"""The port's null-model motif prior against the JAX package.

``shuffled_events`` must permute the stream as JAX's does. The estimator
runs on a seeded toy stream in both packages: the JAX graph is built
without its dense layout, so JAX takes its CSR branch, and the port gets
the uniforms JAX draws from the keys its ``one_batch`` splits. The cached
``.npy`` prior (name and contents), and with it the class counts, must then
match exactly.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import jax_hop_draws, to_torch_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.data import events as JE
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import null_model as JN
from tempme_tpu_torch.data import events as E
from tempme_tpu_torch.explain import null_model as N
from tempme_tpu_torch.ops import sampler as S

N_DEGREE = 4


def jax_null_draws(seed, batch_size, n_degree):
    """``draw`` for the port's estimator: each call returns the next batch's
    uniforms, as JAX's estimator draws them (``key, sub = split(key)``, six
    keys from ``sub``: the hops' and the walks' of src, dst and background)."""
    key = jax.random.PRNGKey(seed)

    def walk_draws(kw):
        kw, k2 = jax.random.split(kw)
        _, k3 = jax.random.split(kw)
        q = batch_size * n_degree
        return S.WalkDraws(
            torch.from_numpy(np.array(jax.random.uniform(k2, (q, 1)))),
            torch.from_numpy(np.array(jax.random.uniform(k3, (q,)))))

    def draw():
        nonlocal key
        key, sub = jax.random.split(key)
        k = jax.random.split(sub, 6)
        return tuple((jax_hop_draws(k[2 * i], batch_size, 2, n_degree),
                      walk_draws(k[2 * i + 1])) for i in range(3))
    return draw


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_events_equals_jax(seed):
    ev = make_events(num_events=300, num_nodes=30, seed=seed)
    port = E.shuffled_events(to_torch_events(ev), seed=seed)
    ref = JE.shuffled_events(ev, seed=seed)
    for field in ("src", "dst", "ts", "label", "e_idx"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
    assert not np.array_equal(port.src, ev.src)


def test_null_distribution_equals_jax(tmp_path, monkeypatch):
    # bipartite, as the wikipedia stream is: 10 users, 100 items, so the
    # background pool (test nodes and train destinations) is its own set
    ev = make_events(num_events=600, num_nodes=110, seed=9)
    ev = dataclasses.replace(ev, src=(1 + ev.src % 10).astype(np.int32),
                             dst=(11 + ev.dst % 100).astype(np.int32))
    node_feat = np.zeros((ev.num_nodes + 1, 4), np.float32)
    edge_feat = np.zeros((ev.num_edges + 1, 4), np.float32)

    def csr_only(*args, **kw):
        return dataclasses.replace(jax_build_graph(*args, **kw), dense_ts=None,
                                   dense_node=None, dense_eid=None)
    monkeypatch.setattr(JN, "build_temporal_graph", csr_only)
    seed, name = 3, "toy"
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = JN.get_null_distribution(name, ev, N_DEGREE, node_feat, edge_feat,
                                   cache_dir=jdir, seed=seed)
    port = N.get_null_distribution(name, to_torch_events(ev), N_DEGREE,
                                   node_feat, edge_feat, cache_dir=pdir,
                                   seed=seed, device="cpu",
                                   draw=jax_null_draws(seed, 10, N_DEGREE))
    (fname,) = os.listdir(jdir)
    assert os.listdir(pdir) == [fname]
    cached = np.load(os.path.join(pdir, fname))
    assert cached.dtype == np.float32
    np.testing.assert_array_equal(cached, np.load(os.path.join(jdir, fname)))
    np.testing.assert_array_equal(port, ref)
    # the counts behind it: whole test batches of 10 events, 3 sides, 4 walks
    n_test = len(JE.split_events(JE.shuffled_events(ev, seed=seed),
                                 node_feat, edge_feat).test)
    total = (n_test // 10) * 10 * 3 * N_DEGREE
    counts = port.astype(np.float64) * total
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-3)
    assert total > 0 and (counts > 0.5).sum() > 2     # several classes seen
    # a second call reads the cache, whatever it would draw
    again = N.get_null_distribution(name, to_torch_events(ev), N_DEGREE,
                                    node_feat, edge_feat, cache_dir=pdir,
                                    seed=seed, device="cpu", draw=None)
    np.testing.assert_array_equal(again, port)
