"""The exp-decay and binary sampling modes against the JAX package on the
CPU, bit for bit.

``sample_neighbors`` with ``bias > 0`` (an exp(-bias * dt)-weighted
multinomial, sorted picks) and with ``sample_method="binary"`` (the same
draw, unsorted), and ``find_k_hop`` in both modes, take the JAX sampler's
own Gumbels (``jax.random.gumbel(fold_in(key, c), (Q, n, 128))`` per
128-event chunk c, per hop ``split(key)`` as JAX's ``find_k_hop`` splits
it) and must give the same ids and timestamps exactly. The stream has a
few busy nodes (histories of several chunks), ties in time, node ids
with no events and queries cut at time 0, so rows with empty histories
are in every batch. JAX runs its CSR sampler (these modes never reach its
kernel or its dense path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.ops import sampler as JS
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.ops import sampler as S

NUM_NODES = 9                      # ids 9 and 10 have no events


@pytest.fixture(scope="module")
def graphs():
    ev = make_events(num_events=1500, num_nodes=NUM_NODES, seed=4)
    n = NUM_NODES + 2
    jg = dataclasses.replace(jax_build_graph(ev, num_nodes=n), dense_ts=None,
                             dense_node=None, dense_eid=None)
    tg = build_temporal_graph(to_torch_events(ev), num_nodes=n, device="cpu")
    return ev, jg, tg


def _queries(ev, q, seed):
    r = np.random.RandomState(seed)
    nodes = r.randint(0, NUM_NODES + 2, q).astype(np.int32)
    times = r.uniform(0, float(ev.ts.max()) + 2, q).astype(np.float32)
    times[:3] = 0.0                                   # nothing before t = 0
    eids = r.randint(0, len(ev) + 1, q).astype(np.int32)
    return nodes, times, eids


def _gumbel(key, chunks, q, n):
    """JAX's Gumbels for ``chunks`` chunks, [chunks, Q, n, 128]."""
    return torch.from_numpy(np.stack([np.array(jax.random.gumbel(
        jax.random.fold_in(key, c), (q, n, S.CHUNK)))
        for c in range(chunks)]))


def _assert_same(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("method, bias", [("multinomial", 0.05),
                                          ("multinomial", 2.0),
                                          ("binary", 0.05), ("binary", 0.0)])
@pytest.mark.parametrize("by_edge", [False, True])
def test_sample_neighbors_matches_jax(graphs, method, bias, by_edge):
    ev, jg, tg = graphs
    q, n = 64, 5
    nodes, times, eids = _queries(ev, q, seed=int(bias * 100) + by_edge)
    if by_edge:
        times = ev.ts[np.maximum(eids - 1, 0)].astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = JS.sample_neighbors(jg, key, jnp.asarray(nodes), jnp.asarray(times),
                              n, bias=bias,
                              eids=jnp.asarray(eids) if by_edge else None,
                              sample_method=method)
    te = torch.from_numpy(eids) if by_edge else None
    chunks = S.decay_chunks(tg, torch.from_numpy(nodes),
                            torch.from_numpy(times), te)
    assert chunks >= 2                       # several chunks are scanned
    out = S.sample_neighbors(tg, _gumbel(key, chunks, q, n),
                             torch.from_numpy(nodes), torch.from_numpy(times),
                             n, bias=bias, eids=te, sample_method=method)
    _assert_same(out, ref)
    empty = (out[0] == 0).all(dim=1)
    assert empty.any() and not empty.all()
    if method == "multinomial":
        assert (out[2].diff(dim=1) >= 0).all()      # sorted picks
    # more chunks than the longest history needs change nothing
    more = S.sample_neighbors(tg, _gumbel(key, chunks + 1, q, n),
                              torch.from_numpy(nodes),
                              torch.from_numpy(times), n, bias=bias, eids=te,
                              sample_method=method)
    _assert_same(more, ref)
    with pytest.raises(ValueError, match="gumbel"):
        S.sample_neighbors(tg, _gumbel(key, chunks - 1, q, n),
                           torch.from_numpy(nodes), torch.from_numpy(times),
                           n, bias=bias, eids=te, sample_method=method)


@pytest.mark.parametrize("method, bias", [("multinomial", 0.1),
                                          ("binary", 0.1)])
def test_find_k_hop_matches_jax(graphs, method, bias):
    ev, jg, tg = graphs
    b, k, n = 6, 2, 4
    nodes, times, _ = _queries(ev, b, seed=11)
    key = jax.random.PRNGKey(3)
    ref = JS.find_k_hop(jg, key, jnp.asarray(nodes), jnp.asarray(times), k,
                        n, bias=bias, sample_method=method)
    chunks = -(-tg.max_degree // S.CHUNK)      # enough for any history
    draws, hop_key = [], key
    for layer in range(k):
        hop_key, sub = jax.random.split(hop_key)
        draws.append(_gumbel(sub, chunks, b * n ** layer, n))
    out = S.find_k_hop(tg, draws, torch.from_numpy(nodes),
                       torch.from_numpy(times), k, n, bias=bias,
                       sample_method=method)
    for field in range(3):
        _assert_same(out[field], ref[field])
    assert (out.nodes[1] != 0).any() and (out.nodes[1] == 0).any()


def test_draw_gumbel_and_unknown_method(graphs):
    _, _, tg = graphs
    gen = torch.Generator().manual_seed(0)
    g = S.draw_gumbel(gen, 2, 3, 4, "cpu")
    assert g.shape == (2, 3, 4, S.CHUNK) and torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.1     # the Gumbel's mean
    with pytest.raises(ValueError, match="sample_method"):
        S.sample_neighbors(tg, g, torch.ones(3, dtype=torch.int32),
                           torch.ones(3), 4, sample_method="stratified")
