"""The port's graph build and sampler against the JAX package, bit for bit.

The same seeded event streams go through ``tempme_tpu`` and
``tempme_tpu_torch`` on the CPU. Random draws are made with ``jax.random`` in
the JAX package's split order and handed to the port as tensors, so every
sampled id and timestamp must match exactly. The JAX side runs through its
CSR path, its dense path and its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.ops import sampler as JS
from tempme_tpu.ops.pallas import sample_kernel as SK
from tempme_tpu.train import loops as JL
from tempme_tpu_torch.data.events import EventStream
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows_plain
from tempme_tpu_torch.train import loops as L


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's CPU tests on one intra-op thread: the tier-1 run has
    six test workers on the machine's cores, and PyTorch's default of one
    thread per core in each of them oversubscribes the CPU (a test file
    took twenty times its time alone). Other port test modules import this
    fixture, which applies it to them too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch_events(ev):
    return EventStream(ev.src, ev.dst, ev.ts, ev.label, ev.e_idx)


def jax_hop_draws(key, b, k, n):
    """The uniforms ``tempme_tpu.ops.sampler.find_k_hop`` draws, per hop."""
    out = []
    for layer in range(k):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (b * n ** layer, n)))))
    return tuple(out)


def jax_support_draws(key, b, k, n, num_dst):
    """The draws ``tempme_tpu.train.loops.sample_support`` makes from
    ``key``, as the port's ``SupportDraws``."""
    kn, k1, k2, k3 = jax.random.split(key, 4)
    neg = np.array(jax.random.randint(kn, (b,), 0, num_dst))
    return L.SupportDraws(torch.from_numpy(neg).long(),
                          *(jax_hop_draws(kk, b, k, n) for kk in (k1, k2, k3)))


def assert_same(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def events():
    return make_events(num_events=500, num_nodes=40, seed=3, allow_node0=True)


@pytest.fixture(scope="module")
def graphs(events):
    # two extra node ids that have no events at all
    n = events.num_nodes + 2
    return (jax_build_graph(events, num_nodes=n),
            build_temporal_graph(to_torch_events(events), num_nodes=n,
                                 device="cpu"))


def jax_variant(g, path):
    if path == "csr":
        return dataclasses.replace(g, dense_ts=None, dense_node=None,
                                   dense_eid=None)
    return g


def test_graph_arrays_equal_jax(events, graphs):
    jg, tg = graphs
    assert (events.src == 0).any() and len(np.unique(events.ts)) < len(events)
    for name in ("ngh_node", "ngh_eid", "ngh_ts", "off", "edge_ts"):
        p, r = getattr(tg, name), np.asarray(getattr(jg, name))
        assert p.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
    assert (tg.num_nodes, tg.num_edges, tg.max_degree) == \
        (jg.num_nodes, jg.num_edges, jg.max_degree)


def _queries(seed, q, num_nodes, num_events):
    r = np.random.RandomState(seed)
    nodes = r.randint(0, num_nodes, q).astype(np.int32)
    times = (r.rand(q) * num_events / 2).astype(np.float32)
    eids = r.randint(0, num_events + 1, q).astype(np.int32)
    # probes: node 0, t = 0, edge 0 and a node with no events
    nodes[:4] = 0
    times[4:8] = 0.0
    eids[8:10] = 0
    nodes[10:12] = num_nodes - 1
    return nodes, times, eids


@pytest.mark.parametrize("path", ["csr", "dense", "pallas"])
@pytest.mark.parametrize("cut", ["time", "edge"])
def test_sample_neighbors_bit_identical(graphs, monkeypatch, path, cut):
    jg, tg = graphs
    n, q = 5, 64
    nodes, times, eids = _queries(1, q, jg.num_nodes, jg.num_edges - 1)
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (q, n))))
    e = eids if cut == "edge" else None
    if path == "pallas":
        t_cut = jg.edge_ts[eids] if e is not None else jnp.asarray(times)
        force = None if e is None else jnp.asarray((nodes == 0) | (eids == 0))
        ref = SK.sample_rows(jg, key, jnp.asarray(nodes), t_cut, n,
                             force_empty=force, interpret=True)
    else:
        ref = JS.sample_neighbors(jax_variant(jg, path), key,
                                  jnp.asarray(nodes), jnp.asarray(times), n,
                                  eids=None if e is None else jnp.asarray(e))
    port = S.sample_neighbors(tg, u, torch.from_numpy(nodes),
                              torch.from_numpy(times), n,
                              eids=None if e is None else torch.from_numpy(e))
    assert_same(port, ref)
    assert port[0].dtype == torch.int32 and port[2].dtype == torch.float32
    # the probes come back as all-zero padding: t = 0 (nothing is strictly
    # earlier) and the node without events always; node 0 and edge 0 where
    # the history is cut at an edge
    empty = [slice(10, 12)] + ([slice(0, 4), slice(8, 10)] if cut == "edge"
                               else [slice(4, 8)])
    for out in port:
        for rows in empty:
            assert not out[rows].any()


@pytest.mark.parametrize("hop0_cut", ["time", "edge"])
def test_find_k_hop_bit_identical(events, graphs, hop0_cut):
    jg, tg = graphs
    b, k, n = 12, 2, 4
    src, times, eids = _queries(2, b, jg.num_nodes, len(events))
    times[:] = events.ts[eids.clip(1) - 1]
    key = jax.random.PRNGKey(3)
    e = eids if hop0_cut == "edge" else None
    ref = JS.find_k_hop(jg, key, jnp.asarray(src), jnp.asarray(times), k, n,
                        eids=None if e is None else jnp.asarray(e))
    port = S.find_k_hop(tg, jax_hop_draws(key, b, k, n),
                        torch.from_numpy(src), torch.from_numpy(times), k, n,
                        eids=None if e is None else torch.from_numpy(e))
    for field in ("nodes", "eids", "ts"):
        assert_same(getattr(port, field), getattr(ref, field))
    assert port.nodes[1].shape == (b, n * n)


@pytest.mark.parametrize("use_eidx", [False, True])
def test_sample_support_bit_identical(events, graphs, use_eidx):
    jg, tg = graphs
    b, k, n = 8, 2, 3
    s = 100
    jb = JL.Batch(src=jnp.asarray(events.src[s:s + b]),
                  dst=jnp.asarray(events.dst[s:s + b]),
                  ts=jnp.asarray(events.ts[s:s + b]),
                  eidx=jnp.asarray(events.e_idx[s:s + b]),
                  mask=jnp.ones(b, bool))
    tb = L.Batch(*(torch.from_numpy(np.array(x)) for x in jb))
    dst_table = np.unique(events.dst[:300])
    key = jax.random.PRNGKey(11)
    ref = JL.sample_support(jg, key, jb, jnp.asarray(dst_table), k, n,
                            use_eidx=use_eidx)
    draws = jax_support_draws(key, b, k, n, len(dst_table))
    port = L.sample_support(tg, tb, torch.from_numpy(dst_table), k, n, draws,
                            use_eidx=use_eidx)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    for p, r in zip(port[1:], ref[1:]):
        for field in ("nodes", "eids", "ts"):
            assert_same(getattr(p, field), getattr(r, field))


def test_plain_and_wrapper_agree_on_cpu(graphs):
    """On CPU tensors the wrapper is its plain version."""
    _, tg = graphs
    nodes, times, eids = _queries(4, 32, tg.num_nodes, tg.num_edges - 1)
    u = torch.from_numpy(np.random.RandomState(5).rand(32, 6)
                         .astype(np.float32))
    for e in (None, torch.from_numpy(eids)):
        a = S.sample_neighbors(tg, u, torch.from_numpy(nodes),
                               torch.from_numpy(times), 6, eids=e)
        b = sample_rows_plain(tg, torch.from_numpy(nodes),
                              torch.from_numpy(times), u, e)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_other_sampling_modes_name_the_roadmap_item(graphs):
    """The exp-decay and binary modes (item A2) are ported
    (``tests/test_torch_sampler_modes.py`` holds them against JAX); they
    take Gumbels, not the uniform mode's [Q, n] uniforms, and refuse
    those."""
    _, tg = graphs
    u = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="gumbel"):
        S.sample_neighbors(tg, u, torch.ones(2, dtype=torch.int32),
                           torch.ones(2), 3, bias=0.5)
