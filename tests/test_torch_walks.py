"""The port's motif-walk sampler against the JAX package, bit for bit.

The same seeded event streams go through ``tempme_tpu`` and
``tempme_tpu_torch`` on the CPU. The JAX graph is built without its dense
layout (``dense_ts=None``), so JAX takes its CSR branch, whose scheme the
port's ``sample_union`` and ``sample_masked`` kernels and their plain
versions follow. The uniforms are JAX's: ``jax.random.uniform`` of the keys
JAX's functions split, handed to the port as tensors. Every id, timestamp,
anonymous code and motif class must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_kernels_cuda import (UNION_NODES, UNION_PROBES,
                                           hub_events, hub_queries,
                                           union_queries)
from tests.test_torch_graph_sampler import (assert_same, jax_hop_draws,
                                            to_torch_events)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.data.events import EventStream as JaxEventStream
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.ops import sampler as JS
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.kernels.sample_masked import (sample_masked,
                                                        sample_masked_plain)
from tempme_tpu_torch.ops.kernels.sample_union import (sample_union,
                                                       sample_union_plain)


@pytest.fixture(scope="module")
def events():
    # few nodes and many events: repeated (node, neighbour) pairs and ties
    return make_events(num_events=600, num_nodes=25, seed=5, allow_node0=True)


@pytest.fixture(scope="module")
def graphs(events):
    n = events.num_nodes + 1                 # one node without events
    jg = jax_build_graph(events, num_nodes=n)
    jg = dataclasses.replace(jg, dense_ts=None, dense_node=None,
                             dense_eid=None)
    return jg, build_temporal_graph(to_torch_events(events), num_nodes=n,
                                    device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_secondary_csr_equals_jax(graphs):
    jg, tg = graphs
    for name in ("bynb_ngh", "bynb_eid", "bynb_ts"):
        p, r = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert p.dtype == r.dtype, name
        np.testing.assert_array_equal(p, r, err_msg=name)
    # each node's slice is sorted by (neighbour, time)
    off = tg.off.numpy()
    for v in range(tg.num_nodes):
        ngh = tg.bynb_ngh.numpy()[off[v]:off[v + 1]]
        ts = tg.bynb_ts.numpy()[off[v]:off[v + 1]]
        assert np.all(np.lexsort((ts, ngh)) == np.arange(len(ngh)))


def _pair_queries(seed, q, num_nodes, num_edges):
    r = np.random.RandomState(seed)
    a = r.randint(0, num_nodes, q).astype(np.int32)
    b = r.randint(0, num_nodes, q).astype(np.int32)
    e = r.randint(0, num_edges, q).astype(np.int32)
    a[:3] = 0                 # probes: padding node, padding edge, no events
    e[3:6] = 0
    b[6:8] = num_nodes - 1
    return a, b, e


def test_sample_union_plain_matches_jax_csr(graphs):
    jg, tg = graphs
    q, n = 96, 3
    a, b, e = _pair_queries(1, q, jg.num_nodes, jg.num_edges)
    key = jax.random.PRNGKey(4)
    ref = JS._union_uniform_sample(jg, key, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(e), n)
    u = _t(jax.random.uniform(key, (q, n)))
    port = sample_union_plain(tg, _t(a), _t(b), _t(e), u)
    assert_same(port, ref)
    for x, y in zip(port, sample_union(tg, _t(a), _t(b), _t(e), u)):
        assert torch.equal(x, y)
    assert not port[1][3:6].any() and port[1].any()


def test_sample_union_plain_matches_jax_csr_on_a_hub():
    """The same on a graph with a hub: 1,000 events of node 1 at 40
    distinct times, edge cuts at the hub's own events (ties with its
    history), nodes of degree 0-33, 289-290 and 1,023-1,024, a == b on a
    fifth of the rows and 33 draws a query (the shapes the card's
    ``sample_union`` is held to on a larger hub)."""
    src, dst, ts, label, e_idx = hub_events(1000, 40, 300, seed=14,
                                            probes=UNION_PROBES)
    ev = JaxEventStream(src, dst, ts, label, e_idx)
    jg = dataclasses.replace(jax_build_graph(ev, num_nodes=UNION_NODES),
                             dense_ts=None, dense_node=None, dense_eid=None)
    tg = build_temporal_graph(to_torch_events(ev), num_nodes=UNION_NODES,
                              device="cpu")
    q, n = 129, 33
    a, b, e, _ = union_queries(src, q, n, seed=8)
    assert (a == b).sum() > 10
    key = jax.random.PRNGKey(9)
    ref = JS._union_uniform_sample(jg, key, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(e), n)
    u = _t(jax.random.uniform(key, (q, n)))
    port = sample_union_plain(tg, _t(a), _t(b), _t(e), u)
    assert_same(port, ref)
    ngh = port[1].numpy()
    assert ngh[0].all() and not ngh[4:8].any() and not ngh.all()


def test_sample_masked_plain_matches_jax_csr(graphs, events):
    jg, tg = graphs
    q = 128
    a, b, e = _pair_queries(2, q, jg.num_nodes, jg.num_edges)
    r = np.random.RandomState(3)
    # candidates that exist: neighbours taken from the stream itself
    va1 = events.dst[r.randint(0, len(events), q)].astype(np.int32)
    va2 = events.src[r.randint(0, len(events), q)].astype(np.int32)
    vb1 = events.dst[r.randint(0, len(events), q)].astype(np.int32)
    wild = r.rand(q) < 0.3
    key = jax.random.PRNGKey(6)
    ref = JS._masked_union_sample(jg, key, *map(jnp.asarray,
                                                (a, b, e, va1, va2, vb1)),
                                  jnp.asarray(wild))
    u = _t(jax.random.uniform(key, (q,)))
    args = [_t(x) for x in (a, b, e, va1, va2, vb1, wild)]
    port = sample_masked_plain(tg, *args, u)
    assert_same(port, ref)
    for x, y in zip(port, sample_masked(tg, *args, u)):
        assert torch.equal(x, y)
    found = port[4].numpy()
    assert found[~wild].any() and found[wild].any() and not found.all()


def test_sample_masked_plain_matches_jax_csr_on_a_hub():
    """The same on a graph with a hub: 600 events of node 1 at 40 distinct
    times, most with neighbour 2 or 3, edge cuts at the hub's own events,
    nodes of degree 0, 1, 31, 32 and 33 (the semantics the card's
    ``sample_masked`` is held to on a larger hub)."""
    ev = JaxEventStream(*hub_events(600, 40, 300, seed=13))
    n, q = 60, 96
    jg = dataclasses.replace(jax_build_graph(ev, num_nodes=n), dense_ts=None,
                             dense_node=None, dense_eid=None)
    tg = build_temporal_graph(to_torch_events(ev), num_nodes=n, device="cpu")
    *ints, wild, _ = hub_queries(ev.src, ev.dst, q, seed=5)
    key = jax.random.PRNGKey(7)
    ref = JS._masked_union_sample(jg, key, *map(jnp.asarray, ints),
                                  jnp.asarray(wild))
    u = _t(jax.random.uniform(key, (q,)))
    port = sample_masked_plain(tg, *map(_t, ints), _t(wild), u)
    assert_same(port, ref)
    found = port[4].numpy()
    assert found[0] and found[wild].any() and found[~wild].any()
    assert not found.all()


@pytest.mark.parametrize("n1,n2", [(4, 3), (5, 1)])
def test_find_k_walks_matches_jax(graphs, n1, n2):
    jg, tg = graphs
    bsz = 16
    r = np.random.RandomState(n1)
    src = r.randint(1, jg.num_nodes, bsz).astype(np.int32)
    eids = r.randint(1, jg.num_edges, bsz).astype(np.int32)
    times = np.asarray(jg.edge_ts)[eids]
    src[0] = 0                                    # padding anchor
    key_h, key_w = jax.random.split(jax.random.PRNGKey(n2))
    def jax_walks(key_h, key_w, src, times, eids):
        jsub = JS.find_k_hop(jg, key_h, src, times, 2, n1, eids=eids)
        return JS.find_k_walks(jg, key_w, src, jsub, n1, n2)
    ref = jax.jit(jax_walks)(key_h, key_w, jnp.asarray(src),
                             jnp.asarray(times), jnp.asarray(eids))
    # the uniforms find_k_walks draws: key, k2 = split; key, k3 = split
    key, k2 = jax.random.split(key_w)
    _, k3 = jax.random.split(key)
    draws = S.WalkDraws(_t(jax.random.uniform(k2, (bsz * n1, n2))),
                        _t(jax.random.uniform(k3, (bsz * n1 * n2,))))
    sub = S.find_k_hop(tg, jax_hop_draws(key_h, bsz, 2, n1), _t(src),
                       _t(times), 2, n1, eids=_t(eids))
    port = S.find_k_walks(tg, draws, _t(src), sub, n1, n2)
    for field in S.Walks._fields:
        p, q = getattr(port, field), np.array(getattr(ref, field))
        assert p.dtype == torch.from_numpy(q).dtype, field
        np.testing.assert_array_equal(p.numpy(), q, err_msg=field)
    cat = port.cat.numpy()
    assert cat.min() >= 0 and cat.max() < 12
    assert len(np.unique(cat)) > 3               # several motif classes
    assert port.nodes.shape == (bsz, n1 * n2, 6)


def test_anony_to_cat_is_the_canonical_order():
    x = torch.tensor([1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], dtype=torch.int32)
    t = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32)
    cat = S.anony_to_cat(x, t).tolist()
    for xi, ti, c in zip(x.tolist(), t.tolist(), cat):
        assert S.CAT_ORDER[c] == f"1,{xi},{ti}"
    np.testing.assert_array_equal(
        cat, np.asarray(JS.anony_to_cat(jnp.asarray(x.numpy()),
                                        jnp.asarray(t.numpy()))))
