"""The port's native host runtime (``tempme_tpu_torch/utils/native.py``,
its own copy of ``tempme_host.cpp``) against the JAX package's on the CPU:
``HostGraph.sample_neighbors`` and ``sample_walks`` equal
``tempme_tpu.utils.native``'s bit for bit at two seeds, the outputs pass
the oracle checks of ``tests/test_native.py`` (the python ``Oracle`` and
the walk case analysis of ``tests/test_sampler.py``), and ``load_csv``
equals the port's numpy loader on a written ``ml_synth`` CSV. Each test
skips only where the library cannot be built (no g++), as JAX's file
does.
"""
import numpy as np
import pytest

from conftest import make_events
from tests.test_sampler import Oracle, _walk_case_oracle
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tempme_tpu.utils import native as jax_native
from tempme_tpu_torch.data.events import load_csv_events
from tempme_tpu_torch.utils import native


@pytest.fixture(autouse=True)
def toolchain():
    if not native.available():
        pytest.skip("no native toolchain (g++ with OpenMP)")


@pytest.fixture(scope="module")
def graphs():
    events = make_events(500, 40, seed=13)
    args = (events.src, events.dst, events.e_idx, events.ts,
            events.num_nodes, events.num_edges)
    return events, native.HostGraph(*args), jax_native.HostGraph(*args)


def _first_hops(g, events, n_rows, seed):
    r = np.random.RandomState(seed)
    src = r.randint(1, events.num_nodes, n_rows).astype(np.int32)
    times = np.full(n_rows, float(events.ts.max()) + 1, np.float32)
    n1, e1, _ = g.sample_neighbors(src, times, 1, seed=3)
    return src, n1[:, 0], e1[:, 0]


@pytest.mark.parametrize("seed", [7, 21])
def test_samplers_equal_jax_bit_for_bit(graphs, seed):
    events, port, ref = graphs
    assert all(np.array_equal(a, b) for a, b in (
        (port.ngh, ref.ngh), (port.eid, ref.eid), (port.ts, ref.ts),
        (port.off, ref.off), (port.edge_ts, ref.edge_ts)))
    r = np.random.RandomState(seed)
    nodes = r.randint(0, events.num_nodes, 300).astype(np.int32)
    times = r.uniform(0, float(events.ts.max()) + 1, 300).astype(np.float32)
    for a, b in zip(port.sample_neighbors(nodes, times, 6, seed=seed),
                    ref.sample_neighbors(nodes, times, 6, seed=seed)):
        np.testing.assert_array_equal(a, b)
    src, u1, e1 = _first_hops(port, events, 300, seed)
    for a, b in zip(port.sample_walks(src, u1, e1, seed=seed),
                    ref.sample_walks(src, u1, e1, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_native_neighbors_support(graphs):
    events, g, _ = graphs
    oracle = Oracle(events)
    r = np.random.RandomState(0)
    nodes = r.randint(0, events.num_nodes, 100).astype(np.int32)
    times = r.uniform(0, float(events.ts.max()) + 1, 100).astype(np.float32)
    on, oe, ot = g.sample_neighbors(nodes, times, 6, seed=7)
    for k in range(100):
        pre = oracle.prefix(int(nodes[k]), float(times[k]))
        if not pre:
            assert (on[k] == 0).all()
            continue
        allowed = {(a, b, c) for (a, b, c) in pre}
        for j in range(6):
            assert (int(on[k, j]), int(oe[k, j]), float(ot[k, j])) in allowed
        assert (np.diff(ot[k]) >= 0).all()


def test_native_walks_match_case_analysis(graphs):
    events, g, _ = graphs
    oracle = Oracle(events)
    src, u1, e1 = _first_hops(g, events, 200, 1)
    out, out_t = g.sample_walks(src, u1, e1, seed=11)
    for w in range(200):
        s1, tgt1, ee1 = int(src[w]), int(u1[w]), int(e1[w])
        s2, u2, e2, s3, u3, e3, x, t = (int(v) for v in out[w])
        pre_a = oracle.prefix_by_edge(s1, ee1)
        pre_b = oracle.prefix_by_edge(tgt1, ee1)
        if not pre_a and not pre_b:
            assert s2 == 0 and u2 == 0 and e2 == 0
        else:
            cands = [(s1, *c) for c in pre_a] + [(tgt1, *c) for c in pre_b]
            assert (s2, u2, e2, float(out_t[w, 0])) in cands
        cands3, xx = _walk_case_oracle(oracle, s1, tgt1, s2, u2, e2)
        assert x == xx
        if not cands3:
            assert s3 == 0 and u3 == 0 and t == 0
        else:
            assert (s3, u3, e3, float(out_t[w, 1])) in cands3


def test_load_csv_matches_numpy_loader(workdir):  # noqa: F811
    path = str(workdir / "ml_synth.csv")
    src, dst, ts, label, eidx = native.load_csv(path)
    ev = load_csv_events(path)
    assert len(src) == len(ev) == 600
    for a, b in ((src, ev.src), (dst, ev.dst), (ts, ev.ts),
                 (label, ev.label), (eidx, ev.e_idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
