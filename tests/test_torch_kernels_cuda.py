"""Each CUDA kernel against its plain PyTorch version, on the card.

Skipped where there is no CUDA device (the check is made inside the
fixture, when the test runs). ``sample_rows`` must be bit-identical;
``attend`` agrees to rtol 1e-5 and atol 1e-6 (float32 sums in another
order). The file imports neither JAX nor the JAX package; on a machine
without JAX run it with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from tempme_tpu_torch.data.events import EventStream
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.ops.kernels.attend import attend, attend_plain
from tempme_tpu_torch.ops.kernels.sample_rows import (sample_rows,
                                                      sample_rows_plain)


def _events(num_events, num_nodes, seed):
    """A stream with node 0, timestamp ties and 1-based edge ids."""
    r = np.random.RandomState(seed)
    ts = np.sort(r.randint(0, num_events // 2, num_events)).astype(np.float32)
    return EventStream(r.randint(0, num_nodes, num_events).astype(np.int32),
                       r.randint(0, num_nodes, num_events).astype(np.int32),
                       ts, np.zeros(num_events, np.float32),
                       np.arange(1, num_events + 1, dtype=np.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [5, 20, 40])
@pytest.mark.parametrize("edge_cut", [False, True])
def test_sample_rows_kernel_bitwise(cuda, n, edge_cut):
    ev = _events(2000, 60, seed=5)
    g = build_temporal_graph(ev, num_nodes=ev.num_nodes + 1, device=cuda)
    r = np.random.RandomState(n)
    q = 777
    nodes = torch.from_numpy(r.randint(0, g.num_nodes, q).astype(np.int32))
    times = torch.from_numpy((r.rand(q) * 1000).astype(np.float32))
    eids = torch.from_numpy(r.randint(0, g.num_edges, q).astype(np.int32))
    times[:8] = 0.0
    eids[8:16] = 0
    u = torch.from_numpy(r.rand(q, n).astype(np.float32))
    nodes, times, eids, u = (x.to(cuda) for x in (nodes, times, eids, u))
    e = eids if edge_cut else None
    before = sample_rows.launches
    out = sample_rows(g, nodes, times, u, e)
    ref = sample_rows_plain(g, nodes, times, u, e)
    torch.cuda.synchronize()
    assert sample_rows.launches == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,h,n,dk", [(37, 2, 20, 172), (64, 1, 40, 30),
                                      (5, 3, 1, 7)])
def test_attend_kernel_matches_plain(cuda, m, h, n, dk):
    r = np.random.RandomState(m)
    q, k, v = (torch.from_numpy(r.randn(*s).astype(np.float32)).to(cuda)
               for s in ((m, h, dk), (m, n, h, dk), (m, n, h, dk)))
    mask = torch.from_numpy(r.rand(m, n) < 0.3).to(cuda)
    mask[0] = True
    ew = torch.from_numpy(r.rand(m, n).astype(np.float32)).to(cuda)
    for mk, w in ((mask, ew), (None, None)):
        before = attend.launches
        out, attn = attend(q, k, v, mk, w, 1.0 / dk ** 0.5)
        ref_out, ref_attn = attend_plain(q, k, v, mk, w, 1.0 / dk ** 0.5)
        torch.cuda.synchronize()
        assert attend.launches == before + 1
        torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(attn, ref_attn, rtol=1e-5, atol=1e-6)
