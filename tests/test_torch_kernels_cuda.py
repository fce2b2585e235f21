"""Each CUDA kernel against its plain PyTorch version, on the card, and
the launches of one TGN train step and one explainer train and eval step.

Skipped where there is no CUDA device (the check is made inside the
fixture, when the test runs). ``sample_rows``, ``sample_union`` and
``sample_masked`` must be bit-identical, and ``walk_to_edge``'s forward
exactly equal (its ``cnt`` equal to ``walk_to_edge_count_plain``); ``attend`` and ``attend_drop`` agree to rtol 1e-5 and atol
1e-6 (float32 sums in another order), ``attend_bwd`` to rtol 1e-5 and atol
1e-5 (its sums run over up to n * dk terms; the explain weight's gradient
too), ``walk_to_edge``'s backward to rtol 1e-5, atol 1e-5 (each slot
sums its share over up to T targets, in another order) and to the same
bits from one launch to the next. With bf16 q, k and v the forward keeps its
tolerance (the same float32 arithmetic on the same inputs) and the bf16
gradients dq, dk, dv are held to rtol 1e-2, atol 1e-4: one bf16 rounding
of values that differ in their last float32 digits. The file imports neither JAX nor the JAX
package; on a machine without JAX run it with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from tempme_tpu_torch.data.events import EventStream
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgn import TGN, init_memory_state
from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                 attend_bwd_plain,
                                                 attend_drop,
                                                 attend_drop_plain,
                                                 attend_plain)
from tempme_tpu_torch.ops.kernels.sample_masked import (sample_masked,
                                                        sample_masked_plain)
from tempme_tpu_torch.ops.kernels.sample_rows import (sample_rows,
                                                      sample_rows_plain)
from tempme_tpu_torch.ops.kernels.sample_union import (sample_union,
                                                       sample_union_plain)
from tempme_tpu_torch.ops.kernels.walk_to_edge import (
    walk_to_edge, walk_to_edge_bwd, walk_to_edge_count_plain,
    walk_to_edge_fwd, walk_to_edge_plain)
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.train import loops as L


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


def _at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage, so its base is not 16-byte aligned for a small odd offset."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


# (m, h, n, dk, storage offset of k and v in elements): the paths' shape
# (h 2, dk 172: 16-byte rows, the bulk-copy path), the explainer's root m,
# odd shapes whose rows are not a multiple of 16 bytes, k and v at an odd
# offset (4- and 2-byte words) and at 2 elements (8- and 4-byte words),
# and n large enough that a row's slabs do not fit one block's shared
# memory (tiles of keys). A block takes one row, so any m, odd ones
# included, fills its blocks.
ATTEND_CASES = [(37, 2, 20, 172, 0), (100, 2, 20, 172, 0), (64, 1, 40, 30, 0),
                (5, 3, 1, 7, 0), (37, 2, 20, 172, 1), (37, 2, 20, 172, 2),
                (6, 2, 200, 172, 0)]


@pytest.mark.parametrize("m,h,n,dk,offset", ATTEND_CASES)
def test_attend_kernel_matches_plain(cuda, m, h, n, dk, offset):
    r = np.random.RandomState(m)
    q, k, v = (torch.from_numpy(r.randn(*s).astype(np.float32)).to(cuda)
               for s in ((m, h, dk), (m, n, h, dk), (m, n, h, dk)))
    k, v = _at_offset(k, offset), _at_offset(v, offset)
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


def _attend_inputs(cuda, m, h, n, dk):
    r = np.random.RandomState(m + n)
    q, k, v = (torch.from_numpy(r.randn(*s).astype(np.float32)).to(cuda)
               for s in ((m, h, dk), (m, n, h, dk), (m, n, h, dk)))
    mask = torch.from_numpy(r.rand(m, n) < 0.3).to(cuda)
    mask[0] = True
    ew = torch.from_numpy(r.rand(m, n).astype(np.float32)).to(cuda)
    u = torch.from_numpy(r.rand(m, h, n).astype(np.float32)).to(cuda)
    dout = torch.from_numpy(r.randn(m, h, dk).astype(np.float32)).to(cuda)
    dattn = torch.from_numpy(r.randn(m, h, n).astype(np.float32)).to(cuda)
    return q, k, v, mask, ew, u, dout, dattn


@pytest.mark.parametrize("m,h,n,dk,offset", ATTEND_CASES)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attend_drop_kernel_matches_plain(cuda, m, h, n, dk, offset, rate):
    q, k, v, mask, ew, u, _, _ = _attend_inputs(cuda, m, h, n, dk)
    k, v = _at_offset(k, offset), _at_offset(v, offset)
    for mk, w in ((mask, ew), (None, None)):
        before = attend_drop.launches
        out, attn = attend_drop(q, k, v, mk, w, u, rate, 1.0 / dk ** 0.5)
        ref_out, ref_attn = attend_drop_plain(q, k, v, mk, w, u, rate,
                                              1.0 / dk ** 0.5)
        torch.cuda.synchronize()
        assert attend_drop.launches == before + 1
        torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(attn, ref_attn, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,h,n,dk,offset", ATTEND_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attend_bwd_kernel_matches_plain(cuda, m, h, n, dk, offset, rate):
    q, k, v, mask, ew, u, dout, dattn = _attend_inputs(cuda, m, h, n, dk)
    k, v = _at_offset(k, offset), _at_offset(v, offset)
    u = u if rate else None
    for mk, w, da in ((mask, ew, dattn), (None, None, None)):
        before = attend_bwd.launches
        got = attend_bwd(q, k, v, mk, w, u, rate, 1.0 / dk ** 0.5, dout, da)
        want = attend_bwd_plain(q, k, v, mk, w, u, rate, 1.0 / dk ** 0.5,
                                dout, da)
        torch.cuda.synchronize()
        assert attend_bwd.launches == before + 1
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_attend_autograd_runs_the_backward_kernel(cuda):
    q, k, v, mask, ew, u, dout, dattn = _attend_inputs(cuda, 33, 2, 20, 172)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = attend_bwd.launches
    out, attn = attend_drop(*leaves, mask, ew, u, 0.1, 0.25)
    grads = torch.autograd.grad((out, attn), leaves,
                                (dout.transpose(0, 2).contiguous()
                                 .transpose(0, 2), dattn))
    want = attend_bwd_plain(q, k, v, mask, ew, u, 0.1, 0.25, dout, dattn)
    torch.cuda.synchronize()
    assert attend_bwd.launches == before + 1
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the explain weight's gradient (the explainer trains through it)
    w = ew.clone().requires_grad_()
    out, attn = attend(q, k, v, mask, w, 0.25)
    (g_ew,) = torch.autograd.grad((out, attn), [w], (dout, dattn))
    want = attend_bwd_plain(q, k, v, mask, ew, None, 0.0, 0.25, dout, dattn,
                            ew_grad=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(g_ew, want[3], rtol=1e-5, atol=1e-5)


def test_train_step_launches_each_kernel_six_times(cuda):
    """The port's counterpart of the JAX package's dispatch test: one
    train step at dropout 0.1 launches the sampler, the training-form
    attention and its backward 6 times each, and the eval-form attention
    not at all; one eval step launches the eval form 6 times."""
    ev = _events(3000, 60, seed=7)
    g = build_temporal_graph(ev, num_nodes=ev.num_nodes, device=cuda)
    r = np.random.RandomState(0)
    feats = Features(
        torch.from_numpy(r.randn(g.num_nodes, 16).astype(np.float32)).to(cuda),
        torch.from_numpy(r.randn(g.num_edges, 8).astype(np.float32)).to(cuda))
    model = TGN(16, 8, g.num_nodes, dropout=0.1, device=cuda)
    dst = torch.from_numpy(np.unique(ev.dst)).to(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = T.make_tgn_train_step(model, g, feats, dst, 10, opt)
    mem = init_memory_state(g.num_nodes, 16, model.raw_message_dim, cuda)
    batch = next(L.iter_batches(ev, 64, False, cuda))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    kernels = (sample_rows, attend, attend_drop, attend_bwd)
    before = [f.launches for f in kernels]
    mem, aux = step(mem, batch, step.draw(gen, 64))
    torch.cuda.synchronize()
    assert torch.isfinite(aux["loss"])
    assert [f.launches - b for f, b in zip(kernels, before)] == [6, 0, 6, 6]
    eval_step = T.make_tgn_eval_step(model, g, feats, dst, 10)
    before = [f.launches for f in kernels]
    eval_step(mem, batch, eval_step.draw(gen, 64))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [6, 6, 0, 0]


@pytest.mark.parametrize("m,h,n,dk,offset", ATTEND_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attend_kernels_bf16_and_explain_weight_grad(cuda, m, h, n, dk,
                                                     offset, rate):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v, mask, ew, u, dout, dattn = _attend_inputs(cuda, m, h, n, dk)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    k, v = _at_offset(k, offset), _at_offset(v, offset)
    u = u if rate else None
    scale = 1.0 / dk ** 0.5
    if rate:
        out, attn = attend_drop(q, k, v, mask, ew, u, rate, scale)
    else:
        out, attn = attend(q, k, v, mask, ew, scale)
    ref_out, ref_attn = attend_drop_plain(q, k, v, mask, ew, u, rate, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = attend_bwd(q, k, v, mask, ew, u, rate, scale, dout, dattn,
                         ew_grad=True)
        torch.cuda.synchronize()
    # one kernel per call: the explain weight's gradient is summed over the
    # heads inside it
    launched = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    assert len(launched) == 1, launched
    assert got[3].shape == (m, n)
    want = attend_bwd_plain(q, k, v, mask, ew, u, rate, scale, dout, dattn,
                            ew_grad=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(attn, ref_attn, rtol=1e-5, atol=1e-6)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5)


# The 3-layer TGAT's attention, h 2, n 20, at d_k 258 (width 172: 516 / 2)
# and 173 (the committed uslegis checkpoint: 345 / 2 rounded up; its bf16
# rows of 692 bytes take 4-byte copies, 1,032 bytes 8-byte ones), at the
# TGAT paths' rows: m 32 (the root at batch 32), 640 (hop 1), 12,800
# (hop 2), 40,000 (the explainer's hop 2 at batch 100) and 8,000 (the
# ratio sweep's 4 ratios x batch 100 x 20).
TGAT_ATTEND = [(m, dk) for dk in (258, 173)
               for m in (32, 640, 8000, 12800, 40000)]


@pytest.mark.parametrize("m,dk", TGAT_ATTEND)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_kernels_at_tgat_shapes(cuda, m, dk, dtype):
    """``attend`` (mask and explain weight), ``attend_drop`` (rate 0.1) and
    ``attend_bwd`` in its training form (dropout, no explain weight, no
    ``dattn``) and with the explain weight's gradient, each against its
    plain version at the tolerances above (float32; bf16 dq, dk, dv). The
    forwards are held against the plain version evaluated in float64 and
    rounded to float32: at d_k 258 the float32 plain version's own sums of
    258 terms round in another order than the kernel's, and against it 3
    of 20.6 million outputs at m 40,000 missed atol 1e-6."""
    h, n = 2, 20
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + dk)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    q, k, v = (randn(*s).to(dtype)
               for s in ((m, h, dk), (m, n, h, dk), (m, n, h, dk)))
    mask = rand(m, n) < 0.3
    mask[0] = True
    ew, u, dout = rand(m, n), rand(m, h, n), randn(m, h, dk)
    scale = 1.0 / dk ** 0.5
    before = [f.launches for f in (attend, attend_drop, attend_bwd)]
    got = [attend(q, k, v, mask, ew, scale),
           attend_drop(q, k, v, mask, None, u, 0.1, scale)]
    q64, k64, v64 = q.double(), k.double(), v.double()
    want = [attend_plain(q64, k64, v64, mask, ew.double(), scale),
            attend_drop_plain(q64, k64, v64, mask, None, u.double(), 0.1,
                              scale)]
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y.float(), rtol=1e-5, atol=1e-6)
    del got, want, q64, k64, v64
    for args, ew_grad in (((mask, None, u, 0.1), False),
                          ((mask, ew, None, 0.0), True)):
        got = attend_bwd(q, k, v, *args, scale, dout, None, ew_grad=ew_grad)
        want = attend_bwd_plain(q, k, v, *args, scale, dout, None,
                                ew_grad=ew_grad)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == dtype
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                           atol=1e-4)
        if ew_grad:
            torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5)
        del got, want
    assert [f.launches - b for f, b in zip(
        (attend, attend_drop, attend_bwd), before)] == [1, 1, 2]


def _pair_queries(g, q, seed):
    r = np.random.RandomState(seed)
    a = r.randint(0, g.num_nodes, q).astype(np.int32)
    b = r.randint(0, g.num_nodes, q).astype(np.int32)
    e = r.randint(0, g.num_edges, q).astype(np.int32)
    a[:4] = 0                   # probes: padding node, padding edge
    e[4:8] = 0
    return a, b, e, r


@pytest.mark.parametrize("q,n", [(2000, 3), (333, 1)])
def test_sample_union_kernel_bitwise(cuda, q, n):
    ev = _events(3000, 50, seed=3)
    g = build_temporal_graph(ev, num_nodes=ev.num_nodes + 1, device=cuda)
    a, b, e, r = _pair_queries(g, q, seed=q)
    args = [torch.from_numpy(x).to(cuda) for x in (a, b, e)]
    u = torch.from_numpy(r.rand(q, n).astype(np.float32)).to(cuda)
    before = sample_union.launches
    got = sample_union(g, *args, u)
    want = sample_union_plain(g, *args, u)
    torch.cuda.synchronize()
    assert sample_union.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert not got[1][4:8].any() and got[1].any()


@pytest.mark.parametrize("q", [6000, 129])
def test_sample_masked_kernel_bitwise(cuda, q):
    ev = _events(3000, 50, seed=4)
    g = build_temporal_graph(ev, num_nodes=ev.num_nodes + 1, device=cuda)
    a, b, e, r = _pair_queries(g, q, seed=q)
    va1, va2, vb1 = (ev.dst[r.randint(0, len(ev), q)].astype(np.int32)
                     for _ in range(3))
    wild = r.rand(q) < 0.3
    args = [torch.from_numpy(x).to(cuda)
            for x in (a, b, e, va1, va2, vb1, wild)]
    u = torch.from_numpy(r.rand(q).astype(np.float32)).to(cuda)
    before = sample_masked.launches
    got = sample_masked(g, *args, u)
    want = sample_masked_plain(g, *args, u)
    torch.cuda.synchronize()
    assert sample_masked.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    found = got[4].cpu().numpy()
    assert found[wild].any() and found[~wild].any() and not found.all()


HUB, PROBES = 1, {50: 1, 51: 31, 52: 32, 53: 33}   # node: degree
NO_EVENTS = 54


def hub_events(hub_degree, num_times, num_background, seed, probes=PROBES):
    """A stream with one hub: ``hub_degree`` events of node 1, most of them
    with neighbour 2 or 3 (long runs of one neighbour in the secondary CSR)
    at ``num_times`` distinct timestamps (many events at each); the
    ``probes`` nodes ({node: degree}; by default 50-53 of degree 1, 31, 32
    and 33), all with neighbour 4; node 54 without events;
    ``num_background`` events among nodes 2-40. Returns the numpy arrays
    (src, dst, ts, label, e_idx), in time order."""
    r = np.random.RandomState(seed)
    hub_ngh = r.choice([2, 3, 5], hub_degree, p=[0.6, 0.3, 0.1])
    probe_src = np.concatenate([np.full(d, v) for v, d in probes.items()])
    src = np.concatenate([np.full(hub_degree, HUB), probe_src,
                          r.randint(2, 41, num_background)])
    dst = np.concatenate([hub_ngh, np.full(len(probe_src), 4),
                          r.randint(2, 41, num_background)])
    ts = r.randint(0, num_times, len(src)).astype(np.float32)
    order = np.argsort(ts, kind="stable")
    n = len(src)
    return (src[order].astype(np.int32), dst[order].astype(np.int32),
            ts[order], np.zeros(n, np.float32),
            np.arange(1, n + 1, dtype=np.int32))


def hub_queries(src, dst, q, seed):
    """sample_masked's queries on ``hub_events``: nodes the hub (about 40%),
    the probe nodes, the node without events or any other; edge cuts at
    the hub's own events (their times repeat) or anywhere; candidates the
    hub's runs, the probes' neighbour or any node; node 0 and edge 0 probes;
    30% wildcard. Numpy (a, b, eid_cut, va1, va2, vb1, wildcard, u)."""
    r = np.random.RandomState(seed)
    special = np.array([HUB, *PROBES, NO_EVENTS])

    def nodes():
        return np.where(r.rand(q) < 0.4, HUB,
                        np.where(r.rand(q) < 0.5, r.choice(special, q),
                                 r.randint(0, 60, q))).astype(np.int32)

    def cands(pool):
        return np.where(r.rand(q) < 0.7, r.choice(pool, q),
                        r.randint(0, 60, q)).astype(np.int32)
    a, b = nodes(), nodes()
    hub_eids = np.flatnonzero(src == HUB) + 1
    e = np.where(r.rand(q) < 0.5, r.choice(hub_eids, q),
                 r.randint(0, len(src) + 1, q)).astype(np.int32)
    a[1:4] = 0
    e[4:8] = 0
    va1, va2, vb1 = cands([2, 4]), cands([3, 5]), cands([2, 3, 4])
    wild = r.rand(q) < 0.3
    # query 0 finds a candidate: the hub's run of neighbour 2 before its
    # last event
    wild[0] = False
    a[0], b[0], e[0], va1[0], vb1[0] = HUB, HUB, hub_eids[-1], 2, 2
    return a, b, e, va1, va2, vb1, wild, r.rand(q).astype(np.float32)


@pytest.mark.parametrize("q", [6000, 129, 1])
def test_sample_masked_kernel_bitwise_on_a_hub(cuda, q):
    ev = EventStream(*hub_events(5000, 200, 2000, seed=12))
    g = build_temporal_graph(ev, num_nodes=60, device=cuda)
    deg = (g.off[1:] - g.off[:-1]).cpu().numpy()
    assert deg[HUB] > 4096 and deg[NO_EVENTS] == 0
    assert [deg[v] for v in PROBES] == list(PROBES.values())
    *ints, wild, u = hub_queries(ev.src, ev.dst, q, seed=q)
    args = [torch.from_numpy(x).to(cuda) for x in (*ints, wild)]
    u = torch.from_numpy(u).to(cuda)
    before = sample_masked.launches
    got = sample_masked(g, *args, u)
    want = sample_masked_plain(g, *args, u)
    torch.cuda.synchronize()
    assert sample_masked.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    found = got[4].cpu().numpy()
    assert found[0]
    if q > 1:
        assert found[wild].any() and found[~wild].any() and not found.all()


# sample_rows' probe nodes: degrees at the edges of a 31-lane group's
# rounds (a slice of at most 31 events is tested whole; 32^2 = 1,024),
# beside the hub's 5,000 (3 rounds)
ROW_PROBES = {50: 1, 51: 31, 52: 32, 53: 33, 55: 30, 56: 1023, 57: 1024}


@pytest.mark.parametrize("q", [1, 100, 2000, 5120])
@pytest.mark.parametrize("n", [1, 20, 33])
@pytest.mark.parametrize("edge_cut", [False, True])
def test_sample_rows_kernel_bitwise_on_a_hub(cuda, q, n, edge_cut):
    """Queries on the hub, the probe nodes, the node without events, node 0
    and others; cuts at the hub's own timestamps (repeated many times),
    anywhere, and at 0; edge cuts at the hub's events, anywhere, or edge
    0. n 33 takes more draws than a warp has lanes."""
    _sample_rows_on_a_hub(cuda, q, n, edge_cut)


@pytest.mark.parametrize("q", [12800, 40000])
@pytest.mark.parametrize("edge_cut", [False, True])
def test_sample_rows_kernel_bitwise_at_tgat_hop3(cuda, q, edge_cut):
    """The 3-layer TGAT's hop 3 at n 20: Q 12,800 (training, batch 32) and
    40,000 (the explainer, batch 100)."""
    _sample_rows_on_a_hub(cuda, q, 20, edge_cut)


@pytest.mark.parametrize("n", [3073, 4096])
@pytest.mark.parametrize("edge_cut", [False, True])
def test_sample_rows_kernel_bitwise_above_48kb(cuda, n, edge_cut):
    """n above 3,072: the picks' shared memory (16 n bytes a block) passes
    48 KB and the kernel opts in to more."""
    _sample_rows_on_a_hub(cuda, 129, n, edge_cut)


def _sample_rows_on_a_hub(cuda, q, n, edge_cut):
    src, dst, ts, label, e_idx = hub_events(5000, 200, 2000, seed=13,
                                            probes=ROW_PROBES)
    g = build_temporal_graph(EventStream(src, dst, ts, label, e_idx),
                             num_nodes=60, device=cuda)
    deg = (g.off[1:] - g.off[:-1]).cpu().numpy()
    assert deg[HUB] == 5000 and deg[NO_EVENTS] == 0
    assert [deg[v] for v in ROW_PROBES] == list(ROW_PROBES.values())
    r = np.random.RandomState(q + n)
    special = np.array([0, HUB, NO_EVENTS, *ROW_PROBES])
    nodes = np.where(r.rand(q) < 0.4, HUB,
                     np.where(r.rand(q) < 0.6, r.choice(special, q),
                              r.randint(0, 60, q))).astype(np.int32)
    hub_rows = np.flatnonzero(src == HUB)
    times = np.where(r.rand(q) < 0.5, ts[r.choice(hub_rows, q)],
                     r.rand(q) * 220).astype(np.float32)
    times[r.rand(q) < 0.05] = 0.0
    eids = np.where(r.rand(q) < 0.5, e_idx[r.choice(hub_rows, q)],
                    r.randint(0, len(src) + 1, q)).astype(np.int32)
    eids[r.rand(q) < 0.05] = 0
    u = r.rand(q, n).astype(np.float32)
    nodes, times, eids, u = (torch.from_numpy(x).to(cuda)
                             for x in (nodes, times, eids, u))
    e = eids if edge_cut else None
    before = sample_rows.launches
    got = sample_rows(g, nodes, times, u, e)
    want = sample_rows_plain(g, nodes, times, u, e)
    torch.cuda.synchronize()
    assert sample_rows.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if q > 1:
        assert got[0].any() and not got[0].all()


# sample_union's probe nodes: sample_rows' and the edges of a 16-lane
# group's rounds (a slice of at most 16 events is tested whole; 17^2 = 289),
# beside the hub's 5,000 (4 rounds)
UNION_PROBES = {**ROW_PROBES, 58: 16, 59: 17, 60: 289, 61: 290}
UNION_NODES = 64


def union_queries(src, q, n, seed, probes=UNION_PROBES):
    """sample_union's queries on ``hub_events``: nodes the hub (about 40%),
    the probe nodes, the node without events, node 0 or any other; b equal
    to a on about a fifth of the rows; edge cuts at the hub's own events
    (their times repeat, so the cut falls on ties) or anywhere; node 0 and
    edge 0 probes; query 0 the hub on both sides, cut at its last event.
    Numpy (a, b, eid_cut, u [q, n])."""
    r = np.random.RandomState(seed)
    special = np.array([0, HUB, NO_EVENTS, *probes])

    def nodes():
        return np.where(r.rand(q) < 0.4, HUB,
                        np.where(r.rand(q) < 0.6, r.choice(special, q),
                                 r.randint(0, UNION_NODES, q))
                        ).astype(np.int32)
    a, b = nodes(), nodes()
    same = r.rand(q) < 0.2
    b[same] = a[same]
    hub_eids = np.flatnonzero(src == HUB) + 1
    e = np.where(r.rand(q) < 0.5, r.choice(hub_eids, q),
                 r.randint(0, len(src) + 1, q)).astype(np.int32)
    a[1:4] = 0
    e[4:8] = 0
    a[0], b[0], e[0] = HUB, HUB, hub_eids[-1]
    return a, b, e, r.rand(q, n).astype(np.float32)


@pytest.mark.parametrize("q", [1, 129, 2000])
@pytest.mark.parametrize("n", [1, 3, 32, 33, 40])
def test_sample_union_kernel_bitwise_on_a_hub(cuda, q, n):
    """Queries on the hub, nodes of degree 0-33, 289-290 and 1,023-1,024,
    node 0 and others, a == b on a fifth of them; edge cuts at the hub's
    own events (ties with its history), anywhere, or edge 0. n 1 is one
    lane's pick, 32 a whole warp's, 33 and 40 more picks than lanes; no Q
    is a multiple of a block's queries."""
    src, dst, ts, label, e_idx = hub_events(5000, 200, 2000, seed=14,
                                            probes=UNION_PROBES)
    g = build_temporal_graph(EventStream(src, dst, ts, label, e_idx),
                             num_nodes=UNION_NODES, device=cuda)
    deg = (g.off[1:] - g.off[:-1]).cpu().numpy()
    assert deg[HUB] == 5000 and deg[NO_EVENTS] == 0
    assert [deg[v] for v in UNION_PROBES] == list(UNION_PROBES.values())
    a, b, e, u = (torch.from_numpy(x).to(cuda)
                  for x in union_queries(src, q, n, seed=q + n))
    before = sample_union.launches
    got = sample_union(g, a, b, e, u)
    want = sample_union_plain(g, a, b, e, u)
    torch.cuda.synchronize()
    assert sample_union.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert got[1][0].all()
    if q > 1:
        assert not got[1][4:8].any() and not got[1].all()


@pytest.mark.parametrize("b,s,t", [(100, 180, 20), (100, 180, 400),
                                   (3, 7, 5)])
def test_walk_to_edge_kernels_match_plain(cuda, b, s, t):
    r = np.random.RandomState(s + t)
    ids = torch.from_numpy(r.randint(0, 30, (b, s)).astype(np.int32))
    imp = torch.from_numpy(r.rand(b, s).astype(np.float32))
    tgt = torch.from_numpy(r.randint(0, 40, (b, t)).astype(np.int32))
    imp[0, :] = 0.25                  # exact ties among matching slots
    imp[1, :] = 0.0                   # a max of 0 ties with the fill
    tgt[2, :] = 99                    # a row whose targets match nothing
    ids, imp, tgt = ids.to(cuda), imp.to(cuda), tgt.to(cuda)
    ct = torch.from_numpy(r.randn(b, t).astype(np.float32)).to(cuda)
    before = (walk_to_edge_fwd.launches, walk_to_edge_bwd.launches)
    leaf = imp.clone().requires_grad_()
    out = walk_to_edge(ids, leaf, tgt)
    (g_imp,) = torch.autograd.grad(out, [leaf], ct)
    ref_leaf = imp.clone().requires_grad_()
    ref = walk_to_edge_plain(ids, ref_leaf, tgt)
    (g_ref,) = torch.autograd.grad(ref, [ref_leaf], ct)
    torch.cuda.synchronize()
    assert (walk_to_edge_fwd.launches, walk_to_edge_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out, ref)
    torch.testing.assert_close(g_imp, g_ref, rtol=1e-5, atol=1e-5)
    assert not out[2].any()


def _padded_walks(s, t, seed):
    """16 rows of walk slots and targets, about 80% of both id 0 (padding
    walks and edges): in the even rows every slot of id 0 has importance
    0.5, so each such slot attains the max of every target of id 0 and sums
    hundreds of shares."""
    r = np.random.RandomState(seed)
    b = 16
    ids = np.where(r.rand(b, s) < 0.8, 0, r.randint(1, 30, (b, s)))
    tgt = np.where(r.rand(b, t) < 0.8, 0, r.randint(1, 30, (b, t)))
    imp = r.rand(b, s).astype(np.float32)
    imp[0::2][ids[0::2] == 0] = 0.5
    ct = r.randn(b, t).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(imp),
            torch.from_numpy(tgt.astype(np.int32)), torch.from_numpy(ct))


@pytest.mark.parametrize("s", [1, 180])
@pytest.mark.parametrize("t", [1, 20, 33, 400])
def test_walk_to_edge_kernels_with_padding_ids(cuda, s, t):
    ids, imp, tgt, ct = (x.to(cuda) for x in _padded_walks(s, t, seed=s + t))
    out, cnt = walk_to_edge_fwd(ids, imp, tgt)
    g_imp = walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct)
    leaf = imp.clone().requires_grad_()
    ref = walk_to_edge_plain(ids, leaf, tgt)
    (g_ref,) = torch.autograd.grad(ref, [leaf], ct)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    torch.testing.assert_close(g_imp, g_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [20, 400])
def test_walk_to_edge_bwd_is_deterministic(cuda, t):
    ids, imp, tgt, ct = (x.to(cuda) for x in _padded_walks(180, t, seed=t))
    out, cnt = walk_to_edge_fwd(ids, imp, tgt)
    first = walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct)
    second = walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert (first != 0).any()


def _count_rows(b, s, t, seed):
    """``b`` rows of walk slots and targets: ids in a small range with
    importances of both signs, a row of ties at a negative value, a row
    whose matching slots all hold 0, a row whose targets match nothing, and
    the padding-heavy rows of ``_padded_walks`` (id 0 on about 80% of both
    sides)."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, 12, (b, s)).astype(np.int32)
    tgt = r.randint(0, 16, (b, t)).astype(np.int32)
    imp = (r.rand(b, s) - 0.5).astype(np.float32)
    imp[0, :] = -0.25                   # every matching slot below the fill
    imp[1, :] = 0.0                     # matching slots tie with the fill
    tgt[2, :] = 99                      # no target matches a slot
    pad_ids, pad_imp, pad_tgt, _ = _padded_walks(s, t, seed)
    k = min(16, b - 3)
    ids[3:3 + k], imp[3:3 + k] = pad_ids[:k].numpy(), pad_imp[:k].numpy()
    tgt[3:3 + k] = pad_tgt[:k].numpy()
    return (torch.from_numpy(ids), torch.from_numpy(imp),
            torch.from_numpy(tgt), torch.from_numpy(
                r.randn(b, t).astype(np.float32)))


@pytest.mark.parametrize("s", [1, 7, 33, 180, 600, 1300])
@pytest.mark.parametrize("t", [1, 20, 33, 400, 1000, 2100])
@pytest.mark.parametrize("b", [20, 100])
def test_walk_to_edge_fwd_count_matches_plain(cuda, s, t, b):
    """The forward's ``out`` bit for bit and ``cnt`` exactly, at slot
    counts from one to a table beyond 48 KB of shared memory (S 1,300) and
    target counts from one to more than a few blocks' 256 (T 2,100); the
    backward to rtol 1e-5, atol 1e-5 on that ``cnt`` up to T 1,000. At T
    2,100 a slot sums up to 2,100 shares, in another order than the plain
    version's, and float32 rounding reached 1.5e-5: there the backward is
    held to the bound of two float32 sums of T terms, each off the exact
    sum by at most T * 2^-24 times the sum of the terms' magnitudes, so
    |kernel - plain| <= 2 T 2^-24 sum_t |ct / cnt| per slot (the shares'
    magnitudes summed by the plain backward on |ct|)."""
    ids, imp, tgt, ct = (x.to(cuda) for x in _count_rows(b, s, t, seed=s * t))
    out, cnt = walk_to_edge_fwd(ids, imp, tgt)
    g_imp = walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct)
    leaf = imp.clone().requires_grad_()
    ref = walk_to_edge_plain(ids, leaf, tgt)
    (g_ref,) = torch.autograd.grad(ref, [leaf], ct)
    ref_cnt = walk_to_edge_count_plain(ids, imp, tgt)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.detach())
    assert torch.equal(cnt, ref_cnt)
    assert (cnt[2] == s).all() and not out[2].any()
    if t <= 1000:
        torch.testing.assert_close(g_imp, g_ref, rtol=1e-5, atol=1e-5)
    else:
        (mag,) = torch.autograd.grad(walk_to_edge_plain(ids, leaf, tgt),
                                     [leaf], ct.abs())
        bound = 2 * t * 2.0 ** -24 * mag
        assert ((g_imp - g_ref).abs() <= bound).all(), \
            ((g_imp - g_ref).abs() - bound).max().item()


@pytest.mark.parametrize("s", [4097, 8192])
@pytest.mark.parametrize("t", [20, 400, 2100])
def test_walk_to_edge_fwd_above_table_cap(cuda, s, t):
    """Rows of more than 4,096 slots, whose id table would not fit a
    block's shared memory, take the scan path: ``out`` bit for bit and
    ``cnt`` exactly, as below the cap."""
    ids, imp, tgt, _ = (x.to(cuda) for x in _count_rows(20, s, t, seed=s + t))
    before = walk_to_edge_fwd.launches
    out, cnt = walk_to_edge_fwd(ids, imp, tgt)
    ref = walk_to_edge_plain(ids, imp, tgt)
    ref_cnt = walk_to_edge_count_plain(ids, imp, tgt)
    torch.cuda.synchronize()
    assert walk_to_edge_fwd.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(cnt, ref_cnt)
    assert (cnt[2] == s).all() and not out[2].any()


def test_explainer_steps_launch_counts(cuda):
    """One explainer train step launches the sampler 6 times, the walk
    samplers 3 times each, the walk -> edge kernel and its backward 6
    times each, the eval-form attention 12 times (the labelling and the
    explained contrast) and its backward 6 times; one eval step adds the
    ratio sweep's hop-0 level (3 more ``attend``) and no backward."""
    from tempme_tpu_torch.explain.tempme import TempME
    from tempme_tpu_torch.train import temp_exp_main as X
    from tempme_tpu_torch.train.base_loader import LoadedBase
    ev = _events(3000, 60, seed=8)
    g = build_temporal_graph(ev, num_nodes=ev.num_nodes, device=cuda)
    r = np.random.RandomState(1)
    feats = Features(
        torch.from_numpy(r.randn(g.num_nodes, 16).astype(np.float32)).to(cuda),
        torch.from_numpy(r.randn(g.num_edges, 8).astype(np.float32)).to(cuda))
    model = TGN(16, 8, g.num_nodes, dropout=0.1, device=cuda)
    model.requires_grad_(False)
    base = LoadedBase("tgn", model,
                      init_memory_state(g.num_nodes, 16,
                                        model.raw_message_dim, cuda), {})
    dst = torch.from_numpy(np.unique(ev.dst)).to(cuda)
    null = torch.full((12,), 1.0 / 12, device=cuda)
    explainer = TempME(16, 8, hid_dim=16, device=cuda)
    opt = torch.optim.Adam(explainer.parameters(), lr=1e-3)
    step = X.ExplainerTrainStep(explainer, base, g, feats, dst, 5, null, opt)
    batch = L.Batch(*(x[0] for x in L.stack_batches(ev, 32, True, 0, cuda)))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    kernels = (sample_rows, sample_union, sample_masked, walk_to_edge_fwd,
               walk_to_edge_bwd, attend, attend_drop, attend_bwd)
    before = [f.launches for f in kernels]
    aux = step(batch, step.draw(gen, 32))
    torch.cuda.synchronize()
    assert torch.isfinite(aux["loss"])
    assert [f.launches - b for f, b in zip(kernels, before)] == [
        6, 3, 3, 6, 6, 12, 0, 6]
    eval_step = X.ExplainerEvalStep(explainer, base, g, feats, dst, 5, null)
    before = [f.launches for f in kernels]
    out = eval_step(batch, eval_step.draw(gen, 32))
    torch.cuda.synchronize()
    assert out["pos_r"].shape == (16, 32)
    assert [f.launches - b for f, b in zip(kernels, before)] == [
        6, 3, 3, 6, 0, 15, 0, 0]
