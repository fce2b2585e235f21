"""The variant blocks on the card against the CPU (skipped without a CUDA
device; no JAX: run it on the card with ``python -m pytest --noconftest
tests/test_torch_variants_cuda.py``).

* ``LSTMPool``: output and every parameter's gradient, rtol 1e-4 and atol
  1e-5 of each tensor's largest (float32 GEMMs and fused cells summed in
  another order). The bias gradient is the case that once failed: the
  card's fused LSTM cell gives none when the cell's input bias is absent.
* Map attention and the pos encoding: output and gradients likewise
  (map attention's query-side score parameters, whose gradients are zero
  in exact arithmetic, against the module's largest gradient).
* The exp-decay and binary samplers: ids, edge ids and timestamps bit
  for bit, as ``chip_smoke.py`` [sampler-modes] holds them at full size.
"""
import numpy as np
import pytest
import torch

from tempme_tpu_torch.data.events import EventStream
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.ops import aggregators as A
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.encodings import PosEncode


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: it holds the card against the CPU")
    return torch.device("cuda")


def _grads_close(mod_c, mod_g):
    """Map attention's query-side score is the same for every key of a
    query, so the softmax removes it: those gradients are round-off, held
    against the module's largest gradient."""
    model_top = max(p.grad.abs().max().item() for p in mod_c.parameters())
    for (name, p), q in zip(mod_c.named_parameters(), mod_g.parameters()):
        assert q.grad is not None, name
        zero = name.endswith(("weight_map_q", "wq_node_transform.weight"))
        top = model_top if zero else max(p.grad.abs().max().item(), 1e-30)
        torch.testing.assert_close(q.grad.cpu(), p.grad,
                                   rtol=0.0 if zero else 1e-4,
                                   atol=1e-5 * top, msg=name)


@pytest.mark.parametrize("block", ["lstm", "map"])
def test_block_and_gradients_match_the_cpu(cuda, block):
    torch.manual_seed(0)
    bq, n, df, de, dt = 300, 20, 24, 8, 24
    mod_c = A.LSTMPool(df, de, dt) if block == "lstm" else \
        A.MapAttnLayer(df, de, dt, 2)
    mod_g = A.LSTMPool(df, de, dt) if block == "lstm" else \
        A.MapAttnLayer(df, de, dt, 2)
    mod_g.load_state_dict(mod_c.state_dict())
    mod_g.to(cuda)
    xs = (torch.randn(bq, df), torch.randn(bq, 1, dt), torch.randn(bq, n, df),
          torch.randn(bq, n, dt), torch.randn(bq, n, de))
    mask = torch.rand(bq, n) < 0.3
    out_c, _ = mod_c(*xs, mask)
    out_g, _ = mod_g(*(x.to(cuda) for x in xs), mask.to(cuda))
    torch.testing.assert_close(out_g.cpu(), out_c, rtol=1e-4, atol=1e-5)
    out_c.square().sum().backward()
    out_g.square().sum().backward()
    _grads_close(mod_c, mod_g)


def test_pos_encode_gradient_matches_the_cpu(cuda):
    torch.manual_seed(1)
    enc_c = PosEncode(16, 64)
    enc_g = PosEncode(16, 64)
    enc_g.load_state_dict(enc_c.state_dict())
    enc_g.to(cuda)
    ts = torch.randint(0, 5, (4000, 20)).float()       # ties
    w = torch.randn(4000, 20, 16)
    (enc_c(ts) * w).sum().backward()
    (enc_g(ts.to(cuda)) * w.to(cuda)).sum().backward()
    _grads_close(enc_c, enc_g)


@pytest.mark.parametrize("method", ["multinomial", "binary"])
def test_decay_sampling_matches_the_cpu_bit_for_bit(cuda, method):
    r = np.random.RandomState(2)
    m = 3000
    ev = EventStream(r.randint(1, 12, m).astype(np.int32),
                     r.randint(1, 12, m).astype(np.int32),
                     np.sort(r.randint(0, 900, m)).astype(np.float32),
                     np.zeros(m, np.float32),
                     np.arange(1, m + 1, dtype=np.int32))
    g_c = build_temporal_graph(ev, 14, device="cpu")
    g_g = build_temporal_graph(ev, 14, device=cuda)
    q, n = 500, 10
    nodes = torch.from_numpy(r.randint(0, 14, q).astype(np.int32))
    times = torch.from_numpy(r.uniform(0, 950, q).astype(np.float32))
    chunks = S.decay_chunks(g_c, nodes, times)
    gumbel = S.draw_gumbel(torch.Generator().manual_seed(3), chunks, q, n,
                           "cpu")
    want = S.sample_neighbors(g_c, gumbel, nodes, times, n, bias=0.01,
                              sample_method=method)
    got = S.sample_neighbors(g_g, gumbel.to(cuda), nodes.to(cuda),
                             times.to(cuda), n, bias=0.01,
                             sample_method=method)
    assert chunks >= 3
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
