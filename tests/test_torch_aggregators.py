"""TGAT's variant blocks and time encodings against the JAX modules on the
CPU.

Each port module (``ops/aggregators.py``: ``MapBasedTemporalAttention``,
``MapAttnLayer``, ``LSTMPool``, ``MeanPool``; ``ops/encodings.py``:
``PosEncode``, ``EmptyEncode``) takes the JAX module's weights through
``utils/convert.py`` and the same seeded numpy inputs, padding included.
Outputs agree to rtol 1e-5, atol 1e-6 (float32 sums in another order;
the LSTM's 20 steps of it), the attention probabilities too, and the
position encoding exactly (a table lookup; tied time deltas keep their
order under both packages' stable sorts). Explain weights of all ones
give map attention's output without them; the pools refuse explain
weights, as the JAX modules do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.ops import aggregators as JA
from tempme_tpu.ops import encodings as JEnc
from tempme_tpu_torch.ops import aggregators as A
from tempme_tpu_torch.ops import encodings as E
from tempme_tpu_torch.ops.attention import AttnDraws
from tempme_tpu_torch.utils.convert import flax_to_state_dict

BQ, N, DF, DE, DT, H = 6, 20, 10, 4, 10, 2
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0):
    """Raw block inputs: src [Bq, Df], src_t [Bq, 1, Dt], seq [Bq, n, Df],
    seq_t [Bq, n, Dt], seq_e [Bq, n, De], mask [Bq, n] (row 0 all padding,
    row 1 none)."""
    r = np.random.RandomState(seed)
    f = np.float32
    xs = (r.randn(BQ, DF).astype(f), r.randn(BQ, 1, DT).astype(f),
          r.randn(BQ, N, DF).astype(f), r.randn(BQ, N, DT).astype(f),
          r.randn(BQ, N, DE).astype(f))
    mask = r.rand(BQ, N) < 0.3
    mask[0] = True
    mask[1] = False
    return xs + (mask,)


def _both(jmod, tmod, inputs, **kw):
    """Init ``jmod`` on ``inputs``, carry its weights into ``tmod``, run
    both: (JAX outputs, port outputs)."""
    params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs),
                       **kw)
    tmod.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    ref = jmod.apply(params, *map(jnp.asarray, inputs), **kw)
    with torch.no_grad():
        out = tmod(*map(_t, inputs), **kw)
    return ref, out


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("explained", [False, True])
def test_map_attn_layer_matches_jax(explained):
    inputs = _inputs(1)
    kw = {}
    if explained:
        kw["explain_weight"] = np.random.RandomState(2).rand(BQ, N).astype(
            np.float32)
    jmod = JA.MapAttnLayer(feat_dim=DF, edge_dim=DE, time_dim=DT, n_head=H,
                           dropout=0.0)
    tmod = A.MapAttnLayer(DF, DE, DT, H)
    params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tmod.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    (ref, ref_attn) = jmod.apply(params, *map(jnp.asarray, inputs),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out, attn = tmod(*map(_t, inputs),
                         **{k: _t(v) for k, v in kw.items()})
    # d_k truncates: (10 + 4 + 10) // 2 = 12
    assert tmod.map_attn.d_k == (DF + DE + DT) // H
    _close(out, ref)
    _close(attn, ref_attn)
    if not explained:
        with torch.no_grad():
            ones, _ = tmod(*map(_t, inputs),
                           explain_weight=torch.ones(BQ, N))
        torch.testing.assert_close(ones, out, rtol=0, atol=0)


def test_map_attention_dropout_sites():
    """The training form drops where the draws fall below the rate and
    scales the rest by 1 / (1 - rate), on the probabilities and after
    ``fc``; draws of all ones are the eval form."""
    torch.manual_seed(0)
    m = A.MapBasedTemporalAttention(H, 24, 12, dropout=0.25)
    q, k = torch.randn(BQ, 1, 24), torch.randn(BQ, N, 24)
    ones = AttnDraws(torch.ones(BQ, 1, H, N), torch.ones(BQ, 1, 24))
    with torch.no_grad():
        ref, ref_attn = m(q, k)
        out, attn = m(q, k, draws=ones)
        torch.testing.assert_close(attn, ref_attn / 0.75)
        zeros = AttnDraws(torch.zeros(BQ, 1, H, N), torch.zeros(BQ, 1, 24))
        out0, attn0 = m(q, k, draws=zeros)
    assert (attn0 == 0).all()
    torch.testing.assert_close(out0, m.ln(q))


def test_lstm_pool_matches_jax():
    inputs = _inputs(3)
    ref, out = _both(JA.LSTMPool(feat_dim=DF, edge_dim=DE, time_dim=DT),
                     A.LSTMPool(DF, DE, DT), inputs)
    assert out[1] is None
    _close(out[0], ref[0])


def test_mean_pool_matches_jax():
    inputs = _inputs(4)
    ref, out = _both(JA.MeanPool(feat_dim=DF, edge_dim=DE),
                     A.MeanPool(DF, DE), inputs)
    _close(out[0], ref[0])


@pytest.mark.parametrize("pool", [A.LSTMPool(DF, DE, DT),
                                  A.MeanPool(DF, DE)])
def test_pools_refuse_explain_weights(pool):
    with pytest.raises(ValueError, match="explain weights"):
        pool(*map(_t, _inputs()), explain_weight=torch.ones(BQ, N))


def test_pos_encode_matches_jax_with_ties():
    r = np.random.RandomState(5)
    ts = r.randint(0, 4, (7, N)).astype(np.float32)   # many ties
    ts[0] = 0.0                                       # a padded row
    jmod = JEnc.PosEncode(dim=DT, seq_len=32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ts))
    tmod = E.PosEncode(DT, 32)
    tmod.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    assert tmod.pos_table.shape == (32, DT)
    with torch.no_grad():
        out = tmod(_t(ts))
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jmod.apply(params, jnp.asarray(ts))))
    np.testing.assert_array_equal(out[0].numpy(), tmod.pos_table[:N]
                                  .detach().numpy())
    with pytest.raises(ValueError, match="seq_len"):
        E.PosEncode(DT, N - 1)(_t(ts))


def test_empty_encode_and_factory():
    ts = _t(np.arange(6, dtype=np.float32).reshape(2, 3))
    out = E.make_time_encoder("empty", DT)(ts)
    assert out.shape == (2, 3, DT) and (out == 0).all()
    assert isinstance(E.make_time_encoder("time", DT), E.TimeEncode)
    assert isinstance(E.make_time_encoder("pos", DT, 8), E.PosEncode)
    assert not list(E.EmptyEncode(DT).parameters())
    with pytest.raises(ValueError, match="unknown time encoding"):
        E.make_time_encoder("clock", DT)
