"""The port's attention against the JAX package on the CPU.

* The ``attend`` kernel's plain version against ``_attend_jnp`` and against
  ``fused_attend`` run in Pallas interpret mode, with a mask, an explain
  weight and rows whose keys are all masked: float32, rtol 1e-5 and atol
  1e-6 (the only differences are the order of the float32 sums).
* ``SplitTemporalAttention`` and ``TGNAttnLayer`` after
  ``utils/convert.py`` against the flax modules at float32 compute: rtol
  1e-5, atol 1e-5 (sum order through three chained matmuls and a
  LayerNorm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401

from tempme_tpu.models.tgn import TGNAttnLayer as JaxTGNAttnLayer
from tempme_tpu.ops.attention import SplitTemporalAttention as JaxSplit
from tempme_tpu.ops.pallas import kernels as pk
from tempme_tpu_torch.models.tgn import TGNAttnLayer
from tempme_tpu_torch.ops.attention import SplitTemporalAttention
from tempme_tpu_torch.ops.kernels.attend import attend, attend_plain
from tempme_tpu_torch.utils.convert import flax_to_state_dict


def _inputs(seed=0, m=12, n=5, h=2, dk=9):
    r = np.random.RandomState(seed)
    q = r.randn(m, h, dk).astype(np.float32)
    k = r.randn(m, n, h, dk).astype(np.float32)
    v = r.randn(m, n, h, dk).astype(np.float32)
    mask = r.rand(m, n) < 0.3
    mask[:2] = True                     # rows whose keys are all masked
    ew = r.rand(m, n).astype(np.float32)
    return q, k, v, mask, ew


def _flat_jax(q, k, v, mask, ew):
    """The port's [m, n, h, dk] layout -> fused_attend's flattened rows."""
    m, h, dk = q.shape
    n = k.shape[1]
    k2 = k.transpose(0, 2, 1, 3).reshape(m * h, n, dk)
    v2 = v.transpose(0, 2, 1, 3).reshape(m * h, n, dk)
    m2 = np.repeat(mask, h, axis=0).astype(np.float32)
    w2 = np.repeat(ew, h, axis=0)
    return q.reshape(m * h, dk), k2, v2, m2, w2


@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("with_mask_ew", [True, False])
def test_attend_plain_matches_jax(ref, with_mask_ew):
    q, k, v, mask, ew = _inputs()
    m, h, dk = q.shape
    n = k.shape[1]
    if not with_mask_ew:
        mask, ew = np.zeros_like(mask), np.ones_like(ew)
    scale = 1.0 / np.sqrt(dk)
    if ref == "jnp":
        out_r, attn_r = pk._attend_jnp(*_flat_jax(q, k, v, mask, ew), scale)
    else:
        out_r, attn_r = pk.fused_attend(
            jnp.asarray(q)[:, None], jnp.asarray(k)[:, None],
            jnp.asarray(v)[:, None],
            jnp.asarray(mask).reshape(m, 1, 1, n),
            jnp.asarray(ew).reshape(m, 1, 1, n), scale)
    t = [torch.from_numpy(x) for x in (q, k, v, mask, ew)]
    if not with_mask_ew:
        t[3] = t[4] = None
    out, attn = attend_plain(*t, scale=scale)
    np.testing.assert_allclose(out.reshape(m, h * dk).numpy(),
                               np.asarray(out_r).reshape(m, h * dk),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(attn.numpy(),
                               np.asarray(attn_r).reshape(m, h, n),
                               rtol=1e-5, atol=1e-6)
    # an all-masked row attends uniformly (times the explain weight)
    if with_mask_ew:
        np.testing.assert_allclose(attn[0, 0].numpy(), ew[0] / n, rtol=1e-6)


def test_attend_wrapper_is_plain_on_cpu():
    t = [torch.from_numpy(x) for x in _inputs(seed=1)]
    a = attend(*t, scale=0.3)
    b = attend_plain(*t, scale=0.3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        attend(t[0], t[1][:, :, :1], t[2], t[3], t[4])


def _params_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _init_all(module, key, call_args, node_x, edge_x, **kw):
    """flax creates the node/edge projections only when ``project_*`` runs,
    so initialise those methods too and merge the trees."""
    params = module.init(key, *call_args, **kw)
    for method, x in ((module.project_node, node_x),
                      (module.project_edge, edge_x)):
        extra = module.init(key, x, method=method)
        for name, sub in extra["params"].items():
            params["params"].setdefault(name, {}).update(sub)
    return params


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_split_attention_matches_jax(monkeypatch, pallas):
    monkeypatch.setenv("TEMPME_PALLAS", pallas)
    b, nq, n, h, dk = 3, 2, 4, 2, 6
    dn, de, dt = 8, 5, 8
    d_model = dn + dt
    r = np.random.RandomState(2)
    q_node = r.randn(b, nq, dn).astype(np.float32)
    q_time = r.randn(b, nq, dt).astype(np.float32)
    residual = np.concatenate([q_node, q_time], -1)
    k_nv, v_nv, k_ev, v_ev = (r.randn(b, nq * n, h * dk).astype(np.float32)
                              for _ in range(4))
    ngh_time = r.randn(b, nq * n, dt).astype(np.float32)
    mask = r.rand(b, nq * n) < 0.3
    mask[0, :n] = True
    ew = r.rand(b, nq * n).astype(np.float32)
    jm = JaxSplit(n_head=h, d_model=d_model, d_k=dk, d_node=dn, d_edge=de,
                  d_time=dt, dropout=0.0, compute_dtype=jnp.float32)
    args = (q_node, q_time, residual, k_nv, v_nv, k_ev, v_ev, ngh_time)
    params = _init_all(jm, jax.random.PRNGKey(0), args, q_node, k_ev[..., :de],
                       mask=mask, explain_weight=ew)
    out_r, attn_r = jm.apply(params, *args, mask=mask, explain_weight=ew)
    tm = SplitTemporalAttention(h, d_model, dk, dn, de, dt,
                                compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(_params_np(params)))
    with torch.no_grad():
        out, attn = tm(*(torch.from_numpy(x) for x in args),
                       mask=torch.from_numpy(mask),
                       explain_weight=torch.from_numpy(ew))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_r),
                               rtol=1e-5, atol=1e-5)


def test_tgn_attn_layer_matches_jax():
    bq, n, dn, de, h = 6, 4, 8, 5, 2
    dk = -(-2 * dn // h)
    r = np.random.RandomState(3)
    src_feat = r.randn(bq, dn).astype(np.float32)
    src_t = r.randn(bq, 1, dn).astype(np.float32)
    k_nv, v_nv, k_ev, v_ev = (r.randn(bq, n, h * dk).astype(np.float32)
                              for _ in range(4))
    e_t = r.randn(bq, n, dn).astype(np.float32)
    mask = r.rand(bq, n) < 0.3
    mask[1] = True
    jl = JaxTGNAttnLayer(node_dim=dn, edge_dim=de, time_dim=dn, n_head=h,
                         dropout=0.0, compute_dtype=jnp.float32)
    args = (src_feat, src_t, k_nv, v_nv, k_ev, v_ev, e_t, mask)
    params = _init_all(jl, jax.random.PRNGKey(1), args, src_feat,
                       r.randn(bq, de).astype(np.float32))
    out_r, attn_r = jl.apply(params, *args)
    tl = TGNAttnLayer(dn, de, dn, h, compute_dtype=torch.float32)
    tl.load_state_dict(flax_to_state_dict(_params_np(params)))
    with torch.no_grad():
        out, attn = tl(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_r),
                               rtol=1e-5, atol=1e-5)


def test_bf16_weight_casts_are_kept_while_no_gradient_flows():
    """At the bf16 default the weights are cast per call while a gradient
    flows to them, and cast once and reused otherwise (under ``no_grad``,
    or frozen as the explainer's base is) until they are written in place;
    the outputs are the same either way."""
    b, nq, n, h, dk, dn, de, dt = 3, 1, 4, 2, 6, 8, 5, 8
    torch.manual_seed(0)
    tm = SplitTemporalAttention(h, dn + dt, dk, dn, de, dt)
    r = np.random.RandomState(4)
    q_node, q_time = (torch.from_numpy(r.randn(b, nq, d).astype(np.float32))
                      for d in (dn, dt))
    ngh = torch.from_numpy(r.randn(b, nq * n, dn).astype(np.float32))
    edge = torch.from_numpy(r.randn(b, nq * n, de).astype(np.float32))
    ngh_time = torch.from_numpy(r.randn(b, nq * n, dt).astype(np.float32))

    def run():
        k_nv, v_nv = tm.project_node(ngh)
        k_ev, v_ev = tm.project_edge(edge)
        out, _ = tm(q_node, q_time, torch.cat([q_node, q_time], -1), k_nv,
                    v_nv, k_ev, v_ev, ngh_time)
        return out

    def cached():
        return {k: v[3] for k, v in tm._casts.items()}

    fresh = run()
    assert fresh.requires_grad and not tm._casts
    with torch.no_grad():
        first = run()
        casts = cached()
        again = run()
    assert len(casts) == 10                 # 8 projections, fc and its bias
    assert all(cached()[k] is c for k, c in casts.items())
    assert all(c.dtype == torch.bfloat16 for c in casts.values())
    assert torch.equal(first, fresh.detach()) and torch.equal(again, first)
    with torch.no_grad():
        tm.fc.weight.mul_(2.0)               # as an optimiser step would
        tm.wq_time.weight.add_(0.5)
        written = run()
    assert cached()[id(tm.fc.weight)] is not casts[id(tm.fc.weight)]
    assert cached()[id(tm.wk_node.weight)] is casts[id(tm.wk_node.weight)]
    assert torch.equal(written, run().detach())
    assert not torch.equal(written, first)
    tm.requires_grad_(False)                 # frozen: cached with grad on
    casts = cached()
    frozen = run()
    assert torch.equal(frozen, written)
    assert all(cached()[k] is c for k, c in casts.items())
