"""The training form of the port's attention against the JAX package on the
CPU, forward and VJP.

* ``attend_drop_plain`` (and ``attend_drop`` / ``attend_bwd`` on CPU
  tensors, which take it) against ``fused_attend`` with ``drop_u`` run in
  Pallas interpret mode and against ``_attend_drop_jnp``, with the same
  q, k, v, mask, explain weight and draws, rates 0.1 and 0.5, and rows whose
  keys are all masked; the eval form's VJP against ``fused_attend``'s.
  Forward rtol 1e-5, atol 1e-6 and VJP rtol 1e-5, atol 1e-5: float32 sums
  in another order (the VJP's sums run over up to n * dk terms).
* ``SplitTemporalAttention`` in training form with injected draws against
  the flax module at float32 compute, through its jnp path and its Pallas
  path (interpret mode): the flax module's dropout draws are replaced by
  the same uniforms (``nn.intercept_methods`` on ``nn.Dropout``, and
  ``jax.random.uniform`` for the Pallas path's draws). Output, attention
  and every parameter's gradient: rtol 1e-5, atol 1e-5 (sum order through
  three chained matmuls and a LayerNorm).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attention import _flat_jax, _init_all, _inputs
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.ops.attention import SplitTemporalAttention as JaxSplit
from tempme_tpu.ops.pallas import kernels as pk
from tempme_tpu_torch.ops.attention import AttnDraws, SplitTemporalAttention
from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                 attend_drop,
                                                 attend_drop_plain)
from tempme_tpu_torch.utils.convert import flax_to_state_dict


def _draws(m, h, n, seed):
    u = np.random.RandomState(seed).rand(m, h, n).astype(np.float32)
    u[1, 0, :2] = [0.0, 0.99]          # a dropped and a kept probability
    return u


def _cotangents(m, h, n, dk, seed):
    r = np.random.RandomState(seed)
    return (r.randn(m, h, dk).astype(np.float32),
            r.randn(m, h, n).astype(np.float32))


def _jax_vjp(ref, q, k, v, mask, ew, u, rate, dout, dattn):
    """(out [m, h, dk], attn [m, h, n], dq, dk, dv) of the JAX package's
    ``ref`` ("jnp": ``_attend_drop_jnp``, "pallas_interpret":
    ``fused_attend``) in the port's layouts."""
    m, h, dk = q.shape
    n = k.shape[1]
    scale = 1.0 / np.sqrt(dk)
    if ref == "jnp":
        _, k2, v2, m2, w2 = _flat_jax(q, k, v, mask, ew)

        def f(q2, k2, v2):
            if u is None:
                return pk._attend_jnp(q2, k2, v2, m2, w2, scale)
            return pk._attend_drop_jnp(q2, k2, v2, m2, w2,
                                       u.reshape(m * h, n), scale, rate)
        (out, attn), vjp = jax.vjp(f, q.reshape(m * h, dk), k2, v2)
        dq, dk2, dv2 = vjp((dout.reshape(m * h, dk),
                            dattn.reshape(m * h, n)))

        def unflat(x):
            return np.asarray(x).reshape(m, h, n, dk).transpose(0, 2, 1, 3)
        return (np.asarray(out).reshape(m, h, dk),
                np.asarray(attn).reshape(m, h, n),
                np.asarray(dq).reshape(m, h, dk), unflat(dk2), unflat(dv2))

    def f(q5, k5, v5):
        return pk.fused_attend(
            q5, k5, v5, jnp.asarray(mask).reshape(m, 1, 1, n),
            jnp.asarray(ew).reshape(m, 1, 1, n), scale,
            None if u is None else jnp.asarray(u).reshape(m, 1, h, n), rate)
    (out, attn), vjp = jax.vjp(f, jnp.asarray(q)[:, None],
                               jnp.asarray(k)[:, None],
                               jnp.asarray(v)[:, None])
    dq, dk5, dv5 = vjp((jnp.asarray(dout).reshape(m, 1, h * dk),
                        jnp.asarray(dattn).reshape(m, 1, h, n)))
    return (np.asarray(out).reshape(m, h, dk),
            np.asarray(attn).reshape(m, h, n), np.asarray(dq)[:, 0],
            np.asarray(dk5)[:, 0], np.asarray(dv5)[:, 0])


@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_attend_drop_forward_and_vjp_match_jax(ref, rate):
    q, k, v, mask, ew = _inputs(seed=4)
    m, h, dk = q.shape
    n = k.shape[1]
    u = _draws(m, h, n, seed=5) if rate else None
    dout, dattn = _cotangents(m, h, n, dk, seed=6)
    want = _jax_vjp(ref, q, k, v, mask, ew, u, rate, dout, dattn)

    t = [torch.from_numpy(x).requires_grad_(i < 3)
         for i, x in enumerate((q, k, v, mask, ew))]
    scale = 1.0 / np.sqrt(dk)
    if rate:
        out, attn = attend_drop(*t, torch.from_numpy(u), rate, scale)
    else:
        out, attn = attend(*t, scale=scale)
    grads = torch.autograd.grad((out, attn), t[:3], (torch.from_numpy(dout),
                                                     torch.from_numpy(dattn)))
    by_wrapper = attend_bwd(*(x.detach() for x in t),
                            None if u is None else torch.from_numpy(u), rate,
                            scale, torch.from_numpy(dout),
                            torch.from_numpy(dattn))
    got = [out, attn, *grads]
    for i, (a, b) in enumerate(zip(got, want)):
        tol = dict(rtol=1e-5, atol=1e-6 if i < 2 else 1e-5)
        np.testing.assert_allclose(a.detach().numpy(), b, **tol)
    for a, b in zip(by_wrapper, grads):
        assert torch.equal(a, b)
    # masked keys get no gradient; an all-masked row (rows 0 and 1) still
    # attends uniformly, so its values do
    assert not grads[1][0].any() and grads[2][0].any()
    if rate:
        assert attn[1, 0, 0] == 0 and attn[1, 0, 1] > 0


def test_attend_drop_plain_is_the_jax_order():
    """Dropout sits between the softmax and the explain weight, scaling the
    kept probabilities by 1 / (1 - rate)."""
    q, k, v, mask, ew = (torch.from_numpy(x) for x in _inputs(seed=7))
    m, h, _ = q.shape
    n = k.shape[1]
    u = torch.from_numpy(_draws(m, h, n, seed=8))
    _, p = attend_drop_plain(q, k, v, mask, None, None, 0.0, 0.5)
    _, a = attend_drop_plain(q, k, v, mask, ew, u, 0.3, 0.5)
    want = torch.where(u >= 0.3, p / 0.7, 0.0) * ew[:, None, :]
    torch.testing.assert_close(a, want, rtol=1e-6, atol=0.0)


def _inject(u_attn, u_fc, rate):
    """A flax interceptor that applies ``nn.Dropout`` with the given
    uniforms (chosen by the input's shape) in place of flax's draws."""
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            x = args[0]
            u = u_attn if x.shape == u_attn.shape else u_fc
            assert x.shape == u.shape
            return jnp.where(u >= rate, x / (1.0 - rate), 0.0)
        return next_fun(*args, **kwargs)
    return interceptor


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_split_attention_training_form_matches_jax(monkeypatch, pallas):
    monkeypatch.setenv("TEMPME_PALLAS", pallas)
    b, nq, n, h, dk = 3, 2, 4, 2, 6
    dn, de, dt = 8, 5, 8
    d_model, rate = dn + dt, 0.3
    r = np.random.RandomState(9)
    q_node = r.randn(b, nq, dn).astype(np.float32)
    q_time = r.randn(b, nq, dt).astype(np.float32)
    residual = np.concatenate([q_node, q_time], -1)
    k_nv, v_nv, k_ev, v_ev = (r.randn(b, nq * n, h * dk).astype(np.float32)
                              for _ in range(4))
    ngh_time = r.randn(b, nq * n, dt).astype(np.float32)
    mask = r.rand(b, nq * n) < 0.3
    mask[0, :n] = True
    ew = r.rand(b, nq * n).astype(np.float32)
    u_attn = r.rand(b, nq, h, n).astype(np.float32)
    u_fc = r.rand(b, nq, d_model).astype(np.float32)

    jm = JaxSplit(n_head=h, d_model=d_model, d_k=dk, d_node=dn, d_edge=de,
                  d_time=dt, dropout=rate, compute_dtype=jnp.float32)
    args = (q_node, q_time, residual, k_nv, v_nv, k_ev, v_ev, ngh_time)
    params = _init_all(jm, jax.random.PRNGKey(0), args, q_node,
                       k_ev[..., :de], mask=mask, explain_weight=ew)
    cot = r.randn(b, nq, d_model).astype(np.float32)
    # the Pallas path draws its probabilities' uniforms itself
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **kw: jnp.asarray(u_attn))

    def loss(p):
        with fnn.intercept_methods(_inject(u_attn, u_fc, rate)):
            out, attn = jm.apply(p, *args, mask=mask, explain_weight=ew,
                                 deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * cot), (out, attn)
    (_, (out_r, attn_r)), g_r = jax.value_and_grad(loss, has_aux=True)(
        params)

    tm = SplitTemporalAttention(h, d_model, dk, dn, de, dt, dropout=rate,
                                compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    out, attn = tm(*(torch.from_numpy(x) for x in args),
                   mask=torch.from_numpy(mask),
                   explain_weight=torch.from_numpy(ew),
                   draws=AttnDraws(torch.from_numpy(u_attn).reshape(
                       b * nq, h, n), torch.from_numpy(u_fc)))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(attn_r),
                               rtol=1e-5, atol=1e-5)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_r))
    grads = dict(tm.named_parameters())
    assert set(ref) == set(grads)
    for name, g in ref.items():
        got = grads[name].grad         # None: the caller projects node/edge
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert (attn == 0).any()                 # some probabilities dropped
