"""The explain weight's gradient and bf16 inputs of the port's ``attend``,
against the JAX package's ``fused_attend`` in Pallas interpret mode.

* The VJP with respect to q, k, v and the explain weight, eval and training
  forms (rates 0 and 0.3), rows whose keys are all masked included: the
  plain version's autograd and ``attend_bwd(..., ew_grad=True)`` (the
  wrapper the CUDA kernel sits behind) against ``jax.vjp`` of
  ``fused_attend``. Forward rtol 1e-5, atol 1e-6; VJP rtol 1e-5, atol 1e-5
  (float32 sums in another order, up to n * dk terms).
* bf16 q, k and v (the projections' default type): the plain version casts
  them to float32 as the Pallas body does, so the forward and the VJP match
  ``fused_attend`` on the same bf16 inputs to the same tolerances; dq, dk
  and dv come back in bf16, as JAX's do, and are compared after a bf16
  rounding of JAX's (rtol 1e-2, one bf16 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attend_drop import _cotangents, _draws
from tests.test_torch_attention import _inputs
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.ops.pallas import kernels as pk
from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                 attend_drop)


def _jax_fused(q, k, v, mask, ew, u, rate, dout, dattn, dtype):
    """fused_attend (interpret mode) in the port's layouts: (out, attn, dq,
    dk, dv, dew)."""
    m, h, dk = q.shape
    n = k.shape[1]

    def f(q5, k5, v5, w):
        return pk.fused_attend(
            q5, k5, v5, jnp.asarray(mask).reshape(m, 1, 1, n),
            w.reshape(m, 1, 1, n), 1.0 / np.sqrt(dk),
            None if u is None else jnp.asarray(u).reshape(m, 1, h, n), rate)
    (out, attn), vjp = jax.vjp(
        f, *(jnp.asarray(x, dtype)[:, None] for x in (q, k, v)),
        jnp.asarray(ew))
    dq, dk5, dv5, dew = vjp((jnp.asarray(dout).reshape(m, 1, h * dk),
                             jnp.asarray(dattn).reshape(m, 1, h, n)))
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (
        out.reshape(m, h, dk), attn.reshape(m, h, n), dq[:, 0], dk5[:, 0],
        dv5[:, 0], dew))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attend_vjp_with_explain_weight_matches_fused_attend(dtype, rate):
    q, k, v, mask, ew = _inputs(seed=11)
    m, h, dk = q.shape
    n = k.shape[1]
    u = _draws(m, h, n, seed=12) if rate else None
    dout, dattn = _cotangents(m, h, n, dk, seed=13)
    tdt = getattr(torch, dtype)
    want = _jax_fused(q, k, v, mask, ew, u, rate, dout, dattn,
                      getattr(jnp, dtype))

    qkv = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tmask = torch.from_numpy(mask)
    tew = torch.from_numpy(ew).requires_grad_()
    scale = 1.0 / np.sqrt(dk)
    tu = None if u is None else torch.from_numpy(u)
    if rate:
        out, attn = attend_drop(*qkv, tmask, tew, tu, rate, scale)
    else:
        out, attn = attend(*qkv, tmask, tew, scale)
    cts = (torch.from_numpy(dout), torch.from_numpy(dattn))
    grads = torch.autograd.grad((out, attn), [*qkv, tew], cts)
    by_wrapper = attend_bwd(*(x.detach() for x in qkv), tmask, tew.detach(),
                            tu, rate, scale, *cts, ew_grad=True)
    assert [g.dtype for g in grads] == [tdt] * 3 + [torch.float32]
    for a, b in zip(by_wrapper, grads):
        assert torch.equal(a, b)
    got = [out, attn, *grads]
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach()
        if a.dtype == torch.bfloat16:             # dq, dk, dv in bf16
            b = np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
            tol = dict(rtol=1e-2, atol=1e-5)
        else:
            tol = dict(rtol=1e-5, atol=1e-6 if i < 2 else 1e-5)
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=str(i),
                                   **tol)
    assert grads[3].abs().sum() > 0
    # an all-masked row attends uniformly: its weights get a gradient
    assert grads[3][0].abs().sum() > 0


def test_attend_bwd_without_ew_grad_returns_none():
    q, k, v, mask, ew = (torch.from_numpy(x) for x in _inputs(seed=3))
    m, h, dk = q.shape
    dout, _ = _cotangents(m, h, k.shape[1], dk, seed=4)
    *grads, dew = attend_bwd(q, k, v, mask, ew, None, 0.0, 0.5,
                             torch.from_numpy(dout))
    assert dew is None and len(grads) == 3
    with pytest.raises(ValueError, match="ew_grad"):
        attend_bwd(q, k, v, mask, None, None, 0.0, 0.5,
                   torch.from_numpy(dout), ew_grad=True)
    with pytest.raises(ValueError, match="bfloat16"):
        attend(q.to(torch.bfloat16), k, v, mask, ew)
