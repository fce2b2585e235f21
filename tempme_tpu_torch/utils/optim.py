"""A float64 replay of one ``torch.optim.Adam`` or ``AdamW`` step.

The card-against-CPU and data-parallel checks hold a parameter after the
optimizer's step to this replay of the same step, from the same starting
state and with the gradient that the checked side applied. Two sides with
gradients that agree within round-off can still move an entry in
opposite directions: where the gradient is round-off (its sign is noise),
Adam's first step moves the entry by ``lr * g / (|g| + eps)`` towards its
own sign, so two sides differ by up to ``2 * lr``; from a trained state
``m_hat / (sqrt(v_hat) + eps)`` exceeds 1 after a sign change, and an
entry moves by several ``lr``. So no bound in units of ``lr`` holds such
entries; the replay does, at the optimizer's own round-off.
"""
from __future__ import annotations

import math

import torch


def adam_replay(param, grad, state=None, lr=1e-3, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=0.0, decoupled=False):
    """The parameter after one Adam step from ``param`` with ``grad`` and
    the optimizer state ``state`` (a ``torch.optim.Adam`` state entry:
    ``step``, ``exp_avg``, ``exp_avg_sq``; None or empty: a fresh one),
    computed in float64 on the CPU. ``decoupled``: AdamW's weight decay
    (the parameter scaled by ``1 - lr * weight_decay`` first), else Adam's
    (``weight_decay * param`` added to the gradient)."""
    p = param.detach().double().cpu()
    g = grad.detach().double().cpu()
    b1, b2 = betas
    state = state or {}
    step = float(state.get("step", 0)) + 1
    m = state["exp_avg"].double().cpu() if "exp_avg" in state \
        else torch.zeros_like(p)
    v = state["exp_avg_sq"].double().cpu() if "exp_avg_sq" in state \
        else torch.zeros_like(p)
    if weight_decay:
        if decoupled:
            p = p * (1.0 - lr * weight_decay)
        else:
            g = g + weight_decay * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    denom = v.sqrt() / math.sqrt(1.0 - b2 ** step) + eps
    return p - lr / (1.0 - b1 ** step) * m / denom


def hold_adam_step(after, before, grad, state, lr, what, rtol=1e-5,
                   atol=1e-6, **kw) -> float:
    """Hold ``after`` (one side's parameter after its step) to
    ``adam_replay`` from ``before`` and ``state`` with ``grad`` (that
    side's own gradient) at ``rtol``, ``atol``; returns the largest
    difference."""
    want = adam_replay(before, grad, state, lr, **kw)
    got = after.detach().double().cpu()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what} after Adam: {m}")
    return (got - want).abs().max().item() if got.numel() else 0.0
