"""Adam's step on round-off gradients, and its float64 replay.

The card-against-CPU checks of ``chip_smoke.py`` once bounded the two
sides' parameters after Adam by ``lr`` where the gradient is round-off.
That premise is wrong: Adam moves an entry towards its gradient's sign by
``lr * m_hat / (sqrt(v_hat) + eps)``, so

* on its first step, by ``lr * g / (|g| + eps)`` either way: two sides
  whose round-off gradients differ in sign part by up to ``2 lr`` (an
  entry of a GraphMixer explainer's motif attention, gradients 3.007e-08
  on an H100 and -1.363e-08 on the CPU, parted by 1.3273e-03 at lr 1e-3);
* from a trained state, by up to about ``3 lr`` when a gradient far
  larger than the recent ones (a sign flip after round-off) arrives late
  in training (``v_hat`` remembers the small past, ``m_hat`` takes a
  tenth of the new gradient).

So the checks hold each side's parameters to ``utils/optim.py``'s float64
replay of Adam with that side's own gradient; the replay equals
``torch.optim.Adam`` and ``AdamW``.
"""
import numpy as np
import pytest
import torch

from tempme_tpu_torch.utils.optim import adam_replay, hold_adam_step

LR = 1e-3


def _adam_step(p0, grads, state_steps=(), dtype=torch.float32, **kw):
    """``p0`` after Adam's steps on ``state_steps`` then ``grads``' last;
    returns (the parameter before the last step, its state then, after)."""
    kw = dict(kw)
    p = torch.nn.Parameter(p0.clone().to(dtype))
    opt = (torch.optim.AdamW if kw.pop("decoupled", False)
           else torch.optim.Adam)([p], lr=LR, **kw)
    for g in list(state_steps) + [grads]:
        before = p.detach().clone()
        state = {k: v.clone() for k, v in opt.state[p].items()}
        p.grad = g.clone().to(dtype)
        opt.step()
    return before, state, p.detach()


def test_first_step_parts_opposite_round_off_signs_by_up_to_two_lr():
    p0 = torch.zeros(1)
    card = _adam_step(p0, torch.tensor([3.0069714e-08]))[2]
    cpu = _adam_step(p0, torch.tensor([-1.3633326e-08]))[2]
    apart = (card - cpu).abs().item()
    assert LR < apart < 2 * LR
    np.testing.assert_allclose(apart, 1.3273e-3, rtol=1e-3)
    # each side alone moves by lr g / (|g| + eps), under lr
    assert card.abs().item() < LR and cpu.abs().item() < LR


def test_trained_state_moves_past_lr_when_the_gradient_flips_sign():
    """2,000 steps of a round-off gradient of +1e-6, then one of -1e-2:
    ``v_hat`` has forgotten the small past by a factor 1 - 0.999**2001
    only, ``m_hat`` takes a tenth of the new gradient, and
    ``m_hat / sqrt(v_hat)`` is about 0.1 / sqrt(0.001 / 0.865) = 2.94: the
    entry moves by nearly 3 lr (3.16 lr in the limit)."""
    history = [torch.full((1,), 1e-6)] * 2000
    before, state, after = _adam_step(torch.zeros(1), torch.tensor([-1e-2]),
                                      history)
    step = (after - before).item()
    assert step > 2 * LR
    np.testing.assert_allclose(step, 2.94 * LR, rtol=0.01)
    hold_adam_step(after, before, torch.tensor([-1e-2]), state, LR, "flip")


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.1),
                                dict(weight_decay=0.1, decoupled=True)])
def test_replay_equals_torch_adam(kw):
    r = np.random.RandomState(0)
    p0 = torch.from_numpy(r.randn(64))
    grads = [torch.from_numpy(r.randn(64) * s) for s in (1, 1e-8, 3)]
    before, state, after = _adam_step(p0, grads[-1], grads[:-1],
                                      dtype=torch.float64, **kw)
    want = adam_replay(before, grads[-1], state, LR, **kw)
    np.testing.assert_allclose(after.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-15)
    before, state, after = _adam_step(p0, grads[-1], grads[:-1], **kw)
    hold_adam_step(after, before, grads[-1].float(), state, LR, "float32",
                   **kw)
    with pytest.raises(AssertionError, match="after Adam"):
        hold_adam_step(after + 2e-6, before, grads[-1].float(), state, LR,
                       "moved", **kw)
