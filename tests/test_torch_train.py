"""The port's TGN train step against ``make_tgn_train_step`` on the CPU.

Both packages start from the same flax weights (``utils/convert.py``) and
the same memory, at dropout 0 (threefry and Philox draws can never match;
dropout is held against the JAX package at the kernel and module level in
``tests/test_torch_attend_drop.py``). The port replays the JAX step's
support draws, made from its ``k_samp`` in the JAX split order. After each
of three steps (the third with padded rows) these agree:

* the loss, rtol 1e-5: float32 sums in another order;
* every gradient, against ``jax.grad`` of the JAX step's loss converted by
  the same ``flax_to_state_dict``: rtol 1e-4 and atol 1e-5 times the
  tensor's largest gradient, since sums of many terms that cancel lose
  digits relative to the largest one; 1e-4 times the largest for the time
  encoder, whose gradient weighs ``sin`` of large arguments (time deltas
  times the unit frequency, which lose digits in both packages) by the
  time deltas;
* Adam: the port's parameters after each step equal ``optax.adam`` applied
  to the port's own gradients, rtol 1e-6 and atol 5e-5 of ``lr`` per step:
  optax rounds its bias corrections in float32 (``1 - 0.999`` is 1.3e-5
  off there), which moves a step by up to about 2e-5 of ``lr``;
* the parameters after Adam equal the JAX step's, rtol 1e-5 and atol 1e-6,
  wherever the gradient stayed above 1e-4 of its tensor's largest in every
  step so far. Below that a gradient is round-off of terms that cancel in
  exact arithmetic (the time encoding's near-zero frequencies give every
  key the same term, which the softmax removes), and Adam scales such noise
  to a step of up to ``lr``: there the parameters agree to ``lr`` per step;
* each field of the new memory, as ``tests/test_torch_tgn.py`` holds it
  (rtol 2e-4, atol 1e-5; ``msg_valid`` exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests.test_torch_graph_sampler import jax_support_draws
from tests.test_torch_tgn import Setup, _assert_memory_close, _np_tree, _t
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.train import learn_tgn as JT
from tempme_tpu.train import loops as JL
from tempme_tpu_torch.models.tgn import TGN
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.utils.convert import flax_to_state_dict

LR, B, N = 1e-3, 16, 4


def _jax_grads(s, dst):
    """``grads(state, mem, batch) -> (grads, k_samp)``: ``jax.grad`` of the
    loss ``make_tgn_train_step`` takes, with the step's own keys, and its
    support key."""
    @jax.jit
    def grads(state, mem, batch):
        _, k_samp, k_drop = jax.random.split(state.key, 3)
        b = JL.mask_batch_nodes(batch)
        bgd, ss, st, sb = JL.sample_support(s.jg, k_samp, b, dst, 2, N,
                                            use_eidx=False)

        def loss_fn(params):
            (pos, neg), _ = s.jm.apply(
                params, s.jfeats, mem, b.src, b.dst, bgd, b.ts, b.eidx, ss,
                st, sb, deterministic=False, rngs={"dropout": k_drop},
                method=JaxTGN.contrast)
            ones = jnp.ones(pos.shape[0])
            return (JL.masked_bce_with_logits(pos, ones, b.mask)
                    + JL.masked_bce_with_logits(neg, ones * 0, b.mask))

        return jax.grad(loss_fn)(state.params), k_samp

    return grads


def _close_to_max(port, ref, name):
    scale = max(float(np.abs(ref).max()), 1e-30)
    atol = (1e-4 if name.startswith("time_encoder.") else 1e-5) * scale
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=atol, err_msg=name)


def test_train_steps_match_jax():
    s = Setup(seed=2)
    dst = np.unique(s.ev.dst)
    jopt = optax.adam(LR)
    jstep = JT.make_tgn_train_step(s.jm, s.jg, s.jfeats, jnp.asarray(dst), N,
                                   jopt)
    state = JL.TrainState(s.params, jopt.init(s.params),
                          jax.random.PRNGKey(5))
    model = TGN(12, 6, s.tm.num_nodes, dropout=0.0, device="cpu",
                compute_dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(_np_tree(s.params)))
    assert {n for n, _ in model.memory_updater.named_parameters()} == {
        "weight_ih", "weight_hh", "bias_ih", "bias_hn"}
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = T.make_tgn_train_step(model, s.tg, s.tfeats, _t(dst), N, opt)
    jax_grads = _jax_grads(s, jnp.asarray(dst))
    jmem, tmem = s.jmem, s.tmem
    ported = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    port_adam = jopt.init(ported)
    settled = {n: np.ones(p.shape, bool) for n, p in ported.items()}
    for i in range(3):
        jb = s.batch(100 + B * i, B)
        if i == 2:                                  # padded rows
            jb = jb._replace(mask=jnp.arange(B) < B - 3)
        grads, k_samp = jax_grads(state, jmem, jb)
        state, jmem, jaux = jstep(state, jmem, jb)
        draws = T.StepDraws(jax_support_draws(k_samp, B, 2, N, len(dst)),
                            None)
        tb = L.Batch(*(_t(x) for x in jb))
        tmem, aux = step(tmem, tb, draws)

        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                                   rtol=1e-5)
        ref_grads = flax_to_state_dict(_np_tree(grads))
        ref_params = flax_to_state_dict(_np_tree(state.params))
        port_grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        upd, port_adam = jopt.update(port_grads, port_adam, ported)
        ported = {n: np.asarray(x) for n, x in
                  optax.apply_updates(ported, upd).items()}
        for name, p in model.named_parameters():
            g_ref = ref_grads[name].numpy()
            _close_to_max(p.grad.numpy(), g_ref, name)
            got, want = p.detach().numpy(), ref_params[name].numpy()
            np.testing.assert_allclose(got, ported[name], rtol=1e-6,
                                       atol=5e-5 * LR * (i + 1),
                                       err_msg=name)
            settled[name] &= np.abs(g_ref) >= 1e-4 * np.abs(g_ref).max()
            np.testing.assert_allclose(got[settled[name]],
                                       want[settled[name]], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            assert np.abs(got - want).max() <= LR * (i + 1) * 1.001, name
        _assert_memory_close(tmem, jmem)
        assert all(x.grad_fn is None and not x.requires_grad for x in tmem)
    # the GRU learnt from the stored messages of steps 1 and 2
    assert model.memory_updater.weight_hh.grad.abs().max() > 0


def test_initialisers_follow_jax():
    """A fresh port TGN starts from the JAX package's distributions: the
    same zero biases, unit LayerNorm scales and time encoder, and for every
    matrix of at least 1,000 entries a standard deviation within 10% of the
    flax initialiser's (lecun_normal, xavier_normal, the projections'
    normal and the GRU's orthogonal kernels)."""
    s = Setup(node_dim=64, edge_dim=16, num_events=120, seed=3)
    ref = flax_to_state_dict(_np_tree(s.params))
    port = TGN(64, 16, s.tm.num_nodes, device="cpu", seed=1).state_dict()
    assert set(port) == set(ref)
    big = 0
    for name, want in ref.items():
        got = port[name]
        assert got.shape == want.shape, name
        constant = bool((want == want.flatten()[0]).all())
        if name.startswith("time_encoder.") or constant:
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=name)    # zeros, ones, freq
        elif want.numel() >= 1000:
            big += 1
            ratio = (got.std() / want.std()).item()
            assert abs(ratio - 1) < 0.1, (name, ratio)
            assert abs(got.mean().item()) < 0.1 * want.std().item(), name
    assert big >= 20
