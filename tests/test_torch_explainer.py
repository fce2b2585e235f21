"""The port's TempME explainer against the JAX package on the CPU.

* One explainer train step on a frozen toy TGN (weights converted from the
  JAX model, float32 compute): the port's ``ExplainerTrainStep`` samples
  the supports and walks from draws made with ``jax.random`` in the JAX
  driver's split order, and its loss, prediction loss, KL, the walk
  importances, the explanation and every parameter's gradient are held
  against the JAX driver's loss (``temp_exp_main.py:318-340``) under
  ``jax.value_and_grad``; the parameters after Adam against ``optax.adam``
  on the port's own gradients. At dropout 0, and at rate 0.2 with the same
  uniforms injected into both (flax's ``nn.Dropout`` through
  ``nn.intercept_methods``; one compiled JAX program serves both rates).
  The Beta sample's gamma draws are JAX's own (recorded from
  ``jax.random.gamma`` in the same pass) and enter the port as tensors;
  their gradient is ``torch._standard_gamma_grad``, the same
  implicit-reparameterisation derivative. Tolerances: losses rtol 1e-5;
  the explanation rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-4 of
  each tensor's largest (float32 sums in another order through the
  explained base's backward and the gamma derivative; the smallest
  tensors' gradients are about 1e-4 and differ by about 1e-9); Adam atol
  5e-5 lr, rtol 1e-6 (optax rounds its bias corrections in float32).

``tests/test_torch_explainer_eval.py`` holds the eval step and the
committed checkpoint's conversion.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_tgn import Setup, _np_tree, _t
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.explain import tempme as JE
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu_torch.explain.tempme import EdgeDraws, ImpDraws, TempME
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.utils.convert import flax_to_state_dict

N, B, HID, LR = 3, 6, 16, 1e-3
W = N * X.N_WALK_CONT


@pytest.fixture(scope="module")
def world():
    s = Setup(seed=3)
    # the JAX sampler's CSR branch, which the port's kernels follow
    s.jg = dataclasses.replace(s.jg, dense_ts=None, dense_node=None,
                               dense_eid=None)
    s.tm.requires_grad_(False)
    s.jbase = JX.LoadedBase("tgn", s.jm, s.params, s.jmem, {})
    s.tbase = X.LoadedBase("tgn", s.tm, s.tmem, {})
    s.dst = np.unique(s.ev.dst)
    s.null = np.random.RandomState(1).dirichlet(np.ones(12)).astype(
        np.float32)
    return s


def _port_draws(key, dst_len):
    """The port's draws for JAX's ``sample_explainer_inputs(key)``: the
    negatives' indices, per side the hops' uniforms (``find_k_hop``'s
    splits) and the walks' (``find_k_walks``'s splits)."""
    @jax.jit
    def draws(key):
        kn, k1, k2, k3, w1, w2, w3 = jax.random.split(key, 7)
        hops = []
        for k in (k1, k2, k3):
            side = []
            for layer in range(2):
                k, sub = jax.random.split(k)
                side.append(jax.random.uniform(sub, (B * N ** layer, N)))
            hops.append(side)
        walks = []
        for wk in (w1, w2, w3):
            kk, ku2 = jax.random.split(wk)
            _, ku3 = jax.random.split(kk)
            walks.append((jax.random.uniform(ku2, (B * N, X.N_WALK_CONT)),
                          jax.random.uniform(ku3, (B * W,))))
        return jax.random.randint(kn, (B,), 0, dst_len), hops, walks
    neg, hops, walks = draws(key)
    support = L.SupportDraws(_t(neg).long(),
                             *(tuple(_t(u) for u in side) for side in hops))
    return support, tuple(S.WalkDraws(_t(u2), _t(u3)) for u2, u3 in walks)


def _inject(flat_u, scale):
    """Feed flax's dropout sites the uniforms ``flat_u`` in call order (per
    side the motif attention's two and the head's, then per side the
    gate's two), each at its module's rate times ``scale``: at scale 0 a
    site returns its input exactly, as flax's dropout does at rate 0, so
    one compiled program serves both rates."""
    queue = list(flat_u)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            x, u = args[0], queue.pop(0)
            rate = context.module.rate * scale
            assert x.shape == u.shape, (x.shape, u.shape)
            return jnp.where(u >= rate, x / (1.0 - rate), 0.0)
        return next_fun(*args, **kwargs)
    return interceptor


def _explainers(s, rate, walks0, sub0, ts0):
    je = JE.TempME(node_dim=12, edge_dim=6, hid_dim=HID, dropout=rate)
    params = jax.jit(lambda k: je.init(
        {"params": k}, s.jfeats, walks0, ts0, sub0,
        method=JE.TempME.init_all))(jax.random.PRNGKey(7))
    te = TempME(12, 6, hid_dim=HID, dropout=rate, device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return je, params, te


RATES = (0.0, 0.2)


@pytest.fixture(scope="module")
def jax_steps(world):
    """The JAX driver's loss (``temp_exp_main.py:318-340``), its gradient
    and the recorded gamma draws, for both rates from one compiled
    program."""
    s = world
    jb = s.batch(150, B)
    key = jax.random.PRNGKey(21)
    dst = jnp.asarray(s.dst)
    bgd, subs, walks = jax.jit(
        lambda k, b: JX.sample_explainer_inputs(s.jg, k, b, dst, N))(key, jb)
    je, params, _ = _explainers(s, RATES[1], walks[0], subs[0], jb.ts)
    contrast = JX.make_base_contrast(s.jbase, s.jfeats)
    null = jnp.asarray(s.null)
    imp_u, edge_u = _uniforms(seed=8)
    gammas = []

    def loss_fn(ep, flat_u, scale):
        gammas.clear()
        pos_ori, neg_ori = contrast(jb.src, jb.dst, bgd, jb.ts, jb.eidx,
                                    *subs, None)
        y_ori = (jnp.concatenate([pos_ori, neg_ori]) > 0.0).astype(
            jnp.float32)
        with fnn.intercept_methods(_inject(flat_u, scale)):
            imps = [je.apply(ep, s.jfeats, walks[i], jb.ts,
                             deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(i)})
                    for i in range(3)]
            explanation = je.apply(
                ep, s.jfeats, subs[0], imps[0], walks[0], subs[1], imps[1],
                walks[1], subs[2], imps[2], walks[2], training=True,
                deterministic=False,
                rngs={"sample": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                method=JE.TempME.retrieve_explanation)
        pos, neg = contrast(jb.src, jb.dst, bgd, jb.ts, jb.eidx, *subs,
                            explanation)
        pred = jnp.concatenate([pos, neg])
        pred_loss = optax.sigmoid_binary_cross_entropy(pred, y_ori).mean()
        kl = sum(JE.kl_sparsity_loss(imps[i], walks[i].cat, null, 0.3)
                 for i in range(3))
        return pred_loss + 0.5 * kl, (pred_loss, kl, explanation,
                                      tuple(gammas))

    real_gamma = jax.random.gamma

    def recording_gamma(k, a, *args, **kw):
        g = real_gamma(k, a, *args, **kw)
        gammas.append(g)
        return g
    flat_u = [jnp.asarray(x) for d in imp_u + edge_u for x in d]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gamma", recording_gamma)
        run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        out = {rate: run(params, flat_u, jnp.float32(rate > 0))
               for rate in RATES}
    return dict(batch=jb, key=key, params=params, walks=walks, subs=subs,
                uniforms=(imp_u, edge_u), out=out)


def _uniforms(seed):
    """Per side the importance's and the gate's dropout uniforms."""
    r = np.random.RandomState(seed)

    def u(*shape):
        return r.rand(*shape).astype(np.float32)
    imp = [ImpDraws(u(B, W, 1, 2), u(B, W, 1, HID), u(B, W, HID + 12))
           for _ in range(3)]
    edge = [EdgeDraws(u(B, 3 * W, HID), u(B, 3 * W, HID // 2))
            for _ in range(3)]
    return imp, edge


@pytest.mark.parametrize("rate", RATES)
def test_train_step_matches_jax(world, jax_steps, rate):
    s, ref = world, jax_steps
    (loss_r, (pred_loss_r, kl_r, expl_r, gam)), grads_r = ref["out"][rate]
    assert len(gam) == 12                      # 3 sides x 2 hops x (ga, gb)
    te = TempME(12, 6, hid_dim=HID, dropout=rate, device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(ref["params"])))
    support, wdraws = _port_draws(ref["key"], len(s.dst))
    opt = torch.optim.Adam(te.parameters(), lr=LR)
    step = X.ExplainerTrainStep(te, s.tbase, s.tg, s.tfeats, _t(s.dst), N,
                                _t(s.null), opt, 0.3, 0.5, True)
    imp_u, edge_u = ref["uniforms"]
    draws = X.ExplainerDraws(
        support, wdraws,
        tuple(ImpDraws(*map(torch.from_numpy, d)) for d in imp_u)
        if rate else None,
        tuple(EdgeDraws(*map(torch.from_numpy, d)) for d in edge_u)
        if rate else None,
        tuple(tuple(_t(g) for g in gam[4 * i:4 * i + 4]) for i in range(3)))
    seen = {}
    real_forward = step._forward

    def keep(*a, **kw):                   # keep the step's explanation
        out = real_forward(*a, **kw)
        seen.update(out)
        return out
    step._forward = keep
    before = {n: p.detach().clone() for n, p in te.named_parameters()}
    aux = step(L.Batch(*(_t(x) for x in ref["batch"])), draws)

    np.testing.assert_allclose(aux["loss"].item(), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(aux["pred_loss"].item(), float(pred_loss_r),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["kl"].item(), float(kl_r), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(seen["explanation"], expl_r):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    grads = flax_to_state_dict(_np_tree(grads_r))
    # the enhance head (aff_*) is not on this path: no gradient in the port,
    # zeros in JAX
    port_grads = {n: np.zeros(p.shape, np.float32) if p.grad is None
                  else p.grad.numpy() for n, p in te.named_parameters()}
    assert set(grads) == set(port_grads)
    for name, g in grads.items():
        g = g.numpy()
        np.testing.assert_allclose(port_grads[name], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)
    assert all((np.abs(g).max() > 0) != n.startswith("aff_")
               for n, g in port_grads.items())
    # Adam: the port's step against optax's on the port's own gradients
    jopt = optax.adam(LR)
    upd = jax.jit(lambda g, p: jopt.update(g, jopt.init(p))[0])(
        port_grads, {n: v.numpy() for n, v in before.items()})
    for name, p in te.named_parameters():
        want = before[name].numpy() + np.asarray(upd[name])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                   atol=5e-5 * LR, err_msg=name)
    if rate:                                   # the draws change the step
        assert float(loss_r) != float(ref["out"][0.0][0][0])
