"""The port's joint enhance train step against the JAX package on the
CPU, for a TGN and for a GraphMixer base.

The same world, weights, draws and tolerances as
``tests/test_torch_enhance.py`` (whose docstring states them): one joint
step at dropout 0 against ``jax.value_and_grad`` of the JAX driver's loss
(``enhance_main.py:112-126``, written out here), comparing the loss, the
gradients of both models, the TGN's new memory and the parameters after
Adam, and with ``--weight_decay`` after AdamW against ``optax.adamw``
masked to the predictor; then the freeze warmup over two frozen steps and
one joint step. The TGN's memory holds two batches' messages first, so
that every base parameter takes a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_enhance import (ATOL, LR, N, RTOL, _batch,
                                      _check_adam, _bce, _grads_close,
                                      _optax_step, _port_draws, _port_step,
                                      _predictor)
from tests.test_torch_enhance import world  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_tgn import _assert_memory_close, _np_tree, _t
from tempme_tpu.explain import tempme as JE
from tempme_tpu.models.graphmixer import GraphMixer as JaxGraphMixer
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu_torch.explain.tempme import TempME
from tempme_tpu_torch.models.graphmixer import GraphMixer
from tempme_tpu_torch.models.tgn import TGN
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.train.base_loader import LoadedBase
from tempme_tpu_torch.utils.convert import flax_to_state_dict

OUT, HID = 8, 8


def _jax_joint_grad(kind, jbase, jpred, feats, deg):
    """``jax.value_and_grad`` of the JAX driver's joint loss at dropout 0
    (``enhance_main.py:112-126``): (loss, (pos, neg, new memory)),
    grads over {"predictor", "base"}."""
    def loss_fn(ps, mem, batch, bgd, subs, walks):
        if kind == "tgn":
            (s, t, b), mem = jbase.apply(
                ps["base"], feats, mem, batch.src, batch.dst, bgd, batch.ts,
                batch.eidx, *subs, update_memory=True, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(0)},
                method=JaxTGN.get_node_emb)
        else:
            s, t, b = jbase.apply(
                ps["base"], feats, batch.src, batch.dst, bgd, batch.ts,
                *subs, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(0)},
                method=JaxGraphMixer.get_node_emb)
        pos, neg = jpred.apply(
            ps["predictor"], feats, batch.ts, *walks, s, t, b,
            node_degree=deg, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)},
            method=JE.TempME.enhance_predict_agg)
        return _bce(pos, neg), (pos, neg, mem)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _tgn_base_grad_close(got, ref, name):
    frac = 1e-4 if name.startswith("time_encoder.") else 1e-5
    _grads_close(got, ref, name, frac=frac)


@pytest.fixture(scope="module")
def tgn_joint(world):
    s = world.s
    je, pparams, te = _predictor(world)
    grad = _jax_joint_grad("tgn", s.jm, je, s.jfeats, jnp.asarray(world.deg))
    # a memory that holds messages, so that the GRU's recurrent weights get
    # a gradient: two batches' embeddings and messages in both packages
    params = {"predictor": pparams, "base": s.params}
    jmem, tmem = s.jmem, s.tmem
    for i in range(2):
        jb, key, (bgd, subs, walks) = world.inputs(100 + 20 * i, 40 + i)
        (_, (_, _, jmem)), _ = grad(params, jmem, jb, bgd, subs, walks)
        tb = _batch(jb)
        tbgd, tsubs, _ = X.sample_explainer_inputs(
            s.tg, tb, _t(world.dst), N, _port_draws(key, len(world.dst)))
        with torch.no_grad():
            _, tmem = s.tm.get_node_emb(s.tfeats, tmem, tb.src, tb.dst, tbgd,
                                        tb.ts, tb.eidx, *tsubs)
    _assert_memory_close(tmem, jmem)
    assert tmem.msg_valid.any()
    return dict(je=je, pparams=pparams, grad=grad, jmem=jmem, tmem=tmem)


def _fresh_tgn(world, tgn_joint):
    s = world.s
    te = TempME(12, 6, out_dim=OUT, hid_dim=HID, dropout=0.0, device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(tgn_joint["pparams"])))
    tm = TGN(12, 6, s.tm.num_nodes, dropout=0.0, device="cpu",
             compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(_np_tree(s.params)))
    return te, LoadedBase("tgn", tm, tgn_joint["tmem"], {})


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_tgn_joint_step_matches_jax(world, tgn_joint, weight_decay):
    s = world.s
    jb, key, (bgd, subs, walks) = world.inputs(150, 21)
    params = {"predictor": tgn_joint["pparams"], "base": s.params}
    (loss_r, (pos_r, neg_r, jmem)), grads = tgn_joint["grad"](
        params, tgn_joint["jmem"], jb, bgd, subs, walks)
    te, tbase = _fresh_tgn(world, tgn_joint)
    groups = [{"params": list(te.parameters())},
              {"params": list(tbase.model.parameters()),
               "weight_decay": 0.0}]
    if weight_decay:
        opt = torch.optim.AdamW(groups, lr=LR, weight_decay=weight_decay)
        jopt = optax.adamw(LR, weight_decay=weight_decay, mask={
            "predictor": jax.tree_util.tree_map(lambda _: True,
                                                params["predictor"]),
            "base": jax.tree_util.tree_map(lambda _: False,
                                           params["base"])})
    else:
        opt = torch.optim.Adam(groups, lr=LR)
        jopt = optax.adam(LR)
    jparams, _ = _optax_step(jopt, grads, jopt.init(params), params)
    before = {("predictor." if m is te else "base.") + n:
              p.detach().numpy().copy()
              for m in (te, tbase.model) for n, p in m.named_parameters()}
    step = _port_step(te, tbase, s.tg, s.tfeats, world.dst, world.deg, opt)
    draws = _port_draws(key, len(world.dst))
    tmem, aux = step(tbase.memory, _batch(jb), draws)

    np.testing.assert_allclose(aux["loss"].item(), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(aux["pos"].numpy(),
                               np.asarray(pos_r).squeeze(-1), rtol=RTOL,
                               atol=ATOL)
    _assert_memory_close(tmem, jmem)
    assert all(not x.requires_grad for x in tmem)
    g_pred = flax_to_state_dict(_np_tree(grads["predictor"]))
    g_base = flax_to_state_dict(_np_tree(grads["base"]))
    port_grads = {}
    for prefix, model, ref, close in (
            ("predictor.", te, g_pred, _grads_close),
            ("base.", tbase.model, g_base, _tgn_base_grad_close)):
        assert set(ref) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            g = np.zeros(p.shape, np.float32) if p.grad is None \
                else p.grad.numpy()
            close(g, ref[name].numpy(), prefix + name)
            port_grads[prefix + name] = g
    # the gradient reached the base through the embeddings and the memory
    assert np.abs(port_grads["base.memory_updater.weight_hh"]).max() > 0
    assert np.abs(port_grads["base.attn_layers.0.attn.fc.weight"]).max() > 0
    ref_params = {"predictor." + k: v for k, v in flax_to_state_dict(
        _np_tree(jparams["predictor"])).items()}
    ref_params.update({"base." + k: v for k, v in flax_to_state_dict(
        _np_tree(jparams["base"])).items()})

    class Joint(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.predictor, self.base = te, tbase.model
    jopt_port = optax.adamw(LR, weight_decay=weight_decay, mask={
        k: k.startswith("predictor.") for k in before}) if weight_decay \
        else optax.adam(LR)
    _check_adam(Joint(), before, port_grads, jopt_port, ref_params, LR,
                1e-4)


def test_freeze_warmup_keeps_the_base_then_steps_as_optax(world, tgn_joint):
    """Two frozen steps, then one joint step: the base is bitwise unchanged
    through the frozen ones, and after the joint one equals optax's step on
    the zeroed-then-real gradients, the memory carried."""
    s = world.s
    te, tbase = _fresh_tgn(world, tgn_joint)
    params = {"predictor": tgn_joint["pparams"], "base": s.params}
    jopt = optax.adam(LR)
    jstate = jopt.init(params)
    opt = torch.optim.Adam(list(te.parameters())
                           + list(tbase.model.parameters()), lr=LR)
    step = _port_step(te, tbase, s.tg, s.tfeats, world.dst, world.deg, opt)
    base0 = {n: p.detach().clone() for n, p in
             tbase.model.named_parameters()}
    jmem, tmem = tgn_joint["jmem"], tgn_joint["tmem"]
    for i, train_base in enumerate((False, False, True)):
        jb, key, (bgd, subs, walks) = world.inputs(140 + 10 * i, 30 + i)
        (_, (_, _, jmem)), grads = tgn_joint["grad"](params, jmem, jb, bgd,
                                                     subs, walks)
        if not train_base:
            grads = {"predictor": grads["predictor"],
                     "base": jax.tree_util.tree_map(jnp.zeros_like,
                                                    grads["base"])}
        params, jstate = _optax_step(jopt, grads, jstate, params)
        tmem, _ = step(tmem, _batch(jb), _port_draws(key, len(world.dst)),
                       train_base=train_base)
        if not train_base:
            for n, p in tbase.model.named_parameters():
                assert torch.equal(p.detach(), base0[n]), n
                assert not p.grad.any(), n
        _assert_memory_close(tmem, jmem)
    want = flax_to_state_dict(_np_tree(params["base"]))
    moved = 0
    for n, p in tbase.model.named_parameters():
        got = p.detach().numpy()
        g = p.grad.numpy()
        settled = np.abs(g) >= 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(got[settled], want[n].numpy()[settled],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert np.abs(got - want[n].numpy()).max() <= LR * 1.001, n
        moved += int(not torch.equal(p.detach(), base0[n]))
    assert moved > 10
    assert all(st["step"].item() == 3 for st in opt.state.values())


def test_graphmixer_joint_step_matches_jax(world):
    """A 2-block GraphMixer base: the JAX step's loss, gradients and Adam
    step (its base gradients at the GraphMixer tests' atol 5e-4 of the
    largest)."""
    s = world.s
    jb, key, (bgd, subs, walks) = world.inputs(160, 22)
    jm = JaxGraphMixer(node_dim=12, edge_dim=6, num_tokens=N, num_layers=2,
                       dropout=0.0)
    bparams = jax.jit(lambda k: jm.init(
        k, s.jfeats, jb.src, jb.dst, bgd, jb.ts, *subs,
        deterministic=True))(jax.random.PRNGKey(2))
    je, pparams, te = _predictor(world, base_type="graphmixer")
    params = {"predictor": pparams, "base": bparams}
    (loss_r, (pos_r, _, _)), grads = _jax_joint_grad(
        "graphmixer", jm, je, s.jfeats, jnp.asarray(world.deg))(
            params, None, jb, bgd, subs, walks)
    jopt = optax.adam(LR)
    jparams, _ = _optax_step(jopt, grads, jopt.init(params), params)
    tm = GraphMixer(12, 6, N, num_layers=2, dropout=0.0, device="cpu")
    tm.load_state_dict(flax_to_state_dict(_np_tree(bparams)))
    opt = torch.optim.Adam(list(te.parameters()) + list(tm.parameters()),
                           lr=LR)
    before = {("predictor." if m is te else "base.") + n:
              p.detach().numpy().copy()
              for m in (te, tm) for n, p in m.named_parameters()}
    step = _port_step(te, LoadedBase("graphmixer", tm, None, {}), s.tg,
                      s.tfeats, world.dst, world.deg, opt)
    mem, aux = step(None, _batch(jb), _port_draws(key, len(world.dst)))
    assert mem is None
    np.testing.assert_allclose(aux["loss"].item(), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(aux["pos"].numpy(),
                               np.asarray(pos_r).squeeze(-1), rtol=RTOL,
                               atol=ATOL)
    port_grads, ref_params = {}, {}
    for key_, model, frac in (("predictor", te, 1e-4), ("base", tm, 5e-4)):
        ref = flax_to_state_dict(_np_tree(grads[key_]))
        ref_params.update({f"{key_}.{k}": v for k, v in flax_to_state_dict(
            _np_tree(jparams[key_])).items()})
        for name, p in model.named_parameters():
            g = np.zeros(p.shape, np.float32) if p.grad is None \
                else p.grad.numpy()
            _grads_close(g, ref[name].numpy(), f"{key_}.{name}", frac=frac)
            port_grads[f"{key_}.{name}"] = g
    assert np.abs(port_grads["base.mixers.1.token_ffn.fc1.weight"]).max() > 0

    class Joint(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.predictor, self.base = te, tm
    _check_adam(Joint(), before, port_grads, optax.adam(LR), ref_params, LR,
                1e-4)


