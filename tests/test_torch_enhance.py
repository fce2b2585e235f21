"""The port's enhance stage against the JAX package on the CPU.

Inputs come from a numpy seed; JAX's weights are carried across by
``utils/convert.py``, JAX's supports and walks (its CSR sampler) are
replayed in the port from the same draws (``jax.random`` in the JAX
split order), and everything runs at float32 and small widths.

* ``TempME``'s enhance form: ``walk_embedding`` and
  ``enhance_predict_agg`` with and without a degree table, on walks that
  hold node 0, and their gradients (parameters and base embeddings)
  against ``jax.grad``: values rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
  atol 1e-4 of each tensor's largest (the explainer tests'). The same for
  ``TempMETGAT``, whose ``walk_enc_cat`` runs at width 20 over 8 heads
  (rounded up to 24, head width 3). Its attention's key bias adds the same
  amount to every score of a query, which the softmax removes: that
  gradient is zero in exact arithmetic and round-off in both packages (up
  to 3e-7), held to 1e-4 of the model's largest gradient. JAX runs these
  module checks on walks of which each side has a row anchored at node 0
  (the padding id: every walk of it is padding). Without a degree table a
  walk's mean degree is count / (count + 1e-6): when every walk of the
  batch holds some node these are all within 1e-6 of 1, the walk weights
  divide their deviations by their standard deviation (about 1e-7), and
  rounding decides the weights in either package (JAX's own jitted and
  op-by-op embeddings differ by 1.9e-2 on a batch of mid-stream rows,
  where XLA folds the table of ones). The empty walks' mean degree 0
  makes the weights well defined. The drivers always pass the table.
  ``TempMETGAT``'s logits sum 2W walk scores that partly cancel: atol
  1e-5 there.
* One joint train step for a TGN and for a GraphMixer base at dropout 0
  against ``jax.value_and_grad`` of the JAX driver's loss
  (``enhance_main.py:112-126``, written out here): the loss rtol 1e-5;
  the predictor's gradients as above; the base's as its own train step's
  tests hold them (a TGN's rtol 1e-4, atol 1e-5 of each tensor's largest,
  1e-4 for its time encoder, ``tests/test_torch_train.py``; a
  GraphMixer's atol 5e-4 of the largest, ``tests/test_torch_graphmixer.py``:
  token LayerNorms over near-constant rows); the TGN's new memory rtol
  2e-4, atol 1e-5; the parameters after Adam against ``optax.adam`` on the
  port's own gradients (rtol 1e-6, atol 5e-5 of lr per step: optax rounds
  its bias corrections in float32) and against the JAX step where the
  gradient is settled (above 1e-4 of its tensor's largest: rtol 1e-5,
  atol 1e-6; elsewhere Adam turns round-off of either sign into a step of
  up to lr, so the packages part by up to 2 lr there), and
  with ``--weight_decay`` the AdamW step against ``optax.adamw`` masked to
  the predictor.
* The freeze warmup: over two frozen steps and one joint step the base
  stays bitwise unchanged, then moves as optax's does on the zeroed
  gradients (one step count over both models).
* One TGAT enhance step (``TempMETGAT`` on the walks alone) likewise.
* The committed uslegis enhance checkpoints, read by the port's own
  reader: every tensor equals flax's load, and the logits through the
  trained base and predictor agree with JAX's (rtol 2e-4, atol 1e-5); the
  GraphMixer base holds the 2 blocks the JAX driver trained (C7).
* ``tools/node_degrees.py`` equals JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tests.test_torch_tgn import Setup, _np_tree, _t
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import tempme as JE
from tempme_tpu.explain.tempme_tgat import TempMETGAT as JaxTempMETGAT
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.models.graphmixer import GraphMixer as JaxGraphMixer
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.models.tgn import init_memory_state as jax_init_memory
from tempme_tpu.tools import node_degrees as JND
from tempme_tpu.train import loops as JL
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu.utils.checkpoint import load_meta, load_params
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.explain.tempme import TempME, WalkInputs
from tempme_tpu_torch.explain.tempme_tgat import TempMETGAT
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.graphmixer import GraphMixer
from tempme_tpu_torch.models.tgn import TGN, init_memory_state
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.tools import node_degrees as ND
from tempme_tpu_torch.train import enhance_main as E
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.utils.convert import (enhance_state_dicts,
                                            flax_to_state_dict, mixer_blocks,
                                            read_flax_msgpack)

B, N, HID, OUT, LR = 6, 3, 8, 8, 1e-3
W = N * E.N_WALK_CONT
RTOL, ATOL = 2e-4, 1e-5


def _port_draws(key, dst_len, b=B, n=N):
    """The port's draws for JAX's ``sample_explainer_inputs(key)`` (2-hop
    supports): the negatives' indices, per side the hops' and the walks'
    uniforms."""
    kn, k1, k2, k3, w1, w2, w3 = jax.random.split(key, 7)
    hops = []
    for k in (k1, k2, k3):
        side = []
        for layer in range(2):
            k, sub = jax.random.split(k)
            side.append(_t(jax.random.uniform(sub, (b * n ** layer, n))))
        hops.append(tuple(side))
    walks = []
    for wk in (w1, w2, w3):
        kk, ku2 = jax.random.split(wk)
        _, ku3 = jax.random.split(kk)
        walks.append(S.WalkDraws(
            _t(jax.random.uniform(ku2, (b * n, E.N_WALK_CONT))),
            _t(jax.random.uniform(ku3, (b * n * E.N_WALK_CONT,)))))
    neg = _t(jax.random.randint(kn, (b,), 0, dst_len)).long()
    return L.EnhanceDraws(L.SupportDraws(neg, *hops), tuple(walks))


def _walks(walks):
    return tuple(WalkInputs(*(_t(x) for x in w)) for w in walks)


def _subs(subs):
    return tuple(Subgraph(*(tuple(_t(x) for x in f) for f in s))
                 for s in subs)


def _batch(jb):
    return L.Batch(*(_t(x) for x in jb))


def _grads_close(port, ref, name, frac=1e-4, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=frac * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


def _tgat_grads_close(model, ref):
    """``TempMETGAT``'s gradients against JAX's (``ref``, a state dict);
    the attention key biases', zero in exact arithmetic, to 1e-4 of the
    model's largest. Returns the port's gradients (zeros where none)."""
    top = max(float(v.abs().max()) for v in ref.values())
    out = {}
    for name, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        want = ref[name].numpy()
        if name.endswith("self_attn.key.bias"):
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * top,
                                       err_msg=name)
        else:
            _grads_close(g, want, name)
        out[name] = g
    return out


class World:
    """A small TGN world (``tests/test_torch_tgn.py``'s ``Setup``, JAX's
    CSR sampler), its degree table and one batch's supports and walks."""

    def __init__(self, seed=3):
        s = Setup(seed=seed)
        s.jg = dataclasses.replace(s.jg, dense_ts=None, dense_node=None,
                                   dense_eid=None)
        self.s = s
        self.dst = np.unique(s.ev.dst)
        self.deg = JND.compute_node_degrees(s.ev)
        self.sample = jax.jit(lambda k, b: JX.sample_explainer_inputs(
            s.jg, k, b, jnp.asarray(self.dst), N))

    def inputs(self, start, seed):
        jb, key = self.s.batch(start, B), jax.random.PRNGKey(seed)
        return jb, key, self.sample(key, jb)

    def mixed_inputs(self, seed):
        """A batch of mid-stream events whose row 0 has source node 0 and
        row 1 destination node 0 (the padding id, no history: all their
        walks are padding), its supports, and three sides' walks: src,
        tgt, and as the third side the walks of the batch with src and
        dst swapped, so that each side has a row of empty walks."""
        ev = self.s.ev
        idx = np.arange(150, 150 + B)
        src, dst = ev.src[idx].copy(), ev.dst[idx].copy()
        src[0], dst[1] = 0, 0
        jb = JL.Batch(jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(ev.ts[idx]), jnp.asarray(ev.e_idx[idx]),
                      jnp.ones(B, bool))
        key = jax.random.PRNGKey(seed)
        _, subs, walks = self.sample(key, jb)
        _, _, swapped = self.sample(jax.random.fold_in(key, 1),
                                    jb._replace(src=jb.dst, dst=jb.src))
        return jb, subs, (walks[0], walks[1], swapped[0])


@pytest.fixture(scope="module")
def world():
    return World()


def _predictor(world, base_type="tgn", hid=HID, seed=7):
    s = world.s
    jb, _, (bgd, subs, walks) = world.inputs(120, 0)
    je = JE.TempME(node_dim=12, edge_dim=6, out_dim=OUT, hid_dim=hid,
                   base_type=base_type, dropout=0.0)
    params = jax.jit(lambda k: je.init(
        {"params": k}, s.jfeats, walks[0], jb.ts, subs[0],
        method=JE.TempME.init_all))(jax.random.PRNGKey(seed))
    te = TempME(12, 6, out_dim=OUT, hid_dim=hid, base_type=base_type,
                dropout=0.0, device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return je, params, te


@pytest.mark.parametrize("with_degree", [False, True])
def test_tempme_enhance_form_matches_jax(world, with_degree):
    s = world.s
    je, params, te = _predictor(world)
    jb, subs, walks = world.mixed_inputs(4)
    nodes = [np.asarray(w.nodes) for w in walks]
    assert not nodes[0][0].any() and not nodes[1][1].any() and \
        not nodes[2][1].any()
    assert (nodes[0][2:] == 0).any() and (nodes[0][2:] > 0).any()
    r = np.random.RandomState(5)
    gats = [r.randn(B, 12).astype(np.float32) for _ in range(3)]
    coef = r.randn(2, B, 1).astype(np.float32)
    deg = jnp.asarray(world.deg) if with_degree else None

    def jax_out(p, gats):
        emb = je.apply(p, s.jfeats, walks[0], jb.ts, deg,
                       method=JE.TempME.walk_embedding)
        pos, neg = je.apply(p, s.jfeats, jb.ts, *walks, *gats,
                            node_degree=deg,
                            method=JE.TempME.enhance_predict_agg)
        return emb, pos, neg

    def jax_loss(p, gats):
        _, pos, neg = jax_out(p, gats)
        return (pos * coef[0]).sum() + (neg * coef[1]).sum()

    emb_r, pos_r, neg_r = jax.jit(jax_out)(params, [jnp.asarray(g)
                                                    for g in gats])
    g_params, g_gats = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        params, [jnp.asarray(g) for g in gats])

    tw = _walks(walks)
    tdeg = None if deg is None else _t(world.deg)
    tgats = [_t(g).requires_grad_() for g in gats]
    emb = te.walk_embedding(s.tfeats, tw[0], _t(jb.ts), tdeg)
    pos, neg = te.enhance_predict_agg(s.tfeats, _t(jb.ts), *tw, *tgats,
                                      tdeg)
    assert emb.shape == (B, HID + 12) and pos.shape == (B, 1)
    for a, b in ((emb, emb_r), (pos, pos_r), (neg, neg_r)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    ((pos * _t(coef[0])).sum() + (neg * _t(coef[1])).sum()).backward()
    ref = flax_to_state_dict(_np_tree(g_params))
    for name, p in te.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        _grads_close(got, ref[name].numpy(), name)
    for a, b in zip(tgats, g_gats):
        _grads_close(a.grad.numpy(), b, "gat")
    # the enhance form reads the motif attention, the event conv and the
    # affinity; not the importance head or the dependency gate
    assert te.aff_fc1.weight.grad.abs().max() > 0
    assert te.head_d1.weight.grad is None and te.dep_d1.weight.grad is None


@pytest.fixture(scope="module")
def tgat(world):
    """A JAX ``TempMETGAT`` (width 20 for ``walk_enc_cat``), its weights
    and one compiled ``jax.value_and_grad`` of the TGAT branch's loss
    (``enhance_main.py:378-387``) at dropout 0, which also returns a side's
    walk embedding and the logits."""
    s = world.s
    jb, subs, walks = world.mixed_inputs(4)
    je = JaxTempMETGAT(node_dim=12, edge_dim=6, out_dim=OUT, hid_dim=16,
                       dropout=0.0)
    params = jax.jit(lambda k: je.init(
        {"params": k}, s.jfeats, walks[0], jb.src, jb.ts, jb.dst, subs[0],
        method=JaxTempMETGAT.init_all))(jax.random.PRNGKey(3))
    deg = jnp.asarray(world.deg)

    def loss_fn(p, ts, walks):
        emb = je.apply(p, s.jfeats, walks[1], ts, deg,
                       method=JaxTempMETGAT.walk_embedding)
        pos, neg = je.apply(p, s.jfeats, ts, *walks, node_degree=deg,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            method=JaxTempMETGAT.enhance_predict_agg)
        return _bce(pos, neg), (emb, pos, neg)
    return dict(params=params, inputs=(jb, subs, walks),
                vg=jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))


def _port_tgat(tgat):
    te = TempMETGAT(12, 6, out_dim=OUT, hid_dim=16, dropout=0.0,
                    device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(tgat["params"])))
    return te


def test_tgat_enhance_form_matches_jax(world, tgat):
    s = world.s
    jb, subs, walks = tgat["inputs"]
    (_, (emb_r, pos_r, neg_r)), g_params = tgat["vg"](tgat["params"], jb.ts,
                                                      walks)
    te = _port_tgat(tgat)
    assert te.walk_enc_cat.self_attn.head_dim == 3      # 20 -> 24 over 8
    tw = _walks(walks)
    emb = te.walk_embedding(s.tfeats, tw[1], _t(jb.ts), _t(world.deg))
    pos, neg = te.enhance_predict_agg(s.tfeats, _t(jb.ts), *tw,
                                      _t(world.deg))
    assert emb.shape == (B, W, OUT + 12)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(emb_r),
                               rtol=1e-5, atol=1e-6)
    for a, b in ((pos, pos_r), (neg, neg_r)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    E.enhance_loss(pos, neg).backward()
    _tgat_grads_close(te, flax_to_state_dict(_np_tree(g_params)))
    assert te.walk_enc_cat.fc1.weight.grad.abs().max() > 0
    assert te.walk_enc.fc1.weight.grad is None


# -- the joint train step ---------------------------------------------------
def _bce(pos, neg):
    return (optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)).mean()
            + optax.sigmoid_binary_cross_entropy(
                neg, jnp.zeros_like(neg)).mean())


def _port_step(te, tbase, world_g, tfeats, dst, deg, opt):
    return E.EnhanceTrainStep(te, tbase, world_g, tfeats, _t(dst), N,
                              _t(deg), opt)


def _optax_step(opt, grads, state, params):
    """(params after one step of ``opt``, new state), compiled as one
    program (op by op, every small leaf's shape would compile apart)."""
    @jax.jit
    def step(grads, state, params):
        upd, state = opt.update(grads, state, params)
        return optax.apply_updates(params, upd), state
    return step(grads, state, params)


def _check_adam(model, before, port_grads, jopt, ref_params, lr, frac_grad,
                prefix=""):
    """The port's parameters after one step against optax on its own
    gradients (tight) and against the JAX step (settled entries)."""
    want, _ = _optax_step(jopt, port_grads, jopt.init(before), before)
    want = {n: np.asarray(x) for n, x in want.items()}
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[name], rtol=1e-6,
                                   atol=5e-5 * lr, err_msg=prefix + name)
        g = port_grads[name]
        # a key bias's gradient is round-off throughout (zero exactly)
        settled = np.abs(g) >= frac_grad * np.abs(g).max() if not \
            name.endswith("self_attn.key.bias") else np.zeros(g.shape, bool)
        ref = ref_params[name].numpy()
        np.testing.assert_allclose(got[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=prefix + name)
        # a round-off gradient is a step of up to lr either way
        assert np.abs(got - ref).max() <= 2 * lr * 1.001, prefix + name


def test_tgat_enhance_step_matches_jax(world, tgat):
    """``_main_tgat``'s step: ``TempMETGAT`` on the walks alone, Adam,
    from the port's own sampling of JAX's draws."""
    s = world.s
    jb, key, (bgd, subs, walks) = world.inputs(170, 23)
    params = tgat["params"]
    (loss_r, _), grads = tgat["vg"](params, jb.ts, walks)
    jopt = optax.adam(LR)
    jparams, _ = _optax_step(jopt, grads, jopt.init(params), params)
    jparams = flax_to_state_dict(_np_tree(jparams))
    te = _port_tgat(tgat)
    before = {n: p.detach().numpy().copy() for n, p in te.named_parameters()}
    opt = torch.optim.Adam(te.parameters(), lr=LR)
    step = _port_step(te, None, s.tg, s.tfeats, world.dst, world.deg, opt)
    mem, aux = step(None, _batch(jb), _port_draws(key, len(world.dst)))
    assert mem is None
    np.testing.assert_allclose(aux["loss"].item(), float(loss_r), rtol=1e-5)
    port_grads = _tgat_grads_close(te, flax_to_state_dict(_np_tree(grads)))
    _check_adam(te, before, port_grads, optax.adam(LR), jparams, LR, 1e-4)


# -- the committed uslegis enhance checkpoints -------------------------------
USLEGIS = "params/enhance/{}/uslegis_sampled.msgpack"


class _Wide:
    """A stream at the uslegis widths (node 172, edge 1), both graphs
    (JAX's CSR sampler), empty memories, one batch and its supports (n 30,
    the bases' n_degree) and walks."""

    def __init__(self, seed=6):
        self.ev = ev = make_events(num_events=240, num_nodes=40, seed=seed)
        self.num_nodes = nn_ = ev.num_nodes
        self.jg = dataclasses.replace(
            jax_build_graph(ev, num_nodes=nn_), dense_ts=None,
            dense_node=None, dense_eid=None)
        self.tg = build_temporal_graph(to_torch_events(ev), num_nodes=nn_,
                                       device="cpu")
        r = np.random.RandomState(seed)
        node = r.randn(nn_, 172).astype(np.float32)
        edge = r.randn(self.jg.num_edges, 1).astype(np.float32)
        node[0] = edge[0] = 0.0
        self.jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
        self.tfeats = Features(_t(node), _t(edge))
        raw = 3 * 172 + 1
        self.jmem = jax_init_memory(nn_, 172, raw)
        self.tmem = init_memory_state(nn_, 172, raw, device="cpu")
        self.deg = JND.compute_node_degrees(ev)
        self.jb = JL.Batch(*(jnp.asarray(x[150:154]) for x in (
            ev.src, ev.dst, ev.ts, ev.e_idx)), jnp.ones(4, bool))
        dst = jnp.asarray(np.unique(ev.dst))
        self.bgd, self.subs, self.walks = jax.jit(
            lambda k, b: JX.sample_explainer_inputs(self.jg, k, b, dst, 30))(
                jax.random.PRNGKey(8), self.jb)


@functools.lru_cache
def _wide_world():
    return _Wide()


def _jax_predictor_template(w, hid):
    je = JE.TempME(node_dim=172, edge_dim=1, out_dim=40, hid_dim=hid)
    return je, jax.eval_shape(lambda: je.init(
        {"params": jax.random.PRNGKey(0)}, w.jfeats, w.walks[0], w.jb.ts,
        w.subs[0], method=JE.TempME.init_all))


def _read_enhance(base_type, template):
    path = USLEGIS.format(base_type)
    ref = load_params(path, template)
    own = enhance_state_dicts(read_flax_msgpack(path))
    parts = ("predictor", "base") if "base" in own else ("predictor",)
    for part in parts:
        want = flax_to_state_dict(_np_tree(
            ref[part] if len(parts) == 2 else ref))
        assert own[part].keys() == want.keys(), part
        for name in want:
            assert torch.equal(own[part][name], want[name]), (part, name)
    return ref, own, load_meta(path)


@pytest.mark.parametrize("base_type", ["tgn", "graphmixer"])
def test_uslegis_enhance_checkpoint_matches_jax(base_type):
    s = _wide_world()
    jb, bgd, subs, walks = s.jb, s.bgd, s.subs, s.walks
    meta_hid = load_meta(USLEGIS.format(base_type))["hid_dim"]
    je, ptmpl = _jax_predictor_template(s, meta_hid)
    if base_type == "tgn":
        jm = JaxTGN(node_dim=172, edge_dim=1, num_nodes=s.num_nodes,
                    n_layers=2, n_head=2, dropout=0.0,
                    compute_dtype=jnp.float32)
        btmpl = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), s.jfeats, s.jmem, jb.src, jb.dst, bgd,
            jb.ts, jb.eidx, *subs))
    else:
        # C7: the committed run trained the 2 blocks JAX's loader built
        jm = JaxGraphMixer(node_dim=172, edge_dim=1, num_tokens=30,
                           num_layers=2, dropout=0.0)
        btmpl = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), s.jfeats, jb.src, jb.dst, bgd, jb.ts,
            *subs, deterministic=True))
    ref, own, meta = _read_enhance(base_type, {"predictor": ptmpl,
                                               "base": btmpl})
    assert (meta["out_dim"], meta["hid_dim"]) == (40, meta_hid)
    if base_type == "tgn":
        assert meta_hid == 32
        assert own["predictor"]["aff_fc1.weight"].shape == (216, 432)
        tm = TGN(172, 1, s.num_nodes, n_layers=2, n_head=2,
                 device="cpu", compute_dtype=torch.float32)
    else:
        assert mixer_blocks(own["base"]) == 2
        tm = GraphMixer(172, 1, 30, num_layers=mixer_blocks(own["base"]),
                        device="cpu")
    tm.load_state_dict(own["base"])                       # strict
    te = TempME(172, 1, out_dim=40, hid_dim=meta_hid, base_type=base_type,
                device="cpu")
    te.load_state_dict(own["predictor"])
    deg = s.deg

    def jax_logits(ps):
        if base_type == "tgn":
            (es, et, eb), _ = jm.apply(ps["base"], s.jfeats, s.jmem, jb.src,
                                       jb.dst, bgd, jb.ts, jb.eidx, *subs,
                                       method=JaxTGN.get_node_emb)
        else:
            es, et, eb = jm.apply(ps["base"], s.jfeats, jb.src, jb.dst, bgd,
                                  jb.ts, *subs,
                                  method=JaxGraphMixer.get_node_emb)
        return je.apply(ps["predictor"], s.jfeats, jb.ts, *walks, es, et, eb,
                        node_degree=jnp.asarray(deg),
                        method=JE.TempME.enhance_predict_agg)
    pos_r, neg_r = jax.jit(jax_logits)(ref)
    tb = _batch(jb)
    tsubs = _subs(subs)
    with torch.no_grad():
        if base_type == "tgn":
            embs, _ = tm.get_node_emb(s.tfeats, s.tmem, tb.src, tb.dst,
                                      _t(bgd), tb.ts, tb.eidx, *tsubs)
        else:
            embs = tm.get_node_emb(s.tfeats, tb.src, tb.dst, _t(bgd), tb.ts,
                                   *tsubs)
        pos, neg = te.enhance_predict_agg(s.tfeats, tb.ts, *_walks(walks),
                                          *embs, _t(deg))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)


def test_uslegis_tgat_enhance_checkpoint_matches_jax():
    s = _wide_world()
    jb, subs, walks = s.jb, s.subs, s.walks
    je = JaxTempMETGAT(node_dim=172, edge_dim=1, out_dim=40, hid_dim=64)
    tmpl = jax.eval_shape(lambda: je.init(
        {"params": jax.random.PRNGKey(0)}, s.jfeats, walks[0], jb.src,
        jb.ts, jb.dst, subs[0], method=JaxTempMETGAT.init_all))
    ref, own, meta = _read_enhance("tgat", tmpl)
    assert set(own) == {"predictor"}
    te = TempMETGAT(172, 1, out_dim=meta["out_dim"], hid_dim=meta["hid_dim"],
                    device="cpu")
    te.load_state_dict(own["predictor"])
    assert te.walk_enc_cat.self_attn.head_dim == 7        # 52 -> 56 over 8
    deg = s.deg
    pos_r, neg_r = jax.jit(lambda p: je.apply(
        p, s.jfeats, jb.ts, *walks, node_degree=jnp.asarray(deg),
        method=JaxTempMETGAT.enhance_predict_agg))(ref)
    with torch.no_grad():
        pos, neg = te.enhance_predict_agg(s.tfeats, _t(jb.ts),
                                          *_walks(walks), _t(deg))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)


def test_node_degrees_match_jax(tmp_path):
    ev = make_events(num_events=600, num_nodes=30, seed=1, allow_node0=True)
    want = JND.compute_node_degrees(ev)
    got = ND.compute_node_degrees(to_torch_events(ev))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got[0] == 0.0 and got.sum() > 0
    np.testing.assert_array_equal(
        ND.compute_node_degrees(to_torch_events(ev), 40),
        JND.compute_node_degrees(ev, 40))
    path = str(tmp_path / "deg.npy")
    ND.save_node_degrees(path, got)
    np.testing.assert_array_equal(ND.load_node_degrees(path), want)
