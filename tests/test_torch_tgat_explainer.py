"""The port's TGAT explainer (``TempMETGAT``) and its eval step against the
JAX package on the CPU.

* The committed ``params/explainer/tgat/uslegis_sampled.msgpack`` (node
  172, edge 1: event width 517, attention 8 heads of 65 after rounding up
  to 520) converts onto ``TempMETGAT`` parameter for parameter (a strict
  ``load_state_dict``: the 3-D attention kernels, the encoder layers'
  auto-named ``Dense_j`` and ``LayerNorm_j``, ``walk_enc_cat`` and
  ``aff_fc``) and gives the same walk importance on the same walks: rtol
  1e-5, atol 1e-6 (float32 sums in another order; flax's LayerNorm takes
  the variance as E[x^2] - E[x]^2).
* At small widths, from the same flax weights: the three sides' walk
  importances (each read with its anchor pair) and ``retrieve_explanation``
  in eval (the walk -> edge max, padding zeroed, no Beta mean) at the same
  tolerance.
* The eval step on a frozen 3-layer TGAT (3-hop supports; the port sweeps
  4 ratios at a time, the JAX reference here all 8 at once): the explained
  logits, the fidelity and the sweep's logits against the JAX driver's eval
  core from the same draws, rtol 2e-4, atol 1e-5 (the serving tolerance of
  ``tests/test_torch_tgn.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain.tempme_tgat import TempMETGAT as JaxTempMETGAT
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.models.tgat import TGAT as JaxTGAT
from tempme_tpu.train import loops as JL
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu.utils.checkpoint import load_meta, load_params
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.explain.tempme import WalkInputs
from tempme_tpu_torch.explain.tempme_tgat import TempMETGAT
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgat import TGAT
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.utils.convert import flax_to_state_dict

CKPT = "params/explainer/tgat/uslegis_sampled.msgpack"
B, N, DN, DE, HID, OUT = 4, 3, 12, 8, 16, 8


class World:
    def __init__(self, node_dim, edge_dim, seed=2):
        self.ev = make_events(num_events=300, num_nodes=40, seed=seed)
        jg = jax_build_graph(self.ev)
        self.jg = dataclasses.replace(jg, dense_ts=None, dense_node=None,
                                      dense_eid=None)
        self.tg = build_temporal_graph(to_torch_events(self.ev),
                                       num_nodes=jg.num_nodes, device="cpu")
        r = np.random.RandomState(seed)
        node = r.randn(jg.num_nodes, node_dim).astype(np.float32)
        edge = r.randn(jg.num_edges, edge_dim).astype(np.float32)
        node[0] = edge[0] = 0.0
        self.jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
        self.tfeats = Features(_t(node), _t(edge))
        self.dst = np.unique(self.ev.dst)

    def batch(self, start):
        s = slice(start, start + B)
        ev = self.ev
        return JL.Batch(jnp.asarray(ev.src[s]), jnp.asarray(ev.dst[s]),
                        jnp.asarray(ev.ts[s]), jnp.asarray(ev.e_idx[s]),
                        jnp.ones(B, bool))

    def inputs(self, key, jb, k_hops):
        dst = jnp.asarray(self.dst)
        return jax.jit(lambda k, b: JX.sample_explainer_inputs(
            self.jg, k, b, dst, N, k_hops=k_hops))(key, jb)


def _port_walks(walks):
    return tuple(WalkInputs(*(_t(x) for x in w)) for w in walks)


def _port_subs(subs):
    return tuple(Subgraph(*(tuple(_t(x) for x in f) for f in s))
                 for s in subs)


def _port_draws(key, k_hops, dst_len):
    """The port's draws for JAX's ``sample_explainer_inputs(key)``: the
    negatives' indices, per side the hops' uniforms and the walks'."""
    kn, k1, k2, k3, w1, w2, w3 = jax.random.split(key, 7)
    hops = []
    for k in (k1, k2, k3):
        side = []
        for layer in range(k_hops):
            k, sub = jax.random.split(k)
            side.append(_t(jax.random.uniform(sub, (B * N ** layer, N))))
        hops.append(tuple(side))
    walks = []
    for wk in (w1, w2, w3):
        kk, ku2 = jax.random.split(wk)
        _, ku3 = jax.random.split(kk)
        walks.append(S.WalkDraws(
            _t(jax.random.uniform(ku2, (B * N, X.N_WALK_CONT))),
            _t(jax.random.uniform(ku3, (B * N * X.N_WALK_CONT,)))))
    neg = _t(jax.random.randint(kn, (B,), 0, dst_len)).long()
    return L.SupportDraws(neg, *hops), tuple(walks)


def _explainers(w, walks0, jb, sub0, node_dim, edge_dim):
    je = JaxTempMETGAT(node_dim=node_dim, edge_dim=edge_dim, out_dim=OUT,
                       hid_dim=HID)
    params = jax.jit(lambda k: je.init(
        {"params": k}, w.jfeats, walks0, jb.src, jb.ts, jb.dst, sub0,
        method=JaxTempMETGAT.init_all))(jax.random.PRNGKey(3))
    te = TempMETGAT(node_dim, edge_dim, out_dim=OUT, hid_dim=HID,
                    device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return je, params, te


def test_committed_checkpoint_converts_and_scores_walks_alike():
    meta = load_meta(CKPT)
    assert (meta["node_dim"], meta["edge_dim"], meta["out_dim"],
            meta["hid_dim"]) == (172, 1, 40, 64)
    w = World(172, 1, seed=9)
    jb = w.batch(200)
    _, subs, walks = w.inputs(jax.random.PRNGKey(0), jb, 2)
    je = JaxTempMETGAT(node_dim=172, edge_dim=1, out_dim=40, hid_dim=64,
                       dropout=meta["drop_out"])
    template = jax.eval_shape(lambda: je.init(
        {"params": jax.random.PRNGKey(0)}, w.jfeats, walks[0], jb.src,
        jb.ts, jb.dst, subs[0], method=JaxTempMETGAT.init_all))
    params = load_params(CKPT, template)
    want = jax.jit(lambda p: je.apply(p, w.jfeats, walks[0], jb.src, jb.ts,
                                      jb.dst, deterministic=True))(params)
    te = TempMETGAT(172, 1, out_dim=40, hid_dim=64, device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))    # strict
    assert te.event_enc.self_attn.head_dim == 65
    assert te.event_enc.norm1.eps == 1e-6
    with torch.no_grad():
        got = te(w.tfeats, _port_walks(walks)[0], _t(jb.src), _t(jb.ts),
                 _t(jb.dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert got.std() > 0


def test_importance_and_retrieve_explanation_at_eval():
    w = World(DN, DE)
    jb = w.batch(150)
    bgd, subs, walks = w.inputs(jax.random.PRNGKey(5), jb, 2)
    je, params, te = _explainers(w, walks[0], jb, subs[0], DN, DE)
    sides = ((jb.src, jb.dst), (jb.dst, jb.src), (bgd, jb.src))

    @jax.jit
    def ref(p):
        imps = [je.apply(p, w.jfeats, walks[i], a, jb.ts, o,
                         deterministic=True)
                for i, (a, o) in enumerate(sides)]
        expl = je.apply(p, w.jfeats, subs[0], imps[0], walks[0], subs[1],
                        imps[1], walks[1], subs[2], imps[2], walks[2],
                        training=False, deterministic=True,
                        method=JaxTempMETGAT.retrieve_explanation)
        return imps, expl
    jimps, jexpl = ref(params)
    tw, ts = _port_walks(walks), _port_subs(subs)
    with torch.no_grad():
        imps = [te(w.tfeats, tw[i], _t(a), _t(jb.ts), _t(o))
                for i, (a, o) in enumerate(sides)]
        expl = te.retrieve_explanation(w.tfeats, ts, imps, tw,
                                       training=False)
    for got, want in zip(imps + expl, list(jimps) + list(jexpl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert expl[1].shape == (3 * B, N * N) and (expl[1] > 0).any()
    # padding support edges carry no importance
    assert not expl[0][torch.cat([s.nodes[0] for s in ts]) == 0].any()


def test_eval_step_on_a_3_layer_base_matches_jax():
    w = World(DN, DE, seed=4)
    jb = w.batch(180)
    key = jax.random.PRNGKey(17)
    bgd, subs, walks = w.inputs(key, jb, 3)
    assert len(subs[0].nodes) == 3
    jm = JaxTGAT(node_dim=DN, edge_dim=DE, num_layers=3, n_head=2,
                 dropout=0.0, compute_dtype=jnp.float32)
    bparams = jax.jit(lambda k: jm.init(k, w.jfeats, jb.src, jb.dst, bgd,
                                        jb.ts, *subs, deterministic=True))(
        jax.random.PRNGKey(1))
    tm = TGAT(DN, DE, num_layers=3, dropout=0.0, remat=True, device="cpu",
              compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(_np_tree(bparams)))
    tm.requires_grad_(False)
    je, params, te = _explainers(w, walks[0], jb, subs[0], DN, DE)
    jbase = JX.LoadedBase("tgat", jm, bparams, None, {"n_layer": 3})
    contrast = JX.make_base_contrast(jbase, w.jfeats)
    ratios = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.6)
    sides = ((jb.src, jb.dst), (jb.dst, jb.src), (bgd, jb.src))

    @jax.jit
    def eval_core(ep):
        # temp_exp_main.py:388-451, the JAX driver's eval core (TGAT)
        pos_ori, neg_ori = contrast(jb.src, jb.dst, bgd, jb.ts, jb.eidx,
                                    *subs, None)
        imps = [je.apply(ep, w.jfeats, walks[i], a, jb.ts, o,
                         deterministic=True)
                for i, (a, o) in enumerate(sides)]
        expl = je.apply(ep, w.jfeats, subs[0], imps[0], walks[0], subs[1],
                        imps[1], walks[1], subs[2], imps[2], walks[2],
                        training=False, deterministic=True,
                        method=JaxTempMETGAT.retrieve_explanation)
        pos, neg = contrast(jb.src, jb.dst, bgd, jb.ts, jb.eidx, *subs, expl)
        keeps = JX.keep_masks_for_ratios(expl, ratios, N)
        pos_r, neg_r = jm.apply(bparams, w.jfeats, jb.src, jb.dst, bgd,
                                jb.ts, *subs, *keeps,
                                method=JaxTGAT.ratio_contrast)
        return pos_ori, neg_ori, pos, neg, pos_r, neg_r
    ref = dict(zip(("pos_ori", "neg_ori", "pos", "neg", "pos_r", "neg_r"),
                   eval_core(params)))
    null = np.full(12, 1 / 12, np.float32)
    step = X.ExplainerEvalStep(te, X.LoadedBase("tgat", tm, None, {}),
                               w.tg, w.tfeats, _t(w.dst), N, _t(null), 0.3,
                               ratios)
    support, wdraws = _port_draws(key, 3, len(w.dst))
    out = step(L.Batch(*(_t(x) for x in jb)),
               X.ExplainerDraws(support, wdraws))
    for name, want in ref.items():
        np.testing.assert_allclose(out[name].numpy(),
                                   np.asarray(want).reshape(out[name].shape),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    assert out["pos_r"].shape == (len(ratios), B)

    def fid(pos, neg, pos_ori, neg_ori):
        sig = (lambda x: 1 / (1 + np.exp(-np.asarray(x, np.float64))))
        return np.r_[sig(pos) - sig(pos_ori), sig(neg_ori) - sig(neg)].mean()
    np.testing.assert_allclose(
        fid(*(out[k].numpy() for k in ("pos", "neg", "pos_ori", "neg_ori"))),
        fid(*(np.asarray(ref[k]).ravel()
              for k in ("pos", "neg", "pos_ori", "neg_ori"))),
        rtol=2e-4, atol=1e-5)
