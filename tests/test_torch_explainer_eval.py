"""The port's TempME eval step and checkpoint conversion against the JAX
package on the CPU.

* The eval step's explained logits and ratio sweep (``pos_r``, ``neg_r``)
  against the JAX driver's eval core on a frozen toy TGN, from the same
  draws: rtol 2e-4, atol 1e-5 (the serving tolerance: ``cos`` of large
  time arguments loses digits in both packages).
* The committed JAX checkpoint ``params/explainer/tgn/uslegis_sampled``
  (node 172, edge 1, hid 64, ``n_degree`` 30) converts onto ``TempME``
  parameter for parameter (a strict ``load_state_dict``), and gives the
  same walk importance on the same walks: rtol 1e-5, atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.conftest import make_events
from tests.test_torch_explainer import B, N, _explainers, _port_draws
from tests.test_torch_explainer import world  # noqa: F401 (fixture)
from tests.test_torch_tgn import _np_tree, _t
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import tempme as JE
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu.utils.checkpoint import load_meta, load_params
from tempme_tpu_torch.explain.tempme import TempME, WalkInputs
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.utils.convert import flax_to_state_dict

CKPT = "params/explainer/tgn/uslegis_sampled.msgpack"


def test_eval_step_matches_jax(world):
    s = world
    jb = s.batch(200, B)
    key = jax.random.PRNGKey(31)
    dst = jnp.asarray(s.dst)
    ratios = (0.1, 0.3, 0.6)
    bgd, subs, walks = jax.jit(
        lambda k, b: JX.sample_explainer_inputs(s.jg, k, b, dst, N))(key, jb)
    je, params, te = _explainers(s, 0.1, walks[0], subs[0], jb.ts)
    contrast = JX.make_base_contrast(s.jbase, s.jfeats)

    @jax.jit
    def eval_core(ep):
        # temp_exp_main.py:365-393, the JAX driver's eval core (TGN)
        imps = [je.apply(ep, s.jfeats, walks[i], jb.ts, deterministic=True)
                for i in range(3)]
        explanation = je.apply(
            ep, s.jfeats, subs[0], imps[0], walks[0], subs[1], imps[1],
            walks[1], subs[2], imps[2], walks[2], training=False,
            deterministic=True, method=JE.TempME.retrieve_explanation)
        pos, neg = contrast(jb.src, jb.dst, bgd, jb.ts, jb.eidx, *subs,
                            explanation)
        keeps = JX.keep_masks_for_ratios(explanation, ratios, N)
        pos_r, neg_r = s.jm.apply(
            s.params, s.jfeats, s.jmem, jb.src, jb.dst, bgd, jb.ts, *subs,
            *keeps, method=type(s.jm).ratio_contrast)
        return pos, neg, pos_r, neg_r
    ref = eval_core(params)
    support, wdraws = _port_draws(key, len(s.dst))
    step = X.ExplainerEvalStep(te, s.tbase, s.tg, s.tfeats, _t(s.dst), N,
                               _t(s.null), 0.3, ratios)
    out = step(L.Batch(*(_t(x) for x in jb)),
               X.ExplainerDraws(support, wdraws))
    for name, want in zip(("pos", "neg", "pos_r", "neg_r"), ref):
        np.testing.assert_allclose(out[name].numpy(),
                                   np.asarray(want).reshape(
                                       out[name].shape),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    assert out["pos_r"].shape == (len(ratios), B)


def test_committed_checkpoint_converts_and_scores_walks_alike():
    meta = load_meta(CKPT)
    assert (meta["node_dim"], meta["edge_dim"], meta["hid_dim"],
            meta["n_degree"]) == (172, 1, 64, 30)
    ev = make_events(num_events=300, num_nodes=40, seed=9)
    jg = jax_build_graph(ev)
    jg = dataclasses.replace(jg, dense_ts=None, dense_node=None,
                             dense_eid=None)
    r = np.random.RandomState(2)
    node = r.randn(jg.num_nodes, 172).astype(np.float32)
    edge = r.randn(jg.num_edges, 1).astype(np.float32)
    node[0] = edge[0] = 0.0
    jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
    b, n = 8, 5
    src = jnp.asarray(ev.src[200:200 + b])
    ts = jnp.asarray(ev.ts[200:200 + b])
    eidx = jnp.asarray(ev.e_idx[200:200 + b])
    kh, kw = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def walks_of(kh, kw):
        sub = JX.S.find_k_hop(jg, kh, src, ts, 2, n, eids=eidx)
        return sub, JE.make_walk_inputs(JX.S.find_k_walks(jg, kw, src, sub,
                                                          n, 3))
    sub, walks = walks_of(kh, kw)
    je = JE.TempME(node_dim=172, edge_dim=1, out_dim=meta["out_dim"],
                   hid_dim=meta["hid_dim"], dropout=meta["drop_out"])
    template = jax.jit(lambda k: je.init(
        {"params": k}, jfeats, walks, ts, sub,
        method=JE.TempME.init_all))(jax.random.PRNGKey(0))
    params = load_params(CKPT, template)
    want = jax.jit(lambda p: je.apply(p, jfeats, walks, ts,
                                      deterministic=True))(params)
    te = TempME(172, 1, out_dim=meta["out_dim"], hid_dim=meta["hid_dim"],
                dropout=meta["drop_out"], device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))   # strict
    tw = WalkInputs(*(_t(x) for x in walks))
    with torch.no_grad():
        got = te(Features(_t(node), _t(edge)), tw, _t(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert got.std() > 0
