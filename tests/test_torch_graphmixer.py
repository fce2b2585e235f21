"""The port's GraphMixer and its explainer against the JAX package on the
CPU.

Both packages hold the same flax weights (``utils/convert.py``) and see the
same supports (sampled by the JAX package, ``dense_ts=None``: its CSR
sampler). The batch has a row whose anchor has no history at all and a row
cut at time 0, so both meet rows with no valid neighbour. GraphMixer runs
in float32 in both packages. Tolerances:

* ``FeedForward`` and ``MixerBlock``, with and without explain weights:
  rtol 1e-5, atol 1e-6 (flax's LayerNorm takes the variance as
  E[x^2] - E[x]^2, torch in two passes: float32 round-off);
* logits (``contrast`` at 2 and 3 blocks, with and without explain
  weights; the eval step; the committed uslegis GraphMixer): rtol 2e-4,
  atol 1e-5, the TGAT tests' (``cos`` of large time arguments loses digits
  in both packages);
* the explain weights' gradient against ``jax.grad``: rtol 1e-4, atol
  1e-4 of its largest;
* the ratio sweep against JAX's ``ratio_contrast`` at rtol 2e-4, atol
  1e-5, and against the stacked masked contrast (JAX's
  ``mask_supports_for_ratios``, as ``tests/test_models.py`` holds them) at
  rtol 2e-4, atol 2e-5, with and without exact ties;
* the base train step at dropout 0 against ``make_base_train_step``: the
  loss rtol 1e-5; the gradients rtol 1e-4, atol 5e-4 of each tensor's
  largest (the backward runs through token LayerNorms over near-constant
  rows: padded slots all hold the projection's bias, and the frozen time
  encoding's low frequencies give every token the same value, so the
  normaliser 1 / sqrt(var + 1e-5) scales float32 round-off by up to 316;
  the error grows toward the input, 2.3e-4 of the largest at the
  projection, 1e-6 at the affinity head); the parameters after one Adam
  step rtol 1e-5, atol 1e-6 where
  the gradient is settled (above 1e-4 of its tensor's largest), within
  ``lr`` elsewhere (Adam turns round-off gradients into steps of up to
  ``lr``);
* the explainer on a frozen GraphMixer (hop 0 only): the train step at
  dropout 0 with JAX's own gamma draws, losses rtol 1e-5, the explanation
  rtol 1e-5, atol 1e-6, gradients rtol 1e-4, atol 1e-4 of each tensor's
  largest (``tests/test_torch_explainer.py``'s); the eval step's logits,
  fidelity and sweep (keep masks over the n hop-0 edges, ``use_hops=1``)
  rtol 2e-4, atol 1e-5.
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
from tests.test_torch_graph_sampler import jax_support_draws, one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import tempme as JE
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.models.graphmixer import GraphMixer as JaxGraphMixer
from tempme_tpu.ops import layers as JLay
from tempme_tpu.ops import sampler as JS
from tempme_tpu.train import loops as JL
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu.utils.checkpoint import load_meta, load_params
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.explain.tempme import TempME
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.graphmixer import GraphMixer
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.ops.layers import FeedForward, MixerBlock
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.utils.convert import (flax_to_state_dict,
                                            read_flax_msgpack)

B, N, DN, DE, HID = 4, 5, 12, 6, 16
RTOL, ATOL = 2e-4, 1e-5
CKPT = "params/tgnn/graphmixer_uslegis_sampled.msgpack"


class World:
    """A small stream, its graphs for both packages, the features and a
    batch: row 1's source has no events, row 3 is cut at time 0."""

    def __init__(self, node_dim=DN, edge_dim=DE, num_nodes=30, seed=3):
        self.ev = make_events(300, num_nodes, seed=seed)
        nn_ = num_nodes + 2
        g = jax_build_graph(self.ev, num_nodes=nn_)
        self.jg = dataclasses.replace(g, dense_ts=None, dense_node=None,
                                      dense_eid=None)
        self.tg = build_temporal_graph(to_torch_events(self.ev),
                                       num_nodes=nn_, device="cpu")
        r = np.random.RandomState(seed)
        node = r.randn(nn_, node_dim).astype(np.float32)
        edge = r.randn(self.jg.num_edges, edge_dim).astype(np.float32)
        node[0] = edge[0] = 0.0
        self.jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
        self.tfeats = Features(_t(node), _t(edge))
        self.src = r.randint(1, num_nodes, B).astype(np.int32)
        self.dst = r.randint(1, num_nodes, B).astype(np.int32)
        self.bgd = r.randint(1, num_nodes, B).astype(np.int32)
        self.src[1] = nn_ - 1
        self.ts = np.full(B, float(self.ev.ts.max()) + 1, np.float32)
        self.ts[0] = float(self.ev.ts[len(self.ev) // 2])
        self.ts[3] = 0.0
        self.dst_table = np.unique(self.ev.dst)

        @functools.partial(jax.jit, static_argnums=0)
        def sample(n, key, src, dst, bgd, ts):
            return tuple(JS.find_k_hop(self.jg, jax.random.fold_in(key, i),
                                       x, ts, 2, n)
                         for i, x in enumerate((src, dst, bgd)))
        self._sample = sample

    @functools.lru_cache
    def supports(self, n=N, seed=0):
        """One batch's 2-hop supports per side, for JAX and for the port
        (sampled once per ``n`` and ``seed``)."""
        jsubs = self._sample(n, jax.random.PRNGKey(seed), *self.args(False))
        return jsubs, _port_subs(jsubs)

    def args(self, port: bool):
        f = _t if port else jnp.asarray
        return tuple(f(x) for x in (self.src, self.dst, self.bgd, self.ts))

    def batch(self, start):
        s = slice(start, start + B)
        ev = self.ev
        return JL.Batch(jnp.asarray(ev.src[s]), jnp.asarray(ev.dst[s]),
                        jnp.asarray(ev.ts[s]), jnp.asarray(ev.e_idx[s]),
                        jnp.ones(B, bool))


def _port_subs(subs):
    return tuple(Subgraph(*(tuple(_t(x) for x in f) for f in s))
                 for s in subs)


@functools.lru_cache
def _init(w, blocks):
    """The JAX GraphMixer of ``blocks`` blocks over ``w``'s width and its
    weights, made once per world and depth."""
    jm = JaxGraphMixer(node_dim=w.jfeats.node.shape[1],
                       edge_dim=w.jfeats.edge.shape[1], num_tokens=N,
                       num_layers=blocks, dropout=0.0)
    jsubs = w.supports()[0]
    return jm, jax.jit(lambda k: jm.init(
        k, w.jfeats, *w.args(False), *jsubs, deterministic=True))(
            jax.random.PRNGKey(blocks))


def _models(w, blocks, params=None, n=N):
    if params is None:
        jm, params = _init(w, blocks)
    else:
        jm = JaxGraphMixer(node_dim=w.jfeats.node.shape[1],
                           edge_dim=w.jfeats.edge.shape[1], num_tokens=n,
                           num_layers=blocks, dropout=0.0)
    tm = GraphMixer(jm.node_dim, jm.edge_dim, n, num_layers=blocks,
                    dropout=0.0, device="cpu")
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))  # strict
    return jm, params, tm


def _explain_weights(jsubs, seed):
    r = np.random.RandomState(seed)
    per = [r.rand(*s.nodes[0].shape).astype(np.float32) for s in jsubs]
    return (tuple(jnp.asarray(x) for x in per), tuple(_t(x) for x in per))


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.mark.parametrize("explained", [False, True])
def test_feed_forward_and_mixer_block_match_jax(explained):
    r = np.random.RandomState(1)
    x = r.randn(B, N, DE).astype(np.float32)
    ew = r.rand(B, N).astype(np.float32) if explained else None
    jff = JLay.FeedForward(DE, 4.0)
    p_ff = jff.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ff = FeedForward(DE, 4.0)
    ff.load_state_dict(flax_to_state_dict(_np_tree(p_ff)))
    jmb = JLay.MixerBlock(num_tokens=N, num_channels=DE)
    jew = None if ew is None else jnp.asarray(ew)
    p_mb = jmb.init(jax.random.PRNGKey(1), jnp.asarray(x), jew)
    mb = MixerBlock(N, DE)
    mb.load_state_dict(flax_to_state_dict(_np_tree(p_mb)))
    assert ff.hidden == 24 and mb.token_ffn.hidden == 2   # int(0.5 * 5)
    with torch.no_grad():
        got_ff = ff(_t(x))
        got_mb = mb(_t(x), None if ew is None else _t(ew))
    np.testing.assert_allclose(got_ff.numpy(),
                               np.asarray(jff.apply(p_ff, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got_mb.numpy(), np.asarray(jmb.apply(p_mb, jnp.asarray(x), jew)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("explained", [False, True])
def test_contrast_matches_jax(world, blocks, explained):
    w = world
    jsubs, tsubs = w.supports()
    # rows 1 and 3 have no valid neighbour on the source side
    assert not jsubs[0].nodes[0][1].any() and not jsubs[0].nodes[0][3].any()
    jm, params, tm = _models(w, blocks)
    assert not any(n.startswith("time_encoder") for n in tm.state_dict())
    jew = tew = None
    if explained:
        jew, tew = _explain_weights(jsubs, seed=blocks)
    pos_r, neg_r = jax.jit(lambda p, ew: jm.apply(
        p, w.jfeats, *w.args(False), *jsubs, explain_weights=ew,
        deterministic=True, method=JaxGraphMixer.contrast))(params, jew)
    with torch.no_grad():
        pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs,
                               explain_weights=tew)
    assert pos.shape == (B, 1)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)
    assert pos.std() > 0


def test_explain_weights_gradient_matches_jax(world):
    w = world
    jsubs, tsubs = w.supports()
    jm, params, tm = _models(w, 2)
    jew, tew = _explain_weights(jsubs, seed=6)

    def f(ew):
        pos, neg = jm.apply(params, w.jfeats, *w.args(False), *jsubs,
                            explain_weights=ew, deterministic=True,
                            method=JaxGraphMixer.contrast)
        return pos.sum() - 2.0 * neg.sum()
    want = jax.jit(jax.grad(f))(jew)
    tew = tuple(x.clone().requires_grad_(True) for x in tew)
    pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs,
                           explain_weights=tew)
    (pos.sum() - 2.0 * neg.sum()).backward()
    for got, ref, sub in zip(tew, want, tsubs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
        assert np.abs(ref).max() > 0
        assert not got.grad[sub.nodes[0] == 0].any()   # zeroed at padding


@pytest.mark.parametrize("ties", [False, True])
def test_ratio_contrast_matches_jax_and_stacked(world, ties):
    w = world
    jsubs, tsubs = w.supports(seed=11)
    jm, params, tm = _models(w, 3)
    ratios = (0.01, 0.2, 0.4, 0.6, 0.9)
    r = len(ratios)
    imp0 = np.random.RandomState(7).rand(3 * B, N).astype(np.float32)
    if ties:
        imp0 = np.round(imp0 * 4) / 4
    explanation = [jnp.asarray(imp0)]
    jkeeps = JX.keep_masks_for_ratios(explanation, ratios, N, use_hops=1)

    def tile(x):
        return jnp.broadcast_to(x[None], (r,) + x.shape).reshape(
            (-1,) + x.shape[1:])

    @jax.jit
    def ref(p, expl):
        keeps = JX.keep_masks_for_ratios(expl, ratios, N, use_hops=1)
        swept = jm.apply(p, w.jfeats, *w.args(False), *jsubs,
                         *(k[0] for k in keeps),
                         method=JaxGraphMixer.ratio_contrast)
        masked = JX.mask_supports_for_ratios(expl, jsubs, ratios, N,
                                             "graphmixer")
        return swept + jm.apply(p, w.jfeats,
                                *(tile(x) for x in w.args(False)), *masked,
                                deterministic=True,
                                method=JaxGraphMixer.contrast)
    pos_j, neg_j, pos_s, neg_s = ref(params, explanation)
    tkeeps = X.keep_masks_for_ratios([_t(imp0)], ratios, N, use_hops=1)
    assert len(tkeeps[0]) == 1
    for tk, jk in zip(tkeeps, jkeeps):
        np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk[0]))
    with torch.no_grad():
        pos, neg = tm.ratio_contrast(w.tfeats, *w.args(True), *tsubs,
                                     *(k[0] for k in tkeeps))
    assert pos.shape == (r, B)
    for got, ref, stacked in ((pos, pos_j, pos_s), (neg, neg_j, neg_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(stacked).reshape(r, B),
                                   rtol=2e-4, atol=2e-5)


def test_base_train_step_matches_jax(world):
    """One Adam step at dropout 0 of a 3-block GraphMixer over 2-hop
    supports (hop 0 read), from the JAX step's own support draws."""
    w, lr = world, 1e-3
    jm, params, tm = _models(w, 3)
    dst = w.dst_table
    jopt = optax.adam(lr)
    jstep = JL.make_base_train_step(jm, w.jg, w.jfeats, jnp.asarray(dst), 2,
                                    N, jopt)
    state = JL.TrainState(params, jopt.init(params), jax.random.PRNGKey(9))
    jb = w.batch(150)
    _, k_samp, _ = jax.random.split(state.key, 3)
    state, jaux = jstep(state, jb)
    # after one step Adam's first moment is (1 - b1) * gradient
    jgrads = flax_to_state_dict(_np_tree(jax.tree_util.tree_map(
        lambda m: m / (1.0 - 0.9), state.opt_state[0].mu)))
    opt = torch.optim.Adam(tm.parameters(), lr=lr)
    step = L.make_base_train_step(tm, w.tg, w.tfeats, _t(dst), 2, N, opt)
    draws = L.StepDraws(jax_support_draws(k_samp, B, 2, N, len(dst)), None)
    aux = step(L.Batch(*(_t(x) for x in jb)), draws)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["pos"].numpy(), np.asarray(jaux["pos"]),
                               rtol=RTOL, atol=ATOL)
    want = flax_to_state_dict(_np_tree(state.params))
    assert want.keys() == dict(tm.named_parameters()).keys()
    for name, p in tm.named_parameters():
        g, gj = p.grad.numpy(), jgrads[name].numpy()
        np.testing.assert_allclose(g, gj, rtol=1e-4,
                                   atol=5e-4 * np.abs(gj).max(),
                                   err_msg=name)
        settled = np.abs(g) >= 1e-4 * np.abs(g).max()
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - ref).max() <= lr * 1.001, name
    assert np.abs(jgrads["mixers.2.token_ffn.fc1.weight"].numpy()).max() > 0


def test_train_step_draws_one_mixer_draws_per_block_and_side(world):
    w = world
    tm = GraphMixer(DN, DE, N, num_layers=3, dropout=0.1, device="cpu")
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    step = L.make_base_train_step(tm, w.tg, w.tfeats, _t(w.dst_table), 2, N,
                                  opt)
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = step.draw(gen, B)
    assert len(draws.dropout) == 3 and len(draws.dropout[0]) == 3
    assert [tuple(u.shape) for u in draws.dropout[0][0]] == [
        (B, DE, 2), (B, DE, N), (B, N, 4 * DE), (B, N, DE)]
    jsubs, tsubs = w.supports()
    with torch.no_grad():
        eval_pos, _ = tm.contrast(w.tfeats, *w.args(True), *tsubs)
        drop_pos, _ = tm.contrast(w.tfeats, *w.args(True), *tsubs,
                                  drop=draws.dropout)
    assert not torch.equal(eval_pos, drop_pos)
    assert all(not p.requires_grad for p in tm.time_encoder.buffers())


def test_base_eval_step_matches_jax(world):
    w = world
    jm, params, tm = _models(w, 2)
    dst = jnp.asarray(w.dst_table)
    jstep = JL.make_base_eval_step(jm, w.jg, w.jfeats, dst, 2, N)
    jb, key = w.batch(200), jax.random.PRNGKey(12)
    pos_r, neg_r = jstep(params, key, jb)
    step = L.make_base_eval_step(tm, w.tg, w.tfeats, _t(w.dst_table), 2, N)
    pos, neg = step(L.Batch(*(_t(x) for x in jb)),
                    jax_support_draws(key, B, 2, N, len(w.dst_table)))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)


def test_uslegis_checkpoint_contrast_at_full_width():
    """The committed uslegis GraphMixer holds 3 blocks (``mixer_2``) though
    its meta says ``n_layer`` 2 (the JAX driver writes the support depth
    there, and its loader then drops ``mixer_2``): it is built here with 3
    blocks from ``jax.eval_shape``, not through JAX's ``load_base``."""
    meta = load_meta(CKPT)
    assert (meta["n_layer"], meta["n_degree"], meta["node_dim"],
            meta["edge_dim"]) == (2, 30, 172, 1)
    n = meta["n_degree"]
    w = World(node_dim=172, edge_dim=1, num_nodes=40, seed=8)
    jsubs, tsubs = w.supports(n=n)
    jm = JaxGraphMixer(node_dim=172, edge_dim=1, num_tokens=n, num_layers=3,
                       dropout=0.0)
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), w.jfeats, *w.args(False), *jsubs,
        deterministic=True))
    params = load_params(CKPT, template)
    own = flax_to_state_dict(read_flax_msgpack(CKPT))
    ref = flax_to_state_dict(_np_tree(params))
    assert own.keys() == ref.keys() and "mixers.2.token_norm.weight" in own
    for name in ref:
        assert torch.equal(own[name], ref[name]), name
    _, _, tm = _models(w, 3, params=params, n=n)
    assert tm.mixers[0].token_ffn.hidden == 15
    assert tm.mixers[0].channel_ffn.hidden == 4
    with pytest.raises(RuntimeError, match="mixers.2"):
        GraphMixer(172, 1, n, num_layers=2, device="cpu").load_state_dict(own)
    pos_r, neg_r = jax.jit(lambda p: jm.apply(
        p, w.jfeats, *w.args(False), *jsubs, deterministic=True,
        method=JaxGraphMixer.contrast))(params)
    with torch.no_grad():
        pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)


# -- the explainer on a frozen GraphMixer ---------------------------------
def _port_draws(key, dst_len):
    """The port's draws for JAX's ``sample_explainer_inputs(key)`` (2-hop
    supports): the negatives' indices, per side the hops' uniforms and the
    walks'."""
    kn, k1, k2, k3, w1, w2, w3 = jax.random.split(key, 7)
    hops = []
    for k in (k1, k2, k3):
        side = []
        for layer in range(2):
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


@pytest.fixture(scope="module")
def explained(world):
    """A batch's supports and walks (JAX's sampler), the frozen 2-block
    GraphMixer in both packages and a JAX explainer's weights."""
    w = world
    jb, key = w.batch(170), jax.random.PRNGKey(21)
    dst = jnp.asarray(w.dst_table)
    bgd, subs, walks = jax.jit(lambda k, b: JX.sample_explainer_inputs(
        w.jg, k, b, dst, N))(key, jb)
    jm, bparams, tm = _models(w, 2)
    tm.requires_grad_(False)
    je = JE.TempME(node_dim=DN, edge_dim=DE, hid_dim=HID, dropout=0.0,
                   base_type="graphmixer")
    params = jax.jit(lambda k: je.init(
        {"params": k}, w.jfeats, walks[0], jb.ts, subs[0],
        method=JE.TempME.init_all))(jax.random.PRNGKey(7))
    null = np.random.RandomState(1).dirichlet(np.ones(12)).astype(np.float32)
    return dict(jb=jb, key=key, bgd=bgd, subs=subs, walks=walks, je=je,
                params=params, null=null, tm=tm,
                contrast=JX.make_base_contrast(JX.LoadedBase(
                    "graphmixer", jm, bparams, None, {}), w.jfeats),
                jm=jm, bparams=bparams)


def _port_explainer(e):
    te = TempME(DN, DE, hid_dim=HID, dropout=0.0, base_type="graphmixer",
                device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(e["params"])))
    return te


def test_explainer_train_step_matches_jax(world, explained):
    """The JAX driver's loss (``temp_exp_main.py:318-340``) and its
    gradient against one ``ExplainerTrainStep`` at dropout 0, the Beta
    sample's gamma draws JAX's own (recorded in the same pass; JAX samples
    hop 1 too and drops it, the port reads each side's first two)."""
    w, e = world, explained
    jb, bgd, subs, walks, je = (e[k] for k in ("jb", "bgd", "subs", "walks",
                                               "je"))
    gammas = []

    def loss_fn(ep):
        gammas.clear()
        pos_ori, neg_ori = e["contrast"](jb.src, jb.dst, bgd, jb.ts, jb.eidx,
                                         *subs, None)
        y_ori = (jnp.concatenate([pos_ori, neg_ori]) > 0.0).astype(
            jnp.float32)
        imps = [je.apply(ep, w.jfeats, walks[i], jb.ts, deterministic=True)
                for i in range(3)]
        expl = je.apply(ep, w.jfeats, subs[0], imps[0], walks[0], subs[1],
                        imps[1], walks[1], subs[2], imps[2], walks[2],
                        training=True, deterministic=True,
                        rngs={"sample": jax.random.PRNGKey(3)},
                        method=JE.TempME.retrieve_explanation)
        pos, neg = e["contrast"](jb.src, jb.dst, bgd, jb.ts, jb.eidx, *subs,
                                 expl)
        pred_loss = optax.sigmoid_binary_cross_entropy(
            jnp.concatenate([pos, neg]), y_ori).mean()
        kl = sum(JE.kl_sparsity_loss(imps[i], walks[i].cat,
                                     jnp.asarray(e["null"]), 0.3)
                 for i in range(3))
        return pred_loss + 0.5 * kl, (pred_loss, kl, expl, tuple(gammas))

    real_gamma = jax.random.gamma

    def recording_gamma(k, a, *args, **kw):
        g = real_gamma(k, a, *args, **kw)
        gammas.append(g)
        return g
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gamma", recording_gamma)
        (loss_r, (pred_loss_r, kl_r, expl_r, gam)), grads_r = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(e["params"])
    assert len(expl_r) == 1 and len(gam) == 12

    te = _port_explainer(e)
    opt = torch.optim.Adam(te.parameters(), lr=1e-3)
    step = X.ExplainerTrainStep(te, X.LoadedBase("graphmixer", e["tm"], None,
                                                 {}),
                                w.tg, w.tfeats, _t(w.dst_table), N,
                                _t(e["null"]), opt, 0.3, 0.5, True)
    support, wdraws = _port_draws(e["key"], len(w.dst_table))
    draws = X.ExplainerDraws(support, wdraws, None, None, tuple(
        tuple(_t(g) for g in gam[4 * i:4 * i + 4]) for i in range(3)))
    seen = {}
    real_forward = step._forward

    def keep(*a, **kw):                   # keep the step's explanation
        out = real_forward(*a, **kw)
        seen.update(out)
        return out
    step._forward = keep
    aux = step(L.Batch(*(_t(x) for x in jb)), draws)
    np.testing.assert_allclose(aux["loss"].item(), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(aux["pred_loss"].item(), float(pred_loss_r),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["kl"].item(), float(kl_r), rtol=1e-5,
                               atol=1e-6)
    assert len(seen["explanation"]) == 1                  # hop 0 only
    np.testing.assert_allclose(seen["explanation"][0].detach().numpy(),
                               np.asarray(expl_r[0]), rtol=1e-5, atol=1e-6)
    grads = flax_to_state_dict(_np_tree(grads_r))
    port = {n: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy() for n, p in te.named_parameters()}
    assert set(grads) == set(port)
    for name, g in grads.items():
        g = g.numpy()
        np.testing.assert_allclose(port[name], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
    assert all((np.abs(g).max() > 0) != n.startswith("aff_")
               for n, g in port.items())


def test_explainer_eval_step_matches_jax(world, explained):
    """The JAX driver's eval core for a GraphMixer (``temp_exp_main.py``:
    hop 0's keep masks, ``use_hops=1``, through ``ratio_contrast``) against
    ``ExplainerEvalStep`` from the same draws."""
    w, e = world, explained
    jb, bgd, subs, walks, je = (e[k] for k in ("jb", "bgd", "subs", "walks",
                                               "je"))
    ratios = (0.05, 0.2, 0.4, 0.6, 0.8, 1.0)

    @jax.jit
    def eval_core(ep):
        pos_ori, neg_ori = e["contrast"](jb.src, jb.dst, bgd, jb.ts, jb.eidx,
                                         *subs, None)
        imps = [je.apply(ep, w.jfeats, walks[i], jb.ts, deterministic=True)
                for i in range(3)]
        expl = je.apply(ep, w.jfeats, subs[0], imps[0], walks[0], subs[1],
                        imps[1], walks[1], subs[2], imps[2], walks[2],
                        training=False, deterministic=True,
                        method=JE.TempME.retrieve_explanation)
        pos, neg = e["contrast"](jb.src, jb.dst, bgd, jb.ts, jb.eidx, *subs,
                                 expl)
        keeps = JX.keep_masks_for_ratios(expl, ratios, N, use_hops=1)
        pos_r, neg_r = e["jm"].apply(
            e["bparams"], w.jfeats, jb.src, jb.dst, bgd, jb.ts, *subs,
            keeps[0][0], keeps[1][0], keeps[2][0],
            method=JaxGraphMixer.ratio_contrast)
        return pos_ori, neg_ori, pos, neg, pos_r, neg_r
    ref = dict(zip(("pos_ori", "neg_ori", "pos", "neg", "pos_r", "neg_r"),
                   eval_core(e["params"])))
    step = X.ExplainerEvalStep(_port_explainer(e),
                               X.LoadedBase("graphmixer", e["tm"], None, {}),
                               w.tg, w.tfeats, _t(w.dst_table), N,
                               _t(e["null"]), 0.3, ratios)
    support, wdraws = _port_draws(e["key"], len(w.dst_table))
    out = step(L.Batch(*(_t(x) for x in jb)),
               X.ExplainerDraws(support, wdraws))
    assert out["pos_r"].shape == (len(ratios), B)
    for name, want in ref.items():
        np.testing.assert_allclose(out[name].numpy(),
                                   np.asarray(want).reshape(out[name].shape),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # the last ratio keeps every hop-0 edge: the unexplained logits
    np.testing.assert_allclose(out["pos_r"][-1].numpy(),
                               out["pos_ori"].numpy(), rtol=1e-5, atol=1e-6)

    def fid(pos, neg, pos_ori, neg_ori):
        sig = (lambda x: 1 / (1 + np.exp(-np.asarray(x, np.float64))))
        return np.r_[sig(pos) - sig(pos_ori), sig(neg_ori) - sig(neg)].mean()
    np.testing.assert_allclose(
        fid(*(out[k].numpy() for k in ("pos", "neg", "pos_ori", "neg_ori"))),
        fid(*(np.asarray(ref[k]).ravel()
              for k in ("pos", "neg", "pos_ori", "neg_ori"))),
        rtol=RTOL, atol=ATOL)
