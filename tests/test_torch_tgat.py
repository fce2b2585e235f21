"""The port's TGAT against the JAX package on the CPU.

Both models hold the same flax weights (``utils/convert.py``) and see the
same supports (sampled by the JAX package, ``dense_ts=None``: its CSR
sampler); the JAX model runs with ``compute_dtype=float32`` and the port
with ``compute_dtype=torch.float32``. Tolerances:

* logits rtol 2e-4, atol 1e-5 (the serving tolerance of
  ``tests/test_torch_tgn.py``: float32 sums in another order, and ``cos``
  of large time arguments losing digits in both packages), at 1, 2 and 3
  layers, with and without explain weights;
* remat on against off in the port, with dropout draws: the same logits
  and gradients to rtol 1e-6, atol 1e-7 (the recompute replays the same
  operations on the same draws);
* the ratio sweep against JAX's ``ratio_contrast`` at rtol 2e-4, atol
  1e-5, and against the port's own stacked masked contrast at the JAX
  test's rtol 2e-4, atol 2e-5, at 2 and 3 layers, with exact ties;
* the base train step at dropout 0 against ``make_base_train_step``: the
  loss rtol 1e-5, the parameters after one Adam step rtol 1e-5 and atol
  1e-6 where the step's gradient is settled (above 1e-4 of its tensor's
  largest, as ``tests/test_torch_train.py`` holds the TGN step), within
  ``lr`` elsewhere;
* the committed ``params/tgnn/tgat_uslegis_sampled.msgpack`` (3 layers,
  node 172, edge 1: d_k 173, ``fc`` 346 -> 345) loaded into both packages
  (the port's own ``read_flax_msgpack`` gives flax's tensors exactly):
  ``contrast`` at n 3, rtol 2e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import jax_support_draws, one_torch_thread  # noqa: F401
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.models.tgat import TGAT as JaxTGAT
from tempme_tpu.ops import sampler as JS
from tempme_tpu.train import loops as JL
from tempme_tpu.train.temp_exp_main import keep_masks_for_ratios
from tempme_tpu.utils.checkpoint import load_meta, load_params
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgat import TGAT
from tempme_tpu_torch.ops.attention import AttnDraws
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.utils.convert import (flax_to_state_dict,
                                            read_flax_msgpack)

B, N, DN, DE = 4, 3, 12, 8
RTOL, ATOL = 2e-4, 1e-5
CKPT = "params/tgnn/tgat_uslegis_sampled.msgpack"


class World:
    """A small stream, its CSR graph for both packages, the features and
    one batch's supports of ``k`` hops per side."""

    def __init__(self, node_dim=DN, edge_dim=DE, num_nodes=30, seed=3,
                 num_model_nodes=None):
        self.ev = make_events(300, num_nodes, seed=seed)
        nn_ = num_model_nodes or self.ev.num_nodes
        g = jax_build_graph(self.ev, num_nodes=nn_)
        self.jg = dataclasses.replace(g, dense_ts=None, dense_node=None,
                                      dense_eid=None)
        r = np.random.RandomState(seed)
        node = r.randn(nn_, node_dim).astype(np.float32)
        edge = r.randn(self.jg.num_edges, edge_dim).astype(np.float32)
        node[0] = edge[0] = 0.0
        self.jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
        self.tfeats = Features(_t(node), _t(edge))
        self.src = r.randint(1, self.ev.num_nodes, B).astype(np.int32)
        self.dst = r.randint(1, self.ev.num_nodes, B).astype(np.int32)
        self.bgd = r.randint(1, self.ev.num_nodes, B).astype(np.int32)
        self.ts = np.full(B, float(self.ev.ts.max()) + 1, np.float32)
        self.ts[0] = float(self.ev.ts[len(self.ev) // 2])

    def supports(self, k, n=N, seed=0):
        key = jax.random.PRNGKey(seed)
        ts = jnp.asarray(self.ts)
        jsubs = tuple(JS.find_k_hop(self.jg, jax.random.fold_in(key, i),
                                    jnp.asarray(x), ts, k, n)
                      for i, x in enumerate((self.src, self.dst, self.bgd)))
        tsubs = tuple(Subgraph(*(tuple(_t(x) for x in f) for f in s))
                      for s in jsubs)
        return jsubs, tsubs

    def args(self, port: bool):
        f = _t if port else jnp.asarray
        return tuple(f(x) for x in (self.src, self.dst, self.bgd, self.ts))


def _models(w, layers, seed=0, params=None, jsubs=None):
    jm = JaxTGAT(node_dim=w.jfeats.node.shape[1],
                 edge_dim=w.jfeats.edge.shape[1], num_layers=layers,
                 n_head=2, dropout=0.0, compute_dtype=jnp.float32)
    if params is None:
        params = jm.init(jax.random.PRNGKey(seed), w.jfeats, *w.args(False),
                         *jsubs, deterministic=True)
    tm = TGAT(jm.node_dim, jm.edge_dim, num_layers=layers, dropout=0.0,
              device="cpu", compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return jm, params, tm


def _explain_weights(jsubs, seed):
    """Per side per hop weights in [0, 1], hops beyond the second left
    unweighted (the explainer covers 2), as the pair of pairs ``contrast``
    takes, for JAX and for the port."""
    r = np.random.RandomState(seed)
    per = [[r.rand(*h.shape).astype(np.float32) if i < 2 else None
            for i, h in enumerate(s.nodes)] for s in jsubs]

    def pair(cast):
        hops = [[None if h is None else cast(h) for h in side]
                for side in per]
        return (hops[0], hops[1]), (hops[0], hops[2])
    return pair(jnp.asarray), pair(_t)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("explained", [False, True])
def test_contrast_matches_jax(world, layers, explained):
    w = world
    jsubs, tsubs = w.supports(layers, seed=layers)
    jm, params, tm = _models(w, layers, seed=layers, jsubs=jsubs)
    jew = tew = None
    if explained:
        jew, tew = _explain_weights(jsubs, seed=layers)
    pos_r, neg_r = jm.apply(params, w.jfeats, *w.args(False), *jsubs,
                            explain_weights=jew, deterministic=True,
                            method=JaxTGAT.contrast)
    with torch.no_grad():
        pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs,
                               explain_weights=tew)
    assert pos.shape == (B, 1)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)
    assert pos.std() > 0


def _loss_and_grads(tm, w, tsubs, drop):
    tm.zero_grad(set_to_none=True)
    pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs, drop=drop)
    loss = torch.nn.functional.logsigmoid(pos).mean() - \
        torch.nn.functional.logsigmoid(-neg).mean()
    loss.backward()
    return pos.detach(), neg.detach(), {
        n: p.grad.clone() for n, p in tm.named_parameters()}


def test_remat_matches_no_remat(world):
    """Checkpointed blocks recompute their forward in the backward with the
    same dropout draws: logits and gradients equal those of the model that
    keeps its activations."""
    w = world
    _, tsubs = w.supports(3, seed=7)
    plain = TGAT(DN, DE, num_layers=3, dropout=0.1, device="cpu", seed=2,
                 compute_dtype=torch.float32)
    remat = TGAT(DN, DE, num_layers=3, dropout=0.1, remat=True,
                 device="cpu", seed=2, compute_dtype=torch.float32)
    remat.load_state_dict(plain.state_dict())
    gen = torch.Generator()
    gen.manual_seed(0)
    drop = tuple(L.draw_dropout(gen, plain.dropout_shapes(B, N), "cpu")
                 for _ in range(4))
    assert all(isinstance(d, AttnDraws) for d in drop[0])
    assert len(drop[0]) == 6                      # 3 + 2 + 1 blocks
    a = _loss_and_grads(plain, w, tsubs, drop)
    b = _loss_and_grads(remat, w, tsubs, drop)
    for x, y in zip(a[:2], b[:2]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    assert a[2].keys() == b[2].keys()
    for name in a[2]:
        torch.testing.assert_close(a[2][name], b[2][name], rtol=1e-6,
                                   atol=1e-7, msg=name)
    assert a[2]["attn_layers.0.attn.wk_time.weight"].abs().max() > 0


def _stacked_keep(subs, keeps, r):
    """The port's own stacked threshold test: per ratio the support with
    the dropped hop-0/1 edges' node ids set to 0, R copies batched."""
    out = []
    for sub, keep in zip(subs, keeps):
        nodes = []
        for h, nd in enumerate(sub.nodes):
            if h < len(keep):
                nd = torch.where(keep[h], nd[None], 0)
            else:
                nd = nd[None].expand((r,) + nd.shape)
            nodes.append(nd.reshape((-1,) + nd.shape[2:]))
        tile = (lambda x: x[None].expand((r,) + x.shape).reshape(
            (-1,) + x.shape[1:]))
        out.append(Subgraph(tuple(nodes), tuple(tile(e) for e in sub.eids),
                            tuple(tile(t) for t in sub.ts)))
    return out


@pytest.mark.parametrize("layers,ties", [(2, False), (3, False), (3, True)])
def test_ratio_contrast_matches_jax_and_stacked(world, layers, ties):
    w = world
    jsubs, tsubs = w.supports(layers, seed=10 + layers)
    jm, params, tm = _models(w, layers, seed=4, jsubs=jsubs)
    ratios = (0.01, 0.05, 0.1, 0.2, 0.3)
    r = len(ratios)
    rng = np.random.RandomState(7)
    imp0 = rng.rand(3 * B, N).astype(np.float32)
    imp1 = rng.rand(3 * B, N * N).astype(np.float32)
    if ties:
        imp0, imp1 = np.round(imp0 * 4) / 4, np.round(imp1 * 4) / 4
    jkeeps = keep_masks_for_ratios([jnp.asarray(imp0), jnp.asarray(imp1)],
                                   ratios, N)
    pos_j, neg_j = jm.apply(params, w.jfeats, *w.args(False), *jsubs,
                            *jkeeps, method=JaxTGAT.ratio_contrast)
    tkeeps = [[_t(k) for k in side] for side in jkeeps]
    with torch.no_grad():
        pos, neg = tm.ratio_contrast(w.tfeats, *w.args(True), *tsubs,
                                     *tkeeps)
        pos_s, neg_s = tm.contrast(
            w.tfeats, *(x[None].expand((r,) + x.shape).reshape(-1)
                        for x in w.args(True)),
            *_stacked_keep(tsubs, tkeeps, r))
    assert pos.shape == (r, B)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pos.numpy(), pos_s.reshape(r, B).numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(neg.numpy(), neg_s.reshape(r, B).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_base_train_step_matches_jax(world):
    """One Adam step at dropout 0 of a 3-layer TGAT (remat on, as the
    drivers build it), from the JAX step's own support draws."""
    w = world
    lr = 1e-3
    jsubs, _ = w.supports(3)
    jm, params, tm = _models(w, 3, seed=5, jsubs=jsubs)
    tm.remat = True
    jg, ev = w.jg, w.ev
    dst = np.unique(ev.dst)
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tests.test_torch_graph_sampler import to_torch_events
    tg = build_temporal_graph(to_torch_events(ev), num_nodes=jg.num_nodes,
                              device="cpu")
    jopt = optax.adam(lr)
    jstep = JL.make_base_train_step(jm, jg, w.jfeats, jnp.asarray(dst), 3, N,
                                    jopt)
    state = JL.TrainState(params, jopt.init(params), jax.random.PRNGKey(9))
    s = slice(150, 150 + B)
    jb = JL.Batch(jnp.asarray(ev.src[s]), jnp.asarray(ev.dst[s]),
                  jnp.asarray(ev.ts[s]), jnp.asarray(ev.e_idx[s]),
                  jnp.ones(B, bool))
    _, k_samp, _ = jax.random.split(state.key, 3)
    state, jaux = jstep(state, jb)
    opt = torch.optim.Adam(tm.parameters(), lr=lr)
    step = L.make_base_train_step(tm, tg, w.tfeats, _t(dst), 3, N, opt)
    draws = L.StepDraws(jax_support_draws(k_samp, B, 3, N, len(dst)), None)
    aux = step(L.Batch(*(_t(x) for x in jb)), draws)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["pos"].numpy(), np.asarray(jaux["pos"]),
                               rtol=RTOL, atol=ATOL)
    want = flax_to_state_dict(_np_tree(state.params))
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        settled = np.abs(g) >= 1e-4 * np.abs(g).max()
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - ref).max() <= lr * 1.001, name


def test_uslegis_checkpoint_contrast_at_full_width():
    meta = load_meta(CKPT)
    assert (meta["n_layer"], meta["node_dim"], meta["edge_dim"],
            meta["n_head"]) == (3, 172, 1, 2)
    w = World(node_dim=172, edge_dim=1, num_nodes=40, seed=8)
    jsubs, tsubs = w.supports(3)
    jm = JaxTGAT(node_dim=172, edge_dim=1, num_layers=3, n_head=2,
                 dropout=0.0, compute_dtype=jnp.float32)
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), w.jfeats, *w.args(False), *jsubs,
        deterministic=True))
    params = load_params(CKPT, template)
    _, _, tm = _models(w, 3, params=params)
    # the port reads the checkpoint itself, without flax: the same tensors
    own = flax_to_state_dict(read_flax_msgpack(CKPT))
    ref = flax_to_state_dict(_np_tree(params))
    assert own.keys() == ref.keys()
    for name in ref:
        assert torch.equal(own[name], ref[name]), name
    assert tm.attn_layers[0].attn.d_k == 173
    assert tm.attn_layers[0].attn.fc.weight.shape == (345, 346)
    pos_r, neg_r = jm.apply(params, w.jfeats, *w.args(False), *jsubs,
                            deterministic=True, method=JaxTGAT.contrast)
    with torch.no_grad():
        pos, neg = tm.contrast(w.tfeats, *w.args(True), *tsubs)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)


def test_unported_variants_name_roadmap_item():
    """The variants (item A10) are ported (``tests/test_torch_tgat_variants
    .py`` holds them against JAX); unknown values raise, as in JAX."""
    for kw in (dict(agg_method="lstm"), dict(attn_mode="map"),
               dict(use_time="pos")):
        TGAT(8, 4, device="cpu", **kw)
    for kw, match in ((dict(agg_method="max"), "agg_method"),
                      (dict(attn_mode="dot"), "agg_method/attn_mode"),
                      (dict(use_time="clock"), "time encoding")):
        with pytest.raises(ValueError, match=match):
            TGAT(8, 4, device="cpu", **kw)
