"""The port's TGAT variants against the JAX package on the CPU.

The variants are the values of the drivers' flags other than the default
attn/prod/time: ``--attn_mode map``, ``--agg_method lstm`` and ``mean``
(``ops/aggregators.py``), ``--use_time pos`` and ``empty``
(``ops/encodings.py``; these two on the attn/prod blocks). Both packages
hold the same flax weights (``utils/convert.py``) and read the same
supports (the JAX package's CSR sampler); the JAX model runs at float32
(the variant blocks have no other type), the port's projections with
``compute_dtype=torch.float32``. Tolerances, those of
``tests/test_torch_tgat.py``:

* ``contrast`` logits rtol 2e-4, atol 1e-5, n 3, each variant at one of
  1, 2 and 3 layers (the attn/prod blocks of "pos" and "empty" are
  ``tests/test_torch_tgat.py``'s at every depth);
* one base train step at dropout 0 against ``make_base_train_step``: the
  loss rtol 1e-5, the logits rtol 2e-4, atol 1e-5, the parameters after
  Adam rtol 1e-5, atol 1e-6 where the gradient is settled (above 1e-4 of
  its tensor's largest), within ``lr`` elsewhere (within 2 ``lr`` for map
  attention's ``wq`` and ``weight_map_q``, whose gradients are zero in
  exact arithmetic);
* a checkpoint the JAX package writes for a variant loads strictly through
  ``load_base`` and scores the same logits (rtol 2e-4, atol 1e-5);
* the port's fresh ``state_dict`` holds the entries of the
  ``jax.eval_shape`` tree of each variant, shape for shape.

The explainer refuses a TGAT that is not attn/prod, naming the reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_graph_sampler import jax_support_draws, one_torch_thread  # noqa: F401
from tests.test_torch_tgat import ATOL, B, N, RTOL, World
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.models.tgat import TGAT as JaxTGAT
from tempme_tpu.train import loops as JL
from tempme_tpu.utils.checkpoint import save_params
from tempme_tpu_torch.models.tgat import TGAT
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train.base_loader import LoadedBase, load_base
from tempme_tpu_torch.train.temp_exp_main import explainable
from tempme_tpu_torch.utils.convert import flax_to_state_dict

VARIANTS = {"map": dict(attn_mode="map"), "lstm": dict(agg_method="lstm"),
            "mean": dict(agg_method="mean"), "pos": dict(use_time="pos"),
            "empty": dict(use_time="empty")}
POS_LEN = 64
# map attention's query-side score q . w_q is the same for every key of a
# query, so the softmax removes it: these parameters' gradients are zero in
# exact arithmetic
QUERY_SCORE = ("weight_map_q", "wq_node_transform.weight")


def _jax_model(w, layers, kw):
    return JaxTGAT(node_dim=w.jfeats.node.shape[1],
                   edge_dim=w.jfeats.edge.shape[1], num_layers=layers,
                   n_head=2, dropout=0.0, pos_seq_len=POS_LEN,
                   compute_dtype=jnp.float32, **kw)


def _port_model(w, layers, kw, **extra):
    return TGAT(w.tfeats.node.shape[1], w.tfeats.edge.shape[1],
                num_layers=layers, dropout=0.0, pos_seq_len=POS_LEN,
                device="cpu", compute_dtype=torch.float32, **kw, **extra)


def _jax_params(jm, w, jsubs, seed):
    """Weights for ``jm`` drawn from ``seed`` with numpy, normal(0.3), in
    the structure of its ``jax.eval_shape`` tree (no init is compiled);
    returned with that tree."""
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), w.jfeats, *w.args(False), *jsubs,
        deterministic=True))
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.3 * r.randn(*s.shape), s.dtype), tree)
    return params, tree


def _models(w, layers, kw, jsubs, seed=0):
    jm = _jax_model(w, layers, kw)
    params, tree = _jax_params(jm, w, jsubs, seed)
    tm = _port_model(w, layers, kw)
    sd = flax_to_state_dict(_np_tree(params))
    # the port's fresh module holds the eval_shape tree's entries exactly
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm


def _contrast(jm, params, *args):
    """The JAX logits: jitted for the LSTM (its scans compile once), op by
    op otherwise (the ops' compiles are shared across the cases)."""
    f = lambda p, *a: jm.apply(p, *a, deterministic=True,  # noqa: E731
                               method=JaxTGAT.contrast)
    return (jax.jit(f) if jm.agg_method == "lstm" else f)(params, *args)


def _assert_logits(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.mark.parametrize("variant, layers", [("map", 2), ("lstm", 2),
                                             ("mean", 3), ("pos", 2),
                                             ("empty", 1)])
def test_variant_contrast_matches_jax(world, variant, layers):
    w = world
    kw = VARIANTS[variant]
    jsubs, tsubs = w.supports(layers, seed=layers)
    jm, params, tm = _models(w, layers, kw, jsubs, seed=layers)
    if variant == "pos":
        assert tm.time_encoder.pos_table.shape == (POS_LEN, w.tfeats.node
                                                   .shape[1])
    ref = _contrast(jm, params, w.jfeats, *w.args(False), *jsubs)
    with torch.no_grad():
        _assert_logits(tm.contrast(w.tfeats, *w.args(True), *tsubs), ref)


@pytest.mark.parametrize("variant", ["map", "lstm"])
def test_variant_train_step_matches_jax(world, variant):
    """One Adam step at dropout 0 of a 1-layer variant TGAT from the JAX
    step's own support draws. Map attention's query-side score (``wq`` and
    ``weight_map_q``) is the same for every key of a query, so the softmax
    removes it: those gradients are zero in exact arithmetic and round-off
    in both packages, held within 1e-5 of the model's largest gradient;
    Adam's first step moves each side's entries by up to ``lr`` either
    way, so they agree within 2 ``lr``."""
    w = world
    lr, kw, k = 1e-3, VARIANTS[variant], 1
    jsubs, _ = w.supports(k)
    jm, params, tm = _models(w, k, kw, jsubs, seed=5)
    jg, ev = w.jg, w.ev
    dst = np.unique(ev.dst)
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tests.test_torch_graph_sampler import to_torch_events
    tg = build_temporal_graph(to_torch_events(ev), num_nodes=jg.num_nodes,
                              device="cpu")
    jopt = optax.adam(lr)
    jstep = JL.make_base_train_step(jm, jg, w.jfeats, jnp.asarray(dst), k, N,
                                    jopt)
    state = JL.TrainState(params, jopt.init(params), jax.random.PRNGKey(9))
    s = slice(150, 150 + B)
    jb = JL.Batch(jnp.asarray(ev.src[s]), jnp.asarray(ev.dst[s]),
                  jnp.asarray(ev.ts[s]), jnp.asarray(ev.e_idx[s]),
                  jnp.ones(B, bool))
    _, k_samp, _ = jax.random.split(state.key, 3)
    state, jaux = jstep(state, jb)
    opt = torch.optim.Adam(tm.parameters(), lr=lr)
    step = L.make_base_train_step(tm, tg, w.tfeats, _t(dst), k, N, opt)
    draws = L.StepDraws(jax_support_draws(k_samp, B, k, N, len(dst)), None)
    aux = step(L.Batch(*(_t(x) for x in jb)), draws)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    _assert_logits((aux["pos"], aux["neg"]), (jaux["pos"], jaux["neg"]))
    want = flax_to_state_dict(_np_tree(state.params))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    top = max(p.grad.abs().max().item() for p in tm.parameters())
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith(QUERY_SCORE):
            assert np.abs(g).max() <= 1e-5 * top, name
            assert np.abs(got - ref).max() <= 2 * lr * 1.001, name
            continue
        assert np.abs(got - ref).max() <= lr * 1.001, name
        settled = np.abs(g) >= 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(got[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_jax_checkpoint_loads_through_load_base(world, tmp_path):
    """A JAX checkpoint of an LSTM/pos TGAT (flax msgpack and its meta, as
    the JAX ``learn_base`` writes them) loads strictly into the port."""
    w = world
    kw = dict(agg_method="lstm", use_time="pos")
    jsubs, tsubs = w.supports(2)
    jm = _jax_model(w, 2, kw)
    params, _ = _jax_params(jm, w, jsubs, 4)
    path = str(tmp_path / "tgat_synth.msgpack")
    save_params(path, params, meta=dict(
        base_type="tgat", data="synth", n_degree=N, n_layer=2, n_head=2,
        drop_out=0.1, node_dim=int(jm.node_dim), edge_dim=int(jm.edge_dim),
        agg_method="lstm", attn_mode="prod", use_time="pos",
        pos_seq_len=POS_LEN))
    base = load_base(path, device="cpu", compute_dtype=torch.float32)
    assert (base.model.agg_method, base.model.use_time) == ("lstm", "pos")
    ref = _contrast(jm, params, w.jfeats, *w.args(False), *jsubs)
    with torch.no_grad():
        _assert_logits(base.model.contrast(w.tfeats, *w.args(True), *tsubs),
                       ref)


REFUSAL = {"map": "the explainer's ratio sweep has no map form",
           "lstm": "the lstm pool takes no explain weights",
           "mean": "the mean pool takes no explain weights"}


@pytest.mark.parametrize("variant", ["map", "lstm", "mean"])
def test_explainer_refuses_a_tgat_without_split_attention(world, variant):
    w = world
    base = LoadedBase("tgat", _port_model(w, 2, VARIANTS[variant]), None, {})
    with pytest.raises(ValueError, match="--agg_method attn and "
                                         "--attn_mode prod"):
        explainable(base)
    with pytest.raises(ValueError, match=REFUSAL[variant]):
        explainable(base)
    for kw in (VARIANTS["pos"], VARIANTS["empty"]):
        explainable(LoadedBase("tgat", _port_model(w, 2, kw), None, {}))
