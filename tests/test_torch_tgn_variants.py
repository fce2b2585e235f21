"""The port's TGN variants, and ``edge_attr`` of the TGN and GraphMixer,
against the JAX package on the CPU.

The variants are the values of the drivers' TGN flags other than the
default gru/last/mlp/graph_attention: (a) ``--memory_updater rnn
--aggregator mean --message_function identity`` together, and each alone,
and (b) ``--embedding_module identity`` and (c) ``time`` (Jodie, with the
train split's time statistics). Both packages hold the same weights
(drawn with numpy in the structure of the JAX model's ``jax.eval_shape``
tree, whose entries the port's fresh ``state_dict`` must match shape for
shape), the same memory and the same supports (the JAX package's). The
tolerances are ``tests/test_torch_tgn.py``'s: logits and every float field
of the memory rtol 2e-4, atol 1e-5 (float32 sums in another order), the
flags exactly. The train step is held as ``tests/test_torch_tgat.py``
holds TGAT's: the loss rtol 1e-5, logits rtol 2e-4, atol 1e-5, the
parameters after Adam rtol 1e-5, atol 1e-6 where the gradient is settled
(above 1e-4 of its tensor's largest), within ``lr`` elsewhere. The time
statistics agree to rtol 1e-12 (float64 both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_graph_sampler import jax_support_draws, one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tests.test_torch_tgn import (ATOL, RTOL, Setup, _assert_memory_close,
                                  _np_tree, _port_memory, _t)
from tempme_tpu.data.events import compute_time_statistics as jax_stats
from tempme_tpu.models.graphmixer import GraphMixer as JaxGraphMixer
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.models.tgn import init_memory_state as jax_init_memory
from tempme_tpu.train import learn_tgn as JT
from tempme_tpu.train import loops as JL
from tempme_tpu.utils.checkpoint import save_params
from tempme_tpu_torch.data.events import compute_time_statistics
from tempme_tpu_torch.models.graphmixer import GraphMixer
from tempme_tpu_torch.models.tgn import TGN
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train.base_loader import LoadedBase, load_base
from tempme_tpu_torch.train.temp_exp_main import explainable
from tempme_tpu_torch.utils.convert import flax_to_state_dict

DN, DE, N = 12, 6, 3
A = dict(memory_updater="rnn", aggregator="mean", message_function="identity")
VARIANTS = {"a": A, "rnn": dict(memory_updater="rnn"),
            "mean": dict(aggregator="mean"),
            "identity_message": dict(message_function="identity"),
            "identity_embedding": dict(embedding_type="identity"),
            "time_embedding": dict(embedding_type="time")}


@pytest.fixture(scope="module")
def setup():
    return Setup(node_dim=DN, edge_dim=DE, seed=6)


def _shifts(s, kw):
    if kw.get("embedding_type") != "time":
        return {}
    mean, std = compute_time_statistics(to_torch_events(s.ev))
    return dict(mean_time_shift=mean, std_time_shift=std)


def _models(s, kw, seed=0):
    """(JAX TGN, its weights, the port's TGN holding them) of variant
    ``kw``; the weights are normal(0.3) draws in the structure of the JAX
    model's ``eval_shape`` tree."""
    extra = _shifts(s, kw)
    jm = JaxTGN(node_dim=DN, edge_dim=DE, num_nodes=s.tm.num_nodes,
                n_layers=2, n_head=2, dropout=0.0, compute_dtype=jnp.float32,
                **kw, **extra)
    jmem = jax_init_memory(s.tm.num_nodes, jm.memory_dim,
                           jm.raw_message_dim)
    b = s.batch(0, 8)
    _, s0, s1, s2 = s._jax_support(s.jg, jax.random.PRNGKey(0), b,
                                   jnp.arange(1, 5), 2, N, True)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), s.jfeats, jmem, b.src, b.dst, b.dst, b.ts,
        b.eidx, s0, s1, s2))
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.3 * r.randn(*x.shape), x.dtype), tree)
    tm = TGN(DN, DE, s.tm.num_nodes, dropout=0.0, device="cpu",
             compute_dtype=torch.float32, **kw, **extra)
    sd = flax_to_state_dict(_np_tree(params))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, jmem


def _contrast(jm):
    return jax.jit(lambda p, *a, **k: jm.apply(p, *a, method=JaxTGN.contrast,
                                               **k))


def _port_subs(subs):
    return [Subgraph(*(tuple(_t(x) for x in f) for f in sub))
            for sub in subs]


def _assert_logits(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_contrast_and_memory_match_jax(setup, variant):
    """Two batches, the memory carried from the first to the second (the
    messages the first stores are what the second's updater reads)."""
    s = setup
    kw = VARIANTS[variant]
    jm, params, tm, jmem = _models(s, kw)
    tmem = _port_memory(jmem)
    if kw.get("embedding_type") == "time":
        assert tm.mean_time_shift == jm.mean_time_shift
    jax_contrast = _contrast(jm)
    dst_table = jnp.asarray(np.unique(s.ev.dst))
    for i in range(2):
        jb = s.batch(60 + 12 * i, 12)
        bgd, ss, st, sb = s._jax_support(s.jg, jax.random.PRNGKey(i), jb,
                                         dst_table, 2, N, False)
        ref, jmem = jax_contrast(params, s.jfeats, jmem, jb.src, jb.dst,
                                 bgd, jb.ts, jb.eidx, ss, st, sb)
        with torch.no_grad():
            out, tmem = tm.contrast(s.tfeats, tmem, _t(jb.src), _t(jb.dst),
                                    _t(bgd), _t(jb.ts), _t(jb.eidx),
                                    *_port_subs((ss, st, sb)))
        _assert_logits(out, ref)
        _assert_memory_close(tmem, jmem)
    assert tmem.msg_valid.any() and (tmem.memory != 0).any()


def test_time_statistics_match_jax(setup):
    ev = setup.ev
    got = compute_time_statistics(to_torch_events(ev))
    want = jax_stats(ev)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-12)
    assert got[1][0] > 0 and got[1][1] > 0


@pytest.mark.parametrize("variant", ["a", "time_embedding"])
def test_variant_train_step_matches_jax(setup, variant):
    """One Adam step at dropout 0 from the same memory (two batches of
    messages stored first), the JAX step's own support draws replayed.
    A time-embedding TGN samples no support (``reads_support``)."""
    s = setup
    lr, kw = 1e-3, VARIANTS[variant]
    jm, params, tm, jmem = _models(s, kw, seed=3)
    dst = np.unique(s.ev.dst)
    jax_contrast = _contrast(jm)
    for i in range(2):                         # memory with messages
        jb = s.batch(40 + 10 * i, 10)
        bgd, ss, st, sb = s._jax_support(
            s.jg, jax.random.PRNGKey(i), jb, jnp.asarray(dst), 2, N, False)
        _, jmem = jax_contrast(params, s.jfeats, jmem, jb.src, jb.dst, bgd,
                               jb.ts, jb.eidx, ss, st, sb)
    tmem = _port_memory(jmem)
    jopt = optax.adam(lr)
    jstep = JT.make_tgn_train_step(jm, s.jg, s.jfeats, jnp.asarray(dst), N,
                                   jopt)
    state = JL.TrainState(params, jopt.init(params), jax.random.PRNGKey(7))
    _, k_samp, _ = jax.random.split(state.key, 3)
    jb = s.batch(100, 16)
    state, jmem, jaux = jstep(state, jmem, jb)
    opt = torch.optim.Adam(tm.parameters(), lr=lr)
    step = T.make_tgn_train_step(tm, s.tg, s.tfeats, _t(dst), N, opt)
    draws = T.StepDraws(jax_support_draws(k_samp, 16, 2, N, len(dst)), None)
    tmem, aux = step(tmem, L.Batch(*(_t(x) for x in jb)), draws)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    _assert_logits((aux["pos"], aux["neg"]), (jaux["pos"], jaux["neg"]))
    want = flax_to_state_dict(_np_tree(state.params))
    for name, p in tm.named_parameters():
        # no gradient reaches the time encoder of an embedding that reads
        # no support (its messages are stored detached): JAX's is zeros
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        settled = np.abs(g) >= 1e-4 * np.abs(g).max()
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - ref).max() <= lr * 1.001, name
    _assert_memory_close(tmem, jmem)


def test_tgn_edge_attr_matches_jax(setup):
    """Edge features given from outside per hop replace the support's in
    the attention's keys and values."""
    s = setup
    jm, params, tm, jmem = _models(s, {}, seed=4)
    jb = s.batch(120, 8)
    bgd, ss, st, sb = s._jax_support(s.jg, jax.random.PRNGKey(3), jb,
                                     jnp.asarray(np.unique(s.ev.dst)), 2, N,
                                     False)
    r = np.random.RandomState(5)
    attr = [[r.randn(*h.shape, DE).astype(np.float32) for h in sub.nodes]
            for sub in (ss, st, sb)]
    ref, jmem = _contrast(jm)(params, s.jfeats, jmem, jb.src, jb.dst, bgd,
                              jb.ts, jb.eidx, ss, st, sb,
                              edge_attr=tuple([jnp.asarray(h) for h in a]
                                              for a in attr))
    with torch.no_grad():
        out, tmem = tm.contrast(
            s.tfeats, _port_memory(s.jmem), _t(jb.src), _t(jb.dst), _t(bgd),
            _t(jb.ts), _t(jb.eidx), *_port_subs((ss, st, sb)),
            edge_attr=tuple([_t(h) for h in a] for a in attr))
    _assert_logits(out, ref)
    _assert_memory_close(tmem, jmem)


def test_graphmixer_edge_attr_matches_jax(setup):
    """Hop-0 edge features from outside; their padded slots stay as given,
    the time part is zeroed there."""
    s = setup
    jm = JaxGraphMixer(node_dim=DN, edge_dim=DE, num_tokens=N, num_layers=2,
                       dropout=0.0)
    jb = s.batch(4, 8)                  # early events: short histories
    subs = s._jax_support(s.jg, jax.random.PRNGKey(3), jb,
                          jnp.asarray(np.unique(s.ev.dst)), 2, N, False)
    args = (jb.src, jb.dst, subs[0], jb.ts) + tuple(subs[1:])
    params = jax.jit(lambda k: jm.init(k, s.jfeats, *args,
                                       deterministic=True))(
        jax.random.PRNGKey(2))
    tm = GraphMixer(DN, DE, N, num_layers=2, dropout=0.0, device="cpu")
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    r = np.random.RandomState(6)
    attr = [r.randn(8, N, DE).astype(np.float32) for _ in range(3)]
    assert (np.asarray(subs[1].nodes[0]) == 0).any()   # padded slots
    ref = jm.apply(params, s.jfeats, *args, deterministic=True,
                   edge_attr=tuple(jnp.asarray(a) for a in attr),
                   method=JaxGraphMixer.contrast)
    with torch.no_grad():
        out = tm.contrast(s.tfeats, *(_t(x) for x in args[:4]),
                          *_port_subs(subs[1:]),
                          edge_attr=tuple(_t(a) for a in attr))
    _assert_logits(out, ref)


def test_jax_checkpoint_loads_through_load_base(setup, tmp_path):
    """A JAX checkpoint of TGN (a), its memory included (flax msgpack and
    meta, as the JAX ``learn_tgn`` writes them), loads strictly into the
    port and scores the same logits from the same memory."""
    s = setup
    jm, params, _, jmem = _models(s, A, seed=8)
    jb = s.batch(60, 12)
    dst_table = jnp.asarray(np.unique(s.ev.dst))
    bgd, ss, st, sb = s._jax_support(s.jg, jax.random.PRNGKey(0), jb,
                                     dst_table, 2, N, False)
    _, jmem = _contrast(jm)(params, s.jfeats, jmem, jb.src, jb.dst, bgd,
                            jb.ts, jb.eidx, ss, st, sb)
    path = str(tmp_path / "tgn_synth.msgpack")
    save_params(path, {"params": params, "memory": jmem}, meta=dict(
        base_type="tgn", data="synth", n_degree=N, n_layer=2, n_head=2,
        drop_out=0.1, node_dim=DN, edge_dim=DE, num_nodes=s.tm.num_nodes,
        memory_updater="rnn", aggregator="mean",
        message_function="identity", embedding_module="graph_attention",
        mean_time_shift=[0.0, 0.0], std_time_shift=[1.0, 1.0]))
    base = load_base(path, device="cpu", compute_dtype=torch.float32)
    _assert_memory_close(base.memory, jmem)
    jb = s.batch(90, 12)
    bgd, ss, st, sb = s._jax_support(s.jg, jax.random.PRNGKey(1), jb,
                                     dst_table, 2, N, False)
    ref, _ = _contrast(jm)(params, s.jfeats, jmem, jb.src, jb.dst, bgd,
                           jb.ts, jb.eidx, ss, st, sb)
    with torch.no_grad():
        out, _ = base.model.contrast(
            s.tfeats, base.memory, _t(jb.src), _t(jb.dst), _t(bgd),
            _t(jb.ts), _t(jb.eidx), *_port_subs((ss, st, sb)))
    _assert_logits(out, ref)


def test_explainer_refuses_a_tgn_without_attention():
    for emb in ("identity", "time"):
        base = LoadedBase("tgn", TGN(8, 4, 10, embedding_type=emb,
                                     device="cpu"), None, {})
        with pytest.raises(ValueError, match="graph_attention"):
            explainable(base)
    explainable(LoadedBase("tgn", TGN(8, 4, 10, device="cpu", **A), None,
                           {}))
