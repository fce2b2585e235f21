"""The port's offline walk cache against the JAX package on the CPU.

* ``build_walk_cache`` on ``make_events(120, 20, seed=5)`` at n_degree 4
  and batch 64 (two batches, the second padded), with the JAX
  ``build_walk_cache``'s ``jax.random`` chain replayed as the port's
  draws: every id array, the motif classes, the co-occurrence counts and
  the negatives equal bit for bit; the timestamps, the class distribution and the marginals equal.
* Each package's ``cache_to_inputs`` on the other's ``.npz`` at a
  shuffled, padded index gives the same arrays.
* The explainer's train step (toy TGN, dropout 0) fed from the cache
  equals the port's online step on the same draws exactly, and its loss
  and gradients equal the JAX driver's loss (``temp_exp_main.py:318-340``,
  ``train_core``) on the same cached inputs within the explainer tests'
  float32 tolerances (loss rtol 1e-5, gradients rtol 1e-4 and atol 1e-4
  of each tensor's largest).
* The guards: ids at 2**24, cache widths other than ``n_degree``, and a
  3-layer TGAT with ``--use_cache``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_explainer import (B, HID, N, _explainers,  # noqa: F401
                                        world)
from tests.test_torch_graph_sampler import (jax_hop_draws,  # noqa: F401
                                            one_torch_thread,
                                            to_torch_events)
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.data import cache as JC
from tempme_tpu.data.events import RandEdgeSampler as JaxSampler
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import tempme as JE
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu_torch.data import cache as C
from tempme_tpu_torch.data.events import RandEdgeSampler
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.explain.tempme import TempME
from tempme_tpu_torch.models.tgat import TGAT
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train import temp_exp_main as X
from tempme_tpu_torch.utils.checkpoint import save_checkpoint
from tempme_tpu_torch.utils.convert import flax_to_state_dict

N_DEG, BS, SEED, NEG_SEED = 4, 64, 0, 3


def jax_cache_draws(seed, n_batches, b, n, n2=3):
    """The port's draws for JAX's ``build_walk_cache`` key chain: ``key =
    PRNGKey(seed)``; per batch ``key, sub = split(key)``, ``ks =
    split(sub, 6)``; side i's hops from ``ks[2i]`` (``find_k_hop``), its
    walks from ``ks[2i + 1]`` (``find_k_walks``: ``k, k2 = split``, ``_,
    k3 = split(k)``)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        ks = jax.random.split(sub, 6)
        sides = []
        for i in range(3):
            kk, k2 = jax.random.split(ks[2 * i + 1])
            _, k3 = jax.random.split(kk)
            walks = S.WalkDraws(_t(jax.random.uniform(k2, (b * n, n2))),
                                _t(jax.random.uniform(k3, (b * n * n2,))))
            sides.append((jax_hop_draws(ks[2 * i], b, 2, n), walks))
        out.append(tuple(sides))
    return out


@pytest.fixture(scope="module")
def caches():
    ev = make_events(120, 20, seed=5)
    jg = dataclasses.replace(jax_build_graph(ev), dense_ts=None,
                             dense_node=None, dense_eid=None)
    ref = JC.build_walk_cache(jg, ev, JaxSampler([ev.src], [ev.dst],
                                                 seed=NEG_SEED),
                              N_DEG, batch_size=BS, seed=SEED)
    tev = to_torch_events(ev)
    tg = build_temporal_graph(tev, device="cpu")
    port = C.build_walk_cache(
        tg, tev, RandEdgeSampler([ev.src], [ev.dst], seed=NEG_SEED), N_DEG,
        batch_size=BS, draws=jax_cache_draws(SEED, 2, BS, N_DEG))
    return ev, ref, port


def test_build_walk_cache_matches_jax(caches):
    ev, ref, port = caches
    assert set(port) == set(ref)
    for k in sorted(ref):
        r = np.asarray(ref[k])
        assert port[k].dtype == r.dtype and port[k].shape == r.shape, k
        np.testing.assert_array_equal(port[k], r, err_msg=k)
    assert port["subgraph_src_1"].shape == (len(ev), 3 * N_DEG ** 2)
    assert port["edge_bgd"].shape == (len(ev), 3 * N_DEG, 3, 3)
    for side in C.SIDES:
        np.testing.assert_array_equal(C.pack_walks_14(port, side),
                                      JC.pack_walks_14(ref, side))
    cat = port["walks_src_cat"]
    assert cat.min() >= 0 and cat.max() < 12 and len(np.unique(cat)) > 3
    assert abs(float(port["class_distribution"].sum()) - 1.0) < 1e-6


def test_each_package_reads_the_others_cache(caches, tmp_path):
    ev, ref, port = caches
    JC.save_cache(str(tmp_path / "jax.npz"), ref)
    C.save_cache(str(tmp_path / "port.npz"), port)
    idx = np.random.RandomState(0).permutation(len(ev))[:50]
    idx = np.r_[idx, np.zeros(14, np.int64)]              # padded to 64
    for ours, theirs in (("port.npz", "jax.npz"), ("jax.npz", "port.npz")):
        tb, tsubs, twalks = C.cache_to_inputs(
            C.load_cache(str(tmp_path / theirs)), idx, N_DEG, "cpu")
        jb, jsubs, jwalks = JC.cache_to_inputs(
            JC.load_cache(str(tmp_path / ours)), idx, N_DEG)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        for t, j in zip(tsubs + twalks, jsubs + jwalks):
            for a, b in zip(jax.tree_util.tree_leaves(tuple(t)),
                            jax.tree_util.tree_leaves(tuple(j))):
                assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _cached_step_world(s):
    """A one-batch cache of events 150..155 of the toy TGN's stream (both
    packages' files are the same arrays, above), the port's inputs from
    it, and the JAX ones."""
    keep = np.zeros(len(s.ev), bool)
    keep[150:150 + B] = True
    ev = s.ev.select(keep)
    draws = jax_cache_draws(SEED, 1, B, N)
    cache = C.build_walk_cache(
        s.tg, to_torch_events(ev), RandEdgeSampler([s.ev.src], [s.ev.dst],
                                                   seed=NEG_SEED),
        N, batch_size=B, draws=draws)
    idx = np.arange(B)
    return (ev, cache, draws, C.cache_to_inputs(cache, idx, N, "cpu"),
            JC.cache_to_inputs(cache, idx, N))


def test_cached_train_step_equals_online_step_and_jax(world):  # noqa: F811
    s = world
    ev, cache, draws, inputs, jinputs = _cached_step_world(s)
    batch = L.Batch(*(_t(x) for x in (ev.src, ev.dst, ev.ts, ev.e_idx)),
                    mask=torch.ones(B, dtype=torch.bool))
    dst = np.unique(s.ev.dst)
    jbgd, jsubs, jwalks = jinputs
    je, params, _ = _explainers(s, 0.0, jwalks[0], jsubs[0],
                                jnp.asarray(ev.ts))
    null = jnp.asarray(s.null)
    contrast = JX.make_base_contrast(s.jbase, s.jfeats)
    jb = JX.loops.Batch(*(jnp.asarray(x) for x in (ev.src, ev.dst, ev.ts,
                                                   ev.e_idx)),
                        jnp.ones(B, bool))
    gammas = []

    def loss_fn(ep):                     # the JAX driver's train_core loss
        gammas.clear()
        pos_ori, neg_ori = contrast(jb.src, jb.dst, jbgd, jb.ts, jb.eidx,
                                    *jsubs, None)
        y_ori = (jnp.concatenate([pos_ori, neg_ori]) > 0.0).astype(
            jnp.float32)
        imps = [je.apply(ep, s.jfeats, jwalks[i], jb.ts, deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(i)})
                for i in range(3)]
        explanation = je.apply(
            ep, s.jfeats, jsubs[0], imps[0], jwalks[0], jsubs[1], imps[1],
            jwalks[1], jsubs[2], imps[2], jwalks[2], training=True,
            deterministic=False, rngs={"sample": jax.random.PRNGKey(3),
                                       "dropout": jax.random.PRNGKey(4)},
            method=JE.TempME.retrieve_explanation)
        pos, neg = contrast(jb.src, jb.dst, jbgd, jb.ts, jb.eidx, *jsubs,
                            explanation)
        pred_loss = optax.sigmoid_binary_cross_entropy(
            jnp.concatenate([pos, neg]), y_ori).mean()
        kl = sum(JE.kl_sparsity_loss(imps[i], jwalks[i].cat, null, 0.3)
                 for i in range(3))
        return pred_loss + 0.5 * kl, tuple(gammas)

    real_gamma = jax.random.gamma

    def recording_gamma(k, a, *args, **kw):
        g = real_gamma(k, a, *args, **kw)
        gammas.append(g)
        return g
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gamma", recording_gamma)
        (loss_r, gam), grads_r = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    gamma = tuple(tuple(_t(g) for g in gam[4 * i:4 * i + 4])
                  for i in range(3))

    # the online step's draws: ``build_walk_cache``'s, and negatives whose
    # indices into the table give the cached dst_fake
    neg_idx = torch.from_numpy(np.searchsorted(dst, cache["dst_fake"]))
    support = L.SupportDraws(neg_idx, *(hops for hops, _ in draws[0]))
    online = X.ExplainerDraws(support, tuple(w for _, w in draws[0]),
                              gamma=gamma)
    cached = X.ExplainerDraws(None, None, gamma=gamma)
    auxs, grads = [], []
    for d, inp in ((online, None), (cached, inputs)):
        te = TempME(12, 6, hid_dim=HID, dropout=0.0, device="cpu")
        te.load_state_dict(flax_to_state_dict(_np_tree(params)))
        step = X.ExplainerTrainStep(
            te, s.tbase, s.tg, s.tfeats, _t(dst), N, _t(s.null),
            torch.optim.Adam(te.parameters(), lr=1e-3), 0.3, 0.5, True)
        auxs.append(step(batch, d, inp))
        grads.append({n: p.grad for n, p in te.named_parameters()})
    assert torch.equal(auxs[0]["loss"], auxs[1]["loss"])
    for n, g in grads[0].items():
        assert (g is None) == (grads[1][n] is None), n
        assert g is None or torch.equal(g, grads[1][n]), n

    np.testing.assert_allclose(auxs[1]["loss"].item(), float(loss_r),
                               rtol=1e-5)
    for name, g in flax_to_state_dict(_np_tree(grads_r)).items():
        g = g.numpy()
        mine = grads[1][name]
        mine = np.zeros_like(g) if mine is None else mine.numpy()
        np.testing.assert_allclose(mine, g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_cached_step_draws_no_sampling_uniforms(world):  # noqa: F811
    s = world
    step = X.ExplainerTrainStep(
        TempME(12, 6, hid_dim=HID, dropout=0.2, device="cpu"), s.tbase,
        s.tg, s.tfeats, _t(np.unique(s.ev.dst)), N, _t(s.null),
        None, 0.3, 0.5, True)
    gen = torch.Generator().manual_seed(0)
    cached = step.draw(gen, B, sample=False)
    assert cached.support is None and cached.walks is None
    assert cached.imp is not None and cached.edge is not None
    assert cached.gamma is gen
    # the online draws start with the support and the walks, then the same
    # dropout draws
    gen_a, gen_b = (torch.Generator().manual_seed(0) for _ in range(2))
    step._support_and_walks(gen_a, B)
    online = step.draw(gen_b, B)
    again = step.draw(gen_a, B, sample=False)
    for a, b in zip(online.imp + online.edge, again.imp + again.edge):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_ids_at_2_24_raise():
    g = types.SimpleNamespace(num_nodes=2 ** 24, edge_ts=torch.zeros(5),
                              ngh_node=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        C.build_walk_cache(g, None, None, 4)
    g = types.SimpleNamespace(num_nodes=10, edge_ts=torch.zeros(2 ** 24),
                              ngh_node=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        C.build_walk_cache(g, None, None, 4)
    C.check_id_range(2 ** 24 - 1, 2 ** 24 - 1)         # the largest exact


def test_widths_other_than_n_degree_raise(caches):
    _, _, port = caches
    C.check_cache_widths(port, N_DEG)
    for n in (3, 5):
        with pytest.raises(ValueError, match=f"n_degree {n}"):
            C.cache_to_inputs(port, np.arange(4), n, "cpu")


def test_a_3_layer_tgat_refuses_the_cache(workdir, tmp_path):  # noqa: F811
    """The cache holds 2 hops and a 3-layer TGAT reads 3: refused before
    any cache is built (a 2-layer TGAT runs, as in the JAX package)."""
    ck = tmp_path / "params"
    tgat = TGAT(8, 4, num_layers=3, remat=True, device="cpu")
    save_checkpoint(str(ck / "tgnn" / "tgat_synth.pt"),
                    {"params": tgat.state_dict()},
                    meta=dict(base_type="tgat", data="synth", n_degree=4,
                              n_layer=3, n_head=2, drop_out=0.1, node_dim=8,
                              edge_dim=4))
    cache_dir = tmp_path / "cache"
    with pytest.raises(ValueError, match="3-layer TGAT"):
        X.main(["--data", "synth", "--data_dir", str(workdir),
                "--base_type", "tgat", "--ckpt_dir", str(ck), "--use_cache",
                "--cache_dir", str(cache_dir), "--log_dir",
                str(tmp_path / "tb")], device="cpu")
    assert not cache_dir.exists()
