"""The port's explanation figures and multi-seed tables against the JAX
package's on the CPU.

* ``explain_samples`` on the ``ml_synth`` stream (``tests/test_torch_
  drivers.py``): a TGN explainer whose weights are converted from a JAX
  ``TempME`` initialisation, the supports and walks drawn from
  ``jax.random`` in JAX's ``sample_explainer_inputs`` order and passed in
  as tensors. Per sample the support edge ids, their times and the motif
  counts equal what JAX's ``visualize_explanations`` computes
  (``explainer.apply(..., method=edge_importance)`` on the same walks, the
  CSR sampler) bit for bit; the importances agree to rtol 2e-4, atol 1e-5
  at float32 (sums in another order through the walk scores' MLPs).
* ``cli visualize`` writes ``n_samples + 1`` PNGs from a checkpoint
  directory built without a driver run (the base a fresh TGN from a seed,
  the explainer the converted JAX initialisation), through matplotlib and
  through the rasteriser used where matplotlib is missing.
* ``aggregate_multiseed``: on one results tree written for seeds 0, 1 and
  2, the port's ``collect``, ``summarize``, ``markdown`` and the written
  summary equal JAX's exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import jax_hop_draws
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_tgn import _np_tree, _t
from tempme_tpu.data.events import load_dataset as jax_load_dataset
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.explain import tempme as JE
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.tools import aggregate_multiseed as JA
from tempme_tpu.train import loops as JL
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu_torch import cli
from tempme_tpu_torch.data.events import RandEdgeSampler, load_dataset
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.explain.tempme import TempME
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgn import TGN, init_memory_state
from tempme_tpu_torch.ops import sampler as S
from tempme_tpu_torch.tools import aggregate_multiseed as A
from tempme_tpu_torch.tools import visualize
from tempme_tpu_torch.tools.visualize import explain_samples
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train.temp_exp_main import (N_WALK_CONT,
                                                  ExplainerDraws)
from tempme_tpu_torch.utils.checkpoint import save_checkpoint
from tempme_tpu_torch.utils.convert import flax_to_state_dict

N, B, HID, OUT = 4, 5, 16, 8


def jax_explainer_draws(key, b, n, num_dst):
    """The draws JAX's ``sample_explainer_inputs(key)`` makes (2 hops), as
    the port's ``ExplainerDraws``: the negatives' indices, per side the
    hops' uniforms, per side the walks' uniforms."""
    kn, k1, k2, k3, w1, w2, w3 = jax.random.split(key, 7)
    neg = torch.from_numpy(np.array(
        jax.random.randint(kn, (b,), 0, num_dst))).long()
    support = L.SupportDraws(neg, *(jax_hop_draws(k, b, 2, n)
                                    for k in (k1, k2, k3)))
    walks = []
    for wk in (w1, w2, w3):
        kk, ku2 = jax.random.split(wk)
        _, ku3 = jax.random.split(kk)
        walks.append(S.WalkDraws(
            _t(jax.random.uniform(ku2, (b * n, N_WALK_CONT))),
            _t(jax.random.uniform(ku3, (b * n * N_WALK_CONT,)))))
    return ExplainerDraws(support, tuple(walks))


@pytest.fixture(scope="module")
def world(workdir):  # noqa: F811
    """Both packages' view of ``ml_synth``'s full graph, one shuffled test
    batch, JAX's explanation internals and the port's explainer with the
    same weights."""
    ds = load_dataset("synth", str(workdir))
    jds = jax_load_dataset("synth", str(workdir))
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    # the JAX sampler's CSR branch, which the port's kernels follow
    jg = dataclasses.replace(jax_build_graph(jds.full, nn_, ne),
                             dense_ts=None, dense_node=None, dense_eid=None)
    g = build_temporal_graph(ds.full, nn_, ne, device="cpu")
    jfeats = JaxFeatures(jnp.asarray(ds.node_feat), jnp.asarray(ds.edge_feat))
    feats = Features(_t(ds.node_feat), _t(ds.edge_feat))
    dst = RandEdgeSampler([ds.test.src], [ds.test.dst], seed=0).dst_list
    batch = L.Batch(*(x[0] for x in L.stack_batches(
        ds.test, B, shuffle=True, seed=0, device="cpu")))
    jb = JL.Batch(*(jnp.asarray(x.numpy()) for x in batch))
    key = jax.random.PRNGKey(5)
    _, subs, walks = jax.jit(lambda k, b: JX.sample_explainer_inputs(
        jg, k, b, jnp.asarray(dst), N))(key, jb)
    je = JE.TempME(node_dim=ds.node_feat.shape[1],
                   edge_dim=ds.edge_feat.shape[1], out_dim=OUT, hid_dim=HID,
                   base_type="tgn")

    @jax.jit
    def internals(k):
        params = je.init({"params": k}, jfeats, walks[0], jb.ts, subs[0],
                         method=JE.TempME.init_all)
        imp = je.apply(params, jfeats, walks[0], jb.ts, deterministic=True)
        imp0, imp1 = je.apply(params, jfeats, subs[0], imp, walks[0],
                              method=JE.TempME.edge_importance,
                              training=False)
        return params, imp0, imp1
    params, imp0, imp1 = internals(jax.random.PRNGKey(7))
    te = TempME(ds.node_feat.shape[1], ds.edge_feat.shape[1], out_dim=OUT,
                hid_dim=HID, base_type="tgn", device="cpu")
    te.load_state_dict(flax_to_state_dict(_np_tree(params)))
    sub = subs[0]
    ref = dict(eids=np.concatenate([sub.eids[0], sub.eids[1]], axis=1),
               imps=np.concatenate([imp0, imp1], axis=1),
               ts=np.concatenate([sub.ts[0], sub.ts[1]], axis=1),
               counts=np.bincount(np.asarray(walks[0].cat).ravel(),
                                  minlength=12)[:12].astype(np.float64))
    return dict(ds=ds, g=g, feats=feats, dst=dst, batch=batch, key=key,
                explainer=te, ref=ref)


@pytest.mark.parametrize("n_samples", [B, 2])
def test_explain_samples_match_jax(world, n_samples):
    w, ref = world, world["ref"]
    draws = jax_explainer_draws(w["key"], B, N, len(w["dst"]))
    samples, counts = explain_samples(w["explainer"], w["feats"], w["g"],
                                      w["batch"], torch.from_numpy(w["dst"]),
                                      N, draws, n_samples)
    assert len(samples) == n_samples
    np.testing.assert_array_equal(counts, ref["counts"])
    assert counts.sum() == B * N * N_WALK_CONT
    for i, (eids, imps, ts) in enumerate(samples):
        assert eids.shape == (N + N * N,)
        np.testing.assert_array_equal(eids, ref["eids"][i])
        np.testing.assert_array_equal(ts, ref["ts"][i])
        np.testing.assert_allclose(imps, ref["imps"][i], rtol=2e-4,
                                   atol=1e-5)
        assert np.isfinite(imps).all() and (imps[eids == 0] == 0).all()
    assert any((s[0] > 0).any() for s in samples)


def write_tgn_base(ckpt_dir, ds, n_degree, seed=0):
    """A TGN base checkpoint in the layout ``learn_base`` writes, from
    fresh weights (no training run)."""
    dn, de = ds.node_feat.shape[1], ds.edge_feat.shape[1]
    model = TGN(dn, de, ds.full.num_nodes, device="cpu", seed=seed)
    mem = init_memory_state(ds.full.num_nodes, model.memory_dim,
                            model.raw_message_dim, device="cpu")
    save_checkpoint(str(ckpt_dir / "tgnn" / "tgn_synth.pt"),
                    {"params": model.state_dict(), "memory": mem._asdict()},
                    meta=dict(base_type="tgn", data="synth",
                              n_degree=n_degree, n_layer=2, n_head=2,
                              drop_out=0.1, node_dim=dn, edge_dim=de,
                              num_nodes=ds.full.num_nodes))


@pytest.mark.parametrize("backend", ["matplotlib", "raster"])
def test_cli_visualize_writes_the_figures(world, workdir,  # noqa: F811
                                          tmp_path, monkeypatch, backend):
    """The figures through matplotlib, and through the numpy rasteriser
    that draws them where matplotlib is missing."""
    if backend == "raster":
        monkeypatch.setattr(visualize, "_plt", lambda: None)
    w, ck = world, tmp_path / "params"
    write_tgn_base(ck, w["ds"], N)
    save_checkpoint(str(ck / "explainer" / "tgn" / "synth.pt"),
                    {"params": w["explainer"].state_dict()},
                    meta=dict(base_type="tgn", data="synth", out_dim=OUT,
                              hid_dim=HID, drop_out=0.1, n_degree=N,
                              node_dim=w["ds"].node_feat.shape[1],
                              edge_dim=w["ds"].edge_feat.shape[1]))
    out = tmp_path / "viz"
    assert cli.main(["visualize", "--data", "synth", "--data_dir",
                     str(workdir), "--base_type", "tgn", "--ckpt_dir",
                     str(ck), "--out_dir", str(out), "--n_samples", "2"],
                    device="cpu") == 0
    pngs = sorted(p.name for p in out.iterdir() if p.suffix == ".png")
    assert pngs == ["tgn_synth_motifs.png", "tgn_synth_sample0.png",
                    "tgn_synth_sample1.png"]
    for name in pngs:
        data = (out / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[-8:-4] == b"IEND"
        assert (b"tEXtTitle" in data) == (backend == "raster")


def _results_tree(root, layout):
    """Results JSONs for seeds 0 (top level), 1 and 2 (``multiseed/s<k>``)
    with metrics drawn from a seed; ``layout`` "partial" leaves some files
    and some metrics out, and adds a directory that is not a seed."""
    r = np.random.RandomState(3)
    for seed, d in ((0, root), (1, root / "multiseed" / "s1"),
                    (2, root / "multiseed" / "s2")):
        d.mkdir(parents=True, exist_ok=True)
        for base in ("tgn", "tgat", "graphmixer"):
            if layout == "partial" and (seed, base) in ((1, "tgat"),
                                                       (0, "graphmixer")):
                continue
            payload = {m: float(r.rand()) for m in A.BASE_METRICS}
            if layout == "partial" and seed == 2:
                payload.pop("val_ap")
            (d / f"base_{base}_synth.json").write_text(json.dumps(payload))
            if layout == "partial" and base == "graphmixer":
                continue
            payload = {m: float(r.rand()) for m in A.EXP_METRICS}
            (d / f"explainer_{base}_synth.json").write_text(
                json.dumps(payload))
    if layout == "partial":
        (root / "multiseed" / "sx").mkdir()
        (root / "base_tgn_other.json").write_text("{}")


@pytest.mark.parametrize("layout", ["full", "partial"])
def test_multiseed_tables_equal_jax(tmp_path, layout):
    root = tmp_path / "results"
    _results_tree(root, layout)
    runs = A.collect(str(root), "synth")
    assert runs == JA.collect(str(root), "synth")
    assert {s for by_seed in runs.values() for s in by_seed} == {0, 1, 2}
    summary = A.summarize(runs)
    assert summary == JA.summarize(runs)
    assert A.markdown(summary) == JA.markdown(summary)
    out = tmp_path / "summary.json"
    assert A.main(["--results_dir", str(root), "--data", "synth", "--out",
                   str(out)]) == summary
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
