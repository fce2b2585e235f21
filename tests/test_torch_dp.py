"""The port's data-parallel TGN train step on 2 gloo ranks on the CPU.

One subprocess (its own timeout) spawns 2 ranks, one torch thread each,
which replay three global steps (``parallel/dryrun.py``) at node dim 16,
about 32 nodes, batch 8 (4 a rank), 4 neighbours, 2 layers, float32:

* run A, dropout 0, from flax weights (``utils/convert.py``; normal draws
  in the structure of the JAX model's ``eval_shape`` tree) with the JAX
  step's support draws (its ``k_samp``, as ``tests/test_torch_train.py``
  replays them). Step 2's batch holds one node as a target on rank 0 and as
  a source on rank 1 (its message must be rank 0's target message, the
  later one in the global order), and nodes that step 1 left with a
  pending message on rank 1's rows only (their positives persist on both
  ranks); step 3 has 2 padded rows, all on rank 1. Rank 0 saves a
  checkpoint after step 2.
* run B, the ``mean`` aggregator at dropout 0.1, draws from each rank's
  generator (seeded differently per rank, then made rank 0's by
  ``place``).

Both ranks end every step with the same bytes. Each run is held against
the port's 1-process ``TGNTrainStep`` on the global batches and draws, and
run A also against JAX's ``make_sharded_tgn_train_step`` on a dp = 2 mesh
of the virtual CPU devices, with ``tests/test_torch_train.py``'s
tolerances: the loss rtol 1e-5; every gradient rtol 1e-4, atol 1e-5 of the
tensor's largest (1e-4 for the time encoder), against the gradient the JAX
step applied (read back from its Adam first moments: (mu_k - 0.9 mu_{k-1})
/ 0.1, float32 round-off of about 2e-6 of the largest); the parameters
after Adam rtol 1e-5,
atol 1e-6 where the gradient stayed above 1e-4 of its tensor's largest in
every step so far, within ``lr`` a step elsewhere (Adam scales round-off
of cancelling terms up to a step of ``lr``); each memory field rtol 2e-4,
atol 1e-5, ``msg_valid`` exactly. A 1-process restore of the step-2
checkpoint then runs step 3 equal to the 2-rank step 3 at the same
tolerances.

The JAX package is imported inside the fixture only, so the card case
runs where JAX is not installed: ``python -m pytest --noconftest
tests/test_torch_dp.py -k card``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tempme_tpu_torch.parallel import checkpoint as C
from tempme_tpu_torch.parallel import dryrun as D
from tempme_tpu_torch.parallel import mesh as M
from tempme_tpu_torch.parallel.train import make_sharded_tgn_train_step
from tempme_tpu_torch.models.tgn import TGN
from tempme_tpu_torch.train import loops as L

ROOT = Path(__file__).resolve().parents[1]
LR, B, N, W = 1e-3, 8, 4, 2
DN, DE = 16, 8
CROSS = 1, 5                 # dst[1] on rank 0 and src[5] on rank 1
RANK_TIMEOUT = 240


def _launch(spec, work, backend="gloo", device="cpu"):
    """Start the ranks in a subprocess; returns it (wait with ``_join``).
    It forks them, so they share its imports."""
    path = os.path.join(work, "spec.pt")
    torch.save(spec, path)
    code = ("import sys; from tempme_tpu_torch.parallel import dryrun as D; "
            "D.launch(D.run_ranks, 2, (sys.argv[1], sys.argv[2], "
            f"sys.argv[3], sys.argv[4], 1), {RANK_TIMEOUT}, 'fork')")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", code, backend, device, path, work], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _join(proc, work):
    out, _ = proc.communicate(timeout=RANK_TIMEOUT + 30)
    assert proc.returncode == 0, out[-3000:]
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(W)]


def _batches(ev):
    """Three global batches of the stream: step 2 with the cross-rank node,
    step 3 with rows 6 and 7 (rank 1) padded."""
    def rows(start):
        s = slice(start, start + B)
        return [ev.src[s].copy(), ev.dst[s].copy(), ev.ts[s].copy(),
                ev.e_idx[s].copy(), np.ones(B, bool)]
    b1, b2, b3 = rows(100), rows(108), rows(116)
    seen = set(b2[0]) | set(b2[1]) | set(b1[0]) | set(b1[1])
    x = min(set(range(1, ev.num_nodes)) - seen)
    b2[1][CROSS[0]], b2[0][CROSS[1]] = x, x
    b3[4][6:] = False
    return [L.Batch(*(torch.from_numpy(np.asarray(c)) for c in b))
            for b in (b1, b2, b3)]


def _jax_model(ev, node, edge, nodes):
    """The JAX TGN, its graph and features, and weights: normal(0.3) draws
    in the structure of the model's ``eval_shape`` tree (no init
    compiled)."""
    import jax
    import jax.numpy as jnp
    from tempme_tpu.data.graph import build_temporal_graph
    from tempme_tpu.models.common import Features
    from tempme_tpu.models.tgn import TGN as JaxTGN, init_memory_state
    from tempme_tpu.train import loops as JL

    jg = build_temporal_graph(ev, num_nodes=nodes)
    jfeats = Features(jnp.asarray(node), jnp.asarray(edge))
    jm = JaxTGN(node_dim=DN, edge_dim=DE, num_nodes=nodes, n_layers=2,
                n_head=2, dropout=0.0, compute_dtype=jnp.float32)
    jmem = init_memory_state(nodes, jm.memory_dim, jm.raw_message_dim)
    b = JL.Batch(*(jnp.asarray(x[:B]) for x in (ev.src, ev.dst, ev.ts,
                                                 ev.e_idx)),
                 jnp.ones(B, bool))
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: jm.init(
        key, jfeats, jmem, b.src, b.dst, b.dst, b.ts, b.eidx,
        *JL.sample_support(jg, key, b, jnp.arange(1, 5), 2, N)[1:]))
    r = np.random.RandomState(6)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.3 * r.randn(*x.shape), x.dtype), tree)
    return jm, jg, jfeats, jmem, params


def _adam_grads(mu, mu_prev):
    """The gradient an ``optax.adam`` step applied, from its first moments
    (b1 0.9): (mu_k - b1 mu_{k-1}) / (1 - b1)."""
    prev = np.zeros_like(mu) if mu_prev is None else np.asarray(mu_prev,
                                                                 np.float64)
    return ((np.asarray(mu, np.float64) - 0.9 * prev) / 0.1).astype(
        np.float32)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from tests.conftest import make_events
    from tests.test_torch_graph_sampler import (jax_support_draws,
                                                to_torch_events)
    from tempme_tpu.parallel import mesh as JM
    from tempme_tpu.parallel.train import make_sharded_tgn_train_step as JS
    from tempme_tpu.train import loops as JL
    from tempme_tpu_torch.utils.convert import flax_to_state_dict

    def port(tree):
        return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))

    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("dp"))
    ev = make_events(num_events=200, num_nodes=32, seed=6)
    nodes, dst = ev.num_nodes, np.unique(ev.dst)
    r = np.random.RandomState(7)
    node = r.randn(nodes, DN).astype(np.float32)
    edge = r.randn(ev.num_edges, DE).astype(np.float32)
    node[0] = edge[0] = 0.0
    jm, jg, jfeats, jmem, params = _jax_model(ev, node, edge, nodes)
    batches = _batches(ev)
    keys = [jax.random.PRNGKey(5)]
    for _ in range(2):
        keys.append(jax.random.split(keys[-1], 3)[0])
    draws = [L.StepDraws(jax_support_draws(jax.random.split(k, 3)[1], B, 2,
                                           N, len(dst)), None) for k in keys]
    model = dict(node_dim=DN, edge_dim=DE, num_nodes=nodes, n_layers=2,
                 n_head=2, compute_dtype=torch.float32)
    spec = D.make_spec(
        to_torch_events(ev), nodes, ev.num_edges, node, edge, dst, N,
        [D.make_run(dict(model, dropout=0.0), batches, LR, draws=draws,
                    state={"params": port(params)}, record=(1, 2, 3),
                    save_at=2),
         D.make_run(dict(model, dropout=0.1, aggregator="mean", seed=3),
                    batches, LR, seed=7, record=(1, 2, 3))])
    proc = _launch(spec, work)
    try:
        # meanwhile: JAX's sharded step on a dp = 2 mesh, and the port's
        # 1-process step
        jopt = optax.adam(LR)
        mesh = JM.make_mesh(2, 1, 1, devices=jax.devices()[:2])
        jax_out, mu_prev = [], None
        with mesh:
            jstep, place, place_batch = JS(jm, jg, jfeats, jnp.asarray(dst),
                                           N, jopt, mesh)
            p, o, m, k = place(params, jopt.init(params), jmem, keys[0])
            for i, tb in enumerate(batches):
                jb = JL.Batch(*(jnp.asarray(x.numpy()) for x in tb))
                p, o, m, k, loss = jstep(p, o, m, k, place_batch(jb))
                if i < 2:                      # the draws' keys are JAX's
                    assert np.array_equal(np.asarray(k), keys[i + 1])
                mu = port(o[0].mu)
                jax_out.append(dict(
                    loss=float(loss), params=port(p),
                    grads={n: _adam_grads(g, None if mu_prev is None
                                          else mu_prev[n])
                           for n, g in mu.items()},
                    memory={f: np.asarray(getattr(m, f)) for f in m._fields}))
                mu_prev = mu
        plain = D.replay_plain(spec, torch.device("cpu"))
        ranks = _join(proc, work)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return dict(spec=spec, work=work, ranks=ranks, plain=plain, jax=jax_out,
                model=model, draws=draws, batches=batches)


def _close_to_max(port, ref, name):
    scale = max(float(np.abs(ref).max()), 1e-30)
    atol = (1e-4 if name.startswith("time_encoder.") else 1e-5) * scale
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=atol, err_msg=name)


def _memory_close(got, want):
    for name, a in want.items():
        b, a = np.asarray(got[name]), np.asarray(a)
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-5,
                                       err_msg=name)


def _hold(got, want, settled, step, grads=True):
    """The state after ``step`` (a record) against the reference's."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name, p in got["params"].items():
        g = None if got["grads"] is None else got["grads"].get(name)
        if grads and g is not None:
            _close_to_max(g.numpy(), np.asarray(want["grads"][name]), name)
        ref = np.asarray(want["params"][name])
        if name in settled:
            g_ref = np.abs(np.asarray(want["grads"][name]))
            settled[name] &= g_ref >= 1e-4 * g_ref.max()
            np.testing.assert_allclose(p.numpy()[settled[name]],
                                       ref[settled[name]], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        assert np.abs(p.numpy() - ref).max() <= LR * step * 1.001, name
    _memory_close(got["memory"], want["memory"])


def _record(res, k):
    st = res["states"][k]
    return dict(st, loss=res["loss"][k - 1])


def _settled(res):
    return {n: np.ones(p.shape, bool)
            for n, p in res["states"][1]["params"].items()
            if n in res["states"][1]["grads"]}


def test_ranks_end_every_step_bitwise_equal(dp):
    D.assert_ranks_equal(dp["ranks"])
    assert all(r[0]["states"][3]["memory"]["msg_valid"].any()
               for r in dp["ranks"])


@pytest.mark.parametrize("run", [0, 1])
def test_two_ranks_match_the_one_process_step(dp, run):
    got, want = dp["ranks"][0][run], dp["plain"][run]
    settled = _settled(want)
    for k in (1, 2, 3):
        _hold(_record(got, k), _record(want, k), settled, k)


def test_two_ranks_match_jax_sharded_step(dp):
    got = dp["ranks"][0][0]
    settled = _settled(got)
    for k, ref in enumerate(dp["jax"], start=1):
        _hold(_record(got, k), ref, settled, k)


def test_cross_rank_node_keeps_the_later_global_message(dp):
    """Step 2's node ``x``: a target on rank 0 (global position B + 1)
    beats a source on rank 1 (position 5); ranks and JAX agree."""
    b2 = dp["batches"][1]
    x = int(b2.dst[CROSS[0]])
    assert int(b2.src[CROSS[1]]) == x
    assert (b2.src == x).sum() + (b2.dst == x).sum() == 2
    assert CROSS[0] < B // W <= CROSS[1]
    mem = dp["ranks"][1][0]["states"][2]["memory"]
    assert bool(mem["msg_valid"][x])
    assert float(mem["msg_ts"][x]) == float(b2.ts[CROSS[0]])
    ref = dp["jax"][1]["memory"]
    np.testing.assert_allclose(mem["msg_buf"][x].numpy(), ref["msg_buf"][x],
                               rtol=2e-4, atol=1e-5)
    # the message of x as a target starts with x's own (target) embedding
    # at the target slot, so it differs from its message as a source
    d = dp["model"]["node_dim"]
    assert not np.allclose(ref["msg_buf"][x][:d], ref["msg_buf"][x][d:2 * d])


def test_padded_rows_sit_on_rank_one_only(dp):
    """Step 3's loss is the mean over its 6 valid rows, all of rank 0's
    and 2 of rank 1's (a mean of the ranks' means would weigh rank 1's
    rows double)."""
    mask = dp["batches"][2].mask
    assert mask[:B // W].all() and mask[B // W:].sum() == 2
    np.testing.assert_allclose(dp["ranks"][0][0]["loss"][2],
                               dp["jax"][2]["loss"], rtol=1e-5)
    np.testing.assert_allclose(dp["ranks"][1][1]["loss"][2],
                               dp["plain"][1]["loss"][2], rtol=1e-5)


def test_persisted_positives_are_the_union_over_ranks(dp):
    """Nodes that step 1 left with a pending message and that step 2 holds
    on rank 1's rows only: their memory advanced on rank 0 too."""
    b1, b2 = dp["batches"][:2]
    pending = set(b1.src.tolist()) | set(b1.dst.tolist())
    half = B // W
    rank0 = set(b2.src[:half].tolist()) | set(b2.dst[:half].tolist())
    rank1 = set(b2.src[half:].tolist()) | set(b2.dst[half:].tolist())
    only1 = sorted((pending & rank1) - rank0)
    assert only1
    m1 = dp["ranks"][0][0]["states"][1]["memory"]
    m2 = dp["ranks"][0][0]["states"][2]["memory"]
    for v in only1:
        assert bool(m1["msg_valid"][v])
        assert float(m2["last_update"][v]) == float(m1["msg_ts"][v])
        assert not torch.equal(m2["memory"][v], m1["memory"][v])


def test_checkpoint_restores_at_world_size_one(dp):
    """The step-2 checkpoint of 2 ranks, restored on one process (no
    process group), runs step 3 equal to the 2-rank step 3."""
    ckpt = os.path.join(dp["work"], "run0")
    assert C.latest_step(ckpt) == 2
    spec = dp["spec"]
    run = dict(spec["runs"][0], state=None)
    g, feats, dst, model, opt, mem = D.build_run(spec, run, "cpu")
    step, place, place_batch = make_sharded_tgn_train_step(
        model, g, feats, dst, N, opt, M.make_mesh())
    gen = torch.Generator()
    blob = C.restore_sharded(ckpt, 2, step.state_dict(mem, gen))
    assert blob["step"] == 2
    mem = step.load_state_dict(blob, gen)
    mem, aux = step(mem, place_batch(dp["batches"][2]), dp["draws"][2])
    got = dict(D.snapshot(model, opt, mem, gen), loss=float(aux["loss"]))
    ranks = dp["ranks"][0][0]
    want = _record(ranks, 3)
    settled = {n: np.ones(p.shape, bool) for n, p in got["params"].items()}
    _hold(got, want, settled, 1)
    name = next(iter(blob["params"]))
    with pytest.raises(ValueError, match="shape"):
        C.restore_sharded(ckpt, 2, {"params": {name: torch.zeros(3)}})


def test_card_two_gloo_ranks_match_the_card_step(tmp_path):
    """On the card: 2 gloo ranks with CUDA tensors on one card against the
    1-process card step, the dry run's tiny stream at dropout 0 and
    float32, at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks run the card's kernels")
    spec = D.tiny_spec(W)
    spec["runs"] = spec["runs"][1:]
    ranks = _join(_launch(spec, str(tmp_path), "gloo", "cuda:0"),
                  str(tmp_path))
    D.assert_ranks_equal(ranks)
    plain = D.replay_plain(spec, torch.device("cuda"))[0]
    settled = _settled(plain)
    for k in (1, 2):
        _hold(_record(ranks[0][0], k), _record(plain, k), settled, k)
    launches = ranks[0][0]["launches"]
    assert launches == dict(sample_rows=12, attend=12, attend_drop=0,
                            attend_bwd=12), launches
