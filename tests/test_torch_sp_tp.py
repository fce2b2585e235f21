"""The port's TGN train step on the sp and tp mesh axes, on gloo ranks on
the CPU.

One subprocess a mesh (each under its own timeout) forks the mesh's ranks,
one torch thread each, which replay three global steps
(``parallel/dryrun.py``) at ``tests/test_torch_dp.py``'s sizes, as the JAX
dry run scales them: node dim 16 tp, 32 nodes, batch 4 dp, 4 sp
neighbours, 2 layers, float32, dropout 0, flax weights (normal draws in the
structure of the JAX model's ``eval_shape`` tree, carried across by
``utils/convert.py``) and the JAX step's support draws. Step 2's batch holds
a node of sp shard 1's rows as a target in the first dp index and as a
source in the last (its message must be the target's, the later one in the
global order); step 3 has 2 padded rows, on the last dp index.

On each of the meshes (1,2,1), (1,1,2), (2,2,1) and (2,2,2) every step is
held to the port's 1-process ``TGNTrainStep`` on the global batches and
draws at ``test_torch_dp.py``'s tolerances (the loss rtol 1e-5; every
gradient rtol 1e-4, atol 1e-5 of its tensor's largest, 1e-4 for the time
encoder; the parameters after Adam rtol 1e-5, atol 1e-6 where settled,
within ``lr`` a step elsewhere; each memory field rtol 2e-4, atol 1e-5,
``msg_valid`` exactly), (2,2,2) also to JAX's ``make_sharded_tgn_train_step``
on a (2,2,2) mesh of the 8 virtual CPU devices (the file's one JAX
compile; the gradients there at twice those tolerances, as the test
says why). The replicas of each shard hold the same bytes, each step makes
the golden's collectives, and at rest a rank holds ``ceil(num_nodes/sp)``
rows of ``memory`` and ``msg_buf`` and ``out/tp`` rows of each tp-sharded
weight and of its Adam moments, the tensors JAX's ``shard_params_tp``
shards. The (2,2,2) run's checkpoint after step 2 restores at (1,1,1) and
(1,2,1) and runs step 3 equal to (2,2,2)'s. The (2,2,1) run takes the mean
aggregator, whose message of a node averages over every dp index's rows;
the others the last-message one.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_dp import _adam_grads, _hold, _record, _settled
from tempme_tpu_torch.parallel import checkpoint as C
from tempme_tpu_torch.parallel import dryrun as D
from tempme_tpu_torch.parallel import mesh as M
from tempme_tpu_torch.parallel.train import (GOLDEN_COLLECTIVES, golden_kind,
                                             make_sharded_tgn_train_step)
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.utils import convert

ROOT = Path(__file__).resolve().parents[1]
LR, DE = 1e-3, 8
MESHES = [(1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2)]
IDS = ["x".join(map(str, m)) for m in MESHES]
RANK_TIMEOUT = 240
MEAN_MESH = (2, 2, 1)          # the run with the mean aggregator


def _launch(*jobs):
    """Start a subprocess that runs each job ``(spec, work, mesh)`` in turn,
    forking the mesh's ranks; returns it (wait with ``_join``)."""
    argv = []
    for spec, work, mesh in jobs:
        path = os.path.join(work, "spec.pt")
        torch.save(spec, path)
        argv += [path, work, "x".join(map(str, mesh))]
    code = ("import sys; from tempme_tpu_torch.parallel import dryrun as D\n"
            "for i in range(1, len(sys.argv), 3):\n"
            "    m = tuple(map(int, sys.argv[i + 2].split('x')))\n"
            "    D.launch(D.run_ranks, m[0] * m[1] * m[2], ('gloo', 'cpu', "
            f"sys.argv[i], sys.argv[i + 1], 1, m), {RANK_TIMEOUT}, 'fork')")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", code] + argv, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _join(proc, *outs):
    """Each ``(work, world)``'s rank results, once ``proc`` has ended."""
    out, _ = proc.communicate(timeout=2 * RANK_TIMEOUT + 30)
    assert proc.returncode == 0, out[-3000:]
    return [[torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
            for work, world in outs]


def _batches(ev, b, nodes):
    """Three global batches of ``b`` rows: in step 2 a node of sp shard 1's
    rows (of 2) as the target of row 1 and the source of row ``b - 1``;
    step 3's last 2 rows padded."""
    def rows(start):
        s = slice(start, start + b)
        return [ev.src[s].copy(), ev.dst[s].copy(), ev.ts[s].copy(),
                ev.e_idx[s].copy(), np.ones(b, bool)]
    b1, b2, b3 = rows(100), rows(100 + b), rows(100 + 2 * b)
    seen = set(b2[0]) | set(b2[1]) | set(b1[0]) | set(b1[1])
    lo, _ = M.row_block(nodes, 2, 1)
    x = min(set(range(lo, nodes)) - seen)
    b2[1][1], b2[0][b - 1] = x, x
    b3[4][b - 2:] = False
    return [L.Batch(*(torch.from_numpy(np.asarray(c)) for c in bt))
            for bt in (b1, b2, b3)]


def _jax_case(ev, mesh, trees):
    """The JAX TGN at the mesh's sizes, its graph, features and weights
    (normal draws in the structure of its ``eval_shape`` tree, kept in
    ``trees`` by width)."""
    import jax
    import jax.numpy as jnp
    from tempme_tpu.data.graph import build_temporal_graph
    from tempme_tpu.models.common import Features
    from tempme_tpu.models.tgn import TGN as JaxTGN, init_memory_state
    from tempme_tpu.train import loops as JL

    dp, sp, tp = mesh
    dn, n, b = 16 * tp, 4 * sp, 4 * dp
    nodes = ev.num_nodes
    r = np.random.RandomState(7)
    node = r.randn(nodes, dn).astype(np.float32)
    edge = r.randn(ev.num_edges, DE).astype(np.float32)
    node[0] = edge[0] = 0.0
    jg = build_temporal_graph(ev, num_nodes=nodes)
    jfeats = Features(jnp.asarray(node), jnp.asarray(edge))
    jm = JaxTGN(node_dim=dn, edge_dim=DE, num_nodes=nodes, n_layers=2,
                n_head=2, dropout=0.0, compute_dtype=jnp.float32)
    jmem = init_memory_state(nodes, jm.memory_dim, jm.raw_message_dim)
    bt = JL.Batch(*(jnp.asarray(x[:b]) for x in (ev.src, ev.dst, ev.ts,
                                                  ev.e_idx)),
                  jnp.ones(b, bool))
    key = jax.random.PRNGKey(0)
    if dn not in trees:
        trees[dn] = jax.eval_shape(lambda: jm.init(
            key, jfeats, jmem, bt.src, bt.dst, bt.dst, bt.ts, bt.eidx,
            *JL.sample_support(jg, key, bt, jnp.arange(1, 5), 2, n)[1:]))
    tree = trees[dn]
    r = np.random.RandomState(6)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.3 * r.randn(*x.shape), x.dtype), tree)
    return dict(jm=jm, jg=jg, jfeats=jfeats, jmem=jmem, params=params,
                node=node, edge=edge, dn=dn, n=n, b=b)


def _port(tree):
    import jax
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             tree))


@pytest.fixture(scope="module")
def sptp(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from tests.conftest import make_events
    from tests.test_torch_graph_sampler import (jax_support_draws,
                                                to_torch_events)
    from tempme_tpu.parallel import mesh as JM
    from tempme_tpu.parallel.train import make_sharded_tgn_train_step as JS
    from tempme_tpu.train import loops as JL

    torch.set_num_threads(1)
    ev = make_events(num_events=200, num_nodes=32, seed=6)
    nodes, dst = ev.num_nodes, np.unique(ev.dst)
    cases, procs, trees = {}, {}, {}
    try:
        for mesh in MESHES[::-1]:               # the largest first
            c = _jax_case(ev, mesh, trees)
            keys = [jax.random.PRNGKey(5)]
            for _ in range(2):
                keys.append(jax.random.split(keys[-1], 3)[0])
            draws = [L.StepDraws(jax_support_draws(
                jax.random.split(k, 3)[1], c["b"], 2, c["n"], len(dst)),
                None) for k in keys]
            batches = _batches(ev, c["b"], nodes)
            model = dict(node_dim=c["dn"], edge_dim=DE, num_nodes=nodes,
                         n_layers=2, n_head=2, dropout=0.0,
                         compute_dtype=torch.float32)
            if mesh == MEAN_MESH:
                model["aggregator"] = "mean"
            spec = D.make_spec(
                to_torch_events(ev), nodes, ev.num_edges, c["node"],
                c["edge"], dst, c["n"],
                [D.make_run(model, batches, LR, draws=draws,
                            state={"params": _port(c["params"])},
                            record=(0, 1, 2, 3),
                            save_at=2 if mesh == (2, 2, 2) else None)])
            work = str(tmp_path_factory.mktemp("sptp"))
            c.update(keys=keys, draws=draws, batches=batches, spec=spec,
                     work=work)
            cases[mesh] = c
            jobs = [(spec, work, mesh)]
            if mesh == (2, 2, 2):
                # then the checkpoint after step 2, restored at (1,2,1)
                run = dict(spec["runs"][0], state=None, batches=batches[2:],
                           draws=draws[2:], record=(1,), save_at=None,
                           restore=(os.path.join(work, "run0"), 2))
                c["restore_work"] = str(tmp_path_factory.mktemp("restore"))
                jobs.append((dict(spec, runs=[run]), c["restore_work"],
                             (1, 2, 1)))
            procs[mesh] = _launch(*jobs)
        # meanwhile: JAX's sharded step on a (2,2,2) mesh
        c = cases[(2, 2, 2)]
        jopt = optax.adam(LR)
        jmesh = JM.make_mesh(2, 2, 2, devices=jax.devices()[:8])
        jax_out, mu_prev = [], None
        with jmesh:
            jstep, place, place_batch = JS(c["jm"], c["jg"], c["jfeats"],
                                           jnp.asarray(dst), c["n"], jopt,
                                           jmesh)
            p, o, m, k = place(c["params"], jopt.init(c["params"]), c["jmem"],
                               c["keys"][0])
            for i, tb in enumerate(c["batches"]):
                jb = JL.Batch(*(jnp.asarray(x.numpy()) for x in tb))
                p, o, m, k, loss = jstep(p, o, m, k, place_batch(jb))
                if i < 2:
                    assert np.array_equal(np.asarray(k), c["keys"][i + 1])
                mu = _port(o[0].mu)
                jax_out.append(dict(
                    loss=float(loss), params=_port(p),
                    grads={n: _adam_grads(g, None if mu_prev is None
                                          else mu_prev[n])
                           for n, g in mu.items()},
                    memory={f: np.asarray(getattr(m, f)) for f in m._fields}))
                mu_prev = mu
        c["jax"] = jax_out
        for mesh, c in cases.items():
            c["plain"] = D.replay_plain(c["spec"], torch.device("cpu"))[0]
            outs = [(c["work"], int(np.prod(mesh)))]
            if mesh == (2, 2, 2):
                outs.append((c["restore_work"], 2))
            got = _join(procs[mesh], *outs)
            c["ranks"] = [r[0] for r in got[0]]
            if mesh == (2, 2, 2):
                c["restored"] = got[1]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(cases=cases, ev=ev, nodes=nodes)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_replicas_equal_and_collectives_golden(sptp, mesh):
    """Every rank's whole state (gathered from its shards) bitwise equal,
    the memory blocks of each sp index equal across dp indices, and each
    step's collectives a rank the golden's."""
    ranks = sptp["cases"][mesh]["ranks"]
    D.assert_ranks_equal([[r] for r in ranks])
    golden = GOLDEN_COLLECTIVES[golden_kind(M.Mesh(*mesh, rank=0))]
    by_shard = {}
    for r in ranks:
        assert all(c["by_kind"] == golden for c in r["comm"]), r["comm"]
        local = r["local"]
        key = local["coords"][1]
        if key in by_shard:
            assert torch.equal(by_shard[key]["memory"], local["memory"])
            assert torch.equal(by_shard[key]["msg_buf"], local["msg_buf"])
        by_shard[key] = local
    assert len(by_shard) == mesh[1]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_mesh_matches_the_one_process_step(sptp, mesh):
    c = sptp["cases"][mesh]
    got, want = c["ranks"][0], c["plain"]
    settled = _settled(want)
    for k in (1, 2, 3):
        _hold(_record(got, k), _record(want, k), settled, k)


def test_mean_aggregator_writes_across_owners(sptp):
    """The mean aggregator at (2,2,1): step 2's node of sp shard 1's rows,
    the target of the first dp index's row 1 and the source of the last
    one's row B - 1, gets the 1-process step's message (the mean of the
    two) in its owner's block only, stamped with the time of the last of
    them in the global order ``[src.., tgt..]``: the target's."""
    c = sptp["cases"][MEAN_MESH]
    b2, b = c["batches"][1], c["b"]
    x = int(b2.dst[1])
    assert int(b2.src[b - 1]) == x
    mem = c["ranks"][0]["states"][2]["memory"]
    ref = c["plain"]["states"][2]["memory"]
    assert bool(mem["msg_valid"][x])
    assert float(mem["msg_ts"][x]) == float(b2.ts[1]) == \
        float(ref["msg_ts"][x])
    np.testing.assert_allclose(mem["msg_buf"][x].numpy(),
                               ref["msg_buf"][x].numpy(), rtol=2e-4,
                               atol=1e-5)
    lo, rows = M.row_block(sptp["nodes"], 2, 1)
    for r in c["ranks"]:
        if r["local"]["coords"][1] == 1:
            assert torch.equal(r["local"]["msg_buf"][x - lo],
                               mem["msg_buf"][x])


def test_2x2x2_matches_jax_sharded_step(sptp):
    """Each step against JAX's (2,2,2) step: the loss, the parameters and
    the memory at the tolerances above; the gradients at twice theirs
    (rtol 2e-4, atol 2e-5 of the tensor's largest, 2e-4 for the time
    encoder): this comparison chains two float32 programs, the sharded
    step to the 1-process one (held at the tolerances above in
    ``test_mesh_matches_the_one_process_step``) and that to JAX's, and on
    the GRU's recurrent weight at step 3, the first step with a memory to
    read, the gradient's largest entry parts them by 4.6e-5 (the port's
    1-process step from JAX's) plus 6.8e-5 (the sharded step from the
    1-process one) of itself: round-off of a sum that cancels, which
    JAX's own (2,2,2) and 1-device steps part by 8.8e-6."""
    c = sptp["cases"][(2, 2, 2)]
    got = c["ranks"][0]
    settled = _settled(got)
    for k, ref in enumerate(c["jax"], start=1):
        rec = _record(got, k)
        for name, g in rec["grads"].items():
            want = np.asarray(ref["grads"][name])
            scale = max(float(np.abs(want).max()), 1e-30)
            atol = (2e-4 if name.startswith("time_encoder.") else 2e-5)
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                       atol=atol * scale, err_msg=name)
        _hold(rec, ref, settled, k, grads=False)


def test_memory_write_across_owners(sptp):
    """Step 2's node of sp shard 1's rows at (2,2,2): the target of the
    first dp index's row 1 (global position B + 1) beats the source of the
    last dp index's row B - 1; its message sits in shard 1's block only."""
    c = sptp["cases"][(2, 2, 2)]
    b2, b = c["batches"][1], c["b"]
    x = int(b2.dst[1])
    assert int(b2.src[b - 1]) == x
    lo, rows = M.row_block(sptp["nodes"], 2, 1)
    assert lo <= x < lo + rows
    mem = c["ranks"][0]["states"][2]["memory"]
    assert bool(mem["msg_valid"][x])
    assert float(mem["msg_ts"][x]) == float(b2.ts[1])
    ref = c["plain"]["states"][2]["memory"]
    np.testing.assert_allclose(mem["msg_buf"][x].numpy(),
                               ref["msg_buf"][x].numpy(), rtol=2e-4,
                               atol=1e-5)
    d = c["dn"]
    assert not np.allclose(ref["msg_buf"][x][:d], ref["msg_buf"][x][d:2 * d])
    owner = [r for r in c["ranks"] if r["local"]["coords"][1] == 1]
    other = [r for r in c["ranks"] if r["local"]["coords"][1] == 0]
    assert all(torch.equal(r["local"]["msg_buf"][x - lo],
                           mem["msg_buf"][x]) for r in owner)
    assert all(r["local"]["msg_buf"].shape[0] == rows for r in other)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_each_rank_holds_only_its_shards(sptp, mesh):
    """At rest: ``ceil(num_nodes/sp)`` rows of ``memory`` and ``msg_buf``
    (the flags, times and last updates whole); ``out/tp`` rows of each
    tp-sharded weight and of its Adam moments, the tensors that JAX's
    ``shard_params_tp`` places on ``P(None, 'tp')``."""
    c = sptp["cases"][mesh]
    nodes, (dp, sp, tp) = sptp["nodes"], mesh
    rows = -(-nodes // sp)
    whole = c["ranks"][0]["states"][3]["params"]
    names = convert.tp_sharded_names(
        {k: tuple(v.shape) for k, v in whole.items()}, tp)
    assert bool(names) == (tp > 1)
    for r in c["ranks"]:
        shapes = r["local"]["shapes"]
        mem = shapes["memory"]
        assert mem["memory"][0] == mem["msg_buf"][0] == rows
        assert mem["last_update"] == mem["msg_valid"] == (nodes,)
        assert sorted(shapes["params"]) == sorted(names)
        for name in names:
            want = (whole[name].shape[0] // tp,) + tuple(whole[name].shape[1:])
            assert shapes["params"][name] == want
            assert shapes["moments"][name] == dict(exp_avg=want,
                                                   exp_avg_sq=want)
    if tp > 1:
        assert sorted(names) == sorted(_jax_tp_names(c["params"]))


def _jax_tp_names(params):
    """The port's names of the tensors JAX's ``shard_params_tp`` places on
    ``P(None, 'tp')`` on a tp = 2 mesh (a GRU weight where its gate
    kernels are)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from tempme_tpu.parallel import mesh as JM
    jmesh = JM.make_mesh(1, 1, 2, devices=jax.devices()[:2])
    placed = JM.shard_params_tp(params, jmesh)
    marks = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(x.sharding.spec == P(None, "tp")),
                          np.float32), placed)
    sd = convert.flax_to_state_dict(marks)
    return [k for k, v in sd.items() if bool((v == 1).all())]


def test_tp_shards_cut_and_join_a_state_dict(sptp):
    c = sptp["cases"][(1, 1, 2)]
    sd = _port(c["params"])
    names = convert.tp_sharded_names({k: tuple(v.shape)
                                      for k, v in sd.items()}, 2)
    parts = [convert.tp_shard_state_dict(sd, 2, t) for t in range(2)]
    assert parts[1]["memory_updater.weight_ih"].shape[0] == 48
    assert torch.equal(parts[1]["affinity_score.fc2.weight"],
                       sd["affinity_score.fc2.weight"])
    back = convert.tp_unshard_state_dict(parts, names)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_coords_are_the_jax_layout(n):
    """Rank r's (d, s, t) is r's place in ``np.arange(n).reshape(dp, sp,
    tp)`` for ``factorize(n)``, the device layout of JAX's
    ``make_mesh``; each subgroup holds the ranks that share the other
    coordinates."""
    import jax
    from tempme_tpu.parallel import mesh as JM
    shape = M.factorize(n)
    arr = np.arange(n).reshape(shape)
    ids = np.vectorize(lambda d: d.id)(
        JM.make_mesh(*shape, devices=jax.devices()[:n]).devices)
    first = jax.devices()[0].id
    np.testing.assert_array_equal(ids - first, arr)
    groups = M.mesh_groups(*shape)
    for r in range(n):
        d, s, t = M.mesh_coords(r, *shape)
        assert arr[d, s, t] == r
        assert [int(x) for x in arr[:, s, t]] in groups["dp"]
        assert [int(x) for x in arr[d, :, t]] in groups["sp"]
        assert [int(x) for x in arr[d, s, :]] in groups["tp"]
        assert sorted(arr[:, :, t].ravel().tolist()) in groups["peers"]


def test_checkpoint_restores_at_other_meshes(sptp):
    """The (2,2,2) checkpoint after step 2 (whole tensors) restores on one
    process and at (1,2,1), and step 3 equals (2,2,2)'s step 3."""
    c = sptp["cases"][(2, 2, 2)]
    ckpt = os.path.join(c["work"], "run0")
    assert C.latest_step(ckpt) == 2
    want = _record(c["ranks"][0], 3)
    run = dict(c["spec"]["runs"][0], state=None)
    g, feats, dst, model, opt, mem = D.build_run(c["spec"], run, "cpu")
    step, _, place_batch = make_sharded_tgn_train_step(
        model, g, feats, dst, c["n"], opt, M.make_mesh())
    gen = torch.Generator()
    blob = C.restore_sharded(ckpt, 2, step.state_dict(mem, gen))
    assert blob["memory"]["memory"].shape[0] == sptp["nodes"]
    mem = step.load_state_dict(blob, gen)
    mem, aux = step(mem, place_batch(c["batches"][2]), c["draws"][2])
    got = dict(D.snapshot(model, opt, mem, gen), loss=float(aux["loss"]))
    settled = {n: np.ones(p.shape, bool) for n, p in got["params"].items()}
    _hold(got, want, settled, 1)
    restored = c["restored"]
    D.assert_ranks_equal([[r[0]] for r in restored])
    settled = {n: np.ones(p.shape, bool) for n, p in got["params"].items()}
    _hold(_record(restored[0][0], 1), want, settled, 1)
    assert restored[1][0]["local"]["shapes"]["memory"]["memory"][0] == \
        -(-sptp["nodes"] // 2)
