"""The port's mesh, process and input-pipeline helpers against the JAX
package, and the data-parallel step on one process; no process is launched
(``tests/test_torch_dp.py`` runs the ranks).

``factorize`` and ``local_slice`` equal JAX's; the ranks' slices of
``iter_global_batches``, concatenated in rank order, equal the JAX
package's global batches (one process, a dp mesh of the virtual CPU
devices), exactly; the explainer's and enhance's steps refuse ``sp`` or
``tp`` above 1, the TGN step a neighbour count that ``sp`` does not
divide, and nccl a shared card. On one process the sharded step equals
``TGNTrainStep`` bit for bit (no collective runs), padded rows and dropout
included. Each sharded step
(TGN, explainer, TGAT explainer, enhance) makes the committed golden's
collectives by kind (``utils/debug.py::count_collectives``) on a stand-in
process group of 2 that runs in this process; a drifted golden raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_graph_sampler import to_torch_events
from tempme_tpu import config as JC
from tempme_tpu.parallel import mesh as JM
from tempme_tpu.parallel import multihost as JH
from tempme_tpu_torch import config as TC
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgn import TGN, init_memory_state
from tempme_tpu_torch.parallel import checkpoint as C
from tempme_tpu_torch.parallel import mesh as M
from tempme_tpu_torch.parallel import multihost as H
from tempme_tpu_torch.parallel import train as P
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.train import loops as L


@pytest.mark.parametrize("n", range(1, 9))
def test_factorize_matches_jax(n):
    assert M.factorize(n) == JM.factorize(n)


def test_local_slice_matches_jax():
    for b, w in ((8, 1), (8, 2), (12, 3), (16, 4), (256, 8)):
        for r in range(w):
            assert H.local_slice(b, r, w) == JH.local_slice(b, r, w)
    with pytest.raises(ValueError, match="split"):
        H.local_slice(10, 0, 4)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_iter_global_batches_concatenate_to_jax(drop_remainder):
    ev = make_events(num_events=53, num_nodes=20, seed=4)   # 53 = 6 * 8 + 5
    mesh = JM.make_mesh(2, 1, 1, devices=jax.devices()[:2])
    ref = list(JH.iter_global_batches(ev, 8, mesh, shuffle=True, seed=3,
                                      drop_remainder=drop_remainder))
    assert len(ref) == (6 if drop_remainder else 7)
    for w in (1, 2, 4):
        ranks = [list(H.iter_global_batches(
            to_torch_events(ev), 8, True, 3, drop_remainder, device="cpu",
            rank=r, world_size=w)) for r in range(w)]
        assert all(len(x) == len(ref) for x in ranks)
        for i, want in enumerate(ref):
            for f in L.Batch._fields:
                got = torch.cat([getattr(x[i], f) for x in ranks]).numpy()
                np.testing.assert_array_equal(got,
                                              np.asarray(getattr(want, f)))
    assert not np.asarray(ref[-1].mask).all() or drop_remainder


@pytest.mark.parametrize("kind,sp,tp", [
    ("explainer", 2, 1), ("explainer", 1, 2), ("enhance", 2, 1),
    ("enhance", 2, 2)])
def test_sp_and_tp_raise(kind, sp, tp):
    """The explainer's and enhance's sharded steps refuse sp or tp above
    1 (their sp and tp wait for A16d); the mesh itself takes them."""
    from tempme_tpu_torch.parallel import dryrun as D
    walk = D.tiny_walk_spec(1)
    run = next(r for r in walk["runs"] if r["kind"] == kind)
    built = D._build(walk, run, "cpu")
    with pytest.raises(ValueError, match="A16d"):
        built["step"](M.Mesh(1, sp, tp, 0, group=object()))
    assert M.Mesh(1, sp, tp, 0).shape == {"dp": 1, "sp": sp, "tp": tp}


def test_tgn_step_refuses_n_not_divisible_by_sp():
    """The sp axis cuts each hop's n neighbours into contiguous chunks."""
    ev, step = _setup(0.0)
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        step(lambda *a: P.make_sharded_tgn_train_step(
            *a, M.Mesh(1, 2, 1, 0, group=object())))


def test_mesh_without_a_group_is_one_process():
    mesh = M.make_mesh()
    assert (mesh.shape, mesh.rank, mesh.group) == (
        {"dp": 1, "sp": 1, "tp": 1}, 0, None)
    assert M.AXES == JM.AXES
    with pytest.raises(ValueError, match="dp=2"):
        M.make_mesh(2)


def test_nccl_refuses_a_shared_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="gloo"):
        H.rank_device("nccl", 1)
    seats = [("host", "GPU-0"), ("host", "GPU-0")]
    with pytest.raises(ValueError, match="gloo"):
        H.check_placement("nccl", seats)
    H.check_placement("gloo", seats)
    H.check_placement("nccl", [("host", "GPU-0"), ("host", "GPU-1")])
    with pytest.raises(ValueError, match="gloo"):
        H.rank_device("nccl", 0, "cpu")
    with pytest.raises(ValueError, match="backend"):
        H.rank_device("mpi", 0, "cpu")
    assert H.rank_device("gloo", 3, "cpu") == torch.device("cpu")


def test_parallel_config_matches_jax():
    assert [f.name for f in dataclasses.fields(TC.ParallelConfig)] == \
        [f.name for f in dataclasses.fields(JC.ParallelConfig)]
    cfg = TC.ParallelConfig(dp=4, tp=2)
    assert cfg.n_devices == JC.ParallelConfig(dp=4, tp=2).n_devices == 8
    assert TC.Config().parallel == TC.ParallelConfig()


def _setup(dropout):
    ev = make_events(num_events=160, num_nodes=24, seed=5)
    g = build_temporal_graph(to_torch_events(ev), device="cpu")
    r = np.random.RandomState(0)
    feats = Features(torch.from_numpy(r.randn(g.num_nodes, 8).astype(
        np.float32)), torch.from_numpy(r.randn(g.num_edges, 4).astype(
            np.float32)))
    dst = torch.from_numpy(np.unique(ev.dst)).long()

    def step(make):
        model = TGN(8, 4, g.num_nodes, dropout=dropout, device="cpu",
                    seed=1)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        return make(model, g, feats, dst, 3, opt), model
    return ev, step


def test_shard_draws_splits_every_draw_by_batch_row():
    ev, step = _setup(0.1)
    (plain, _) = step(T.make_tgn_train_step)
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = plain.draw(gen, 8)
    flat = jax.tree_util.tree_leaves(draws)
    parts = [jax.tree_util.tree_leaves(P.shard_draws(draws, 4, r))
             for r in range(4)]
    assert len(flat) == 1 + 3 * 2 + 3 * 2 * 2
    for i, whole in enumerate(flat):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole)
        assert parts[1][i].shape[0] == whole.shape[0] // 4


def test_grads_flatten_with_a_missing_gradient():
    a, b = torch.nn.Parameter(torch.ones(2, 3)), torch.nn.Parameter(
        torch.ones(4))
    a.grad = torch.arange(6.0).reshape(2, 3)
    flat = P.flatten_grads([a, b])
    assert flat.tolist() == [0, 1, 2, 3, 4, 5, 0, 0, 0, 0, 1, 0]
    grads = flat[:-2]
    P.unflatten_grads([a, b], grads * 2, [True, False])
    assert torch.equal(a.grad, 2 * torch.arange(6.0).reshape(2, 3))
    assert b.grad is None
    P.unflatten_grads([a, b], grads, [True, True])  # another rank had b's
    assert torch.equal(b.grad, torch.zeros(4))


def test_sharded_step_on_one_process_is_the_plain_step(tmp_path):
    """Three steps (the third with padded rows), dropout 0.1, the draws
    from equal generators; then a save and restore at world size 1."""
    ev, step = _setup(0.1)
    plain, m1 = step(T.make_tgn_train_step)
    (dp, place, place_batch), m2 = step(
        lambda *a: P.make_sharded_tgn_train_step(*a, M.make_mesh()))
    mem1 = mem2 = init_memory_state(m1.num_nodes, m1.memory_dim,
                                    m1.raw_message_dim, device="cpu")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    mem2 = place(mem2, g2)
    batches = L.stack_batches(to_torch_events(ev), 8, True, 0, "cpu")
    for i in range(3):
        b = L.Batch(*(x[i] for x in batches))
        if i == 2:
            b = b._replace(mask=torch.arange(8) < 5)
        mem1, a1 = plain(mem1, b, plain.draw(g1, 8))
        mem2, a2 = dp(mem2, place_batch(b), dp.draw(g2, 8))
        assert torch.equal(a1["loss"], a2["loss"])
        assert all(torch.equal(x, y) for x, y in zip(mem1, mem2))
        assert all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                     m2.parameters()))
    assert dp.comm.calls == 0
    assert dp.present == dp.local == [True] * len(dp.params)
    dp.params[0].grad = None            # read once: a change is an error
    with pytest.raises(RuntimeError, match="changed between steps"):
        dp._check_local()
    C.save_sharded(str(tmp_path), dp.state_dict(mem2, g2), 3)
    assert C.latest_step(str(tmp_path)) == 3
    assert C.latest_step(str(tmp_path / "none")) is None
    blob = C.restore_sharded(str(tmp_path), 3, dp.state_dict(mem2, g2))
    assert blob["step"] == 3
    mem3 = dp.load_state_dict(blob, torch.Generator())
    assert all(torch.equal(x, y) for x, y in zip(mem2, mem3))
    with pytest.raises(ValueError, match="lacks"):
        C.restore_sharded(str(tmp_path), 3, {"other": torch.zeros(1)})


class _TwoRanks:
    """A stand-in for ``torch.distributed`` with 2 ranks whose second rank
    holds the same rows: an all-gather repeats the tensor, an all-reduce
    doubles it. It counts nothing itself: the step counts its calls."""

    @staticmethod
    def all_gather(parts, x, group=None):
        for p in parts:
            p.copy_(x)

    @staticmethod
    def all_reduce(x, group=None):
        x.mul_(2)


@pytest.mark.parametrize("run,golden", [
    (1, "tgn"), (3, "explainer"), (5, "tgat-explainer"), (7, "enhance-tgn")])
def test_collectives_match_the_goldens(run, golden, monkeypatch):
    from tempme_tpu_torch.parallel import dryrun as D
    from tempme_tpu_torch.utils import debug
    monkeypatch.setattr(P, "dist", _TwoRanks)
    spec = D.tiny_spec(2)
    spec = dict(spec, runs=spec["runs"] + D.tiny_walk_spec(2)["runs"],
                node_degree=D.tiny_walk_spec(2)["node_degree"])
    r = spec["runs"][run]
    built = D._build(spec, r, "cpu")
    step, _, place_batch = built["step"](M.Mesh(2, 1, 1, 0, group=object()))
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = place_batch(r["batches"][0])
    draws = step.draw(gen, r["batches"][0].src.shape[0])
    if r["kind"] in ("explainer", "tgat-explainer"):
        step(batch, draws)
    else:
        step(built["mem"], batch, draws)
    assert debug.count_collectives(step) == P.GOLDEN_COLLECTIVES[golden]
    debug.assert_collectives(step, P.GOLDEN_COLLECTIVES[golden], golden)
    drifted = dict(P.GOLDEN_COLLECTIVES[golden])
    drifted["all_reduce"] += 1
    with pytest.raises(AssertionError, match="drifted in " + golden):
        debug.assert_collectives(step, drifted, golden)
