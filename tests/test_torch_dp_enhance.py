"""The port's data-parallel enhance train step on 2 gloo ranks on the CPU.

One subprocess (its own timeout) starts 2 ranks, one torch thread a
rank, which replay two runs of three global steps (``parallel/dryrun.py``)
of the joint predictor and base step at node dim 16, about 32 nodes,
batch 8 (4 a rank), 4 neighbours, 12 walks a side, hid_dim 16, float32.
The three batches: an ordinary one; a skewed one, whose rank-0 rows join
nodes of degree 1 and rank-1 rows nodes of degree 400 (the walk weights'
degree table) and cut 5,000 time units later (so each rank's own time
deltas' ``std``, degrees' mean and ``std`` are far from the global
batch's); one with its last 2 rows padded, both on rank 1 (enhance's loss
counts them, as the JAX step does).

* run A: a ``TempME`` predictor and a TGN at dropout 0, from flax weights
  (``utils/convert.py``; normal draws in the structure of the JAX models'
  ``eval_shape`` trees), with the JAX step's supports and walks replayed
  (its ``k_samp``). Held against JAX's ``make_sharded_enhance_train_step``
  on a dp = 2 mesh of the virtual CPU devices, and against the port's
  1-process step, memory included (each rank writes it from the
  all-gathered batch rows).
* run B: a ``TempME`` predictor and a GraphMixer at dropout 0.1, the draws
  from the generator, against the port's 1-process step.

Tolerances (``parallel/dryrun.py::hold_step``). Against the port's
1-process step, ``tests/test_torch_dp.py``'s: the loss rtol 1e-5; every
gradient rtol 1e-4, atol 1e-5 of its tensor's largest; the parameters
after Adam rtol 1e-5, atol 1e-6 where the gradient stayed at least 1e-4
of its tensor's largest in every step so far, and every parameter to the
float64 replay of Adam from its previous state with the port's own
gradient, rtol 1e-5, atol 1e-6 (``utils/optim.py``); each memory field
rtol 2e-4, atol 1e-5, ``msg_valid`` exactly. Against JAX's sharded step,
both the 2 ranks and the 1-process step (``JAX_TOL``; the readings are
each limit's largest excess over its rtol part, the same on both paths
to 3 digits): every gradient atol 2e-4 of its tensor's largest (read:
9.5e-5, ``attn_layers.1.attn.wv_time.weight`` at step 2, and 8.5e-5 the
time encoder's frequencies), the settled parameters atol 5e-6 (read:
2.48e-6, ``message_mlp.2.weight`` at step 3), each memory field atol 5e-4
(read: 3.43e-4 in ``msg_buf``, whose largest is 5.1, at step 3): the
skewed batch's time deltas of 5,000 turn round-off in the time encoder's
frequencies into time encodings of the stored messages that part, and
each step starts from the last one's state. Every parameter takes a
gradient (zeros where the step did not reach it), so Adam keeps one step
count.

The JAX package is imported inside the fixture only.
"""
import numpy as np
import pytest
import torch

from tempme_tpu_torch.parallel import dryrun as D
from tempme_tpu_torch.parallel.train import GOLDEN_COLLECTIVES
from tempme_tpu_torch.train import loops as L
from tests.test_torch_dp import B, DE, DN, LR, N, W, _adam_grads, _join, \
    _launch
from tests.test_torch_dp_explain import (PLAIN_TOL, REC, SKEW,
                                         explainer_support, jax_tree,
                                         walk_draws)

HID = 16
LOW, HIGH = 1.0, 400.0       # the degree table's two values
HUB = 16                     # nodes from HUB on have degree HIGH
MEMORY_TOL = dict(mem_rtol=2e-4, mem_atol=1e-5)
JAX_TOL = dict(grad_atol=2e-4, param_atol=5e-6, mem_atol=5e-4)


def stream():
    """The stream, its features, the degree table and the three global
    batches: step 2's rank-0 rows join nodes below ``HUB``, its rank-1
    rows nodes from ``HUB`` on, ``SKEW`` later."""
    from tests.conftest import make_events
    ev = make_events(num_events=200, num_nodes=32, seed=6)
    r = np.random.RandomState(7)
    node = r.randn(ev.num_nodes, DN).astype(np.float32)
    edge = r.randn(ev.num_edges, DE).astype(np.float32)
    node[0] = edge[0] = 0.0
    deg = np.where(np.arange(ev.num_nodes) < HUB, LOW, HIGH).astype(
        np.float32)
    deg[0] = 0.0

    def rows(idx):
        return [ev.src[idx].copy(), ev.dst[idx].copy(), ev.ts[idx].copy(),
                ev.e_idx[idx].copy(), np.ones(B, bool)]
    late = np.arange(100, len(ev))
    low = late[(ev.src[late] < HUB) & (ev.dst[late] < HUB)][:B // W]
    high = late[(ev.src[late] >= HUB) & (ev.dst[late] >= HUB)][:B // W]
    b1, b2, b3 = (rows(np.arange(100, 100 + B)),
                  rows(np.r_[low, high]), rows(np.arange(140, 140 + B)))
    b2[2][B // W:] += SKEW
    b3[4][B - 2:] = False
    for c in range(4):                 # padded rows repeat the first event
        b3[c][B - 2:] = b3[c][0]
    batches = [L.Batch(*(torch.from_numpy(np.asarray(c)) for c in b))
               for b in (b1, b2, b3)]
    return ev, node, edge, deg, batches


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Runs A and B on one pair of ranks, started before JAX's step runs
    (run A's draws come from JAX's keys alone); then JAX's sharded step
    and the 1-process steps."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import optax
    from tempme_tpu.explain import tempme as JE
    from tempme_tpu.parallel import mesh as JM
    from tempme_tpu.parallel.train import make_sharded_enhance_train_step
    from tempme_tpu.train import loops as JL
    from tempme_tpu.train import temp_exp_main as JX
    from tempme_tpu_torch.utils.convert import flax_to_state_dict
    from tests.test_torch_dp import _jax_model
    from tests.test_torch_graph_sampler import to_torch_events

    def port(tree, prefix=""):
        return {prefix + k: v for k, v in flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("dp_enhance"))
    ev, node, edge, deg, batches = stream()
    nodes, dst = ev.num_nodes, np.unique(ev.dst)
    pred = dict(node_dim=DN, edge_dim=DE, hid_dim=HID)
    jm, jg, jfeats, jmem, params = _jax_model(ev, node, edge, nodes)
    jg = dataclasses.replace(jg, dense_ts=None, dense_node=None,
                             dense_eid=None)
    jp = JE.TempME(node_dim=DN, edge_dim=DE, hid_dim=HID, base_type="tgn",
                   dropout=0.0)
    b0 = JL.Batch(*(jnp.asarray(x.numpy()) for x in batches[0]))
    key = jax.random.PRNGKey(11)
    jdst = jnp.asarray(dst)

    def init():
        _, subs, walks = JX.sample_explainer_inputs(jg, key, b0, jdst, N)
        return jp.init({"params": key}, jfeats, walks[0], b0.ts, subs[0],
                       method=JE.TempME.init_all)
    pparams = jax_tree(jax.eval_shape(init), seed=9)
    keys = [jax.random.PRNGKey(5)]
    for _ in range(2):
        keys.append(jax.random.split(keys[-1], 4)[3])
    draws = [L.EnhanceDraws(explainer_support(k_samp, B, N, len(dst)),
                            walk_draws(k_samp, B, N))
             for k_samp in (jax.random.split(k, 4)[0] for k in keys)]
    spec = D.make_spec(
        to_torch_events(ev), nodes, ev.num_edges, node, edge, dst, N,
        [D.make_run(dict(pred, base_type="tgn", dropout=0.0), batches, LR,
                    draws=draws, state={"params": {
                        **port(pparams, "predictor."),
                        **port(params, "base.")}},
                    record=REC, kind="enhance", base=D.make_base(
                        "tgn", dict(node_dim=DN, edge_dim=DE,
                                    num_nodes=nodes, n_layers=2, n_head=2,
                                    dropout=0.0,
                                    compute_dtype=torch.float32))),
         D.make_run(dict(pred, base_type="graphmixer", dropout=0.1),
                    batches, LR, seed=3, record=REC, kind="enhance",
                    base=D.make_base("graphmixer", dict(
                        node_dim=DN, edge_dim=DE, num_tokens=N,
                        num_layers=2, dropout=0.1)))],
        node_degree=deg)
    proc = _launch(spec, work)
    try:
        jopt = optax.adam(LR)
        mesh = JM.make_mesh(2, 1, 1, devices=jax.devices()[:2])
        base = JX.LoadedBase("tgn", jm, params, jmem, {})
        both = {"base": params, "predictor": pparams}
        with mesh:
            jstep, place, place_batch = make_sharded_enhance_train_step(
                base, jp, jg, jfeats, jdst, N, jnp.asarray(deg), jopt, mesh)
            p, o, m, k = place(both, jopt.init(both), jmem, keys[0])
            jax_out, mu_prev = [], None
            for i, tb in enumerate(batches):
                jb = JL.Batch(*(jnp.asarray(x.numpy()) for x in tb))
                p, o, m, k, loss = jstep(p, o, m, k, place_batch(jb))
                if i < 2:
                    assert np.array_equal(np.asarray(k), keys[i + 1])
                mu = {**port(o[0].mu["predictor"], "predictor."),
                      **port(o[0].mu["base"], "base.")}
                jax_out.append(dict(
                    loss=float(loss),
                    params={**port(p["predictor"], "predictor."),
                            **port(p["base"], "base.")},
                    grads={n: _adam_grads(g, None if mu_prev is None
                                          else mu_prev[n])
                           for n, g in mu.items()},
                    memory={f: np.asarray(getattr(m, f))
                            for f in m._fields}))
                mu_prev = mu
        plain = D.replay_plain(spec, torch.device("cpu"))
        ranks = _join(proc, work)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return dict(spec=spec, ranks=ranks, plain=plain, jax=jax_out,
                batches=batches, deg=deg)


def hold(got, want, **tol):
    """``got``'s state after each step (a run's record, recording every
    step from 0) against ``want`` (a state with its loss, gradients,
    parameters and memory a step), by ``dryrun.hold_step`` at
    ``PLAIN_TOL``, ``MEMORY_TOL`` and ``tol``."""
    settled = {}
    for k, ref in enumerate(want, start=1):
        st = D.at_step(got, k)
        assert all(g is not None for g in st["grads"].values())
        D.hold_step(st, ref, got["states"][k - 1], f"step {k}", LR,
                    exact_zero=(), settled=settled,
                    **{**PLAIN_TOL, **MEMORY_TOL, **tol})


def _plain(res):
    return [D.at_step(res, k) for k in (1, 2, 3)]


def test_ranks_end_every_step_bitwise_equal(dp):
    D.assert_ranks_equal(dp["ranks"])


@pytest.mark.parametrize("run,golden", [(0, "enhance-tgn"),
                                        (1, "enhance-graphmixer")])
def test_collectives_match_the_golden(dp, run, golden):
    for rank in dp["ranks"]:
        for comm in rank[run]["comm"]:
            assert comm["by_kind"] == GOLDEN_COLLECTIVES[golden]


@pytest.mark.parametrize("run", [0, 1])
def test_two_ranks_match_the_one_process_step(dp, run):
    got, want = dp["ranks"][0][run], dp["plain"][run]
    hold(got, _plain(want))
    for k in (1, 2, 3):
        assert torch.equal(got["states"][k]["generator"],
                           want["states"][k]["generator"])


def test_two_ranks_match_jax_sharded_step(dp):
    hold(dp["ranks"][1][0], dp["jax"], **JAX_TOL)


def test_one_process_step_matches_jax_sharded_step(dp):
    """The port's 1-process step on the same global batches and draws, at
    the same limits as the 2 ranks."""
    hold(dp["plain"][0], dp["jax"], **JAX_TOL)


def test_skewed_batch_needs_the_global_statistics(dp):
    """Step 2's halves: the walks' degrees and time deltas differ by
    orders of magnitude between the ranks, so each rank's own statistics
    are far from the global batch's."""
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.explain.tempme import walk_degree, walk_delta
    from tempme_tpu_torch.train.temp_exp_main import sample_explainer_inputs
    spec, b2 = dp["spec"], dp["batches"][1]
    g = build_temporal_graph(spec["events"], spec["num_nodes"],
                             spec["num_edges"], device="cpu")
    _, _, walks = sample_explainer_inputs(
        g, b2, torch.from_numpy(spec["dst_table"]), N,
        spec["runs"][0]["draws"][1])
    half = B // W
    avg = walk_degree(walks[0].nodes, torch.from_numpy(dp["deg"]))
    delta = walk_delta(walks[0].ts, b2.ts)
    # a rank's own mean moves the degree sigmoid's argument by a quarter
    # of the global std and more; its own delta std is a tenth of the
    # global one
    for part in (avg[:half], avg[half:]):
        assert abs(part.mean() - avg.mean()) > 0.25 * avg.std()
    assert delta.std() > 10 * delta[:half].std()
    np.testing.assert_allclose(dp["ranks"][0][0]["loss"][1],
                               dp["jax"][1]["loss"], rtol=1e-5)


def test_padded_rows_count_in_the_loss(dp):
    """Step 3's last 2 rows (rank 1's) are padding; enhance's loss is the
    unmasked mean of each BCE over all B rows, as JAX's step takes it."""
    mask = dp["batches"][2].mask
    assert mask[:B // W].all() and int(mask[B // W:].sum()) == B // W - 2
    for run in (0, 1):
        np.testing.assert_allclose(dp["ranks"][1][run]["loss"][2],
                                   dp["plain"][run]["loss"][2], rtol=1e-5)
    np.testing.assert_allclose(dp["ranks"][1][0]["loss"][2],
                               dp["jax"][2]["loss"], rtol=1e-5)
