"""The port's data-parallel explainer train step on 2 gloo ranks on the CPU.

One subprocess (its own timeout) spawns 2 ranks, one torch thread each,
which replay three global steps (``parallel/dryrun.py``) at node dim 16,
about 32 nodes, batch 8 (4 a rank), 4 neighbours, 12 walks a side,
hid_dim 16, float32. The three batches: an ordinary one; a skewed one,
whose rank-1 rows cut 5,000 time units after rank 0's (so the motif
attention's time deltas on the two halves differ by orders of magnitude,
and a rank's own ``std`` is far from the global one); one with its last 2
rows padded, both on rank 1 (the explainer's loss counts them, as the JAX
step does).

* run A: ``TempME`` on a frozen TGN at dropout 0, both from flax weights
  (``utils/convert.py``; normal draws in the structure of the JAX models'
  ``eval_shape`` trees), with the JAX step's draws replayed: the supports
  and walks from its ``k_samp``, the Beta sample's gamma draws recorded
  from ``jax.random.gamma`` inside JAX's sharded step (a debug callback
  sees the global array). Held against JAX's
  ``make_sharded_explainer_train_step`` on a dp = 2 mesh of the virtual
  CPU devices, and against the port's 1-process step.
* run B: ``TempME`` on a frozen GraphMixer at dropout 0, the gamma draws
  from the generator (each rank draws on the global shapes from the
  all-gathered probabilities).
* run C: ``TempMETGAT`` on a frozen 2-layer TGAT at dropout 0.1 (its
  attention masks, shared by the batch rows, stay whole on every rank),
  the gamma draws from the generator.

Tolerances (``parallel/dryrun.py::hold_step``). Against the port's
1-process step, ``tests/test_torch_dp.py``'s: the loss rtol 1e-5; every
gradient rtol 1e-4, atol 1e-5 of its tensor's largest (an attention's key
bias, zero in exact arithmetic, 1e-5 of the model's largest); the
parameters after Adam rtol 1e-5, atol 1e-6 where the gradient stayed at
least 1e-4 of its tensor's largest in every step so far, and every
parameter to the float64 replay of Adam from its previous state with the
port's own gradient, rtol 1e-5, atol 1e-6 (``utils/optim.py``). Against
JAX's sharded step, both the 2 ranks and the 1-process step: the same,
but every gradient atol 5e-4 of its tensor's largest (``JAX_GRAD_ATOL``:
the small ``dep_d3.bias``, largest 3.4e-4, reaches JAX's step-2 gradient
only to 2.63e-4 of that beyond the rtol, on both paths: float32 sums in
another order through the gamma derivative and the base's backward,
which Adam carries into the next step's gradients). Both ranks end every
step with the same bytes and the generator's state.

The JAX package is imported inside the fixture only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tempme_tpu_torch.parallel import dryrun as D
from tempme_tpu_torch.parallel.train import GOLDEN_COLLECTIVES
from tempme_tpu_torch.train import loops as L
from tempme_tpu_torch.train.temp_exp_main import ExplainerDraws
from tests.test_torch_dp import B, DE, DN, LR, N, W, _adam_grads, _join, \
    _launch

HID = 16
WALKS = N * 3
SKEW = 5000.0                # rank 1's cut times after rank 0's, step 2
REC = (0, 1, 2, 3)           # the states each run records
PLAIN_TOL = dict(loss_rtol=1e-5, loss_atol=0.0, grad_rtol=1e-4,
                 grad_atol=1e-5, param_rtol=1e-5, param_atol=1e-6)
JAX_GRAD_ATOL = 5e-4         # of each tensor's largest, against JAX


def walk_draws(key, b, n, cont=3):
    """The walks' draws of ``sample_explainer_inputs(key)`` (its keys
    ``w1..w3``), as the port's ``WalkDraws`` a side."""
    import jax
    from tempme_tpu_torch.ops import sampler as S
    out = []
    for wk in jax.random.split(key, 7)[4:]:
        kk, ku2 = jax.random.split(wk)
        _, ku3 = jax.random.split(kk)
        out.append(S.WalkDraws(
            torch.from_numpy(np.asarray(jax.random.uniform(ku2,
                                                           (b * n, cont)))),
            torch.from_numpy(np.asarray(jax.random.uniform(
                ku3, (b * n * cont,))))))
    return tuple(out)


def explainer_support(key, b, n, num_dst):
    """The supports' draws of ``sample_explainer_inputs(key)``: the
    negatives (key ``kn``) and per side the hops (``k1..k3``)."""
    import jax
    from tests.test_torch_graph_sampler import jax_hop_draws
    kn, k1, k2, k3 = jax.random.split(key, 7)[:4]
    neg = np.array(jax.random.randint(kn, (b,), 0, num_dst))
    return L.SupportDraws(torch.from_numpy(neg).long(),
                          *(jax_hop_draws(k, b, 2, n) for k in (k1, k2, k3)))


def stream():
    """The stream, its features and the three global batches."""
    from tests.conftest import make_events
    ev = make_events(num_events=200, num_nodes=32, seed=6)
    r = np.random.RandomState(7)
    node = r.randn(ev.num_nodes, DN).astype(np.float32)
    edge = r.randn(ev.num_edges, DE).astype(np.float32)
    node[0] = edge[0] = 0.0

    def rows(start):
        s = slice(start, start + B)
        return [ev.src[s].copy(), ev.dst[s].copy(), ev.ts[s].copy(),
                ev.e_idx[s].copy(), np.ones(B, bool)]
    b1, b2, b3 = rows(100), rows(120), rows(140)
    b2[2][B // W:] += SKEW
    b3[4][B - 2:] = False
    for c in range(4):                 # padded rows repeat the first event
        b3[c][B - 2:] = b3[c][0]
    batches = [L.Batch(*(torch.from_numpy(np.asarray(c)) for c in b))
               for b in (b1, b2, b3)]
    return ev, node, edge, batches


def jax_tree(tree, seed, scale=0.3):
    """Normal draws in the structure of an ``eval_shape`` tree."""
    import jax
    import jax.numpy as jnp
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(scale * r.randn(*x.shape), x.dtype), tree)


def recording_gamma(store):
    """``jax.random.gamma`` that hands each draw's global array to
    ``store`` (keyed by its order in the trace) through a debug
    callback."""
    import jax
    real = jax.random.gamma
    count = [0]

    def gamma(key, a, *args, **kw):
        g = real(key, a, *args, **kw)
        i = count[0]
        count[0] += 1
        jax.debug.callback(lambda v, i=i: store.__setitem__(i, np.asarray(v)),
                           g)
        return g
    return gamma


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from tests.test_torch_graph_sampler import to_torch_events
    torch.set_num_threads(1)
    work_a = str(tmp_path_factory.mktemp("dp_explain_a"))
    work_bc = str(tmp_path_factory.mktemp("dp_explain_bc"))
    ev, node, edge, batches = stream()
    nodes, dst = ev.num_nodes, np.unique(ev.dst)
    null = np.random.RandomState(1).dirichlet(np.ones(12)).astype(np.float32)
    # runs B and C need no JAX: their ranks start first
    exp = dict(node_dim=DN, edge_dim=DE, hid_dim=HID, dropout=0.0)
    spec_bc = D.make_spec(
        to_torch_events(ev), nodes, ev.num_edges, node, edge, dst, N,
        [D.make_run(dict(exp, base_type="graphmixer"), batches, LR, seed=3,
                    record=REC, kind="explainer", null=null,
                    base=D.make_base("graphmixer", dict(
                        node_dim=DN, edge_dim=DE, num_tokens=N,
                        num_layers=2, dropout=0.0))),
         D.make_run(dict(exp, out_dim=8, dropout=0.1), batches, LR, seed=4,
                    record=REC, kind="tgat-explainer", null=null,
                    base=D.make_base("tgat", dict(
                        node_dim=DN, edge_dim=DE, num_layers=2, n_head=2,
                        dropout=0.0, compute_dtype=torch.float32)))])
    proc_bc = _launch(spec_bc, work_bc)
    try:
        return _with_jax(ev, node, edge, batches, null, exp, spec_bc,
                         proc_bc, work_a, work_bc)
    finally:
        if proc_bc.poll() is None:
            proc_bc.kill()
            proc_bc.wait()


def _with_jax(ev, node, edge, batches, null, exp, spec_bc, proc_bc, work_a,
              work_bc):
    """Run A: JAX's sharded step (recording its draws), then the port's 2
    ranks on those draws; both runs against the 1-process step."""
    import jax
    import jax.numpy as jnp
    import optax
    from tempme_tpu.explain import tempme as JE
    from tempme_tpu.parallel import mesh as JM
    from tempme_tpu.parallel.train import make_sharded_explainer_train_step
    from tempme_tpu.train import loops as JL
    from tempme_tpu.train import temp_exp_main as JX
    from tempme_tpu_torch.utils.convert import flax_to_state_dict
    from tests.test_torch_dp import _jax_model

    def port(tree):
        return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))

    nodes, dst = ev.num_nodes, np.unique(ev.dst)
    jm, jg, jfeats, jmem, params = _jax_model(ev, node, edge, nodes)
    # the JAX sampler's CSR branch, which the port's kernels follow
    jg = dataclasses.replace(jg, dense_ts=None, dense_node=None,
                             dense_eid=None)
    je = JE.TempME(node_dim=DN, edge_dim=DE, hid_dim=HID, base_type="tgn",
                   dropout=0.0)
    b0 = JL.Batch(*(jnp.asarray(x.numpy()) for x in batches[0]))
    key = jax.random.PRNGKey(11)
    jdst = jnp.asarray(dst)

    def init():
        _, subs, walks = JX.sample_explainer_inputs(jg, key, b0, jdst, N)
        return je.init({"params": key}, jfeats, walks[0], b0.ts, subs[0],
                       method=JE.TempME.init_all)
    tree = jax.eval_shape(init)
    eparams = jax_tree(tree, seed=8)
    keys = [jax.random.PRNGKey(5)]
    for _ in range(2):
        keys.append(jax.random.split(keys[-1], 4)[3])
    gammas = {}
    jopt = optax.adam(LR)
    mesh = JM.make_mesh(2, 1, 1, devices=jax.devices()[:2])
    base = JX.LoadedBase("tgn", jm, params, jmem, {})
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jax.random, "gamma", recording_gamma(gammas))
        jstep, place, place_batch = make_sharded_explainer_train_step(
            je, JX.make_base_contrast(base, jfeats), jg, jfeats, jdst, N,
            jnp.asarray(null), jopt, mesh)
        p, o, k = place(eparams, jopt.init(eparams), keys[0])
        jax_out, mu_prev, draws = [], None, []
        for i, tb in enumerate(batches):
            jb = JL.Batch(*(jnp.asarray(x.numpy()) for x in tb))
            gammas.clear()
            p, o, k, loss = jstep(p, o, k, place_batch(jb))
            jax.effects_barrier()
            if i < 2:
                assert np.array_equal(np.asarray(k), keys[i + 1])
            assert sorted(gammas) == list(range(12))
            k_samp = jax.random.split(keys[i], 4)[0]
            draws.append(ExplainerDraws(
                explainer_support(k_samp, B, N, len(dst)),
                walk_draws(k_samp, B, N), None, None,
                tuple(tuple(torch.from_numpy(gammas[4 * s + j])
                            for j in range(4)) for s in range(3))))
            mu = port(o[0].mu)
            grads = {n: _adam_grads(g, None if mu_prev is None
                                    else mu_prev[n]) for n, g in mu.items()}
            # the enhance head takes no gradient: no Adam moment either
            jax_out.append(dict(
                loss=float(loss), params=port(p),
                grads={n: g if g.any() else None
                       for n, g in grads.items()}))
            mu_prev = mu
    # run A: JAX's draws, the gamma draws among them, recorded above
    spec = dict(spec_bc, runs=[D.make_run(
        dict(exp, base_type="tgn"), batches, LR, draws=draws,
        state={"params": port(eparams)}, record=REC, kind="explainer",
        null=null, base=D.make_base("tgn", dict(
            node_dim=DN, edge_dim=DE, num_nodes=nodes, n_layers=2, n_head=2,
            dropout=0.0, compute_dtype=torch.float32), port(params)))])
    proc_a = _launch(spec, work_a)
    try:
        plain = D.replay_plain(spec, torch.device("cpu")) + \
            D.replay_plain(spec_bc, torch.device("cpu"))
        ranks = [a + bc for a, bc in zip(_join(proc_a, work_a),
                                         _join(proc_bc, work_bc))]
    finally:
        if proc_a.poll() is None:
            proc_a.kill()
            proc_a.wait()
    return dict(spec=spec, ranks=ranks, plain=plain, jax=jax_out,
                batches=batches)


def hold(got, want, **tol):
    """``got``'s state after each step (a run's record, recording every
    step from 0) against ``want`` (a state with its loss, gradients and
    parameters a step), by ``dryrun.hold_step`` at ``PLAIN_TOL`` and
    ``tol``."""
    settled = {}
    for k, ref in enumerate(want, start=1):
        D.hold_step(D.at_step(got, k), ref, got["states"][k - 1],
                    f"step {k}", LR, settled=settled, **{**PLAIN_TOL, **tol})


def _plain(res):
    return [D.at_step(res, k) for k in (1, 2, 3)]


def test_ranks_end_every_step_bitwise_equal(dp):
    D.assert_ranks_equal(dp["ranks"])      # the generators' states too


@pytest.mark.parametrize("run,golden", [
    (0, "explainer-injected-gamma"), (1, "explainer"),
    (2, "tgat-explainer")])
def test_collectives_match_the_golden(dp, run, golden):
    for rank in dp["ranks"]:
        for comm in rank[run]["comm"]:
            assert comm["by_kind"] == GOLDEN_COLLECTIVES[golden]


@pytest.mark.parametrize("run", [0, 1, 2])
def test_two_ranks_match_the_one_process_step(dp, run):
    got, want = dp["ranks"][0][run], dp["plain"][run]
    hold(got, _plain(want))
    for k in (1, 2, 3):
        # the generators (the gamma draws among them) stay in step
        assert torch.equal(got["states"][k]["generator"],
                           want["states"][k]["generator"])


def test_two_ranks_match_jax_sharded_step(dp):
    hold(dp["ranks"][1][0], dp["jax"], grad_atol=JAX_GRAD_ATOL)


def test_one_process_step_matches_jax_sharded_step(dp):
    """The port's 1-process step on the same global batches and draws, at
    the same limits as the 2 ranks."""
    hold(dp["plain"][0], dp["jax"], grad_atol=JAX_GRAD_ATOL)


def test_skewed_batch_needs_the_global_statistics(dp):
    """Step 2's halves: the motif attention's time deltas differ by orders
    of magnitude, so a rank's own ``std`` is far from the global one
    (the case the statistics' all-reduce exists for; JAX's step and the
    1-process step both take it over the global batch)."""
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.explain.tempme import motif_delta
    from tempme_tpu_torch.train.temp_exp_main import sample_explainer_inputs
    spec, b2 = dp["spec"], dp["batches"][1]    # run A's
    g = build_temporal_graph(spec["events"], spec["num_nodes"],
                             spec["num_edges"], device="cpu")
    draws = spec["runs"][0]["draws"][1]
    _, _, walks = sample_explainer_inputs(
        g, b2, torch.from_numpy(spec["dst_table"]), N, draws)
    delta = motif_delta(walks[0].ts, b2.ts)
    half = B // W
    local = [delta[:half].std().item(), delta[half:].std().item()]
    assert delta.std().item() > 10 * local[0]
    assert abs(delta.std().item() - local[1]) > 0.1 * delta.std().item()
    np.testing.assert_allclose(dp["ranks"][0][0]["loss"][1],
                               dp["jax"][1]["loss"], rtol=1e-5)


def test_padded_rows_count_in_the_loss(dp):
    """Step 3's last 2 rows (rank 1's) are padding; the explainer's loss
    is the unmasked mean over all 2 B rows, as JAX's step takes it."""
    mask = dp["batches"][2].mask
    assert mask[:B // W].all() and int(mask[B // W:].sum()) == B // W - 2
    for run in (0, 1, 2):
        np.testing.assert_allclose(dp["ranks"][1][run]["loss"][2],
                                   dp["plain"][run]["loss"][2], rtol=1e-5)
    np.testing.assert_allclose(dp["ranks"][1][0]["loss"][2],
                               dp["jax"][2]["loss"], rtol=1e-5)


def test_card_two_gloo_ranks_match_the_card_step(tmp_path):
    """On the card: the dry run's explainer, TGAT-explainer and enhance
    runs at dropout 0 and float32 on 2 gloo ranks with CUDA tensors on one
    card, against the 1-process card step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks run the card's kernels")
    spec = D.tiny_walk_spec(W)
    spec["runs"] = spec["runs"][1::2]
    ranks = _join(_launch(spec, str(tmp_path), "gloo", "cuda:0"),
                  str(tmp_path))
    D.assert_ranks_equal(ranks)
    plain = D.replay_plain(spec, torch.device("cuda"))
    for got, want, kind in zip(ranks[0], plain, D.KINDS[1:]):
        D.hold_plain(got, want, kind)
