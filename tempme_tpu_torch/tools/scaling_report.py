"""The sharded steps' collectives and communication, mesh by mesh.

    python -m tempme_tpu_torch.tools.scaling_report [--max_world 8] \
        [--out SCALING_torch.md] [--json_out scaling_report_torch.json]

Port of ``tempme_tpu/tools/scaling_report.py``. For each mesh of the JAX
tool's ``MESHES`` (dp x sp x tp) that ``--max_world`` allows, gloo ranks
spawned on the CPU (``parallel/dryrun.py``) run the TGN train step
(``parallel/train.py``) on the dry run's tiny stream with the JAX tool's
sizes (``--bs_per_dp`` rows a dp index: weak scaling over dp;
``--n_base`` x sp neighbours; width 16 x tp), and on the dp meshes the
explainer's too, two steps each at float32 and dropout 0. It reports from
the second step the collectives a rank makes by kind, the bytes it puts
into them and the step's wall ms (the ranks share the host's cores: a
check of the semantics and of the collectives' overhead, **not a hardware
number**). The JAX tool counts the collectives XLA inserts in the compiled
HLO; here the steps make them and count them themselves. The explainer's
step on an sp or tp mesh is reported with the ``ValueError`` it raises:
its sp and tp wait for ROADMAP A16d.

It writes the markdown table to ``--out`` and the rows to ``--json_out``
(by default ``SCALING_torch.md`` and ``scaling_report_torch.json`` in the
working directory; the JAX tool's ``SCALING.md`` and
``scaling_report.json`` are its own).
"""
from __future__ import annotations

import argparse
import json
import tempfile

from ..parallel import dryrun as D
from ..parallel import mesh as M
from ..parallel import train as P

MESHES = [(1, 1, 1), (2, 1, 1), (4, 1, 1), (8, 1, 1),
          (1, 2, 1), (1, 1, 2), (4, 2, 1), (2, 2, 2)]
STEPS = ("tgn", "explainer")


def scaling_spec(mesh, bs_per_dp: int, n: int) -> dict:
    """The TGN's deterministic dry-run run (dropout 0, float32) on ``mesh``
    at ``bs_per_dp`` rows a dp index, ``n * sp`` neighbours and width ``16
    tp``, and on a dp mesh the explainer's at ``n`` neighbours; two timed
    steps each."""
    dp = mesh[0]
    spec = D.tiny_spec(dp, per_rank=bs_per_dp, n=n, mesh=mesh)
    runs = [dict(spec["runs"][1], record=(), timed=True)]
    if mesh[1:] == (1, 1):
        walk = D.tiny_walk_spec(dp, per_rank=bs_per_dp, n=n)
        runs.append(dict(walk["runs"][1], record=(), timed=True))
    return dict(spec, runs=runs)


def measure(mesh, bs_per_dp: int, n: int) -> dict:
    """One mesh's row: per step kind the collectives of a rank by kind,
    its bytes and the wall ms of the second step (rank 0's); the
    explainer's refusal on an sp or tp mesh."""
    world = mesh[0] * mesh[1] * mesh[2]
    with tempfile.TemporaryDirectory(prefix="scaling_") as work:
        results = D.run_spec(scaling_spec(mesh, bs_per_dp, n), world,
                             "gloo", "cpu", work, mesh=mesh)
    row = {"global_batch": bs_per_dp * mesh[0], "n_degree": n * mesh[1]}
    for kind, res in zip(STEPS, results[0]):
        comm = res["comm"][-1]
        row[kind] = {"collectives": comm["by_kind"],
                     "comm_bytes_per_rank_per_step": comm["bytes"],
                     "collective_ms": comm["ms"],
                     "cpu_step_ms": res["wall_ms"][-1]}
    if "explainer" not in row:
        try:
            P.refuse_sp_tp(M.Mesh(*mesh, rank=0), "explainer")
        except ValueError as e:
            row["explainer"] = {"refused": str(e)}
    return row


def report(max_world: int, bs_per_dp: int, n: int) -> list:
    rows = []
    for dp, sp, tp in MESHES:
        if dp * sp * tp > max_world:
            continue
        row = {"mesh": f"{dp}x{sp}x{tp}", "devices": dp * sp * tp}
        row.update(measure((dp, sp, tp), bs_per_dp, n))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def markdown(rows, max_world: int, bs_per_dp: int) -> str:
    lines = [
        "# SCALING (PyTorch port) - the sharded steps' collectives",
        "",
        "Generated by `tempme_tpu_torch.tools.scaling_report` with gloo "
        f"ranks spawned on the CPU (up to {max_world}). Weak scaling: "
        f"{bs_per_dp} rows a dp index. `cpu step ms` is the wall time of one "
        "step with the ranks sharing the host's cores: a check of the "
        "semantics and the collectives' overhead, NOT a hardware number. "
        "AG, AR, BC: all-gathers, all-reduces, broadcasts a rank makes a "
        "step; bytes: what a rank puts into them.",
        "",
        "| mesh (dp x sp x tp) | global batch | TGN AG / AR / BC | TGN "
        "bytes | TGN cpu step ms | explainer AG / AR / BC | explainer "
        "bytes | explainer cpu step ms |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        cells = []
        for kind in STEPS:
            if "refused" in r[kind]:
                cells += [f"refused: {r[kind]['refused']}", "", ""]
                continue
            c = r[kind]["collectives"]
            cells += [f"{c['all_gather']} / {c['all_reduce']} / "
                      f"{c['broadcast']}",
                      f"{r[kind]['comm_bytes_per_rank_per_step']:,}",
                      f"{r[kind]['cpu_step_ms']:.1f}"]
        lines.append(f"| {r['mesh']} | {r['global_batch']} | "
                     + " | ".join(cells) + " |")
    lines += [
        "",
        "A dp rank all-gathers the batch rows that the TGN's memory write "
        "reads and the explainer's edge probabilities (its gamma draws are "
        "taken on the global shapes), all-reduces the explainer's batch "
        "statistics, and all-reduces every gradient with the loss in one "
        "buffer. An sp rank all-gathers the ids and memory rows of its "
        "distributed row gather and each side's hop-0 embeddings (and "
        "all-reduces their gradients); a tp rank all-gathers the "
        "tp-sharded weights and all-reduces its shards' gradients over the "
        "ranks with its tp index. At world size 1 the local statistics and draws are the "
        "global ones. The explainer's sp and tp wait for ROADMAP A16d.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="SCALING_torch.md")
    ap.add_argument("--json_out", default="scaling_report_torch.json")
    ap.add_argument("--bs_per_dp", type=int, default=8)
    ap.add_argument("--n_base", type=int, default=4)
    ap.add_argument("--max_world", type=int, default=8,
                    help="the largest mesh to run (gloo ranks on the CPU)")
    args = ap.parse_args(argv)
    rows = report(args.max_world, args.bs_per_dp, args.n_base)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    with open(args.out, "w") as f:
        f.write(markdown(rows, args.max_world, args.bs_per_dp))
    print(f"wrote {args.out} + {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
