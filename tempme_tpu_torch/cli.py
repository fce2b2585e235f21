"""One command line for the port's drivers and tools.

    python -m tempme_tpu_torch.cli learn-base  --data wikipedia --base_type tgn
    python -m tempme_tpu_torch.cli preprocess  --data wikipedia
    python -m tempme_tpu_torch.cli explain     --data wikipedia --base_type tgn
    python -m tempme_tpu_torch.cli explain     --data wikipedia --use_cache
    python -m tempme_tpu_torch.cli enhance     --data wikipedia --base_type tgn
    python -m tempme_tpu_torch.cli pipeline    --data wikipedia --base_types tgn
    python -m tempme_tpu_torch.cli sample-dataset --data enron --ratio 0.15
    python -m tempme_tpu_torch.cli analyze     --data wikipedia
    python -m tempme_tpu_torch.cli node-degrees --data wikipedia
    python -m tempme_tpu_torch.cli visualize   --data wikipedia --base_type tgn
    python -m tempme_tpu_torch.cli validate    --data wikipedia
    python -m tempme_tpu_torch.cli supervise   --stall_timeout 600 -- python -m ...
    python -m tempme_tpu_torch.cli profile     --data wikipedia
    python -m tempme_tpu_torch.cli scaling-report --max_world 8

The data directory is ``--data_dir`` or ``TEMPME_DATA_DIR``. Each command
runs on the CUDA device; a Python caller may pass ``device="cpu"`` to
``main`` (``scaling-report`` runs gloo ranks on the CPU). Port of
``tempme_tpu/cli.py``; ``smoke`` is ``python3 chip_smoke.py``, and the
command exits non-zero saying so.
"""
from __future__ import annotations

import sys

NOT_PORTED = {
    "smoke": "the port's smoke run is `python3 chip_smoke.py` from the root "
             "of a checkout, on a machine with a CUDA card",
}


def main(argv=None, device=None):
    """Run one command; returns what its entry point returns (an exit code
    for the tools, a driver's number or report), 1 for an unknown or
    unported command."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "learn-base":
        from .train.learn_base import main as m
        return m(rest, device=device)
    if cmd == "preprocess":
        from .train.preprocess import main as m
        return m(rest, device=device)
    if cmd == "explain":
        from .train.temp_exp_main import main as m
        return m(rest, device=device)
    if cmd == "enhance":
        from .train.enhance_main import main as m
        return m(rest, device=device)
    if cmd == "pipeline":
        from .train.batch_train import main as m
        return m(rest, device=device)
    if cmd in ("sample-dataset", "analyze"):
        from .train.sample_tools import main as m
        return m([cmd] + rest)
    if cmd == "node-degrees":
        from .tools.node_degrees import main as m
        return m(rest)
    if cmd == "visualize":
        from .tools.visualize import main as m
        return m(rest, device=device)
    if cmd == "validate":
        from .tools.validate import main as m
        return m(rest, device=device)
    if cmd == "supervise":
        from .tools.supervise import main as m
        return m(rest)
    if cmd == "profile":
        from .tools.profile_step import main as m
        return m(rest, device=device)
    if cmd == "scaling-report":      # gloo ranks on the CPU
        from .tools.scaling_report import main as m
        return m(rest)
    if cmd in NOT_PORTED:
        print(f"{cmd}: {NOT_PORTED[cmd]}", file=sys.stderr)
        return 1
    print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
    return 1


def exit_code(cmd: str, result) -> int:
    """A command's result as the process's exit code: a pipeline fails if
    any stage raised; an int (a tool's code) is itself; a driver's number
    or report is success."""
    if cmd == "pipeline":
        from .train.batch_train import failed
        return int(failed(result))
    if isinstance(result, int) and not isinstance(result, bool):
        return result
    return 0


if __name__ == "__main__":
    sys.exit(exit_code(sys.argv[1] if len(sys.argv) > 1 else "",
                       main()))
