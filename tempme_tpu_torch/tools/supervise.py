"""Stall watchdog and restart supervisor.

The drivers checkpoint their full train state (params, optimizer,
generator, early stop, a TGN's memory) every epoch and take ``--resume``.
This supervisor turns that into automatic recovery: it runs a driver
command, watches its stdout for progress, and on a stall (no output for
``--stall_timeout`` seconds: a device op that never completes) kills the
process group and restarts the command with ``--resume`` appended, up to
``--max_restarts`` times.

Usage:
    python -m tempme_tpu_torch.tools.supervise --stall_timeout 600 -- \
        python -m tempme_tpu_torch.train.learn_base --data uslegis_sampled \
        --base_type tgat --n_epoch 20

The port's own copy of ``tempme_tpu/tools/supervise.py`` (subprocess
code only).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time


def run_supervised(cmd, stall_timeout=600, max_restarts=5, resume_flag="--resume",
                   log=print, _poll_interval=None):
    """Run ``cmd`` (list) under a stall watchdog. Returns the final exit code
    (0 on success). On stall or crash, restarts with ``resume_flag`` appended
    (once; subsequent restarts keep it). ``_poll_interval`` overrides the
    watchdog wake period (tests only)."""
    attempt = 0
    cur = list(cmd)
    while True:
        attempt += 1
        log(f"[supervise] attempt {attempt}: {' '.join(cur)}")
        proc = subprocess.Popen(cur, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                bufsize=1, start_new_session=True)
        last_beat = [time.time()]

        def pump():
            for line in proc.stdout:
                last_beat[0] = time.time()
                sys.stdout.write(line)
                sys.stdout.flush()

        t = threading.Thread(target=pump, daemon=True)
        t.start()

        stalled = False
        # Poll much faster than the stall timeout so short timeouts are
        # honored, and re-check poll() after every wake: a child that exits
        # during the sleep is a normal exit, never a stall (a beat older than
        # stall_timeout at that point just means the final phase was silent).
        poll_interval = (_poll_interval if _poll_interval is not None
                         else min(5.0, max(0.05, stall_timeout / 4.0)))
        while proc.poll() is None:
            time.sleep(poll_interval)
            if proc.poll() is not None:
                break
            if time.time() - last_beat[0] > stall_timeout:
                stalled = True
                log(f"[supervise] STALL: no output for {stall_timeout}s — "
                    f"killing process group {proc.pid}")
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
                break
        t.join(timeout=10)

        rc = proc.returncode
        # rc==0 always wins: even if a stall was (mis)declared, a clean exit
        # code means the work completed.
        if rc == 0:
            log(f"[supervise] success after {attempt} attempt(s)")
            return 0
        if attempt > max_restarts:
            log(f"[supervise] giving up after {attempt} attempts (rc={rc}, "
                f"stalled={stalled})")
            return rc if rc not in (None, 0) else 1
        if resume_flag and resume_flag not in cur:
            cur = cur + [resume_flag]
        log(f"[supervise] restarting (rc={rc}, stalled={stalled})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "tempme_tpu_torch stall watchdog",
        usage="python -m tempme_tpu_torch.tools.supervise [opts] -- CMD ...")
    ap.add_argument("--stall_timeout", type=float, default=600,
                    help="seconds without stdout progress before the run is "
                         "declared hung and restarted")
    ap.add_argument("--max_restarts", type=int, default=5)
    ap.add_argument("--resume_flag", default="--resume",
                    help="flag appended on restart ('' to disable)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to supervise (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    return run_supervised(cmd, args.stall_timeout, args.max_restarts,
                          args.resume_flag or None)


if __name__ == "__main__":
    sys.exit(main())
