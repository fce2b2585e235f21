"""Time this checkout's attention kernels against another build of them, in
turns, on one card.

    python3 -m tempme_tpu_torch.tools.attend_ab OTHER_CSRC [--json PATH]

``OTHER_CSRC`` is a directory with an ``attend.cu`` and an ``attend_bwd.cu``
that export the same launchers (``attend_launch``, ``attend_drop_launch``,
``attend_bwd_launch``), for example an earlier commit's
``tempme_tpu_torch/ops/kernels/csrc`` unpacked with ``git archive``. They are
built and timed by ``tools/ab.py``; this checkout's are built as the port
builds them.

At the attention shapes of ``chip_smoke.py`` (hop m 5,120, root m 256,
explainer hop m 2,000) and the explainer's root (m 100), h 2, n 20, dk 172,
in float32 and bf16, four forms are run: ``attend`` (mask and explain
weight), ``attend_drop`` (mask, draws at rate 0.1), ``attend_bwd`` in the
training form (mask, draws) and in the explainer's form (mask, explain
weight and its gradient). Each build's outputs are first held against the
plain PyTorch version: float32 outputs to rtol 1e-5, atol 1e-5 (sums of 20
to 344 float32 terms in another order than the plain version's; the
forward's ``out`` at m 5,120 differed by 1.1e-6 on these inputs in both
builds), bf16 gradients to rtol 1e-2, atol 1e-4 as in ``chip_smoke.py``;
the other build's explain-weight gradient is not compared, its layout may
differ. The largest difference between the two builds' outputs is
printed.
Then each form is timed six times in turns (``ab.in_turns``: plain, other,
this, this, other, plain, device ms per call in a CUDA graph). The launchers
are called directly on buffers made beforehand, so no wrapper, allocation
or second launch is timed. Prints one line per form and shape and, with
``--json``, writes them all.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from ..ops.kernels import _build
from ..ops.kernels import attend as A
from . import ab

SHAPES = (("hop m=5120", 5120), ("root m=256", 256),
          ("explain hop m=2000", 2000), ("explain root m=100", 100))
H, N, DK, RATE, SEED = 2, 20, 172, 0.1, 0


def inputs(m, dtype, gen, dev):
    q = torch.randn((m, H, DK), generator=gen, device=dev).to(dtype)
    k = torch.randn((m, N, H, DK), generator=gen, device=dev).to(dtype)
    v = torch.randn((m, N, H, DK), generator=gen, device=dev).to(dtype)
    mask = torch.rand((m, N), generator=gen, device=dev) < 0.3
    mask[:3] = True
    ew = torch.rand((m, N), generator=gen, device=dev)
    u = torch.rand((m, H, N), generator=gen, device=dev)
    dout = torch.randn((m, H, DK), generator=gen, device=dev)
    return q, k, v, mask, ew, u, dout


def forms(q, k, v, mask, ew, u, dout):
    """{form: (launcher, plain, make_outputs, args of the launcher)}."""
    m = q.shape[0]
    scale = 1.0 / DK ** 0.5
    dev, bf16 = q.device, int(q.dtype == torch.bfloat16)
    p = A._ptr

    def fwd_out():
        return [torch.empty((m, H, DK), device=dev),
                torch.empty((m, H, N), device=dev)]

    def bwd_out():
        # the explain weight's gradient gets room for per-head partials,
        # the larger of the layouts a build may write
        return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                torch.empty((m, H, N), device=dev)]

    return {
        "attend": (
            "attend_launch",
            lambda: A.attend_plain(q, k, v, mask, ew, scale), fwd_out,
            lambda o: (p(q), p(k), p(v), p(mask), p(ew), m, H, N, DK, bf16,
                       scale, p(o[0]), p(o[1]))),
        "attend_drop": (
            "attend_drop_launch",
            lambda: A.attend_drop_plain(q, k, v, mask, None, u, RATE, scale),
            fwd_out,
            lambda o: (p(q), p(k), p(v), p(mask), None, p(u), m, H, N, DK,
                       bf16, scale, RATE, p(o[0]), p(o[1]))),
        "attend_bwd": (
            "attend_bwd_launch",
            lambda: A.attend_bwd_plain(q, k, v, mask, None, u, RATE, scale,
                                       dout),
            bwd_out,
            lambda o: (p(q), p(k), p(v), p(mask), None, p(u), m, H, N, DK,
                       bf16, scale, RATE, p(dout), None, p(o[0]), p(o[1]),
                       p(o[2]), None)),
        "attend_bwd ew": (
            "attend_bwd_launch",
            lambda: A.attend_bwd_plain(q, k, v, mask, ew, None, 0.0, scale,
                                       dout, ew_grad=True),
            bwd_out,
            lambda o: (p(q), p(k), p(v), p(mask), p(ew), None, m, H, N, DK,
                       bf16, scale, 0.0, p(dout), None, p(o[0]), p(o[1]),
                       p(o[2]), p(o[3]))),
    }


def check(name, got, want, this_build):
    """float32 outputs to rtol 1e-5, atol 1e-5; bf16 ones to rtol 1e-2,
    atol 1e-4."""
    m = got[0].shape[0]
    if name.startswith("attend_bwd"):
        pairs = list(zip(got[:3], want[:3]))
        if name.endswith("ew") and this_build:
            pairs.append((got[3].reshape(-1)[:m * N].view(m, N), want[3]))
    else:
        pairs = list(zip(got, want))
    for a, b in pairs:
        tol = (dict(rtol=1e-2, atol=1e-4) if a.dtype == torch.bfloat16
               else dict(rtol=1e-5, atol=1e-5))
        torch.testing.assert_close(a.float(), b.float(), **tol)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attend_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = ab.card_line()
    print(f"[attend_ab] {card}; other sources {args.other_csrc}", flush=True)
    this = {name: A._lib(name) for name in ("attend", "attend_bwd")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = []
    with tempfile.TemporaryDirectory(prefix="attend_ab_") as tmp:
        other = {name: A._typed(lib) for name, lib in ab.build_other(
            args.other_csrc, ("attend", "attend_bwd"), tmp).items()}
        for (shape, m), dtype in ((s, d) for s in SHAPES
                                  for d in (torch.float32, torch.bfloat16)):
            tensors = inputs(m, dtype, gen, dev)
            for name, (fn, plain, make, args_of) in forms(*tensors).items():
                lib_of = {"this": this, "other": other}
                outs = {b: make() for b in lib_of}
                libname = "attend_bwd" if name.startswith("attend_bwd") \
                    else "attend"

                def run(build, libname=libname, fn=fn, outs=outs,
                        args_of=args_of):
                    stream = torch.cuda.current_stream().cuda_stream
                    err = getattr(lib_of[build][libname], fn)(
                        *args_of(outs[build]), stream)
                    _build.check(err, f"{build} {fn}")

                want = plain()
                for build in lib_of:
                    run(build)
                    torch.cuda.synchronize()
                    check(name, outs[build], want, build == "this")
                diff = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(outs["this"][:3], outs["other"][:3]))
                times = ab.in_turns({"plain": plain,
                                     "other": lambda: run("other"),
                                     "this": lambda: run("this")})
                row = dict(form=name, shape=shape,
                           dtype=str(dtype).replace("torch.", ""),
                           this_vs_other=diff,
                           **{f"{b}_ms": t for b, t in times.items()})
                rows.append(row)
                print(f"  {name:14s} {shape:19s} {row['dtype']:8s} "
                      f"{ab.turns_text(times)}; |this - other| {diff:.2e}",
                      flush=True)
    print(card)
    if args.json:
        ab.write_json(args.json, card, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
