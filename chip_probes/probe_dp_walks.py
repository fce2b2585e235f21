"""Rehearse chip_smoke's [dp-explain] and [dp-enhance] alone on the card,
on quick prerequisites: the enhance TGN base of the 15,000-event cut (also
the explained TGN), its explainer, a 2-layer TGAT (batch 256) and its
explainer, the GraphMixer."""
import contextlib
import io
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    import chip_smoke as cs
    from tempme_tpu_torch.data.events import load_dataset
    from tempme_tpu_torch.ops.kernels import _build
    from tempme_tpu_torch.train import learn_base, temp_exp_main
    dev = torch.device("cuda")
    print(cs.gpu_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build()
    with tempfile.TemporaryDirectory() as work:
        ds_dir = os.path.join(work, "data")
        os.makedirs(ds_dir)
        cs.write_stream(ds_dir, cs.CUT_DATA, cs.CUT_EVENTS)
        cs.write_stream(ds_dir, cs.ENHANCE_TGN_DATA, cs.CUT_EVENTS,
                        trim_nodes=True)
        ds = load_dataset(cs.CUT_DATA, ds_dir)
        ds_tgn = load_dataset(cs.ENHANCE_TGN_DATA, ds_dir)
        with contextlib.redirect_stdout(io.StringIO()):
            base_out = os.path.join(work, "enhance_tgn_base")
            learn_base.main(cs.enhance_tgn_base_argv(ds_dir, base_out))
            tgn_ckpt = os.path.join(base_out, "params")
            temp_exp_main.main(cs.explain_argv(
                ds_dir, tgn_ckpt, os.path.join(work, "ex"),
                data=cs.ENHANCE_TGN_DATA))
            tgat_out = os.path.join(work, "tgat")
            learn_base.main(cs.tgat_argv(ds_dir, tgat_out, "--n_layer", "2",
                                         "--bs", "256"))
            tgat_ckpt = os.path.join(tgat_out, "params")
            temp_exp_main.main(cs.explain_argv(
                ds_dir, tgat_ckpt, os.path.join(work, "tx"),
                base_type="tgat", data=cs.TGAT_DATA))
            mixer_out = os.path.join(work, "mixer")
            learn_base.main(cs.mixer_argv(ds_dir, mixer_out))
        print(f"prerequisites {time.time() - t0:.1f} s", flush=True)
        cs.EXPLAIN_DATA = cs.ENHANCE_TGN_DATA
        # the probe's TGAT has 2 layers: 3 sides x 2 hops, 2 contrasts of 4
        # embeddings through 3 blocks, and 12 blocks' backward a step
        cs.TGAT_EXPLAIN_PER_STEP["train"] = dict(
            cs.TGAT_EXPLAIN_PER_STEP["train"], sample_rows=6, attend=24,
            attend_bwd=12)
        t = time.time()
        cs.say("[dp-explain]")
        print(cs.dp_explain_phase(ds_tgn, tgn_ckpt, tgat_ckpt, dev, torch),
              flush=True)
        print(f"dp-explain {time.time() - t:.1f} s", flush=True)
        t = time.time()
        cs.say("[dp-enhance]")
        print(cs.dp_enhance_phase(
            ds_tgn, os.path.join(tgn_ckpt, "tgnn",
                                 f"tgn_{cs.ENHANCE_TGN_DATA}.pt"), ds,
            os.path.join(mixer_out, "params", "tgnn",
                         f"graphmixer_{cs.MIXER_DATA}.pt"), dev, torch),
            flush=True)
        print(f"dp-enhance {time.time() - t:.1f} s", flush=True)
    print(f"probe {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
