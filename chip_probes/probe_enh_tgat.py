"""Probe: the TGAT enhance step (TempMETGAT on the walks alone) of the
15,000-event cut (``chip_smoke.py``'s [enhance-tgat] check, C11 in
``ROADMAP.md``), card float32 and CPU float32 against a CPU float64
reference of the same step; and how many of the batch's walks are all
padding (their three events' keys equal, so the softmax's gradient with
respect to the queries and keys is zero in exact arithmetic). Prints,
for every predictor tensor, the largest distance of the card's and the
CPU's float32 gradients from the float64 one and from each other, over
the float64 gradient's largest (absolute where that is zero).

    python3 chip_probes/probe_enh_tgat.py     # on a machine with a card
"""
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
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.ops.kernels import _build
    from tempme_tpu_torch.train import learn_base, loops
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    t0 = time.time()
    _build.build()
    with tempfile.TemporaryDirectory() as work:
        ds_dir = os.path.join(work, "data")
        os.makedirs(ds_dir)
        cs.write_stream(ds_dir, cs.CUT_DATA, cs.CUT_EVENTS)
        ds = load_dataset(cs.CUT_DATA, ds_dir)
        tgat_out = os.path.join(work, "tgat")
        with contextlib.redirect_stdout(io.StringIO()):
            learn_base.main(cs.tgat_argv(ds_dir, tgat_out, "--n_layer", "2",
                                         "--bs", "256"))
        _, _, ckpt, _ = cs.enhance(ds, ds_dir, os.path.join(tgat_out, "params"),
                                   os.path.join(work, "enhance_tgat"), torch,
                                   "tgat", base_data=cs.TGAT_DATA)
        print(f"prerequisites {time.time() - t0:.1f} s", flush=True)
        cpu = torch.device("cpu")
        steps = {}
        for name, d in (("cpu32", cpu), ("card", dev), ("cpu64", cpu)):
            steps[name], _ = cs.enhance_steps_on(d, ds, ckpt, "tgat",
                                                 torch.float32, cs.CUT_DATA)
        s64 = steps["cpu64"]
        s64.predictor.double()
        s64.feats = Features(s64.feats.node.double(), s64.feats.edge.double())
        s64.node_degree = s64.node_degree.double()
        batch = loops.Batch(*(x[0] for x in loops.stack_batches(
            ds.train, cs.ENHANCE_REF_BATCH, True, cs.SEED + 1, cpu)))
        gen = torch.Generator(device=cpu)
        gen.manual_seed(cs.SEED + 31)
        draws = steps["cpu32"].draw(gen, cs.ENHANCE_REF_BATCH)
        draws64 = draws._replace(pred=cs.to_device(draws.pred, cpu) and tuple(
            type(p)(*(x.double() for x in p)) for p in draws.pred))
        _, _, walks = steps["cpu32"].sample(batch, draws)
        for i, w in enumerate(walks):
            eids = w.eids
            pad = (eids == 0).all(-1)
            same = (eids == eids[..., :1]).all(-1)
            print(f"side {i}: walks {eids.shape[0] * eids.shape[1]}, all "
                  f"three events padding {int(pad.sum())}, three equal "
                  f"edge ids {int(same.sum())}", flush=True)
        steps["cpu32"](None, batch, draws)
        steps["card"](None, cs.to_device(batch, dev), cs.to_device(draws, dev))
        steps["cpu64"](None, batch, draws64)
        torch.cuda.synchronize()
        p32 = dict(steps["cpu32"].predictor.named_parameters())
        pg = dict(steps["card"].predictor.named_parameters())
        for name, p in steps["cpu64"].predictor.named_parameters():
            if p.grad is None:
                print(f"{name:45s} no gradient on the float64 side "
                      f"(card {pg[name].grad is not None}, cpu32 "
                      f"{p32[name].grad is not None})", flush=True)
                continue
            ref = p.grad
            top = ref.abs().max().item()
            e_card = (pg[name].grad.cpu().double() - ref).abs().max().item()
            e_cpu = (p32[name].grad.double() - ref).abs().max().item()
            e_both = (pg[name].grad.cpu() - p32[name].grad).abs().max().item()
            if top == 0.0:      # zero in float64: absolute distances
                print(f"{name:45s} top 0 (float64) card-f64 {e_card:.3e} "
                      f"cpu32-f64 {e_cpu:.3e} card-cpu32 {e_both:.3e} "
                      f"(absolute)", flush=True)
                continue
            print(f"{name:45s} top {top:.3e} card-f64 {e_card / top:.3e} "
                  f"cpu32-f64 {e_cpu / top:.3e} card-cpu32 "
                  f"{e_both / top:.3e}", flush=True)
    print(f"probe {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
