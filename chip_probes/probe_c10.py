"""C10 probe: the GraphMixer explainer on the 15,000-event cut, one train
step card against CPU, with every entry of attention.fc1.weight (and any
entry over lr) printed: its gradient on each side, the Adam state it
started from and the update each side applied; then the float64 Adam
replay check on every parameter."""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

cs.MIXER_DATA = "wikishape15k"
DATA = cs.MIXER_DATA


def main():
    from tempme_tpu_torch.ops.kernels import _build
    from tempme_tpu_torch.data.events import load_dataset
    from tempme_tpu_torch.train import learn_base, temp_exp_main, loops
    from tempme_tpu_torch.utils.optim import adam_replay
    t0 = time.perf_counter()
    _build.build()
    print(cs.gpu_line(), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        ds_dir = os.path.join(work, "data")
        os.makedirs(ds_dir)
        cs.write_stream(ds_dir, DATA, 15_000)
        out = os.path.join(work, "mixer")
        learn_base.main(cs.mixer_argv(ds_dir, out))
        ckpt = os.path.join(out, "params")
        temp_exp_main.main(cs.explain_argv(
            ds_dir, ckpt, os.path.join(work, "mx"), base_type="graphmixer",
            data=DATA))
        print(f"trained in {time.perf_counter() - t0:.1f} s", flush=True)
        ds = load_dataset(DATA, ds_dir)
        cpu = torch.device("cpu")
        tc, _ = cs.explainer_steps_on(cpu, ds, ckpt, torch.float32,
                                      "graphmixer", DATA)
        tg, _ = cs.explainer_steps_on(dev, ds, ckpt, torch.float32,
                                      "graphmixer", DATA)
        batch = loops.Batch(*(x[0] for x in loops.stack_batches(
            ds.train, cs.EXPLAIN_BATCH, True, cs.SEED + 1, cpu)))
        gen = torch.Generator(device=cpu)
        gen.manual_seed(cs.SEED + 5)
        draws = cs.explainer_draws(tc, gen)
        before = {n: p.detach().cpu().clone()
                  for n, p in tc.explainer.named_parameters()}
        tc(batch, draws)
        tg(cs.to_device(batch, dev), cs.to_device(draws, dev))
        torch.cuda.synchronize()
        pc = dict(tc.explainer.named_parameters())
        report = []
        worst_replay = 0.0
        for name, p in tg.explainer.named_parameters():
            c = pc[name]
            if c.grad is None:
                continue
            gg, gc = p.grad.cpu(), c.grad
            top = gc.abs().max().item()
            diff = (p.detach().cpu() - c.detach()).abs()
            st_g = tg.optimizer.state[p]
            st_c = tc.optimizer.state[c]
            over = (diff > cs.LR * 1.001).nonzero().tolist()
            if name == "attention.fc1.weight" or over:
                idx = torch.argsort(diff.reshape(-1), descending=True)[:5]
                for flat in idx.tolist():
                    ij = tuple(int(x) for x in torch.unravel_index(
                        torch.tensor(flat), diff.shape))
                    report.append(dict(
                        name=name, entry=ij, diff=diff[ij].item(),
                        grad_card=gg[ij].item(), grad_cpu=gc[ij].item(),
                        grad_top=top,
                        start_exp_avg=0.0, start_exp_avg_sq=0.0,
                        start_step=0,
                        exp_avg_card=st_g["exp_avg"][ij].item(),
                        exp_avg_cpu=st_c["exp_avg"][ij].item(),
                        exp_avg_sq_card=st_g["exp_avg_sq"][ij].item(),
                        exp_avg_sq_cpu=st_c["exp_avg_sq"][ij].item(),
                        update_card=(p.detach().cpu()[ij]
                                     - before[name][ij]).item(),
                        update_cpu=(c.detach()[ij]
                                    - before[name][ij]).item(),
                        over_lr=len(over)))
            want = adam_replay(before[name], gg, None, cs.LR)
            err = (p.detach().cpu().double() - want).abs()
            tol = 1e-6 + 1e-5 * want.abs()
            worst_replay = max(worst_replay, (err / tol).max().item())
        for r in report:
            print(json.dumps(r), flush=True)
        print(f"replay check: worst err/tol {worst_replay:.4f} "
              f"(pass if <= 1)", flush=True)
        print(f"probe {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
