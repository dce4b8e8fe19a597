"""Reproduce the paper's Figure 3 / Table 2 structure at small scale, on
the PyTorch port.

The port's counterpart of ``examples/reproduce_paper.py``. Trains the
paper's own architecture family (Big LSTM, reduced) on the synthetic
non-IID LM stream with each algorithm the paper compares:

  * Distributed AdaGrad  (Alg. 1)  — fully synchronous baseline
  * Distributed AdaAlter (Alg. 3)  — same comm, new accumulator ordering
  * Local AdaAlter       (Alg. 4)  — H in {4, 8, 16}

and reports final train PPL beside the *modeled* time per step of the
paper's time model (``core.comm.step_time``: a fixed compute time plus the
amortized all-reduce of each round). The times come from the H100 fabric
model (``core.comm.FabricModel``: NVLink at 450 GB/s, an assumed 10 µs a
collective), not from a measurement; only their ratios matter. Runs on
the card by default; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/torch/reproduce_paper.py [--steps 150] \\
      [--device cpu]
"""
import argparse

from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                 reduced)
from repro_torch.core.comm import FabricModel, step_time
from repro_torch.launch.train import train_loop
from repro_torch.models.counting import count_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--workers", type=int, default=8,
                    help="worker count of the time model (paper: 8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch("biglstm"), vocab=512)
    shape = ShapeConfig(name="paper", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    n_params = count_params(cfg)
    # time model: a fixed compute time stands in for the paper's GPU step;
    # the rounds' all-reduces priced on the H100 fabric. Only RATIOS matter.
    fabric = FabricModel()
    compute_s = 0.1

    runs = [("adagrad", 1), ("adaalter", 1),
            ("local_adaalter", 4), ("local_adaalter", 8),
            ("local_adaalter", 16)]
    print(f"{'method':20s} {'H':>3s} {'final loss':>11s} {'final PPL':>10s} "
          f"{'model step (ms)':>16s} {'epoch time vs AdaGrad':>22s}")
    t_base = None
    for name, H in runs:
        opt = OptimizerConfig(name=name, lr=0.5, H=H, warmup_steps=50)
        res = train_loop(cfg, shape, opt, steps=args.steps, verbose=False,
                         device=args.device)
        t = step_time(name, n_params, compute_s, args.workers, H, fabric)
        t_base = t_base or t
        print(f"{name:20s} {H:3d} {res.final_loss:11.4f} "
              f"{min(res.ppl[-1], 1e6):10.2f} {t * 1e3:16.4f} "
              f"{100 * t / t_base:21.1f}%")
    print("\npaper claim: Local AdaAlter reaches comparable PPL with ~30% "
          "less wall time; larger H saves more time at slightly worse PPL.")


if __name__ == "__main__":
    main()
