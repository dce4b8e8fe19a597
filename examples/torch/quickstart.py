"""Quickstart: train a tiny model with Local AdaAlter (paper Alg. 4), on
the PyTorch port.

The port's counterpart of ``examples/quickstart.py``: config ->
``train_loop`` -> metrics, and the communication accounting that is the
paper's point (Local AdaAlter moves 2/H of fully synchronous AdaGrad's
bytes a step). Runs on the card by default; ``--device cpu`` runs it on
the CPU (a few seconds).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import sys

from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                 reduced)
from repro_torch.core.comm import sync_bytes_per_step
from repro_torch.launch.train import train_loop
from repro_torch.models.counting import count_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)

    cfg = reduced(get_arch("qwen2-7b"), n_layers=2, d_model=128, vocab=256)
    shape = ShapeConfig(name="tiny", seq_len=64, global_batch=8, kind="train")
    n_params = count_params(cfg)
    print(f"model: {cfg.name} ({n_params:,} params) on {args.device}")

    for name, H in [("adagrad", 1), ("local_adaalter", 4)]:
        opt = OptimizerConfig(name=name, lr=0.5, H=H, warmup_steps=20)
        res = train_loop(cfg, shape, opt, steps=args.steps, verbose=False,
                         device=args.device)
        comm = sync_bytes_per_step(name, n_params, H)
        print(f"{name:16s} H={H}  final loss {res.final_loss:7.4f}  "
              f"avg comm/step {comm / 1e6:6.2f} MB "
              f"({'%.0f%% of sync AdaGrad' % (100 * comm / (4 * n_params))})")


if __name__ == "__main__":
    sys.exit(main())
