"""End-to-end driver: train a ~100M-parameter model, checkpointed and
restartable, on the PyTorch port.

The port's counterpart of ``examples/train_100m.py``: the paper's Big LSTM
family at a width where the embedding, the softmax and two LSTMP layers
land near 100M parameters (the paper's own model is ~1B because of its
793k-word vocabulary). Local AdaAlter (H=4) with warm-up, a checkpoint
every ``--checkpoint-every`` steps in the JAX package's format (either
package restores it); run it again with a larger ``--steps`` and it
resumes from the last checkpoint. Runs on the card by default;
``--device cpu`` runs it on the CPU (slow at 100M: use a few steps).

  PYTHONPATH=src python examples/torch/train_100m.py --steps 300
  PYTHONPATH=src python examples/torch/train_100m.py --steps 600  # resumes
"""
import argparse
import os
import tempfile

from repro_torch.configs import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.launch.train import train_loop
from repro_torch.models.counting import count_params


def make_100m_lstm() -> ModelConfig:
    # 2 LSTMP layers d=2048/proj 512 (the paper's real width) + 75k vocab
    # x 512 embed + full softmax = ~96M params
    return ModelConfig(
        name="biglstm-100m", family="lstm", n_layers=2, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=75000, lstm_proj=512,
        act="", param_dtype="float32",
        source="LSTM-2048-512 of Jozefowicz et al. (paper's model), scaled")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--H", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="",
                    help="write the run's losses and steps as JSON")
    args = ap.parse_args(argv)

    cfg = make_100m_lstm()
    print(f"{cfg.name}: {count_params(cfg):,} params on {args.device}")
    shape = ShapeConfig(name="e2e", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    opt = OptimizerConfig(name="local_adaalter", lr=0.5, H=args.H,
                          warmup_steps=min(100, args.steps // 3))
    res = train_loop(cfg, shape, opt, steps=args.steps,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every, log_every=10,
                     device=args.device)
    print(f"final loss {res.final_loss:.4f} after steps {res.start_step}-"
          f"{res.start_step + res.steps} ({res.wall_s:.0f}s)")
    if args.out:
        import json
        with open(args.out, "w") as f:
            json.dump({"start_step": res.start_step, "steps": res.steps,
                       "losses": res.losses}, f)


if __name__ == "__main__":
    main()
