"""End-to-end serving driver: batched requests against a small model, on
the PyTorch port.

The port's counterpart of ``examples/serve_batched.py``. Builds a reduced
member of an architecture family (default: the hybrid attention + SSM
hymba, the interesting decode path), prefills a batch of prompts and
greedy-decodes continuations: the prefill -> KV cache / recurrent state
-> decode_step pipeline that the dry-run's ``decode_32k`` and
``long_500k`` shapes walk. Runs on the card by default; ``--device cpu``
runs it on the CPU.

  PYTHONPATH=src python examples/torch/serve_batched.py --arch hymba-1.5b
"""
import argparse

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.serve import serve_session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    print(f"serving {cfg.name} ({cfg.family}) on {args.device} — "
          f"batch={args.batch}, prompt={args.prompt_len}, "
          f"new={args.new_tokens}")
    gen, tps = serve_session(cfg, batch=args.batch,
                             prompt_len=args.prompt_len,
                             new_tokens=args.new_tokens, device=args.device,
                             verbose=False)
    print(f"{tps:.1f} tok/s; generations:")
    for i, row in enumerate(gen):
        print(f"  request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
