"""Walls of one all-gather and one all-to-all between gloo ranks on one
host, through the ranks' shared region (``core.comm.SharedRegion``) and
through the process group, at output sizes from 1 KiB to 64 MiB: where
the region starts to pay for its two barriers
(``core.comm.SHARED_MIN_BYTES``).

The buffers live in host memory, as a staged collective's do once they
are off the card, so the walls are the exchange alone. Each size is timed
``--reps`` times a route (after two warm calls), the routes alternating;
rank 0 prints one JSON line: the median microseconds a call by world,
collective, size and route.

  PYTHONPATH=src python tools/collective_walls.py [--worlds 2 4]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SIZES = [1 << k for k in range(10, 27, 2)]       # 1 KiB .. 64 MiB


def rank_main(spec_path: str, out_path: str) -> None:
    import torch
    from repro_torch.core import comm
    from repro_torch.launch import mesh
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    group, _ = mesh.init_ranks("gloo", "cpu")
    R = group.world
    routes = {"region": 0, "process_group": 1 << 62}
    walls = {}
    for n in spec["sizes"]:
        per = max(n // (R * R), 1) * R         # a rank's bytes, R rows
        buf = torch.full((per,), group.rank, dtype=torch.uint8)
        out = torch.empty((R, per), dtype=torch.uint8)
        send = buf.view(R, -1)
        recv = torch.empty_like(send)
        calls = {"all_gather": lambda: group._all_gather(out, buf),
                 "all_to_all": lambda: group._all_to_all(recv, send)}
        for name, call in calls.items():
            got = {r: [] for r in routes}
            for i in range(spec["reps"] + 2):
                for route, floor in routes.items():
                    comm.SHARED_MIN_BYTES = dict.fromkeys(calls, floor)
                    torch.distributed.barrier()
                    t0 = time.perf_counter()
                    call()
                    if i >= 2:
                        got[route].append(1e6 * (time.perf_counter() - t0))
            walls.setdefault(name, {})[str(R * per)] = {
                r: statistics.median(v) for r, v in got.items()}
    if group.rank == 0:
        Path(out_path).write_text(json.dumps(walls))
    mesh.close_ranks()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    result = {"unit": "us per call, median", "reps": args.reps,
              "walls": {}}
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "spec.json"
        spec.write_text(json.dumps({"sizes": args.sizes,
                                    "reps": args.reps}))
        for R in args.worlds:
            out = Path(tmp) / f"walls_{R}.json"
            subprocess.run([sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc-per-node", str(R),
                            __file__, "--rank", str(spec), str(out)],
                           env=env, check=True, timeout=600)
            result["walls"][str(R)] = json.loads(out.read_text())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:4])
    else:
        sys.exit(main())
