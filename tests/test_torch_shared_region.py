"""The shared region that gloo ranks on one host exchange their larger
collectives through (``core.comm.SharedRegion``).

Groups of 2, 3 and 4 gloo ranks on the CPU (``torch.distributed.run
--standalone``), each rank's bytes drawn from a seed of its own, so every
rank knows what every other sent:

  * ``RankGroup._all_gather`` and ``_all_to_all`` through the region give
    every rank exactly the bytes the process group moves (the region
    forced on with ``SHARED_MIN_BYTES`` at 0, then off), at sizes that make
    it grow, in several dtypes, with collectives of both routes between;
  * ``gather_mean_`` over the region is bitwise ``worker_mean_`` over the
    stacked rows;
  * the sub-groups a 2 x 2 grid opens (workers, shards) have regions of
    their own;
  * a group whose ranks cannot share a region (a rank fails to open it)
    falls back to the process group, on every rank alike;
  * a region opened under inference mode takes writes outside it;
  * a group laid out again unmaps the regions of the sub-groups it
    replaces, and closing the ranks unmaps every region a rank holds.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240

SCRIPT = r"""
import json, sys
import torch
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.sharding import GridLayout

spec = json.load(open(sys.argv[1]))
group, dev = mesh.init_ranks("gloo", "cpu")
R, me = group.world, group.rank
out = {"rank": me, "checks": []}

def bytes_of(rank, n, salt):
    g = torch.Generator().manual_seed(1000 * salt + rank)
    return torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8)

def route(shared):
    comm.SHARED_MIN_BYTES = dict.fromkeys(("all_gather", "all_to_all"),
                                          0 if shared else 1 << 62)

def gather(g, n, salt, shared):
    route(shared)
    buf = bytes_of(g.rank, n, salt)
    got = torch.empty((g.world, n), dtype=torch.uint8)
    g._all_gather(got, buf)
    return got

def to_all(g, n, salt, shared):
    route(shared)
    send = bytes_of(g.rank, g.world * n, salt).view(torch.float32).view(
        g.world, -1)
    recv = torch.empty_like(send)
    g._all_to_all(recv, send)
    return recv

salt = 0
for n in spec["sizes"]:
    salt += 1
    # the first collective opens the region under inference mode (as a
    # serving forward may); the later ones write into it outside it
    with torch.inference_mode(salt == 1):
        a = gather(group, n, salt, True)
    b = gather(group, n, salt, False)
    want = torch.stack([bytes_of(r, n, salt) for r in range(R)])
    out["checks"].append(["all_gather", n, torch.equal(a, b),
                          torch.equal(a, want)])
    a, b = to_all(group, n, salt, True), to_all(group, n, salt, False)
    want = torch.stack([bytes_of(r, R * n, salt).view(torch.float32).view(
        R, -1)[me] for r in range(R)])
    # random bytes read as float32 hold NaNs: compare the bits
    bits = lambda t: t.view(torch.int32)
    out["checks"].append(["all_to_all", n, torch.equal(bits(a), bits(b)),
                          torch.equal(bits(a), bits(want))])
out["region_bytes"] = group._shared.size if group._shared else 0

# the sync mean over the region: worker_mean_ of the stacked rows, bitwise
route(True)
for dtype in (torch.float32, torch.bfloat16):
    rows = torch.stack([torch.randn(4099, generator=torch.Generator()
                                    .manual_seed(r)).to(dtype)
                        for r in range(R)])
    x = rows[me].clone()
    comm.gather_mean_(x, group)
    stacked = comm.worker_mean_(rows.clone())
    out["checks"].append(["gather_mean_", str(dtype),
                          torch.equal(x, stacked[me]), True])

if spec.get("grid"):
    group.split(GridLayout.of(spec["grid"]))
    for name, sub in (("workers", group.workers), ("shards", group.shards)):
        n = 3 << 20
        salt += 1
        a, b = gather(sub, n, salt, True), gather(sub, n, salt, False)
        out["checks"].append([name, n, torch.equal(a, b),
                              sub._shared not in (None, False)
                              and sub._shared is not group._shared])
    # laid out again: the sub-groups it replaces unmap their regions, and
    # the new ones open their own
    old = [group.workers._shared, group.shards._shared]
    group.split(GridLayout.of(spec["grid"]))
    salt += 1
    a, b = gather(group.shards, 1 << 20, salt, True), gather(
        group.shards, 1 << 20, salt, False)
    out["checks"].append(["relaid", 1 << 20, torch.equal(a, b),
                          all(r.bytes is None and r.size == 0 for r in old)
                          and group.shards._shared.size >= 1 << 20])

if spec.get("refuse"):
    # rank 1 cannot open the region: every rank moves the bytes through
    # the process group
    sub = comm.RankGroup(dev, torch.distributed.new_group(list(range(R))))
    import os
    real = os.open
    if me == 1:
        def refuse(*a, **k):
            raise PermissionError("refused")
        os.open = refuse
    a = gather(sub, 1 << 20, 99, True)
    os.open = real
    want = torch.stack([bytes_of(r, 1 << 20, 99) for r in range(R)])
    out["checks"].append(["refused", 1 << 20, torch.equal(a, want),
                          sub._shared is False])

every = [None] * R
torch.distributed.all_gather_object(every, out)
held = [g._shared for g in (group, group.workers, group.shards)
        if g is not None and g._shared not in (None, False)]
mesh.close_ranks()
# closing the ranks unmaps every region this rank held
json.dump([r.bytes is None for r in held], open(f"{sys.argv[2]}.{me}", "w"))
if me == 0:
    json.dump(every, open(sys.argv[2], "w"))
"""


def _launch(tmp: Path, nproc: int, spec: dict) -> list:
    script, spec_path, out = (tmp / "ranks.py", tmp / "spec.json",
                              tmp / "out.json")
    script.write_text(SCRIPT)
    spec_path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", str(nproc),
                        str(script), str(spec_path), str(out)],
                       capture_output=True, text=True, env=env,
                       timeout=TIMEOUT, cwd=tmp)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    for r in range(nproc):
        closed = json.loads(Path(f"{out}.{r}").read_text())
        assert closed and all(closed), (r, closed)
    return json.loads(out.read_text())


@pytest.mark.parametrize("nproc,spec", [
    (2, {"sizes": [16, 1 << 20, 5 << 20 | 12], "refuse": True}),
    (3, {"sizes": [1 << 20, 3 << 20]}),
    (4, {"sizes": [1 << 20], "grid": {"data": 2, "model": 2}}),
], ids=["world2", "world3", "world4_grid"])
def test_shared_region_equals_process_group(tmp_path, nproc, spec):
    ranks = _launch(tmp_path, nproc, spec)
    assert [r["rank"] for r in ranks] == list(range(nproc))
    for rep in ranks:
        bad = [c for c in rep["checks"] if not (c[2] and c[3])]
        assert not bad, (rep["rank"], bad)
        # the region grew to a power of two at least the largest output
        largest = max(nproc * max(spec["sizes"]),
                      nproc * nproc * max(spec["sizes"]))
        assert rep["region_bytes"] >= largest
        assert rep["region_bytes"] & (rep["region_bytes"] - 1) == 0
