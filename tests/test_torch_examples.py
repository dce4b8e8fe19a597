"""The port's examples (``examples/torch/``) and the paper's time model.

* ``core.comm.step_time``, ``bytes_per_param`` and
  ``FabricModel.allreduce_time``, given the reference's fabric values,
  equal the reference's (``src/repro/core/comm.py``).
* Each of the four examples runs with ``--device cpu`` at a tiny size and
  exits 0; ``train_100m.py`` resumes from its checkpoint, and the resumed
  step's loss is the straight run's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import comm

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "torch"

#: the reference's FabricModel defaults (a TPU v5e's ICI and DCN)
REF_FABRIC = dict(ici_bw=50e9, dcn_bw=6.25e9, latency=20e-6)


@pytest.mark.parametrize("algorithm", ["none", "sgd", "adagrad", "adaalter",
                                       "local_sgd", "local_adaalter"])
def test_step_time_equals_reference(algorithm):
    from repro.core import comm as ref
    mine_f = comm.FabricModel(**REF_FABRIC)
    ref_f = ref.FabricModel(**REF_FABRIC)
    for n_params, compute, workers, H, cross, codec in (
            (832_198_527, 0.1, 8, 4, False, ""),
            (1_000_000, 0.02, 2, 16, True, "int8"),
            (7_615_616_512, 1.5, 256, 1, False, "bf16"),
            (10, 0.0, 1, 3, False, "")):
        got = comm.step_time(algorithm, n_params, compute, workers, H,
                             mine_f, cross_pod=cross, compression=codec)
        want = ref.step_time(algorithm, n_params, compute, workers, H,
                             ref_f, cross_pod=cross, compression=codec)
        assert got == want


def test_allreduce_time_and_bytes_per_param_equal_reference():
    from repro.core import comm as ref
    mine_f = comm.FabricModel(**REF_FABRIC)
    ref_f = ref.FabricModel(**REF_FABRIC)
    for nbytes, n, cross in ((1e9, 8, False), (3.3e9, 2, True),
                             (5.0, 1, False), (0.0, 16, False)):
        assert mine_f.allreduce_time(nbytes, n, cross) == \
            ref_f.allreduce_time(nbytes, n, cross)
    for d in (1, 2, 4, 8):
        assert comm.bytes_per_param(d) == ref.bytes_per_param(d)
    assert comm.bytes_per_param() == ref.bytes_per_param()
    # the port's default fabric is the H100's
    assert comm.FabricModel().ici_bw == 450e9
    assert comm.FabricModel().dcn_bw == 50e9


def _run(name, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(EXAMPLES / name),
                           "--device", "cpu", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_runs():
    out = _run("quickstart.py", "--steps", "6")
    assert "adagrad" in out and "local_adaalter" in out
    assert "50% of sync AdaGrad" in out


def test_reproduce_paper_runs():
    out = _run("reproduce_paper.py", "--steps", "3", "--batch", "4",
               "--seq", "16")
    assert out.count("local_adaalter") == 3 and "adaalter" in out
    assert "epoch time vs AdaGrad" in out


def test_serve_batched_runs_hymba_by_default():
    out = _run("serve_batched.py", "--batch", "2", "--prompt-len", "8",
               "--new-tokens", "3")
    assert "hymba-1.5b" in out and "request 1:" in out


def test_train_100m_resumes(tmp_path):
    # one checkpoint (~1.15 GB: the 96M model's fp32 params and two
    # accumulators) at step 2; the straight run writes none
    common = ["--batch", "2", "--seq", "4", "--checkpoint-every", "2"]
    a, b, c = (tmp_path / f"{k}.json" for k in "abc")
    _run("train_100m.py", "--steps", "2", "--checkpoint-dir",
         str(tmp_path / "ck"), "--out", str(a), *common)
    out = _run("train_100m.py", "--steps", "3", "--checkpoint-dir",
               str(tmp_path / "ck"), "--out", str(b), *common)
    assert "restored checkpoint at step 2" in out
    _run("train_100m.py", "--steps", "3", "--checkpoint-dir", "",
         "--out", str(c), *common)
    first, resumed, straight = (json.loads(p.read_text()) for p in (a, b, c))
    assert first["start_step"] == 0 and first["steps"] == 2
    assert resumed["start_step"] == 2 and resumed["steps"] == 1
    assert straight["losses"][:2] == first["losses"]
    assert resumed["losses"] == straight["losses"][2:]
