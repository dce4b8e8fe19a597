"""Build the CUDA kernels from ``csrc/`` on first use and bind them with ctypes.

Every ``csrc/*.cu`` has a plain C interface; one ``nvcc`` call compiles
them all into one shared library under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``). The library's file name carries a
hash of the sources and the flags, so an edited source is never served a
stale build.

Nothing is built or loaded when a module is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fmad=false: no multiply-add contraction anywhere; the kernels round every
# product and sum as their plain versions do (they also spell it out with
# __fmul_rn/__fadd_rn). No --use_fast_math: divisions stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


class LaunchCount:
    """Launches of one kernel: its wrapper adds one where it launches."""

    def __init__(self) -> None:
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    found = (os.path.join(home, "bin", "nvcc") if home
             else shutil.which("nvcc"))
    if not found or not os.path.exists(found):
        from torch.utils.cpp_extension import CUDA_HOME
        found = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source on first use")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if it is not built yet. Returns the compiler's
    log (register and shared-memory use, from ``-Xptxas=-v``), empty when
    the library was already there."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    os.replace(tmp, out)          # another process may be loading `out`
    return proc.stdout


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(library_path()))
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
