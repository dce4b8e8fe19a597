"""Build the CUDA kernels from ``csrc/`` on first use and bind them with ctypes.

Every ``csrc/*.cu`` has a plain C interface (the ``*.cuh`` headers hold
device code they share). One ``nvcc`` process per source compiles them
all at once, and one more links the objects into one shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The library's file name carries a hash of the sources, the headers and
the flags, so an edited file is never served a stale build.

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
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

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


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
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
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]     # all compile at once
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    tmp = out.with_name(f"{tag}.tmp.so")
    link = subprocess.run([_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode:
        raise RuntimeError(f"nvcc failed to link:\n{link.stdout}")
    os.replace(tmp, out)          # another process may be loading `out`
    return "\n".join(logs)


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
