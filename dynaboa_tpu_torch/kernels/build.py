"""Build the port's CUDA sources into plain-C shared libraries and load them
with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash covers the source and the flags, so
an edited source rebuilds).  The build happens at first use, never at
import; the directory is listed in ``.gitignore``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float      # compile time; 0.0 when an up-to-date build existed
    ptxas_log: str      # nvcc's -Xptxas -v report (registers, smem, spills)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of dynaboa_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (if needed) and load it."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src}:\n{log}")
        os.replace(tmp, out)
    return BuiltLibrary(lib=ctypes.CDLL(out), path=out, seconds=seconds,
                        ptxas_log=log)
