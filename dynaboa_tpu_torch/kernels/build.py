"""Build the port's native sources into plain-C shared libraries and load
them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so``; the host library of ``csrc/native/*.cpp``
compiles with the host C++ compiler (``$CXX``, default ``g++``) and the
flags of ``native/Makefile`` less OpenMP.  The hash covers the sources
(with the CUDA headers ``csrc/*.cuh``) and the flags, so an edited source
rebuilds.  The build happens at first use,
never at import; the directory is listed in ``.gitignore``.  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# native/Makefile's CXXFLAGS (before the sources) and LDFLAGS (after them),
# without -fopenmp: the toolchain of the machine with the card has no
# libgomp.  The one OpenMP loop (imageops' crop, which no path of the port
# calls) runs over independent output pixels, so its results are the same
# on one thread.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wno-unknown-pragmas")
CXX_LDFLAGS = ("-shared",)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float      # compile time; 0.0 when an up-to-date build existed
    ptxas_log: str      # the compiler's report (nvcc: registers, smem, spills)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of dynaboa_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def find_cxx() -> str:
    name = os.environ.get("CXX", "g++")
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found: the native "
                           "host library of dynaboa_tpu_torch is built with it")
    return path


def _compile(name: str, sources: list[str], head: list[str],
             tail: tuple[str, ...] = (), key: str = "",
             headers: tuple[str, ...] = ()) -> BuiltLibrary:
    """Run ``head + sources + tail -o out`` unless ``out``, named by the
    hash of the sources, the ``headers`` they include, the flags and
    ``key``, exists; then load it."""
    digest = hashlib.sha256(
        (" ".join(head[1:] + list(tail)) + key).encode())
    for src in (*sources, *headers):
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [*head, *sources, *tail, "-o", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(head[0])} failed "
                               f"({proc.returncode}) building {name} from "
                               f"{sources}:\n{log}")
        os.replace(tmp, out)
    return BuiltLibrary(lib=ctypes.CDLL(out), path=out, seconds=seconds,
                        ptxas_log=log)


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` with nvcc (if needed) and load it; the
    hash also covers the headers beside it (``csrc/*.cuh``)."""
    return _compile(name, [os.path.join(CSRC, f"{name}.cu")],
                    [find_nvcc(), *NVCC_FLAGS],
                    headers=tuple(sorted(glob.glob(os.path.join(CSRC,
                                                                "*.cuh")))))


def build_host(name: str, sources: list[str]) -> BuiltLibrary:
    """Compile host C++ sources (paths under ``csrc/``) into one library
    with the host compiler (if needed) and load it."""
    # -march=native code is built for this host's CPU: a checkout copied to
    # another machine builds its own
    return _compile(name, [os.path.join(CSRC, s) for s in sources],
                    [find_cxx(), *CXX_FLAGS], CXX_LDFLAGS,
                    key=platform.node())
