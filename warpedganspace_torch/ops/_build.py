"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`. The library
lands in ``build/warpedganspace_torch/`` at the root of the checkout, named by
a hash of the source, the headers beside it (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it is.
A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import time

PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(PKG_DIR, "csrc")
BUILD_DIR = osp.join(osp.dirname(PKG_DIR), "build", "warpedganspace_torch")
# -Xptxas=-v prints each kernel's registers, shared memory and spills once,
# when the library is built.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # source name -> seconds its last build took


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and osp.isfile(osp.join(CUDA_HOME, "bin", "nvcc")):
        return osp.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
                           "the package's CUDA kernels")
    return found


def _compile(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library is there; return the library's path."""
    src_path = osp.join(CSRC_DIR, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src_path] + sorted(glob.glob(osp.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = osp.splitext(source)[0]
    lib_path = osp.join(BUILD_DIR, f"{stem}-{digest}.so")
    if not osp.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        if proc.stderr.strip():
            print(proc.stderr.strip())
        os.replace(tmp, lib_path)
    return lib_path


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(_compile(source))
    return _LIBS[source]

