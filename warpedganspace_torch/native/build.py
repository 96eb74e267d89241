"""Build ``sfd_post.cpp`` with ``g++`` at first use and bind it with ctypes.

The library lands in the port's build directory, ``build/warpedganspace_torch/``
at the root of the checkout (the directory of the CUDA kernels, which git
ignores), named by a hash of the source, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess

from warpedganspace_torch.ops._build import BUILD_DIR

SOURCE = osp.join(osp.dirname(osp.abspath(__file__)), "sfd_post.cpp")

_state = {"lib": None, "error": None}


def _build() -> ctypes.CDLL:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = osp.join(BUILD_DIR, f"sfd_post-{digest}.so")
    if not osp.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # A temporary name per process: builds racing in parallel workers must
        # not publish a half-written library.
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.wgs_nms.restype = ctypes.c_int
    lib.wgs_nms.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int)]
    return lib


def load_native():
    """The ctypes library, built on first use; None where it cannot be built
    (no ``g++``, or it failed: :func:`native_error` says why), and the callers
    run their numpy versions."""
    if _state["lib"] is None and _state["error"] is None:
        try:
            _state["lib"] = _build()
        except (OSError, subprocess.CalledProcessError) as e:
            _state["error"] = f"{type(e).__name__}: {e}" + (
                f"\n{e.stderr}" if isinstance(e, subprocess.CalledProcessError) else "")
    return _state["lib"]


def native_error():
    """Why the native library could not be built or loaded, or None."""
    return _state["error"]
