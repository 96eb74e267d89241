"""The CUDA-core design of the RBF warp kernel, kept for comparison.

``csrc/rbf_warp_cuda_cores.cu`` holds the first design of the warp kernel, on
the CUDA cores, which the tensor-core design of ``csrc/rbf_warp.cu`` replaced.
:mod:`warpedganspace_torch.ops.rbf_cuda` never calls it; ``chip_smoke.py``,
``scripts/ablate_warp_cuda.py`` and the card tests time or check the shipped
kernel against it, at the shapes of :data:`SHAPES`, with :func:`warp_cost` for
its bound. :func:`cuda_cores` takes CUDA tensors only, launches on the current
stream and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "rbf_warp_cuda_cores.cu"

# (name, K sets, 2N support vectors, d, R rows): the timed shape and the
# traversals' own (R = 2 x codes in the pool).
SHAPES = (("timed, 32 codes x +-", 200, 1024, 512, 64),
          ("ProgGAN eval pool", 200, 1024, 512, 16),
          ("StyleGAN2 eval pool", 200, 1024, 512, 12),
          ("ProgGAN smoke CLI", 200, 1024, 512, 2),
          ("BigGAN eval pool", 120, 512, 120, 8))


def warp_cost(k, n2, d, rows, elem):
    """(bytes, flops) of one call: the sets (elem bytes an element) and their
    three (K, 2N) f32 vectors read once, z read and the directions written
    once; the two contractions' 2 * K * R * 2N * d multiply-adds."""
    return (elem * k * n2 * d + 4 * 3 * k * n2 + 4 * 2 * k * rows * d,
            2 * 2 * k * rows * n2 * d)


def cuda_cores():
    """The CUDA-core design (one launch, no scratch), built from its source:
    run(ws, z) -> directions, for the sets ``ws`` of
    :func:`~warpedganspace_torch.ops.rbf_cuda.prepare_warp_sets` (f32 or bf16)
    and codes z (K, R, d) on the card."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.rbf_warp_cc_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(ws, z):
        k, n2, d = ws.sv.shape
        out = torch.empty_like(z)
        err = fn(ws.sv.data_ptr(), int(ws.sv.dtype == torch.bfloat16), ws.g.data_ptr(),
                 ws.ag.data_ptr(), ws.svsq.data_ptr(), z.data_ptr(), out.data_ptr(), k, n2,
                 z.shape[1], d, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA-core warp launch failed: cudaError {err}")
        return out
    return run
