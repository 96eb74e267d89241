"""The CUDA-core float32 attention designs, kept for comparison.

``csrc/sa_attention_cuda_cores.cu`` and ``csrc/sa_attention_bwd_cuda_cores.cu``
hold the first float32 designs of the attention kernels, on the CUDA cores,
which the split-precision tensor-core designs of ``csrc/sa_attention.cu`` and
``csrc/sa_attention_bwd.cu`` replaced. :mod:`warpedganspace_torch.ops.attn_cuda`
never calls them; ``chip_smoke.py``, ``scripts/ablate_attention_cuda.py``,
``scripts/measure_attention_f32_error.py`` and the card tests time or check the
shipped designs against them. Both functions take float32 CUDA tensors only,
launch on the current stream and count nothing.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "sa_attention_cuda_cores.cu"
BWD_SOURCE = "sa_attention_bwd_cuda_cores.cu"


def cc_forward(theta, phi, g, want_lse: bool = False):
    """(out, lse) of the CUDA-core forward through its C entry
    ``sa_attention_cc_launch``; lse is None unless asked for."""
    from warpedganspace_torch.ops._build import load_library

    fn = load_library(SOURCE).sa_attention_cc_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, n, dk = theta.shape
    m, dv = g.shape[1], g.shape[2]
    out = torch.empty((b, n, dv), dtype=torch.float32, device=theta.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=theta.device) if want_lse else None
    err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
             lse.data_ptr() if want_lse else None, b, n, m, dk, dv,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sa_attention_cc_launch failed: cudaError {err}")
    return out, lse


def cc_backward(theta, phi, g, out, lse, ct):
    """(dtheta, dphi, dg) of the CUDA-core backward through its C entry
    ``sa_attention_bwd_cc_launch``, from the forward's out and lse."""
    from warpedganspace_torch.ops._build import load_library

    fn = load_library(BWD_SOURCE).sa_attention_bwd_cc_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, n, dk = theta.shape
    m, dv = g.shape[1], g.shape[2]
    grads = tuple(torch.empty_like(t) for t in (theta, phi, g))
    rdot = torch.empty((b, n), dtype=torch.float32, device=theta.device)
    err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(), ct.data_ptr(),
             lse.data_ptr(), rdot.data_ptr(), *(t.data_ptr() for t in grads), b, n, m, dk, dv,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sa_attention_bwd_cc_launch failed: cudaError {err}")
    return grads
