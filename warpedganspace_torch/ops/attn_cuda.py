"""SA-GAN spatial attention through the hand-written CUDA kernel.

Counterpart of :mod:`warpedganspace_tpu.ops.attn_pallas` (forward). The kernel
(``csrc/sa_attention.cu``) computes, for every sample b and query row n,

    out[b, n, :] = sum_m softmax_m(theta[b, n, :] . phi[b, m, :]) * g[b, m, :]

with the softmax in float32 (running row maximum subtracted), both products
accumulated in float32, and the (B, N, M) attention matrix never written to
device memory. Inputs and output are float32 or bfloat16.

- :func:`sa_attention` is the entry point. On CPU tensors it runs the plain
  version :func:`warpedganspace_torch.ops.attn.sa_attention_plain`; on CUDA
  tensors it launches the kernel or raises. The kernel takes every N, M and dv
  (ragged edges are masked) and dk up to the limit the library reports.
- Its backward differentiates the plain version. A backward *kernel* (the
  counterpart of ``_attn_bwd_kernel``) belongs to BigGAN training and is not
  part of this module yet.

``launches`` counts kernel launches; it is a plain int the caller may reset.
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.attn import sa_attention_plain

SOURCE = "sa_attention.cu"
launches = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.sa_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sa_attention_max_dk.argtypes = []
    lib.sa_attention_max_dk.restype = ctypes.c_int
    return lib


def _launch(theta, phi, g):
    """Check the operands, allocate the output and launch on the current stream."""
    global launches
    if theta.dim() != 3 or phi.dim() != 3 or g.dim() != 3:
        raise ValueError("theta, phi and g must be (B, N, dk), (B, M, dk), (B, M, dv); got "
                         f"{tuple(theta.shape)}, {tuple(phi.shape)}, {tuple(g.shape)}")
    b, n, dk = theta.shape
    m, dv = g.shape[1], g.shape[2]
    if tuple(phi.shape) != (b, m, dk) or g.shape[0] != b:
        raise ValueError(f"theta {tuple(theta.shape)}, phi {tuple(phi.shape)} and "
                         f"g {tuple(g.shape)} do not match")
    if theta.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention operands must be float32 or bfloat16, got {theta.dtype}")
    if phi.dtype != theta.dtype or g.dtype != theta.dtype:
        raise TypeError("theta, phi and g must share one dtype, got "
                        f"{theta.dtype}, {phi.dtype}, {g.dtype}")
    if phi.device != theta.device or g.device != theta.device:
        raise ValueError("all attention operands must be on one device")
    if not (theta.is_contiguous() and phi.is_contiguous() and g.is_contiguous()):
        raise ValueError("attention operands must be contiguous")
    if m < 1 or dk < 1:
        raise ValueError(f"the attention needs at least one key and one feature, got M={m}, dk={dk}")
    lib = build()
    if dk > lib.sa_attention_max_dk():
        raise ValueError(f"the attention kernel takes dk <= {lib.sa_attention_max_dk()} "
                         f"(its shared-memory tile), got {dk}")
    out = torch.empty((b, n, dv), dtype=theta.dtype, device=theta.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.sa_attention_launch(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
            int(theta.dtype == torch.bfloat16), b, n, m, dk, dv, stream)
    if err != 0:
        raise RuntimeError(f"sa_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


class _SAAttention(torch.autograd.Function):
    """Kernel forward; backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        ctx.save_for_backward(theta, phi, g)
        return _launch(theta, phi, g)

    @staticmethod
    def backward(ctx, ct):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = sa_attention_plain(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def sa_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(theta @ phi^T) @ g without materializing the attention matrix.

    theta (B, N, dk), phi (B, M, dk), g (B, M, dv) -> (B, N, dv) in
    ``theta.dtype``; softmax in float32. CUDA tensors go through the kernel
    (or raise), CPU tensors through the plain version.
    """
    if not theta.is_cuda:
        return sa_attention_plain(theta, phi, g)
    return _SAAttention.apply(theta, phi, g)
