"""SA-GAN spatial attention through the hand-written CUDA kernels.

Counterpart of :mod:`warpedganspace_tpu.ops.attn_pallas`. The forward kernel
(``csrc/sa_attention.cu``) computes, for every sample b and query row n,

    out[b, n, :] = sum_m softmax_m(theta[b, n, :] . phi[b, m, :]) * g[b, m, :]

with the softmax in float32 (running row maximum subtracted), both products
accumulated in float32, and the (B, N, M) attention matrix never written to
device memory. The backward kernel (``csrc/sa_attention_bwd.cu``) computes
dtheta, dphi and dg from the cotangent of ``out`` by recomputing the softmax
from one saved float32 per query (the row's log-sum-exp); it too writes no
(B, N, M) matrix. Inputs, outputs and gradients are float32 or bfloat16.

Each kernel has two designs, chosen inside its C launch function by the
operands' type (:func:`design` and :func:`bwd_design` say which), both on the
tensor cores (``mma.sync`` with float32 accumulation). bfloat16 operands are
multiplied as they are (the softmax weights and, in the backward, ds are
rounded to bf16 before their products, as the plain bf16 versions and the TPU
kernels do). float32 operands are multiplied in split precision: each is
carried as two TF32 pieces, hi and lo, and a product is three TF32 products
(lo hi, hi lo, hi hi), which keeps about 22 bits of each operand; one TF32
product alone keeps 11, too few for the float32 bounds
(``tests/test_torch_attn_f32_split_numerics.py`` emulates both). The weights
and ds stay float32 values there. The CUDA-core float32 designs these
replaced stay in their own sources (``csrc/sa_attention_cuda_cores.cu``,
``csrc/sa_attention_bwd_cuda_cores.cu``), bound by
:mod:`warpedganspace_torch.ops.attn_cuda_cores` for comparison; nothing here
reaches them.

- :func:`sa_attention` is the entry point. On CPU tensors it runs the plain
  version :func:`warpedganspace_torch.ops.attn.sa_attention_plain` (and
  autograd differentiates that); on CUDA tensors it launches the forward
  kernel, and its backward launches the backward kernel, or raises. Nothing on
  a CUDA tensor's path falls back to the plain versions.
- :func:`sa_attention_bwd` calls the backward on its own (the smoke test and
  the card tests hold it against
  :func:`warpedganspace_torch.ops.attn.sa_attention_bwd_plain`).
- The forward kernel takes every N, M and dv (ragged edges are masked) and dk
  up to the limit its library reports. The backward kernel keeps both row
  operands in shared memory (the bf16 design also its lanes' f32 sums), so
  besides the same dk limit it has a dv limit that depends on dk (dk=24 with
  dv up to 264 and dk=48 with dv=192 fit; the smaller of the two designs'
  limits); above the limits the wrapper raises.

``launches`` counts forward-kernel launches and ``bwd_launches`` backward
launches (one per call: the backward's two passes and its row-dot prologue are
one launch of the wrapper); both are plain ints the caller may reset.
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

SOURCE = "sa_attention.cu"
BWD_SOURCE = "sa_attention_bwd.cu"
launches = 0
bwd_launches = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the forward kernel's library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.sa_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sa_attention_max_dk.argtypes = []
    lib.sa_attention_max_dk.restype = ctypes.c_int
    lib.sa_attention_design.argtypes = [ctypes.c_int]
    lib.sa_attention_design.restype = ctypes.c_char_p
    return lib


def build_bwd() -> ctypes.CDLL:
    """Compile (once per source hash) and load the backward kernel's library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(BWD_SOURCE)
    fn = lib.sa_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sa_attention_bwd_max_dk.argtypes = []
    lib.sa_attention_bwd_max_dk.restype = ctypes.c_int
    lib.sa_attention_bwd_max_dv.argtypes = [ctypes.c_int]
    lib.sa_attention_bwd_max_dv.restype = ctypes.c_int
    lib.sa_attention_bwd_design.argtypes = [ctypes.c_int]
    lib.sa_attention_bwd_design.restype = ctypes.c_char_p
    return lib


def design(dtype: torch.dtype) -> str:
    """Which design of the forward kernel serves operands of ``dtype``."""
    return build().sa_attention_design(int(dtype == torch.bfloat16)).decode()


def bwd_design(dtype: torch.dtype) -> str:
    """Which design of the backward kernel serves operands of ``dtype``."""
    return build_bwd().sa_attention_bwd_design(int(dtype == torch.bfloat16)).decode()


def _check_operands(theta, phi, g):
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
    return b, n, m, dk, dv


def _launch(theta, phi, g, want_lse: bool = False):
    """Check the operands, allocate the output and launch on the current stream.

    Returns (out, lse); lse is the (B, N) float32 log-sum-exp of every row's
    logits when ``want_lse`` (what the backward kernel needs), else None.
    """
    global launches
    b, n, m, dk, dv = _check_operands(theta, phi, g)
    lib = build()
    if dk > lib.sa_attention_max_dk():
        raise ValueError(f"the attention kernel takes dk <= {lib.sa_attention_max_dk()} "
                         f"(its shared-memory tile), got {dk}")
    out = torch.empty((b, n, dv), dtype=theta.dtype, device=theta.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=theta.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.sa_attention_launch(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            int(theta.dtype == torch.bfloat16), b, n, m, dk, dv, stream)
    if err != 0:
        raise RuntimeError(f"sa_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out, lse


def _launch_bwd(theta, phi, g, out, lse, ct):
    """Launch the backward kernel on the current stream: (dtheta, dphi, dg)."""
    global bwd_launches
    b, n, m, dk, dv = _check_operands(theta, phi, g)
    for name, t, shape, dtype in (("out", out, (b, n, dv), theta.dtype),
                                  ("ct", ct, (b, n, dv), theta.dtype),
                                  ("lse", lse, (b, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != theta.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {theta.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build_bwd()
    if dk > lib.sa_attention_bwd_max_dk():
        raise ValueError(f"the attention backward kernel takes dk <= "
                         f"{lib.sa_attention_bwd_max_dk()} (its shared-memory tile), got {dk}")
    if dv > lib.sa_attention_bwd_max_dv(dk):
        raise ValueError(f"the attention backward kernel takes dv <= "
                         f"{lib.sa_attention_bwd_max_dv(dk)} beside dk = {dk} (both stay in "
                         f"shared memory), got {dv}")
    dtheta, dphi, dg = torch.empty_like(theta), torch.empty_like(phi), torch.empty_like(g)
    if theta.numel() == 0 or dv == 0:
        return dtheta.zero_(), dphi.zero_(), dg.zero_()
    rdot = torch.empty((b, n), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.sa_attention_bwd_launch(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(), ct.data_ptr(),
            lse.data_ptr(), rdot.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(), dg.data_ptr(),
            int(theta.dtype == torch.bfloat16), b, n, m, dk, dv, stream)
    if err != 0:
        raise RuntimeError(f"sa_attention backward kernel launch failed: cudaError {err}")
    bwd_launches += 1
    return dtheta, dphi, dg


class _SAAttention(torch.autograd.Function):
    """Kernel forward and kernel backward."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        need = any(ctx.needs_input_grad)
        out, lse = _launch(theta, phi, g, want_lse=need)
        if need:
            ctx.save_for_backward(theta, phi, g, out, lse)
        return out

    @staticmethod
    def backward(ctx, ct):
        theta, phi, g, out, lse = ctx.saved_tensors
        # The kernel always computes all three (training needs all three).
        grads = _launch_bwd(theta, phi, g, out, lse, ct.contiguous())
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))


def sa_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(theta @ phi^T) @ g without materializing the attention matrix.

    theta (B, N, dk), phi (B, M, dk), g (B, M, dv) -> (B, N, dv) in
    ``theta.dtype``; softmax in float32. CUDA tensors go through the kernels
    (forward and, under autograd, backward) or raise; CPU tensors through the
    plain version.
    """
    if not theta.is_cuda:
        return sa_attention_plain(theta, phi, g)
    return _SAAttention.apply(theta, phi, g)


def sa_attention_bwd(theta, phi, g, ct, saved=None):
    """(dtheta, dphi, dg) of :func:`sa_attention` for the cotangent ``ct``.

    On CUDA tensors this launches the backward kernel (or raises). ``saved`` is
    the forward's ``(out, lse)`` as :func:`sa_attention_saved` returns them;
    without it the forward kernel is launched first to make them. CPU tensors
    go through :func:`warpedganspace_torch.ops.attn.sa_attention_bwd_plain`.
    """
    if not theta.is_cuda:
        return sa_attention_bwd_plain(theta, phi, g, ct)
    out, lse = sa_attention_saved(theta, phi, g) if saved is None else saved
    return _launch_bwd(theta, phi, g, out, lse, ct)


def sa_attention_saved(theta, phi, g):
    """The forward kernel's (out, lse) on CUDA tensors: what the backward keeps."""
    return _launch(theta, phi, g, want_lse=True)
