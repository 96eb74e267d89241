"""All-sets RBF warp directions through the hand-written CUDA kernel.

Counterpart of :mod:`warpedganspace_tpu.ops.rbf_pallas`. The kernel
(``csrc/rbf_warp.cu``) computes, for every set k and set-major row z (K, R, d),

    w_j = ag_j * exp(-g_j * (||z||^2 - 2 z.sv_j + svsq_j))
    out = normalize(-2 (sum_j w_j) z + 2 sum_j w_j sv_j)

in one pass over the sets, with f32 dot products and accumulation whether sv
is stored in f32 or bf16.

- :func:`prepare_warp_sets` packs the sets once (``g = gamma``,
  ``ag = alpha * gamma``, ``svsq = ||sv||^2`` in f32 before any bf16 cast), so
  a traversal does it outside its step loop. No padding is needed: the kernel
  masks its ragged edges.
- :func:`warp_grad_all_sets_kn` is the set-major entry. On a CPU tensor it
  runs the plain version :func:`_torch_kn`; on a CUDA tensor it launches the
  kernel or raises. Its backward differentiates the plain version, as the
  JAX package's custom VJP does (the kernel has no backward of its own).
- :func:`warp_grad_all_sets_fused` is the (N, K, d) drop-in for
  :func:`warpedganspace_torch.ops.rbf.warp_grad_all_sets`.

``launches`` counts kernel launches; it is a plain int the caller may reset.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

SOURCE = "rbf_warp.cu"
launches = 0

_BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class WarpSets:
    """Support-set tensors packed for the kernel (build once per traversal)."""

    sv: torch.Tensor    # (K, 2N, d) f32 or bf16, contiguous
    g: torch.Tensor     # (K, 2N) f32, gamma_j
    ag: torch.Tensor    # (K, 2N) f32, alpha_j * gamma_j
    svsq: torch.Tensor  # (K, 2N) f32, ||sv_j||^2 (exact even when sv is bf16)


def prepare_warp_sets(support_sets, alphas, gammas, dtype=None) -> WarpSets:
    """Pack (K, 2N, d) sets for the kernel. ``dtype=torch.bfloat16`` stores the
    support vectors in bf16, which halves the bytes the kernel reads."""
    sv = support_sets.float()
    svsq = torch.sum(sv * sv, dim=-1)
    if dtype is not None:
        sv = sv.to(dtype)
    return WarpSets(sv=sv.contiguous(), g=gammas.float().contiguous(),
                    ag=(alphas * gammas).float().contiguous(), svsq=svsq.contiguous())


def _torch_kn(sv, g, ag, svsq, z):
    """Plain PyTorch version of the kernel on the packed layout."""
    sv = sv.float()
    zsq = torch.sum(z * z, dim=-1, keepdim=True)                     # (K, R, 1)
    cross = torch.bmm(z, sv.transpose(1, 2))                          # (K, R, 2N)
    w = ag[:, None, :] * torch.exp(-g[:, None, :] * (zsq - 2.0 * cross + svsq[:, None, :]))
    grad = -2.0 * torch.sum(w, dim=-1, keepdim=True) * z + 2.0 * torch.bmm(w, sv)
    return grad * torch.rsqrt(torch.sum(grad * grad, dim=-1, keepdim=True))


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.rbf_warp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rbf_warp_max_d.argtypes = []
    lib.rbf_warp_max_d.restype = ctypes.c_int
    return lib


def _launch(sv, g, ag, svsq, z):
    """Check the operands, allocate the output and launch on the current stream."""
    global launches
    k, n2, d = sv.shape
    if sv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sv must be float32 or bfloat16, got {sv.dtype}")
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if z.dim() != 3 or z.shape[0] != k or z.shape[2] != d:
        raise ValueError(f"z {tuple(z.shape)} does not match sets {tuple(sv.shape)}")
    for name, t in (("g", g), ("ag", ag), ("svsq", svsq)):
        if t.dtype != torch.float32 or tuple(t.shape) != (k, n2):
            raise ValueError(f"{name} must be float32 of shape {(k, n2)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (sv, g, ag, svsq, z)
    if any(t.device != z.device for t in tensors):
        raise ValueError("all warp operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("warp operands must be contiguous")
    lib = build()
    if d > lib.rbf_warp_max_d():
        raise ValueError(f"the warp kernel takes d <= {lib.rbf_warp_max_d()}, got {d}")
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.rbf_warp_launch(
            sv.data_ptr(), int(sv.dtype == torch.bfloat16), g.data_ptr(), ag.data_ptr(),
            svsq.data_ptr(), z.data_ptr(), out.data_ptr(), k, n2, z.shape[1], d, stream)
    if err != 0:
        raise RuntimeError(f"rbf_warp kernel launch failed: cudaError {err}")
    launches += 1
    return out


class _WarpKN(torch.autograd.Function):
    """Kernel forward; backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, sv, g, ag, svsq, z):
        ctx.save_for_backward(sv, g, ag, svsq, z)
        return _launch(sv, g, ag, svsq, z)

    @staticmethod
    def backward(ctx, ct):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad)]
            out = _torch_kn(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def warp_grad_all_sets_kn(ws: WarpSets, z_kn: torch.Tensor, backend: str = "auto"):
    """Directions, set-major: z (K, R, d) f32 -> (K, R, d).

    ``backend``: "auto" launches the kernel for CUDA tensors and runs the plain
    version for CPU tensors; "cuda" requires CUDA tensors; "torch" always runs
    the plain version.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown warp backend {backend!r}; expected one of {_BACKENDS}")
    if backend == "torch" or (backend == "auto" and not z_kn.is_cuda):
        return _torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z_kn)
    if not z_kn.is_cuda:
        raise ValueError("warp backend 'cuda' needs CUDA tensors")
    return _WarpKN.apply(ws.sv, ws.g, ws.ag, ws.svsq, z_kn)


def warp_grad_all_sets_fused(support_sets, alphas, gammas, z, backend: str = "auto"):
    """Drop-in for ``rbf.warp_grad_all_sets``: z (N, K, d) -> (N, K, d).
    Packs the sets per call; a step loop packs once and calls the _kn form."""
    ws = prepare_warp_sets(support_sets, alphas, gammas)
    out = warp_grad_all_sets_kn(ws, z.transpose(0, 1).contiguous(), backend)
    return out.transpose(0, 1)
