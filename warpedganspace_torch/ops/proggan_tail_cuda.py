"""ProgGAN's thin-channel tail through the hand-written CUDA kernel.

Counterpart of :mod:`warpedganspace_tpu.ops.proggan_tail_pallas`. The kernel
(``csrc/proggan_tail.cu``) runs one resolution section of the tail, 2C
channels at (H, W) to C channels at (2H, 2W), in one launch:

    PixelNorm -> nearest 2x up -> conv3x3 -> WScale -> LeakyReLU(0.2)
    -> PixelNorm -> conv3x3 -> WScale -> LeakyReLU(0.2)
    [-> PixelNorm -> conv1x1 (C -> 3) -> WScale on the last section]

with no intermediate in device memory. Activations are NCHW, weights OIHW.
The kernel has two designs, chosen in its C launch function by the operands'
type (:func:`design` says which), both on the tensor cores: bfloat16 as bf16
products (``mma.sync`` m16n8k16, float32 accumulation); float32 in split
precision (``mma.sync`` m16n8k8, each operand as TF32 hi + lo, three
products). This wrapper prepares the weights each design reads
(:func:`kernel_weights`), the up-conv's merged taps and the same-conv's taps:
for bf16 K-contiguous (:func:`tc_weights`), a few small elementwise passes on
the card on every call; for float32 split into 16-byte records of B fragments
(:func:`f32_records`), made once for a weight pair and kept while the weights
do not change (:func:`cached_f32_records`); both in the span
``wgs.proggan_tail.weights`` (:mod:`~warpedganspace_torch.utils.spans`). The
float32 design on the CUDA cores that the split-precision one replaced is
bound for comparison only, by
:mod:`warpedganspace_torch.ops.proggan_tail_cuda_cores`.

- :func:`fused_section` is one section, :func:`proggan_tail` the chain of
  sections with the RGB head on the last: one launch per section. On CPU
  tensors they run the plain versions of
  :mod:`warpedganspace_torch.ops.proggan_tail`; on CUDA tensors they launch the
  kernel or raise. The kernel takes every H, W >= 1 (ragged tiles are masked)
  and C in ``TAIL_CHANNELS``.
- The backward differentiates the plain version, as the JAX package's
  ``custom_vjp`` does: the TPU kernel has no backward kernel either
  (traversal and sampling never differentiate the generator).

``launches`` counts kernel launches; it is a plain int the caller may reset.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from warpedganspace_torch.ops.proggan_tail import (TAIL_CHANNELS, fused_section_plain,
                                                   merge_up_taps)
from warpedganspace_torch.ops.sg2_tail_cuda import split_records
from warpedganspace_torch.utils.spans import span

SOURCE = "proggan_tail.cu"
launches = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.proggan_tail_section_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.proggan_tail_design.argtypes = [ctypes.c_int]
    lib.proggan_tail_design.restype = ctypes.c_char_p
    return lib


def design(dtype: torch.dtype) -> str:
    """Which design of the kernel serves operands of ``dtype``."""
    return build().proggan_tail_design(int(dtype == torch.bfloat16)).decode()


def tc_weights(w_up: torch.Tensor, w_same: torch.Tensor):
    """The bf16 design's weights: the up-conv's merged taps (2, 4, 4, C, 2C)
    as [hi, lo][tap (a, b)][parity (pi, pj)][co][ci], hi the bf16 rounding of
    the float32 merged tap and lo that of the remainder (the section with the
    RGB head multiplies both), and the same-conv's (9, C, C) as
    [tap][co][ci]."""
    c = w_up.shape[0]
    merged = merge_up_taps(w_up).permute(2, 3, 0, 1, 4, 5).reshape(4, 4, c, 2 * c)
    hi = merged.to(torch.bfloat16)
    lo = (merged - hi.float()).to(torch.bfloat16)
    same = w_same.permute(2, 3, 0, 1).reshape(9, c, c).to(torch.bfloat16).contiguous()
    return torch.stack([hi, lo]).contiguous(), same


def f32_records(w_up: torch.Tensor, w_same: torch.Tensor):
    """The float32 design's weights as split records
    (:func:`~warpedganspace_torch.ops.sg2_tail_cuda.split_records`): the
    up-conv's merged taps, summed in float32 (:func:`merge_up_taps`), as
    (4 taps x 2C / 16 chunks, 2, 4C / 8, 32, 4), taps (a, b) in row-major
    order and the n8 tiles of a k8 step parity-major (parity (pi, pj)'s C
    output channels are the C / 8 tiles from (2 pi + pj) C / 8 on), and the
    same-conv's nine taps (ky, kx) in row-major order as
    (9 x C / 16, 2, C / 8, 32, 4)."""
    c = w_up.shape[0]
    up = merge_up_taps(w_up).permute(2, 3, 0, 1, 4, 5).reshape(4, 4 * c, 2 * c)
    same = w_same.permute(2, 3, 0, 1).reshape(9, c, c)
    return split_records(up), split_records(same)


# f32_records of the last few weight pairs: (id w_up, id w_same) -> (weak
# references, the tensors' stamps, records).
_RECORDS: dict = {}
_RECORDS_KEPT = 8


def _stamp(t: torch.Tensor) -> tuple:
    return t._version, t.data_ptr(), t.device, tuple(t.shape)


def cached_f32_records(w_up: torch.Tensor, w_same: torch.Tensor):
    """:func:`f32_records`, made once for a weight pair and kept while both
    tensors are the same objects with the same version counters and storage:
    a generator's sections reuse them on every forward. Made anew on every
    call, the records cost some twenty small launches, about 0.3 ms of the
    host's time a section (``PERF.md``, PR 17), which a section at B=1 does
    not hide."""
    key, stamp = (id(w_up), id(w_same)), (_stamp(w_up), _stamp(w_same))
    hit = _RECORDS.get(key)
    if hit is not None and hit[0]() is w_up and hit[1]() is w_same and hit[2] == stamp:
        return hit[3]
    records = f32_records(w_up, w_same)
    if key not in _RECORDS and len(_RECORDS) >= _RECORDS_KEPT:
        del _RECORDS[next(iter(_RECORDS))]
    _RECORDS[key] = (weakref.ref(w_up), weakref.ref(w_same), stamp, records)
    return records


def kernel_weights(w_up: torch.Tensor, w_same: torch.Tensor, dtype: torch.dtype):
    """The weights as the kernel's design for ``dtype`` reads them:
    :func:`tc_weights` for bfloat16, :func:`cached_f32_records` for float32."""
    if dtype == torch.bfloat16:
        return tc_weights(w_up, w_same)
    return cached_f32_records(w_up, w_same)


def _check_operands(x, w_up, b_up, s_up, w_same, b_same, s_same, head):
    """Raise on what the kernel does not take; return C."""
    if x.dim() != 4 or w_up.dim() != 4 or w_same.dim() != 4:
        raise ValueError("x must be (B, 2C, H, W) and the weights OIHW; got "
                         f"{tuple(x.shape)}, {tuple(w_up.shape)}, {tuple(w_same.shape)}")
    c = w_up.shape[0]
    if c not in TAIL_CHANNELS:
        raise ValueError(f"the tail kernel takes C in {TAIL_CHANNELS} output channels per "
                         f"section (its thread and shared-memory maps), got C={c}")
    if (tuple(w_up.shape) != (c, 2 * c, 3, 3) or tuple(w_same.shape) != (c, c, 3, 3)
            or x.shape[1] != 2 * c):
        raise ValueError(f"section operands must be x (B, {2 * c}, H, W), up ({c}, {2 * c}, 3, 3) "
                         f"and same ({c}, {c}, 3, 3); got {tuple(x.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_same.shape)}")
    operands = {"x": x, "w_up": w_up, "b_up": b_up, "s_up": s_up, "w_same": w_same,
                "b_same": b_same, "s_same": s_same}
    sizes = {"b_up": c, "s_up": 1, "b_same": c, "s_same": 1}
    if head is not None:
        w_out, b_out, s_out = head
        if tuple(w_out.shape) != (3, c, 1, 1):
            raise ValueError(f"the head's weight must be (3, {c}, 1, 1), got {tuple(w_out.shape)}")
        operands.update(w_out=w_out, b_out=b_out, s_out=s_out)
        sizes.update(b_out=3, s_out=1)
    for name, n in sizes.items():
        if operands[name].numel() != n:
            raise ValueError(f"{name} must have {n} element(s), got {tuple(operands[name].shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tail operands must be float32 or bfloat16, got {x.dtype}")
    for name, t in operands.items():
        if t.dtype != x.dtype:
            raise TypeError(f"all tail operands must share one dtype: x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all tail operands must be on one device: x is on {x.device}, "
                             f"{name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"tail operands must be contiguous, {name} is not")
    return c


def _launch(x, w_up, b_up, s_up, w_same, b_same, s_same, head):
    """Check the operands, allocate the output and launch on the current stream."""
    global launches
    c = _check_operands(x, w_up, b_up, s_up, w_same, b_same, s_same, head)
    b, _, h, w = x.shape
    out = torch.empty((b, 3 if head is not None else c, 2 * h, 2 * w), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = build()
    head_ptrs = [t.data_ptr() for t in head] if head is not None else [None] * 3
    with span("wgs.proggan_tail.weights"):
        w_up, w_same = kernel_weights(w_up, w_same, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.proggan_tail_section_launch(
            x.data_ptr(), w_up.data_ptr(), b_up.data_ptr(), s_up.data_ptr(),
            w_same.data_ptr(), b_same.data_ptr(), s_same.data_ptr(), *head_ptrs,
            out.data_ptr(), int(x.dtype == torch.bfloat16), b, c, h, w, stream)
    if err != 0:
        raise RuntimeError(f"proggan_tail kernel launch failed: cudaError {err}")
    launches += 1
    return out


class _FusedSection(torch.autograd.Function):
    """Kernel forward; backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, has_head, *operands):
        ctx.has_head = has_head
        ctx.save_for_backward(*operands)
        return _launch(*operands[:7], operands[7:] if has_head else None)

    @staticmethod
    def backward(ctx, ct):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            out = fused_section_plain(*leaves[:7], head=leaves[7:] if ctx.has_head else None)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return (None,) + tuple(next(grads) if t.requires_grad else None for t in leaves)


def fused_section(x, w_up, b_up, s_up, w_same, b_same, s_same, head=None) -> torch.Tensor:
    """One tail section: x (B, 2C, H, W) -> (B, C, 2H, 2W), or (B, 3, 2H, 2W)
    with ``head = (w_out (3, C, 1, 1), b_out (3,), s_out)``.

    ``w_up`` is (C, 2C, 3, 3), ``w_same`` (C, C, 3, 3), the biases (C,), the
    WScale scales one element each. CUDA tensors go through the kernel (or
    raise), CPU tensors through the plain version.
    """
    if not x.is_cuda:
        return fused_section_plain(x, w_up, b_up, s_up, w_same, b_same, s_same, head=head)
    operands = (x, w_up, b_up, s_up, w_same, b_same, s_same) + (tuple(head) if head else ())
    return _FusedSection.apply(head is not None, *operands)


def proggan_tail(x, sections, out) -> torch.Tensor:
    """The whole tail on the entry block's input: every ``(up_block,
    same_block)`` of ``sections`` (see ``tail_sections_from_blocks``), the last
    one with the RGB head ``out``; blocks carry ``weight``, ``bias``, ``scale``.
    One kernel launch per section on a CUDA tensor; on a CPU tensor this is
    ``proggan_tail_plain``."""
    for i, (up, same) in enumerate(sections):
        head = (out.weight, out.bias, out.scale) if i == len(sections) - 1 else None
        x = fused_section(x, up.weight, up.bias, up.scale, same.weight, same.bias, same.scale,
                          head=head)
    return x
