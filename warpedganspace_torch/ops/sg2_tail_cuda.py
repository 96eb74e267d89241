"""StyleGAN2's thin-channel tail through the hand-written CUDA kernel.

Counterpart of :mod:`warpedganspace_tpu.ops.sg2_tail_pallas`. The kernel
(``csrc/sg2_tail.cu``) runs one resolution block of the generator with C < 128
output channels, 2C channels at (H, W) to C channels at (2H, 2W), in one
launch:

    x * s1 -> stride-2 transposed conv3x3 + [1,3,3,1]^2 blur -> * d1 -> + nw1 noise1 + b1
    -> leaky * sqrt 2 -> * s2 -> conv3x3 -> * d2 -> + nw2 noise2 + b2 -> leaky * sqrt 2 (= x2)
    -> * s3 -> ToRGB 1x1 + rgb bias (= rgb)

with float32 arithmetic on float32 or bfloat16 storage and no intermediate in
device memory but x2, which it writes only when asked (the last block's is
never read). Activations are NCHW, weights OIHW. The weights' layouts for the
kernel (the up-conv as four polyphase 3x3 convs, :func:`compose_up_weight`)
are prepared here in float32 on every call, a few small elementwise passes;
the products are the kernel's.

- :func:`fused_section` is one section. On CPU tensors it runs
  :func:`~warpedganspace_torch.ops.sg2_tail.fused_section_plain`; on CUDA
  tensors it launches the kernel or raises. The kernel takes every H, W >= 1
  (ragged tiles are masked) and C in ``TAIL_CHANNELS``.
- The backward differentiates the plain version, as the JAX package's
  ``custom_vjp`` differentiates its fold-x twin: the TPU kernel has no backward
  kernel either. So a forward on the card that needs gradients, a training
  step's included, runs the kernel forward and the plain VJP; the JAX training
  CLI runs the plain composition instead. Traversal and sampling never
  differentiate the generator.

``launches`` counts kernel launches; it is a plain int the caller may reset.
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.sg2_tail import (TAIL_CHANNELS, compose_up_weight,
                                               fused_section_plain)

SOURCE = "sg2_tail.cu"
launches = 0
_NAMES = ("x", "w_up", "w_same", "w_rgb", "s1", "d1", "s2", "d2", "s3",
          "n1", "nw1", "b1", "n2", "nw2", "b2", "rgb_b")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.sg2_tail_section_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_operands(*operands):
    """Raise on what the kernel does not take; return C."""
    ops = dict(zip(_NAMES, operands))
    x, w_up = ops["x"], ops["w_up"]
    if x.dim() != 4 or w_up.dim() != 4:
        raise ValueError("x must be (B, 2C, H, W) and the weights OIHW; got "
                         f"{tuple(x.shape)}, {tuple(w_up.shape)}")
    c = w_up.shape[0]
    if c not in TAIL_CHANNELS:
        raise ValueError(f"the tail kernel takes C in {TAIL_CHANNELS} output channels per "
                         f"section (its thread and shared-memory maps), got C={c}")
    b, _, h, w = x.shape
    shapes = {"x": (b, 2 * c, h, w), "w_up": (c, 2 * c, 3, 3), "w_same": (c, c, 3, 3),
              "w_rgb": (3, c, 1, 1), "s1": (b, 2 * c), "d1": (b, c), "s2": (b, c),
              "d2": (b, c), "s3": (b, c), "n1": (1, 1, 2 * h, 2 * w), "b1": (c,),
              "n2": (1, 1, 2 * h, 2 * w), "b2": (c,), "rgb_b": (3,)}
    for name, shape in shapes.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"section operand {name} must be {shape}, got "
                             f"{tuple(ops[name].shape)}")
    for name in ("nw1", "nw2"):
        if ops[name].numel() != 1:
            raise ValueError(f"{name} must have one element, got {tuple(ops[name].shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tail operands must be float32 or bfloat16, got {x.dtype}")
    for name, t in ops.items():
        if t.dtype != x.dtype:
            raise TypeError(f"all tail operands must share one dtype: x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all tail operands must be on one device: x is on {x.device}, "
                             f"{name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"tail operands must be contiguous, {name} is not")
    return c


def _launch(want_x2: bool, *operands):
    """Check the operands, prepare the weights, allocate the outputs and launch
    on the current stream. Returns (rgb, x2 or None)."""
    global launches
    c = _check_operands(*operands)
    x, w_up, w_same, w_rgb = operands[:4]
    b, _, h, w = x.shape
    rgb = torch.empty((b, 3, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    x2 = (torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
          if want_x2 else None)
    if rgb.numel() == 0:
        return rgb, x2
    lib = build()
    wu = compose_up_weight(w_up)                                    # (2C, 4, 9, C) f32
    ws = w_same.float().permute(1, 2, 3, 0).contiguous()            # (C, 3, 3, C) f32
    wr = w_rgb.float().reshape(3, c).contiguous()                   # (3, C) f32
    vectors = [t.data_ptr() for t in operands[4:]]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sg2_tail_section_launch(
            x.data_ptr(), wu.data_ptr(), ws.data_ptr(), wr.data_ptr(), *vectors,
            rgb.data_ptr(), None if x2 is None else x2.data_ptr(),
            int(x.dtype == torch.bfloat16), b, c, h, w, int(want_x2), stream)
    if err != 0:
        raise RuntimeError(f"sg2_tail kernel launch failed: cudaError {err}")
    launches += 1
    return rgb, x2


class _FusedSection(torch.autograd.Function):
    """Kernel forward; backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, want_x2, *operands):
        ctx.want_x2 = want_x2
        ctx.save_for_backward(*operands)
        rgb, x2 = _launch(want_x2, *operands)
        return (rgb, x2) if want_x2 else rgb

    @staticmethod
    def backward(ctx, *cts):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            out = fused_section_plain(*leaves, want_x2=ctx.want_x2)
            outs = out if ctx.want_x2 else (out,)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, cts))
        return (None,) + tuple(next(grads) if t.requires_grad else None for t in leaves)


def fused_section(x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2,
                  rgb_b, want_x2: bool = True):
    """One tail section: x (B, 2C, H, W) -> ``(rgb, x2)`` or rgb; the operands
    as :func:`~warpedganspace_torch.ops.sg2_tail.fused_section_plain` takes
    them. CUDA tensors go through the kernel (or raise), CPU tensors through
    the plain version."""
    operands = (x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b)
    if not x.is_cuda:
        return fused_section_plain(*operands, want_x2=want_x2)
    return _FusedSection.apply(want_x2, *operands)
