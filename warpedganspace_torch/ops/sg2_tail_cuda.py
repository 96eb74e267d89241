"""StyleGAN2's thin-channel tail through the hand-written CUDA kernel.

Counterpart of :mod:`warpedganspace_tpu.ops.sg2_tail_pallas`. The kernel
(``csrc/sg2_tail.cu``) runs one resolution block of the generator with C < 128
output channels, 2C channels at (H, W) to C channels at (2H, 2W), in one
launch:

    x * s1 -> stride-2 transposed conv3x3 + [1,3,3,1]^2 blur -> * d1 -> + nw1 noise1 + b1
    -> leaky * sqrt 2 -> * s2 -> conv3x3 -> * d2 -> + nw2 noise2 + b2 -> leaky * sqrt 2 (= x2)
    -> * s3 -> ToRGB 1x1 + rgb bias (= rgb)

with no intermediate in device memory but x2, which it writes only when
asked (the last block's is never read). Activations are NCHW, weights OIHW.
The kernel has two designs, chosen in its C launch function by the operands'
type (:func:`design` says which), both on the tensor cores and both computing
the transposed conv's raw taps into a pre-blur window, then the blur:
bfloat16 on warpgroup MMA (``wgmma`` m64nCk16, float32 accumulation), its
weights laid out here in the descriptor's core matrices (:func:`wgmma_layout`)
and streamed through a ring of shared slots by the TMA unit; float32 in split
precision (``mma.sync`` m16n8k8, each operand as TF32 hi + lo, three
products), with the weights split here into 16-byte records of B fragments
(:func:`split_records`). Both layouts are prepared here on every call, a few
small elementwise passes (the span ``wgs.sg2_tail.weights``,
:mod:`~warpedganspace_torch.utils.spans`); the products are the kernel's. The
designs they replaced stay in the source for comparison only, each behind
its own C entry: the bfloat16 ``mma.sync`` design of the polyphase up-conv
(:mod:`warpedganspace_torch.ops.sg2_tail_polyphase`) and the float32 design on
the CUDA cores (:mod:`warpedganspace_torch.ops.sg2_tail_cuda_cores`).

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
``launches_by_design`` counts them by the design that ran (``DESIGN_KEYS``).
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.sg2_tail import TAIL_CHANNELS, fused_section_plain
from warpedganspace_torch.utils.spans import span

SOURCE = "sg2_tail.cu"
launches = 0
# The design each operand type launches: bf16 on wgmma, float32 in split TF32.
DESIGN_KEYS = {torch.bfloat16: "wgmma", torch.float32: "split_tf32"}
launches_by_design = {key: 0 for key in DESIGN_KEYS.values()}
_NAMES = ("x", "w_up", "w_same", "w_rgb", "s1", "d1", "s2", "d2", "s3",
          "n1", "nw1", "b1", "n2", "nw2", "b2", "rgb_b")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from warpedganspace_torch.ops._build import load_library

    lib = load_library(SOURCE)
    fn = lib.sg2_tail_section_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sg2_tail_design.argtypes = [ctypes.c_int]
    lib.sg2_tail_design.restype = ctypes.c_char_p
    return lib


def design(dtype: torch.dtype) -> str:
    """Which design of the kernel serves operands of ``dtype``."""
    return build().sg2_tail_design(int(dtype == torch.bfloat16)).decode()


# The transposed conv's raw taps (ky, kx) in the order both designs take
# them: their parity groups (ky, kx mod 2) = (0, 0), (0, 1), (1, 0), (1, 1).
UP_TAP_ORDER = ((0, 0), (0, 2), (2, 0), (2, 2), (0, 1), (2, 1), (1, 0), (1, 2), (1, 1))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero as ``cvt.rna.tf32.f32`` rounds, in the float32 layout."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_records(w: torch.Tensor) -> torch.Tensor:
    """(taps, C out, C in) float32 weights -> the records of B fragments the
    float32 design reads, (taps x C in / 16 chunks, 2 k8 steps, C out / 8 n8
    tiles, 32 lanes, 4) float32: for lane 4 gq + tq of n8 tile nt at input
    channel k0 = 16 kb + 8 s, {hi(b0), hi(b1), lo(b0), lo(b1)} with b0 =
    w[tap][8 nt + gq][k0 + tq], b1 the same at k0 + tq + 4, hi = tf32(b), lo =
    tf32(b - hi)."""
    taps, co, ci = w.shape
    w = w.float().reshape(taps, co // 8, 8, ci // 16, 2, 2, 4)   # t, nt, gq, kb, s, half, tq
    w = w.permute(0, 3, 4, 1, 2, 6, 5)                           # t, kb, s, nt, gq, tq, half
    hi = tf32(w)
    lo = tf32(w - hi)
    rec = torch.stack([hi, lo], dim=-2)                          # ..., gq, tq, (hi, lo), half
    return rec.reshape(taps * (ci // 16), 2, co // 8, 32, 4).contiguous()


def wgmma_layout(w: torch.Tensor) -> torch.Tensor:
    """(taps, N, K) weights -> the chunks the bfloat16 design's ``wgmma``
    reads as its B operand, (taps, K / 16, N / 8, 2, 8, 8): [tap][k16
    step][n8 group][k half][n][k], each 8 n x 8 k a core matrix of 128
    contiguous bytes (``csrc/tc_wgmma.cuh``)."""
    taps, n, k = w.shape
    w = w.reshape(taps, n // 8, 8, k // 16, 2, 8)                # t, ng, nr, ks, kh, ke
    return w.permute(0, 3, 1, 4, 2, 5).contiguous()


def kernel_weights(w_up: torch.Tensor, w_same: torch.Tensor, w_rgb: torch.Tensor,
                   dtype: torch.dtype):
    """The weights as the kernel's design for ``dtype`` reads them: the
    transposed conv's raw taps in ``UP_TAP_ORDER`` (9, C, 2C) and the
    same-conv's nine taps (ky, kx) in row-major order (9, C, C), both
    [tap][co][ci]; bfloat16 as :func:`wgmma_layout` lays them out, the
    operands' own values; float32 as :func:`split_records`. ToRGB (3, C) in
    float32 for both."""
    c = w_up.shape[0]
    wr = w_rgb.float().reshape(3, c).contiguous()
    up = torch.stack([w_up[:, :, ky, kx] for ky, kx in UP_TAP_ORDER])   # (9, C, 2C)
    same = w_same.permute(2, 3, 0, 1).reshape(9, c, c)                  # (9, C, C)
    if dtype == torch.bfloat16:
        return wgmma_layout(up.to(dtype)), wgmma_layout(same.to(dtype)), wr
    return split_records(up), split_records(same), wr


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
    with span("wgs.sg2_tail.weights"):
        wu, ws, wr = kernel_weights(w_up, w_same, w_rgb, x.dtype)
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
    launches_by_design[DESIGN_KEYS[x.dtype]] += 1
    return rgb, x2


def launch_comparison(entry: str, weights, dtype: torch.dtype, operands, want_x2: bool):
    """One section through a design kept for comparison, behind its C entry
    ``entry`` of the same library: the operands of :func:`fused_section`,
    ``dtype`` CUDA tensors only, with ``weights`` (wu, wsame, wrgb) as that
    design reads them. Launches on the current stream and counts nothing;
    ``(rgb, x2)`` or rgb."""
    c = _check_operands(*operands)
    x = operands[0]
    if x.dtype != dtype or not x.is_cuda:
        raise TypeError(f"{entry} takes {dtype} CUDA tensors")
    fn = getattr(build(), entry)
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, _, h, w = x.shape
    rgb = torch.empty((b, 3, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    x2 = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device) if want_x2 else None
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *(t.data_ptr() for t in weights),
                 *(t.data_ptr() for t in operands[4:]), rgb.data_ptr(),
                 None if x2 is None else x2.data_ptr(), b, c, h, w, int(want_x2),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return (rgb, x2) if want_x2 else rgb


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
