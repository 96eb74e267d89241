"""The CUDA-core float32 design of StyleGAN2's tail section, kept for comparison.

``csrc/sg2_tail.cu`` holds, beside its shipped designs, the first float32
design of the section, on the CUDA cores (``namespace cc``), which the
split-precision tensor-core design replaced. It stays in the same translation
unit behind its own C entry, ``sg2_tail_section_cc_launch``.
:mod:`warpedganspace_torch.ops.sg2_tail_cuda` never calls it;
``chip_smoke.py``, ``scripts/measure_sg2_tail_tc_rate.py`` and the card tests
time or check the shipped design against it. It takes float32 CUDA tensors
only, launches on the current stream and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.sg2_tail import compose_up_weight
from warpedganspace_torch.ops.sg2_tail_cuda import SOURCE, _check_operands


def cc_weights(w_up: torch.Tensor, w_same: torch.Tensor, w_rgb: torch.Tensor):
    """The weights as the CUDA-core design reads them: the polyphase up-conv
    (2C, 4, 9, C) as [ci][phase][tap][co], the same-conv (C, 3, 3, C) as
    [ci][ky][kx][co] and ToRGB (3, C), all float32."""
    c = w_up.shape[0]
    return (compose_up_weight(w_up), w_same.float().permute(1, 2, 3, 0).contiguous(),
            w_rgb.float().reshape(3, c).contiguous())


def cc_section(x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b,
               want_x2: bool = True):
    """One tail section through the CUDA-core design: the operands of
    :func:`~warpedganspace_torch.ops.sg2_tail_cuda.fused_section`, float32 on
    the card; ``(rgb, x2)`` or rgb."""
    from warpedganspace_torch.ops._build import load_library

    operands = (x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b)
    c = _check_operands(*operands)
    if x.dtype != torch.float32 or not x.is_cuda:
        raise TypeError("the CUDA-core design takes float32 CUDA tensors")
    fn = load_library(SOURCE).sg2_tail_section_cc_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, _, h, w = x.shape
    rgb = torch.empty((b, 3, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    x2 = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device) if want_x2 else None
    wu, ws, wr = cc_weights(w_up, w_same, w_rgb)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wu.data_ptr(), ws.data_ptr(), wr.data_ptr(),
                 *(t.data_ptr() for t in operands[4:]), rgb.data_ptr(),
                 None if x2 is None else x2.data_ptr(), b, c, h, w, int(want_x2),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sg2_tail_section_cc_launch failed: cudaError {err}")
    return (rgb, x2) if want_x2 else rgb
