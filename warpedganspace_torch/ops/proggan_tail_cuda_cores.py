"""The CUDA-core float32 design of ProgGAN's tail section, kept for comparison.

``csrc/proggan_tail.cu`` holds, beside its shipped designs, the first float32
design of the section, on the CUDA cores (``namespace cc``), which the
split-precision tensor-core design replaced. It stays in the same translation
unit behind its own C entry, ``proggan_tail_section_cc_launch``.
:mod:`warpedganspace_torch.ops.proggan_tail_cuda` never calls it;
``chip_smoke.py``, ``scripts/measure_sg2_tail_tc_rate.py`` and the card tests
time or check the shipped design against it. It takes float32 CUDA tensors
only, reads the weights as the model holds them (OIHW), launches on the
current stream and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from warpedganspace_torch.ops.proggan_tail_cuda import SOURCE, _check_operands


def cc_section(x, w_up, b_up, s_up, w_same, b_same, s_same, head=None) -> torch.Tensor:
    """One tail section through the CUDA-core design: the operands of
    :func:`~warpedganspace_torch.ops.proggan_tail_cuda.fused_section`, float32
    on the card."""
    from warpedganspace_torch.ops._build import load_library

    c = _check_operands(x, w_up, b_up, s_up, w_same, b_same, s_same, head)
    if x.dtype != torch.float32 or not x.is_cuda:
        raise TypeError("the CUDA-core design takes float32 CUDA tensors")
    fn = load_library(SOURCE).proggan_tail_section_cc_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, _, h, w = x.shape
    out = torch.empty((b, 3 if head is not None else c, 2 * h, 2 * w), dtype=x.dtype,
                      device=x.device)
    head_ptrs = [t.data_ptr() for t in head] if head is not None else [None] * 3
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_up.data_ptr(), b_up.data_ptr(), s_up.data_ptr(),
                 w_same.data_ptr(), b_same.data_ptr(), s_same.data_ptr(), *head_ptrs,
                 out.data_ptr(), b, c, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"proggan_tail_section_cc_launch failed: cudaError {err}")
    return out
