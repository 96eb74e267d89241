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

import torch

from warpedganspace_torch.ops.sg2_tail import compose_up_weight
from warpedganspace_torch.ops.sg2_tail_cuda import launch_comparison


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
    operands = (x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b)
    return launch_comparison("sg2_tail_section_cc_launch", cc_weights(w_up, w_same, w_rgb),
                             torch.float32, operands, want_x2)
