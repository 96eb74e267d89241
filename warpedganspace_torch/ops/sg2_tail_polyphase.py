"""The mma.sync bf16 design of StyleGAN2's tail section, kept for comparison.

``csrc/sg2_tail.cu`` holds, beside its shipped designs, the bfloat16 design
that the ``wgmma`` design replaced: ``mma.sync`` m16n8k16 products of the
up-conv as four polyphase 3x3 convs, one per output phase (``namespace tc``).
It stays in the same translation unit behind its own C entry,
``sg2_tail_section_tc_launch``. :mod:`warpedganspace_torch.ops.sg2_tail_cuda`
never calls it; ``chip_smoke.py``, ``scripts/measure_sg2_tail_tc_rate.py``
and the card tests time or check the shipped design against it. It takes
bfloat16 CUDA tensors only, launches on the current stream and counts nothing.
"""
from __future__ import annotations

import torch

from warpedganspace_torch.ops.sg2_tail import compose_up_weight
from warpedganspace_torch.ops.sg2_tail_cuda import launch_comparison


def polyphase_weights(w_up: torch.Tensor, w_same: torch.Tensor, w_rgb: torch.Tensor):
    """The weights as the polyphase design reads them: the up-conv composed
    in float32 (:func:`~warpedganspace_torch.ops.sg2_tail.compose_up_weight`)
    and rounded once, (9, 4, C, 2C) as [tap (oy, ox)][phase (py, px)][co][ci];
    the same-conv (9, C, C) as [tap][co][ci], both bfloat16; ToRGB (3, C) in
    float32."""
    c = w_up.shape[0]
    wu = compose_up_weight(w_up)                                    # (2C, 4, 9, C) f32
    return (wu.permute(2, 1, 3, 0).to(torch.bfloat16).contiguous(),
            w_same.permute(2, 3, 0, 1).reshape(9, c, c).to(torch.bfloat16).contiguous(),
            w_rgb.float().reshape(3, c).contiguous())


def polyphase_section(x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2,
                      rgb_b, want_x2: bool = True):
    """One tail section through the polyphase ``mma.sync`` design: the
    operands of :func:`~warpedganspace_torch.ops.sg2_tail_cuda.fused_section`,
    bfloat16 on the card; ``(rgb, x2)`` or rgb."""
    operands = (x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b)
    return launch_comparison("sg2_tail_section_tc_launch",
                             polyphase_weights(w_up, w_same, w_rgb), torch.bfloat16, operands,
                             want_x2)
