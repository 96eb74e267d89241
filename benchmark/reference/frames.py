"""The render stream's frames, judged: the reference image scaled to [0, 255]
by its own minimum and maximum, as the traversal converts every frame, and
the distance of a delivered uint8 frame from it."""
from __future__ import annotations

import torch


def scaled_255(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float -> (B, H, W, 3) float32 in [0, 255], per image."""
    img = img.float()
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return (255.0 * (img - lo) / torch.clamp(hi - lo, min=1e-12)).permute(0, 2, 3, 1)


def gap_levels(frame_u8: torch.Tensor, ref_255: torch.Tensor) -> torch.Tensor:
    """Per pixel, how far (in levels) the reference value lies outside the
    level [v, v + 1) that the uint8 value v stands for: 0 where the frame is
    the reference truncated to levels."""
    v = frame_u8.float()
    return torch.clamp(ref_255 - (v + 1.0), min=0.0) + torch.clamp(v - ref_255, min=0.0)


def rms_gap(frame_u8: torch.Tensor, ref_255: torch.Tensor) -> float:
    """The root mean square of :func:`gap_levels` over a frame, in levels."""
    return float(torch.sqrt(torch.mean(gap_levels(frame_u8, ref_255) ** 2)))


def level_size(img: torch.Tensor) -> torch.Tensor:
    """(B,) the size of one level of each image's uint8 frame, relative to the
    image's root mean square: (max - min) / 255 / rms. A gap in levels times
    this is a gap relative to the image's own magnitude, which is what a
    rounding error scales with, whatever offset the frame's scaling removes."""
    img = img.float()
    span = img.amax(dim=(1, 2, 3)) - img.amin(dim=(1, 2, 3))
    return span / 255.0 / torch.sqrt(torch.mean(img * img, dim=(1, 2, 3)))


def relative_gap(frame_u8: torch.Tensor, ref_255: torch.Tensor, level: float) -> float:
    """:func:`rms_gap` relative to the reference image's magnitude (``level``
    from :func:`level_size`)."""
    return rms_gap(frame_u8, ref_255) * float(level)
