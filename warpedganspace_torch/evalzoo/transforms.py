"""Image transforms of the attribute stage, on (N, C, H, W) float tensors.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.transforms`: the torchvision
stacks of the reference's ``traverse_attribute_space.py`` (Resize, bilinear
with half-pixel centres, :172, :203-206, :213; CenterCrop; ImageNet
Normalize) and its ``crop_face`` rectangle with the fixed -50/+50/+30 margins
and the transposed x/y quirk (:37-58).

The JAX package resizes with cv2 ``INTER_LINEAR``; here it is
``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``, the
same half-pixel bilinear sampling without antialiasing, so the port needs no
cv2. The tensors may sit on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resized_dims(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision Resize(size): the shorter side becomes ``size`` and the long
    side is TRUNCATED, ``int(size * long / short)``, as torchvision's
    functional.resize computes it (round() would move every later centre crop
    by a pixel on about half of the non-square face crops)."""
    if h <= w:
        return size, max(1, int(w * size / h))
    return max(1, int(h * size / w)), size


def resize_shorter(batch: torch.Tensor, size: int) -> torch.Tensor:
    nh, nw = resized_dims(batch.shape[-2], batch.shape[-1], size)
    if (nh, nw) == tuple(batch.shape[-2:]):
        return batch
    return F.interpolate(batch, size=(nh, nw), mode="bilinear", align_corners=False,
                         antialias=False)


def center_crop(batch: torch.Tensor, size: int) -> torch.Tensor:
    """CenterCrop(size), padding with zeros first where the image is smaller."""
    h, w = batch.shape[-2:]
    top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
    if top < 0 or left < 0:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        batch = F.pad(batch, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        h, w = batch.shape[-2:]
        top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
    return batch[..., top:top + size, left:left + size]


def resize_center(batch: torch.Tensor, size: int) -> torch.Tensor:
    """Resize(size) + CenterCrop(size) of a batch of equal-sized images."""
    return center_crop(resize_shorter(batch, size), size)


def normalize_imagenet(batch: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=batch.dtype, device=batch.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=batch.dtype, device=batch.device).view(1, 3, 1, 1)
    return (batch - mean) / std


def crop_rect(bbox, src_h: int, src_w: int, padding: float = 0.0):
    """The reference's crop_face rectangle (traverse_attribute_space.py:37-58)
    with its fixed -50/+50/+30 margins and its transposed x/y indexing (x
    slices the height axis, y the width axis). Returns (x0, x1, y0, y1)."""
    x_min = int((1.0 - padding) * bbox[0]) - 50
    y_min = int((1.0 - padding) * bbox[1]) - 50
    x_max = int((1.0 + padding) * bbox[2]) + 50
    y_max = int((1.0 + padding) * bbox[3]) + 30
    return max(x_min, 0), min(src_h, x_max), max(y_min, 0), min(src_w, y_max)


def crop_face(images: torch.Tensor, idx: int, bbox, padding: float = 0.0) -> torch.Tensor:
    """One face of an (N, C, H, W) batch as (1, C, h, w): the slicing form of
    :func:`crop_rect`."""
    x0, x1, y0, y1 = crop_rect(bbox, images.shape[-2], images.shape[-1], padding)
    return images[idx:idx + 1, :, x0:x1, y0:y1]
