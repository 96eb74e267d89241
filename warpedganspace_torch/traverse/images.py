"""Image conversion and JPEG/GIF emission for traversal outputs.

Parity targets: ``tensor2image`` (traverse_latent_space.py:215-230 /
sample_gan.py:13-21) — adaptive min-max or tanh-range mapping to uint8 —
and the JPEG save settings (quality/optimize/progressive) used across the
pipeline. Inputs here are NHWC numpy arrays (the render stream's host layout).
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def tensor2image(img_hwc: np.ndarray, img_size: int | None = None, adaptive: bool = False) -> Image.Image:
    """Convert one (H, W, C) float image to PIL.

    adaptive=True rescales by the image's own min/max (the traversal scripts'
    default); otherwise maps tanh range [-1, 1] -> [0, 1] with clipping.
    """
    x = np.asarray(img_hwc)
    if x.dtype == np.uint8:
        pass  # already converted (device-side adaptive path, engine.iter_rendered_u8)
    else:
        x = x.astype(np.float32)
        if adaptive:
            lo, hi = x.min(), x.max()
            x = (x - lo) / max(hi - lo, 1e-12)
        else:
            x = np.clip((x + 1.0) / 2.0, 0.0, 1.0)
        x = (255.0 * x).astype(np.uint8)
    if x.shape[-1] == 1:
        x = x[..., 0]
    pil = Image.fromarray(x)
    if img_size:
        pil = pil.resize((img_size, img_size))
    return pil


def save_jpeg(pil_img: Image.Image, path: str, quality: int = 75) -> None:
    """JPEG save with the pipeline's settings (optimize + progressive)."""
    pil_img.save(path, "JPEG", quality=quality, optimize=True, progressive=True)
