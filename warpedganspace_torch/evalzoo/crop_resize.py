"""Face crops gathered on the device from the staged 256² frame batch.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.crop_resize`. The reference
crops each detected face on the host and resizes it before every predictor
(traverse_attribute_space.py:423-531 via crop_face, :37-58). Here the 256²
batch is already on the device for the detector, so the host computes only a
sampling plan per frame from the NMS rectangles (two index rows and one weight
row per axis), and the device applies it as two batched gathers. The plan
reproduces ``crop_face -> resize_shorter -> center_crop``
(:mod:`warpedganspace_torch.evalzoo.transforms`): half-pixel bilinear
coordinates, replicated borders, the truncated long side and the rounded
centre offset. The plans are the JAX package's, index for index.
"""
from __future__ import annotations

import numpy as np
import torch

from warpedganspace_torch.evalzoo.transforms import resized_dims


def _axis_plan(lo: int, n: int, resized_n: int, out_size: int):
    """Source indices (i0, i1) and the bilinear fraction of each of
    ``out_size`` output pixels along one axis: the crop [lo, lo + n) resized
    to ``resized_n``, then centre-cropped to ``out_size`` at offset
    round((resized_n - out_size) / 2)."""
    offset = int(round((resized_n - out_size) / 2.0))
    j = np.arange(out_size, dtype=np.float64) + offset
    src = np.clip((j + 0.5) * (n / resized_n) - 0.5, 0.0, n - 1.0)
    i0 = np.floor(src).astype(np.int32)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = (src - i0).astype(np.float32)
    return lo + i0, lo + i1, frac


def plan_crop_resize(rects, out_size: int) -> dict:
    """Per-frame axis plans for a batch of (x0, x1, y0, y1) rectangles: arrays
    of shape (T, out_size), h0/h1/hw along the height and w0/w1/ww along the
    width."""
    plans = {k: [] for k in ("h0", "h1", "hw", "w0", "w1", "ww")}
    for x0, x1, y0, y1 in rects:
        ch, cw = max(x1 - x0, 1), max(y1 - y0, 1)
        nh, nw = resized_dims(ch, cw, out_size)
        for axis, (lo, n, resized) in (("h", (x0, ch, nh)), ("w", (y0, cw, nw))):
            i0, i1, f = _axis_plan(lo, n, resized, out_size)
            plans[axis + "0"].append(i0)
            plans[axis + "1"].append(i1)
            plans[axis + "w"].append(f)
    return {k: np.stack(v) for k, v in plans.items()}


def crop_resize(frames: torch.Tensor, plan: dict) -> torch.Tensor:
    """(T, C, H, W) frames + a :func:`plan_crop_resize` plan -> (T, C, S, S)
    crops on the frames' device, in the frames' value scale."""
    dev = frames.device
    idx = torch.from_numpy(np.stack([plan[k] for k in ("h0", "h1", "w0", "w1")])).to(
        dev, torch.long)
    wts = torch.from_numpy(np.stack([plan["hw"], plan["ww"]])).to(dev)
    h0, h1, w0, w1 = idx
    hw, ww = wts[0][:, :, None, None], wts[1][:, :, None, None]
    t = torch.arange(frames.shape[0], device=dev)[:, None]
    x = frames.permute(0, 2, 3, 1)                                # (T, H, W, C)
    rows = x[t, h0] * (1.0 - hw) + x[t, h1] * hw                  # (T, S, W, C)
    # Advanced indices around a slice put their dimensions first: (T, Sw, Sh, C).
    out = rows[t, :, w0] * (1.0 - ww) + rows[t, :, w1] * ww
    return out.permute(0, 3, 2, 1).contiguous()                    # (T, C, Sh, Sw)
