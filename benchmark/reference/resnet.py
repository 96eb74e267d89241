"""The ResNet reconstructor, plain: torchvision's ResNet-18 with a conv1 for
the channel-stacked image pair, features at the global average pool, and two
linear heads (path logits, shift magnitude), as ``lib/reconstructor.py``
builds it. BatchNorm in training mode (batch statistics, eps 1e-5)."""
from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference.quant import exact

PREFIX = "features_extractor."


def _bn(x, p, name):
    return F.batch_norm(x, None, None, p[name + ".weight"], p[name + ".bias"], training=True,
                        eps=1e-5)


def _conv(x, w, stride, padding, q):
    return F.conv2d(q(x), q(w), stride=stride, padding=padding)


def forward(x, p: dict, q=exact):
    """(B, 2C, H, W) -> (path logits (B, K), magnitudes (B,)) over the
    parameters ``p`` under the reference's names."""
    y = F.relu(_bn(_conv(x, p[PREFIX + "conv1.weight"], 2, 3, q), p, PREFIX + "bn1"))
    y = F.max_pool2d(y, 3, 2, 1)
    for li in range(1, 5):
        for b in range(2):
            n = f"{PREFIX}layer{li}.{b}."
            stride = 2 if (li > 1 and b == 0) else 1
            out = F.relu(_bn(_conv(y, p[n + "conv1.weight"], stride, 1, q), p, n + "bn1"))
            out = _bn(_conv(out, p[n + "conv2.weight"], 1, 1, q), p, n + "bn2")
            if n + "downsample.0.weight" in p:
                y = _bn(_conv(y, p[n + "downsample.0.weight"], stride, 0, q), p,
                        n + "downsample.1")
            y = F.relu(out + y)
    feats = y.mean((2, 3))
    logits = F.linear(q(feats), q(p["path_indices.weight"]), p["path_indices.bias"])
    mags = F.linear(q(feats), q(p["shift_magnitudes.weight"]), p["shift_magnitudes.bias"])
    return logits, mags[:, 0]
