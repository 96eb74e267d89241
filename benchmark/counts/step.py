"""Operations of one training step per sample, from a configuration's shapes.

The step (``train/train_step.py``): the unshifted and the shifted generator
forwards, the warp's direction, the reconstructor on the pair, the backward
into the shift (data gradients only: G is frozen) and into R (data and weight
gradients), two Adams. Least arithmetic as in :mod:`benchmark.counts.generators`;
the backward of a convolution or linear counts what its forward counts once
for each gradient it forms. Adam's and BatchNorm's elementwise work and any
recomputation are not counted.
"""
from __future__ import annotations

from benchmark.counts.generators import (proggan_frame_flops, sg2_mapping_flops,
                                         sg2_synthesis_flops)

_RESNET18 = ((64, 1), (128, 2), (256, 2), (512, 2))


def resnet18_flops(cfg: dict) -> dict:
    """ResNet-18's trunk on the channel-stacked pair at the generator's
    resolution, and its first conv alone."""
    r = cfg["resolution"]
    cin = 2 * cfg["reconstructor_channels"]
    h = r // 2
    conv1 = 2 * h * h * 64 * cin * 49
    total = conv1
    h //= 2                                                   # the max-pool
    ch = 64
    for out, stride in _RESNET18:
        for block in range(2):
            s = stride if block == 0 else 1
            ho = h // s
            total += 2 * ho * ho * 9 * ch * out + 2 * ho * ho * 9 * out * out
            if s != 1 or ch != out:
                total += 2 * ho * ho * ch * out
            h, ch = ho, out
    total += 2 * 512 * (cfg["num_support_sets"] + 1)          # the two heads
    return {"total": total, "conv1": conv1}


def generator_flops(cfg: dict) -> float:
    """One generator forward of the training step (StyleGAN2 from Z: the
    mapping and the synthesis)."""
    if cfg["family"] == "stylegan2":
        return sg2_mapping_flops(cfg) + sg2_synthesis_flops(cfg)
    if cfg["family"] == "proggan":
        return proggan_frame_flops(cfg)
    raise ValueError(f"no operation count for the family {cfg['family']!r}")


def step_flops_per_sample(cfg: dict) -> dict:
    """The step's parts for one sample, and their sum under ``total``."""
    g = generator_flops(cfg)
    mapping = sg2_mapping_flops(cfg) if cfg["family"] == "stylegan2" else 0.0
    r = resnet18_flops(cfg)
    warp = 2 * 2 * (2 * cfg["num_support_dipoles"]) * cfg["support_vectors_dim"]
    parts = {
        "generator_forwards": 2 * g + mapping,     # G(z), G(z, shift), and W for the warp
        "generator_backward": g - mapping,         # data gradient into the shift
        "warp": 3 * warp,                          # forward, and the gradient into S
        "reconstructor": 3 * r["total"] - r["conv1"] / 2,   # no gradient for G(z)'s half
    }
    parts["total"] = sum(parts.values())
    return parts
