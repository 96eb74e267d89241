"""Operations of one generator forward per frame, from a configuration's shapes.

Least arithmetic, two operations a multiply-add: convolutions and linears at
the taps that read the image (a stride-2 transposed conv is 9 taps per input
pixel, 2.25 per output pixel; ProgGAN's nearest-up and 3x3 conv merge into 4
taps per output pixel; the first 4x4 conv over a 1x1 seed reads one tap), the
FIR blurs separable (8 taps per output pixel), StyleGAN2's demodulation a
matrix product per sample. Elementwise passes (noise, bias, activations,
PixelNorm, WScale) are not counted, nor any recomputation.
"""
from __future__ import annotations

import math


def sg2_channels(cfg: dict) -> dict[int, int]:
    return {int(k): v for k, v in cfg["channels"].items()}


def sg2_mapping_flops(cfg: dict) -> float:
    """StyleGAN2's mapping network Z -> W for one code."""
    return cfg["n_mlp"] * 2 * cfg["style_dim"] ** 2


def sg2_block_flops(cfg: dict, r: int) -> dict:
    """The synthesis block whose output is ``r`` x ``r``: its up-conv (with
    the blur), same-conv and ToRGB, and what lies outside a tail section
    (the three modulation linears, the two demodulations, the skip's blurred
    upsampling)."""
    ch = sg2_channels(cfg)
    i, o, s = ch[r // 2], ch[r], cfg["style_dim"]
    h = r // 2
    section = 2 * (h * h * 9 * i * o + r * r * (8 * o + 9 * o * o + 3 * o))
    outside = 2 * (s * i + i * o + s * o + o * o + s * o) + 2 * r * r * 8 * 3
    return {"section": section, "outside": outside}


def sg2_synthesis_flops(cfg: dict) -> float:
    """StyleGAN2's synthesis network for one frame (W given)."""
    ch, s = sg2_channels(cfg), cfg["style_dim"]
    c4 = ch[4]
    total = 2 * (16 * 9 * c4 * c4 + s * c4 + c4 * c4)        # conv1, its modulation, demod
    total += 2 * (16 * 3 * c4 + s * c4)                       # to_rgb1
    for j in range(3, int(math.log2(cfg["resolution"])) + 1):
        f = sg2_block_flops(cfg, 2 ** j)
        total += f["section"] + f["outside"]
    return total


def sg2_tail_sections(cfg: dict, batch: int) -> list[tuple]:
    """(B, C, H, W, want_x2) of each section the tail kernel runs: the blocks
    of fewer than 128 output channels, the last without x2."""
    ch = sg2_channels(cfg)
    blocks = [2 ** j for j in range(3, int(math.log2(cfg["resolution"])) + 1)]
    tail = [r for r in blocks if ch[r] < 128]
    return [(batch, ch[r], r // 2, r // 2, r != blocks[-1]) for r in tail]


def proggan_specs(cfg: dict) -> list[tuple]:
    """(kernel, upsample, cin, cout) of each block of the chain."""
    ch = cfg["channels"]
    ups = [False, False] + [True, False] * 8
    ks = [4] + [3] * 17
    return [(ks[j], ups[j], ch[j], ch[j + 1]) for j in range(len(ch) - 1)]


def proggan_frame_flops(cfg: dict) -> float:
    """ProgGAN's chain and RGB head for one frame."""
    total, r = 0.0, 1
    for j, (k, up, i, o) in enumerate(proggan_specs(cfg)):
        if j == 0:
            r = 4
            total += 2 * r * r * i * o                        # one tap reads the 1x1 seed
        elif up:
            r *= 2
            total += 2 * r * r * 4 * i * o
        else:
            total += 2 * r * r * 9 * i * o
    return total + 2 * r * r * 3 * cfg["channels"][-1]


def proggan_tail_sections(cfg: dict, batch: int) -> list[tuple]:
    """(B, C, H, W, head) of each section the tail kernel runs: each up block
    2C -> C with C <= 64 and the same block after it; the last has the head."""
    out, r = [], 4
    specs = proggan_specs(cfg)
    for j, (k, up, i, o) in enumerate(specs):
        if up:
            if o <= 64 and i == 2 * o:
                out.append((batch, o, r, r, j + 2 == len(specs)))
            r *= 2
    return out


def frame_flops(cfg: dict) -> float:
    """One rendered frame (the render stream's forward, in the latent space of
    the configuration: StyleGAN2 renders from W, without its mapping)."""
    if cfg["family"] == "stylegan2":
        return sg2_synthesis_flops(cfg)
    if cfg["family"] == "proggan":
        return proggan_frame_flops(cfg)
    raise ValueError(f"no operation count for the family {cfg['family']!r}")
