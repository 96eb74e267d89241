"""Static registry: GAN types, resolutions, pretrained-weight artifacts.

Counterpart of :mod:`warpedganspace_tpu.config` (reference ``lib/config.py``:
GAN resolutions :20-26, local weight paths :28-64). The port keeps its own
copy of the entries it reads, so that it imports nothing of the JAX package.
"""
from __future__ import annotations

GAN_RESOLUTIONS = {
    "SNGAN_MNIST": 32,
    "SNGAN_AnimeFaces": 64,
    "BigGAN": 128,
    "ProgGAN": 1024,
    "StyleGAN2": 1024,
}

# Pretrained generator artifacts: the local path layout shared with the
# reference pipeline (models/pretrained/...), by resolution.
GAN_WEIGHTS = {
    "SNGAN_MNIST": {
        "weights": {32: "models/pretrained/generators/SNGAN_MNIST/generator.pt"},
    },
    "SNGAN_AnimeFaces": {
        "weights": {64: "models/pretrained/generators/SNGAN_AnimeFaces/generator.pt"},
    },
    "BigGAN": {
        "weights": {128: "models/pretrained/generators/BigGAN/G_ema.pth"},
    },
    "ProgGAN": {
        "weights": {
            1024: "models/pretrained/generators/ProgGAN/100_celeb_hq_network-snapshot-010403.pth"
        },
    },
    "StyleGAN2": {
        "weights": {
            256: "models/pretrained/generators/StyleGAN2/stylegan2-ffhq-256-550000.pt",
            1024: "models/pretrained/generators/StyleGAN2/stylegan2-ffhq-config-f.pt",
        },
    },
}
