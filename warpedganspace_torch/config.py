"""Static registry: GAN types, resolutions, pretrained-weight artifacts.

Counterpart of :mod:`warpedganspace_tpu.config` (reference ``lib/config.py``:
reconstructor types :12, GAN resolutions :20-26, weight URLs, sha256 sums and
local paths :28-64, the published WarpedGANSpace experiment tarballs :71-94,
the attribute predictors' artifacts :101-142, BigGAN's ImageNet class names
:150-1151, kept as data in ``configs/biggan_classes.json``). The port keeps
its own copy, so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import os.path as osp

RECONSTRUCTOR_TYPES = ("ResNet", "LeNet")

GAN_RESOLUTIONS = {
    "SNGAN_MNIST": 32,
    "SNGAN_AnimeFaces": 64,
    "BigGAN": 128,
    "ProgGAN": 1024,
    "StyleGAN2": 1024,
}

# Pretrained generator artifacts: download URL, integrity hash, and the local
# path layout shared with the reference pipeline (models/pretrained/...).
GAN_WEIGHTS = {
    "SNGAN_MNIST": {
        "url": "https://www.dropbox.com/s/jh9xylezn45tmml/pretrained_sngan_mnist_generator.tar?dl=1",
        "sha256sum": "d0279ad755adfc9dd2c5ff04479d31bbd8c2fd508b5e75ce4f7c267249c2cdc9",
        "weights": {32: "models/pretrained/generators/SNGAN_MNIST/generator.pt"},
    },
    "SNGAN_AnimeFaces": {
        "url": "https://www.dropbox.com/s/04l48564h70impg/pretrained_sngan_animefaces_generator.tar?dl=1",
        "sha256sum": "00809a842ab9f6dfad5c9782a2bcd644d7e6d17adc54af04c671affab4a24ecd",
        "weights": {64: "models/pretrained/generators/SNGAN_AnimeFaces/generator.pt"},
    },
    "BigGAN": {
        "url": "https://www.dropbox.com/s/z82rwv65lwry0ox/pretrained_biggan_generator.tar?dl=1",
        "sha256sum": "748f4d85dff5e89a106a74b7f8c80a5a52cb735680356a00da025695c7b21198",
        "weights": {128: "models/pretrained/generators/BigGAN/G_ema.pth"},
    },
    "ProgGAN": {
        "url": "https://www.dropbox.com/s/697ibqzlw8mboo9/pretrained_proggan_generator.tar?dl=1",
        "sha256sum": "08a27b36fda82d840136e570637b2b3bf5dfcf92732d298b9684e07d071aa64b",
        "weights": {
            1024: "models/pretrained/generators/ProgGAN/100_celeb_hq_network-snapshot-010403.pth"
        },
    },
    "StyleGAN2": {
        "url": "https://www.dropbox.com/s/rwhul1kjg2r2m88/pretrained_stylegan2_generators.tar?dl=1",
        "sha256sum": "99f345cc67d88cc5292fed0f8b458192d57eccb0ec291145b5123de5015d0608",
        "weights": {
            256: "models/pretrained/generators/StyleGAN2/stylegan2-ffhq-256-550000.pt",
            1024: "models/pretrained/generators/StyleGAN2/stylegan2-ffhq-config-f.pt",
        },
    },
}

# Pretrained WarpedGANSpace experiment tarballs (reference lib/config.py:71-94).
SNGAN_MNIST_LeNet_K64_D128_LearnGammas_eps0d15_0d25 = (
    "https://www.dropbox.com/s/sn16j9w6h35nyqv/SNGAN_MNIST-LeNet-K64-D128-LearnGammas-eps0.15_0.25.tar?dl=1",
    "29212be9a23f4906ce0ef6d3735cd9bdd9f12825f63187a5d1dd6a153fc85a95",
)
SNGAN_AnimeFaces_LeNet_K64_D128_LearnGammas_eps0d25_0d35 = (
    "https://www.dropbox.com/s/dlmqk8oes723sq8/SNGAN_AnimeFaces-LeNet-K64-D128-LearnGammas-eps0.25_0.35.tar?dl=1",
    "211a219b66e77844d5babccdf2028daed647e15696d6bb0a7d9b833b110bc245",
)
BigGAN_239_ResNet_K120_D256_LearnGammas_eps0d15_0d25 = (
    "https://www.dropbox.com/s/8v72vmehw214u8c/BigGAN-239-ResNet-K120-D256-LearnGammas-eps0.1_0.2.tar?dl=1",
    "df346b0edb83d11add784bcbb915a78695f6c29435ea1b6165eb70166f5b3995",
)
ProgGAN_ResNet_K200_D512_LearnGammas_eps0d1_0d2 = (
    "https://www.dropbox.com/s/kw9ozsgo5emx2ef/ProgGAN-ResNet-K200-D512-LearnGammas-eps0.1_0.2.tar?dl=1",
    "867daac2b516f1ab1282c85bd9a8a14db07cb9095495a2d1591c0efe9b20fcac",
)
StyleGAN2_1024_W_ResNet_K200_D512_LearnGammas_eps0d1_0d2 = (
    "https://www.dropbox.com/s/w2bnb1jukcyx2fk/StyleGAN2-1024-W-ResNet-K200-D512-LearnGammas-eps0.1_0.2.tar?dl=1",
    "2579db60d2f04065f05d3aa86216c0a6f7b04022f2623ba770311c3c3c4a88de",
)

# Attribute-evaluation model artifacts (reference lib/config.py:101-142).
SFD = (
    "https://www.dropbox.com/s/zejv9acgk62lfbv/sfd.tar?dl=1",
    "2bea5f1c10110e356eef3f4efd45169100b9c7704eb6e6abd309df58f34452d4",
)
ARCFACE = (
    "https://www.dropbox.com/s/vumuvgh84mhorx4/arcface.tar?dl=1",
    "edd5854cacd86c17a78a11f70ab8c49bceffefb90ee070754288fa7ceadcdfb2",
)
FAIRFACE = (
    "https://www.dropbox.com/s/xnxd2wnfgzt3og1/fairface.tar?dl=1",
    "0e78ff8b79612e52e226461fb67f6cff43cef0959d1ab2b520acdcc9105d065e",
)
HOPENET = (
    "https://www.dropbox.com/s/bckhfk4u02sl8lz/hopenet.tar?dl=1",
    "8c9d67dd8f82ce3332c43b5fc407dc57674d1f16fbe7f0743e9ad57ede73e33f",
)
AUDET = (
    "https://www.dropbox.com/s/qzeugjqi4ss2w5m/au_detector.tar?dl=1",
    "dbdf18bf541de3c46769d712866bef38496b7528072850c28207747b2b2c101e",
)
CELEBA_ATTRIBUTES = (
    "https://www.dropbox.com/s/ulyu428dw620vhi/celeba_attributes.tar?dl=1",
    "45276f2df865112c7488fe128d8c79527da252aad30fc541417b9961dfdd9bbc",
)


@functools.lru_cache(maxsize=1)
def biggan_classes() -> dict[int, str]:
    """ImageNet class-id -> name map (reference lib/config.py:150-1151)."""
    path = osp.join(osp.dirname(__file__), "configs", "biggan_classes.json")
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


# The reference's constant, read from the JSON file on first access only
# (PEP 562 module __getattr__), then bound in the module as a plain dict.
def __getattr__(name):
    if name == "BIGGAN_CLASSES":
        globals()["BIGGAN_CLASSES"] = biggan_classes()  # later lookups skip __getattr__
        return globals()["BIGGAN_CLASSES"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
