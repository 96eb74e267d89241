"""Generator builders: a frozen pretrained GAN behind the uniform contract.

Counterpart of :mod:`warpedganspace_tpu.models.gan_load` (reference
``models/gan_load.py``): SNGAN (MNIST 32, AnimeFaces 64), StyleGAN2 (256/1024,
shifts in Z or W), BigGAN (128, class-conditional) and ProgGAN (1024,
CelebA-HQ). ``remat`` ("off", "tail" or "full") reaches the two generators
that take it, StyleGAN2 and ProgGAN, as in the JAX package.

If the pretrained weight file is missing, builders raise FileNotFoundError
unless ``allow_random_init=True`` (or the environment sets
WGS_ALLOW_RANDOM_G=1): the generator then gets random weights from a seeded
``torch.Generator``, for smoke tests and timing on machines without weights.
"""
from __future__ import annotations

import os
import os.path as osp

import torch

from warpedganspace_torch.config import GAN_RESOLUTIONS, GAN_WEIGHTS
from warpedganspace_torch.models.api import GeneratorBundle
from warpedganspace_torch.utils.io import load_pt

def _allow_random(flag: bool | None) -> bool:
    if flag is not None:
        return flag
    return os.environ.get("WGS_ALLOW_RANDOM_G", "0") == "1"


def _load_state_dict(path: str, allow_random: bool):
    if osp.isfile(path):
        return load_pt(path)
    if allow_random:
        print(f"#. Warning: weights not found at {path}; using RANDOM generator weights")
        return None
    raise FileNotFoundError(
        f"Pretrained generator weights not found: {path} "
        "(run download_models.py, or set allow_random_init for smoke tests)")


def build_sngan(pretrained_gan_weights: str, gan_type: str,
                allow_random_init: bool | None = None, device=None) -> GeneratorBundle:
    """SNGAN (MNIST 32 / AnimeFaces 64), frozen, on ``device``
    (reference models/gan_load.py:31-58)."""
    from warpedganspace_torch.convert.sngan import load_reference_state_dict
    from warpedganspace_torch.models.sngan import SNGANGenerator

    sd = _load_state_dict(pretrained_gan_weights, _allow_random(allow_random_init))
    gen = SNGANGenerator.from_gan_type(gan_type, generator=torch.Generator().manual_seed(0))
    if sd is not None:
        load_reference_state_dict(gen, sd)
    gen.requires_grad_(False).eval()
    return GeneratorBundle(gan_type, gen.to(device), dim_z=gen.dim_z,
                           resolution=gen.resolution)


def build_stylegan2(pretrained_gan_weights: str, resolution: int,
                    shift_in_w_space: bool = False, allow_random_init: bool | None = None,
                    device=None, remat: str = "off") -> GeneratorBundle:
    """StyleGAN2 FFHQ (256 / 1024, config-f), frozen, on ``device``."""
    from warpedganspace_torch.convert.stylegan2 import load_reference_state_dict
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    sd = _load_state_dict(pretrained_gan_weights, _allow_random(allow_random_init))
    gen = StyleGAN2Generator(resolution=resolution, shift_in_w_space=shift_in_w_space,
                             generator=torch.Generator().manual_seed(0), remat=remat)
    if sd is not None:
        load_reference_state_dict(gen, sd)
    gen.requires_grad_(False).eval()
    return GeneratorBundle("StyleGAN2", gen.to(device), dim_z=gen.dim_z,
                           resolution=resolution, shift_in_w_space=shift_in_w_space)


def build_biggan(pretrained_gan_weights: str, target_classes,
                 allow_random_init: bool | None = None, device=None) -> GeneratorBundle:
    """BigGAN 128^2 class-conditional, frozen, on ``device``. When the caller
    gives no ``y``, the generator draws a class per batch element from
    ``target_classes`` (see :mod:`warpedganspace_torch.models.biggan`). On a
    CUDA device its attention runs through the hand-written kernels: the
    forward in every generator forward, the backward in every training step."""
    from warpedganspace_torch.convert.biggan import load_reference_state_dict
    from warpedganspace_torch.models.biggan import BigGANGenerator

    sd = _load_state_dict(pretrained_gan_weights, _allow_random(allow_random_init))
    gen = BigGANGenerator.from_config(target_classes=target_classes,
                                      generator=torch.Generator().manual_seed(0))
    if sd is not None:
        load_reference_state_dict(gen, sd)
    gen.requires_grad_(False).eval()
    return GeneratorBundle("BigGAN", gen.to(device), dim_z=gen.dim_z,
                           resolution=gen.resolution)


def build_proggan(pretrained_gan_weights: str, allow_random_init: bool | None = None,
                  device=None, remat: str = "off") -> GeneratorBundle:
    """ProgGAN 1024^2 CelebA-HQ, frozen, on ``device``. On a CUDA device every
    render's <=64-channel tail runs through the hand-written kernel (see
    :mod:`warpedganspace_torch.models.proggan`)."""
    from warpedganspace_torch.convert.proggan import load_reference_state_dict
    from warpedganspace_torch.models.proggan import ProgGANGenerator

    sd = _load_state_dict(pretrained_gan_weights, _allow_random(allow_random_init))
    gen = ProgGANGenerator(generator=torch.Generator().manual_seed(0), remat=remat)
    if sd is not None:
        load_reference_state_dict(gen, sd)
    gen.requires_grad_(False).eval()
    return GeneratorBundle("ProgGAN", gen.to(device), dim_z=gen.dim_z,
                           resolution=gen.resolution)


def build_gan(gan_type: str, target_classes=None, stylegan2_resolution: int = 1024,
              shift_in_w_space: bool = False, weights_root: str = ".",
              allow_random_init: bool | None = None, device=None,
              remat: str = "off") -> GeneratorBundle:
    """Dispatcher used by the CLIs (reference traverse_latent_space.py:233-259)."""
    if gan_type not in GAN_WEIGHTS:
        raise ValueError(f"unknown GAN type {gan_type!r}")
    if gan_type == "StyleGAN2":
        path = osp.join(weights_root, GAN_WEIGHTS[gan_type]["weights"][stylegan2_resolution])
        return build_stylegan2(path, stylegan2_resolution, shift_in_w_space,
                               allow_random_init, device=device, remat=remat)
    if gan_type == "BigGAN":
        path = osp.join(weights_root, GAN_WEIGHTS[gan_type]["weights"][GAN_RESOLUTIONS[gan_type]])
        return build_biggan(path, target_classes, allow_random_init, device=device)
    if gan_type == "ProgGAN":
        path = osp.join(weights_root, GAN_WEIGHTS[gan_type]["weights"][GAN_RESOLUTIONS[gan_type]])
        return build_proggan(path, allow_random_init, device=device, remat=remat)
    path = osp.join(weights_root, GAN_WEIGHTS[gan_type]["weights"][GAN_RESOLUTIONS[gan_type]])
    return build_sngan(path, gan_type, allow_random_init, device=device)
