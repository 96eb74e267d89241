"""StyleGAN2 (rosinality's ``g_ema`` layout): weights, the port's generator,
the plain reference, the operation counts."""
from __future__ import annotations

import math

import torch

from benchmark.counts.generators import sg2_mapping_flops, sg2_synthesis_flops
from benchmark.inputs import randn_views
from benchmark.reference.stylegan2 import StyleGAN2

# 8x8 (the 512-channel 4x4 and 8x8 blocks) with 3 sets of 4 dipoles.
TINY = {"num_support_sets": 3, "num_support_dipoles": 4, "resolution": 8}


def _layers(cfg: dict):
    """(name, in, out, kernel, kind) of every modulated conv in the layout."""
    ch = {int(k): v for k, v in cfg["channels"].items()}
    yield "conv1", ch[4], ch[4], 3, "styled"
    yield "to_rgb1", ch[4], 3, 1, "rgb"
    for j in range(int(math.log2(cfg["resolution"])) - 2):
        i, o = ch[2 ** (j + 2)], ch[2 ** (j + 3)]
        yield f"convs.{2 * j}", i, o, 3, "styled"
        yield f"convs.{2 * j + 1}", o, o, 3, "styled"
        yield f"to_rgbs.{j}", o, 3, 1, "rgb"


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """A ``g_ema`` state dict drawn from ``gen``: N(0, 1) weights as the
    reference stores them (the mapping's divided by its lr multiplier), the
    modulation biases about 1, and the noise weights, biases and ToRGB
    biases away from 0 so that no term of the generator is hidden."""
    s, lr = cfg["style_dim"], cfg["lr_mlp"]
    shapes = {}
    for i in range(1, cfg["n_mlp"] + 1):
        shapes[f"style.{i}.weight"] = (s, s)
        shapes[f"style.{i}.bias"] = (s,)
    shapes["input.input"] = (1, int(cfg["channels"]["4"]), 4, 4)
    for name, i, o, k, kind in _layers(cfg):
        shapes[name + ".conv.weight"] = (1, o, i, k, k)
        shapes[name + ".conv.modulation.weight"] = (i, s)
        shapes[name + ".conv.modulation.bias"] = (i,)
        if kind == "styled":
            shapes[name + ".noise.weight"] = (1,)
            shapes[name + ".activate.bias"] = (o,)
        else:
            shapes[name + ".bias"] = (1, 3, 1, 1)
    log_size = int(math.log2(cfg["resolution"]))
    for i in range((log_size - 2) * 2 + 1):
        size = 2 ** ((i + 5) // 2)
        shapes[f"noises.noise_{i}"] = (1, 1, size, size)
    sd = randn_views(gen, shapes, device)
    for i in range(1, cfg["n_mlp"] + 1):
        sd[f"style.{i}.weight"] = sd[f"style.{i}.weight"] / lr
        sd[f"style.{i}.bias"] = 0.1 * sd[f"style.{i}.bias"] / lr
    for name, *_ in _layers(cfg):
        sd[name + ".conv.modulation.bias"] = 1.0 + 0.1 * sd[name + ".conv.modulation.bias"]
        for small in (".noise.weight", ".activate.bias", ".bias"):
            if name + small in sd:
                sd[name + small] = 0.1 * sd[name + small]
    return sd


def build_program(cfg: dict, sd: dict, device):
    """The port's frozen generator, loaded through its own converter, behind
    the uniform contract (as ``models/gan_load.py::build_stylegan2`` builds it)."""
    from warpedganspace_torch.convert.stylegan2 import load_reference_state_dict
    from warpedganspace_torch.models.api import GeneratorBundle
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    w_space = cfg["latent_space"] == "w"
    net = StyleGAN2Generator(resolution=cfg["resolution"], style_dim=cfg["style_dim"],
                             n_mlp=cfg["n_mlp"], channel_multiplier=cfg["channel_multiplier"],
                             shift_in_w_space=w_space,
                             generator=torch.Generator().manual_seed(0))
    load_reference_state_dict(net, sd)
    net.requires_grad_(False).eval()
    return GeneratorBundle("StyleGAN2", net.to(device), dim_z=net.dim_z,
                           resolution=cfg["resolution"], shift_in_w_space=w_space)


def build_reference(cfg: dict, sd: dict, q):
    return StyleGAN2(sd, cfg, q)


def frame_flops(cfg: dict) -> float:
    """One frame in the configuration's latent space: the synthesis from W,
    and the mapping too where the paths live in Z."""
    mapping = sg2_mapping_flops(cfg) if cfg["latent_space"] == "z" else 0
    return mapping + sg2_synthesis_flops(cfg)


def forward_flops(cfg: dict) -> float:
    """One forward from Z: the mapping and the synthesis."""
    return sg2_mapping_flops(cfg) + sg2_synthesis_flops(cfg)
