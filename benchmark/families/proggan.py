"""ProgGAN (the reference ``features.N`` / ``output`` layout): weights, the
port's generator, the plain reference."""
from __future__ import annotations

import math

import torch

from benchmark.counts.generators import proggan_specs
from benchmark.inputs import randn_views
from benchmark.reference.proggan import ProgGAN


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """A state dict drawn from ``gen``: N(0, 1) conv weights, each WScale's
    scale He's sqrt(2 / fan in) (the head's sqrt(1 / fan in)), its bias
    N(0, 0.1^2)."""
    specs = proggan_specs(cfg)
    shapes = {}
    for j, (k, _, i, o) in enumerate(specs):
        shapes[f"features.{j}.conv.weight"] = (o, i, k, k)
        shapes[f"features.{j}.wscale.b"] = (o,)
    c = cfg["channels"][-1]
    shapes["output.conv.weight"] = (3, c, 1, 1)
    shapes["output.wscale.b"] = (3,)
    sd = randn_views(gen, shapes, device)
    for j, (k, _, i, o) in enumerate(specs):
        sd[f"features.{j}.wscale.b"] = 0.1 * sd[f"features.{j}.wscale.b"]
        sd[f"features.{j}.wscale.scale"] = torch.full((1,), math.sqrt(2.0 / (i * k * k)),
                                                      device=device)
    sd["output.wscale.b"] = 0.1 * sd["output.wscale.b"]
    sd["output.wscale.scale"] = torch.full((1,), math.sqrt(1.0 / c), device=device)
    return sd


def build_program(cfg: dict, sd: dict, device):
    """The port's frozen generator, loaded through its own converter, behind
    the uniform contract (as ``models/gan_load.py::build_proggan`` builds it)."""
    from warpedganspace_torch.convert.proggan import load_reference_state_dict
    from warpedganspace_torch.models.api import GeneratorBundle
    from warpedganspace_torch.models.proggan import ProgGANGenerator

    net = ProgGANGenerator(dim_z=cfg["dim_z"], channels=cfg["channels"],
                           generator=torch.Generator().manual_seed(0))
    load_reference_state_dict(net, sd)
    net.requires_grad_(False).eval()
    return GeneratorBundle("ProgGAN", net.to(device), dim_z=net.dim_z,
                           resolution=net.resolution)


def build_reference(cfg: dict, sd: dict, q):
    return ProgGAN(sd, cfg, q)

