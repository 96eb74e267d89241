"""Reference StyleGAN2 state dicts -> the port's generator and discriminator.

Counterpart of :mod:`warpedganspace_tpu.convert.stylegan2` (reference
``models/StyleGAN2/model.py`` Generator, the ``g_ema`` payload of the
stylegan2-ffhq checkpoints, and Discriminator, their ``d`` payload). The
equalized-lr runtime scales are folded into the stored weights exactly as the
JAX converter folds them:

- EqualLinear: w_eff = w * (lr_mul / sqrt(in)), b_eff = b * lr_mul;
- ModulatedConv2d: w_eff = w * (1 / sqrt(in * k^2)), (1, out, in, kh, kw) -> OIHW;
- EqualConv2d: w_eff = w * (1 / sqrt(in * k^2)), OIHW as stored.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _arr(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _eq_linear(sd, src, dst, out, lr_mul=1.0):
    w = _arr(sd[src + ".weight"])                       # (out, in)
    out[dst + ".weight"] = w * (lr_mul / math.sqrt(w.shape[1]))
    out[dst + ".bias"] = _arr(sd[src + ".bias"]) * lr_mul


def _mod_conv(sd, src, dst, out):
    w = _arr(sd[src + ".conv.weight"])[0]               # (out, in, kh, kw)
    out[dst + ".conv.weight"] = w / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
    _eq_linear(sd, src + ".conv.modulation", dst + ".conv.modulation", out)


def _styled_conv(sd, name, out):
    _mod_conv(sd, name, name, out)
    out[name + ".noise_weight"] = _arr(sd[name + ".noise.weight"]).reshape(())
    out[name + ".act_bias"] = _arr(sd[name + ".activate.bias"])


def _to_rgb(sd, name, out):
    _mod_conv(sd, name, name, out)
    out[name + ".bias"] = _arr(sd[name + ".bias"]).reshape(3)


def stylegan2_state_dict_from_reference(sd: dict, resolution: int) -> dict[str, torch.Tensor]:
    """Map a reference Generator state dict (numpy arrays or tensors) to
    :class:`~warpedganspace_torch.models.stylegan2.StyleGAN2Generator` keys."""
    log_size = int(math.log2(resolution))
    num_layers = (log_size - 2) * 2 + 1
    out: dict[str, np.ndarray] = {}
    n_mlp = 0
    while f"style.{n_mlp + 1}.weight" in sd:
        _eq_linear(sd, f"style.{n_mlp + 1}", f"mapping.{n_mlp}", out, lr_mul=0.01)
        n_mlp += 1
    out["const_input"] = _arr(sd["input.input"])        # (1, 512, 4, 4)
    _styled_conv(sd, "conv1", out)
    _to_rgb(sd, "to_rgb1", out)
    for j in range(log_size - 2):
        _styled_conv(sd, f"convs.{2 * j}", out)
        _styled_conv(sd, f"convs.{2 * j + 1}", out)
        _to_rgb(sd, f"to_rgbs.{j}", out)
    for i in range(num_layers):
        out[f"noises.noise_{i}"] = _arr(sd[f"noises.noise_{i}"])   # (1, 1, H, W)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_reference_state_dict(G, sd: dict):
    """Load a reference ``g_ema`` (or a checkpoint holding one) into ``G``."""
    sd = sd["g_ema"] if "g_ema" in sd else sd
    G.load_state_dict(stylegan2_state_dict_from_reference(sd, G.resolution))
    return G


def _eq_conv(sd, src, dst, out, bias_key=None):
    """EqualConv2d (model.py:86-107), with the FusedLeakyReLU bias that follows it."""
    w = _arr(sd[src + ".weight"])                       # (out, in, kh, kw)
    out[dst + ".weight"] = w / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
    if bias_key is not None:
        out[dst + ".act_bias"] = _arr(sd[bias_key])


def stylegan2_discriminator_state_dict_from_reference(
        sd: dict, resolution: int) -> dict[str, torch.Tensor]:
    """Map a reference Discriminator state dict (numpy arrays or tensors) to
    :class:`~warpedganspace_torch.models.stylegan2.StyleGAN2Discriminator` keys.
    The reference's ``convs`` holds the 1x1 input conv, then one ResBlock per
    resolution; its blur kernels are buffers the port rebuilds."""
    out: dict[str, np.ndarray] = {}
    _eq_conv(sd, "convs.0.0", "conv_in", out, bias_key="convs.0.1.bias")
    for j in range(1, int(math.log2(resolution)) - 1):
        src, dst = f"convs.{j}", f"blocks.{j - 1}"
        _eq_conv(sd, src + ".conv1.0", dst + ".conv1", out, bias_key=src + ".conv1.1.bias")
        _eq_conv(sd, src + ".conv2.1", dst + ".conv2", out, bias_key=src + ".conv2.2.bias")
        _eq_conv(sd, src + ".skip.1", dst + ".skip", out)
    _eq_conv(sd, "final_conv.0", "final_conv", out, bias_key="final_conv.1.bias")
    _eq_linear(sd, "final_linear.0", "final_linear1", out)
    _eq_linear(sd, "final_linear.1", "final_linear2", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
