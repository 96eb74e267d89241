"""The JAX package's parameter pytrees, as numpy arrays, -> the port's state dicts.

The JAX package stores convolutions HWIO, linears (in, out), activations and
noise buffers NHWC; the port stores OIHW, (out, in) and NCHW. Both already
hold the equalized-lr scales folded in, so only layouts change. The caller
converts the pytree's leaves with ``numpy.asarray``; this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x, *perm) -> torch.Tensor:
    x = np.asarray(x, dtype=np.float32)
    if perm:
        x = np.transpose(x, perm)
    return torch.from_numpy(np.array(x, order="C"))  # a writable copy


def _linear(p, dst, out):
    out[dst + ".weight"] = _t(p["w"], 1, 0)          # (in, out) -> (out, in)
    if "b" in p:
        out[dst + ".bias"] = _t(p["b"])


def _conv(p, dst, out, bias=True):
    """``bias``: the port's conv has one; a pytree that leaves it out gets zeros."""
    w = out[dst + ".weight"] = _t(p["w"], 3, 2, 0, 1)    # HWIO -> OIHW
    if bias:
        out[dst + ".bias"] = _t(p["b"]) if "b" in p else torch.zeros(w.shape[0])


def _mod_conv(p, dst, out):
    out[dst + ".conv.weight"] = _t(p["w"], 3, 2, 0, 1)   # HWIO -> OIHW
    _linear(p["mod"], dst + ".conv.modulation", out)


def _styled(p, dst, out):
    _mod_conv(p, dst, out)
    out[dst + ".noise_weight"] = _t(p["noise_weight"]).reshape(())
    out[dst + ".act_bias"] = _t(p["act_bias"])


def _rgb(p, dst, out):
    _mod_conv(p, dst, out)
    out[dst + ".bias"] = _t(p["bias"])


def stylegan2_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``StyleGAN2Generator.init``/converter params -> port generator state dict."""
    out: dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["mapping"]):
        _linear(layer, f"mapping.{i}", out)
    out["const_input"] = _t(params["const_input"], 0, 3, 1, 2)   # (1,4,4,C) -> (1,C,4,4)
    _styled(params["conv1"], "conv1", out)
    _rgb(params["to_rgb1"], "to_rgb1", out)
    for j, p in enumerate(params["convs"]):
        _styled(p, f"convs.{j}", out)
    for j, p in enumerate(params["to_rgbs"]):
        _rgb(p, f"to_rgbs.{j}", out)
    for i, n in enumerate(params["noises"]):
        out[f"noises.noise_{i}"] = _t(n, 0, 3, 1, 2)            # (1,H,W,1) -> (1,1,H,W)
    return out


def _eq_conv(p, dst, out):
    """A discriminator ConvLayer: HWIO -> OIHW, with its fused bias if it has one."""
    out[dst + ".weight"] = _t(p["w"], 3, 2, 0, 1)
    if "act_bias" in p:
        out[dst + ".act_bias"] = _t(p["act_bias"])


def stylegan2_discriminator_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``StyleGAN2Discriminator.init``/converter params -> port discriminator state dict."""
    out: dict[str, torch.Tensor] = {}
    _eq_conv(params["conv_in"], "conv_in", out)
    for i, block in enumerate(params["blocks"]):
        for name in ("conv1", "conv2", "skip"):
            _eq_conv(block[name], f"blocks.{i}.{name}", out)
    _eq_conv(params["final_conv"], "final_conv", out)
    _linear(params["final_linear1"], "final_linear1", out)
    _linear(params["final_linear2"], "final_linear2", out)
    return out


def _ccbn(p, dst, out):
    _linear(p["gain"], dst + ".gain", out)
    _linear(p["bias"], dst + ".bias", out)
    out[dst + ".mean"] = _t(p["mean"])
    out[dst + ".var"] = _t(p["var"])


def _attention(p, dst, out):
    for name in ("theta", "phi", "g", "o"):
        _conv(p[name], dst + name, out, bias=False)
    out[dst + "gamma"] = _t(p["gamma"]).reshape(())


def biggan_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``BigGANGenerator.init``/converter params -> port generator state dict."""
    out: dict[str, torch.Tensor] = {"shared_embed": _t(params["shared_embed"])}
    _linear(params["linear"], "linear", out)
    for i, block in enumerate(params["blocks"]):
        dst = f"blocks.{i}."
        _ccbn(block["bn1"], dst + "bn1", out)
        _ccbn(block["bn2"], dst + "bn2", out)
        for name in ("conv1", "conv2", "conv_sc"):
            _conv(block[name], dst + name, out)
        if "attention" in block:
            _attention(block["attention"], dst + "attention.", out)
    for name in ("scale", "bias", "mean", "var"):
        out["out_bn." + name] = _t(params["out_bn"][name])
    _conv(params["out_conv"], "out_conv", out)
    return out


def biggan_d_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``BigGANDiscriminator.init``/converter params -> port discriminator state dict."""
    out: dict[str, torch.Tensor] = {"embed.weight": _t(params["embed"])}
    _linear(params["linear"], "linear", out)
    for i, block in enumerate(params["blocks"]):
        dst = f"blocks.{i}."
        for name in ("conv1", "conv2", "conv_sc"):
            if name in block:
                _conv(block[name], dst + name, out)
        if "attention" in block:
            _attention(block["attention"], dst + "attention.", out)
    return out


def _wscale_conv(p, dst, out):
    out[dst + ".weight"] = _t(p["conv"]["w"], 3, 2, 0, 1)      # HWIO -> OIHW
    out[dst + ".scale"] = _t(p["wscale_scale"]).reshape(1)
    out[dst + ".bias"] = _t(p["wscale_bias"])


def proggan_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``ProgGANGenerator.init``/converter params -> port generator state dict."""
    out: dict[str, torch.Tensor] = {}
    for i, block in enumerate(params["blocks"]):
        _wscale_conv(block, f"blocks.{i}", out)
    _wscale_conv(params["out"], "out", out)
    return out


def sngan_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``SNGANGenerator.init``/converter params -> port generator state dict."""
    out: dict[str, torch.Tensor] = {}
    _linear(params["dense"], "dense", out)
    for i, block in enumerate(params["blocks"]):
        dst = f"blocks.{i}."
        for name in ("bn1", "bn2"):
            _bn(block[name], dst + name, out)
        for name in ("conv1", "conv2"):
            _conv(block[name], dst + name, out)
        if "bypass_conv" in block:
            _conv(block["bypass_conv"], dst + "bypass", out)
    _bn(params["out_bn"], "out_bn", out)
    _conv(params["out_conv"], "out_conv", out)
    return out


def support_sets_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``SupportSets.init`` params -> the reference state-dict layout that
    :meth:`SupportSets.from_torch_state_dict` reads."""
    sv = np.asarray(params["support_sets"], dtype=np.float32)
    return {"SUPPORT_SETS": _t(sv.reshape(sv.shape[0], -1)),
            "ALPHAS": _t(params["alphas"]),
            "LOGGAMMA": _t(params["loggamma"])}


def _bn(p, dst, out):
    out[dst + ".weight"] = _t(p["scale"])
    out[dst + ".bias"] = _t(p["bias"])
    out[dst + ".running_mean"] = _t(p["mean"])
    out[dst + ".running_var"] = _t(p["var"])


def reconstructor_from_jax(params: dict, reconstructor_type: str) -> dict[str, torch.Tensor]:
    """``Reconstructor.init`` params -> the reference state-dict layout that
    :func:`warpedganspace_torch.convert.reconstructor.load_reference_state_dict` reads."""
    out: dict[str, torch.Tensor] = {}
    if reconstructor_type == "LeNet":
        for i, idx in enumerate((0, 4, 8), start=1):
            _conv(params[f"conv{i}"], f"feature_extractor.{idx}", out)
            _bn(params[f"bn{i}"], f"feature_extractor.{idx + 1}", out)
        for head, dst in (("cls", "path_indices"), ("reg", "shift_magnitudes")):
            _linear(params[head + "_fc1"], dst + ".0", out)
            _bn(params[head + "_bn"], dst + ".1", out)
            _linear(params[head + "_fc2"], dst + ".3", out)
        return out
    if reconstructor_type != "ResNet":
        raise ValueError(f"unknown reconstructor type {reconstructor_type!r}")
    fe = "features_extractor."
    _conv(params["conv1"], fe + "conv1", out, bias=False)
    _bn(params["bn1"], fe + "bn1", out)
    for li in range(1, 5):
        for bi, block in enumerate(params[f"layer{li}"]):
            pre = f"{fe}layer{li}.{bi}."
            _conv(block["conv1"], pre + "conv1", out, bias=False)
            _bn(block["bn1"], pre + "bn1", out)
            _conv(block["conv2"], pre + "conv2", out, bias=False)
            _bn(block["bn2"], pre + "bn2", out)
            if "downsample" in block:
                _conv(block["downsample"]["conv"], pre + "downsample.0", out, bias=False)
                _bn(block["downsample"]["bn"], pre + "downsample.1", out)
    _linear(params["cls_fc"], "path_indices", out)
    _linear(params["reg_fc"], "shift_magnitudes", out)
    return out
