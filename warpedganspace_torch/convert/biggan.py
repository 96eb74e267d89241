"""BigGAN torch checkpoints -> the port's generator and discriminator state dicts.

Counterpart of :mod:`warpedganspace_tpu.convert.biggan`. Spectral
normalization is folded here: the reference divides every SN weight by a
singular-value estimate obtained from ONE power-iteration step off the stored
``u0`` buffer, without updating it at eval (layers.py:85-95 with update=False
given G.eval(); num_svs=num_itrs=1 per generator_config.json). That step is
reproduced in numpy (v = normalize(u W), u' = normalize(v W^T),
sigma = ||v W^T||) and W / sigma is stored, in the port's layouts: OIHW
convolutions and (out, in) linears, which are the checkpoint's own. The
discriminator's SNEmbedding (layers.py:121-135) runs the same step on its
(num_embeddings, dim) matrix, as an SN linear with one output per class.
"""
from __future__ import annotations

import numpy as np
import torch

SN_EPS = 1e-6  # generator_config.json SN_eps


def _normalize(x, eps):
    return x / max(np.linalg.norm(x), eps)


def _sn_sigma(w_mat: np.ndarray, u: np.ndarray) -> float:
    """One power-iteration step from the stored u (layers.py:25-47)."""
    v = _normalize(u @ w_mat, SN_EPS)
    uw = v @ w_mat.T
    u2 = _normalize(uw, SN_EPS)
    return float(np.dot(uw.ravel(), u2.ravel()))


def _arr(sd, key) -> np.ndarray:
    return np.asarray(sd[key], dtype=np.float32)


def _sn(sd, src: str, dst: str, out: dict, bias: bool = True) -> None:
    """An SN conv (OIHW) or linear (out, in): weight / sigma, bias as it is
    (zeros where the checkpoint leaves it out)."""
    w = _arr(sd, src + ".weight")
    u = _arr(sd, src + ".u0").reshape(1, -1)
    sigma = _sn_sigma(w.reshape(w.shape[0], -1), u)
    out[dst + ".weight"] = torch.from_numpy(w / sigma)
    if bias:
        out[dst + ".bias"] = (torch.from_numpy(_arr(sd, src + ".bias").copy())
                              if src + ".bias" in sd else torch.zeros(w.shape[0]))


def _ccbn(sd, src: str, dst: str, out: dict) -> None:
    _sn(sd, src + ".gain", dst + ".gain", out, bias=False)
    _sn(sd, src + ".bias", dst + ".bias", out, bias=False)
    out[dst + ".mean"] = torch.from_numpy(_arr(sd, src + ".stored_mean").copy())
    out[dst + ".var"] = torch.from_numpy(_arr(sd, src + ".stored_var").copy())


def biggan_state_dict_from_reference(sd: dict) -> dict[str, torch.Tensor]:
    """Reference ``G_ema.pth`` ``state_dict`` (tensors or numpy arrays) -> the
    ``state_dict`` of :class:`warpedganspace_torch.models.biggan.BigGANGenerator`."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {
        "shared_embed": torch.from_numpy(_arr(sd, "shared.weight").copy())}
    _sn(sd, "linear", "linear", out)
    for dst, src in (("scale", "gain"), ("bias", "bias"), ("mean", "stored_mean"),
                     ("var", "stored_var")):
        out[f"out_bn.{dst}"] = torch.from_numpy(_arr(sd, f"output_layer.0.{src}").copy())
    _sn(sd, "output_layer.2", "out_conv", out)
    i = 0
    while f"blocks.{i}.0.conv1.weight" in sd:
        src, dst = f"blocks.{i}.0.", f"blocks.{i}."
        _ccbn(sd, src + "bn1", dst + "bn1", out)
        _ccbn(sd, src + "bn2", dst + "bn2", out)
        for name in ("conv1", "conv2", "conv_sc"):
            _sn(sd, src + name, dst + name, out)
        _attention(sd, i, out)
        i += 1
    return out


def _attention(sd, i: int, out: dict) -> None:
    """Block ``i``'s attention, where the checkpoint has one (``blocks.i.1``)."""
    if f"blocks.{i}.1.theta.weight" in sd:
        asrc, adst = f"blocks.{i}.1.", f"blocks.{i}.attention."
        for name in ("theta", "phi", "g", "o"):
            _sn(sd, asrc + name, adst + name, out, bias=False)
        out[adst + "gamma"] = torch.from_numpy(_arr(sd, asrc + "gamma").reshape(()).copy())


def biggan_d_state_dict_from_reference(sd: dict) -> dict[str, torch.Tensor]:
    """Reference Discriminator ``state_dict`` (BigGAN.py:281-399; tensors or
    numpy arrays) -> the ``state_dict`` of
    :class:`warpedganspace_torch.models.biggan.BigGANDiscriminator`."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    _sn(sd, "linear", "linear", out)
    _sn(sd, "embed", "embed", out, bias=False)
    i = 0
    while f"blocks.{i}.0.conv1.weight" in sd:
        src, dst = f"blocks.{i}.0.", f"blocks.{i}."
        for name in ("conv1", "conv2", "conv_sc"):
            if src + name + ".weight" in sd:
                _sn(sd, src + name, dst + name, out)
        _attention(sd, i, out)
        i += 1
    return out


def load_reference_state_dict(gen, sd: dict):
    """Load a reference ``G_ema.pth`` ``state_dict`` into ``gen`` (strict)."""
    gen.load_state_dict(biggan_state_dict_from_reference(sd))
    return gen
