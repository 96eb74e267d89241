"""StyleGAN2's generator (config-f), plain, from the reference layout.

The equations of ``models/StyleGAN2/model.py`` (rosinality's PyTorch port of
NVlabs' config-f, which WarpedGANSpace loads): a mapping network of PixelNorm
and equalized-lr linears with fused leaky ReLU; a constant 4x4 input; styled
convolutions whose per-sample weights are modulated by the style and
demodulated, as grouped convolutions, the upsampling one a stride-2
transposed conv followed by a [1,3,3,1] blur; noise injection from the fixed
buffers; ToRGB with the blur-upsampled skip. The equalized-lr scales are
applied at run time, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.quant import exact

SQRT2 = math.sqrt(2.0)


def make_kernel(k) -> torch.Tensor:
    k = torch.tensor(k, dtype=torch.float32)
    k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Zero-stuff by ``up`` (zeros after each sample), pad (pad0 before, pad1
    after), correlate with the flipped kernel, keep every ``down``-th sample."""
    b, c, h, w = x.shape
    x = x.reshape(b * c, 1, h, 1, w, 1)
    x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
    x = x.reshape(b * c, 1, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kh, kw = kernel.shape
    x = F.conv2d(x, torch.flip(kernel, (0, 1)).to(x).reshape(1, 1, kh, kw))
    x = x[:, :, ::down, ::down]
    return x.reshape(b, c, x.shape[-2], x.shape[-1])


def fused_leaky_relu(x, bias):
    return F.leaky_relu(x + bias.reshape(1, -1, *([1] * (x.dim() - 2))), 0.2) * SQRT2


class StyleGAN2:
    """Generator over a reference ``g_ema`` state dict (tensors on the device)."""

    def __init__(self, sd: dict, cfg: dict, q=exact):
        self.sd, self.cfg, self.q = sd, cfg, q
        self.log_size = int(math.log2(cfg["resolution"]))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        dev = sd["input.input"].device
        self.blur_up = make_kernel(cfg["blur_kernel"]).to(dev) * 4      # factor ** 2

    def _linear(self, x, name, lr_mul=1.0, activate=False):
        w = self.sd[name + ".weight"]
        scale = lr_mul / math.sqrt(w.shape[1])
        b = self.sd[name + ".bias"] * lr_mul
        if activate:
            return fused_leaky_relu(F.linear(self.q(x), self.q(w * scale)), b)
        return F.linear(self.q(x), self.q(w * scale)) + b

    def mapping(self, z):
        x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        for i in range(1, self.cfg["n_mlp"] + 1):
            x = self._linear(x, f"style.{i}", self.cfg["lr_mlp"], activate=True)
        return x

    def _modconv(self, x, style, name, demodulate=True, upsample=False):
        w = self.sd[name + ".conv.weight"]                    # (1, out, in, k, k)
        _, out_ch, in_ch, k, _ = w.shape
        b, _, h, wd = x.shape
        s = self._linear(style, name + ".conv.modulation").view(b, 1, in_ch, 1, 1)
        weight = w / math.sqrt(in_ch * k * k) * s
        if demodulate:
            weight = weight * torch.rsqrt(weight.pow(2).sum([2, 3, 4]) + 1e-8).view(
                b, out_ch, 1, 1, 1)
        x = self.q(x).reshape(1, b * in_ch, h, wd)
        if upsample:
            weight = weight.transpose(1, 2).reshape(b * in_ch, out_ch, k, k)
            out = F.conv_transpose2d(x, self.q(weight), stride=2, groups=b)
            out = upfirdn2d(out.view(b, out_ch, out.shape[-2], out.shape[-1]), self.blur_up,
                            pad=(1, 1))
        else:
            out = F.conv2d(x, self.q(weight.reshape(b * out_ch, in_ch, k, k)), padding=k // 2,
                           groups=b)
            out = out.view(b, out_ch, h, wd)
        return out

    def _styled(self, x, style, name, noise, upsample=False):
        out = self._modconv(x, style, name, upsample=upsample)
        out = out + self.sd[name + ".noise.weight"].reshape(()) * noise
        return fused_leaky_relu(out, self.sd[name + ".activate.bias"])

    def _to_rgb(self, x, style, name, skip=None):
        out = self._modconv(x, style, name, demodulate=False) + self.sd[name + ".bias"]
        if skip is not None:
            out = out + upfirdn2d(skip, self.blur_up, up=2, pad=(2, 1))
        return out

    def synthesis(self, w):
        """(B, 512) W latents, the same at every layer -> (B, 3, R, R)."""
        b = w.shape[0]
        noise = [self.sd[f"noises.noise_{i}"] for i in range(self.num_layers)]
        out = self.sd["input.input"].expand(b, -1, -1, -1)
        out = self._styled(out, w, "conv1", noise[0])
        skip = self._to_rgb(out, w, "to_rgb1")
        for j in range(self.log_size - 2):
            out = self._styled(out, w, f"convs.{2 * j}", noise[2 * j + 1], upsample=True)
            out = self._styled(out, w, f"convs.{2 * j + 1}", noise[2 * j + 2])
            skip = self._to_rgb(out, w, f"to_rgbs.{j}", skip)
        return skip

    def latent(self, z):
        """The space the paths live in: W."""
        return self.mapping(z)

    def render(self, latent, shift):
        return self.synthesis(latent + shift)
