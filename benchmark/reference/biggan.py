"""BigGAN's class-conditional ImageNet generator, plain, from the reference layout.

The equations of BigGAN-PyTorch's ``BigGAN.py`` Generator and ``layers.py``
(Brock et al. 2019) in eval mode, read from a ``G_ema.pth`` state dict:

- spectral norm folded here: each SN weight W, viewed as (out, -1), is divided
  by sigma from one power-iteration step off its stored ``u0``, which eval
  does not update (layers.py:25-47, 85-95): v = normalize(u0 W),
  u = normalize(v W^T), sigma = (v W^T) . u;
- hierarchical z (BigGAN.py:224-229): z split into chunks of
  dim_z // (blocks + 1); chunk 0 feeds the first SN linear, whose output is
  the (C, 4, 4) bottom map, and each later chunk, after the class's shared
  embedding, conditions one block;
- each block (layers.py:372-405): ccbn -> ReLU -> nearest 2x up -> SN conv3x3
  -> ccbn -> ReLU -> SN conv3x3, plus an SN conv1x1 of the upsampled input;
- ccbn (layers.py:275-326): batch norm with stored statistics and no affine,
  times 1 + SN linear(cond), plus SN linear(cond), cond = [embedding; chunk];
- the SA-GAN block after the block at the attention's resolution
  (layers.py:141-166): theta = conv1x1(x), phi and g max-pooled 2x2 after
  their conv1x1, beta = softmax(theta^T phi) over the keys, written out as a
  (B, N, M) matrix, o = conv1x1(g beta^T), and x + gamma o;
- the output (BigGAN.py:170-174, 242-243): affine batch norm with stored
  statistics -> ReLU -> SN conv3x3 -> tanh.

Departures from BigGAN-PyTorch: the architecture is read from the state
dict's keys and shapes (blocks while ``blocks.i.0.conv1.weight`` is there, an
attention block where ``blocks.i.1.theta.weight`` is) in place of its tables;
the class is one index for every row (the configuration names one target
class); ``q`` rounds the operands of every product (convolutions, linears and
both of the attention's products, the softmax weights included) and nothing
else. The kernel rounds the softmax weights before their sum divides them,
this reference after: the same rounding up to each row's scale.
:meth:`BigGAN.stand` sets every batch norm's stored statistics as BigGAN's
standing statistics do (``utils.accumulate_standing_stats``): forwards of
several batches, each normalised by its own statistics, and the means of
their per-batch means and (here biased) variances.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.quant import exact


def _normalize(x, eps):
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


class BigGAN:
    def __init__(self, sd: dict, cfg: dict, q=exact):
        self.sd, self.cfg, self.q = sd, cfg, q
        self.n_blocks = 0
        while f"blocks.{self.n_blocks}.0.conv1.weight" in sd:
            self.n_blocks += 1
        self.chunk = cfg["dim_z"] // (self.n_blocks + 1)
        if len(cfg["target_classes"]) != 1:
            raise ValueError("the reference renders one target class")
        self.standing = None

    def weight(self, name):
        """``name``'s weight over its spectral norm's one-step estimate."""
        w, eps = self.sd[name + ".weight"], self.cfg["sn_eps"]
        mat = w.reshape(w.shape[0], -1)
        v = _normalize(self.sd[name + ".u0"].reshape(1, -1) @ mat, eps)
        vw = v @ mat.t()
        sigma = (vw * _normalize(vw, eps)).sum()
        return w / sigma

    def _bias(self, name):
        return self.sd.get(name + ".bias")

    def linear(self, x, name, bias=True):
        return F.linear(self.q(x), self.q(self.weight(name)),
                        self._bias(name) if bias else None)

    def conv(self, x, name, bias=True):
        w = self.weight(name)
        return F.conv2d(self.q(x), self.q(w), self._bias(name) if bias else None,
                        padding=w.shape[-1] // 2)

    def bn(self, x, name):
        """Normalised by the stored statistics; in :meth:`stand` by the
        batch's own, which it sums."""
        if self.standing is None:
            mean, var = self.sd[name + ".stored_mean"], self.sd[name + ".stored_var"]
        else:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
            sums = self.standing.setdefault(name, [0.0, 0.0])
            sums[0], sums[1] = sums[0] + mean, sums[1] + var
        return (x - mean[None, :, None, None]) * torch.rsqrt(
            var[None, :, None, None] + self.cfg["bn_eps"])

    def ccbn(self, x, cond, name):
        gain = 1.0 + self.linear(cond, name + ".gain", bias=False)
        bias = self.linear(cond, name + ".bias", bias=False)
        return self.bn(x, name) * gain[:, :, None, None] + bias[:, :, None, None]

    def attention(self, x, name):
        b, c, h, w = x.shape
        theta = self.conv(x, name + ".theta", bias=False).flatten(2)          # (B, C/8, N)
        phi = F.max_pool2d(self.conv(x, name + ".phi", bias=False), 2).flatten(2)
        g = F.max_pool2d(self.conv(x, name + ".g", bias=False), 2).flatten(2)
        logits = self.q(theta).transpose(1, 2) @ self.q(phi)                 # (B, N, M)
        beta = torch.softmax(logits, dim=-1)
        o = (self.q(g) @ self.q(beta).transpose(1, 2)).reshape(b, c // 2, h, w)
        return x + self.sd[name + ".gamma"].reshape(()) * self.conv(o, name + ".o", bias=False)

    def block(self, x, cond, i):
        p = f"blocks.{i}.0."
        h = F.interpolate(F.relu(self.ccbn(x, cond, p + "bn1")), scale_factor=2, mode="nearest")
        h = self.conv(h, p + "conv1")
        h = self.conv(F.relu(self.ccbn(h, cond, p + "bn2")), p + "conv2")
        h = h + self.conv(F.interpolate(x, scale_factor=2, mode="nearest"), p + "conv_sc")
        if f"blocks.{i}.1.theta.weight" in self.sd:
            h = self.attention(h, f"blocks.{i}.1")
        return h

    def forward(self, z):
        """(B, dim_z) codes of the configuration's class -> (B, 3, H, W) in tanh range."""
        y = self.sd["shared.weight"][self.cfg["target_classes"][0]]
        y = y[None].expand(z.shape[0], -1)
        chunks = torch.split(z[:, :self.chunk * (self.n_blocks + 1)], self.chunk, dim=1)
        bw = self.cfg["bottom_width"]
        h = self.linear(chunks[0], "linear").reshape(z.shape[0], -1, bw, bw)
        for i in range(self.n_blocks):
            h = self.block(h, torch.cat([y, chunks[i + 1]], dim=1), i)
        h = self.bn(h, "output_layer.0")
        h = h * self.sd["output_layer.0.gain"][None, :, None, None] \
            + self.sd["output_layer.0.bias"][None, :, None, None]
        return torch.tanh(self.conv(F.relu(h), "output_layer.2"))

    def stand(self, batches):
        """Set every batch norm's stored statistics from forwards of each
        batch of codes in ``batches``."""
        self.standing = {}
        try:
            for z in batches:
                self.forward(z)
            for name, (mean, var) in self.standing.items():
                self.sd[name + ".stored_mean"] = mean / len(batches)
                self.sd[name + ".stored_var"] = var / len(batches)
        finally:
            self.standing = None

    def latent(self, z):
        """The space the paths live in: Z."""
        return z

    def render(self, latent, shift):
        return self.forward(latent + shift)
