"""WarpedGANSpace's training step, plain (reference ``lib/trainer.py:184-254``).

From a batch (z, path index k, signed magnitude m): the unshifted image
G(z); the path's unit direction at z's latent (W for StyleGAN2 in W space, z
otherwise) under support set k; the shifted image G(latent + m * direction);
the reconstructor on the channel-stacked pair; cross-entropy of the path
logits plus ``lambda_reg`` times the mean absolute error of the magnitude;
the gradient into the support sets (and log gamma when it is learned) and
into R; two Adams with torch's defaults. G is frozen.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import resnet
from benchmark.reference.quant import exact
from benchmark.reference.warp import unit_gradient

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class Step:
    """The reference step over its own float32 leaves, made from the
    benchmark's state dicts: ``support_sets`` (K, 2N, d), ``loggamma`` when
    learned (``alphas`` when learned), and R's parameters under the
    reference's names."""

    def __init__(self, cfg: dict, G, sd_s: dict, sd_r: dict, q_r=exact, q_warp=exact):
        self.cfg, self.G, self.q_r, self.q_warp = cfg, G, q_r, q_warp
        k, d = cfg["num_support_sets"], cfg["support_vectors_dim"]
        s = {"support_sets": sd_s["SUPPORT_SETS"].reshape(k, -1, d), "alphas": sd_s["ALPHAS"],
             "loggamma": sd_s["LOGGAMMA"]}
        trained = ["support_sets"] + [n for n, flag in (("alphas", "learn_alphas"),
                                                        ("loggamma", "learn_gammas"))
                                      if cfg[flag]]
        self.fixed = {n: t.float().clone() for n, t in s.items() if n not in trained}
        self.leaves = {n: s[n].float().clone().requires_grad_(True) for n in trained}
        self.s_names = list(self.leaves)
        for name, t in sd_r.items():
            if t.is_floating_point() and not name.endswith(("running_mean", "running_var")):
                self.leaves[name] = t.float().clone().requires_grad_(True)
        self.moments = {n: (torch.zeros_like(t), torch.zeros_like(t))
                        for n, t in self.leaves.items()}
        self.t = 0

    def loss(self, z, idx, mags):
        cfg, G, p = self.cfg, self.G, {**self.fixed, **self.leaves}
        with torch.no_grad():
            latent = G.latent(z)
            img = G.render(latent, torch.zeros_like(latent))
        gammas = torch.exp(p["loggamma"]).expand_as(p["alphas"])
        direction = unit_gradient(p["support_sets"][idx], p["alphas"][idx], gammas[idx],
                                  latent[:, None, :], self.q_warp)[:, 0]
        img_shifted = G.render(latent, mags[:, None] * direction)
        logits, mag_hat = resnet.forward(torch.cat([img, img_shifted], 1), p, self.q_r)
        cls = F.cross_entropy(logits, idx)
        reg = torch.mean(torch.abs(mag_hat - mags))
        return cfg["lambda_cls"] * cls + cfg["lambda_reg"] * reg, cls, reg

    def step(self, z, idx, mags) -> tuple[dict, dict]:
        """One step in place: ({total, classification, regression} losses,
        the gradient of every leaf)."""
        total, cls, reg = self.loss(z, idx, mags)
        names = list(self.leaves)
        grads = dict(zip(names, torch.autograd.grad(total, [self.leaves[n] for n in names])))
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            for n in names:
                lr = self.cfg["support_set_lr"] if n in self.s_names else \
                    self.cfg["reconstructor_lr"]
                m, v = self.moments[n]
                m.mul_(b1).add_(grads[n], alpha=1 - b1)
                v.mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)).add_(ADAM_EPS)
                self.leaves[n].addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))
        losses = {"total_loss": float(total.detach()), "classification_loss": float(cls.detach()),
                  "regression_loss": float(reg.detach())}
        return losses, grads
