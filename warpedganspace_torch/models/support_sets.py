"""Support sets: K learnable RBF warping functions over a GAN latent space.

Counterpart of :mod:`warpedganspace_tpu.models.support_sets` (reference
``lib/support_sets.py``):

- ``support_sets`` (K, 2N, d): N dipoles per set, each Gaussian vector
  interleaved with its antipode and rescaled to the set's radius r_k, with the
  radii spanning [1, 4) linearly over the K sets;
- ``alphas`` (K, 2N): the alternating pattern +1, -1, +1, ...;
- ``loggamma`` (K, 1): log(gamma), gamma defaulting to 1/d.

Gammas are always exp(loggamma). Alphas and loggamma take gradients only when
``learn_alphas`` / ``learn_gammas`` are set. On disk the sets keep the
reference ``SupportSets`` state-dict layout: SUPPORT_SETS (K, 2N*d), ALPHAS
(K, 2N), LOGGAMMA (K, 1).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from warpedganspace_torch.ops import rbf


class SupportSets(nn.Module):
    def __init__(self, num_support_sets: int, num_support_dipoles: int,
                 support_vectors_dim: int, learn_alphas: bool = False,
                 learn_gammas: bool = False, gamma: float | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        k, n, d = num_support_sets, num_support_dipoles, support_vectors_dim
        self.num_support_sets = k
        self.num_support_dipoles = n
        self.support_vectors_dim = d
        self.learn_alphas = learn_alphas
        self.learn_gammas = learn_gammas
        self.gamma_init = 1.0 / d if gamma is None else gamma

        sv = torch.randn((k, n, d), generator=generator, dtype=torch.float32)
        sv = torch.stack([sv, -sv], dim=2).reshape(k, 2 * n, d)
        radii = 1.0 + 3.0 / k * torch.arange(k, dtype=torch.float32)    # [1, 4)
        sv = radii[:, None, None] * sv / torch.linalg.vector_norm(sv, dim=-1, keepdim=True)
        alphas = torch.tensor([1.0, -1.0]).repeat(n).expand(k, 2 * n).contiguous()
        loggamma = torch.full((k, 1), math.log(self.gamma_init))

        self.support_sets = nn.Parameter(sv.to(device))
        self.alphas = nn.Parameter(alphas.to(device), requires_grad=learn_alphas)
        self.loggamma = nn.Parameter(loggamma.to(device), requires_grad=learn_gammas)

    def gammas(self) -> torch.Tensor:
        """Per-RBF gamma, (K, 2N): exp(loggamma) broadcast over each set."""
        return torch.exp(self.loggamma).expand(self.num_support_sets, 2 * self.num_support_dipoles)

    def direction(self, z, idx):
        """Unit-norm grad f_idx(z) for (B, d) codes and (B,) set indices."""
        return rbf.warp_grad(self.support_sets, self.alphas, self.gammas(), z, idx)

    def direction_all_sets(self, z):
        """Directions of all K sets at per-set points z (N, K, d)."""
        return rbf.warp_grad_all_sets(self.support_sets, self.alphas, self.gammas(), z)

    def direction_all_sets_fused(self, z, backend: str = "auto"):
        """:meth:`direction_all_sets` through the CUDA warp kernel (CUDA tensors)."""
        from warpedganspace_torch.ops.rbf_cuda import warp_grad_all_sets_fused

        return warp_grad_all_sets_fused(self.support_sets, self.alphas, self.gammas(), z, backend)

    # ------------------------------------------------ reference layout (.pt)
    def to_torch_state_dict(self) -> dict:
        """Reference ``SupportSets.state_dict()`` layout, as CPU tensors."""
        k = self.num_support_sets
        return {
            "SUPPORT_SETS": self.support_sets.detach().reshape(k, -1).cpu().clone(),
            "ALPHAS": self.alphas.detach().cpu().clone(),
            "LOGGAMMA": self.loggamma.detach().cpu().clone(),
        }

    @torch.no_grad()
    def from_torch_state_dict(self, state_dict: dict) -> "SupportSets":
        """Load a reference-layout state dict (tensors or numpy arrays) in place."""
        k, n, d = self.num_support_sets, self.num_support_dipoles, self.support_vectors_dim

        def tensor(x):
            if isinstance(x, torch.Tensor):
                return x.detach().float()
            return torch.as_tensor(np.asarray(x), dtype=torch.float32)

        self.support_sets.copy_(tensor(state_dict["SUPPORT_SETS"]).reshape(k, 2 * n, d))
        self.alphas.copy_(tensor(state_dict["ALPHAS"]))
        self.loggamma.copy_(tensor(state_dict["LOGGAMMA"]))
        return self
