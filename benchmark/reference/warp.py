"""WarpedGANSpace's RBF warp and the traversal's path integration, plain.

For support set k with vectors sv_j, weights alpha_j and widths gamma_j,
f_k(z) = sum_j alpha_j exp(-gamma_j ||z - sv_j||^2), and a path steps along
the unit gradient: z_{t+1} = z_t + eps * grad f_k(z_t) / ||grad f_k(z_t)||
(reference lib/support_sets.py, traverse_latent_space.py:333-463).
"""
from __future__ import annotations

import torch

from benchmark.reference.quant import exact


def unit_gradient(sv, alphas, gammas, z, q=exact):
    """Unit grad f_k at per-set points: sv (K, 2N, d), alphas and gammas
    (K, 2N), z (K, R, d) -> (K, R, d)."""
    zq, svq = q(z), q(sv)
    d_sq = (z * z).sum(-1, keepdim=True) - 2.0 * zq @ svq.transpose(1, 2) \
        + (sv * sv).sum(-1)[:, None, :]
    w = alphas[:, None, :] * gammas[:, None, :] * torch.exp(-gammas[:, None, :] * d_sq)
    grad = 2.0 * (q(w) @ svq) - 2.0 * w.sum(-1, keepdim=True) * z
    return grad / torch.linalg.vector_norm(grad, dim=-1, keepdim=True)


def integrate(sets: dict, latents: torch.Tensor, eps: float, steps: int,
              dtype=torch.float64, q=exact):
    """Every path of every code: (codes, shifts), each (N, K, 2 steps + 1, d)
    in float32, ordered as the traversal stores them: the farthest negative
    step first, the unshifted code in the middle; the shift at t is the one
    that produced code t (zero at the centre)."""
    k = sets["SUPPORT_SETS"].shape[0]
    n, d = latents.shape
    sv = sets["SUPPORT_SETS"].to(dtype).reshape(k, -1, d)
    alphas = sets["ALPHAS"].to(dtype)
    gammas = torch.exp(sets["LOGGAMMA"].to(dtype)).expand_as(alphas)
    z = latents.to(dtype)[None].expand(k, n, d)
    z = torch.cat([z, z], dim=1)
    sign = torch.cat([torch.ones(n), -torch.ones(n)]).to(z)[None, :, None]
    codes, shifts = [], []
    for _ in range(steps):
        shift = eps * sign * unit_gradient(sv, alphas, gammas, z, q)
        z = z + shift
        codes.append(z)
        shifts.append(shift)
    codes = torch.stack(codes, 2)                             # (K, 2N, steps, d)
    shifts = torch.stack(shifts, 2)
    centre = latents.to(dtype)[None, :, None, :].expand(k, n, 1, d)
    c = torch.cat([codes[:, n:].flip(2), centre, codes[:, :n]], 2)
    s = torch.cat([shifts[:, n:].flip(2), torch.zeros_like(centre), shifts[:, :n]], 2)
    return c.permute(1, 0, 2, 3).float(), s.permute(1, 0, 2, 3).float()
