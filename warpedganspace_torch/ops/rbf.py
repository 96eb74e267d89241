"""RBF warping-function ops: f(z) and its gradient field, in plain PyTorch.

Counterpart of :mod:`warpedganspace_tpu.ops.rbf`. For support set k with 2N
support vectors sv_j, weights alpha_j and widths gamma_j:

    f_k(z)      = sum_j alpha_j * exp(-gamma_j * ||z - sv_j||^2)
    grad f_k(z) = -2 * sum_j alpha_j * gamma_j * exp(-gamma_j * ||z - sv_j||^2) * (z - sv_j)

and the path direction at z is the L2-normalised gradient.

As in the JAX package, the per-sample set is selected by an integer gather
(its gradient is an index-add), and distances use the expanded form
||z||^2 - 2 z.sv + ||sv||^2 so both contractions are batched matrix products.
These functions are also the plain versions that the CUDA warp kernel
(:mod:`warpedganspace_torch.ops.rbf_cuda`) is held against.
"""
from __future__ import annotations

import torch


def _rbf_terms(support_sets, alphas, gammas, z, idx):
    """Gathered sets and the RBF weights w_j, exponentials e_j and alphas a_j.

    Shapes: support_sets (K, 2N, d), alphas/gammas (K, 2N), z (B, d), idx (B,).
    """
    sv = support_sets.index_select(0, idx)                   # (B, 2N, d)
    a = alphas.index_select(0, idx)                           # (B, 2N)
    g = gammas.index_select(0, idx)                           # (B, 2N)
    z_sq = torch.sum(z * z, dim=-1, keepdim=True)             # (B, 1)
    sv_sq = torch.sum(sv * sv, dim=-1)                        # (B, 2N)
    cross = torch.einsum("bd,bnd->bn", z, sv)                 # (B, 2N)
    e = torch.exp(-g * (z_sq - 2.0 * cross + sv_sq))          # (B, 2N)
    return sv, a * g * e, e, a


def _grad(sv, w, z, normalize: bool):
    grad = -2.0 * torch.sum(w, dim=-1, keepdim=True) * z + 2.0 * torch.einsum("bn,bnd->bd", w, sv)
    if normalize:
        grad = grad / torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    return grad


def warp_grad(support_sets, alphas, gammas, z, idx, normalize: bool = True):
    """Gradient field of the selected warping functions at z, (B, d)."""
    sv, w, _, _ = _rbf_terms(support_sets, alphas, gammas, z, idx)
    return _grad(sv, w, z, normalize)


def warp_value(support_sets, alphas, gammas, z, idx):
    """f(z) = sum_j alpha_j exp(-gamma_j ||z - sv_j||^2), shape (B,)."""
    _, _, e, a = _rbf_terms(support_sets, alphas, gammas, z, idx)
    return torch.sum(a * e, dim=-1)


def warp_value_and_grad(support_sets, alphas, gammas, z, idx, normalize: bool = True):
    """f(z) and grad f(z) from one distance/exp evaluation."""
    sv, w, e, a = _rbf_terms(support_sets, alphas, gammas, z, idx)
    return torch.sum(a * e, dim=-1), _grad(sv, w, z, normalize)


def warp_grad_all_sets(support_sets, alphas, gammas, z, normalize: bool = True):
    """Gradient field of every warping function at per-set points.

    z is (N, K, d): code n evaluated under set k. Returns (N, K, d).
    """
    sv = support_sets                                              # (K, 2N, d)
    z_sq = torch.sum(z * z, dim=-1, keepdim=True)                  # (N, K, 1)
    sv_sq = torch.sum(sv * sv, dim=-1)                             # (K, 2N)
    cross = torch.einsum("nkd,kmd->nkm", z, sv)                    # (N, K, 2N)
    d_sq = z_sq - 2.0 * cross + sv_sq[None]
    w = alphas[None] * gammas[None] * torch.exp(-gammas[None] * d_sq)
    grad = -2.0 * torch.sum(w, dim=-1, keepdim=True) * z + 2.0 * torch.einsum("nkm,kmd->nkd", w, sv)
    if normalize:
        grad = grad / torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    return grad
