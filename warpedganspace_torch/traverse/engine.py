"""Batched latent path traversal and the render stream.

Counterpart of :mod:`warpedganspace_tpu.traverse.engine`. The traversal is
sequential in t (z_{t+1} = z_t + eps * dir(z_t)) and data-parallel in
everything else, so each step is ONE warp call over the whole
(paths x codes x {+eps, -eps}) grid: the rows of the +eps and -eps directions
share the call. The rows are kept set-major, (K, rows, d), which is the
CUDA kernel's layout (:mod:`warpedganspace_torch.ops.rbf_cuda`), and the sets
are packed once, outside the step loop.

Index and order semantics replicate the reference
(traverse_latent_space.py:333-463):

- the positive direction appends and the negative one *prepends*, so the
  stored sequence is [farthest negative ... center ... farthest positive]
  with the unshifted code in the middle;
- the shift stored at position t is the shift that *produced* code t, and
  rendering evaluates G(code_t + shift_t): rendered frame t is one step ahead
  of stored code t, a reference quirk kept for output parity;
- ``shift_leap`` keeps every leap-th step of each direction.
"""
from __future__ import annotations

import torch

from warpedganspace_torch.ops.rbf_cuda import prepare_warp_sets, warp_grad_all_sets_kn


@torch.no_grad()
def traverse_paths(S, latents: torch.Tensor, eps: float, shift_steps: int,
                   shift_leap: int = 1, backend: str = "auto"):
    """Integrate all K paths for all latent codes.

    Args:
        S:           :class:`~warpedganspace_torch.models.support_sets.SupportSets`,
                     on the device of ``latents``.
        latents:     (N, d) float32 starting codes (z, or w when traversing W).
        eps:         per-step magnitude.
        shift_steps: steps per direction (stored: 2 * (steps // leap) + 1).
        shift_leap:  store every leap-th step.
        backend:     warp backend, as in ``warp_grad_all_sets_kn``.

    Returns:
        codes, shifts: (N, K, T, d) stored codes and the shifts that produced
        them (zero at the center).
    """
    k = S.num_support_sets
    n, d = latents.shape
    latents = latents.float()
    ws = prepare_warp_sets(S.support_sets, S.alphas, S.gammas())

    # Rows [0, n) advance by +eps and rows [n, 2n) by -eps in the same call.
    z = latents[None].expand(k, n, d)
    z = torch.cat([z, z], dim=1).contiguous()                         # (K, 2N, d)
    signed_eps = torch.cat([torch.full((n,), eps), torch.full((n,), -eps)])
    signed_eps = signed_eps.to(latents)[None, :, None]                # (1, 2N, 1)

    codes_t = torch.empty((shift_steps, k, 2 * n, d), dtype=torch.float32,
                          device=latents.device)
    shifts_t = torch.empty_like(codes_t)
    for t in range(shift_steps):
        shift = signed_eps * warp_grad_all_sets_kn(ws, z, backend)
        z = z + shift
        codes_t[t] = z
        shifts_t[t] = shift

    sel = torch.arange(shift_leap - 1, shift_steps, shift_leap, device=latents.device)
    codes_t = codes_t.index_select(0, sel).permute(0, 2, 1, 3)       # (T', 2N, K, d)
    shifts_t = shifts_t.index_select(0, sel).permute(0, 2, 1, 3)
    center = latents[None, :, None, :].expand(1, n, k, d)
    codes = torch.cat([codes_t[:, n:].flip(0), center, codes_t[:, :n]], dim=0)
    shifts = torch.cat([shifts_t[:, n:].flip(0), torch.zeros_like(center), shifts_t[:, :n]],
                       dim=0)
    return codes.permute(1, 2, 0, 3).contiguous(), shifts.permute(1, 2, 0, 3).contiguous()


def _render_u8(G, codes, shifts, latent_is_w: bool):
    """Render one batch and convert each image to uint8 NHWC by its own min/max."""
    img = G(codes, shifts, latent_is_w=latent_is_w).float()
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    x = (img - lo) / torch.clamp(hi - lo, min=1e-12)
    return (255.0 * x).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def iter_rendered_u8(G, codes: torch.Tensor, shifts: torch.Tensor, batch_size: int,
                     latent_is_w: bool = False, dtype: torch.dtype | None = None):
    """Yield (start, uint8 numpy chunk (b, H, W, C)) over a flat (T, d) sequence
    of (code, shift) rows: the traversal CLI's render stream.

    Rows of different paths share batches; the last batch is padded to a full
    one. The per-image min/max conversion (``images.tensor2image``'s adaptive
    mode) runs on the device, so the host receives 1 byte per pixel. On a CUDA
    device each batch is copied to pinned host memory right after its render
    is queued, and yielded only after the next batch's render is queued, so
    one batch of device->host latency hides behind the next render.
    """
    if dtype is not None:
        codes, shifts = codes.to(dtype), shifts.to(dtype)
    t = codes.shape[0]
    prev = None
    for start in range(0, t, batch_size):
        c, s = codes[start:start + batch_size], shifts[start:start + batch_size]
        pad = batch_size - c.shape[0]
        if pad:
            c = torch.cat([c, c.new_zeros((pad, c.shape[1]))])
            s = torch.cat([s, s.new_zeros((pad, s.shape[1]))])
        out = _render_u8(G, c, s, latent_is_w)
        done = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host
        if prev is not None:
            yield _finish(*prev)
        prev = (start, out, done, pad)
    if prev is not None:
        yield _finish(*prev)


def _finish(start, out, done, pad):
    if done is not None:
        done.synchronize()
    img = out.numpy()
    return start, (img[:-pad] if pad else img)
