"""The contrastive training step.

Counterpart of :mod:`warpedganspace_tpu.train.train_step` (reference
``lib/trainer.py:184-254``): sample (z, path index k, signed magnitude eps) ->
generate G(z) -> warp direction from the support sets -> generate
G(z + eps * direction) -> reconstructor forward -> CE + L1 loss -> backward
through the frozen generator into S and through R -> two Adam updates.

The step runs eagerly and never waits for the host: the batch is drawn on the
device from a generator reseeded from (seed, iteration), the metrics come back
as device tensors, and nothing calls ``.item()``. The unshifted image is
generated under ``torch.no_grad()`` (nothing trainable lies before it); only
the shifted forward keeps a graph, and on a CUDA device BigGAN's attention in
it goes through the forward kernel and, in ``backward()``, the backward kernel
of :mod:`warpedganspace_torch.ops.attn_cuda`.

Optimizers (reference lib/trainer.py:153-156): two independent Adams with
torch's defaults (equal to optax's). Untrained alphas / loggamma have
``requires_grad=False`` and are not handed to the optimizer; BatchNorm running
statistics are buffers, refreshed by the train-mode forward and never by Adam.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from warpedganspace_torch.core.sampling import reseed, sample_batch_directives
from warpedganspace_torch.core.stats import STAT_KEYS
from warpedganspace_torch.models.api import GeneratorBundle, cast_params_bf16
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    batch_size: int
    num_support_sets: int
    min_shift_magnitude: float
    max_shift_magnitude: float
    lambda_cls: float = 1.0
    lambda_reg: float = 0.25
    support_set_lr: float = 1e-4
    reconstructor_lr: float = 1e-4
    z_truncation: float | None = None
    shift_in_w_space: bool = False
    # Generator compute dtype. The generator is frozen, so bfloat16 only
    # affects the gradient path through it: the warp, the reconstructor's
    # heads and the loss stay float32.
    generator_dtype: str = "float32"
    # Reconstructor compute dtype: bfloat16 runs R's convolution trunk in bf16
    # with float32 master parameters, BatchNorm statistics and heads.
    reconstructor_dtype: str = "float32"


def make_optimizers(S: SupportSets, R: Reconstructor, cfg: TrainStepConfig):
    """Two Adams (reference lib/trainer.py:153-156) over what is trainable."""
    opt_s = torch.optim.Adam([p for p in S.parameters() if p.requires_grad],
                             lr=cfg.support_set_lr)
    opt_r = torch.optim.Adam(list(R.parameters()), lr=cfg.reconstructor_lr)
    return opt_s, opt_r


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates in place. ``G`` is the frozen generator in
    the step's compute dtype (a bfloat16 copy, made once, with
    ``generator_dtype='bfloat16'``)."""

    G: GeneratorBundle
    S: SupportSets
    R: Reconstructor
    opt_s: torch.optim.Optimizer
    opt_r: torch.optim.Optimizer
    cfg: TrainStepConfig
    generator: torch.Generator
    seed: int


def init_train_state(G: GeneratorBundle, S: SupportSets, R: Reconstructor,
                     cfg: TrainStepConfig, seed: int = 0) -> TrainState:
    """Move S and R to G's device, put R in train mode and build the optimizers
    and the batch generator there."""
    device = next(G.parameters()).device
    S.to(device)
    R.to(device).train()
    if cfg.generator_dtype == "bfloat16":
        G = cast_params_bf16(G)
    opt_s, opt_r = make_optimizers(S, R, cfg)
    return TrainState(G=G, S=S, R=R, opt_s=opt_s, opt_r=opt_r, cfg=cfg,
                      generator=torch.Generator(device=device), seed=seed)


def loss_fn(S: SupportSets, R: Reconstructor, G: GeneratorBundle, z, idx, mags,
            cfg: TrainStepConfig):
    """total loss and (classification loss, regression loss, accuracy).

    ``G`` is already in ``cfg.generator_dtype``; z (B, d) float32, idx (B,)
    int64, mags (B,) float32.
    """
    g_dtype = torch.bfloat16 if cfg.generator_dtype == "bfloat16" else torch.float32
    r_dtype = torch.bfloat16 if cfg.reconstructor_dtype == "bfloat16" else None

    def for_r(img):
        # R casts its input to r_dtype anyway: skip the float32 round trip
        # when the generator already produced that type.
        return img if r_dtype is not None and img.dtype == r_dtype else img.float()

    z_g = z.to(g_dtype)
    with torch.no_grad():
        img = for_r(G(z_g))
        latent = G.get_w(z_g).float() if cfg.shift_in_w_space else z
    direction = S.direction(latent, idx)
    shift = mags[:, None] * direction
    img_shifted = for_r(G(z_g, shift.to(g_dtype)))
    logits, mag_hat = R(img, img_shifted, dtype=r_dtype)
    cls_loss = F.cross_entropy(logits, idx)
    reg_loss = torch.mean(torch.abs(mag_hat - mags))
    total = cfg.lambda_cls * cls_loss + cfg.lambda_reg * reg_loss
    acc = torch.mean((torch.argmax(logits, dim=-1) == idx).float())
    return total, (cls_loss, reg_loss, acc)


def train_step(state: TrainState, iteration: int, batch=None) -> dict:
    """One iteration, in place. The batch is a pure function of (seed,
    iteration) unless ``batch = (z, idx, mags)`` is given. Returns the four
    metrics of ``STAT_KEYS`` as detached tensors on the device."""
    cfg = state.cfg
    if batch is None:
        reseed(state.generator, state.seed, iteration)
        batch = sample_batch_directives(
            state.generator, cfg.batch_size, state.G.dim_z, cfg.num_support_sets,
            cfg.min_shift_magnitude, cfg.max_shift_magnitude, cfg.z_truncation)
    z, idx, mags = batch
    state.opt_s.zero_grad(set_to_none=True)
    state.opt_r.zero_grad(set_to_none=True)
    total, (cls_loss, reg_loss, acc) = loss_fn(state.S, state.R, state.G, z, idx, mags, cfg)
    total.backward()
    state.opt_s.step()
    state.opt_r.step()
    metrics = {"accuracy": acc, "classification_loss": cls_loss,
               "regression_loss": reg_loss, "total_loss": total}
    return {k: metrics[k].detach() for k in STAT_KEYS}
