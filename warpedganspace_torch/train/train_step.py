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
On a CUDA device both are ``capturable`` (their step counts live on the
device), so that a graphed chunk and an eager step run the same arithmetic.

:class:`StepChunk` runs k iterations per call (``--steps-per-call``), the
counterpart of the JAX package's ``lax.scan`` of k steps: on a CUDA device
one replay of a CUDA graph of k steps, on the CPU k eager steps.

Data parallelism (``init_train_state(..., data_parallel=True)``, under a
process group; the JAX package's step on a mesh): every rank draws the global
batch of ``cfg.batch_size`` and takes its contiguous slice, BigGAN's classes
are drawn on the global z and sliced the same way, R's BatchNorm averages its
moments over the group, and after the backward the S and R gradients, one
flat buffer, and the metric row are averaged over the group. G is frozen and
the same on every rank, so nothing of it is reduced. With equal slices the
mean of the ranks' means is the global batch's: the step is the one-process
step on the global batch up to the order of the sums. The collectives run at
world size 1 too, and on a card they are captured in a chunk's CUDA graph
(NCCL's communicator is made by the eager warm-up chunk).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from warpedganspace_torch.core.sampling import reseed, sample_batch_directives
from warpedganspace_torch.core.stats import STAT_KEYS
from warpedganspace_torch.models.api import GeneratorBundle, cast_params_bf16
from warpedganspace_torch.models.reconstructor import Reconstructor, set_sync_moments
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.parallel import mesh


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

    @classmethod
    def from_params(cls, p) -> "TrainStepConfig":
        """The step's configuration from the training CLI's arguments."""
        return cls(batch_size=p.batch_size, num_support_sets=p.num_support_sets,
                   min_shift_magnitude=p.min_shift_magnitude,
                   max_shift_magnitude=p.max_shift_magnitude, lambda_cls=p.lambda_cls,
                   lambda_reg=p.lambda_reg, support_set_lr=p.support_set_lr,
                   reconstructor_lr=p.reconstructor_lr,
                   z_truncation=getattr(p, "z_truncation", None),
                   shift_in_w_space=bool(getattr(p, "shift_in_w_space", False)),
                   generator_dtype=getattr(p, "g_dtype", "float32"),
                   reconstructor_dtype=getattr(p, "r_dtype", "float32"))


def make_optimizers(S: SupportSets, R: Reconstructor, cfg: TrainStepConfig):
    """Two Adams (reference lib/trainer.py:153-156) over what is trainable,
    capturable on a CUDA device."""
    capturable = S.support_sets.is_cuda
    opt_s = torch.optim.Adam([p for p in S.parameters() if p.requires_grad],
                             lr=cfg.support_set_lr, capturable=capturable)
    opt_r = torch.optim.Adam(list(R.parameters()), lr=cfg.reconstructor_lr,
                             capturable=capturable)
    return opt_s, opt_r


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates in place. ``G`` is the frozen generator in
    the step's compute dtype (a bfloat16 copy, made once, with
    ``generator_dtype='bfloat16'``). ``world`` ranks share each batch when
    ``data_parallel``; this one takes slice ``rank``."""

    G: GeneratorBundle
    S: SupportSets
    R: Reconstructor
    opt_s: torch.optim.Optimizer
    opt_r: torch.optim.Optimizer
    cfg: TrainStepConfig
    generator: torch.Generator
    seed: int
    data_parallel: bool = False
    rank: int = 0
    world: int = 1


def init_train_state(G: GeneratorBundle, S: SupportSets, R: Reconstructor,
                     cfg: TrainStepConfig, seed: int = 0,
                     data_parallel: bool = False) -> TrainState:
    """Move S and R to G's device, put R in train mode and build the optimizers
    and the batch generator there. ``data_parallel`` needs an active process
    group whose size divides ``cfg.batch_size``."""
    device = next(G.parameters()).device
    S.to(device)
    R.to(device).train()
    rank, world = 0, 1
    if data_parallel:
        if not mesh.active():
            raise RuntimeError("data-parallel training needs a process group "
                               "(parallel.initialize_distributed)")
        rank, world = mesh.rank(), mesh.world_size()
        if cfg.batch_size % world:
            raise ValueError(f"the batch size {cfg.batch_size} does not split over "
                             f"{world} ranks")
        set_sync_moments(R)
    if cfg.generator_dtype == "bfloat16":
        G = cast_params_bf16(G)
    opt_s, opt_r = make_optimizers(S, R, cfg)
    return TrainState(G=G, S=S, R=R, opt_s=opt_s, opt_r=opt_r, cfg=cfg,
                      generator=torch.Generator(device=device), seed=seed,
                      data_parallel=data_parallel, rank=rank, world=world)


def loss_fn(S: SupportSets, R: Reconstructor, G: GeneratorBundle, z, idx, mags,
            cfg: TrainStepConfig, y=None):
    """total loss and (classification loss, regression loss, accuracy).

    ``G`` is already in ``cfg.generator_dtype``; z (B, d) float32, idx (B,)
    int64, mags (B,) float32; ``y`` BigGAN's classes of the rows, drawn by G
    from z when not given.
    """
    g_dtype = torch.bfloat16 if cfg.generator_dtype == "bfloat16" else torch.float32
    r_dtype = torch.bfloat16 if cfg.reconstructor_dtype == "bfloat16" else None

    def for_r(img):
        # R casts its input to r_dtype anyway: skip the float32 round trip
        # when the generator already produced that type.
        return img if r_dtype is not None and img.dtype == r_dtype else img.float()

    z_g = z.to(g_dtype)
    with torch.no_grad():
        img = for_r(G(z_g, y=y))
        latent = G.get_w(z_g).float() if cfg.shift_in_w_space else z
    direction = S.direction(latent, idx)
    shift = mags[:, None] * direction
    img_shifted = for_r(G(z_g, shift.to(g_dtype), y=y))
    logits, mag_hat = R(img, img_shifted, dtype=r_dtype)
    cls_loss = F.cross_entropy(logits, idx)
    reg_loss = torch.mean(torch.abs(mag_hat - mags))
    total = cfg.lambda_cls * cls_loss + cfg.lambda_reg * reg_loss
    acc = torch.mean((torch.argmax(logits, dim=-1) == idx).float())
    return total, (cls_loss, reg_loss, acc)


def sample_batch(state: TrainState, iteration: int):
    """(z, idx, mags) of ``iteration``, the global batch: a pure function of
    (seed, iteration)."""
    cfg = state.cfg
    reseed(state.generator, state.seed, iteration)
    return sample_batch_directives(
        state.generator, cfg.batch_size, state.G.dim_z, cfg.num_support_sets,
        cfg.min_shift_magnitude, cfg.max_shift_magnitude, cfg.z_truncation)


def metric_row(metrics: dict) -> torch.Tensor:
    """A step's metrics as one (4,) tensor in the order of ``STAT_KEYS``."""
    return torch.stack([metrics[k] for k in STAT_KEYS])


def _rank_slice(state: TrainState, z, idx, mags):
    """This rank's rows of the global batch, and BigGAN's classes of them drawn
    on the global z (a draw on the slice alone would read other bits)."""
    b = state.cfg.batch_size // state.world
    rows = slice(state.rank * b, (state.rank + 1) * b)
    draw = getattr(state.G.net, "mixed_classes", None)
    y = None
    if draw is not None:
        g_dtype = torch.bfloat16 if state.cfg.generator_dtype == "bfloat16" else torch.float32
        y = draw(z.to(g_dtype))[rows]
    return z[rows], idx[rows], mags[rows], y


def _all_reduce_mean_(tensors, world: int) -> None:
    """Average ``tensors`` over the group in place, through one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def train_step(state: TrainState, iteration: int, batch=None) -> dict:
    """One iteration, in place. The (global) batch is a pure function of
    (seed, iteration) unless ``batch = (z, idx, mags)`` is given. Returns the
    four metrics of ``STAT_KEYS`` as detached tensors on the device, those of
    the global batch under data parallelism."""
    cfg = state.cfg
    z, idx, mags = sample_batch(state, iteration) if batch is None else batch
    y = None
    if state.data_parallel:
        z, idx, mags, y = _rank_slice(state, z, idx, mags)
    state.opt_s.zero_grad(set_to_none=True)
    state.opt_r.zero_grad(set_to_none=True)
    total, (cls_loss, reg_loss, acc) = loss_fn(state.S, state.R, state.G, z, idx, mags, cfg,
                                               y=y)
    total.backward()
    if state.data_parallel:
        _all_reduce_mean_([p.grad for opt in (state.opt_s, state.opt_r)
                           for group in opt.param_groups for p in group["params"]], state.world)
    state.opt_s.step()
    state.opt_r.step()
    metrics = {"accuracy": acc, "classification_loss": cls_loss,
               "regression_loss": reg_loss, "total_loss": total}
    out = {k: metrics[k].detach() for k in STAT_KEYS}
    if state.data_parallel:
        row = metric_row(out)
        dist.all_reduce(row)
        out = dict(zip(STAT_KEYS, (row / state.world).unbind()))
    return out


class StepChunk:
    """k consecutive iterations per call, in place: the metrics of
    iterations [it, it + k) as one (k, 4) device tensor (rows in the order of
    ``STAT_KEYS``). Exact: each iteration's batch is drawn as
    :func:`train_step` draws it, after ``reseed`` to (seed, iteration), so a
    chunk does what k calls of ``train_step`` do.

    On the CPU a call is k eager steps. On a CUDA device the k batches are
    drawn eagerly, outside any graph (sampling reseeds a generator on the
    host), and copied into static buffers. The first call runs the k steps
    eagerly on a side stream: the warm-up that capture needs (cuDNN's plans,
    the Adams' moments, the kernel libraries), and a real chunk, so nothing
    advances beyond the real iterations. The second call captures the k steps
    (both generator forwards, the warp, R, the loss, the backward and both
    Adams, which are ``capturable``) as one CUDA graph on that stream; every
    call from then on replays it. A capture that fails raises: nothing falls
    back to eager steps.

    The graph reads the state's tensors in place, so the parameters, the
    Adams' moments and R's statistics must not be replaced between calls
    (``Trainer`` loads a checkpoint only before its first step). The kernel
    wrappers' launch counters count a capture, not its replays.
    """

    def __init__(self, state: TrainState, k: int):
        if k < 1:
            raise ValueError(f"a chunk has at least one step, got k={k}")
        self.state, self.k = state, k
        self.cuda = state.S.support_sets.is_cuda
        self.static = None        # k (z, idx, mags) buffers the graph reads
        self.stream = None
        self.graph = None
        self.rows = None          # the graph's output

    def _steps(self, batches) -> torch.Tensor:
        return torch.stack([metric_row(train_step(self.state, 0, batch=b)) for b in batches])

    def __call__(self, iteration: int) -> torch.Tensor:
        batches = [sample_batch(self.state, it) for it in range(iteration, iteration + self.k)]
        if not self.cuda:
            return self._steps(batches)
        if self.static is None:
            self.static = [tuple(t.clone() for t in b) for b in batches]
            self.stream = torch.cuda.Stream(device=self.state.S.support_sets.device)
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                rows = self._steps(self.static)
            torch.cuda.current_stream().wait_stream(self.stream)
            return rows
        for dst, src in zip(self.static, batches):
            for d, t in zip(dst, src):
                d.copy_(t)
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            self.stream.wait_stream(torch.cuda.current_stream())
            try:
                with torch.cuda.graph(graph, stream=self.stream):
                    self.rows = self._steps(self.static)
            except RuntimeError as e:
                raise RuntimeError(f"--steps-per-call {self.k}: the training step could not "
                                   f"be captured as a CUDA graph: {e}") from e
            self.graph = graph
        self.graph.replay()
        return self.rows.clone()
