"""Processes, ranks and barriers over ``torch.distributed``.

Counterpart of :mod:`warpedganspace_tpu.parallel.mesh` in the idiom of
PyTorch: one process per card, as ``torchrun`` launches them, each with an
explicit device of its own.

- **Training** is data parallel (``cli/train.py --multi-device``): every rank
  holds the same frozen G and the same S and R, draws the global batch and
  takes its contiguous slice of it; after the backward only the S and R
  gradients are all-reduced, and R's BatchNorm reduces its moments across
  ranks (``models/reconstructor.py::BatchNorm``). The JAX package gets the
  same from a GSPMD mesh (``make_mesh``, ``shard_batch``,
  ``replicate_to_global``); those place arrays on a mesh and have no
  counterpart here, where each rank owns its slice.
- **Traversal and attribute evaluation** split their sorted work lists over
  the ranks with :func:`partition_work` and use no collective; a barrier
  stands where the coordinator reads what the others wrote.
- Every file of a tree has one writer, the coordinator (rank 0).

Without a launcher environment and without arguments, nothing is initialised
and every helper answers for one process: rank 0 of 1, barriers are no-ops.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def active() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_coordinator() -> bool:
    """True on the process that owns every write of the experiment tree,
    stdout's progress and TensorBoard: rank 0 (any process without a group)."""
    return rank() == 0


def local_device() -> torch.device:
    """The card of this rank, ``cuda:LOCAL_RANK`` (torchrun's index of the
    process on its host; the global rank without it) modulo the cards this
    process sees (two ranks may share one card), made the current device."""
    index = int(os.environ.get("LOCAL_RANK", rank())) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize_distributed(backend: str | None = None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None) -> bool:
    """Join the process group, once per process; True when one is active.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
    that environment it does nothing and returns False. A second call is a
    no-op, so CLIs chained in one process (sample, train, traverse) join once.
    ``backend`` defaults to NCCL when a card is visible and gloo otherwise;
    gloo also carries CUDA tensors for ``all_reduce`` and ``broadcast``, which
    is how two ranks share one card. A group that was asked for and fails to
    form raises: nothing drops quietly to one process.
    """
    if active():
        return True
    if init_method is None and not all(k in os.environ for k in _LAUNCHER_ENV):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(**kwargs)
    if torch.cuda.is_available():
        local_device()
    return True


def launch_error(multi_device: bool, cuda: bool) -> str | None:
    """What is wrong with this launch of a CLI that takes ``--multi-device``
    (``train``, ``traverse_latent_space``, ``traverse_attribute_space``), or
    None. One rule for the three: several processes need the flag, which
    gives each rank its share of the work; and one process that sees several
    cards is refused it, since the port's route to several cards is one
    process per card (the JAX package's in-process mesh has no counterpart)."""
    if world_size() > 1 and not multi_device:
        return (f"{world_size()} processes need --multi-device: without it each would "
                "do all of the work and all would write the same tree")
    if (multi_device and not active() and cuda and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return (f"--multi-device in one process that sees {torch.cuda.device_count()} "
                "cards: the port runs one process per card; launch with torchrun "
                "--nproc-per-node N -m <the CLI's module> --multi-device ...")
    return None


def _collective_device() -> torch.device:
    """Where a host-side collective's tensor lives: NCCL takes CUDA tensors
    only; gloo takes CPU tensors for every collective."""
    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")


def sync_processes(name: str) -> None:
    """Barrier across the group (a no-op with one process), where a rank is
    about to read what the coordinator wrote, or the coordinator what the
    others wrote. ``name`` says which point it is in an error."""
    if world_size() <= 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"rank {rank()}: barrier {name!r} failed: {e}") from e


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group of each rank's ``x``; its backward sums the
    cotangents over the group too, since every rank's output reads every
    rank's input."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable all-reduce (sum) over the group."""
    return _AllReduceSum.apply(x)


def _leaves(tree):
    if isinstance(tree, dict):
        for key in tree:
            yield str(key)
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _digest(tree) -> bytes:
    """blake2b of every leaf's type, shape and bytes, on the host."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(leaf, np.ndarray):
            a = np.ascontiguousarray(leaf)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.digest()


def assert_identical_across_processes(tree, name: str) -> None:
    """Raise on every rank unless every rank holds the same bytes of ``tree``
    (nested dicts, lists and tuples of tensors, arrays and scalars) as the
    coordinator: a torn checkpoint or sidecar read on one rank must not train
    on silently. Each rank hashes on the host; the coordinator's digest is
    broadcast and the verdict all-reduced, so all ranks fail together. A no-op
    with one process."""
    if world_size() <= 1:
        return
    device = _collective_device()
    local = torch.tensor(list(_digest(tree)), dtype=torch.int64, device=device)
    coord = local.clone()
    dist.broadcast(coord, src=0)
    differs = torch.zeros(world_size(), dtype=torch.int64, device=device)
    differs[rank()] = int(not torch.equal(local, coord))
    dist.all_reduce(differs)
    ranks = [r for r, d in enumerate(differs.tolist()) if d]
    if ranks:
        raise RuntimeError(f"{name} differs from the coordinator's on rank(s) {ranks} "
                           "(a torn checkpoint or sidecar read?): refusing to train "
                           "divergent replicas")


def partition_work(items, num_shards: int = 1, shard_index: int = 0) -> list:
    """``items[shard_index::num_shards]``: the deterministic split of a sorted
    work list (latent codes, hash dirs) between processes that need no
    collective, as the JAX package splits it."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} out of range for {num_shards} shards")
    return list(items)[shard_index::num_shards]
