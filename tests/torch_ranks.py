"""Ranks of a ``torch.distributed`` group for the port's multi-process tests.

:func:`spawn` runs ``world`` processes of this file, each with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), so the port's ``initialize_distributed`` forms the group as
it does under ``torchrun``; each process runs one scenario of ``SCENARIOS``
in a work directory and saves what it saw there as ``<scenario>.<rank>.pt``.
Every process is awaited with a timeout of its own and killed on expiry, so a
hang fails the test instead of eating the suite's time.

The module imports no JAX: the card tests use it on a machine without JAX.
"""
from __future__ import annotations

import os
import os.path as osp
import socket
import subprocess
import sys

import torch
import torch.distributed

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, workdir: str, world: int = 2, timeout: float = 300,
          extra_env: dict | None = None) -> list:
    """Run ``scenario`` on ``world`` ranks; returns each rank's output and its
    saved result. Fails with the output of any rank that did not exit 0."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, osp.abspath(__file__), scenario, str(workdir)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {scenario!r} exited {p.returncode}:\n{out}"
    return [(out, torch.load(osp.join(workdir, f"{scenario}.{r}.pt"), weights_only=False))
            for r, out in enumerate(outs)]


class AllReduceRecorder:
    """Records the shape of every tensor handed to ``torch.distributed.all_reduce``."""

    def __init__(self):
        self.shapes = []
        self._real = None

    def __enter__(self):
        import torch.distributed as dist

        self._real = dist.all_reduce

        def recording(tensor, *args, **kwargs):
            self.shapes.append(tuple(tensor.shape))
            return self._real(tensor, *args, **kwargs)

        dist.all_reduce = recording
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._real


# ------------------------------------------------------------------ scenarios
def _bn_case(inputs: dict, device, sync: bool) -> dict:
    """One train-mode BatchNorm forward and backward on this rank's rows."""
    from warpedganspace_torch.models.reconstructor import BatchNorm
    from warpedganspace_torch.parallel import mesh

    out = {}
    r, w = mesh.rank(), mesh.world_size()
    for name in ("f32", "bf16"):
        x = inputs["x_" + name]
        rows = slice(r * x.shape[0] // w, (r + 1) * x.shape[0] // w)
        bn = BatchNorm(x.shape[1])
        bn.load_state_dict(inputs["state"])
        bn.to(device).train()
        bn.sync_moments = sync
        xl = x[rows].to(device).requires_grad_(True)
        y = bn(xl)
        (y.float() * inputs["gy"][rows].to(device)).sum().backward()
        out[name] = {"y": y.detach().float().cpu(), "x_grad": xl.grad.float().cpu(),
                     "weight_grad": bn.weight.grad.cpu(), "bias_grad": bn.bias.grad.cpu(),
                     "running_mean": bn.running_mean.cpu(),
                     "running_var": bn.running_var.cpu()}
    return out


def _step_case(inputs: dict, record: bool = False) -> dict:
    """Data-parallel steps from the state and global batches in ``inputs``."""
    import torch.distributed as dist

    from warpedganspace_torch.train.train_step import (TrainStepConfig, init_train_state,
                                                       train_step)

    state = init_train_state(inputs["G"], inputs["S"], inputs["R"],
                             TrainStepConfig(**inputs["cfg"]), data_parallel=True)
    steps = []
    for i, batch in enumerate(inputs["batches"]):
        recorder = AllReduceRecorder()
        if record and i == 0:
            with recorder:
                metrics = train_step(state, i + 1, batch=batch)
        else:
            metrics = train_step(state, i + 1, batch=batch)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": {n: p.grad.clone() for m in (state.S, state.R)
                                for n, p in m.named_parameters() if p.grad is not None},
                      "S": {k: v.clone() for k, v in state.S.state_dict().items()},
                      "R": {k: v.clone() for k, v in state.R.state_dict().items()},
                      "all_reduce": recorder.shapes})
    assert dist.get_world_size() == state.world
    return {"steps": steps}


def scenario_units(workdir: str) -> dict:
    """SyncBN (synchronised and local), data-parallel steps with a recorder on
    ``all_reduce``, BigGAN's two-class draw, a step of StyleGAN2 in W space
    with the ResNet reconstructor, and the identity check."""
    from warpedganspace_torch.models import biggan
    from warpedganspace_torch.parallel import mesh

    mesh.initialize_distributed()
    torch.set_num_threads(1)
    inputs = torch.load(osp.join(workdir, "units_in.pt"), weights_only=False)
    cpu = torch.device("cpu")
    out = {"bn": _bn_case(inputs["bn"], cpu, sync=True),
           "bn_local": _bn_case(inputs["bn"], cpu, sync=False),
           "sngan": _step_case(inputs["sngan"], record=True)}

    seen = []
    real_apply = biggan.BigGANGenerator.apply

    def apply(self, z, shift=None, y=None, latent_is_w=False):
        seen.append(None if y is None else y.clone())
        return real_apply(self, z, shift, y=y, latent_is_w=latent_is_w)

    biggan.BigGANGenerator.apply = apply
    try:
        out["biggan"] = _step_case(inputs["biggan"])
    finally:
        biggan.BigGANGenerator.apply = real_apply
    out["biggan"]["classes"] = seen
    out["stylegan2"] = _step_case(inputs["stylegan2"])

    tree = {"a": torch.arange(6.0), "b": [torch.ones(2, 2, dtype=torch.bfloat16), 3]}
    mesh.assert_identical_across_processes(tree, "a tree")
    if mesh.rank() == 1:
        tree["b"][0][1, 1] = 2.0
    try:
        mesh.assert_identical_across_processes(tree, "a tree")
        out["differs"] = None
    except RuntimeError as e:
        out["differs"] = str(e)
    return out


def scenario_pipeline(workdir: str) -> dict:
    """``sample_gan`` -> ``train --multi-device`` -> ``traverse_latent_space
    --multi-device`` with the arguments saved in ``pipeline_in.pt``, in
    ``workdir/multi``; every rank counts its generator calls and the GIF
    collations it made."""
    from warpedganspace_torch.cli import sample_gan, train, traverse_latent_space
    from warpedganspace_torch.models.api import GeneratorBundle
    from warpedganspace_torch.parallel import mesh

    torch.set_num_threads(1)
    argv = torch.load(osp.join(workdir, "pipeline_in.pt"), weights_only=False)
    root = osp.join(workdir, "multi")
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    calls = []
    real_forward = GeneratorBundle.forward

    def forward(self, z, *args, **kwargs):
        calls.append(z.shape[0])
        return real_forward(self, z, *args, **kwargs)

    gifs = []
    real_collate = traverse_latent_space.collate_traversal_gifs

    def collate(*args, **kwargs):
        gifs.append(args[0])
        return real_collate(*args, **kwargs)

    GeneratorBundle.forward = forward
    traverse_latent_space.collate_traversal_gifs = collate
    try:
        sample_gan.main(argv["sample"])
        sampled = len(calls)
        train.main(argv["train"])
        trained = len(calls) - sampled
        traverse_latent_space.main(argv["traverse"])
    finally:
        GeneratorBundle.forward = real_forward
        traverse_latent_space.collate_traversal_gifs = real_collate
    return {"rank": mesh.rank(), "world": mesh.world_size(), "sampled": sampled,
            "train_rows": calls[sampled:sampled + trained],
            "traversed": len(calls) - sampled - trained, "gif_collations": len(gifs)}


def predictors(sds: dict) -> dict:
    """The six predictor families of ``load_predictors`` from state dicts."""
    from warpedganspace_torch.evalzoo.arcface import IDComparator
    from warpedganspace_torch.evalzoo.celeba import celeba_attr_predictor
    from warpedganspace_torch.evalzoo.fairface import FairFace
    from warpedganspace_torch.evalzoo.fanau import AUdetector
    from warpedganspace_torch.evalzoo.hopenet import Hopenet
    from warpedganspace_torch.evalzoo.load import CONFIGS_DIR
    from warpedganspace_torch.evalzoo.sfd import SFDDetector

    return {"sfd": SFDDetector.from_state_dict(sds["sfd"]),
            "id": IDComparator.from_state_dict(sds["arcface"], prefix=""),
            "fairface": FairFace.from_state_dict(sds["fairface"]),
            "hopenet": Hopenet.from_state_dict(sds["hopenet"]),
            "au": AUdetector.from_state_dict(sds["au_detector"]),
            "celeba": celeba_attr_predictor(osp.join(CONFIGS_DIR, "attributes_5.json"),
                                            sds["celeba"])}


def scenario_attribute(workdir: str) -> dict:
    """``traverse_attribute_space --multi-device`` on the tree in
    ``workdir/multi``, its predictors built from ``attribute_in.pt``; every
    rank lists the ``(hash, path)`` pairs it evaluated."""
    from warpedganspace_torch.cli import traverse_attribute_space as cli
    from warpedganspace_torch.parallel import mesh

    torch.set_num_threads(1)
    inputs = torch.load(osp.join(workdir, "attribute_in.pt"), weights_only=False)
    evaluated = []
    real_paths = cli.evaluate_paths

    def evaluate_paths(pairs, *args, **kwargs):
        pairs = list(pairs)
        evaluated.extend((osp.basename(h_dir), d) for h_dir, d in pairs)
        return real_paths(pairs, *args, **kwargs)

    cli.load_predictors = lambda device: predictors(inputs["state_dicts"])
    cli.evaluate_paths = evaluate_paths
    os.chdir(osp.join(workdir, "multi"))
    cli.main(inputs["argv"])
    return {"rank": mesh.rank(), "evaluated": evaluated}


def scenario_traverse(workdir: str) -> dict:
    """``traverse_latent_space --multi-device`` in ``workdir/multi`` with the
    generator, arguments and (optionally) backend of ``traverse_in.pt``;
    every rank lists the render batches it rendered, by code, the
    generator's calls and the warp's and StyleGAN2 tail's kernel launches."""
    from warpedganspace_torch.cli import traverse_latent_space as cli
    from warpedganspace_torch.ops import rbf_cuda, sg2_tail_cuda
    from warpedganspace_torch.parallel import mesh

    torch.set_num_threads(1)
    inputs = torch.load(osp.join(workdir, "traverse_in.pt"), weights_only=False)
    if inputs.get("backend"):          # gloo: two ranks that share one card
        mesh.initialize_distributed(backend=inputs["backend"])
    G, rendered, calls = inputs["G"], [], []
    real_iter, real_forward = cli.iter_rendered_u8, type(G).forward

    def iter_rendered_u8(*args, batches=None, **kwargs):
        rendered.append((batches.start, batches.stop))
        return real_iter(*args, batches=batches, **kwargs)

    def forward(self, z, *args, **kwargs):
        calls.append(z.shape[0])
        return real_forward(self, z, *args, **kwargs)

    cli.build_gan = lambda **kw: G.to(kw["device"])
    cli.iter_rendered_u8 = iter_rendered_u8
    type(G).forward = forward
    os.chdir(osp.join(workdir, "multi"))
    try:
        cli.main(inputs["argv"])
    finally:
        type(G).forward = real_forward
    return {"rank": mesh.rank(), "rendered": rendered, "calls": calls,
            "launches": {"rbf_warp": rbf_cuda.launches, "sg2_tail": sg2_tail_cuda.launches}}


def scenario_bn_cuda(workdir: str) -> dict:
    """SyncBN as ``scenario_units`` runs it, on CUDA tensors of one card that
    every rank shares, over gloo (NCCL refuses two ranks on one card)."""
    from warpedganspace_torch.parallel import mesh

    mesh.initialize_distributed(backend="gloo")
    inputs = torch.load(osp.join(workdir, "bn_cuda_in.pt"), weights_only=False)
    return {"bn": _bn_case(inputs, mesh.local_device(), sync=True)}


def scenario_graph_nccl(workdir: str) -> dict:
    """One NCCL rank: a data-parallel state trained by graphed chunks
    (``StepChunk``; the eager warm-up, the capture, replays) and the same
    state trained by eager steps, twice, with the deterministic algorithms.
    Saves what ``tests/test_torch_train_graph_cuda.py`` compares."""
    from test_torch_train_graph_cuda import K, DIPOLES, _generator, _snapshot
    from warpedganspace_torch.models.reconstructor import Reconstructor
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.parallel import mesh
    from warpedganspace_torch.train.train_step import (StepChunk, TrainStepConfig,
                                                       init_train_state, metric_row,
                                                       train_step)

    mesh.initialize_distributed()
    assert torch.distributed.get_backend() == "nccl"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    family, k, iters = torch.load(osp.join(workdir, "graph_nccl_in.pt"))
    device = mesh.local_device()

    def state():
        G, rtype, ch, kw = _generator(family, device)
        init = torch.Generator().manual_seed(13)
        S = SupportSets(K, DIPOLES, G.dim_z, learn_gammas=True, generator=init)
        R = Reconstructor(rtype, dim=K, channels=ch, generator=init)
        cfg = TrainStepConfig(batch_size=8, num_support_sets=K, min_shift_magnitude=0.1,
                              max_shift_magnitude=0.2, **kw)
        return init_train_state(G, S, R, cfg, seed=5, data_parallel=True)

    graphed = state()
    chunk = StepChunk(graphed, k)
    rows = torch.cat([chunk(it) for it in range(1, iters + 1, k)])
    out = {"graphed": (_snapshot(graphed), rows.cpu()), "captured": chunk.graph is not None}
    for name in ("eager", "again"):
        st = state()
        rows = torch.stack([metric_row(train_step(st, it)) for it in range(1, iters + 1)])
        out[name] = (_snapshot(st), rows.cpu())
    return out


SCENARIOS = {"units": scenario_units, "pipeline": scenario_pipeline,
             "attribute": scenario_attribute, "traverse": scenario_traverse,
             "bn_cuda": scenario_bn_cuda,
             "graph_nccl": scenario_graph_nccl}


def main(argv=None) -> None:
    scenario, workdir = (argv or sys.argv[1:])[:2]
    workdir = osp.abspath(workdir)
    result = SCENARIOS[scenario](workdir)
    from warpedganspace_torch.parallel import mesh

    rank = mesh.rank()
    torch.save(result, osp.join(workdir, f"{scenario}.{rank}.pt"))
    mesh.sync_processes("scenario-saved")
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} DONE")


if __name__ == "__main__":
    main()
