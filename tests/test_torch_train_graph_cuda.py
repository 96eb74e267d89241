"""Training on the card: the CUDA graph of ``--steps-per-call`` against eager
steps, and the tail kernels on the gradient path against the plain tails.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph_cuda.py -m gpu

Generators are the port's own with seeded random weights (BigGAN's attention
gammas opened, ProgGAN's WScale terms and StyleGAN2's noise weights and biases
moved off their initial values, where a dropped term would not show).
"""
import json
import os
import os.path as osp

import pytest
import torch

from warpedganspace_torch.models.api import GeneratorBundle
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.train.train_step import (StepChunk, TrainStepConfig, init_train_state,
                                                   metric_row, train_step)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

K, DIPOLES = 8, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # f32 comparisons: keep the convolutions out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic(monkeypatch):
    """cuDNN's and PyTorch's deterministic algorithms (the gather warp's
    index-add backward then sums without atomics): with them an eager
    training step repeats its own bits on the card."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _perturb(gen, seed):
    """Move the convolutions' biases, WScale scales, noise weights and
    attention gammas off their initial values (not the mapping's or the
    modulations' linears, whose scale sets the styles)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if "mapping" in name or "modulation" in name:
                continue
            if name.endswith("gamma"):
                p.fill_(0.7)
            elif name.endswith("noise_weight"):
                p.fill_(0.3)
            elif name.endswith(".scale") and p.numel() == 1:
                p.copy_(0.7 + 0.7 * torch.rand(1, generator=g))
            elif name.endswith("bias") and p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return gen


def _generator(family, device):
    """(bundle, reconstructor type, image channels, TrainStepConfig overrides)."""
    gen = torch.Generator().manual_seed(11)
    if family == "SNGAN_MNIST":
        from warpedganspace_torch.models.sngan import SNGANGenerator

        net, rtype, ch, kw = SNGANGenerator.from_gan_type(family, generator=gen), "LeNet", 1, {}
    elif family == "BigGAN":
        from warpedganspace_torch.models.biggan import BigGANGenerator

        net = BigGANGenerator(resolution=32, ch=16, shared_dim=16, n_classes=240,
                              attention="32", generator=gen)
        rtype, ch, kw = "ResNet", 3, {}
    elif family == "StyleGAN2":
        from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

        net = StyleGAN2Generator(resolution=256, n_mlp=2, channel_multiplier=1,
                                 shift_in_w_space=True, generator=gen)
        rtype, ch, kw = "ResNet", 3, dict(shift_in_w_space=True, z_truncation=0.7)
    else:
        from warpedganspace_torch.models.proggan import ProgGANGenerator

        net = ProgGANGenerator(dim_z=128, channels=[128, 128, 128, 128, 128, 64, 64, 32, 32,
                                                    16, 16], generator=gen)
        rtype, ch, kw = "ResNet", 3, {}
    net = _perturb(net, 12).requires_grad_(False).eval().to(device)
    bundle = GeneratorBundle(family, net, dim_z=128 if family != "StyleGAN2" else 512,
                             resolution=net.resolution,
                             shift_in_w_space=family == "StyleGAN2")
    return bundle, rtype, ch, kw


def _state(family, device, batch_size=8, **cfg_kw):
    G, rtype, ch, kw = _generator(family, device)
    init = torch.Generator().manual_seed(13)
    S = SupportSets(K, DIPOLES, G.dim_z, learn_gammas=True, generator=init)
    R = Reconstructor(rtype, dim=K, channels=ch, generator=init)
    cfg = TrainStepConfig(batch_size=batch_size, num_support_sets=K, min_shift_magnitude=0.1,
                          max_shift_magnitude=0.2, **dict(kw, **cfg_kw))
    return init_train_state(G, S, R, cfg, seed=5)


def _snapshot(state):
    """Every tensor a step updates: S, R (with its statistics) and both Adams."""
    out = {f"S.{n}": t.detach().clone() for n, t in state.S.named_parameters()}
    out.update({f"R.{n}": t.detach().clone() for n, t in state.R.state_dict().items()})
    for name, opt in (("opt_s", state.opt_s), ("opt_r", state.opt_r)):
        params = [p for group in opt.param_groups for p in group["params"]]
        for i, p in enumerate(params):
            for key, t in opt.state[p].items():
                out[f"{name}.{i}.{key}"] = t.detach().clone()
    return out


def _bit_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _eager(family, device, iters):
    state = _state(family, device)
    rows = torch.stack([metric_row(train_step(state, it)) for it in range(1, iters + 1)])
    return _snapshot(state), rows


def _norm(t):
    return float(torch.linalg.vector_norm(t.float()))


# Should the eager step not repeat its own bits even with the deterministic
# algorithms (sums in a run-dependent order, which the steps after amplify), a
# graphed run is held to the eager run as a second eager run is: it departs
# from it no more than SPREAD times as far as the second eager run does, or
# 1 % of the distance the tensor moved from its start (its norm where it has
# no start: the Adams' moments).
SPREAD = 5.0


def _close_as_eager(got, want, again, start=None):
    moved = _norm(want - start) if start is not None else _norm(want)
    return _norm(got - want) <= max(SPREAD * _norm(again - want), 1e-2 * moved) + 1e-12


# Kernel launches a training step makes: BigGAN's attention forward twice and
# its backward once, StyleGAN2's one tail section (256^2, channel multiplier 1)
# and the tiny ProgGAN chain's three in each of two generator forwards.
STEP_LAUNCHES = {"SNGAN_MNIST": {}, "BigGAN": {"sa_attention": 2, "sa_attention_bwd": 1},
                 "StyleGAN2": {"sg2_tail": 2}, "ProgGAN": {"proggan_tail": 6}}


def _launches():
    from warpedganspace_torch.ops import attn_cuda, proggan_tail_cuda, sg2_tail_cuda

    return {"sa_attention": attn_cuda.launches, "sa_attention_bwd": attn_cuda.bwd_launches,
            "sg2_tail": sg2_tail_cuda.launches, "proggan_tail": proggan_tail_cuda.launches}


@pytest.mark.parametrize("family", ["SNGAN_MNIST", "BigGAN", "StyleGAN2", "ProgGAN"])
def test_graphed_chunks_match_eager_steps(cuda, deterministic, family):
    """Three chunks of 3 (the eager warm-up, the capture and its first replay,
    a second replay) against 9 eager steps from the same state: S, R, both
    Adams' moments and step counts, and the metrics. Bit-equal when the eager
    step repeats its own bits (it does with the deterministic algorithms);
    otherwise each tensor and the metrics as close to the eager run as a
    second eager run is (``SPREAD``), the step counts equal. The kernels launch inside the graph; their wrappers count the
    warm-up's and the capture's launches, not the replays'."""
    k, iters = 3, 9
    state = _state(family, cuda)
    start = _snapshot(state)
    chunk = StepChunk(state, k)
    before = _launches()
    rows = torch.cat([chunk(it) for it in range(1, iters + 1, k)])
    assert chunk.graph is not None
    counted = {name: n - before[name] for name, n in _launches().items()}
    assert counted == {name: 2 * k * STEP_LAUNCHES[family].get(name, 0) for name in counted}
    got = _snapshot(state)
    want, want_rows = _eager(family, cuda, iters)
    again, again_rows = _eager(family, cuda, iters)
    assert rows.shape == (iters, 4) and bool(torch.isfinite(rows).all())
    if _bit_equal(want, again):
        assert _bit_equal(got, want)
        assert torch.equal(rows, want_rows)
        return
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.endswith(".step") or w.dtype == torch.long:
            assert torch.equal(got[name], w), name
        else:
            assert _close_as_eager(got[name], w, again[name], start.get(name)), name
    assert float((rows - want_rows).abs().max()) <= max(
        SPREAD * float((again_rows - want_rows).abs().max()), 1e-3)


def test_cli_resume_in_the_middle_of_a_chunk(cuda, deterministic, tmp_path, monkeypatch):
    """``cli.train`` on SNGAN-MNIST at full width with ``--steps-per-call 3``:
    a run to 4 (a chunk, then the lone iteration 4, so the run ends inside
    the second chunk), then a resume at the checkpoint of iteration 3: the
    lone re-run of 3, the chunks 4-6 (the eager warm-up of this process) and
    7-9 (a capture and its replay), the lone 10. Against the same two runs
    with one step a call, held as the test above holds a graph to eager
    steps: the statistics windows and the support sets."""
    from warpedganspace_torch.cli import train as t_train

    monkeypatch.setenv("WGS_ALLOW_RANDOM_G", "1")
    flags = ["--gan-type", "SNGAN_MNIST", "--reconstructor-type", "LeNet", "-K", "8",
             "-D", "16", "--learn-gammas", "--min-shift-magnitude", "0.15",
             "--max-shift-magnitude", "0.25", "--batch-size", "32", "--g-dtype", "bfloat16",
             "--log-freq", "3", "--ckp-freq", "3"]
    exp = osp.join("experiments", "wip", "SNGAN_MNIST-LeNet-K8-D16-LearnGammas-eps0.15_0.25")
    out = {}
    for k in (1, 3, 1):
        root = tmp_path / f"run{len(out)}"
        root.mkdir()
        monkeypatch.chdir(root)
        for max_iter in (4, 10):
            t_train.main(flags + ["--steps-per-call", str(k), "--max-iter", str(max_iter)])
        with open(osp.join(exp, "stats.json")) as f:
            stats = json.load(f)
        sets = torch.load(osp.join(exp, "models", "support_sets.pt"))
        init = torch.load(osp.join(exp, "models", "support_sets_init.pt"))
        out[len(out)] = (stats, sets, init)
        assert set(stats) == {"3", "6", "9"}
        assert os.path.isfile(osp.join(exp, "models", "checkpoint.pt"))
    (s1, e1, init), (s3, e3, _), (s1b, e1b, _) = out[0], out[1], out[2]
    if all(torch.equal(e1[key], e1b[key]) for key in e1) and s1 == s1b:
        assert s3 == s1 and all(torch.equal(e3[key], e1[key]) for key in e1)
        return
    for key in e1:
        assert _close_as_eager(e3[key], e1[key], e1b[key], init[key]), key
    for it in s1:
        for name, v in s1[it].items():
            assert abs(s3[it][name] - v) <= max(SPREAD * abs(s1b[it][name] - v), 1e-3), (it, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["StyleGAN2", "ProgGAN"])
def test_tail_kernels_on_the_gradient_path(cuda, deterministic, family, dtype, monkeypatch):
    """A training step with the tail kernel in both generator forwards (its
    backward recomputes the plain section) against the same step with the
    plain tail: the kernel launches once per section and forward, two
    forwards a step, and the losses agree. Then the step's gradient path
    through the generator, d(G(z + shift) . w)/d(shift) at the step's own
    codes, with the deterministic algorithms (cuDNN's others sum in a
    run-dependent order, 2e-4 of the largest entry apart from one run to the
    next): in f32 the two routes agree within 1e-4 of its largest entry (a
    section's backward is the plain section's VJP at the saved operands, so
    StyleGAN2's one section gives the same bits; ProgGAN's later sections see
    inputs that the kernel summed in another order); with a bf16 generator each route is held
    to the f32 gradient, and the kernel route departs from it no more than
    the plain route does (the kernel rounds only its outputs, the plain tail
    every intermediate), with a margin of 1.5x and 1e-2 of the largest entry.
    R's and the sets' gradients are not compared: R in train mode on a batch
    of 4 amplifies any difference of its input images by orders of
    magnitude."""
    from warpedganspace_torch.models import proggan, stylegan2
    from warpedganspace_torch.ops import proggan_tail_cuda, sg2_tail_cuda
    from warpedganspace_torch.ops.proggan_tail import proggan_tail_plain
    from warpedganspace_torch.ops.sg2_tail import fused_section_plain
    from warpedganspace_torch.train.train_step import sample_batch

    def run(plain, g_dtype):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(stylegan2, "fused_section", fused_section_plain)
                mp.setattr(proggan, "proggan_tail", proggan_tail_plain)
            state = _state(family, cuda, batch_size=4, generator_dtype=g_dtype,
                           reconstructor_dtype=g_dtype)
            before = (sg2_tail_cuda.launches, proggan_tail_cuda.launches)
            metrics = metric_row(train_step(state, 1))
            torch.cuda.synchronize()
            launches = (sg2_tail_cuda.launches - before[0], proggan_tail_cuda.launches - before[1])
            G, dt = state.G, next(state.G.parameters()).dtype
            z = sample_batch(state, 1)[0]
            if state.cfg.shift_in_w_space:
                with torch.no_grad():
                    z = G.get_w(z.to(dt))
            shift = (0.1 * torch.randn(z.shape, generator=torch.Generator().manual_seed(3))
                     ).to(cuda, dt).requires_grad_(True)
            img = G(z.to(dt), shift, latent_is_w=state.cfg.shift_in_w_space)
            w = torch.randn(img.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
            torch.sum(img.float() * w).backward()
        return metrics, shift.grad.float(), launches

    rows, grad, launches = run(False, dtype)
    want_rows, want_grad, plain_launches = run(True, dtype)
    # StyleGAN2 at 256^2 with channel multiplier 1 has one tail section, the
    # tiny ProgGAN chain three; two generator forwards a step.
    assert launches == ((2, 0) if family == "StyleGAN2" else (0, 6))
    assert plain_launches == (0, 0)
    assert bool(torch.isfinite(rows).all()) and bool(torch.isfinite(grad).all())
    loss_diff = abs(float(rows[3] - want_rows[3]))

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    if dtype == "float32":
        err = rel(grad, want_grad)
        assert loss_diff <= 1e-4 and err <= 1e-4, (loss_diff, err)
        if family == "StyleGAN2":
            assert torch.equal(grad, want_grad)
    else:
        _, ref, _ = run(True, "float32")
        err, plain_err = rel(grad, ref), rel(want_grad, ref)
        assert loss_diff <= 5e-2 and err <= max(1.5 * plain_err, 1e-2), \
            (loss_diff, err, plain_err)
