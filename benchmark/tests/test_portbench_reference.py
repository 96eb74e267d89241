"""The plain reference agrees with the port at a tiny size on the CPU, in
float32 (the tests may import both; the reference imports nothing of the
port)."""
import pytest
import torch

from benchmark import inputs
from benchmark.reference import quant, resnet
from benchmark.reference import warp as ref_warp
from benchmark.tests.portbench_tiny import make_run
from benchmark.traffic import train

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["sg2w1024-render-bf16", "proggan1024-render-bf16"])
def test_generator_agrees(cell):
    run = make_run(cell)
    cfg = run.config
    sd = run.family.make_weights(cfg, inputs.generator(5, "generator", CPU), CPU)
    G = run.family.build_program(cfg, sd, CPU)
    ref = run.family.build_reference(cfg, sd, quant.exact)
    z = torch.randn(3, 512, generator=torch.Generator().manual_seed(1))
    shift = 0.1 * torch.randn(3, 512, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        w = G.get_w(z)
        got = G(w, shift, latent_is_w=True) if G.shift_in_w_space else G(z, shift)
        want = ref.render(ref.latent(z), shift)
    assert torch.allclose(w if G.shift_in_w_space else z, ref.latent(z), atol=1e-5, rtol=1e-5)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_warp_integration_agrees():
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.traverse.engine import traverse_paths

    cfg = dict(make_run("proggan1024-render-bf16").config, support_vectors_dim=16)
    sd = inputs.support_sets_state_dict(cfg, inputs.generator(3, "support_sets", CPU), CPU)
    S = SupportSets(3, 4, 16, learn_gammas=True).from_torch_state_dict(sd)
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(4))
    codes, shifts = traverse_paths(S, z, eps=0.15, shift_steps=3)
    rc, rs = ref_warp.integrate(sd, z, 0.15, 3)
    assert codes.shape == rc.shape == (2, 3, 7, 16)
    assert torch.allclose(codes, rc, atol=1e-5) and torch.allclose(shifts, rs, atol=1e-5)


def test_resnet_agrees():
    from warpedganspace_torch.convert.reconstructor import load_reference_state_dict
    from warpedganspace_torch.models.reconstructor import Reconstructor

    cfg = make_run("sg2w1024-render-bf16").config
    sd = inputs.resnet_state_dict(cfg, inputs.generator(6, "reconstructor", CPU), CPU)
    R = load_reference_state_dict(Reconstructor("ResNet", cfg["num_support_sets"], 3), sd)
    x1, x2 = torch.randn(2, 4, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    logits, mags = R(x1, x2)
    want_logits, want_mags = resnet.forward(torch.cat([x1, x2], 1), sd)
    assert torch.allclose(logits, want_logits, atol=1e-4)
    assert torch.allclose(mags, want_mags, atol=1e-4)


def test_training_step_agrees_in_float32():
    """The port's step in float32 against the reference step: the first
    losses, the first gradients and the change over three steps."""
    run = make_run("sg2w1024-train-bf16", family="proggan",
                   params={"g_dtype": "float32", "r_dtype": "float32"})
    st = train.setup(run)
    values = train.gaps(run, train.outputs(run, st))
    assert values["loss_gap"] < 1e-5 and values["loss_gap_steps"] < 1e-3
    assert values["grad_gap_worst"] < 1e-4 and values["update_gap"] < 1e-2
