"""The port and its card smoke test never import JAX: they must run on a
machine that has none."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "warpedganspace_torch",
    "warpedganspace_torch.ops.rbf",
    "warpedganspace_torch.ops.rbf_cuda",
    "warpedganspace_torch.ops._build",
    "warpedganspace_torch.ops.fused_act",
    "warpedganspace_torch.ops.upfirdn2d",
    "warpedganspace_torch.models.support_sets",
    "warpedganspace_torch.models.stylegan2",
    "warpedganspace_torch.models.api",
    "warpedganspace_torch.models.gan_load",
    "warpedganspace_torch.convert.stylegan2",
    "warpedganspace_torch.convert.from_jax",
    "warpedganspace_torch.core.sampling",
    "warpedganspace_torch.traverse.engine",
    "warpedganspace_torch.traverse.images",
    "warpedganspace_torch.traverse.writer",
    "warpedganspace_torch.traverse.gifs",
    "warpedganspace_torch.cli.sample_gan",
    "warpedganspace_torch.cli.traverse_latent_space",
    "chip_smoke",
]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
