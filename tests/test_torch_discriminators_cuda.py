"""BigGAN's discriminator on the card: its attention block launches the
forward kernel once per D forward, and the logits equal the plain route's.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX (``tests/test_torch_discriminators.py`` holds the port's
discriminators to the JAX package's on the CPU, with the fabricator below), so
on a machine without it run it on its own, past the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_discriminators_cuda.py -m gpu
"""
import math

import numpy as np
import pytest
import torch

from warpedganspace_torch.convert.biggan import biggan_d_state_dict_from_reference
from warpedganspace_torch.models import biggan
from warpedganspace_torch.models.biggan import BigGANDiscriminator, biggan_d_arch
from warpedganspace_torch.ops import attn_cuda
from warpedganspace_torch.ops.attn import sa_attention_plain


def fabricate_biggan_d(resolution, ch, attention, n_classes, seed=0):
    """A reference-layout BigGAN Discriminator ``state_dict`` (BigGAN.py:281-399)
    as numpy arrays, with non-trivial SN ``u0`` vectors and attention gammas."""
    rng = np.random.default_rng(seed)
    arch = biggan_d_arch(ch, resolution, attention)
    sd = {}

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    def sn(prefix, shape, bias=True):
        fan_in = int(np.prod(shape[1:]))
        sd[prefix + ".weight"] = f32(rng.standard_normal(shape) * (1.5 / math.sqrt(fan_in)))
        sd[prefix + ".u0"] = f32(rng.standard_normal((1, shape[0])))
        if bias:
            sd[prefix + ".bias"] = f32(0.1 * rng.standard_normal(shape[0]))

    for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
        pre = f"blocks.{i}.0."
        sn(pre + "conv1", (cout, cin, 3, 3))
        sn(pre + "conv2", (cout, cout, 3, 3))
        if cin != cout or arch["downsample"][i]:
            sn(pre + "conv_sc", (cout, cin, 1, 1))
        if arch["attention"][i]:
            apre = f"blocks.{i}.1."
            sn(apre + "theta", (cout // 8, cout, 1, 1), bias=False)
            sn(apre + "phi", (cout // 8, cout, 1, 1), bias=False)
            sn(apre + "g", (cout // 2, cout, 1, 1), bias=False)
            sn(apre + "o", (cout, cout // 2, 1, 1), bias=False)
            sd[apre + "gamma"] = f32(0.8 + 0.1 * i)
    c = arch["out_channels"][-1]
    sn("linear", (1, c))
    sn("embed", (n_classes, c), bias=False)
    return sd



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_biggan_d_attention_launches_the_kernel_once(cuda, monkeypatch, b):
    """BigGAN-128's D at full width (D_ch=96, attention at 64²: dk=12, dv=48)."""
    d = BigGANDiscriminator(128, 96, 1000, "64")
    d.load_state_dict(biggan_d_state_dict_from_reference(
        fabricate_biggan_d(128, 96, "64", 1000, seed=2)))
    d = d.to(cuda)
    gen = torch.Generator().manual_seed(b)
    x = torch.randn((b, 3, 128, 128), generator=gen).to(cuda)
    y = torch.randint(0, 1000, (b,), generator=gen).to(cuda)
    with torch.no_grad():
        before = attn_cuda.launches
        got = d(x, y)
        torch.cuda.synchronize()
        assert attn_cuda.launches == before + 1
        monkeypatch.setattr(biggan, "sa_attention", sa_attention_plain)
        want = d(x, y)
        assert attn_cuda.launches == before + 1
    assert bool(torch.isfinite(got).all()) and got.shape == (b, 1)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-4, err
