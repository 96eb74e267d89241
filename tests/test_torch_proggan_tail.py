"""The port's ProgGAN tail (plain versions and chain logic) against the JAX
package's fused tail, on the CPU.

Inputs and weights come from a numpy seed and go through both packages. The
JAX side runs as ``tests/test_proggan_pallas.py`` runs it: ``fused_section``
in interpret mode around ``fold_x``/``unfold_x``, under
``jax.default_matmul_precision("highest")``, and the jnp twins. The port runs
its plain versions (the CUDA kernel is held to them on the card,
``tests/test_torch_proggan_tail_cuda.py``). Layouts: JAX NHWC/HWIO, the port
NCHW/OIHW.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.nn import core as jnn
from warpedganspace_tpu.ops import proggan_tail_pallas as ptp
from warpedganspace_torch.models.proggan import _BLOCK_SPECS, _CHANNELS
from warpedganspace_torch.ops import proggan_tail_cuda
from warpedganspace_torch.ops.proggan_tail import (fused_section_plain, pixel_norm,
                                                   proggan_tail_plain,
                                                   tail_sections_from_blocks)

torch.set_num_threads(1)

# f32 sums of up to 9 * 128 = 1,152 products in another order: the bound
# tests/test_proggan_pallas.py holds the TPU kernel to.
TOL = dict(atol=2e-5, rtol=2e-5)


def section_arrays(seed, c, head):
    """One section's operands in the JAX layouts (HWIO), scales != 1 and random
    biases so that a wrong WScale or a computed (not zeroed) border shows."""
    rng = np.random.default_rng(seed)

    def f32(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    args = [f32(3, 3, 2 * c, c, std=0.1), f32(c, std=0.1), np.float32(1.3),
            f32(3, 3, c, c, std=0.1), f32(c, std=0.1), np.float32(0.8)]
    h = (f32(1, 1, c, 3, std=0.2), f32(3, std=0.1), np.float32(1.1)) if head else None
    return args, h


def to_port(args, head):
    """HWIO -> OIHW, scalars -> one-element tensors."""
    def conv(w):
        return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))

    def vec(b):
        return torch.from_numpy(np.atleast_1d(b).copy())

    w_up, b_up, s_up, w_same, b_same, s_same = args
    port = [conv(w_up), vec(b_up), vec(s_up), conv(w_same), vec(b_same), vec(s_same)]
    return port, None if head is None else (conv(head[0]), vec(head[1]), vec(head[2]))


def section_twin(x, w_up, b_up, s_up, w_same, b_same, s_same, head=None):
    """The jnp composition of one section (tests/test_proggan_pallas.py:24-39)."""
    x = jnn.pixel_norm(x)
    x = jnn.upsample_nearest(x, 2)
    x = jnn.conv2d({"w": w_up}, x, padding=1)
    x = x * s_up + b_up
    x = jnp.where(x >= 0, x, 0.2 * x)
    x = jnn.pixel_norm(x)
    x = jnn.conv2d({"w": w_same}, x, padding=1)
    x = x * s_same + b_same
    x = jnp.where(x >= 0, x, 0.2 * x)
    if head is not None:
        w_out, b_out, s_out = head
        x = jnn.pixel_norm(x)
        x = jnn.conv2d({"w": w_out}, x, padding=0)
        x = x * s_out + b_out
    return x


def port_section(x_nhwc, args, head):
    port, port_head = to_port(args, head)
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        return fused_section_plain(x, *port, head=port_head).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", [16, 64])
def test_section_plain_matches_jax_kernel_and_twin(c, head):
    args, h = section_arrays(c, c, head)
    w = 8 * (64 // c)                       # the TPU kernel wants a folded width of 8
    x = np.random.default_rng(c + 1).standard_normal((2, 8, w, 2 * c)).astype(np.float32)
    got = port_section(x, args, h)
    with jax.default_matmul_precision("highest"):
        twin = np.asarray(section_twin(jnp.asarray(x), *args, head=h))
        kern = np.asarray(ptp.unfold_x(
            ptp.fused_section(ptp.fold_x(jnp.asarray(x), 64 // c), *args, head=h), 128 // c))
    assert got.shape == twin.shape == kern.shape == (2, 16, 2 * w, 3 if head else c)
    np.testing.assert_allclose(got, twin, **TOL)
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("head", [False, True])
def test_section_plain_odd_nonsquare_matches_twin(head):
    """An odd, non-square input, which the TPU kernel's layout does not take."""
    c = 32
    args, h = section_arrays(7, c, head)
    x = np.random.default_rng(8).standard_normal((1, 5, 3, 2 * c)).astype(np.float32)
    got = port_section(x, args, h)
    with jax.default_matmul_precision("highest"):
        twin = np.asarray(section_twin(jnp.asarray(x), *args, head=h))
    assert got.shape == twin.shape == (1, 10, 6, 3 if head else c)
    np.testing.assert_allclose(got, twin, **TOL)


def test_pixel_norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 7)).astype(np.float32)
    x[0, 0, 0] = 0.0                        # a zero pixel stays zero (eps under the root)
    ref = np.asarray(jnn.pixel_norm(jnp.asarray(x)))
    got = pixel_norm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, atol=1e-6, rtol=1e-6)
    assert np.all(got[0, :, 0, 0] == 0.0)


def _block(w_hwio, bias, scale):
    return types.SimpleNamespace(
        weight=torch.from_numpy(np.ascontiguousarray(np.asarray(w_hwio).transpose(3, 2, 0, 1))),
        bias=torch.from_numpy(np.asarray(bias).copy()),
        scale=torch.from_numpy(np.atleast_1d(np.asarray(scale)).copy()))


def tiny_tail(seed=0):
    """The three sections (C = 64, 32, 16) and the head of the tiny chain of
    tests/test_proggan_pallas.py, in both packages' forms."""
    jsections, sections = [], []
    for i, c in enumerate((64, 32, 16)):
        (w_up, b_up, s_up, w_same, b_same, s_same), _ = section_arrays(seed + i, c, False)
        jsections.append({
            "up": {"conv": {"w": w_up}, "wscale_bias": b_up, "wscale_scale": s_up},
            "same": {"conv": {"w": w_same}, "wscale_bias": b_same, "wscale_scale": s_same}})
        sections.append((_block(w_up, b_up, s_up), _block(w_same, b_same, s_same)))
    _, (w_out, b_out, s_out) = section_arrays(seed + 3, 16, True)
    jout = {"conv": {"w": w_out}, "wscale_bias": b_out, "wscale_scale": s_out}
    return jsections, jout, sections, _block(w_out, b_out, s_out)


def test_tail_plain_matches_tail_jnp():
    jsections, jout, sections, out = tiny_tail()
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 128)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(ptp._tail_jnp(jnp.asarray(x), jsections, jout))
    with torch.no_grad():
        got = proggan_tail_plain(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                 sections, out).numpy()
    assert got.shape == (2, 3, 64, 64) and ref.shape == (2, 64, 64, 3)
    # Three sections deep: the section bound, with room for six convolutions.
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, atol=5e-5, rtol=5e-5)


def _shape_blocks(channels):
    specs = _BLOCK_SPECS[: len(channels) - 1]
    blocks = [types.SimpleNamespace(weight=torch.empty((cout, cin, k, k), device="meta"))
              for (k, _, _), cin, cout in zip(specs, channels[:-1], channels[1:])]
    return blocks, specs


def test_tail_sections_from_blocks_full_width_chain():
    blocks, specs = _shape_blocks(_CHANNELS)
    assert len(blocks) == 18
    n_head, sections = tail_sections_from_blocks(blocks, specs)
    assert n_head == 12                     # blocks 12..17 fuse: (64,64) (32,32) (16,16)
    assert [up.weight.shape[0] for up, _ in sections] == [64, 32, 16]
    assert all(up is blocks[12 + 2 * i] and same is blocks[13 + 2 * i]
               for i, (up, same) in enumerate(sections))
    # The JAX package splits its own full-width chain at the same place.
    from warpedganspace_tpu.models.proggan import _BLOCK_SPECS as J_SPECS
    from warpedganspace_tpu.models.proggan import ProgGANGenerator as JGenerator
    jparams = jax.eval_shape(lambda k: JGenerator().init(k), jax.random.key(0))
    jn_head, jsections = ptp.tail_sections_from_blocks(jparams["blocks"], J_SPECS)
    assert (jn_head, len(jsections)) == (n_head, len(sections))
    assert list(J_SPECS) == list(_BLOCK_SPECS)


@pytest.mark.parametrize("channels", [
    [512, 256, 256, 128, 128],              # no block of at most 64 channels
    [128, 128, 128, 64, 64, 32],            # an odd number of blocks after the entry
    [128, 128, 128, 64, 64, 16, 16],        # C does not halve
    [128, 128, 128, 128, 128, 8, 8],        # the entry does not halve its input
])
def test_tail_sections_from_blocks_nonmatching(channels):
    blocks, specs = _shape_blocks(channels)
    assert tail_sections_from_blocks(blocks, specs) == (len(blocks), [])


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    args, h = section_arrays(11, 16, True)
    port, port_head = to_port(args, h)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 32, 4, 6))
                         .astype(np.float32))
    before = proggan_tail_cuda.launches
    with torch.no_grad():
        got = proggan_tail_cuda.fused_section(x, *port, head=port_head)
        ref = fused_section_plain(x, *port, head=port_head)
        _, _, sections, out = tiny_tail()
        x128 = torch.from_numpy(np.random.default_rng(13).standard_normal((1, 128, 2, 2))
                                .astype(np.float32))
        tail = proggan_tail_cuda.proggan_tail(x128, sections, out)
        tail_ref = proggan_tail_plain(x128, sections, out)
    assert proggan_tail_cuda.launches == before
    assert torch.equal(got, ref) and torch.equal(tail, tail_ref)
    assert tuple(tail.shape) == (1, 3, 16, 16)


@pytest.mark.parametrize("head", [False, True])
def test_wrapper_backward_is_plain_vjp(monkeypatch, head):
    """The autograd function around the kernel differentiates the plain
    version. The launch is replaced by the plain forward (no card here), so
    the gradients must be the plain version's own, for every operand."""
    args, h = section_arrays(14, 16, head)
    port, port_head = to_port(args, h)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((2, 32, 3, 5))
                         .astype(np.float32))
    operands = [x] + port + (list(port_head) if head else [])
    monkeypatch.setattr(
        proggan_tail_cuda, "_launch",
        lambda *ops: fused_section_plain(*ops[:7], head=ops[7]))
    leaves1 = [t.clone().requires_grad_() for t in operands]
    leaves2 = [t.clone().requires_grad_() for t in operands]
    out1 = proggan_tail_cuda._FusedSection.apply(head, *leaves1)
    out2 = fused_section_plain(*leaves2[:7], head=leaves2[7:] if head else None)
    assert out1.grad_fn is not None and torch.equal(out1, out2)
    torch.cos(out1).sum().backward()
    torch.cos(out2).sum().backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)
    # A frozen operand gets no gradient.
    leaves3 = [t.clone() for t in operands]
    leaves3[0].requires_grad_()
    out3 = proggan_tail_cuda._FusedSection.apply(head, *leaves3)
    out3.sum().backward()
    assert leaves3[0].grad is not None and all(t.grad is None for t in leaves3[1:])
