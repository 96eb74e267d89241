"""The port's S3FD detector, ArcFace comparator and FAN-AU detector against the
JAX package's, on the CPU.

Each network is built at its full reference architecture from one fabricated
reference-layout state dict (``evalzoo/fabricate.py``: seeded weights, data-set
BatchNorm statistics randomised around those of a calibration batch), loaded
into the port with ``load_state_dict(strict=True)`` and, as numpy, into the
JAX package through its ``from_state_dict`` (``prefix=""`` for ArcFace, as its
loader passes). Both get the same 2-3 frames made with numpy from a seed.
Tolerance: every raw output within 1e-3 relative plus 1e-4 of its largest
magnitude (``assert_close`` below); ``-s`` prints the worst.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.evalzoo import arcface as jarc
from warpedganspace_tpu.evalzoo import fanau as jfan
from warpedganspace_tpu.evalzoo import sfd as jsfd
from warpedganspace_torch.evalzoo import fabricate
from warpedganspace_torch.evalzoo.arcface import IDComparator
from warpedganspace_torch.evalzoo.fabricate import predictor_state_dicts
from warpedganspace_torch.evalzoo.fanau import AUdetector
from warpedganspace_torch.evalzoo.sfd import S3FD, SFDDetector, decode_batch

torch.set_num_threads(1)

# The helpers down to ``assert_close`` serve tests/test_torch_evalzoo_{resnets,
# pieces}.py too. Raw outputs: |port - JAX| <= ATOL_REL * max|JAX| + RTOL * |JAX|.
RTOL, ATOL_REL = 1e-3, 1e-4


@functools.cache
def state_dicts():
    """{name: state dict} of the six predictors, seed 0, made once per process."""
    return predictor_state_dicts(seed=0)


def numpy_state_dict(sd):
    return {k: v.numpy() for k, v in sd.items()}


def images(seed, n, size, lo=0.0, hi=255.0):
    """(n, size, size, 3) float32 NHWC smooth random images in [lo, hi], numpy only."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, 8, 8, 3))
    up = np.repeat(np.repeat(coarse, size // 8, axis=1), size // 8, axis=2)
    x = 0.8 * up + 0.2 * rng.random((n, size, size, 3))
    return (lo + (hi - lo) * x).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want, name):
    """The tolerance above; returns the worst error relative to max|want|."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= ATOL_REL * scale + RTOL * np.abs(want)).all(), (
        f"{name}: worst {float(err.max()):.3e} at scale {scale:.3e}")
    worst = float(err.max()) / max(scale, 1e-30)
    print(f"{name}: worst abs {float(err.max()):.3e} = {worst:.2e} of max|out| {scale:.3e}")
    return worst


@pytest.fixture(scope="module")
def sfd_pair():
    sd = state_dicts()["sfd"]
    return SFDDetector.from_state_dict(sd), jsfd.SFDDetector.from_state_dict(numpy_state_dict(sd))


def test_sfd_maps_and_boxes(sfd_pair):
    port, jax_det = sfd_pair
    x = images(11, 3, 128)          # raw 0-255 values, as the batch path feeds them
    got = [o.numpy() for o in port.forward_maps(nchw(x))]
    want = [np.asarray(o).transpose(0, 3, 1, 2)
            for o in jsfd.s3fd_apply(jax_det.params, jnp.asarray(x))]
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"sfd map {i} ({'class' if i % 2 == 0 else 'box'})")
    # The decoded candidate sets (the union-over-batch positions) and the
    # first box of every frame after NMS.
    boxes, jboxes = decode_batch(got), jax_det.batch_detect(x)
    assert boxes.shape == jboxes.shape and boxes.shape[1] > 10
    np.testing.assert_allclose(boxes, jboxes, rtol=1e-3, atol=1e-3)
    faces, _, _ = port.detect_from_boxes(boxes)
    jfaces, _, _ = jax_det.detect_from_batch(x)
    for f, jf in zip(faces, jfaces):
        assert len(f) == len(jf) > 0
        np.testing.assert_allclose(f[0], jf[0], rtol=1e-4, atol=1e-3)


def test_sfd_maps_with_drawn_heads():
    """The fitted tower with all twelve heads drawn as PyTorch initialises
    them: every head reads its map with its own random weights, and the three
    background channels of the stride-4 head differ, so each 3x3 head layout
    and the max-out background are held against the JAX package apart from
    the fitting."""
    torch.manual_seed(1)
    heads = {k: v for k, v in S3FD().state_dict().items() if "_mbox_" in k}
    sd = {**state_dicts()["sfd"], **heads}
    port = SFDDetector.from_state_dict(sd)
    params = jsfd.SFDDetector.from_state_dict(numpy_state_dict(sd)).params
    x = images(16, 2, 128)
    got = [o.numpy() for o in port.forward_maps(nchw(x))]
    want = [np.asarray(o).transpose(0, 3, 1, 2) for o in jsfd.s3fd_apply(params, jnp.asarray(x))]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"sfd map {i} ({'class' if i % 2 == 0 else 'box'}), drawn heads")
    # Each of the three background channels wins the max-out somewhere.
    with torch.no_grad():
        bg = port.net.conv3_3_norm_mbox_conf(port.net.head_inputs(nchw(x))[0])[:, :3]
    assert set(bg.argmax(dim=1).unique().tolist()) == {0, 1, 2}


def test_sfd_face_head_is_held_below_saturation(monkeypatch):
    """The fitted stride-4 face head puts the lowest calibration frame's best
    anchor at ``TOP_LOGIT``. Where the frames' best anchors spread further
    than ``TOP_SPREAD`` (set small here), the head is fitted again against
    two drawn background channels and the third is a knee: it leaves every
    logit under ``TOP_LOGIT + TOP_SPREAD / 2`` as that fit has it and bends
    the ones above until the highest frame's best reads ``TOP_LOGIT +
    TOP_SPREAD``; no float32 score reads 1."""
    x = fabricate.calibration_frames(torch.Generator().manual_seed(1), n=6, size=128)

    def fit(spread):
        monkeypatch.setattr(fabricate, "TOP_SPREAD", spread)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            net = S3FD().eval()
        fabricate.set_sfd_heads(net, x, torch.Generator().manual_seed(0))
        with torch.no_grad():
            cls = net.conv3_3_norm_mbox_conf(net.head_inputs(x)[0]).double().flatten(2)
            scores = net(x)[0][:, 1]
        return cls, scores

    spread = 1.0
    first, _ = fit(float("inf"))
    cls, scores = fit(spread)
    first_best = (first[:, 3] - first[:, :3].amax(dim=1)).amax(dim=1)
    unbent = cls[:, 3] - cls[:, :2].amax(dim=1)
    bent = cls[:, 3] - cls[:, :3].amax(dim=1)
    knee = fabricate.TOP_LOGIT + spread / 2
    assert float(first_best.max() - first_best.min()) > spread, first_best
    assert float(unbent.amax(dim=1).max()) > fabricate.TOP_LOGIT + spread + 0.5, unbent
    for logits in (first_best, unbent.amax(dim=1), bent.amax(dim=1)):
        assert abs(float(logits.min()) - fabricate.TOP_LOGIT) < 1e-4, logits
    assert abs(float(bent.amax(dim=1).max()) - fabricate.TOP_LOGIT - spread) < 1e-4
    under = unbent < knee
    torch.testing.assert_close(bent[under], unbent[under], rtol=0, atol=1e-5)
    assert bool((bent <= unbent + 1e-5).all())
    assert float(scores.max()) < 1.0


def test_sfd_single_image_path(sfd_pair):
    """``detect_from_image`` subtracts the means on both sides."""
    port, jax_det = sfd_pair
    x = images(12, 1, 128)[0]
    got, want = port.detect_from_image(x), jax_det.detect_from_image(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)


def test_arcface_embeddings_and_similarities():
    sd = state_dicts()["arcface"]
    port = IDComparator.from_state_dict(sd, prefix="")
    jcmp = jarc.IDComparator.from_state_dict(numpy_state_dict(sd), prefix="")
    x, x2 = images(13, 2, 256, -1.0, 1.0), images(14, 2, 256, -1.0, 1.0)
    with torch.no_grad():
        emb = port.extract(nchw(x)).numpy()
    assert_close(emb, np.asarray(jcmp._extract(jcmp.params, jnp.asarray(x))), "arcface embedding")
    assert_close(port.similarities(nchw(x), nchw(x2)).numpy(),
                 np.asarray(jcmp.similarities(jnp.asarray(x), jnp.asarray(x2))),
                 "arcface similarities")
    assert_close(float(port(nchw(x), nchw(x2))), float(jcmp(jnp.asarray(x), jnp.asarray(x2))),
                 "arcface mean similarity")


def test_arcface_prefix_and_strict_keys():
    """A prefixed dict loads with its prefix; a key missing fails the strict load."""
    sd = state_dicts()["arcface"]
    IDComparator.from_state_dict({"backbone." + k: v for k, v in sd.items()})
    with pytest.raises(RuntimeError, match="Missing key"):
        IDComparator.from_state_dict({k: v for k, v in sd.items()
                                      if k != "output_layer.3.weight"}, prefix="")


def test_adaptive_avg_pool_188_to_112():
    """ArcFace's pool of the 188² crop to 112²: ``F.adaptive_avg_pool2d``
    against the JAX package's integral image."""
    x = images(15, 2, 192, -1.0, 1.0)[:, 2:190, 2:190]
    got = torch.nn.functional.adaptive_avg_pool2d(nchw(x), (112, 112)).numpy()
    # The windows [floor(i*188/112), ceil((i+1)*188/112)) averaged in float64.
    lo = np.floor(np.arange(112) * 188 / 112).astype(int)
    hi = np.ceil((np.arange(112) + 1) * 188 / 112).astype(int)
    x64 = nchw(x).double().numpy()
    exact = np.stack([np.stack([x64[:, :, a:b, c:d].mean(axis=(2, 3)) for c, d in zip(lo, hi)],
                               axis=-1) for a, b in zip(lo, hi)], axis=-2)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    # The integral image carries the float32 rounding of sums over up to 188²
    # entries, about 1e-4 here.
    want = np.asarray(jarc.adaptive_avg_pool(jnp.asarray(x), 112, 112)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_fanau_heatmaps_and_intensities():
    sd = state_dicts()["au_detector"]
    port = AUdetector.from_state_dict(sd)
    jdet = jfan.AUdetector.from_state_dict(numpy_state_dict(sd))
    x = images(16, 2, 256)
    norm = (x - x.min()) / (x.max() - x.min())
    with torch.no_grad():
        heat = port.net(nchw(norm)).numpy()
    assert heat.shape == (2, 12, 64, 64)
    assert_close(heat, np.asarray(jfan.fanau_apply(jdet.params, jnp.asarray(norm)))
                 .transpose(0, 3, 1, 2), "fan-au heatmaps")
    assert_close(port.detect_AU(nchw(x)).numpy(), np.asarray(jdet.detect_AU(x)),
                 "fan-au intensities")
