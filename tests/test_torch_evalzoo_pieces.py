"""The attribute stage's host and glue pieces against the JAX package's, on
the CPU: the JPEG decoder, the transforms, the face-crop plans and their
device gathers, the SFD decode and both NMS implementations, the loaders and
the pose helper.

The JAX package decodes and resizes with cv2; the port with PIL and
``F.interpolate`` (the card's machine has no cv2). Tolerances on the 0-255
scale: the decoders are equal; 1024² -> 256², the path's main resize, within
1e-4; other sizes within 0.05 (cv2 and PyTorch compute the bilinear weights
from the scale in different precisions); the crop gathers within 1e-4 (the
same plan, products in another order).
"""
import os
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_evalzoo_detect import images, nchw, numpy_state_dict, state_dicts
from warpedganspace_tpu.evalzoo import crop_resize as jcrop
from warpedganspace_tpu.evalzoo import sfd as jsfd
from warpedganspace_tpu.evalzoo import transforms as jtf
from warpedganspace_torch.evalzoo import crop_resize as pcrop
from warpedganspace_torch.evalzoo import sfd as psfd
from warpedganspace_torch.evalzoo import transforms as ptf
from warpedganspace_torch.traverse.images import save_jpeg
from warpedganspace_torch.utils.data import PathImages

torch.set_num_threads(1)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [1024, 64])
def test_pil_decoder_equals_cv2(size, tmp_path):
    """The port's PIL decode of the pipeline's q75 progressive JPEGs is the
    JAX package's cv2 decode, byte for byte."""
    cv2 = pytest.importorskip("cv2")
    from warpedganspace_tpu.utils.data import PathImages as JPathImages

    x = images(31, 3, size).astype(np.uint8)
    for t in range(3):
        save_jpeg(Image.fromarray(x[t]), str(tmp_path / f"{t:06d}.jpg"))
    got, want = PathImages(str(tmp_path)).load_all(), JPathImages(str(tmp_path)).load_all()
    assert got.dtype == want.dtype == np.float32 and got.shape == (3, size, size, 3)
    np.testing.assert_array_equal(got, want)
    rgb = cv2.cvtColor(cv2.imread(str(tmp_path / "000000.jpg")), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got[0], rgb.astype(np.float32))


@pytest.mark.parametrize("shape, size, atol", [
    ((2, 1024, 1024), 256, 1e-4),      # the 256² frame batch of every path
    ((2, 1024, 1024), 224, 0.05),      # CelebA's input
    ((2, 300, 500), 224, 0.05),        # a wide face crop
    ((2, 500, 300), 224, 0.05),        # a tall one
    ((2, 90, 60), 224, 0.05),          # an upscaled small one
    ((2, 256, 256), 256, 0.0),         # already the size: returned as it is
])
def test_resize_center_matches_cv2_chain(shape, size, atol):
    n, h, w = shape
    x = (np.random.default_rng(32).random((n, h, w, 3)) * 255).astype(np.float32)
    got = _nhwc(ptf.resize_center(nchw(x), size))
    want = jtf.resize_center(x, size)
    assert got.shape == want.shape == (n, size, size, 3)
    assert ptf.resized_dims(h, w, size) == jtf.resize_shorter(x[0], size).shape[:2]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_center_crop_pads_smaller_images():
    x = (np.random.default_rng(33).random((1, 100, 60, 3)) * 255).astype(np.float32)
    got = _nhwc(ptf.center_crop(nchw(x), 224))[0]
    np.testing.assert_array_equal(got, jtf.center_crop(x[0], 224))


def test_normalize_and_crop_rect():
    x = images(34, 2, 32, 0.0, 1.0)
    np.testing.assert_allclose(_nhwc(ptf.normalize_imagenet(nchw(x))),
                               jtf.normalize_imagenet(x), rtol=0, atol=1e-6)
    for bbox in ([40, 60, 200, 220], [0, 0, 256, 256], [-7.5, 3.2, 20.9, 250.1]):
        for padding in (0.0, 0.25):
            assert ptf.crop_rect(bbox, 256, 256, padding) == jtf.crop_rect(bbox, 256, 256, padding)
    frames = images(35, 2, 256)
    got = ptf.crop_face(nchw(frames), 1, [40, 60, 200, 220], 0.25)[0].permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(got, jtf.crop_face(frames, 1, [40, 60, 200, 220], 0.25))


BBOXES = [[0, 0, 256, 256], [40, 60, 200, 220], [10, 10, 30, 250], [10, 10, 250, 30],
          [120, 120, 135, 140], [200, 200, 256, 256], [0, 0, 64, 64]]


def _fuzz_bboxes(rng, n):
    out = []
    for _ in range(n):
        x1, y1 = rng.integers(0, 200, 2)
        out.append([x1, y1, x1 + rng.integers(4, 256 - x1), y1 + rng.integers(4, 256 - y1)])
    return out


@pytest.mark.parametrize("padding, size", [(0.0, 224), (0.25, 224), (0.0, 256), (0.1, 112)])
def test_crop_plans_and_gathers_match_jax(padding, size):
    """The plans equal the JAX package's index for index; the device gather
    matches the JAX gather and the port's own host chain (crop_face ->
    resize_center) for hand-picked and random rectangles."""
    bboxes = BBOXES + _fuzz_bboxes(np.random.default_rng(36), 20)
    frames = images(37, len(bboxes), 256)
    rects = [ptf.crop_rect(b, 256, 256, padding) for b in bboxes]
    plan, jplan = pcrop.plan_crop_resize(rects, size), jcrop.plan_crop_resize(rects, size)
    assert plan.keys() == jplan.keys()
    for k in plan:
        assert plan[k].dtype == jplan[k].dtype
        np.testing.assert_array_equal(plan[k], jplan[k], err_msg=k)
    got = _nhwc(pcrop.crop_resize(nchw(frames), plan))
    assert got.shape == (len(bboxes), size, size, 3)
    np.testing.assert_allclose(got, np.asarray(jcrop.crop_resize(jnp.asarray(frames), jplan)),
                               rtol=0, atol=1e-4)
    host = np.concatenate([_nhwc(ptf.resize_center(ptf.crop_face(nchw(frames), t, b, padding),
                                                   size)) for t, b in enumerate(bboxes)])
    np.testing.assert_allclose(got, host, rtol=0, atol=0.05)


def _maps(seed, b=3, size=64):
    """Random class and box maps of the six heads, as the tower gives them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        s = size // 2 ** (i + 2) or 1
        logits = rng.normal(-2.0, 1.5, (b, 2, s, s))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        out += [(e / e.sum(axis=1, keepdims=True)).astype(np.float32),
                rng.normal(0, 1, (b, 4, s, s)).astype(np.float32)]
    return out


def test_decode_matches_jax():
    maps = _maps(38, size=256)
    got, want = psfd.decode_batch(maps), jsfd._decode_batch(maps)
    assert got.shape == want.shape and got.shape[1] > 50
    np.testing.assert_array_equal(got, want)
    none = [m * 0 if i % 2 == 0 else m for i, m in enumerate(maps)]     # no candidate
    np.testing.assert_array_equal(psfd.decode_batch(none), jsfd._decode_batch(none))


def _dets(rng, n=200):
    xy = rng.random((n, 2)) * 200
    wh = rng.random((n, 2)) * 60 + 5
    # Distinct scores: numpy's argsort is not stable, so only distinct scores
    # have one order.
    return np.concatenate([xy, xy + wh, rng.random((n, 1))], axis=1).astype(np.float32)


def test_native_nms_builds_and_matches_numpy(monkeypatch):
    from warpedganspace_torch.native import load_native, native_error
    from warpedganspace_torch.ops._build import BUILD_DIR

    lib = load_native()
    if lib is None:
        pytest.skip(f"no C++ toolchain: {native_error()}")
    assert any(f.startswith("sfd_post-") and f.endswith(".so") for f in os.listdir(BUILD_DIR))
    rng = np.random.default_rng(39)
    for trial in range(5):
        dets = _dets(rng)
        want = psfd.nms_numpy(dets, 0.3)
        assert psfd.nms_native(lib, dets, 0.3) == want == jsfd.nms(dets, 0.3), trial
    # The dispatcher runs the library where it loaded; without it, numpy.
    ran = []
    for name in ("nms_native", "nms_numpy"):
        impl = getattr(psfd, name)
        monkeypatch.setattr(psfd, name, lambda *a, _f=impl, _n=name: ran.append(_n) or _f(*a))
    assert psfd.nms(dets, 0.3) == want and ran == ["nms_native"]
    monkeypatch.setattr(psfd, "load_native", lambda: None)
    assert psfd.nms(dets, 0.3) == want and ran == ["nms_native", "nms_numpy"]
    assert psfd.nms(np.zeros((0, 5)), 0.3) == []


def _nms_in_order(dets, order, thresh):
    """Greedy NMS (the reference's loop) visiting ``dets`` in ``order``."""
    keep, order = [], np.asarray(order)
    x1, y1, x2, y2 = (dets[:, i].astype(np.float64) for i in range(4))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        w = np.maximum(0.0, np.minimum(x2[i], x2[order[1:]]) - np.maximum(x1[i], x1[order[1:]]) + 1)
        h = np.maximum(0.0, np.minimum(y2[i], y2[order[1:]]) - np.maximum(y1[i], y1[order[1:]]) + 1)
        order = order[np.where(w * h / (areas[i] + areas[order[1:]] - w * h) <= thresh)[0] + 1]
    return keep


def test_native_nms_keeps_numpys_boxes_under_equal_scores():
    """Candidate sets with equal scores, as a detector's decode gives by
    chance (1 of 61 frames of a ProgGAN-1024 path on the card): the native NMS
    visits the boxes in numpy's argsort order, which is not a stable sort's,
    and keeps what the numpy NMS keeps. A stable order (the native NMS's
    earlier own sort) keeps other boxes in some of these sets."""
    from warpedganspace_torch.native import load_native, native_error

    lib = load_native()
    if lib is None:
        pytest.skip(f"no C++ toolchain: {native_error()}")
    rng = np.random.default_rng(40)
    stable_differs = 0
    for trial in range(20):
        dets = _dets(rng)
        dets[:, 4] = np.round(dets[:, 4] * 5) / 5          # six score values
        want = psfd.nms_numpy(dets, 0.3)
        assert psfd.nms_native(lib, dets, 0.3) == want, trial
        stable = np.argsort(dets[:, 4], kind="stable")[::-1]
        stable_differs += _nms_in_order(dets, stable, 0.3) != want
    assert stable_differs > 0


def test_loaders_read_the_reference_files(tmp_path, monkeypatch):
    """``write_pretrained`` puts the six files where the loaders look (AU and
    CelebA wrapped in {"state_dict": ...}); each loads with strict keys, and
    a bare AU dict loads too."""
    import torch.nn as nn

    from warpedganspace_torch.evalzoo import load as zoo
    from warpedganspace_torch.evalzoo.fabricate import write_pretrained

    sds = state_dicts()
    monkeypatch.chdir(tmp_path)
    paths = write_pretrained(".", sds)
    assert paths == {k: osp.join(".", zoo.PATHS[k]) for k in sds}
    assert "state_dict" in torch.load(zoo.PATHS["celeba"], weights_only=False)
    loaded = {"sfd": zoo.load_sfd().net, "arcface": zoo.load_arcface().net,
              "fairface": zoo.load_fairface(), "hopenet": zoo.load_hopenet(),
              "au_detector": zoo.load_audetector().net, "celeba": zoo.load_celeba()}
    for name, net in loaded.items():
        assert isinstance(net, nn.Module) and not net.training, name
        got = net.state_dict()
        assert got.keys() == sds[name].keys(), name
        assert all(torch.equal(got[k], sds[name][k]) for k in got), name
    torch.save(sds["au_detector"], zoo.PATHS["au_detector"])
    zoo.load_audetector()
    os.remove(zoo.PATHS["sfd"])
    with pytest.raises(FileNotFoundError, match="s3fd"):
        zoo.load_sfd()


def test_pose_estimator_matches_jax():
    from warpedganspace_tpu.evalzoo.hopenet import Hopenet as JHopenet
    from warpedganspace_tpu.evalzoo.pose_estimator import PoseEstimator as JPose
    from warpedganspace_torch.evalzoo.hopenet import Hopenet
    from warpedganspace_torch.evalzoo.pose_estimator import PoseEstimator

    sds = state_dicts()
    port = PoseEstimator(psfd.SFDDetector.from_state_dict(sds["sfd"]),
                         Hopenet.from_state_dict(sds["hopenet"]))
    jpose = JPose(jsfd.SFDDetector.from_state_dict(numpy_state_dict(sds["sfd"])),
                  JHopenet.from_state_dict(numpy_state_dict(sds["hopenet"])))
    x = images(40, 2, 128)
    for got, want in zip(port.detect_pose_batch(nchw(x)), jpose.detect_pose_batch(x)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
