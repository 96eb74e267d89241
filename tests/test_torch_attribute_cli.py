"""The port's attribute CLI against the JAX package's, on one small traversal tree.

A tree is fabricated as ``traverse_latent_space`` leaves it: ``args.json``,
one latent-code hash with ``paths_latent_codes.pt`` and 2 paths x 5 frames of
64² q75 JPEGs. Both CLIs' ``load_predictors`` are patched to the same
fabricated reference-layout state dicts (``evalzoo/fabricate.py``; the way
``tests/test_attribute_e2e.py`` patches the JAX CLI), and each CLI runs on its
own copy of the tree: the JAX package's ``main`` and the port's ``main
--no-cuda``. Both must write the same 26 ``eval_np`` and 12 ``eval_json``
files, with values at the gates of the reference oracle
(``tests/test_reference_attribute_oracle.py``: rtol 1e-2, atol 2e-3) and the
same argmaxes where a score is (argmax + max probability) / n. The case runs
for a StyleGAN2 tree and a ProgGAN one (the two CelebA normalisations), and
the detector's face bias is set so that one frame has no face, for the
reference's 256.0. A third case is one ProgGAN path at
``scripts/eval/proggan_full.sh``'s ``--eps 0.15 --shift-steps 30`` (config
``60_0.15_9.0``): 61 frames, whose CelebA input is min-max normalised over
the whole path, not over a render batch of 16. Its frames are those of the
two-path tree, to which the detector is fitted, each held for 7 frames, and
those of the second render batch of 16 at a lower contrast, so that the
batch does not span the path's range; the port's CLI runs it on 4 threads.
"""
import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from warpedganspace_tpu.cli import traverse_attribute_space as jcli
from warpedganspace_torch.cli import traverse_attribute_space as pcli
from warpedganspace_torch.evalzoo.fabricate import predictor_state_dicts
from warpedganspace_torch.evalzoo.load import CONFIGS_DIR
from warpedganspace_torch.evalzoo.sfd import SFDDetector, decode_batch
from warpedganspace_torch.traverse.images import save_jpeg
from warpedganspace_torch.utils.io import save_pt

torch.set_num_threads(1)

POOL, STEPS, EPS = "pool", 2, 0.2
CONFIG = f"{2 * STEPS}_{EPS}_{round(2 * STEPS * EPS, 3)}"
K, T, SIZE = 2, 2 * STEPS + 1, 64
# proggan_full.sh's path length: one path of 61 frames, each frame of the
# two-path tree held for LONG_HOLD of them.
LONG_STEPS, LONG_EPS, LONG_HOLD = 30, 0.15, 7
RTOL, ATOL = 1e-2, 2e-3
# Scores whose integer part is an argmax: (argmax + max prob) / n.
ARGMAX_N = {"age": 9, "race": 7, "celeba_bangs": 6, "celeba_eyeglasses": 6,
            "celeba_beard": 6, "celeba_smiling": 6, "celeba_age": 6}


def _frames(seed, k=K, t=T):
    """(k, t, SIZE, SIZE, 3) uint8: smooth random images drifting along each path."""
    rng = np.random.default_rng(seed)
    base = rng.random((k, 1, 8, 8, 3))
    drift = 0.3 * rng.random((k, t, 8, 8, 3)) * np.linspace(0, 1, t)[None, :, None, None, None]
    coarse = torch.from_numpy((base + drift).reshape(k * t, 8, 8, 3)).permute(0, 3, 1, 2)
    x = torch.nn.functional.interpolate(coarse, size=(SIZE, SIZE), mode="bicubic",
                                        align_corners=False).clamp(0, 1)
    return (255 * x).permute(0, 2, 3, 1).numpy().astype(np.uint8).reshape(k, t, SIZE, SIZE, 3)


def _long_frames():
    """(1, 61, SIZE, SIZE, 3): the two-path tree's frames, each held for
    LONG_HOLD, those of the second render batch of 16 in [16, 240] (every
    frame spans [0, 255])."""
    flat = _frames(0).reshape(K * T, SIZE, SIZE, 3)
    out = flat[[(i // LONG_HOLD) % (K * T) for i in range(2 * LONG_STEPS + 1)]]
    out[16:32] = 16 + (out[16:32].astype(np.float32) * (224 / 255)).round().astype(np.uint8)
    return out[None]


def make_tree(root, gan_type, seed=0, steps=STEPS, eps=EPS, frames=None):
    """The experiment directory and its one hash dir: ``frames`` (paths,
    frames, SIZE, SIZE, 3), by default K paths of ``2 steps + 1``."""
    from PIL import Image

    frames = _frames(seed, K, 2 * steps + 1) if frames is None else frames
    k, t = frames.shape[:2]
    config = f"{2 * steps}_{eps}_{round(2 * steps * eps, 3)}"
    exp = osp.join(root, "exp")
    h_dir = osp.join(exp, "results", POOL, config, "0123abcd")
    os.makedirs(h_dir)
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump({"gan_type": gan_type}, f)
    save_pt(np.zeros((k, t, 8), np.float32), osp.join(h_dir, "paths_latent_codes.pt"))
    for p in range(k):
        d = osp.join(h_dir, "paths_images", f"path_{p:03d}")
        os.makedirs(d)
        for i in range(t):
            save_jpeg(Image.fromarray(frames[p, i]), osp.join(d, f"{i:06d}.jpg"))
    os.makedirs(osp.join(exp, "results", POOL, config, "paths_gifs"))   # not a hash
    return exp, h_dir


def _path_frames256(h_dir):
    """The 256² frames of every path of a hash dir, as the port's host stage makes them."""
    from warpedganspace_torch.cli.traverse_attribute_space import _prep_path

    paths = sorted(os.listdir(osp.join(h_dir, "paths_images")))
    return torch.cat([_prep_path(osp.join(h_dir, "paths_images", p), "x")[0] for p in paths])


def _with_one_faceless_frame(sds, h_dir):
    """Lower the stride-4 face bias so that exactly the frame whose face logit
    is lowest falls under the 0.5 score, halfway between it and the next.
    Returns the state dicts and that frame's index (the paths' frames in order)."""
    det = SFDDetector.from_state_dict(sds["sfd"])
    f256 = _path_frames256(h_dir)
    tops = np.array([b[:, 4].max() for b in decode_batch(
        [m.numpy() for m in det.forward_maps(f256)])])
    top = np.sort(tops)
    logits = np.log(top / (1 - top))
    sds["sfd"]["conv3_3_norm_mbox_conf.bias"][3] -= float(logits[0] + logits[1]) / 2
    return sds, int(np.argmin(tops))


def _jax_predictors(sds):
    from warpedganspace_tpu.evalzoo.arcface import IDComparator
    from warpedganspace_tpu.evalzoo.celeba import CelebaAttrPredictor
    from warpedganspace_tpu.evalzoo.fairface import FairFace
    from warpedganspace_tpu.evalzoo.fanau import AUdetector
    from warpedganspace_tpu.evalzoo.hopenet import Hopenet
    from warpedganspace_tpu.evalzoo.sfd import SFDDetector as JSFD

    np_sd = {name: {k: v.numpy() for k, v in sd.items()} for name, sd in sds.items()}
    return {"sfd": JSFD.from_state_dict(np_sd["sfd"]),
            "id": IDComparator.from_state_dict(np_sd["arcface"], prefix=""),
            "fairface": FairFace.from_state_dict(np_sd["fairface"]),
            "hopenet": Hopenet.from_state_dict(np_sd["hopenet"]),
            "au": AUdetector.from_state_dict(np_sd["au_detector"]),
            "celeba": CelebaAttrPredictor.from_state_dict(
                np_sd["celeba"], osp.join(CONFIGS_DIR, "attributes_5.json"))}


def _port_predictors(sds):
    from warpedganspace_torch.evalzoo.arcface import IDComparator
    from warpedganspace_torch.evalzoo.celeba import celeba_attr_predictor
    from warpedganspace_torch.evalzoo.fairface import FairFace
    from warpedganspace_torch.evalzoo.fanau import AUdetector
    from warpedganspace_torch.evalzoo.hopenet import Hopenet

    return {"sfd": SFDDetector.from_state_dict(sds["sfd"]),
            "id": IDComparator.from_state_dict(sds["arcface"], prefix=""),
            "fairface": FairFace.from_state_dict(sds["fairface"]),
            "hopenet": Hopenet.from_state_dict(sds["hopenet"]),
            "au": AUdetector.from_state_dict(sds["au_detector"]),
            "celeba": celeba_attr_predictor(osp.join(CONFIGS_DIR, "attributes_5.json"),
                                            sds["celeba"])}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One fabricated weight set, its SFD heads fitted to the two-path tree's
    frames, one frame faceless; both packages' predictors built once (the JAX
    ones compile once for both trees), and the faceless frame's index."""
    _, h_dir = make_tree(str(tmp_path_factory.mktemp("calib")), "StyleGAN2")
    sds, faceless = _with_one_faceless_frame(
        predictor_state_dicts(seed=0, calibration=_path_frames256(h_dir)), h_dir)
    return _port_predictors(sds), _jax_predictors(sds), faceless


def _read(h_dir):
    np_dir, json_dir = osp.join(h_dir, "eval_np"), osp.join(h_dir, "eval_json")
    arrays = {f[:-4]: np.load(osp.join(np_dir, f)) for f in os.listdir(np_dir)}
    jsons = {}
    for f in os.listdir(json_dir):
        with open(osp.join(json_dir, f)) as fh:
            jsons[f[:-5]] = json.load(fh)
    return arrays, jsons


@pytest.mark.parametrize("gan_type, steps, eps", [
    pytest.param("StyleGAN2", STEPS, EPS, id="StyleGAN2"),
    pytest.param("ProgGAN", STEPS, EPS, id="ProgGAN"),
    pytest.param("ProgGAN", LONG_STEPS, LONG_EPS, id="ProgGAN-61-frames"),
])
def test_port_cli_matches_jax_cli(gan_type, steps, eps, weights, tmp_path, monkeypatch):
    port_preds, jax_preds, faceless_index = weights
    long = steps == LONG_STEPS
    frames = _long_frames() if long else None
    if long:
        # A render batch of 16 that does not span the path's range: a min-max
        # over it would give another CelebA input.
        whole = (frames.min(), frames.max())
        assert any((frames[0, i:i + 16].min(), frames[0, i:i + 16].max()) != whole
                   for i in range(0, frames.shape[1], 16))
    trees = {}
    for side in ("jax", "port"):
        exp, h_dir = make_tree(str(tmp_path / side), gan_type, steps=steps, eps=eps,
                               frames=frames)
        trees[side] = h_dir
        argv = ["--exp", exp, "--pool", POOL, "--shift-steps", str(steps), "--eps", str(eps)]
        if side == "jax":
            monkeypatch.setattr(jcli, "load_predictors", lambda: jax_preds)
            jcli.main(argv)
        else:
            monkeypatch.setattr(pcli, "load_predictors", lambda device: port_preds)
            threads = torch.get_num_threads()
            torch.set_num_threads(4 if long else threads)
            try:
                pcli.main(argv + ["--no-cuda"])
            finally:
                torch.set_num_threads(threads)
    k, t = (1, 2 * LONG_STEPS + 1) if long else (K, T)
    (j_np, j_json), (p_np, p_json) = _read(trees["jax"]), _read(trees["port"])
    assert sorted(p_np) == sorted(j_np) and len(p_np) == 26
    assert sorted(p_json) == sorted(j_json) and len(p_json) == 12
    worst = {}
    for name, want in j_np.items():
        got = p_np[name]
        assert got.shape == want.shape == (k, t), name
        assert np.isfinite(got).all() and np.isfinite(want).all(), name
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        if name in ARGMAX_N:
            assert np.array_equal(np.floor(got * ARGMAX_N[name]),
                                  np.floor(want * ARGMAX_N[name])), name
        worst[name] = float(np.abs(got - want).max())
    print(f"{gan_type}, {k} x {t} frames: worst abs difference by array: "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))
    # The frame without a face counts as 256.0 on both sides; the others have one.
    faceless = p_np["face_width"] == 256.0
    n_faceless = (sum((i // LONG_HOLD) % (K * T) == faceless_index for i in range(t))
                  if long else 1)
    assert faceless.sum() == n_faceless
    assert np.array_equal(faceless, j_np["face_width"] == 256.0)
    assert np.array_equal(p_np["face_height"] == 256.0, faceless)
    for d in range(k):
        pb, jb = p_json["face_bbox"][str(d)], j_json["face_bbox"][str(d)]
        assert len(pb) == len(jb) == t - int(faceless[d].sum())
        np.testing.assert_allclose(pb, jb, rtol=1e-4, atol=1e-3)
    for key in ("identity", "age", "race", "gender", "pose", "au", "celeba_smiling"):
        np.testing.assert_allclose(np.asarray(p_json[key]["0"]), np.asarray(j_json[key]["0"]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("argv, grouped, error", [
    (["--multi-device", "--num-shards", "2"], True, SystemExit),
    ([], True, SystemExit),
    (["--shard-index", "2", "--num-shards", "2"], False, ValueError),
    (["--num-shards", "0"], False, ValueError),
])
def test_refused_before_anything_is_read_or_written(argv, grouped, error, tmp_path,
                                                     monkeypatch):
    """Invalid splits and launches. A ``grouped`` case runs as rank 0 of a
    group of two, where the ranks split the ``(hash, path)`` pairs: manual
    shards would split them twice, and without ``--multi-device`` each rank
    would evaluate all."""
    exp, h_dir = make_tree(str(tmp_path), "StyleGAN2")
    before = sorted(os.walk(exp))
    if grouped:
        from warpedganspace_torch.parallel import mesh

        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        monkeypatch.setattr(mesh, "rank", lambda: 0)

    def refuse(device):
        raise AssertionError("predictors loaded")

    monkeypatch.setattr(pcli, "load_predictors", refuse)
    with pytest.raises(error):
        pcli.main(["--exp", exp, "--pool", POOL, "--eps", str(EPS), "--no-cuda"] + argv)
    assert sorted(os.walk(exp)) == before


def test_shards_partition_the_sorted_hashes(weights, tmp_path, monkeypatch):
    """Two shards of a three-hash config evaluate hashes [0, 2] and [1]."""
    exp, h_dir = make_tree(str(tmp_path), "StyleGAN2")
    config = osp.dirname(h_dir)
    for name in ("1aaa", "2bbb"):
        shutil.copytree(h_dir, osp.join(config, name))
    seen = []
    monkeypatch.setattr(pcli, "load_predictors", lambda device: weights[0])
    monkeypatch.setattr(pcli, "evaluate_hash_dir",
                        lambda h, *a, **k: seen.append(osp.basename(h)))
    for index in (0, 1):
        pcli.main(["--exp", exp, "--pool", POOL, "--eps", str(EPS), "--shift-steps",
                   str(STEPS), "--no-cuda", "--num-shards", "2", "--shard-index", str(index)])
    assert seen == ["0123abcd", "2bbb", "1aaa"]


def test_cuda_flag_needs_a_card(tmp_path, monkeypatch):
    exp, _ = make_tree(str(tmp_path), "StyleGAN2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["--exp", exp, "--pool", POOL, "--eps", str(EPS)])
