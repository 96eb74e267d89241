"""The port's traversal CLI against the JAX CLI: the same experiment, pool and
generator weights must give the same results tree.

The JAX ``sample_gan`` makes the pool; both ``traverse_latent_space`` CLIs
then walk a fabricated K=2 experiment, each with its ``build_gan`` patched to
one small W-space StyleGAN2 carrying the same weights. The gate is the one of
tests/test_reference_oracle.py: the same file set, latent codes within 5e-5,
and JPEG frames within a mean gray-level difference of 1 and a max of 24.
"""
import json
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_traverse import small_generators
from warpedganspace_tpu.cli import sample_gan as j_sample_gan
from warpedganspace_tpu.cli import traverse_latent_space as j_traverse
from warpedganspace_tpu.models.support_sets import SupportSets as JSupportSets
from warpedganspace_tpu.utils.io import load_pt, save_pt
from warpedganspace_torch.cli import sample_gan as t_sample_gan
from warpedganspace_torch.cli import traverse_latent_space as t_traverse

torch.set_num_threads(1)

K, STEPS, EPS, POOL = 2, 3, 0.2, "cli_pool"
RES_SUBDIR = osp.join("results", POOL, f"{2 * STEPS}_{EPS}_{round(2 * STEPS * EPS, 3)}")


def _file_set(root):
    out = set()
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            out.add(osp.normpath(osp.join(osp.relpath(dirpath, root), f)))
    return out


def _make_experiment(exp):
    os.makedirs(osp.join(exp, "models"), exist_ok=True)
    S = JSupportSets(num_support_sets=K, num_support_dipoles=8, support_vectors_dim=512,
                     learn_gammas=True)
    save_pt(S.to_torch_state_dict(S.init(jax.random.key(7))),
            osp.join(exp, "models", "support_sets-500.pt"))   # exercises the fallback
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump({"gan_type": "StyleGAN2", "num_support_sets": K, "num_support_dipoles": 8,
                   "learn_alphas": False, "learn_gammas": True, "gamma": None,
                   "shift_in_w_space": True, "stylegan2_resolution": 32}, f)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    jG, G = small_generators()
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        os.chdir(root)
        mp.setattr(j_sample_gan, "build_gan", lambda **kw: jG)
        mp.setattr(j_traverse, "build_gan", lambda **kw: jG)
        mp.setattr(t_traverse, "build_gan", lambda **kw: G.to(kw["device"]))
        j_sample_gan.main(["-g", "StyleGAN2", "--num-samples", "2", "--pool", POOL])
        for exp in ("exp_jax", "exp_torch"):
            _make_experiment(exp)
        argv = ["--pool", POOL, "--shift-steps", str(STEPS), "--eps", str(EPS),
                "--gif", "--gif-size", "32"]
        j_traverse.main(["--exp", "exp_jax"] + argv)
        t_traverse.main(["--exp", "exp_torch", "--no-cuda"] + argv)
    finally:
        os.chdir(cwd)
        mp.undo()
    return osp.join(root, "exp_jax", RES_SUBDIR), osp.join(root, "exp_torch", RES_SUBDIR)


def test_same_file_set(trees):
    ours, ref = trees
    files = _file_set(ours)
    assert files == _file_set(ref)
    n_frames = 2 * STEPS + 1
    assert sum(f.endswith(".jpg") for f in files) == 2 * (K * n_frames + 1)
    assert {f for f in files if f.endswith(".gif")} == {
        osp.join("paths_gifs", f"path_{k:03d}.gif") for k in range(K)}


def test_latent_codes_match(trees):
    ours, ref = trees
    hashes = sorted(d for d in os.listdir(ours) if d != "paths_gifs")
    assert len(hashes) == 2
    for h in hashes:
        a = np.asarray(load_pt(osp.join(ours, h, "paths_latent_codes.pt")))
        b = np.asarray(load_pt(osp.join(ref, h, "paths_latent_codes.pt")))
        assert a.shape == b.shape == (K, 2 * STEPS + 1, 512)
        # f32 drift over 3 normalised-gradient steps; the reference oracle's bound.
        assert float(np.max(np.abs(a - b))) < 5e-5


def test_frames_match(trees):
    ours, ref = trees
    worst_mean, worst_max, n = 0.0, 0, 0
    for dirpath, _, filenames in os.walk(ref):
        for f in filenames:
            if not f.endswith(".jpg"):
                continue
            rel = osp.relpath(osp.join(dirpath, f), ref)
            a = np.asarray(Image.open(osp.join(ours, rel)), dtype=np.int16)
            b = np.asarray(Image.open(osp.join(ref, rel)), dtype=np.int16)
            assert a.shape == b.shape == (32, 32, 3)
            diff = np.abs(a - b)
            worst_mean, worst_max = max(worst_mean, float(diff.mean())), max(worst_max,
                                                                             int(diff.max()))
            n += 1
    assert n == 2 * (K * (2 * STEPS + 1) + 1)
    # A one-level flip at a block edge ripples through the 8x8 JPEG DCT:
    # the bound of tests/test_reference_oracle.py.
    assert worst_mean < 1.0, worst_mean
    assert worst_max <= 24, worst_max


BK, BSTEPS, BEPS, BPOOL = 3, 2, 0.15, "biggan_pool"
BRES_SUBDIR = osp.join("results", BPOOL, f"{2 * BSTEPS}_{BEPS}_{round(2 * BSTEPS * BEPS, 3)}")


def _make_biggan_experiment(exp):
    os.makedirs(osp.join(exp, "models"), exist_ok=True)
    S = JSupportSets(num_support_sets=BK, num_support_dipoles=8, support_vectors_dim=120,
                     learn_gammas=True)
    save_pt(S.to_torch_state_dict(S.init(jax.random.key(11))),
            osp.join(exp, "models", "support_sets.pt"))
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump({"gan_type": "BigGAN", "biggan_target_classes": [239], "num_support_sets": BK,
                   "num_support_dipoles": 8, "learn_alphas": False, "learn_gammas": True,
                   "gamma": None}, f)


@pytest.fixture(scope="module")
def biggan_trees(tmp_path_factory):
    """The port's ``sample_gan`` makes the BigGAN pool (under ``BigGAN-239``);
    both traversal CLIs then walk the same fabricated K=3 experiment, each
    with its ``build_gan`` patched to one small BigGAN of the same weights."""
    from tests.test_torch_traverse import small_biggan_bundles

    root = str(tmp_path_factory.mktemp("cli_biggan"))
    jG, G = small_biggan_bundles()
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        os.chdir(root)
        mp.setattr(t_sample_gan, "build_gan", lambda **kw: G.to(kw["device"]))
        mp.setattr(j_traverse, "build_gan", lambda **kw: jG)
        mp.setattr(t_traverse, "build_gan", lambda **kw: G.to(kw["device"]))
        t_sample_gan.main(["-g", "BigGAN", "--biggan-target-classes", "239", "--num-samples", "2",
                           "--pool", BPOOL, "--no-cuda"])
        for exp in ("exp_jax", "exp_torch"):
            _make_biggan_experiment(exp)
        argv = ["--pool", BPOOL, "--shift-steps", str(BSTEPS), "--eps", str(BEPS),
                "--batch-size", "4"]
        j_traverse.main(["--exp", "exp_jax"] + argv)
        t_traverse.main(["--exp", "exp_torch", "--no-cuda"] + argv)
    finally:
        os.chdir(cwd)
        mp.undo()
    return root


def test_biggan_cli_trees_match(biggan_trees):
    root = biggan_trees
    pool = osp.join(root, "experiments", "latent_codes", "BigGAN-239", BPOOL)
    hashes = sorted(d for d in os.listdir(pool) if osp.isdir(osp.join(pool, d)))
    assert len(hashes) == 2 and osp.isfile(osp.join(pool, "args.json"))
    for h in hashes:
        assert np.asarray(load_pt(osp.join(pool, h, "latent_code.pt"))).shape == (1, 120)
        assert Image.open(osp.join(pool, h, "image.jpg")).size == (32, 32)

    ref, ours = (osp.join(root, e, BRES_SUBDIR) for e in ("exp_jax", "exp_torch"))
    files = _file_set(ours)
    assert files == _file_set(ref)
    n_frames = 2 * BSTEPS + 1
    assert sum(f.endswith(".jpg") for f in files) == 2 * (BK * n_frames + 1)
    assert sorted(os.listdir(ours)) == hashes
    worst_mean, worst_max = 0.0, 0
    for rel in files:
        if rel.endswith(".pt"):
            a = np.asarray(load_pt(osp.join(ours, rel)))
            b = np.asarray(load_pt(osp.join(ref, rel)))
            assert a.shape == b.shape == (BK, n_frames, 120)
            # f32 drift over 2 normalised-gradient steps.
            assert float(np.max(np.abs(a - b))) < 1e-4
        else:
            a = np.asarray(Image.open(osp.join(ours, rel)), dtype=np.int16)
            b = np.asarray(Image.open(osp.join(ref, rel)), dtype=np.int16)
            assert a.shape == b.shape == (32, 32, 3)
            diff = np.abs(a - b)
            worst_mean = max(worst_mean, float(diff.mean()))
            worst_max = max(worst_max, int(diff.max()))
    # The JPEG bound of tests/test_reference_oracle.py, as for StyleGAN2 above.
    assert worst_mean < 1.0, worst_mean
    assert worst_max <= 24, worst_max


PK, PSTEPS, PEPS, PPOOL = 3, 2, 0.15, "proggan_pool"
PRES_SUBDIR = osp.join("results", PPOOL, f"{2 * PSTEPS}_{PEPS}_{round(2 * PSTEPS * PEPS, 3)}")


def _make_proggan_experiment(exp):
    os.makedirs(osp.join(exp, "models"), exist_ok=True)
    S = JSupportSets(num_support_sets=PK, num_support_dipoles=8, support_vectors_dim=128,
                     learn_gammas=True)
    save_pt(S.to_torch_state_dict(S.init(jax.random.key(13))),
            osp.join(exp, "models", "support_sets.pt"))
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump({"gan_type": "ProgGAN", "num_support_sets": PK, "num_support_dipoles": 8,
                   "learn_alphas": False, "learn_gammas": True, "gamma": None}, f)


@pytest.fixture(scope="module")
def proggan_trees(tmp_path_factory):
    """The port's ``sample_gan -g ProgGAN`` makes the pool (under ``ProgGAN``);
    both traversal CLIs then walk the same fabricated K=3 experiment, each
    with its ``build_gan`` patched to one small ProgGAN of the same weights
    (the JAX one with its fused tail kernel in interpret mode)."""
    from tests.test_torch_traverse import small_proggan_bundles

    root = str(tmp_path_factory.mktemp("cli_proggan"))
    jG, G = small_proggan_bundles()
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        os.chdir(root)
        mp.setattr(t_sample_gan, "build_gan", lambda **kw: G.to(kw["device"]))
        mp.setattr(j_traverse, "build_gan", lambda **kw: jG)
        mp.setattr(t_traverse, "build_gan", lambda **kw: G.to(kw["device"]))
        t_sample_gan.main(["-g", "ProgGAN", "--num-samples", "2", "--pool", PPOOL, "--no-cuda"])
        for exp in ("exp_jax", "exp_torch"):
            _make_proggan_experiment(exp)
        argv = ["--pool", PPOOL, "--shift-steps", str(PSTEPS), "--eps", str(PEPS),
                "--batch-size", "4"]
        j_traverse.main(["--exp", "exp_jax"] + argv)
        t_traverse.main(["--exp", "exp_torch", "--no-cuda"] + argv)
    finally:
        os.chdir(cwd)
        mp.undo()
    return root


def test_proggan_cli_trees_match(proggan_trees):
    root = proggan_trees
    pool = osp.join(root, "experiments", "latent_codes", "ProgGAN", PPOOL)
    hashes = sorted(d for d in os.listdir(pool) if osp.isdir(osp.join(pool, d)))
    assert len(hashes) == 2 and osp.isfile(osp.join(pool, "args.json"))
    for h in hashes:
        assert np.asarray(load_pt(osp.join(pool, h, "latent_code.pt"))).shape == (1, 128)
        assert Image.open(osp.join(pool, h, "image.jpg")).size == (64, 64)

    ref, ours = (osp.join(root, e, PRES_SUBDIR) for e in ("exp_jax", "exp_torch"))
    files = _file_set(ours)
    assert files == _file_set(ref)
    n_frames = 2 * PSTEPS + 1
    assert sum(f.endswith(".jpg") for f in files) == 2 * (PK * n_frames + 1)
    assert sorted(os.listdir(ours)) == hashes
    worst_mean, worst_max = 0.0, 0
    for rel in files:
        if rel.endswith(".pt"):
            a = np.asarray(load_pt(osp.join(ours, rel)))
            b = np.asarray(load_pt(osp.join(ref, rel)))
            assert a.shape == b.shape == (PK, n_frames, 128)
            # f32 drift over 2 normalised-gradient steps.
            assert float(np.max(np.abs(a - b))) < 1e-4
        else:
            a = np.asarray(Image.open(osp.join(ours, rel)), dtype=np.int16)
            b = np.asarray(Image.open(osp.join(ref, rel)), dtype=np.int16)
            assert a.shape == b.shape == (64, 64, 3)
            diff = np.abs(a - b)
            worst_mean = max(worst_mean, float(diff.mean()))
            worst_max = max(worst_max, int(diff.max()))
    # The JPEG bound of tests/test_reference_oracle.py, as for StyleGAN2 and BigGAN above.
    assert worst_mean < 1.0, worst_mean
    assert worst_max <= 24, worst_max


def test_biggan_needs_target_classes():
    with pytest.raises(SystemExit):
        t_sample_gan.main(["-g", "BigGAN", "--num-samples", "1", "--no-cuda"])


def test_cuda_flag_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sample_gan.select_device(True)
    assert t_sample_gan.select_device(False) == torch.device("cpu")


def test_port_sample_gan_pool(tmp_path, monkeypatch):
    from hashlib import sha1

    _, G = small_generators()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_sample_gan, "build_gan", lambda **kw: G.to(kw["device"]))
    t_sample_gan.main(["-g", "StyleGAN2", "--num-samples", "2", "--pool", "p", "--no-cuda"])
    pool = osp.join("experiments", "latent_codes", "StyleGAN2", "p")
    hashes = sorted(d for d in os.listdir(pool) if osp.isdir(osp.join(pool, d)))
    assert len(hashes) == 2 and osp.isfile(osp.join(pool, "args.json"))
    for h in hashes:
        z = np.asarray(load_pt(osp.join(pool, h, "latent_code.pt")))
        assert z.shape == (1, 512) and z.dtype == np.float32
        assert sha1(z).hexdigest() == h
        assert Image.open(osp.join(pool, h, "image.jpg")).size == (32, 32)


def test_build_gan_rules(tmp_path):
    from warpedganspace_torch.models.gan_load import build_gan

    for gan_type in ("SNGAN_MNIST", "SNGAN_AnimeFaces"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_gan(gan_type, weights_root=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        build_gan("ProgGAN", weights_root=str(tmp_path), allow_random_init=False)
    with pytest.raises(ValueError, match="unknown GAN type"):
        build_gan("NoSuchGAN", weights_root=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        build_gan("StyleGAN2", stylegan2_resolution=256, weights_root=str(tmp_path),
                  allow_random_init=False)
    # Random weights come from a seeded generator: two builds agree.
    G1, G2 = (build_gan("StyleGAN2", stylegan2_resolution=256, shift_in_w_space=True,
                        weights_root=str(tmp_path), allow_random_init=True,
                        device="cpu") for _ in range(2))
    assert G1.dim_z == 512 and G1.resolution == 256 and G1.shift_in_w_space
    for (name, a), (_, b) in zip(G1.state_dict().items(), G2.state_dict().items()):
        assert torch.equal(a, b), name
    assert not any(p.requires_grad for p in G1.parameters())


def test_build_gan_proggan(tmp_path, monkeypatch):
    """``build_gan('ProgGAN')`` reads the reference ``.pth`` layout from the
    registry's path; without the file it builds seeded random weights when
    allowed. The chain is cut to the tiny one: full width is 23 M parameters
    and a 1024^2 forward, too much for the CPU suite."""
    from tests.test_torch_proggan import TINY_CH, _jax_image, _latents, fabricate_proggan_sd
    from warpedganspace_tpu.convert.torch_import import proggan_params_from_state_dict
    from warpedganspace_torch.config import GAN_WEIGHTS
    from warpedganspace_torch.models import proggan as t_proggan
    from warpedganspace_torch.models.gan_load import build_gan

    real_init = t_proggan.ProgGANGenerator.__init__
    monkeypatch.setattr(
        t_proggan.ProgGANGenerator, "__init__",
        lambda self, **kw: real_init(self, dim_z=TINY_CH[0], channels=TINY_CH, **kw))
    G1, G2 = (build_gan("ProgGAN", weights_root=str(tmp_path), allow_random_init=True,
                        device="cpu") for _ in range(2))
    assert (G1.name, G1.dim_z, G1.resolution, G1.shift_in_w_space) == ("ProgGAN", 128, 64, False)
    for (name, a), (_, b) in zip(G1.state_dict().items(), G2.state_dict().items()):
        assert torch.equal(a, b), name               # random weights from a seed
    assert not any(p.requires_grad for p in G1.parameters())

    sd = fabricate_proggan_sd(TINY_CH, seed=15)
    path = tmp_path / GAN_WEIGHTS["ProgGAN"]["weights"][1024]
    os.makedirs(path.parent)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    G = build_gan("ProgGAN", weights_root=str(tmp_path), device="cpu")
    z, shift = _latents(16, 2, 128)
    ref = _jax_image(proggan_params_from_state_dict(sd), z, shift, "pallas")
    with torch.no_grad():
        img = G(torch.from_numpy(z), torch.from_numpy(shift)).numpy()   # the bundle's call
    np.testing.assert_allclose(img, ref, rtol=6e-5, atol=6e-5)
