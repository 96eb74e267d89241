"""The port's traversal CLI against the JAX CLI: the same experiment, pool and
generator weights must give the same results tree.

The JAX ``sample_gan`` makes the pool; both ``traverse_latent_space`` CLIs
then walk a fabricated K=2 experiment, each with its ``build_gan`` patched to
one small W-space StyleGAN2 carrying the same weights. The gate is the one of
tests/test_reference_oracle.py: the same file set, latent codes within 5e-5,
and JPEG frames within a mean gray-level difference of 1 and a max of 24.

The training CLIs follow (the last section): both ``cli.train``s with the same
flags on one small BigGAN write the same experiment tree; the port resumes its
own and the JAX trainer's checkpoint, and traverses the trees both trained.
On a small SNGAN-MNIST-shaped generator both packages run ``train`` with
``--steps-per-call``, ``checkpoint2model`` and ``traverse_latent_space`` and
write the same trees; the port's chunked run equals its unchunked one.
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

    for gan_type in ("SNGAN_MNIST", "SNGAN_AnimeFaces", "ProgGAN"):
        with pytest.raises(FileNotFoundError):
            build_gan(gan_type, weights_root=str(tmp_path), allow_random_init=False)
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


# ------------------------------------------------------------------ training
TK, TD = 3, 4
TRAIN_BASE = ["--gan-type", "BigGAN", "--biggan-target-classes", "239",
              "--reconstructor-type", "ResNet", "-K", str(TK), "-D", str(TD), "--learn-gammas",
              "--min-shift-magnitude", "0.1", "--max-shift-magnitude", "0.2",
              "--batch-size", "4", "--log-freq", "2"]
TRAIN_FLAGS = TRAIN_BASE + ["--ckp-freq", "2"]
TRAIN_EXP = "BigGAN-239-ResNet-K3-D4-LearnGammas-eps0.1_0.2"


def _shapes(tree):
    """Nested dict of arrays -> {path: shape}; scalars map to ()."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = tuple(np.shape(x))
    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def train_trees(tmp_path_factory):
    """Both training CLIs with the same flags, each in a root of its own and
    with its ``build_gan`` patched to one small BigGAN of the same weights."""
    from tests.test_torch_traverse import small_biggan_bundles
    from warpedganspace_tpu.cli import train as j_train
    from warpedganspace_torch.cli import train as t_train

    jG, G = small_biggan_bundles()
    roots = {name: str(tmp_path_factory.mktemp(f"train_{name}")) for name in ("jax", "torch")}
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        mp.setattr(j_train, "build_gan", lambda **kw: jG)
        mp.setattr(t_train, "build_gan", lambda **kw: G.to(kw["device"]))
        os.chdir(roots["jax"])
        j_train.main(TRAIN_FLAGS + ["--max-iter", "4"])
        os.chdir(roots["torch"])
        t_train.main(TRAIN_FLAGS + ["--max-iter", "4", "--no-cuda"])
    finally:
        os.chdir(cwd)
        mp.undo()
    return roots, G


def test_train_cli_trees_match(train_trees):
    roots, _ = train_trees
    exps = {k: osp.join(r, "experiments") for k, r in roots.items()}
    assert _file_set(exps["torch"]) == _file_set(exps["jax"])
    files = _file_set(osp.join(exps["torch"], "wip", TRAIN_EXP))
    assert files == {"args.json", "command.sh", "stats.json"} | {
        osp.join("models", f) for f in ("support_sets_init.pt", "checkpoint.pt",
                                        "optimizer_state.npz", "support_sets.pt",
                                        "reconstructor.pt")}
    assert _file_set(osp.join(exps["torch"], "complete", TRAIN_EXP)) == files - {
        osp.join("models", "checkpoint.pt")}

    for rel in ("checkpoint.pt", "support_sets.pt", "support_sets_init.pt", "reconstructor.pt"):
        ours, ref = (_shapes(load_pt(osp.join(e, "wip", TRAIN_EXP, "models", rel)))
                     for e in (exps["torch"], exps["jax"]))
        assert ours == ref, rel
    ckpt = load_pt(osp.join(exps["torch"], "wip", TRAIN_EXP, "models", "checkpoint.pt"))
    assert ckpt["iter"] == 4 and set(ckpt) == {"iter", "support_sets", "reconstructor"}
    assert ckpt["support_sets"]["SUPPORT_SETS"].shape == (TK, 2 * TD * 120)

    def loaded(e, name):
        with open(osp.join(e, "wip", TRAIN_EXP, name)) as f:
            return json.load(f)

    ours, ref = (loaded(e, "args.json") for e in (exps["torch"], exps["jax"]))
    assert set(ref) == set(ours)                 # the JAX CLI's whole flag surface
    assert all(ours[k] == ref[k] for k in ours if k != "cuda")
    ours, ref = (loaded(e, "stats.json") for e in (exps["torch"], exps["jax"]))
    assert set(ours) == set(ref) == {"2", "4"}
    assert set(ours["4"]) == set(ref["4"]) == {"accuracy", "classification_loss",
                                               "regression_loss", "total_loss"}
    assert all(np.isfinite(v) for row in ours.values() for v in row.values())


def test_train_cli_moves_what_trains(train_trees):
    roots, _ = train_trees
    models = osp.join(roots["torch"], "experiments", "complete", TRAIN_EXP, "models")
    init, final = (load_pt(osp.join(models, f)) for f in ("support_sets_init.pt",
                                                          "support_sets.pt"))
    assert np.abs(final["SUPPORT_SETS"] - init["SUPPORT_SETS"]).max() > 0
    assert np.abs(final["LOGGAMMA"] - init["LOGGAMMA"]).max() > 0      # --learn-gammas
    np.testing.assert_array_equal(final["ALPHAS"], init["ALPHAS"])     # frozen


def test_train_cli_resume_and_early_exit(train_trees, tmp_path, monkeypatch, capsys):
    """A run that finds a checkpoint restarts at its iteration, as the
    reference does (so that iteration runs again), with the Adam moments, the
    BatchNorm statistics and the batch stream of the run that wrote it: it
    ends where the same steps taken by hand in one go end. Run again, the
    completed experiment exits at once."""
    from warpedganspace_torch.cli import train as t_train
    from warpedganspace_torch.models.reconstructor import Reconstructor
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.train.train_step import (TrainStepConfig, init_train_state,
                                                       train_step)

    _, G = train_trees
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_train, "build_gan", lambda **kw: G.to(kw["device"]))
    flags = TRAIN_BASE + ["--ckp-freq", "3", "--seed", "7", "--no-cuda"]
    t_train.main(flags + ["--max-iter", "3"])
    capsys.readouterr()
    t_train.main(flags + ["--max-iter", "6"])
    assert "Start training from iteration 3" in capsys.readouterr().out
    resumed = load_pt(osp.join("experiments", "wip", TRAIN_EXP, "models", "support_sets.pt"))

    init_gen = torch.Generator().manual_seed(7)
    S = SupportSets(TK, TD, 120, learn_gammas=True, generator=init_gen)
    R = Reconstructor("ResNet", dim=TK, generator=init_gen)
    state = init_train_state(G, S, R, TrainStepConfig(
        batch_size=4, num_support_sets=TK, min_shift_magnitude=0.1, max_shift_magnitude=0.2),
        seed=7)
    for it in (1, 2, 3, 3, 4, 5, 6):
        train_step(state, it)
    by_hand = S.to_torch_state_dict()
    for key in ("SUPPORT_SETS", "LOGGAMMA"):
        np.testing.assert_allclose(resumed[key], by_hand[key].numpy(), rtol=0, atol=1e-6)

    with pytest.raises(SystemExit):
        t_train.main(flags + ["--max-iter", "6"])
    assert "already been completed" in capsys.readouterr().out


def test_train_cli_resumes_the_jax_trainers_checkpoint(train_trees, monkeypatch, capsys):
    """checkpoint.pt is the reference's format, so the port picks up the JAX
    trainer's; that trainer's optimizer sidecar is not the port's, which warns
    and resets the Adam moments."""
    from warpedganspace_torch.cli import train as t_train

    roots, G = train_trees
    monkeypatch.chdir(roots["jax"])
    monkeypatch.setattr(t_train, "build_gan", lambda **kw: G.to(kw["device"]))
    t_train.main(TRAIN_FLAGS + ["--max-iter", "5", "--no-cuda"])
    out = capsys.readouterr().out
    assert "Start training from iteration 4" in out
    assert "could not restore optimizer sidecar" in out and "Adam moments reset" in out
    ckpt = load_pt(osp.join("experiments", "wip", TRAIN_EXP, "models", "checkpoint.pt"))
    assert ckpt["iter"] == 4                      # --ckp-freq 2: iteration 5 wrote none


def test_port_traverses_trained_trees(train_trees, monkeypatch):
    """The port's traversal walks the tree the port trained, and one that the
    JAX trainer wrote."""
    roots, G = train_trees
    monkeypatch.setattr(t_sample_gan, "build_gan", lambda **kw: G.to(kw["device"]))
    monkeypatch.setattr(t_traverse, "build_gan", lambda **kw: G.to(kw["device"]))
    for name in ("torch", "jax"):
        monkeypatch.chdir(roots[name])
        t_sample_gan.main(["-g", "BigGAN", "--biggan-target-classes", "239", "--num-samples", "1",
                           "--pool", "trained", "--no-cuda"])
        exp = osp.join("experiments", "complete", TRAIN_EXP)
        t_traverse.main(["--exp", exp, "--pool", "trained", "--shift-steps", "2", "--eps", "0.15",
                         "--no-cuda"])
        out = osp.join(exp, "results", "trained", "4_0.15_0.6")
        (code,) = os.listdir(out)
        codes = np.asarray(load_pt(osp.join(out, code, "paths_latent_codes.pt")))
        assert codes.shape == (TK, 5, 120) and np.isfinite(codes).all()
        frames = [f for f in _file_set(osp.join(out, code)) if f.endswith(".jpg")]
        assert len(frames) == TK * 5 + 1


def test_train_cli_rules(tmp_path, monkeypatch):
    from warpedganspace_torch.cli import train as t_train

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):                       # -K and -D are required
        t_train.main(["--gan-type", "BigGAN", "--biggan-target-classes", "239", "--no-cuda"])
    with pytest.raises(SystemExit):                       # BigGAN needs its classes
        t_train.main(["--gan-type", "BigGAN", "-K", "2", "-D", "2", "--no-cuda"])
    with pytest.raises(SystemExit):                       # 3 does not divide the frequencies
        t_train.main(TRAIN_FLAGS + ["--steps-per-call", "3", "--no-cuda"])
    with pytest.raises(SystemExit):
        t_train.main(TRAIN_FLAGS + ["--steps-per-call", "0", "--no-cuda"])
    assert not osp.exists("experiments")                  # nothing was written
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(TRAIN_FLAGS + ["--max-iter", "1"])   # --cuda is the default


@pytest.mark.parametrize("flag", [["--checkpoint-backend", "orbax"], ["--multi-device"]])
def test_train_cli_rejects_jax_only_flags_before_writing(flag, tmp_path, monkeypatch, capsys):
    """The JAX package's orbax checkpoints, and its data parallelism over the
    cards of one process (here one process that sees two cards), are refused
    before the experiment directory exists, so the failed launch leaves no
    tree behind; the refusal names the port's route, one process per card."""
    from warpedganspace_torch.cli import train as t_train

    monkeypatch.chdir(tmp_path)
    extra = ["--no-cuda"]
    if "--multi-device" in flag:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        extra = []
    with pytest.raises(SystemExit):
        t_train.main(TRAIN_FLAGS + flag + extra)
    assert ("orbax" if "orbax" in flag else "torchrun") in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("script", ["mnist", "anime", "stylegan2", "proggan", "biggan"])
def test_train_scripts_run_against_the_port(script, tmp_path, monkeypatch):
    """Each ``scripts/train/<script>.sh`` command line, with ``python
    train.py`` replaced by the port's module, passes every check the CLI makes
    before it picks a device (which here stops the run, before anything is
    written)."""
    import shlex

    from warpedganspace_torch.cli import train as t_train

    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(repo, "scripts", "train", f"{script}.sh")) as f:
        (line,) = [ln for ln in f if ln.startswith("python train.py")]
    argv = shlex.split(line)[2:]

    class Reached(Exception):
        pass

    def stop(cuda):
        assert cuda
        raise Reached

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_train, "select_device", stop)
    with pytest.raises(Reached):
        t_train.main(argv)
    assert os.listdir(tmp_path) == []
    args = t_train.build_parser().parse_args(argv)
    assert args.steps_per_call == (10 if script in ("mnist", "anime") else 1)
    assert args.pair_layout == ("s2d" if script in ("stylegan2", "proggan") else "auto")


# --------------------------------------------------- SNGAN: --steps-per-call, checkpoint2model
SK, SD = 3, 4
SNGAN_BASE = ["--gan-type", "SNGAN_MNIST", "--reconstructor-type", "LeNet", "-K", str(SK),
              "-D", str(SD), "--learn-gammas", "--min-shift-magnitude", "0.15",
              "--max-shift-magnitude", "0.25", "--batch-size", "4"]
SNGAN_FLAGS = SNGAN_BASE + ["--steps-per-call", "2", "--log-freq", "2", "--ckp-freq", "2",
                            "--max-iter", "4"]
SNGAN_EXP = "SNGAN_MNIST-LeNet-K3-D4-LearnGammas-eps0.15_0.25"


@pytest.fixture(scope="module")
def sngan_trees(tmp_path_factory):
    """Both packages, each in a root of its own with its ``build_gan`` patched
    to one small SNGAN of the same weights: the JAX ``sample_gan`` makes a
    pool, ``train`` runs chunked (2 steps a call), ``checkpoint2model`` splits
    the checkpoint, and ``traverse_latent_space`` walks the tree without its
    final ``support_sets.pt`` (an interrupted run), so that it reads the
    split file."""
    from tests.test_torch_sngan import small_sngan_bundles
    from warpedganspace_tpu.cli import checkpoint2model as j_c2m
    from warpedganspace_tpu.cli import train as j_train
    from warpedganspace_torch.cli import checkpoint2model as t_c2m
    from warpedganspace_torch.cli import train as t_train

    jG, G = small_sngan_bundles(seed=2)
    roots = {name: str(tmp_path_factory.mktemp(f"sngan_{name}")) for name in ("jax", "torch")}
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    traverse = ["--pool", "p", "--shift-steps", "2", "--eps", "0.2", "--batch-size", "4"]
    exp = osp.join("experiments", "wip", SNGAN_EXP)
    try:
        for mod in (j_sample_gan, j_train, j_traverse):
            mp.setattr(mod, "build_gan", lambda **kw: jG)
        for mod in (t_train, t_traverse):
            mp.setattr(mod, "build_gan", lambda **kw: G.to(kw["device"]))
        for name, train, c2m, trav, extra in (
                ("jax", j_train, j_c2m, j_traverse, []),
                ("torch", t_train, t_c2m, t_traverse, ["--no-cuda"])):
            os.chdir(roots[name])
            j_sample_gan.main(["-g", "SNGAN_MNIST", "--num-samples", "1", "--pool", "p"])
            train.main(SNGAN_FLAGS + extra)
            c2m.main(["--exp", exp])
            os.remove(osp.join(exp, "models", "support_sets.pt"))
            trav.main(["--exp", exp] + traverse + extra)
    finally:
        os.chdir(cwd)
        mp.undo()
    return roots


def test_sngan_cli_trees_match(sngan_trees):
    exps = {k: osp.join(r, "experiments") for k, r in sngan_trees.items()}
    files = _file_set(exps["torch"])
    assert files == _file_set(exps["jax"])
    wip = osp.join("wip", SNGAN_EXP)
    models = {osp.join(wip, "models", f) for f in (
        "support_sets_init.pt", "checkpoint.pt", "optimizer_state.npz", "reconstructor.pt",
        "support_sets-4.pt", "reconstructor-4.pt")}
    assert models <= files and osp.join(wip, "models", "support_sets.pt") not in files
    assert osp.join("complete", SNGAN_EXP, "models", "support_sets.pt") in files
    for rel in ("checkpoint.pt", "support_sets-4.pt", "reconstructor-4.pt", "reconstructor.pt"):
        ours, ref = (load_pt(osp.join(e, wip, "models", rel)) for e in exps.values())
        assert _shapes(ours) == _shapes(ref), rel
    ckpt = load_pt(osp.join(exps["torch"], wip, "models", "checkpoint.pt"))
    split = load_pt(osp.join(exps["torch"], wip, "models", "support_sets-4.pt"))
    assert ckpt["iter"] == 4
    for key, v in ckpt["support_sets"].items():
        np.testing.assert_array_equal(split[key], v)
    r_split = load_pt(osp.join(exps["torch"], wip, "models", "reconstructor-4.pt"))
    assert all(np.array_equal(r_split[k], v) for k, v in ckpt["reconstructor"].items())
    with open(osp.join(exps["torch"], wip, "stats.json")) as f:
        assert set(json.load(f)) == {"2", "4"}

    (code,) = [d for d in os.listdir(osp.join(exps["torch"], wip, "results", "p", "4_0.2_0.8"))]
    out = osp.join(exps["torch"], wip, "results", "p", "4_0.2_0.8", code)
    codes = np.asarray(load_pt(osp.join(out, "paths_latent_codes.pt")))
    assert codes.shape == (SK, 5, 128) and np.isfinite(codes).all()
    # The sets are those the checkpoint holds: the center is the pool's code,
    # and every other code moved.
    assert np.abs(codes[:, 0] - codes[:, 2]).max() > 0
    frame = Image.open(osp.join(out, "paths_images", "path_000", "000000.jpg"))
    assert frame.size == (32, 32) and frame.mode == "L"


def test_sngan_chunked_run_equals_unchunked(tmp_path, monkeypatch):
    """``--steps-per-call 3`` over 10 iterations with a resume: the first run
    stops at 4 (a chunk, then the lone iteration 4), the second resumes at the
    checkpoint of iteration 3 (re-run alone), then chunks 4-6 and 7-9, then
    the lone 10. On the CPU a chunk is three eager steps, so the sets, the
    statistics and the checkpoints equal those of the same runs with one step
    a call, bit for bit."""
    from tests.test_torch_sngan import small_sngan_bundles
    from warpedganspace_torch.cli import train as t_train
    from warpedganspace_torch.train.train_step import StepChunk

    _, G = small_sngan_bundles(seed=4)
    monkeypatch.setattr(t_train, "build_gan", lambda **kw: G.to(kw["device"]))
    chunks = []
    real_call = StepChunk.__call__

    def spy(self, iteration):
        chunks.append((self.k, iteration))
        return real_call(self, iteration)

    monkeypatch.setattr(StepChunk, "__call__", spy)
    flags = SNGAN_BASE + ["--log-freq", "3", "--ckp-freq", "3", "--no-cuda"]
    trees = {}
    for k in (1, 3):
        root = tmp_path / f"k{k}"
        root.mkdir()
        monkeypatch.chdir(root)
        for max_iter in (4, 10):
            t_train.main(flags + ["--steps-per-call", str(k), "--max-iter", str(max_iter)])
        trees[k] = osp.join(str(root), "experiments", "wip", SNGAN_EXP)
    assert chunks == [(3, 1), (3, 4), (3, 7)]
    for rel in ("stats.json", "models/support_sets.pt", "models/reconstructor.pt",
                "models/checkpoint.pt", "models/optimizer_state.npz"):
        a, b = (osp.join(trees[k], rel) for k in (1, 3))
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                ja, jb = json.load(fa), json.load(fb)
            assert set(ja) == {"3", "6", "9"} and ja == jb
        elif rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert set(za.files) == set(zb.files)
                assert all(np.array_equal(za[f], zb[f]) for f in za.files)
        else:
            ta, tb = load_pt(a), load_pt(b)
            if "iter" in ta:
                assert ta["iter"] == tb["iter"] == 9
                ta, tb = ta["support_sets"] | ta["reconstructor"], \
                    tb["support_sets"] | tb["reconstructor"]
            assert set(ta) == set(tb)
            assert all(np.array_equal(ta[key], tb[key]) for key in ta), rel
