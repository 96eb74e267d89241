"""The port's CLIs on two gloo ranks on the CPU write the one tree that one
process writes.

Two ranks (``tests/torch_ranks.py``, launched as ``torchrun`` launches them)
run ``sample_gan`` -> ``train --multi-device --steps-per-call 2`` ->
``traverse_latent_space --multi-device --gif`` with the JAX package's
multi-process arguments (``tests/test_cli_multiprocess.py``: SNGAN-MNIST with
seeded random weights, LeNet, K=2, D=2, a global batch of 8, 4 iterations);
the port in this process runs the same stages on one batch of 8, one step a
call. The trees must hold the same files, the same statistics (rtol 1e-4,
atol 1e-5), the same codes (1e-4) and frames within 2 grey levels; the GIFs
are collated once, by rank 0. Then ``traverse_attribute_space
--multi-device`` on two ranks writes the eval tree of one process, on a
fabricated two-hash tree with seeded predictors. The refusals of
``--multi-device``, ``--num-shards`` and ``--shard-index`` come before any
file is written.
"""
import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_ranks import predictors, spawn
from warpedganspace_torch.cli import sample_gan, train, traverse_attribute_space
from warpedganspace_torch.cli import traverse_latent_space
from warpedganspace_torch.evalzoo.fabricate import predictor_state_dicts
from warpedganspace_torch.parallel import mesh
from warpedganspace_torch.traverse.images import save_jpeg
from warpedganspace_torch.utils.io import load_pt, save_pt

torch.set_num_threads(1)

TRAIN_ARGS = [
    "--gan-type", "SNGAN_MNIST", "--reconstructor-type", "LeNet",
    "-K", "2", "-D", "2", "--min-shift-magnitude", "0.15",
    "--max-shift-magnitude", "0.25", "--max-iter", "4", "--batch-size", "8",
    "--log-freq", "2", "--ckp-freq", "4", "--seed", "11", "--no-cuda",
]
SAMPLE_ARGS = ["-g", "SNGAN_MNIST", "--num-samples", "2", "--pool", "p", "--seed", "2",
               "--no-cuda"]
EXP = osp.join("experiments", "complete", "SNGAN_MNIST-LeNet-K2-D2-eps0.15_0.25")
TRAVERSE_ARGS = ["--exp", EXP, "--pool", "p", "--shift-steps", "2", "--eps", "0.2", "--gif",
                 "--no-cuda"]
RES = osp.join(EXP, "results", "p", "4_0.2_0.8")


def _read_tree(root):
    """(stats, codes by hash, frames of path 0 by hash, relative file set)."""
    with open(osp.join(root, EXP, "stats.json")) as f:
        stats = json.load(f)
    res = osp.join(root, RES)
    hashes = sorted(d for d in os.listdir(res)
                    if osp.isdir(osp.join(res, d)) and d != "paths_gifs")
    codes, frames = {}, {}
    for h in hashes:
        codes[h] = np.asarray(load_pt(osp.join(res, h, "paths_latent_codes.pt")))
        fdir = osp.join(res, h, "paths_images", "path_000")
        frames[h] = np.stack([np.asarray(Image.open(osp.join(fdir, f)).convert("L"))
                              for f in sorted(os.listdir(fdir))])
    files = set()
    for dirpath, _, filenames in os.walk(osp.join(root, "experiments")):
        files |= {osp.relpath(osp.join(dirpath, f), root) for f in filenames}
    return stats, codes, frames, files


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(single-process root, two-rank root, each rank's record)."""
    workdir = tmp_path_factory.mktemp("pipeline")
    torch.save({"sample": SAMPLE_ARGS,
                "train": TRAIN_ARGS + ["--multi-device", "--steps-per-call", "2"],
                "traverse": TRAVERSE_ARGS + ["--multi-device"]},
               workdir / "pipeline_in.pt")
    ranks = [res for _, res in spawn("pipeline", str(workdir), world=2, timeout=300)]

    single = workdir / "single"
    single.mkdir()
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        os.chdir(single)
        mp.setenv("WGS_ALLOW_RANDOM_G", "1")
        sample_gan.main(SAMPLE_ARGS)
        train.main(TRAIN_ARGS)
        traverse_latent_space.main(TRAVERSE_ARGS)
    finally:
        os.chdir(cwd)
        mp.undo()
    return str(single), str(workdir / "multi"), ranks


def test_two_ranks_write_the_single_process_tree(trees):
    single, multi, _ = trees
    s1, c1, f1, files1 = _read_tree(single)
    s2, c2, f2, files2 = _read_tree(multi)
    # One tree: nothing missing (a gated write nobody made), nothing extra (a
    # second writer).
    assert files2 == files1, files2 ^ files1
    assert set(s1) == {"2", "4"}
    for it in s1:
        for k in s1[it]:
            np.testing.assert_allclose(s2[it][k], s1[it][k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{it}[{k}]")
    assert set(c1) == set(c2) and len(c1) == 2
    for h in c1:
        np.testing.assert_allclose(c2[h], c1[h], rtol=1e-4, atol=1e-4)
        assert f1[h].shape == f2[h].shape == (5, 32, 32)
        assert np.abs(f1[h].astype(int) - f2[h].astype(int)).max() <= 2


def test_each_rank_did_its_share(trees):
    """Each rank trained on 4 of the 8 rows (two generator calls a step),
    traversed one of the two codes, and only rank 0 sampled and made the
    GIFs."""
    _, multi, ranks = trees
    assert [r["rank"] for r in ranks] == [0, 1] and {r["world"] for r in ranks} == {2}
    assert [r["sampled"] for r in ranks] == [2, 0]
    for r in ranks:
        assert r["train_rows"] == [4] * 8
        assert r["traversed"] > 0
    assert [r["gif_collations"] for r in ranks] == [1, 0]
    assert len(os.listdir(osp.join(multi, RES, "paths_gifs"))) == 2


# --------------------------------------------------------------- refusals
@pytest.fixture
def group_of_two(monkeypatch):
    """This process as rank 0 of two, as far as the CLIs can tell."""
    monkeypatch.setattr(mesh, "initialize_distributed", lambda **kw: True)
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 0)


@pytest.mark.parametrize("argv, match", [
    ([], "need --multi-device"),
    (["--multi-device", "--batch-size", "7"], "does not split evenly over 2 ranks"),
])
def test_train_refusals_under_a_group(argv, match, group_of_two, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        train.main(TRAIN_ARGS + argv)
    assert match in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv, grouped, error", [
    (["--multi-device", "--num-shards", "2", "--shard-index", "1"], True, SystemExit),
    ([], True, SystemExit),
    (["--num-shards", "2", "--gif"], False, ValueError),
    (["--num-shards", "2", "--shard-index", "2"], False, ValueError),
    (["--num-shards", "0"], False, ValueError),
])
def test_traverse_refusals_before_reading(argv, grouped, error, tmp_path, monkeypatch, request):
    """Each refusal comes before the experiment is read (it does not exist)
    and before anything is written."""
    if grouped:
        request.getfixturevalue("group_of_two")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error):
        traverse_latent_space.main(["--exp", "missing", "--pool", "p", "--no-cuda"] + argv)
    assert os.listdir(tmp_path) == []


def test_empty_pool_and_empty_shard(trees, tmp_path, monkeypatch, capsys):
    """An empty pool is an error; a shard left without codes (3 shards of 2
    codes) has nothing to do and writes nothing."""
    root = tmp_path / "tree"
    shutil.copytree(trees[0], root)
    monkeypatch.chdir(root)
    monkeypatch.setenv("WGS_ALLOW_RANDOM_G", "1")
    argv = ["--exp", EXP, "--pool", "p", "--shift-steps", "2", "--eps", "0.2", "--no-cuda"]
    before = _read_tree(str(root))[3]
    traverse_latent_space.main(argv + ["--num-shards", "3", "--shard-index", "2"])
    assert "Shard 2/3 has no latent codes" in capsys.readouterr().out
    assert _read_tree(str(root))[3] == before
    os.makedirs(osp.join("experiments", "latent_codes", "SNGAN_MNIST", "empty"))
    with pytest.raises(ValueError, match="contains no latent codes"):
        traverse_latent_space.main(["--exp", EXP, "--pool", "empty", "--no-cuda"])


# ------------------------------------------------------- the attribute CLI
POOL, CONFIG, HASHES, T, SIZE = "pool", "2_0.2_0.4", ("0123abcd", "89efcdab"), 3, 64


def _attribute_tree(root):
    """An experiment with two hashes of one 3-frame path of 64² JPEGs."""
    rng = np.random.default_rng(0)
    exp = osp.join(root, "exp")
    os.makedirs(exp)
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump({"gan_type": "StyleGAN2"}, f)
    for h in HASHES:
        h_dir = osp.join(exp, "results", POOL, CONFIG, h)
        path = osp.join(h_dir, "paths_images", "path_000")
        os.makedirs(path)
        save_pt(np.zeros((1, T, 8), np.float32), osp.join(h_dir, "paths_latent_codes.pt"))
        coarse = torch.from_numpy(rng.random((T, 3, 8, 8)))
        frames = torch.nn.functional.interpolate(coarse, size=(SIZE, SIZE), mode="bicubic",
                                                 align_corners=False).clamp(0, 1)
        for t in range(T):
            img = (255 * frames[t]).permute(1, 2, 0).numpy().astype(np.uint8)
            save_jpeg(Image.fromarray(img), osp.join(path, f"{t:06d}.jpg"))
    return exp


def _eval_tree(exp):
    out = {}
    for h in HASHES:
        h_dir = osp.join(exp, "results", POOL, CONFIG, h)
        for sub in ("eval_np", "eval_json"):
            for f in sorted(os.listdir(osp.join(h_dir, sub))):
                p = osp.join(h_dir, sub, f)
                out[(h, sub, f)] = np.load(p) if f.endswith(".npy") else open(p).read()
    return out


def test_attribute_cli_two_ranks_write_the_single_process_tree(tmp_path, monkeypatch):
    sds = predictor_state_dicts(seed=0)
    argv = ["--exp", "exp", "--pool", POOL, "--shift-steps", "1", "--eps", "0.2", "--no-cuda"]
    workdir = tmp_path / "ranks"
    _attribute_tree(str(workdir / "multi"))
    torch.save({"state_dicts": sds, "argv": argv + ["--multi-device"]},
               workdir / "attribute_in.pt")
    ranks = [res for _, res in spawn("attribute", str(workdir), world=2, timeout=300)]
    assert [r["evaluated"] for r in ranks] == [[HASHES[0]], [HASHES[1]]]

    single = str(tmp_path / "single")
    _attribute_tree(single)
    monkeypatch.chdir(single)
    monkeypatch.setattr(traverse_attribute_space, "load_predictors",
                        lambda device: predictors(sds))
    traverse_attribute_space.main(argv)
    got, want = _eval_tree(str(workdir / "multi" / "exp")), _eval_tree(osp.join(single, "exp"))
    assert sorted(got) == sorted(want) and len(want) == 2 * (26 + 12)
    for key, v in want.items():
        if isinstance(v, str):
            assert got[key] == v, key
        else:
            np.testing.assert_array_equal(got[key], v, err_msg=str(key))
