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

The ranks split the work inside a latent code: on a one-code SNGAN-MNIST
pool each of two ranks renders its contiguous block of the code's render
batches, and the tree is one process's, JPEG bytes and all, and the JAX
package's ``--multi-device`` tree on the virtual 8-device mesh within its
gates (codes 1e-4, frames within 2 grey levels); on a one-hash tree of three
paths rank 0 evaluates paths 0 and 1 and rank 1 path 2, and the eval tree is
one process's, bytes and bits, and the JAX attribute CLI's ``--multi-device``
tree within the gates of its own multi-device test (rtol 1e-4, atol 1e-5).
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
    rendered its block of the code-major render batches (2 codes x 2 batches
    of 5 frames: both of code 0 on rank 0, both of code 1 on rank 1), and
    only rank 0 sampled and made the GIFs."""
    _, multi, ranks = trees
    assert [r["rank"] for r in ranks] == [0, 1] and {r["world"] for r in ranks} == {2}
    assert [r["sampled"] for r in ranks] == [2, 0]
    for r in ranks:
        assert r["train_rows"] == [4] * 8
    assert [r["traversed"] for r in ranks] == [2, 2]
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
    assert [r["evaluated"] for r in ranks] == [[(HASHES[0], 0)], [(HASHES[1], 0)]]

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


# ------------------------------------------- one code's work split over the ranks
A_K, A_STEPS, A_EPS, A_BATCH = 3, 2, 0.2, 4
A_ARGS = ["--exp", "exp", "--pool", "one", "--shift-steps", str(A_STEPS), "--eps", str(A_EPS),
          "--batch-size", str(A_BATCH)]
A_RES = osp.join("exp", "results", "one", f"{2 * A_STEPS}_{A_EPS}_{round(2 * A_STEPS * A_EPS, 3)}")


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            with open(osp.join(dirpath, f), "rb") as fh:
                out[osp.relpath(osp.join(dirpath, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def one_code_trees(tmp_path_factory):
    """A one-code SNGAN-MNIST pool (the JAX ``sample_gan``) and a K=3
    experiment of seeded sets, traversed 2 steps each way at a render batch
    of 4 (15 frames: 4 batches, the last padded) by the JAX CLI with
    ``--multi-device`` on the virtual mesh, by the port in one process and by
    the port on two gloo ranks, each ``build_gan`` patched to one small
    SNGAN of the same weights. Returns the three results dirs and the ranks'
    records."""
    import jax

    from tests.test_torch_sngan import small_sngan_bundles
    from warpedganspace_tpu.cli import sample_gan as j_sample_gan
    from warpedganspace_tpu.cli import traverse_latent_space as j_traverse
    from warpedganspace_tpu.models.support_sets import SupportSets as JSupportSets

    jG, G = small_sngan_bundles(seed=2)
    root = tmp_path_factory.mktemp("one_code")
    base = root / "base"
    base.mkdir()
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        os.chdir(base)
        mp.setattr(j_sample_gan, "build_gan", lambda **kw: jG)
        j_sample_gan.main(["-g", "SNGAN_MNIST", "--num-samples", "1", "--pool", "one"])
        os.makedirs(osp.join("exp", "models"))
        S = JSupportSets(num_support_sets=A_K, num_support_dipoles=8, support_vectors_dim=128,
                         learn_gammas=True)
        save_pt(S.to_torch_state_dict(S.init(jax.random.key(7))),
                osp.join("exp", "models", "support_sets.pt"))
        with open(osp.join("exp", "args.json"), "w") as f:
            json.dump({"gan_type": "SNGAN_MNIST", "num_support_sets": A_K,
                       "num_support_dipoles": 8, "learn_alphas": False, "learn_gammas": True,
                       "gamma": None}, f)
        for name in ("jax", "single", "multi"):
            shutil.copytree(base, root / name)
        os.chdir(root / "jax")
        mp.setattr(j_traverse, "build_gan", lambda **kw: jG)
        j_traverse.main(A_ARGS + ["--multi-device"])
        os.chdir(root / "single")
        mp.setattr(traverse_latent_space, "build_gan", lambda **kw: G.to(kw["device"]))
        traverse_latent_space.main(A_ARGS + ["--no-cuda"])
    finally:
        os.chdir(cwd)
        mp.undo()
    torch.save({"G": G, "argv": A_ARGS + ["--no-cuda", "--multi-device"]},
               root / "traverse_in.pt")
    ranks = [res for _, res in spawn("traverse", str(root), world=2, timeout=300)]
    return {name: str(root / name / A_RES) for name in ("jax", "single", "multi")}, ranks


def test_two_ranks_split_one_code_into_the_single_process_tree(one_code_trees):
    """One code, two ranks: each renders its contiguous block of the code's
    four render batches, and the tree is one process's, byte for byte."""
    res, ranks = one_code_trees
    assert [r["rank"] for r in ranks] == [0, 1]
    assert [[b for b in r["rendered"] if b[1] > b[0]] for r in ranks] == [[(0, 2)], [(2, 4)]]
    assert [r["calls"] for r in ranks] == [[A_BATCH] * 2, [A_BATCH] * 2]
    single, multi = _files(res["single"]), _files(res["multi"])
    assert sorted(multi) == sorted(single)
    assert sum(f.endswith(".jpg") for f in single) == A_K * (2 * A_STEPS + 1) + 1
    for rel, data in single.items():
        assert multi[rel] == data, rel


def test_two_ranks_split_one_code_as_the_jax_mesh_does(one_code_trees):
    """The two ranks' tree against the JAX package's ``--multi-device`` tree
    on the virtual 8-device mesh: the same files, codes within 1e-4 and
    frames within 2 grey levels."""
    res, _ = one_code_trees
    ours, ref = _files(res["multi"]), _files(res["jax"])
    assert sorted(ours) == sorted(ref)
    (h,) = {rel.split(os.sep)[0] for rel in ref}
    a = np.asarray(load_pt(osp.join(res["multi"], h, "paths_latent_codes.pt")))
    b = np.asarray(load_pt(osp.join(res["jax"], h, "paths_latent_codes.pt")))
    assert a.shape == b.shape == (A_K, 2 * A_STEPS + 1, 128)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    worst = 0
    for rel in ref:
        if rel.endswith(".jpg"):
            fa, fb = (np.asarray(Image.open(osp.join(r, rel)), dtype=np.int16)
                      for r in (res["multi"], res["jax"]))
            assert fa.shape == fb.shape == (32, 32), rel
            worst = max(worst, int(np.abs(fa - fb).max()))
    assert worst <= 2, worst


A_PATHS, A_HASH = 3, "0123abcd"


def test_two_ranks_split_one_hash_by_paths(tmp_path, monkeypatch):
    """A one-hash tree of three paths: rank 0 evaluates paths 0 and 1, rank 1
    path 2, and the eval tree is one process's, ``eval_json`` byte for byte
    and ``eval_np`` bit for bit; and against the JAX attribute CLI's
    ``--multi-device`` run on the virtual 8-device mesh it holds the gates of
    that run against the JAX CLI's single-device one
    (``tests/test_attribute_e2e.py``: rtol 1e-4, atol 1e-5) and the same
    argmaxes."""
    from tests.test_torch_attribute_cli import (ARGMAX_N, _frames, _jax_predictors,
                                                _path_frames256, make_tree)
    from warpedganspace_tpu.cli import traverse_attribute_space as jcli

    frames = _frames(3, k=A_PATHS, t=3)
    roots = {name: str(tmp_path / name) for name in ("single", "jax")}
    roots["multi"] = str(tmp_path / "ranks" / "multi")
    h_dirs = {name: make_tree(r, "StyleGAN2", steps=1, frames=frames)[1]
              for name, r in roots.items()}
    sds = predictor_state_dicts(seed=0, calibration=_path_frames256(h_dirs["single"]))
    argv = ["--exp", "exp", "--pool", "pool", "--shift-steps", "1", "--eps", "0.2"]
    torch.save({"state_dicts": sds, "argv": argv + ["--no-cuda", "--multi-device"]},
               tmp_path / "ranks" / "attribute_in.pt")
    ranks = [res for _, res in spawn("attribute", str(tmp_path / "ranks"), world=2,
                                     timeout=300)]
    assert [r["evaluated"] for r in ranks] == [[(A_HASH, 0), (A_HASH, 1)], [(A_HASH, 2)]]

    monkeypatch.chdir(roots["single"])
    monkeypatch.setattr(traverse_attribute_space, "load_predictors",
                        lambda device: predictors(sds))
    traverse_attribute_space.main(argv + ["--no-cuda"])
    monkeypatch.chdir(roots["jax"])
    jax_preds = _jax_predictors(sds)
    monkeypatch.setattr(jcli, "load_predictors", lambda: jax_preds)
    jcli.main(argv + ["--multi-device"])

    trees = {name: _files(osp.join(h, "eval_np")) | _files(osp.join(h, "eval_json"))
             for name, h in h_dirs.items()}
    assert sorted(trees["multi"]) == sorted(trees["single"]) == sorted(trees["jax"])
    assert len(trees["single"]) == 26 + 12
    for rel, data in trees["single"].items():
        assert trees["multi"][rel] == data, rel
    worst = 0.0
    for rel in trees["jax"]:
        if not rel.endswith(".npy"):
            continue
        got, want = (np.load(osp.join(h_dirs[n], "eval_np", rel)) for n in ("multi", "jax"))
        assert got.shape == want.shape == (A_PATHS, 3), rel
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=rel)
        name = rel[:-4]
        if name in ARGMAX_N:
            assert np.array_equal(np.floor(got * ARGMAX_N[name]),
                                  np.floor(want * ARGMAX_N[name])), name
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"two ranks against the JAX --multi-device eval tree: worst abs {worst:.3g}")
