"""The port's ranking stage against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages:
``path_attribute_correlations`` and ``l1_normalize_rows`` directly, and both
ranking CLIs over one fabricated traversal tree (K=200 paths, 2 latent codes,
41 points and 41 JPEG frames a path, every attribute of the registry), with
planted ties (attributes saturated at their clip, paths with equal
sequences) and paths whose every attribute is constant (their L1 row is NaN).
The port's ``interpretable_paths/`` tree must equal the JAX CLI's file for
file and byte for byte, GIFs included: the JAX CLI writes its CSVs with
pandas, the port's with plain strings.
"""
import filecmp
import importlib
import os
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from warpedganspace_tpu.cli import rank_interpretable_paths as j_rank
from warpedganspace_tpu.ranking import engine as j_engine
from warpedganspace_tpu.utils import aux as j_aux
from warpedganspace_torch.cli import rank_interpretable_paths as rank
from warpedganspace_torch.ranking import engine
from warpedganspace_torch.utils import aux

K, T, STEPS, EPS = 200, 41, 20, 0.15
CONFIG = f"{2 * STEPS}_{EPS}_{round(2 * STEPS * EPS, 3)}"
HASHES = ("5f0c1e", "a93b72")
SATURATED = range(10, 60)       # au_12 held above its range: |corr| 0, a 50-way tie
EQUAL = range(60, 100)          # gender and age: one sequence, in range, for all of them
CONSTANT = (5, 150, 199)        # every attribute constant: the L1 row is NaN
GROUP = "Smiling-AU12"


def fabricate_attributes(seed: int) -> dict:
    """{attribute: (K, T) array} for one latent code, on every attribute's range."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(-1.0, 1.0, T)
    out = {}
    for name, (lo, hi) in engine.ATTRIBUTE_RANGES.items():
        slope = rng.standard_normal((K, 1))
        a = lo + (hi - lo) * (0.5 + 0.3 * slope * ramp + 0.1 * rng.standard_normal((K, T)))
        a[list(EQUAL)] = lo + (hi - lo) * (0.5 + 0.4 * ramp ** 3)
        if name == "au_12_Lip_Corner_Puller":
            a[list(SATURATED)] = hi + 2.0 + rng.random((len(SATURATED), T))
        a[list(CONSTANT)] = lo + 0.25 * (hi - lo)
        out[name] = a
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """exp/results/<pool>/<config>/<hash>/{eval_np/*.npy, paths_images/path_*/*.jpg}."""
    root = tmp_path_factory.mktemp("rank")
    hashes_root = root / "exp" / "results" / "pool" / CONFIG
    rng = np.random.default_rng(7)
    for s, h in enumerate(HASHES):
        np_dir = hashes_root / h / "eval_np"
        np_dir.mkdir(parents=True)
        for name, a in fabricate_attributes(s).items():
            np.save(np_dir / f"{name}.npy", a)
        for k in range(K):
            p_dir = hashes_root / h / "paths_images" / f"path_{k:03d}"
            p_dir.mkdir(parents=True)
            base = rng.integers(0, 256, (12, 12, 3))
            for t in range(T):
                frame = np.clip(base + 3 * t, 0, 255).astype(np.uint8)
                Image.fromarray(frame).save(p_dir / f"{t:06d}.jpg")
    return root, hashes_root


def _argv(root, metric, extra=()):
    return ["--exp", str(root / "exp"), "--pool", "pool", "--attr-group", GROUP,
            "--metric", metric, "--num-imgs", "5", "--gif-size", "16", *extra]


def _run_both(root, hashes_root, argv, tmp_path):
    """Run the JAX CLI, move its tree aside, run the port's CLI: (jax, port) dirs."""
    out = hashes_root / "interpretable_paths"
    shutil.rmtree(out, ignore_errors=True)
    j_rank.main(list(argv))
    want = tmp_path / "jax"
    shutil.move(str(out), want)
    rank.main(list(argv))
    return want, out


def _assert_same_tree(want, got):
    want_files = sorted(osp.relpath(osp.join(d, f), want)
                        for d, _, fs in os.walk(want) for f in fs)
    got_files = sorted(osp.relpath(osp.join(d, f), got)
                       for d, _, fs in os.walk(got) for f in fs)
    assert got_files == want_files
    differ = [f for f in want_files
              if not filecmp.cmp(osp.join(want, f), osp.join(got, f), shallow=False)]
    assert not differ, differ[:10]
    return want_files


def test_correlations_match_jax():
    """Through the identity's V-shaped index; both are the same numpy einsum."""
    a = fabricate_attributes(3)
    names = list(engine.ATTRIBUTE_GROUPS["Rotation"])
    attrs = np.stack([np.stack([a[n] for n in names], axis=1)] * 2)
    attrs[1] += 0.01
    got = engine.path_attribute_correlations(attrs, names)
    want = j_engine.path_attribute_correlations(attrs, names)
    assert got.shape == (2, K, len(names))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert engine.ATTRIBUTE_GROUPS == j_engine.ATTRIBUTE_GROUPS
    assert engine.ATTRIBUTE_RANGES == j_engine.ATTRIBUTE_RANGES


def test_l1_normalize_rows_keeps_nan_of_a_zero_row():
    x = np.array([[1.0, -3.0], [0.0, 0.0], [2.0, 2.0]])
    with np.errstate(invalid="ignore"):
        got, want = engine.l1_normalize_rows(x), j_engine.l1_normalize_rows(x)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).all() and np.allclose(np.abs(got[[0, 2]]).sum(1), 1.0)


def test_sort_descending_is_pandas_order():
    """pandas' order of a column with NaNs and ties (numpy's quicksort is not
    stable above 16 elements, so a stable sort would give another order)."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    v = np.round(rng.random(300), 1)
    v[rng.integers(0, 300, 30)] = np.nan
    want = pd.DataFrame(v).sort_values(by=0, ascending=False).index.to_numpy()
    np.testing.assert_array_equal(rank.sort_descending(v), want)
    assert not np.array_equal(want[~np.isnan(v[want])],
                              np.argsort(-v, kind="stable")[:len(want) - 30])


@pytest.mark.parametrize("metric", ["corr", "corr_l1", "corr+corr_l1"])
def test_cli_tree_equals_jax(tree, tmp_path, metric, monkeypatch):
    """Also: the port makes each (code, path) GIF once and copies it to every
    other name the top-k lists give it."""
    root, hashes_root = tree
    made = []
    make = rank.create_summarizing_gif
    monkeypatch.setattr(rank, "create_summarizing_gif",
                        lambda **kw: made.append(kw["imgs_root"]) or make(**kw))
    want, got = _run_both(root, hashes_root, _argv(root, metric, ("--eps", str(EPS),
                                                                  "--shift-steps", str(STEPS))),
                          tmp_path)
    files = _assert_same_tree(want, got)
    gifs = [f for f in files if f.endswith(".gif")]
    assert len(gifs) == 3 * 5 * len(HASHES) * len(metric.split("+"))
    distinct = {tuple(osp.basename(f)[:-4].split("_")[-2:]) for f in gifs}   # (path, code)
    assert len(made) == len(set(made)) == len(distinct)
    if "+" in metric:               # the metrics' top-k share paths
        assert len(distinct) < len(gifs)
    group = got / f"Group_{GROUP}"
    for m in metric.split("+"):
        lines = (group / m / f"attr_idx_{m}_sorted_by_au_12_Lip_Corner_Puller.csv"
                 ).read_text().splitlines()
        ids = [int(line.split(",")[0]) for line in lines[1:]]
        tied = [i for i in ids if i in SATURATED]
        assert len(tied) == len(SATURATED)
        if m == "corr_l1":      # the NaN rows come last, in their order, as empty fields
            assert ids[-len(CONSTANT):] == list(CONSTANT)
            assert lines[-1].endswith(",,,,")


def test_cli_finds_eps_configs_and_reruns(tree, tmp_path):
    """No --eps: the configs under the pool are found; a second run skips the
    interpretable_paths/ the first one wrote."""
    root, hashes_root = tree
    argv = _argv(root, "corr+corr_l1", ("--no-gif",))
    want, got = _run_both(root, hashes_root, argv, tmp_path)
    _assert_same_tree(want, got)
    rank.main(argv)
    _assert_same_tree(want, got)


def test_cli_names_a_hash_with_missing_arrays(tree, tmp_path):
    root, hashes_root = tree
    victim = hashes_root / HASHES[1] / "eval_np" / "gender.npy"
    saved = tmp_path / "gender.npy"
    shutil.move(victim, saved)
    try:
        with pytest.raises(FileNotFoundError, match=HASHES[1]):
            rank.main(_argv(root, "corr", ("--no-gif", "--eps", str(EPS),
                                           "--shift-steps", str(STEPS))))
    finally:
        shutil.move(saved, victim)


def test_cli_runs_without_pandas(tree, tmp_path, monkeypatch):
    """The card's machine has no pandas: the port's CLI, imported anew with
    pandas unimportable, writes the JAX CLI's tree."""
    root, hashes_root = tree
    argv = _argv(root, "corr+corr_l1", ("--no-gif", "--top-k", str(K + 5), "--eps",
                                        str(EPS), "--shift-steps", str(STEPS)))
    shutil.rmtree(hashes_root / "interpretable_paths", ignore_errors=True)
    j_rank.main(list(argv))
    want = tmp_path / "jax"
    shutil.move(str(hashes_root / "interpretable_paths"), want)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    fresh = importlib.reload(rank)
    try:
        fresh.main(list(argv))
    finally:
        monkeypatch.undo()
        importlib.reload(rank)
    _assert_same_tree(want, hashes_root / "interpretable_paths")
    md = (hashes_root / "interpretable_paths" / f"Group_{GROUP}"
          / f"top-{K}_interpretable_path_{GROUP}.md")
    assert md.is_file()                  # top-k was cut to the 200 paths


def test_summarizing_gif_and_get_wh_match_jax(tree, tmp_path):
    _, hashes_root = tree
    frames = hashes_root / HASHES[0] / "paths_images" / "path_007"
    files = sorted(str(p) for p in frames.iterdir())
    assert aux.get_wh(files) == j_aux.get_wh(files) == (12, 12)
    for kwargs in ({"num_imgs": 5, "gif_size": 32}, {"num_imgs": None, "gif_size": None},
                   {"num_imgs": 7, "gif_size": 20, "gif_fps": 12, "progress_bar_h": 0}):
        aux.create_summarizing_gif(str(frames), str(tmp_path / "port.gif"), **kwargs)
        j_aux.create_summarizing_gif(str(frames), str(tmp_path / "jax.gif"), **kwargs)
        assert (tmp_path / "port.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()
    odd = tmp_path / "odd"
    odd.mkdir()
    Image.new("RGB", (12, 12)).save(odd / "000000.jpg")
    Image.new("RGB", (12, 10)).save(odd / "000001.jpg")
    with pytest.raises(ValueError, match="Inconsistent"):
        aux.get_wh(sorted(str(p) for p in odd.iterdir()))
    with pytest.raises(NotADirectoryError):
        aux.create_summarizing_gif(str(tmp_path / "none"), str(tmp_path / "x.gif"))
