"""The port's registry and downloader against the JAX package's, on the CPU.

The registry's constants (weight URLs and sha256 sums, the experiment
tarballs, the attribute predictors' artifacts, BigGAN's class names) must be
the JAX package's. The downloader is driven through ``file://`` artifacts
built in the test's directory: nothing is fetched from the network.
"""
import hashlib
import importlib
import os.path as osp
import tarfile

import pytest

from warpedganspace_tpu import config as j_config
from warpedganspace_torch import config
from warpedganspace_torch.cli import download_models

ARTIFACTS = ("SNGAN_MNIST_LeNet_K64_D128_LearnGammas_eps0d15_0d25",
             "SNGAN_AnimeFaces_LeNet_K64_D128_LearnGammas_eps0d25_0d35",
             "BigGAN_239_ResNet_K120_D256_LearnGammas_eps0d15_0d25",
             "ProgGAN_ResNet_K200_D512_LearnGammas_eps0d1_0d2",
             "StyleGAN2_1024_W_ResNet_K200_D512_LearnGammas_eps0d1_0d2",
             "SFD", "ARCFACE", "FAIRFACE", "HOPENET", "AUDET", "CELEBA_ATTRIBUTES")


def test_weights_registry_matches_jax():
    assert config.GAN_WEIGHTS == j_config.GAN_WEIGHTS
    assert config.GAN_RESOLUTIONS == j_config.GAN_RESOLUTIONS
    assert config.RECONSTRUCTOR_TYPES == j_config.RECONSTRUCTOR_TYPES
    for spec in config.GAN_WEIGHTS.values():
        assert len(spec["sha256sum"]) == 64 and spec["url"].startswith("https://")


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_matches_jax(name):
    url, digest = getattr(config, name)
    assert (url, digest) == getattr(j_config, name)
    assert len(digest) == 64 and int(digest, 16) >= 0


def test_biggan_classes_match_jax():
    classes = config.biggan_classes()
    assert classes == j_config.biggan_classes()
    assert len(classes) == 1000 and sorted(classes) == list(range(1000))
    assert classes[239] == j_config.biggan_classes()[239]


def test_biggan_classes_constant_is_lazy():
    """``BIGGAN_CLASSES`` is read from the JSON file on first access only, and
    is then a plain dict bound in the module."""
    fresh = importlib.reload(config)
    fresh.biggan_classes.cache_clear()
    assert "BIGGAN_CLASSES" not in vars(fresh)
    assert fresh.biggan_classes.cache_info().currsize == 0
    classes = fresh.BIGGAN_CLASSES
    assert type(classes) is dict and classes == j_config.biggan_classes()
    assert vars(fresh)["BIGGAN_CLASSES"] is classes is fresh.BIGGAN_CLASSES
    assert fresh.biggan_classes.cache_info().currsize == 1
    with pytest.raises(AttributeError):
        fresh.NOT_A_CONSTANT  # noqa: B018


def _tarball(tmp_path, members: dict, name="artifact.tar"):
    """A tar of ``{arcname: bytes}`` members: (file:// URL, sha256)."""
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    path = tmp_path / name
    with tarfile.open(path, "w") as tar:
        for i, (arcname, data) in enumerate(members.items()):
            f = src / f"member_{i}"
            f.write_bytes(data)
            tar.add(f, arcname=arcname)
    return "file://" + str(path), hashlib.sha256(path.read_bytes()).hexdigest()


def test_download_extracts_the_reference_layout(tmp_path):
    url, digest = _tarball(tmp_path, {"SNGAN_MNIST/generator.pt": b"\x01" * 64,
                                      "StyleGAN2/stylegan2-ffhq-config-f.pt": b"\x02" * 32})
    dest = tmp_path / "models" / "pretrained" / "generators"
    download_models.download(url, digest, str(dest))
    assert (dest / "SNGAN_MNIST" / "generator.pt").read_bytes() == b"\x01" * 64
    assert (dest / "StyleGAN2" / "stylegan2-ffhq-config-f.pt").read_bytes() == b"\x02" * 32
    assert not (dest / ".tmp.tar").exists()


def test_download_checks_sha256_before_extracting(tmp_path):
    url, digest = _tarball(tmp_path, {"SNGAN_MNIST/generator.pt": b"\x00" * 128})
    dest = tmp_path / "bad"
    with pytest.raises(Exception, match="sha256"):
        download_models.download(url, "0" * 64, str(dest))
    assert not (dest / "SNGAN_MNIST").exists()


def test_download_refuses_a_member_outside_dest(tmp_path):
    url, digest = _tarball(tmp_path, {"../escaped.txt": b"x", "inside.txt": b"y"})
    dest = tmp_path / "out" / "dest"
    with pytest.raises(tarfile.FilterError):
        download_models.download(url, digest, str(dest))
    assert not (tmp_path / "out" / "escaped.txt").exists()


def test_download_names_an_unreachable_source(tmp_path):
    with pytest.raises(ConnectionError, match="missing.tar"):
        download_models.download("file://" + str(tmp_path / "missing.tar"), "0" * 64,
                                 str(tmp_path / "dest"))


@pytest.mark.parametrize("argv,n_experiments", [([], 0), (["-m"], 5)])
def test_main_fetches_the_three_groups(tmp_path, monkeypatch, argv, n_experiments):
    """Generators and predictors always, the published experiments with -m,
    each group into its directory of the reference layout."""
    calls = []
    monkeypatch.setattr(download_models, "download",
                        lambda src, digest, dest: calls.append((src, digest, dest)))
    monkeypatch.chdir(tmp_path)
    download_models.main(argv)
    want = [(s["url"], s["sha256sum"], osp.join("models", "pretrained", "generators"))
            for s in j_config.GAN_WEIGHTS.values()]
    want += [getattr(j_config, n) + (osp.join("models", "pretrained"),) for n in ARTIFACTS[5:]]
    want += [getattr(j_config, n) + (osp.join("experiments", "complete"),)
             for n in ARTIFACTS[:n_experiments]]
    assert calls == want

