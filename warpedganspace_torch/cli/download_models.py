"""Pretrained-artifact downloader CLI (reference ``download_models.py``).

The port's counterpart of :mod:`warpedganspace_tpu.cli.download_models`, run as
``python -m warpedganspace_torch.cli.download_models [-m]``.

Fetches the pretrained GAN generators, the published WarpedGANSpace experiment
tarballs, and the attribute-evaluation detector weights; verifies every
artifact's sha256 before extraction into the reference directory layout
(models/pretrained/{generators,sfd,arcface,fairface,hopenet,au_detector,
celeba_attributes}).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import os.path as osp
import sys
import tarfile
import time
import urllib.request

from warpedganspace_torch.config import (
    ARCFACE,
    AUDET,
    BigGAN_239_ResNet_K120_D256_LearnGammas_eps0d15_0d25,
    CELEBA_ATTRIBUTES,
    FAIRFACE,
    GAN_WEIGHTS,
    HOPENET,
    ProgGAN_ResNet_K200_D512_LearnGammas_eps0d1_0d2,
    SFD,
    SNGAN_AnimeFaces_LeNet_K64_D128_LearnGammas_eps0d25_0d35,
    SNGAN_MNIST_LeNet_K64_D128_LearnGammas_eps0d15_0d25,
    StyleGAN2_1024_W_ResNet_K200_D512_LearnGammas_eps0d1_0d2,
)

_start_time = None


def _reporthook(count, block_size, total_size):
    global _start_time
    if count == 0:
        _start_time = time.time()
        return
    duration = max(time.time() - _start_time, 1e-6)
    progress_size = int(count * block_size)
    speed = int(progress_size / (1024 * duration))
    percent = min(int(count * block_size * 100 / total_size), 100) if total_size > 0 else 0
    sys.stdout.write(
        "\r      \\__%d%%, %d MB, %d KB/s, %d seconds passed"
        % (percent, progress_size / (1024 * 1024), speed, duration)
    )
    sys.stdout.flush()


def download(src: str, sha256sum: str, dest: str) -> None:
    """Download ``src`` into ``dest``, verify sha256, extract the tarball.

    Fails hard on hash mismatch (reference download_models.py:37-47).
    """
    os.makedirs(dest, exist_ok=True)
    tmp_tar = osp.join(dest, ".tmp.tar")
    try:
        urllib.request.urlretrieve(src, tmp_tar, _reporthook)
    except Exception as e:
        raise ConnectionError("Error: {} ({})".format(src, e))

    h = hashlib.sha256()
    with open(tmp_tar, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    ok = h.hexdigest() == sha256sum
    print()
    print("      \\__Check sha256: {}".format("OK!" if ok else "Error"))
    if not ok:
        raise Exception("Error: Invalid sha256 sum: {}".format(h.hexdigest()))

    with tarfile.open(tmp_tar, mode="r") as tar:
        # The "data" filter refuses absolute paths, ".." members and links
        # that leave ``dest``, and drops dangerous metadata.
        tar.extractall(dest, filter="data")
    os.remove(tmp_tar)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Download pre-trained models")
    parser.add_argument("-m", "--pretrained-models", action="store_true",
                        help="also download the published pretrained WarpedGANSpace experiments")
    args = parser.parse_args(argv)

    pretrained_root = osp.join("models", "pretrained")

    print("#. Download pre-trained GAN generators...")
    for gan, spec in GAN_WEIGHTS.items():
        print("  \\__.{}".format(gan))
        download(spec["url"], spec["sha256sum"], osp.join(pretrained_root, "generators"))

    print("#. Download pre-trained attribute detectors...")
    for name, spec in (
        ("SFD", SFD),
        ("ArcFace", ARCFACE),
        ("FairFace", FAIRFACE),
        ("HopeNet", HOPENET),
        ("AU detector", AUDET),
        ("CelebA attributes", CELEBA_ATTRIBUTES),
    ):
        print("  \\__.{}".format(name))
        download(spec[0], spec[1], pretrained_root)

    if args.pretrained_models:
        print("#. Download pre-trained WarpedGANSpace models...")
        for name, spec in (
            ("SNGAN_MNIST", SNGAN_MNIST_LeNet_K64_D128_LearnGammas_eps0d15_0d25),
            ("SNGAN_AnimeFaces", SNGAN_AnimeFaces_LeNet_K64_D128_LearnGammas_eps0d25_0d35),
            ("BigGAN-239", BigGAN_239_ResNet_K120_D256_LearnGammas_eps0d15_0d25),
            ("ProgGAN", ProgGAN_ResNet_K200_D512_LearnGammas_eps0d1_0d2),
            ("StyleGAN2", StyleGAN2_1024_W_ResNet_K200_D512_LearnGammas_eps0d1_0d2),
        ):
            print("  \\__.{}".format(name))
            download(spec[0], spec[1], osp.join("experiments", "complete"))


if __name__ == "__main__":
    main()
