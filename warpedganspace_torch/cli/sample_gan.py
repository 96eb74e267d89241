"""Latent-pool sampling CLI (reference ``sample_gan.py``).

Samples N latent codes, renders their images, and stores each pair under
experiments/latent_codes/<gan_type>(<classes>)/<pool>/<sha1(z)>/
{latent_code.pt, image.jpg}: the pool the traversal stage reads. The tree and
the files are those of :mod:`warpedganspace_tpu.cli.sample_gan`, so pools are
interchangeable between the two packages and the reference. Under a process
group (``torchrun``) only the coordinator samples; the other ranks wait at a
barrier that every path of the coordinator reaches, so the pool is complete
when any rank goes on.

    python -m warpedganspace_torch.cli.sample_gan -g StyleGAN2 --num-samples 4 --pool demo
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from hashlib import sha1

import torch

from warpedganspace_torch.config import GAN_RESOLUTIONS, GAN_WEIGHTS
from warpedganspace_torch.core.sampling import sample_z
from warpedganspace_torch.models.gan_load import build_gan
from warpedganspace_torch.parallel import mesh
from warpedganspace_torch.traverse.images import tensor2image
from warpedganspace_torch.utils.aux import update_progress, update_stdout
from warpedganspace_torch.utils.io import save_pt


def build_parser():
    parser = argparse.ArgumentParser(
        description="Sample a pre-trained GAN latent space and generate images")
    parser.add_argument("-v", "--verbose", action="store_true", help="set verbose mode on")
    parser.add_argument("-g", "--gan-type", type=str, required=True,
                        choices=list(GAN_WEIGHTS.keys()), help="GAN generator model type")
    parser.add_argument("--shift-in-w-space", action="store_true",
                        help="search latent paths in StyleGAN2's W-space")
    parser.add_argument("--z-truncation", type=float,
                        help="set latent code sampling truncation parameter")
    parser.add_argument("--biggan-target-classes", nargs="+", type=int,
                        help="list of classes for conditional BigGAN")
    parser.add_argument("--stylegan2-resolution", type=int, default=1024, choices=(256, 1024),
                        help="StyleGAN2 image resolution")
    parser.add_argument("--num-samples", type=int, default=4,
                        help="number of latent codes to sample")
    parser.add_argument("--pool", type=str, help="name of latent codes/images pool")
    parser.add_argument("--seed", type=int, default=0, help="RNG seed")
    parser.add_argument("--cuda", dest="cuda", action="store_true",
                        help="run on the CUDA device (default)")
    parser.add_argument("--no-cuda", dest="cuda", action="store_false",
                        help="run on the CPU")
    parser.set_defaults(cuda=True)
    return parser


def select_device(use_cuda: bool) -> torch.device:
    """``--cuda`` means the CUDA device and fails without one; ``--no-cuda`` the
    CPU. Under a process group the CUDA device is the rank's own card."""
    if not use_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--cuda was given (the default) but no CUDA device is "
                           "available; pass --no-cuda to run on the CPU")
    if mesh.active():
        return mesh.local_device()
    return torch.device("cuda")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    # Checks that fail on every rank alike come before the coordinator's
    # gate, so that no rank waits at the barrier for one that has left.
    if args.gan_type == "BigGAN" and args.biggan_target_classes is None:
        parser.error("In case of BigGAN, a list of classes needs to be determined.")
    mesh.initialize_distributed(backend=None if args.cuda else "gloo")
    if not mesh.is_coordinator():
        mesh.sync_processes("sample-gan-done")
        return
    try:
        _sample_pool(args)
    finally:
        mesh.sync_processes("sample-gan-done")


def _sample_pool(args):
    """The coordinator's sampling (reference sample_gan.py:32-184)."""
    device = select_device(args.cuda)

    out_dir = osp.join("experiments", "latent_codes", args.gan_type)
    biggan_classes = None
    if args.gan_type == "BigGAN":
        biggan_classes = "".join("-{}".format(c) for c in args.biggan_target_classes)
        out_dir += biggan_classes
    if args.pool:
        out_dir = osp.join(out_dir, args.pool)
    else:
        out_dir = osp.join(out_dir, "{}_{}".format(
            args.gan_type + biggan_classes if args.gan_type == "BigGAN" else args.gan_type,
            args.num_samples))
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, "args.json"), "w") as f:
        json.dump(args.__dict__, f)

    if args.verbose:
        print("#. Build GAN generator model G and load with pre-trained weights...")
        print("  \\__GAN type: {}".format(args.gan_type))
        print("  \\__Pre-trained weights: {}".format(
            GAN_WEIGHTS[args.gan_type]["weights"][args.stylegan2_resolution]
            if args.gan_type == "StyleGAN2"
            else GAN_WEIGHTS[args.gan_type]["weights"][GAN_RESOLUTIONS[args.gan_type]]))

    G = build_gan(gan_type=args.gan_type, target_classes=args.biggan_target_classes,
                  stylegan2_resolution=args.stylegan2_resolution,
                  shift_in_w_space=args.shift_in_w_space, device=device)

    if args.verbose:
        print("#. Sample {} {}-dimensional latent codes...".format(args.num_samples, G.dim_z))
        if args.z_truncation:
            print("  \\__Truncate standard Gaussian to range [{}, +{}]".format(
                -args.z_truncation, args.z_truncation))
    zs = sample_z(torch.Generator().manual_seed(args.seed), args.num_samples, G.dim_z,
                  args.z_truncation)
    zs_np = zs.numpy()

    if args.verbose:
        print("#. Generate images...")
        print("  \\__{}".format(out_dir))
    with torch.no_grad():
        for i in range(args.num_samples):
            z = zs_np[i:i + 1]
            latent_code_hash = sha1(z).hexdigest()
            if args.verbose:
                update_progress("  \\__.Latent code hash: {} [{:03d}/{:03d}] ".format(
                    latent_code_hash, i + 1, args.num_samples), args.num_samples, i)
            latent_code_dir = osp.join(out_dir, latent_code_hash)
            os.makedirs(latent_code_dir, exist_ok=True)
            save_pt(z, osp.join(latent_code_dir, "latent_code.pt"))
            img = G(zs[i:i + 1].to(device))[0].float().permute(1, 2, 0).cpu().numpy()
            tensor2image(img, adaptive=True).save(
                osp.join(latent_code_dir, "image.jpg"), "JPEG",
                quality=95, optimize=True, progressive=True)

    if args.verbose:
        update_stdout(1)
        print()
        print()


if __name__ == "__main__":
    main()
