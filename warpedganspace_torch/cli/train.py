"""WarpedGANSpace training CLI (reference ``train.py``).

Trains K RBF warping functions (the support sets S) and a reconstructor R
against a frozen pretrained GAN, and writes the reference experiment tree

    experiments/wip/<name>/{args.json, command.sh, stats.json,
        models/{support_sets_init.pt, checkpoint.pt, optimizer_state.npz,
                support_sets.pt, reconstructor.pt}, tensorboard/}

which a finished run copies to experiments/complete/<name>/ (without
checkpoint.pt), where :mod:`warpedganspace_torch.cli.traverse_latent_space`
reads it. The flag surface is the reference's plus ``--seed``, ``--g-dtype``,
``--r-dtype`` and ``--no-tensorboard-server``, as in
:mod:`warpedganspace_tpu.cli.train`. ``--cuda`` (the default) trains on the
CUDA device and fails without one; ``--no-cuda`` trains on the CPU.

    python -m warpedganspace_torch.cli.train --gan-type BigGAN \\
        --biggan-target-classes 239 -K 120 -D 256 --learn-gammas \\
        --min-shift-magnitude 0.1 --max-shift-magnitude 0.2 --batch-size 32 \\
        --g-dtype bfloat16 --r-dtype bfloat16
"""
from __future__ import annotations

import argparse

import torch

from warpedganspace_torch.cli.sample_gan import select_device
from warpedganspace_torch.config import GAN_RESOLUTIONS, GAN_WEIGHTS, RECONSTRUCTOR_TYPES
from warpedganspace_torch.models.gan_load import build_gan, check_ported
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.train.trainer import Trainer
from warpedganspace_torch.utils.aux import create_exp_dir


def build_parser():
    parser = argparse.ArgumentParser(description="WarpedGANSpace training script")

    # === Pre-trained GAN Generator (G) ===
    parser.add_argument("--gan-type", type=str, choices=list(GAN_WEIGHTS.keys()),
                        help="set GAN generator model type")
    parser.add_argument("--z-truncation", type=float,
                        help="set latent code sampling truncation parameter")
    parser.add_argument("--biggan-target-classes", nargs="+", type=int,
                        help="list of classes for conditional BigGAN")
    parser.add_argument("--stylegan2-resolution", type=int, default=1024, choices=(256, 1024),
                        help="StyleGAN2 image resolution")
    parser.add_argument("--shift-in-w-space", action="store_true",
                        help="search latent paths in StyleGAN2's W-space")

    # === Support Sets (S) ===
    parser.add_argument("-K", "--num-support-sets", type=int,
                        help="set number of support sets (warping functions)")
    parser.add_argument("-D", "--num-support-dipoles", type=int,
                        help="set number of support dipoles per support set")
    parser.add_argument("--learn-alphas", action="store_true", help="learn RBF alpha params")
    parser.add_argument("--learn-gammas", action="store_true", help="learn RBF gamma params")
    parser.add_argument("-g", "--gamma", type=float,
                        help="set RBF gamma param; when --learn-gammas is set, this will be "
                             "the initial value of gammas of all RBFs")
    parser.add_argument("--support-set-lr", type=float, default=1e-4, help="set learning rate")

    # === Reconstructor (R) ===
    parser.add_argument("--reconstructor-type", type=str, choices=RECONSTRUCTOR_TYPES,
                        default="ResNet", help="set reconstructor network type")
    parser.add_argument("--min-shift-magnitude", type=float, default=0.25,
                        help="set minimum shift magnitude")
    parser.add_argument("--max-shift-magnitude", type=float, default=0.45,
                        help="set shifts magnitude scale")
    parser.add_argument("--reconstructor-lr", type=float, default=1e-4,
                        help="set learning rate for reconstructor R optimization")

    # === Training ===
    parser.add_argument("--max-iter", type=int, default=100000,
                        help="set maximum number of training iterations")
    parser.add_argument("--batch-size", type=int, default=32, help="set batch size")
    parser.add_argument("--lambda-cls", type=float, default=1.00, help="classification loss weight")
    parser.add_argument("--lambda-reg", type=float, default=0.25, help="regression loss weight")
    parser.add_argument("--log-freq", default=10, type=int, help="set number iterations per log")
    parser.add_argument("--ckp-freq", default=1000, type=int,
                        help="set number iterations per checkpoint model saving")
    parser.add_argument("--tensorboard", action="store_true", help="use tensorboard")
    parser.add_argument("--no-tensorboard-server", action="store_true",
                        help="with --tensorboard: write scalars but do not launch the "
                             "in-process TensorBoard server (the reference always "
                             "launches one, lib/trainer.py:55-63)")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed of the initial S and R and of the batch stream")
    parser.add_argument("--g-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="generator compute dtype during training (the warp "
                             "and loss always run float32)")
    parser.add_argument("--r-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="reconstructor compute dtype during training: "
                             "bfloat16 runs R's conv trunk in bf16 (float32 "
                             "master params, BN statistics and heads)")

    # === Devices ===
    parser.add_argument("--cuda", dest="cuda", action="store_true",
                        help="train on the CUDA device (default)")
    parser.add_argument("--no-cuda", dest="cuda", action="store_false",
                        help="train on the CPU")
    parser.set_defaults(cuda=True)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    # Check what every run needs BEFORE the experiment directory exists, so a
    # wrong launch leaves no 'None-...-KNone-DNone' tree behind.
    for flag, val in (("--gan-type", args.gan_type),
                      ("-K/--num-support-sets", args.num_support_sets),
                      ("-D/--num-support-dipoles", args.num_support_dipoles)):
        if val is None:
            parser.error(f"{flag} is required")
    if args.gan_type == "BigGAN" and args.biggan_target_classes is None:
        parser.error("In case of BigGAN, a list of classes needs to be determined.")
    check_ported(args.gan_type)
    device = select_device(args.cuda)

    # Create output dir and save current arguments (the args.json contract).
    exp_dir = create_exp_dir(args)

    print("#. Build GAN generator model G and load with pre-trained weights...")
    print("  \\__GAN type: {}".format(args.gan_type))
    if args.gan_type == "StyleGAN2":
        print("  \\__Search for paths in {}-space".format("W" if args.shift_in_w_space else "Z"))
    if args.z_truncation:
        print("  \\__Input noise truncation: {}".format(args.z_truncation))
    print("  \\__Pre-trained weights: {}".format(
        GAN_WEIGHTS[args.gan_type]["weights"][args.stylegan2_resolution]
        if args.gan_type == "StyleGAN2"
        else GAN_WEIGHTS[args.gan_type]["weights"][GAN_RESOLUTIONS[args.gan_type]]))
    G = build_gan(gan_type=args.gan_type,
                  target_classes=args.biggan_target_classes,
                  stylegan2_resolution=args.stylegan2_resolution,
                  shift_in_w_space=args.shift_in_w_space, device=device)

    print("#. Build Support Sets S...")
    print("  \\__Number of Support Sets    : {}".format(args.num_support_sets))
    print("  \\__Number of Support Dipoles : {}".format(args.num_support_dipoles))
    print("  \\__Support Vectors dim       : {}".format(G.dim_z))
    print("  \\__Learn RBF alphas          : {}".format(args.learn_alphas))
    print("  \\__Learn RBF gammas          : {}".format(args.learn_gammas))
    if not args.learn_gammas:
        print("  \\__RBF gamma                 : {}".format(
            1.0 / G.dim_z if args.gamma is None else args.gamma))
    # One seeded generator gives the initial S, then the initial R.
    init_gen = torch.Generator().manual_seed(args.seed)
    S = SupportSets(num_support_sets=args.num_support_sets,
                    num_support_dipoles=args.num_support_dipoles,
                    support_vectors_dim=G.dim_z,
                    learn_alphas=args.learn_alphas,
                    learn_gammas=args.learn_gammas,
                    gamma=1.0 / G.dim_z if args.gamma is None else args.gamma,
                    generator=init_gen)

    print("#. Build reconstructor model R...")
    R = Reconstructor(reconstructor_type=args.reconstructor_type,
                      dim=args.num_support_sets,
                      channels=1 if args.gan_type == "SNGAN_MNIST" else 3,
                      generator=init_gen)

    print("#. Experiment: {}".format(exp_dir))
    trn = Trainer(params=args, exp_dir=exp_dir, seed=args.seed)
    trn.train(generator=G, support_sets=S, reconstructor=R)
    return trn


if __name__ == "__main__":
    main()
