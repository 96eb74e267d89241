"""WarpedGANSpace training CLI (reference ``train.py``).

Trains K RBF warping functions (the support sets S) and a reconstructor R
against a frozen pretrained GAN, and writes the reference experiment tree

    experiments/wip/<name>/{args.json, command.sh, stats.json,
        models/{support_sets_init.pt, checkpoint.pt, optimizer_state.npz,
                support_sets.pt, reconstructor.pt}, tensorboard/}

which a finished run copies to experiments/complete/<name>/ (without
checkpoint.pt), where :mod:`warpedganspace_torch.cli.traverse_latent_space`
reads it. The flag surface is that of :mod:`warpedganspace_tpu.cli.train`,
so the commands of ``scripts/train/*.sh`` run as they are:

- ``--steps-per-call k``: k iterations per call, one CUDA graph of k steps on
  the card (k eager steps on the CPU); k must divide ``--log-freq`` and
  ``--ckp-freq``.
- ``--remat {off,tail,full}``: recompute generator blocks in the backward
  (StyleGAN2 and ProgGAN; see their modules).
- ``--profile``: a ``torch.profiler`` trace of the loop under ``<wip>/profile``.
- ``--pair-layout``: accepted; the port has one layout, NCHW.
- ``--multi-device``: data parallel over the processes of a group, one
  process per card, as ``torchrun`` launches them: each rank takes its slice
  of the global ``--batch-size``, only the S and R gradients and R's
  BatchNorm moments are reduced, and rank 0 writes the one tree
  (:mod:`warpedganspace_torch.parallel.mesh`). Without a group it is the
  single-card run. Refused before anything is written: several processes
  without it, a batch the ranks do not split evenly, and one process that
  sees several cards (the JAX package's in-process mesh; here each card is a
  process of its own).
- ``--checkpoint-backend orbax`` is the JAX package's and is refused before
  anything is written.

``--cuda`` (the default) trains on the CUDA device and fails without one;
``--no-cuda`` trains on the CPU (a group on gloo).

    torchrun --nproc-per-node 4 -m warpedganspace_torch.cli.train --multi-device ...

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
from warpedganspace_torch.models.gan_load import build_gan
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.parallel import mesh
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
    parser.add_argument("--checkpoint-backend", type=str, default="pt", choices=("pt", "orbax"),
                        help="'pt' (default): the reference-format checkpoint.pt and the "
                             "optimizer sidecar; 'orbax' is the JAX package's and is refused")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed of the initial S and R and of the batch stream")
    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="iterations per call: one CUDA graph of k training steps on the "
                             "card (must divide --log-freq and --ckp-freq)")
    parser.add_argument("--remat", type=str, nargs="?", const="tail", default="off",
                        choices=("off", "tail", "full"),
                        help="recompute generator blocks in the backward (StyleGAN2, ProgGAN): "
                             "bare --remat = 'tail', the blocks of < 128 channels; 'full' "
                             "every block")
    parser.add_argument("--profile", action="store_true",
                        help="record a torch.profiler trace of the training loop")
    parser.add_argument("--pair-layout", type=str, default="auto",
                        choices=("auto", "nhwc", "s2d"),
                        help="accepted for the JAX package's scripts; the port hands the "
                             "image pair to R in its one layout, NCHW")
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
    parser.add_argument("--multi-device", action="store_true",
                        help="data parallel over the ranks of a process group, one card "
                             "each (launch with torchrun --nproc-per-node N)")
    parser.set_defaults(cuda=True)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    # A group from torchrun's environment (none without it); every check
    # below runs on every rank before anything is written.
    mesh.initialize_distributed(backend=None if args.cuda else "gloo")
    world = mesh.world_size()

    # Check what every run needs BEFORE the experiment directory exists, so a
    # wrong launch leaves no 'None-...-KNone-DNone' tree behind.
    for flag, val in (("--gan-type", args.gan_type),
                      ("-K/--num-support-sets", args.num_support_sets),
                      ("-D/--num-support-dipoles", args.num_support_dipoles)):
        if val is None:
            parser.error(f"{flag} is required")
    if args.gan_type == "BigGAN" and args.biggan_target_classes is None:
        parser.error("In case of BigGAN, a list of classes needs to be determined.")
    if args.checkpoint_backend == "orbax":
        parser.error("--checkpoint-backend orbax is the JAX package's; the port writes 'pt'")
    error = mesh.launch_error(args.multi_device, args.cuda)
    if error:
        parser.error(error)
    data_parallel = args.multi_device and mesh.active()
    if data_parallel and args.batch_size % world:
        parser.error(f"--batch-size {args.batch_size} does not split evenly over "
                     f"{world} ranks")
    if args.steps_per_call < 1:
        parser.error(f"--steps-per-call must be at least 1, got {args.steps_per_call}")
    for flag, freq in (("--ckp-freq", args.ckp_freq), ("--log-freq", args.log_freq)):
        if freq % args.steps_per_call:
            parser.error(f"--steps-per-call {args.steps_per_call} must divide {flag} ({freq})")
    device = select_device(args.cuda)

    # Create output dir and save current arguments (the args.json contract);
    # under a group the coordinator writes them.
    exp_dir = create_exp_dir(args, write=mesh.is_coordinator())
    say = print if mesh.is_coordinator() else (lambda *a, **kw: None)

    say("#. Build GAN generator model G and load with pre-trained weights...")
    say("  \\__GAN type: {}".format(args.gan_type))
    if args.gan_type == "StyleGAN2":
        say("  \\__Search for paths in {}-space".format("W" if args.shift_in_w_space else "Z"))
    if args.z_truncation:
        say("  \\__Input noise truncation: {}".format(args.z_truncation))
    say("  \\__Pre-trained weights: {}".format(
        GAN_WEIGHTS[args.gan_type]["weights"][args.stylegan2_resolution]
        if args.gan_type == "StyleGAN2"
        else GAN_WEIGHTS[args.gan_type]["weights"][GAN_RESOLUTIONS[args.gan_type]]))
    if args.pair_layout != "auto":
        say("  \\__Pair layout: NCHW, the port's one layout (--pair-layout {} has no "
              "effect)".format(args.pair_layout))
    G = build_gan(gan_type=args.gan_type,
                  target_classes=args.biggan_target_classes,
                  stylegan2_resolution=args.stylegan2_resolution,
                  shift_in_w_space=args.shift_in_w_space, device=device, remat=args.remat)

    say("#. Build Support Sets S...")
    say("  \\__Number of Support Sets    : {}".format(args.num_support_sets))
    say("  \\__Number of Support Dipoles : {}".format(args.num_support_dipoles))
    say("  \\__Support Vectors dim       : {}".format(G.dim_z))
    say("  \\__Learn RBF alphas          : {}".format(args.learn_alphas))
    say("  \\__Learn RBF gammas          : {}".format(args.learn_gammas))
    if not args.learn_gammas:
        say("  \\__RBF gamma                 : {}".format(
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

    say("#. Build reconstructor model R...")
    R = Reconstructor(reconstructor_type=args.reconstructor_type,
                      dim=args.num_support_sets,
                      channels=1 if args.gan_type == "SNGAN_MNIST" else 3,
                      generator=init_gen)

    if data_parallel:
        say("#. Data parallel over {} ranks, {} images each".format(
            world, args.batch_size // world))
    say("#. Experiment: {}".format(exp_dir))
    trn = Trainer(params=args, exp_dir=exp_dir, seed=args.seed, data_parallel=data_parallel)
    trn.train(generator=G, support_sets=S, reconstructor=R, profile=args.profile)
    return trn


if __name__ == "__main__":
    main()
