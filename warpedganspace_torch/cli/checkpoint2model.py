"""Checkpoint splitter CLI (reference ``checkpoint2model.py``).

Counterpart of :mod:`warpedganspace_tpu.cli.checkpoint2model`: splits
``<exp>/models/checkpoint.pt`` into ``support_sets-<iter>.pt`` and
``reconstructor-<iter>.pt``, the weight files that
:mod:`warpedganspace_torch.cli.traverse_latent_space` falls back to (the
newest ``support_sets-<iter>.pt``) when there is no final ``support_sets.pt``.
The JAX package's orbax checkpoints are not read: a ``models/orbax``
directory without ``checkpoint.pt`` is an error that says so.

    python -m warpedganspace_torch.cli.checkpoint2model --exp experiments/wip/<name>
"""
from __future__ import annotations

import argparse
import os.path as osp

from warpedganspace_torch.utils.io import load_pt, save_pt


def build_parser():
    parser = argparse.ArgumentParser(description="Convert a checkpoint file into a support "
                                                 "sets and a reconstructor weights files")
    parser.add_argument("--exp", type=str, required=True,
                        help="set experiment's model dir (created by `train.py`)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    if not osp.isdir(args.exp):
        raise NotADirectoryError("Invalid given directory: {}".format(args.exp))
    models_dir = osp.join(args.exp, "models")
    if not osp.isdir(models_dir):
        raise NotADirectoryError("Invalid models directory: {}".format(models_dir))
    checkpoint_file = osp.join(models_dir, "checkpoint.pt")
    if not osp.isfile(checkpoint_file):
        if osp.isdir(osp.join(models_dir, "orbax")):
            raise FileNotFoundError(
                "Checkpoint file not found: {} -- {} holds an orbax checkpoint of the JAX "
                "package, which this port does not read (split it with the JAX package's "
                "checkpoint2model)".format(checkpoint_file, models_dir))
        raise FileNotFoundError("Checkpoint file not found: {}".format(checkpoint_file))

    print("#. Convert checkpoint file into support sets and reconstructor weight files...")
    ckpt = load_pt(checkpoint_file)
    it = ckpt["iter"]
    print("  \\__Checkpoint iteration: {}".format(it))
    print("  \\__Save checkpoint support sets weights file...")
    save_pt(ckpt["support_sets"], osp.join(models_dir, "support_sets-{}.pt".format(it)))
    print("  \\__Save checkpoint reconstructor weights file...")
    save_pt(ckpt["reconstructor"], osp.join(models_dir, "reconstructor-{}.pt".format(it)))


if __name__ == "__main__":
    main()
