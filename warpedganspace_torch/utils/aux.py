"""Experiment bookkeeping and the terminal progress UI of the CLIs.

The port's own copies of what it needs from :mod:`warpedganspace_tpu.utils.aux`
(reference lib/aux.py): ``experiment_name`` / ``create_exp_dir`` (:56-104; the
directory name is the experiment's identity for every later stage, so its
encoding is the reference's byte for byte), ``update_progress`` /
``update_stdout`` (:107-132) and ``sec2dhms`` (:134-151).
"""
from __future__ import annotations

import json
import os
import os.path as osp
import sys


def experiment_name(args: dict) -> str:
    """Canonical experiment directory name (reference lib/aux.py:60-90).

    Format: <gan>(-<res>-{Z,W})(-<classes>)-<R>-K<k>-D<d>(-LearnAlphas)
            (-LearnGammas)-eps<min>_<max>
    """
    gan_type = args["gan_type"]
    name = str(gan_type)
    if gan_type == "StyleGAN2":
        name += "-{}".format(args["stylegan2_resolution"])
        name += "-W" if args.get("shift_in_w_space") else "-Z"
    if gan_type == "BigGAN":
        name += "-" + "".join("{}".format(c) for c in args["biggan_target_classes"])
    name += "-{}".format(args["reconstructor_type"])
    name += "-K{}-D{}".format(args["num_support_sets"], args["num_support_dipoles"])
    if args.get("learn_alphas"):
        name += "-LearnAlphas"
    if args.get("learn_gammas"):
        name += "-LearnGammas"
    name += "-eps{}_{}".format(args["min_shift_magnitude"], args["max_shift_magnitude"])
    return name


def create_exp_dir(args, root: str = "experiments") -> str:
    """Create experiments/wip/<name>/, write args.json and command.sh, return the name.

    ``args`` is an argparse.Namespace or a dict. args.json is what the
    traversal and evaluation stages read back (reference lib/aux.py:95-97).
    """
    args_dict = args if isinstance(args, dict) else vars(args)
    name = experiment_name(args_dict)
    wip_dir = osp.join(root, "wip", name)
    os.makedirs(wip_dir, exist_ok=True)
    with open(osp.join(wip_dir, "args.json"), "w") as f:
        json.dump(args_dict, f)
    with open(osp.join(wip_dir, "command.sh"), "w") as f:
        f.write("#!/usr/bin/bash\n")
        f.write(" ".join(sys.argv) + "\n")
    return name


def update_progress(msg: str, total: int, progress: int) -> None:
    """One-line block progress bar (reference lib/aux.py:107-120)."""
    bar_length, status = 20, ""
    frac = float(progress) / float(total)
    if frac >= 1.0:
        frac, status = 1, "\r\n"
    block = int(round(bar_length * frac))
    text = "\r{}{} {:.0f}% {}".format(
        msg, "█" * block + "░" * (bar_length - block), round(frac * 100, 0), status
    )
    sys.stdout.write(text)
    sys.stdout.flush()


def update_stdout(num_lines: int) -> None:
    """Move the cursor up and erase the given number of lines (lib/aux.py:122-132)."""
    for _ in range(num_lines):
        print("\x1b[1A" + "\x1b[1A")


def sec2dhms(t: float) -> str:
    """Format seconds as 'DD days, HH hours, MM minutes, and SS seconds'."""
    t = float(t)
    day, t = divmod(t, 24 * 3600)
    hour, t = divmod(t, 3600)
    minutes, seconds = divmod(t, 60)
    return "%02d days, %02d hours, %02d minutes, and %02d seconds" % (day, hour, minutes, seconds)
