"""Experiment bookkeeping and the terminal progress UI of the CLIs.

The port's own copies of what it needs from :mod:`warpedganspace_tpu.utils.aux`
(reference lib/aux.py): ``experiment_name`` / ``create_exp_dir`` (:56-104; the
directory name is the experiment's identity for every later stage, so its
encoding is the reference's byte for byte), ``update_progress`` /
``update_stdout`` (:107-132), ``sec2dhms`` (:134-151), and ``get_wh`` and
``create_summarizing_gif`` (:154-260; the ranking stage's GIFs, with the JAX
package's PIL calls, so that the bytes it writes are the same).
"""
from __future__ import annotations

import json
import math
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


def create_exp_dir(args, root: str = "experiments", write: bool = True) -> str:
    """Create experiments/wip/<name>/, write args.json and command.sh, return the name.

    ``args`` is an argparse.Namespace or a dict. args.json is what the
    traversal and evaluation stages read back (reference lib/aux.py:95-97).
    ``write=False`` (every rank but the coordinator of a multi-process run)
    creates the directory and returns the name, and leaves the two files to
    the coordinator.
    """
    args_dict = args if isinstance(args, dict) else vars(args)
    name = experiment_name(args_dict)
    wip_dir = osp.join(root, "wip", name)
    os.makedirs(wip_dir, exist_ok=True)
    if write:
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


def get_wh(img_paths):
    """Common (width, height) of a list of same-resolution images
    (reference lib/aux.py:154-175)."""
    from PIL import Image

    widths, heights = [], []
    for f in img_paths:
        with Image.open(f) as im:
            widths.append(im.width)
            heights.append(im.height)
    if len(set(widths)) == len(set(heights)) == 1:
        return widths[0], heights[0]
    raise ValueError("Inconsistent image resolutions in {}".format(img_paths))


def create_summarizing_gif(
    imgs_root: str,
    gif_filename: str,
    num_imgs: int | None = None,
    gif_size: int | None = None,
    gif_fps: int = 30,
    gap: int = 15,
    progress_bar_h: int = 15,
    progress_bar_color=(252, 186, 3),
) -> None:
    """Summarizing GIF: a static strip of ``num_imgs`` frames, a gap, then an
    animated pane cycling through all frames with a progress bar
    (reference lib/aux.py:178-260)."""
    from PIL import Image, ImageDraw

    if not osp.isdir(imgs_root):
        raise NotADirectoryError("Invalid directory: {}".format(imgs_root))

    frames = sorted(
        osp.join(imgs_root, f)
        for f in os.listdir(imgs_root)
        if osp.isfile(osp.join(imgs_root, f))
    )
    total = len(frames)
    num_imgs = total if num_imgs is None else min(num_imgs, total)

    static_files = [
        osp.join(imgs_root, "{:06}.jpg".format(i))
        for i in range(0, total, math.ceil(total / num_imgs))
    ]
    n_static = len(static_files)

    if gif_size is not None:
        gif_w = gif_h = gif_size
    else:
        with Image.open(static_files[0]) as im:
            gif_w, gif_h = im.width, im.height

    static_strip = Image.new("RGB", size=(n_static * gif_w, gif_h))
    for i, f in enumerate(static_files):
        static_strip.paste(Image.open(f).resize((gif_w, gif_h)), (i * gif_w, 0))

    gif_frames = []
    for i, f in enumerate(frames):
        frame = Image.new(
            "RGB", size=((n_static + 1) * gif_w + gap, gif_h), color=(255, 255, 255)
        )
        frame.paste(static_strip, (0, 0))
        frame.paste(Image.open(f).resize((gif_w, gif_h)), (n_static * gif_w + gap, 0))
        if progress_bar_h > 0:
            draw = ImageDraw.Draw(frame)
            progress = (i / total) * gif_w
            draw.rectangle(
                xy=[
                    n_static * gif_w + gap,
                    gif_h - progress_bar_h,
                    n_static * gif_w + gap + progress,
                    gif_h,
                ],
                fill=progress_bar_color,
            )
        gif_frames.append(frame)

    gif_frames[0].save(
        fp=gif_filename,
        append_images=gif_frames[1:],
        save_all=True,
        optimize=False,
        loop=0,
        duration=1000 // gif_fps,
    )
