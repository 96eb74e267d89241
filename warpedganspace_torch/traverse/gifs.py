"""Traversal GIF collation (parity: traverse_latent_space.py:79-116,497-567).

For each path, every latent code contributes a row of
[original image | current traversal frame + progress bar]; rows are stacked
vertically and the frames are animated into paths_gifs/path_<k>.gif.
"""
from __future__ import annotations

import os
import os.path as osp

from PIL import Image, ImageDraw

from warpedganspace_torch.utils.aux import update_progress


def concat_pair(
    img_file_orig: str,
    shifted_img_file: str,
    size: int,
    img_id: str,
    s: int,
    shift_steps: int,
    path_id: int,
    draw_header: bool = False,
    draw_progress_bar: bool = True,
) -> Image.Image:
    """Horizontally concatenate original | shifted frame, with optional header
    and a progress bar along the bottom of the shifted pane."""
    img_orig = Image.open(img_file_orig).resize((size, size))
    img_shifted = Image.open(shifted_img_file).resize((size, size))

    dst = Image.new("RGB", (img_orig.width + img_shifted.width, img_orig.height))
    dst.paste(img_orig, (0, 0))
    dst.paste(img_shifted, (img_orig.width, 0))

    if draw_header:
        draw = ImageDraw.Draw(dst)
        draw.rectangle(xy=[(6, 6), (276, 19)], fill=(0, 0, 0))
        draw.text((8, 8), "{}/{:03d}".format(img_id, path_id), fill=(255, 255, 255))

    if draw_progress_bar:
        draw = ImageDraw.Draw(dst)
        bar_h = 7
        draw.rectangle(
            xy=[(size, size - bar_h), ((1 + s / shift_steps) * size, size)],
            fill=(252, 186, 3),
        )
    return dst


def collate_traversal_gifs(
    out_dir: str,
    num_paths: int,
    gif_size: int = 256,
    gif_fps: int = 30,
    verbose: bool = False,
):
    """Build paths_gifs/path_<k>.gif from the rendered traversal tree under
    ``out_dir`` (one sub-directory per latent-code hash)."""
    img_ids = sorted(
        d
        for d in os.listdir(out_dir)
        if osp.isdir(osp.join(out_dir, d)) and d not in ("paths_gifs", "validation_results")
    )
    os.makedirs(osp.join(out_dir, "paths_gifs"), exist_ok=True)

    print("#. Collate GIFs...")
    if not img_ids:
        # Nothing traversed (e.g. an empty results tree) — skip cleanly.
        print("  \\__No rendered latent-code directories found; nothing to collate")
        return
    for dim in range(num_paths):
        if verbose:
            update_progress(
                "  \\__path: {:03d}/{:03d} ".format(dim + 1, num_paths), num_paths, dim + 1
            )
        rows = []
        n_frames = None
        for img_id in img_ids:
            original = osp.join(out_dir, img_id, "original_image.jpg")
            frames_dir = osp.join(out_dir, img_id, "paths_images", "path_{:03d}".format(dim))
            frame_files = sorted(
                f for f in os.listdir(frames_dir) if osp.isfile(osp.join(frames_dir, f))
            )
            # A partially-rendered tree (interrupted run) can leave codes with
            # fewer frames; collate the common prefix instead of IndexError.
            n_frames = (
                len(frame_files) if n_frames is None else min(n_frames, len(frame_files))
            )
            row = [
                concat_pair(
                    original,
                    osp.join(frames_dir, "{:06d}.jpg".format(t)),
                    size=gif_size,
                    img_id=img_id,
                    s=t,
                    shift_steps=len(frame_files),
                    path_id=dim,
                )
                for t in range(len(frame_files))
            ]
            rows.append(row)

        full_frames = []
        for f in range(int(n_frames)):
            frame = Image.new("RGB", (2 * gif_size, len(img_ids) * gif_size))
            for i in range(len(img_ids)):
                frame.paste(rows[i][f], (0, i * gif_size))
            full_frames.append(frame)

        lead = Image.new(mode="RGB", size=(2 * gif_size, len(img_ids) * gif_size))
        lead.save(
            fp=osp.join(out_dir, "paths_gifs", "path_{:03d}.gif".format(dim)),
            append_images=full_frames,
            save_all=True,
            optimize=True,
            loop=0,
            duration=1000 // gif_fps,
        )
