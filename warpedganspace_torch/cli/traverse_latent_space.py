"""Latent-space traversal CLI (reference ``traverse_latent_space.py``).

Traverses the latent space of a trained experiment's GAN along the K warped
paths for every latent code of a pool, and writes the reference results tree:

    <EXP_DIR>/results/<pool>/<2*steps>_<eps>_<len>/<hash>/
        paths_images/path_<k>/<t:06d>.jpg
        paths_latent_codes.pt
        original_image.jpg
    (+ paths_gifs/path_<k>.gif with --gif)

The path integration runs one warp call per step for all codes and paths
(the CUDA kernel on a CUDA device, see traverse/engine.py); the frames are
rendered in device batches and JPEG-encoded on a host thread pool.

Several processes split the sorted latent codes, ``codes[i::n]``, and each
writes the hash dirs of its own codes (no collective): under a process group
(``torchrun`` with ``--multi-device``, which a group requires: one card per
rank) the split is over the ranks, and after a barrier the coordinator alone
collates the GIFs; with
``--num-shards``/``--shard-index`` it is over unconnected processes, which
cannot collate (``--gif`` is refused there).

    python -m warpedganspace_torch.cli.traverse_latent_space --exp <EXP_DIR> --pool <POOL>
    torchrun --nproc-per-node 4 -m warpedganspace_torch.cli.traverse_latent_space \
        --multi-device --exp <EXP_DIR> --pool <POOL> --gif
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from warpedganspace_torch.cli.sample_gan import select_device
from warpedganspace_torch.models.api import cast_params_bf16
from warpedganspace_torch.models.gan_load import build_gan
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.parallel import mesh
from warpedganspace_torch.traverse.engine import iter_rendered_u8, traverse_paths
from warpedganspace_torch.traverse.gifs import collate_traversal_gifs
from warpedganspace_torch.traverse.writer import AsyncImageWriter
from warpedganspace_torch.utils.aux import update_progress, update_stdout
from warpedganspace_torch.utils.io import load_pt, save_pt


def build_parser():
    parser = argparse.ArgumentParser(description="WarpedGANSpace latent space traversal script")
    parser.add_argument("-v", "--verbose", action="store_true", help="set verbose mode on")
    parser.add_argument("--exp", type=str, required=True,
                        help="set experiment's model dir (created by `train.py`)")
    parser.add_argument("--pool", type=str, required=True,
                        help="directory of pre-defined pool of latent codes (created by `sample_gan.py`)")
    parser.add_argument("--shift-steps", type=int, default=16,
                        help="set number of shifts per positive/negative path direction")
    parser.add_argument("--eps", type=float, default=0.2, help="set shift step magnitude")
    parser.add_argument("--shift-leap", type=int, default=1,
                        help="set path shift leap (after how many steps to generate images)")
    parser.add_argument("--batch-size", type=int,
                        help="set generator batch size (if not set, use the total number of images per path)")
    parser.add_argument("--img-size", type=int,
                        help="set size of saved generated images (if not set, use the output "
                             "size of the respective GAN generator)")
    parser.add_argument("--img-quality", type=int, default=75, help="set JPEG image quality")
    parser.add_argument("--gif", action="store_true", help="Create GIF traversals")
    parser.add_argument("--gif-size", type=int, default=256, help="set gif resolution")
    parser.add_argument("--gif-fps", type=int, default=30, help="set gif frame rate")
    parser.add_argument("--cuda", dest="cuda", action="store_true",
                        help="run on the CUDA device (default)")
    parser.add_argument("--no-cuda", dest="cuda", action="store_false",
                        help="run on the CPU")
    parser.add_argument("--dtype", type=str, default="float32", choices=("float32", "bfloat16"),
                        help="generator render dtype (the warp integration always runs in float32)")
    parser.add_argument("--multi-device", action="store_true",
                        help="split the codes over the ranks of a process group, one card "
                             "each (launch with torchrun --nproc-per-node N); required "
                             "under a group")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="unconnected processes splitting the latent codes (each "
                             "traverses codes shard-index::num-shards)")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="this process's shard index in [0, num-shards)")
    parser.add_argument("--warp-backend", type=str, default="auto",
                        choices=("auto", "cuda", "torch"),
                        help="RBF warp implementation for path integration: the CUDA kernel "
                             "(auto on a CUDA device) or the plain PyTorch version")
    parser.set_defaults(cuda=True)
    return parser


def _support_sets_file(models_dir: str) -> str:
    """support_sets.pt, else the newest support_sets-<iter>.pt by numeric iteration
    (the reference's lexicographic sort would pick 9000 over 10000)."""
    final = osp.join(models_dir, "support_sets.pt")
    if osp.isfile(final):
        return final

    def _ckpt_iter(f):
        try:
            return int(f.split("support_sets-")[1].split(".pt")[0])
        except (IndexError, ValueError):
            return -1

    ckpts = sorted((f for f in os.listdir(models_dir) if "support_sets-" in f), key=_ckpt_iter)
    if not ckpts:
        raise FileNotFoundError("No support sets weights found under {}".format(models_dir))
    return osp.join(models_dir, ckpts[-1])


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh.initialize_distributed(backend=None if args.cuda else "gloo")
    # An invalid split must fail even when splitting is off, not traverse
    # every code in every process.
    if args.num_shards < 1:
        raise ValueError(f"--num-shards must be >= 1 (got {args.num_shards})")
    if not 0 <= args.shard_index < args.num_shards:
        raise ValueError(f"--shard-index {args.shard_index} out of range for "
                         f"{args.num_shards} shards")
    error = mesh.launch_error(args.multi_device, args.cuda)
    if error:
        parser.error(error)
    grouped = mesh.world_size() > 1
    if grouped:
        if args.num_shards != 1:
            parser.error("--num-shards is for unconnected processes; under a process "
                         "group the codes are split over the ranks")
        args.num_shards, args.shard_index = mesh.world_size(), mesh.rank()
    elif args.num_shards > 1 and args.gif:
        raise ValueError("--gif needs every code's frames on disk: collate the GIFs in "
                         "an unsplit pass after all shards have finished")
    device = select_device(args.cuda)

    if not osp.isdir(args.exp):
        raise NotADirectoryError("Invalid given directory: {}".format(args.exp))
    args_json_file = osp.join(args.exp, "args.json")
    if not osp.isfile(args_json_file):
        raise FileNotFoundError("File not found: {}".format(args_json_file))
    with open(args_json_file) as f:
        args_json = argparse.Namespace(**json.load(f))
    gan_type = args_json.gan_type

    models_dir = osp.join(args.exp, "models")
    if not osp.isdir(models_dir):
        raise NotADirectoryError("Invalid models directory: {}".format(models_dir))
    support_sets_model = _support_sets_file(models_dir)

    pool = osp.join("experiments", "latent_codes")
    if gan_type == "BigGAN":
        classes = "".join("-{}".format(c) for c in args_json.biggan_target_classes)
        pool = osp.join(pool, gan_type + classes, args.pool)
    else:
        pool = osp.join(pool, gan_type, args.pool)
    if not osp.isdir(pool):
        raise NotADirectoryError(
            "Invalid pool directory: {} -- Please run sample_gan.py to create it.".format(pool))

    if args.verbose:
        print("#. Build GAN generator model G and load with pre-trained weights...")
        print("  \\__GAN type: {}".format(gan_type))
    shift_in_w_space = bool(getattr(args_json, "shift_in_w_space", False))
    G = build_gan(gan_type=gan_type,
                  target_classes=getattr(args_json, "biggan_target_classes", None),
                  stylegan2_resolution=getattr(args_json, "stylegan2_resolution", 1024),
                  shift_in_w_space=shift_in_w_space, device=device)

    if args.verbose:
        print("#. Build support sets model S...")
        print("  \\__Pre-trained weights: {}".format(support_sets_model))
    S = SupportSets(num_support_sets=args_json.num_support_sets,
                    num_support_dipoles=args_json.num_support_dipoles,
                    support_vectors_dim=G.dim_z,
                    learn_alphas=args_json.learn_alphas,
                    learn_gammas=args_json.learn_gammas,
                    gamma=1.0 / G.dim_z if args_json.gamma is None else args_json.gamma)
    S.from_torch_state_dict(load_pt(support_sets_model)).to(device)

    out_dir = osp.join(args.exp, "results", args.pool, "{}_{}_{}".format(
        2 * args.shift_steps, args.eps, round(2 * args.shift_steps * args.eps, 3)))
    os.makedirs(out_dir, exist_ok=True)
    if args.batch_size is None:
        args.batch_size = 2 * args.shift_steps + 1

    if args.verbose:
        print("#. Use latent codes from pool {}...".format(args.pool))
    latent_codes_dirs = sorted(d for d in os.listdir(pool) if osp.isdir(osp.join(pool, d)))
    if not latent_codes_dirs:
        # Empty everywhere: a failed sampling, not a split with nothing left.
        raise ValueError(f"latent-code pool {pool} contains no latent codes")
    latent_codes_dirs = mesh.partition_work(latent_codes_dirs, args.num_shards,
                                            args.shard_index)
    if latent_codes_dirs:
        _traverse_codes(args, G, S, pool, latent_codes_dirs, out_dir, shift_in_w_space,
                        device)
    elif not grouped:
        print("#. Shard {}/{} has no latent codes; nothing to do.".format(
            args.shard_index, args.num_shards))
        return

    # The tree is whole once every rank's writer is done; the GIFs read it all.
    mesh.sync_processes("traversal-frames-done")
    if args.gif and mesh.is_coordinator():
        collate_traversal_gifs(out_dir, S.num_support_sets, gif_size=args.gif_size,
                               gif_fps=args.gif_fps, verbose=args.verbose)


def _traverse_codes(args, G, S, pool, latent_codes_dirs, out_dir, shift_in_w_space, device):
    """Integrate the paths of these codes and write their hash dirs."""
    num_gen_paths = S.num_support_sets
    zs = np.concatenate([np.asarray(load_pt(osp.join(pool, d, "latent_code.pt")))
                         for d in latent_codes_dirs]).astype(np.float32)

    if args.verbose:
        print("#. Traverse latent space...")
        print("  \\__Experiment       : {}".format(osp.basename(osp.abspath(args.exp))))
        print("  \\__Shift magnitude  : {}".format(args.eps))
        print("  \\__Shift steps      : {}".format(2 * args.shift_steps))
        print("  \\__Traversal length : {}".format(round(2 * args.shift_steps * args.eps, 3)))
        print("  \\__Save results at  : {}".format(out_dir))

    with torch.no_grad():
        latents = torch.from_numpy(zs).to(device)
        if shift_in_w_space:
            latents = G.get_w(latents)  # the warp integration stays float32
        codes, shifts = traverse_paths(S, latents, eps=args.eps, shift_steps=args.shift_steps,
                                       shift_leap=args.shift_leap, backend=args.warp_backend)
    codes_np = codes.cpu().numpy()
    G_render = cast_params_bf16(G) if args.dtype == "bfloat16" else G
    render_dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    with AsyncImageWriter() as writer:
        _traverse_all(args, G_render, render_dtype, codes, shifts, codes_np, latent_codes_dirs,
                      num_gen_paths, out_dir, shift_in_w_space, writer)


def _traverse_all(args, G, render_dtype, codes, shifts, codes_np, latent_codes_dirs,
                  num_gen_paths, out_dir, shift_in_w_space, writer):
    num_codes = len(latent_codes_dirs)
    num_frames = codes.shape[2]
    for i, latent_code_hash in enumerate(latent_codes_dirs):
        if args.verbose:
            update_progress("  \\__.Latent code hash: {} [{:03d}/{:03d}] ".format(
                latent_code_hash, i + 1, num_codes), num_codes, i)
        latent_code_dir = osp.join(out_dir, latent_code_hash)
        path_dirs = []
        for dim in range(num_gen_paths):
            d = osp.join(latent_code_dir, "paths_images", "path_{:03d}".format(dim))
            os.makedirs(d, exist_ok=True)
            path_dirs.append(d)

        # All of this code's frames (every path x every step) as one render
        # stream: frames of different paths share device batches and come
        # back as uint8; JPEG encodes overlap on the writer's threads.
        flat_codes = codes[i].reshape(num_gen_paths * num_frames, -1)
        flat_shifts = shifts[i].reshape(num_gen_paths * num_frames, -1)
        done_paths = 0
        for start, imgs in iter_rendered_u8(G, flat_codes, flat_shifts, args.batch_size,
                                            latent_is_w=shift_in_w_space, dtype=render_dtype):
            for j in range(imgs.shape[0]):
                dim, t = divmod(start + j, num_frames)
                writer.submit(imgs[j], osp.join(path_dirs[dim], "{:06d}.jpg".format(t)),
                              img_size=args.img_size, quality=args.img_quality)
                if dim == 0 and t == num_frames // 2:
                    writer.submit(imgs[j], osp.join(latent_code_dir, "original_image.jpg"),
                                  img_size=args.img_size, quality=95)
            if args.verbose:
                completed = (start + imgs.shape[0]) // num_frames
                while done_paths < completed:
                    done_paths += 1
                    print()
                    update_progress("      \\__path: {:03d}/{:03d} ".format(
                        done_paths, num_gen_paths), num_gen_paths, done_paths)
                    update_stdout(1)

        # (K, T, dim) latent codes of all paths for this sample (reference :488-490).
        save_pt(codes_np[i], osp.join(latent_code_dir, "paths_latent_codes.pt"))
        if args.verbose:
            update_stdout(1)
            print()
            print()


if __name__ == "__main__":
    main()
