"""Attribute-space traversal CLI (reference ``traverse_attribute_space.py``).

Counterpart of :mod:`warpedganspace_tpu.cli.traverse_attribute_space`. For
every latent-code hash of a traversal config, it measures six predictor
families over the saved JPEG frames of each path and writes the reference's
files and arrays (:538-605):

    <hash>/eval_json/{face_bbox,identity,age,race,gender,pose,au,celeba_*}.json
    <hash>/eval_np/{face_width,face_height,identity,age,race,gender,yaw,pitch,
                    roll,celeba_*,au_<n>_<name>}.npy        (paths, frames) each

A path is decoded and resized on a host thread pool while the device works on
the one before (``_prep_path``). Its 256² frame batch is uploaded once; the
identity input is an affine of it on the device and the FairFace, Hopenet and
AU face crops are gathers from it on the device (``evalzoo/crop_resize.py``),
driven by the rectangles of the host's NMS. The CelebA input (224² of the full
frame) is the path's second upload.

    python -m warpedganspace_torch.cli.traverse_attribute_space --exp <EXP_DIR> \\
        --pool <POOL> --shift-steps 20 --eps 0.15

``--cuda`` (the default) runs on the CUDA device, in float32 with TF32 off, and
fails without one; ``--no-cuda`` runs on the CPU. ``--num-shards`` and
``--shard-index`` split the sorted hash list, ``hashes[i::n]``, between
unconnected processes. Under a process group (``torchrun`` with
``--multi-device``, which a group requires: one card per rank) the ranks split
the work inside a latent code, as the JAX package splits a path's frames over
the cards of its local mesh: each rank evaluates its contiguous block of the
code-major list of ``(hash, path)`` pairs on its own card (every result is a
path's own, so no step needs a collective), the coordinator gathers the
per-path records and alone writes ``eval_json/`` and ``eval_np/``, as one
process writes them, and a barrier at the end holds every rank until they are
written.

    torchrun --nproc-per-node 4 -m warpedganspace_torch.cli.traverse_attribute_space \\
        --multi-device --exp <EXP_DIR> --pool <POOL> --shift-steps 20 --eps 0.15
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from warpedganspace_torch.cli.sample_gan import select_device
from warpedganspace_torch.evalzoo import load as zoo
from warpedganspace_torch.evalzoo.crop_resize import crop_resize, plan_crop_resize
from warpedganspace_torch.evalzoo.hopenet import Hopenet
from warpedganspace_torch.evalzoo.transforms import crop_rect, normalize_imagenet, resize_center
from warpedganspace_torch.parallel import mesh
from warpedganspace_torch.utils.aux import update_progress, update_stdout
from warpedganspace_torch.utils.data import PathImages
from warpedganspace_torch.utils.io import load_pt

# Action Units (reference :16-29).
AUs = {
    "au_1": "Inner_Brow_Raiser",
    "au_2": "Outer_Brow_Raiser",
    "au_4": "Brow_Lowerer",
    "au_5": "Upper_Lid_Raiser",
    "au_6": "Cheek_Raiser",
    "au_9": "Nose_Wrinkler",
    "au_12": "Lip_Corner_Puller",
    "au_15": "Lip_Corner_Depressor",
    "au_17": "Chin_Raiser",
    "au_20": "Lip_stretcher",
    "au_25": "Lips_part",
    "au_26": "Jaw_Drop",
}
CELEBA_KEYS = {"Bangs": "celeba_bangs", "Eyeglasses": "celeba_eyeglasses",
               "No_Beard": "celeba_beard", "Smiling": "celeba_smiling", "Young": "celeba_age"}
# Directories of a traversal config that are no latent-code hash.
NOT_HASHES = ("paths_gifs", "validation_results", "interpretable_paths")


def build_parser():
    parser = argparse.ArgumentParser(description="WarpedGANSpace attribute space traversal script")
    parser.add_argument("-v", "--verbose", action="store_true", help="set verbose mode on")
    parser.add_argument("--exp", type=str, required=True,
                        help="set experiment's model dir (created by `train.py` and used by "
                             "`traverse_latent_space.py`.)")
    parser.add_argument("--pool", type=str, required=True,
                        help="choose pool of pre-defined latent codes and their latent traversals")
    parser.add_argument("--shift-steps", type=int, default=16,
                        help="number of shifts per positive/negative path direction")
    parser.add_argument("--eps", type=float, help="shift magnitude")
    parser.add_argument("--cuda", dest="cuda", action="store_true",
                        help="run on the CUDA device (default)")
    parser.add_argument("--no-cuda", dest="cuda", action="store_false", help="run on the CPU")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="total number of independent processes splitting the hash dirs "
                             "(each evaluates hashes shard-index::num-shards)")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="this process's shard index in [0, num-shards)")
    parser.add_argument("--multi-device", action="store_true",
                        help="split the (hash, path) pairs over the ranks of a process group, "
                             "one card each (launch with torchrun --nproc-per-node N); "
                             "required under a group")
    parser.set_defaults(cuda=True)
    return parser


def load_predictors(device):
    """The six predictor families from the models/pretrained/ weights, on ``device``."""
    return {
        "sfd": zoo.load_sfd(device=device),
        "id": zoo.load_arcface(device=device),
        "fairface": zoo.load_fairface(device=device),
        "hopenet": zoo.load_hopenet(device=device),
        "au": zoo.load_audetector(device=device),
        "celeba": zoo.load_celeba(device=device),
    }


def _prep_path(path_dir: str, gan_type: str):
    """Host stage of one path, run on the prefetch pool: the JPEG decode and
    the two full-frame resizes, 256² and CelebA's 224² (the face crops come
    later, on the device). Returns two (T, 3, S, S) float32 CPU tensors."""
    frames = torch.from_numpy(PathImages(path_dir).load_all()).permute(0, 3, 1, 2).contiguous()
    frames256 = resize_center(frames, 256).contiguous()     # [0, 255]
    # CelebA normalisation (reference :346-365): StyleGAN2 frames are taken as
    # [-1, 1]-scaled; the others are min-max normalised over the whole path.
    if gan_type == "StyleGAN2":
        celeba_norm = frames / 255.0 * 2.0 - 1.0
    else:
        lo, hi = frames.min(), frames.max()
        celeba_norm = (frames - lo) / (hi - lo)
    celeba_in = normalize_imagenet(resize_center(celeba_norm, 224)).contiguous()
    return frames256, celeba_in


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def _path_count(h_dir: str) -> tuple:
    """(paths, frames a path) of a hash dir, from its stored codes."""
    return tuple(np.asarray(load_pt(osp.join(h_dir, "paths_latent_codes.pt"))).shape[:2])


@torch.no_grad()
def evaluate_path(frames256: torch.Tensor, celeba_in: torch.Tensor, predictors: dict,
                  device) -> dict:
    """The six predictor families on one path's prepared frames (the body of
    the reference's per-path loop, :300-531). Returns the path's record:
    ``{"json": {dicts key: value}, "np": {nps key: row}, "aus": (12, T)}``."""
    num_per_path = frames256.shape[0]
    js, rows = {}, {}
    f256 = frames256.to(device)            # the path's one 256² upload

    # --- face detection (:316-340) ---------------------------------------------
    detected_faces, _, _ = predictors["sfd"].detect_from_batch(f256)
    bbox_list, face_w, face_h = [], [], []
    for t in range(num_per_path):
        if len(detected_faces[t]) > 0:
            bbox = list(np.asarray(detected_faces[t][0], dtype=float))
            bbox_list.append(bbox)
            face_w.append((bbox[2] - bbox[0]) / 256.0)
            face_h.append((bbox[3] - bbox[1]) / 256.0)
        else:
            # The reference's value for a frame without a face.
            face_w.append(256.0)
            face_h.append(256.0)
    js["face_bbox"] = bbox_list
    rows["face_width"] = face_w
    rows["face_height"] = face_h

    # --- CelebA attributes (:346-387): softmax as exp / sum, as written.
    preds = predictors["celeba"](celeba_in.to(device))
    for attr, logits in preds.items():
        e = torch.exp(logits)
        p = (e / e.sum(dim=1, keepdim=True)).cpu().numpy()
        final = (np.argmax(p, axis=1) + np.max(p, axis=1)) / 6.0
        rows[CELEBA_KEYS[attr]] = final
        js[CELEBA_KEYS[attr]] = final.tolist()

    # --- identity against the centre frame (:395-415). The reference walks
    # outward one pair a forward; its list is [cos(centre, frame t)] in frame
    # order, which one batched call computes.
    scaled = f256 / 255.0 * 2.0 - 1.0
    center = scaled[num_per_path // 2][None].expand_as(scaled)
    id_scores = predictors["id"].similarities(center, scaled).cpu().tolist()
    js["id"] = id_scores
    rows["identity"] = id_scores

    # --- face crops, gathered on the device from the 256² batch; the host
    # gives only the NMS rectangles (:423-531; the /255 commutes with the
    # linear resize).
    def cropped_batch(size, padding, divide):
        h, w = f256.shape[-2:]
        rects = [crop_rect(detected_faces[t][0][:-1] if len(detected_faces[t]) > 0
                           else [0, 0, 256, 256], h, w, padding)
                 for t in range(len(detected_faces))]
        crops = crop_resize(f256, plan_crop_resize(rects, size))
        return crops / 255.0 if divide else crops

    outputs = predictors["fairface"](normalize_imagenet(
        cropped_batch(224, 0.25, divide=True))).cpu().numpy()
    gender = _softmax_rows(outputs[:, 7:9])
    rows["gender"] = gender[:, 1]
    js["gender"] = gender[:, 1].tolist()
    for key, lo, hi in (("age", 9, 18), ("race", 0, 7)):
        probs = _softmax_rows(outputs[:, lo:hi])
        pred = (np.argmax(probs, axis=1) + np.max(probs, axis=1)) / (hi - lo)
        rows[key] = pred
        js[key] = pred.tolist()

    # --- pose (:475-504) ---------------------------------------------------------
    logits = predictors["hopenet"](normalize_imagenet(cropped_batch(224, 0.0, divide=True)))
    degs = [Hopenet.angles_deg(lg).cpu().numpy() for lg in logits]
    js["pose"] = [deg.tolist() for deg in degs]
    for key, deg in zip(("yaw", "pitch", "roll"), degs):
        rows[key] = deg * np.pi / 180

    # --- action units (:512-531) -------------------------------------------------
    intensities = predictors["au"].detect_AU(
        cropped_batch(256, 0.0, divide=False)).cpu().numpy().T     # (12, T)
    js["aus"] = [intensities[t].tolist() for t in range(len(AUs))]
    return {"json": js, "np": rows, "aus": intensities}


def evaluate_paths(pairs, predictors: dict, gan_type: str, device, verbose: bool = False):
    """Yield ``(h_dir, d, record)`` of :func:`evaluate_path` for each
    ``(hash dir, path index)`` of ``pairs``, in order. A path is prepared
    (``_prep_path``) on a host pool of ``mesh.host_threads()`` threads, three
    pairs ahead, while the device works on the one before."""
    pairs = list(pairs)

    def prep(i):
        h_dir, d = pairs[i]
        return pool.submit(_prep_path, osp.join(h_dir, "paths_images", f"path_{d:03d}"),
                           gan_type)

    pool = ThreadPoolExecutor(max_workers=mesh.host_threads())
    prefetch = 3
    prepped = {i: prep(i) for i in range(min(prefetch, len(pairs)))}
    try:
        for i, (h_dir, d) in enumerate(pairs):
            if verbose:
                update_progress("               \\__path: {:03d} of {} ".format(
                    d + 1, osp.basename(h_dir)), len(pairs), i + 1)
            frames256, celeba_in = prepped.pop(i).result()
            if i + prefetch < len(pairs):
                prepped[i + prefetch] = prep(i + prefetch)
            yield h_dir, d, evaluate_path(frames256, celeba_in, predictors, device)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def write_hash_outputs(h_dir: str, records: dict, num_per_path: int) -> None:
    """Write a hash dir's ``eval_json/`` and ``eval_np/`` (reference
    :538-605) from its per-path records ``{path index: record}``, filled in
    path order."""
    num_of_paths = len(records)
    dicts = {k: {} for k in ("face_bbox", "id", "gender", "age", "race", "pose", "aus",
                             *CELEBA_KEYS.values())}
    nps = {k: np.zeros((num_of_paths, num_per_path))
           for k in ("face_width", "face_height", "identity", "gender", "age", "race",
                     "yaw", "pitch", "roll", *CELEBA_KEYS.values())}
    aus_np = np.zeros((len(AUs), num_of_paths, num_per_path))
    for d in sorted(records):
        rec = records[d]
        for key, value in rec["json"].items():
            dicts[key][d] = value
        for key, row in rec["np"].items():
            nps[key][d] = row
        aus_np[:, d, :] = rec["aus"]

    json_dir, np_dir = osp.join(h_dir, "eval_json"), osp.join(h_dir, "eval_np")
    os.makedirs(json_dir, exist_ok=True)
    os.makedirs(np_dir, exist_ok=True)

    def dump(json_name, d_key, np_names):
        with open(osp.join(json_dir, json_name + ".json"), "w") as f:
            json.dump(dicts[d_key], f)
        for np_name in np_names:
            np.save(osp.join(np_dir, np_name + ".npy"), nps[np_name])

    dump("face_bbox", "face_bbox", ["face_width", "face_height"])
    dump("identity", "id", ["identity"])
    dump("age", "age", ["age"])
    dump("race", "race", ["race"])
    dump("gender", "gender", ["gender"])
    dump("pose", "pose", ["yaw", "pitch", "roll"])
    with open(osp.join(json_dir, "au.json"), "w") as f:
        json.dump(dicts["aus"], f)
    for t, k in enumerate(AUs):
        np.save(osp.join(np_dir, "{}_{}.npy".format(k, AUs[k])), aus_np[t])
    for name in CELEBA_KEYS.values():
        dump(name, name, [name])


def evaluate_hash_dir(h_dir: str, predictors: dict, gan_type: str, device,
                      verbose: bool = False) -> None:
    """Evaluate every path of one latent-code hash dir and write its outputs
    (the reference's per-hash loop, :252-605)."""
    num_of_paths, num_per_path = _path_count(h_dir)
    records = {d: rec for _, d, rec in evaluate_paths(
        [(h_dir, d) for d in range(num_of_paths)], predictors, gan_type, device, verbose)}
    write_hash_outputs(h_dir, records, num_per_path)


def evaluate_split(h_dirs: list, predictors: dict, gan_type: str, device,
                   verbose: bool = False) -> None:
    """The hash dirs of one traversal config under a process group: this
    rank evaluates its contiguous block of the code-major ``(hash, path)``
    pairs; the coordinator gathers every rank's records and writes each hash
    dir's outputs as one process writes them."""
    shapes = {h: _path_count(h) for h in h_dirs}
    pairs = [(h, d) for h in h_dirs for d in range(shapes[h][0])]
    mine = mesh.rank_block(pairs, mesh.world_size(), mesh.rank())
    records = [(h, d, rec) for h, d, rec in evaluate_paths(mine, predictors, gan_type, device,
                                                             verbose)]
    gathered = mesh.gather_to_coordinator(records)
    if gathered is None:
        return
    by_hash = {h: {} for h in h_dirs}
    for h, d, rec in (r for rank_records in gathered for r in rank_records):
        by_hash[h][d] = rec
    for h in h_dirs:
        write_hash_outputs(h, by_hash[h], shapes[h][1])


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh.initialize_distributed(backend=None if args.cuda else "gloo")
    # An invalid split must fail, not evaluate everything.
    if args.num_shards < 1:
        raise ValueError(f"--num-shards must be >= 1 (got {args.num_shards})")
    if not 0 <= args.shard_index < args.num_shards:
        raise ValueError(f"--shard-index {args.shard_index} out of range for "
                         f"{args.num_shards} shards")
    error = mesh.launch_error(args.multi_device, args.cuda)
    if error:
        parser.error(error)
    grouped = mesh.world_size() > 1
    if grouped and args.num_shards != 1:
        parser.error("--num-shards is for unconnected processes; under a process "
                     "group the (hash, path) pairs are split over the ranks")
    device = select_device(args.cuda)
    if device.type == "cuda":
        # float32 as in the JAX package: cuDNN would otherwise take TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    latent_traversal_dir = osp.join(args.exp, "results", args.pool)
    if not osp.isdir(args.exp):
        raise NotADirectoryError("Error: invalid experiment's directory: {}".format(args.exp))
    args_json_file = osp.join(args.exp, "args.json")
    if not osp.isfile(args_json_file):
        raise FileNotFoundError("File not found: {}".format(args_json_file))
    with open(args_json_file) as f:
        gan_type = json.load(f)["gan_type"]
    if not osp.isdir(latent_traversal_dir):
        raise NotADirectoryError("Error: pool directory {} not found under {}".format(
            args.pool, osp.join(args.exp, "results")))

    # Without --eps, every traversal config of the pool (the reference's
    # intended auto-discovery, which its --shift-steps default makes unreachable).
    if args.eps is None:
        configs = sorted(d for d in os.listdir(latent_traversal_dir)
                         if osp.isdir(osp.join(latent_traversal_dir, d)))
    else:
        configs = ["{}_{}_{}".format(2 * args.shift_steps, args.eps,
                                     round(2 * args.shift_steps * args.eps, 3))]
    if args.verbose:
        print("#. Calculate attribute traversals in {}".format(latent_traversal_dir))
        print("  \\__.Latent space traversal configs: {}".format(configs))

    predictors = load_predictors(device)
    for l_config in configs:
        if args.verbose:
            print("       \\__.Latent space traversal config: {}".format(l_config))
        hashes_dir = osp.join(latent_traversal_dir, l_config)
        hashes = sorted(d for d in os.listdir(hashes_dir)
                        if osp.isdir(osp.join(hashes_dir, d)) and d not in NOT_HASHES)
        if grouped:
            evaluate_split([osp.join(hashes_dir, h) for h in hashes], predictors, gan_type,
                           device, verbose=args.verbose)
            continue
        hashes = mesh.partition_work(hashes, args.num_shards, args.shard_index)
        for cnt, h in enumerate(hashes, start=1):
            if args.verbose:
                print("           \\__.hash: {} [{}/{}]".format(h, cnt, len(hashes)))
            evaluate_hash_dir(osp.join(hashes_dir, h), predictors, gan_type, device,
                              verbose=args.verbose)
    # What a later stage reads (the ranking, on the coordinator) is whole
    # once every rank is done.
    mesh.sync_processes("attribute-eval-done")
    if args.verbose:
        update_stdout(1)
        print()


if __name__ == "__main__":
    main()
