"""Path-ranking CLI (reference ``rank_interpretable_paths.py``).

Ranks the K discovered paths by |correlation| between attribute traversals and
the step index, for a chosen attribute group; writes per-attribute sorted CSVs,
the diagonal cross-attribute CSV, top-k summarizing GIFs, the
interpretable_paths.json index, and the top-k markdown summary — all under
<hashes_root>/interpretable_paths/Group_<group>/ with the reference layout
(:119-214, :342-480).

The port's counterpart of :mod:`warpedganspace_tpu.cli.rank_interpretable_paths`,
run as ``python -m warpedganspace_torch.cli.rank_interpretable_paths``. It
writes the same files byte for byte without pandas: the CSVs are the text
``DataFrame.to_csv`` writes (:func:`write_csv`), and each attribute's ranking
is the row order of ``DataFrame.sort_values(ascending=False)``
(:func:`sort_descending`), which decides the order of tied paths in the JSON
and in the GIF names. Each path's GIF is made once and copied to every name
the top-k lists give it (:func:`write_gifs`).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from warpedganspace_torch.ranking.engine import (
    ATTRIBUTE_GROUPS,
    l1_normalize_rows,
    path_attribute_correlations,
)
from warpedganspace_torch.utils.aux import create_summarizing_gif


def write_csv(path, header, index, rows, float_format):
    """``pandas.DataFrame(rows, index=index).to_csv(path, header=header[1:],
    index_label=header[0] or None, float_format=float_format)``: a header line,
    then each row's index and its values in ``float_format``, NaN as an empty
    field, ``\\n`` line ends."""
    lines = [",".join(header)]
    for i, row in zip(index, rows):
        lines.append(",".join([str(i)] + ["" if np.isnan(v) else float_format % v
                                          for v in row]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def sort_descending(values: np.ndarray) -> np.ndarray:
    """The row order of ``DataFrame.sort_values(by=column, ascending=False)``
    (pandas' ``nargsort``): the non-NaN values and their indices reversed,
    an unstable ``argsort(kind="quicksort")``, reversed again, then the NaN
    rows in their original order."""
    mask = np.isnan(values)
    idx = np.arange(len(values))
    non_nans = values[~mask][::-1]
    non_nan_idx = idx[~mask][::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([indexer, np.nonzero(mask)[0]])


def save_results(attributes, attr_idx_corr, metric, interpretable_paths_dict,
                 summary_md_dict, create_gifs=True, top_k=3, num_imgs=7,
                 gif_size=256, gif_fps=30, hashes_root=None, hashes=None,
                 interpretable_paths_root=None, gifs_written=None):
    """Write CSVs / GIFs for one metric (reference :96-178). ``gifs_written``
    is :func:`write_gifs`' record, shared by the metrics of one config."""
    out_dir = osp.join(interpretable_paths_root, metric)
    os.makedirs(out_dir, exist_ok=True)

    paths = np.arange(attr_idx_corr.shape[0])
    write_csv(osp.join(out_dir, "attr_idx_{}.csv".format(metric)), ["path_id"] + attributes,
              paths, attr_idx_corr, "%.3f")

    top_k_paths = {i: [] for i in range(top_k)}
    first_rows = []
    for t in range(attr_idx_corr.shape[1]):
        order = sort_descending(attr_idx_corr[:, t])
        first_rows.append(attr_idx_corr[order[0]])
        interpretable_paths_dict[metric][attributes[t]] = order.tolist()
        for i in range(top_k):
            top_k_paths[i].append(int(order[i]))
        write_csv(osp.join(out_dir, "attr_idx_{}_sorted_by_{}.csv".format(metric, attributes[t])),
                  [""] + attributes, order, attr_idx_corr[order], "%.3f")

    write_csv(osp.join(out_dir, "attr_idx_{}_diag.csv".format(metric)), [""] + attributes,
              range(len(first_rows)), first_rows, "%.2f")

    if create_gifs:
        gifs = []
        for a, attr in enumerate(attributes):
            attr_dir = osp.join(out_dir, attr)
            os.makedirs(attr_dir, exist_ok=True)
            for k in range(top_k):
                for h in hashes:
                    imgs_root = osp.join(hashes_root, h, "paths_images",
                                         "path_{:03d}".format(top_k_paths[k][a]))
                    gif_filename = osp.join(attr_dir, "{}_{}_{}_{}.gif".format(
                        attr, k + 1, top_k_paths[k][a], h))
                    gifs.append((imgs_root, gif_filename))
                    summary_md_dict[attr][h][metric][k + 1] = top_k_paths[k][a]
        write_gifs(gifs, {} if gifs_written is None else gifs_written, num_imgs=num_imgs,
                   gif_size=gif_size, gif_fps=gif_fps)


def write_gifs(gifs, written: dict, **kwargs) -> None:
    """Write each ``(imgs_root, gif_filename)`` summarizing GIF.

    A GIF is a function of its frames and ``kwargs`` alone, so each path's is
    made once, by the first file that names it, and copied to the others:
    the same path is often among the top k of several attributes and of
    both metrics. ``written`` maps a frames directory to the file made from
    it, across calls. Nearly all of a GIF's time is PIL's palette quantizer,
    which releases the GIL: the new ones are made by one thread each, up to
    one per core.
    """
    targets: dict[str, list] = {}
    for imgs_root, gif_filename in gifs:
        targets.setdefault(imgs_root, []).append(gif_filename)
    new = [root for root in targets if root not in written]
    with ThreadPoolExecutor(max(1, min(len(new), os.cpu_count() or 1))) as pool:
        list(pool.map(lambda root: create_summarizing_gif(
            imgs_root=root, gif_filename=targets[root][0], **kwargs), new))
    written.update((root, targets[root][0]) for root in new)
    for root, filenames in targets.items():
        for gif_filename in filenames:
            if gif_filename != written[root]:
                shutil.copyfile(written[root], gif_filename)


def create_summary_md_file(attr_group, summary_md_dict, metric, top_k=3, hashes=None,
                           interpretable_paths_root=None):
    """Top-k .md summary (reference :181-214)."""
    md_file = osp.join(interpretable_paths_root,
                       "top-{}_interpretable_path_{}.md".format(top_k, attr_group))
    with open(md_file, "w") as f:
        f.write("# Attribute group: {}\n".format(attr_group))
        attributes = tuple(a for a in ATTRIBUTE_GROUPS[attr_group] if a != "identity")
        for attr in attributes:
            f.write("## {}\n".format(attr))
            for h in hashes:
                f.write("### Latent code: {}\n".format(h))
                for m in metric.split("+"):
                    f.write("#### Metric: {}\n".format(m))
                    f.write('<p align="center">\n')
                    for k in range(top_k):
                        path_id = summary_md_dict[attr][h][m][k + 1]
                        gif_file = osp.join(m, attr, "{}_{}_{}_{}.gif".format(attr, k + 1, path_id, h))
                        mouseover = "top-{} interpretable path [path_id: {}] for {}".format(
                            k + 1, path_id, attr)
                        f.write('<img src="{}" title="{}"/>\n'.format(gif_file, mouseover))
                    f.write("</p>\n")


def build_parser():
    parser = argparse.ArgumentParser(description="WarpedGANSpace interpretable path ranking script")
    parser.add_argument("-v", "--verbose", action="store_true", help="set verbose mode on")
    parser.add_argument("--exp", type=str, required=True,
                        help="set experiment's model dir (created by `train.py` and used by "
                             "`traverse_latent_space.py` and `traverse_attribute_space.py`.)")
    parser.add_argument("--pool", type=str, required=True, help="set pool of latent codes")
    parser.add_argument("--shift-steps", type=int, default=16,
                        help="number of shifts per positive/negative path direction")
    parser.add_argument("--eps", type=float, help="shift magnitude")
    parser.add_argument("--gif", dest="gif", action="store_true", help="create summarizing GIF files")
    parser.add_argument("--no-gif", dest="gif", action="store_false",
                        help="do NOT create summarizing GIF files")
    parser.set_defaults(gif=True)
    parser.add_argument("--num-imgs", type=int,
                        help="set number of static images per sequence")
    parser.add_argument("--gif-size", type=int, default=256, help="GIF image size")
    parser.add_argument("--gif-fps", type=int, default=30, help="set GIF frame rate")
    parser.add_argument("--top-k", type=int, default=3,
                        help="create summarizing GIFs for the top-k interpretable path "
                             "for each latent code and each attribute")
    parser.add_argument("--attr-group", type=str, required=True,
                        choices=list(ATTRIBUTE_GROUPS.keys()),
                        help="set attribute group -- see ranking/engine.py ATTRIBUTE_GROUPS")
    parser.add_argument("--metric", type=str, default="corr+corr_l1",
                        choices=("corr", "corr_l1", "corr+corr_l1"),
                        help="choose path ranking metric")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    latent_traversal_dir = osp.join(args.exp, "results", args.pool)
    if not osp.isdir(args.exp):
        raise NotADirectoryError("Error: invalid experiment's directory: {}".format(args.exp))
    if not osp.isdir(latent_traversal_dir):
        raise NotADirectoryError("Error: pool directory {} not found under {}".format(
            args.pool, osp.join(args.exp, "results")))

    # The reference gates auto-discovery on BOTH flags being None, but its
    # --shift-steps has a default, making that branch unreachable (omitting
    # --eps then crashes computing the config name). Honor the documented
    # intent instead: no --eps -> scan the existing traversal config dirs.
    if args.eps is None:
        configs = [d for d in os.listdir(latent_traversal_dir)
                   if osp.isdir(osp.join(latent_traversal_dir, d))]
    else:
        configs = ["{}_{}_{}".format(2 * args.shift_steps, args.eps,
                                     round(2 * args.shift_steps * args.eps, 3))]

    attributes = ATTRIBUTE_GROUPS[args.attr_group]

    if args.verbose:
        print("#. Rank interpretable paths in {}".format(latent_traversal_dir))
        print("  \\__.Attributes group '{}': {}".format(args.attr_group, attributes))
        print("  \\__.Latent space traversal configs: {}".format(configs))

    for l_config in configs:
        if args.verbose:
            print("       \\__.Latent space traversal config: {}".format(l_config))
        # NOTE: the dir encodes <2*steps>_<eps>_<len>, so these names are
        # swapped — replicated verbatim from the reference's mislabeled unpack
        # (rank_interpretable_paths.py:312) so attributes_traversals_details
        # .json stays byte-compatible.
        eps, shift_steps, traversal_length = l_config.split("_")
        hashes_root = osp.join(latent_traversal_dir, l_config)
        hashes = [d for d in os.listdir(hashes_root)
                  if osp.isdir(osp.join(hashes_root, d))
                  and d not in ("paths_gifs", "interpretable_paths",
                                "validation_results")]

        # [num_samples, num_attributes, num_paths, num_points]
        all_attrs = []
        for i, h in enumerate(hashes):
            if args.verbose:
                print("           \\__.hash: {} [{}/{}]".format(h, i + 1, len(hashes)))
            np_dir = osp.join(hashes_root, h, "eval_np")
            sample = []
            for a in attributes:
                f = osp.join(np_dir, "{}.npy".format(a))
                try:
                    sample.append(np.load(f))
                except FileNotFoundError:
                    print("Attribute traversal file not found: {}".format(f))
            all_attrs.append(sample)
        # A hash with missing attribute files would make the nested list
        # ragged, and np.array would fail far from the cause — name the
        # deficient hashes instead.
        want = len(attributes)
        bad = [h for h, s_ in zip(hashes, all_attrs) if len(s_) != want]
        if bad:
            raise FileNotFoundError(
                "incomplete eval_np arrays for hash dir(s) {} — re-run "
                "traverse_attribute_space for this config".format(bad))
        attrs = np.array(all_attrs)
        # -> [num_samples, num_paths, num_attributes, num_points]
        attrs = np.transpose(attrs, axes=(0, 2, 1, 3))

        interp_root = osp.join(hashes_root, "interpretable_paths", "Group_{}".format(args.attr_group))
        os.makedirs(interp_root, exist_ok=True)

        n_samples, n_paths, n_attrs, n_points = attrs.shape
        if args.verbose:
            print("           \\__.Attributes matrix (ATTRIBUTES) : {}".format(attrs.shape))

        with open(osp.join(interp_root, "attributes_traversals_details.json"), "w") as fp:
            json.dump({
                "eps": eps,
                "shift_steps": shift_steps,
                "traversal_length": traversal_length,
                "num_of_samples": n_samples,
                "num_of_paths": n_paths,
                "num_of_attributes": n_attrs,
                "num_of_points_per_path": n_points,
            }, fp)
        with open(osp.join(hashes_root, "interpretable_paths", "attributes_groups.json"), "w") as fp:
            json.dump(ATTRIBUTE_GROUPS, fp)

        corr = path_attribute_correlations(attrs, attributes).mean(0)

        # Robustness fix over the reference: top-k cannot exceed the number of
        # discovered paths (the reference would IndexError).
        args.top_k = min(args.top_k, n_paths)

        interpretable_paths_dict = {m: {a: [] for a in attributes} for m in ("corr", "corr_l1")}
        summary_md_dict = {
            a: {h: {m: {k + 1: None for k in range(args.top_k)} for m in ("corr", "corr_l1")}
                for h in hashes}
            for a in attributes
        }

        common = dict(
            interpretable_paths_dict=interpretable_paths_dict,
            summary_md_dict=summary_md_dict,
            create_gifs=args.gif,
            top_k=args.top_k,
            num_imgs=args.num_imgs,
            gif_size=args.gif_size,
            gif_fps=args.gif_fps,
            hashes_root=hashes_root,
            hashes=hashes,
            interpretable_paths_root=interp_root,
            gifs_written={},
        )
        if args.metric in ("corr", "corr+corr_l1"):
            if args.verbose:
                print("               \\__.Correlation...")
            save_results(attributes=list(attributes), attr_idx_corr=np.abs(corr),
                         metric="corr", **common)
        if args.metric in ("corr_l1", "corr+corr_l1"):
            if args.verbose:
                print("               \\__.Correlation (L1-normalized)...")
            save_results(attributes=list(attributes),
                         attr_idx_corr=l1_normalize_rows(np.abs(corr)),
                         metric="corr_l1", **common)

        if args.verbose:
            print("           \\__.Create summary md file...")
        create_summary_md_file(attr_group=args.attr_group, summary_md_dict=summary_md_dict,
                               metric=args.metric, top_k=args.top_k, hashes=hashes,
                               interpretable_paths_root=interp_root)

        with open(osp.join(interp_root, "interpretable_paths.json"), "w") as fp:
            json.dump(interpretable_paths_dict, fp)


if __name__ == "__main__":
    main()
