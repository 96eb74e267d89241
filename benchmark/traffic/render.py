"""Traffic ``render``: the traversal stage's device path.

As ``cli/traverse_latent_space.py`` drives the port: a pool of codes (drawn
from the seed; mapped to W in float32 where the paths live in W) is
integrated along all K paths by ``traverse_paths`` (one warp launch a step),
then each code's K x T frames go through ``iter_rendered_u8`` in render
batches of the configured size and dtype, and arrive on the host as uint8,
one code after another. Pools follow each other until the window ends; the
window ends at the first delivered batch after ``--seconds``. Nothing is
encoded or written: the host's JPEG writer is another layer.

Parameters (the workload file's ``params``): ``codes`` a pool, ``eps``,
``shift_steps`` each way, ``batch``, ``dtype`` of the render, and
``check_frames``, the frames kept (a reservoir sample drawn from the seed
over all delivered frames) for the output check.

The check (``check``): every pool integrated in the window, all codes and
paths, against the plain warp integrated in float64 (``warp_gap``: the
largest difference of a stored code or shift, in units of ``eps``); each
kept frame against the plain generator rendering the reference's own code
and shift in float32. A frame's gap is its RMS distance from the reference
scaled to [0, 255], in units of the reference image's own RMS
(``frame_gap``, the largest frame's); ``frame_ratio`` is the median frame's
gap over the gap that the reference rendered at the configuration's own
precision shows on that frame. The ratio is what the cells compare: the gap
alone swings from seed to seed with how much a random generator's frames
show its rounding, the ratio does not. The workload's ``limits`` name the
numbers a cell compares.
"""
from __future__ import annotations

import random
import time

import torch
from torch.profiler import record_function

from benchmark import inputs
from benchmark.reference import frames as ref_frames
from benchmark.reference import quant
from benchmark.reference import warp as ref_warp


def _build(run):
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.support_sets import SupportSets

    cfg, dev = run.config, run.device
    sd_g = run.family.make_weights(cfg, inputs.generator(run.seed, "generator", dev), dev)
    sd_s = inputs.support_sets_state_dict(cfg, inputs.generator(run.seed, "support_sets", dev),
                                          dev)
    G = run.family.build_program(cfg, sd_g, dev)
    d = cfg["support_vectors_dim"]
    S = SupportSets(num_support_sets=cfg["num_support_sets"],
                    num_support_dipoles=cfg["num_support_dipoles"], support_vectors_dim=d,
                    learn_alphas=cfg["learn_alphas"], learn_gammas=cfg["learn_gammas"],
                    gamma=1.0 / d)
    S.from_torch_state_dict(sd_s).to(dev)
    bf16 = run.params["dtype"] == "bfloat16"
    return {"G": G, "S": S, "G_render": cast_params_bf16(G) if bf16 else G,
            "dtype": torch.bfloat16 if bf16 else torch.float32,
            "w": cfg["latent_space"] == "w"}


def _integrate(run, st, index):
    from warpedganspace_torch.traverse.engine import traverse_paths

    p = run.params
    z = inputs.pool(run.config, run.seed, index, p["codes"], run.device)
    latents = st["G"].get_w(z) if st["w"] else z
    return traverse_paths(st["S"], latents, eps=p["eps"], shift_steps=p["shift_steps"])


def _stream(run, st, codes, shifts, i):
    from warpedganspace_torch.traverse.engine import iter_rendered_u8

    flat_c = codes[i].reshape(codes.shape[1] * codes.shape[2], -1)
    flat_s = shifts[i].reshape(shifts.shape[1] * shifts.shape[2], -1)
    return iter_rendered_u8(st["G_render"], flat_c, flat_s, run.params["batch"],
                            latent_is_w=st["w"], dtype=st["dtype"])


@torch.no_grad()
def setup(run):
    st = _build(run)
    # The cell's shapes: one pool's integration, two render batches.
    codes, shifts = _integrate(run, st, 0)
    stream = _stream(run, st, codes, shifts, 0)
    for _ in range(2):
        next(stream)
    stream.close()
    return st


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, key, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, make()))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (key, make())


@torch.no_grad()
def window(run, st):
    keep = Reservoir(run.params["check_frames"], inputs.sub_seed(run.seed, "check"))
    frames, pools = 0, []
    t0 = time.perf_counter()
    deadline, now, index = t0 + run.seconds, t0, 0
    while now < deadline:
        with record_function("bench.integrate"):
            codes, shifts = _integrate(run, st, index)
        pools.append((index, codes, shifts))
        for i in range(codes.shape[0]):
            stream = _stream(run, st, codes, shifts, i)
            while now < deadline:
                with record_function("bench.render_batch"):
                    item = next(stream, None)
                if item is None:
                    break
                start, imgs = item
                for j in range(imgs.shape[0]):
                    keep.offer((index, i, start + j), imgs[j].copy)
                frames += imgs.shape[0]
                now = time.perf_counter()
            stream.close()
            if now >= deadline:
                break
        index += 1
    elapsed = now - t0
    st["kept"], st["pools"] = keep.items, pools
    return {"values": {"render_frames_per_s": frames / elapsed}, "work": {"frames": frames},
            "attempted": frames}


def outputs(run, st):
    """The window's stored codes and shifts (on the host) and the kept frames."""
    return {"pools": [(i, c.cpu(), s.cpu()) for i, c, s in st["pools"]],
            "frames": [(key, torch.from_numpy(img)) for key, img in st["kept"]]}


def _reference_paths(run, index, q_map, q_warp, warp_dtype):
    cfg, dev = run.config, run.device
    sd_g = run.family.make_weights(cfg, inputs.generator(run.seed, "generator", dev), dev)
    sd_s = inputs.support_sets_state_dict(cfg, inputs.generator(run.seed, "support_sets", dev),
                                          dev)
    z = inputs.pool(cfg, run.seed, index, run.params["codes"], dev)
    latents = run.family.build_reference(cfg, sd_g, q_map).latent(z)
    return sd_g, ref_warp.integrate(sd_s, latents, run.params["eps"],
                                    run.params["shift_steps"], dtype=warp_dtype, q=q_warp)


@torch.no_grad()
def render_reference(run, out, q_render=quant.exact, q_map=quant.exact, q_warp=quant.exact,
                     warp_dtype=torch.float64, q_stated=None):
    """The reference's own paths of every pool of ``out`` and its frames at the
    kept frames' positions: (scaled to [0, 255], a level's size over the
    image's RMS) and, with ``q_stated``, the gap that the reference rendered
    at the configuration's own precision shows against it. With the ``q_*``
    of a lower precision, the control's paths and frames."""
    quant.no_tf32()
    paths, frames = {}, {}
    for index, _, _ in out["pools"]:
        sd_g, (codes, shifts) = _reference_paths(run, index, q_map, q_warp, warp_dtype)
        paths[index] = (codes, shifts)
        G = run.family.build_reference(run.config, sd_g, q_render)
        G_stated = q_stated and run.family.build_reference(run.config, sd_g, q_stated)
        t = codes.shape[2]
        for key, _ in out["frames"]:
            if key[0] != index:
                continue
            _, i, flat = key
            k, step = divmod(flat, t)
            code, shift = codes[i, k, step][None], shifts[i, k, step][None]
            img = G.render(code, shift)
            ref, level = ref_frames.scaled_255(img)[0], ref_frames.level_size(img)[0]
            stated = None
            if G_stated:
                as_u8 = ref_frames.scaled_255(G_stated.render(code, shift))[0].to(torch.uint8)
                stated = ref_frames.relative_gap(as_u8, ref, level)
            frames[key] = (ref, level, stated)
    return paths, frames


def readings(run, out, paths, frames) -> dict:
    """Every number the check can compare."""
    eps, dev = run.params["eps"], run.device
    warp_gap = 0.0
    for index, codes, shifts in out["pools"]:
        rc, rs = paths[index]
        warp_gap = max(warp_gap, float((codes.to(dev) - rc).abs().max()) / eps,
                       float((shifts.to(dev) - rs).abs().max()) / eps)
    gaps, ratios = [], []  # per kept frame
    for key, img in out["frames"]:
        ref, level, stated = frames[key]
        gaps.append(ref_frames.relative_gap(img.to(dev), ref, level))
        ratios.append(gaps[-1] / max(stated, 1e-12))
    gaps.sort()
    ratios.sort()
    none = float("inf")
    return {"warp_gap": warp_gap, "frame_gap": gaps[-1] if gaps else none,
            "frame_ratio": ratios[len(ratios) // 2] if ratios else none,
            "frame_ratio_max": ratios[-1] if ratios else none}


def gaps(run, out) -> dict:
    """The program's readings: ``out`` against the reference."""
    return readings(run, out, *render_reference(run, out,
                                                q_stated=quant.STATED[run.params["dtype"]]))


def check(run, out) -> dict:
    """The numbers compared, each with its limit from the workload file."""
    values = gaps(run, out)
    return {name: {"value": values[name], "limit": limit}
            for name, limit in run.cell["limits"].items()}


def control(run, out) -> dict:
    """The control in the program's place: the reference one precision below
    the configuration's (the warp and the W mapping below float32, the render
    below its dtype), producing what the program produces (stored paths, and
    uint8 frames truncated to levels as the program truncates them), read as
    :func:`check` reads the program."""
    below_f32, below_render = quant.BELOW["float32"], quant.BELOW[run.params["dtype"]]
    paths, frames = render_reference(run, out, q_render=below_render, q_map=below_f32,
                                     q_warp=below_f32, warp_dtype=torch.float32)
    ctl = {"pools": [(i, *paths[i]) for i, _, _ in out["pools"]],
           "frames": [(key, frames[key][0].to(torch.uint8)) for key, _ in out["frames"]]}
    return gaps(run, ctl)
