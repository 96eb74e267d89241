"""Traffic ``train``: the contrastive training step, as ``cli/train.py`` and
``train/trainer.py`` drive it.

Set-up builds the port's training state (the frozen generator, the support
sets, the ResNet reconstructor, two capturable Adams) from the seed's
reference-layout weights, and drives that same state through its first
``checked_steps`` iterations by the window's own call and feed: each
iteration's batch is drawn on the card from the seed (``inputs.train_batch``)
and handed to ``train_step(..., batch=)``. The window goes on from there with
one ``train_step`` a call, the metric rows copied to the host once every
``log_freq`` iterations as ``Trainer``'s log window copies them (no
checkpoint), and ends at the first log boundary after ``--seconds``.

Parameters: ``batch`` (global), ``g_dtype`` and ``r_dtype`` (the script's
``--g-dtype``/``--r-dtype``), ``log_freq``, ``checked_steps``.

The check follows the checked steps with the plain reference from the same
weights and batches: ``loss_gap``, the largest relative gap of a step's total
loss; ``grad_gap``, the median over the leaves of the gap between the norms
of the first gradient as Adam got it (its first moment over 1 - beta1) and
the reference's, over the larger of the reference leaf's norm and the median
leaf's; ``update_gap``, the same for the parameters' change over the checked
steps. Leaves whose reference gradient is below a thousandth of the median
leaf's are left out of both. The median leaf and not the worst: the worst
is a small leaf at the front of R (the first BatchNorm's 64 shifts and
scales), whose gradient sums 3 M terms of the bfloat16 backward that nearly
cancel, and swings from seed to seed (PERF.md).
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import inputs
from benchmark.reference import quant
from benchmark.reference.step import BETAS, Step

_STEP1 = 1                      # iterations are numbered from 1, as the Trainer's


def _state_dicts(run):
    cfg, dev = run.config, run.device
    return (run.family.make_weights(cfg, inputs.generator(run.seed, "generator", dev), dev),
            inputs.support_sets_state_dict(cfg, inputs.generator(run.seed, "support_sets", dev),
                                           dev),
            inputs.resnet_state_dict(cfg, inputs.generator(run.seed, "reconstructor", dev), dev))


def _batch(run, iteration):
    return inputs.train_batch(run.config, run.seed, iteration, run.params["batch"], run.device)


def build_state(run):
    """The port's training state, as ``cli/train.py`` builds it, loaded from
    the seed's reference-layout weights."""
    from warpedganspace_torch.convert.reconstructor import load_reference_state_dict
    from warpedganspace_torch.models.reconstructor import Reconstructor
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.train.train_step import TrainStepConfig, init_train_state

    cfg, p = run.config, run.params
    sd_g, sd_s, sd_r = _state_dicts(run)
    G = run.family.build_program(cfg, sd_g, run.device)
    d = cfg["support_vectors_dim"]
    S = SupportSets(num_support_sets=cfg["num_support_sets"],
                    num_support_dipoles=cfg["num_support_dipoles"], support_vectors_dim=d,
                    learn_alphas=cfg["learn_alphas"], learn_gammas=cfg["learn_gammas"],
                    gamma=1.0 / d).from_torch_state_dict(sd_s)
    R = Reconstructor(reconstructor_type=cfg["reconstructor"], dim=cfg["num_support_sets"],
                      channels=cfg["reconstructor_channels"])
    load_reference_state_dict(R, sd_r)
    tcfg = TrainStepConfig(
        batch_size=p["batch"], num_support_sets=cfg["num_support_sets"],
        min_shift_magnitude=cfg["min_shift_magnitude"],
        max_shift_magnitude=cfg["max_shift_magnitude"], lambda_cls=cfg["lambda_cls"],
        lambda_reg=cfg["lambda_reg"], support_set_lr=cfg["support_set_lr"],
        reconstructor_lr=cfg["reconstructor_lr"], z_truncation=cfg["z_truncation"],
        shift_in_w_space=cfg["latent_space"] == "w", generator_dtype=p["g_dtype"],
        reconstructor_dtype=p["r_dtype"])
    return init_train_state(G, S, R, tcfg, seed=inputs.sub_seed(run.seed, "trainer"))


def leaves(state) -> dict:
    """The trained parameters by name: the support sets' and R's."""
    out = {n: t for n, t in state.S.named_parameters() if t.requires_grad}
    out.update(state.R.named_parameters())
    return out


def first_gradient(state) -> dict:
    """Each leaf's gradient of the first step as Adam got it: its first
    moment after one step over 1 - beta1, on the host (zero where Adam holds
    no moment: it got nothing)."""
    out = {}
    for opt in (state.opt_s, state.opt_r):
        for group in opt.param_groups:
            for t in group["params"]:
                moment = opt.state.get(t, {}).get("exp_avg", torch.zeros_like(t))
                out[id(t)] = (moment / (1 - BETAS[0])).cpu()
    return {n: out[id(t)] for n, t in leaves(state).items()}


def setup(run):
    from warpedganspace_torch.train.train_step import metric_row, train_step

    state = build_state(run)
    p0 = {n: t.detach().to("cpu", copy=True) for n, t in leaves(state).items()}
    rows, g1 = [], None
    for it in range(_STEP1, _STEP1 + run.params["checked_steps"]):
        rows.append(metric_row(train_step(state, it, batch=_batch(run, it))))
        if it == _STEP1:
            g1 = first_gradient(state)
    delta = {n: t.detach().cpu() - p0[n] for n, t in leaves(state).items()}
    return {"state": state, "checked": {"rows": torch.stack(rows).cpu(), "g1": g1,
                                        "delta": delta}}


def window(run, st):
    from warpedganspace_torch.train.train_step import metric_row, train_step

    state, p = st["state"], run.params
    it = _STEP1 + p["checked_steps"]
    pending, steps = [], 0
    t0 = time.perf_counter()
    deadline, now = t0 + run.seconds, t0
    while now < deadline:
        batch = _batch(run, it)
        with record_function("bench.train_step"):
            pending.append(metric_row(train_step(state, it, batch=batch)))
        it += 1
        steps += 1
        if steps % p["log_freq"] == 0:
            with record_function("bench.log_window"):
                torch.stack(pending).float().cpu()
            pending = []
            now = time.perf_counter()
    elapsed = now - t0
    samples = steps * p["batch"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    return {"values": {"train_samples_per_s": samples / elapsed,
                       "train_peak_mem_gib": peak / 2 ** 30},
            "work": {"samples": samples}, "attempted": steps}


def outputs(run, st):
    return st["checked"]


def reference_steps(run, q_g=quant.exact, q_map=quant.exact, q_r=quant.exact,
                    q_warp=quant.exact, rows=None):
    """The reference (with lower-precision ``q_*``, the control) through the
    checked steps on the same weights and batches: its losses, its first
    gradient and its parameters' change. ``rows`` (a slice) keeps only those
    rows of each batch: a planted fault."""
    quant.no_tf32()
    cfg = run.config
    sd_g, sd_s, sd_r = _state_dicts(run)
    G = run.family.build_reference(cfg, sd_g, q_g)
    if q_map is not q_g and hasattr(G, "mapping"):
        G_map = run.family.build_reference(cfg, sd_g, q_map)
        G.latent = G_map.latent
    ref = Step(cfg, G, sd_s, sd_r, q_r=q_r, q_warp=q_warp)
    start = {n: t.detach().clone() for n, t in ref.leaves.items()}
    losses, g1 = [], None
    for it in range(_STEP1, _STEP1 + run.params["checked_steps"]):
        loss, grads = ref.step(*(t[rows or slice(None)] for t in _batch(run, it)))
        losses.append(loss)
        if g1 is None:
            g1 = {n: g.detach() for n, g in grads.items()}
    delta = {n: (t.detach() - start[n]) for n, t in ref.leaves.items()}
    return losses, g1, delta


def leaf_gaps(got: dict, want: dict, names) -> list:
    """For each of ``names``: | ||got|| - ||want|| | over the larger of
    ||want|| and the median leaf's norm of ``want``."""
    norms = {n: float(torch.linalg.vector_norm(want[n].float())) for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    return [abs(float(torch.linalg.vector_norm(got[n].float())) - norms[n])
            / max(norms[n], median) for n in names]


def leaf_diffs(got: dict, want: dict, names) -> list:
    """For each of ``names``: ||got - want|| over the larger of ||want|| and
    the median leaf's norm of ``want``: the whole error, where a gap of norms
    sees only its part along ``want``."""
    norms = {n: float(torch.linalg.vector_norm(want[n].float())) for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    return [float(torch.linalg.vector_norm(got[n].float() - want[n].float()))
            / max(norms[n], median) for n in names]


def _median(values) -> float:
    return sorted(values)[len(values) // 2]


def readings(run, out, ref_losses, ref_g1, ref_delta) -> dict:
    """Every number the check can compare."""
    from warpedganspace_torch.core.stats import STAT_KEYS

    total = STAT_KEYS.index("total_loss")
    gaps = [abs(float(out["rows"][i, total]) - r["total_loss"]) / abs(r["total_loss"])
            for i, r in enumerate(ref_losses)]
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref_g1.items()}
    median = _median(list(norms.values()))
    names = [n for n, v in norms.items() if v >= 1e-3 * median]
    g1, ref_g1 = {n: out["g1"][n] for n in names}, {n: ref_g1[n].cpu() for n in names}
    delta = {n: out["delta"][n] for n in names}
    ref_delta = {n: ref_delta[n].cpu() for n in names}
    grad, change = leaf_gaps(g1, ref_g1, names), leaf_gaps(delta, ref_delta, names)
    grad_diff, change_diff = leaf_diffs(g1, ref_g1, names), leaf_diffs(delta, ref_delta, names)
    return {"loss_gap": gaps[0], "loss_gap_steps": max(gaps),
            "grad_gap": _median(grad), "grad_gap_worst": max(grad),
            "update_gap": _median(change), "grad_diff": _median(grad_diff),
            "update_diff": _median(change_diff)}


def gaps(run, out) -> dict:
    """The program's readings: ``out`` against the reference."""
    return readings(run, out, *reference_steps(run))


def check(run, out) -> dict:
    """The numbers compared, each with its limit from the workload file."""
    values = gaps(run, out)
    return {name: {"value": values[name], "limit": limit}
            for name, limit in run.cell["limits"].items()}


def _as_outputs(losses, g1, delta) -> dict:
    """A reference's readings in the form of the program's outputs."""
    from warpedganspace_torch.core.stats import STAT_KEYS

    rows = torch.zeros((len(losses), len(STAT_KEYS)))
    for i, loss in enumerate(losses):
        for k, v in loss.items():
            rows[i, STAT_KEYS.index(k)] = v
    return {"rows": rows, "g1": {n: g.cpu() for n, g in g1.items()},
            "delta": {n: t.cpu() for n, t in delta.items()}}


def half_batch(run, out) -> dict:
    """A fault planted in the reference put in the program's place: half of
    each batch left out, the mean taken over the rest."""
    return readings(run, _as_outputs(*reference_steps(
        run, rows=slice(0, run.params["batch"] // 2))), *reference_steps(run))


FAULTS = {"half_batch": half_batch}


def control(run, out) -> dict:
    """The reference one precision below the configuration's in the program's
    place: the generator and R below their dtypes, the warp and the W mapping
    below float32."""
    below_f32 = quant.BELOW["float32"]
    ctl = _as_outputs(*reference_steps(
        run, q_g=quant.BELOW[run.params["g_dtype"]], q_map=below_f32,
        q_r=quant.BELOW[run.params["r_dtype"]], q_warp=below_f32))
    return readings(run, ctl, *reference_steps(run))
