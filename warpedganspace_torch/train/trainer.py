"""Trainer: the experiment tree, checkpoints, statistics and the loop around
:func:`warpedganspace_torch.train.train_step.train_step`.

Counterpart of :mod:`warpedganspace_tpu.train.trainer` (reference
``lib/trainer.py``), one process on one device:

- experiments/wip/<EXP_DIR>/ with models/, stats.json and, with
  ``--tensorboard``, tensorboard/ (:36-63); a finished run is copied to
  experiments/complete/ without checkpoint.pt (:169-177, :302-319).
- checkpoint.pt = {'iter', 'support_sets': state_dict, 'reconstructor':
  state_dict} every ``ckp_freq`` iterations (:288-295); a run that finds one
  restarts at the stored iteration (:74-89). The reference does not keep the
  optimizers' state; as the JAX package does, this trainer writes both Adams'
  moments beside the checkpoint in ``optimizer_state.npz`` (tagged with the
  iteration, written atomically) and restores them when it can read them. A
  sidecar it cannot read, the JAX package's for one, warns and resets the
  moments.
- stats.json: {iteration: {accuracy, classification_loss, regression_loss,
  total_loss}} rewritten whole every ``log_freq`` iterations (:101-112), the
  same stdout block (:114-127), the same final support_sets.pt and
  reconstructor.pt in the reference's torch format (:302-308).

The metrics stay on the device until the log boundary, so no iteration inside
a window waits for the host; the printed mean iteration time is the window's.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import sys
import time

import numpy as np
import torch

from warpedganspace_torch.convert.reconstructor import (load_reference_state_dict,
                                                        to_reference_state_dict)
from warpedganspace_torch.core.stats import STAT_KEYS, TrainingStatTracker
from warpedganspace_torch.train.train_step import (TrainState, TrainStepConfig,
                                                   init_train_state, train_step)
from warpedganspace_torch.utils.aux import sec2dhms, update_progress, update_stdout
from warpedganspace_torch.utils.io import load_pt

_SIDECAR_FORMAT = "warpedganspace_torch-adam-1"


def _adam_arrays(name: str, opt: torch.optim.Optimizer) -> dict:
    """``opt``'s moments and step counts as numpy arrays, keyed by parameter position."""
    out = {}
    params = [p for group in opt.param_groups for p in group["params"]]
    for i, p in enumerate(params):
        st = opt.state.get(p)
        if st:
            out[f"{name}.{i}.step"] = np.asarray(float(st["step"]))
            out[f"{name}.{i}.exp_avg"] = st["exp_avg"].detach().cpu().numpy()
            out[f"{name}.{i}.exp_avg_sq"] = st["exp_avg_sq"].detach().cpu().numpy()
    return out


def _restore_adam(name: str, opt: torch.optim.Optimizer, blob) -> None:
    sd = opt.state_dict()
    params = [p for group in opt.param_groups for p in group["params"]]
    state = {}
    for i, p in enumerate(params):
        exp_avg = torch.from_numpy(blob[f"{name}.{i}.exp_avg"])
        if tuple(exp_avg.shape) != tuple(p.shape):
            raise ValueError(f"{name}.{i}: moment shape {tuple(exp_avg.shape)} does not fit "
                             f"{tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(blob[f"{name}.{i}.step"])),
                    "exp_avg": exp_avg,
                    "exp_avg_sq": torch.from_numpy(blob[f"{name}.{i}.exp_avg_sq"])}
    sd["state"] = state
    opt.load_state_dict(sd)


class Trainer:
    """Owns the experiment directory tree, checkpointing, statistics and the loop."""

    def __init__(self, params=None, exp_dir=None, seed: int = 0):
        if params is None:
            raise ValueError("Cannot build a Trainer instance with empty params")
        self.params = params
        self.seed = seed

        self.wip_dir = osp.join("experiments", "wip", exp_dir)
        self.complete_dir = osp.join("experiments", "complete", exp_dir)
        self.stats_json = osp.join(self.wip_dir, "stats.json")
        os.makedirs(self.wip_dir, exist_ok=True)
        if not osp.isfile(self.stats_json):
            with open(self.stats_json, "w") as f:
                json.dump({}, f)
        self.models_dir = osp.join(self.wip_dir, "models")
        os.makedirs(self.models_dir, exist_ok=True)
        self.checkpoint = osp.join(self.models_dir, "checkpoint.pt")
        self.opt_sidecar = osp.join(self.models_dir, "optimizer_state.npz")

        self.tb_writer = None
        if bool(getattr(params, "tensorboard", False)):
            self.tb_dir = osp.join(self.wip_dir, "tensorboard")
            os.makedirs(self.tb_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(log_dir=self.tb_dir)
            except Exception as e:  # tensorboard is not installed: go on without scalars
                print(f"#. Warning: TensorBoard unavailable ({e}); scalar logging disabled")
            # In-process TensorBoard server, like the reference
            # (lib/trainer.py:55-63). A port conflict or a missing package must
            # not end a training run.
            if self.tb_writer is not None and not getattr(params, "no_tensorboard_server", False):
                try:
                    from tensorboard import program

                    tb = program.TensorBoard()
                    tb.configure(argv=[None, "--logdir", self.tb_dir, "--port", "0"])
                    print("#. Start TensorBoard at {}".format(tb.launch()))
                except Exception as e:
                    print(f"#. Warning: TensorBoard server not started ({e})")

        self.stat_tracker = TrainingStatTracker()
        # Per log window: (iterations, seconds, whether a checkpoint was written in it).
        self.window_times: list[tuple[int, float, bool]] = []

    # ------------------------------------------------------------- checkpoints
    def save_checkpoint(self, iteration: int, state: TrainState) -> None:
        torch.save({"iter": iteration,
                    "support_sets": state.S.to_torch_state_dict(),
                    "reconstructor": to_reference_state_dict(state.R)}, self.checkpoint)
        # Both Adams' state, tagged with the iteration and written atomically,
        # so that a crash between the two files never resumes with moments of
        # another iteration.
        tmp = self.opt_sidecar + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, iter=np.asarray(iteration), format=np.asarray(_SIDECAR_FORMAT),
                     **_adam_arrays("opt_s", state.opt_s), **_adam_arrays("opt_r", state.opt_r))
        os.replace(tmp, self.opt_sidecar)

    def get_starting_iteration(self, state: TrainState) -> int:
        """Resume from checkpoint.pt (reference trainer.py:74-89); 1 without one."""
        if not osp.isfile(self.checkpoint):
            return 1
        ckpt = load_pt(self.checkpoint)
        state.S.from_torch_state_dict(ckpt["support_sets"])
        load_reference_state_dict(state.R, ckpt["reconstructor"])
        if osp.isfile(self.opt_sidecar):
            try:
                with np.load(self.opt_sidecar) as blob:
                    if "format" not in blob.files or str(blob["format"]) != _SIDECAR_FORMAT:
                        raise ValueError("not a sidecar of this package")
                    if int(blob["iter"]) != int(ckpt["iter"]):
                        raise ValueError(f"sidecar is from iteration {int(blob['iter'])}, "
                                         f"checkpoint from {int(ckpt['iter'])}")
                    _restore_adam("opt_s", state.opt_s, blob)
                    _restore_adam("opt_r", state.opt_r, blob)
            except Exception as e:
                for opt in (state.opt_s, state.opt_r):
                    opt.state.clear()
                print(f"#. Warning: could not restore optimizer sidecar ({e}); Adam moments reset")
        return int(ckpt["iter"])

    # ------------------------------------------------------------------- stats
    def log_progress(self, iteration, mean_iter_time, elapsed_time, eta):
        stats = self.stat_tracker.get_means()
        with open(self.stats_json) as f:
            stats_dict = json.load(f)
        stats_dict.update({iteration: stats})
        with open(self.stats_json, "w") as f:
            json.dump(stats_dict, f)
        self.stat_tracker.flush()

        p = self.params
        update_progress("  \\__.Training [bs: {}] [iter: {:06d}/{:06d}] ".format(
            p.batch_size, iteration, p.max_iter), p.max_iter, iteration + 1)
        if iteration < p.max_iter - 1:
            print()
        print("      \\__Batch accuracy      : {:.03f}".format(stats["accuracy"]))
        print("      \\__Classification loss : {:.08f}".format(stats["classification_loss"]))
        print("      \\__Regression loss     : {:.08f}".format(stats["regression_loss"]))
        print("      \\__Total loss          : {:.08f}".format(stats["total_loss"]))
        print("         ===================================================================")
        print("      \\__Mean iter time      : {:.3f} sec".format(mean_iter_time))
        print("      \\__Elapsed time        : {}".format(sec2dhms(elapsed_time)))
        print("      \\__ETA                 : {}".format(sec2dhms(eta)))
        print("         ===================================================================")
        update_stdout(10)

    def _copy_to_complete(self) -> None:
        print("#. Copy {} to {}...".format(self.wip_dir, self.complete_dir))
        try:
            shutil.copytree(src=self.wip_dir, dst=self.complete_dir,
                            ignore=shutil.ignore_patterns("checkpoint.pt"))
            print("  \\__Done!")
        except (IOError, FileExistsError) as e:
            print("  \\__Already exists -- {}".format(e))

    # ------------------------------------------------------------------- train
    def train(self, generator, support_sets, reconstructor) -> TrainState:
        """Run the contrastive training loop (reference trainer.py:129-319).

        ``generator`` is the frozen GeneratorBundle; ``support_sets`` and
        ``reconstructor`` are moved to its device and trained in place.
        """
        p = self.params
        cfg = TrainStepConfig(
            batch_size=p.batch_size,
            num_support_sets=p.num_support_sets,
            min_shift_magnitude=p.min_shift_magnitude,
            max_shift_magnitude=p.max_shift_magnitude,
            lambda_cls=p.lambda_cls,
            lambda_reg=p.lambda_reg,
            support_set_lr=p.support_set_lr,
            reconstructor_lr=p.reconstructor_lr,
            z_truncation=getattr(p, "z_truncation", None),
            shift_in_w_space=bool(getattr(p, "shift_in_w_space", False)),
            generator_dtype=getattr(p, "g_dtype", "float32"),
            reconstructor_dtype=getattr(p, "r_dtype", "float32"),
        )
        state = init_train_state(generator, support_sets, reconstructor, cfg, seed=self.seed)

        # Save initial support sets (reference trainer.py:139).
        torch.save(state.S.to_torch_state_dict(),
                   osp.join(self.models_dir, "support_sets_init.pt"))

        starting_iter = self.get_starting_iteration(state)
        if starting_iter == p.max_iter:
            print("#. This experiment has already been completed and can be found @ {}".format(
                self.wip_dir))
            self._copy_to_complete()
            sys.exit()
        print("#. Start training from iteration {}".format(starting_iter))

        t0 = time.time()
        window_t0, window_iters, window_ckpt = t0, 0, False
        pending = []  # (iteration, metrics on the device), fetched at the log boundary

        for iteration in range(starting_iter, p.max_iter + 1):
            pending.append((iteration, train_step(state, iteration)))
            window_iters += 1

            if iteration % p.log_freq == 0:
                # One device-to-host copy for the whole window; it also waits
                # for the window's work, so the wall time below is the window's.
                host = torch.stack([torch.stack([m[k] for k in STAT_KEYS])
                                    for _, m in pending]).float().cpu().numpy()
                for (it, _), row in zip(pending, host):
                    stats = dict(zip(STAT_KEYS, (float(v) for v in row)))
                    self.stat_tracker.update(**stats)
                    if self.tb_writer is not None:
                        # Each buffered iteration at its own global step
                        # (reference trainer.py:264-266).
                        for k, v in stats.items():
                            self.tb_writer.add_scalar(k, v, it)
                pending = []
                now = time.time()
                self.window_times.append((window_iters, now - window_t0, window_ckpt))
                mean_iter_time = (now - window_t0) / max(window_iters, 1)
                window_t0, window_iters, window_ckpt = now, 0, False
                elapsed = now - t0
                eta = elapsed * ((p.max_iter - iteration) / max(iteration - starting_iter + 1, 1))
                self.log_progress(iteration, mean_iter_time, elapsed, eta)

            if iteration % p.ckp_freq == 0:
                self.save_checkpoint(iteration, state)
                window_ckpt = True

        elapsed = time.time() - t0
        if self.tb_writer is not None:
            self.tb_writer.flush()

        # Final model exports (reference trainer.py:302-308).
        torch.save(state.S.to_torch_state_dict(), osp.join(self.models_dir, "support_sets.pt"))
        torch.save(to_reference_state_dict(state.R), osp.join(self.models_dir, "reconstructor.pt"))

        for _ in range(10):
            print()
        print("#.Training completed -- Total elapsed time: {}.".format(sec2dhms(elapsed)))
        self._copy_to_complete()
        return state
