"""Trainer: the experiment tree, checkpoints, statistics and the loop around
:func:`warpedganspace_torch.train.train_step.train_step`.

Counterpart of :mod:`warpedganspace_tpu.train.trainer` (reference
``lib/trainer.py``), on one device, or data parallel over a process group
(``data_parallel=True``, one process per card; see
:mod:`warpedganspace_torch.parallel.mesh`), where the coordinator (rank 0)
writes every file of the tree below, prints the progress and owns
TensorBoard, every rank reads the checkpoint on a resume, the state is
checked to be the same bytes on every rank before the first step, and a
barrier holds the others until the coordinator has finished the tree:

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

``--steps-per-call k`` runs the loop of the JAX trainer (:388-480): a chunk of
k iterations (:class:`~warpedganspace_torch.train.train_step.StepChunk`, a
CUDA graph on the card) starts only at ``(iteration - 1) % k == 0`` with a
whole chunk ahead, and single steps run otherwise (the iteration a resumed run
repeats, a final partial chunk); ``k`` divides the log and checkpoint
frequencies (``cli.train`` checks it before it writes anything), so both land
on chunk ends. ``profile=True`` records a
``torch.profiler`` trace of the loop into ``<wip>/profile/trace.json``.
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
from warpedganspace_torch.parallel.mesh import (assert_identical_across_processes,
                                               is_coordinator, sync_processes)
from warpedganspace_torch.train.train_step import (StepChunk, TrainState, TrainStepConfig,
                                                   init_train_state, metric_row, train_step)
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

    def __init__(self, params=None, exp_dir=None, seed: int = 0, data_parallel: bool = False):
        if params is None:
            raise ValueError("Cannot build a Trainer instance with empty params")
        self.params = params
        self.seed = seed
        self.data_parallel = data_parallel
        self.is_coord = is_coordinator()

        self.wip_dir = osp.join("experiments", "wip", exp_dir)
        self.complete_dir = osp.join("experiments", "complete", exp_dir)
        self.stats_json = osp.join(self.wip_dir, "stats.json")
        os.makedirs(self.wip_dir, exist_ok=True)
        if self.is_coord and not osp.isfile(self.stats_json):
            with open(self.stats_json, "w") as f:
                json.dump({}, f)
        self.models_dir = osp.join(self.wip_dir, "models")
        os.makedirs(self.models_dir, exist_ok=True)
        self.checkpoint = osp.join(self.models_dir, "checkpoint.pt")
        self.opt_sidecar = osp.join(self.models_dir, "optimizer_state.npz")

        self.tb_writer = None
        if self.is_coord and bool(getattr(params, "tensorboard", False)):
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
        if not self.is_coord:
            return
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
        if not self.is_coord:
            self.stat_tracker.flush()
            return
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
        """The coordinator copies wip to complete; every rank waits for it."""
        if self.is_coord:
            print("#. Copy {} to {}...".format(self.wip_dir, self.complete_dir))
            try:
                shutil.copytree(src=self.wip_dir, dst=self.complete_dir,
                                ignore=shutil.ignore_patterns("checkpoint.pt"))
                print("  \\__Done!")
            except (IOError, FileExistsError) as e:
                print("  \\__Already exists -- {}".format(e))
        sync_processes("trainer-complete")

    # ------------------------------------------------------------------- train
    def train(self, generator, support_sets, reconstructor, profile: bool = False) -> TrainState:
        """Run the contrastive training loop (reference trainer.py:129-319).

        ``generator`` is the frozen GeneratorBundle; ``support_sets`` and
        ``reconstructor`` are moved to its device and trained in place.
        """
        p = self.params
        k_chunk = int(getattr(p, "steps_per_call", 1) or 1)
        state = init_train_state(generator, support_sets, reconstructor,
                                 TrainStepConfig.from_params(p), seed=self.seed,
                                 data_parallel=self.data_parallel)
        say = print if self.is_coord else (lambda *a, **kw: None)

        # Save initial support sets (reference trainer.py:139).
        if self.is_coord:
            torch.save(state.S.to_torch_state_dict(),
                       osp.join(self.models_dir, "support_sets_init.pt"))

        starting_iter = self.get_starting_iteration(state)
        if starting_iter == p.max_iter:
            say("#. This experiment has already been completed and can be found @ {}".format(
                self.wip_dir))
            self._copy_to_complete()
            sys.exit()
        # Every rank built or read its own copy of the state; train only on
        # copies that are the same bytes.
        assert_identical_across_processes(
            {"S": state.S.to_torch_state_dict(), "R": state.R.state_dict(),
             "opt_s": state.opt_s.state_dict()["state"],
             "opt_r": state.opt_r.state_dict()["state"]}, "the training state")
        say("#. Start training from iteration {}".format(starting_iter))
        chunk = StepChunk(state, k_chunk) if k_chunk > 1 else None

        prof = None
        if profile and self.is_coord:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            activities = [ProfilerActivity.CPU]
            if state.S.support_sets.is_cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = torch_profile(activities=activities)
            prof.start()

        t0 = time.time()
        window_t0, window_iters, window_ckpt = t0, 0, False
        pending = []  # (first iteration, (n, 4) metrics on the device), fetched at the log boundary

        iteration = starting_iter
        while iteration <= p.max_iter:
            if (chunk is not None and (iteration - 1) % k_chunk == 0
                    and iteration + k_chunk - 1 <= p.max_iter):
                pending.append((iteration, chunk(iteration)))
                n_advance = k_chunk
            else:
                pending.append((iteration, metric_row(train_step(state, iteration))[None]))
                n_advance = 1
            window_iters += n_advance
            iteration += n_advance - 1          # the last iteration of the chunk

            if iteration % p.log_freq == 0:
                # One device-to-host copy for the whole window; it also waits
                # for the window's work, so the wall time below is the window's.
                host = torch.cat([rows for _, rows in pending]).float().cpu().numpy()
                starts = [start + j for start, rows in pending for j in range(rows.shape[0])]
                for it, row in zip(starts, host):
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
            iteration += 1

        if prof is not None:
            prof.stop()
            os.makedirs(osp.join(self.wip_dir, "profile"), exist_ok=True)
            prof.export_chrome_trace(osp.join(self.wip_dir, "profile", "trace.json"))
        elapsed = time.time() - t0
        if self.tb_writer is not None:
            self.tb_writer.flush()

        # Final model exports (reference trainer.py:302-308).
        if self.is_coord:
            torch.save(state.S.to_torch_state_dict(),
                       osp.join(self.models_dir, "support_sets.pt"))
            torch.save(to_reference_state_dict(state.R),
                       osp.join(self.models_dir, "reconstructor.pt"))
            for _ in range(10):
                print()
            print("#.Training completed -- Total elapsed time: {}.".format(sec2dhms(elapsed)))
        self._copy_to_complete()
        return state
