"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --profile proggan   # instead: where that path's time goes
                                              # (also: biggan, stylegan2, train_biggan,
                                              # attribute; --steps N walks N steps each way)
    python3 chip_smoke.py --profile dp --cards 4   # data-parallel training, 1 card and 4
                                                   # (--dp-config biggan, stylegan2, proggan)
    python3 chip_smoke.py --profile dp_eval --cards 4   # the evaluation chains of
                                                        # stylegan2_full.sh and proggan_full.sh,
                                                        # 1 card and 4 (--dp-eval-chain one)
    python3 chip_smoke.py --profile cuda_cores     # the kernels beside the CUDA-core designs
                                                   # they replaced

Phases, each of which must pass; any failure ends the run with a non-zero
exit and no result line:

1. device: the card's name and power limit;
2. build: the CUDA kernels of ``warpedganspace_torch/csrc``, one ``nvcc`` per
   source, started together (with ``--profile cuda_cores`` also the CUDA-core
   designs kept for comparison); each phase of 3, 4 and 5 starts as soon as
   its sources are built (the attention backward's are the last);
3. kernels, each against its plain PyTorch version and timed with CUDA events
   (plain, kernel, kernel, plain); the CUDA-core designs that the tensor-core
   designs replaced are timed beside them only under ``--profile
   cuda_cores``. Each tensor-core design that accumulates in f32 on
   ``mma.sync`` is held to a float64 twin beside the plain version at the same
   dtype (the max abs error, and the signed mean error with its standard
   error: the tensor cores' f32 sums round toward zero): the warp at R=64 and
   at a traversal's R=2 (pooled over draws of z) with f32 and bf16 sets, the
   bf16 attention's output and lse at B=16 and its backward's three gradients
   at B=32, both tails' bf16 sections at B=4, and the f32 tails:
   - the RBF warp at the five shapes of ``ops/rbf_cuda_cores.py`` (``SHAPES``)
     (K=200 sets, 2N=1024 support vectors, d=512 at R=64 rows = 32 codes x
     +-, and at R=16, 12 and 2 as the eval pools and the ProgGAN CLI give
     it; BigGAN's K=120, 2N=512, d=120 at R=8) with f32 and bf16 set
     storage, each call repeated for the same bits; the bound is the bytes or the
     products at the bf16 tensor-core peak, whichever is larger; then at the
     shapes the three traversals below give it;
   - the SA attention at BigGAN-128's shape (B=16, N=4096, M=1024, dk=24,
     dv=96) in f32 (its split-precision tensor-core design, 3xTF32) and bf16
     (its bf16 tensor-core design), at the two shapes the BigGAN path below
     gives it (a bf16 render batch of 64, one f32 sample), at the render batch
     and BigGAN D's operands (B=64, dk=12, dv=48) in f32, at a ragged shape and
     at logits near +-200 (lse too), with ``F.scaled_dot_product_attention``
     timed beside it (at B=16 and at the render batch) as a yardstick the port
     never calls; in f32 all in turns at B=16, B=1 and D's operands, with two
     bounds: the least arithmetic at the TF32 tensor-core rate beside the
     exponentials and the bytes, and the products on the CUDA cores;
   - the SA attention's backward at BigGAN-128's training shape (B=32, N=4096,
     M=1024, dk=24, dv=96) in f32 and bf16, at B=1, at the ragged shape and in
     f32 at logits near +-200, each gradient within a tolerance of its largest
     entry, with the backward of ``F.scaled_dot_product_attention`` through
     autograd as the yardstick (in f32 with the same two bounds); at each of
     those shapes also what
     the training forward saves for it, the forward kernel's output and its
     rows' log-sum-exp, against their plain versions;
   - ProgGAN's fused tail section at the three full-width sections of the
     1024^2 generator (128 -> 64 channels at 256^2, 64 -> 32 at 512^2,
     32 -> 16 at 1024^2 with the RGB head; B=4) in f32 and bf16, at the shapes
     the ProgGAN path below gives it (a bf16 render batch of 16, one f32
     sample), at a border-only and at a ragged odd shape, with WScale scales
     != 1 and random biases; in f32 (its split-precision tensor-core design,
     3xTF32) in turns at B=4 and B=1, with two bounds (the least arithmetic
     at the TF32 tensor cores and on the CUDA cores); no one PyTorch call
     computes a section;
   - StyleGAN2's fused tail section at the two sections of the 1024^2
     generator (128 -> 64 channels at 512^2 writing x2, 64 -> 32 at 1024^2
     writing only the RGB; B=4) in f32 and bf16, at the shapes the StyleGAN2
     path below gives it (a bf16 render batch of 16, one f32 sample), at C=16,
     at border-only and at ragged odd shapes, x2 written and not, with noise
     weights != 0, random biases and s, d away from 1; in f32 (its
     split-precision tensor-core design, 3xTF32) in turns at B=4 and B=1,
     with two bounds (the least arithmetic at the TF32 tensor cores and on the
     CUDA cores); no one PyTorch call computes a section;
4. generators with random weights from a seed: StyleGAN2-1024 in W space
   (B=4), BigGAN-128 at full width (class 239, B=16) and ProgGAN-1024 at full
   width (B=4), each in f32 and bf16 and in f32 on the card against f32 on
   the CPU; StyleGAN2 (noise weights and biases perturbed) also with the tail
   kernel swapped for its plain version and for a tail without its noise
   terms, to show the comparison would see it; BigGAN also with the
   attention kernel swapped for its plain version, in f32 and on a bf16
   render batch of 64, and the gradient of a
   scalar of G(z + shift) with respect to the shift through the backward
   kernel against the same through the plain backward (and against a backward
   with dg zeroed, to show the comparison would see it), in f32 and with a
   bf16 generator as a training step runs it; ProgGAN also with the
   tail kernel swapped for its plain version and for two deliberately wrong
   tails, to show the comparison would see them;
5. the port's main paths through its CLIs, ``sample_gan`` then
   ``traverse_latent_space``: a K=4, D=512 StyleGAN2-1024 W-space experiment
   for 2 steps each way at bf16 with GIFs, the K=120, D=256 BigGAN-128
   class-239 experiment for 5 steps each way at bf16 (1,320 frames), and the
   K=200, D=512 ProgGAN-1024 Z-space experiment for 1 step each way at bf16
   (600 frames of 1024^2). Each kernel's launch count is set to 0 just
   before a path and read just after: the warp must show one launch per step
   on all three, the attention one launch per generator forward on BigGAN's,
   ProgGAN's tail three launches per generator forward on ProgGAN's and
   StyleGAN2's tail two per generator forward on StyleGAN2's, each 0 on the
   other paths. The stored codes are checked against the plain warp;
6. the attribute stage (``ATTR``): ``traverse_latent_space`` writes a K=4
   StyleGAN2-1024 W tree at ``scripts/eval/stylegan2_full.sh``'s path length
   (20 steps each way, eps 0.15: 41 frames a path; bf16, batch 16; the warp 20
   launches, the tail 2 per generator forward), six predictor files are
   fabricated into a temporary ``models/pretrained/`` (seeded, BatchNorm
   statistics randomised, the detector's heads fitted to the tree's first
   path), and ``traverse_attribute_space`` runs on the card, which launches
   none of the port's kernels: the 26 ``eval_np`` and 12 ``eval_json`` files of
   shape (4, 41); the time of each stage per path (the host's ``_prep_path``
   and decode + NMS, the upload and the six predictors' forwards by CUDA
   events; ``--profile attribute`` adds three warm runs and a traced one, the
   device's busy share and kernel table). Then the port's CPU run
   of the first path, and the card held to it: each predictor's raw outputs on
   the CPU run's inputs within 1e-3 relative + 1e-4 of the output's largest
   magnitude, the path's ``eval_np`` rows at rtol 1e-2 / atol 2e-3 with the
   same argmaxes, the same first SFD box in all 41 frames (whose lead over the
   next candidate must exceed 100x the card-vs-CPU difference of the class
   maps); the native NMS must have run on the card, never the numpy one, and
   keep what the numpy one keeps on the run's candidate sets. Then
   ``rank_paths``: the port's ranking CLI on that tree with
   ``stylegan2_full.sh``'s flags and its loop of eight attribute groups
   (without GIFs: the ProgGAN chain makes them), each ``attr_idx`` CSV held
   to a plain ``np.cov`` ranking written here and each JSON order to its CSV;
   it launches none of the port's kernels. Then the same chain for
   ``PROGGAN_ATTR``, ``scripts/eval/proggan_full.sh`` without its ``--gif``: a
   ProgGAN-1024 Z tree of the first 2 paths of K=200 seeded sets, 30 steps
   each way (61 frames a path, 122 of 1024^2; bf16, batch 16; the warp 30
   launches, the tail 3 per generator forward), one cold and one warm
   attribute run on the card, the CPU run of the first path
   and the same checks, the CPU run's CelebA input against the min-max over
   all 61 frames of the path computed here, and ranking with the script's
   group order (GIFs for ``Smiling-AU12``);
7. the training path, ``train`` then ``traverse_latent_space``: the experiment
   of ``scripts/train/biggan.sh`` (BigGAN-128 class 239, ResNet reconstructor,
   K=120, D=256, learn-gammas, shifts in [0.1, 0.2], batch 32, bf16 G and R)
   at full width for 20 iterations with a checkpoint at 10 and 20, then the
   same command with ``--max-iter 30``, which resumes at the stored iteration
   20: 31 iterations in all, each of which must launch the attention's forward
   kernel twice and its backward kernel once, and neither tail kernel. The
   random init leaves the attention's gamma at 0, where the backward kernel's
   cotangent is exactly 0 and any backward would train the same, so this
   phase wraps the CLIs' ``build_gan`` to open gamma to 1. Losses must be
   finite, the support sets and loggamma moved, the alphas not; then the
   port's traversal walks the tree that run wrote;
8. the other families' training paths (``TRAIN_PATHS``), each the experiment
   of its ``scripts/train/*.sh`` at full width, cut in iterations and in the
   cadence of logs and checkpoints, with a resume: SNGAN-MNIST (LeNet, K=64,
   D=128, batch 128, bf16 G, ``--steps-per-call 10``: a CUDA graph of ten
   steps; 40 iterations, then a resume at 40 to 60 with ``--profile``, and 40
   iterations again with one step a call, twice: the graphed run's log windows
   before the resume held to the first eager run's as the second is, and the
   steps/s), SNGAN-AnimeFaces (``scripts/train/anime.sh``: the same cut, 64^2
   RGB, shifts in [0.25, 0.35]; its tree walked with
   ``scripts/eval/animefaces.sh``'s flags but ``--gif``, 24 steps each way),
   StyleGAN2-1024
   in W space (``--z-truncation 0.7``, ResNet, K=200, D=512, batch 12, bf16 G
   and R) and ProgGAN-1024 (the same at batch 8), both graphed with
   ``--steps-per-call 2``: 10 iterations logged every 2 (the warm-up, the
   capture, two windows of replays, the checkpoint's), then a resume at 10 to
   20 with ``--profile``, and 8 iterations with one step a call, twice, held
   as the SNGAN paths are. Each writes its tree, ``checkpoint2model`` splits
   the checkpoint, and ``traverse_latent_space`` walks the tree without its
   final ``support_sets.pt``, as an interrupted run leaves it. Launch counts
   as equalities: StyleGAN2's tail 4 and ProgGAN's 6 per counted training
   step (two sections or three in each of two generator forwards; a graphed
   run counts its eager warm-up and its capture, not its replays:
   ``counted_steps``), the warp none in training and one per traversal step.
   Then each step alone, outside the CLI, graphed against eager
   (``graph_against_eager``): ms per step untraced in turns and traced on host
   and device for the device's busy share, peak device memory allocated and
   reserved of each route; StyleGAN2's and ProgGAN's step also through the
   tail kernel against the same step with the plain tail, in turns, with peak
   device memory, the tail kernel's share of the device time, and
   ``compare_routes``. Before the paths, SNGAN-AnimeFaces at full width (B=64)
   in f32 and bf16 on the card against f32 on the CPU;
9. ``multi_device``: ``--multi-device``, the
   experiment of ``scripts/train/biggan.sh`` at full width, data parallel
   over ``torch.distributed`` (``MD``). (a) Two ranks share the card over
   gloo (worker processes of this script; NCCL refuses two ranks on one
   card): ``sample_gan``, ``train --multi-device`` in f32 (16 of the global
   32 rows a rank, 2 iterations) and ``traverse_latent_space --multi-device``
   (three codes, their 18 render batches split into two contiguous blocks: code
   0 and half of code 1 on rank 0), then the same pipeline in this process, a
   control that trains with PyTorch's native convolutions, and the first
   step again in float64: one tree; the first step's metrics at the JAX
   package's gates and its gradients no farther from float64 than twice one
   process's (f32 computes them to about 1 % of their norm); later windows,
   codes and frames at those gates or as close as the control
   (``MD_SPREAD``); the traversal split over the ranks equal to one
   process's on the same sets; each rank launches the attention forward and
   backward and the warp. (b) One NCCL rank, bf16 G and R,
   ``--steps-per-call 5``: the all-reduces captured in the CUDA graph, the
   run the same bits as the run without a group; the workers print their
   launch counts for this process to sum;
   (``--profile dp_eval --cards N`` runs the evaluation chains of
   ``stylegan2_full.sh`` and ``proggan_full.sh`` on one card and on N: the
   traversal and the attribute stage split inside each code over N ranks,
   held to one card's tree; ``DP_EVAL``);
10. ``discriminators``: StyleGAN2 config-f D at 1024² (B=4), the BigGAN-128 D
   (D_ch=96, attention at 64²; B=64) and BigGAN's G_D pair at class 239
   (B=16), f32 with seeded random weights: the attention kernel once per G and
   D forward (counted from 0 around the path), each D's logits against a
   float64 run of the same module on the card, BigGAN D's against the plain
   attention and G_D's three ways of scoring against each other; the
   attention kernel timed at D's own operands (dk=12, dv=48).

Runs with TF32 off (f32 comparisons). Needs no network. Imports no JAX.
Prints the card's name and power limit, then one JSON line with each kernel's
launches, error, times, bound and design by operand type (five kernels), then,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import math
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# The three traversals the CLIs run (sets, dipoles, latent width, steps, eps, batch).
SG2 = dict(gan="StyleGAN2", k=4, dipoles=512, d=512, steps=2, eps=0.2, batch=16, res=1024,
           gif=True, pool="smoke")
BIGGAN = dict(gan="BigGAN", k=120, dipoles=256, d=120, steps=5, eps=0.15, batch=64, res=128,
              gif=False, pool="smoke_biggan")
PROGGAN = dict(gan="ProgGAN", k=200, dipoles=512, d=512, steps=1, eps=0.15, batch=16, res=1024,
               gif=False, pool="smoke_proggan")
PATHS = {"stylegan2": SG2, "biggan": BIGGAN, "proggan": PROGGAN}
ATTN_SHAPE = (16, 4096, 1024, 24, 96)        # B, N, M, dk, dv of BigGAN-128's attention, timed
# What the BigGAN path gives the kernel: bf16 render batches (the last one is
# padded to the batch size) and sample_gan's one f32 code.
ATTN_RENDER = (BIGGAN["batch"],) + ATTN_SHAPE[1:]
ATTN_SAMPLE = (1,) + ATTN_SHAPE[1:]
ATTN_RAGGED = (2, 1000, 250, 20, 80)
ATTN_D = (64, 4096, 1024, 12, 48)             # BigGAN-128 D's attention (D_ch=96, at 64²)
ATTN_LARGE = (2, 200, 100, 16, 32)            # with queries and keys x8: logits near +-200
# The training path: the experiment of scripts/train/biggan.sh, cut in iterations.
TRAIN = dict(gan="BigGAN", k=120, dipoles=256, d=120, batch=32, iters=20, resume_to=30,
             log_freq=5, ckp_freq=10, steps=3, eps=0.15, render_batch=64, res=128,
             pool="smoke_train")
ATTN_TRAIN = (TRAIN["batch"],) + ATTN_SHAPE[1:]   # what a training step gives both kernels
# The training paths of every other family: the experiments of
# scripts/train/{mnist,stylegan2,proggan}.sh as written (``argv``: their flags
# but --tensorboard, the cadence and --max-iter), cut in iterations and in the
# cadence of logs and checkpoints; then checkpoint2model and a traversal of the
# tree (``steps`` each way, ``render_batch``). ``tail``: the kernel in every
# generator forward, ``per_forward`` launches each.
SNGAN_TRAIN = dict(
    gan="SNGAN_MNIST", k=64, dipoles=128, d=128, iters=40, resume_to=60, log_freq=10,
    ckp_freq=20, steps=8, eps=0.2, render_batch=128, res=32, channels=1, pool="smoke_sngan",
    tail=None, per_forward=0, chunk=10,
    argv=["--learn-gammas", "--gan-type", "SNGAN_MNIST", "--reconstructor-type", "LeNet",
          "-K", "64", "-D", "128", "--min-shift-magnitude", "0.15", "--max-shift-magnitude",
          "0.25", "--batch-size", "128", "--g-dtype", "bfloat16", "--steps-per-call", "10"])
# The 1024^2 experiments run graphed, --steps-per-call 2 added to their
# scripts' flags: the first run of 10 iterations logs 5 windows of one chunk,
# of which the first two are the eager warm-up and the capture and the last
# holds the checkpoint, so two clean windows of replays remain; the resume
# runs the stored iteration 10 alone, then chunks 11-12 to 19-20.
SG2_TRAIN = dict(
    gan="StyleGAN2", k=200, dipoles=512, d=512, iters=10, resume_to=20, log_freq=2,
    ckp_freq=10, steps=1, eps=0.15, render_batch=16, res=1024, pool="smoke_sg2_train",
    tail="sg2_tail", per_forward=2, chunk=2,
    argv=["--learn-gammas", "--gan-type", "StyleGAN2", "--stylegan2-resolution", "1024",
          "--z-truncation", "0.7", "--shift-in-w-space", "--reconstructor-type", "ResNet",
          "-K", "200", "-D", "512", "--min-shift-magnitude", "0.1", "--max-shift-magnitude",
          "0.2", "--batch-size", "12", "--g-dtype", "bfloat16", "--r-dtype", "bfloat16",
          "--pair-layout", "s2d", "--steps-per-call", "2"])
PROGGAN_TRAIN = dict(
    gan="ProgGAN", k=200, dipoles=512, d=512, iters=10, resume_to=20, log_freq=2, ckp_freq=10,
    steps=1, eps=0.15, render_batch=16, res=1024, pool="smoke_proggan_train",
    tail="proggan_tail", per_forward=3, chunk=2,
    argv=["--learn-gammas", "--gan-type", "ProgGAN", "--reconstructor-type", "ResNet",
          "-K", "200", "-D", "512", "--min-shift-magnitude", "0.1", "--max-shift-magnitude",
          "0.2", "--batch-size", "8", "--g-dtype", "bfloat16", "--r-dtype", "bfloat16",
          "--pair-layout", "s2d", "--steps-per-call", "2"])
# scripts/train/anime.sh, cut as the MNIST path is; its tree walked with
# scripts/eval/animefaces.sh's flags (--eps 0.25 --shift-steps 24, bf16; its
# --shift-leap 1 and batch are the CLI's defaults, 2 x 24 + 1 frames) but its
# --gif: the 8-core host of an H100 machine collates a GIF of 49 frames in
# about 11 s, the 64 of them in 691 s. The graphed step alone is traced on the
# MNIST path only (``step_alone``).
ANIME_TRAIN = dict(
    gan="SNGAN_AnimeFaces", k=64, dipoles=128, d=128, iters=40, resume_to=60, log_freq=10,
    ckp_freq=20, steps=24, eps=0.25, render_batch=49, res=64, channels=3, pool="smoke_anime",
    tail=None, per_forward=0, chunk=10, step_alone=False,
    argv=["--learn-gammas", "--gan-type", "SNGAN_AnimeFaces", "--reconstructor-type", "LeNet",
          "-K", "64", "-D", "128", "--min-shift-magnitude", "0.25", "--max-shift-magnitude",
          "0.35", "--batch-size", "128", "--g-dtype", "bfloat16", "--steps-per-call", "10"])
TRAIN_PATHS = {"train_sngan_mnist": SNGAN_TRAIN, "train_sngan_anime": ANIME_TRAIN,
               "train_stylegan2_w": SG2_TRAIN, "train_proggan_z": PROGGAN_TRAIN}
# The multi-device path: the experiment of scripts/train/biggan.sh at full
# width, data parallel. Part (a): two ranks that share the card over gloo, f32
# (TF32 off), eager steps, then a traversal of three codes whose 18 render
# batches the ranks split, 9 each (code 0 and half of code 1 on rank 0); held
# to the same pipeline in one process. Part (b): one NCCL rank, bf16 as the script
# runs it, graphed chunks of ``chunk`` steps; held to the same run without a
# process group in the same process, both with the deterministic algorithms.
MD = dict(gan="BigGAN", k=120, dipoles=256, d=120, batch=32, iters=2, log_freq=1, ckp_freq=2,
          steps=1, eps=0.15, render_batch=64, codes=3, res=128, pool="smoke_md",
          graph_iters=15, graph_log_freq=5, graph_ckp_freq=30, chunk=5)
# f32 computes this network's first-step gradients to about 1 % of their
# norm: the phase's witness holds one process's first step, through the CLI's
# own code and through PyTorch's native convolutions instead of cuDNN's,
# against the same step in float64, and every route lies about as far from it
# while R's BatchNorm inputs and logits agree with float64 far more closely
# (PERF.md's multi-GPU findings). Two ranks change the rounding as another route does. So
# their first step is held to the float64 step: no farther from it than
# MD_F64_RATIO times one process's f32 step is.
MD_F64_RATIO = 2.0
# After the first step Adam's update is lr * sign(g) for every element, so
# elements whose gradient lies within that 1 % take either sign and later
# steps carry it on. The tree of two ranks (later log windows, codes, frames)
# is held to one process's as far as a control lies from it, times
# MD_SPREAD, and at least at the JAX package's gates: the control is one
# process that trains with PyTorch's native convolutions (another f32
# rounding of the same steps, as far from float64 as cuDNN's) and traverses
# as the others do.
MD_SPREAD = 5.0
# The evaluation chains (``phase_attribute_stage``). The ranking stage runs the
# script's loop of attribute groups with its flags; ``gif_group`` (if any) also
# writes its top-k GIFs, the others pass --no-gif.
RANK_FLAGS = ["--num-imgs=5", "--gif-size=256", "--metric=corr+corr_l1"]
# scripts/eval/stylegan2_full.sh: traverse_attribute_space --eps 0.15
# --shift-steps 20 (41 frames a path) on a StyleGAN2-1024 W traversal of that
# length, cut from its K=200 paths x 6 codes to 4 paths of one, its ranking
# without GIFs (the ProgGAN chain makes them; these took 15.8 s of an H100
# machine's host).
ATTR = dict(gan="StyleGAN2", k=4, dipoles=512, d=512, steps=20, eps=0.15, batch=16, res=1024,
            gif=False, pool="smoke_attr", script="stylegan2_full.sh",
            rank_groups=("Smiling-AU12", "Age-FareFace", "Age-CelebA", "Gender", "Rotation",
                         "Smiling-CelebA", "Brow-Lowerer-AU4", "Bangs"),
            gif_group=None)
# scripts/eval/proggan_full.sh: the ProgGAN-1024 Z traversal at --eps 0.15
# --shift-steps 30 (61 frames a path; bf16, batch 16; without its --gif), then
# traverse_attribute_space and ranking, cut from the script's K=200 paths x 8
# codes to the first 2 paths of K=200 seeded sets (``sets``) and one code.
PROGGAN_ATTR = dict(gan="ProgGAN", k=2, sets=200, dipoles=512, d=512, steps=30, eps=0.15,
                    batch=16, res=1024, gif=False, pool="smoke_proggan_attr",
                    script="proggan_full.sh",
                    rank_groups=("Age-FareFace", "Age-CelebA", "Gender", "Rotation",
                                 "Smiling-AU12", "Smiling-CelebA", "Brow-Lowerer-AU4", "Bangs"),
                    gif_group="Smiling-AU12")
ATTR_PATHS = {"attribute_stage": ATTR, "attribute_stage_proggan": PROGGAN_ATTR}
# A crop rectangle (x0, x1, y0, y1) of a 256² frame that touches no border,
# gathered on the card and on the CPU beside the first boxes' crops.
INNER_RECT = (61, 190, 37, 203)
# The discriminators at full width: StyleGAN2 config-f at 1024² (batch), BigGAN-128
# (D_ch=96, D_attn="64"; batch), and BigGAN's G_D pair at class 239 (batch).
D_SG2_B, D_BIGGAN_B, GD_B = 4, 64, 16
# 1 BigGAN D forward, then G_D on fakes, fakes + reals in one D forward, and
# fakes + reals split: one attention launch per G and per D forward.
D_PATH_ATTN = 1 + 2 + 2 + 3
# The three sections of ProgGAN-1024's tail: (C output channels, input height = width, head).
TAIL_SECTIONS = ((64, 128, False), (32, 256, False), (16, 512, True))
TAIL_B = 4                                   # batch of the timed sections and generator
# The two sections of StyleGAN2-1024's tail (config-f): (C output channels,
# input height = width, whether x2 goes on to a next block).
SG2_SECTIONS = ((64, 256, True), (32, 512, False))

# NVIDIA H100 SXM data sheet: device memory rate, the f32 rate outside the tensor
# cores, and the dense tensor-core rate for bf16 operands with f32 accumulation.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# The dense tensor-core rate for TF32 operands (the f32 attention's split
# products, three TF32 products each, are counted as one: the least arithmetic).
PEAK_TF32_FLOPS = 495e12
# Exponentials on the special-function units: 16 a cycle per SM, 132 SMs, at
# the 1.83 GHz at which the data sheet's bf16 rate is 4,096 operations a cycle per SM.
PEAK_EXP_PER_S = 16 * 132 * 1.83e9


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def in_turns(fns: dict, **kw) -> dict:
    """Each of ``fns`` timed by :func:`cuda_ms` in turns, in order and back:
    {name: [ms, ms]}."""
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(cuda_ms(fns[name], **kw))
    return runs


def ms_text(ms) -> str:
    """A time, or where it is measured when this run did not."""
    return "not timed (--profile cuda_cores)" if ms is None else f"{ms:.4f} ms"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def psnr(img, ref) -> float:
    peak = float(ref.max() - ref.min())
    mse = float(((img - ref) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(peak ** 2 / mse)


def bound(bytes_moved: float, flops: float, bf16: bool = False) -> tuple[float, str]:
    """The least time (ms) the card could take: each input read and each output
    written once at the memory rate, or the operations at the card's peak for
    their operands' type (f32, or bf16 with f32 accumulation)."""
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bounds(b, n, m, dk, dv, elem: int, backward: bool = False) -> dict:
    """The attention's least times (ms) at one shape, forward or backward: the
    bytes (each input read and each output written once), the products
    (2 B N M (dk + dv) forward, 2 B N M (3 dk + 2 dv) backward) and the B N M
    exponentials (beta is recomputed once in the backward). ``tc``: at the unit
    the kernel runs on, the tensor cores (bf16 for bf16 operands, TF32 for f32
    ones: one product, not the split's three) beside the special-function
    units, the larger of products and exponentials against the bytes;
    ``cuda_cores``: the products at the f32 rate outside the tensor cores (for
    f32 operands; the figure of the earlier CUDA-core designs)."""
    if backward:
        nbytes = elem * b * (2 * n * dk + 2 * m * dk + 2 * m * dv + 2 * n * dv) + 4 * b * n
        flops = 2 * b * n * m * (3 * dk + 2 * dv)
    else:
        nbytes = elem * b * (n * dk + m * dk + m * dv + n * dv)
        flops = 2 * b * n * m * (dk + dv)
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = max(1e3 * flops / (PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS),
                1e3 * b * n * m / PEAK_EXP_PER_S)
    res = {"tc": (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")}
    if elem == 4:
        res["cuda_cores"] = bound(nbytes, flops)
    return res


def warp_f64(ws, z):
    """The warp's plain formula (``rbf_cuda._torch_kn``) in float64 on the same
    packed sets (bf16 support vectors taken exactly) and codes."""
    sv, g, ag, svsq, z = (t.double() for t in (ws.sv, ws.g, ws.ag, ws.svsq, z))
    zsq = (z * z).sum(-1, keepdim=True)
    w = ag[:, None, :] * (-g[:, None, :] * (zsq - 2.0 * (z @ sv.transpose(1, 2))
                                            + svsq[:, None, :])).exp()
    grad = -2.0 * w.sum(-1, keepdim=True) * z + 2.0 * (w @ sv)
    return grad / grad.norm(dim=-1, keepdim=True)


# The warp's shapes audited against float64: the timed R=64 and one traversal's R.
WARP_AUDIT_ROWS = (64, 2)


def phase_warp_kernel(card: str, cuda_cores: bool = False) -> dict:
    import torch

    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops import rbf_cuda, rbf_cuda_cores

    cc_warp = rbf_cuda_cores.cuda_cores() if cuda_cores else None
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    sets, shapes = {}, []
    with torch.no_grad():
        # The table's shapes: the timed R=64 and the traversals' own R.
        for label, k, n2, d, rows in rbf_cuda_cores.SHAPES:
            if (k, n2, d) not in sets:
                sets[(k, n2, d)] = SupportSets(k, n2 // 2, d, learn_gammas=True,
                                               generator=gen).to(dev)
            S = sets[(k, n2, d)]
            z = torch.randn((k, rows, d), generator=gen).to(dev)   # |z| ~ sqrt(d)
            name = f"K={k} 2N={n2} d={d} R={rows}"
            rec = {"shape": name, "label": label}
            outs = {}
            for dtype in (torch.float32, torch.bfloat16):
                tag = str(dtype).split(".")[-1]
                ws = rbf_cuda.prepare_warp_sets(S.support_sets, S.alphas, S.gammas(),
                                                None if dtype == torch.float32 else dtype)
                fns = {"plain": lambda: rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z),
                       "kernel": lambda: rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")}
                kern, plain = fns["kernel"], fns["plain"]
                before = rbf_cuda.launches
                out = kern()
                torch.cuda.synchronize()
                check(rbf_cuda.launches == before + 1, "the warp kernel's launch count did not move")
                check(bool(torch.isfinite(out).all()), f"non-finite warp output at {name} {tag}")
                # Unit vectors; split-precision products against f32 sums over 2N terms.
                err = float((out - plain()).abs().max())
                check(err <= 1e-4, f"warp kernel vs plain at {name} {tag} sets: "
                                   f"max abs {err:.3g} > 1e-4")
                # Partials of the runs of 2N are added in a fixed order: the same bits.
                check(torch.equal(kern(), out), f"warp kernel repeats differ at {name} {tag}")
                if cc_warp is not None:
                    fns["cuda_cores"] = lambda: cc_warp(ws, z)
                    cc_err = float((fns["cuda_cores"]() - plain()).abs().max())
                    check(cc_err <= 1e-4, f"CUDA-core warp vs plain at {name} {tag}: {cc_err:.3g}")
                outs[tag] = out
                # Plain, kernel (, the CUDA-core design), in turns and back.
                runs = in_turns(fns)
                nbytes, flops = rbf_cuda_cores.warp_cost(k, n2, d, rows, ws.sv.element_size())
                # The bound: the bytes, or the products at the peak of the unit the
                # design runs them on (bf16 tensor cores, whatever the sets' type).
                bound_ms, bound_by = bound(nbytes, flops, bf16=True)
                ms = sum(runs["kernel"]) / 2
                rec[tag] = {"ms": ms, "runs": runs["kernel"], "plain_ms": sum(runs["plain"]) / 2,
                            "plain_runs": runs["plain"],
                            "cuda_cores_ms": (sum(runs["cuda_cores"]) / 2
                                              if "cuda_cores" in runs else None),
                            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
                            "cuda_core_ops_ms": 1e3 * flops / PEAK_F32_FLOPS,
                            "evals_per_s": k * rows / ms * 1e3,
                            "share_of_bound": bound_ms / ms}
                if k == 200 and rows in WARP_AUDIT_ROWS:
                    # Against float64: does the tensor cores' truncating f32
                    # accumulation bias the directions (the plain f32 version
                    # beside)? Pooled over draws of z, 2**16 rows of d in all.
                    draws = [z] + [torch.randn((k, rows, d), generator=gen).to(dev)
                                   for _ in range(max(0, 2 ** 16 // (k * rows) - 1))]
                    for route, fn in (("kernel", kern), ("plain", plain)):
                        pairs = []
                        for zz in draws:
                            z = zz                    # the timed closures read z
                            pairs.append((fn(), warp_f64(ws, zz)))
                        rec[tag]["audit_" + route] = error_stats(pairs)
                        del pairs
                    rec[tag]["audit_draws"] = len(draws)
                    z = draws[0]
            cos16 = float((outs["bfloat16"] * outs["float32"]).sum(-1).mean())
            # bf16 set storage against f32: the bound of tests/test_rbf_pallas.py.
            check(cos16 > 0.999, f"bf16 vs f32 sets mean cosine {cos16:.6f} <= 0.999 at {name}")
            rec["cos_bf16_vs_f32"] = cos16
            shapes.append(rec)
            f, b = rec["float32"], rec["bfloat16"]
            audit = "".join(
                f"; {t} sets against float64 over {r['audit_draws']} draws of z (max abs, "
                f"signed mean error +- its standard error): kernel "
                f"{stats_text(r['audit_kernel'])}, plain {stats_text(r['audit_plain'])}"
                for t, r in (("f32", f), ("bf16", b)) if "audit_kernel" in r)
            print(f"[kernel] rbf_warp {name} ({label}) on {card}: "
                  f"f32 sets {f['ms']:.4f} ms ({f['runs'][0]:.4f}, {f['runs'][1]:.4f}), "
                  f"{f['evals_per_s'] / 1e6:.2f} M evals/s, {100 * f['share_of_bound']:.1f} % of "
                  f"its bound {f['bound_ms']:.4f} ms by {f['bound_by']}, plain "
                  f"{f['plain_ms']:.4f} ms, CUDA-core design {ms_text(f['cuda_cores_ms'])}; "
                  f"bf16 sets {b['ms']:.4f} ms ({b['runs'][0]:.4f}, {b['runs'][1]:.4f}), "
                  f"{b['evals_per_s'] / 1e6:.2f} M evals/s, {100 * b['share_of_bound']:.1f} % of "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']}, plain {b['plain_ms']:.4f} ms, "
                  f"CUDA-core design {ms_text(b['cuda_cores_ms'])}; least time of the products "
                  f"on the CUDA cores (67 TFLOP/s, not this design's unit) "
                  f"{f['cuda_core_ops_ms']:.4f} ms; max abs err f32 {f['max_abs_err']:.3g}, bf16 "
                  f"{b['max_abs_err']:.3g}; bf16-vs-f32 cos {cos16:.6f}{audit}")

        # The CLIs' own shapes: one code x +- = 2 rows, and 64 rows at BigGAN's.
        errs = {}
        for cfg, rows in ((SG2, 2), (BIGGAN, 2), (BIGGAN, 64), (PROGGAN, 2)):
            Ss = SupportSets(cfg["k"], cfg["dipoles"], cfg["d"], learn_gammas=True,
                             generator=gen).to(dev)
            zs = torch.randn((cfg["k"], rows, cfg["d"]), generator=gen).to(dev)
            wss = rbf_cuda.prepare_warp_sets(Ss.support_sets, Ss.alphas, Ss.gammas())
            e = float((rbf_cuda.warp_grad_all_sets_kn(wss, zs, backend="cuda")
                       - rbf_cuda._torch_kn(wss.sv, wss.g, wss.ag, wss.svsq, zs)).abs().max())
            name = f"K={cfg['k']} 2N={2 * cfg['dipoles']} d={cfg['d']} R={rows}"
            check(e <= 1e-4, f"warp kernel vs plain at {name}: max abs {e:.3g} > 1e-4")
            errs[name] = e
        print("[kernel] rbf_warp at the CLIs' shapes, max abs err: "
              + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items()))
    f, b = shapes[0]["float32"], shapes[0]["bfloat16"]
    return {"max_abs_err": max(r[t]["max_abs_err"] for r in shapes for t in ("float32", "bfloat16")),
            "max_abs_err_traversal_shapes": errs, "cos_bf16_vs_f32": shapes[0]["cos_bf16_vs_f32"],
            "ms": f["ms"], "plain_ms": f["plain_ms"], "ms_bf16": b["ms"],
            "plain_ms_bf16": b["plain_ms"], "cuda_cores_ms": f["cuda_cores_ms"],
            "cuda_cores_ms_bf16": b["cuda_cores_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "bound_ms_bf16": b["bound_ms"],
            "bound_by_bf16": b["bound_by"], "cuda_core_ops_ms": f["cuda_core_ops_ms"],
            "library_ms": None, "shape": f"{shapes[0]['shape']} f32",
            "audit": {f"{r['shape']} {t}": {key: r[t][key] for key in
                                             ("audit_kernel", "audit_plain", "audit_draws")}
                      for r in shapes for t in ("float32", "bfloat16") if "audit_kernel" in r[t]},
            "design": {"float32": "tensor cores, 3 bf16 products a pass (hi + lo)",
                       "bfloat16": "tensor cores, 2 bf16 products a pass (hi + lo)"},
            "shapes": shapes}


def attn_inputs(shape, seed: int, dtype):
    """Normal queries and keys (a peaked softmax), values uniform in [-1, 1):
    every output is a convex combination of values of magnitude below 1."""
    import torch

    b, n, m, dk, dv = shape
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((b, n, dk), generator=gen)
    phi = torch.randn((b, m, dk), generator=gen)
    g = torch.rand((b, m, dv), generator=gen) * 2 - 1
    return tuple(t.to(device="cuda", dtype=dtype) for t in (theta, phi, g))


def attn_f64(theta, phi, g):
    """softmax(theta phi^T) g and each row's log-sum-exp, in float64 on the
    same operands."""
    s = theta.double() @ phi.double().transpose(1, 2)
    lse = s.logsumexp(-1)
    return (s - lse[..., None]).exp() @ g.double(), lse


def attn_bwd_f64(theta, phi, g, ct):
    """(dtheta, dphi, dg) of :func:`attn_f64`'s output for ``ct``, in float64."""
    th, ph, gd, ctd = (t.double() for t in (theta, phi, g, ct))
    beta = (th @ ph.transpose(1, 2)).softmax(-1)
    dbeta = ctd @ gd.transpose(1, 2)
    ds = beta * (dbeta - (dbeta * beta).sum(-1, keepdim=True))
    del dbeta
    return ds @ ph, ds.transpose(1, 2) @ th, beta.transpose(1, 2) @ ctd


def phase_attn_kernel(card: str, cuda_cores: bool = False) -> dict:
    import torch
    import torch.nn.functional as F

    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.ops.attn import sa_attention_plain

    errs = {}
    with torch.no_grad():
        # f32: sums over M=1024 terms in another order, of values below 1.
        # bf16: against the plain version in bf16; one bf16 ulp of O(1) values
        # after a 1024-term sum.
        for shape, dtype, tol in ((ATTN_SHAPE, torch.float32, 1e-4),
                                  (ATTN_SHAPE, torch.bfloat16, 3e-2),
                                  (ATTN_RENDER, torch.bfloat16, 3e-2),
                                  (ATTN_RENDER, torch.float32, 1e-4),
                                  (ATTN_D, torch.float32, 1e-4),
                                  (ATTN_SAMPLE, torch.float32, 1e-4),
                                  (ATTN_RAGGED, torch.float32, 1e-4),
                                  (ATTN_RAGGED, torch.bfloat16, 3e-2)):
            theta, phi, g = attn_inputs(shape, 2, dtype)
            before = attn_cuda.launches
            out = attn_cuda.sa_attention(theta, phi, g)
            torch.cuda.synchronize()
            check(attn_cuda.launches == before + 1,
                  "the attention kernel's launch count did not move")
            ref = sa_attention_plain(theta, phi, g)
            name = f"{shape} {str(dtype).split('.')[-1]}"
            check(out.dtype == dtype and out.shape == ref.shape, f"attention output at {name}")
            check(bool(torch.isfinite(out).all()), f"non-finite attention output at {name}")
            e = float((out.float() - ref.float()).abs().max())
            check(e <= tol, f"attention kernel vs plain at {name}: max abs {e:.3g} > {tol}")
            errs[name] = e
        # Logits near +-200 in f32: the running maximum keeps every exp() in
        # range; lse within 2e-5 + 1e-6 of itself.
        theta, phi, g = (t * 8 if i < 2 else t
                         for i, t in enumerate(attn_inputs(ATTN_LARGE, 2, torch.float32)))
        out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
        e = float((out - sa_attention_plain(theta, phi, g)).abs().max())
        check(e <= 1e-4, f"attention kernel vs plain at logits near +-200: max abs {e:.3g}")
        errs[f"{ATTN_LARGE} float32 x8"] = e
        want = torch.logsumexp(torch.bmm(theta, phi.transpose(1, 2)), -1)
        e = float(((lse - want).abs() - 1e-6 * want.abs()).max())
        check(e <= 2e-5, f"lse at logits near +-200: {e:.3g} past rtol 1e-6 > 2e-5")
        errs[f"{ATTN_LARGE} float32 x8 lse past rtol 1e-6"] = e

        # bf16 in turns: plain, kernel, kernel, plain, then the yardstick: one
        # library call for the same function (one head, no scale), timed here,
        # never called by the port.
        theta, phi, g = attn_inputs(ATTN_SHAPE, 2, torch.bfloat16)
        kern = lambda: attn_cuda.sa_attention(theta, phi, g)  # noqa: E731
        plain = lambda: sa_attention_plain(theta, phi, g)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        q, k, v = theta[:, None], phi[:, None], g[:, None]
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
        lib_err16 = float((lib()[:, 0].float() - plain().float()).abs().max())
        ms16, plain_ms16, lib_ms16 = (k1 + k2) / 2, (p1 + p2) / 2, cuda_ms(lib)
        # The bf16 design against float64 at B=16 (the plain bf16 version
        # beside): does the tensor cores' truncating f32 accumulation bias the
        # output or the rows' log-sum-exp?
        theta, phi, g = attn_inputs(ATTN_SHAPE, 2, torch.bfloat16)
        out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
        out64, lse64 = attn_f64(theta, phi, g)
        plain_lse = torch.logsumexp(torch.bmm(theta.float(), phi.float().transpose(1, 2)), -1)
        audit = {oname: {"kernel": error_stats([(got, ref64)]),
                         "plain": error_stats([(plain_got, ref64)])}
                 for oname, got, plain_got, ref64 in (
                     ("out", out, sa_attention_plain(theta, phi, g), out64),
                     ("lse", lse, plain_lse, lse64))}
        del out, lse, out64, lse64, plain_lse
        # f32 in turns: plain, kernel (, the CUDA-core design it replaced, its own
        # C entry), SDPA, and back, at B=16, one sampled code and BigGAN D's operands.
        from warpedganspace_torch.ops.attn_cuda_cores import cc_forward

        f32 = {}
        for shape in (ATTN_SHAPE, ATTN_SAMPLE, ATTN_D):
            theta, phi, g = attn_inputs(shape, 2, torch.float32)
            q, k, v = theta[:, None], phi[:, None], g[:, None]
            fns = {"plain": lambda: sa_attention_plain(theta, phi, g),
                   "kernel": lambda: attn_cuda.sa_attention(theta, phi, g),
                   "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)}
            cc_err = None
            if cuda_cores:
                fns["cuda_cores"] = lambda: cc_forward(theta, phi, g)
                cc_err = float((fns["cuda_cores"]()[0] - fns["plain"]()).abs().max())
                check(cc_err <= 1e-4, f"the CUDA-core design vs plain at {shape}: {cc_err:.3g}")
            runs = in_turns(fns, iters=20 if shape[0] > 16 else 50)
            bounds = attn_bounds(*shape, 4)
            f32[shape] = {f"{name}_ms": sum(r) / 2 for name, r in runs.items()}
            f32[shape].setdefault("cuda_cores_ms", None)
            f32[shape].update(runs=runs, cc_err=cc_err, bound_ms=bounds["tc"][0],
                              bound_by=bounds["tc"][1],
                              bound_ms_cuda_cores=bounds["cuda_cores"][0])
        # The render batch's own shape, timed too (bf16, the CLI's batch size).
        theta, phi, g = attn_inputs(ATTN_RENDER, 2, torch.bfloat16)
        kern = lambda: attn_cuda.sa_attention(theta, phi, g)  # noqa: E731
        plain = lambda: sa_attention_plain(theta, phi, g)  # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, iters=20) for f in (plain, kern, kern, plain))
        render_ms, render_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        q, k, v = theta[:, None], phi[:, None], g[:, None]
        lib_render_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
                                iters=20)
    design = {str(dt).split(".")[-1]: attn_cuda.design(dt)
              for dt in (torch.float32, torch.bfloat16)}

    b, n, m, dk, dv = ATTN_SHAPE
    bound_ms16, bound_by16 = attn_bounds(*ATTN_SHAPE, 2)["tc"]
    bound_render, _ = attn_bounds(*ATTN_RENDER, 2)["tc"]
    main = f32[ATTN_SHAPE]
    res = {"max_abs_err": errs[f"{ATTN_SHAPE} float32"], "max_abs_errs": errs,
           "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
           "library_ms": main["library_ms"], "cc_ms": main["cuda_cores_ms"],
           "ms_bf16": ms16, "plain_ms_bf16": plain_ms16, "library_ms_bf16": lib_ms16,
           "ms_render_bf16": render_ms, "plain_ms_render_bf16": render_plain_ms,
           "library_ms_render_bf16": lib_render_ms,
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "bound_ms_cuda_cores": main["bound_ms_cuda_cores"],
           "bound_ms_bf16": bound_ms16, "bound_by_bf16": bound_by16,
           "bound_ms_render_bf16": bound_render, "design": design,
           "f32_shapes": {str(shape): {key: val for key, val in t.items() if key != "runs"}
                          for shape, t in f32.items()},
           "audit_bf16": audit, "shape": f"B={b} N={n} M={m} dk={dk} dv={dv} f32"}
    f32_text = "; ".join(
        f"f32 {shape}: kernel {t['kernel_ms']:.4f} ms, CUDA-core design "
        f"{ms_text(t['cuda_cores_ms'])}, plain {t['plain_ms']:.4f} ms, library SDPA "
        f"{t['library_ms']:.4f} ms (each "
        + ", ".join(f"{name} " + "/".join(f"{x:.4f}" for x in r)
                    for name, r in t["runs"].items())
        + f"); bound {t['bound_ms']:.4f} ms by {t['bound_by']} at the TF32 tensor cores, "
        f"{t['bound_ms_cuda_cores']:.4f} ms on the CUDA cores"
        + (f"; CUDA-core design's max abs err {t['cc_err']:.3g}" if t["cc_err"] is not None
           else "") for shape, t in f32.items())
    audit_text = "; ".join(
        f"{oname}: kernel {stats_text(a['kernel'])}, plain bf16 {stats_text(a['plain'])}"
        for oname, a in audit.items())
    print(f"[kernel] sa_attention {res['shape']} on {card}; design f32: {design['float32']}, "
          f"bf16: {design['bfloat16']}: {f32_text}; bf16 kernel {ms16:.4f} ms "
          f"plain {plain_ms16:.4f} ms library SDPA {lib_ms16:.4f} ms (err {lib_err16:.3g}), "
          f"bound {bound_ms16:.4f} ms by {bound_by16} at the bf16 tensor-core peak; "
          f"bf16 at the render batch B={ATTN_RENDER[0]}: kernel {render_ms:.4f} ms plain "
          f"{render_plain_ms:.4f} ms library SDPA {lib_render_ms:.4f} ms bound "
          f"{bound_render:.4f} ms; bf16 at B={ATTN_SHAPE[0]} against float64 (max abs, signed "
          f"mean error +- its standard error): {audit_text}; "
          "max abs err " + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items()))
    return res


def rel_err(got, ref) -> float:
    """Max abs difference relative to the reference's largest entry."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def phase_attn_bwd_kernel(card: str, cuda_cores: bool = False) -> dict:
    import torch
    import torch.nn.functional as F

    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

    def problem(shape, dtype):
        theta, phi, g = attn_inputs(shape, 2, dtype)
        ct = torch.randn((shape[0], shape[1], shape[4]),
                         generator=torch.Generator().manual_seed(3)).to(theta)
        return theta, phi, g, ct

    errs = {}
    fwd_tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # the forward phase's bounds
    with torch.no_grad():
        # Each gradient against the plain backward, relative to its largest
        # entry. f32: sums over N=4096 or M=1024 terms in another order. bf16:
        # against the plain version in bf16, which rounds ds and beta to bf16
        # before their products as the kernel does, but from its own softmax
        # and rowsum; a bf16 result.
        for shape, dtype, tol in ((ATTN_TRAIN, torch.float32, 1e-4),
                                  (ATTN_TRAIN, torch.bfloat16, 3e-2),
                                  (ATTN_SAMPLE, torch.float32, 1e-4),
                                  (ATTN_RAGGED, torch.float32, 1e-4),
                                  (ATTN_RAGGED, torch.bfloat16, 3e-2)):
            theta, phi, g, ct = problem(shape, dtype)
            name = f"{shape} {str(dtype).split('.')[-1]}"
            # What the training forward keeps for the backward: the forward
            # kernel's output, held as in the forward's own phase, and every
            # row's log-sum-exp against float32 logits of the same operands
            # (values near 20: some float32 ulps of 2e-6).
            saved = out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
            e = float((out.float() - sa_attention_plain(theta, phi, g).float()).abs().max())
            check(out.dtype == dtype and e <= fwd_tol[dtype],
                  f"attention kernel with the row statistics vs plain at {name}: max abs "
                  f"{e:.3g} > {fwd_tol[dtype]}")
            errs[f"{name} out"] = e
            e = float((lse - torch.logsumexp(
                torch.bmm(theta.float(), phi.float().transpose(1, 2)), -1)).abs().max())
            check(lse.dtype == torch.float32 and tuple(lse.shape) == shape[:2] and e <= 2e-5,
                  f"the forward kernel's log-sum-exp at {name}: max abs {e:.3g} > 2e-5")
            errs[f"{name} lse"] = e
            before = attn_cuda.bwd_launches
            got = attn_cuda.sa_attention_bwd(theta, phi, g, ct, saved=saved)
            torch.cuda.synchronize()
            check(attn_cuda.bwd_launches == before + 1,
                  "the attention backward kernel's launch count did not move")
            ref = sa_attention_bwd_plain(theta, phi, g, ct)
            for gname, a, b, like in zip(("dtheta", "dphi", "dg"), got, ref, (theta, phi, g)):
                check(a.dtype == dtype and a.shape == like.shape, f"{gname} at {name}")
                check(bool(torch.isfinite(a).all()), f"non-finite {gname} at {name}")
                e = rel_err(a, b)
                check(e <= tol, f"attention backward kernel vs plain, {gname} at {name}: "
                                f"{e:.3g} of the largest entry > {tol}")
                errs[f"{name} {gname}"] = e
            del got, ref, saved, out, lse

        # Logits near +-200 in f32: the saved log-sum-exp keeps exp() in range.
        theta, phi, g, ct = problem(ATTN_LARGE, torch.float32)
        theta, phi = theta * 8, phi * 8
        got = attn_cuda.sa_attention_bwd(theta, phi, g, ct)
        ref = sa_attention_bwd_plain(theta, phi, g, ct)
        for gname, a, b in zip(("dtheta", "dphi", "dg"), got, ref):
            e = rel_err(a, b)
            check(bool(torch.isfinite(a).all()) and e <= 1e-4,
                  f"attention backward kernel vs plain, {gname} at logits near +-200: {e:.3g}")
            errs[f"{ATTN_LARGE} float32 x8 {gname}"] = e

    # In turns: plain, kernel, (f32: the CUDA-core design it replaced, through
    # its own C entry,) the library's backward, and back.
    from warpedganspace_torch.ops.attn_cuda_cores import cc_backward

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        theta, phi, g, ct = problem(ATTN_TRAIN, dtype)
        # The yardstick: the backward of one library call for the same function
        # (one head, no scale) through autograd. Timed here, never called by the port.
        q, k, v = (t[:, None].detach().requires_grad_() for t in (theta, phi, g))
        out = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        with torch.no_grad():
            saved = attn_cuda.sa_attention_saved(theta, phi, g)
            fns = {"plain": lambda: sa_attention_bwd_plain(theta, phi, g, ct),
                   "kernel": lambda: attn_cuda.sa_attention_bwd(theta, phi, g, ct, saved=saved)}
            if dtype == torch.float32 and cuda_cores:
                fns["cuda_cores"] = lambda: cc_backward(theta, phi, g, *saved, ct)
        fns["library"] = lambda: torch.autograd.grad(out, (q, k, v), ct[:, None],
                                                     retain_graph=True)
        with torch.no_grad():
            ref = fns["plain"]()
            cc_err = (max(rel_err(a, b) for a, b in zip(fns["cuda_cores"](), ref))
                      if "cuda_cores" in fns else None)
        lib_err = max(rel_err(a[:, 0], b) for a, b in zip(fns["library"](), ref))
        runs = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            with torch.no_grad() if name != "library" else torch.enable_grad():
                runs[name].append(cuda_ms(fns[name], iters=10, warmup=2))
        times[dtype] = {f"{name}_ms": sum(r) / 2 for name, r in runs.items()}
        times[dtype].setdefault("cuda_cores_ms", None)
        times[dtype].update(runs=runs, lib_err=lib_err, cc_err=cc_err)
        if dtype == torch.bfloat16:
            # The bf16 design's three gradients against float64 at the train
            # shape (the plain bf16 version beside): does the tensor cores'
            # truncating f32 accumulation bias them?
            with torch.no_grad():
                got, ref64 = fns["kernel"](), attn_bwd_f64(theta, phi, g, ct)
                audit = {gname: {"kernel": error_stats([(a, r64)]),
                                 "plain": error_stats([(p, r64)])}
                         for gname, a, p, r64 in zip(("dtheta", "dphi", "dg"), got, ref, ref64)}
            del got, ref64
        del out, q, k, v, ref, saved, fns
    check(times[torch.float32]["cc_err"] is None or times[torch.float32]["cc_err"] <= 1e-4,
          f"the CUDA-core backward design vs plain: {times[torch.float32]['cc_err']}")

    b, n, m, dk, dv = ATTN_TRAIN
    design = {str(dt).split(".")[-1]: attn_cuda.bwd_design(dt)
              for dt in (torch.float32, torch.bfloat16)}
    bounds = attn_bounds(*ATTN_TRAIN, 4, backward=True)
    bound_ms, bound_by = bounds["tc"]
    bound_cc, _ = bounds["cuda_cores"]
    bound_ms16, bound_by16 = attn_bounds(*ATTN_TRAIN, 2, backward=True)["tc"]
    t32, t16 = times[torch.float32], times[torch.bfloat16]
    f32_name = f"{ATTN_TRAIN} float32"
    res = {"max_abs_err": max(errs[f"{f32_name} {gname}"] for gname in ("dtheta", "dphi", "dg")),
           "max_abs_errs": errs, "err_is": "relative to each gradient's largest entry; max abs for the forward's out, lse",
           "ms": t32["kernel_ms"], "plain_ms": t32["plain_ms"], "library_ms": t32["library_ms"],
           "cc_ms": t32["cuda_cores_ms"],
           "ms_bf16": t16["kernel_ms"], "plain_ms_bf16": t16["plain_ms"],
           "library_ms_bf16": t16["library_ms"],
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_cuda_cores": bound_cc,
           "bound_ms_bf16": bound_ms16, "bound_by_bf16": bound_by16, "design": design,
           "audit_bf16": audit, "shape": f"B={b} N={n} M={m} dk={dk} dv={dv} f32"}

    def each(t):
        return ", ".join(f"{name} " + "/".join(f"{x:.4f}" for x in r)
                         for name, r in t["runs"].items())

    print(f"[kernel] sa_attention_bwd {res['shape']} on {card}; design f32: "
          f"{design['float32']}, bf16: {design['bfloat16']}: f32 kernel {res['ms']:.4f} ms, "
          f"CUDA-core design {ms_text(res['cc_ms'])} (its error vs plain {t32['cc_err']}), "
          f"plain {res['plain_ms']:.4f} ms, library SDPA backward {res['library_ms']:.4f} ms "
          f"(its error vs plain {t32['lib_err']:.3g}; each {each(t32)}); bound {bound_ms:.4f} ms "
          f"by {bound_by} at the TF32 tensor cores, {bound_cc:.4f} ms on the CUDA cores; bf16 "
          f"kernel {res['ms_bf16']:.4f} ms plain {res['plain_ms_bf16']:.4f} ms library SDPA "
          f"backward {res['library_ms_bf16']:.4f} ms (err {t16['lib_err']:.3g}; each "
          f"{each(t16)}), bound {bound_ms16:.4f} ms by {bound_by16} at the bf16 tensor-core "
          f"peak; bf16 at B={ATTN_TRAIN[0]} against float64 (max abs, signed mean error +- "
          "its standard error): " + "; ".join(
              f"{gname}: kernel {stats_text(a['kernel'])}, plain bf16 {stats_text(a['plain'])}"
              for gname, a in audit.items())
          + "; error relative to each gradient's largest entry (max abs for the forward's "
          "out and lse) " + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items()))
    return res


def tail_problem(seed: int, b: int, c: int, h: int, w: int, head: bool, dtype):
    """One tail section's operands on the card: unit-scale input, weights that
    keep every conv output at unit scale, WScale scales != 1 and random biases
    (the random init's scale 1 and bias 0 would hide a wrong WScale or a mid
    border computed instead of zeroed)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen)).to(device="cuda", dtype=dtype)

    ops = [normal(b, 2 * c, h, w),
           normal(c, 2 * c, 3, 3, std=(18 * c) ** -0.5), normal(c, std=0.3),
           torch.tensor([1.3], device="cuda", dtype=dtype),
           normal(c, c, 3, 3, std=(9 * c) ** -0.5), normal(c, std=0.3),
           torch.tensor([0.8], device="cuda", dtype=dtype)]
    hd = None
    if head:
        hd = (normal(3, c, 1, 1, std=c ** -0.5), normal(3, std=0.3),
              torch.tensor([1.1], device="cuda", dtype=dtype))
    return ops, hd


def tail_bound(b: int, c: int, h: int, w: int, head: bool, elem: int,
               unit: str = "tc") -> tuple[float, str]:
    """A section's bound: the input and the weights read once and the output
    written once, against the LEAST arithmetic that computes it: the
    phase-merged up-conv needs 4 taps of 2C x C per output pixel, not 9, then
    9 taps of C x C, and 3 C for the head. ``unit="tc"``: the operations at the
    peak of the unit the kernel's designs run their products on, the tensor
    cores: bf16 for 2-byte elements, TF32 for f32 ones (one product, not the
    split's three); ``unit="cuda_cores"``: f32 outside the tensor cores (the
    figure of the earlier CUDA-core design)."""
    r2 = 4 * h * w
    n_w = 9 * 2 * c * c + 9 * c * c + 2 * c + 2 + ((3 * c + 4) if head else 0)
    bytes_moved = elem * (b * 2 * c * h * w + b * (3 if head else c) * r2 + n_w)
    flops = b * r2 * (2 * (4 * 2 * c * c + 9 * c * c) + (2 * 3 * c if head else 0))
    if unit == "cuda_cores":
        return bound(bytes_moved, flops)
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def error_stats(pairs) -> dict:
    """Errors of outputs against their float64 references, pooled over the
    (got, ref64) pairs (tuples of outputs taken together): the largest
    absolute error (``f64``); the signed mean error (``sme``), the mean of
    (got - ref64) along the reference's sign over its mean magnitude, which
    the tensor cores' truncating f32 sums make negative; and its standard
    error over the elements (``se``)."""
    signed = mag = sq = n = worst = 0.0
    for got, ref64 in pairs:
        got, ref64 = (got, ref64) if isinstance(ref64, tuple) else ((got,), (ref64,))
        for a, r in zip(got, ref64):
            d = a.double() - r
            e = d * r.sign()
            signed, sq, n = signed + float(e.sum()), sq + float((e * e).sum()), n + e.numel()
            mag, worst = mag + float(r.abs().sum()), max(worst, float(d.abs().max()))
    var = max(sq / n - (signed / n) ** 2, 0.0)
    return {"f64": worst, "sme": signed / mag, "se": math.sqrt(var * n) / mag}


def stats_text(st: dict) -> str:
    return f"{st['f64']:.3g}, {st['sme']:.3g} (+-{st['se']:.2g})"


def sum_sections(res: dict, sections: list) -> None:
    """One generator forward's tail is its sections: the times and bounds summed
    into ``res`` (None where this run did not time a design)."""
    for key in ("ms", "plain_ms", "cc_ms", "bound_ms", "bound_ms_cuda_cores", "ms_b1",
                "plain_ms_b1", "cc_ms_b1", "bound_ms_b1", "bound_ms_cuda_cores_b1", "ms_bf16",
                "plain_ms_bf16", "bound_ms_bf16", "ms_render_bf16", "plain_ms_render_bf16",
                "bound_ms_render_bf16"):
        vals = [r[key] for r in sections]
        res[key] = None if None in vals else sum(vals)


def f32_section_text(r: dict) -> str:
    """A tail section's f32 timings and its routes' errors against float64."""
    text = "; ".join(
        f"f32 B={bsz}: kernel {r['ms' + key]:.4f} ms, CUDA-core design "
        f"{ms_text(r['cc_ms' + key])}, plain {r['plain_ms' + key]:.4f} ms (each " + ", ".join(
            f"{name} " + "/".join(f"{t:.4f}" for t in ts) for name, ts in r["runs" + key].items())
        + f"); bound {r['bound_ms' + key]:.4f} ms by {r['bound_by' + key]} at the TF32 tensor "
        f"cores, {r['bound_ms_cuda_cores' + key]:.4f} ms on the CUDA cores"
        + ("" if r["cc_err" + key] is None
           else f"; CUDA-core design's max abs err {r['cc_err' + key]:.3g}")
        for bsz, key in ((TAIL_B, ""), (1, "_b1")))
    return text + "; against float64 (max abs, signed mean error): " + ", ".join(
        f"{name} {r['f64_' + name]:.3g}, {r['sme_' + name]:.3g}"
        for name in ("kernel", "cuda_cores", "plain") if "f64_" + name in r)


def phase_tail_kernel(card: str, cuda_cores: bool = False) -> dict:
    import torch

    from warpedganspace_torch.ops import proggan_tail_cuda
    from warpedganspace_torch.ops.proggan_tail import fused_section_plain
    from warpedganspace_torch.ops.proggan_tail_cuda_cores import cc_section

    def run(ops, hd, name):
        """Kernel against the plain version in f32 on the same (rounded) operands."""
        before = proggan_tail_cuda.launches
        out = proggan_tail_cuda.fused_section(*ops, head=hd)
        torch.cuda.synchronize()
        check(proggan_tail_cuda.launches == before + 1,
              "the tail kernel's launch count did not move")
        ref = fused_section_plain(*[t.float() for t in ops],
                                  head=None if hd is None else tuple(t.float() for t in hd))
        check(out.dtype == ops[0].dtype and out.shape == ref.shape, f"tail output at {name}")
        check(bool(torch.isfinite(out).all()), f"non-finite tail output at {name}")
        e = float((out.float() - ref).abs().max())
        # f32, the split-precision design: products of about 22 bits in
        # another order, sums of up to 4 * 128 and 9 * 64 of them, merged
        # up-conv taps (the CPU emulation,
        # tests/test_torch_proggan_tail_f32_split_numerics.py: 4.4e-6 at
        # worst). bf16, the tensor-core design: the products see the
        # normalised input, the merged up-conv taps and the normalised mid
        # tile rounded to bf16 (in the section with the RGB head, bf16 hi + lo
        # pairs of them, so there only the output rounds), then the output is
        # rounded: half an ulp of values below 8, 2^-6, plus at most about as
        # much again from the three roundings (the CPU emulation,
        # tests/test_torch_tail_tc_numerics.py: 0.0196 at worst without the
        # head, 0.0156 with it).
        tol = 1e-4 if out.dtype == torch.float32 else 3e-2
        check(e <= tol, f"tail kernel vs plain at {name}: max abs {e:.3g} > {tol}")
        return e

    def f64(ops, head):
        return fused_section_plain(*[t.double() for t in ops],
                                   head=None if head is None else tuple(t.double() for t in head))

    errs, sections = {}, []
    with torch.no_grad():
        cases = [(TAIL_B, c, h, h, hd, dt) for c, h, hd in TAIL_SECTIONS
                 for dt in (torch.float32, torch.bfloat16)]
        # What the ProgGAN path gives it: bf16 render batches, one f32 sample.
        cases += [(PROGGAN["batch"], c, h, h, hd, torch.bfloat16) for c, h, hd in TAIL_SECTIONS]
        cases += [(1, c, h, h, hd, torch.float32) for c, h, hd in TAIL_SECTIONS]
        # Border only (a 2 x 2 output), and ragged, odd, non-square.
        for dt in (torch.float32, torch.bfloat16):
            cases += [(3, 16, 1, 1, True, dt), (3, 64, 1, 1, False, dt),
                      (2, 32, 9, 23, False, dt), (2, 16, 17, 5, True, dt)]
        for b, c, h, w, hd, dt in cases:
            name = f"B={b} C={c} {h}x{w}{' +head' if hd else ''} {str(dt).split('.')[-1]}"
            errs[name] = run(*tail_problem(5, b, c, h, w, hd, dt), name)

        for c, h, hd in TAIL_SECTIONS:
            row = {"c": c, "in": h, "head": hd}
            # f32 in turns: the split-precision design, the CUDA-core design it
            # replaced (through its own C entry), plain, and back; at B=4 and at
            # the path's sampled B=1.
            for bsz, key in ((TAIL_B, ""), (1, "_b1")):
                ops, head = tail_problem(5, bsz, c, h, h, hd, torch.float32)
                fns = {"kernel": proggan_tail_cuda.fused_section, "plain": fused_section_plain}
                if cuda_cores:
                    fns["cuda_cores"] = cc_section
                fns = {name: functools.partial(fn, *ops, head=head) for name, fn in fns.items()}
                cc_err = None
                if cuda_cores:
                    cc_err = float((fns["cuda_cores"]() - fns["plain"]()).abs().max())
                    check(cc_err <= 1e-4, f"the CUDA-core design vs plain at B={bsz} C={c}: "
                                          f"{cc_err:.3g}")
                runs = in_turns(fns, iters=20, warmup=3)
                for name, field in (("kernel", "ms"), ("cuda_cores", "cc_ms"),
                                    ("plain", "plain_ms")):
                    row[field + key] = sum(runs[name]) / 2 if name in runs else None
                row["runs" + key], row["cc_err" + key] = runs, cc_err
                if bsz == TAIL_B:
                    # Against float64: the max abs and the signed mean error of
                    # each route (the card tests' bound 1e-6 on the kernel's).
                    ref64 = f64(ops, head)
                    for name, fn in fns.items():
                        st = error_stats([(fn(), ref64)])
                        row[f"f64_{name}"], row[f"sme_{name}"] = st["f64"], st["sme"]
                    del ref64
                    check(abs(row["sme_kernel"]) <= 1e-6,
                          f"tail kernel's signed mean error against float64 at C={c}: "
                          f"{row['sme_kernel']:.3g}")
                row["bound_ms" + key], row["bound_by" + key] = tail_bound(bsz, c, h, h, hd, 4)
                row["bound_ms_cuda_cores" + key] = tail_bound(bsz, c, h, h, hd, 4,
                                                              unit="cuda_cores")[0]
            ops, head = tail_problem(5, TAIL_B, c, h, h, hd, torch.bfloat16)
            kern = lambda: proggan_tail_cuda.fused_section(*ops, head=head)  # noqa: E731
            plain = lambda: fused_section_plain(*ops, head=head)  # noqa: E731
            p1, k1, k2, p2 = (cuda_ms(f, iters=20, warmup=3) for f in (plain, kern, kern, plain))
            row["ms_bf16"], row["plain_ms_bf16"] = (k1 + k2) / 2, (p1 + p2) / 2
            row["runs_bf16"] = (k1, k2, p1, p2)
            row["bound_ms_bf16"], row["bound_by_bf16"] = tail_bound(TAIL_B, c, h, h, hd, 2)
            # How far the plain bf16 version, which rounds every intermediate,
            # is from the f32 one on the same operands; and the bf16 design's
            # and plain bf16's signed mean error against float64 (do the
            # tensor cores' truncating f32 sums bias the bf16 design too?).
            ref = fused_section_plain(*[t.float() for t in ops],
                                      head=head and tuple(t.float() for t in head))
            row["plain_bf16_err"] = float((plain().float() - ref).abs().max())
            ref64 = f64(ops, head)
            row["audit_bf16"] = error_stats([(kern(), ref64)])
            row["audit_plain_bf16"] = error_stats([(plain(), ref64)])
            del ref, ref64
            # The render batch's own shape (bf16, the CLI's batch size).
            ops, head = tail_problem(5, PROGGAN["batch"], c, h, h, hd, torch.bfloat16)
            p1, k1, k2, p2 = (cuda_ms(f, iters=10, warmup=2) for f in (plain, kern, kern, plain))
            row["ms_render_bf16"], row["plain_ms_render_bf16"] = (k1 + k2) / 2, (p1 + p2) / 2
            row["bound_ms_render_bf16"], row["bound_by_render_bf16"] = tail_bound(
                PROGGAN["batch"], c, h, h, hd, 2)
            sections.append(row)
            del ops, head

    # One generator forward's tail is the three sections: the row's times,
    # bound and error are theirs summed (f32, B=4).
    f32_names = [f"B={TAIL_B} C={c} {h}x{h}{' +head' if hd else ''} float32"
                 for c, h, hd in TAIL_SECTIONS]
    res = {"max_abs_err": max(errs[n] for n in f32_names), "max_abs_errs": errs,
           "sections": [{k: v for k, v in r.items() if not k.startswith("runs")}
                        for r in sections],
           "bound_by": sections[0]["bound_by"], "bound_by_bf16": sections[0]["bound_by_bf16"],
           "design": {str(dt).split(".")[-1]: proggan_tail_cuda.design(dt)
                      for dt in (torch.float32, torch.bfloat16)},
           "shape": f"3 sections (C=64@256^2, 32@512^2, 16@1024^2 + head), B={TAIL_B} f32, summed"}
    check(all(r["bound_by" + k] == res["bound_by" + k] for r in sections for k in ("", "_bf16"))
          and all(r["bound_by_render_bf16"] == res["bound_by_bf16"] for r in sections),
          "sections bound differently")
    sum_sections(res, sections)
    for r in sections:
        f32 = f32_section_text(r)
        k1, k2, p1, p2 = r["runs_bf16"]
        print(f"[kernel] proggan_tail C={r['c']} {r['in']}^2 -> {2 * r['in']}^2"
              f"{' + head' if r['head'] else ''} on {card}: {f32}; bf16 B={TAIL_B}: kernel "
              f"{r['ms_bf16']:.4f} ms ({k1:.4f}, {k2:.4f}) plain {r['plain_ms_bf16']:.4f} ms "
              f"({p1:.4f}, {p2:.4f}), bound {r['bound_ms_bf16']:.4f} ms by {r['bound_by_bf16']} "
              f"at the bf16 tensor-core peak; plain bf16 vs f32 max abs "
              f"{r['plain_bf16_err']:.3g}; against float64 (max abs, signed mean error +- its "
              f"standard error): bf16 kernel {stats_text(r['audit_bf16'])}, plain bf16 "
              f"{stats_text(r['audit_plain_bf16'])}; "
              f"bf16 at the render batch B={PROGGAN['batch']}: kernel {r['ms_render_bf16']:.4f} ms "
              f"plain {r['plain_ms_render_bf16']:.4f} ms bound {r['bound_ms_render_bf16']:.4f} ms; "
              "no library call")
    print(f"[kernel] proggan_tail, the three sections summed; design f32: "
          f"{res['design']['float32']}, bf16: {res['design']['bfloat16']}: f32 B={TAIL_B} kernel "
          f"{res['ms']:.4f} ms, CUDA-core design {ms_text(res['cc_ms'])}, plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by {res['bound_by']} at the "
          f"TF32 tensor cores ({res['bound_ms_cuda_cores']:.4f} ms on the CUDA cores); f32 B=1 "
          f"kernel {res['ms_b1']:.4f} ms, CUDA-core design {ms_text(res['cc_ms_b1'])}, plain "
          f"{res['plain_ms_b1']:.4f} ms, bound {res['bound_ms_b1']:.4f} ms "
          f"({res['bound_ms_cuda_cores_b1']:.4f} ms); bf16 B={TAIL_B} kernel "
          f"{res['ms_bf16']:.4f} ms plain {res['plain_ms_bf16']:.4f} ms bound "
          f"{res['bound_ms_bf16']:.4f} ms by {res['bound_by_bf16']}; at B={PROGGAN['batch']} bf16 "
          f"kernel {res['ms_render_bf16']:.4f} ms bound {res['bound_ms_render_bf16']:.4f} ms; "
          "max abs err " + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items()))
    return res


def sg2_problem(seed: int, b: int, c: int, h: int, w: int, dtype):
    """One StyleGAN2 tail section's operands on the card: unit-scale input,
    weights that keep each conv output at a scale of one half (every output
    stays below 8), and every other operand away from the random init (noise
    weights != 0, random biases, s and d away from 1), which would hide a
    dropped term or a mid border computed instead of zeroed."""
    import torch

    # Drawn on the card: the render batch's input is 268 M values.
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen, device="cuda")

    ops = [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3, std=0.5 * (18 * c) ** -0.5),
           rnd(c, c, 3, 3, std=0.5 * (9 * c) ** -0.5), rnd(3, c, 1, 1, std=0.5 * c ** -0.5),
           rnd(b, 2 * c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(0.7, device="cuda"), rnd(c, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(-0.4, device="cuda"), rnd(c, std=0.3),
           rnd(3, std=0.3)]
    return [t.to(dtype) for t in ops]


def sg2_bound(b: int, c: int, h: int, w: int, want_x2: bool, elem: int,
              unit: str = "tc") -> tuple[float, str]:
    """A StyleGAN2 tail section's bound: the input, the weights, the vectors and
    the noise read once and the outputs written once, against the LEAST
    arithmetic that computes it: the stride-2 transposed conv is 9 taps of
    2C x C per INPUT pixel (2.25 per output pixel), the blur 8 C per output
    pixel (separable), the same-conv 9 C^2, ToRGB 3 C. ``unit="tc"``: the
    operations at the peak of the unit the kernel's design runs its products
    on, the tensor cores: bf16 for 2-byte elements, TF32 for f32 ones (one
    product, not the split's three); ``unit="cuda_cores"``: f32 outside the
    tensor cores (the figure of the earlier CUDA-core design). The polyphase
    up-conv of the bf16 and CUDA-core designs does 9 taps of 2C x C per output
    pixel, four times the transposed conv's; the f32 design's transposed conv
    over the 21 x 21 window of a 16 x 16 tile, 1.72 times."""
    r2 = 4 * h * w
    n_small = 9 * 2 * c * c + 9 * c * c + 3 * c + 2 * c + 5 + b * 6 * c + 2 * r2
    bytes_moved = elem * (b * 2 * c * h * w + b * (3 + (c if want_x2 else 0)) * r2 + n_small)
    flops = 2 * (b * h * w * 9 * 2 * c * c + b * r2 * (8 * c + 9 * c * c + 3 * c))
    if unit == "cuda_cores":
        return bound(bytes_moved, flops)
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_sg2_tail_kernel(card: str, cuda_cores: bool = False) -> dict:
    import torch

    from warpedganspace_torch.ops import sg2_tail_cuda
    from warpedganspace_torch.ops.sg2_tail import fused_section_plain
    from warpedganspace_torch.ops.sg2_tail_cuda_cores import cc_section
    from warpedganspace_torch.ops.sg2_tail_polyphase import polyphase_section

    def run(ops, want_x2, name):
        """Kernel against the plain version in f32 on the same (rounded) operands."""
        before = sg2_tail_cuda.launches
        key = sg2_tail_cuda.DESIGN_KEYS[ops[0].dtype]
        before_design = sg2_tail_cuda.launches_by_design[key]
        got = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
        torch.cuda.synchronize()
        check(sg2_tail_cuda.launches == before + 1
              and sg2_tail_cuda.launches_by_design[key] == before_design + 1,
              "the sg2 tail kernel's launch count (or its design's) did not move")
        ref = fused_section_plain(*[t.float() for t in ops], want_x2=want_x2)
        got, ref = (got, ref) if want_x2 else ((got,), (ref,))
        e = 0.0
        for g, r in zip(got, ref):
            check(g.dtype == ops[0].dtype and g.shape == r.shape, f"sg2 tail output at {name}")
            check(bool(torch.isfinite(g).all()), f"non-finite sg2 tail output at {name}")
            e = max(e, float((g.float() - r).abs().max()))
        # f32, the split-precision design: products of about 22 bits in
        # another order, sums of up to 4 * 128 and 9 * 64 of them, the blur
        # after * d1 (the CPU emulation,
        # tests/test_torch_sg2_tail_f32_split_numerics.py: 2.4e-6 at worst).
        # bf16, the wgmma design: the products see x * s1 and the mid tile
        # (after * s2) rounded to bf16 and the raw bf16 weights, x2 stays f32
        # for ToRGB,
        # then the outputs are rounded: half an ulp of values below 8, 2^-6,
        # plus at most about as much again from the roundings (the CPU
        # emulation, tests/test_torch_tail_tc_numerics.py: 0.0219 at worst).
        tol = 1e-4 if ops[0].dtype == torch.float32 else 3e-2
        check(e <= tol, f"sg2 tail kernel vs plain at {name}: max abs {e:.3g} > {tol}")
        return e

    errs, sections = {}, []
    with torch.no_grad():
        cases = [(TAIL_B, c, h, h, x2, dt) for c, h, x2 in SG2_SECTIONS
                 for dt in (torch.float32, torch.bfloat16)]
        # What the StyleGAN2 path gives it: bf16 render batches, one f32 sample.
        cases += [(SG2["batch"], c, h, h, x2, torch.bfloat16) for c, h, x2 in SG2_SECTIONS]
        cases += [(1, c, h, h, x2, torch.float32) for c, h, x2 in SG2_SECTIONS]
        # C=16 (channel multiplier 1), border only (2x2 and 4x4 outputs), and
        # ragged, odd, non-square; x2 written and not.
        for dt in (torch.float32, torch.bfloat16):
            cases += [(2, 16, 64, 64, True, dt), (3, 16, 1, 1, False, dt), (3, 64, 2, 2, True, dt),
                      (2, 32, 13, 7, True, dt), (2, 64, 13, 7, False, dt)]
        for b, c, h, w, x2, dt in cases:
            name = f"B={b} C={c} {h}x{w}{' +x2' if x2 else ''} {str(dt).split('.')[-1]}"
            errs[name] = run(sg2_problem(6, b, c, h, w, dt), x2, name)

        for c, h, x2 in SG2_SECTIONS:
            row = {"c": c, "in": h, "want_x2": x2}
            # f32 in turns: the split-precision design, the CUDA-core design it
            # replaced (through its own C entry), plain, and back; at B=4 and at
            # the path's sampled B=1.
            for bsz, key in ((TAIL_B, ""), (1, "_b1")):
                ops = sg2_problem(6, bsz, c, h, h, torch.float32)
                fns = {"kernel": sg2_tail_cuda.fused_section, "plain": fused_section_plain}
                if cuda_cores:
                    fns["cuda_cores"] = cc_section
                fns = {name: functools.partial(fn, *ops, want_x2=x2) for name, fn in fns.items()}
                cc_err = None
                if cuda_cores:
                    got, ref = fns["cuda_cores"](), fns["plain"]()
                    got, ref = (got, ref) if x2 else ((got,), (ref,))
                    cc_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                    check(cc_err <= 1e-4, f"the CUDA-core design vs plain at B={bsz} C={c}: "
                                          f"{cc_err:.3g}")
                runs = in_turns(fns, iters=5 if bsz > 1 else 20, warmup=1 if bsz > 1 else 3)
                for name, field in (("kernel", "ms"), ("cuda_cores", "cc_ms"),
                                    ("plain", "plain_ms")):
                    row[field + key] = sum(runs[name]) / 2 if name in runs else None
                row["runs" + key], row["cc_err" + key] = runs, cc_err
                if bsz == TAIL_B:
                    # Against float64: the max abs and the signed mean error (the
                    # error along the reference's sign over its mean magnitude)
                    # of each route; the tensor cores' truncating f32 sums would
                    # make the kernel's negative (the card tests' bound 1e-6).
                    ref64 = fused_section_plain(*[t.double() for t in ops], want_x2=x2)
                    for name, fn in fns.items():
                        st = error_stats([(fn(), ref64)])
                        row[f"f64_{name}"], row[f"sme_{name}"] = st["f64"], st["sme"]
                    del ref64
                    check(abs(row["sme_kernel"]) <= 1e-6,
                          f"sg2 tail kernel's signed mean error against float64 at C={c}: "
                          f"{row['sme_kernel']:.3g}")
                row["bound_ms" + key], row["bound_by" + key] = sg2_bound(bsz, c, h, h, x2, 4)
                row["bound_ms_cuda_cores" + key] = sg2_bound(bsz, c, h, h, x2, 4,
                                                             unit="cuda_cores")[0]
            ops = sg2_problem(6, TAIL_B, c, h, h, torch.bfloat16)
            kern = lambda: sg2_tail_cuda.fused_section(*ops, want_x2=x2)  # noqa: E731
            plain = lambda: fused_section_plain(*ops, want_x2=x2)  # noqa: E731
            poly = lambda: polyphase_section(*ops, want_x2=x2)  # noqa: E731
            # The polyphase mma.sync design that the wgmma design replaced,
            # through its own C entry, against the same plain version.
            got, ref = poly(), fused_section_plain(*[t.float() for t in ops], want_x2=x2)
            got, ref = (got, ref) if x2 else ((got,), (ref,))
            row["polyphase_err"] = max(float((g.float() - r).abs().max()) for g, r in zip(got, ref))
            check(row["polyphase_err"] <= 3e-2, f"the polyphase design vs plain at C={c}: "
                                                f"{row['polyphase_err']:.3g}")
            p1, k1, q1, q2, k2, p2 = (cuda_ms(f, iters=5, warmup=1)
                                      for f in (plain, kern, poly, poly, kern, plain))
            row["ms_bf16"], row["plain_ms_bf16"] = (k1 + k2) / 2, (p1 + p2) / 2
            row["polyphase_ms_bf16"] = (q1 + q2) / 2
            row["runs_bf16"] = (k1, k2, p1, p2, q1, q2)
            row["bound_ms_bf16"], row["bound_by_bf16"] = sg2_bound(TAIL_B, c, h, h, x2, 2)
            # How far the plain bf16 version, which rounds every intermediate,
            # is from the f32 one on the same operands; and the bf16 design's
            # and plain bf16's signed mean error against float64 (do the
            # tensor cores' truncating f32 sums bias the bf16 design?).
            ref = fused_section_plain(*[t.float() for t in ops], want_x2=x2)
            got = plain()
            got, ref = (got, ref) if x2 else ((got,), (ref,))
            row["plain_bf16_err"] = max(float((g.float() - r).abs().max())
                                        for g, r in zip(got, ref))
            ref64 = fused_section_plain(*[t.double() for t in ops], want_x2=x2)
            ref64 = ref64 if x2 else (ref64,)
            for name, fn in (("bf16", kern), ("polyphase", poly), ("plain_bf16", plain)):
                out = fn()
                row["audit_" + name] = error_stats([(out if x2 else (out,), ref64)])
            del ref, ref64, got, out
            # The render batch's own shape (bf16, the CLI's batch size).
            ops = sg2_problem(6, SG2["batch"], c, h, h, torch.bfloat16)
            p1, k1, q1, q2, k2, p2 = (cuda_ms(f, iters=3, warmup=1)
                                      for f in (plain, kern, poly, poly, kern, plain))
            row["ms_render_bf16"], row["plain_ms_render_bf16"] = (k1 + k2) / 2, (p1 + p2) / 2
            row["polyphase_ms_render_bf16"] = (q1 + q2) / 2
            row["bound_ms_render_bf16"], row["bound_by_render_bf16"] = sg2_bound(
                SG2["batch"], c, h, h, x2, 2)
            sections.append(row)
            del ops

    # One generator forward's tail is the two sections: the row's times, bound
    # and error are theirs summed (f32, B=4).
    f32_names = [f"B={TAIL_B} C={c} {h}x{h}{' +x2' if x2 else ''} float32"
                 for c, h, x2 in SG2_SECTIONS]
    res = {"max_abs_err": max(errs[n] for n in f32_names), "max_abs_errs": errs,
           "sections": [{k: v for k, v in r.items() if not k.startswith("runs")}
                        for r in sections],
           "bound_by": sections[0]["bound_by"], "bound_by_bf16": sections[0]["bound_by_bf16"],
           "design": {str(dt).split(".")[-1]: sg2_tail_cuda.design(dt)
                      for dt in (torch.float32, torch.bfloat16)},
           "shape": f"2 sections (C=64@512^2 +x2, C=32@1024^2), B={TAIL_B} f32, summed"}
    check(all(r["bound_by" + k] == res["bound_by" + k] for r in sections for k in ("", "_bf16"))
          and all(r["bound_by_render_bf16"] == res["bound_by_bf16"] for r in sections),
          "sections bound differently")
    sum_sections(res, sections)
    for r in sections:
        f32 = f32_section_text(r)
        k1, k2, p1, p2, q1, q2 = r["runs_bf16"]
        print(f"[kernel] sg2_tail C={r['c']} {r['in']}^2 -> {2 * r['in']}^2"
              f"{' + x2' if r['want_x2'] else ''} on {card}: {f32}; bf16 B={TAIL_B}: kernel "
              f"{r['ms_bf16']:.4f} ms ({k1:.4f}, {k2:.4f}) polyphase design "
              f"{r['polyphase_ms_bf16']:.4f} ms ({q1:.4f}, {q2:.4f}) plain "
              f"{r['plain_ms_bf16']:.4f} ms ({p1:.4f}, {p2:.4f}), bound "
              f"{r['bound_ms_bf16']:.4f} ms by {r['bound_by_bf16']} at the bf16 tensor-core "
              f"peak; plain bf16 vs f32 max abs {r['plain_bf16_err']:.3g}, polyphase design "
              f"{r['polyphase_err']:.3g}; against float64 (max abs, signed mean error +- its "
              f"standard error): bf16 kernel {stats_text(r['audit_bf16'])}, polyphase design "
              f"{stats_text(r['audit_polyphase'])}, plain bf16 "
              f"{stats_text(r['audit_plain_bf16'])}; bf16 at the render batch "
              f"B={SG2['batch']}: kernel "
              f"{r['ms_render_bf16']:.4f} ms polyphase design "
              f"{r['polyphase_ms_render_bf16']:.4f} ms plain {r['plain_ms_render_bf16']:.4f} ms "
              f"bound {r['bound_ms_render_bf16']:.4f} ms; no library call")
    print(f"[kernel] sg2_tail, the two sections summed; design f32: {res['design']['float32']}, "
          f"bf16: {res['design']['bfloat16']}: f32 B={TAIL_B} kernel {res['ms']:.4f} ms, "
          f"CUDA-core design {ms_text(res['cc_ms'])}, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} at the TF32 tensor cores "
          f"({res['bound_ms_cuda_cores']:.4f} ms on the CUDA cores); f32 B=1 kernel "
          f"{res['ms_b1']:.4f} ms, CUDA-core design {ms_text(res['cc_ms_b1'])}, plain "
          f"{res['plain_ms_b1']:.4f} ms, bound {res['bound_ms_b1']:.4f} ms "
          f"({res['bound_ms_cuda_cores_b1']:.4f} ms); bf16 B={TAIL_B} kernel "
          f"{res['ms_bf16']:.4f} ms plain {res['plain_ms_bf16']:.4f} ms bound "
          f"{res['bound_ms_bf16']:.4f} ms by {res['bound_by_bf16']}; at B={SG2['batch']} bf16 "
          f"kernel {res['ms_render_bf16']:.4f} ms plain {res['plain_ms_render_bf16']:.4f} ms "
          f"bound {res['bound_ms_render_bf16']:.4f} ms; "
          "max abs err " + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items()))
    return res


def reset_launch_counts() -> None:
    """Set every kernel wrapper's count to 0 (just before a main path is driven)."""
    from warpedganspace_torch.ops import attn_cuda, proggan_tail_cuda, rbf_cuda, sg2_tail_cuda

    rbf_cuda.launches = attn_cuda.launches = attn_cuda.bwd_launches = 0
    proggan_tail_cuda.launches = sg2_tail_cuda.launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's count (just after a main path was driven)."""
    from warpedganspace_torch.ops import attn_cuda, proggan_tail_cuda, rbf_cuda, sg2_tail_cuda

    return {"rbf_warp": rbf_cuda.launches, "sa_attention": attn_cuda.launches,
            "sa_attention_bwd": attn_cuda.bwd_launches,
            "proggan_tail": proggan_tail_cuda.launches, "sg2_tail": sg2_tail_cuda.launches}


def check_images(x, shape, name: str) -> None:
    import torch

    check(tuple(x.shape) == shape, f"{name} image shape {tuple(x.shape)}")
    check(bool(torch.isfinite(x).all()), f"non-finite {name} image")
    check(float(x.float().std()) > 0, f"constant {name} image")


def sg2_tail_without_noise(*operands, want_x2=True):
    """A deliberately WRONG tail section: the plain version with both noise
    terms dropped (what a kernel that forgets its noise epilogue computes)."""
    import torch

    from warpedganspace_torch.ops.sg2_tail import fused_section_plain

    ops = list(operands)
    ops[10], ops[13] = torch.zeros_like(ops[10]), torch.zeros_like(ops[13])
    return fused_section_plain(*ops, want_x2=want_x2)


def phase_generator_stylegan2(card: str) -> None:
    import torch

    from warpedganspace_torch.models import stylegan2
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.ops import sg2_tail_cuda
    from warpedganspace_torch.ops.sg2_tail import fused_section_plain

    G = build_gan("StyleGAN2", stylegan2_resolution=1024, shift_in_w_space=True,
                  allow_random_init=True, device="cuda")
    net = G.net
    check(len(net.to_rgbs) - net.tail_start() == 2,
          "StyleGAN2-1024 config-f must have two tail sections")
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        # The random init leaves every noise weight and bias at 0, which would
        # hide a dropped noise or bias term: perturb them.
        for blk in [net.conv1] + list(net.convs):
            blk.noise_weight.fill_(float(0.2 + 0.1 * torch.rand(1, generator=gen)))
            blk.act_bias.copy_(0.1 * torch.randn(blk.act_bias.shape, generator=gen))
        for rgb in [net.to_rgb1] + list(net.to_rgbs):
            rgb.bias.copy_(0.1 * torch.randn(3, generator=gen))
    G16 = cast_params_bf16(G)
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        w = G.get_w(z)
        shift = 0.2 * torch.nn.functional.normalize(torch.randn_like(w), dim=-1)
        w16, shift16 = w.bfloat16(), shift.bfloat16()
        before = sg2_tail_cuda.launches
        by_design = dict(sg2_tail_cuda.launches_by_design)
        img = G(w, shift, latent_is_w=True)
        torch.cuda.synchronize()
        check(sg2_tail_cuda.launches == before + 2,
              "StyleGAN2-1024's forward must launch the tail kernel twice")
        img16 = G16(w16, shift16, latent_is_w=True).float()
        torch.cuda.synchronize()
        check(sg2_tail_cuda.launches == before + 4, "the bf16 forward's two tail launches")
        check(sg2_tail_cuda.launches_by_design == {"wgmma": by_design["wgmma"] + 2,
                                                   "split_tf32": by_design["split_tf32"] + 2},
              "the bf16 forward's tail launches went through the wgmma design, the f32 "
              "forward's through the split TF32 one")
        check_images(img, (4, 3, 1024, 1024), "f32")
        check_images(img16, (4, 3, 1024, 1024), "bf16")
        p16 = psnr(img16, img)
        ms32 = cuda_ms(lambda: G(w, shift, latent_is_w=True), iters=5, warmup=1)
        ms16 = cuda_ms(lambda: G16(w16, shift16, latent_is_w=True), iters=5, warmup=1)

        # The same forward with the kernel swapped for its plain version (a
        # check of the kernel inside the model, not a path the port takes),
        # then for a wrong tail, to show that this comparison sees it.
        kernel_fn = stylegan2.fused_section
        try:
            stylegan2.fused_section = fused_section_plain
            before = sg2_tail_cuda.launches
            img_plain = G(w, shift, latent_is_w=True)
            img16_plain = G16(w16, shift16, latent_is_w=True).float()
            check(sg2_tail_cuda.launches == before, "the swapped forward still launched")
            ms32_plain = cuda_ms(lambda: G(w, shift, latent_is_w=True), iters=5, warmup=1)
            ms16_plain = cuda_ms(lambda: G16(w16, shift16, latent_is_w=True), iters=5, warmup=1)
            stylegan2.fused_section = sg2_tail_without_noise
            p_noise = psnr(G(w, shift, latent_is_w=True), img_plain)
        finally:
            stylegan2.fused_section = kernel_fn
        pp = psnr(img, img_plain)
        pp16 = psnr(img16, img16_plain)
        # The card's f32 against the CPU's f32 on the same weights (TF32 off).
        Gc = copy.deepcopy(G).to("cpu")
        pc = psnr(img[:1].cpu(), Gc(w[:1].cpu(), shift[:1].cpu(), latent_is_w=True))
    check(pc > 40.0, f"card f32 vs CPU f32 PSNR {pc:.2f} dB <= 40")
    # A tail without its noise terms moves the image by p_noise; the kernel
    # path must agree far better.
    check(pp > 40.0 and pp > p_noise + 20.0,
          f"StyleGAN2 kernel path vs plain tail PSNR {pp:.2f} dB (noise dropped: "
          f"{p_noise:.2f} dB)")
    # In bf16 the two paths round at different places (the plain version
    # rounds every intermediate, the kernel only its outputs).
    check(pp16 > 40.0, f"StyleGAN2 bf16 kernel path vs plain tail PSNR {pp16:.2f} dB <= 40")
    print(f"[generator] StyleGAN2-1024 W, B=4 on {card}: f32 {ms32:.2f} ms/batch "
          f"({ms32_plain:.2f} with the plain tail), bf16 {ms16:.2f} ms/batch ({ms16_plain:.2f}); "
          f"2 tail launches per forward; bf16-vs-f32 PSNR {p16:.2f} dB; kernel-vs-plain-tail "
          f"PSNR {pp:.2f} dB f32 (noise dropped: {p_noise:.2f} dB), {pp16:.2f} dB bf16; "
          f"card-vs-CPU f32 PSNR {pc:.2f} dB")


def open_attention(G, value: float = 1.0):
    """Set every attention block's gamma (0 in the random init, where the block
    adds nothing and its backward gets a zero cotangent)."""
    import torch

    with torch.no_grad():
        for block in G.net.blocks:
            if block.attention is not None:
                block.attention.gamma.fill_(value)
    return G


def phase_generator_biggan(card: str) -> None:
    import torch

    from warpedganspace_torch.models import biggan
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.ops.attn import sa_attention_plain

    b = ATTN_SHAPE[0]
    # The random init leaves the attention's gamma at 0, which would hide the
    # block from every image check below: open it.
    G = open_attention(build_gan("BigGAN", target_classes=[239], allow_random_init=True,
                                 device="cuda"))
    G16 = cast_params_bf16(G)
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((b, G.dim_z), generator=gen).cuda()
    shift = (0.15 * torch.nn.functional.normalize(torch.randn((b, G.dim_z), generator=gen),
                                                  dim=-1)).cuda()
    with torch.no_grad():
        before = attn_cuda.launches
        img = G(z, shift)
        img16 = G16(z.bfloat16(), shift.bfloat16()).float()
        torch.cuda.synchronize()
        check(attn_cuda.launches == before + 2, "BigGAN's forward did not launch the attention")
        check_images(img, (b, 3, 128, 128), "BigGAN f32")
        check_images(img16, (b, 3, 128, 128), "BigGAN bf16")
        p16 = psnr(img16, img)
        ms32 = cuda_ms(lambda: G(z, shift), iters=10, warmup=2)
        ms16 = cuda_ms(lambda: G16(z.bfloat16(), shift.bfloat16()), iters=10, warmup=2)
        # One render batch as the traversal makes it: bf16 at the CLI's batch size.
        zr, shiftr = (t.repeat(BIGGAN["batch"] // b, 1).bfloat16() for t in (z, shift))
        zr = zr + 0.5 * torch.randn(zr.shape, generator=gen).cuda().bfloat16()
        img16r = G16(zr, shiftr).float()
        check_images(img16r, (BIGGAN["batch"], 3, 128, 128), "BigGAN bf16 render batch")

        # The same forward with the kernel swapped for its plain version (a
        # check of the kernel inside the model, not a path the port takes),
        # and with the attention closed, to show the check can see the block.
        kernel_fn = biggan.sa_attention
        biggan.sa_attention = sa_attention_plain
        try:
            before = attn_cuda.launches
            img_plain = G(z, shift)
            img16r_plain = G16(zr, shiftr).float()
            check(attn_cuda.launches == before, "the swapped forward still launched the kernel")
            ms32_plain = cuda_ms(lambda: G(z, shift), iters=10, warmup=2)
        finally:
            biggan.sa_attention = kernel_fn
        pp = psnr(img, img_plain)
        pp16 = psnr(img16r, img16r_plain)
        Gc = copy.deepcopy(G).to("cpu")
        pc = psnr(img[:2].cpu(), Gc(z[:2].cpu(), shift[:2].cpu()))
        check(pc > 40.0, f"BigGAN card f32 vs CPU f32 PSNR {pc:.2f} dB <= 40")
        p_closed = psnr(open_attention(G, 0.0)(z, shift), img)
        p_closed16 = psnr(open_attention(G16, 0.0)(zr, shiftr).float(), img16r)
    # A broken attention output would move the image about as much as closing
    # the block does, so the kernel path must agree far better than that.
    check(pp > 40.0 and pp > p_closed + 20.0,
          f"BigGAN kernel path vs plain attention PSNR {pp:.2f} dB (attention closed: "
          f"{p_closed:.2f} dB)")
    # In bf16 the two paths round at different places (the plain version rounds
    # the normalised softmax weights to bf16, the kernel the unnormalised
    # weights of each 64-key chunk).
    check(pp16 > 40.0 and pp16 > p_closed16 + 10.0,
          f"BigGAN bf16 render batch, kernel path vs plain attention PSNR {pp16:.2f} dB "
          f"(attention closed: {p_closed16:.2f} dB)")
    print(f"[generator] BigGAN-128 class 239, B={b} on {card}: f32 {ms32:.2f} ms/batch "
          f"({ms32_plain:.2f} with the plain attention), bf16 {ms16:.2f} ms/batch; "
          f"bf16-vs-f32 PSNR {p16:.2f} dB; kernel-vs-plain-attention PSNR {pp:.2f} dB "
          f"(attention closed: {p_closed:.2f} dB); bf16 render batch of {BIGGAN['batch']}: "
          f"{pp16:.2f} dB (attention closed: {p_closed16:.2f} dB); "
          f"card-vs-CPU f32 PSNR {pc:.2f} dB")


def spectral_normalise(module) -> None:
    """Divide every conv, linear and embedding weight of ``module`` by its
    largest singular value, as a trained BigGAN D's spectral norm leaves it."""
    import torch

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, torch.nn.Embedding)):
                w = m.weight.reshape(m.weight.shape[0], -1).double()
                m.weight.div_(float(torch.linalg.matrix_norm(w, ord=2)))


def perturb_biases(module, gen, scale: float = 0.1) -> None:
    """Random biases (0 in the random init, where a dropped bias would not show)."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(scale * torch.randn(p.shape, generator=gen))


def phase_discriminators(card: str) -> tuple:
    """``discriminators``: StyleGAN2 config-f D at 1024² (B=``D_SG2_B``), the
    BigGAN-128 D (D_ch=96, D_attn="64", B=``D_BIGGAN_B``) and BigGAN's G_D
    pair at class 239 (B=``GD_B``: fakes, fakes + reals in one D forward, and
    split), in f32 with seeded random weights (BigGAN's spectrally normalised,
    attention gammas 1, biases random). The counts are set to 0 just before
    that path and read just after: the attention kernel once per G and per D
    forward, ``D_PATH_ATTN`` in all. Then each D's logits against a float64 run
    of the same module on the card (the attention through its plain version,
    which the kernel does not take in float64); BigGAN D's against the same D
    with the plain attention, and with the attention closed, to show the
    comparison sees it; G_D's joint, split and fake-only logits against each
    other and against float64. Times each forward, and the attention kernel at
    D's own operands against plain, SDPA and its bound. Returns (the path's
    launch counts, the attention's numbers at D's shape)."""
    import torch
    import torch.nn.functional as F

    from warpedganspace_torch.models import biggan
    from warpedganspace_torch.models.biggan import BigGAN_GD, BigGANDiscriminator
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Discriminator
    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.ops.attn import sa_attention_plain

    marks = {"start": time.perf_counter()}
    gen = torch.Generator().manual_seed(12)
    sg2 = StyleGAN2Discriminator(1024, 2, generator=gen)
    perturb_biases(sg2, gen)
    bd = BigGANDiscriminator(128, 96, 1000, "64", generator=gen)
    perturb_biases(bd, gen)
    sg2, bd = sg2.cuda().eval(), bd.cuda().eval()
    spectral_normalise(bd)
    with torch.no_grad():
        bd.blocks[0].attention.gamma.fill_(1.0)
    check([b.attention is not None for b in bd.blocks] == [True] + [False] * 5,
          "BigGAN-128's D must attend once, after its first block (64²)")
    G = open_attention(build_gan("BigGAN", target_classes=[239], allow_random_init=True,
                                 device="cuda")).net
    gd = BigGAN_GD(G, bd)
    x_sg2 = torch.randn((D_SG2_B, 3, 1024, 1024), generator=gen).cuda()
    x_bg = torch.randn((D_BIGGAN_B, 3, 128, 128), generator=gen).cuda()
    y_bg = torch.randint(0, 1000, (D_BIGGAN_B,), generator=gen).cuda()
    z = torch.randn((GD_B, G.dim_z), generator=gen).cuda()
    gy = torch.full((GD_B,), 239, dtype=torch.long).cuda()
    x_real, dy = x_bg[:GD_B], y_bg[:GD_B]
    marks["models"] = time.perf_counter()

    with torch.no_grad():
        reset_launch_counts()
        l_sg2 = sg2(x_sg2)
        torch.cuda.synchronize()
        n_sg2 = attn_cuda.launches
        l_bg = bd(x_bg, y_bg)
        torch.cuda.synchronize()
        n_bg = attn_cuda.launches - n_sg2
        gd_fake = gd(z, gy)
        gd_joint = gd(z, gy, x_real, dy)
        gd_split = gd(z, gy, x_real, dy, split_D=True)
        torch.cuda.synchronize()
        counts = launch_counts()
    marks["path"] = time.perf_counter()
    check(n_sg2 == 0 and n_bg == 1,
          f"StyleGAN2's D launched the attention {n_sg2} times, BigGAN's {n_bg}; not 0 and 1")
    want_counts = dict(dict.fromkeys(counts, 0), sa_attention=D_PATH_ATTN)
    check(counts == want_counts, f"the discriminators' path launched {counts}, not {want_counts}")
    for name, t, b in (("StyleGAN2 D", l_sg2, D_SG2_B), ("BigGAN D", l_bg, D_BIGGAN_B),
                       ("G_D fake", gd_fake, GD_B), ("G_D joint fake", gd_joint[0], GD_B),
                       ("G_D joint real", gd_joint[1], GD_B), ("G_D split fake", gd_split[0], GD_B),
                       ("G_D split real", gd_split[1], GD_B)):
        check(tuple(t.shape) == (b, 1) and bool(torch.isfinite(t).all())
              and float(t.std()) > 0, f"{name} logits: shape {tuple(t.shape)}, finite "
                                      f"{bool(torch.isfinite(t).all())}")

    # The comparisons, outside the counted path.
    err = {}
    with torch.no_grad():
        kernel_fn = biggan.sa_attention
        biggan.sa_attention = sa_attention_plain
        try:
            before = attn_cuda.launches
            l_bg_plain = bd(x_bg, y_bg)
            sg2_64, bd_64 = copy.deepcopy(sg2).double(), copy.deepcopy(bd).double()
            gd_64 = BigGAN_GD(copy.deepcopy(G).double(), bd_64)
            l_sg2_64 = sg2_64(x_sg2.double())
            l_bg_64 = bd_64(x_bg.double(), y_bg)
            gd_fake_64 = gd_64(z.double(), gy)
            torch.cuda.synchronize()
            check(attn_cuda.launches == before, "the plain and float64 runs launched the kernel")
            ms_bg_plain = cuda_ms(lambda: bd(x_bg, y_bg), iters=10, warmup=2)
            bd.blocks[0].attention.gamma.zero_()
            l_bg_closed = bd(x_bg, y_bg)
            bd.blocks[0].attention.gamma.fill_(1.0)
            del sg2_64, bd_64, gd_64
        finally:
            biggan.sa_attention = kernel_fn
        marks["plain and float64 runs"] = time.perf_counter()
        err["BigGAN D kernel vs plain attention"] = rel_err(l_bg, l_bg_plain)
        err["BigGAN D attention closed"] = rel_err(l_bg_closed, l_bg_plain)
        err["StyleGAN2 D f32 vs f64"] = rel_err(l_sg2, l_sg2_64)
        err["BigGAN D f32 vs f64"] = rel_err(l_bg, l_bg_64)
        err["G_D fake f32 vs f64"] = rel_err(gd_fake, gd_fake_64)
        err["G_D joint vs fake-only"] = rel_err(gd_joint[0], gd_fake)
        err["G_D split vs joint"] = max(rel_err(gd_split[0], gd_joint[0]),
                                        rel_err(gd_split[1], gd_joint[1]))

        ms_sg2 = cuda_ms(lambda: sg2(x_sg2), iters=5, warmup=1)
        ms_bg = cuda_ms(lambda: bd(x_bg, y_bg), iters=10, warmup=2)
        ms_gd = cuda_ms(lambda: gd(z, gy), iters=10, warmup=2)
        marks["forward times"] = time.perf_counter()

        # The attention kernel at D's own operands.
        seen = []

        def capture(theta, phi, g):
            seen.append((theta, phi, g))
            return kernel_fn(theta, phi, g)

        biggan.sa_attention = capture
        try:
            bd(x_bg, y_bg)
        finally:
            biggan.sa_attention = kernel_fn
        theta, phi, g = seen[0]
        b, n, dk = theta.shape
        m, dv = g.shape[1], g.shape[2]
        check((b, n, m, dk, dv) == (D_BIGGAN_B, 4096, 1024, 12, 48),
              f"BigGAN D's attention operands {(b, n, m, dk, dv)}")
        kern = lambda: attn_cuda.sa_attention(theta, phi, g)  # noqa: E731
        plain = lambda: sa_attention_plain(theta, phi, g)  # noqa: E731
        attn_err = float((kern() - plain()).abs().max())
        check(attn_err <= 1e-4, f"the attention kernel at D's operands: max abs {attn_err:.3g}")
        p1, k1, k2, p2 = (cuda_ms(f, iters=20) for f in (plain, kern, kern, plain))
        q, k, v = theta[:, None], phi[:, None], g[:, None]
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
        lib_err = float((lib()[:, 0] - plain()).abs().max())
        lib_ms = cuda_ms(lib, iters=20)
    marks["attention times"] = time.perf_counter()
    bounds = attn_bounds(b, n, m, dk, dv, 4)
    bound_ms, bound_by = bounds["tc"]
    bound_cc = bounds["cuda_cores"][0]
    check(err["BigGAN D kernel vs plain attention"] <= 1e-4
          and err["BigGAN D attention closed"] > 100 * err["BigGAN D kernel vs plain attention"],
          f"BigGAN D, kernel vs plain attention: {err['BigGAN D kernel vs plain attention']:.3g} "
          f"of max|logit| (attention closed: {err['BigGAN D attention closed']:.3g})")
    for name in ("StyleGAN2 D f32 vs f64", "BigGAN D f32 vs f64", "G_D fake f32 vs f64"):
        check(err[name] <= 1e-3, f"{name}: {err[name]:.3g} of max|logit| > 1e-3")
    for name in ("G_D joint vs fake-only", "G_D split vs joint"):
        check(err[name] <= 1e-4, f"{name}: {err[name]:.3g} of max|logit| > 1e-4")
    attn_d = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_cuda_cores": bound_cc,
              "max_abs_err": attn_err,
              "shape": f"B={b} N={n} M={m} dk={dk} dv={dv} f32"}
    print(f"[discriminators] on {card}, f32, TF32 off: StyleGAN2 config-f D 1024², "
          f"B={D_SG2_B}: {ms_sg2:.2f} ms a forward; BigGAN-128 D (D_ch=96, attention at 64²), "
          f"B={D_BIGGAN_B}: {ms_bg:.2f} ms a forward ({ms_bg_plain:.2f} with the plain "
          f"attention); G_D at class 239, B={GD_B} fakes: {ms_gd:.2f} ms; attention launches "
          f"on the path {counts['sa_attention']} (1 a D forward); of max|logit|: "
          + ", ".join(f"{name} {e:.3g}" for name, e in err.items())
          + "; the phase's seconds: " + ", ".join(
              f"{name} {t - prev:.1f}" for (name, t), prev
              in zip(list(marks.items())[1:], list(marks.values())[:-1])))
    print(f"[discriminators] sa_attention at BigGAN D's operands, {attn_d['shape']} on {card}: "
          f"kernel {attn_d['ms']:.4f} ms ({k1:.4f}, {k2:.4f}) plain {attn_d['plain_ms']:.4f} ms "
          f"({p1:.4f}, {p2:.4f}) library SDPA {lib_ms:.4f} ms (its max abs err vs plain "
          f"{lib_err:.3g}); bound {bound_ms:.4f} ms by {bound_by} at the TF32 tensor cores, "
          f"{bound_cc:.4f} ms on the CUDA cores; kernel max abs err {attn_err:.3g}")
    return counts, attn_d


def phase_generator_biggan_grad(card: str, dtype) -> None:
    """The gradient that training needs, d(scalar of G(z + shift)) / d(shift),
    at full width with the attention open: through the backward kernel against
    the same through the plain backward, and against a deliberately wrong
    backward (dg zeroed), to show that the comparison would see one. In bf16
    the generator is the bf16 copy a training step runs, fed z and the shift
    cast to bf16 as there."""
    import torch

    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.ops.attn import sa_attention_bwd_plain

    b = 4
    G = open_attention(build_gan("BigGAN", target_classes=[239], allow_random_init=True,
                                 device="cuda"))
    with torch.no_grad():
        # The 0.02 init gives logits near 0 and a block that adds little to
        # its input: ten times the weights, so that the block weighs in.
        for block in G.net.blocks:
            if block.attention is not None:
                for conv in (block.attention.theta, block.attention.phi, block.attention.g,
                             block.attention.o):
                    conv.weight.mul_(10.0)
    if dtype == torch.bfloat16:
        G = cast_params_bf16(G)
    gen = torch.Generator().manual_seed(11)
    z = torch.randn((b, G.dim_z), generator=gen).cuda()
    shift0 = (0.15 * torch.nn.functional.normalize(torch.randn((b, G.dim_z), generator=gen),
                                                   dim=-1)).cuda()
    weight = torch.randn((b, 3, 128, 128), generator=gen).cuda()

    def grad_of_shift():
        shift = shift0.clone().requires_grad_()
        (G(z.to(dtype), shift.to(dtype)).float() * weight).sum().backward()
        return shift.grad

    before = attn_cuda.launches, attn_cuda.bwd_launches
    g_kernel = grad_of_shift()
    torch.cuda.synchronize()
    check((attn_cuda.launches, attn_cuda.bwd_launches) == (before[0] + 1, before[1] + 1),
          "BigGAN's forward and backward must launch each attention kernel once")
    check(bool(torch.isfinite(g_kernel).all()) and float(g_kernel.abs().max()) > 0,
          "the shift's gradient through the kernels is zero or not finite")

    # The same forward (the kernel's, so every ReLU gate is the same) with the
    # backward kernel swapped for the plain backward, then for a wrong one: a
    # check of the kernel inside the model, not a path the port takes.
    real_bwd = attn_cuda._launch_bwd

    def plain_bwd(theta, phi, g, out, lse, ct):
        return sa_attention_bwd_plain(theta, phi, g, ct)

    def wrong_bwd(*args):
        dtheta, dphi, dg = real_bwd(*args)
        return dtheta, dphi, torch.zeros_like(dg)

    try:
        attn_cuda._launch_bwd = plain_bwd
        before = attn_cuda.bwd_launches
        g_plain = grad_of_shift()
        check(attn_cuda.bwd_launches == before, "the swapped backward still launched the kernel")
        attn_cuda._launch_bwd = wrong_bwd
        g_wrong = grad_of_shift()
    finally:
        attn_cuda._launch_bwd = real_bwd
    e, e_wrong = rel_err(g_kernel, g_plain), rel_err(g_wrong, g_plain)
    # Only the attention's backward differs: in f32 by sums in another order,
    # in bf16 also by where the two round (the attention backward's own bound
    # is 3e-2), and every bf16 layer below rounds the difference again. A
    # wrong dg must stand far above that.
    tol, margin = (1e-4, 100) if dtype == torch.float32 else (3e-2, 10)
    name = str(dtype).split(".")[-1]
    check(e <= tol and e_wrong > margin * max(e, 1e-6),
          f"shift gradient, {name}, kernel backward vs plain backward: {e:.3g} of the largest "
          f"entry (with dg zeroed: {e_wrong:.3g})")
    print(f"[generator] BigGAN-128 class 239, B={b}, {name}, attention open, on {card}: "
          f"d(G(z + shift) . w)/d(shift) through the backward kernel vs the plain backward: "
          f"{e:.3g} of the largest entry; with dg zeroed {e_wrong:.3g}")


def tail_with_computed_border(x, sections, out):
    """A deliberately WRONG tail: the mid tensor's border is computed from the
    zero-padded input instead of being the same-conv's zero padding (what a
    tiled kernel does if it forgets to zero its halo outside the image)."""
    import torch.nn.functional as F

    from warpedganspace_torch.ops.proggan_tail import (LEAKY_SLOPE, head_plain, pixel_norm,
                                                       wscale)

    for up, same in sections:
        x = F.interpolate(pixel_norm(x), scale_factor=2, mode="nearest")
        x = F.leaky_relu(wscale(F.conv2d(x, up.weight, padding=2), up.scale, up.bias),
                         LEAKY_SLOPE)
        x = F.leaky_relu(wscale(F.conv2d(pixel_norm(x), same.weight), same.scale, same.bias),
                         LEAKY_SLOPE)
    return head_plain(x, out.weight, out.bias, out.scale)


def phase_generator_proggan(card: str) -> None:
    import torch

    from warpedganspace_torch.models import proggan
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.ops import proggan_tail_cuda
    from warpedganspace_torch.ops.proggan_tail import proggan_tail_plain

    b = TAIL_B
    G = build_gan("ProgGAN", allow_random_init=True, device="cuda")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        # The random init leaves every WScale at scale 1 and bias 0, which
        # would hide a wrong scale, bias or border: perturb them.
        for block in list(G.net.blocks) + [G.net.out]:
            block.scale.copy_(torch.rand(1, generator=gen) * 0.45 + 0.8)
            block.bias.copy_(0.1 * torch.randn(block.bias.shape, generator=gen))
    G16 = cast_params_bf16(G)
    z = torch.randn((b, G.dim_z), generator=gen).cuda()
    shift = (0.15 * torch.nn.functional.normalize(torch.randn((b, G.dim_z), generator=gen),
                                                  dim=-1)).cuda()
    n_head, sections = G.net.tail_split()
    check(n_head == 12 and len(sections) == 3, "the full-width chain must split 12 + 3 sections")
    with torch.no_grad():
        before = proggan_tail_cuda.launches
        img = G(z, shift)
        torch.cuda.synchronize()
        check(proggan_tail_cuda.launches == before + 3,
              "ProgGAN's forward must launch the tail kernel three times")
        img16 = G16(z.bfloat16(), shift.bfloat16()).float()
        torch.cuda.synchronize()
        check(proggan_tail_cuda.launches == before + 6, "the bf16 forward's three tail launches")
        check_images(img, (b, 3, 1024, 1024), "ProgGAN f32")
        check_images(img16, (b, 3, 1024, 1024), "ProgGAN bf16")
        p16 = psnr(img16, img)
        # Few f32 calls: at B=4 cuDNN takes an FFT algorithm for one block and
        # the forward is some 400 ms (PERF.md section 7).
        ms32 = cuda_ms(lambda: G(z, shift), iters=3, warmup=1)
        ms16 = cuda_ms(lambda: G16(z.bfloat16(), shift.bfloat16()), iters=10, warmup=2)
        # The ProgGAN path's own two forwards: one f32 code, a bf16 render batch.
        ms32_one = cuda_ms(lambda: G(z[:1]), iters=10, warmup=2)
        zr = z.bfloat16().repeat(PROGGAN["batch"] // b, 1)
        ms16_render = cuda_ms(lambda: G16(zr), iters=10, warmup=2)

        # The same forward with the kernel swapped for its plain version (a
        # check of the kernel inside the model, not a path the port takes),
        # then for two wrong tails, to show that this comparison sees them.
        kernel_fn = proggan.proggan_tail
        try:
            proggan.proggan_tail = proggan_tail_plain
            before = proggan_tail_cuda.launches
            img_plain = G(z, shift)
            img16_plain = G16(z.bfloat16(), shift.bfloat16()).float()
            check(proggan_tail_cuda.launches == before, "the swapped forward still launched")
            ms32_plain = cuda_ms(lambda: G(z, shift), iters=3, warmup=1)
            ms16_plain = cuda_ms(lambda: G16(z.bfloat16(), shift.bfloat16()), iters=5, warmup=1)
            proggan.proggan_tail = tail_with_computed_border
            p_border = psnr(G(z, shift), img_plain)
            proggan.proggan_tail = proggan_tail_plain
            last_same = sections[-1][1]
            kept = last_same.bias.clone()
            last_same.bias.zero_()
            p_bias = psnr(G(z, shift), img_plain)
            last_same.bias.copy_(kept)
        finally:
            proggan.proggan_tail = kernel_fn
        pp = psnr(img, img_plain)
        pp16 = psnr(img16, img16_plain)
        # The card's f32 against the CPU's f32 on the same weights (TF32 off).
        Gc = copy.deepcopy(G).to("cpu")
        pc = psnr(img[:1].cpu(), Gc(z[:1].cpu(), shift[:1].cpu()))
    check(pc > 40.0, f"ProgGAN card f32 vs CPU f32 PSNR {pc:.2f} dB <= 40")
    # A tail with a computed mid border, or with one zeroed bias, moves the
    # image by p_border and p_bias; the kernel path must agree far better.
    check(pp > 40.0 and pp > max(p_border, p_bias) + 20.0,
          f"ProgGAN kernel path vs plain tail PSNR {pp:.2f} dB (computed border: "
          f"{p_border:.2f} dB, zeroed bias: {p_bias:.2f} dB)")
    # In bf16 the two paths round at different places (the plain version
    # rounds every intermediate, the kernel only its output).
    check(pp16 > 40.0, f"ProgGAN bf16 kernel path vs plain tail PSNR {pp16:.2f} dB <= 40")
    print(f"[generator] ProgGAN-1024, B={b} on {card}: f32 {ms32:.2f} ms/batch "
          f"({ms32_plain:.2f} with the plain tail), bf16 {ms16:.2f} ms/batch ({ms16_plain:.2f}); "
          f"f32 B=1 {ms32_one:.2f} ms, bf16 B={PROGGAN['batch']} {ms16_render:.2f} ms/batch; "
          f"3 tail launches per forward; bf16-vs-f32 PSNR {p16:.2f} dB; kernel-vs-plain-tail "
          f"PSNR {pp:.2f} dB f32 (computed mid border: {p_border:.2f} dB, last bias zeroed: "
          f"{p_bias:.2f} dB), {pp16:.2f} dB bf16; card-vs-CPU f32 PSNR {pc:.2f} dB")


def traverse_and_verify(cfg: dict, exp: str, S) -> tuple:
    """``sample_gan`` makes a one-code pool, then ``traverse_latent_space`` walks
    the experiment directory ``exp`` (whose support sets are ``S``) at bf16, from
    the current directory. Every kernel's count is set to 0 just before and read
    just after; the frames, the stored codes (against the plain warp on ``S``)
    and the counts are checked. Returns (launches, seconds of ``sample_gan``,
    seconds of the traversal, the codes' max abs error)."""
    import numpy as np
    import torch
    from PIL import Image

    from warpedganspace_torch.cli import sample_gan, traverse_latent_space
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.traverse.engine import traverse_paths

    gan, k, d, steps, eps = cfg["gan"], cfg["k"], cfg["d"], cfg["steps"], cfg["eps"]
    biggan, w_space = gan == "BigGAN", gan == "StyleGAN2"
    sample_argv = ["--biggan-target-classes", "239"] if biggan else []
    pool_dir = "BigGAN-239" if biggan else gan

    reset_launch_counts()                     # count only this path's launches
    t0 = time.perf_counter()
    sample_gan.main(["-g", gan, "--num-samples", "1", "--pool", cfg["pool"]] + sample_argv)
    t1 = time.perf_counter()
    traverse_latent_space.main([
        "--exp", exp, "--pool", cfg["pool"], "--shift-steps", str(steps),
        "--eps", str(eps), "--batch-size", str(cfg["batch"]), "--dtype", "bfloat16"]
        + (["--gif"] if cfg["gif"] else []))
    t2 = time.perf_counter()
    launches = launch_counts()

    n_frames = 2 * steps + 1
    out_dir = osp.join(exp, "results", cfg["pool"],
                       f"{2 * steps}_{eps}_{round(2 * steps * eps, 3)}")
    hashes = sorted(h for h in os.listdir(out_dir) if h != "paths_gifs")
    check(len(hashes) == 1, f"expected one latent code dir, got {hashes}")
    code_dir = osp.join(out_dir, hashes[0])
    jpgs = [osp.join(code_dir, "paths_images", f"path_{p:03d}", f"{t:06d}.jpg")
            for p in range(k) for t in range(n_frames)]
    check(all(osp.isfile(p) for p in jpgs), "missing traversal frames")
    check(osp.isfile(osp.join(code_dir, "original_image.jpg")), "no original_image.jpg")
    if cfg["gif"]:
        gifs = [osp.join(out_dir, "paths_gifs", f"path_{p:03d}.gif") for p in range(k)]
        check(all(osp.isfile(p) for p in gifs), "missing GIFs")
    codes = torch.load(osp.join(code_dir, "paths_latent_codes.pt")).numpy()
    check(codes.shape == (k, n_frames, d), f"codes shape {codes.shape}")
    check(bool(np.isfinite(codes).all()), "non-finite latent codes")
    first = np.asarray(Image.open(jpgs[0]), dtype=np.float32)
    last = np.asarray(Image.open(jpgs[n_frames - 1]), dtype=np.float32)
    other = np.asarray(Image.open(jpgs[-1]), dtype=np.float32)
    frame_shape = (cfg["res"], cfg["res"]) + ((3,) if cfg.get("channels", 3) == 3 else ())
    check(first.shape == frame_shape, f"frame shape {first.shape}")
    check(first.std() > 0 and float(np.abs(first - last).mean()) > 0
          and float(np.abs(first - other).mean()) > 0, "constant or unchanging frames")
    # Generator forwards: the render batches and sample_gan's one code.
    forwards = math.ceil(k * n_frames / cfg["batch"]) + 1
    # One warp launch per step; one attention launch per BigGAN forward; one
    # tail launch per section, three sections per ProgGAN forward and two per
    # StyleGAN2-1024 forward.
    want = {"rbf_warp": steps, "sa_attention": forwards if biggan else 0, "sa_attention_bwd": 0,
            "proggan_tail": 3 * forwards if gan == "ProgGAN" else 0,
            "sg2_tail": 2 * forwards if w_space else 0}
    check(launches == want, f"{gan}'s traversal of {forwards} generator forwards launched "
                            f"{launches}, not {want}")

    # The stored codes against the plain warp on the same code and sets.
    z = torch.load(osp.join("experiments", "latent_codes", pool_dir, cfg["pool"],
                            hashes[0], "latent_code.pt")).cuda()
    if w_space:
        G = build_gan(gan, stylegan2_resolution=cfg["res"], shift_in_w_space=True, device="cuda")
        with torch.no_grad():
            z = G.get_w(z)
    with torch.no_grad():
        ref, _ = traverse_paths(S.cuda(), z, eps, steps, backend="torch")
    err = float(np.abs(codes - ref[0].cpu().numpy()).max())
    # f32 steps of unit directions, the kernel's sums in another order.
    check(err <= 1e-3, f"traversal codes vs plain warp max abs {err:.3g}")
    return launches, t1 - t0, t2 - t1, err


def fabricated_experiment(cfg: dict):
    """Write a trained-looking experiment of ``cfg`` (seeded support sets,
    ``args.json``) under the current directory; returns (its path, the sets)."""
    import torch

    from warpedganspace_torch.models.support_sets import SupportSets

    gan, k = cfg["gan"], cfg["k"]
    exp = osp.join("experiments", "complete", "smoke_exp")
    os.makedirs(osp.join(exp, "models"))
    # ``sets`` seeded sets, of which the experiment keeps the first k.
    S = SupportSets(cfg.get("sets", k), cfg["dipoles"], cfg["d"], learn_gammas=True,
                    generator=torch.Generator().manual_seed(0))
    sd = {key: t[:k] for key, t in S.to_torch_state_dict().items()}
    S = SupportSets(k, cfg["dipoles"], cfg["d"], learn_gammas=True).from_torch_state_dict(sd)
    torch.save(sd, osp.join(exp, "models", "support_sets.pt"))
    args_json = {"gan_type": gan, "num_support_sets": k,
                 "num_support_dipoles": cfg["dipoles"], "learn_alphas": False,
                 "learn_gammas": True, "gamma": None}
    if gan == "BigGAN":
        args_json["biggan_target_classes"] = [239]
    elif gan == "StyleGAN2":
        args_json.update(shift_in_w_space=True, stylegan2_resolution=cfg["res"])
    with open(osp.join(exp, "args.json"), "w") as f:
        json.dump(args_json, f)
    return exp, S


def phase_cli(card: str, cfg: dict) -> dict:
    """One main path: ``sample_gan`` makes a one-code pool, then
    ``traverse_latent_space`` walks a fabricated experiment at bf16. Returns
    each kernel's launches on that path."""
    gan, k, steps = cfg["gan"], cfg["k"], cfg["steps"]
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wgs_smoke_") as tmp:
        os.chdir(tmp)
        try:
            exp, S = fabricated_experiment(cfg)
            launches, t_sample, t_traverse, err = traverse_and_verify(cfg, exp, S)
        finally:
            os.chdir(cwd)
    n = k * (2 * steps + 1)
    print(f"[cli] {gan}: sample_gan {t_sample:.2f} s; traverse_latent_space K={k} "
          f"steps={steps} bf16 batch {cfg['batch']}: {n} frames"
          f"{' + ' + str(k) + ' GIFs' if cfg['gif'] else ''} in {t_traverse:.2f} s "
          f"({n / t_traverse:.2f} frames/s, JPEG{' and GIF' if cfg['gif'] else ''} writing "
          f"included) on {card}; launches {launches}; codes vs plain warp max abs {err:.3g}")
    return launches


class StageClock:
    """Per-stage times of the attribute CLI, summed over a run: CUDA events
    around each device call (recorded on the current stream, read after a
    synchronise), the host's clock around each host call."""

    def __init__(self):
        self.events, self.host_s = {}, {}

    def device(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def host(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host_s.setdefault(name, []).append(time.perf_counter() - t0)
        return timed

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {n: sum(s.elapsed_time(e) for s, e in ev) for n, ev in self.events.items()}
        out.update({n: 1e3 * sum(v) for n, v in self.host_s.items()})
        return out


class Recorder:
    """Keeps the arguments and the result of the first call of each wrapped
    function (path 0 of a run)."""

    def __init__(self):
        self.calls = {}

    def __call__(self, name, fn):
        def rec(*args):
            out = fn(*args)
            self.calls.setdefault(name, (args, out))
            return out
        return rec


def run_attribute_cli(exp: str, cfg: dict, cuda: bool = True, device_wrap=None,
                      host_wrap=None) -> float:
    """``traverse_attribute_space`` on ``exp`` (seconds, synchronised). With
    the wraps, the predictor objects that ``load_predictors`` returns have
    their calls wrapped: ``device_wrap(name, fn)`` around each forward,
    ``host_wrap("sfd_nms", fn)`` around the detector's NMS."""
    import torch

    from warpedganspace_torch.cli import traverse_attribute_space as cli

    argv = ["--exp", exp, "--pool", cfg["pool"], "--shift-steps", str(cfg["steps"]),
            "--eps", str(cfg["eps"])] + ([] if cuda else ["--no-cuda"])
    saved = cli.load_predictors
    if device_wrap is not None:
        def load(device):
            preds = saved(device)
            det = preds["sfd"]
            det.forward_maps = device_wrap("sfd", det.forward_maps)
            det.detect_from_boxes = host_wrap("sfd_nms", det.detect_from_boxes)
            preds["id"].similarities = device_wrap("arcface", preds["id"].similarities)
            preds["au"].detect_AU = device_wrap("fanau", preds["au"].detect_AU)
            for name in ("fairface", "hopenet", "celeba"):
                preds[name] = device_wrap(name, preds[name])
            return preds

        cli.load_predictors = load
    try:
        t0 = time.perf_counter()
        cli.main(argv)
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        cli.load_predictors = saved


def read_eval_tree(h_dir: str) -> tuple:
    """({eval_np name: array}, {eval_json name: object}) of one hash dir."""
    import numpy as np

    np_dir, json_dir = osp.join(h_dir, "eval_np"), osp.join(h_dir, "eval_json")
    arrays = {f[:-4]: np.load(osp.join(np_dir, f)) for f in sorted(os.listdir(np_dir))}
    objs = {}
    for f in sorted(os.listdir(json_dir)):
        with open(osp.join(json_dir, f)) as fh:
            objs[f[:-5]] = json.load(fh)
    return arrays, objs


def forward_flops(nets, call) -> float:
    """FLOPs of ``call()``, counted from the shapes: 2 x the multiply-adds of
    every Conv2d and Linear of ``nets`` that runs in it."""
    import torch

    total = [0]

    def hook(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        else:
            k = m.in_features
        total[0] += 2 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for net in nets for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return float(total[0])


def raw_close(got, want) -> tuple:
    """(passes, worst error over max|want|) for the predictors' raw-output
    gate: |got - want| <= 1e-4 max|want| + 1e-3 |want|."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got - want)
    ok = (got.shape == want.shape and bool(np.isfinite(got).all())
          and bool((err <= 1e-4 * scale + 1e-3 * np.abs(want)).all()))
    return ok, float(err.max()) / max(scale, 1e-30)


def plain_path_ranking(attrs, names, ranges):
    """The reference's ranking loop, written apart from ``ranking/engine.py``:
    for every (code, path, attribute), the attribute's sequence scaled to
    [-1, 1] on its range and clipped, ``np.cov`` of it with the step index (the
    distance from the middle frame for ``identity``) over the index's
    stddev; the mean over the codes. ``attrs`` is (codes, paths, attributes,
    points) with an odd number of points. Returns (|corr|, its rows L1-normalised)."""
    import numpy as np

    n_codes, n_paths, n_attrs, n_points = attrs.shape
    check(n_points % 2 == 1, "the plain ranking takes paths of an odd number of points")
    steps = np.arange(n_points)
    corr = np.zeros((n_codes, n_paths, n_attrs))
    for s_ in range(n_codes):
        for k in range(n_paths):
            for a, name in enumerate(names):
                lo, hi = ranges[name]
                seq = np.clip(2.0 * (attrs[s_, k, a] - lo) / (hi - lo) - 1.0, -1.0, 1.0)
                idx = np.abs(steps - n_points // 2) if name == "identity" else steps
                with np.errstate(divide="ignore", invalid="ignore"):
                    corr[s_, k, a] = np.cov(seq, idx)[0, 1] / np.sqrt(np.cov(idx))
    corr = np.abs(corr.mean(0))
    with np.errstate(divide="ignore", invalid="ignore"):
        return corr, corr / corr.sum(axis=1, keepdims=True)


def rank_paths(exp: str, cfg: dict, h_dir: str) -> dict:
    """``rank_paths``: the port's ranking CLI on the attribute stage's tree with
    the flags of ``cfg['script']``, its loop of ``cfg['rank_groups']`` in its
    order (GIFs for ``cfg['gif_group']``, ``--no-gif`` for the rest). Every
    ``attr_idx_<metric>.csv`` is held to :func:`plain_path_ranking` of the
    tree's ``eval_np`` arrays to the CSV's 3 decimals; each attribute's order
    in ``interpretable_paths.json`` must be the CSV column's, largest first,
    its ``_sorted_by_`` CSV the CSV's rows in that order, and the ``_diag``
    CSV the plain ranking's first rows to 2 decimals. Returns the wall times
    (s) and counts."""
    import csv

    import numpy as np

    from warpedganspace_torch.cli import rank_interpretable_paths as rank
    from warpedganspace_torch.ranking.engine import ATTRIBUTE_GROUPS, ATTRIBUTE_RANGES

    hashes_root = osp.dirname(h_dir)
    out_root = osp.join(hashes_root, "interpretable_paths")
    argv = ["--exp", exp, "--pool", cfg["pool"], f"--eps={cfg['eps']}",
            f"--shift-steps={cfg['steps']}"] + RANK_FLAGS
    seconds, n_csv, n_gif = {}, 0, 0
    for group in cfg["rank_groups"]:
        gifs = group == cfg["gif_group"]
        t0 = time.perf_counter()
        rank.main(argv + [f"--attr-group={group}"] + ([] if gifs else ["--no-gif"]))
        seconds[group] = time.perf_counter() - t0

        names = ATTRIBUTE_GROUPS[group]
        attrs = np.stack([np.stack([np.load(osp.join(h_dir, "eval_np", f"{a}.npy"))
                                    for a in names], axis=1)])    # (1 code, K, A, T)
        plain = dict(zip(("corr", "corr_l1"), plain_path_ranking(attrs, names,
                                                                 ATTRIBUTE_RANGES)))
        g_dir = osp.join(out_root, f"Group_{group}")
        with open(osp.join(g_dir, "interpretable_paths.json")) as f:
            orders = json.load(f)
        for metric, want in plain.items():
            with open(osp.join(g_dir, metric, f"attr_idx_{metric}.csv")) as f:
                rows = list(csv.reader(f))
            check(rows[0] == ["path_id"] + list(names), f"{group}/{metric}: header {rows[0]}")
            got = np.array([[float(v) if v else np.nan for v in r[1:]] for r in rows[1:]])
            check(got.shape == want.shape
                  and np.array_equal(np.isnan(got), np.isnan(want))
                  and bool(np.all(np.abs(got - want)[~np.isnan(want)] <= 5e-4 + 1e-9)),
                  f"{group}/{metric}: the CSV against the plain ranking, max abs "
                  f"{float(np.nanmax(np.abs(got - want))) if got.shape == want.shape else 'n/a'}")
            n_csv += 1
            for a, name in enumerate(names):
                order = orders[metric][name]
                col = got[order, a]
                finite = col[~np.isnan(col)]
                check(sorted(order) == list(range(len(got)))
                      and bool(np.all(np.diff(finite) <= 0))
                      and bool(np.isnan(col[len(finite):]).all()),
                      f"{group}/{metric}/{name}: the JSON order does not follow the CSV")
                with open(osp.join(g_dir, metric,
                                   f"attr_idx_{metric}_sorted_by_{name}.csv")) as f:
                    by = list(csv.reader(f))
                check(by[0] == [""] + list(names)
                      and [int(r[0]) for r in by[1:]] == order
                      and [r[1:] for r in by[1:]] == [rows[1 + k][1:] for k in order],
                      f"{group}/{metric}: the CSV sorted by {name} is not the CSV in the "
                      "JSON's order")
                n_csv += 1
            with open(osp.join(g_dir, metric, f"attr_idx_{metric}_diag.csv")) as f:
                diag = list(csv.reader(f))
            firsts = want[[orders[metric][name][0] for name in names]]
            got_diag = np.array([[float(v) if v else np.nan for v in r[1:]] for r in diag[1:]])
            check(diag[0] == [""] + list(names)
                  and [r[0] for r in diag[1:]] == [str(a) for a in range(len(names))]
                  and np.array_equal(np.isnan(got_diag), np.isnan(firsts))
                  and bool(np.all(np.abs(got_diag - firsts)[~np.isnan(firsts)] <= 5e-3 + 1e-9)),
                  f"{group}/{metric}: the diagonal CSV against the plain ranking's first rows")
            n_csv += 1
        if gifs:
            n_gif = sum(f.endswith(".gif") for _, _, fs in os.walk(g_dir) for f in fs)
            top_k = min(3, attrs.shape[1])
            check(n_gif == top_k * len(names) * 2,
                  f"{group}: {n_gif} GIFs, not {top_k * len(names) * 2}")
            check(osp.isfile(osp.join(g_dir, f"top-{top_k}_interpretable_path_{group}.md")),
                  f"{group}: no top-k summary")
    return {"seconds": seconds, "csv": n_csv, "gifs": n_gif}


def phase_attribute_stage(card: str, cfg: dict = ATTR, profile_rows: int = 0,
                          warm_runs: int = 0) -> dict:
    """An evaluation chain of ``ATTR_PATHS``: ``traverse_latent_space`` writes
    the tree of ``cfg['script']`` (``2 steps + 1`` frames a path), six
    predictor files are fabricated into ``models/pretrained/`` (the detector's
    heads fitted to the tree's first path), and ``traverse_attribute_space``
    runs on the card: a cold run, a warm one with each stage timed (CUDA
    events; its wall time too), ``warm_runs`` more, and with ``profile_rows``
    one traced for the device's busy share and its kernel table. Then the
    port's CPU run of the
    first path, and the card held to it: each predictor's raw outputs on the
    CPU run's inputs, the path's ``eval_np`` rows, the first SFD box of every
    frame, the face-crop gathers (and one inside every border); the native NMS
    against the numpy NMS on the run's candidate sets; the CelebA input of the
    CPU run against the script's normalisation of the whole path, computed
    here. The host's ``_prep_path``, the upload and the anchor decode are
    timed apart from the CLI. Then :func:`rank_paths`. Returns the
    traversal's kernel launches (the attribute and ranking CLIs launch
    none)."""
    import shutil

    import numpy as np
    import torch

    from warpedganspace_torch.cli import traverse_attribute_space as cli
    from warpedganspace_torch.evalzoo import sfd
    from warpedganspace_torch.evalzoo.crop_resize import crop_resize, plan_crop_resize
    from warpedganspace_torch.evalzoo.fabricate import predictor_state_dicts, write_pretrained
    from PIL import Image

    from warpedganspace_torch.evalzoo.transforms import crop_rect, normalize_imagenet, resize_center
    from warpedganspace_torch.native import load_native, native_error
    from warpedganspace_torch.utils.io import load_pt, save_pt

    k, steps = cfg["k"], cfg["steps"]
    T = 2 * steps + 1
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    cwd = os.getcwd()
    marks = {"start": time.perf_counter()}
    with tempfile.TemporaryDirectory(prefix="wgs_smoke_attr_") as tmp:
        os.chdir(tmp)
        try:
            # 1. The tree, as the script's traversal writes it.
            exp, S = fabricated_experiment(cfg)
            launches, t_sample, t_traverse, err = traverse_and_verify(cfg, exp, S)
            config = f"{2 * steps}_{cfg['eps']}_{round(2 * steps * cfg['eps'], 3)}"
            rel = osp.join("results", cfg["pool"], config)
            h_name = [h for h in os.listdir(osp.join(exp, rel)) if h not in cli.NOT_HASHES][0]
            h_dir = osp.join(exp, rel, h_name)

            # 2. The predictor files, the detector's heads fitted to path 0.
            t0 = marks["tree"] = time.perf_counter()
            calib = cli._prep_path(osp.join(h_dir, "paths_images", "path_000"), cfg["gan"])[0]
            files = write_pretrained(".", predictor_state_dicts(seed=0, calibration=calib,
                                                                 device="cuda"))
            t_fab = time.perf_counter() - t0
            marks["files"] = time.perf_counter()
            mb = sum(osp.getsize(p) for p in files.values()) / 2 ** 20

            # 3. The CLI on the card. No kernel of the port runs in it.
            lib = load_native()
            check(lib is not None, f"the native NMS did not build on the card's host: "
                                   f"{native_error()}")
            reset_launch_counts()
            t_cold = run_attribute_cli(exp, cfg)
            clock = StageClock()
            t_warm = [run_attribute_cli(exp, cfg, device_wrap=clock.device,
                                        host_wrap=clock.host)]
            stage_ms = clock.ms()
            t_warm += [run_attribute_cli(exp, cfg) for _ in range(warm_runs)]
            card_np, card_json = read_eval_tree(h_dir)
            marks["card runs"] = time.perf_counter()
            traced = None
            if profile_rows:
                traced = trace_device(lambda: run_attribute_cli(exp, cfg), rows=profile_rows)
                marks["traced run"] = time.perf_counter()
            check(launch_counts() == dict.fromkeys(launch_counts(), 0),
                  f"the attribute CLI launched {launch_counts()}")
            ranked = rank_paths(exp, cfg, h_dir)
            marks["ranking"] = time.perf_counter()
            check(launch_counts() == dict.fromkeys(launch_counts(), 0),
                  f"the ranking stage launched {launch_counts()}")
            # ``sfd.nms`` takes the library whenever ``load_native`` returns one.
            check(sfd.load_native() is lib, "the native NMS was not loaded through the card runs")
            check(len(card_np) == 26 and len(card_json) == 12,
                  f"{len(card_np)} eval_np and {len(card_json)} eval_json files, not 26 and 12")
            for name, arr in card_np.items():
                check(arr.shape == (k, T) and bool(np.isfinite(arr).all()),
                      f"eval_np/{name}: shape {arr.shape}, finite {np.isfinite(arr).all()}")

            # 4. The port's CPU run of path 0, on its own copy of the tree.
            cpu_exp = "exp_cpu"
            os.makedirs(osp.join(cpu_exp, rel, h_name))
            shutil.copy(osp.join(exp, "args.json"), cpu_exp)
            h_cpu = osp.join(cpu_exp, rel, h_name)
            save_pt(load_pt(osp.join(h_dir, "paths_latent_codes.pt"))[:1],
                    osp.join(h_cpu, "paths_latent_codes.pt"))
            shutil.copytree(osp.join(h_dir, "paths_images", "path_000"),
                            osp.join(h_cpu, "paths_images", "path_000"))
            rec = Recorder()
            t_cpu = run_attribute_cli(cpu_exp, cfg, cuda=False, device_wrap=rec, host_wrap=rec)
            cpu_np, cpu_json = read_eval_tree(h_cpu)
            marks["CPU run"] = time.perf_counter()

            # 4a. Each predictor's raw outputs on the CPU run's inputs.
            preds = cli.load_predictors(torch.device("cuda"))

            def cuda(args):
                return [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]

            def flat(out):
                if isinstance(out, dict):
                    return [(f".{key}", v) for key, v in out.items()]
                if isinstance(out, (list, tuple)):
                    return [(f"[{i}]", v) for i, v in enumerate(out)]
                return [("", out)]

            calls = {"sfd": preds["sfd"].forward_maps, "arcface": preds["id"].similarities,
                     "fairface": preds["fairface"], "hopenet": preds["hopenet"],
                     "fanau": preds["au"].detect_AU, "celeba": preds["celeba"]}
            nets = {"sfd": [preds["sfd"].net], "arcface": [preds["id"].net],
                    "fairface": [preds["fairface"]], "hopenet": [preds["hopenet"]],
                    "fanau": [preds["au"].net], "celeba": [preds["celeba"]]}
            raw, gflop, class_diff, card_maps = {}, {}, {}, None
            with torch.no_grad():
                for name, fn in calls.items():
                    args, want = rec.calls[name]
                    out = []
                    gflop[name] = forward_flops(nets[name],
                                                lambda: out.append(fn(*cuda(args)))) / 1e9
                    for (tag, g), (_, w) in zip(flat(out[0]), flat(want)):
                        ok, worst = raw_close(g.cpu().numpy(), w.numpy())
                        check(ok, f"{name}{tag}: card against CPU {worst:.3g} of max|out|")
                        raw[f"{name}{tag}"] = worst
                        if name == "sfd" and tag in ("[0]", "[2]", "[4]", "[6]", "[8]", "[10]"):
                            class_diff[4 * 2 ** (int(tag[1:-1]) // 2)] = float(
                                (g.cpu() - w).abs().max())
                    if name == "sfd":
                        card_maps = [m.cpu().numpy() for m in out[0]]

            # 4b. The path's eval_np rows at the oracle's gates, the same
            # argmaxes, and the same first SFD box in every frame.
            argmax_n = {"age": 9, "race": 7, "celeba_bangs": 6, "celeba_eyeglasses": 6,
                        "celeba_beard": 6, "celeba_smiling": 6, "celeba_age": 6}
            check(sorted(cpu_np) == sorted(card_np), "CPU and card eval_np file sets differ")
            rows = {}
            for name, want in cpu_np.items():
                got = card_np[name][:1]
                check(np.allclose(got, want, rtol=1e-2, atol=2e-3),
                      f"eval_np/{name} row 0: card against CPU max abs "
                      f"{float(np.abs(got - want).max()):.3g}")
                if name in argmax_n:
                    check(np.array_equal(np.floor(got * argmax_n[name]),
                                         np.floor(want * argmax_n[name])),
                          f"eval_np/{name} row 0: another argmax on the card")
                rows[name] = float(np.abs(got - want).max())
            faceless = card_np["face_width"][0] == 256.0
            check(np.array_equal(faceless, cpu_np["face_width"][0] == 256.0),
                  "the frames without a face differ between card and CPU")
            boxes, cpu_boxes = card_json["face_bbox"]["0"], cpu_json["face_bbox"]["0"]
            check(len(boxes) == len(cpu_boxes) == T - int(faceless.sum())
                  and np.allclose(boxes, cpu_boxes, rtol=0, atol=1e-2),
                  "the first SFD boxes of path 0 differ between card and CPU")

            # 4c. The lead of each frame's first box, and the native NMS
            # against the numpy NMS on the run's own candidate sets.
            def logit(p):
                return float(np.log(p / (1 - p)))

            # The first box of a frame flips only if the card moves its score
            # and the next candidate's by more than their lead: each frame's
            # lead is held against that, where the card's candidate set is
            # the CPU's (else against the largest class-map difference).
            cands = rec.calls["sfd_nms"][0][0]
            card_cands = sfd.decode_batch(card_maps)
            same_sets = card_cands.shape == cands.shape
            lead, margin, lead_kept, n_cands = [], [], [], []
            for j, dets in enumerate(cands):
                order = np.argsort(-dets[:, 4], kind="stable")
                # The decoder repeats a position once per frame that passes
                # the threshold there: the next candidate is another position.
                nxt = next((i for i in order[1:] if not np.array_equal(dets[i], dets[order[0]])),
                           None)
                if nxt is not None:
                    pair = [order[0], nxt]
                    lead.append(float(dets[order[0], 4] - dets[nxt, 4]))
                    moved = (float(np.abs(card_cands[j, pair, 4] - dets[pair, 4]).sum())
                             if same_sets else max(class_diff.values()))
                    margin.append(lead[-1] / max(moved, 1e-12))
                keep_native = sfd.nms_native(lib, dets, 0.3)
                keep_numpy = sfd.nms_numpy(dets, 0.3)
                check(len(keep_native) == len(keep_numpy) and np.array_equal(
                    dets[keep_native], dets[keep_numpy]),
                    "the native NMS kept other boxes than the numpy NMS")
                if len(keep_numpy) > 1:
                    lead_kept.append(logit(dets[keep_numpy[0], 4]) - logit(dets[keep_numpy[1], 4]))
                n_cands.append(len(dets))
            firsts = [tuple(round(v) for v in b[:2]) for b in cpu_boxes]

            # 4d. The face-crop gathers of path 0 on the card against the
            # CPU's, at the CPU run's first boxes with each crop's padding,
            # and at one rectangle inside every border.
            f_cpu = rec.calls["sfd"][0][0]
            f_card = f_cpu.cuda()
            faced = [t for t in range(T) if not faceless[t]] + [T // 2]
            gather_err, n_inner = 0.0, 0
            for size, padding in ((224, 0.25), (224, 0.0), (256, 0.0)):
                rects = [crop_rect(b[:4], 256, 256, padding) for b in cpu_boxes] + [INNER_RECT]
                n_inner += sum(0 < r[0] and r[1] < 256 and 0 < r[2] and r[3] < 256
                               for r in rects[:-1])
                plan = plan_crop_resize(rects, size)
                want = crop_resize(f_cpu[faced], plan)
                gather_err = max(gather_err, float(
                    (crop_resize(f_card[faced], plan).cpu() - want).abs().max()))
            check(gather_err <= 1e-3, f"the crop gathers differ card against CPU by {gather_err:.3g}")

            # 4e. The host stages and the upload, timed apart from the CLI:
            # _prep_path of path 0 (the JPEG decode and the two full-frame
            # resizes the CLI's pool runs), the upload of path 0's two host
            # batches (CUDA events, best of 3), the anchor decode of path 0's
            # card maps.
            t0 = time.perf_counter()
            host = cli._prep_path(osp.join(h_dir, "paths_images", "path_000"), cfg["gan"])
            t_prep = time.perf_counter() - t0
            copies = []
            for _ in range(3):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for x in host:
                    x.cuda()
                end.record()
                copies.append((start, end))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sfd.decode_batch(card_maps)
            apart = {"prep": 1e3 * t_prep, "decode": 1e3 * (time.perf_counter() - t0),
                     "upload": min(s.elapsed_time(e) for s, e in copies)}
            # 4f. The CPU run's CelebA input against the script's normalisation
            # of the whole path, computed here from the path's JPEGs: StyleGAN2
            # frames taken as [-1, 1]-scaled, the others min-max normalised over
            # all T frames (JAX traverse_attribute_space.py:98-104), not over a
            # render batch or another part of the path.
            p0 = osp.join(h_dir, "paths_images", "path_000")
            path0 = torch.from_numpy(np.stack([
                np.asarray(Image.open(osp.join(p0, f"{t:06d}.jpg")).convert("RGB"), np.float32)
                for t in range(T)])).permute(0, 3, 1, 2)
            if cfg["gan"] == "StyleGAN2":
                norm = path0 / 255.0 * 2.0 - 1.0
            else:
                norm = (path0 - path0.min()) / (path0.max() - path0.min())
            celeba_err = float((rec.calls["celeba"][0][0]
                                - normalize_imagenet(resize_center(norm, 224))).abs().max())
            check(celeba_err <= 1e-6, f"the CelebA input of path 0 is {celeba_err:.3g} from the "
                                      "script's normalisation of the whole path")
            whole = (float(path0.min()), float(path0.max()))
            n_ranges = sum((float(path0[i:i + cfg["batch"]].min()),
                            float(path0[i:i + cfg["batch"]].max())) != whole
                           for i in range(0, T, cfg["batch"]))
            marks["comparisons"] = time.perf_counter()
            check(min(margin) > 100,
                  f"a first box leads by only {min(margin):.3g}x what the card moved its and the "
                  f"next candidate's scores (leads from {min(lead):.3g}; the class maps differ by "
                  f"{class_diff}; candidate sets {'equal' if same_sets else 'unequal'})")
        finally:
            os.chdir(cwd)

    marks["clean-up"] = time.perf_counter()
    frames = k * T
    per = {name: ms / k for name, ms in stage_ms.items()}
    per.update(apart)
    device_ms = sum(per[n] for n in ("upload", "sfd", "arcface", "fairface", "hopenet",
                                     "fanau", "celeba"))
    per_frame = sum(gflop.values()) / T
    tag = f"[attribute {cfg['gan']}, {cfg['script']}]"
    print(f"{tag} tree: sample_gan {t_sample:.2f} s, traverse_latent_space K={k} "
          f"steps={steps} eps={cfg['eps']} bf16 batch {cfg['batch']}: {frames} frames of "
          f"{cfg['res']}² in {t_traverse:.2f} s; launches {launches}; codes vs plain warp "
          f"max abs {err:.3g}; {len(files)} predictor files ({mb:.0f} MiB) fabricated in "
          f"{t_fab:.2f} s on {card}")
    traced_text = ("" if traced is None else
                   f", {traced['ms'] / 1e3:.2f} s traced on the device with it busy "
                   f"{100 * traced['busy']:.1f} % of that ({traced['kernel_ms']:.1f} ms in "
                   f"{traced['launches']} kernels and copies)")
    print(f"{tag} traverse_attribute_space on the card: {frames} frames ({k} paths of "
          f"{T}) in {t_cold:.2f} s cold, "
          + ", ".join(f"{t:.2f} s" for t in t_warm)
          + f" warm, the first with its stages timed ({frames / min(t_warm):.1f} frames/s)"
          f"{traced_text} on {card}; the phase's seconds: "
          + ", ".join(f"{name} {t - prev:.1f}" for (name, t), prev
                      in zip(list(marks.items())[1:], list(marks.values())[:-1])))
    print(f"{tag} per path of {T} frames on {card}: host _prep_path {per['prep']:.1f} ms "
          f"(path 0, timed apart, one thread; JPEG decode and the two full-frame resizes), upload "
          f"{per['upload']:.2f} ms (timed apart), SFD forward {per['sfd']:.2f} ms, host decode + "
          f"NMS {per['decode'] + per['sfd_nms']:.1f} ms ({per['decode']:.1f} timed apart + "
          f"{per['sfd_nms']:.1f}), ArcFace {per['arcface']:.2f} ms, FairFace "
          f"{per['fairface']:.2f} ms, Hopenet {per['hopenet']:.2f} ms, FAN-AU "
          f"{per['fanau']:.2f} ms, CelebA {per['celeba']:.2f} ms (CUDA events); device stages "
          f"{device_ms:.1f} ms; the CLI {1e3 * min(t_warm) / k:.0f} ms a path on the host's "
          f"clock")
    print(f"{tag} FLOPs a frame, counted from the shapes: "
          + ", ".join(f"{n} {g / T:.1f} G" for n, g in gflop.items())
          + f"; {per_frame:.1f} GFLOP a frame, {sum(gflop.values()) / 1e3:.2f} TFLOP a path; "
          + ", ".join(f"{n} {g / per[n]:.1f} TFLOP/s" for n, g in gflop.items())
          + f" (f32, TF32 off) on {card}")
    print(f"{tag} card against the port's CPU run of path 0 ({t_cpu:.1f} s on the CPU): "
          f"raw outputs within 1e-3 rel + 1e-4 of max|out| (worst "
          + ", ".join(f"{n} {v:.2e}" for n, v in raw.items())
          + f"); eval_np rows within rtol 1e-2 / atol 2e-3, argmaxes equal (worst "
          + ", ".join(f"{n} {v:.2e}" for n, v in sorted(rows.items()) if v > 0)
          + f"); the same first SFD box in all {T} frames ({int(faceless.sum())} without a "
          f"face); the crop gathers of its {len(faced) - 1} first boxes (with each crop's "
          f"padding; {n_inner} of the {3 * (len(faced) - 1)} rectangles inside every border) "
          f"and of the rectangle {INNER_RECT} within {gather_err:.2g} of the CPU's; the CelebA "
          f"input within {celeba_err:.2g} of the {cfg['gan']} normalisation of all {T} frames "
          f"(their range {whole}; {n_ranges} of the {math.ceil(T / cfg['batch'])} render "
          f"batches of {cfg['batch']} span another)")
    print(f"{tag} NMS: native ({osp.basename(lib._name)}, g++) loaded before and after "
          f"the card runs, so every card run's NMS was native; on path 0's "
          f"{len(cands)} candidate sets ({min(n_cands)}-{max(n_cands)} boxes) native keeps "
          f"equal numpy's; each first box leads the next candidate by {min(lead):.3g} in score "
          f"at least, {min(margin):.3g}x at least what the card moved the two scores "
          f"(candidate sets {'equal' if same_sets else 'unequal'} card against CPU; the class "
          f"maps differ by " + ", ".join(f"{v:.2g} at stride {k}" for k, v in class_diff.items())
          + f"), and the next kept box by {min(lead_kept) if lead_kept else float('inf'):.3g} "
          f"logits at least; {len(set(firsts))} distinct first-box corners in path 0 "
          f"({firsts[0]} in frame 0)")
    print(f"[rank_paths {cfg['gan']}] rank_interpretable_paths on that tree ({k} paths of {T} "
          f"points, one code), {cfg['script']}'s {len(cfg['rank_groups'])} groups: "
          f"{sum(ranked['seconds'].values()):.2f} s wall on the host of {card} ("
          + ", ".join(f"{g} {t:.2f} s" for g, t in ranked["seconds"].items())
          + f"; {ranked['gifs']} GIFs of {cfg['gif_group'] or 'no group'}); {ranked['csv']} "
          "attr_idx CSVs "
          "held to the plain np.cov ranking, every JSON order and sorted CSV the CSV's")
    if traced is not None:
        print(traced["table"])
    return launches


def train_argv(cfg: dict, max_iter: int) -> list:
    """The experiment of scripts/train/biggan.sh, cut to ``max_iter`` iterations."""
    return ["--gan-type", cfg["gan"], "--biggan-target-classes", "239",
            "--reconstructor-type", "ResNet", "-K", str(cfg["k"]), "-D", str(cfg["dipoles"]),
            "--learn-gammas", "--min-shift-magnitude", "0.1", "--max-shift-magnitude", "0.2",
            "--batch-size", str(cfg["batch"]), "--g-dtype", "bfloat16", "--r-dtype", "bfloat16",
            "--log-freq", str(cfg["log_freq"]), "--ckp-freq", str(cfg["ckp_freq"]),
            "--max-iter", str(max_iter)]


def phase_train(card: str, cfg: dict) -> dict:
    """The training path: ``train`` for ``cfg['iters']`` iterations, the same
    command again with a larger ``--max-iter`` (a resume at the stored
    iteration), then ``sample_gan`` and ``traverse_latent_space`` on the tree
    that run wrote. Returns each kernel's launches on that path."""
    import contextlib
    import io

    import torch

    from warpedganspace_torch.cli import sample_gan, train, traverse_latent_space
    from warpedganspace_torch.models import gan_load
    from warpedganspace_torch.models.support_sets import SupportSets

    k, d, steps = cfg["k"], cfg["d"], cfg["steps"]
    exp_name = f"BigGAN-239-ResNet-K{k}-D{cfg['dipoles']}-LearnGammas-eps0.1_0.2"
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"

    def build_open(**kw):
        # Random weights leave the attention's gamma at 0, where its backward
        # gets a zero cotangent and any backward kernel would train the same.
        return open_attention(gan_load.build_gan(**kw))

    cwd = os.getcwd()
    patched = (train, traverse_latent_space, sample_gan)
    with tempfile.TemporaryDirectory(prefix="wgs_smoke_train_") as tmp:
        os.chdir(tmp)
        for mod in patched:
            mod.build_gan = build_open
        try:
            reset_launch_counts()                     # count only this path's launches
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):     # the progress block redraws itself
                first = train.main(train_argv(cfg, cfg["iters"]))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                second = train.main(train_argv(cfg, cfg["resume_to"]))
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(f"Start training from iteration {cfg['iters']}" in log.getvalue(),
                  "the second run did not resume at the stored iteration")
            check("Adam moments reset" not in log.getvalue(),
                  "the resumed run could not read its own optimizer sidecar")
            # The resumed run repeats the stored iteration, as the reference does.
            n_iters = cfg["iters"] + (cfg["resume_to"] - cfg["iters"] + 1)
            train_launches = launch_counts()
            check(train_launches["sa_attention"] == 2 * n_iters
                  and train_launches["sa_attention_bwd"] == n_iters,
                  f"{n_iters} training iterations must launch the attention forward "
                  f"{2 * n_iters} times and its backward {n_iters} times, got {train_launches}")
            check(train_launches["rbf_warp"] == 0 and train_launches["proggan_tail"] == 0
                  and train_launches["sg2_tail"] == 0,
                  f"training launches neither the warp kernel nor a tail: {train_launches}")

            wip = osp.join("experiments", "wip", exp_name)
            exp = osp.join("experiments", "complete", exp_name)
            stats, init, moved = check_trained_tree(cfg, wip, exp)

            # Step time after warm-up: the first run's log windows but its first
            # (kernel build, cuDNN's first calls), on the host's clock around
            # windows that each end in a device-to-host copy; and the same
            # without the windows in which a checkpoint was written.
            windows = first.window_times[1:]
            step_s = sum(w[1] for w in windows) / sum(w[0] for w in windows)
            clean = [w for w in windows if not w[2]]
            clean_s = sum(w[1] for w in clean) / sum(w[0] for w in clean)

            # The traversal of the completed tree, held to what every served
            # path is held to, its codes against the plain warp on that tree's
            # sets: those of the first run's end, since a later run finds the
            # completed tree in place and leaves it, as the reference does.
            done = torch.load(osp.join(exp, "models", "support_sets.pt"))
            check(float((done["SUPPORT_SETS"] - init["SUPPORT_SETS"]).abs().max()) > 0,
                  "the completed tree's support sets are the initial ones")
            S = SupportSets(k, cfg["dipoles"], d, learn_gammas=True).from_torch_state_dict(done)
            trav_launches, _, t_traverse, err = traverse_and_verify(
                dict(cfg, batch=cfg["render_batch"], gif=False), exp, S)
        finally:
            for mod in patched:
                mod.build_gan = gan_load.build_gan
            os.chdir(cwd)
    last = stats[str(cfg["resume_to"])]
    print(f"[train] {cfg['gan']}-128 class 239, K={k} D={cfg['dipoles']} learn-gammas, batch "
          f"{cfg['batch']}, bf16 G and R, attention open, on {card}: {cfg['iters']} iterations in "
          f"{t1 - t0:.2f} s (generator build and first calls included), resumed at "
          f"{cfg['iters']} and ran to {cfg['resume_to']} in {t2 - t1:.2f} s; launches "
          f"{train_launches} over {n_iters} iterations; last window: total loss "
          f"{last['total_loss']:.4f}, accuracy {last['accuracy']:.3f}; moved {moved}; then "
          f"traverse_latent_space of the trained tree: {k * (2 * steps + 1)} frames in "
          f"{t_traverse:.2f} s, launches {trav_launches}, codes vs plain warp max abs {err:.3g}")
    print(f"[train] mean step time after warm-up {1e3 * clean_s:.2f} ms over "
          f"{sum(w[0] for w in clean)} iterations = {1 / clean_s:.2f} steps/s = "
          f"{cfg['batch'] / clean_s:.1f} images/s on {card} (log windows without a checkpoint; "
          f"{1e3 * step_s:.2f} ms over all {sum(w[0] for w in windows)} iterations after the "
          f"first window, one checkpoint of S, R and both Adams included)")
    return {name: train_launches[name] + trav_launches[name] for name in train_launches}


def md_argv(cfg: dict, bf16: bool) -> list:
    """The experiment of scripts/train/biggan.sh, cut in iterations; f32 for
    part (a), the script's bf16 G and R with graphed chunks for part (b). A
    ``cfg`` with ``argv`` (one of ``TRAIN_PATHS``' experiments, for the check
    of ``--profile dp``) gives part (b) of that experiment."""
    if bf16:
        cadence = ["--log-freq", str(cfg["graph_log_freq"]), "--ckp-freq",
                   str(cfg["graph_ckp_freq"]), "--max-iter", str(cfg["graph_iters"])]
        base = cfg["argv"] + cadence if "argv" in cfg else train_argv(
            dict(cfg, log_freq=cfg["graph_log_freq"], ckp_freq=cfg["graph_ckp_freq"]),
            cfg["graph_iters"])
        return base + ["--steps-per-call", str(cfg["chunk"])]
    return [a for a in train_argv(cfg, cfg["iters"])
            if a not in ("--g-dtype", "--r-dtype", "bfloat16")]


def md_pipeline(cfg: dict, multi: bool, stages=("sample", "train", "traverse"),
                native_conv: bool = False, snapshot: bool = False) -> dict:
    """The ``stages`` of part (a) from the current directory (``sample_gan``,
    ``train``, ``traverse_latent_space``), the attention opened, every launch
    count set to 0 before and read after. ``native_conv``: train with
    PyTorch's native convolutions instead of cuDNN's. Returns the launches,
    the seconds of each stage, the train state, the gradients the first step
    handed to Adam (S's, R's; on the host) and with ``snapshot`` what that
    step started from (copies of S and R, and its batch)."""
    import contextlib
    import importlib
    import io

    import torch

    from warpedganspace_torch.cli import sample_gan, train, traverse_latent_space
    from warpedganspace_torch.models import gan_load
    from warpedganspace_torch.train import trainer as trainer_module

    step_module = importlib.import_module("warpedganspace_torch.train.train_step")
    real_step, real_train = trainer_module.train_step, trainer_module.Trainer.train
    flag = ["--multi-device"] if multi else []
    out = {"seconds": {}}

    def keep_state(self, *args, **kwargs):
        out["state"] = real_train(self, *args, **kwargs)
        return out["state"]

    def first_grads(state, iteration, *args, **kwargs):
        if snapshot and "first" not in out:
            out["first"] = (copy.deepcopy(state.S), copy.deepcopy(state.R),
                            step_module.sample_batch(state, iteration))
        metrics = real_step(state, iteration, *args, **kwargs)
        if "grads" not in out:
            out["grads"] = {name: [p.grad.detach().cpu() for group in opt.param_groups
                                   for p in group["params"]]
                            for name, opt in (("S", state.opt_s), ("R", state.opt_r))}
        return metrics

    runs = {"sample": lambda: sample_gan.main(
                ["-g", "BigGAN", "--biggan-target-classes", "239", "--num-samples",
                 str(cfg["codes"]), "--pool", cfg["pool"]]),
            "train": lambda: train.main(md_argv(cfg, bf16=False) + flag),
            "traverse": lambda: traverse_latent_space.main(
                ["--exp", osp.join("experiments", "complete", md_exp_name(cfg)), "--pool",
                 cfg["pool"], "--shift-steps", str(cfg["steps"]), "--eps", str(cfg["eps"]),
                 "--batch-size", str(cfg["render_batch"]), "--dtype", "bfloat16"] + flag)}
    patched = (sample_gan, train, traverse_latent_space)
    for mod in patched:
        mod.build_gan = lambda **kw: open_attention(gan_load.build_gan(**kw))
    trainer_module.Trainer.train = keep_state
    trainer_module.train_step = first_grads
    try:
        reset_launch_counts()
        for stage in stages:
            t0 = time.perf_counter()
            torch.backends.cudnn.enabled = not (native_conv and stage == "train")
            with contextlib.redirect_stdout(io.StringIO()):
                runs[stage]()
            out["seconds"][stage] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.enabled = True
        for mod in patched:
            mod.build_gan = gan_load.build_gan
        trainer_module.Trainer.train = real_train
        trainer_module.train_step = real_step
    out["launches"] = launch_counts()
    return out


def md_step_timing(state, n: int = 3) -> tuple:
    """ms per eager step of ``state`` over ``n`` steps after one untimed, and
    the share of that time inside ``all_reduce`` (None without a group). Each
    all-reduce is timed between synchronises on the host's clock: gloo copies
    through the host, so that is its cost."""
    import torch
    import torch.distributed as dist

    from warpedganspace_torch.parallel import mesh
    from warpedganspace_torch.train.train_step import train_step

    real = dist.all_reduce
    spent = [0.0]

    def timed(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    train_step(state, 10 ** 6)
    torch.cuda.synchronize()
    dist.all_reduce = timed
    try:
        t0 = time.perf_counter()
        for it in range(n):
            train_step(state, 10 ** 6 + 1 + it)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        dist.all_reduce = real
    return 1e3 * total / n, (spent[0] / total if mesh.active() else None)


def md_exp_name(cfg: dict) -> str:
    if "argv" in cfg:
        return argv_exp_name(cfg["argv"])
    return f"BigGAN-239-ResNet-K{cfg['k']}-D{cfg['dipoles']}-LearnGammas-eps0.1_0.2"


def argv_exp_name(argv: list) -> str:
    """The experiment directory ``cli.train`` names for ``argv``."""
    from warpedganspace_torch.cli import train
    from warpedganspace_torch.utils.aux import experiment_name

    return experiment_name(vars(train.build_parser().parse_args(argv)))


def md_first_step(G, first, cfg, dtype, native_conv: bool = False) -> tuple:
    """The first step's S and R gradients from ``first`` (copies of S and R
    and the batch, as :func:`md_pipeline` keeps them) with G, S and R in
    ``dtype``: the loss of ``train_step.loss_fn`` written out for any float
    type. In float64 every cast to float32 of the port's modules is held at
    float64 and the attention is its plain formula (the kernels take f32 and
    bf16). Returns the gradients (S's, R's, float64 on the device, in the
    optimisers' order) and each of R's BatchNorm inputs and its logits."""
    import torch
    import torch.nn.functional as F

    from warpedganspace_torch.models import biggan
    from warpedganspace_torch.models.reconstructor import BatchNorm

    S, R, (z, idx, mags) = (copy.deepcopy(first[0]).to(dtype), copy.deepcopy(first[1]).to(dtype),
                            first[2])
    G = G if dtype == torch.float32 else copy.deepcopy(G).to(dtype)
    z, mags = z.to(dtype), mags.to(dtype)
    seen = {}
    hooks = [m.register_forward_hook(
                 lambda mod, inp, out, name=name: seen.__setitem__(name, inp[0].detach()))
             for name, m in R.named_modules() if isinstance(m, BatchNorm)]
    real_float, real_attn = torch.Tensor.float, biggan.sa_attention
    if dtype == torch.float64:
        torch.Tensor.float = lambda self, *a, **kw: (self if self.dtype == torch.float64
                                                     else real_float(self, *a, **kw))
        biggan.sa_attention = lambda t, p, g: torch.softmax(t @ p.transpose(1, 2), -1) @ g
    torch.backends.cudnn.enabled = not native_conv
    try:
        with torch.no_grad():
            img = G(z)
        img_shifted = G(z, mags[:, None] * S.direction(z, idx))
        logits, mag_hat = R(img, img_shifted)
        total = (cfg.lambda_cls * F.cross_entropy(logits, idx)
                 + cfg.lambda_reg * torch.mean(torch.abs(mag_hat - mags)))
        total.backward()
    finally:
        torch.Tensor.float, biggan.sa_attention = real_float, real_attn
        torch.backends.cudnn.enabled = True
        for h in hooks:
            h.remove()
    seen["logits"] = logits.detach()
    grads = {name: [p.grad.double() for p in m.parameters() if p.requires_grad]
             for name, m in (("S", S), ("R", R))}
    seen["names"] = [n for m in (S, R) for n, p in m.named_parameters() if p.requires_grad]
    return grads, seen


def multi_device_worker(part: str, workdir: str, cfg_json: str) -> int:
    """A process of the ``multi_device`` phase (``python3 -c``, started by
    :func:`phase_multi_device`). Part ``a``: a rank of the gloo group the
    parent's environment describes, running :func:`md_pipeline`, then timing
    its steps; rank 0 saves the first step's gradients. Part ``b``:
    the graphed run without a group, then the same run as the one rank of an
    NCCL group, both with the deterministic algorithms; the two trees must be
    the same bits. ``cfg_json`` is the phase's configuration (``MD``, or a
    1024^2 experiment's from ``dp_check``). Prints
    its report as ``MD_REPORT {json}``."""
    import torch
    import torch.distributed as dist

    from warpedganspace_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    os.chdir(workdir)
    cfg = json.loads(cfg_json)
    report = {}
    if part == "a":
        mesh.initialize_distributed(backend="gloo")
        run = md_pipeline(cfg, True)
        step_ms, share = md_step_timing(run["state"])
        report.update(launches=run["launches"], seconds=run["seconds"], rank=mesh.rank(),
                      world=mesh.world_size(), step_ms=step_ms, all_reduce_share=share)
        if mesh.rank() == 0:
            torch.save(run["grads"], osp.join(workdir, "first_step_grads.pt"))
        dist.destroy_process_group()
    else:
        import contextlib
        import io

        from warpedganspace_torch.cli import train
        from warpedganspace_torch.models import gan_load
        from warpedganspace_torch.train.train_step import train_step
        from warpedganspace_torch.train.trainer import Trainer

        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        if cfg["gan"] == "BigGAN":
            train.build_gan = lambda **kw: open_attention(gan_load.build_gan(**kw))
        states, trees = [], {}
        real_train = Trainer.train

        def keep_state(self, *args, **kwargs):
            states.append(real_train(self, *args, **kwargs))
            return states[-1]

        Trainer.train = keep_state
        calls = []
        real_all_reduce = dist.all_reduce

        def counting(tensor, *args, **kwargs):
            calls.append(tuple(tensor.shape))
            return real_all_reduce(tensor, *args, **kwargs)

        for run in ("plain", "dp"):
            os.makedirs(run)
            os.chdir(run)
            if run == "dp":
                mesh.initialize_distributed(init_method=f"tcp://127.0.0.1:{md_free_port()}",
                                            world_size=1, rank=0)
                report["backend"] = dist.get_backend()
                dist.all_reduce = counting
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train.main(md_argv(cfg, bf16=True) + (["--multi-device"]
                                                                if run == "dp" else []))
            torch.cuda.synchronize()
            dist.all_reduce = real_all_reduce
            # ms per step over the log windows of replays (after the eager
            # warm-up's and the capture's), without a checkpoint.
            windows = [w for w in trainer.window_times[2:] if not w[2]]
            report[run] = {"s": time.perf_counter() - t0, "launches": launch_counts(),
                           "step_ms": 1e3 * sum(w[1] for w in windows)
                           / sum(w[0] for w in windows)}
            reset_launch_counts()
            wip = osp.join("experiments", "wip", md_exp_name(cfg))
            with open(osp.join(wip, "stats.json")) as f:
                stats = json.load(f)
            trees[run] = (stats, torch.load(osp.join(wip, "models", "support_sets.pt")),
                          torch.load(osp.join(wip, "models", "reconstructor.pt")))
            os.chdir(workdir)
        Trainer.train = real_train
        report["all_reduce_calls"] = len(calls)
        report["stats"] = trees["dp"][0]
        report["stats_equal"] = trees["dp"][0] == trees["plain"][0]
        report["tensors_equal"] = all(
            torch.equal(a[key], b[key]) for a, b in zip(trees["dp"][1:], trees["plain"][1:])
            for key in a)
        report["max_stat_diff"] = max(
            abs(trees["dp"][0][it][k] - v) for it, row in trees["plain"][0].items()
            for k, v in row.items())
        state = states[-1]
        traced = trace_calls(lambda: train_step(state, 10 ** 6), 3, tag="nccl")
        report["traced"] = {k: traced[k] for k in ("ms", "busy", "kernel_ms", "tag_share",
                                                    "tag_ms", "tag_launches")}
        dist.destroy_process_group()
    print("MD_REPORT " + json.dumps(report))
    return 0


def md_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def md_spawn(part: str, workdir: str, world: int, cfg: dict) -> list:
    """Start ``world`` worker processes of part ``part`` (a group of that size
    from torchrun's environment for part ``a``; none for ``b``), wait for each
    with a timeout, and return their reports. Fails with a worker's output
    when it did not exit 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    root = osp.dirname(osp.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    port = md_free_port()
    code = "import sys, chip_smoke; sys.exit(chip_smoke.multi_device_worker(*sys.argv[1:]))"
    procs = []
    for r in range(world):
        e = dict(env)
        if part == "a":
            e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", code, part, workdir,
                                       json.dumps(cfg)], cwd=root,
                                      env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MD_REPORT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"multi_device part ({part}) worker {r} exited {p.returncode}:\n{out[-6000:]}")
        reports.append(json.loads(lines[0][len("MD_REPORT "):]))
    return reports


def md_tree(root: str, cfg: dict) -> dict:
    """What part (a) compares of the tree under ``root``: stats.json, the
    traversal's codes by hash and frames by (hash, path, frame) where it was
    traversed, and the relative file set."""
    import numpy as np
    import torch
    from PIL import Image

    exp = osp.join(root, "experiments", "complete", md_exp_name(cfg))
    tree = {"stats": None, "codes": {}, "frames": {}}
    if osp.isfile(osp.join(exp, "stats.json")):
        with open(osp.join(exp, "stats.json")) as f:
            tree["stats"] = json.load(f)
    steps = cfg["steps"]
    res = osp.join(exp, "results", cfg["pool"],
                   f"{2 * steps}_{cfg['eps']}_{round(2 * steps * cfg['eps'], 3)}")
    for h in sorted(os.listdir(res)) if osp.isdir(res) else ():
        tree["codes"][h] = torch.load(osp.join(res, h, "paths_latent_codes.pt")).numpy()
        for p in range(cfg["k"]):
            d = osp.join(res, h, "paths_images", f"path_{p:03d}")
            for f in sorted(os.listdir(d)):
                tree["frames"][h, p, f] = np.asarray(Image.open(osp.join(d, f)),
                                                     dtype=np.int16)
    tree["files"] = set()
    for dirpath, _, filenames in os.walk(osp.join(root, "experiments")):
        tree["files"] |= {osp.relpath(osp.join(dirpath, f), root) for f in filenames}
    return tree


def md_rel(got: list, want: list) -> float:
    """|got - want| / |want|, in norm over a list of tensors."""
    num = sum(float((a - b).double().pow(2).sum()) for a, b in zip(got, want))
    return math.sqrt(num / sum(float(b.double().pow(2).sum()) for b in want))


def check_one_nccl_rank(b: dict, cfg: dict, per_step: dict) -> None:
    """The checks of a part (b) report ``b`` (``multi_device_worker``): both
    runs launched ``per_step`` kernels in each counted step (the eager
    warm-up's and the capture's ``2 * chunk``; replays are not counted), the
    group is NCCL, ``all_reduce`` was called for each BatchNorm of ResNet-18
    forward and backward, the flat gradient and the metric row in each
    counted step and never in a replay, the statistics are finite, and the
    graphed one-rank NCCL run is the run without a group, bit for bit."""
    k = cfg["chunk"]
    want = {name: 2 * k * per_step.get(name, 0) for name in b["plain"]["launches"]}
    for run in ("plain", "dp"):
        check(b[run]["launches"] == want, f"part (b), {run}: {cfg['graph_iters']} graphed "
              f"iterations launched {b[run]['launches']}, not {want} (the eager warm-up "
              "and the capture; replays are not counted)")
    check(b["backend"] == "nccl", f"part (b) ran on {b['backend']}, not NCCL")
    # ResNet-18 has 20 BatchNorms: each all-reduces its moments forward and
    # backward; then the flat gradient and the metric row. Replays call nothing.
    calls = 2 * 20 + 2
    check(b["all_reduce_calls"] == 2 * k * calls,
          f"part (b) called all_reduce {b['all_reduce_calls']} times, not "
          f"{2 * k * calls} (the warm-up's and the capture's {2 * k} steps)")
    check(all(math.isfinite(v) for row in b["stats"].values() for v in row.values()),
          "part (b): non-finite statistics")
    check(b["stats_equal"] and b["tensors_equal"],
          f"part (b): the graphed one-rank NCCL run is not the run without a group, bit for "
          f"bit (stats max abs difference {b['max_stat_diff']:.3g}; S and R equal: "
          f"{b['tensors_equal']})")


def phase_multi_device(card: str, cfg: dict = MD) -> dict:
    """The multi-device path (``--multi-device``), in two parts on the one card.

    (a) Two ranks share the card over gloo (NCCL refuses two ranks on one
    card): ``sample_gan`` (rank 0 samples, rank 1 waits), ``train
    --multi-device`` (f32, TF32 off; 16 of the 32 rows a rank; the attention
    opened) and ``traverse_latent_space --multi-device`` (each rank its
    contiguous block of the three codes' render batches, bf16 frames). Then
    in this process: the same pipeline ("single"); its
    training again with PyTorch's native convolutions, traversed as the
    others ("control"); one process's traversal of the two ranks' own sets
    and pool ("retraverse"); and the first step in float64 and in float32
    from the single run's first state and batch (:func:`md_first_step`).
    One tree: the two ranks' files are the one process's. The first step:
    its metrics within rtol 1e-4 / atol 1e-5 (the JAX package's gates); its
    S and R gradients, the two ranks' no farther from the float64 step than
    ``MD_F64_RATIO`` times one process's (float32 computes them to about
    1 %); the witness's float32 step is the CLI's within 1e-4. Later log
    windows, codes and frames against the single tree: within ``MD_SPREAD``
    times as far as the control lies from it, and at least at the JAX
    package's gates (1e-4 for codes, 2 grey levels). The traversal split
    over the ranks: codes within 1e-4 and frames within 2 grey levels of
    one process's traversal of the same sets. Each rank launches the
    attention forward twice and its backward once an iteration, the
    attention once for each render batch of its block and the warp once a
    step.

    (b) One NCCL rank (world size 1), bf16 G and R as the script runs them,
    ``--steps-per-call``: the all-reduces are captured in the CUDA graph and
    replayed (Python calls ``all_reduce`` only in the eager warm-up and the
    capture). Held to the same run without a process group in the same
    process, with the deterministic algorithms: the same bits.

    Returns each kernel's launches on the path, the workers' summed."""
    import shutil

    import numpy as np
    import torch

    from warpedganspace_torch.parallel import rank_block

    torch.cuda.empty_cache()                  # the workers share the card with this process
    cwd = os.getcwd()
    exp = osp.join("experiments", "complete", md_exp_name(cfg))
    pool = osp.join("experiments", "latent_codes")
    with tempfile.TemporaryDirectory(prefix="wgs_smoke_md_") as tmp:
        roots = {d: osp.join(tmp, d) for d in ("multi", "single", "control", "retraverse",
                                               "graphed")}
        for d in roots.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        ranks = md_spawn("a", roots["multi"], 2, cfg)
        t_a = time.perf_counter() - t0
        # One process's traversal of the two ranks' tree: their sets and pool.
        for sub in (osp.join(exp, "args.json"), osp.join(exp, "models"), pool):
            copy_fn = shutil.copytree if osp.isdir(osp.join(roots["multi"], sub)) else shutil.copy
            os.makedirs(osp.dirname(osp.join(roots["retraverse"], sub)), exist_ok=True)
            copy_fn(osp.join(roots["multi"], sub), osp.join(roots["retraverse"], sub))
        os.environ["WGS_ALLOW_RANDOM_G"] = "1"
        runs = {}
        for name, stages in (("single", ("sample", "train", "traverse")),
                             ("control", ("train", "traverse")), ("retraverse", ("traverse",))):
            if name == "control":                # the single run's pool
                shutil.copytree(osp.join(roots["single"], pool), osp.join(roots["control"], pool))
            os.chdir(roots[name])
            try:
                runs[name] = md_pipeline(cfg, False, stages, native_conv=name == "control",
                                         snapshot=name == "single")
            finally:
                os.chdir(cwd)
        single = runs["single"]
        one_ms, _ = md_step_timing(single["state"])
        # The witness: the first step again from its state and batch, in f32
        # through cuDNN and through the native convolutions, and in float64.
        t_w = time.perf_counter()
        G, step_cfg = single["state"].G, single["state"].cfg
        witness = {name: md_first_step(G, single["first"], step_cfg, dtype, native)
                   for name, dtype, native in (("f32", torch.float32, False),
                                               ("native", torch.float32, True),
                                               ("f64", torch.float64, False))}
        t_w = time.perf_counter() - t_w
        for run in runs.values():
            run.pop("state", None)
            run.pop("first", None)
        del G
        grads_dp = torch.load(osp.join(roots["multi"], "first_step_grads.pt"))
        t_single = time.perf_counter() - t0 - t_a
        trees = {name: md_tree(roots[name], cfg) for name in ("multi", "single", "control",
                                                               "retraverse")}
        t1 = time.perf_counter()
        (b,) = md_spawn("b", roots["graphed"], 1, cfg)
        t_b = time.perf_counter() - t1

    # (a) The first step, from one state on both sides, against float64.
    exact = witness["f64"][0]
    f64_err = {part: {"ranks": md_rel([g.to(exact[part][0].device) for g in grads_dp[part]],
                                      exact[part]),
                      "single": md_rel([g.to(exact[part][0].device)
                                        for g in single["grads"][part]], exact[part]),
                      "f32": md_rel(witness["f32"][0][part], exact[part]),
                      "native": md_rel(witness["native"][0][part], exact[part])}
               for part in ("S", "R")}
    replica = {part: md_rel(witness["f32"][0][part], [g.to(exact[part][0].device).double()
                                                      for g in single["grads"][part]])
               for part in ("S", "R")}
    seen32, seen64 = witness["f32"][1], witness["f64"][1]
    names = seen64.pop("names")
    for w in witness.values():
        w[1].pop("names", None)
    # Where one process's f32 step departs from float64, parameter by parameter.
    param_err = sorted(((md_rel([a], [b]), n) for n, a, b in zip(
        names, witness["f32"][0]["S"] + witness["f32"][0]["R"], exact["S"] + exact["R"])),
        reverse=True)
    layer_err = {name: md_rel([seen32[name].double()], [seen64[name]]) for name in seen64}
    bn_err = max(v for name, v in layer_err.items() if name != "logits")
    seen_native = witness["native"][1]
    bn_err_native = max(md_rel([seen_native[name].double()], [seen64[name]])
                        for name in seen64 if name != "logits")
    grad_err = {part: md_rel(grads_dp[part], single["grads"][part]) for part in ("S", "R")}
    for part in ("S", "R"):
        e = f64_err[part]
        check(replica[part] <= 1e-4,
              f"the witness's f32 first step is {replica[part]:.3g} of {part}'s norm from the "
              "CLI's: it no longer computes the CLI's loss")
        check(e["ranks"] <= MD_F64_RATIO * e["single"],
              f"the first step's {part} gradient: two ranks {e['ranks']:.3g} of its norm from "
              f"float64, one process {e['single']:.3g} (gate {MD_F64_RATIO}x)")
    # One tree, the one process's, and its statistics.
    one, ctl, multi = trees["single"], trees["control"], trees["multi"]
    check(multi["files"] == one["files"],
          f"the two ranks' tree differs in its files: {sorted(multi['files'] ^ one['files'])}")
    s1, s2, s3 = one["stats"], multi["stats"], ctl["stats"]
    check(set(s1) == set(s2) == set(s3) == {str(i) for i in range(1, cfg["iters"] + 1)},
          f"stats.json windows {sorted(s1)}, {sorted(s2)}, {sorted(s3)}")
    stat_err, stat_spread = ({it: max(abs(s[it][k] - v) for k, v in row.items())
                              for it, row in s1.items()} for s in (s2, s3))
    for it, row in s1.items():
        for k, v in row.items():
            gate = 1e-5 + 1e-4 * abs(v)
            if it != "1":
                gate = max(gate, MD_SPREAD * abs(s3[it][k] - v))
            check(abs(s2[it][k] - v) <= gate,
                  f"stats.json[{it}][{k}]: two ranks {s2[it][k]!r}, one process {v!r}, "
                  f"control {s3[it][k]!r}")
    # Codes and frames of the two ranks' tree against the single tree, and
    # the traversal split over the ranks against one process on the same sets.
    c1, c2, c3, c4 = (trees[n]["codes"] for n in ("single", "multi", "control", "retraverse"))
    f1, f2, f3, f4 = (trees[n]["frames"] for n in ("single", "multi", "control", "retraverse"))
    check(len(c1) == cfg["codes"] and set(c1) == set(c2) == set(c3) == set(c4)
          and f1.keys() == f2.keys() == f3.keys() == f4.keys(),
          "the traversals' codes or frames")

    def code_diff(a, b):
        return max(float(np.abs(a[h] - b[h]).max()) for h in b)

    def frame_diff(a, b):
        return max(int(np.abs(a[key] - b[key]).max()) for key in b)

    code_err, code_spread, code_split = code_diff(c2, c1), code_diff(c3, c1), code_diff(c2, c4)
    frame_err, frame_spread, frame_split = (frame_diff(f2, f1), frame_diff(f3, f1),
                                            frame_diff(f2, f4))
    check(code_err <= max(1e-4, MD_SPREAD * code_spread),
          f"codes of two ranks vs one process max abs {code_err:.3g} (control {code_spread:.3g})")
    check(frame_err <= max(2, MD_SPREAD * frame_spread),
          f"frames of two ranks vs one process differ by {frame_err} grey levels (control "
          f"{frame_spread})")
    check(all(bool(np.all(np.abs(c2[h] - c4[h]) <= 1e-4 + 1e-4 * np.abs(c4[h]))) for h in c4),
          f"codes of two ranks vs one process on the same sets max abs {code_split:.3g}")
    check(frame_split <= 2, f"frames of two ranks vs one process on the same sets differ by "
                            f"{frame_split} grey levels")
    iters, n_frames = cfg["iters"], cfg["k"] * (2 * cfg["steps"] + 1)
    renders = math.ceil(n_frames / cfg["render_batch"])
    # Each rank renders its contiguous block of the codes' render batches.
    blocks = [len(rank_block(range(cfg["codes"] * renders), 2, r)) for r in range(2)]
    for rep in ranks:
        want = {"rbf_warp": cfg["steps"], "sa_attention": 2 * iters + blocks[rep["rank"]]
                + (cfg["codes"] if rep["rank"] == 0 else 0), "sa_attention_bwd": iters,
                "proggan_tail": 0, "sg2_tail": 0}
        check(rep["launches"] == want, f"rank {rep['rank']} of 2 launched {rep['launches']}, "
                                       f"not {want}")
    wants = {"single": (cfg["steps"], 2 * iters + cfg["codes"] * (renders + 1), iters),
             "control": (cfg["steps"], 2 * iters + cfg["codes"] * renders, iters),
             "retraverse": (cfg["steps"], cfg["codes"] * renders, 0)}
    for name, (warp, fwd, bwd) in wants.items():
        want = {"rbf_warp": warp, "sa_attention": fwd, "sa_attention_bwd": bwd,
                "proggan_tail": 0, "sg2_tail": 0}
        check(runs[name]["launches"] == want, f"the one-process run ({name}) launched "
                                              f"{runs[name]['launches']}, not {want}")

    # (b): the graphed one-rank NCCL run is the run without a group, bit for bit.
    check_one_nccl_rank(b, cfg, {"sa_attention": 2, "sa_attention_bwd": 1})
    k = cfg["chunk"]

    a_ms = [rep["step_ms"] for rep in ranks]
    secs = [rep["seconds"] for rep in ranks]
    print(f"[multi_device] (a) 2 gloo ranks on one card, BigGAN-128 class 239, K={cfg['k']} "
          f"D={cfg['dipoles']} ResNet R, f32 (TF32 off), global batch {cfg['batch']} "
          f"({cfg['batch'] // 2} a rank), {iters} iterations, then {cfg['codes']} codes "
          f"traversed ({n_frames} frames a code in bf16 render batches of "
          f"{cfg['render_batch']}, {'/'.join(map(str, blocks))} batches by rank) on {card}: "
          f"{t_a:.2f} s wall for both ranks (start-up and generator builds included; rank 0's "
          + ", ".join(f"{st} {sec:.2f} s" for st, sec in secs[0].items())
          + f"); eager steps {a_ms[0]:.1f} / {a_ms[1]:.1f} ms on ranks 0 / 1 against "
          f"{one_ms:.1f} ms in one process on the whole batch ({t_single:.2f} s for the "
          f"one-process runs, {t_w:.2f} s of them the witness); the gloo all-reduces (host "
          f"copies) {100 * ranks[0]['all_reduce_share']:.1f} / "
          f"{100 * ranks[1]['all_reduce_share']:.1f} % of an eager step; launches by rank "
          f"{[rep['launches'] for rep in ranks]}")
    print("[multi_device] (a) the first step against float64 on " + card + ", of S's / R's "
          "gradient norm: two ranks " + " / ".join(f"{f64_err[p]['ranks']:.3g}" for p in "SR")
          + ", one process " + " / ".join(f"{f64_err[p]['single']:.3g}" for p in "SR")
          + ", its first state and batch again through the witness's f32 code "
          + " / ".join(f"{f64_err[p]['f32']:.3g}" for p in "SR") + " (the CLI's within "
          + " / ".join(f"{replica[p]:.3g}" for p in "SR") + ") and through PyTorch's native "
          "convolutions " + " / ".join(f"{f64_err[p]['native']:.3g}" for p in "SR")
          + "; two ranks from one process " + " / ".join(f"{grad_err[p]:.3g}" for p in "SR")
          + f"; R's {len(layer_err) - 1} BatchNorm inputs within {bn_err:.3g} (native "
          f"convolutions: {bn_err_native:.3g}) and its logits within "
          f"{layer_err['logits']:.3g} of float64 (relative in norm; "
          + ", ".join(f"{k} {v:.3g}" for k, v in layer_err.items() if k != "logits")
          + "); one process's worst parameters against float64: "
          + ", ".join(f"{n} {e:.3g}" for e, n in param_err[:6]))
    print(f"[multi_device] (a) the tree of two ranks against one process's (the control, "
          f"trained with the native convolutions, against it): stats max abs difference by "
          f"log window " + ", ".join(f"{it}: {stat_err[it]:.3g} ({stat_spread[it]:.3g})"
                                      for it in s1)
          + f"; codes {code_err:.3g} ({code_spread:.3g}); frames {frame_err} ({frame_spread}) "
          f"grey levels; against one process's traversal of the same sets: codes "
          f"{code_split:.3g}, frames {frame_split} grey levels")
    tr = b["traced"]
    print(f"[multi_device] (b) 1 NCCL rank, bf16 G and R, --steps-per-call {k}, "
          f"{cfg['graph_iters']} iterations, deterministic algorithms, on {card}: "
          f"{t_b:.2f} s wall for both runs; {b['dp']['step_ms']:.2f} ms per step graphed with "
          f"the group against {b['plain']['step_ms']:.2f} ms without (log windows of "
          f"replays); {b['all_reduce_calls']} all_reduce calls for {cfg['graph_iters']} "
          f"iterations; the same bits as the run without a group; an eager data-parallel step "
          f"traced on host and device: {tr['ms']:.2f} ms, device busy {100 * tr['busy']:.1f} %, "
          f"NCCL kernels {tr['tag_ms']:.3f} ms ({100 * tr['tag_share']:.2f} % of "
          f"{tr['kernel_ms']:.2f} ms of kernels) in {tr['tag_launches']:.0f} launches")
    total = dict.fromkeys(ranks[0]["launches"], 0)
    for launches in ([rep["launches"] for rep in ranks] + [run["launches"] for run in runs.values()]
                     + [b["plain"]["launches"], b["dp"]["launches"]]):
        for name, n in launches.items():
            total[name] += n
    return total


def cuda_spans(events) -> list:
    """(start, end) on the tracer's clock (us) of the device events among a
    profile's ``events()``."""
    import torch

    return [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy(spans, lo, hi):
    """Of the (start, end) device intervals that touch [lo, hi]: their summed
    time, the length of their union, their number."""
    spans = sorted((max(start, lo), min(end, hi)) for start, end in spans
                   if end > lo and start < hi)
    total, busy, edge = 0.0, 0.0, lo
    for start, end in spans:
        total += end - start
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    return total, busy, len(spans)


def check_trained_tree(cfg: dict, wip: str, exp: str) -> tuple:
    """The tree a run to ``cfg['resume_to']`` wrote, after a resume: every
    file, the completed copy, the checkpoint's iteration, finite statistics of
    every log window, sets and loggamma moved and the alphas not, R finite
    with refreshed statistics. Returns (stats, initial sets, how far each
    moved)."""
    import torch

    models = ("support_sets_init.pt", "checkpoint.pt", "optimizer_state.npz",
              "support_sets.pt", "reconstructor.pt")
    check(all(osp.isfile(osp.join(wip, "models", f)) for f in models)
          and all(osp.isfile(osp.join(wip, f)) for f in ("args.json", "command.sh", "stats.json")),
          "the training tree misses a file")
    check(osp.isfile(osp.join(exp, "models", "support_sets.pt"))
          and not osp.isfile(osp.join(exp, "models", "checkpoint.pt")),
          "the completed tree must hold support_sets.pt and no checkpoint.pt")
    ckpt = torch.load(osp.join(wip, "models", "checkpoint.pt"))
    check(ckpt["iter"] == cfg["resume_to"], f"checkpoint of iteration {ckpt['iter']}")
    with open(osp.join(wip, "stats.json")) as f:
        stats = json.load(f)
    check(set(stats) == {str(i) for i in range(cfg["log_freq"], cfg["resume_to"] + 1,
                                               cfg["log_freq"])},
          f"stats.json holds windows {sorted(stats)}")
    check(all(math.isfinite(v) for row in stats.values() for v in row.values()),
          "non-finite training statistics")
    init = torch.load(osp.join(wip, "models", "support_sets_init.pt"))
    final = torch.load(osp.join(wip, "models", "support_sets.pt"))
    moved = {key: float((final[key] - init[key]).abs().max()) for key in init}
    check(moved["SUPPORT_SETS"] > 0 and moved["LOGGAMMA"] > 0 and moved["ALPHAS"] == 0
          and all(bool(torch.isfinite(t).all()) for t in final.values()),
          f"after training the sets and loggamma must have moved, alphas not: {moved}")
    check(tuple(final["SUPPORT_SETS"].shape) == (cfg["k"], 2 * cfg["dipoles"] * cfg["d"]),
          "support sets' shape")
    R_sd = torch.load(osp.join(wip, "models", "reconstructor.pt"))
    stat = next(n for n in ("features_extractor.bn1.running_mean",
                            "feature_extractor.1.running_mean") if n in R_sd)
    check(all(bool(torch.isfinite(t.float()).all()) for t in R_sd.values())
          and float(R_sd[stat].abs().max()) > 0,
          "the reconstructor's weights or refreshed statistics")
    return stats, init, moved


def direct_train_state(cfg: dict):
    """The train state of ``cfg``'s experiment, built as ``cli.train`` builds
    it (its own parser reads the script's flags), with seeded random
    generator weights, for timing and tracing the step outside the CLI; and
    the float32 generator the state's bf16 copy was made from."""
    import torch

    from warpedganspace_torch.cli import train
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.models.reconstructor import Reconstructor
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.train.train_step import TrainStepConfig, init_train_state

    a = train.build_parser().parse_args(cfg["argv"])
    G = build_gan(a.gan_type, target_classes=a.biggan_target_classes,
                  stylegan2_resolution=a.stylegan2_resolution,
                  shift_in_w_space=a.shift_in_w_space, allow_random_init=True, device="cuda")
    gen = torch.Generator().manual_seed(a.seed)
    S = SupportSets(a.num_support_sets, a.num_support_dipoles, G.dim_z, learn_gammas=a.learn_gammas,
                    gamma=1.0 / G.dim_z, generator=gen)
    R = Reconstructor(a.reconstructor_type, dim=a.num_support_sets,
                      channels=1 if a.gan_type == "SNGAN_MNIST" else 3, generator=gen)
    return init_train_state(G, S, R, TrainStepConfig.from_params(a), seed=a.seed), G


def compare_routes(state, G32, use_kernel) -> str:
    """The path's own step on the tail kernel and on the plain tail, from
    one snapshot of ``state`` (S, R with its statistics, both Adams) and one
    batch at the experiment's width, with cuDNN's and PyTorch's deterministic
    algorithms: the step's total loss, and the gradient of its path through
    the generator, d(G(z + shift) . w)/d(shift) at the step's own codes.
    The losses agree within 1e-4 in f32 (``G32``, R in f32) and 5e-2 in
    bf16 (the path's own types). Each route's gradient is held to the plain
    tail's in float64 (the generator cast, four codes at a time: a code's
    gradient depends on that code alone): the kernel route's departs from
    it no more than 1.5x the plain route's in the same type, or 1e-4 (f32)
    and 1e-2 (bf16) of its largest entry. A relative bound on the f32 routes
    alone, as ``tests/test_torch_train_graph_cuda.py`` has at a small size,
    does not hold at 1024^2: every section after the first reads the
    kernel's output, summed in another order than the plain section's, and
    a LeakyReLU whose input sits at zero takes the other slope; the f32 routes
    then lie about as far from each other as each lies from float64. Bits
    are not compared for the same reason. ``use_kernel(flag)`` swaps the
    route. Returns what it read."""
    import copy
    import dataclasses

    import torch

    from warpedganspace_torch.train.train_step import metric_row, sample_batch, train_step

    it = 7                                            # any iteration: its batch is fixed
    s32 = dataclasses.replace(state, G=G32, cfg=dataclasses.replace(
        state.cfg, generator_dtype="float32", reconstructor_dtype="float32"))
    G64 = copy.deepcopy(G32)
    for t in list(G64.parameters()) + list(G64.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.double()
    live = list(state.S.state_dict().values()) + list(state.R.state_dict().values())
    for opt in (state.opt_s, state.opt_r):
        live += [t for st in opt.state.values() for t in st.values() if torch.is_tensor(t)]
    saved = [t.clone() for t in live]

    def restore():
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)

    def shift_grad(G, rows=None):
        dt = next(G.parameters()).dtype
        acc = torch.float64 if dt == torch.float64 else torch.float32
        z = sample_batch(state, it)[0]
        n = z.shape[0]
        shift0 = 0.1 * torch.randn(z.shape, generator=torch.Generator().manual_seed(3))
        w = torch.randn((n, 3, G.resolution, G.resolution), device=z.device,
                        generator=torch.Generator(z.device).manual_seed(4))
        out = []
        for b in range(0, n, rows or n):
            zb = z[b:b + (rows or n)].to(dt)
            if state.cfg.shift_in_w_space:
                with torch.no_grad():
                    zb = G.get_w(zb)
            shift = shift0[b:b + len(zb)].to(z.device, dt).requires_grad_(True)
            img = G(zb, shift, latent_is_w=state.cfg.shift_in_w_space)
            torch.sum(img.to(acc) * w[b:b + len(zb)].to(acc)).backward()
            out.append(shift.grad.double())
        return torch.cat(out)

    loss, grad = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for route in ("kernel", "plain"):
            use_kernel(route == "kernel")
            for dt, st in (("bfloat16", state), ("float32", s32)):
                restore()
                loss[route, dt] = float(metric_row(train_step(st, it))[3])
                grad[route, dt] = shift_grad(st.G)
        ref = shift_grad(G64, rows=4)                 # the plain route is still set
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
        use_kernel(True)
        restore()
    del G64

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    err = {key: rel(g, ref) for key, g in grad.items()}
    apart = {dt: abs(loss["kernel", dt] - loss["plain", dt]) for dt in ("float32", "bfloat16")}
    check(all(math.isfinite(v) for v in loss.values())
          and all(bool(torch.isfinite(g).all()) for g in grad.values()),
          f"non-finite loss or shift gradient on a route: {loss}")
    for dt, loss_bound, grad_bound in (("float32", 1e-4, 1e-4), ("bfloat16", 5e-2, 1e-2)):
        check(apart[dt] <= loss_bound
              and err["kernel", dt] <= max(1.5 * err["plain", dt], grad_bound),
              f"{dt}: the routes' losses {apart[dt]:.3g} apart (bound {loss_bound:g}); the "
              f"shift gradient of the kernel route {err['kernel', dt]:.3g} and of the plain "
              f"route {err['plain', dt]:.3g} of its largest entry from float64")
    return (f"loss kernel {loss['kernel', 'bfloat16']:.6f} / plain "
            f"{loss['plain', 'bfloat16']:.6f} in bf16, {loss['kernel', 'float32']:.7f} / "
            f"{loss['plain', 'float32']:.7f} in f32 ({apart['float32']:.3g} apart); the shift's "
            f"gradient through G from the float64 plain route, of its largest entry: f32 kernel "
            f"{err['kernel', 'float32']:.3g}, plain {err['plain', 'float32']:.3g} (the two "
            f"{rel(grad['kernel', 'float32'], grad['plain', 'float32']):.3g} apart); bf16 kernel "
            f"{err['kernel', 'bfloat16']:.3g}, plain {err['plain', 'bfloat16']:.3g}")


def wall_ms(run, n: int) -> float:
    """Milliseconds per call of ``run`` on the host's clock, between synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def trace_calls(run, n: int, tag: str | None = None, rows: int = 0) -> dict:
    """``n`` calls of ``run`` traced on host and device by ``torch.profiler``
    inside a marked window (after one traced call on which the tracer's
    start-up falls): ms per call on the tracer's clock, the device's busy
    share of the window, kernel ms per call and, with ``tag``, the share of
    the kernel time in kernels whose name holds it; with ``rows``, the
    largest rows of the kernel table of all ``n + 1`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cpu = torch.autograd.DeviceType.CPU
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        run()
        torch.cuda.synchronize()
        with record_function("traced_window"):
            for _ in range(n):
                run()
            torch.cuda.synchronize()
    # Host-side marks that hold kernels reappear as device ranges of the same
    # name; they are no kernels.
    host_names = {e.name for e in tp.events() if e.device_type == cpu}
    window = next(e for e in tp.events()
                  if e.name == "traced_window" and e.device_type == cpu).time_range
    events = [e for e in tp.events() if e.name not in host_names]
    kernels_us, busy_us, n_spans = device_busy(cuda_spans(events), window.start, window.end)
    out = {"ms": (window.end - window.start) / 1e3 / n,
           "busy": busy_us / (window.end - window.start), "kernel_ms": kernels_us / 1e3 / n,
           "launches": n_spans / n}
    if tag is not None:
        tag_us, _, tag_n = device_busy(cuda_spans(e for e in events if tag in e.name),
                                       window.start, window.end)
        out.update(tag_share=tag_us / max(kernels_us, 1e-9), tag_ms=tag_us / 1e3 / n,
                   tag_launches=tag_n / n)
    if rows:
        out["table"] = tp.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows,
                                               max_name_column_width=70)
    return out


def trace_device(run, rows: int = 0) -> dict:
    """One call of ``run`` traced on the device alone by ``torch.profiler``
    (the host records nothing per operator): its ms on the host's clock, the
    device's busy share of that, kernel ms and the number of device events,
    and with ``rows`` the kernel table. The intervals are read from the raw
    trace, not from ``events()``, whose Python event tree takes about 20 s to
    build for the 10^5 launches of an attribute-stage run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    spans = [(e.start_ns(), e.end_ns()) for e in tp.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(len(spans) > 0, "the device-only trace holds no device event")
    total, busy, n = device_busy(spans, min(start for start, _ in spans), math.inf)
    out = {"ms": 1e3 * seconds, "busy": busy / (1e9 * seconds), "kernel_ms": total / 1e6,
           "launches": n}
    if rows:
        out["table"] = tp.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows,
                                               max_name_column_width=70)
    return out


def counted_steps(start: int, max_iter: int, k: int) -> int:
    """The steps whose kernel launches the wrappers count in one run of
    ``cli.train`` from iteration ``start`` to ``max_iter`` with
    ``--steps-per-call k``, by the trainer's schedule (``train/trainer.py``):
    a chunk of k starts where ``(iteration - 1) % k == 0`` with a whole chunk
    ahead, every other iteration runs alone. A run's first chunk runs eagerly
    (the warm-up) and its second is captured, both counted; its later chunks
    replay the graph, whose launches no wrapper counts."""
    counted, chunks, it = 0, 0, start
    while it <= max_iter:
        if k > 1 and (it - 1) % k == 0 and it + k - 1 <= max_iter:
            counted += k if chunks < 2 else 0
            chunks += 1
            it += k
        else:
            counted += 1
            it += 1
    return counted


def graph_against_eager(state, k: int, steps: int, trace_steps: int, tag: str | None = None,
                        rows: int = 12) -> tuple:
    """The step of ``state`` graphed (a ``StepChunk`` of ``k``) against the
    eager step (``train_step``). Peak device memory of each route, allocated
    and reserved, the allocator's cache emptied and both peaks reset before
    each: the eager route's over two steps, then the graph's over its eager
    warm-up, its capture and a replay (its private pool beside the blocks the
    warm-up cached). ms per step untraced, in turns graph, eager, eager,
    graph, about ``steps`` steps a turn; then ``trace_steps`` steps of each
    traced on host and device (``trace_calls``; with ``tag`` the share of
    the kernel time in kernels whose name holds it; the kernel tables of
    ``rows`` rows). Returns (what it read, the chunk)."""
    import torch

    from warpedganspace_torch.train.train_step import StepChunk, train_step

    first = iter(range(1, 10 ** 6, k))               # each replay's first iteration

    def replay():
        return chunk(next(first))

    def peaks():
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() / 2 ** 30,
                torch.cuda.max_memory_reserved() / 2 ** 30)

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(state, 1)
    out["eager_gib"] = peaks()
    chunk = StepChunk(state, k)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):                                # the warm-up, the capture, a replay
        replay()
    check(chunk.graph is not None, f"--steps-per-call {k}: the chunk was not captured")
    out["graph_gib"] = peaks()
    replays = max(1, steps // k)
    turns = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        turns[route].append(wall_ms(replay, replays) / k if route == "graph"
                            else wall_ms(lambda: train_step(state, 1), replays * k))
    out["turns"] = turns
    out["ms"] = {route: sum(v) / len(v) for route, v in turns.items()}
    graph = trace_calls(replay, max(1, trace_steps // k), tag=tag, rows=rows)
    out["graph"] = dict(graph, ms=graph["ms"] / k, kernel_ms=graph["kernel_ms"] / k,
                        launches=graph["launches"] / k)
    out["eager"] = trace_calls(lambda: train_step(state, 1), trace_steps, tag=tag, rows=rows)
    if tag is not None:
        out["graph"]["tag_ms"] = graph["tag_ms"] / k
    return out, chunk


def graph_text(name: str, k: int, g: dict, card: str) -> str:
    """The line of :func:`graph_against_eager`'s readings."""
    tr, eg, (g1, g2), ms = g["graph"], g["eager"], g["turns"]["graph"], g["ms"]
    turns = ", ".join(f"{t:.3f}" for t in (g1, *g["turns"]["eager"], g2))
    return (f"[train step] {name} graphed (--steps-per-call {k}, one CUDA graph of {k} steps "
            f"a replay) against eager on {card}: untraced in turns graph, eager, eager, graph "
            f"{turns} ms per step: graphed {ms['graph']:.3f} ms ({1e3 / ms['graph']:.2f} "
            f"steps/s) against eager {ms['eager']:.3f} ms ({1e3 / ms['eager']:.2f} steps/s), "
            f"the graph {ms['eager'] / ms['graph']:.3f}x the eager steps/s; traced on "
            f"host and device: graphed {tr['ms']:.3f} ms per step, device busy "
            f"{100 * tr['busy']:.1f} %, {tr['kernel_ms']:.3f} ms of kernels and "
            f"{tr['launches']:.1f} device events per step; eager {eg['ms']:.3f} ms per step, busy "
            f"{100 * eg['busy']:.1f} %, {eg['kernel_ms']:.3f} ms of kernels in "
            f"{eg['launches']:.1f} events; peak device memory allocated / reserved: eager "
            f"{g['eager_gib'][0]:.2f} / {g['eager_gib'][1]:.2f} GiB, graphed "
            f"{g['graph_gib'][0]:.2f} / {g['graph_gib'][1]:.2f} GiB")


def phase_train_path(card: str, name: str, cfg: dict) -> dict:
    """One training path of ``TRAIN_PATHS``: ``train`` for ``cfg['iters']``
    iterations, the same command with a larger ``--max-iter`` (a resume at the
    stored iteration; ``--profile`` on it where the step is graphed), then
    ``checkpoint2model`` on the tree and ``traverse_latent_space`` on it
    without its final ``support_sets.pt``, as an interrupted run leaves it, so
    that the traversal reads the split file. Launch counts as equalities: the
    tail kernel ``per_forward`` times a forward, two forwards a counted step
    (``counted_steps``: a graphed run's warm-up and capture, not its
    replays); the warp none in training and one per traversal step. Where
    the step is graphed (``cfg['chunk'] > 1``), the log windows of the first
    run before the resume are held to two eager runs'. Then (unless
    ``cfg['step_alone']`` is False) the step alone, outside the CLI: graphed
    against eager (``graph_against_eager``) and, for StyleGAN2 and ProgGAN,
    through the tail kernel against the plain tail with peak memory, the
    tail's share of a traced step and ``compare_routes``. Returns each
    kernel's launches on the path."""
    import contextlib
    import io

    import torch

    from warpedganspace_torch.cli import checkpoint2model, train
    from warpedganspace_torch.models import proggan, stylegan2
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops.proggan_tail import proggan_tail_plain
    from warpedganspace_torch.ops.sg2_tail import fused_section_plain
    from warpedganspace_torch.train.train_step import train_step
    from warpedganspace_torch.utils.aux import experiment_name

    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    exp_name = experiment_name(vars(train.build_parser().parse_args(cfg["argv"])))
    k = cfg["chunk"]
    graphed = k > 1

    def argv(max_iter, extra=()):
        return cfg["argv"] + ["--log-freq", str(cfg["log_freq"]), "--ckp-freq",
                              str(cfg["ckp_freq"]), "--max-iter", str(max_iter)] + list(extra)

    def step_s(trainer, skip):
        """Seconds per step over the log windows after the first ``skip`` and
        without a checkpoint, and over how many steps."""
        clean = [w for w in trainer.window_times[skip:] if not w[2]]
        n = sum(w[0] for w in clean)
        return sum(w[1] for w in clean) / n, n

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix=f"wgs_smoke_{name}_") as tmp:
        os.chdir(tmp)
        try:
            reset_launch_counts()                     # count only this path's launches
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):     # the progress block redraws itself
                first = train.main(argv(cfg["iters"]))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                train.main(argv(cfg["resume_to"], ["--profile"] if graphed else []))
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(f"Start training from iteration {cfg['iters']}" in log.getvalue(),
                  "the second run did not resume at the stored iteration")
            check("Adam moments reset" not in log.getvalue(),
                  "the resumed run could not read its own optimizer sidecar")
            n_iters = cfg["iters"] + (cfg["resume_to"] - cfg["iters"] + 1)
            n_counted = (counted_steps(1, cfg["iters"], k)
                         + counted_steps(cfg["iters"], cfg["resume_to"], k))
            train_launches = launch_counts()
            want = {kname: 0 for kname in train_launches}
            if cfg["tail"]:
                want[cfg["tail"]] = 2 * cfg["per_forward"] * n_counted
            check(train_launches == want, f"{n_iters} training iterations of {cfg['gan']} "
                                          f"({n_counted} of them counted steps) launched "
                                          f"{train_launches}, not {want}")
            wip = osp.join("experiments", "wip", exp_name)
            stats, init, moved = check_trained_tree(cfg, wip,
                                                    osp.join("experiments", "complete", exp_name))
            if graphed:
                check(osp.isfile(osp.join(wip, "profile", "trace.json")),
                      "--profile wrote no trace")
            # The first window builds, warms up and (graphed) captures.
            first_s, first_n = step_s(first, 2 if graphed else 1)
            eager_s = eager_n = apart = None
            if graphed:
                # The same run with one step a call, twice, each in a root of its
                # own, to the last log window before the resume. The graphed
                # run's log windows before the resume (which runs the stored
                # iteration again and logs its window anew) are held to the first
                # eager run's as the second eager run is (MD_SPREAD times as far;
                # cuDNN's algorithms do not repeat their bits), or within 1e-3
                # of the largest metric (tests/test_torch_train_graph_cuda.py's
                # rule, for more steps).
                eager_stats = []
                for root in ("eager", "eager_again"):
                    os.makedirs(root)
                    os.chdir(root)
                    with contextlib.redirect_stdout(io.StringIO()):
                        eager = train.main(argv(cfg["iters"] - cfg["log_freq"],
                                                ["--steps-per-call", "1"]))
                    with open(osp.join(wip, "stats.json")) as f:
                        eager_stats.append(json.load(f))
                    os.chdir(tmp)
                    if root == "eager":
                        eager_s, eager_n = step_s(eager, 1)
                want, again = ({w: row for w, row in st.items() if int(w) < cfg["iters"]}
                               for st in eager_stats)
                check(len(want) > 0 and set(want) == set(again) <= set(stats),
                      "the eager runs' log windows")

                def stats_apart(a):
                    return max(abs(a[w][m] - v) for w, row in want.items() for m, v in row.items())

                apart = {"graphed": stats_apart(stats), "eager again": stats_apart(again)}
                largest = max(abs(v) for row in want.values() for v in row.values())
                check(apart["graphed"] <= max(MD_SPREAD * apart["eager again"], 1e-3 * largest),
                      f"{name}: the graphed run's windows before iteration {cfg['iters']} lie "
                      f"{apart['graphed']:.3g} from the eager run's log windows, the second "
                      f"eager run {apart['eager again']:.3g}")

            checkpoint2model.main(["--exp", wip])
            split = osp.join(wip, "models", f"support_sets-{cfg['resume_to']}.pt")
            check(osp.isfile(split) and osp.isfile(
                osp.join(wip, "models", f"reconstructor-{cfg['resume_to']}.pt")),
                "checkpoint2model wrote no split files")
            os.remove(osp.join(wip, "models", "support_sets.pt"))
            S = SupportSets(cfg["k"], cfg["dipoles"], cfg["d"], learn_gammas=True)
            S.from_torch_state_dict(torch.load(split))
            trav_launches, _, t_traverse, err = traverse_and_verify(
                dict(cfg, batch=cfg["render_batch"], gif=False), wip, S)
        finally:
            os.chdir(cwd)
    last = stats[str(cfg["resume_to"])]
    print(f"[train] {name} ({' '.join(cfg['argv'])}) on {card}: {cfg['iters']} iterations in "
          f"{t1 - t0:.2f} s (generator build and first calls included), resumed at "
          f"{cfg['iters']} and ran to {cfg['resume_to']} in {t2 - t1:.2f} s; launches "
          f"{train_launches} over {n_iters} iterations ({n_counted} counted steps); last "
          f"window: total loss {last['total_loss']:.4f}, accuracy {last['accuracy']:.3f}; "
          f"moved {moved}; checkpoint2model, then traverse_latent_space of the tree: "
          f"{cfg['k'] * (2 * cfg['steps'] + 1)} frames in {t_traverse:.2f} s, launches "
          f"{trav_launches}, codes vs plain warp max abs {err:.3g}; the first run's log "
          f"windows took " + ", ".join(f"{sec:.2f}" for _, sec, _ in first.window_times)
          + " s")
    line = (f"[train] {name} through the CLI: {1e3 * first_s:.3f} ms per step = "
            f"{1 / first_s:.2f} steps/s over {first_n} iterations (log windows after the "
            f"{'first two' if graphed else 'first'}, none with a checkpoint)")
    if graphed:
        line += (f" with --steps-per-call {k} (one CUDA graph of {k} steps a call); "
                 f"{1e3 * eager_s:.3f} ms per step = {1 / eager_s:.2f} steps/s over {eager_n} "
                 f"iterations with --steps-per-call 1: the graph {eager_s / first_s:.2f}x the "
                 f"eager steps/s; its log windows before iteration {cfg['iters']} "
                 f"{apart['graphed']:.3g} from the eager run's (a second eager run "
                 f"{apart['eager again']:.3g})")
    print(line + f" on {card}")
    launches = {kname: train_launches[kname] + trav_launches[kname] for kname in train_launches}
    if not cfg.get("step_alone", True):
        return launches

    # The step alone, outside the CLI.
    state, G32 = direct_train_state(cfg)
    b = state.cfg.batch_size
    if not cfg["tail"]:
        g, chunk = graph_against_eager(state, k, steps=30, trace_steps=10)
        print(graph_text(f"{name}, batch {b}, bf16 G", k, g, card)
              + "; the kernel table of the traced replays:")
        print(g["graph"]["table"])
        del state, G32, chunk
        torch.cuda.empty_cache()
        return launches
    module, attr, plain = ((stylegan2, "fused_section", fused_section_plain)
                           if cfg["tail"] == "sg2_tail"
                           else (proggan, "proggan_tail", proggan_tail_plain))
    kernel_fn = getattr(module, attr)
    routes = {}
    try:
        for route in ("kernel", "plain", "kernel again", "plain again"):
            setattr(module, attr, plain if route.startswith("plain") else kernel_fn)
            train_step(state, 1)                      # cuDNN's first calls, the allocator
            torch.cuda.reset_peak_memory_stats()
            routes[route] = (wall_ms(lambda: train_step(state, 1), 2),
                             torch.cuda.max_memory_allocated() / 2 ** 30)
        setattr(module, attr, kernel_fn)
        g = None
        if graphed:
            g, chunk = graph_against_eager(state, k, steps=4, trace_steps=2,
                                           tag="section_kernel")
            del chunk                                 # the graph's pool
            torch.cuda.empty_cache()
            traced = g["eager"]
        else:
            traced = trace_calls(lambda: train_step(state, 1), 2, tag="section_kernel", rows=12)
        routes_read = compare_routes(
            state, G32, lambda kernel: setattr(module, attr, kernel_fn if kernel else plain))
    finally:
        setattr(module, attr, kernel_fn)
    print(f"[train step] {name}, batch {b}, bf16 G and R on {card}: untraced, in turns kernel, "
          "plain, kernel, plain: "
          + ", ".join(f"{route} {ms:.1f} ms (peak {gib:.2f} GiB)"
                      for route, (ms, gib) in routes.items())
          + f"; traced on host and device (kernel route, eager): {traced['ms']:.1f} ms per "
          f"step, device busy {100 * traced['busy']:.1f} %, {traced['kernel_ms']:.1f} ms of "
          f"kernels per step, the tail kernel {traced['tag_ms']:.2f} ms of it "
          f"({100 * traced['tag_share']:.1f} %) in {traced['tag_launches']:.0f} launches; the "
          "kernel table of the traced steps:")
    print(traced["table"])
    if g is not None:
        print(graph_text(f"{name}, batch {b}, bf16 G and R", k, g, card)
              + f"; the tail kernel {g['graph']['tag_ms']:.2f} ms a graphed step "
              f"({100 * g['graph']['tag_share']:.1f} % of its kernel time); the kernel table "
              "of the traced replays:")
        print(g["graph"]["table"])
    print(f"[train step] {name} on the kernel route and the plain tail from one state "
          f"and batch at batch {b}, deterministic algorithms, on {card}: " + routes_read)
    del state, G32
    torch.cuda.empty_cache()
    return launches


def phase_generator_sngan(card: str) -> None:
    """SNGAN-AnimeFaces at full width, random weights from a seed with its
    BatchNorm statistics and biases moved off their initial values: f32 and
    bf16 on the card against f32 on the CPU, and ms per batch."""
    import torch

    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan

    b = 64
    G = build_gan("SNGAN_AnimeFaces", allow_random_init=True, device="cuda")
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, t in list(G.named_parameters()) + list(G.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(0.6 + 0.9 * torch.rand(t.shape, generator=gen))
            elif name.endswith("bias") or name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    G16 = cast_params_bf16(G)
    z = torch.randn((b, G.dim_z), generator=gen)
    shift = 0.2 * torch.nn.functional.normalize(torch.randn((b, G.dim_z), generator=gen), dim=-1)
    with torch.no_grad():
        ref = copy.deepcopy(G).to("cpu")(z, shift)
        z, shift = z.cuda(), shift.cuda()
        img = G(z, shift)
        img16 = G16(z.bfloat16(), shift.bfloat16()).float()
        check_images(img, (b, 3, 64, 64), "SNGAN-AnimeFaces f32")
        check_images(img16, (b, 3, 64, 64), "SNGAN-AnimeFaces bf16")
        pc, p16 = psnr(img.cpu(), ref), psnr(img16.cpu(), ref)
        ms32 = cuda_ms(lambda: G(z, shift), iters=20, warmup=3)
        ms16 = cuda_ms(lambda: G16(z.bfloat16(), shift.bfloat16()), iters=20, warmup=3)
    check(pc > 40.0, f"SNGAN-AnimeFaces card f32 vs CPU f32 PSNR {pc:.2f} dB <= 40")
    # bf16 rounds every activation of five residual blocks; a sanity bound.
    check(p16 > 25.0, f"SNGAN-AnimeFaces card bf16 vs CPU f32 PSNR {p16:.2f} dB <= 25")
    print(f"[generator] SNGAN-AnimeFaces 64^2, B={b} on {card}: f32 {ms32:.3f} ms/batch, bf16 "
          f"{ms16:.3f} ms/batch; card f32 vs CPU f32 PSNR {pc:.2f} dB, card bf16 vs CPU f32 "
          f"{p16:.2f} dB")


def profile_path(card: str, cfg: dict, rows: int = 14) -> None:
    """Where one main path's time goes (``--profile``): the path run untraced
    for its wall time, under ``cProfile`` for the host's share by function, and
    under ``torch.profiler`` for the device's kernels and its busy share."""
    import cProfile
    import contextlib
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = dict(cfg, gif=False)

    def run():
        with contextlib.redirect_stdout(io.StringIO()) as out:
            t0 = time.perf_counter()
            phase_cli(card, cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return seconds, out.getvalue().strip().splitlines()[-1]

    run()                                            # builds the kernels, warms cuDNN
    seconds, line = run()
    print(f"[untraced] {seconds:.2f} s for the whole path (checks included)\n{line}")
    prof = cProfile.Profile()
    prof.enable()
    seconds_c, _ = run()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(rows + 16)
    print(f"[cProfile] {seconds_c:.2f} s\n{text.getvalue()}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        seconds_t, _ = run()
    events = tp.key_averages()
    # Kernel and copy rows only: the operator rows repeat their kernels' time.
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    attn = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and "sa_attention" in e.key]
    attn_us = sum(e.self_device_time_total for e in attn)
    # Both tails' kernels (either design) are named section_kernel.
    tails = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and "section_kernel" in e.key]
    tails_us = sum(e.self_device_time_total for e in tails)
    print(f"[torch.profiler] {seconds_t:.2f} s traced; device time of all kernels "
          f"{device_us / 1e6:.3f} s = {100 * device_us / 1e6 / seconds_t:.1f} % of the traced "
          f"wall time on {card}; the attention kernels {attn_us / 1e3:.3f} ms in "
          f"{sum(e.count for e in attn)} launches = {100 * attn_us / max(device_us, 1e-9):.1f} % "
          f"of the device time; the tail kernels {tails_us / 1e3:.3f} ms in "
          f"{sum(e.count for e in tails)} launches = {100 * tails_us / max(device_us, 1e-9):.1f} % "
          "of it")
    print(events.table(sort_by="self_cuda_time_total", row_limit=rows,
                       max_name_column_width=70))

    # The generator alone, by device kernel: f32 (sample_gan's type) and bf16
    # (the render's), B=4, three forwards each.
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan

    G = build_gan(cfg["gan"], target_classes=[239], stylegan2_resolution=cfg["res"],
                  allow_random_init=True, device="cuda")
    z = torch.randn((4, G.dim_z), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        for net, zz in ((G, z), (cast_params_bf16(G), z.bfloat16())):
            ms = cuda_ms(lambda: net(zz), iters=3, warmup=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
                for _ in range(3):
                    net(zz)
                torch.cuda.synchronize()
            print(f"[generator] {cfg['gan']} B=4 {str(zz.dtype).split('.')[-1]}: {ms:.2f} ms "
                  f"per forward on {card}; three forwards by kernel:")
            print(tp.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows,
                                          max_name_column_width=70))
        if cfg["gan"] == "ProgGAN":
            # The head blocks one by one in f32 (TF32 off): which of them the
            # f32 forward's time at B=4 sits in, and the same block at B=1.
            from warpedganspace_torch.ops.proggan_tail import block_plain

            net = G.net
            x = z[:, :, None, None]
            for i, ((_, pad, up), blk) in enumerate(zip(net.specs, net.blocks)):
                if i == net.tail_split()[0]:
                    break
                f = lambda t: block_plain(t, blk.weight, blk.bias, blk.scale,  # noqa: E731
                                          up=up, padding=pad)
                ms4 = cuda_ms(lambda: f(x), iters=3, warmup=1)
                ms1 = cuda_ms(lambda: f(x[:1]), iters=3, warmup=1)
                y = f(x)
                print(f"[block] ProgGAN head block {i}: {tuple(x.shape[1:])} -> "
                      f"{tuple(y.shape[1:])}{' up' if up else ''}, f32: B=4 {ms4:.3f} ms, "
                      f"B=1 {ms1:.3f} ms on {card}")
                x = y


def profile_train(card: str, cfg: dict, rows: int = 24) -> None:
    """Where a training step's time goes (``--profile train_biggan``): the step
    of the experiment of scripts/train/biggan.sh at full width, attention open,
    timed on the host's clock around synchronised windows, then traced by
    ``torch.profiler`` on host and device for the device's kernels, and on the
    device alone (which slows the host far less) for its busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.models.reconstructor import Reconstructor
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops import attn_cuda
    from warpedganspace_torch.train.train_step import (TrainStepConfig, init_train_state,
                                                       train_step)

    cpu_type = torch.autograd.DeviceType.CPU

    for g_dtype, r_dtype in (("bfloat16", "bfloat16"), ("float32", "float32")):
        G = open_attention(build_gan(cfg["gan"], target_classes=[239], allow_random_init=True,
                                     device="cuda"))
        gen = torch.Generator().manual_seed(0)
        S = SupportSets(cfg["k"], cfg["dipoles"], cfg["d"], learn_gammas=True, generator=gen)
        R = Reconstructor("ResNet", dim=cfg["k"], generator=gen)
        state = init_train_state(G, S, R, TrainStepConfig(
            batch_size=cfg["batch"], num_support_sets=cfg["k"], min_shift_magnitude=0.1,
            max_shift_magnitude=0.2, generator_dtype=g_dtype, reconstructor_dtype=r_dtype))
        for it in range(1, 6):
            train_step(state, it)
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for it in range(6, 6 + n):
            train_step(state, it)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        torch.cuda.reset_peak_memory_stats()
        # Three steps inside the trace before the ten that are read: the
        # tracer's own start-up falls on them, outside the marked window.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            for it in range(27, 30):
                train_step(state, it)
            torch.cuda.synchronize()
            attn_cuda.launches = attn_cuda.bwd_launches = 0
            t0 = time.perf_counter()
            with record_function("traced_window"):
                for it in range(30, 40):
                    train_step(state, it)
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        # The tracer repeats every host-side mark that holds kernels (this one,
        # the optimizers' steps) as a device-side range under the mark's name:
        # those are no kernels and are left out.
        host_names = {e.name for e in tp.events() if e.device_type == cpu_type}
        window = next(e for e in tp.events() if e.name == "traced_window"
                      and e.device_type == cpu_type).time_range
        device_events = [e for e in tp.events() if e.name not in host_names]
        kernels_us, busy_us, n_spans = device_busy(cuda_spans(device_events), window.start,
                                                   window.end)
        # The attention's forward and backward kernels (the backward's row-dot
        # prologue included) in the same window.
        attn_us, _, attn_n = device_busy(
            cuda_spans(e for e in device_events
                       if "sa_attention" in e.name or "rowdot_kernel" in e.name),
            window.start, window.end)
        window_us = window.end - window.start
        events = tp.key_averages()
        # Ten more steps with only the device traced: the host records nothing
        # per operator, so the loop is slowed less (it still is: compare the
        # printed times). Its window is from the first kernel's start to the
        # last one's end.
        with profile(activities=[ProfilerActivity.CUDA]) as tq:
            t0 = time.perf_counter()
            for it in range(40, 50):
                train_step(state, it)
            torch.cuda.synchronize()
            light_s = time.perf_counter() - t0
        light = cuda_spans(tq.events())
        check(len(light) > 0, "the device-only trace holds no device event")
        lo, hi = min(start for start, _ in light), max(end for _, end in light)
        l_kernels_us, l_busy_us, l_spans = device_busy(light, lo, hi)
        print(f"[train step] G {g_dtype}, R {r_dtype}, batch {cfg['batch']} on {card}: "
              f"{1e3 * step_s:.2f} ms per step untraced ({1 / step_s:.2f} steps/s, "
              f"{cfg['batch'] / step_s:.1f} images/s); 10 steps traced on host and device, after "
              f"3 traced warm-up steps, in {traced_s:.3f} s ({window_us / 1e6:.3f} s on the "
              f"tracer's clock) with {kernels_us / 1e6:.3f} s of device kernels and copies in "
              f"{n_spans} launches: the device was busy {100 * busy_us / window_us:.1f} % of that "
              f"window, the attention kernels {attn_us / 1e3:.3f} ms of it in {attn_n} launches "
              f"({100 * attn_us / max(kernels_us, 1e-9):.1f} % of the window's kernel time); "
              f"10 steps with only the device traced in {light_s:.3f} s "
              f"({(hi - lo) / 1e6:.3f} s from the first kernel's start to the last one's end) with "
              f"{l_kernels_us / 1e6:.3f} s of kernels and copies in {l_spans} launches: the device "
              f"was busy {100 * l_busy_us / (hi - lo):.1f} % of that window; attention launches "
              f"{attn_cuda.launches} forward, {attn_cuda.bwd_launches} backward in 20 steps; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; the table "
              "below is of the 13 steps traced on host and device (its traced_window row is the "
              "mark, no kernel)")
        print(events.table(sort_by="self_cuda_time_total", row_limit=rows,
                           max_name_column_width=80))
        del state, G, S, R


# ``--profile dp --dp-config NAME``: an experiment at full width, bf16 G and R,
# data parallel over the cards of one host, one step a call and graphed in
# chunks of ``chunk``: ``biggan`` is scripts/train/biggan.sh (global batch 32),
# ``stylegan2`` and ``proggan`` the 1024^2 experiments of ``TRAIN_PATHS``
# (global batches 12 and 8: 3 and 2 rows a card on four). ``iters`` at
# ``log_freq``: the log windows after the first (eager) or the first two
# (graphed: the warm-up, the capture) are timed. The 1024^2 experiments are
# also checked on one card first: one NCCL rank against the run without a
# group (``check``, part (b) of ``multi_device``).
DP = {"biggan": dict(iters=40, log_freq=10, batch=32, traced_steps=5, chunk=10),
      "stylegan2": dict(iters=20, log_freq=4, batch=12, traced_steps=3, chunk=2,
                        train=SG2_TRAIN),
      "proggan": dict(iters=20, log_freq=4, batch=8, traced_steps=3, chunk=2,
                      train=PROGGAN_TRAIN)}


def dp_argv(config: str, steps_per_call: int) -> list:
    """The training CLI's arguments of one ``--profile dp`` run."""
    dp = DP[config]
    if config == "biggan":
        argv = train_argv(dict(MD, batch=dp["batch"], log_freq=dp["log_freq"], ckp_freq=1000),
                          dp["iters"])
    else:
        argv = dp["train"]["argv"] + ["--log-freq", str(dp["log_freq"]), "--ckp-freq", "1000",
                                      "--max-iter", str(dp["iters"])]
    return argv + ["--multi-device", "--steps-per-call", str(steps_per_call)]


def dp_worker(run_dir: str, steps_per_call: int, config: str) -> None:
    """One rank of one ``--profile dp`` run, started by torch's launcher: the
    training CLI with ``--multi-device``, then traced eager steps of the
    trained state (every rank traces, so that all take the same steps).
    Every rank writes its peak device memory of the training run to
    ``rank<r>.json``, rank 0 also ``result.json``."""
    import contextlib
    import io

    import torch

    from warpedganspace_torch.cli import train
    from warpedganspace_torch.models import gan_load
    from warpedganspace_torch.parallel import mesh
    from warpedganspace_torch.train import trainer as trainer_module
    from warpedganspace_torch.train.train_step import train_step

    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    os.chdir(run_dir)
    if config == "biggan":
        train.build_gan = lambda **kw: open_attention(gan_load.build_gan(**kw))
    states = []
    real_train = trainer_module.Trainer.train

    def keep_state(self, *args, **kwargs):
        states.append(real_train(self, *args, **kwargs))
        return states[-1]

    trainer_module.Trainer.train = keep_state
    argv = dp_argv(config, steps_per_call)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train.main(argv)
    torch.cuda.synchronize()
    with open(osp.join(run_dir, f"rank{mesh.rank()}.json"), "w") as f:
        json.dump({"peak_gib": [torch.cuda.max_memory_allocated() / 2 ** 30,
                                torch.cuda.max_memory_reserved() / 2 ** 30]}, f)
    # The log windows after the first (one step a call) or the first two
    # (graphed: the eager warm-up, the capture), without a checkpoint.
    windows = [w for w in trainer.window_times[1 if steps_per_call == 1 else 2:] if not w[2]]
    state = states[-1]
    it = iter(range(10 ** 6, 2 * 10 ** 6))
    traced = trace_calls(lambda: train_step(state, next(it)), DP[config]["traced_steps"],
                         tag="nccl")
    if mesh.is_coordinator():
        with open(osp.join("experiments", "wip", argv_exp_name(argv), "stats.json")) as f:
            stats = json.load(f)
        result = {"step_ms": 1e3 * sum(w[1] for w in windows) / sum(w[0] for w in windows),
                  "steps_timed": sum(w[0] for w in windows), "stats": stats,
                  "traced": {k: traced[k] for k in ("ms", "busy", "kernel_ms", "tag_ms",
                                                     "tag_share", "tag_launches")}}
        with open(osp.join(run_dir, "result.json"), "w") as f:
            json.dump(result, f)
    mesh.sync_processes("profile-dp-done")


def dp_launch(cards: int, steps_per_call: int, run_dir: str, config: str = "biggan") -> dict:
    """One ``--profile dp`` run: ``cards`` processes under torch's launcher
    (``python -m torch.distributed.run``, NCCL), each this script as a
    worker. Returns rank 0's result with every rank's peak memory."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(cards),
           "--master-addr", "127.0.0.1", "--master-port", str(md_free_port()),
           osp.abspath(__file__), "--dp-run-dir", run_dir, "--dp-steps-per-call",
           str(steps_per_call), "--dp-config", config]
    root = osp.dirname(osp.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    # A session of its own, so that a run cut by the timeout takes its ranks along.
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=1200)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    check(proc.returncode == 0, f"--profile dp --dp-config {config}, {cards} card(s), "
                                f"--steps-per-call {steps_per_call}: exit {proc.returncode}\n"
                                f"{stdout[-4000:]}\n{stderr[-8000:]}")
    with open(osp.join(run_dir, "result.json")) as f:
        result = json.load(f)
    result["peak_gib"] = []
    for r in range(cards):
        with open(osp.join(run_dir, f"rank{r}.json")) as f:
            result["peak_gib"].append(json.load(f)["peak_gib"])
    return result


def dp_check(card: str, config: str) -> None:
    """One NCCL rank at full width on one card against the same run without a
    group, both graphed in chunks of ``DP[config]['chunk']`` (6 iterations:
    the warm-up, the capture, a replay), under the deterministic algorithms:
    part (b) of ``multi_device`` (``multi_device_worker``,
    ``check_one_nccl_rank``) for one experiment of ``TRAIN_PATHS``."""
    train_cfg = DP[config]["train"]
    cfg = dict(gan=train_cfg["gan"], argv=train_cfg["argv"], graph_iters=6, graph_log_freq=2,
               graph_ckp_freq=1000, chunk=DP[config]["chunk"])
    with tempfile.TemporaryDirectory(prefix="wgs_dp_check_") as tmp:
        t0 = time.perf_counter()
        (b,) = md_spawn("b", tmp, 1, cfg)
        seconds = time.perf_counter() - t0
    check_one_nccl_rank(b, cfg, {train_cfg["tail"]: 2 * train_cfg["per_forward"]})
    tr = b["traced"]
    print(f"[dp] check: 1 NCCL rank, {config} at full width (batch {DP[config]['batch']}), "
          f"--steps-per-call {cfg['chunk']}, {cfg['graph_iters']} iterations, deterministic "
          f"algorithms, against the run without a group on {card}: the same bits; "
          f"{b['dp']['step_ms']:.2f} ms per graphed step with the group against "
          f"{b['plain']['step_ms']:.2f} ms without; {b['all_reduce_calls']} all_reduce calls; "
          f"launches {b['dp']['launches']}; an eager step with the group traced: "
          f"{tr['ms']:.2f} ms, device busy {100 * tr['busy']:.1f} %, NCCL {tr['tag_ms']:.3f} ms "
          f"({100 * tr['tag_share']:.2f} %) in {tr['tag_launches']:.0f} launches; "
          f"{seconds:.1f} s", flush=True)


def profile_dp(card: str, cards: int, config: str = "biggan") -> None:
    """Data-parallel training of ``DP[config]`` on 1 card and on ``cards``,
    one step a call and graphed (``--steps-per-call DP[config]['chunk']``, a
    CUDA graph of that many steps, its collectives captured): ms per step over
    the log windows, steps/s, images/s and the speed against one card; peak
    device memory of each rank; an eager step traced on rank 0 for the NCCL
    kernels' share of the kernel time and the device's busy share; the
    statistics of ``cards`` cards against one. The 1024^2 experiments are
    checked first (``dp_check``)."""
    dp = DP[config]
    if config != "biggan":
        dp_check(card, config)
    results = {}
    with tempfile.TemporaryDirectory(prefix="wgs_dp_") as tmp:
        for k in (1, dp["chunk"]):
            for n in sorted({1, cards}):
                run_dir = osp.join(tmp, f"cards{n}_k{k}")
                os.makedirs(run_dir)
                results[n, k] = res = dp_launch(n, k, run_dir, config)
                base, tr, batch = results[1, k]["step_ms"], res["traced"], dp["batch"]
                print(f"[dp] {config}, {n} card(s), global batch {batch} ({batch // n} a card), "
                      f"--steps-per-call {k}: {res['step_ms']:.2f} ms per step over "
                      f"{res['steps_timed']} steps = {1e3 / res['step_ms']:.2f} steps/s = "
                      f"{batch * 1e3 / res['step_ms']:.1f} images/s ({base / res['step_ms']:.2f}x "
                      f"one card); peak device memory allocated / reserved by rank "
                      + ", ".join(f"{a:.2f} / {r:.2f}" for a, r in res["peak_gib"])
                      + f" GiB; an eager step traced on rank 0: {tr['ms']:.2f} ms, device "
                      f"busy {100 * tr['busy']:.1f} %, {tr['kernel_ms']:.2f} ms of kernels, "
                      f"NCCL {tr['tag_ms']:.3f} ms ({100 * tr['tag_share']:.2f} %) in "
                      f"{tr['tag_launches']:.0f} launches; on {card}", flush=True)
    for k in (1, dp["chunk"]):
        one, many = results[1, k]["stats"], results[cards, k]["stats"]
        print(f"[dp] {config}, --steps-per-call {k}: stats of {cards} cards against one, max abs "
              "difference by log window " + ", ".join(
                  f"{it}: {max(abs(many[it][m] - v) for m, v in row.items()):.3g}"
                  for it, row in one.items()))


# ``--profile dp_eval --cards N``: the evaluation chains of
# scripts/eval/stylegan2_full.sh and proggan_full.sh at full width (seeded
# random G, the fabricated predictors of ``ATTR`` and ``PROGGAN_ATTR``), on
# the scripts' pools of 6 and 8 codes sampled by ``sample_gan``, K cut to the
# first 8 and 4 of K=200 seeded sets, without ``--gif``; the ranking of each
# tree over the scripts' eight groups in their order (both scripts' order is
# ``PROGGAN_ATTR``'s), without GIFs.
DP_EVAL = {"stylegan2": dict(ATTR, k=8, sets=200, codes=6, pool="StyleGAN2_6",
                             rank_groups=PROGGAN_ATTR["rank_groups"], per_forward=2,
                             tail="sg2_tail"),
           "proggan": dict(PROGGAN_ATTR, k=4, codes=8, pool="ProgGAN_8", per_forward=3,
                           tail="proggan_tail")}
# eval_np of N cards against one: the reference oracle's gates.
DP_EVAL_RTOL, DP_EVAL_ATOL = 1e-2, 2e-3
# Scores whose integer part is an argmax: (argmax + max probability) / n.
ARGMAX_N = {"age": 9, "race": 7, "celeba_bangs": 6, "celeba_eyeglasses": 6,
            "celeba_beard": 6, "celeba_smiling": 6, "celeba_age": 6}


def dp_eval_argv(cfg: dict, stage: str) -> list:
    """The script's arguments of ``stage`` (``traverse``; ``attribute``, whose
    arguments the ranking takes too)."""
    argv = ["--exp", osp.join("experiments", "complete", "smoke_exp"), "--pool", cfg["pool"],
            "--shift-steps", str(cfg["steps"]), "--eps", str(cfg["eps"])]
    if stage == "traverse":
        argv += ["--batch-size", str(cfg["batch"]), "--dtype", "bfloat16"]
    return argv


def dp_eval_worker(root: str, stage: str, chain: str) -> None:
    """One process of a ``--profile dp_eval`` stage, a plain process or a rank
    under torch's launcher (then with ``--multi-device``): the stage's CLI in
    ``root``, its render batches or paths counted, its own time (the CLI
    from its start to its end; its work up to the last batch written or path
    evaluated), the coordinator's gather and writes timed, and the kernels'
    launches. Writes ``<stage>.<rank>.json`` in ``root``."""
    import torch

    from warpedganspace_torch.cli import traverse_attribute_space as attr_cli
    from warpedganspace_torch.cli import traverse_latent_space as trav_cli
    from warpedganspace_torch.parallel import mesh
    from warpedganspace_torch.traverse import engine

    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    os.chdir(root)
    cfg = DP_EVAL[chain]
    grouped = mesh.initialize_distributed()
    counts, spans = {"batches": 0, "paths": 0}, {"gather": 0.0, "write": 0.0, "barrier": 0.0}
    done = [None]
    real = {"render": engine._render_u8, "path": attr_cli.evaluate_path,
            "codes": trav_cli._traverse_codes, "gather": mesh.gather_to_coordinator,
            "write": attr_cli.write_hash_outputs, "barrier": mesh.sync_processes}

    def render(*args, **kwargs):
        counts["batches"] += 1
        return real["render"](*args, **kwargs)

    def path(*args, **kwargs):
        counts["paths"] += 1
        out = real["path"](*args, **kwargs)
        done[0] = time.perf_counter()
        return out

    def traverse_codes(*args, **kwargs):
        real["codes"](*args, **kwargs)                # the writer is closed when it returns
        done[0] = time.perf_counter()

    def timed(name):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spans[name] += time.perf_counter() - t
        return run

    engine._render_u8, attr_cli.evaluate_path = render, path
    trav_cli._traverse_codes = traverse_codes
    mesh.gather_to_coordinator, attr_cli.write_hash_outputs = timed("gather"), timed("write")
    mesh.sync_processes = timed("barrier")
    cli = trav_cli if stage == "traverse" else attr_cli
    reset_launch_counts()
    epoch0, t0 = time.time(), time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(dp_eval_argv(cfg, stage) + (["--multi-device"] if grouped else []))
    torch.cuda.synchronize()
    report = dict(counts, rank=mesh.rank(), world=mesh.world_size(),
                  cli_s=time.perf_counter() - t0,
                  work_s=(done[0] or time.perf_counter()) - t0, launches=launch_counts(),
                  gather_s=spans["gather"], write_s=spans["write"], barrier_s=spans["barrier"],
                  cli_epoch=(epoch0, time.time()),
                  host_threads=mesh.host_threads(), torch_threads=torch.get_num_threads())
    with open(osp.join(root, f"{stage}.{mesh.rank()}.json"), "w") as f:
        json.dump(report, f)
    if grouped:
        torch.distributed.destroy_process_group()


def dp_eval_launch(root: str, stage: str, chain: str, cards: int, launcher: bool) -> dict:
    """One stage in ``root``: a plain process on the first card, or with
    ``launcher`` ``cards`` ranks under ``python -m torch.distributed.run``
    (NCCL, one card each). Each process's torch threads are the host's cores
    over the processes. Returns the wall time and every process's report."""
    import signal

    worker = [osp.abspath(__file__), "--dp-eval-run", root, "--dp-eval-stage", stage,
              "--dp-eval-chain", chain]
    cmd = [sys.executable] + (["-m", "torch.distributed.run", "--nproc-per-node", str(cards),
                               "--master-addr", "127.0.0.1", "--master-port",
                               str(md_free_port())] if launcher else []) + worker
    here = osp.dirname(osp.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // cards)))
    epoch0, t0 = time.time(), time.perf_counter()
    # A session of its own, so that a run cut by the timeout takes its ranks along.
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    wall, epoch1 = time.perf_counter() - t0, time.time()
    check(proc.returncode == 0, f"--profile dp_eval, {chain} {stage} on {cards} card(s): exit "
                                f"{proc.returncode}\n{stdout[-4000:]}\n{stderr[-8000:]}")
    reports = []
    for r in range(cards):
        with open(osp.join(root, f"{stage}.{r}.json")) as f:
            reports.append(json.load(f))
        os.remove(osp.join(root, f"{stage}.{r}.json"))
    # Outside the CLI: from the launch to the first process's entry into the
    # CLI (Python, torch, the launcher, the group), and from the last one's
    # exit from it to the end of the launch (the group's and processes' end).
    return {"wall_s": wall, "ranks": reports,
            "start_s": min(r["cli_epoch"][0] for r in reports) - epoch0,
            "end_s": epoch1 - max(r["cli_epoch"][1] for r in reports)}


def dp_eval_files(root: str) -> dict:
    """{path relative to ``root``: full path} of every file under ``root``."""
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            out[osp.relpath(osp.join(dirpath, f), root)] = osp.join(dirpath, f)
    return out


def dp_eval_compare(one: str, many: str) -> dict:
    """Hold the results tree of N cards (``many``) to one card's (``one``):
    the same files; frames byte-equal, else within 2 grey levels (which rule
    held is returned); stored codes within 1e-4; every ``eval_np`` array at
    the oracle's gates with the same argmaxes, and every ``eval_json`` file
    byte-equal in a hash dir whose ``eval_np`` arrays are bit-equal; the
    ranking CSVs byte-equal."""
    import numpy as np
    import torch
    from PIL import Image

    a, b = dp_eval_files(one), dp_eval_files(many)
    check(sorted(a) == sorted(b), f"dp_eval: the trees differ in their files: "
                                  f"{sorted(set(a) ^ set(b))[:10]}")

    def same_bytes(rel):
        with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
            return fa.read() == fb.read()

    frames = [rel for rel in a if rel.endswith(".jpg")]
    differ = [rel for rel in frames if not same_bytes(rel)]
    grey = 0
    for rel in differ:
        fa, fb = (np.asarray(Image.open(p[rel]), dtype=np.int16) for p in (a, b))
        grey = max(grey, int(np.abs(fa - fb).max()))
    check(grey <= 2, f"dp_eval: frames differ by {grey} grey levels")
    code_err, code_bits = 0.0, True
    for rel in (r for r in a if r.endswith("paths_latent_codes.pt")):
        ca, cb = (torch.load(p[rel]).numpy() for p in (a, b))
        code_err, code_bits = max(code_err, float(np.abs(ca - cb).max())), (
            code_bits and np.array_equal(ca, cb))
    check(code_err <= 1e-4, f"dp_eval: stored codes differ by {code_err:.3g}")
    np_err, np_bits, json_checked = 0.0, 0, 0
    hashes = sorted({osp.dirname(osp.dirname(rel)) for rel in a if "eval_np" in rel})
    for h in hashes:
        bits = True
        for rel in (r for r in a if r.startswith(h + os.sep + "eval_np" + os.sep)):
            xa, xb = np.load(a[rel]), np.load(b[rel])
            name = osp.basename(rel)[:-4]
            check(xa.shape == xb.shape and bool(np.isfinite(xb).all()),
                  f"dp_eval: {rel} shape {xb.shape}")
            check(bool(np.allclose(xb, xa, rtol=DP_EVAL_RTOL, atol=DP_EVAL_ATOL)),
                  f"dp_eval: {rel} differs by {float(np.abs(xa - xb).max()):.3g}")
            if name in ARGMAX_N:
                check(np.array_equal(np.floor(xa * ARGMAX_N[name]),
                                     np.floor(xb * ARGMAX_N[name])), f"dp_eval: {rel} argmaxes")
            np_err = max(np_err, float(np.abs(xa - xb).max()))
            bits = bits and np.array_equal(xa, xb)
        np_bits += bits
        if bits:
            for rel in (r for r in a if r.startswith(h + os.sep + "eval_json" + os.sep)):
                check(same_bytes(rel), f"dp_eval: {rel} differs where eval_np is bit-equal")
                json_checked += 1
    csvs = [rel for rel in a if rel.endswith(".csv")]
    check(csvs and all(same_bytes(rel) for rel in csvs),
          f"dp_eval: the ranking CSVs differ: {[r for r in csvs if not same_bytes(r)][:5]}")
    return {"files": len(a), "frames": len(frames), "frames_differ": len(differ),
            "grey": grey, "codes_err": code_err, "codes_bit_equal": code_bits,
            "eval_np_err": np_err, "hashes": len(hashes), "hashes_bit_equal": np_bits,
            "json_checked": json_checked, "csvs": len(csvs)}


def dp_eval_chain(card: str, cards: int, chain: str) -> None:
    """One chain of ``DP_EVAL``: the pool and the experiment once, then the
    traversal and the attribute stage on one card (plain processes) and on
    ``cards`` (ranks under torch's launcher, ``--multi-device``), the
    ranking of each tree on the host, and the trees held to each other
    (:func:`dp_eval_compare`); every rank's share of render batches and
    paths within one of the others', and each process's kernel launches."""
    import shutil

    import torch

    from warpedganspace_torch.cli import rank_interpretable_paths as rank
    from warpedganspace_torch.cli import sample_gan
    from warpedganspace_torch.cli import traverse_attribute_space as attr_cli
    from warpedganspace_torch.evalzoo.fabricate import predictor_state_dicts, write_pretrained
    from warpedganspace_torch.parallel import mesh

    cfg = DP_EVAL[chain]
    k, codes, steps, batch = cfg["k"], cfg["codes"], cfg["steps"], cfg["batch"]
    T = 2 * steps + 1
    per_code = math.ceil(k * T / batch)
    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    cwd = os.getcwd()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="wgs_dp_eval_") as tmp:
        roots = {n: osp.join(tmp, f"cards{n}") for n in ("one", "many")}
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            os.makedirs(roots["one"])
            os.chdir(roots["one"])
            fabricated_experiment(cfg)
            with contextlib.redirect_stdout(io.StringIO()):
                sample_gan.main(["-g", cfg["gan"], "--num-samples", str(codes), "--pool",
                                 cfg["pool"]])
            torch.cuda.empty_cache()
            os.chdir(tmp)
            shutil.copytree(roots["one"], roots["many"])
            t_setup = time.perf_counter() - t0
            for stage in ("traverse", "attribute"):
                for n, launcher in (("one", False), ("many", True)):
                    runs[stage, n] = dp_eval_launch(roots[n], stage, chain,
                                                    cards if launcher else 1, launcher)
                if stage == "traverse":
                    # The predictor files, the detector's heads fitted to the
                    # first code's first path.
                    res = osp.join(roots["one"], "experiments", "complete", "smoke_exp",
                                   "results", cfg["pool"],
                                   f"{2 * steps}_{cfg['eps']}_{round(2 * steps * cfg['eps'], 3)}")
                    first = sorted(h for h in os.listdir(res) if h not in attr_cli.NOT_HASHES)[0]
                    calib = attr_cli._prep_path(osp.join(res, first, "paths_images", "path_000"),
                                                cfg["gan"])[0]
                    sds = predictor_state_dicts(seed=0, calibration=calib, device="cuda")
                    for root in roots.values():
                        write_pretrained(root, sds)
                    del sds
                    torch.cuda.empty_cache()
            rank_s = {}
            for n, root in roots.items():
                os.chdir(root)
                argv = dp_eval_argv(cfg, "attribute") + RANK_FLAGS
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    for group in cfg["rank_groups"]:
                        rank.main(argv + [f"--attr-group={group}", "--no-gif"])
                rank_s[n] = time.perf_counter() - t1
                os.chdir(tmp)
            t2 = time.perf_counter()
            cmp = dp_eval_compare(osp.join(roots["one"], "experiments"),
                                  osp.join(roots["many"], "experiments"))
            t_cmp = time.perf_counter() - t2
        finally:
            os.chdir(cwd)

    # Shares and launches: every rank's block within one unit of the
    # others', the blocks summing to the work; the warp once a step on every
    # process, the tail ``per_forward`` times a render batch.
    units = {"traverse": ("batches", codes * per_code), "attribute": ("paths", codes * k)}
    for (stage, n), run in runs.items():
        key, total = units[stage]
        shares = [rep[key] for rep in run["ranks"]]
        check(sum(shares) == total and max(shares) - min(shares) <= (1 if n == "many" else 0),
              f"dp_eval {chain} {stage} on {len(shares)} card(s): {key} by rank {shares}, "
              f"{total} in all")
        check([rep["rank"] for rep in run["ranks"]] == list(range(len(shares))),
              f"dp_eval {chain} {stage}: ranks {[rep['rank'] for rep in run['ranks']]}")
        for rep in run["ranks"]:
            want = dict.fromkeys(rep["launches"], 0)
            if stage == "traverse":
                want.update(rbf_warp=steps, **{cfg["tail"]: cfg["per_forward"] * rep["batches"]})
            check(rep["launches"] == want, f"dp_eval {chain} {stage}, rank {rep['rank']} of "
                                           f"{len(shares)}: launches {rep['launches']}, not "
                                           f"{want}")

    def stage_text(stage):
        one, many = runs[stage, "one"], runs[stage, "many"]
        key = units[stage][0]
        ranks = many["ranks"]
        coord = ranks[0]
        cli_one, cli_many = one["ranks"][0]["cli_s"], max(r["cli_s"] for r in ranks)
        return (f"{stage} {one['wall_s']:.2f} s on 1 card, {many['wall_s']:.2f} s on "
                f"{len(ranks)} ({one['wall_s'] / many['wall_s']:.2f}x; outside the CLI, "
                f"the processes' start and end: {one['wall_s'] - cli_one:.2f} s as a plain "
                f"process ({one['start_s']:.2f} + {one['end_s']:.2f}), "
                f"{many['wall_s'] - cli_many:.2f} s under the launcher ({many['start_s']:.2f} + "
                f"{many['end_s']:.2f}); the ranks' barriers "
                + ", ".join(f"{r['barrier_s']:.2f}" for r in ranks) + " s); the CLI "
                f"{cli_one:.2f} s on 1 card against {cli_many:.2f} s on {len(ranks)} "
                f"({cli_one / cli_many:.2f}x; 1 card's work {one['ranks'][0]['work_s']:.2f}"
                f" s), by rank " + ", ".join(f"{r['cli_s']:.2f}" for r in ranks)
                + " s (work " + ", ".join(f"{r['work_s']:.2f}" for r in ranks)
                + f" s; {key} " + ", ".join(str(r[key]) for r in ranks)
                + f"; host threads {coord['host_threads']}, torch threads "
                f"{coord['torch_threads']} a rank)"
                + (f"; the coordinator's gather {coord['gather_s']:.3f} s and writes "
                   f"{coord['write_s']:.3f} s (1 card: writes {one['ranks'][0]['write_s']:.3f} s)"
                   if stage == "attribute" else ""))

    busiest = math.ceil(codes / cards)
    print(f"[dp_eval] {chain} ({cfg['script']}: {cfg['gan']}-{cfg['res']}, pool {cfg['pool']} "
          f"of {codes} codes, K={k} of {cfg['sets']} sets, {T} frames a path, bf16 render "
          f"batch {batch}: {codes * k} paths, {codes * k * T} frames, {codes * per_code} render "
          f"batches) on {cards} x {card}, os.cpu_count() {os.cpu_count()}: "
          + "; ".join(stage_text(st) for st in ("traverse", "attribute"))
          + f"; ranking over {len(cfg['rank_groups'])} groups without GIFs "
          + " / ".join(f"{rank_s[n]:.2f}" for n in ("one", "many"))
          + f" s; the old whole-code split's bound: {busiest} codes on the busiest rank "
          f"against {codes / cards:.2f}, at most {codes / busiest:.2f}x; set-up "
          f"{t_setup:.1f} s", flush=True)
    print(f"[dp_eval] {chain}, {cards} cards against 1: {cmp['files']} files the same; "
          f"frames {cmp['frames'] - cmp['frames_differ']} of {cmp['frames']} byte-equal"
          + (f", the rest within {cmp['grey']} grey levels (rule: 2 grey levels)"
             if cmp["frames_differ"] else " (rule: bytes)")
          + f"; stored codes {'bit-equal' if cmp['codes_bit_equal'] else 'max abs '}"
          + ("" if cmp["codes_bit_equal"] else f"{cmp['codes_err']:.3g}")
          + f"; eval_np max abs {cmp['eval_np_err']:.3g} (gates rtol {DP_EVAL_RTOL}, atol "
          f"{DP_EVAL_ATOL}, argmaxes equal), bit-equal in {cmp['hashes_bit_equal']} of "
          f"{cmp['hashes']} hash dirs, {cmp['json_checked']} eval_json files byte-equal there; "
          f"{cmp['csvs']} ranking CSVs byte-equal; compared in {t_cmp:.1f} s", flush=True)


def profile_dp_eval(card: str, cards: int, chains) -> None:
    """``--profile dp_eval``: the kernels built once (the workers load them),
    then each chain of ``chains`` on one card and on ``cards``."""
    build_kernels()
    for chain in chains:
        dp_eval_chain(card, cards, chain)


def start_builds(pool, cuda_cores: bool = False) -> dict:
    """Start building every kernel source on ``pool``, one ``nvcc`` per source;
    with ``cuda_cores`` also the warp's and the f32 attention's CUDA-core
    designs, which the tensor-core designs replaced. Returns {source: future}."""
    from warpedganspace_torch.ops import (_build, attn_cuda, attn_cuda_cores, proggan_tail_cuda,
                                          rbf_cuda, rbf_cuda_cores, sg2_tail_cuda)

    builds = {rbf_cuda.SOURCE: rbf_cuda.build, attn_cuda.SOURCE: attn_cuda.build,
              attn_cuda.BWD_SOURCE: attn_cuda.build_bwd,
              proggan_tail_cuda.SOURCE: proggan_tail_cuda.build,
              sg2_tail_cuda.SOURCE: sg2_tail_cuda.build}
    if cuda_cores:
        for cc_source in (rbf_cuda_cores.SOURCE, attn_cuda_cores.SOURCE,
                          attn_cuda_cores.BWD_SOURCE):
            builds[cc_source] = lambda src=cc_source: _build.load_library(src)
    return {src: pool.submit(build) for src, build in builds.items()}


def build_line(futures: dict, seconds: float) -> str:
    from warpedganspace_torch.ops import _build

    return (f"[build] {', '.join(futures)} side by side: {seconds:.2f} s (nvcc "
            + ", ".join(f"{_build.build_seconds.get(src, 0.0):.2f} s" for src in futures)
            + "; 0 = already built)")


def build_kernels(cuda_cores: bool = False) -> None:
    """Build every kernel source, all started together, and wait for them."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futures = start_builds(pool, cuda_cores)
        for f in futures.values():
            f.result()
    print(build_line(futures, time.perf_counter() - t0))


def profile_cuda_cores(card: str) -> None:
    """The kernel phases with the CUDA-core designs that the tensor-core designs
    replaced built and timed beside them, in turns."""
    build_kernels(cuda_cores=True)
    for phase in (phase_warp_kernel, phase_sg2_tail_kernel, phase_tail_kernel, phase_attn_kernel,
                  phase_attn_bwd_kernel):
        phase(card, cuda_cores=True)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA card.")
    parser.add_argument("--profile", choices=tuple(PATHS) + ("train_biggan", "attribute", "dp",
                                                              "dp_eval", "cuda_cores"),
                        help="instead of the smoke test, say where that main path's time goes "
                             "(dp: data-parallel training on 1 card and on --cards; dp_eval: "
                             "the evaluation chains on 1 card and on --cards; cuda_cores: "
                             "the kernels beside the CUDA-core designs they replaced)")
    parser.add_argument("--steps", type=int, default=None,
                        help="with --profile of a traversal: steps each way (default: the "
                             "smoke test's)")
    parser.add_argument("--cards", type=int, default=None,
                        help="with --profile dp or dp_eval: the cards of the data-parallel run "
                             "(default: every card of the host)")
    parser.add_argument("--dp-config", choices=tuple(DP), default="biggan",
                        help="with --profile dp: the experiment (biggan: scripts/train/"
                             "biggan.sh; stylegan2, proggan: the 1024^2 experiments)")
    parser.add_argument("--dp-eval-chain", choices=tuple(DP_EVAL), default=None,
                        help="with --profile dp_eval: one chain only (default: both)")
    parser.add_argument("--dp-eval-run", help=argparse.SUPPRESS)
    parser.add_argument("--dp-eval-stage", choices=("traverse", "attribute"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--dp-run-dir", help=argparse.SUPPRESS)
    parser.add_argument("--dp-steps-per-call", type=int, default=1, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dp_run_dir:                       # a rank of --profile dp, under torch's launcher
        dp_worker(args.dp_run_dir, args.dp_steps_per_call, args.dp_config)
        return 0
    if args.dp_eval_run:                      # a process of --profile dp_eval
        dp_eval_worker(args.dp_eval_run, args.dp_eval_stage, args.dp_eval_chain)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.profile:
        card = card_line()
        print(card)
        if args.profile == "dp":
            print(f"{torch.cuda.device_count()} x {card}; torch {torch.__version__}")
            profile_dp(card, args.cards or torch.cuda.device_count(), args.dp_config)
        elif args.profile == "dp_eval":
            print(f"{torch.cuda.device_count()} x {card}; torch {torch.__version__}")
            profile_dp_eval(card, args.cards or torch.cuda.device_count(),
                            [args.dp_eval_chain] if args.dp_eval_chain else list(DP_EVAL))
        elif args.profile == "train_biggan":
            profile_train(card, TRAIN)
        elif args.profile == "attribute":
            phase_attribute_stage(card, profile_rows=24, warm_runs=3)
        elif args.profile == "cuda_cores":
            profile_cuda_cores(card)
        else:
            cfg = PATHS[args.profile]
            profile_path(card, cfg if args.steps is None else dict(cfg, steps=args.steps))
        return 0

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    print(card)

    seconds = {}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(card, *args)
        seconds[name] = time.perf_counter() - t
        return out

    # Each kernel, generator and CLI phase runs as soon as the sources it needs
    # are built, while the others still compile: the attention backward's nvcc
    # takes the longest, so its phases come last (the kernels are timed with
    # CUDA events; a launch bound by the host's Python may read slower while
    # nvcc shares its cores).
    attn, bwd = "sa_attention.cu", "sa_attention_bwd.cu"
    early = (("rbf_warp", phase_warp_kernel, (), ("rbf_warp.cu",)),
             ("sg2_tail", phase_sg2_tail_kernel, (), ("sg2_tail.cu",)),
             ("proggan_tail", phase_tail_kernel, (), ("proggan_tail.cu",)),
             ("sa_attention", phase_attn_kernel, (), (attn,)),
             ("generator_stylegan2", phase_generator_stylegan2, (), ("sg2_tail.cu",)),
             ("generator_biggan", phase_generator_biggan, (), (attn,)),
             ("generator_proggan", phase_generator_proggan, (), ("proggan_tail.cu",)),
             ("generator_sngan", phase_generator_sngan, (), ()),
             ("cli_stylegan2", phase_cli, (SG2,), ("rbf_warp.cu", "sg2_tail.cu")),
             ("cli_biggan", phase_cli, (BIGGAN,), ("rbf_warp.cu", attn)),
             ("cli_proggan", phase_cli, (PROGGAN,), ("rbf_warp.cu", "proggan_tail.cu")),
             ("sa_attention_bwd", phase_attn_bwd_kernel, (), (attn, bwd)),
             ("generator_biggan_grad", phase_generator_biggan_grad, (torch.float32,), (attn, bwd)),
             ("generator_biggan_grad_bf16", phase_generator_biggan_grad, (torch.bfloat16,),
              (attn, bwd)))
    t0 = time.perf_counter()
    early_res = {}
    with ThreadPoolExecutor(8) as pool:
        futures = start_builds(pool)
        for phase_name, phase, args, sources in early:
            for src in sources:
                futures[src].result()
            early_res[phase_name] = timed(phase_name, phase, *args)
    # "build": the time spent waiting for nvcc beside those phases.
    seconds["build"] = time.perf_counter() - t0 - sum(seconds.values())
    print(build_line(futures, time.perf_counter() - t0) + " with the kernel, generator and "
          f"CLI phases, {seconds['build']:.2f} s of it waiting for nvcc")
    warp, attn, attn_bwd, tail, sg2_tail = (early_res[k] for k in (
        "rbf_warp", "sa_attention", "sa_attention_bwd", "proggan_tail", "sg2_tail"))
    paths = {name: early_res[f"cli_{name}"] for name in PATHS}
    for path, cfg in ATTR_PATHS.items():
        paths[path] = timed(path, phase_attribute_stage, cfg)
    paths["train_biggan"] = timed("train_biggan", phase_train, TRAIN)
    for path, cfg in TRAIN_PATHS.items():
        paths[path] = timed(path, phase_train_path, path, cfg)
    paths["multi_device"] = timed("multi_device", phase_multi_device)
    paths["discriminators"], attn_d = timed("discriminators", phase_discriminators)

    def row(kname, source, replaces, k):
        by_path = {p: launches.get(kname, 0) for p, launches in paths.items()}
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms"), "shape": k["shape"],
                "ms_bf16": k["ms_bf16"], "plain_ms_bf16": k["plain_ms_bf16"],
                "design": k.get("design", {"float32": "CUDA cores", "bfloat16": "CUDA cores"})}

    kernels = [row("rbf_warp", "warpedganspace_torch/csrc/rbf_warp.cu",
                   "warpedganspace_tpu/ops/rbf_pallas.py:108", warp),
               row("sa_attention", "warpedganspace_torch/csrc/sa_attention.cu",
                   "warpedganspace_tpu/ops/attn_pallas.py:30", attn)]
    for key in ("bound_ms_bf16", "bound_by_bf16", "cuda_cores_ms", "cuda_cores_ms_bf16",
                "cuda_core_ops_ms", "shapes", "audit"):
        kernels[0][key] = warp[key]
    for key in ("library_ms_bf16", "ms_render_bf16", "plain_ms_render_bf16",
                "library_ms_render_bf16", "bound_ms_bf16", "bound_by_bf16",
                "bound_ms_render_bf16", "cc_ms", "bound_ms_cuda_cores", "f32_shapes",
                "audit_bf16"):
        kernels[1][key] = attn[key]
    for key, value in attn_d.items():
        kernels[1][key + "_discriminator"] = value
    kernels.append(row("sa_attention_bwd", "warpedganspace_torch/csrc/sa_attention_bwd.cu",
                       "warpedganspace_tpu/ops/attn_pallas.py:106", attn_bwd))
    for key in ("library_ms_bf16", "bound_ms_bf16", "bound_by_bf16", "max_abs_errs", "err_is",
                "cc_ms", "bound_ms_cuda_cores", "audit_bf16"):
        kernels[2][key] = attn_bwd[key]
    kernels.append(row("proggan_tail", "warpedganspace_torch/csrc/proggan_tail.cu",
                       "warpedganspace_tpu/ops/proggan_tail_pallas.py:173", tail))
    for key in ("ms_render_bf16", "plain_ms_render_bf16", "bound_ms_bf16", "bound_by_bf16",
                "bound_ms_render_bf16", "sections", "max_abs_errs", "cc_ms",
                "bound_ms_cuda_cores", "ms_b1", "plain_ms_b1", "cc_ms_b1", "bound_ms_b1",
                "bound_ms_cuda_cores_b1"):
        kernels[3][key] = tail[key]
    kernels.append(row("sg2_tail", "warpedganspace_torch/csrc/sg2_tail.cu",
                       "warpedganspace_tpu/ops/sg2_tail_pallas.py:315", sg2_tail))
    for key in ("ms_render_bf16", "plain_ms_render_bf16", "bound_ms_bf16", "bound_by_bf16",
                "bound_ms_render_bf16", "sections", "max_abs_errs", "cc_ms",
                "bound_ms_cuda_cores", "ms_b1", "plain_ms_b1", "cc_ms_b1", "bound_ms_b1",
                "bound_ms_cuda_cores_b1"):
        kernels[4][key] = sg2_tail[key]
    print(f"[total] {time.perf_counter() - t_start:.1f} s; by phase: "
          + ", ".join(f"{name} {sec:.1f} s" for name, sec in seconds.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
