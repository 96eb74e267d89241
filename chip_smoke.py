"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Five phases, each of which must pass; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name and power limit;
2. build: the CUDA warp kernel, compiled from ``warpedganspace_torch/csrc``;
3. kernel: the warp kernel against its plain PyTorch version at the
   production shape (K=200 sets, 2N=1024 support vectors, d=512, R=64 rows =
   32 codes x +-) in f32 and with bf16 set storage, and at the traversal's own
   shape below; both timed with CUDA events;
4. generator: StyleGAN2-1024 in W space with random weights from a seed, B=4,
   f32 and bf16, and f32 on the card against f32 on the CPU;
5. the port's main path through its CLIs: ``sample_gan`` makes a one-code
   pool, then ``traverse_latent_space`` walks a K=8, D=512 W-space experiment
   for 20 steps each way at bf16 and writes the 8 x 41-frame tree and GIFs.
   The warp kernel's launch count is reset just before and must show at least
   one launch per step; the stored codes are checked against the plain warp.

Runs with TF32 off (f32 comparisons). Needs no network. Imports no JAX.
Prints the card's name and power limit, then one JSON line with each kernel's
launches, error and times, then, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

K_PROD, N_DIP, D, ROWS = 200, 512, 512, 64   # production warp shape
K_SMOKE, STEPS, EPS, BATCH = 8, 20, 0.2, 16   # the traversal the CLI runs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def phase_kernel(card: str) -> dict:
    import torch

    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops import rbf_cuda

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    S = SupportSets(K_PROD, N_DIP, D, learn_gammas=True, generator=gen).to(dev)
    z = torch.randn((K_PROD, ROWS, D), generator=gen).to(dev)        # |z| ~ sqrt(d)
    res = {}
    with torch.no_grad():
        ws = rbf_cuda.prepare_warp_sets(S.support_sets, S.alphas, S.gammas())
        ws16 = rbf_cuda.prepare_warp_sets(S.support_sets, S.alphas, S.gammas(), torch.bfloat16)
        before = rbf_cuda.launches
        out = rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")
        ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
        out16 = rbf_cuda.warp_grad_all_sets_kn(ws16, z, backend="cuda")
        ref16 = rbf_cuda._torch_kn(ws16.sv, ws16.g, ws16.ag, ws16.svsq, z)
        torch.cuda.synchronize()
        check(rbf_cuda.launches == before + 2, "the warp kernel's launch count did not move")
        check(bool(torch.isfinite(out).all()), "non-finite kernel output")
        # Unit vectors; f32 sums over 2N=1024 terms in another order.
        err = float((out - ref).abs().max())
        check(err <= 1e-4, f"f32 kernel vs plain max abs {err:.3g} > 1e-4")
        err16 = float((out16 - ref16).abs().max())
        check(err16 <= 1e-4, f"bf16-storage kernel vs plain max abs {err16:.3g} > 1e-4")
        cos16 = float((out16 * out).sum(-1).mean())
        # bf16 set storage against f32: the bound of tests/test_rbf_pallas.py.
        check(cos16 > 0.999, f"bf16 vs f32 mean cosine {cos16:.6f} <= 0.999")

        # The traversal's own shape: K=8 sets, one code x +- = 2 rows.
        zs = torch.randn((K_SMOKE, 2, D), generator=gen).to(dev)
        ws8 = rbf_cuda.prepare_warp_sets(S.support_sets[:K_SMOKE], S.alphas[:K_SMOKE],
                                         S.gammas()[:K_SMOKE])
        err8 = float((rbf_cuda.warp_grad_all_sets_kn(ws8, zs, backend="cuda")
                      - rbf_cuda._torch_kn(ws8.sv, ws8.g, ws8.ag, ws8.svsq, zs)).abs().max())
        check(err8 <= 1e-4, f"kernel vs plain at the traversal shape: max abs {err8:.3g}")

        # Plain, kernel, kernel, plain: one card, in turns.
        kern = lambda: rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")  # noqa: E731
        plain = lambda: rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)  # noqa: E731
        kern16 = lambda: rbf_cuda.warp_grad_all_sets_kn(ws16, z, backend="cuda")  # noqa: E731
        plain16 = lambda: rbf_cuda._torch_kn(ws16.sv, ws16.g, ws16.ag, ws16.svsq, z)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        q1, j1, j2, q2 = cuda_ms(plain16), cuda_ms(kern16), cuda_ms(kern16), cuda_ms(plain16)
    res = {"max_abs_err": err, "max_abs_err_bf16": err16, "cos_bf16_vs_f32": cos16,
           "max_abs_err_traversal_shape": err8,
           "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "ms_bf16": (j1 + j2) / 2, "plain_ms_bf16": (q1 + q2) / 2}
    print(f"[kernel] rbf_warp K={K_PROD} 2N={2 * N_DIP} d={D} R={ROWS} on {card}: "
          f"f32 kernel {res['ms']:.4f} ms ({k1:.4f}, {k2:.4f}) plain {res['plain_ms']:.4f} ms "
          f"({p1:.4f}, {p2:.4f}); bf16 sets kernel {res['ms_bf16']:.4f} ms "
          f"plain {res['plain_ms_bf16']:.4f} ms; max abs err f32 {err:.3g}, "
          f"bf16 {err16:.3g}, traversal shape {err8:.3g}; bf16-vs-f32 cos {cos16:.6f}")
    return res


def phase_generator(card: str) -> None:
    import torch

    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.gan_load import build_gan

    G = build_gan("StyleGAN2", stylegan2_resolution=1024, shift_in_w_space=True,
                  allow_random_init=True, device="cuda")
    G16 = cast_params_bf16(G)
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        w = G.get_w(z)
        shift = 0.2 * torch.nn.functional.normalize(torch.randn_like(w), dim=-1)
        img = G(w, shift, latent_is_w=True)
        img16 = G16(w.bfloat16(), shift.bfloat16(), latent_is_w=True).float()
        torch.cuda.synchronize()
        for name, x in (("f32", img), ("bf16", img16)):
            check(tuple(x.shape) == (4, 3, 1024, 1024), f"{name} image shape {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"non-finite {name} image")
            check(float(x.std()) > 0, f"constant {name} image")
        p16 = psnr(img16, img)
        ms32 = cuda_ms(lambda: G(w, shift, latent_is_w=True), iters=5, warmup=1)
        ms16 = cuda_ms(lambda: G16(w.bfloat16(), shift.bfloat16(), latent_is_w=True),
                       iters=5, warmup=1)
        # The card's f32 against the CPU's f32 on the same weights (TF32 off).
        Gc = build_gan("StyleGAN2", stylegan2_resolution=1024, shift_in_w_space=True,
                       allow_random_init=True, device="cpu")
        pc = psnr(img[:1].cpu(), Gc(w[:1].cpu(), shift[:1].cpu(), latent_is_w=True))
    check(pc > 40.0, f"card f32 vs CPU f32 PSNR {pc:.2f} dB <= 40")
    print(f"[generator] StyleGAN2-1024 W, B=4 on {card}: f32 {ms32:.2f} ms/batch, "
          f"bf16 {ms16:.2f} ms/batch; bf16-vs-f32 PSNR {p16:.2f} dB; "
          f"card-vs-CPU f32 PSNR {pc:.2f} dB")


def phase_cli(card: str) -> int:
    import numpy as np
    import torch
    from PIL import Image

    from warpedganspace_torch.cli import sample_gan, traverse_latent_space
    from warpedganspace_torch.models.gan_load import build_gan
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops import rbf_cuda
    from warpedganspace_torch.traverse.engine import traverse_paths

    os.environ["WGS_ALLOW_RANDOM_G"] = "1"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wgs_smoke_") as tmp:
        os.chdir(tmp)
        try:
            exp = osp.join("experiments", "complete", "smoke_exp")
            os.makedirs(osp.join(exp, "models"))
            S = SupportSets(K_SMOKE, N_DIP, D, learn_gammas=True,
                            generator=torch.Generator().manual_seed(0))
            torch.save(S.to_torch_state_dict(), osp.join(exp, "models", "support_sets.pt"))
            with open(osp.join(exp, "args.json"), "w") as f:
                json.dump({"gan_type": "StyleGAN2", "num_support_sets": K_SMOKE,
                           "num_support_dipoles": N_DIP, "learn_alphas": False,
                           "learn_gammas": True, "gamma": None, "shift_in_w_space": True,
                           "stylegan2_resolution": 1024}, f)

            rbf_cuda.launches = 0  # count only the main path's launches
            t0 = time.perf_counter()
            sample_gan.main(["-g", "StyleGAN2", "--num-samples", "1", "--pool", "smoke"])
            t1 = time.perf_counter()
            traverse_latent_space.main([
                "--exp", exp, "--pool", "smoke", "--shift-steps", str(STEPS),
                "--eps", str(EPS), "--batch-size", str(BATCH), "--dtype", "bfloat16", "--gif"])
            t2 = time.perf_counter()
            launches = rbf_cuda.launches

            n_frames = 2 * STEPS + 1
            out_dir = osp.join(exp, "results", "smoke",
                               f"{2 * STEPS}_{EPS}_{round(2 * STEPS * EPS, 3)}")
            hashes = sorted(d for d in os.listdir(out_dir) if d != "paths_gifs")
            check(len(hashes) == 1, f"expected one latent code dir, got {hashes}")
            code_dir = osp.join(out_dir, hashes[0])
            jpgs = [osp.join(code_dir, "paths_images", f"path_{k:03d}", f"{t:06d}.jpg")
                    for k in range(K_SMOKE) for t in range(n_frames)]
            check(all(osp.isfile(p) for p in jpgs), "missing traversal frames")
            check(osp.isfile(osp.join(code_dir, "original_image.jpg")), "no original_image.jpg")
            gifs = [osp.join(out_dir, "paths_gifs", f"path_{k:03d}.gif") for k in range(K_SMOKE)]
            check(all(osp.isfile(p) for p in gifs), "missing GIFs")
            codes = torch.load(osp.join(code_dir, "paths_latent_codes.pt")).numpy()
            check(codes.shape == (K_SMOKE, n_frames, D), f"codes shape {codes.shape}")
            check(bool(np.isfinite(codes).all()), "non-finite latent codes")
            first = np.asarray(Image.open(jpgs[0]), dtype=np.float32)
            last = np.asarray(Image.open(jpgs[n_frames - 1]), dtype=np.float32)
            check(first.shape == (1024, 1024, 3), f"frame shape {first.shape}")
            check(first.std() > 0 and float(np.abs(first - last).mean()) > 0,
                  "constant or unchanging frames")
            check(launches >= STEPS, f"warp kernel launched {launches} times, < {STEPS} steps")

            # The stored codes against the plain warp on the same code and sets.
            z = torch.load(osp.join("experiments", "latent_codes", "StyleGAN2", "smoke",
                                    hashes[0], "latent_code.pt")).cuda()
            G = build_gan("StyleGAN2", stylegan2_resolution=1024, shift_in_w_space=True,
                          device="cuda")
            with torch.no_grad():
                ref, _ = traverse_paths(S.cuda(), G.get_w(z), EPS, STEPS, backend="torch")
            err = float(np.abs(codes - ref[0].cpu().numpy()).max())
            # 20 f32 steps of unit directions, the kernel's sums in another order.
            check(err <= 1e-3, f"traversal codes vs plain warp max abs {err:.3g}")
        finally:
            os.chdir(cwd)
    n = K_SMOKE * n_frames
    print(f"[cli] sample_gan {t1 - t0:.2f} s; traverse_latent_space K={K_SMOKE} "
          f"steps={STEPS} bf16 batch {BATCH}: {n} frames + {K_SMOKE} GIFs in {t2 - t1:.2f} s "
          f"({n / (t2 - t1):.2f} frames/s, JPEG and GIF writing included) on {card}; "
          f"warp launches {launches}; codes vs plain warp max abs {err:.3g}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from warpedganspace_torch.ops import _build, rbf_cuda

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    print(card)

    t0 = time.perf_counter()
    rbf_cuda.build()
    print(f"[build] {rbf_cuda.SOURCE}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds.get(rbf_cuda.SOURCE, 0.0):.2f} s; 0 = already built)")

    k = phase_kernel(card)
    phase_generator(card)
    launches = phase_cli(card)

    kernels = [{"name": "rbf_warp", "route": "cuda",
                "source": "warpedganspace_torch/csrc/rbf_warp.cu",
                "replaces": "warpedganspace_tpu/ops/rbf_pallas.py:108",
                "launches": launches, "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "shape": f"K={K_PROD} 2N={2 * N_DIP} d={D} R={ROWS} f32",
                "ms_bf16": k["ms_bf16"], "plain_ms_bf16": k["plain_ms_bf16"]}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
