"""Where the bf16 tensor-core attention kernels spend their time, on the card.

Builds variants of the port's ``csrc/sa_attention.cu`` and
``csrc/sa_attention_bwd.cu``, each with one part of the bf16 design taken out
or changed by a textual edit of the source (every edit must apply exactly
once), and times each with CUDA events at BigGAN-128's shapes (N=4096,
M=1024, dk=24, dv=96; the forward at B=16 and at the render batch B=64, the
backward at the training batch B=32), in turns with the shipped design. A
variant that takes a part out computes wrong values: it measures time only.
The shipped backward is also traced by ``torch.profiler`` for the time of
each of its three launches (row-dot prologue, query pass, key pass).

    PYTHONPATH=. python scripts/ablate_attention_cuda.py

Needs an NVIDIA card and ``nvcc``; imports no JAX. Prints the card's name and
power limit and one line per variant.
"""
from __future__ import annotations

import ctypes
import os
import os.path as osp
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from warpedganspace_torch.ops import _build, attn_cuda

SHAPE = (4096, 1024, 24, 96)            # N, M, dk, dv
FWD_B, RENDER_B, BWD_B = 16, 64, 32
OUT_DIR = osp.join(osp.dirname(_build.BUILD_DIR), "ablate")

# Textual edits of the tensor-core designs: (old, new), each applied once.
NO_FETCH = [("    if (c + 1 < nchunks) fetch(c + 1);   // into the buffer no warp reads in this chunk\n", ""),
            ("  fetch(0);\n  cp_async_commit();\n", "  cp_async_commit();\n")]
FWD_NO_EXP = [(f"const float p{i} = ex2(fmaf(", f"const float p{i} = (fmaf(") for i in range(4)]
FWD_NO_LOGITS = [("      if (kk < ks) {\n", "      if (false) {\n")]
FWD_NO_VALUES = [("        if (2 * vp < vn) {\n", "        if (false) {\n")]
BWD_NO_EXP = [("p[e] = valid ? ex2(fmaf(s[j][e], kLog2e, -l)) : 0.f;",
               "p[e] = valid ? fmaf(s[j][e], kLog2e, -l) : 0.f;")]
BWD_NO_S_DP = [("for (int kk = 0; kk < ks1; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {"),
               ("for (int kk = 0; kk < ks2; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")]
BWD_NO_OUTPUTS = [("          if (2 * np < nt1) {\n", "          if (false) {\n"),
                  ("            if (2 * np < nt2) {\n", "            if (false) {\n")]
FWD_WARPS4 = [("constexpr int kWarps = 8;\nconstexpr int kThreads = kWarps * 32;\n"
               "constexpr int kTileRows = kWarps * 16;",
               "constexpr int kWarps = 4;\nconstexpr int kThreads = kWarps * 32;\n"
               "constexpr int kTileRows = kWarps * 16;")]
BWD_WARPS4 = [("constexpr int kWarps = 8;\nconstexpr int kThreads = kWarps * 32;\n"
               "constexpr int kTileRows = kWarps * 16;",
               "constexpr int kWarps = 4;\nconstexpr int kThreads = kWarps * 32;\n"
               "constexpr int kTileRows = kWarps * 16;")]
BWD_QUERY64 = [("constexpr int kQueryStep = 32;", "constexpr int kQueryStep = 64;")]
BWD_KEY32 = [("constexpr int kKeyStep = 64;", "constexpr int kKeyStep = 32;")]
BWD_MIN3 = [("__global__ void __launch_bounds__(kThreads)\nsa_attention_bwd_tc_kernel",
             "__global__ void __launch_bounds__(kThreads, 3)\nsa_attention_bwd_tc_kernel")]

FWD_VARIANTS = {
    "shipped": ([], []),
    "no exponentials": (FWD_NO_EXP, []),
    "no logits product": (FWD_NO_LOGITS, []),
    "no value product": (FWD_NO_VALUES, []),
    "no chunk staging": (NO_FETCH, []),
    "staging and softmax only": (FWD_NO_EXP + FWD_NO_LOGITS + FWD_NO_VALUES, []),
    "4 warps, 64 queries a block": (FWD_WARPS4, []),
}
BWD_VARIANTS = {
    "shipped": ([], []),
    "no exponentials": (BWD_NO_EXP, []),
    "no s and dbeta products": (BWD_NO_S_DP, []),
    "no output products": (BWD_NO_OUTPUTS, []),
    "no chunk staging": (NO_FETCH, []),
    "staging and elementwise only": (BWD_NO_EXP + BWD_NO_S_DP + BWD_NO_OUTPUTS, []),
    "4 warps, 64 rows a block": (BWD_WARPS4, []),
    "query pass in steps of 64 columns": (BWD_QUERY64, []),
    "key pass in steps of 32 columns": (BWD_KEY32, []),
    "key pass in steps of 32, at least 3 blocks an SM": (BWD_KEY32 + BWD_MIN3, []),
}


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once ({text.count(old)}): {old!r}")
        text = text.replace(old, new)
    return text


def _build_variant(source: str, name: str, edits, header_edits) -> tuple[str, str]:
    """Write the edited source and header into their own directory, compile,
    return (library path, the compiler's register report)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    d = osp.join(OUT_DIR, osp.splitext(source)[0], tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(osp.join(_build.CSRC_DIR, source)) as f:
        text = _edit(f.read(), edits)
    with open(osp.join(d, source), "w") as f:
        f.write(text)
    with open(osp.join(_build.CSRC_DIR, "tc_bf16.cuh")) as f:
        header = _edit(f.read(), header_edits)
    with open(osp.join(d, "tc_bf16.cuh"), "w") as f:
        f.write(header)
    lib = osp.join(d, "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, osp.join(d, source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} / {name}:\n{proc.stderr}")
    return lib, proc.stderr


def _registers(report: str, kernel: str, tmpl: str) -> str:
    """The registers ptxas reports for the instantiation whose mangled name
    holds ``kernel`` and ``tmpl``."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line and tmpl in line:
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt:
                    return nxt.split("Used")[1].split(",")[0].strip()
    return "?"


def cuda_ms(fn, iters=30, warmup=3) -> float:
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


def _inputs(b, seed=2):
    n, m, dk, dv = SHAPE
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((b, n, dk), generator=gen)
    phi = torch.randn((b, m, dk), generator=gen)
    g = torch.rand((b, m, dv), generator=gen) * 2 - 1
    ct = torch.randn((b, n, dv), generator=gen)
    return tuple(t.to(device="cuda", dtype=torch.bfloat16) for t in (theta, phi, g, ct))


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_attention_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    jobs = [("sa_attention.cu", k, *v) for k, v in FWD_VARIANTS.items()]
    jobs += [("sa_attention_bwd.cu", k, *v) for k, v in BWD_VARIANTS.items()]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        built = list(pool.map(lambda j: _build_variant(*j), jobs))
    libs = {}
    for (source, name, *_), (path, report) in zip(jobs, built):
        lib = ctypes.CDLL(path)
        if source == "sa_attention.cu":
            fn = lib.sa_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            regs = _registers(report, "sa_attention_tc_kernel", "ILi2ELi12E")
        else:
            fn = lib.sa_attention_bwd_launch
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            regs = (f"query pass {_registers(report, 'bwd_tc_kernel', 'ILb0ELi4ELi2E')}, "
                    f"key pass {_registers(report, 'bwd_tc_kernel', 'ILb1ELi4ELi12E')}")
        fn.restype = ctypes.c_int
        libs[(source, name)] = (fn, regs)

    n, m, dk, dv = SHAPE
    stream = torch.cuda.current_stream().cuda_stream

    def fwd_call(fn, ops, out):
        theta, phi, g = ops[:3]
        return lambda: fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(), None,
                          1, theta.shape[0], n, m, dk, dv, stream)

    for b in (FWD_B, RENDER_B):
        ops = _inputs(b)
        out = torch.empty((b, n, dv), device="cuda", dtype=torch.bfloat16)
        names = list(FWD_VARIANTS) + ["shipped"]          # the shipped design first and last
        times = {}
        for name in names:
            fn, regs = libs[("sa_attention.cu", name)]
            call = fwd_call(fn, ops, out)
            if call() != 0:
                raise RuntimeError(f"forward variant {name!r} failed to launch")
            times.setdefault(name, []).append(cuda_ms(call))
        for name in FWD_VARIANTS:
            ts = times[name]
            print(f"[forward B={b}] {name}: {sum(ts) / len(ts):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in ts)}); registers "
                  f"{libs[('sa_attention.cu', name)][1]}; on {card}")

    theta, phi, g, ct = _inputs(BWD_B)
    out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    rdot = torch.empty((BWD_B, n), device="cuda", dtype=torch.float32)
    grads = [torch.empty_like(t) for t in (theta, phi, g)]

    def bwd_call(fn):
        return lambda: fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                          ct.data_ptr(), lse.data_ptr(), rdot.data_ptr(),
                          *(t.data_ptr() for t in grads), 1, BWD_B, n, m, dk, dv, stream)

    times = {}
    for name in list(BWD_VARIANTS) + ["shipped"]:
        fn, _ = libs[("sa_attention_bwd.cu", name)]
        call = bwd_call(fn)
        if call() != 0:
            raise RuntimeError(f"backward variant {name!r} failed to launch")
        times.setdefault(name, []).append(cuda_ms(call, iters=10))
    for name in BWD_VARIANTS:
        ts = times[name]
        print(f"[backward B={BWD_B}] {name}: {sum(ts) / len(ts):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in ts)}); registers "
              f"{libs[('sa_attention_bwd.cu', name)][1]}; on {card}")

    # The shipped backward's three launches, by kernel.
    from torch.profiler import ProfilerActivity, profile

    call = bwd_call(libs[("sa_attention_bwd.cu", "shipped")][0])
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            print(f"[backward B={BWD_B} by launch] {e.key[:90]}: "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms x {e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
