"""Where the tensor-core attention kernels spend their time, on the card.

Builds variants of the port's ``csrc/sa_attention.cu`` and
``csrc/sa_attention_bwd.cu``, each with one part of a design taken out or
changed by a textual edit of the source or its headers (every edit must apply
exactly once, so an edit of the sources can break it), and times each with
CUDA events in turns with the shipped design (shipped first and last):

- bf16 (``--only bf16``): the bf16 design at BigGAN-128's shapes (N=4096,
  M=1024, dk=24, dv=96; the forward at B=16 and at the render batch B=64, the
  backward at the training batch B=32); the shipped backward is also traced by
  ``torch.profiler`` for the time of each of its three launches (row-dot
  prologue, query pass, key pass);
- f32 (``--only f32``): the split-precision (3xTF32) design at the forward's
  B=16 and BigGAN-128 D's operands (B=64, dk=12, dv=48) and the backward's
  B=32, without its chunk staging, its split into records (or, in the
  backward, the records themselves), its lo products (one TF32 product: wrong
  beyond the f32 bounds), its accumulators' flushes, its exponentials, its
  products; beside them the CUDA-core design it replaced, built from its own
  sources (``warpedganspace_torch/ops/attn_cuda_cores.py``).

A variant that takes a part out computes wrong values: it measures time only.

    PYTHONPATH=. python scripts/ablate_attention_cuda.py [--only f32|bf16]

Needs an NVIDIA card and ``nvcc``; imports no JAX. Prints the card's name and
power limit and one line per variant.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import os.path as osp
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from warpedganspace_torch.ops import _build, attn_cuda, attn_cuda_cores

SHAPE = (4096, 1024, 24, 96)            # N, M, dk, dv
D_SHAPE = (4096, 1024, 12, 48)          # BigGAN-128 D's attention (D_ch=96)
FWD_B, RENDER_B, BWD_B, D_B = 16, 64, 32, 64
OUT_DIR = osp.join(osp.dirname(_build.BUILD_DIR), "ablate")
HEADERS = ("tc_bf16.cuh", "tc_tf32.cuh")

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

# Textual edits of the f32 (split-precision) designs.
TF_NO_LO = [("    if (t < nt) mma1688(d[t], a.lo, b[t].x, b[t].y);\n", "    if (t < nt) {}\n"),
            ("    if (t < nt) mma1688(d[t], a.hi, b[t].z, b[t].w);\n",
             "    if (t < nt) {}\n")]   # tc_tf32.cuh
TF_NO_FLUSH = [("constexpr int kFlushChunks = 4;",
                "constexpr int kFlushChunks = 1 << 30;")]   # tc_tf32.cuh
TF_FWD_NO_FETCH = [("    if (c + 1 < nchunks) fetch_chunk(c + 1);", ""),
                   ("  fetch_chunk(0);\n", "")]
TF_FWD_NO_EXP = [(f"const float w{i} = ex2(fmaf(", f"const float w{i} = (fmaf(") for i in range(4)]
TF_FWD_NO_SPLIT = [("    split_chunk();\n", "")]
TF_FWD_NO_LOGITS = [("        mma3_records<8>(s, a, bq, 8);\n", "        ;\n"),
                    ("        mma3_records_add<8>(s, a, bq, 8);\n", "        ;\n")]
TF_FWD_NO_VALUES = [("      mma3_records<NV>(o, pa, bv, vn);\n", "")]
TF_FWD_MIN2 = [("__global__ void __launch_bounds__(kThreads)\nsa_attention_tf_kernel",
                "__global__ void __launch_bounds__(kThreads, 2)\nsa_attention_tf_kernel")]
TF_BWD_NO_FETCH = [("      if (c + 1 < nchunks) fetch_chunk(c + 1);   // in flight while",
                    "      // in flight while"),
                   ("  fetch_chunk(0);\n", "")]
TF_BWD_NO_SPLIT = [("      split_chunk();\n", "")]
TF_BWD_NO_RECORDS = [("  const bool rec = dk <= 32 && dv <= 96 && "
                      "smem_bytes_rec(dk, dv) <= (size_t)kSmemBytes;", "  const bool rec = false;")]
TF_BWD_NO_EXP = [("beta[e] = valid ? ex2(fmaf(s[j][e], kLog2e, -l)) : 0.f;",
                  "beta[e] = valid ? fmaf(s[j][e], kLog2e, -l) : 0.f;")]
TF_BWD_NO_S_DP = [("for (int k8 = 0; k8 < ks1; ++k8) {", "for (int k8 = 0; k8 < 0; ++k8) {"),
                  ("for (int k8 = 0; k8 < ks2; ++k8) {", "for (int k8 = 0; k8 < 0; ++k8) {")]
TF_BWD_NO_OUTPUTS = [("          mma3_records<NT1>(acc1, da, c0, nt1);\n", ""),
                     ("            mma3_records<NT2>(acc2, pa, e0, nt2);\n", "")]

# bf16: name -> (source edits, header edits).
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

# f32: name -> (source edits, header edits).
TF_FWD_VARIANTS = {
    "shipped": ([], []),
    "no chunk staging": (TF_FWD_NO_FETCH, []),
    "no record split (records of nothing)": (TF_FWD_NO_SPLIT, []),
    "no lo products (one TF32 product)": ([], TF_NO_LO),
    "no flushes (one accumulator chain over all keys)": ([], TF_NO_FLUSH),
    "no exponentials": (TF_FWD_NO_EXP, []),
    "no logits product": (TF_FWD_NO_LOGITS, []),
    "no value product": (TF_FWD_NO_VALUES, []),
    "staging and softmax only": (TF_FWD_NO_EXP + TF_FWD_NO_LOGITS + TF_FWD_NO_VALUES, []),
    "at least 2 blocks an SM": (TF_FWD_MIN2, []),
}
TF_BWD_VARIANTS = {
    "shipped": ([], []),
    "no chunk staging": (TF_BWD_NO_FETCH, []),
    "no records (every warp splits what it reads)": (TF_BWD_NO_RECORDS, []),
    "no record split (records of nothing)": (TF_BWD_NO_SPLIT, []),
    "no lo products (one TF32 product)": ([], TF_NO_LO),
    "no flushes (one accumulator chain over all columns)": ([], TF_NO_FLUSH),
    "no exponentials": (TF_BWD_NO_EXP, []),
    "no s and dbeta products": (TF_BWD_NO_S_DP, []),
    "no output products": (TF_BWD_NO_OUTPUTS, []),
    "staging and elementwise only": (TF_BWD_NO_EXP + TF_BWD_NO_S_DP + TF_BWD_NO_OUTPUTS, []),
}
CC = "CUDA-core design (cc entry)"
def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once ({text.count(old)}): {old!r}")
        text = text.replace(old, new)
    return text


def _build_variant(source: str, name: str, edits, header_edits) -> tuple[str, str]:
    """Write the edited source and headers into their own directory, compile,
    return (library path, the compiler's register report)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    d = osp.join(OUT_DIR, osp.splitext(source)[0], tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(osp.join(_build.CSRC_DIR, source)) as f:
        text = _edit(f.read(), edits)
    with open(osp.join(d, source), "w") as f:
        f.write(text)
    for name in HEADERS:   # the header edits apply to one of them, once
        with open(osp.join(_build.CSRC_DIR, name)) as f:
            header = f.read()
        if header_edits and header_edits[0][0] in header:
            header = _edit(header, header_edits)
        with open(osp.join(d, name), "w") as f:
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


def _inputs(b, dtype=torch.bfloat16, shape=SHAPE, seed=2):
    n, m, dk, dv = shape
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((b, n, dk), generator=gen)
    phi = torch.randn((b, m, dk), generator=gen)
    g = torch.rand((b, m, dv), generator=gen) * 2 - 1
    ct = torch.randn((b, n, dv), generator=gen)
    return tuple(t.to(device="cuda", dtype=dtype) for t in (theta, phi, g, ct))


def _fwd_fn(lib):
    fn = lib.sa_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn(lib):
    fn = lib.sa_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _time_in_turns(calls: dict, iters: int) -> dict:
    """Each call once in order, the first ("shipped") again at the end: ms per variant."""
    times = {}
    for name in list(calls) + [next(iter(calls))]:
        times.setdefault(name, []).append(cuda_ms(calls[name], iters=iters))
    return times


def _report(tag: str, times: dict, regs: dict, card: str) -> None:
    for name, ts in times.items():
        print(f"[{tag}] {name}: {sum(ts) / len(ts):.4f} ms ({', '.join(f'{t:.4f}' for t in ts)})"
              f"; registers {regs.get(name, '-')}; on {card}")


def _forward_calls(fns: dict, b: int, dtype, shape, with_cc: bool) -> dict:
    """Launch closures of every forward variant (and the CUDA-core entry) at one shape."""
    theta, phi, g, _ = _inputs(b, dtype, shape)
    n, m, dk, dv = shape
    out = torch.empty((b, n, dv), device="cuda", dtype=dtype)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(dtype == torch.bfloat16)
    calls = {}
    for name, fn in fns.items():
        def call(fn=fn):
            return fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(), None, bf16,
                      b, n, m, dk, dv, stream)
        if call() != 0:
            raise RuntimeError(f"forward variant {name!r} failed to launch")
        calls[name] = call
    if with_cc:
        calls[CC] = lambda: attn_cuda_cores.cc_forward(theta, phi, g)
    return calls


def _backward_calls(fns: dict, dtype, with_cc: bool):
    """Launch closures of every backward variant (and the CUDA-core entry) at B=32."""
    theta, phi, g, ct = _inputs(BWD_B, dtype)
    n, m, dk, dv = SHAPE
    out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    rdot = torch.empty((BWD_B, n), device="cuda", dtype=torch.float32)
    grads = [torch.empty_like(t) for t in (theta, phi, g)]
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(dtype == torch.bfloat16)
    calls = {}
    for name, fn in fns.items():
        def call(fn=fn):
            return fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                      ct.data_ptr(), lse.data_ptr(), rdot.data_ptr(),
                      *(t.data_ptr() for t in grads), bf16, BWD_B, n, m, dk, dv, stream)
        if call() != 0:
            raise RuntimeError(f"backward variant {name!r} failed to launch")
        calls[name] = call
    if with_cc:
        calls[CC] = lambda: attn_cuda_cores.cc_backward(theta, phi, g, out, lse, ct)
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("f32", "bf16"), default=None,
                    help="ablate one dtype's designs (default: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_attention_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sets = {"bf16": (FWD_VARIANTS, BWD_VARIANTS), "f32": (TF_FWD_VARIANTS, TF_BWD_VARIANTS)}
    dtypes = [args.only] if args.only else ["bf16", "f32"]
    jobs = []
    for dt in dtypes:
        fwd, bwd = sets[dt]
        jobs += [("sa_attention.cu", dt, k, *v) for k, v in fwd.items()]
        jobs += [("sa_attention_bwd.cu", dt, k, *v) for k, v in bwd.items()]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        built = list(pool.map(lambda j: _build_variant(j[0], f"{j[1]} {j[2]}", *j[3:]), jobs))
    fns = {(source, dt): {} for source in ("sa_attention.cu", "sa_attention_bwd.cu")
           for dt in dtypes}
    regs = {(source, dt): {} for source, dt in fns}
    for (source, dt, name, *_), (path, report) in zip(jobs, built):
        lib = ctypes.CDLL(path)
        if source == "sa_attention.cu":
            fns[(source, dt)][name] = _fwd_fn(lib)
            regs[(source, dt)][name] = (
                _registers(report, "sa_attention_tc_kernel", "ILi2ELi12E") if dt == "bf16"
                else _registers(report, "sa_attention_tf_kernel", "ILi4ELi12E"))
        else:
            fns[(source, dt)][name] = _bwd_fn(lib)
            kernel = "bwd_tc_kernel" if dt == "bf16" else "bwd_tf_kernel"
            # f32: the instantiations with records, which the timed shape takes.
            q_tmpl = "ILb0ELi4ELi2E" if dt == "bf16" else "ILb0ELi4ELi1ELb1E"
            k_tmpl = "ILb1ELi4ELi12E" if dt == "bf16" else "ILb1ELi4ELi12ELb1E"
            regs[(source, dt)][name] = (
                f"query pass {_registers(report, kernel, q_tmpl)}, "
                f"key pass {_registers(report, kernel, k_tmpl)}")

    for dt in dtypes:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        f32 = dt == "f32"
        shapes = ([(FWD_B, SHAPE), (D_B, D_SHAPE)] if f32 else [(FWD_B, SHAPE), (RENDER_B, SHAPE)])
        for b, shape in shapes:
            calls = _forward_calls(fns[("sa_attention.cu", dt)], b, dtype, shape, with_cc=f32)
            _report(f"{dt} forward B={b} dk={shape[2]} dv={shape[3]}", _time_in_turns(calls, 30),
                    regs[("sa_attention.cu", dt)], card)
        calls = _backward_calls(fns[("sa_attention_bwd.cu", dt)], dtype, with_cc=f32)
        _report(f"{dt} backward B={BWD_B}", _time_in_turns(calls, 10),
                regs[("sa_attention_bwd.cu", dt)], card)

        # The shipped backward's three launches, by kernel.
        from torch.profiler import ProfilerActivity, profile

        call = calls["shipped"]
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                print(f"[{dt} backward B={BWD_B} by launch] {e.key[:90]}: "
                      f"{e.self_device_time_total / e.count / 1e3:.4f} ms x {e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
