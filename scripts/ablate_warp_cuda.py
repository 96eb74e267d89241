"""Where the tensor-core warp kernel spends its time, on the card.

Builds variants of the port's ``csrc/rbf_warp.cu``, each with one part of the
design taken out or changed by a textual edit of the source or of
``csrc/tc_bf16.cuh`` (every edit must apply as often as it says), and the
CUDA-core design it replaced (``csrc/rbf_warp_cuda_cores.cu``), and times
each with CUDA events in turns with the shipped kernel at the shapes the
traversals give the warp (``SHAPES``), with f32 and bf16 sets. A variant that
takes a part out computes wrong values: it measures time only.

    PYTHONPATH=. python scripts/ablate_warp_cuda.py

Needs an NVIDIA card and ``nvcc``; imports no JAX. Prints the card's name and
power limit, the registers of each variant and one line per variant and
shape. The CUDA-core design's binding, the shapes and the cost of a call are
:mod:`warpedganspace_torch.ops.rbf_cuda_cores`'s, which ``chip_smoke.py``
shares.
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

from warpedganspace_torch.ops import _build, rbf_cuda
from warpedganspace_torch.ops.rbf_cuda_cores import SHAPES, cuda_cores, warp_cost

OUT_DIR = osp.join(osp.dirname(_build.BUILD_DIR), "ablate", "rbf_warp")

# NVIDIA H100 SXM data sheet: memory rate, bf16 tensor-core rate (the unit the
# design's products run on).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


# Textual edits: (old, new, times it must occur).
NO_STAGING = [("    if (i < nc) fetch(i);\n", "", 1),
              ("    if (it + kStages - 1 < nc) fetch(it + kStages - 1);\n", "", 1)]
NO_REDUCE = [("  rbf_warp_reduce_kernel<<<(unsigned)((total + kReduceWarps - 1) / kReduceWarps),\n"
              "                           kReduceWarps * 32, 0, stream>>>(part, z, out, k, rows, d, "
              "splits);\n", "", 1)]
ONE_PRODUCT = [("          tc::mma16816(s[m][0], za_lo[m][i], bh[0], bh[1]);\n", "", 1),
               ("          tc::mma16816(s[m][1], za_lo[m][i], bh[2], bh[3]);\n", "", 1),
               ("          tc::mma16816(acc[m][i][0], wa_lo[m], bh[0], bh[1]);\n", "", 1),
               ("          tc::mma16816(acc[m][i][1], wa_lo[m], bh[2], bh[3]);\n", "", 1),
               ("        if constexpr (F32) {\n          uint32_t bl[4];",
                "        if constexpr (false) {\n          uint32_t bl[4];", 2)]
NO_PRODUCTS_HEADER = [('      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "\n'
                       '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n', '      ""\n', 1)]
STAGES4 = [("constexpr int kStages = 3; ", "constexpr int kStages = 4; ", 1)]

# name -> (source edits, header edits); "one run of 2N" is a plan, not an edit.
VARIANTS = {
    "shipped": ([], []),
    "no products": ([], NO_PRODUCTS_HEADER),
    "no sv staging": (NO_STAGING, []),
    "no reduction kernel": (NO_REDUCE, []),
    "one bf16 product a pass (no lo pieces)": (ONE_PRODUCT, []),
    "ring of 4 stages": (STAGES4, []),
}
# Plans other than the wrapper's, for the shipped kernel: name -> plan(shipped plan, K, 2N, R).
PLAN_VARIANTS = {
    "one run of 2N (no split)": lambda p, k, n2, rows: rbf_cuda.Plan(
        p.tile_rows, p.row_tiles, 1, max(1, -(-n2 // rbf_cuda.CHUNK))),
    "16-row tiles": lambda p, k, n2, rows: rbf_cuda.Plan(
        16, -(-rows // 16), p.splits, p.chunks_per_split),
    "32-row tiles": lambda p, k, n2, rows: rbf_cuda.Plan(
        32, -(-rows // 32), p.splits, p.chunks_per_split),
}


def _edit(text: str, edits) -> str:
    for old, new, times in edits:
        if text.count(old) != times:
            raise RuntimeError(f"edit does not apply {times}x ({text.count(old)}): {old!r}")
        text = text.replace(old, new)
    return text


def _build_variant(name: str, edits, header_edits) -> tuple[str, str]:
    """Write the edited source and header into their own directory, compile,
    return (library path, the compiler's register report)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    d = osp.join(OUT_DIR, tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(osp.join(_build.CSRC_DIR, rbf_cuda.SOURCE)) as f:
        text = _edit(f.read(), edits)
    with open(osp.join(d, rbf_cuda.SOURCE), "w") as f:
        f.write(text)
    with open(osp.join(_build.CSRC_DIR, "tc_bf16.cuh")) as f:
        header = _edit(f.read(), header_edits)
    with open(osp.join(d, "tc_bf16.cuh"), "w") as f:
        f.write(header)
    lib = osp.join(d, "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           osp.join(d, rbf_cuda.SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    return lib, proc.stderr


def _registers(report: str) -> str:
    """Registers of the four tensor-core instantiations, as ptxas reports them."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "rbf_warp_tc_kernel" in line:
            tmpl = line.split("rbf_warp_tc_kernel")[1][:12]
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt:
                    out.append(f"{tmpl}: {nxt.split('Used')[1].split(',')[0].strip()}")
    return "; ".join(out) or "?"


def _bind(lib: ctypes.CDLL):
    fn = lib.rbf_warp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rbf_warp_slots.argtypes = [ctypes.c_int] * 3
    lib.rbf_warp_slots.restype = ctypes.c_int
    return lib


def _runner(lib, ws, z, replan=None):
    """A call of a variant library on (ws, z) with the wrapper's plan."""
    k, n2, d = ws.sv.shape
    rows = z.shape[1]
    bf16 = ws.sv.dtype == torch.bfloat16
    p = rbf_cuda.plan(k, n2, rows, d, lambda t: lib.rbf_warp_slots(t, int(bf16), d),
                      ws.sv.element_size())
    if replan is not None:
        p = replan(p, k, n2, rows)
    out = torch.empty_like(z)
    part = torch.empty(p.scratch_floats(k, rows, d), device=z.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (ws.sv.data_ptr(), int(bf16), ws.g.data_ptr(), ws.ag.data_ptr(), ws.svsq.data_ptr(),
            z.data_ptr(), out.data_ptr(), part.data_ptr(), k, n2, rows, d, p.tile_rows,
            p.splits, p.chunks_per_split, stream)

    def call():
        err = lib.rbf_warp_launch(*args)
        if err != 0:
            raise RuntimeError(f"warp variant launch failed: cudaError {err}")
        return out
    return call, p


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


def warp_inputs(k, n2, d, rows, seed=0):
    """Sets as the init makes them (dipoles, radii in [1, 4), gamma 1/d) and
    codes of |z| ~ sqrt(d), made on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    half = torch.randn((k, n2 // 2, d), generator=gen, device="cuda")
    sv = torch.stack([half, -half], dim=2).reshape(k, n2, d)
    radii = 1.0 + 3.0 / k * torch.arange(k, device="cuda", dtype=torch.float32)
    sv = radii[:, None, None] * sv / torch.linalg.vector_norm(sv, dim=-1, keepdim=True)
    a = torch.tensor([1.0, -1.0], device="cuda").repeat(n2 // 2).expand(k, n2)
    g = torch.full((k, n2), 1.0 / d, device="cuda")
    z = torch.randn((k, rows, d), generator=gen, device="cuda")
    return sv, a, g, z


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_warp_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        cc = pool.submit(cuda_cores)
        built = dict(zip(VARIANTS, pool.map(lambda kv: _build_variant(kv[0], *kv[1]),
                                             VARIANTS.items())))
        cc_run = cc.result()
    libs = {}
    for name, (path, report) in built.items():
        libs[name] = _bind(ctypes.CDLL(path))
        print(f"[registers] {name}: {_registers(report)}")

    for label, k, n2, d, rows in SHAPES:
        sv, a, g, z = warp_inputs(k, n2, d, rows)
        for dtype in (torch.float32, torch.bfloat16):
            ws = rbf_cuda.prepare_warp_sets(sv, a, g, None if dtype == torch.float32 else dtype)
            calls = {name: _runner(lib, ws, z)[0] for name, lib in libs.items()}
            for name, replan in PLAN_VARIANTS.items():
                calls[name] = _runner(libs["shipped"], ws, z, replan)[0]
            calls["CUDA-core design"] = lambda: cc_run(ws, z)   # noqa: B023
            ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
            err = float((calls["shipped"]() - ref).abs().max())
            refused = []
            for name in list(calls):
                try:
                    calls[name]()
                except RuntimeError as e:   # more shared memory than a block may have
                    refused.append(f"{name}: {e}")
                    del calls[name]
            times = {}
            for _ in range(2):   # two turns over every variant
                for name, call in calls.items():
                    times.setdefault(name, []).append(cuda_ms(call))
            nbytes, flops = warp_cost(k, n2, d, rows, ws.sv.element_size())
            bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
            _, plan = _runner(libs["shipped"], ws, z)
            head = (f"[K={k} 2N={n2} d={d} R={rows} {str(dtype).split('.')[-1]} sets, {label}; "
                    f"plan {plan.tile_rows}-row tiles x {plan.row_tiles}, {plan.splits} runs; "
                    f"bound {bound:.4f} ms; shipped max abs {err:.3g}; on {card}]")
            print(head)
            for line in refused:
                print(f"  {line}")
            for name, ts in times.items():
                ms = sum(ts) / len(ts)
                print(f"  {name}: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}); "
                      f"{k * rows / ms / 1e3:.2f} M evals/s; {100 * bound / ms:.1f} % of bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
