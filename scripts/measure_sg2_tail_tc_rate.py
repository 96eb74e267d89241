"""The tensor-core rate the tail kernels sustain, and where their time goes, on the card.

Card counterpart of ``scripts/measure_sg2_megakernel_bound.py::_kernel``, the
TPU rig that asked what rate the MXU sustains in the inner loop of
StyleGAN2's 1024^2 same-conv. Here that loop runs on the tensor cores in the
bf16 designs of ``warpedganspace_torch/csrc/sg2_tail.cu`` and
``csrc/proggan_tail.cu``, so the question is asked of them.

Builds variants of the two sources, each with one part of a bf16 design taken
out or changed by a textual edit of the source (every edit must apply exactly
once), and times each with CUDA events in turns with the unedited design
(first and last). StyleGAN2 has two bf16 designs in its source: the shipped
one on warpgroup MMA (``wgmma`` m64nCk16, the transposed conv's raw taps into
a pre-blur window, the blur in f32, persistent blocks), launched through
``sg2_tail_section_launch``, and the ``mma.sync`` m16n8k16 design of the
polyphase up-conv that it replaced, kept for comparison behind
``sg2_tail_section_tc_launch``; both are timed. The ``wgmma`` design's
variants (``sg2_wg``): ``wg no products`` (the ``wgmma`` instructions taken
out, their operand loads and the weight ring kept), ``wg no input staging``
(the input rows' copies and the channel-last pass), ``wg no T writes``,
``wg no blur`` (both passes), ``wg no final epilogue`` (ToRGB and x2) and
``wg only the products`` (all four of those parts out). The polyphase design's
(``sg2_tail``) and ProgGAN's bf16 design's (``proggan_tail``) mirror the TPU
rig's four:

- ``dots``: the products alone, the staging of activations and the weight
  chunks' copies taken out: the loop's tensor-core ceiling;
- ``build``: the staging and the mid tile's epilogue and bf16 pack, no
  products;
- ``full``: the unedited kernel;
- ``inter``: each weight chunk's ``cp.async`` issued and waited on just before
  its products, instead of two chunks ahead of them;

and, beside them, ``full`` without its epilogues, without the mid tile's
writes, without the weight copies or without the input's staging, with other
register bounds (``__launch_bounds__``: the design asks for two blocks
an SM at C = 64, three at C = 32 and four at C = 16; the variants ask for one,
and for one block fewer at C = 32 and 16), and the CUDA-core design
of the same source run on bf16 operands (the design bf16 took before the
tensor cores). Where a part is skipped rather than cut, it is skipped by a
condition the compiler cannot decide, so no product is dropped with it. A variant that takes
a part out computes wrong values: it measures time only.

StyleGAN2's float32 design (split precision, 3xTF32 on ``mma.sync`` m16n8k8,
the transposed conv and then the blur) is asked the same at B=4 in f32, in
turns with its shipped build: ``f32 no products`` (the split products and
their operand loads taken out), ``f32 no input staging``, ``f32 no weight
copies``, ``f32 no blur`` (both passes skipped at run time), ``f32 no flushes``
(one chain a parity group), ``f32 one TF32 product`` (hi x hi only: wrong
values), C = 32 at one block an SM with three weight slots (the shipped
design fits two blocks with two slots) and the CUDA-core design it replaced,
built from the same source; its
rate counts the three products of the split, 2,048 FLOP each, against the
495 TFLOP/s TF32 peak. ProgGAN's float32 design (the same split, the bf16
design's merged-tap algebra) is asked the same at its three sections at B=4
in f32: ``f32 no products``, ``f32 no input staging`` (neither the copies nor
the PixelNorm and split pass), ``f32 no weight copies``, ``f32 no flushes``
(one chain an accumulator), ``f32 one TF32 product``, ``f32 up-conv A split
in the warps`` (the staged tile keeps the normalised value and a zero, and
the up-conv's warps split their A fragments as they load them: the
arithmetic the split at staging saves), C = 16 at two blocks an SM, and the
CUDA-core design it replaced.

StyleGAN2 is timed at its 1024^2 section (C=32, 512^2 -> 1024^2) and its 512^2
section (C=64, writing x2), ProgGAN at its three sections (C=64, 128^2 ->
256^2; C=32, 256^2 -> 512^2; C=16, 512^2 -> 1024^2 with the RGB head, hi + lo
products), all at the render batch B=16 in bf16. For each variant it prints the time and the
sustained rate: the FLOP of the tensor-core instructions the design issues
for the section (4,096 a m16n8k16; the polyphase up-conv's 81 positions a
parity padded to 96, the mid tile's halo recomputed; 2 x 64 x C x 16 a
``wgmma`` m64nCk16, the transposed conv's parity groups padded to two m64
tiles each), over the time, over the data-sheet dense bf16 peak of 989
TFLOP/s, with the registers and spills ``ptxas`` reports and the dynamic
shared memory a block asks for, beside the card's name and power limit.
Nothing is calibrated against ``bench.py``: that calibration is the TPU's.

    PYTHONPATH=. python scripts/measure_sg2_tail_tc_rate.py [--only f32|bf16]

Needs an NVIDIA card and ``nvcc``; imports no JAX.
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

from warpedganspace_torch.ops import _build, proggan_tail_cuda, sg2_tail_cuda
from warpedganspace_torch.ops.sg2_tail_cuda_cores import cc_weights
from warpedganspace_torch.ops.sg2_tail_polyphase import polyphase_weights

B = 16                                      # the render batch
B_F32 = 4                                   # the f32 design's timed batch
PEAK_BF16_FLOPS = 989e12                    # H100 SXM data sheet, dense bf16
PEAK_TF32_FLOPS = 495e12                    # H100 SXM data sheet, dense TF32
OUT_DIR = osp.join(osp.dirname(_build.BUILD_DIR), "tail_tc_rate")
HEADERS = ("tc_bf16.cuh", "tc_conv.cuh", "tc_tf32.cuh", "tc_wgmma.cuh")

# Textual edits of the tensor-core designs: (old, new), each applied once.
SG2_NO_FETCH = [("  if (j >= K::NCHUNK) return;\n  if (j < K::NUP) {\n    const int t = j / K::UP_KB",
                 "  return;\n  if (j < K::NUP) {\n    const int t = j / K::UP_KB")]
SG2_NO_STAGING = [("  tcc::stage_nchw<kThreads>(act, K::IN_ROW, x + (size_t)b * CI * hi * wi, CI, hi, "
                   "wi, iy0, ix0,\n                            kInWin, [vs1](int ci, float v) "
                   "{ return v * vs1[ci]; }, tid);\n", "")]
SG2_NO_PRODUCTS = [("        tcc::mma_step(acc, a, bs + 32 * ks, 16 * K::UP_ROW);\n", ""),
                   ("      tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);\n", "")]
SG2_INTER = [
    ("  fetch_chunk<C>(ring, wu, wsame, 0, tid);\n  tc::cp_async_commit();\n"
     "  fetch_chunk<C>(ring + K::SLOT, wu, wsame, 1, tid);\n  tc::cp_async_commit();\n", ""),
    ("      tcc::cp_async_wait<1>();   // chunk j has landed (this thread's copies)\n"
     "      __syncthreads();           // (everyone's); chunk j - 1's slot is free\n"
     "      fetch_chunk<C>(ring + ((j + 2) % kStages) * K::SLOT, wu, wsame, j + 2, tid);\n"
     "      tc::cp_async_commit();\n",
     "      __syncthreads();\n      fetch_chunk<C>(ring + (j % kStages) * K::SLOT, wu, wsame, j, tid);\n"
     "      tc::cp_async_commit();\n      tcc::cp_async_wait<0>();\n      __syncthreads();\n"),
    ("    tcc::cp_async_wait<1>();\n    __syncthreads();   // chunk j and (at the first) the mid "
     "tile are in shared memory\n    fetch_chunk<C>(ring + ((j + 2) % kStages) * K::SLOT, wu, "
     "wsame, j + 2, tid);\n    tc::cp_async_commit();\n",
     "    __syncthreads();\n    fetch_chunk<C>(ring + (j % kStages) * K::SLOT, wu, wsame, j, tid);\n"
     "    tc::cp_async_commit();\n    tcc::cp_async_wait<0>();\n    __syncthreads();\n")]
# A part skipped at run time by a condition the compiler cannot decide (hi is
# never negative, always positive), so the accumulators it reads stay live and
# no product is dropped with it.
SG2_NO_EPILOGUES = [("        if (q >= kPos) continue;\n", "        if (q >= kPos || hi > 0) continue;\n"),
                    ("    for (int hh = 0; hh < 2; ++hh) {\n      const int gy = y0 + kSameMT * warp + i",
                     "    for (int hh = 0; hh < (hi > 0 ? 0 : 2); ++hh) {\n"
                     "      const int gy = y0 + kSameMT * warp + i")]
SG2_NO_MID_WRITES = [("          row[4 * n + tq] = tc::pack_bf16x2(v[0], v[1]);\n",
                      "          if (hi < 0) row[4 * n + tq] = tc::pack_bf16x2(v[0], v[1]);\n")]
MIN_BLOCKS = "template <int C>\nconstexpr int kMinBlocks = C == 64 ? 2 : (C == 32 ? 3 : 4);"
FREE_REGISTERS = [(MIN_BLOCKS, "template <int C>\nconstexpr int kMinBlocks = 1;")]
ONE_FEWER = [(MIN_BLOCKS, "template <int C>\nconstexpr int kMinBlocks = C == 16 ? 3 : 2;")]
SG2_CUDA_CORES = [("  return (int)tc::launch(in, rgb, x2, b, c, hi, wi, static_cast<cudaStream_t>(stream));",
                   "  return (int)cc::launch<__nv_bfloat16>(in, rgb, x2, b, c, hi, wi,\n"
                   "                                        static_cast<cudaStream_t>(stream));")]

# Textual edits of the wgmma design (namespace wg of sg2_tail.cu).
WG_NO_PRODUCTS = [
    ("          wgm::mma<C>(acc, a[j & 1][ks], wgm::desc_b(slot + 32 * C * ks));   // up-conv products\n", ""),
    ("            wgm::mma<C>(acc[i], a[tap & 1][i][ks],\n                        wgm::desc_b(slot + 32 * C * ks));   // same-conv products\n", "")]
WG_NO_STAGING = [
    ("    for (int i = tid; i < CI * kInWin * 3; i += kConsumerThreads) {",
     "    for (int i = tid; i < (hi > 0 ? 0 : CI * kInWin * 3); i += kConsumerThreads) {"),
    ("      for (int i = tid; i < kInPix * (CI / 8); i += kConsumerThreads) {",
     "      for (int i = tid; i < (hi > 0 ? 0 : kInPix * (CI / 8)); i += kConsumerThreads) {")]
WG_NO_T_WRITES = [("            if (q >= npos) continue;\n", "            if (q >= npos || hi > 0) continue;\n")]
WG_NO_BLUR = [
    ("    for (int item = tid; item < kT * CP; item += kConsumerThreads) {   // the columns' pass",
     "    for (int item = tid; item < (hi > 0 ? 0 : kT * CP); item += kConsumerThreads) {"),
    ("    for (int item = tid; item < kMid * 2 * CP; item += kConsumerThreads) {   // the rows' pass",
     "    for (int item = tid; item < (hi > 0 ? 0 : kMid * 2 * CP); item += kConsumerThreads) {")]
WG_NO_EPILOGUE = [
    ("          for (int hh = 0; hh < 2; ++hh) {\n            const float nz = vnw[1]",
     "          for (int hh = 0; hh < (hi > 0 ? 0 : 2); ++hh) {\n            const float nz = vnw[1]"),
    ("    if (x2 == nullptr) continue;\n", "    if (x2 == nullptr || hi > 0) continue;\n")]

# Textual edits of the float32 design (namespace tf of sg2_tail.cu); an edit
# of the form (header, old, new) applies to the header's copy.
F32_NO_PRODUCTS = [("            tc::mma3_records<NW>(acc[0], a0, bw, NW);   // transposed-conv products\n", ""),
                   ("              tc::mma3_records<NW>(acc[1], a1, bw, NW);   // transposed-conv products\n", ""),
                   ("          tc::mma3_records<NT>(acc[i], a, bw, NT);   // same-conv products\n", "")]
F32_NO_STAGING = [("  tcc::stage_nchw_f32<kThreads>(in, K::IN_STRIDE, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0,\n"
                   "                                ix0, kInWin, tid);\n", "")]
F32_NO_FETCH = [("  tcc::fetch_units<kThreads>(slot, src, K::CHUNK / 16, tid);\n", "")]
F32_NO_BLUR = [("  for (int item = tid; item < kT * C; item += kThreads) {   // the columns' pass",
                "  for (int item = tid; item < (hi > 0 ? 0 : kT * C); item += kThreads) {"),
               ("  for (int item = tid; item < kMid * C; item += kThreads) {   // the rows' pass and epilogue",
                "  for (int item = tid; item < (hi > 0 ? 0 : kMid * C); item += kThreads) {")]
F32_NO_FLUSHES = [("constexpr int kFlushSteps = 4;", "constexpr int kFlushSteps = 1 << 20;")]
F32_ONE_PRODUCT = [("tc_tf32.cuh", "    if (t < nt) mma1688(d[t], a.lo, b[t].x, b[t].y);\n", ""),
                   ("tc_tf32.cuh", "    if (t < nt) mma1688(d[t], a.hi, b[t].z, b[t].w);\n", "")]
F32_ONE_BLOCK = [("constexpr int kBlocksPerSM = C == 64 ? 1 : (C == 32 ? 2 : 3);",
                  "constexpr int kBlocksPerSM = C == 16 ? 3 : 1;"),
                 ("constexpr int kRing = C == 32 ? 2 : 3;", "constexpr int kRing = 3;")]
F32_CUDA_CORES = [(": tf::launch(in, rgb, x2, b, c, hi, wi, s)",
                   ": cc::launch<float>(in, rgb, x2, b, c, hi, wi, s)")]

PG_NO_FETCH = [("  if (j >= K::NCHUNK) return;\n  if (j < K::NUP) {\n    const int t = j / K::UP_KB",
                "  return;\n  if (j < K::NUP) {\n    const int t = j / K::UP_KB")]
PG_NO_STAGING = [("  tcc::stage_nchw<kThreads>(act, K::IN_ROW, x + (size_t)b * CI * hi * wi, CI, hi, "
                  "wi, iy0, ix0,\n                            kInWin, [](int, float v) { return v; }, "
                  "tid);\n", ""),
                 ("    for (int p = tid >> 3; p < kInPix; p += kThreads / 8) {",
                  "    for (int p = tid >> 3; p < 0; p += kThreads / 8) {")]
PG_NO_PRODUCTS = [("        tcc::mma_step(acc, a, bs + 32 * ks, 16 * K::UP_ROW);\n", ""),
                  ("          tcc::mma_step(acc, a, bs + 32, 16 * K::UP_ROW);            // A hi x W lo\n", ""),
                  ("          tcc::mma_step(acc, a, bs, 16 * K::UP_ROW);                 // A lo x W hi\n", ""),
                  ("      tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);\n", ""),
                  ("        tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);   // A lo x W\n", "")]
PG_NO_EPILOGUES = [("      for (int hh = 0; hh < 2; ++hh) {\n        const int q = 16 * (kUpMT * grp + i)",
                    "      for (int hh = 0; hh < (hi > 0 ? 0 : 2); ++hh) {\n"
                    "        const int q = 16 * (kUpMT * grp + i)"),
                   ("    for (int hh = 0; hh < 2; ++hh) {\n      const int gy = y0 + kSameMT * warp + i",
                    "    for (int hh = 0; hh < (hi > 0 ? 0 : 2); ++hh) {\n"
                    "      const int gy = y0 + kSameMT * warp + i")]
PG_CUDA_CORES = [("      is_bf16 ? tc::launch(x, w_up,", "      is_bf16 ? cc::launch<__nv_bfloat16>(x, w_up,")]

# Textual edits of ProgGAN's float32 design (namespace tf of proggan_tail.cu).
PG_F32_NO_PRODUCTS = [
    ("            tc::mma3_records<NT>(p, a, bw[s], NT);   // up-conv products\n", ""),
    ("          tc::mma3_records<NT>(p, a, bw[s], NT);   // same-conv products\n", "")]
PG_F32_NO_STAGING = [
    ("  tcc::stage_nchw_f32<kThreads>(in, IS, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0, ix0,\n"
     "                                kInWin, tid);\n", ""),
    ("    for (int p = tid / 8; p < kInPix; p += kThreads / 8) {",
     "    for (int p = tid / 8; p < 0; p += kThreads / 8) {")]
PG_F32_NO_FETCH = [("  tcc::fetch_units<kThreads>(slot, src, units, tid);\n", "")]
# One chain an accumulator: the products straight into the sums.
PG_F32_NO_FLUSHES = [
    ("          float p[NT][4] = {};\n", "          float (&p)[NT][4] = acc[i];\n"),
    ("          add_into(acc[i], p);   // the chunk's up-conv sums\n", ""),
    ("        float p[NT][4] = {};\n", "        float (&p)[NT][4] = acc[i];\n"),
    ("        add_into(acc[i], p);   // the chunk's same-conv sums\n", "")]
PG_F32_WARP_SPLIT = [
    ("        tc::split_tf32(f[2 * i] * inv, h0, l0);\n        tc::split_tf32(f[2 * i + 1] * inv, h1, l1);",
     "        h0 = __float_as_uint(f[2 * i] * inv), l0 = 0u;\n"
     "        h1 = __float_as_uint(f[2 * i + 1] * inv), l1 = 0u;"),
    ("            const FragA a = frag_pairs(ap[i][0][k], ap[i][1][k], ap[i][0][k + 4], ap[i][1][k + 4]);",
     "            const FragA a =\n"
     "                tc::frag_a(ap[i][0][k].x, ap[i][1][k].x, ap[i][0][k + 4].x, ap[i][1][k + 4].x);")]
PG_F32_BLOCKS = "constexpr int kBlocksPerSM = C == 64 ? 1 : (C == 32 ? 2 : 3);"
PG_F32_C16_TWO = [(PG_F32_BLOCKS, "constexpr int kBlocksPerSM = C == 64 ? 1 : 2;")]
PG_F32_CUDA_CORES = [(": tf::launch(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,",
                      ": cc::launch<float>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,")]
SG2_VARIANTS = {
    "full": [],
    "dots": SG2_NO_FETCH + SG2_NO_STAGING,
    "build": SG2_NO_PRODUCTS,
    "inter": SG2_INTER,
    "full without epilogues": SG2_NO_EPILOGUES,
    "full without mid-tile writes": SG2_NO_MID_WRITES,
    "full without weight copies": SG2_NO_FETCH,
    "full without input staging": SG2_NO_STAGING,
    "full, registers left to the compiler": FREE_REGISTERS,
    "full, one block fewer an SM at C = 32 and 16": ONE_FEWER,
    "CUDA-core design on bf16": SG2_CUDA_CORES,
}
WG_VARIANTS = {
    "wg full": [],
    "wg no products": WG_NO_PRODUCTS,
    "wg no input staging": WG_NO_STAGING,
    "wg no T writes": WG_NO_T_WRITES,
    "wg no blur": WG_NO_BLUR,
    "wg no final epilogue": WG_NO_EPILOGUE,
    "wg only the products": WG_NO_STAGING + WG_NO_T_WRITES + WG_NO_BLUR + WG_NO_EPILOGUE,
}
F32_VARIANTS = {
    "f32 full": [],
    "f32 no products": F32_NO_PRODUCTS,
    "f32 no input staging": F32_NO_STAGING,
    "f32 no weight copies": F32_NO_FETCH,
    "f32 no blur": F32_NO_BLUR,
    "f32 no flushes": F32_NO_FLUSHES,
    "f32 one TF32 product": F32_ONE_PRODUCT,
    "f32 at C = 32 one block an SM, three slots": F32_ONE_BLOCK,
    "CUDA-core design on f32": F32_CUDA_CORES,
}
PG_VARIANTS = {
    "full": [],
    "dots": PG_NO_FETCH + PG_NO_STAGING,
    "build": PG_NO_PRODUCTS,
    "full without epilogues": PG_NO_EPILOGUES,
    "full without weight copies": PG_NO_FETCH,
    "full without input staging": PG_NO_STAGING,
    "full, registers left to the compiler": FREE_REGISTERS,
    "full, one block fewer an SM at C = 32 and 16": ONE_FEWER,
    "CUDA-core design on bf16": PG_CUDA_CORES,
}
PG_F32_VARIANTS = {
    "f32 full": [],
    "f32 no products": PG_F32_NO_PRODUCTS,
    "f32 no input staging": PG_F32_NO_STAGING,
    "f32 no weight copies": PG_F32_NO_FETCH,
    "f32 no flushes": PG_F32_NO_FLUSHES,
    "f32 one TF32 product": F32_ONE_PRODUCT,
    "f32 up-conv A split in the warps": PG_F32_WARP_SPLIT,
    "f32 C = 16 at two blocks an SM": PG_F32_C16_TWO,
    "CUDA-core design on f32": PG_F32_CUDA_CORES,
}
# (C, input side, x2 written / head): the sections timed.
SG2_SECTIONS = ((32, 512, False), (64, 256, True))
PG_SECTIONS = ((64, 128, False), (32, 256, False), (16, 512, True))


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once ({text.count(old)}): {old!r}")
        text = text.replace(old, new)
    return text


def _split_edits(edits):
    """(source edits, {header: its edits})."""
    src, headers = [], {}
    for e in edits:
        if len(e) == 3:
            headers.setdefault(e[0], []).append(e[1:])
        else:
            src.append(e)
    return src, headers


def _build_variant(source: str, name: str, edits) -> tuple[str, str]:
    """Write the edited source and the headers into their own directory,
    compile, return (library path, the compiler's report)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    d = osp.join(OUT_DIR, osp.splitext(source)[0], tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    edits, header_edits = _split_edits(edits)
    with open(osp.join(_build.CSRC_DIR, source)) as f:
        text = _edit(f.read(), edits)
    with open(osp.join(d, source), "w") as f:
        f.write(text)
    for header in HEADERS:
        with open(osp.join(_build.CSRC_DIR, header)) as f:
            text = _edit(f.read(), header_edits.get(header, []))
        with open(osp.join(d, header), "w") as f:
            f.write(text)
    lib = osp.join(d, "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, osp.join(d, source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} / {name}:\n{proc.stderr}")
    return lib, proc.stderr


def _registers(report: str, kind: str, name: str, c: int, extra: bool) -> str:
    """The registers ptxas reports for the instantiation a section runs: the
    tensor-core kernel of C (and, for ProgGAN, with or without the head), or
    the CUDA-core one on bf16."""
    if name == "CUDA-core design on f32":
        tmpl = f"cc14section_kernelIfLi{c}E"
    elif name.startswith("CUDA-core"):
        tmpl = f"cc14section_kernelI13__nv_bfloat16Li{c}E"
    elif kind == "sg2_f32":
        tmpl = f"tf14section_kernelILi{c}E"
    elif kind == "proggan_f32":
        tmpl = f"tf14section_kernelILi{c}ELb{int(extra)}E"
    elif kind == "sg2_wg":
        tmpl = f"wg14section_kernelILi{c}E"
    elif kind == "sg2_tail":
        tmpl = f"tc14section_kernelILi{c}E"
    else:
        tmpl = f"tc14section_kernelILi{c}ELb{int(extra)}E"
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and tmpl in line:
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt:
                    spill = [w for w in lines[i + 1:i + 4] if "spill" in w]
                    return (nxt.split("Used")[1].split(",")[0].strip()
                            + (f" ({spill[0].strip()})" if spill else ""))
    return "?"


def cuda_ms(fn, iters=10, warmup=2) -> float:
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


def sg2_mma_flop(c: int, h: int) -> float:
    """FLOP of the mma.sync instructions the polyphase bf16 StyleGAN2 design issues for
    one section at B: 8 warps, each 3 m16 tiles x C/8 n8 tiles over 9 taps x
    2C/16 k steps (up-conv) and 2 m16 tiles x C/8 n8 tiles over 9 taps x C/16
    k steps (same-conv), per 16 x 16 output tile."""
    tiles = B * (2 * h // 16) ** 2
    per_tile = 8 * (c // 8) * (3 * 9 * 2 * c // 16 + 2 * 9 * c // 16)
    return 4096.0 * per_tile * tiles


def wg_mma_flop(c: int, h: int) -> float:
    """FLOP of the wgmma instructions the shipped bf16 StyleGAN2 design
    issues for one section at B: per 16 x 16 output tile, the transposed
    conv's 18 m64 tiles x taps (two a parity group: 2 x (4 + 2 + 2 + 1)) over
    2C/16 k steps and the same-conv's 4 m64 tiles x 9 taps over C/16, each 2 x
    64 x C x 16."""
    tiles = B * (2 * h // 16) ** 2
    per_tile = 18 * 2 * c // 16 + 36 * c // 16
    return 2.0 * 64 * c * 16 * per_tile * tiles


def smem_kb(kind: str, c: int) -> float:
    """The dynamic shared memory a block of the StyleGAN2 bf16 design asks
    for, in KiB, as ``Cfg<C>::SMEM`` of its namespace computes it."""
    vec = (4 * (11 * c + 5) + 15) // 16 * 16
    if kind == "sg2_tail":                     # namespace tc
        in_row, mid_row = 2 * (2 * c + 8), 2 * (c + 8)
        slot = max(4 * c * 80, (3 if c == 64 else 9) * c * 48)
        return (vec + max(144 * in_row, 324 * mid_row) + 3 * slot) / 1024
    stages = {64: 3, 32: 4, 16: 6}[c]          # namespace wg
    ring, bars = stages * 4 * c * c, (16 * stages + 15) // 16 * 16
    tt = 441 * (c + 4) * 4
    act = max(144 * 2 * (2 * c + 8), 324 * 2 * (c + 8))
    const = (4 * (5 * c + 5) + 15) // 16 * 16
    return (ring + bars + tt + act + const + 2 * (12 * c + 2 * 18 * 32 + 2 * 256)) / 1024


def f32_mma_flop(c: int, h: int) -> float:
    """FLOP of the mma.sync instructions the float32 StyleGAN2 design issues
    for one section at B_F32, the split's three products each: per 16 x 16
    output tile, the transposed conv's 67 m16 tiles x taps (parity groups of
    121, 110, 110 and 100 positions: 8 x 4 + 7 x 2 + 7 x 2 + 7 x 1) over 2C/8
    k8 steps and the same-conv's 16 x 9 over C/8, each x C/8 n8 tiles; 2,048 a
    m16n8k8."""
    tiles = B_F32 * (2 * h // 16) ** 2
    per_tile = 3 * (c // 8) * (67 * 2 * c // 8 + 16 * 9 * c // 8)
    return 2048.0 * per_tile * tiles


def pg_f32_mma_flop(c: int, h: int, head: bool) -> float:
    """FLOP of the mma.sync instructions the float32 ProgGAN design issues for
    one section at B_F32, the split's three products each: per 16 x 16 output
    tile, the up-conv's 4 parities x 6 m16 tiles (81 positions padded to 96)
    over 4 merged taps x 2C/8 k8 steps and the same-conv's 16 x 9 over C/8,
    each x C/8 n8 tiles; 2,048 a m16n8k8."""
    tiles = B_F32 * (2 * h // 16) ** 2
    per_tile = 3 * (c // 8) * (4 * 6 * 4 * 2 * c // 8 + 16 * 9 * c // 8)
    return 2048.0 * per_tile * tiles


def pg_mma_flop(c: int, h: int, head: bool) -> float:
    """The same for the bf16 ProgGAN design: 4 merged taps x 2C/16 k steps
    in the up-conv (three products a step with the head's hi + lo), 9 taps x
    C/16 in the same-conv (two with the head)."""
    tiles = B * (2 * h // 16) ** 2
    up, same = (3, 2) if head else (1, 1)
    per_tile = 8 * (c // 8) * (3 * 4 * 2 * c // 16 * up + 2 * 9 * c // 16 * same)
    return 4096.0 * per_tile * tiles


def _sg2_call(fn, c, h, want_x2, cuda_cores, dtype=torch.bfloat16, bsz=B, polyphase=False):
    """A launch of one section through ``fn``: the entry of the shipped
    designs (``sg2_tail_section_launch``, which takes the operands' type), or
    with ``polyphase`` the polyphase design's (``sg2_tail_section_tc_launch``,
    bf16 only), each with the weights its design reads."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    x = rnd(bsz, 2 * c, h, h)
    w_up, w_same, w_rgb = (rnd(c, 2 * c, 3, 3, std=0.5 * (18 * c) ** -0.5),
                           rnd(c, c, 3, 3, std=0.5 * (9 * c) ** -0.5),
                           rnd(3, c, 1, 1, std=0.5 * c ** -0.5))
    vecs = [rnd(bsz, 2 * c, mean=1.0, std=0.3)] + [rnd(bsz, c, mean=1.0, std=0.2) for _ in range(4)]
    n1, n2 = rnd(1, 1, 2 * h, 2 * h), rnd(1, 1, 2 * h, 2 * h)
    nw1, nw2 = (torch.tensor([v], device="cuda", dtype=dtype) for v in (0.7, -0.4))
    b1, b2, rgb_b = rnd(c, std=0.3), rnd(c, std=0.3), rnd(3, std=0.3)
    if cuda_cores:
        wu, ws, wr = cc_weights(w_up, w_same, w_rgb)
    elif polyphase:
        wu, ws, wr = polyphase_weights(w_up, w_same, w_rgb)
    else:
        wu, ws, wr = sg2_tail_cuda.kernel_weights(w_up, w_same, w_rgb, dtype)
    rgb = torch.empty((bsz, 3, 2 * h, 2 * h), device="cuda", dtype=dtype)
    x2 = torch.empty((bsz, c, 2 * h, 2 * h), device="cuda", dtype=dtype) if want_x2 else None
    keep = [x, wu, ws, wr, *vecs, n1, nw1, b1, n2, nw2, b2, rgb_b, rgb, x2]
    ptrs = [t.data_ptr() for t in (x, wu, ws, wr, *vecs, n1, nw1, b1, n2, nw2, b2, rgb_b, rgb)]
    stream = torch.cuda.current_stream().cuda_stream
    dtype_arg = [] if polyphase else [int(dtype == torch.bfloat16)]

    def call():
        err = fn(*ptrs, None if x2 is None else x2.data_ptr(), *dtype_arg, bsz, c, h, h,
                 int(want_x2), stream)
        if err != 0:
            raise RuntimeError(f"sg2_tail variant failed to launch: cudaError {err}")
        return keep
    return call


def _sg2_tc_call(fn, c, h, want_x2, cuda_cores):
    return _sg2_call(fn, c, h, want_x2, cuda_cores, polyphase=True)


def _pg_call(fn, c, h, head, cuda_cores, dtype=torch.bfloat16, bsz=B):
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    x = rnd(bsz, 2 * c, h, h)
    w_up, w_same = rnd(c, 2 * c, 3, 3, std=(18 * c) ** -0.5), rnd(c, c, 3, 3, std=(9 * c) ** -0.5)
    b_up, b_same = rnd(c, std=0.3), rnd(c, std=0.3)
    s_up, s_same = (torch.tensor([v], device="cuda", dtype=dtype) for v in (1.3, 0.8))
    hd = ((rnd(3, c, 1, 1, std=c ** -0.5), rnd(3, std=0.3),
           torch.tensor([1.1], device="cuda", dtype=dtype)) if head else None)
    if not cuda_cores:
        w_up, w_same = proggan_tail_cuda.kernel_weights(w_up, w_same, dtype)
    out = torch.empty((bsz, 3 if head else c, 2 * h, 2 * h), device="cuda", dtype=dtype)
    keep = [x, w_up, b_up, s_up, w_same, b_same, s_same, hd, out]
    head_ptrs = [t.data_ptr() for t in hd] if hd else [None] * 3
    ptrs = [t.data_ptr() for t in (x, w_up, b_up, s_up, w_same, b_same, s_same)]
    stream = torch.cuda.current_stream().cuda_stream
    is_bf16 = int(dtype == torch.bfloat16)

    def call():
        err = fn(*ptrs, *head_ptrs, out.data_ptr(), is_bf16, bsz, c, h, h, stream)
        if err != 0:
            raise RuntimeError(f"proggan_tail variant failed to launch: cudaError {err}")
        return keep
    return call


def _sg2_f32_call(fn, c, h, want_x2, cuda_cores):
    return _sg2_call(fn, c, h, want_x2, cuda_cores, torch.float32, B_F32)


def _pg_f32_call(fn, c, h, head, cuda_cores):
    return _pg_call(fn, c, h, head, cuda_cores, torch.float32, B_F32)


def _time(kind, variants, libs, sections, make_call, flop, card):
    for sec in sections:
        c, h, extra = sec
        f32 = kind.endswith("f32")
        full = "f32 full" if f32 else ("wg full" if kind == "sg2_wg" else "full")
        names = list(variants) + [full]              # the shipped design first and last
        times = {}
        for name in names:
            fn, _ = libs[(kind, name)]
            call = make_call(fn, c, h, extra, name.startswith("CUDA-core"))
            call()
            times.setdefault(name, []).append(cuda_ms(call))
            del call
            torch.cuda.empty_cache()
        f = flop(*sec)
        peak, tag = (PEAK_TF32_FLOPS, "495 TFLOP/s TF32") if f32 else (PEAK_BF16_FLOPS,
                                                                      "989 TFLOP/s bf16")
        for name in variants:
            ts = times[name]
            ms = sum(ts) / len(ts)
            rate = f / (ms * 1e-3)
            pg = kind.startswith("proggan")
            smem = (f"; {smem_kb(kind, c):.1f} KiB of shared memory a block"
                    if kind in ("sg2_wg", "sg2_tail") and not name.startswith("CUDA-core") else "")
            print(f"[{kind} C={c} {h}^2 -> {2 * h}^2{' +x2' if extra and not pg else ''}"
                  f"{' +head' if extra and pg else ''} "
                  f"B={B_F32 if f32 else B} {'f32' if f32 else 'bf16'}] {name}: "
                  f"{ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}); the design's tensor-core "
                  f"work {f / 1e9:.1f} GFLOP at {rate / 1e12:.1f} TFLOP/s = "
                  f"{100 * rate / peak:.1f} % of the {tag} peak; "
                  f"{_registers(libs[(kind, name)][1], kind, name, c, extra)}{smem}; on {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("f32", "bf16"),
                        help="time only the float32 designs (StyleGAN2's and ProgGAN's), or "
                             "only the bf16 designs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_sg2_tail_tc_rate: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    jobs = []
    if args.only != "bf16":
        jobs += [("sg2_f32", "sg2_tail.cu", k, v) for k, v in F32_VARIANTS.items()]
        jobs += [("proggan_f32", "proggan_tail.cu", k, v) for k, v in PG_F32_VARIANTS.items()]
    if args.only != "f32":
        jobs += [("sg2_wg", "sg2_tail.cu", k, v) for k, v in WG_VARIANTS.items()]
        jobs += [("sg2_tail", "sg2_tail.cu", k, v) for k, v in SG2_VARIANTS.items()]
        jobs += [("proggan_tail", "proggan_tail.cu", k, v) for k, v in PG_VARIANTS.items()]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        built = list(pool.map(lambda j: _build_variant(*j[1:]), jobs))
    libs = {}
    for (kind, _, name, _), (path, report) in zip(jobs, built):
        lib = ctypes.CDLL(path)
        if kind == "sg2_tail":
            fn = lib.sg2_tail_section_tc_launch
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        elif kind in ("sg2_wg", "sg2_f32"):
            fn = lib.sg2_tail_section_launch
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:
            fn = lib.proggan_tail_section_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[(kind, name)] = (fn, report)
    with torch.no_grad():
        if args.only != "bf16":
            _time("sg2_f32", F32_VARIANTS, libs, SG2_SECTIONS, _sg2_f32_call,
                  lambda c, h, _: f32_mma_flop(c, h), card)
            _time("proggan_f32", PG_F32_VARIANTS, libs, PG_SECTIONS, _pg_f32_call,
                  pg_f32_mma_flop, card)
        if args.only != "f32":
            _time("sg2_wg", WG_VARIANTS, libs, SG2_SECTIONS, _sg2_call,
                  lambda c, h, _: wg_mma_flop(c, h), card)
            _time("sg2_tail", SG2_VARIANTS, libs, SG2_SECTIONS, _sg2_tc_call,
                  lambda c, h, _: sg2_mma_flop(c, h), card)
            _time("proggan_tail", PG_VARIANTS, libs, PG_SECTIONS, _pg_call, pg_mma_flop, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
