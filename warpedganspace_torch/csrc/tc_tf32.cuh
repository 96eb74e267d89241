// Tensor-core building blocks of the float32 attention kernels
// (sa_attention.cu, sa_attention_bwd.cu) for Hopper (sm_90a): float32
// operands carried in split precision (3xTF32) on mma.sync m16n8k8, staged
// into shared memory by cp.async.
//
// 3xTF32: a float32 value x is split into hi = tf32(x) and lo = tf32(x - hi),
// each rounded to nearest (ties away from zero, cvt.rna.tf32.f32; the tensor
// core itself would truncate the low 13 bits of a raw float32). A product a b
// is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 accumulation;
// lo lo is dropped. That keeps about 22 of float32's 24 bits, where one TF32
// product keeps 11: tests/test_torch_attn_f32_split_numerics.py emulates both
// against the float32 checks.
//
// Fragment layout of mma.sync.m16n8k8 .tf32 (lane = 4 * gq + tq): the A tile
// (16 x 8, row-major) is four registers, (row gq, k tq), (row gq + 8, k tq),
// (row gq, k tq + 4), (row gq + 8, k tq + 4); the B tile (8 x 8) is two,
// (k tq, column gq) and (k tq + 4, column gq); the f32 accumulator (16 x 8) is
// (row gq, columns 2tq, 2tq + 1) and (row gq + 8, the same columns). The
// accumulator's columns are not the A fragment's k, so a product whose A is an
// accumulator (the softmax weights, ds) takes its k in a permuted order:
// k tq <-> column 2tq, k tq + 4 <-> column 2tq + 1, and reads the B rows of
// the same columns (a sum over k does not care about its order).
//
// Shared rows hold float32 values, d padded with zeros to a multiple of 8 (a
// whole number of k8 steps or n8 tiles), at a stride of an odd number of
// 16-byte units: then every scalar fragment load, 8 rows x 4 columns or 4 row
// pairs x 8 columns, falls in 32 different banks. A staged chunk that every
// warp reads can instead be split once by the block into 16-byte records of
// B fragments, {hi(b0), hi(b1), lo(b0), lo(b1)} (split_pair, k_records,
// pair_records): one conflict-free load a fragment and no arithmetic in the
// warps that read it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace tc {

// 16-byte units of a staged float32 row of d values (d padded to a multiple of 8).
__host__ __device__ constexpr int f32_units(int d) { return 2 * ((d + 7) / 8); }

// Row stride in 16-byte units: odd (conflict-free fragment loads).
__host__ __device__ constexpr int f32_row_units(int d) { return f32_units(d) + 1; }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16x8 tf32, b 8x8 tf32, d 16x8 f32. Not
// volatile: the compiler may move it among independent products.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment in split precision.
struct FragA {
  uint32_t hi[4], lo[4];
};

// The A fragment of four float32 values (in the register order above).
__device__ __forceinline__ FragA frag_a(float v0, float v1, float v2, float v3) {
  FragA f;
  split_tf32(v0, f.hi[0], f.lo[0]);
  split_tf32(v1, f.hi[1], f.lo[1]);
  split_tf32(v2, f.hi[2], f.lo[2]);
  split_tf32(v3, f.hi[3], f.lo[3]);
  return f;
}

// d[t] += a b[t] in split precision for the n8 tiles t < nt of one k8 step (b
// as its two float32 values b0[t], b1[t]): every tile's lo hi product, then
// every tile's hi lo, then every tile's hi hi, so that consecutive products
// go to different accumulators and none waits for the one before it.
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&d)[NT][4], const FragA& a,
                                           const float (&b0)[NT], const float (&b1)[NT],
                                           int nt) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) {
      split_tf32(b0[t], bh[t][0], bl[t][0]);
      split_tf32(b1[t], bh[t][1], bl[t][1]);
    }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.lo, bh[t][0], bh[t][1]);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.hi, bl[t][0], bl[t][1]);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.hi, bh[t][0], bh[t][1]);
}

// A split B fragment as one 16-byte record: {hi(b0), hi(b1), lo(b0), lo(b1)}.
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 r;
  split_tf32(b0, r.x, r.z);
  split_tf32(b1, r.y, r.w);
  return r;
}

// Records of a staged row whose d values are the k index of a product (B
// fragments of an n8 tile: column gq's slots tq and tq + 4): 4 per k8 step,
// at a stride of 4 (mod 8) records, so that 16-byte loads are conflict-free.
__host__ __device__ constexpr int k_records(int d) {
  return 4 * ((d + 7) / 8) + (((d + 7) / 8) % 2 == 0 ? 4 : 0);
}

// Records of a pair of staged rows whose index is the k of a product in the
// permuted order (rows 2i and 2i + 1 are slots tq and tq + 4): one per column,
// d padded to whole n8 tiles, at a stride of 2 (mod 8) records.
__host__ __device__ constexpr int pair_records(int d) { return 8 * ((d + 7) / 8) + 2; }

// d[t] += a b[t] for the n8 tiles t < nt of one k8 step, with b[t] a split
// record (split_pair), swept as in mma3_tiles.
template <int NT>
__device__ __forceinline__ void mma3_records(float (&d)[NT][4], const FragA& a,
                                             const uint4 (&b)[NT], int nt) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.lo, b[t].x, b[t].y);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.hi, b[t].z, b[t].w);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < nt) mma1688(d[t], a.hi, b[t].x, b[t].y);
}

// A logits product (theta phi^T) of more than this many k8 steps takes each
// step's three products into an accumulator of its own, from 0, and adds the
// step's sum into the logits in float32 (rounded to nearest). The tensor
// cores round a float32 sum toward zero, so one chain of 3 ks mma.sync into
// the logits lowers a logit of 45 by up to 3 ks of its ulps: at dk=192 the
// row's lse then lies about 1e-4 below float64, at dk <= 32 about 1e-5
// (tests/test_torch_attn_f32_split_numerics.py models both).
constexpr int kChainSteps = 4;

// d[t] += a b[t] as mma3_tiles, the step's sum taken from 0 and added.
template <int NT>
__device__ __forceinline__ void mma3_tiles_add(float (&d)[NT][4], const FragA& a,
                                               const float (&b0)[NT], const float (&b1)[NT],
                                               int nt) {
  float p[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) p[t][0] = p[t][1] = p[t][2] = p[t][3] = 0.f;
  mma3_tiles<NT>(p, a, b0, b1, nt);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] += p[t][e];
}

// The same with split records (mma3_records).
template <int NT>
__device__ __forceinline__ void mma3_records_add(float (&d)[NT][4], const FragA& a,
                                                 const uint4 (&b)[NT], int nt) {
  float p[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) p[t][0] = p[t][1] = p[t][2] = p[t][3] = 0.f;
  mma3_records<NT>(p, a, b, nt);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] += p[t][e];
}

// Stage rows first .. first + rows - 1 of a float32 operand whose rows hold d
// elements (src points at row 0 of the wanted columns) into shared rows of
// `ustride` 16-byte units at dst, writing `units` units of each: the first w
// columns, zeros past them, and zero rows past row `limit`. All copies are
// cp.async (zero-filled where nothing is read): 16 bytes where vec (d and the
// column offset multiples of 4, src 16-byte aligned; then every unit is
// wholly inside or outside the w columns), else 4 bytes at a time. The
// block's THREADS threads share the work.
template <int THREADS>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int rows, int first,
                                               int limit, int d, int w, int units, int ustride,
                                               bool vec, int tid) {
  const uint32_t base = smem_addr(dst);
  if (vec) {
    const int total = rows * units;
    const float inv = 1.f / units;
    for (int i = tid; i < total; i += THREADS) {
      const int r = quot(i, inv), u = i - r * units;
      const int gr = first + r;
      const bool ok = gr < limit && 4 * u < w;
      cp_async16(base + (r * ustride + u) * 16, ok ? src + (size_t)gr * d + 4 * u : src, ok);
    }
    return;
  }
  const int cols = 4 * units;
  const int total = rows * cols;
  const float inv = 1.f / cols;
  for (int i = tid; i < total; i += THREADS) {
    const int r = quot(i, inv), c = i - r * cols;
    const int gr = first + r;
    const bool ok = gr < limit && c < w;
    cp_async4(base + (r * ustride * 4 + c) * 4, ok ? src + (size_t)gr * d + c : src, ok);
  }
}

// The accumulators of a split product run through at most this many chunks
// of 64 (4 x 8 x 3 = 96 mma.sync) before they are added into the output in
// float32 and start again from 0. The tensor cores' float32 accumulation
// rounds toward zero: a chain of 1,536 products into one accumulator (the
// backward's key pass over N=4096) left its gradients 1.6e-5 smaller than
// float64 on average, where the CUDA-core design's sums are unbiased (1e-8).
constexpr int kFlushChunks = 4;

// Load two neighbouring float32 values of a row written by store_pair.
__device__ __forceinline__ float2 load_pair(const float* row, int c, int width, bool pair) {
  if (pair && c + 1 < width) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(c < width ? row[c] : 0.f, c + 1 < width ? row[c + 1] : 0.f);
}

// Store two neighbouring float32 outputs (columns c, c + 1 of a row); pair:
// the row's length and first column are even, so the two go as one 8-byte store.
__device__ __forceinline__ void store_pair(float* row, int c, int width, float v0, float v1,
                                           bool pair) {
  if (pair && c + 1 < width) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    return;
  }
  if (c < width) row[c] = v0;
  if (c + 1 < width) row[c + 1] = v1;
}

}  // namespace tc
