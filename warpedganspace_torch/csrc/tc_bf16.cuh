// Tensor-core building blocks of the bf16 attention kernels (sa_attention.cu,
// sa_attention_bwd.cu) for Hopper (sm_90a): 16-byte cp.async staging with
// zero fill, ldmatrix, mma.sync m16n8k16 with bf16 operands and f32
// accumulation, and the packing of f32 accumulator fragments into bf16
// operand fragments.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gq + tq): the A tile (16 x
// 16, row-major) is four registers of two bf16, (row gq, k 2tq..2tq+1), (row
// gq + 8, same k), (row gq, k 2tq + 8..), (row gq + 8, k 2tq + 8..); the B tile
// (16 x 8) is two registers, (k 2tq.., column gq) and (k 2tq + 8.., column
// gq); the f32 accumulator (16 x 8) is (row gq, columns 2tq, 2tq + 1) and
// (row gq + 8, the same columns). So the accumulators of two neighbouring n8
// tiles are, packed to bf16 pairs, the A operand of the next product over
// those 16 columns, without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;               // streamed columns (keys or queries) per chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the most recent) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16-byte units of a staged row holding d values: d padded to a multiple of 16
// (whole k16 steps and pairs of n8 tiles), zeros past d.
__host__ __device__ __forceinline__ int value_units(int d) { return 2 * ((d + 15) / 16); }

// Row stride in 16-byte units: odd, so the eight rows an ldmatrix reads start
// in eight different 16-byte bank groups (no conflicts).
__host__ __device__ __forceinline__ int row_units(int d) { return value_units(d) + 1; }

// i / n for the small counts of the staging loops (i < 2^16, n <= 2^10): exact,
// without an integer division (inv_n = 1.f / n).
__device__ __forceinline__ int quot(int i, float inv_n) {
  return __float2int_rz((i + 0.5f) * inv_n);
}

// Stage rows first .. first + rows - 1 of a bf16 operand whose rows hold `d`
// elements (src points at row 0 of the wanted columns) into shared rows of
// `ustride` 16-byte units at dst, writing `units` units of each: the first w
// columns, zeros past them, and zero rows past row `limit`.
// vec: 16-byte cp.async, which needs d and the column offset to be multiples
// of 8 and src 16-byte aligned (then every unit is wholly inside or outside
// the w columns); otherwise element loads and stores, which are synchronous.
// The block's THREADS threads share the work.
template <int THREADS>
__device__ __forceinline__ void stage_rows(char* dst, const bf16* src, int rows, int first,
                                           int limit, int d, int w, int units, int ustride,
                                           bool vec, int tid) {
  if (vec) {
    const uint32_t base = smem_addr(dst);
    const int total = rows * units;
    const float inv = 1.f / units;
    for (int i = tid; i < total; i += THREADS) {
      const int r = quot(i, inv), u = i - r * units;
      const int gr = first + r;
      const bool ok = gr < limit && 8 * u < w;
      cp_async16(base + (r * ustride + u) * 16, ok ? src + (size_t)gr * d + 8 * u : src, ok);
    }
    return;
  }
  bf16* s = reinterpret_cast<bf16*>(dst);
  const int cols = 8 * units;
  const int total = rows * cols;
  const float inv = 1.f / cols;
  const bf16 zero = __ushort_as_bfloat16(0);
  for (int i = tid; i < total; i += THREADS) {
    const int r = quot(i, inv), c = i - r * cols;
    const int gr = first + r;
    s[r * ustride * 8 + c] = (gr < limit && c < w) ? src[(size_t)gr * d + c] : zero;
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Store two neighbouring output values (columns c, c + 1 of a row) as bf16;
// pair: the row's length and its first column are even, so the two go as one
// 4-byte store.
__device__ __forceinline__ void store_pair(bf16* row, int c, int width, float v0, float v1,
                                           bool pair) {
  if (pair && c + 1 < width) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (c < width) row[c] = __float2bfloat16(v0);
  if (c + 1 < width) row[c + 1] = __float2bfloat16(v1);
}

}  // namespace tc
