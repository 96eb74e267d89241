// Tensor-core building blocks of the bf16 tail kernels (proggan_tail.cu,
// sg2_tail.cu) for Hopper (sm_90a): a 3x3 convolution out of shared memory as
// an implicit GEMM on mma.sync m16n8k16 (bf16 operands, f32 accumulation);
// at the end, the staging and copies of sg2_tail.cu's float32 design.
//
// - M is the pixels of a tile, N the output channels, K taps x input channels.
// - Activation tiles live in shared memory as bf16, channel-last: one row of
//   `stride` bytes per pixel, an odd number of 16-byte units, so the eight
//   rows an ldmatrix reads start in eight different 16-byte bank groups.
//   ldmatrix takes one row address per lane, so im2col costs nothing: for
//   each tap every lane points at its own shifted pixel.
// - Weights are staged [row = (tap, output channel)][input channels] by
//   16-byte cp.async, K-contiguous for the B operand, in chunks of input
//   channels through a ring of shared-memory slots.
// - A warp owns some m16 tiles x all C output columns of a product, so a
//   pixel's C channels lie in one quad (lanes 4 gq .. 4 gq + 3) across the
//   warp's n8 tiles: a sum over channels is a lane's partial and two quad
//   shuffles (tc::quad_sum), with no trip through shared memory.
//
// Fragment layout (tc_bf16.cuh): lane = 4 gq + tq holds accumulator entries
// (row gq, columns 2tq, 2tq + 1) in [0], [1] and (row gq + 8, the same
// columns) in [2], [3] of each n8 tile.
#pragma once

#include "tc_bf16.cuh"

namespace tcc {

using tc::bf16;

// ldmatrix x4 of an A tile (16 rows x 16 k): lanes 8i .. 8i + 7 address matrix
// i; matrices 0..3 are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k
// 8-15), (rows 8-15, k 8-15).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int a_k(int lane) { return (lane >> 4) << 3; }

// ldmatrix x4 of B from rows [n][k]: matrices 0..3 are (n 0-7, k 0-7), (n 0-7,
// k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), i.e. {b0, b1} of n8 tiles 2j and
// 2j + 1.
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_k(int lane) { return ((lane >> 3) & 1) << 3; }

// One k16 step of a warp: acc[MT][NT] += A (MT m16 tiles; a[i] is this lane's
// shared address of its row of tile i at this step's k) x B (NT n8 tiles;
// b is this lane's shared address for n8 tiles 0 and 1, pairs `bpair` bytes
// apart).
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const uint32_t (&a)[MT],
                                         uint32_t b, int bpair) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs");
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) tc::ldsm_x4(af[i], a[i]);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t bf[4];
    tc::ldsm_x4(bf, b + j * bpair);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      tc::mma16816(acc[i][2 * j], af[i], bf[0], bf[1]);
      tc::mma16816(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Copy `rows` rows of `units` 16-byte units by cp.async: row r from src + r *
// src_row elements into dst + r * dst_row bytes. src, src_row and the units
// must keep every copy 16-byte aligned.
template <int THREADS>
__device__ __forceinline__ void fetch_rows(uint32_t dst, int dst_row, const bf16* src,
                                           size_t src_row, int rows, int units, int tid) {
  const int total = rows * units;
  for (int i = tid; i < total; i += THREADS) {
    const int r = i / units, u = i - r * units;
    tc::cp_async16(dst + r * dst_row + 16 * u, src + r * src_row + 8 * u, true);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage a window of an NCHW image into a channel-last bf16 tile: `win` x
// `win` pixels from (iy0, ix0) of the `ch` channels of xb (hi x wi each), pairs
// of channels per 4-byte store, zeros outside the image; f(ci, v) maps each
// value to what is stored (as f32, rounded to bf16 by the store). Row p of
// the tile (pixel r * win + c) starts at tile + p * stride bytes.
template <int THREADS, typename F>
__device__ __forceinline__ void stage_nchw(char* tile, int stride, const bf16* __restrict__ xb,
                                           int ch, int hi, int wi, int iy0, int ix0, int win,
                                           F f, int tid) {
  const int npix = win * win;
  const size_t plane = (size_t)hi * wi;
  for (int idx = tid; idx < (ch / 2) * npix; idx += THREADS) {
    const int cp = idx / npix;
    const int p = idx - cp * npix;
    const int r = p / win, c = p - r * win;
    const int iy = iy0 + r, ix = ix0 + c;
    float v0 = 0.f, v1 = 0.f;
    if (iy >= 0 && iy < hi && ix >= 0 && ix < wi) {
      const bf16* src = xb + (size_t)(2 * cp) * plane + (size_t)iy * wi + ix;
      v0 = f(2 * cp, __bfloat162float(src[0]));
      v1 = f(2 * cp + 1, __bfloat162float(src[plane]));
    }
    *reinterpret_cast<uint32_t*>(tile + p * stride + 4 * cp) = tc::pack_bf16x2(v0, v1);
  }
}

// ---------------------------------------------------------------------------
// The same convolutions in float32 (sg2_tail.cu's split-precision design on
// mma.sync m16n8k8, tc_tf32.cuh): activation tiles are float32, channel-last,
// one row of `stride` floats per pixel, an odd number of 16-byte units, so a
// fragment's scalar loads (8 pixels x 4 channels) fall in 32 different banks
// when the 8 pixels are consecutive. im2col is again an address per lane:
// each tap shifts a lane's pixel. B fragments come as 16-byte records
// prepared before the launch, copied as they are.

// Copy `units` 16-byte units by cp.async from src (16-byte aligned) to dst.
template <int THREADS>
__device__ __forceinline__ void fetch_units(uint32_t dst, const void* src, int units, int tid) {
  const char* s = static_cast<const char*>(src);
  for (int i = tid; i < units; i += THREADS) tc::cp_async16(dst + 16 * i, s + 16 * i, true);
}

// Stage a window of an NCHW float32 image into a channel-last float32 tile by
// 4-byte cp.async (the caller commits and waits): `win` x `win` pixels from
// (iy0, ix0) of the `ch` channels of xb (hi x wi each; ch a multiple of 4),
// zeros outside the image. Row p of the tile (pixel r * win + c) starts at
// tile + p * stride floats. Eight consecutive lanes take eight consecutive
// pixels of one channel (a 32-byte read), the four groups of a warp four
// consecutive channels: with stride = 4 (mod 32) the 32 stores fall in 32
// banks. The copies of a thread are all in flight at once.
template <int THREADS>
__device__ __forceinline__ void stage_nchw_f32(float* tile, int stride,
                                               const float* __restrict__ xb, int ch, int hi,
                                               int wi, int iy0, int ix0, int win, int tid) {
  const uint32_t base = tc::smem_addr(tile);
  const int npix = win * win, pblocks = (npix + 7) / 8;
  for (int idx = tid; idx < pblocks * 8 * ch; idx += THREADS) {
    const int rest = idx >> 5;
    const int p = (rest % pblocks) * 8 + (idx & 7);
    const int ci = (rest / pblocks) * 4 + ((idx >> 3) & 3);
    if (p >= npix) continue;
    const int r = p / win, c = p - r * win;
    const int iy = iy0 + r, ix = ix0 + c;
    const bool ok = iy >= 0 && iy < hi && ix >= 0 && ix < wi;
    tc::cp_async4(base + 4 * (p * stride + ci), ok ? xb + ((size_t)ci * hi + iy) * wi + ix : xb,
                  ok);
  }
}

}  // namespace tcc
