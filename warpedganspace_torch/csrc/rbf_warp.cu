// All-sets RBF warp directions for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel warpedganspace_tpu/ops/rbf_pallas.py::_warp_kernel.
// For every support set k and query row r (z is set-major, (K, R, d)):
//
//   w_j  = ag_j * exp(-g_j * (|z|^2 - 2 z.sv_j + |sv_j|^2))      j < 2N
//   grad = -2 (sum_j w_j) z + 2 sum_j w_j sv_j
//   out  = grad * rsqrt(|grad|^2)
//
// It is shaped like attention without the softmax normalisation: two dependent
// contractions over the same sv_k with an exponential between them. The
// weights are bounded by |alpha| * gamma, so no running maximum is needed.
//
// What bounds it: each set is read once, z read and the directions written
// once. At the timed shape (K=200, 2N=1024, d=512, R=64) that is 474 MB with
// f32 sets and 265 MB with bf16 ones, 0.142 / 0.079 ms at the H100 data-sheet
// 3.35 TB/s; the two contractions are 2 * 2 * K * R * 2N * d = 26.8 GFLOP,
// 0.027 ms at the 989 TFLOP/s of bf16 tensor-core products. So the bytes bound
// it, at every R the traversals use. On the CUDA cores the same products took
// 0.40 ms at least (67 TFLOP/s f32), which is why this design moves them.
//
// Precision. Both contractions run on mma.sync m16n8k16 with bf16 operands and
// f32 accumulation, in split precision: an f32 operand x is carried as
// hi = bf16(x) and lo = bf16(x - hi), and each product keeps all piece pairs
// but lo * lo, about 16 bits of each operand. bf16 sets are exact in bf16, so
// pass 1 is z_hi sv + z_lo sv and pass 2 w_hi sv + w_lo sv (two products
// each); f32 sets add z_hi sv_lo and w_hi sv_lo (three each). The weights,
// their row sums, |z|^2 and the final combination are f32. The CPU emulation
// of these rounding points (tests/test_torch_warp_tc_numerics.py) is within
// 1.3e-5 of the plain f32 version at the traversals' shapes, against the
// 1e-4 bound.
//
// Design:
// - A block owns one set, one tile of 16 or 32 rows (R rounded up, MT = 1 or
//   2 m16 tiles, 8 or 16 warps; bf16 sets always take 16, two blocks an SM) and
//   one run of whole chunks of 16 support vectors (the host's plan splits 2N
//   into runs when K x row tiles blocks cannot fill the card). Blocks of one
//   run of one set sit side by side in the grid, so the row tiles share each
//   sv chunk in L2: sv leaves HBM once.
// - sv streams through a three-stage ring in shared memory by 16-byte
//   cp.async, with each chunk's g, ag and |sv|^2; the next chunks' copies are
//   in flight while two are multiplied. bf16 sets are multiplied from the
//   ring; f32 chunks are split into hi and lo planes (rows of an odd number
//   of 16-byte units, conflict-free for ldmatrix; two buffers) by one pass of
//   the block first. Rows whose length or base does not allow 16-byte copies
//   are staged by element loads instead.
// - The passes are pipelined across chunks: pass 1 of chunk c + 1 runs in the
//   same phase as pass 2 of chunk c, so the two streams of products overlap
//   and a chunk costs two block barriers (three with the f32 split).
// - Pass 1, S = z sv^T: the warps split the d columns (k16 steps w, w + W,
//   ... for W warps); each holds its columns of z as hi and lo A fragments
//   in registers for the whole run, loaded once from global memory (rows
//   padded to 16 with zeros in registers only). sv comes in as B fragments by ldmatrix. The
//   warps' partial S tiles meet in shared memory and are summed in a fixed
//   order.
// - Weights: each thread forms one of the chunk's 16 x 16 MT weights in f32 from
//   |z|^2 and the chunk's g, ag and |sv|^2 (staged with the chunk, so no
//   global load waits between the passes), keeps its row's running sum in a
//   register, and writes w as bf16 hi and lo into a small shared tile.
// - Pass 2, acc += w sv: the warps split the d columns in pairs of n8 tiles
//   (pair p to warp p % W, so d = 120 still spreads over the warps); w comes
//   in as A fragments by ldmatrix, the same shared sv chunk as B fragments by
//   ldmatrix.trans. acc stays in registers (a warp's 16 MT rows by at most
//   64 columns).
// - Every block writes its partial sums (acc and the row sums of w) to
//   scratch that the wrapper allocates; a second kernel of the same launch
//   adds the runs' partials in order, forms grad and normalises it. No float
//   atomics, so repeated calls give the same bits.
// - Ragged edges are masked: rows past R are never written, support vectors
//   past 2N get zero weight, columns past d are zero in shared memory and in
//   the z fragments. d <= 512 (kMaxD): at most four k16 steps and four
//   column pairs a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

using tc::bf16;

constexpr int kChunk = 16;                        // support vectors per stage
constexpr int kStages = 3;                        // ring depth
constexpr int kMaxD = 512;
constexpr int kRedStride = 24;                    // floats per row of a partial S tile
constexpr int kWUnits = 3;                        // 16-byte units per row of the w tile
constexpr int kReduceWarps = 8;                   // rows (one a warp) per block of the reduction
constexpr int kAux = 3 * kChunk;                  // g, ag, |sv|^2 of a chunk, staged with it

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// The same for a pair (a in the low half), as packed bf16x2 hi and lo.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__host__ __device__ __forceinline__ int padded_d(int d) { return (d + 15) / 16 * 16; }

// Warps of a block that owns tile_rows rows: 8 for 16 rows, 16 for 32, so
// that every thread forms one weight of a chunk and a warp holds at most
// four k16 steps of z and four column pairs of acc (d <= 512).
__host__ __device__ constexpr int warps_of(int tile_rows) { return tile_rows / 2; }

// Shared memory of a block, in bytes: the ring, the f32 sets' two buffers of
// hi and lo planes, the warps' partial S tiles, the w tile (hi and lo), |z|^2, and the
// ring of each chunk's g, ag and |sv|^2.
__host__ __device__ __forceinline__ size_t smem_bytes(int d, int tile_rows, bool f32) {
  const int dp = padded_d(d);
  const int ust = tc::row_units(d);
  size_t b = (size_t)kStages * kChunk * (f32 ? dp * 4 : ust * 16);
  if (f32) b += (size_t)4 * kChunk * ust * 16;
  b += (size_t)warps_of(tile_rows) * tile_rows * kRedStride * 4;
  b += (size_t)2 * tile_rows * kWUnits * 16;
  b += (size_t)tile_rows * 4;
  b += (size_t)kStages * kAux * 4;
  return b;
}

// f32 rows first .. first + kChunk - 1 (zeros past limit and past d) into
// rows of dp floats: 16-byte cp.async when vec, else element stores.
template <int THREADS>
__device__ __forceinline__ void stage_raw(float* dst, const float* src, int first, int limit,
                                          int d, int dp, bool vec, int tid) {
  if (vec) {
    const uint32_t base = tc::smem_addr(dst);
    const int units = dp / 4;
    const float inv = 1.f / units;
    for (int i = tid; i < kChunk * units; i += THREADS) {
      const int r = tc::quot(i, inv), u = i - r * units;
      const int gr = first + r;
      const bool ok = gr < limit && 4 * u < d;
      tc::cp_async16(base + i * 16, ok ? src + (size_t)gr * d + 4 * u : src, ok);
    }
    return;
  }
  for (int i = tid; i < kChunk * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp;
    const int gr = first + r;
    dst[i] = (gr < limit && c < d) ? src[(size_t)gr * d + c] : 0.f;
  }
}

// One staged f32 chunk into its bf16 hi and lo planes (rows of ust units).
template <int THREADS>
__device__ __forceinline__ void split_chunk(const float* raw, char* hi, char* lo, int dp,
                                            int ust, int tid) {
  const int units = dp / 8;
  const float inv = 1.f / units;
  for (int i = tid; i < kChunk * units; i += THREADS) {
    const int r = tc::quot(i, inv), u = i - r * units;
    const float4 a = reinterpret_cast<const float4*>(raw)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(raw)[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_pair(v[2 * q], v[2 * q + 1], h[q], l[q]);
    const size_t off = (size_t)(r * ust + u) * 16;
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// MT: m16 tiles of rows a block owns (1 or 2). F32: the sets are f32 (split
// into hi and lo at staging), else bf16.
template <int MT, bool F32>
__global__ void __launch_bounds__(warps_of(16 * MT) * 32, MT == 1 ? 2 : 1)
rbf_warp_tc_kernel(const void* __restrict__ sv_, const float* __restrict__ g,
                   const float* __restrict__ ag, const float* __restrict__ svsq,
                   const float* __restrict__ z, float* __restrict__ part, int nk, int n2,
                   int rows, int d, int row_tiles, int per, int vec) {
  constexpr int kRows = 16 * MT;
  constexpr int kWarps = warps_of(kRows);
  constexpr int kThreads = kWarps * 32;
  constexpr int kSteps = kMaxD / 16 / kWarps;  // pass-1 k16 steps a warp holds
  constexpr int kPairs = kMaxD / 16 / kWarps;  // pass-2 column pairs a warp owns
  constexpr int kTpr = kThreads / kRows;       // threads sharing a row in the weight step
  constexpr int kPer = kChunk / kTpr;          // weights a thread forms per chunk (= MT)
  extern __shared__ uint4 smem[];
  const int dp = padded_d(d);
  const int ust = tc::row_units(d);
  const int nks = dp / 16;                     // k16 steps of pass 1, column pairs of pass 2
  const size_t stage_bytes = (size_t)kChunk * (F32 ? dp * 4 : ust * 16);
  char* ring = reinterpret_cast<char*>(smem);
  const int plane = kChunk * ust * 16;         // bytes of a split chunk's hi or lo plane
  char* op = ring + kStages * stage_bytes;     // f32 sets: two buffers of hi and lo planes
  float* red = reinterpret_cast<float*>(op + (F32 ? 4 * plane : 0));
  char* w_hi = reinterpret_cast<char*>(red + kWarps * kRows * kRedStride);
  char* w_lo = w_hi + kRows * kWUnits * 16;
  float* zsq = reinterpret_cast<float*>(w_lo + kRows * kWUnits * 16);
  float* aux = zsq + kRows;                    // kStages x (g, ag, |sv|^2) x kChunk

  const int k = blockIdx.y;
  const int split = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - split * row_tiles) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  const size_t set_elems = (size_t)k * n2 * d;
  const float* zk = z + (size_t)k * rows * d;
  const float* gk = g + (size_t)k * n2;
  const float* agk = ag + (size_t)k * n2;
  const float* sqk = svsq + (size_t)k * n2;

  const int nchunks = (n2 + kChunk - 1) / kChunk;
  const int c_begin = split * per;
  const int nc = max(0, min(nchunks, c_begin + per) - c_begin);

  auto fetch = [&](int i) {   // chunk c_begin + i into stage i % kStages
    char* dst = ring + (i % kStages) * stage_bytes;
    const int first = (c_begin + i) * kChunk;
    if (tid < kAux) {
      const int j = first + tid % kChunk;
      const float* src = tid < kChunk ? gk : tid < 2 * kChunk ? agk : sqk;
      tc::cp_async4(tc::smem_addr(aux + (i % kStages) * kAux + tid), j < n2 ? src + j : gk,
                    j < n2);
    }
    if constexpr (F32)
      stage_raw<kThreads>(reinterpret_cast<float*>(dst), static_cast<const float*>(sv_) + set_elems,
                first, n2, d, dp, vec, tid);
    else
      tc::stage_rows<kThreads>(dst, static_cast<const bf16*>(sv_) + set_elems, kChunk, first,
                               n2, d, d, tc::value_units(d), ust, vec, tid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nc) fetch(i);
    tc::cp_async_commit();
  }

  // |z|^2 of the tile's rows, in f32.
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    float s = 0.f;
    if (gr < rows)
      for (int c = lane; c < d; c += 32) {
        const float v = zk[(size_t)gr * d + c];
        s = fmaf(v, v, s);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) zsq[r] = s;
  }

  // This warp's columns of z as hi and lo A fragments (k16 steps warp + 8i).
  uint32_t za_hi[MT][kSteps][4], za_lo[MT][kSteps][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = row0 + 16 * m + gq + 8 * (q & 1);
        const int c = 16 * (warp + kWarps * i) + 2 * tq + 8 * (q >> 1);
        float v0 = 0.f, v1 = 0.f;
        if (r < rows) {
          if (c < d) v0 = zk[(size_t)r * d + c];
          if (c + 1 < d) v1 = zk[(size_t)r * d + c + 1];
        }
        split_pair(v0, v1, za_hi[m][i][q], za_lo[m][i][q]);
      }

  float acc[MT][kPairs][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][h][e] = 0.f;
  float wrow = 0.f;                       // this thread's share of its row's sum of w
  const int wr = tid / kTpr;              // the weight step's row and first vector
  const int wj = (tid % kTpr) * kPer;

  const uint32_t w_hi_a = tc::smem_addr(w_hi), w_lo_a = tc::smem_addr(w_lo);
  // The hi plane of chunk c's operand (lo follows it, f32 sets only): the ring
  // stage itself for bf16 sets, split buffer c & 1 for f32 ones.
  auto hi_of = [&](int c) -> char* {
    if constexpr (F32) return op + (c & 1) * 2 * plane;
    else return ring + (c % kStages) * stage_bytes;
  };
  auto split_of = [&](int c) {
    const float* raw = reinterpret_cast<const float*>(ring + (c % kStages) * stage_bytes);
    split_chunk<kThreads>(raw, hi_of(c), hi_of(c) + plane, dp, ust, tid);
  };

  // Pass 1 of chunk c: this warp's share of S over its k16 steps, into red.
  auto pass1 = [&](int c) {
    const uint32_t b_hi = tc::smem_addr(hi_of(c)), b_lo = b_hi + plane;
    float s[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) s[m][h][0] = s[m][h][1] = s[m][h][2] = s[m][h][3] = 0.f;
    const int key = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int ks = warp + kWarps * i;
      if (ks < nks) {
        const uint32_t off = (key * ust + 2 * ks + ((lane >> 3) & 1)) * 16;
        uint32_t bh[4];
        tc::ldsm_x4(bh, b_hi + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma16816(s[m][0], za_lo[m][i], bh[0], bh[1]);
          tc::mma16816(s[m][1], za_lo[m][i], bh[2], bh[3]);
        }
        if constexpr (F32) {
          uint32_t bl[4];
          tc::ldsm_x4(bl, b_lo + off);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            tc::mma16816(s[m][0], za_hi[m][i], bl[0], bl[1]);
            tc::mma16816(s[m][1], za_hi[m][i], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma16816(s[m][0], za_hi[m][i], bh[0], bh[1]);
          tc::mma16816(s[m][1], za_hi[m][i], bh[2], bh[3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(red + (warp * kRows + 16 * m + gq + 8 * hh) * kRedStride +
                                     8 * h + 2 * tq) =
              make_float2(s[m][h][2 * hh], s[m][h][2 * hh + 1]);
  };

  // Weights of chunk c: the warps' partials summed in order, w = ag exp(-g d2).
  auto weights = [&](int c) {
    const int j0 = (c_begin + c) * kChunk;
    const float* ax = aux + (c % kStages) * kAux;
    float wv[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = wj + e, gj = j0 + j;
      float sacc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sacc += red[(w * kRows + wr) * kRedStride + j];
      wv[e] = gj < n2 ? ax[kChunk + j] * expf(-ax[j] * (zsq[wr] - 2.f * sacc + ax[2 * kChunk + j]))
                      : 0.f;
      wrow += wv[e];
    }
    bf16* hrow = reinterpret_cast<bf16*>(w_hi + wr * kWUnits * 16);
    bf16* lrow = reinterpret_cast<bf16*>(w_lo + wr * kWUnits * 16);
#pragma unroll
    for (int e = 0; e < kPer; ++e) split_bf16(wv[e], hrow[wj + e], lrow[wj + e]);
  };

  // Pass 2 of chunk c: acc += w sv over the chunk, this warp's column pairs.
  auto pass2 = [&](int c) {
    const uint32_t b_hi = tc::smem_addr(hi_of(c)), b_lo = b_hi + plane;
    uint32_t wa_hi[MT][4], wa_lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = 16 * m + (lane & 7) + 8 * ((lane >> 3) & 1);
      const uint32_t off = (r * kWUnits + (lane >> 4)) * 16;
      tc::ldsm_x4(wa_hi[m], w_hi_a + off);
      tc::ldsm_x4(wa_lo[m], w_lo_a + off);
    }
    const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = warp + kWarps * i;
      if (p < nks) {
        const uint32_t off = (key * ust + 2 * p + (lane >> 4)) * 16;
        uint32_t bh[4];
        tc::ldsm_x4_t(bh, b_hi + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma16816(acc[m][i][0], wa_lo[m], bh[0], bh[1]);
          tc::mma16816(acc[m][i][1], wa_lo[m], bh[2], bh[3]);
        }
        if constexpr (F32) {
          uint32_t bl[4];
          tc::ldsm_x4_t(bl, b_lo + off);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            tc::mma16816(acc[m][i][0], wa_hi[m], bl[0], bl[1]);
            tc::mma16816(acc[m][i][1], wa_hi[m], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma16816(acc[m][i][0], wa_hi[m], bh[0], bh[1]);
          tc::mma16816(acc[m][i][1], wa_hi[m], bh[2], bh[3]);
        }
      }
    }
  };

  // Chunk 0's pass 1 and weights, then each step runs pass 1 of the next
  // chunk beside pass 2 of this one (two barriers a chunk, three with the
  // f32 split).
  if (nc > 0) {
    cp_async_wait<kStages - 2>();         // chunk 0 has landed (this thread's copies)
    __syncthreads();                      // (everyone's)
    if constexpr (F32) {
      split_of(0);
      __syncthreads();
    }
    pass1(0);
    __syncthreads();
    weights(0);
  }
  for (int it = 0; it < nc; ++it) {
    cp_async_wait<kStages - 3>();         // chunk it + 1 has landed (this thread's copies)
    __syncthreads();                      // w of chunk it is in place; chunk it - 1 is done
    if (it + kStages - 1 < nc) fetch(it + kStages - 1);
    tc::cp_async_commit();
    const bool next = it + 1 < nc;
    if constexpr (F32) {
      if (next) split_of(it + 1);
      __syncthreads();
    }
    if (next) pass1(it + 1);
    pass2(it);
    __syncthreads();                      // red holds chunk it + 1's partials; w is read
    if (next) weights(it + 1);
  }
  tc::cp_async_commit();
  cp_async_wait<0>();   // no copy is left in flight when the block exits

  // Partials of this run: acc (split, k, row, d) and the row sums of w after it.
  const size_t base = ((size_t)split * nk + k) * rows;
  float* pacc = part + base * d;
  const bool pair = d % 2 == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 16 * m + gq + 8 * hh;
      if (r >= rows) continue;
      float* prow = pacc + (size_t)r * d;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * (warp + kWarps * i) + 8 * h + 2 * tq;
          const float v0 = acc[m][i][h][2 * hh], v1 = acc[m][i][h][2 * hh + 1];
          if (pair && c + 1 < d) {
            *reinterpret_cast<float2*>(prow + c) = make_float2(v0, v1);
          } else {
            if (c < d) prow[c] = v0;
            if (c + 1 < d) prow[c + 1] = v1;
          }
        }
    }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) wrow += __shfl_xor_sync(0xffffffffu, wrow, off);
  const int splits = gridDim.x / row_tiles;
  if (tid % kTpr == 0 && row0 + wr < rows)
    part[(size_t)splits * nk * rows * d + base + row0 + wr] = wrow;
}

// Adds the runs' partial sums in order, forms grad and normalises it: one
// warp per row of (K, R), d <= 512 values, 16 a lane.
__global__ void __launch_bounds__(kReduceWarps * 32)
rbf_warp_reduce_kernel(const float* __restrict__ part, const float* __restrict__ z,
                       float* __restrict__ out, int nk, int rows, int d, int splits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kReduceWarps + warp;
  const size_t total = (size_t)nk * rows;
  if (row >= total) return;
  const float* pw = part + (size_t)splits * total * d;
  float wsum = 0.f;
  float gv[kMaxD / 32];
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) gv[i] = 0.f;
  // Runs in order; a run's columns all in flight at once.
  for (int s = 0; s < splits; ++s) {
    const float* prow = part + (s * total + row) * d;
    wsum += pw[s * total + row];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < d) gv[i] += prow[c];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      gv[i] = -2.f * wsum * z[row * d + c] + 2.f * gv[i];
      ss = fmaf(gv[i], gv[i], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss);
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < d) out[row * d + c] = gv[i] * inv;
  }
}

template <int MT, bool F32>
cudaError_t launch_tc(const void* sv, const float* g, const float* ag, const float* svsq,
                      const float* z, float* out, float* part, int k, int n2, int rows, int d,
                      int row_tiles, int splits, int per, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 16 * MT, F32);
  cudaError_t err = cudaFuncSetAttribute(rbf_warp_tc_kernel<MT, F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = (F32 ? d % 4 == 0 : d % 8 == 0) && tc::aligned16(sv);
  const dim3 grid((unsigned)(row_tiles * splits), (unsigned)k);
  rbf_warp_tc_kernel<MT, F32><<<grid, warps_of(16 * MT) * 32, smem, stream>>>(
      sv, g, ag, svsq, z, part, k, n2, rows, d, row_tiles, per, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)k * rows;
  rbf_warp_reduce_kernel<<<(unsigned)((total + kReduceWarps - 1) / kReduceWarps),
                           kReduceWarps * 32, 0, stream>>>(part, z, out, k, rows, d, splits);
  return cudaGetLastError();
}

template <int MT, bool F32>
int slots_of(int d) {
  const size_t smem = smem_bytes(d, 16 * MT, F32);
  cudaError_t err = cudaFuncSetAttribute(rbf_warp_tc_kernel<MT, F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rbf_warp_tc_kernel<MT, F32>,
                                                      warps_of(16 * MT) * 32, smem);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

}  // namespace

// C entry point (loaded with ctypes). sv is (K, n2, d) f32 (sv_bf16 == 0) or
// bf16 (sv_bf16 == 1); g, ag, svsq are (K, n2) f32; z and out are (K, rows, d)
// f32; part is f32 scratch of splits * K * rows * (d + 1) floats; all
// contiguous on one device. tile_rows (16 or 32), splits and chunks_per_split
// are the host's plan (ops/rbf_cuda.py::plan): every chunk of 16 vectors in
// exactly one run. Two kernels go on the stream. Returns a cudaError_t; 0 is
// success.
extern "C" int rbf_warp_launch(const void* sv, int sv_bf16, const void* g, const void* ag,
                               const void* svsq, const void* z, void* out, void* part, int k,
                               int n2, int rows, int d, int tile_rows, int splits,
                               int chunks_per_split, void* stream) {
  if (k < 0 || n2 < 0 || rows < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (tile_rows != 16 && tile_rows != 32) return (int)cudaErrorInvalidValue;
  const int nchunks = max(1, (n2 + kChunk - 1) / kChunk);
  if (splits < 1 || chunks_per_split < 1 || (splits - 1) * chunks_per_split >= nchunks ||
      splits * chunks_per_split < nchunks)
    return (int)cudaErrorInvalidValue;
  if (k == 0 || rows == 0) return (int)cudaSuccess;
  const float* gf = static_cast<const float*>(g);
  const float* agf = static_cast<const float*>(ag);
  const float* sqf = static_cast<const float*>(svsq);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (rows + tile_rows - 1) / tile_rows;
  cudaError_t err;
  if (tile_rows == 16)
    err = sv_bf16 ? launch_tc<1, false>(sv, gf, agf, sqf, zf, of, pf, k, n2, rows, d, row_tiles,
                                        splits, chunks_per_split, s)
                  : launch_tc<1, true>(sv, gf, agf, sqf, zf, of, pf, k, n2, rows, d, row_tiles,
                                       splits, chunks_per_split, s);
  else
    err = sv_bf16 ? launch_tc<2, false>(sv, gf, agf, sqf, zf, of, pf, k, n2, rows, d, row_tiles,
                                        splits, chunks_per_split, s)
                  : launch_tc<2, true>(sv, gf, agf, sqf, zf, of, pf, k, n2, rows, d, row_tiles,
                                       splits, chunks_per_split, s);
  return (int)err;
}

// Largest latent width the kernel takes (four k16 steps a warp).
extern "C" int rbf_warp_max_d() { return kMaxD; }

// Blocks of a tile of tile_rows rows the current device holds at once (its SMs
// times the blocks one SM takes at this d); minus a cudaError_t on failure.
extern "C" int rbf_warp_slots(int tile_rows, int sv_bf16, int d) {
  if (d < 1 || d > kMaxD) return -(int)cudaErrorInvalidValue;
  if (tile_rows == 16) return sv_bf16 ? slots_of<1, false>(d) : slots_of<1, true>(d);
  if (tile_rows == 32) return sv_bf16 ? slots_of<2, false>(d) : slots_of<2, true>(d);
  return -(int)cudaErrorInvalidValue;
}
