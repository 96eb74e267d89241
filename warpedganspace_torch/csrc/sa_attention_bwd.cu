// Backward of the SA-GAN spatial attention (BigGAN's non-local block) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// warpedganspace_tpu/ops/attn_pallas.py::_attn_bwd_kernel. With
//
//   s    = theta phi^T              (B, N, M), no scale
//   beta = softmax_m(s)
//   out  = beta g                   the forward, csrc/sa_attention.cu
//
// and the cotangent ct of out, it computes
//
//   dbeta  = ct g^T
//   ds     = beta * (dbeta - rowsum(dbeta * beta))
//   dtheta = ds phi       dphi = ds^T theta       dg = beta^T ct
//
// with every product accumulated in f32, on f32 or bf16 operands. No (B, N, M)
// matrix reaches device memory: beta is recomputed from the row statistics
// the forward kernel saved (lse = max + log(sum), one f32 per query), and
// rowsum(dbeta * beta) equals rowsum(ct * out), one dot product per query (the
// first small kernel below).
//
// Two designs, chosen by the operands' type inside the C launch function,
// both on the tensor cores: float32 in split precision (namespace tf, at the
// end), bfloat16 as it is (namespace tc). The CUDA-core float32 design that
// came first is kept for comparison only, in
// csrc/sa_attention_bwd_cuda_cores.cu. All are two passes of one kernel
// template with the roles swapped, and none uses atomics, so the result is
// the same bits on every run.
//
// What bounds it: the five products are 2 B N M (3 dk + 2 dv) operations,
// 70.9 GFLOP at BigGAN-128's training shape (B=32, N=4096, M=1024, dk=24,
// dv=96), against about 100 MB of operands and results in f32. One TF32
// product keeps too few bits for the float32 checks; three TF32 products of
// split operands hold them (tests/test_torch_attn_f32_split_numerics.py):
// three times the least arithmetic at the tensor cores' 495 TFLOP/s in TF32,
// 0.43 ms, against 0.14 ms for one product, 0.03 ms for the bytes at
// 3.35 TB/s and 1.06 ms for the same products on the CUDA cores (67 TFLOP/s).
// In bf16, 0.072 ms at the tensor cores' 989 TFLOP/s; the 268 M exponentials
// of the two passes (16 a cycle per SM) take about 0.07 ms more.
//
// All designs: the TPU kernel keeps one sample's whole phi, g, dphi and dg in
// VMEM while its grid sweeps that sample's query blocks in order, and adds
// each block's share of dphi and dg into the resident buffers. Here g alone
// (384 KB in f32) exceeds the 227 KB of shared memory a block may use, and
// blocks run in no order. So the work is two passes of ONE kernel template,
// each block owning its outputs' whole reduction:
// - query pass: a block owns a tile of queries of one sample and streams the
//   keys in chunks of 64; it recomputes s and dbeta for its (rows x chunk)
//   tile, forms ds and accumulates dtheta = ds phi over all chunks;
// - key pass: a block owns a tile of keys of one sample and streams the
//   queries in chunks of 64; it recomputes the transposed tiles s^T and
//   dbeta^T and accumulates dphi = ds^T theta and dg = beta^T ct over all
//   chunks, in f32 registers (the f32 design adds them into the outputs
//   every few chunks).
// s and dbeta are therefore computed twice (2 (dk + dv) of the 2 (3 dk + 2 dv)
// least operations again); a pass that kept them would have to write them out.
// Outputs wider than a block's registers allow (dk above 64, dv above 128)
// are split into column tiles along blockIdx.y, each recomputing s and dbeta.
// Ragged edges are masked, not padded: rows past the edge are never written,
// columns past it get beta = 0, feature columns past dk or dv are zero in
// shared memory.
//
// bf16 design (tc) and f32 design (tf), on mma.sync (see their namespaces).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

// rdot[row] = sum_c ct[row, c] * out[row, c] = rowsum(dbeta * beta): the
// prologue of both designs, one warp per row.
namespace rowdot {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ ct, const T* __restrict__ out, float* __restrict__ rdot,
              long long rows, int dv) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const T* a = ct + row * dv;
  const T* b = out + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32) acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) rdot[row] = acc;
}

template <typename T>
cudaError_t launch(const T* ct, const T* out, float* rdot, long long rows, int dv,
                   cudaStream_t stream) {
  rowdot_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      ct, out, rdot, rows, dv);
  return cudaGetLastError();
}

}  // namespace rowdot

// ---------------------------------------------------------------------------
// bf16 design: both passes on the tensor cores.
//
// - One block of 8 warps owns 128 rows; a warp owns 16 rows. Each streamed
//   chunk serves 128 rows, half the chunk bytes from L2 that 64-row blocks
//   read (8 % faster at the BigGAN training shape; measured by
//   scripts/ablate_attention_cuda.py, as are the steps below).
// - The query pass takes a chunk of 64 columns in two steps of 32, the key
//   pass in one of 64: per step the 16 x 32 (16 x 64) tiles of s and dbeta
//   are 16 (32) f32 registers a lane each in the mma.sync accumulator layout.
//   Steps of 32 bring the query pass to 128 registers (two blocks an SM); the
//   key pass, whose 48 dg accumulators keep it above 168 registers either
//   way, would only pay the A fragments' second read.
// - The row operands (theta and ct in the query pass, phi and g in the key
//   pass) are staged once in shared memory and read by ldmatrix as A
//   fragments at every chunk. In registers they would take 4 (dk + dv) / 16
//   registers a lane beside the accumulators (56 at dk=24, dv=224, which the
//   f32 design takes too), so shared memory keeps one instantiation per
//   output width; the A reads are 8 of a chunk's 48 ldmatrix at dk=24, dv=96.
// - The column operands stream through two shared buffers filled by 16-byte
//   cp.async (element loads where a row is not a whole number of 16-byte
//   units): the next chunk is in flight while the current one is multiplied.
//   In the key pass the chunk's lse and rdot come along by 4-byte cp.async.
//   Staged rows are padded to an odd number of 16-byte units (ldmatrix
//   conflict-free), with zeros past dk or dv up to a multiple of 16.
// - Per chunk: S = A1 B1^T and dP = A2 B2^T by mma.sync m16n8k16 (bf16
//   operands, f32 accumulation; B by ldmatrix); P = exp(S - lse), which is
//   beta itself (no running maximum); dS = P (dP - rdot). dS, rounded to
//   bf16, is packed from the accumulator layout straight into A fragments, and
//   out1 += dS B1 reads B1 by ldmatrix.trans (dtheta = ds phi in the query
//   pass, dphi = ds^T theta in the key pass). In the key pass also
//   out2 += P B2 with P rounded to bf16 (dg = beta^T ct).
// - Rounding points are those of the plain bf16 version and the TPU kernel:
//   ds and beta rounded to bf16 before their products, every product
//   accumulated in f32, each output rounded once. (rowsum(dbeta * beta) is
//   taken from the forward's bf16 output, as in the f32 design.)
// - The tensor cores' f32 accumulation rounds toward zero, so one chain of
//   mma.sync over all of N (dphi, dg: 256 products at N=4096) shrinks the
//   key pass's gradients: signed mean error against float64 -1.24e-5 and
//   -7.9e-6, 2.1x the plain bf16 version's (16 draws at the BigGAN training
//   shape on an H100, scripts/measure_attention_bf16_error.py). Every
//   kSumChunks chunks each lane adds its accumulators into f32 sums of its own
//   in shared memory and starts them again from 0 (-8.4e-6 and -4.1e-6, 1.4x
//   and 1.1x; 3 % more time there); the outputs are the sums, rounded once.
//   The order is fixed, so repeats stay bit-equal.
// - Shared memory: 128 + 2 x 64 rows (the row tile and two chunk buffers) of
//   dk and dv values and the lanes' sums, 137 KB in the key pass and 89 KB in
//   the query pass at dk=24, dv=96.
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;   // rows a block owns, 16 per warp
// Columns of a chunk taken at a time, by pass: the query pass holds 16 x 32
// tiles of s and dbeta, the key pass 16 x 64.
constexpr int kQueryStep = 32;
constexpr int kKeyStep = 64;
constexpr int kMaxT1 = 64;               // dk-wide output columns per block (<= 8 n8 tiles)
constexpr int kMaxT2 = 128;              // dv-wide output columns per block (<= 16 n8 tiles)
constexpr int kSmemBytes = 227 * 1024;
// Chunks between two additions of the accumulators into the sums.
constexpr int kSumChunks = 4;

__host__ __device__ __forceinline__ size_t smem_bytes(int dk, int dv) {
  return (size_t)(kTileRows + 2 * kChunk) * (row_units(dk) + row_units(dv)) * 16  // rows, chunks
         + (size_t)2 * 2 * kChunk * sizeof(float);                              // 2 x lse, rdot
}

// Column tiles of at most `most` columns, each a multiple of 16 (whole pairs
// of n8 tiles); returns the tile width and sets the number of tiles.
__host__ __device__ __forceinline__ int column_tiles(int d, int most, int* ntiles) {
  const int nt = (d + most - 1) / most;
  const int t = value_units((d + nt - 1) / nt) * 8;
  *ntiles = (d + t - 1) / t;
  return t;
}

// The lanes' f32 sums of the n8 tiles a pass keeps (16 bytes a lane a tile).
__host__ __device__ __forceinline__ size_t sums_bytes(int n8_tiles) {
  return (size_t)kThreads * n8_tiles * 16;
}

// A launch's shared memory: the key pass's, whose sums hold dphi's and dg's
// column tiles (the query pass's hold dtheta's alone).
__host__ __device__ __forceinline__ size_t smem_bytes_launch(int dk, int dv) {
  int nt1, nt2;
  return smem_bytes(dk, dv) + sums_bytes(value_units(column_tiles(dk, kMaxT1, &nt1)) +
                                         value_units(column_tiles(dv, kMaxT2, &nt2)));
}

// One pass. KEYS == false, the query pass: rows are queries (a1 = theta,
// a2 = ct), columns are keys (b1 = phi, b2 = g), out1 = dtheta. KEYS == true,
// the key pass: rows are keys (a1 = phi, a2 = g), columns are queries
// (b1 = theta, b2 = ct), out1 = dphi and out2 = dg. lse and rdot are per query.
// NT1 / NT2: n8 tiles of the widest out1 / out2 column tile (t1, t2 wide, both
// multiples of 16); a block computes tile blockIdx.y of each, and skips an
// output past its last tile. vec: bit i set if operand i (a1, a2, b1, b2) is
// staged by 16-byte cp.async.
template <bool KEYS, int NT1, int NT2>
__global__ void __launch_bounds__(kThreads)
sa_attention_bwd_tc_kernel(const bf16* __restrict__ a1, const bf16* __restrict__ a2,
                           const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                           const float* __restrict__ lse, const float* __restrict__ rdot,
                           bf16* __restrict__ out1, bf16* __restrict__ out2, int rtiles,
                           int nrows, int ncols, int d1, int d2, int t1, int t2, int vec) {
  extern __shared__ uint4 smem[];
  const int u1 = row_units(d1), u2 = row_units(d2);
  const int ks1 = value_units(d1) / 2, ks2 = value_units(d2) / 2;   // k16 steps
  char* a1s = reinterpret_cast<char*>(smem);          // kTileRows rows x u1 units
  char* a2s = a1s + kTileRows * u1 * 16;              // kTileRows rows x u2 units
  char* bs = a2s + kTileRows * u2 * 16;               // 2 x (kChunk x u1, kChunk x u2)
  const int bstride = kChunk * (u1 + u2) * 16;        // bytes of one chunk buffer
  float* stats = reinterpret_cast<float*>(bs + 2 * bstride);   // 2 x (lse[64], rdot[64])
  // The lanes' sums: tile t of out1 at (t * kThreads + tid), then out2's.
  float4* sums1 = reinterpret_cast<float4*>(stats + 4 * kChunk);

  const int b = blockIdx.x / rtiles;
  const int row0 = (blockIdx.x % rtiles) * kTileRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int col1 = blockIdx.y * t1, w1 = min(t1, d1 - col1);   // w1 <= 0: no out1 tile here
  const int col2 = blockIdx.y * t2, w2 = min(t2, d2 - col2);
  const int nt1 = w1 > 0 ? value_units(w1) : 0;                // n8 tiles computed
  const int nt2 = (KEYS && w2 > 0) ? value_units(w2) : 0;
  const int nq = KEYS ? ncols : nrows;                          // queries per sample
  float4* sums2 = sums1 + (size_t)nt1 * kThreads;

  const bf16* a1b = a1 + (size_t)b * nrows * d1;
  const bf16* a2b = a2 + (size_t)b * nrows * d2;
  const bf16* b1b = b1 + (size_t)b * ncols * d1;
  const bf16* b2b = b2 + (size_t)b * ncols * d2;
  const float* lseb = lse + (size_t)b * nq;
  const float* rdb = rdot + (size_t)b * nq;

  // The row tile, in the same copy group as the first chunk.
  stage_rows<kThreads>(a1s, a1b, kTileRows, row0, nrows, d1, d1, value_units(d1), u1, vec & 1,
                       tid);
  stage_rows<kThreads>(a2s, a2b, kTileRows, row0, nrows, d2, d2, value_units(d2), u2, vec & 2,
                       tid);

  auto fetch = [&](int c) {
    char* buf = bs + (c & 1) * bstride;
    stage_rows<kThreads>(buf, b1b, kChunk, c * kChunk, ncols, d1, d1, value_units(d1), u1,
                         vec & 4, tid);
    stage_rows<kThreads>(buf + kChunk * u1 * 16, b2b, kChunk, c * kChunk, ncols, d2, d2,
                         value_units(d2), u2, vec & 8, tid);
    if (KEYS) {   // lse of the chunk's queries, then their rdot
      for (int i = tid; i < 2 * kChunk; i += kThreads) {
        const int q = c * kChunk + (i & (kChunk - 1));
        const float* src = i < kChunk ? lseb : rdb;
        cp_async4(smem_addr(stats + (c & 1) * 2 * kChunk + i), q < ncols ? src + q : src,
                  q < ncols);
      }
    }
  };

  // Query pass: the statistics of this lane's rows r and r + 8, times log2(e).
  const int r0 = row0 + warp * 16 + gq;
  float lse_r[2] = {0.f, 0.f}, rd_r[2] = {0.f, 0.f};
  if (!KEYS) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < nrows) {
        lse_r[h] = lseb[r0 + 8 * h] * kLog2e;
        rd_r[h] = rdb[r0 + 8 * h];
      }
  }

  float acc1[NT1][4], acc2[NT2][4];
#pragma unroll
  for (int t = 0; t < NT1; ++t) acc1[t][0] = acc1[t][1] = acc1[t][2] = acc1[t][3] = 0.f;
#pragma unroll
  for (int t = 0; t < NT2; ++t) acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;

  // ldmatrix lane addresses: A fragment rows of this warp, B rows of a pair of
  // n8 column tiles (non-transposed), B rows of a k16 step (transposed).
  const int a_row = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), a_unit = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_unit = (lane >> 3) & 1;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_unit = lane >> 4;
  const uint32_t a1a = smem_addr(a1s), a2a = smem_addr(a2s), bsa = smem_addr(bs);

  // The accumulators added into this lane's sums (written, the first time),
  // then started again from 0.
  bool flushed = false;
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < NT1; ++t)
      if (t < nt1) {
        float4 v = make_float4(acc1[t][0], acc1[t][1], acc1[t][2], acc1[t][3]);
        if (flushed) {
          const float4 p = sums1[t * kThreads + tid];
          v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
        }
        sums1[t * kThreads + tid] = v;
        acc1[t][0] = acc1[t][1] = acc1[t][2] = acc1[t][3] = 0.f;
      }
#pragma unroll
    for (int t = 0; t < NT2; ++t)
      if (t < nt2) {
        float4 v = make_float4(acc2[t][0], acc2[t][1], acc2[t][2], acc2[t][3]);
        if (flushed) {
          const float4 p = sums2[t * kThreads + tid];
          v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
        }
        sums2[t * kThreads + tid] = v;
        acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;
      }
    flushed = true;
  };

  const int nchunks = (ncols + kChunk - 1) / kChunk;
  fetch(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) fetch(c + 1);   // into the buffer no warp reads in this chunk
    cp_async_commit();
    cp_async_wait_one();                 // the row tile and chunk c have landed
    __syncthreads();
    const uint32_t b1a = bsa + (c & 1) * bstride;
    const uint32_t b2a = b1a + kChunk * u1 * 16;

    const float* st = stats + (c & 1) * 2 * kChunk;
    constexpr int kStep = KEYS ? kKeyStep : kQueryStep;
    constexpr int kTiles = kStep / 8;     // n8 tiles of s and dbeta per step
#pragma unroll 1
    for (int hc = 0; hc < kChunk; hc += kStep) {   // first chunk column of the step
      // S = A1 B1^T and dP = A2 B2^T, 16 rows x kStep columns each.
      float s[kTiles][4], dp[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      for (int kk = 0; kk < ks1; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a1a + (a_row * u1 + 2 * kk + a_unit) * 16);
#pragma unroll
        for (int np = 0; np < kTiles / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, b1a + ((hc + 16 * np + b_row) * u1 + 2 * kk + b_unit) * 16);
          mma16816(s[2 * np], af, bf[0], bf[1]);
          mma16816(s[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      for (int kk = 0; kk < ks2; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a2a + (a_row * u2 + 2 * kk + a_unit) * 16);
#pragma unroll
        for (int np = 0; np < kTiles / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, b2a + ((hc + 16 * np + b_row) * u2 + 2 * kk + b_unit) * 16);
          mma16816(dp[2 * np], af, bf[0], bf[1]);
          mma16816(dp[2 * np + 1], af, bf[2], bf[3]);
        }
      }

      // beta = exp(s - lse) and ds = beta (dbeta - rdot), 0 past the last
      // column; both rounded to bf16 into A fragments (column tiles 2kk and
      // 2kk + 1 of the step are the k16 step kk of the output products).
      uint32_t pa[kTiles / 2][4], da[kTiles / 2][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int col = hc + 8 * j + 2 * tq;     // chunk column of s[j][0], s[j][2]
        float lc[2] = {0.f, 0.f}, rc[2] = {0.f, 0.f};
        if (KEYS) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + col);
          const float2 r2 = *reinterpret_cast<const float2*>(st + kChunk + col);
          lc[0] = l2.x * kLog2e;
          lc[1] = l2.y * kLog2e;
          rc[0] = r2.x;
          rc[1] = r2.y;
        }
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, w = e & 1;
          const bool valid = c * kChunk + col + w < ncols;
          const float l = KEYS ? lc[w] : lse_r[h];
          const float r = KEYS ? rc[w] : rd_r[h];
          p[e] = valid ? ex2(fmaf(s[j][e], kLog2e, -l)) : 0.f;
          d[e] = valid ? p[e] * (dp[j][e] - r) : 0.f;
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16x2(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p[2], p[3]);
        da[j >> 1][2 * (j & 1)] = pack_bf16x2(d[0], d[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(d[2], d[3]);
      }

      // out1 += dS B1 over the step's columns (B1 rows are the k index).
#pragma unroll
      for (int kk = 0; kk < kTiles / 2; ++kk) {
#pragma unroll
        for (int np = 0; np < NT1 / 2; ++np) {
          if (2 * np < nt1) {
            uint32_t bf[4];
            ldsm_x4_t(bf, b1a + ((hc + 16 * kk + t_row) * u1 + col1 / 8 + 2 * np + t_unit) * 16);
            mma16816(acc1[2 * np], da[kk], bf[0], bf[1]);
            mma16816(acc1[2 * np + 1], da[kk], bf[2], bf[3]);
          }
        }
      }
      // Key pass: out2 += P B2.
      if (KEYS) {
#pragma unroll
        for (int kk = 0; kk < kTiles / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < NT2 / 2; ++np) {
            if (2 * np < nt2) {
              uint32_t bf[4];
              ldsm_x4_t(bf,
                        b2a + ((hc + 16 * kk + t_row) * u2 + col2 / 8 + 2 * np + t_unit) * 16);
              mma16816(acc2[2 * np], pa[kk], bf[0], bf[1]);
              mma16816(acc2[2 * np + 1], pa[kk], bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();   // the buffer is refilled in the next chunk
    if ((c + 1) % kSumChunks == 0 && c + 1 < nchunks) flush();
  }
  if (flushed) flush();   // the last chunks' products into the sums, read back below
#pragma unroll
  for (int t = 0; t < NT1; ++t)
    if (flushed && t < nt1) {
      const float4 v = sums1[t * kThreads + tid];
      acc1[t][0] = v.x, acc1[t][1] = v.y, acc1[t][2] = v.z, acc1[t][3] = v.w;
    }
#pragma unroll
  for (int t = 0; t < NT2; ++t)
    if (flushed && t < nt2) {
      const float4 v = sums2[t * kThreads + tid];
      acc2[t][0] = v.x, acc2[t][1] = v.y, acc2[t][2] = v.z, acc2[t][3] = v.w;
    }

  // Each output rounded once; rows past the edge are not written.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nrows) continue;
    const size_t grow = (size_t)b * nrows + r;
    if (nt1 > 0) {
      bf16* orow = out1 + grow * d1 + col1;
#pragma unroll
      for (int t = 0; t < NT1; ++t)
        if (t < nt1)
          store_pair(orow, 8 * t + 2 * tq, w1, acc1[t][2 * h], acc1[t][2 * h + 1], d1 % 2 == 0);
    }
    if (nt2 > 0) {
      bf16* orow = out2 + grow * d2 + col2;
#pragma unroll
      for (int t = 0; t < NT2; ++t)
        if (t < nt2)
          store_pair(orow, 8 * t + 2 * tq, w2, acc2[t][2 * h], acc2[t][2 * h + 1], d2 % 2 == 0);
    }
  }
}

template <bool KEYS, int NT1, int NT2>
cudaError_t launch_pass(const bf16* a1, const bf16* a2, const bf16* b1, const bf16* b2,
                        const float* lse, const float* rdot, bf16* out1, bf16* out2, int b,
                        int nrows, int ncols, int d1, int d2, int t1, int t2, int ytiles,
                        size_t smem, cudaStream_t stream) {
  auto kernel = sa_attention_bwd_tc_kernel<KEYS, NT1, NT2>;
  // The lanes' sums of the tiles this pass keeps.
  smem += sums_bytes(value_units(t1) + (KEYS ? value_units(t2) : 0));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = (d1 % 8 == 0 && aligned16(a1) ? 1 : 0) | (d2 % 8 == 0 && aligned16(a2) ? 2 : 0) |
                  (d1 % 8 == 0 && aligned16(b1) ? 4 : 0) | (d2 % 8 == 0 && aligned16(b2) ? 8 : 0);
  const int rtiles = (nrows + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)rtiles, ytiles);
  kernel<<<grid, kThreads, smem, stream>>>(a1, a2, b1, b2, lse, rdot, out1, out2, rtiles, nrows,
                                           ncols, d1, d2, t1, t2, vec);
  return cudaGetLastError();
}

template <int NT1>
cudaError_t key_pass(const bf16* phi, const bf16* g, const bf16* theta, const bf16* ct,
                     const float* lse, const float* rdot, bf16* dphi, bf16* dg, int b, int n,
                     int m, int dk, int dv, int t1, int t2, int ytiles, size_t smem,
                     cudaStream_t stream) {
  const int nv = value_units(t2);
#define WGS_KEY_PASS(NT2)                                                                   \
  launch_pass<true, NT1, NT2>(phi, g, theta, ct, lse, rdot, dphi, dg, b, m, n, dk, dv, t1, t2, \
                              ytiles, smem, stream)
  if (nv <= 4) return WGS_KEY_PASS(4);
  if (nv <= 8) return WGS_KEY_PASS(8);
  if (nv <= 12) return WGS_KEY_PASS(12);
  return WGS_KEY_PASS(16);
#undef WGS_KEY_PASS
}

cudaError_t launch(const void* theta_, const void* phi_, const void* g_, const void* out_,
                   const void* ct_, const float* lse, float* rdot, void* dtheta_, void* dphi_,
                   void* dg_, int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  const bf16* theta = static_cast<const bf16*>(theta_);
  const bf16* phi = static_cast<const bf16*>(phi_);
  const bf16* g = static_cast<const bf16*>(g_);
  const bf16* ct = static_cast<const bf16*>(ct_);
  bf16* dtheta = static_cast<bf16*>(dtheta_);
  bf16* dphi = static_cast<bf16*>(dphi_);
  bf16* dg = static_cast<bf16*>(dg_);
  const size_t smem = smem_bytes(dk, dv);

  cudaError_t err =
      rowdot::launch(ct, static_cast<const bf16*>(out_), rdot, (long long)b * n, dv, stream);
  if (err != cudaSuccess) return err;

  int nt1, nt2;
  const int t1 = column_tiles(dk, kMaxT1, &nt1);
  const int t2 = column_tiles(dv, kMaxT2, &nt2);
  const bool wide1 = t1 > 32;

  // Query pass: dtheta.
  err = wide1 ? launch_pass<false, 8, 2>(theta, ct, phi, g, lse, rdot, dtheta, nullptr, b, n, m,
                                         dk, dv, t1, t2, nt1, smem, stream)
              : launch_pass<false, 4, 2>(theta, ct, phi, g, lse, rdot, dtheta, nullptr, b, n, m,
                                         dk, dv, t1, t2, nt1, smem, stream);
  if (err != cudaSuccess) return err;

  // Key pass: dphi and dg.
  const int yt = nt1 > nt2 ? nt1 : nt2;
  return wide1 ? key_pass<8>(phi, g, theta, ct, lse, rdot, dphi, dg, b, n, m, dk, dv, t1, t2, yt,
                             smem, stream)
               : key_pass<4>(phi, g, theta, ct, lse, rdot, dphi, dg, b, n, m, dk, dv, t1, t2, yt,
                             smem, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 design: both passes on the tensor cores in split precision.
//
// The bf16 design above with float32 operands carried as 3xTF32 pieces on
// mma.sync m16n8k8 (csrc/tc_tf32.cuh): all five products (s, dbeta, dtheta,
// dphi, dg) are three TF32 products each (lo hi, hi lo, hi hi) into f32
// accumulators, which holds the float32 checks where one TF32 product does not
// (tests/test_torch_attn_f32_split_numerics.py).
// - The same two passes of one template, the same row-dot prologue, no
//   atomics (repeats are bit-equal); s and dbeta recomputed from the saved lse.
// - The row operands are staged once in shared memory as float32 and read as
//   split A fragments at every step. The column operands stream through shared
//   memory in chunks of 64 (cp.async, 16 or 4 bytes a copy). Rows are padded
//   to an odd number of 16-byte units (conflict-free scalar fragment loads).
// - Where the shared memory holds them (REC; dk=24 with dv up to 96, 223 KB),
//   each landed chunk is split once by the block into 16-byte records of B
//   fragments (tc_tf32.cuh), one set for the s and dbeta products and one for
//   the output products, and the next chunk's copies start while this one is
//   multiplied: no warp splits a column value, where without records each of
//   the 8 warps splits every value it reads. Otherwise one chunk buffer, split
//   as read, whose next chunk is fetched after the current one is used (two
//   buffers were no faster, scripts/ablate_attention_cuda.py); it sets the dv
//   limit (264 at dk=24).
// - Both passes take a chunk in steps of 32 columns: s and dbeta of 16 x 32
//   are 32 f32 registers a lane. ds and beta stay float32 values (no rounding
//   to a narrower type) and are split from the accumulator registers straight
//   into A fragments, one k8 step per n8 tile, with the step's columns in the
//   permuted order of tc_tf32.cuh; the B fragments of the output products are
//   the chunk rows of the same columns.
// - Each k8 step sweeps its tiles three times (every lo hi product, every hi
//   lo, every hi hi), so that no product waits for the one before it. s sums
//   its steps as the forward kernel does (apart above dk = 32), so that beta
//   is recomputed by the same sums as the forward's lse. At one key dtheta and
//   dphi are set to 0 after the passes (the softmax is constant).
// - The accumulators are added into the outputs in float32 every kFlushChunks
//   chunks and start again from 0: the tensor cores' float32 accumulation
//   rounds toward zero, so a chain over all of N (the key pass) or M would
//   shrink the gradients. The order is fixed, so repeats stay bit-equal.
namespace tf {

using namespace tc;   // the shared helpers of tc_bf16.cuh and tc_tf32.cuh

constexpr int kWarps = 8;               // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;   // rows a block owns
constexpr int kStep = 32;                // columns of a chunk taken at a time
constexpr int kMaxT1 = 64;               // dk-wide output columns per block (<= 8 n8 tiles)
constexpr int kMaxT2 = 128;              // dg columns a block takes (<= 16 n8 tiles)
constexpr int kMaxDk = 192;              // the forward kernel's
constexpr int kSmemBytes = 227 * 1024;

// Shared memory of a pass: the row tile, one chunk buffer and the chunk's lse
// and rdot (the key pass's).
__host__ __device__ constexpr size_t smem_bytes(int dk, int dv) {
  return (size_t)(kTileRows + kChunk) * (f32_row_units(dk) + f32_row_units(dv)) * 16
         + (size_t)2 * kChunk * sizeof(float);
}

// The same with records: the chunk's records for the s and dbeta products
// (k_records) and the output products (pair_records), and a copy of its
// statistics.
__host__ __device__ constexpr size_t smem_bytes_rec(int dk, int dv) {
  return smem_bytes(dk, dv) + (size_t)2 * kChunk * sizeof(float)
         + (size_t)kChunk * (k_records(dk) + k_records(dv)) * 16
         + (size_t)(kChunk / 2) * (pair_records(dk) + pair_records(dv)) * 16;
}

// One pass, as the bf16 design's: KEYS == false, the query pass (rows are
// queries: a1 = theta, a2 = ct; columns are keys: b1 = phi, b2 = g; out1 =
// dtheta); KEYS == true, the key pass (rows are keys: a1 = phi, a2 = g;
// columns are queries: b1 = theta, b2 = ct; out1 = dphi, out2 = dg). NT1 /
// NT2: n8 tiles of the widest out1 / out2 column tile (t1, t2 wide, multiples
// of 8). REC: the chunks as records. vec: bit i set if operand i (a1, a2,
// b1, b2) is staged by 16-byte copies.
template <bool KEYS, int NT1, int NT2, bool REC>
__global__ void __launch_bounds__(kThreads)
sa_attention_bwd_tf_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                           const float* __restrict__ b1, const float* __restrict__ b2,
                           const float* __restrict__ lse, const float* __restrict__ rdot,
                           float* __restrict__ out1, float* __restrict__ out2, int rtiles,
                           int nrows, int ncols, int d1, int d2, int t1, int t2, int vec) {
  extern __shared__ uint4 smem[];
  const int s1 = 4 * f32_row_units(d1), s2 = 4 * f32_row_units(d2);   // row strides, floats
  const int ks1 = (d1 + 7) / 8, ks2 = (d2 + 7) / 8;                    // k8 steps
  float* a1s = reinterpret_cast<float*>(smem);   // kTileRows rows x s1
  float* a2s = a1s + kTileRows * s1;             // kTileRows rows x s2
  float* bs = a2s + kTileRows * s2;              // kChunk x s1, kChunk x s2
  float* stats = bs + kChunk * (s1 + s2);        // lse[64], rdot[64]
  // REC: the statistics' copy, then the records.
  float* stc = stats + 2 * kChunk;
  const int rk1 = k_records(d1), rk2 = k_records(d2);
  const int rn1 = pair_records(d1), rn2 = pair_records(d2);
  uint4* k1rec = reinterpret_cast<uint4*>(stc + 2 * kChunk);   // kChunk x rk1
  uint4* k2rec = k1rec + kChunk * rk1;                          // kChunk x rk2
  uint4* n1rec = k2rec + kChunk * rk2;                          // kChunk / 2 x rn1
  uint4* n2rec = n1rec + (kChunk / 2) * rn1;                    // kChunk / 2 x rn2

  const int b = blockIdx.x / rtiles;
  const int row0 = (blockIdx.x % rtiles) * kTileRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int col1 = blockIdx.y * t1, w1 = min(t1, d1 - col1);   // w1 <= 0: no out1 tile here
  const int col2 = blockIdx.y * t2, w2 = min(t2, d2 - col2);
  const int nt1 = w1 > 0 ? (w1 + 7) / 8 : 0;                   // n8 tiles computed
  const int nt2 = (KEYS && w2 > 0) ? (w2 + 7) / 8 : 0;
  const int nq = KEYS ? ncols : nrows;                          // queries per sample

  const float* a1b = a1 + (size_t)b * nrows * d1;
  const float* a2b = a2 + (size_t)b * nrows * d2;
  const float* b1b = b1 + (size_t)b * ncols * d1;
  const float* b2b = b2 + (size_t)b * ncols * d2;
  const float* lseb = lse + (size_t)b * nq;
  const float* rdb = rdot + (size_t)b * nq;

  // The row tile, in the same copy group as the first chunk.
  stage_rows_f32<kThreads>(a1s, a1b, kTileRows, row0, nrows, d1, d1, f32_units(d1), s1 / 4,
                           vec & 1, tid);
  stage_rows_f32<kThreads>(a2s, a2b, kTileRows, row0, nrows, d2, d2, f32_units(d2), s2 / 4,
                           vec & 2, tid);

  auto fetch_chunk = [&](int c) {
    stage_rows_f32<kThreads>(bs, b1b, kChunk, c * kChunk, ncols, d1, d1, f32_units(d1),
                             s1 / 4, vec & 4, tid);
    stage_rows_f32<kThreads>(bs + kChunk * s1, b2b, kChunk, c * kChunk, ncols, d2, d2,
                             f32_units(d2), s2 / 4, vec & 8, tid);
    if (KEYS) {   // lse of the chunk's queries, then their rdot
      for (int i = tid; i < 2 * kChunk; i += kThreads) {
        const int q = c * kChunk + (i & (kChunk - 1));
        const float* src = i < kChunk ? lseb : rdb;
        cp_async4(smem_addr(stats + i), q < ncols ? src + q : src,
                  q < ncols);
      }
    }
  };
  // REC: the landed chunk as records, each value split once; the statistics copied.
  auto split_chunk = [&]() {
    const float* r1 = bs;
    const float* r2 = bs + kChunk * s1;
    auto k_side = [&](const float* raw, int st, int ks, int rk, uint4* rec) {
      const int np = 4 * ks;
      const float inv = 1.f / np;
      for (int i = tid; i < kChunk * np; i += kThreads) {
        const int col = quot(i, inv), r = i - col * np;
        const float* src = raw + col * st + 8 * (r >> 2) + (r & 3);
        rec[col * rk + r] = split_pair(src[0], src[4]);
      }
    };
    auto n_side = [&](const float* raw, int st, int ks, int rn, uint4* rec) {
      const int ng = 8 * ks;
      const float inv = 1.f / ng;
      for (int i = tid; i < (kChunk / 2) * ng; i += kThreads) {
        const int pr = quot(i, inv), c = i - pr * ng;
        const float* src = raw + 2 * pr * st + c;
        rec[pr * rn + c] = split_pair(src[0], src[st]);
      }
    };
    k_side(r1, s1, ks1, rk1, k1rec);
    k_side(r2, s2, ks2, rk2, k2rec);
    n_side(r1, s1, ks1, rn1, n1rec);
    if (KEYS) {
      n_side(r2, s2, ks2, rn2, n2rec);
      for (int i = tid; i < 2 * kChunk; i += kThreads) stc[i] = stats[i];
    }
  };

  // Query pass: the statistics of this lane's rows r and r + 8, lse times log2(e).
  const int r0 = row0 + warp * 16 + gq;
  float lse_r[2] = {0.f, 0.f}, rd_r[2] = {0.f, 0.f};
  if (!KEYS) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < nrows) {
        lse_r[h] = lseb[r0 + 8 * h] * kLog2e;
        rd_r[h] = rdb[r0 + 8 * h];
      }
  }

  float acc1[NT1][4], acc2[NT2][4];
#pragma unroll
  for (int t = 0; t < NT1; ++t) acc1[t][0] = acc1[t][1] = acc1[t][2] = acc1[t][3] = 0.f;
#pragma unroll
  for (int t = 0; t < NT2; ++t) acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;

  // This warp's A fragment rows in the row tile.
  const float* a1w = a1s + (warp * 16 + gq) * s1 + tq;
  const float* a2w = a2s + (warp * 16 + gq) * s2 + tq;

  // The accumulators added into the outputs in float32 (out += acc; rows
  // past the edge are not written), then started again from 0.
  bool flushed = false;   // the outputs hold partial sums
  auto flush = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const size_t grow = (size_t)b * nrows + r;
      float* orow1 = out1 + grow * d1 + col1;
#pragma unroll
      for (int t = 0; t < NT1; ++t)
        if (t < nt1 && r < nrows) {
          const int col = 8 * t + 2 * tq;
          const float2 prev =
              flushed ? load_pair(orow1, col, w1, d1 % 2 == 0) : make_float2(0.f, 0.f);
          store_pair(orow1, col, w1, prev.x + acc1[t][2 * h], prev.y + acc1[t][2 * h + 1],
                     d1 % 2 == 0);
        }
      if (!KEYS) continue;   // out2 (dg) is the key pass's
      float* orow2 = out2 + grow * d2 + col2;
#pragma unroll
      for (int t = 0; t < NT2; ++t)
        if (t < nt2 && r < nrows) {
          const int col = 8 * t + 2 * tq;
          const float2 prev =
              flushed ? load_pair(orow2, col, w2, d2 % 2 == 0) : make_float2(0.f, 0.f);
          store_pair(orow2, col, w2, prev.x + acc2[t][2 * h], prev.y + acc2[t][2 * h + 1],
                     d2 % 2 == 0);
        }
    }
#pragma unroll
    for (int t = 0; t < NT1; ++t) acc1[t][0] = acc1[t][1] = acc1[t][2] = acc1[t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < NT2; ++t) acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;
    flushed = true;
  };

  const int nchunks = (ncols + kChunk - 1) / kChunk;
  fetch_chunk(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();                 // the row tile and chunk c have landed
    __syncthreads();                     // (everyone's), and the records are free
    if (REC) {
      split_chunk();
      __syncthreads();                   // the records are written, the buffer free
      if (c + 1 < nchunks) fetch_chunk(c + 1);   // in flight while this chunk is multiplied
      cp_async_commit();
    }
    const float* b1c = bs;
    const float* b2c = bs + kChunk * s1;
    const float* st = REC ? stc : stats;

    constexpr int kTiles = kStep / 8;     // n8 tiles of s and dbeta per step
#pragma unroll 1
    for (int hc = 0; hc < kChunk; hc += kStep) {   // first chunk column of the step
      // S = A1 B1^T and dP = A2 B2^T, 16 rows x kStep columns each.
      float s[kTiles][4], dp[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      for (int k8 = 0; k8 < ks1; ++k8) {
        const float* ar = a1w + 8 * k8;
        const FragA af = frag_a(ar[0], ar[8 * s1], ar[4], ar[8 * s1 + 4]);
        if (REC) {
          uint4 bq[kTiles];
#pragma unroll
          for (int j = 0; j < kTiles; ++j) bq[j] = k1rec[(hc + 8 * j + gq) * rk1 + 4 * k8 + tq];
          mma3_records<kTiles>(s, af, bq, kTiles);
        } else {
          float b0[kTiles], b1[kTiles];
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            const float* br = b1c + (hc + 8 * j + gq) * s1 + 8 * k8 + tq;
            b0[j] = br[0];
            b1[j] = br[4];
          }
          if (ks1 > kChainSteps)   // as the forward kernel sums the logits above dk = 32
            mma3_tiles_add<kTiles>(s, af, b0, b1, kTiles);
          else
            mma3_tiles<kTiles>(s, af, b0, b1, kTiles);
        }
      }
      for (int k8 = 0; k8 < ks2; ++k8) {
        const float* ar = a2w + 8 * k8;
        const FragA af = frag_a(ar[0], ar[8 * s2], ar[4], ar[8 * s2 + 4]);
        if (REC) {
          uint4 bq[kTiles];
#pragma unroll
          for (int j = 0; j < kTiles; ++j) bq[j] = k2rec[(hc + 8 * j + gq) * rk2 + 4 * k8 + tq];
          mma3_records<kTiles>(dp, af, bq, kTiles);
        } else {
          float b0[kTiles], b1[kTiles];
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            const float* br = b2c + (hc + 8 * j + gq) * s2 + 8 * k8 + tq;
            b0[j] = br[0];
            b1[j] = br[4];
          }
          mma3_tiles<kTiles>(dp, af, b0, b1, kTiles);
        }
      }

      // Per n8 tile j (a k8 step of the output products): beta = exp(s - lse)
      // and ds = beta (dbeta - rdot), 0 past the last column, split into A
      // fragments with columns 2tq (k tq) and 2tq + 1 (k tq + 4).
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int col = hc + 8 * j + 2 * tq;     // chunk column of s[j][0], s[j][2]
        float lc[2] = {0.f, 0.f}, rc[2] = {0.f, 0.f};
        if (KEYS) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + col);
          const float2 r2 = *reinterpret_cast<const float2*>(st + kChunk + col);
          lc[0] = l2.x * kLog2e;
          lc[1] = l2.y * kLog2e;
          rc[0] = r2.x;
          rc[1] = r2.y;
        }
        float beta[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, w = e & 1;
          const bool valid = c * kChunk + col + w < ncols;
          const float l = KEYS ? lc[w] : lse_r[h];
          const float r = KEYS ? rc[w] : rd_r[h];
          beta[e] = valid ? ex2(fmaf(s[j][e], kLog2e, -l)) : 0.f;
          dsv[e] = valid ? beta[e] * (dp[j][e] - r) : 0.f;
        }
        // out1 += dS B1 (B1 rows are the k index: the chunk rows of these columns).
        const FragA da = frag_a(dsv[0], dsv[2], dsv[1], dsv[3]);
        const int pair = hc / 2 + 4 * j + tq;   // the chunk rows 2 pair, 2 pair + 1
        if (REC) {
          const uint4* k1 = n1rec + pair * rn1 + col1 + gq;
          uint4 c0[NT1];
#pragma unroll
          for (int t = 0; t < NT1; ++t)
            if (t < nt1) c0[t] = k1[8 * t];
          mma3_records<NT1>(acc1, da, c0, nt1);
        } else {
          const float* k1 = b1c + 2 * pair * s1 + col1 + gq;
          float c0[NT1], c1[NT1];
#pragma unroll
          for (int t = 0; t < NT1; ++t)
            if (t < nt1) {
              c0[t] = k1[8 * t];
              c1[t] = k1[s1 + 8 * t];
            }
          mma3_tiles<NT1>(acc1, da, c0, c1, nt1);
        }
        // Key pass: out2 += P B2.
        if (KEYS) {
          const FragA pa = frag_a(beta[0], beta[2], beta[1], beta[3]);
          if (REC) {
            const uint4* k2 = n2rec + pair * rn2 + col2 + gq;
            uint4 e0[NT2];
#pragma unroll
            for (int t = 0; t < NT2; ++t)
              if (t < nt2) e0[t] = k2[8 * t];
            mma3_records<NT2>(acc2, pa, e0, nt2);
          } else {
            const float* k2 = b2c + 2 * pair * s2 + col2 + gq;
            float e0[NT2], e1[NT2];
#pragma unroll
            for (int t = 0; t < NT2; ++t)
              if (t < nt2) {
                e0[t] = k2[8 * t];
                e1[t] = k2[s2 + 8 * t];
              }
            mma3_tiles<NT2>(acc2, pa, e0, e1, nt2);
          }
        }
      }
    }
    if (!REC) {
      __syncthreads();   // the buffer is refilled
      if (c + 1 < nchunks) fetch_chunk(c + 1);
      cp_async_commit();
    }
    if ((c + 1) % kFlushChunks == 0 || c + 1 == nchunks) flush();
  }
}

template <bool KEYS, int NT1, int NT2, bool REC>
cudaError_t launch_pass(const float* a1, const float* a2, const float* b1, const float* b2,
                        const float* lse, const float* rdot, float* out1, float* out2, int b,
                        int nrows, int ncols, int d1, int d2, int t1, int t2, int ytiles,
                        cudaStream_t stream) {
  auto kernel = sa_attention_bwd_tf_kernel<KEYS, NT1, NT2, REC>;
  const size_t smem = REC ? smem_bytes_rec(d1, d2) : smem_bytes(d1, d2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = (d1 % 4 == 0 && aligned16(a1) ? 1 : 0) | (d2 % 4 == 0 && aligned16(a2) ? 2 : 0) |
                  (d1 % 4 == 0 && aligned16(b1) ? 4 : 0) | (d2 % 4 == 0 && aligned16(b2) ? 8 : 0);
  const int rtiles = (nrows + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)rtiles, ytiles);
  kernel<<<grid, kThreads, smem, stream>>>(a1, a2, b1, b2, lse, rdot, out1, out2, rtiles, nrows,
                                           ncols, d1, d2, t1, t2, vec);
  return cudaGetLastError();
}

// Column tiles of at most `most` columns, each a multiple of 8 (whole n8
// tiles); returns the tile width and sets the number of tiles.
inline int column_tiles(int d, int most, int* ntiles) {
  const int nt = (d + most - 1) / most;
  const int t = ((d + nt - 1) / nt + 7) & ~7;
  *ntiles = (d + t - 1) / t;
  return t;
}

// The two passes. With records (dk <= 32 and dv <= 96: BigGAN's training
// shape): one dk-wide column tile of at most 4 n8 tiles, dg tiles of up to 8
// or 12 n8 tiles. Without: dk-wide tiles of up to 8, dg tiles of up to 8 or 16.
template <bool REC>
cudaError_t passes(const float* theta, const float* phi, const float* g, const float* ct,
                   const float* lse, const float* rdot, float* dtheta, float* dphi, float* dg,
                   int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  int nt1, nt2;
  const int t1 = column_tiles(dk, kMaxT1, &nt1);
  const int t2 = column_tiles(dv, kMaxT2, &nt2);
  const int yt = nt1 > nt2 ? nt1 : nt2;
  const bool narrow2 = (t2 + 7) / 8 <= 8;
  constexpr int NT1 = REC ? 4 : 8;
  constexpr int NT2 = REC ? 12 : 16;

  // Query pass: dtheta; then the key pass: dphi and dg.
  cudaError_t err = launch_pass<false, NT1, 1, REC>(theta, ct, phi, g, lse, rdot, dtheta, nullptr,
                                                    b, n, m, dk, dv, t1, t2, nt1, stream);
  if (err != cudaSuccess) return err;
  return narrow2 ? launch_pass<true, NT1, 8, REC>(phi, g, theta, ct, lse, rdot, dphi, dg, b, m,
                                                  n, dk, dv, t1, t2, yt, stream)
                 : launch_pass<true, NT1, NT2, REC>(phi, g, theta, ct, lse, rdot, dphi, dg, b,
                                                    m, n, dk, dv, t1, t2, yt, stream);
}

cudaError_t launch(const void* theta_, const void* phi_, const void* g_, const void* out_,
                   const void* ct_, const float* lse, float* rdot, void* dtheta_, void* dphi_,
                   void* dg_, int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  const float* theta = static_cast<const float*>(theta_);
  const float* phi = static_cast<const float*>(phi_);
  const float* g = static_cast<const float*>(g_);
  const float* ct = static_cast<const float*>(ct_);
  float* dtheta = static_cast<float*>(dtheta_);
  float* dphi = static_cast<float*>(dphi_);
  float* dg = static_cast<float*>(dg_);

  cudaError_t err =
      rowdot::launch(ct, static_cast<const float*>(out_), rdot, (long long)b * n, dv, stream);
  if (err != cudaSuccess) return err;

  const bool rec = dk <= 32 && dv <= 96 && smem_bytes_rec(dk, dv) <= (size_t)kSmemBytes;
  err = rec ? passes<true>(theta, phi, g, ct, lse, rdot, dtheta, dphi, dg, b, n, m, dk, dv, stream)
            : passes<false>(theta, phi, g, ct, lse, rdot, dtheta, dphi, dg, b, n, m, dk, dv,
                            stream);
  if (err != cudaSuccess || m > 1) return err;
  // One key: beta is 1 and ds = dbeta - rowsum(dbeta beta) is exactly 0, so
  // dtheta and dphi are 0, where dbeta (split products) less rdot (the f32 row
  // dot) leaves their last bits.
  err = cudaMemsetAsync(dtheta, 0, (size_t)b * n * dk * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(dphi, 0, (size_t)b * m * dk * sizeof(float), stream);
}

}  // namespace tf

// Largest dk the kernel takes: the forward kernel's.
extern "C" int sa_attention_bwd_max_dk() { return tf::kMaxDk; }

// Largest dv the kernel takes beside this dk: the smaller of the two designs'
// limits. Both keep both row operands resident in shared memory; the f32
// design's limit is that of one chunk buffer without records. 0 if dk itself
// does not fit.
extern "C" int sa_attention_bwd_max_dv(int dk) {
  if (dk < 1 || dk > tf::kMaxDk) return 0;
  int best = 0;
  for (int dv = 4; dv <= 4096; dv += 4)
    if (tc::smem_bytes_launch(dk, dv) <= (size_t)tc::kSmemBytes &&
        tf::smem_bytes(dk, dv) <= (size_t)tf::kSmemBytes)
      best = dv;
  return best;
}

// Which design serves an operand type: both run on the tensor cores, bf16
// operands as they are, f32 operands in split precision.
extern "C" const char* sa_attention_bwd_design(int is_bf16) {
  return is_bf16 ? "tensor cores, mma.sync bf16" : "tensor cores, mma.sync 3xTF32";
}

// Shape checks of the entry below; cudaSuccess if the launch may go on.
static cudaError_t check_shapes(int b, int n, int m, int dk, int dv, size_t smem,
                                size_t smem_limit) {
  if (b < 0 || n < 1 || dv < 1 || m < 1 || dk < 1 || dk > tf::kMaxDk || smem > smem_limit)
    return cudaErrorInvalidValue;
  const long long qblocks = (long long)b * ((n + tc::kTileRows - 1) / tc::kTileRows);
  const long long kblocks = (long long)b * ((m + tc::kTileRows - 1) / tc::kTileRows);
  if (qblocks > 2147483647LL || kblocks > 2147483647LL || (long long)b * n > 17179869176LL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// C entry point (loaded with ctypes). theta (B, n, dk), phi (B, m, dk),
// g (B, m, dv), out and ct (B, n, dv) and the results dtheta, dphi, dg (shaped
// as theta, phi, g) are all f32 (is_bf16 == 0, the split-precision
// tensor-core design tf) or all bf16 (is_bf16 == 1, the bf16 tensor-core
// design tc); lse (B, n) is the forward kernel's f32 row statistic and rdot
// (B, n) f32 scratch. All contiguous on one device. Returns a cudaError_t; 0
// is success.
extern "C" int sa_attention_bwd_launch(const void* theta, const void* phi, const void* g,
                                       const void* out, const void* ct, const void* lse,
                                       void* rdot, void* dtheta, void* dphi, void* dg,
                                       int is_bf16, int b, int n, int m, int dk, int dv,
                                       void* stream) {
  cudaError_t err = is_bf16 ? check_shapes(b, n, m, dk, dv, tc::smem_bytes_launch(dk, dv),
                                           tc::kSmemBytes)
                            : check_shapes(b, n, m, dk, dv, tf::smem_bytes(dk, dv),
                                           tf::kSmemBytes);
  if (err != cudaSuccess || b == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rdot);
  err = is_bf16 ? tc::launch(theta, phi, g, out, ct, l, r, dtheta, dphi, dg, b, n, m, dk, dv, s)
                : tf::launch(theta, phi, g, out, ct, l, r, dtheta, dphi, dg, b, n, m, dk, dv, s);
  return (int)err;
}
