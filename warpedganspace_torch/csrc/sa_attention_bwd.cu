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
// Two designs, chosen by the operands' type inside the C launch function:
// float32 on the CUDA cores (namespace cc), bfloat16 on the tensor cores
// (namespace tc, below it). Both are two passes of one kernel template with
// the roles swapped, and neither uses atomics, so the result is the same bits
// on every run.
//
// What bounds it: the five products are 2 B N M (3 dk + 2 dv) operations,
// 70.9 GFLOP at BigGAN-128's training shape (B=32, N=4096, M=1024, dk=24,
// dv=96), against about 100 MB of operands and results in f32. In f32 the
// arithmetic bounds it: about 1.06 ms at the H100 data-sheet 67 TFLOP/s
// outside the tensor cores (TF32 keeps too few bits for the f32 checks),
// against 0.03 ms for the bytes at 3.35 TB/s. In bf16, 0.072 ms at the tensor
// cores' 989 TFLOP/s; the 268 M exponentials of the two passes (16 a cycle per
// SM) take about 0.07 ms more.
//
// Both designs: the TPU kernel keeps one sample's whole phi, g, dphi and dg in
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
//   chunks. dphi and dg are accumulated in f32 registers and rounded once, at
//   the end.
// s and dbeta are therefore computed twice (2 (dk + dv) of the 2 (3 dk + 2 dv)
// least operations again); a pass that kept them would have to write them out.
// Outputs wider than a block's registers allow (dk above 64, dv above 128)
// are split into column tiles along blockIdx.y, each recomputing s and dbeta.
// Ragged edges are masked, not padded: rows past the edge are never written,
// columns past it get beta = 0, feature columns past dk or dv are zero in
// shared memory.
//
// f32 design (cc), on the CUDA cores:
// - The "row" operands (theta, ct | phi, g) of a block of 128 rows are staged
//   once in shared memory as f32, the "column" operands (phi, g | theta, ct)
//   stream through it. Each warp owns 16 rows and a (16 x 64) tile of s and
//   dbeta per chunk; a lane holds 4 rows x 8 columns of it in registers (lanes
//   as a 4 x 8 grid), so per depth step of 4 it reads 4 row vectors and 8
//   column vectors as float4s for 128 multiply-adds, from rows padded to an
//   odd number of 16-byte units (conflict-free). The statistics come straight
//   from device memory (no reduction is left to do). ds (then, in the key
//   pass, beta) goes to a warp-private tile in shared memory, and the output
//   products read it as broadcast float4s: a lane owns all 16 rows of output
//   columns lane + 32 c. ds and beta stay f32 (nearer to f32 than the plain
//   bf16 version, which rounds them).
// - A chunk is staged with 16-byte loads, four in flight per thread (one block
//   of 8 warps per SM: nothing else runs while a chunk is staged, and scalar
//   loads made one after the other cost more than the arithmetic between).
// - Limits: both row operands are resident, so dk and dv must fit the shared
//   memory together (sa_attention_bwd_max_dk, sa_attention_bwd_max_dv). dk=24,
//   dv=96 and dk=48, dv=192 (attention at 64^2 and 32^2 of a ch=96 model) fit.
//
// bf16 design (tc), on mma.sync (see the tc namespace).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"

namespace cc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // rows a block owns
constexpr int kChunk = 64;                         // streamed columns per chunk
constexpr int kPStride = 20;                       // floats per column of the ds tile:
                                                   // 16 rows + pad, 5 units of 16 bytes
constexpr int kLaneRows = 4;                       // a lane's share of its warp's 16 x 64 tile
constexpr int kLaneCols = 8;                       // of s and dbeta: 4 rows x 8 columns
constexpr int kMaxDk = 192;                        // the forward kernel's limit
constexpr int kMaxT1 = 64;                         // dk-wide output columns per block (CPT1 <= 2)
constexpr int kMaxT2 = 128;                        // dv-wide output columns per block (CPT2 <= 4)
constexpr int kSmemBytes = 227 * 1024;             // what one block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 64 && kRowsPerWarp == 16 && kLaneRows * kLaneCols == 32 &&
                  kRowsPerWarp / kLaneRows * (kChunk / kLaneCols) == 32,
              "lane and register maps assume these");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Row stride (floats) of a staged operand: an odd number of 16-byte units, so
// float4 reads of 8 consecutive rows hit 8 bank groups.
__host__ __device__ __forceinline__ int row_stride(int dp) {
  return ((dp / 4) % 2 == 1) ? dp : dp + 4;
}

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) / 4 * 4; }

__host__ __device__ __forceinline__ size_t smem_floats(int dk, int dv) {
  return (size_t)(kTileRows + kChunk) * (row_stride(round4(dk)) + row_stride(round4(dv)))
         + (size_t)kWarps * kChunk * kPStride;
}

// rdot[row] = sum_c ct[row, c] * out[row, c] = rowsum(dbeta * beta): one warp per row.
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
  acc = warp_sum(acc);
  if (lane == 0) rdot[row] = acc;
}

// 16 bytes of an operand (4 f32 values) into shared memory.
__device__ __forceinline__ void store_vec(float* dst, uint4 raw, const float*) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}

// Stage `rows` rows of a (.., d) operand as f32 into shared memory rows of
// stride `st`, zero past the operand's last row (`limit`) and last column.
// Where a row is a whole number of 16-byte vectors (the operand's base is
// aligned), a thread starts its loads four at a time before it stores any, so
// that their latencies overlap: with one block per SM nothing else runs while
// a chunk is staged.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int rows, int first,
                                           int limit, int d, int dp, int st, int tid) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int kBatch = 4;              // loads in flight per thread
  if (d % kVec == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {   // then dp == d
    const int vpr = d / kVec;
    const int total = rows * vpr;
    for (int base = 0; base < total; base += kThreads * kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        const int gr = first + i / vpr;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && gr < limit)
          raw[u] = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + (i % vpr) * kVec);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < total) store_vec(dst + (i / vpr) * st + (i % vpr) * kVec, raw[u], src);
      }
    }
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const int gr = first + r;
    for (int c = lane; c < dp; c += 32)
      dst[r * st + c] = (gr < limit && c < d) ? to_f32(src[(size_t)gr * d + c]) : 0.f;
  }
}

// acc[r][cc] += sum_j w[r][j] * x[j][col0 + lane + 32 cc] over the chunk's
// first cj columns j; w is the warp's tile, 16 row values per column.
template <int CPT>
__device__ __forceinline__ void accumulate(float (&acc)[kRowsPerWarp][CPT], const float4* pw4,
                                           const float* xs, int st, int col0, int width,
                                           int cj, int lane) {
  bool ok[CPT];
  int col[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    ok[cc] = lane + 32 * cc < width;
    col[cc] = ok[cc] ? col0 + lane + 32 * cc : 0;
  }
#pragma unroll 2
  for (int j = 0; j < cj; ++j) {
    const float4 p0 = pw4[j * (kPStride / 4)];
    const float4 p1 = pw4[j * (kPStride / 4) + 1];
    const float4 p2 = pw4[j * (kPStride / 4) + 2];
    const float4 p3 = pw4[j * (kPStride / 4) + 3];
    const float pv[kRowsPerWarp] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                                    p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
    float xv[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) xv[cc] = ok[cc] ? xs[j * st + col[cc]] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = fmaf(pv[r], xv[cc], acc[r][cc]);
  }
}

// Lane (ri, cj) holds rows 4 ri .. 4 ri + 3 and columns cj + 8 c of its warp's
// tile; the tile in shared memory keeps a column's 16 row values together.
__device__ __forceinline__ void store_tile(float* pw, const float (&v)[kLaneRows][kLaneCols],
                                           int ri, int cj) {
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c)
    *reinterpret_cast<float4*>(pw + (cj + 8 * c) * kPStride + kLaneRows * ri) =
        make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

// acc[rr][c] += a[row 4 ri + rr] . b[column cj + 8 c] over depth dp (a multiple
// of 4). Per step of 4 a lane reads 4 row vectors (4 addresses over the warp,
// multicast) and 8 column vectors (8 consecutive padded rows: conflict-free)
// for 128 multiply-adds.
__device__ __forceinline__ void tile_dot(float (&acc)[kLaneRows][kLaneCols], const float4* a4,
                                         const float4* b4, int s4, int dp, int ri, int cj) {
#pragma unroll
  for (int rr = 0; rr < kLaneRows; ++rr)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[rr][c] = 0.f;
  a4 += kLaneRows * ri * s4;
  b4 += cj * s4;
  for (int c4 = 0; c4 < dp / 4; ++c4) {
    float4 t[kLaneRows];
#pragma unroll
    for (int rr = 0; rr < kLaneRows; ++rr) t[rr] = a4[rr * s4 + c4];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const float4 f = b4[8 * c * s4 + c4];
#pragma unroll
      for (int rr = 0; rr < kLaneRows; ++rr) acc[rr][c] = dot4(t[rr], f, acc[rr][c]);
    }
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void write_rows(T* out, const float (&acc)[kRowsPerWarp][CPT],
                                           size_t sample_row0, int row0, int nrows, int d,
                                           int col0, int width, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = row0 + r;
    if (gr >= nrows) continue;  // uniform over the warp
    T* o = out + (sample_row0 + gr) * d + col0;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = lane + 32 * cc;
      if (c < width) from_f32(acc[r][cc], o + c);
    }
  }
}

// One pass. KEYS == false, the query pass: rows are queries (a1 = theta,
// a2 = ct), columns are keys (b1 = phi, b2 = g), out1 = dtheta. KEYS == true,
// the key pass: rows are keys (a1 = phi, a2 = g), columns are queries
// (b1 = theta, b2 = ct), out1 = dphi and out2 = dg. lse and rdot are per query.
// CPT1 / CPT2: out1 / out2 columns per lane; a block's column tiles are t1 and
// t2 wide, tile blockIdx.y of each (a block past an output's last tile skips it).
template <typename T, bool KEYS, int CPT1, int CPT2>
__global__ void __launch_bounds__(kThreads, 1)
sa_attention_bwd_kernel(const T* __restrict__ a1, const T* __restrict__ a2,
                        const T* __restrict__ b1, const T* __restrict__ b2,
                        const float* __restrict__ lse, const float* __restrict__ rdot,
                        T* __restrict__ out1, T* __restrict__ out2, int rtiles, int nrows,
                        int ncols, int d1, int d2, int t1, int t2) {
  extern __shared__ float4 smem4[];
  const int d1p = round4(d1), d2p = round4(d2);
  const int st1 = row_stride(d1p), st2 = row_stride(d2p);
  float* a1s = reinterpret_cast<float*>(smem4);   // kTileRows x st1
  float* b1s = a1s + kTileRows * st1;             // kChunk x st1
  float* a2s = b1s + kChunk * st1;                // kTileRows x st2
  float* b2s = a2s + kTileRows * st2;             // kChunk x st2
  float* ps = b2s + kChunk * st2;                 // kWarps x kChunk x kPStride

  const int b = blockIdx.x / rtiles;
  const int row0 = (blockIdx.x % rtiles) * kTileRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col1 = blockIdx.y * t1, w1 = min(t1, d1 - col1);   // w1 <= 0: no out1 tile here
  const int col2 = blockIdx.y * t2, w2 = min(t2, d2 - col2);
  const int nq = KEYS ? ncols : nrows;                          // queries per sample

  const T* a1b = a1 + (size_t)b * nrows * d1;
  const T* a2b = a2 + (size_t)b * nrows * d2;
  const T* b1b = b1 + (size_t)b * ncols * d1;
  const T* b2b = b2 + (size_t)b * ncols * d2;
  const float* lseb = lse + (size_t)b * nq;
  const float* rdb = rdot + (size_t)b * nq;

  stage_rows(a1s, a1b, kTileRows, row0, nrows, d1, d1p, st1, tid);
  stage_rows(a2s, a2b, kTileRows, row0, nrows, d2, d2p, st2, tid);

  const int wrow0 = row0 + warp * kRowsPerWarp;
  const int ri = lane >> 3, cj = lane & 7;   // this lane's rows 4 ri + rr, columns cj + 8 c
  // Query pass: the statistics of this lane's four rows.
  float lse_row[kLaneRows], rd_row[kLaneRows];
#pragma unroll
  for (int rr = 0; rr < kLaneRows; ++rr) {
    const int gr = wrow0 + kLaneRows * ri + rr;
    const bool ok = !KEYS && gr < nrows;
    lse_row[rr] = ok ? lseb[gr] : 0.f;
    rd_row[rr] = ok ? rdb[gr] : 0.f;
  }

  const int s41 = st1 / 4, s42 = st2 / 4;
  const float4* a14 = reinterpret_cast<const float4*>(a1s) + warp * kRowsPerWarp * s41;
  const float4* a24 = reinterpret_cast<const float4*>(a2s) + warp * kRowsPerWarp * s42;
  const float4* b14 = reinterpret_cast<const float4*>(b1s);
  const float4* b24 = reinterpret_cast<const float4*>(b2s);
  float* pw = ps + warp * kChunk * kPStride;
  const float4* pw4 = reinterpret_cast<const float4*>(pw);

  float acc1[kRowsPerWarp][CPT1];
  float acc2[kRowsPerWarp][CPT2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int cc = 0; cc < CPT1; ++cc) acc1[r][cc] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT2; ++cc) acc2[r][cc] = 0.f;
  }

  for (int j0 = 0; j0 < ncols; j0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    stage_rows(b1s, b1b, kChunk, j0, ncols, d1, d1p, st1, tid);
    stage_rows(b2s, b2b, kChunk, j0, ncols, d2, d2p, st2, tid);
    __syncthreads();  // also orders the row tiles before their first read

    // Key pass: the statistics belong to this lane's eight columns (queries).
    bool valid[kLaneCols];
    float lse_col[kLaneCols], rd_col[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int gj = j0 + cj + 8 * c;
      valid[c] = gj < ncols;
      lse_col[c] = (KEYS && valid[c]) ? lseb[gj] : 0.f;
      rd_col[c] = (KEYS && valid[c]) ? rdb[gj] : 0.f;
    }

    // beta of this lane's 4 rows x 8 columns: exp(s - lse), 0 past the edge.
    float p[kLaneRows][kLaneCols];
    tile_dot(p, a14, b14, s41, d1p, ri, cj);
#pragma unroll
    for (int rr = 0; rr < kLaneRows; ++rr)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c)
        p[rr][c] = valid[c] ? __expf(p[rr][c] - (KEYS ? lse_col[c] : lse_row[rr])) : 0.f;

    // dbeta of the same tile, then ds = beta * (dbeta - rowsum(dbeta * beta)).
    float ds[kLaneRows][kLaneCols];
    tile_dot(ds, a24, b24, s42, d2p, ri, cj);
#pragma unroll
    for (int rr = 0; rr < kLaneRows; ++rr)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c)
        ds[rr][c] = p[rr][c] * (ds[rr][c] - (KEYS ? rd_col[c] : rd_row[rr]));

    const int ncj = min(kChunk, ncols - j0);
    store_tile(pw, ds, ri, cj);
    __syncwarp();
    if (w1 > 0) accumulate<CPT1>(acc1, pw4, b1s, st1, col1, w1, ncj, lane);
    __syncwarp();  // the tile is rewritten below or in the next chunk
    if (KEYS && w2 > 0) {
      store_tile(pw, p, ri, cj);
      __syncwarp();
      accumulate<CPT2>(acc2, pw4, b2s, st2, col2, w2, ncj, lane);
      __syncwarp();
    }
  }

  const size_t sample_row0 = (size_t)b * nrows;
  if (w1 > 0) write_rows<T, CPT1>(out1, acc1, sample_row0, wrow0, nrows, d1, col1, w1, lane);
  if (KEYS && w2 > 0)
    write_rows<T, CPT2>(out2, acc2, sample_row0, wrow0, nrows, d2, col2, w2, lane);
}

template <typename T, bool KEYS, int CPT1, int CPT2>
cudaError_t launch_pass(const T* a1, const T* a2, const T* b1, const T* b2, const float* lse,
                        const float* rdot, T* out1, T* out2, int b, int nrows, int ncols,
                        int d1, int d2, int t1, int t2, int ytiles, size_t smem,
                        cudaStream_t stream) {
  auto kernel = sa_attention_bwd_kernel<T, KEYS, CPT1, CPT2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rtiles = (nrows + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)rtiles, ytiles);
  kernel<<<grid, kThreads, smem, stream>>>(a1, a2, b1, b2, lse, rdot, out1, out2, rtiles,
                                           nrows, ncols, d1, d2, t1, t2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* theta_, const void* phi_, const void* g_, const void* out_,
                   const void* ct_, const float* lse, float* rdot, void* dtheta_, void* dphi_,
                   void* dg_, int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  const T* theta = static_cast<const T*>(theta_);
  const T* phi = static_cast<const T*>(phi_);
  const T* g = static_cast<const T*>(g_);
  const T* ct = static_cast<const T*>(ct_);
  T* dtheta = static_cast<T*>(dtheta_);
  T* dphi = static_cast<T*>(dphi_);
  T* dg = static_cast<T*>(dg_);
  const size_t smem = sizeof(float) * smem_floats(dk, dv);

  const long long rows = (long long)b * n;
  rowdot_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      ct, static_cast<const T*>(out_), rdot, rows, dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Equal column tiles of at most kMaxT1 (dk-wide outputs) and kMaxT2 (dg).
  const int nt1 = (dk + kMaxT1 - 1) / kMaxT1, t1 = (dk + nt1 - 1) / nt1;
  const int nt2 = (dv + kMaxT2 - 1) / kMaxT2, t2 = (dv + nt2 - 1) / nt2;
  const bool wide1 = t1 > 32, wide2 = t2 > 96;

  // Query pass: dtheta.
  err = wide1 ? launch_pass<T, false, 2, 1>(theta, ct, phi, g, lse, rdot, dtheta, nullptr, b,
                                            n, m, dk, dv, t1, t2, nt1, smem, stream)
              : launch_pass<T, false, 1, 1>(theta, ct, phi, g, lse, rdot, dtheta, nullptr, b,
                                            n, m, dk, dv, t1, t2, nt1, smem, stream);
  if (err != cudaSuccess) return err;

  // Key pass: dphi and dg.
  const int yt = nt1 > nt2 ? nt1 : nt2;
#define WGS_KEY_PASS(C1, C2)                                                              \
  launch_pass<T, true, C1, C2>(phi, g, theta, ct, lse, rdot, dphi, dg, b, m, n, dk, dv, t1, \
                               t2, yt, smem, stream)
  if (wide1) return wide2 ? WGS_KEY_PASS(2, 4) : WGS_KEY_PASS(2, 3);
  return wide2 ? WGS_KEY_PASS(1, 4) : WGS_KEY_PASS(1, 3);
#undef WGS_KEY_PASS
}


}  // namespace cc

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
// - Shared memory: 128 + 2 x 64 rows (the row tile and two chunk buffers) of
//   dk and dv values, 73 KB at dk=24, dv=96.
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

__host__ __device__ __forceinline__ size_t smem_bytes(int dk, int dv) {
  return (size_t)(kTileRows + 2 * kChunk) * (row_units(dk) + row_units(dv)) * 16  // rows, chunks
         + (size_t)2 * 2 * kChunk * sizeof(float);                              // 2 x lse, rdot
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

  const int b = blockIdx.x / rtiles;
  const int row0 = (blockIdx.x % rtiles) * kTileRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int col1 = blockIdx.y * t1, w1 = min(t1, d1 - col1);   // w1 <= 0: no out1 tile here
  const int col2 = blockIdx.y * t2, w2 = min(t2, d2 - col2);
  const int nt1 = w1 > 0 ? value_units(w1) : 0;                // n8 tiles computed
  const int nt2 = (KEYS && w2 > 0) ? value_units(w2) : 0;
  const int nq = KEYS ? ncols : nrows;                          // queries per sample

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

// Column tiles of at most `most` columns, each a multiple of 16 (whole pairs
// of n8 tiles); returns the tile width and sets the number of tiles.
inline int column_tiles(int d, int most, int* ntiles) {
  const int nt = (d + most - 1) / most;
  const int t = value_units((d + nt - 1) / nt) * 8;
  *ntiles = (d + t - 1) / t;
  return t;
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

  const long long rows = (long long)b * n;
  cc::rowdot_kernel<bf16><<<(unsigned)((rows + cc::kWarps - 1) / cc::kWarps), cc::kThreads, 0,
                            stream>>>(ct, static_cast<const bf16*>(out_), rdot, rows, dv);
  cudaError_t err = cudaGetLastError();
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

// Largest dk the kernel takes: the forward kernel's.
extern "C" int sa_attention_bwd_max_dk() { return cc::kMaxDk; }

// Largest dv the kernel takes beside this dk, for either operand type (both
// row operands are resident in shared memory: the f32 design's limit binds,
// the bf16 design's tiles are smaller); 0 if dk itself does not fit.
extern "C" int sa_attention_bwd_max_dv(int dk) {
  if (dk < 1 || dk > cc::kMaxDk) return 0;
  int best = 0;
  for (int dv = 4; dv <= 4096; dv += 4)
    if (sizeof(float) * cc::smem_floats(dk, dv) <= (size_t)cc::kSmemBytes &&
        tc::smem_bytes(dk, dv) <= (size_t)tc::kSmemBytes)
      best = dv;
  return best;
}

// Which design serves an operand type: the tensor cores for bf16, the CUDA
// cores for f32.
extern "C" const char* sa_attention_bwd_design(int is_bf16) {
  return is_bf16 ? "tensor cores, mma.sync bf16" : "CUDA cores";
}

// C entry point (loaded with ctypes). theta (B, n, dk), phi (B, m, dk),
// g (B, m, dv), out and ct (B, n, dv) and the results dtheta, dphi, dg (shaped
// as theta, phi, g) are all f32 (is_bf16 == 0, the CUDA-core design) or all
// bf16 (is_bf16 == 1, the tensor-core design); lse (B, n) is the forward
// kernel's f32 row statistic and rdot (B, n) f32 scratch. All contiguous on
// one device. Returns a cudaError_t; 0 is success.
extern "C" int sa_attention_bwd_launch(const void* theta, const void* phi, const void* g,
                                       const void* out, const void* ct, const void* lse,
                                       void* rdot, void* dtheta, void* dphi, void* dg,
                                       int is_bf16, int b, int n, int m, int dk, int dv,
                                       void* stream) {
  if (b < 0 || n < 1 || dv < 1 || m < 1 || dk < 1 || dk > cc::kMaxDk)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 ? tc::smem_bytes(dk, dv) > (size_t)tc::kSmemBytes
              : sizeof(float) * cc::smem_floats(dk, dv) > (size_t)cc::kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const long long qblocks = (long long)b * ((n + tc::kTileRows - 1) / tc::kTileRows);
  const long long kblocks = (long long)b * ((m + tc::kTileRows - 1) / tc::kTileRows);
  if (qblocks > 2147483647LL || kblocks > 2147483647LL || (long long)b * n > 17179869176LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rdot);
  const cudaError_t err = is_bf16
      ? tc::launch(theta, phi, g, out, ct, l, r, dtheta, dphi, dg, b, n, m, dk, dv, s)
      : cc::launch<float>(theta, phi, g, out, ct, l, r, dtheta, dphi, dg, b, n, m, dk, dv, s);
  return (int)err;
}
