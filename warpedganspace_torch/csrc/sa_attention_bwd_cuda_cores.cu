// The CUDA-core f32 design of the SA-GAN spatial attention's backward,
// kept for comparison only.
//
// It was the port's first attention backward kernel; csrc/sa_attention_bwd.cu
// replaced it with tensor-core designs (f32 in split precision). The
// package's wrapper does not load this file: ops/attn_cuda_cores.py binds its
// C entry (sa_attention_bwd_cc_launch) for chip_smoke.py, the scripts and the
// card tests, which time or check the shipped kernel beside it.
//
// Replaces the Pallas TPU kernel
// warpedganspace_tpu/ops/attn_pallas.py::_attn_bwd_kernel: from the cotangent
// ct of out = softmax(theta phi^T) g and the forward's row statistics lse,
//
//   dbeta  = ct g^T,   ds = beta * (dbeta - rowsum(ct * out))
//   dtheta = ds phi,   dphi = ds^T theta,   dg = beta^T ct
//
// in two passes of one kernel template (query pass dtheta, key pass dphi and
// dg) after a row-dot prologue, every product accumulated in f32 on the CUDA
// cores, no atomics.
//
// Design:
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Shape checks of the entry below; cudaSuccess if the launch may go on.
static cudaError_t check_shapes(int b, int n, int m, int dk, int dv, size_t smem,
                                size_t smem_limit) {
  if (b < 0 || n < 1 || dv < 1 || m < 1 || dk < 1 || dk > cc::kMaxDk || smem > smem_limit)
    return cudaErrorInvalidValue;
  const long long qblocks = (long long)b * ((n + cc::kTileRows - 1) / cc::kTileRows);
  const long long kblocks = (long long)b * ((m + cc::kTileRows - 1) / cc::kTileRows);
  if (qblocks > 2147483647LL || kblocks > 2147483647LL || (long long)b * n > 17179869176LL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// C entry point (loaded with ctypes). theta (B, n, dk), phi (B, m, dk), g (B, m,
// dv), out and ct (B, n, dv) and the results dtheta, dphi, dg, all f32; lse
// (B, n) is the forward's f32 row statistic and rdot (B, n) f32 scratch. All
// contiguous on one device. Returns a cudaError_t; 0 is success.
extern "C" int sa_attention_bwd_cc_launch(const void* theta, const void* phi, const void* g,
                                          const void* out, const void* ct, const void* lse,
                                          void* rdot, void* dtheta, void* dphi, void* dg, int b,
                                          int n, int m, int dk, int dv, void* stream) {
  const cudaError_t err = check_shapes(b, n, m, dk, dv, sizeof(float) * cc::smem_floats(dk, dv),
                                       cc::kSmemBytes);
  if (err != cudaSuccess || b == 0) return (int)err;
  return (int)cc::launch<float>(theta, phi, g, out, ct, static_cast<const float*>(lse),
                                static_cast<float*>(rdot), dtheta, dphi, dg, b, n, m, dk, dv,
                                static_cast<cudaStream_t>(stream));
}
