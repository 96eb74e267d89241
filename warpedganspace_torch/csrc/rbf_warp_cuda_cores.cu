// The CUDA-core design of the all-sets RBF warp, kept for comparison only.
//
// It was the port's first warp kernel; csrc/rbf_warp.cu replaced it with a
// tensor-core design. No wrapper of the package loads this file:
// scripts/ablate_warp_cuda.py compiles it and times it beside the shipped
// kernel (C entry rbf_warp_cc_launch, one launch, no scratch).
//
// All-sets RBF warp directions for Hopper (sm_90a), one pass over the sets.
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
// weights are bounded by |alpha| * gamma, so no running max is needed.
//
// What bounds it: at the production shape (K=200, 2N=1024, d=512, R=64 rows)
// the set read is 419 MB in f32 (210 MB in bf16), about 0.125 ms at the H100
// data-sheet 3.35 TB/s, while the two contractions are 2 * K * R * 2N * d =
// 13.4 G FMAs, about 0.4 ms at the data-sheet 67 TFLOP/s of f32 outside the
// tensor cores. This design stays on the CUDA cores in f32, so the FMAs bound
// it; the tiling below keeps both contractions FMA-bound rather than bound by
// shared-memory reads, and the sv loads overlap the arithmetic.
//
// Design:
// - One block (8 warps) per (tile of TR=32 rows, set k); blockIdx.x walks the
//   row tiles so the blocks of one set run side by side and share sv_k in L2.
// - The z tile is staged once in shared memory; sv_k is streamed through
//   shared memory in chunks of CJ=32 support vectors (converted to f32), and
//   the next chunk's global loads are issued into registers while the
//   current chunk is computed on. This loop takes the place of the TPU's
//   resident sv block. Each row's whole 2N reduction stays inside its block,
//   so nothing crosses blocks.
// - Pass 1 (distances, TR x CJ): the 8 warps split the d columns; each lane
//   holds a 4-row x 8-vector register tile, reading float4s of z and sv from
//   rows padded so that its reads are conflict-free. The warps' partial sums
//   meet in shared memory, where the weights are formed.
// - Pass 2 (accumulation, TR x d): warp w owns columns [64w, 64w + 64); each
//   lane holds an 8-row x 8-column register tile, so d <= 512.
// - Ragged edges are masked, not padded: rows past R are never written (no
//   rsqrt(0) rows), support vectors past 2N get zero weight, columns past d
//   are zero in shared memory.
// - Tensor cores (wgmma / mma.sync), TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 32;                  // TR
constexpr int kChunk = 32;                     // CJ
constexpr int kMaxD = 512;                     // 8 warps x 64 pass-2 columns
constexpr int kSlots = kMaxD / kThreads;       // staged columns per thread
constexpr int kRedStride = kChunk + 1;         // padded row of pass-1 partial sums
static_assert(kTileRows == 32 && kChunk == 32, "the weight step maps lanes to rows");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Row stride (floats) of the staged z and sv rows: an odd number of 16-byte
// units, so float4 reads of 8 consecutive rows hit 8 different bank groups.
__host__ __device__ __forceinline__ int row_stride(int dp) {
  return ((dp / 4) % 2 == 1) ? dp : dp + 4;
}

__host__ __device__ __forceinline__ size_t smem_floats(int dp) {
  return (size_t)(kTileRows + kChunk) * row_stride(dp)   // z tile, sv chunk
         + (size_t)kWarps * kTileRows * kRedStride       // pass-1 partial sums
         + (size_t)kChunk * kTileRows                    // weights ws[j][r]
         + kTileRows                                     // |z|^2
         + (size_t)kWarps * kTileRows;                   // row-norm partials
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rbf_warp_kernel(const T* __restrict__ sv, const float* __restrict__ g,
                const float* __restrict__ ag, const float* __restrict__ svsq,
                const float* __restrict__ z, float* __restrict__ out,
                int n2, int rows, int d, int dp) {
  extern __shared__ float4 smem4[];
  const int st = row_stride(dp);
  float* zs = reinterpret_cast<float*>(smem4);      // kTileRows x st
  float* svs = zs + kTileRows * st;                 // kChunk x st
  float* red = svs + kChunk * st;                   // kWarps x kTileRows x kRedStride
  float* ws = red + kWarps * kTileRows * kRedStride;  // kChunk x kTileRows
  float* zsq = ws + kChunk * kTileRows;             // kTileRows
  float* rn = zsq + kTileRows;                      // kWarps x kTileRows

  const int k = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* zk = z + (size_t)k * rows * d;
  const T* svk = sv + (size_t)k * n2 * d;
  const float* gk = g + (size_t)k * n2;
  const float* agk = ag + (size_t)k * n2;
  const float* sqk = svsq + (size_t)k * n2;

  for (int r = 0; r < kTileRows; ++r) {
    const int gr = row0 + r;
    for (int c = tid; c < dp; c += kThreads)
      zs[r * st + c] = (gr < rows && c < d) ? zk[(size_t)gr * d + c] : 0.f;
  }

  // Registers that stage one sv chunk on its way to shared memory.
  T pre[kChunk][kSlots];
  auto load_chunk = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const bool valid = j0 + jj < n2;
      const T* src = svk + (size_t)(j0 + jj) * d;
#pragma unroll
      for (int cc = 0; cc < kSlots; ++cc) {
        const int c = tid + cc * kThreads;
        pre[jj][cc] = (valid && c < d) ? src[c] : static_cast<T>(0.f);
      }
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
      for (int cc = 0; cc < kSlots; ++cc) {
        const int c = tid + cc * kThreads;
        if (c < dp) svs[jj * st + c] = to_f32(pre[jj][cc]);
      }
  };
  load_chunk(0);
  store_chunk();
  __syncthreads();

  for (int i = 0; i < kTileRows / kWarps; ++i) {
    const int r = warp * (kTileRows / kWarps) + i;
    float s = 0.f;
    for (int c = lane; c < dp; c += 32) s = fmaf(zs[r * st + c], zs[r * st + c], s);
    s = warp_sum(s);
    if (lane == 0) zsq[r] = s;
  }  // zsq is read after the next barrier

  const int d4 = dp / 4;
  const int st4 = st / 4;
  const float4* zs4 = reinterpret_cast<const float4*>(zs);
  const float4* svs4 = reinterpret_cast<const float4*>(svs);
  // Pass-1 tile: rows rg + 8i (i < 4) x vectors cg + 4v (v < 8).
  const int rg = lane >> 2, cg = lane & 3;
  // Pass-2 tile: rows 8 rg2 + i (i < 8) x columns col + 32h + e (h < 2, e < 4).
  const int rg2 = lane >> 3;
  const int col = 64 * warp + 4 * (lane & 7);

  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[i][h][0] = acc[i][h][1] = acc[i][h][2] = acc[i][h][3] = 0.f;
  float wsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int j0 = 0; j0 < n2; j0 += kChunk) {
    const bool has_next = j0 + kChunk < n2;

    // Pass 1: partial z.sv over this warp's share of the columns.
    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < 8; ++v) p[i][v] = 0.f;
    for (int k4 = warp; k4 < d4; k4 += kWarps) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = zs4[(rg + 8 * i) * st4 + k4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 b[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) b[v] = svs4[(cg + 4 * (4 * h + v)) * st4 + k4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) p[i][4 * h + v] = dot4(a[i], b[v], p[i][4 * h + v]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        red[(warp * kTileRows + rg + 8 * i) * kRedStride + cg + 4 * v] = p[i][v];
    __syncthreads();

    // The next chunk's loads are issued here, after pass 1's register peak,
    // and land while the weights and pass 2 are computed.
    if (has_next) load_chunk(j0 + kChunk);

    // Weights: sum the warps' partials, then w = ag exp(-g d2) into ws[j][r].
#pragma unroll
    for (int m = 0; m < kTileRows * kChunk / kThreads; ++m) {
      const int idx = tid + kThreads * m;
      const int j = idx >> 5, r = idx & 31;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(w * kTileRows + r) * kRedStride + j];
      const int gj = j0 + j;
      float wv = 0.f;
      if (gj < n2) wv = agk[gj] * expf(-gk[gj] * (zsq[r] - 2.f * s + sqk[gj]));
      ws[j * kTileRows + r] = wv;
    }
    __syncthreads();

    // Pass 2: acc[r][c] += w[r][j] * sv[j][c] over the chunk.
    const int cj = min(kChunk, n2 - j0);
#pragma unroll 4
    for (int jj = 0; jj < cj; ++jj) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + jj * kTileRows + 8 * rg2);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + jj * kTileRows + 8 * rg2 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) wsum[i] += wv[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col + 32 * h;
        if (c < dp) {
          const float4 b = *reinterpret_cast<const float4*>(svs + jj * st + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][h][0] = fmaf(wv[i], b.x, acc[i][h][0]);
            acc[i][h][1] = fmaf(wv[i], b.y, acc[i][h][1]);
            acc[i][h][2] = fmaf(wv[i], b.z, acc[i][h][2]);
            acc[i][h][3] = fmaf(wv[i], b.w, acc[i][h][3]);
          }
        }
      }
    }
    __syncthreads();  // every read of this chunk is done
    if (has_next) {
      store_chunk();
      __syncthreads();
    }
  }

  // Epilogue: grad = -2 wsum z + 2 acc, normalised over each row's d columns.
  float nrm[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * rg2 + i;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col + 32 * h;
      if (c < dp) {
        const float4 zv = *reinterpret_cast<const float4*>(zs + r * st + c);
        const float zc[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][h][e] = -2.f * wsum[i] * zc[e] + 2.f * acc[i][h][e];
          s = fmaf(acc[i][h][e], acc[i][h][e], s);
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);  // the 8 lanes of this row group
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    nrm[i] = s;
  }
  if ((lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) rn[warp * kTileRows + 8 * rg2 + i] = nrm[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * rg2 + i;
    const int gr = row0 + r;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rn[w * kTileRows + r];
    if (gr >= rows) continue;
    const float inv = rsqrtf(s);
    float* o = out + ((size_t)k * rows + gr) * d;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + 32 * h + e;
        if (c < d) o[c] = acc[i][h][e] * inv;
      }
  }
}

template <typename T>
cudaError_t launch(const void* sv, const float* g, const float* ag, const float* svsq,
                   const float* z, float* out, int k, int n2, int rows, int d,
                   cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = sizeof(float) * smem_floats(dp);
  cudaError_t err = cudaFuncSetAttribute(
      rbf_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTileRows - 1) / kTileRows, k);
  rbf_warp_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(sv), g, ag, svsq, z, out, n2, rows, d, dp);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). sv is (K, n2, d) f32 (sv_bf16 == 0) or
// bf16 (sv_bf16 == 1); g, ag, svsq are (K, n2) f32; z and out are (K, rows, d)
// f32; all contiguous on one device. Returns a cudaError_t; 0 is success.
extern "C" int rbf_warp_cc_launch(const void* sv, int sv_bf16, const void* g, const void* ag,
                               const void* svsq, const void* z, void* out, int k,
                               int n2, int rows, int d, void* stream) {
  if (k < 0 || n2 < 0 || rows < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (k == 0 || rows == 0) return (int)cudaSuccess;
  const float* gf = static_cast<const float*>(g);
  const float* agf = static_cast<const float*>(ag);
  const float* sqf = static_cast<const float*>(svsq);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sv_bf16 ? launch<__nv_bfloat16>(sv, gf, agf, sqf, zf, of, k, n2, rows, d, s)
              : launch<float>(sv, gf, agf, sqf, zf, of, k, n2, rows, d, s);
  return (int)err;
}

// Largest latent width the kernel takes (its register tile).
extern "C" int rbf_warp_cc_max_d() { return kMaxD; }
