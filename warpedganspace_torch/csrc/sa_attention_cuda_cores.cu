// The CUDA-core f32 design of the SA-GAN spatial attention's forward (BigGAN's
// non-local block), kept for comparison only.
//
// It was the port's first attention kernel; csrc/sa_attention.cu replaced it
// with tensor-core designs (f32 in split precision). The package's wrapper
// does not load this file: ops/attn_cuda_cores.py binds its C entry
// (sa_attention_cc_launch) for chip_smoke.py, the scripts and the card tests,
// which time or check the shipped kernel beside it.
//
// Replaces the Pallas TPU kernel warpedganspace_tpu/ops/attn_pallas.py::_attn_kernel.
// For every sample b and query row n:
//
//   s_m  = theta[b, n, :] . phi[b, m, :]                 m < M, no scale
//   out[b, n, :] = sum_m softmax_m(s) * g[b, m, :]
//
// with the softmax in f32 (row maximum subtracted) and both products
// accumulated in f32 on the CUDA cores (about 0.24 ms of arithmetic at
// BigGAN-128's render shape at the H100 data-sheet 67 TFLOP/s). When asked,
// each row's lse = max_m(s) + log(sum_m exp(s - max)) is written too.
//
// Design. The TPU kernel holds one
// sample's whole phi and g beside a block of 512 queries in VMEM and needs no
// running maximum; here g alone
// (384 KB in f32) exceeds the 227 KB of shared memory a block may use, so the
// keys are streamed and the softmax is the online (running-maximum) one:
// - One block (8 warps) per (tile of 128 queries of one sample, tile of at
//   most 128 value columns). A block owns its query rows' whole reduction over
//   M, so nothing crosses blocks. dv above 128 is split into equal column
//   tiles along blockIdx.y, each recomputing the logits (dk is dv / 4 in
//   BigGAN, so that costs little).
// - The theta tile is staged once in shared memory; phi and g are streamed
//   through shared memory in chunks of 64 keys, converted to f32. This loop
//   takes the place of the TPU kernel's resident phi and g blocks.
// - Each warp owns 16 query rows for both products, so the softmax statistics
//   never leave the warp. Logits: a lane holds 16 rows x 2 keys in registers,
//   reading theta as broadcast float4s and phi as float4s from rows padded to
//   an odd number of 16-byte units (conflict-free). The running maximum m and
//   the running sum l of row r live in lane r; the chunk maximum and sum are
//   warp reductions. The weights exp(s - m) go to a warp-private tile in shared
//   memory, and the accumulators are rescaled by exp(m_old - m_new).
// - Values: a lane holds 16 rows x CPT columns (columns lane + 32 c, so g is
//   read conflict-free and the output is written coalesced); per key it reads
//   the 16 weights as 4 broadcast float4s.
// - Ragged edges are masked, not padded: query rows past N are never written,
//   keys past M get a logit of -inf, columns past dk or dv are zero in shared
//   memory. dk is limited by the shared-memory tile (kMaxDk).
//
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // queries per block
constexpr int kChunk = 64;                         // keys per chunk, 2 per lane
constexpr int kPStride = 20;                       // floats per key of the weight tile:
                                                   // 16 rows + pad, 5 units of 16 bytes
constexpr int kMaxDvTile = 128;                    // value columns per block (CPT <= 4)
constexpr int kMaxDk = 192;                        // (128 + 64) padded rows must fit
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 64 && kRowsPerWarp == 16, "lane and register maps assume these");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

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

// Row stride (floats) of the staged theta and phi rows: an odd number of
// 16-byte units, so float4 reads of 8 consecutive rows hit 8 bank groups.
__host__ __device__ __forceinline__ int row_stride(int dkp) {
  return ((dkp / 4) % 2 == 1) ? dkp : dkp + 4;
}

__host__ __device__ __forceinline__ size_t smem_floats(int dkp, int cpt) {
  return (size_t)(kTileRows + kChunk) * row_stride(dkp)   // theta tile, phi chunk
         + (size_t)kChunk * 32 * cpt                      // g chunk
         + (size_t)kWarps * kChunk * kPStride;            // per-warp weight tiles
}

// CPT: value columns per lane; the block's column tile is at most 32 * CPT wide.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
sa_attention_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                    const T* __restrict__ g, T* __restrict__ out, float* __restrict__ lse,
                    int qtiles, int n, int m, int dk, int dv, int dkp, int dvt) {
  extern __shared__ float4 smem4[];
  constexpr int kGStride = 32 * CPT;
  const int kst = row_stride(dkp);
  float* ths = reinterpret_cast<float*>(smem4);   // kTileRows x kst
  float* phs = ths + kTileRows * kst;             // kChunk x kst
  float* gs = phs + kChunk * kst;                 // kChunk x kGStride
  float* ps = gs + kChunk * kGStride;             // kWarps x kChunk x kPStride

  const int b = blockIdx.x / qtiles;
  const int row0 = (blockIdx.x % qtiles) * kTileRows;
  const int col0 = blockIdx.y * dvt;
  const int width = min(dvt, dv - col0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* thb = theta + (size_t)b * n * dk;
  const T* phb = phi + (size_t)b * m * dk;
  const T* gb = g + (size_t)b * m * dv + col0;

  for (int r = warp; r < kTileRows; r += kWarps) {
    const int gr = row0 + r;
    for (int c = lane; c < dkp; c += 32)
      ths[r * kst + c] = (gr < n && c < dk) ? to_f32(thb[(size_t)gr * dk + c]) : 0.f;
  }

  const int kst4 = kst / 4;
  const int d4 = dkp / 4;
  const float4* th4 = reinterpret_cast<const float4*>(ths) + warp * kRowsPerWarp * kst4;
  const float4* ph4 = reinterpret_cast<const float4*>(phs);
  float* pw = ps + warp * kChunk * kPStride;
  const float4* pw4 = reinterpret_cast<const float4*>(pw);

  float acc[kRowsPerWarp][CPT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.f;
  // Lane r < 16 keeps the running maximum and sum of this warp's row r.
  float mrun = -CUDART_INF_F;
  float lrun = 0.f;

  for (int j0 = 0; j0 < m; j0 += kChunk) {
    __syncthreads();  // the previous chunk (and, first, nothing) is no longer read
#pragma unroll
    for (int i = 0; i < kChunk / kWarps; ++i) {
      const int j = warp + i * kWarps;
      const int gj = j0 + j;
      const bool valid = gj < m;
      for (int c = lane; c < dkp; c += 32)
        phs[j * kst + c] = (valid && c < dk) ? to_f32(phb[(size_t)gj * dk + c]) : 0.f;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = lane + 32 * cc;
        gs[j * kGStride + c] = (valid && c < width) ? to_f32(gb[(size_t)gj * dv + c]) : 0.f;
      }
    }
    __syncthreads();  // also orders the theta tile before its first read

    // Logits of 16 rows x keys (lane, lane + 32).
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c4 = 0; c4 < d4; ++c4) {
      const float4 f0 = ph4[lane * kst4 + c4];
      const float4 f1 = ph4[(lane + 32) * kst4 + c4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 t = th4[r * kst4 + c4];
        s[r][0] = dot4(t, f0, s[r][0]);
        s[r][1] = dot4(t, f1, s[r][1]);
      }
    }
    const bool v0 = j0 + lane < m;
    const bool v1 = j0 + lane + 32 < m;

    // Online softmax: new maximum, rescale, weights. Key 0 of every chunk is
    // valid, so the new maximum is finite and exp(-inf - max) is 0.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s0 = v0 ? s[r][0] : -CUDART_INF_F;
      const float s1 = v1 ? s[r][1] : -CUDART_INF_F;
      const float m_old = __shfl_sync(kFull, mrun, r);
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float scale = __expf(m_old - m_new);
      s[r][0] = __expf(s0 - m_new);
      s[r][1] = __expf(s1 - m_new);
      const float psum = warp_sum(s[r][0] + s[r][1]);
      if (lane == r) {
        mrun = m_new;
        lrun = lrun * scale + psum;
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[r][cc] *= scale;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float4* dst = reinterpret_cast<float4*>(pw + (lane + 32 * kk) * kPStride);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp / 4; ++q)
        dst[q] = make_float4(s[4 * q][kk], s[4 * q + 1][kk], s[4 * q + 2][kk],
                             s[4 * q + 3][kk]);
    }
    __syncwarp();

    // Values: acc[r][c] += w[r][j] * g[j][c] over the chunk's valid keys.
    const int cj = min(kChunk, m - j0);
#pragma unroll 2
    for (int j = 0; j < cj; ++j) {
      const float4 p0 = pw4[j * (kPStride / 4)];
      const float4 p1 = pw4[j * (kPStride / 4) + 1];
      const float4 p2 = pw4[j * (kPStride / 4) + 2];
      const float4 p3 = pw4[j * (kPStride / 4) + 3];
      const float pv[kRowsPerWarp] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                                      p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
      float gv[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) gv[cc] = gs[j * kGStride + lane + 32 * cc];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = fmaf(pv[r], gv[cc], acc[r][cc]);
    }
    __syncwarp();  // the weight tile is rewritten in the next chunk
  }

  // The first column tile writes the row statistics (lane r holds row r's).
  if (lse != nullptr && blockIdx.y == 0 && lane < kRowsPerWarp) {
    const int gr = row0 + warp * kRowsPerWarp + lane;
    if (gr < n) lse[(size_t)b * n + gr] = mrun + logf(lrun);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float l = __shfl_sync(kFull, lrun, r);
    const int gr = row0 + warp * kRowsPerWarp + r;
    if (gr >= n) continue;  // uniform over the warp
    const float inv = 1.f / l;
    T* o = out + ((size_t)b * n + gr) * dv + col0;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = lane + 32 * cc;
      if (c < width) from_f32(acc[r][cc] * inv, o + c);
    }
  }
}

template <typename T, int CPT>
cudaError_t launch_cpt(const void* theta, const void* phi, const void* g, void* out,
                       float* lse, int b, int n, int m, int dk, int dv, int ntiles, int dvt,
                       cudaStream_t stream) {
  const int dkp = (dk + 3) / 4 * 4;
  const size_t smem = sizeof(float) * smem_floats(dkp, CPT);
  cudaError_t err = cudaFuncSetAttribute(
      sa_attention_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)qtiles, ntiles);
  sa_attention_kernel<T, CPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(theta), static_cast<const T*>(phi), static_cast<const T*>(g),
      static_cast<T*>(out), lse, qtiles, n, m, dk, dv, dkp, dvt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* theta, const void* phi, const void* g, void* out, float* lse,
                   int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  // Equal column tiles of at most kMaxDvTile values.
  const int ntiles = (dv + kMaxDvTile - 1) / kMaxDvTile;
  const int dvt = (dv + ntiles - 1) / ntiles;
  switch ((dvt + 31) / 32) {
    case 1: return launch_cpt<T, 1>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt,
                                    stream);
    case 2: return launch_cpt<T, 2>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt,
                                    stream);
    case 3: return launch_cpt<T, 3>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt,
                                    stream);
    default: return launch_cpt<T, 4>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt,
                                    stream);
  }
}

}  // namespace cc

// C entry point (loaded with ctypes). theta (B, n, dk), phi (B, m, dk), g (B, m,
// dv) and out (B, n, dv), all f32 and contiguous on one device; lse is null or
// (B, n) f32. Returns a cudaError_t; 0 is success.
extern "C" int sa_attention_cc_launch(const void* theta, const void* phi, const void* g,
                                      void* out, void* lse, int b, int n, int m, int dk, int dv,
                                      void* stream) {
  if (b < 0 || n < 0 || dv < 0 || m < 1 || dk < 1 || dk > cc::kMaxDk)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0 || dv == 0) return (int)cudaSuccess;
  const long long blocks = (long long)b * ((n + cc::kTileRows - 1) / cc::kTileRows);
  if (blocks > 2147483647LL || (dv + cc::kMaxDvTile - 1) / cc::kMaxDvTile > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cc::launch<float>(theta, phi, g, out, static_cast<float*>(lse), b, n, m, dk, dv,
                                static_cast<cudaStream_t>(stream));
}
