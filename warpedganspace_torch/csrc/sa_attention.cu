// SA-GAN spatial attention (BigGAN's non-local block) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel warpedganspace_tpu/ops/attn_pallas.py::_attn_kernel
// (forward; the backward kernel _attn_bwd_kernel is csrc/sa_attention_bwd.cu).
// For every sample b and query row n:
//
//   s_m  = theta[b, n, :] . phi[b, m, :]                 m < M, no scale
//   out[b, n, :] = sum_m softmax_m(s) * g[b, m, :]
//
// with the softmax in f32 (row maximum subtracted), both products accumulated
// in f32, inputs and output in f32 or bf16. The (B, N, M) attention matrix
// never reaches device memory. When the caller asks for it (training), each
// row's statistic lse = max_m(s) + log(sum_m exp(s - max)) is written too, one
// f32 per query: the backward kernel recomputes the softmax from it.
//
// Two designs, chosen by the operands' type inside the C launch function:
// float32 on the CUDA cores (namespace cc), bfloat16 on the tensor cores
// (namespace tc, below it).
//
// What bounds it: at the BigGAN-128 render shape (B=16, N=4096, M=1024, dk=24,
// dv=96) the work is 2 B N M (dk + dv) = 16.1 GFLOP and B N M = 67 M
// exponentials against 39 MB of operands in f32 (each read or written once).
// In f32 the arithmetic bounds it: about 0.24 ms at the H100 data-sheet
// 67 TFLOP/s outside the tensor cores (a TF32 product keeps 10 mantissa bits,
// too few for the f32 checks), against 0.012 ms for the bytes at 3.35 TB/s.
// In bf16 the tensor cores' 989 TFLOP/s put the arithmetic at 0.016 ms, the
// 20 MB of operands at 0.006 ms, and the exponentials (16 a cycle per SM)
// near 0.02 ms: what bounds the bf16 design is the softmax between its two
// products, not the products.
//
// f32 design (cc). The TPU kernel holds one sample's whole phi and g beside a
// block of 512 queries in VMEM and needs no running maximum; here g alone
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
// bf16 design (tc), flash-attention style on mma.sync (see the tc namespace).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tc_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16 design: flash-attention style on the tensor cores.
//
// - One block of 8 warps per (tile of 128 queries of one sample, tile of at
//   most 128 value columns); a warp owns 16 query rows and both products of
//   them, so the softmax statistics never leave the warp (a row lives in the
//   four lanes of a quad). Each chunk of phi and g serves 128 queries: with
//   64 the chunks' reads from L2 cost 8 % more (scripts/ablate_attention_cuda.py).
// - The warp's theta rows are read once into registers as mma A fragments,
//   dk padded with zeros to a multiple of 16 in the registers only (dk=24 is
//   two k16 steps).
// - phi and g stream through shared memory in chunks of 64 keys, two buffers
//   filled by 16-byte cp.async: the next chunk is in flight while the current
//   one is multiplied. Staged rows are padded to an odd number of 16-byte
//   units (a 48-byte phi row of dk=24 takes 80 bytes), so the eight rows an
//   ldmatrix reads fall in eight bank groups. Operands whose rows are not a
//   whole number of 16-byte units, or whose base is not 16-byte aligned, are
//   staged by element loads instead (the same loop, synchronous).
// - Logits S = theta phi^T by mma.sync m16n8k16 (bf16 operands, f32
//   accumulation; phi by ldmatrix as the B operand): a warp's 16 x 64 tile is
//   32 f32 registers a lane. Keys past M get -inf before the maximum. The
//   running maximum is reduced over the quad by two shuffles; the running sum
//   stays a per-lane partial until the end.
// - P = exp(S - m_running), in f32, is rounded to bf16 and packed from the
//   accumulator layout straight into A fragments; O += P g by mma.sync with g
//   read by ldmatrix.trans; O (16 x 96 per warp at dv=96, 48 registers a lane)
//   is rescaled in f32 by exp(m_old - m_new) per chunk and divided by l, then
//   rounded to bf16 once, at the end. The sum l is of the f32 weights, so the
//   row statistic lse = m + log(l) is that of the f32 softmax.
// - dv above 128 is split into column tiles along blockIdx.y (multiples of 16,
//   each recomputing the logits), as in the f32 design.
// - Rounding: the value product takes the unnormalised weights in bf16, the
//   plain bf16 version (and the TPU kernel) the normalised ones; both round the
//   weights once, before an f32-accumulated product with bf16 values.
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;   // queries a block owns, 16 per warp
constexpr int kMaxDvTile = 128;          // value columns per block

// KS: k16 steps of theta the registers hold (dk <= 16 KS); NV: n8 tiles of
// the widest value tile (an even number, <= 16). Steps and tiles past the
// block's own counts are skipped.
template <int KS, int NV>
__global__ void __launch_bounds__(kThreads)
sa_attention_tc_kernel(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                       const bf16* __restrict__ g, bf16* __restrict__ out,
                       float* __restrict__ lse, int qtiles, int n, int m, int dk, int dv,
                       int dvt, int vec_phi, int vec_g) {
  extern __shared__ uint4 smem[];
  const int ks = (dk + 15) / 16;
  const int uk = row_units(dk), uv = row_units(dvt);
  char* phs = reinterpret_cast<char*>(smem);    // 2 buffers x kChunk rows x uk units
  char* gs = phs + 2 * kChunk * uk * 16;        // 2 buffers x kChunk rows x uv units

  const int b = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * kTileRows;
  const int col0 = blockIdx.y * dvt;
  const int width = min(dvt, dv - col0);
  const int vn = value_units(width);            // n8 value tiles of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = q0 + warp * 16 + gq;           // this lane's rows r0 and r0 + 8

  const bf16* thb = theta + (size_t)b * n * dk;
  const bf16* phb = phi + (size_t)b * m * dk;
  const bf16* gb = g + (size_t)b * m * dv + col0;

  // theta as A fragments, zero past dk and past N.
  uint32_t qa[KS][4];
  const bf16 zero = __ushort_as_bfloat16(0);
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ((i & 1) ? 8 : 0);
      const int c = 16 * s + 2 * tq + ((i & 2) ? 8 : 0);
      bf16 lo = zero, hi = zero;
      if (r < n) {
        if (c < dk) lo = thb[(size_t)r * dk + c];
        if (c + 1 < dk) hi = thb[(size_t)r * dk + c + 1];
      }
      qa[s][i] = pack_bf16x2(lo, hi);
    }

  auto fetch = [&](int c) {
    const int buf = c & 1;
    stage_rows<kThreads>(phs + buf * kChunk * uk * 16, phb, kChunk, c * kChunk, m, dk, dk,
                         value_units(dk), uk, vec_phi, tid);
    stage_rows<kThreads>(gs + buf * kChunk * uv * 16, gb, kChunk, c * kChunk, m, dv, width,
                         vn, uv, vec_g, tid);
  };

  float o[NV][4];
#pragma unroll
  for (int t = 0; t < NV; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running maxima of rows r0, r0 + 8
  float lrow[2] = {0.f, 0.f};                       // this lane's share of the running sums

  const int nchunks = (m + kChunk - 1) / kChunk;
  const uint32_t phs_a = smem_addr(phs), gs_a = smem_addr(gs);
  fetch(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) fetch(c + 1);   // into the buffer no warp reads in this chunk
    cp_async_commit();
    cp_async_wait_one();                 // chunk c has landed (this thread's copies)
    __syncthreads();                     // (everyone's)
    const uint32_t pb = phs_a + (c & 1) * kChunk * uk * 16;
    const uint32_t vb = gs_a + (c & 1) * kChunk * uv * 16;

    // Logits of 16 rows x 64 keys: n8 tile j holds keys 8j .. 8j + 7.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];   // B fragments of key tiles 2np and 2np + 1
          const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(bf, pb + (key * uk + 2 * kk + ((lane >> 3) & 1)) * 16);
          mma16816(s[2 * np], qa[kk], bf[0], bf[1]);
          mma16816(s[2 * np + 1], qa[kk], bf[2], bf[3]);
        }
      }
    }

    // Online softmax. Key c * 64 is valid, so the new maxima are finite.
    const int key0 = c * kChunk + 2 * tq;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * j + (e & 1) >= m) s[j][e] = -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      const float scale = ex2((mrow[h] - mx[h]) * kLog2e);   // 0 at the first chunk
      mrow[h] = mx[h];
      mb[h] = mx[h] * kLog2e;
      lrow[h] *= scale;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        o[t][2 * h] *= scale;
        o[t][2 * h + 1] *= scale;
      }
    }
    // The weights, rounded to bf16 into the A fragments of the value product:
    // key tiles 2kk and 2kk + 1 are its k16 step kk.
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], kLog2e, -mb[0]));
      const float p1 = ex2(fmaf(s[j][1], kLog2e, -mb[0]));
      const float p2 = ex2(fmaf(s[j][2], kLog2e, -mb[1]));
      const float p3 = ex2(fmaf(s[j][3], kLog2e, -mb[1]));
      lrow[0] += p0 + p1;
      lrow[1] += p2 + p3;
      pa[j >> 1][2 * (j & 1)] = pack_bf16x2(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p2, p3);
    }

    // O += P g: g rows are keys, so g is read transposed as the B operand.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int vp = 0; vp < NV / 2; ++vp) {
        if (2 * vp < vn) {
          uint32_t bf[4];   // B fragments of value tiles 2vp and 2vp + 1
          const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldsm_x4_t(bf, vb + (key * uv + 2 * vp + (lane >> 4)) * 16);
          mma16816(o[2 * vp], pa[kk], bf[0], bf[1]);
          mma16816(o[2 * vp + 1], pa[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // the buffer is refilled in the next chunk
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] = quad_sum(lrow[h]);
    inv[h] = 1.f / lrow[h];
  }
  if (lse != nullptr && blockIdx.y == 0 && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < n) lse[(size_t)b * n + r0 + 8 * h] = mrow[h] + logf(lrow[h]);
  }
  const bool pair = dv % 2 == 0;   // then col0 (a multiple of 16) keeps pairs aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n) continue;
    bf16* orow = out + ((size_t)b * n + r) * dv + col0;
#pragma unroll
    for (int t = 0; t < NV; ++t)
      if (t < vn)
        store_pair(orow, 8 * t + 2 * tq, width, o[t][2 * h] * inv[h], o[t][2 * h + 1] * inv[h],
                   pair);
  }
}

template <int KS, int NV>
cudaError_t launch_nv(const bf16* theta, const bf16* phi, const bf16* g, bf16* out, float* lse,
                      int b, int n, int m, int dk, int dv, int ntiles, int dvt, bool vec_phi,
                      bool vec_g, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kChunk * (row_units(dk) + row_units(dvt)) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      sa_attention_tc_kernel<KS, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)qtiles, ntiles);
  sa_attention_tc_kernel<KS, NV><<<grid, kThreads, smem, stream>>>(
      theta, phi, g, out, lse, qtiles, n, m, dk, dv, dvt, vec_phi, vec_g);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_ks(const bf16* theta, const bf16* phi, const bf16* g, bf16* out, float* lse,
                      int b, int n, int m, int dk, int dv, int ntiles, int dvt, bool vec_phi,
                      bool vec_g, cudaStream_t stream) {
  const int nv = value_units(dvt);
  if (nv <= 4)
    return launch_nv<KS, 4>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                            vec_g, stream);
  if (nv <= 8)
    return launch_nv<KS, 8>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                            vec_g, stream);
  if (nv <= 12)
    return launch_nv<KS, 12>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                             vec_g, stream);
  return launch_nv<KS, 16>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                           vec_g, stream);
}

cudaError_t launch(const void* theta_, const void* phi_, const void* g_, void* out_, float* lse,
                   int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  const bf16* theta = static_cast<const bf16*>(theta_);
  const bf16* phi = static_cast<const bf16*>(phi_);
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* out = static_cast<bf16*>(out_);
  // Column tiles of at most kMaxDvTile values, each a multiple of 16 (whole
  // pairs of n8 tiles; the tiles after the first start 16-byte aligned).
  int ntiles = (dv + kMaxDvTile - 1) / kMaxDvTile;
  const int dvt = value_units((dv + ntiles - 1) / ntiles) * 8;
  ntiles = (dv + dvt - 1) / dvt;
  const bool vec_phi = dk % 8 == 0 && aligned16(phi);
  const bool vec_g = dv % 8 == 0 && aligned16(g);
  if (dk <= 32)
    return launch_ks<2>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi, vec_g,
                        stream);
  return launch_ks<12>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi, vec_g,
                       stream);
}

}  // namespace tc

// C entry point (loaded with ctypes). theta is (B, n, dk), phi (B, m, dk),
// g (B, m, dv) and out (B, n, dv), all f32 (is_bf16 == 0, the CUDA-core
// design) or all bf16 (is_bf16 == 1, the tensor-core design), contiguous on
// one device; lse is null or (B, n) f32, filled with the rows' log-sum-exp.
// Returns a cudaError_t; 0 is success.
extern "C" int sa_attention_launch(const void* theta, const void* phi, const void* g,
                                   void* out, void* lse, int is_bf16, int b, int n, int m,
                                   int dk, int dv, void* stream) {
  if (b < 0 || n < 0 || dv < 0 || m < 1 || dk < 1 || dk > cc::kMaxDk)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0 || dv == 0) return (int)cudaSuccess;
  const int rows = is_bf16 ? tc::kTileRows : cc::kTileRows;
  const long long blocks = (long long)b * ((n + rows - 1) / rows);
  if (blocks > 2147483647LL || (dv + cc::kMaxDvTile - 1) / cc::kMaxDvTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err = is_bf16
      ? tc::launch(theta, phi, g, out, l, b, n, m, dk, dv, s)
      : cc::launch<float>(theta, phi, g, out, l, b, n, m, dk, dv, s);
  return (int)err;
}

// Largest dk the kernel takes (the f32 design's shared-memory tile; the bf16
// design holds up to 12 k16 steps of theta in registers, the same 192).
extern "C" int sa_attention_max_dk() { return cc::kMaxDk; }

// Which design serves an operand type: the tensor cores for bf16, the CUDA
// cores for f32.
extern "C" const char* sa_attention_design(int is_bf16) {
  return is_bf16 ? "tensor cores, mma.sync bf16" : "CUDA cores";
}
