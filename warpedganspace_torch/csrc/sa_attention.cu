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
// Two designs, chosen by the operands' type inside the C launch function,
// both on the tensor cores: float32 in split precision (namespace tf, at the
// end), bfloat16 as it is (namespace tc). The CUDA-core float32 design that
// came first is kept for comparison only, in csrc/sa_attention_cuda_cores.cu.
//
// What bounds it: at the BigGAN-128 render shape (B=16, N=4096, M=1024, dk=24,
// dv=96) the work is 2 B N M (dk + dv) = 16.1 GFLOP and B N M = 67 M
// exponentials against 39 MB of operands in f32 (each read or written once).
// One TF32 product keeps 10 mantissa bits, too few for the float32 checks, but
// three TF32 products of split operands (hi and lo pieces) keep about 22 bits
// and hold them (tests/test_torch_attn_f32_split_numerics.py); that is three
// times the least arithmetic at the tensor cores' 495 TFLOP/s in TF32, about
// 0.1 ms, against 0.033 ms for one product, 0.012 ms for the bytes at
// 3.35 TB/s and 0.24 ms for the same products on the CUDA cores (67 TFLOP/s).
// In bf16 the tensor cores' 989 TFLOP/s put the arithmetic at 0.016 ms, the
// 20 MB of operands at 0.006 ms, and the exponentials (16 a cycle per SM)
// near 0.02 ms: what bounds the bf16 design is the softmax between its two
// products, not the products.
//
// bf16 design (tc) and f32 design (tf), flash-attention style on mma.sync (see
// their namespaces).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

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

// ---------------------------------------------------------------------------
// f32 design: flash-attention style on the tensor cores in split precision.
//
// The bf16 design above, with float32 operands carried as 3xTF32 pieces
// (csrc/tc_tf32.cuh) on mma.sync m16n8k8: every product is three TF32
// products (lo hi, hi lo, hi hi) into one f32 accumulator, which keeps about
// 22 bits of each operand and holds the float32 checks where one TF32 product
// does not (tests/test_torch_attn_f32_split_numerics.py).
// - One block of 8 warps per (tile of 128 queries of one sample, tile of at
//   most 128 value columns, 64 above dk = 32); a warp owns 16 query rows and
//   both products of them, and a row's softmax statistics live in the four
//   lanes of a quad.
// - theta is read once into registers as split A fragments (k8 steps: dk=24 is
//   three, 24 registers) when dk <= 32; above that, each chunk reads the
//   warp's theta rows again from device memory (through L1) and splits them.
// - phi and g stream in chunks of 64 keys: cp.async (16 bytes where rows are
//   whole 16-byte units and bases aligned, else 4) brings a chunk's float32
//   rows into shared memory while the previous chunk is multiplied; once it
//   has landed, the block splits it, each value once, into 16-byte records
//   of B fragments, {hi(b0), hi(b1), lo(b0), lo(b1)}, so that a lane's B
//   fragment is one conflict-free 16-byte load with no arithmetic (ldmatrix
//   moves 16-bit elements; a split in every warp would repeat each value's
//   split eight times). Then the next chunk's copies start.
// - Logits S = theta phi^T, 16 x 64 per warp in the accumulator layout; keys
//   past M get -inf; online softmax as in the bf16 design, the weights
//   P = exp(S - m_running) kept in f32. Above dk = 32 each k8 step's three
//   products go into an accumulator of their own and are added into S in
//   f32, where one chain over the steps would lower lse by its rounding
//   toward zero (kChainSteps, tc_tf32.cuh).
// - O += P g: P's accumulator registers are the A fragments of the value
//   product with the chunk's keys in a permuted order (tc_tf32.cuh), so g's
//   records pair the rows of keys 2i and 2i + 1. O is rescaled in f32 by
//   exp(m_old - m_new) per chunk and divided by l at the end; lse = m + log(l).
// - Each k8 step sweeps its tiles three times (every lo hi product, every hi
//   lo, every hi hi), so that no product waits for the one before it.
namespace tf {

using namespace tc;   // the shared helpers of tc_bf16.cuh and tc_tf32.cuh

constexpr int kWarps = 8;               // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;   // queries a block owns
constexpr int kMaxDvTile = 128;          // value columns a block takes (dk <= 32)
constexpr int kMaxDvTileWide = 64;       // the same above dk = 32
constexpr int kRegSteps = 4;             // theta in registers up to dk = 32
constexpr int kMaxDk = 192;              // as the bf16 design's 12 k16 steps of theta

__host__ __device__ constexpr size_t smem_bytes(int dk, int dvt) {
  return (size_t)kChunk * (f32_row_units(dk) + f32_row_units(dvt)) * 16   // float32 rows
         + (size_t)kChunk * k_records(dk) * 16                            // phi records
         + (size_t)(kChunk / 2) * pair_records(dvt) * 16;                 // g records
}

// KS: k8 steps of theta the registers hold (kRegSteps), or 0: read theta from
// device memory at every chunk. NV: n8 tiles of the widest value tile (<= 16).
template <int KS, int NV>
__global__ void __launch_bounds__(kThreads)
sa_attention_tf_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                       const float* __restrict__ g, float* __restrict__ out,
                       float* __restrict__ lse, int qtiles, int n, int m, int dk, int dv,
                       int dvt, int vec_phi, int vec_g) {
  extern __shared__ uint4 smem[];
  const int ks = (dk + 7) / 8;
  const int sk = 4 * f32_row_units(dk), sv = 4 * f32_row_units(dvt);   // row strides, floats
  const int rp = k_records(dk), rg = pair_records(dvt);               // record strides
  float* phs = reinterpret_cast<float*>(smem);   // kChunk rows x sk
  float* gs = phs + kChunk * sk;                 // kChunk rows x sv
  uint4* prec = reinterpret_cast<uint4*>(gs + kChunk * sv);   // kChunk keys x rp
  uint4* grec = prec + kChunk * rp;                           // kChunk / 2 key pairs x rg

  const int b = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * kTileRows;
  const int col0 = blockIdx.y * dvt;
  const int width = min(dvt, dv - col0);
  const int vn = (width + 7) / 8;                // n8 value tiles of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = q0 + warp * 16 + gq;            // this lane's rows r0 and r0 + 8

  const float* thb = theta + (size_t)b * n * dk;
  const float* phb = phi + (size_t)b * m * dk;
  const float* gb = g + (size_t)b * m * dv + col0;

  // theta's A fragment of k8 step kk, zero past dk and past N.
  auto theta_frag = [&](int kk) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ((i & 1) ? 8 : 0);
      const int c = 8 * kk + tq + ((i & 2) ? 4 : 0);
      v[i] = (r < n && c < dk) ? __ldg(thb + (size_t)r * dk + c) : 0.f;
    }
    return frag_a(v[0], v[1], v[2], v[3]);
  };
  FragA qa[KS > 0 ? KS : 1];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < ks) qa[kk] = theta_frag(kk);

  auto fetch_chunk = [&](int c) {
    stage_rows_f32<kThreads>(phs, phb, kChunk, c * kChunk, m, dk, dk, f32_units(dk), sk / 4,
                             vec_phi, tid);
    stage_rows_f32<kThreads>(gs, gb, kChunk, c * kChunk, m, dv, width, 2 * vn, sv / 4, vec_g,
                             tid);
  };
  // The landed chunk as records, each value split once.
  auto split_chunk = [&]() {
    const int np = 4 * ks, ng = 8 * vn;
    const float inv_p = 1.f / np, inv_g = 1.f / ng;
    for (int i = tid; i < kChunk * np; i += kThreads) {
      const int key = quot(i, inv_p), r = i - key * np;
      const float* src = phs + key * sk + 8 * (r >> 2) + (r & 3);
      prec[key * rp + r] = split_pair(src[0], src[4]);
    }
    for (int i = tid; i < (kChunk / 2) * ng; i += kThreads) {
      const int pr = quot(i, inv_g), c = i - pr * ng;
      const float* src = gs + 2 * pr * sv + c;
      grec[pr * rg + c] = split_pair(src[0], src[sv]);
    }
  };

  float o[NV][4];
#pragma unroll
  for (int t = 0; t < NV; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running maxima of rows r0, r0 + 8
  float lrow[2] = {0.f, 0.f};                       // this lane's share of the running sums
  float since[2] = {1.f, 1.f};     // the rescales of O since it was last added into out
  bool flushed = false;            // out holds a partial O

  // out (= out * since + O) / l, or without / l before the last chunk;
  // then O starts again from 0.
  const bool pair = dv % 2 == 0;   // then col0 (a multiple of 8) keeps pairs aligned
  auto flush = [&](const float (&div)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float* orow = out + ((size_t)b * n + r) * dv + col0;
#pragma unroll
      for (int t = 0; t < NV; ++t)
        if (t < vn && r < n) {
          const int col = 8 * t + 2 * tq;
          const float2 prev = flushed ? load_pair(orow, col, width, pair) : make_float2(0.f, 0.f);
          store_pair(orow, col, width, fmaf(prev.x, since[h], o[t][2 * h]) * div[h],
                     fmaf(prev.y, since[h], o[t][2 * h + 1]) * div[h], pair);
        }
#pragma unroll
      for (int t = 0; t < NV; ++t) o[t][2 * h] = o[t][2 * h + 1] = 0.f;
      since[h] = 1.f;
    }
    flushed = true;
  };

  const int nchunks = (m + kChunk - 1) / kChunk;
  fetch_chunk(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();                 // chunk c has landed (this thread's copies)
    __syncthreads();                     // (everyone's), and the records are free
    split_chunk();
    __syncthreads();                     // the records are written, the rows free
    if (c + 1 < nchunks) fetch_chunk(c + 1);   // in flight while this chunk is multiplied
    cp_async_commit();

    // Logits of 16 rows x 64 keys: n8 tile j holds keys 8j .. 8j + 7.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // Up to dk = 32 (theta in registers) one chain over the k8 steps, above
    // it each step's sum added in float32 (kChainSteps, tc_tf32.cuh).
    static_assert(kRegSteps == kChainSteps, "the step sums begin where theta's registers end");
    auto logits_step = [&](int kk, const FragA& a) {
      uint4 bq[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bq[j] = prec[(8 * j + gq) * rp + 4 * kk + tq];
      if (KS > 0)
        mma3_records<8>(s, a, bq, 8);
      else
        mma3_records_add<8>(s, a, bq, 8);
    };
    if (KS > 0) {
#pragma unroll
      for (int kk = 0; kk < (KS > 0 ? KS : 1); ++kk)
        if (kk < ks) logits_step(kk, qa[kk]);
    } else {
      for (int kk = 0; kk < ks; ++kk) logits_step(kk, theta_frag(kk));
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
      since[h] *= scale;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        o[t][2 * h] *= scale;
        o[t][2 * h + 1] *= scale;
      }
    }

    // O += P g, one k8 step per key tile j: A = the weights of keys
    // 8j + 2tq (k tq) and 8j + 2tq + 1 (k tq + 4), B = the record of that key pair.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w0 = ex2(fmaf(s[j][0], kLog2e, -mb[0]));
      const float w1 = ex2(fmaf(s[j][1], kLog2e, -mb[0]));
      const float w2 = ex2(fmaf(s[j][2], kLog2e, -mb[1]));
      const float w3 = ex2(fmaf(s[j][3], kLog2e, -mb[1]));
      lrow[0] += w0 + w1;
      lrow[1] += w2 + w3;
      const FragA pa = frag_a(w0, w2, w1, w3);
      const uint4* g0 = grec + (4 * j + tq) * rg + gq;
      uint4 bv[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t)
        if (t < vn) bv[t] = g0[8 * t];
      mma3_records<NV>(o, pa, bv, vn);
    }
    if ((c + 1) % kFlushChunks == 0 && c + 1 < nchunks) {
      const float one[2] = {1.f, 1.f};
      flush(one);
    }
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
  flush(inv);
}

template <int KS, int NV>
cudaError_t launch_nv(const float* theta, const float* phi, const float* g, float* out,
                      float* lse, int b, int n, int m, int dk, int dv, int ntiles, int dvt,
                      bool vec_phi, bool vec_g, cudaStream_t stream) {
  const size_t smem = smem_bytes(dk, dvt);
  cudaError_t err = cudaFuncSetAttribute(
      sa_attention_tf_kernel<KS, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)b * (unsigned)qtiles, ntiles);
  sa_attention_tf_kernel<KS, NV><<<grid, kThreads, smem, stream>>>(
      theta, phi, g, out, lse, qtiles, n, m, dk, dv, dvt, vec_phi, vec_g);
  return cudaGetLastError();
}

// Value tiles of up to 8, 12 or 16 n8 tiles: 12 is BigGAN's dv=96, 8 its
// discriminator's dv=48 and every narrower one (the ch=16 test models' dv=8).
template <int KS>
cudaError_t launch_ks(const float* theta, const float* phi, const float* g, float* out,
                      float* lse, int b, int n, int m, int dk, int dv, int ntiles, int dvt,
                      bool vec_phi, bool vec_g, cudaStream_t stream) {
  const int nv = (dvt + 7) / 8;
  if (KS == 0 || nv <= 8)   // above dk = 32 (KS == 0) a tile is at most kMaxDvTileWide
    return launch_nv<KS, 8>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                            vec_g, stream);
  if constexpr (KS > 0) {
    if (nv <= 12)
      return launch_nv<KS, 12>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                               vec_g, stream);
    return launch_nv<KS, 16>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                             vec_g, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch(const void* theta_, const void* phi_, const void* g_, void* out_, float* lse,
                   int b, int n, int m, int dk, int dv, cudaStream_t stream) {
  const float* theta = static_cast<const float*>(theta_);
  const float* phi = static_cast<const float*>(phi_);
  const float* g = static_cast<const float*>(g_);
  float* out = static_cast<float*>(out_);
  // Column tiles of at most kMaxDvTile values (kMaxDvTileWide above dk = 32,
  // where phi's rows and records take more room), each a multiple of 8 (whole
  // n8 tiles; the tiles after the first start 16-byte aligned).
  const int most = dk <= 8 * kRegSteps ? kMaxDvTile : kMaxDvTileWide;
  int ntiles = (dv + most - 1) / most;
  const int dvt = ((dv + ntiles - 1) / ntiles + 7) & ~7;
  ntiles = (dv + dvt - 1) / dvt;
  const bool vec_phi = dk % 4 == 0 && aligned16(phi);
  const bool vec_g = dv % 4 == 0 && aligned16(g);
  if (dk <= 8 * kRegSteps)
    return launch_ks<kRegSteps>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi,
                                vec_g, stream);
  return launch_ks<0>(theta, phi, g, out, lse, b, n, m, dk, dv, ntiles, dvt, vec_phi, vec_g,
                      stream);
}

static_assert(smem_bytes(8 * kRegSteps, kMaxDvTile) <= 227 * 1024 &&
                  smem_bytes(kMaxDk, kMaxDvTileWide) <= 227 * 1024,
              "the widest chunks must fit");

}  // namespace tf

// C entry point (loaded with ctypes). theta is (B, n, dk), phi (B, m, dk),
// g (B, m, dv) and out (B, n, dv), all f32 (is_bf16 == 0, the split-precision
// tensor-core design tf) or all bf16 (is_bf16 == 1, the bf16 tensor-core
// design tc), contiguous on one device; lse is null or (B, n) f32, filled with
// the rows' log-sum-exp. Returns a cudaError_t; 0 is success.
extern "C" int sa_attention_launch(const void* theta, const void* phi, const void* g,
                                   void* out, void* lse, int is_bf16, int b, int n, int m,
                                   int dk, int dv, void* stream) {
  if (b < 0 || n < 0 || dv < 0 || m < 1 || dk < 1 || dk > tf::kMaxDk)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0 || dv == 0) return (int)cudaSuccess;
  const int rows = is_bf16 ? tc::kTileRows : tf::kTileRows;
  const long long blocks = (long long)b * ((n + rows - 1) / rows);
  if (blocks > 2147483647LL || (dv + tf::kMaxDvTileWide - 1) / tf::kMaxDvTileWide > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err = is_bf16 ? tc::launch(theta, phi, g, out, l, b, n, m, dk, dv, s)
                                  : tf::launch(theta, phi, g, out, l, b, n, m, dk, dv, s);
  return (int)err;
}

// Largest dk the kernel takes, from the design that serves f32: 192, where its
// chunks of phi and g still fit (it reads theta from device memory at every
// chunk above dk = 32); the bf16 design holds the same 192 in 12 k16 steps of
// registers.
extern "C" int sa_attention_max_dk() { return tf::kMaxDk; }

// Which design serves an operand type: both run on the tensor cores, bf16
// operands as they are, f32 operands in split precision.
extern "C" const char* sa_attention_design(int is_bf16) {
  return is_bf16 ? "tensor cores, mma.sync bf16" : "tensor cores, mma.sync 3xTF32";
}
