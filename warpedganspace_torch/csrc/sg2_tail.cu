// One fused section of StyleGAN2's thin-channel tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// warpedganspace_tpu/ops/sg2_tail_pallas.py::_section_kernel (launched by
// fused_section). One launch runs one resolution block of the generator with
// C < 128 output channels, 2C channels at (Hi, Wi) to C channels at
// (H, W) = (2 Hi, 2 Wi):
//
//   x * s1 -> stride-2 transposed conv3x3 + [1,3,3,1]^2 blur (gain 4) -> * d1
//   -> + nw1 * noise1 + b1 -> leaky 0.2 * sqrt 2                        (mid)
//   -> * s2 -> conv3x3 pad 1 -> * d2 -> + nw2 * noise2 + b2 -> leaky * sqrt 2   (x2)
//   -> * s3 -> ToRGB 1x1 (C -> 3) + rgb bias                           (rgb)
//
// s1 (B, 2C), d1, s2, d2, s3 (B, C) are the per-sample modulation and
// demodulation vectors: modulation sits on the activations, so every sample of
// the batch shares one set of weights. The noise maps (H, W) are shared by the
// batch. Only rgb, and x2 when the caller asks for it (the next block's input),
// reach device memory: the mid activation lives in shared memory.
//
// What bounds it: the least arithmetic is the stride-2 transposed conv's 9
// taps of 2C x C per input pixel (2.25 per output pixel), the depthwise blur
// and the same-conv's 9 taps of C x C per output pixel: about 15 G
// multiply-adds per image for each of StyleGAN2-1024's two sections (C = 64
// at 512^2, C = 32 at 1024^2), against 80-104 MB of input and output per
// image in f32. Operations bound it on every unit: on the CUDA cores at the
// data-sheet 67 TFLOP/s, 0.44 ms per image; on the tensor cores at 495 TFLOP/s
// TF32 (f32) or 989 TFLOP/s bf16, 0.06 or 0.03 ms, against 0.024-0.031 ms of
// bytes at 3.35 TB/s in f32.
//
// Four designs. The C launch function takes bf16 to the tensor cores as
// warpgroup MMA (wgmma) products of the transposed conv and then the blur
// (namespace wg) and f32 to the tensor cores in split precision, the same
// transposed conv and blur (namespace tf). The bf16 design that wg replaced,
// mma.sync products of the polyphase up-conv (namespace tc), and the f32
// design on the CUDA cores that tf replaced (namespace cc) have their own C
// entries, for comparison only. Nothing of the TPU kernel's fold-x lanes,
// K-window builds, k-merged RGB or row stripes is carried over. All take
// NCHW activations and a block per (image, 16 x 16 output tile); all stage
// the 12 x 12 input tile (halo 2 on the input grid) of all 2C channels
// already multiplied by s1. Mid pixels outside the image are set to ZERO,
// not computed: the same-conv zero-pads x * s2. Ragged edges are masked: any
// Hi, Wi >= 1; tiles past the right and bottom edge store nothing outside
// the image. Offsets are 64-bit; the limits are 2^31 - 1 blocks (B x tiles)
// and C in {16, 32, 64}.
//
// wg and tf compute the stride-2 transposed conv into a pre-blur window T of
// 21 x 21 pixels (the 18 x 18 mid tile, the same-conv's halo included, and
// the blur's 3) in its four parity groups: window pixel (2u + pr, 2v + pc)
// takes only the taps ky = pr, kx = pc (mod 2), 4, 2, 2 and 1 of them. Each
// group is an implicit GEMM, M = its 121, 110, 110 or 100 positions, N = C,
// K = taps x 2C, from the raw transposed-conv weights; then the separable [1,
// 3, 3, 1] blur with gain 4 runs in f32 on the CUDA cores, in place in T
// (columns, then rows), and the rows' pass applies * d1, noise, bias, leaky *
// sqrt 2 and * s2 and leaves the mid tile (d1 is per channel, so it commutes
// with the blur). Same-conv: M = the 256 output pixels, N = C, K = 9 taps x
// C. tc and cc compute the transposed conv followed by the 4-tap blur as,
// for each parity (py, px) of the output pixel (2u + py, 2v + px), a 3x3
// conv of the input pixels (u - 1 .. u + 1, v - 1 .. v + 1) with its own
// weights (the wrapper derives them from the plain transposed conv and
// blur), so the mid tile splits into four parity groups of 9 x 9 pixels: 9
// taps of 2C x C per output pixel, four times the transposed conv's.
//
// bf16 (wg): both GEMMs on wgmma.mma_async m64nCk16 (tc_wgmma.cuh), bf16
// operands, f32 accumulation; two consumer warpgroups and one producer warp;
// persistent blocks, as many as the card holds at once, each walking its
// tiles gridDim.x apart.
// - A, the activations, from registers: ldmatrix from the channel-last bf16
//   tiles, [pixel][channel] rows of an odd number of 16-byte units, one row
//   address a lane, so each tap's shifted window costs nothing. The staging
//   pass transposes the NCHW input and multiplies it by s1 in f32, one
//   rounding to bf16.
// - B, the weights, from shared memory through wgmma descriptors, K-major
//   core matrices without swizzle; a chunk is one tap (the transposed conv's
//   raw taps in the wrapper's UP_TAP_ORDER, 2C x C, then the same-conv's, C
//   x C) in the layout the wrapper prepares. The producer warp's one lane
//   copies chunk k into slot k % S of a ring by one bulk copy (the TMA unit)
//   completed on the slot's mbarrier, once each consumer warp has released
//   chunk k - S on the slot's other mbarrier: no block barrier a chunk, and S
//   - 1 chunks travel while one is multiplied, across tiles too. S = 3, 4, 6
//   slots at C = 64, 32, 16.
// - The next tile's input rows (16-byte cp.async of 8-pixel units, 24 pixels
//   a row, into T's room), its noise rows and its per-sample vectors travel
//   while this tile's same-conv runs; where the image width is no multiple of
//   8 pixels the input and the noise are read element by element instead.
// - The transposed conv: warpgroup g owns m64 tile g of each parity group
//   (rows past the group's positions repeat its last and are not stored), so
//   both read every chunk; the same-conv: warpgroup g owns m64 tiles 2g and
//   2g + 1, four output rows each (warp w of the warpgroup one row, its 16
//   columns the m16 rows). Both loops are unrolled: a chunk's A fragments
//   load while the chunk before is multiplied, and within a group its
//   products queue behind that chunk's (wgmma.wait_group 1). Issued products
//   a tile: 1152 position-taps of 2C x C and 256 x 9 of C x C, 2.0x the
//   transposed conv's least and 0.5x the polyphase design's (its 96 rows
//   padded for 81 positions, the same-conv's halo recomputed).
// - T is f32 ([21 x 21][C + 4 floats]), the blur too; the mid tile is bf16
//   in the input tile's room; x2 stays f32 for ToRGB, dotted with ToRGB's
//   [3][C] f32 weights by a lane's partial and two quad shuffles, and goes
//   out through the same room as bf16 rows (16-byte stores).
// - Rounding: the products see bf16 x * s1, the bf16 raw weights (the
//   operands' own, not rounded again) and the bf16 mid tile; sums, T, the
//   blur and x2 for ToRGB stay f32 (tests/test_torch_tail_tc_numerics.py).
// - Shared memory: C = 64 (512^2 section): ring 3 x 16 KiB, T 441 x 272 B =
//   117.1 KiB, the input tile 144 x 272 B = 38.3 KiB then the mid tile 324 x
//   144 B = 45.6 KiB in its room, vectors and two tiles' copied vectors and
//   noise 6.0 KiB: 216.8 KiB, one block (9 warps) an SM. C = 32 (1024^2):
//   ring 4 x 4 KiB, T 62.0 KiB, the tile room 25.3 KiB: 108.0 KiB, two
//   blocks. C = 16: 59.7 KiB, three blocks.
//
// f32 (tf): both convolutions are implicit GEMMs on mma.sync m16n8k8 in
// split precision (tc_tf32.cuh: each operand as TF32 hi + lo rounded to
// nearest, three products lo hi + hi lo + hi hi), from shared memory; 8 warps.
// - The input tile x * s1 stays f32, channel-last, [pixel][channel] rows of
//   an odd number of 16-byte units (tc_conv.cuh); the warps split their A
//   fragments as they load them.
// - The transposed conv's parity groups as in wg, m16 tiles of each group's
//   positions: 1.72x the transposed conv's least products (the halo), 0.43x
//   the polyphase up-conv's. The blur as in wg; the mid tile stays f32 in
//   T's room.
// - Same-conv: an m16 tile is one output row; a warp owns two output rows.
//   Epilogue as in wg, in f32.
// - Weights: the wrapper splits the raw taps once a call into 16-byte records
//   of B fragments {hi b0, hi b1, lo b0, lo b1} (tc_tf32.cuh), one chunk per
//   tap x 16 input channels, in the order the kernel takes them; they go
//   through a ring of shared slots by cp.async, one block barrier a chunk.
// - The tensor cores round their f32 sums toward zero: accumulators are added
//   into f32 sums every kFlushSteps k8 steps (tests/test_torch_sg2_tail_f32_split_numerics.py).
// - Shared memory: C = 64 (512^2 section): vectors and the mid tile's noise
//   4.0 KB, input tile 144 x 528 B = 74.3 KB, T and then mid 441 x 272 B =
//   117.1 KB, ring 3 x 8 KB: 219.4 KB, one block (8 warps) an SM. C = 32
//   (1024^2): 2.7, 38.3, 62.0 KB, ring 2 x 4 KB: 111.0 KB, two blocks. C = 16:
//   62.7 KB, three blocks. The input tile and the noise come by 4-byte
//   cp.async, all of a thread's copies in flight at once; s1 is applied in
//   place once they land.
//
// f32 (cc), for comparison: 8 C threads; all arithmetic and every
// intermediate f32. Weights prepared by the wrapper in f32: the up-conv as
// [2C][4 phases][9 taps][C], the same-conv as [C][9 taps][C], ToRGB [3][C].
// They stream through two shared buffers in chunks of 4 input channels with
// 16-byte cp.async copies (the C = 64 section's composite is 1.2 MB in f32):
// the next chunk is in flight while the current one is multiplied; weight
// reads in the inner loops are uniform float4 broadcasts. Up-conv: a warp
// owns one (parity group, 16 output channels), 27 lanes each holding 3 pixels
// x 16 channels. Same-conv: a thread holds 4 rows x 8 channels of one output
// column; x2 * s3 meets the other channels of its pixel in shared memory for
// the 1x1 ToRGB.
//
// bf16 (tc), for comparison: both convolutions are implicit GEMMs on mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, from shared memory
// (tc_conv.cuh); 8 warps.
// - Activations as in wg.
// - Up-conv: per parity, M = the 81 positions (padded to 96), N = C, K = 9
//   taps x 2C; a warp owns one parity and 3 m16 tiles, all C output columns,
//   and reads the input window shifted by its parity and the tap. The
//   composite weights are composed in f32 and rounded to bf16 once by the
//   wrapper (ops/sg2_tail_polyphase.py), laid out [tap][phase][co][ci].
// - Epilogues in the accumulator layout, in f32, as in wg; the mid tile in
//   the input tile's room.
// - Same-conv: M = the 256 output pixels (an m16 tile is one output row), N =
//   C, K = 9 taps x C; a warp owns two output rows.
// - Weights go through a ring of three shared slots by 16-byte cp.async, one
//   chunk a step (a polyphase tap x 32 input channels for all four phases; 3
//   or 9 taps x 16 channels of the same-conv): two chunks are in flight while
//   one is multiplied, one block barrier a chunk.
// - Rounding: the products see bf16 x * s1, bf16 composite weights and the
//   bf16 mid tile; x2 stays f32 for ToRGB.
// - Shared memory: C = 64 (512^2 section): vectors 2.8 KB, input tile 144 x
//   272 B = 39.2 KB, mid tile 324 x 144 B = 46.7 KB in its room, ring 3 x 20.5
//   KB: 110.9 KB, two blocks (16 warps) an SM. C = 32 (1024^2): 1.4, 20.7 and
//   25.9 KB, ring 3 x 13.8 KB: 68.8 KB, three blocks. __launch_bounds__ holds
//   the registers to those counts (kMinBlocks; -Xptxas -v prints them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_conv.cuh"
#include "tc_tf32.cuh"
#include "tc_wgmma.cuh"

namespace {

constexpr int kTile = 16;                       // output tile, rows and columns
constexpr int kMid = kTile + 2;                 // mid tile with the same-conv's halo
constexpr int kGroup = kMid / 2;                // a parity group of the mid tile is 9 x 9
constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;   // sqrt 2

__device__ __forceinline__ float act_fn(float v) { return kGain * (v >= 0.f ? v : kSlope * v); }

}  // namespace

// ---------------------------------------------------------------------------
// f32 on the CUDA cores, the design the split-precision one replaced, behind
// its own C entry (sg2_tail_section_cc_launch) for comparison. The template
// also takes bf16 storage, the design bf16 had before the tensor cores:
// scripts/measure_sg2_tail_tc_rate.py times it so.
namespace cc {

constexpr int kMidStride = 20;                  // floats per mid row: 4 rows apart = 16 banks
constexpr int kMidPlane = kMid * kMidStride;    // floats per mid channel
constexpr int kIn = kTile / 2 + 4;              // input tile with the up-conv's halo
constexpr int kInPlane = kIn * kIn;
constexpr int kKC = 4;                          // input channels per weight chunk
static_assert(kTile == 16 && kGroup == 9, "thread maps assume a 16 x 16 tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory, in floats: the per-sample vectors, the activation tile (the
// input tile, then the mid tile, then the x2 * s3 tile for ToRGB, each in the
// room of the one before), two weight chunks (the up-conv's are the larger).
__host__ __device__ constexpr int vec_floats(int c) { return 11 * c + 8; }
__host__ __device__ constexpr int act_floats(int c) {
  return c * kMidPlane > 2 * c * kInPlane ? c * kMidPlane : 2 * c * kInPlane;
}
__host__ __device__ constexpr int chunk_floats(int c) { return kKC * 36 * c; }
__host__ __device__ constexpr size_t smem_floats(int c) {
  return (size_t)vec_floats(c) + act_floats(c) + 2 * chunk_floats(c);
}
static_assert(16 * 256 <= act_floats(16), "the ToRGB tile fits the activation room");

// Weight chunk j into dst: chunks 0 .. 2C/kKC - 1 are the up-conv's, the rest
// the same-conv's. One commit group per chunk.
template <int C>
__device__ __forceinline__ void fetch_chunk(float* dst, const float* __restrict__ wu,
                                            const float* __restrict__ wsame, int j, int tid) {
  constexpr int NT = 8 * C;
  constexpr int NUP = 2 * C / kKC;
  const float* src;
  int n4;
  if (j < NUP) {
    src = wu + (size_t)j * kKC * 36 * C;
    n4 = kKC * 9 * C;
  } else {
    src = wsame + (size_t)(j - NUP) * kKC * 9 * C;
    n4 = kKC * 9 * C / 4;
  }
  for (int i = tid; i < n4; i += NT) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

template <typename T, int C>
__global__ void __launch_bounds__(8 * C)
section_kernel(const T* __restrict__ x, const float* __restrict__ wu,
               const float* __restrict__ wsame, const float* __restrict__ wrgb,
               const T* __restrict__ s1, const T* __restrict__ d1, const T* __restrict__ s2,
               const T* __restrict__ d2, const T* __restrict__ s3, const T* __restrict__ n1,
               const T* __restrict__ nw1, const T* __restrict__ b1, const T* __restrict__ n2,
               const T* __restrict__ nw2, const T* __restrict__ b2,
               const T* __restrict__ rgb_b, T* __restrict__ rgb, T* __restrict__ x2, int hi,
               int wi, int tiles_x, int tiles_y) {
  constexpr int NT = 8 * C;
  constexpr int CI = 2 * C;
  constexpr int NUP = CI / kKC;
  constexpr int NCHUNK = NUP + C / kKC;
  extern __shared__ float4 smem4[];
  float* vs1 = reinterpret_cast<float*>(smem4);   // [2C]
  float* vd1 = vs1 + CI;                          // [C] each, then ToRGB [3][C], bias [3], nw [2]
  float* vs2 = vd1 + C;
  float* vd2 = vs2 + C;
  float* vs3 = vd2 + C;
  float* vb1 = vs3 + C;
  float* vb2 = vb1 + C;
  float* vwr = vb2 + C;
  float* vrb = vwr + 3 * C;
  float* vnw = vrb + 3;
  float* tile = vs1 + vec_floats(C);              // input [2C][kIn][kIn] / mid / ToRGB tile
  float* wbuf = tile + act_floats(C);             // two weight chunks, 16-byte aligned

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int bid = blockIdx.x;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int h = 2 * hi, w = 2 * wi;
  const int y0 = ty * kTile, x0 = tx * kTile;     // output tile origin, even
  const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;   // input tile origin

  fetch_chunk<C>(wbuf, wu, wsame, 0, tid);

  // 1. The per-sample vectors and the input tile times s1, zero outside the image.
  for (int i = tid; i < CI; i += NT) vs1[i] = to_f32(s1[(size_t)b * CI + i]);
  for (int i = tid; i < C; i += NT) {
    const size_t bi = (size_t)b * C + i;
    vd1[i] = to_f32(d1[bi]);
    vs2[i] = to_f32(s2[bi]);
    vd2[i] = to_f32(d2[bi]);
    vs3[i] = to_f32(s3[bi]);
    vb1[i] = to_f32(b1[i]);
    vb2[i] = to_f32(b2[i]);
  }
  for (int i = tid; i < 3 * C; i += NT) vwr[i] = wrgb[i];
  if (tid < 3) vrb[tid] = to_f32(rgb_b[tid]);
  if (tid == 0) {
    vnw[0] = to_f32(nw1[0]);
    vnw[1] = to_f32(nw2[0]);
  }
  __syncthreads();
  const T* xb = x + (size_t)b * CI * hi * wi;
  for (int idx = tid; idx < CI * kInPlane; idx += NT) {
    const int ci = idx / kInPlane;
    const int rem = idx - ci * kInPlane;
    const int r = rem / kIn;
    const int c = rem - r * kIn;
    const int iy = iy0 + r, ix = ix0 + c;
    float v = 0.f;
    if (iy >= 0 && iy < hi && ix >= 0 && ix < wi)
      v = to_f32(xb[((size_t)ci * hi + iy) * wi + ix]) * vs1[ci];
    tile[idx] = v;
  }

  // 2. Up-conv: warp = (parity group, 16 output channels). Local mid pixel
  // (i, j) = (2 a + pi, 2 c + pj) is global (y0 - 1 + i, x0 - 1 + j): local
  // parity 0 is an odd global row (py = 1) and reads input rows a + oy of the
  // tile, local parity 1 an even one (py = 0) reading rows a + 1 + oy;
  // columns alike. Lane < 27 holds rows a = rg + 3 r (r = 0..2) of column v.
  {
    const int ph = warp & 3, g = warp >> 2;
    const int pi = ph >> 1, pj = ph & 1;
    const int gph = 3 - ph;                       // (1 - pi) * 2 + (1 - pj)
    const bool active = lane < 3 * kGroup;
    const int rg = active ? lane / kGroup : 0;
    const int v = active ? lane % kGroup : 0;
    float acc[3][16];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[r][q] = 0.f;

    for (int j = 0; j < NUP; ++j) {
      fetch_chunk<C>(wbuf + ((j + 1) & 1) * chunk_floats(C), wu, wsame, j + 1, tid);
      cp_async_wait<1>();
      __syncthreads();   // chunk j and the input tile are in shared memory
      const float* wb = wbuf + (j & 1) * chunk_floats(C);
      if (active) {
#pragma unroll 1
        for (int k = 0; k < kKC; ++k) {
          const float* xp = tile + (j * kKC + k) * kInPlane + (rg + pi) * kIn + v + pj;
          float av[9][3];
#pragma unroll
          for (int q = 0; q < 9; ++q)
#pragma unroll
            for (int c = 0; c < 3; ++c) av[q][c] = xp[q * kIn + c];
          const float4* wp = reinterpret_cast<const float4*>(wb + (k * 4 + gph) * 9 * C + 16 * g);
#pragma unroll
          for (int oy = 0; oy < 3; ++oy)
#pragma unroll
            for (int ox = 0; ox < 3; ++ox) {
              float wv[16];
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4) {
                const float4 f = wp[(oy * 3 + ox) * (C / 4) + q4];
                wv[4 * q4] = f.x;
                wv[4 * q4 + 1] = f.y;
                wv[4 * q4 + 2] = f.z;
                wv[4 * q4 + 3] = f.w;
              }
#pragma unroll
              for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int q = 0; q < 16; ++q)
                  acc[r][q] = fmaf(av[3 * r + oy][ox], wv[q], acc[r][q]);
            }
        }
      }
      __syncthreads();   // chunk j (and, after the last, the input tile) no longer read
    }

    // 3. Up-conv epilogue into the mid tile, which takes the input tile's room.
    if (active) {
      const float nw = vnw[0];
      float nz[3];
      bool inside[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int gy = y0 - 1 + 2 * (rg + 3 * r) + pi, gx = x0 - 1 + 2 * v + pj;
        inside[r] = gy >= 0 && gy < h && gx >= 0 && gx < w;
        nz[r] = inside[r] ? nw * to_f32(n1[(size_t)gy * w + gx]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int co = 16 * g + q;
        const float dd = vd1[co], bb = vb1[co], ss = vs2[co];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          tile[co * kMidPlane + (2 * (rg + 3 * r) + pi) * kMidStride + 2 * v + pj] =
              inside[r] ? act_fn(fmaf(acc[r][q], dd, nz[r] + bb)) * ss : 0.f;
      }
    }
  }

  // 4. Same-conv: thread = (column ox, 4 rows from 4 rg, 8 output channels);
  // a warp is 16 columns x 2 row groups of one channel group, and its lanes
  // read addresses 80 (rg & 1) + ox: distinct banks.
  const int ox = lane & 15;
  const int rg = (lane >> 4) + 2 * (warp & 1);
  const int g = warp >> 1;
  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  for (int j = NUP; j < NCHUNK; ++j) {
    if (j + 1 < NCHUNK) {
      fetch_chunk<C>(wbuf + ((j + 1) & 1) * chunk_floats(C), wu, wsame, j + 1, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk j and the mid tile are in shared memory
    const float* wb = wbuf + (j & 1) * chunk_floats(C);
#pragma unroll 2
    for (int k = 0; k < kKC; ++k) {
      const float* mp = tile + ((j - NUP) * kKC + k) * kMidPlane + 4 * rg * kMidStride + ox;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float av[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) av[q] = mp[q * kMidStride + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(wb + (k * 9 + ky * 3 + kx) * C + 8 * g);
          const float4 f0 = wp[0], f1 = wp[1];
          const float wv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p + ky], wv[q], acc[p][q]);
        }
      }
    }
    __syncthreads();   // chunk j (and, after the last, the mid tile) no longer read
  }

  // 5. Same-conv epilogue: x2, stored when asked; x2 * s3 into the ToRGB tile
  // (the mid tile's room).
  const int gx = x0 + ox;
  float nz[4];
  bool inside[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gy = y0 + 4 * rg + p;
    inside[p] = gy < h && gx < w;
    nz[p] = inside[p] ? vnw[1] * to_f32(n2[(size_t)gy * w + gx]) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = 8 * g + q;
    const float dd = vd2[co], bb = vb2[co], ss = vs3[co];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float val = act_fn(fmaf(acc[p][q], dd, nz[p] + bb));
      if (x2 != nullptr && inside[p])
        from_f32(val, x2 + (((size_t)b * C + co) * h + y0 + 4 * rg + p) * w + gx);
      tile[co * kTile * kTile + (4 * rg + p) * kTile + ox] = val * ss;
    }
  }
  __syncthreads();

  // 6. ToRGB: the C channels of each output pixel.
  for (int p = tid; p < kTile * kTile; p += NT) {
    const int gy = y0 + p / kTile, gxp = x0 + p % kTile;
    if (gy >= h || gxp >= w) continue;
    float out[3] = {vrb[0], vrb[1], vrb[2]};
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float v = tile[c * kTile * kTile + p];
#pragma unroll
      for (int o = 0; o < 3; ++o) out[o] = fmaf(v, vwr[o * C + c], out[o]);
    }
#pragma unroll
    for (int o = 0; o < 3; ++o)
      from_f32(out[o], rgb + (((size_t)b * 3 + o) * h + gy) * w + gxp);
  }
}

template <typename T, int C>
cudaError_t launch_c(const void* const* in, void* rgb, void* x2, int b, int hi, int wi,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(C);
  cudaError_t err = cudaFuncSetAttribute(
      section_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto t = [&](int i) { return static_cast<const T*>(in[i]); };
  auto f = [&](int i) { return static_cast<const float*>(in[i]); };
  section_kernel<T, C><<<(unsigned)blocks, 8 * C, smem, stream>>>(
      t(0), f(1), f(2), f(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10), t(11), t(12), t(13),
      t(14), t(15), static_cast<T*>(rgb), static_cast<T*>(x2), hi, wi, tiles_x, tiles_y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* in, void* rgb, void* x2, int b, int c, int hi, int wi,
                   cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch_c<T, 16>(in, rgb, x2, b, hi, wi, stream);
    case 32:
      return launch_c<T, 32>(in, rgb, x2, b, hi, wi, stream);
    case 64:
      return launch_c<T, 64>(in, rgb, x2, b, hi, wi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation).
namespace tc {

constexpr int kThreads = 256;                   // 8 warps
constexpr int kInWin = kTile / 2 + 4;           // input tile with the up-conv's halo
constexpr int kInPix = kInWin * kInWin;
constexpr int kMidPix = kMid * kMid;
constexpr int kPos = kGroup * kGroup;           // positions of one parity group
constexpr int kUpMT = 3;                        // up-conv m16 tiles a warp: 2 warps x 48 rows cover 81
constexpr int kSameMT = 2;                      // same-conv m16 tiles (output rows) a warp
constexpr int kStages = 3;                      // weight chunks: ring of shared slots
// Blocks an SM that __launch_bounds__ asks registers for: left alone, the
// compiler takes 170-220 registers a thread at C = 64 (one block an SM) and
// 108-125 at C = 16 and 32; held to 128, 85 and 64 (two, three and four
// blocks, as many as shared memory allows), the sections ran 5-30 % faster
// on the card though some registers spill at C = 64
// (scripts/measure_sg2_tail_tc_rate.py).
template <int C>
constexpr int kMinBlocks = C == 64 ? 2 : (C == 32 ? 3 : 4);
static_assert(kThreads / 32 == 4 * 2 && 2 * kUpMT * 16 >= kPos && 8 * kSameMT == kTile,
              "warp maps: 4 parities x 2 row groups; 8 warps x 2 output rows");

// Sizes in bytes.
template <int C>
struct Cfg {
  static constexpr int CI = 2 * C;
  static constexpr int NT = C / 8;                          // n8 tiles of one product
  static constexpr int IN_ROW = 2 * (CI + 8);
  static constexpr int MID_ROW = 2 * (C + 8);
  // Up-conv chunk j: polyphase tap t = j / UP_KB (oy, ox), input channels
  // (j % UP_KB) * 32 + [0, 32), rows (phase, co).
  static constexpr int UP_ROW = 2 * (32 + 8);
  static constexpr int UP_KB = CI / 32;
  static constexpr int NUP = 9 * UP_KB;
  // Same-conv chunk: ST taps x 16 input channels, rows (tap, co).
  static constexpr int ST = C == 64 ? 3 : 9;
  static constexpr int SAME_ROW = 2 * (16 + 8);
  static constexpr int SAME_KB = C / 16;
  static constexpr int NCHUNK = NUP + (9 / ST) * SAME_KB;
  static constexpr int UP_SLOT = 4 * C * UP_ROW;
  static constexpr int SAME_SLOT = ST * C * SAME_ROW;
  static constexpr int SLOT = UP_SLOT > SAME_SLOT ? UP_SLOT : SAME_SLOT;
  // The per-sample vectors (f32): s1 [2C]; d1, s2, d2, s3, b1, b2 [C]; ToRGB
  // [3][C]; its bias [3]; the two noise weights.
  static constexpr int VEC = (4 * (11 * C + 5) + 15) / 16 * 16;
  // The input tile, then the mid tile in its room.
  static constexpr int ACT = kInPix * IN_ROW > kMidPix * MID_ROW ? kInPix * IN_ROW
                                                                 : kMidPix * MID_ROW;
  static constexpr int SMEM = VEC + ACT + kStages * SLOT;
  static_assert((IN_ROW / 16) % 2 == 1 && (MID_ROW / 16) % 2 == 1 && (UP_ROW / 16) % 2 == 1 &&
                    (SAME_ROW / 16) % 2 == 1,
                "odd 16-byte units per row: conflict-free ldmatrix");
};

// Weight chunk j into a ring slot (nothing past the last chunk). wu is the
// polyphase up-conv weight [tap (oy, ox)][phase (py, px)][co][ci], wsame the
// same-conv weight [tap][co][ci], both bf16.
template <int C>
__device__ __forceinline__ void fetch_chunk(uint32_t slot, const bf16* __restrict__ wu,
                                            const bf16* __restrict__ wsame, int j, int tid) {
  using K = Cfg<C>;
  if (j >= K::NCHUNK) return;
  if (j < K::NUP) {
    const int t = j / K::UP_KB, kb = j - t * K::UP_KB;
    tcc::fetch_rows<kThreads>(slot, K::UP_ROW, wu + (size_t)t * 4 * C * K::CI + kb * 32, K::CI,
                              4 * C, 4, tid);
  } else {
    const int s = j - K::NUP, tg = s / K::SAME_KB, kb = s - tg * K::SAME_KB;
    tcc::fetch_rows<kThreads>(slot, K::SAME_ROW, wsame + (size_t)tg * K::ST * C * C + kb * 16, C,
                              K::ST * C, 2, tid);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>)
section_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wu,
               const bf16* __restrict__ wsame, const float* __restrict__ wrgb,
               const bf16* __restrict__ s1, const bf16* __restrict__ d1,
               const bf16* __restrict__ s2, const bf16* __restrict__ d2,
               const bf16* __restrict__ s3, const bf16* __restrict__ n1,
               const bf16* __restrict__ nw1, const bf16* __restrict__ b1,
               const bf16* __restrict__ n2, const bf16* __restrict__ nw2,
               const bf16* __restrict__ b2, const bf16* __restrict__ rgb_b,
               bf16* __restrict__ rgb, bf16* __restrict__ x2, int hi, int wi, int tiles_x,
               int tiles_y) {
  using K = Cfg<C>;
  constexpr int CI = K::CI, NT = K::NT;
  extern __shared__ float4 smem4[];
  float* vs1 = reinterpret_cast<float*>(smem4);   // [2C]
  float* vd1 = vs1 + CI;                          // [C] each
  float* vs2 = vd1 + C;
  float* vd2 = vs2 + C;
  float* vs3 = vd2 + C;
  float* vb1 = vs3 + C;
  float* vb2 = vb1 + C;
  float* vwr = vb2 + C;                           // [3][C]
  float* vrb = vwr + 3 * C;                       // [3]
  float* vnw = vrb + 3;                           // [2]
  char* act = reinterpret_cast<char*>(smem4) + K::VEC;   // input tile, then mid tile
  const uint32_t act_a = tc::smem_addr(act);
  const uint32_t ring = act_a + K::ACT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  int bid = blockIdx.x;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int h = 2 * hi, w = 2 * wi;
  const int y0 = ty * kTile, x0 = tx * kTile;     // output tile origin, even
  const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;   // input tile origin

  // The first two weight chunks travel while the input is staged.
  fetch_chunk<C>(ring, wu, wsame, 0, tid);
  tc::cp_async_commit();
  fetch_chunk<C>(ring + K::SLOT, wu, wsame, 1, tid);
  tc::cp_async_commit();

  // 1. The per-sample vectors, then the input tile times s1, rounded to bf16,
  // channel-last, zero outside the image.
  for (int i = tid; i < CI; i += kThreads) vs1[i] = __bfloat162float(s1[(size_t)b * CI + i]);
  for (int i = tid; i < C; i += kThreads) {
    const size_t bi = (size_t)b * C + i;
    vd1[i] = __bfloat162float(d1[bi]);
    vs2[i] = __bfloat162float(s2[bi]);
    vd2[i] = __bfloat162float(d2[bi]);
    vs3[i] = __bfloat162float(s3[bi]);
    vb1[i] = __bfloat162float(b1[i]);
    vb2[i] = __bfloat162float(b2[i]);
  }
  for (int i = tid; i < 3 * C; i += kThreads) vwr[i] = wrgb[i];
  if (tid < 3) vrb[tid] = __bfloat162float(rgb_b[tid]);
  if (tid == 0) {
    vnw[0] = __bfloat162float(nw1[0]);
    vnw[1] = __bfloat162float(nw2[0]);
  }
  __syncthreads();
  tcc::stage_nchw<kThreads>(act, K::IN_ROW, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0, ix0,
                            kInWin, [vs1](int ci, float v) { return v * vs1[ci]; }, tid);

  // 2. Up-conv: for each parity (pi, pj) of the mid pixel (2 A + pi, 2 V + pj)
  // (local parity 0 is an odd image row, phase py = 1), a 3x3 conv of input
  // pixels (A + pi + oy, V + pj + ox) with that phase's polyphase weights.
  // Warp = (parity, 3 m16 tiles of the 81 positions), all C output channels;
  // rows past the 81st repeat the last and are not stored.
  const int par = warp & 3, grp = warp >> 2;
  const int pi = par >> 1, pj = par & 1;
  {
    float acc[kUpMT][NT][4];
    tcc::zero(acc);
    uint32_t apos[kUpMT];
#pragma unroll
    for (int i = 0; i < kUpMT; ++i) {
      const int q = min(16 * (kUpMT * grp + i) + tcc::a_row(lane), kPos - 1);
      apos[i] = act_a + ((q / kGroup + pi) * kInWin + q % kGroup + pj) * K::IN_ROW +
                2 * tcc::a_k(lane);
    }
    const uint32_t blane = ((3 - par) * C + tcc::b_row(lane)) * K::UP_ROW + 2 * tcc::b_k(lane);
    for (int j = 0; j < K::NUP; ++j) {
      tcc::cp_async_wait<1>();   // chunk j has landed (this thread's copies)
      __syncthreads();           // (everyone's); chunk j - 1's slot is free
      fetch_chunk<C>(ring + ((j + 2) % kStages) * K::SLOT, wu, wsame, j + 2, tid);
      tc::cp_async_commit();
      const int t = j / K::UP_KB, kb = j - t * K::UP_KB;
      const int shift = ((t / 3) * kInWin + t % 3) * K::IN_ROW + 64 * kb;
      const uint32_t bs = ring + (j % kStages) * K::SLOT + blane;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[kUpMT];
#pragma unroll
        for (int i = 0; i < kUpMT; ++i) a[i] = apos[i] + shift + 32 * ks;
        tcc::mma_step(acc, a, bs + 32 * ks, 16 * K::UP_ROW);
      }
    }
    __syncthreads();   // every warp is done with the input tile: the mid tile takes its room

    // Epilogue: * d1, + nw1 * noise1 + b1, leaky * sqrt 2, * s2, bf16 into the
    // mid tile; zero outside the image.
#pragma unroll
    for (int i = 0; i < kUpMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 16 * (kUpMT * grp + i) + gq + 8 * hh;
        if (q >= kPos) continue;
        const int mi = 2 * (q / kGroup) + pi, mj = 2 * (q % kGroup) + pj;
        const int gy = y0 - 1 + mi, gx = x0 - 1 + mj;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        const float nz = inside ? vnw[0] * __bfloat162float(n1[(size_t)gy * w + gx]) : 0.f;
        uint32_t* row = reinterpret_cast<uint32_t*>(act + (mi * kMid + mj) * K::MID_ROW);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int co = 8 * n + 2 * tq;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = inside ? act_fn(fmaf(acc[i][n][2 * hh + e], vd1[co + e], nz + vb1[co + e])) *
                                vs2[co + e]
                          : 0.f;
          row[4 * n + tq] = tc::pack_bf16x2(v[0], v[1]);
        }
      }
  }

  // 3. Same-conv from the mid tile: warp = output rows 2 warp, 2 warp + 1 (one
  // m16 tile each, its 16 columns the rows of the tile), all C channels.
  float acc[kSameMT][NT][4];
  tcc::zero(acc);
  uint32_t apx[kSameMT];
#pragma unroll
  for (int i = 0; i < kSameMT; ++i)
    apx[i] = act_a + ((kSameMT * warp + i) * kMid + tcc::a_row(lane)) * K::MID_ROW +
             2 * tcc::a_k(lane);
  const uint32_t blane = tcc::b_row(lane) * K::SAME_ROW + 2 * tcc::b_k(lane);
  for (int j = K::NUP; j < K::NCHUNK; ++j) {
    tcc::cp_async_wait<1>();
    __syncthreads();   // chunk j and (at the first) the mid tile are in shared memory
    fetch_chunk<C>(ring + ((j + 2) % kStages) * K::SLOT, wu, wsame, j + 2, tid);
    tc::cp_async_commit();
    const int s = j - K::NUP, tg = s / K::SAME_KB, kb = s - tg * K::SAME_KB;
    const uint32_t bs = ring + (j % kStages) * K::SLOT + blane;
#pragma unroll
    for (int tt = 0; tt < K::ST; ++tt) {
      const int tap = tg * K::ST + tt;
      uint32_t a[kSameMT];
#pragma unroll
      for (int i = 0; i < kSameMT; ++i)
        a[i] = apx[i] + ((tap / 3) * kMid + tap % 3) * K::MID_ROW + 32 * kb;
      tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);
    }
  }

  // 4. Epilogue: * d2, + nw2 * noise2 + b2, leaky * sqrt 2 is x2 (stored when
  // asked); ToRGB of x2 * s3 from the accumulators (a quad's partials) + bias.
#pragma unroll
  for (int i = 0; i < kSameMT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gy = y0 + kSameMT * warp + i, gx = x0 + gq + 8 * hh;
      const bool inside = gy < h && gx < w;
      const float nz = inside ? vnw[1] * __bfloat162float(n2[(size_t)gy * w + gx]) : 0.f;
      float out[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * n + 2 * tq + e;
          const float v = act_fn(fmaf(acc[i][n][2 * hh + e], vd2[co], nz + vb2[co]));
          if (x2 != nullptr && inside)
            x2[(((size_t)b * C + co) * h + gy) * w + gx] = __float2bfloat16(v);
          const float m = v * vs3[co];
#pragma unroll
          for (int o = 0; o < 3; ++o) out[o] = fmaf(m, vwr[o * C + co], out[o]);
        }
#pragma unroll
      for (int o = 0; o < 3; ++o) out[o] = tc::quad_sum(out[o]);
      if (inside && tq < 3) {
        const float r = tq == 0 ? out[0] : (tq == 1 ? out[1] : out[2]);
        rgb[(((size_t)b * 3 + tq) * h + gy) * w + gx] = __float2bfloat16(r + vrb[tq]);
      }
    }
}

template <int C>
cudaError_t launch_c(const void* const* in, void* rgb, void* x2, int b, int hi, int wi,
                     cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(section_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto t = [&](int i) { return static_cast<const bf16*>(in[i]); };
  section_kernel<C><<<(unsigned)blocks, kThreads, smem, stream>>>(
      t(0), t(1), t(2), static_cast<const float*>(in[3]), t(4), t(5), t(6), t(7), t(8), t(9),
      t(10), t(11), t(12), t(13), t(14), t(15), static_cast<bf16*>(rgb), static_cast<bf16*>(x2),
      hi, wi, tiles_x, tiles_y);
  return cudaGetLastError();
}

cudaError_t launch(const void* const* in, void* rgb, void* x2, int b, int c, int hi, int wi,
                   cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch_c<16>(in, rgb, x2, b, hi, wi, stream);
    case 32:
      return launch_c<32>(in, rgb, x2, b, hi, wi, stream);
    case 64:
      return launch_c<64>(in, rgb, x2, b, hi, wi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: tensor cores in split precision (3xTF32 on mma.sync m16n8k8,
// tc_tf32.cuh), the stride-2 transposed conv and then the blur.
namespace tf {

using tc::FragA;

constexpr int kThreads = 256;                   // 8 warps
constexpr int kInWin = kTile / 2 + 4;           // input tile with the transposed conv's halo
constexpr int kInPix = kInWin * kInWin;
constexpr int kT = kMid + 3;                    // pre-blur window: the mid tile and the blur's 3
constexpr int kTPix = kT * kT;
constexpr int kEven = (kT + 1) / 2;             // even rows (columns) of the window: 11
// The products' accumulators are added into float32 sums (rounded to nearest)
// and start again from 0 after this many k8 steps (chains of 12 mma.sync), and
// at the end of each parity group and of the same-conv. The tensor cores round
// their float32 sums toward zero: one chain over a parity group's K (up to 3 x
// 64 products at C = 64) shrinks the outputs by up to 2.8e-6 of their mean
// magnitude in the CPU emulation (tests/test_torch_sg2_tail_f32_split_numerics.py),
// these flushes by 4e-8 to 2e-7 (1.0e-7 and 4.4e-8 measured on the card at the
// two full-width sections); 4 is the longest interval that keeps the emulated
// error within 1.5x the plain f32 section's own distance from float64.
constexpr int kFlushSteps = 4;
constexpr int kChunkSteps = 2;                  // k8 steps (16 input channels) of a weight chunk
// Blocks an SM, as shared memory allows them (__launch_bounds__ holds the
// registers to it), and the ring's slots: C = 32 takes two slots so that two
// blocks fit (one block with three slots took 6.86 against 4.90 ms at B = 4,
// scripts/measure_sg2_tail_tc_rate.py).
template <int C>
constexpr int kBlocksPerSM = C == 64 ? 1 : (C == 32 ? 2 : 3);
template <int C>
constexpr int kRing = C == 32 ? 2 : 3;
static_assert(kThreads / 32 == 8 && (kEven * kEven + 15) / 16 <= 8 && 8 * 2 == kTile,
              "warp maps: 4 m16 pairs x 2 column halves cover a parity group; 8 warps x 2 "
              "output rows");

// Sizes: strides in floats, regions in bytes.
template <int C>
struct Cfg {
  static constexpr int CI = 2 * C;
  static constexpr int NT = C / 8;                              // n8 tiles of a product
  static constexpr int IN_STRIDE = 4 * tc::f32_row_units(CI);   // a pixel of the input tile
  static constexpr int T_STRIDE = 4 * tc::f32_row_units(C);     // a pixel of the T / mid tile
  static constexpr int CHUNK = kChunkSteps * NT * 32 * 16;      // records of a weight chunk
  static constexpr int UP_KB = CI / 16, SAME_KB = C / 16;       // chunks of a tap
  static constexpr int NUP = 9 * UP_KB;
  static constexpr int NCHUNK = NUP + 9 * SAME_KB;
  // The per-sample vectors (f32): s1 [2C]; d1, s2, d2, s3, b1, b2 [C]; ToRGB
  // [3][C]; its bias [3]; the two noise weights.
  static constexpr int VEC = (4 * (11 * C + 5) + 15) / 16 * 16;
  static constexpr int NZ = (4 * kMid * kMid + 15) / 16 * 16;   // the mid tile's noise1
  static constexpr int IN = kInPix * IN_STRIDE * 4;
  static constexpr int TT = kTPix * T_STRIDE * 4;
  static constexpr int SMEM = VEC + NZ + IN + TT + kRing<C> * CHUNK;
};

// Weight chunk j into a ring slot (nothing past the last chunk): the records
// of one tap x 16 input channels for all C output channels, as the wrapper
// lays them out ([chunk][k8 step][n8 tile][lane] of {hi b0, hi b1, lo b0, lo
// b1}): chunks 0 .. NUP - 1 the transposed conv's, in the kernel's order of
// taps, the rest the same-conv's.
template <int C>
__device__ __forceinline__ void fetch_chunk(uint32_t slot, const uint4* __restrict__ wu,
                                            const uint4* __restrict__ wsame, int j, int tid) {
  using K = Cfg<C>;
  if (j >= K::NCHUNK) return;
  const uint4* src = j < K::NUP ? wu + (size_t)j * (K::CHUNK / 16)
                                : wsame + (size_t)(j - K::NUP) * (K::CHUNK / 16);
  tcc::fetch_units<kThreads>(slot, src, K::CHUNK / 16, tid);
}

// sum += acc, rounded to nearest; acc = 0.
template <int M, int N>
__device__ __forceinline__ void flush(float (&sum)[M][N][4], float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[i][n][e] += acc[i][n][e];
        acc[i][n][e] = 0.f;
      }
}

// One tap of the blur, [1, 3, 3, 1] / 4 (the 2-D kernel's gain of 4 split
// over its two passes).
__device__ __forceinline__ float blur4(float t0, float t1, float t2, float t3) {
  return fmaf(0.75f, t1 + t2, 0.25f * (t0 + t3));
}

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<C>)
section_kernel(const float* __restrict__ x, const uint4* __restrict__ wu,
               const uint4* __restrict__ wsame, const float* __restrict__ wrgb,
               const float* __restrict__ s1, const float* __restrict__ d1,
               const float* __restrict__ s2, const float* __restrict__ d2,
               const float* __restrict__ s3, const float* __restrict__ n1,
               const float* __restrict__ nw1, const float* __restrict__ b1,
               const float* __restrict__ n2, const float* __restrict__ nw2,
               const float* __restrict__ b2, const float* __restrict__ rgb_b,
               float* __restrict__ rgb, float* __restrict__ x2, int hi, int wi, int tiles_x,
               int tiles_y) {
  using K = Cfg<C>;
  constexpr int CI = K::CI, NT = K::NT, NW = NT / 2, TS = K::T_STRIDE, RING = kRing<C>;
  extern __shared__ float4 smem4[];
  float* vs1 = reinterpret_cast<float*>(smem4);   // [2C]
  float* vd1 = vs1 + CI;                          // [C] each
  float* vs2 = vd1 + C;
  float* vd2 = vs2 + C;
  float* vs3 = vd2 + C;
  float* vb1 = vs3 + C;
  float* vb2 = vb1 + C;
  float* vwr = vb2 + C;                           // [3][C]
  float* vrb = vwr + 3 * C;                       // [3]
  float* vnw = vrb + 3;                           // [2]
  float* nzt = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + K::VEC);   // [18][18]
  float* in = reinterpret_cast<float*>(reinterpret_cast<char*>(nzt) + K::NZ);
  float* tt = reinterpret_cast<float*>(reinterpret_cast<char*>(in) + K::IN);   // T, then mid
  const uint4* ring = reinterpret_cast<const uint4*>(reinterpret_cast<char*>(tt) + K::TT);
  const uint32_t ring_a = tc::smem_addr(ring);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  int bid = blockIdx.x;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int h = 2 * hi, w = 2 * wi;
  const int y0 = ty * kTile, x0 = tx * kTile;     // output tile origin, even
  const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;   // input tile origin

  // The input tile's copies and the mid tile's noise1 (zero outside the
  // image), then the first weight chunks, travel while the vectors load.
  tcc::stage_nchw_f32<kThreads>(in, K::IN_STRIDE, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0,
                                ix0, kInWin, tid);
  for (int i = tid; i < kMid * kMid; i += kThreads) {
    const int gy = y0 - 1 + i / kMid, gx = x0 - 1 + i % kMid;
    const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
    tc::cp_async4(tc::smem_addr(nzt + i), ok ? n1 + (size_t)gy * w + gx : n1, ok);
  }
  tc::cp_async_commit();
  for (int s = 0; s < RING - 1; ++s) {
    fetch_chunk<C>(ring_a + s * K::CHUNK, wu, wsame, s, tid);
    tc::cp_async_commit();
  }
  // Chunk j has landed for everyone, and the slot of chunk j - 1 is free: it
  // takes chunk j + RING - 1. One block barrier a chunk.
  auto land = [&](int j) {
    tcc::cp_async_wait<RING - 2>();
    __syncthreads();
    fetch_chunk<C>(ring_a + ((j + RING - 1) % RING) * K::CHUNK, wu, wsame, j + RING - 1, tid);
    tc::cp_async_commit();
    return ring + (j % RING) * (K::CHUNK / 16);
  };

  // 1. The per-sample vectors, then the input tile (channel-last, zero outside
  // the image) times s1, in place once it has landed.
  for (int i = tid; i < CI; i += kThreads) vs1[i] = s1[(size_t)b * CI + i];
  for (int i = tid; i < C; i += kThreads) {
    const size_t bi = (size_t)b * C + i;
    vd1[i] = d1[bi];
    vs2[i] = s2[bi];
    vd2[i] = d2[bi];
    vs3[i] = s3[bi];
    vb1[i] = b1[i];
    vb2[i] = b2[i];
  }
  for (int i = tid; i < 3 * C; i += kThreads) vwr[i] = wrgb[i];
  if (tid < 3) vrb[tid] = rgb_b[tid];
  if (tid == 0) {
    vnw[0] = nw1[0];
    vnw[1] = nw2[0];
  }
  tcc::cp_async_wait<RING - 1>();   // this thread's input copies (the oldest group)
  __syncthreads();
  for (int i = tid; i < kInPix * CI; i += kThreads) {   // times s1
    const int p = i / CI, ci = i - p * CI;
    in[p * K::IN_STRIDE + ci] *= vs1[ci];
  }

  // 2. The transposed conv into the pre-blur window T (21 x 21, from (y0 - 2,
  // x0 - 2)). Window pixel (2u + pr, 2v + pc) takes the kernel taps ky = pr
  // (mod 2), kx = pc (mod 2): 4, 2, 2 and 1 taps for the parity groups (0, 0),
  // (0, 1), (1, 0), (1, 1) of 11 x 11, 11 x 10, 10 x 11 and 10 x 10
  // positions; tap (ky, kx) reads input pixel (u + 1 - ky / 2, v + 1 - kx / 2)
  // of the tile. Each group is an implicit GEMM, M = its positions, N = C, K
  // = its taps x 2C; warp = (m16 tiles 2 mp and 2 mp + 1, n8 tiles of column
  // half nh). Rows past the group's positions repeat its last and are not
  // stored; a second m16 tile without positions is skipped.
  int j = 0;   // weight chunks used
  {
    const int mp = warp >> 1, nh = warp & 1;
#pragma unroll 1
    for (int g = 0; g < 4; ++g) {
      const int pr = g >> 1, pc = g & 1;
      const int nc = kEven - pc, npos = (kEven - pr) * nc;
      const bool two = 16 * (2 * mp + 1) < npos;
      const float* ap[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = min(16 * (2 * mp + i) + gq + 8 * hh, npos - 1);
          const int u = q / nc, v = q - u * nc;
          ap[i][hh] = in + ((u + 1) * kInWin + v + 1) * K::IN_STRIDE + tq;
        }
      float acc[2][NW][4], sum[2][NW][4];
      tcc::zero(acc);
      tcc::zero(sum);
      const int taps_x = pc ? 1 : 2;
      const int ntaps = (pr ? 1 : 2) * taps_x;
      int since = 0;   // k8 steps since the last flush
#pragma unroll 1
      for (int t = 0; t < ntaps; ++t) {
        const int ky = pr ? 1 : 2 * (t / taps_x), kx = pc ? 1 : 2 * (t % taps_x);
        const int shift = ((ky >> 1) * kInWin + (kx >> 1)) * K::IN_STRIDE;
#pragma unroll 1
        for (int kb = 0; kb < K::UP_KB; ++kb, ++j) {
          const uint4* rec = land(j) + nh * NW * 32 + lane;
#pragma unroll
          for (int s = 0; s < kChunkSteps; ++s) {
            const int k = 16 * kb + 8 * s - shift;
            uint4 bw[NW];
#pragma unroll
            for (int n = 0; n < NW; ++n) bw[n] = rec[(s * NT + n) * 32];
            const FragA a0 = tc::frag_a(ap[0][0][k], ap[0][1][k], ap[0][0][k + 4], ap[0][1][k + 4]);
            tc::mma3_records<NW>(acc[0], a0, bw, NW);   // transposed-conv products
            if (two) {
              const FragA a1 =
                  tc::frag_a(ap[1][0][k], ap[1][1][k], ap[1][0][k + 4], ap[1][1][k + 4]);
              tc::mma3_records<NW>(acc[1], a1, bw, NW);   // transposed-conv products
            }
          }
          since += kChunkSteps;
          if (since >= kFlushSteps) {
            flush(sum, acc);
            since = 0;
          }
        }
      }
      if (since != 0) flush(sum, acc);
      // The group's positions into T; IN and T are apart, so no barrier.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * (2 * mp + i) + gq + 8 * hh;
          if (q >= npos || (i == 1 && !two)) continue;
          const int u = q / nc, v = q - u * nc;
          float* row = tt + ((2 * u + pr) * kT + 2 * v + pc) * TS + 8 * NW * nh + 2 * tq;
#pragma unroll
          for (int n = 0; n < NW; ++n)
            *reinterpret_cast<float2*>(row + 8 * n) = make_float2(sum[i][n][2 * hh],
                                                                  sum[i][n][2 * hh + 1]);
        }
    }
  }
  __syncthreads();   // T is whole

  // 3. The blur, in place in T: the columns, then the rows, whose epilogue
  // (* d1, + nw1 * noise1 + b1, leaky * sqrt 2, * s2) leaves the 18 x 18 mid
  // tile (from (y0 - 1, x0 - 1)) at the top left of T's room; mid pixels
  // outside the image are zero. A thread owns one channel of a column, then
  // of a row, and slides a window of four along it.
  for (int item = tid; item < kT * C; item += kThreads) {   // the columns' pass
    const int co = item % C, c = item / C;
    float* col = tt + c * TS + co;
    float t0 = col[0], t1 = col[kT * TS], t2 = col[2 * kT * TS];
#pragma unroll 2
    for (int r = 0; r < kMid; ++r) {
      const float t3 = col[(r + 3) * kT * TS];
      col[r * kT * TS] = blur4(t0, t1, t2, t3);
      t0 = t1;
      t1 = t2;
      t2 = t3;
    }
  }
  __syncthreads();
  for (int item = tid; item < kMid * C; item += kThreads) {   // the rows' pass and epilogue
    const int co = item % C, i = item / C;
    float* row = tt + i * kT * TS + co;
    const int gy = y0 - 1 + i;
    const bool row_in = gy >= 0 && gy < h;
    const float dd = vd1[co], bb = vb1[co], ss = vs2[co], nw = vnw[0];
    float t0 = row[0], t1 = row[TS], t2 = row[2 * TS];
#pragma unroll 2
    for (int jj = 0; jj < kMid; ++jj) {
      const float t3 = row[(jj + 3) * TS];
      const int gx = x0 - 1 + jj;
      const bool inside = row_in && gx >= 0 && gx < w;
      row[jj * TS] = inside ? act_fn(fmaf(blur4(t0, t1, t2, t3), dd,
                                          nw * nzt[i * kMid + jj] + bb)) * ss
                            : 0.f;
      t0 = t1;
      t1 = t2;
      t2 = t3;
    }
  }

  // 4. Same-conv from the mid tile: M = the 256 output pixels (an m16 tile is
  // one output row), N = C, K = 9 taps x C; warp = output rows 2 warp and 2
  // warp + 1, all C channels. (The first chunk's barrier covers the mid tile.)
  float acc[2][NT][4], sum[2][NT][4];
  tcc::zero(acc);
  tcc::zero(sum);
  const float* apx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) apx[i] = tt + ((2 * warp + i) * kT + gq) * TS + tq;
  int since = 0;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * kT + tap % 3) * TS;
#pragma unroll 1
    for (int kb = 0; kb < K::SAME_KB; ++kb, ++j) {
      const uint4* rec = land(j) + lane;
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        const int k = off + 16 * kb + 8 * s;
        uint4 bw[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) bw[n] = rec[(s * NT + n) * 32];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = apx[i] + k;
          const FragA a = tc::frag_a(p[0], p[8 * TS], p[4], p[8 * TS + 4]);
          tc::mma3_records<NT>(acc[i], a, bw, NT);   // same-conv products
        }
      }
      since += kChunkSteps;
      if (since >= kFlushSteps) {
        flush(sum, acc);
        since = 0;
      }
    }
  }
  if (since != 0) flush(sum, acc);

  // 5. Epilogue: * d2, + nw2 * noise2 + b2, leaky * sqrt 2 is x2 (stored when
  // asked); ToRGB of x2 * s3 from the sums (a quad's partials) + bias.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int oy = y0 + 2 * warp + i, ox = x0 + gq + 8 * hh;
      const bool inside = oy < h && ox < w;
      const float nz = inside ? vnw[1] * n2[(size_t)oy * w + ox] : 0.f;
      float out[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * n + 2 * tq + e;
          const float v = act_fn(fmaf(sum[i][n][2 * hh + e], vd2[co], nz + vb2[co]));
          if (x2 != nullptr && inside) x2[(((size_t)b * C + co) * h + oy) * w + ox] = v;
          const float m = v * vs3[co];
#pragma unroll
          for (int o = 0; o < 3; ++o) out[o] = fmaf(m, vwr[o * C + co], out[o]);
        }
#pragma unroll
      for (int o = 0; o < 3; ++o) out[o] = tc::quad_sum(out[o]);
      if (inside && tq < 3) {
        const float r = tq == 0 ? out[0] : (tq == 1 ? out[1] : out[2]);
        rgb[(((size_t)b * 3 + tq) * h + oy) * w + ox] = r + vrb[tq];
      }
    }
}

template <int C>
cudaError_t launch_c(const void* const* in, void* rgb, void* x2, int b, int hi, int wi,
                     cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(section_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(in[i]); };
  auto r = [&](int i) { return static_cast<const uint4*>(in[i]); };
  section_kernel<C><<<(unsigned)blocks, kThreads, smem, stream>>>(
      f(0), r(1), r(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11), f(12), f(13),
      f(14), f(15), static_cast<float*>(rgb), static_cast<float*>(x2), hi, wi, tiles_x, tiles_y);
  return cudaGetLastError();
}

cudaError_t launch(const void* const* in, void* rgb, void* x2, int b, int c, int hi, int wi,
                   cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch_c<16>(in, rgb, x2, b, hi, wi, stream);
    case 32:
      return launch_c<32>(in, rgb, x2, b, hi, wi, stream);
    case 64:
      return launch_c<64>(in, rgb, x2, b, hi, wi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tf

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma m64nCk16, bf16 operands, f32 accumulation,
// tc_wgmma.cuh), the stride-2 transposed conv and then the blur, the weights
// through a ring of shared slots filled by the TMA unit.
namespace wg {

using tc::bf16;

constexpr int kConsumers = 2;           // warpgroups that multiply
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;   // and one producer warp
constexpr int kInWin = kTile / 2 + 4;   // input tile with the transposed conv's halo
constexpr int kInPix = kInWin * kInWin;
constexpr int kMidPix = kMid * kMid;
constexpr int kT = kMid + 3;            // pre-blur window: the mid tile and the blur's 3
constexpr int kTPix = kT * kT;
constexpr int kEven = (kT + 1) / 2;     // even rows (columns) of the window: 11
constexpr int kUpChunks = 9;            // weight chunks: the transposed conv's taps,
constexpr int kChunks = kUpChunks + 9;  // then the same-conv's
constexpr int kRow = 24;                // pixels of a copied input row: 3 units of 8
constexpr int kNRow = 32;               // of a copied noise1 row: 4 units
// The transposed conv's chunk j: its parity group (ky, kx mod 2) and tap (ky,
// kx), in the wrapper's UP_TAP_ORDER.
__host__ __device__ constexpr int up_group(int j) {
  return j < 4 ? 0 : (j < 6 ? 1 : (j < 8 ? 2 : 3));
}
__host__ __device__ constexpr int up_ky(int j) {
  return j < 4 ? 2 * (j >> 1) : (j < 6 ? 2 * (j - 4) : 1);
}
__host__ __device__ constexpr int up_kx(int j) {
  return j < 4 ? 2 * (j & 1) : (j < 6 ? 1 : (j < 8 ? 2 * (j - 6) : 1));
}
// A channel of the x2 tile, in bf16 elements: 16 x 16 and 8 more, so the four
// channel pairs of a quad's store fall 8 banks apart.
constexpr int kXs = kTile * kTile + 8;
// Blocks an SM, as shared memory allows them (__launch_bounds__ holds the
// registers to it), and the ring's slots.
template <int C>
constexpr int kBlocksPerSM = C == 16 ? 3 : (C == 32 ? 2 : 1);
template <int C>
constexpr int kStages = C == 64 ? 3 : (C == 32 ? 4 : 6);
static_assert(kConsumers == 2 && 2 * 64 >= kEven * kEven && 4 * kConsumers * 2 == kTile,
              "warpgroup maps: one m64 tile of each parity group's two; two m64 tiles of four "
              "output rows each");

// Sizes in bytes.
template <int C>
struct Cfg {
  static constexpr int CI = 2 * C;
  static constexpr int NT = C / 8;                              // n8 tiles of a product
  static constexpr int IN_ROW = 2 * (CI + 8);                   // a pixel of the input tile
  static constexpr int MID_ROW = 2 * (C + 8);                   // a pixel of the mid tile
  static constexpr int TS = 4 * tc::f32_row_units(C);           // floats a pixel of T
  static constexpr int UP_BYTES = 2 * CI * C;                   // a raw tap of the transposed conv
  static constexpr int SAME_BYTES = 2 * C * C;                  // a tap of the same-conv
  static constexpr int RING = kStages<C> * UP_BYTES;
  static constexpr int BARS = (2 * 8 * kStages<C> + 15) / 16 * 16;
  // T; in its room before T is written, the tile's copied input rows.
  static constexpr int TT = kTPix * TS * 4;
  // The input tile, then the mid tile, then the x2 tile in its room.
  static constexpr int ACT = kInPix * IN_ROW > kMidPix * MID_ROW ? kInPix * IN_ROW
                                                                 : kMidPix * MID_ROW;
  // f32: b1, b2 [C], ToRGB [3][C], its bias [3], the two noise weights.
  static constexpr int CONST = (4 * (5 * C + 5) + 15) / 16 * 16;
  // bf16 as copied, two tiles' each: s1 [2C], d1, s2, d2, s3 [C]; noise1 [18][32] from
  // (y0 - 1, x0 - 8); noise2 [16][16] from (y0, x0).
  static constexpr int VRAW = 2 * 6 * C;
  static constexpr int N1 = 2 * kMid * kNRow;
  static constexpr int N2 = 2 * kTile * kTile;
  static constexpr int SMEM = RING + BARS + TT + ACT + CONST + 2 * (VRAW + N1 + N2);
  static_assert((IN_ROW / 16) % 2 == 1 && (MID_ROW / 16) % 2 == 1,
                "odd 16-byte units per row: conflict-free ldmatrix");
  static_assert(CI * kInWin * kRow * 2 <= TT && C * kXs * 2 <= ACT && VRAW % 16 == 0,
                "the copied input rows fit T's room, the x2 tile the tile room");
  static_assert(SMEM * kBlocksPerSM<C> + 1024 * kBlocksPerSM<C> <= 233472,
                "the blocks an SM fit its shared memory");
};

using tf::blur4;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Chunk k of the ring: wait until it has landed, return its slot; let the
// producer have its slot again once this warp's products are done.
template <int S, int SLOT>
__device__ __forceinline__ uint32_t take(uint32_t ring, uint32_t full, int k) {
  wgm::bar_wait(full + 8 * (k % S), (k / S) & 1);
  return ring + (k % S) * SLOT;
}
template <int S>
__device__ __forceinline__ void release(uint32_t empty, int lane, int k) {
  if (lane == 0) wgm::bar_arrive(empty + 8 * (k % S));
}

// KS k16 steps of A fragments from this lane's row address, 32 bytes apart.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], uint32_t addr) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) tc::ldsm_x4(a[ks], addr + 32 * ks);
}

// Tile t's origin: image, output row, output column.
__device__ __forceinline__ void origin(int t, int tiles_x, int tiles_y, int& img, int& oy,
                                       int& ox) {
  ox = (t % tiles_x) * kTile;
  t /= tiles_x;
  oy = (t % tiles_y) * kTile;
  img = t / tiles_y;
}

// Tile t's operands by 16-byte cp.async, zero outside the image, one commit
// group: its per-sample vectors into r (bf16, as copied); where vec, also its
// input rows into rows ([2C][12 rows][24 pixels from ix0 - 6, a multiple of
// 8]) and its noise rows into r after the vectors.
template <int C>
__device__ __forceinline__ void request(int t, bf16* r, void* rows, bool vec,
                                        const bf16* __restrict__ x, const bf16* __restrict__ s1,
                                        const bf16* __restrict__ d1, const bf16* __restrict__ s2,
                                        const bf16* __restrict__ d2, const bf16* __restrict__ s3,
                                        const bf16* __restrict__ n1, const bf16* __restrict__ n2,
                                        int hi, int wi, int tiles_x, int tiles_y, int tid) {
  constexpr int CI = 2 * C;
  int img, oy, ox;
  origin(t, tiles_x, tiles_y, img, oy, ox);
  const uint32_t rv = tc::smem_addr(r);
  for (int i = tid; i < 6 * C / 8; i += kConsumerThreads) {
    const int u = i - CI / 8;
    const bf16* src = u < 0 ? s1 + (size_t)img * CI + 8 * i
                            : (u < C / 8 ? d1 : u < 2 * C / 8 ? s2 : u < 3 * C / 8 ? d2 : s3) +
                                  (size_t)img * C + 8 * (u % (C / 8));
    tc::cp_async16(rv + 16 * i, src, true);
  }
  if (vec) {
    const int h = 2 * hi, w = 2 * wi;
    const uint32_t dst = tc::smem_addr(rows);
    const int iy0 = oy / 2 - 2, ax = ox / 2 - 8;
    const bf16* xb = x + (size_t)img * CI * hi * wi;
    for (int i = tid; i < CI * kInWin * 3; i += kConsumerThreads) {
      const int u = i % 3, row = (i / 3) % kInWin, ci = i / (3 * kInWin);
      const int iy = iy0 + row, ix = ax + 8 * u;
      const bool ok = iy >= 0 && iy < hi && ix >= 0 && ix < wi;
      tc::cp_async16(dst + 16 * i, ok ? xb + ((size_t)ci * hi + iy) * wi + ix : xb, ok);
    }
    for (int i = tid; i < kMid * 4 + kTile * 2; i += kConsumerThreads) {
      const bool first = i < kMid * 4;
      const int row = first ? i / 4 : (i - kMid * 4) / 2, u = first ? i % 4 : (i - kMid * 4) % 2;
      const int gy = first ? oy - 1 + row : oy + row, gx = (first ? ox - 8 : ox) + 8 * u;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const bf16* src = first ? n1 : n2;
      tc::cp_async16(rv + 12 * C + 16 * i, ok ? src + (size_t)gy * w + gx : src, ok);
    }
  }
  tc::cp_async_commit();
}

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<C>)
section_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wu,
               const bf16* __restrict__ wsame, const float* __restrict__ wrgb,
               const bf16* __restrict__ s1, const bf16* __restrict__ d1,
               const bf16* __restrict__ s2, const bf16* __restrict__ d2,
               const bf16* __restrict__ s3, const bf16* __restrict__ n1,
               const bf16* __restrict__ nw1, const bf16* __restrict__ b1,
               const bf16* __restrict__ n2, const bf16* __restrict__ nw2,
               const bf16* __restrict__ b2, const bf16* __restrict__ rgb_b,
               bf16* __restrict__ rgb, bf16* __restrict__ x2, int hi, int wi, int tiles_x,
               int tiles_y, int tiles) {
  using K = Cfg<C>;
  constexpr int CI = K::CI, NT = K::NT, TS = K::TS, S = kStages<C>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const uint32_t ring = tc::smem_addr(smem);                    // S slots of UP_BYTES
  const uint32_t full = ring + K::RING;                         // S mbarriers: a chunk landed
  const uint32_t empty = full + 8 * S;                          // S mbarriers: a slot was read
  float* tt = reinterpret_cast<float*>(smem + K::RING + K::BARS);   // T [21 x 21][TS]
  char* act = smem + K::RING + K::BARS + K::TT;                 // input / mid / x2 tile
  const uint32_t act_a = tc::smem_addr(act);
  float* vb1 = reinterpret_cast<float*>(act + K::ACT);          // [C]
  float* vb2 = vb1 + C;                                         // [C]
  float* vwr = vb2 + C;                                         // [3][C]
  float* vrb = vwr + 3 * C;                                     // [3]
  float* vnw = vrb + 3;                                         // [2]
  bf16* raw = reinterpret_cast<bf16*>(act + K::ACT + K::CONST); // [2][6C + 18 x 32 + 16 x 16]
  constexpr int RAW = (K::VRAW + K::N1 + K::N2) / 2;            // elements of one tile's

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int h = 2 * hi, w = 2 * wi;
  // Copies of whole 16-byte units: every 8-pixel unit of a row lies wholly
  // inside or outside the image.
  const bool vec = (wi & 7) == 0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wgm::bar_init(full + 8 * s, 1);
      wgm::bar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    wgm::bar_init_fence();
  }
  __syncthreads();

  // The producer warp: one lane keeps the ring full, chunk k in slot k % S
  // once the consumers have read chunk k - S there. A tile takes 18 chunks:
  // the transposed conv's raw taps in UP_TAP_ORDER (2C x C each), then the
  // same-conv's (C x C), in the wgmma layout the wrapper prepares.
  if (warp == kConsumerThreads / 32) {
    if (lane == 0) {
      int k = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int j = 0; j < kChunks; ++j, ++k) {
          const int s = k % S;
          if (k >= S) wgm::bar_wait(empty + 8 * s, (k / S - 1) & 1);
          const bool up = j < kUpChunks;
          const int bytes = up ? K::UP_BYTES : K::SAME_BYTES;
          const char* src = up ? reinterpret_cast<const char*>(wu) + (size_t)j * K::UP_BYTES
                               : reinterpret_cast<const char*>(wsame) +
                                     (size_t)(j - kUpChunks) * K::SAME_BYTES;
          wgm::bar_expect(full + 8 * s, bytes);
          wgm::bulk_copy(ring + s * K::UP_BYTES, src, bytes, full + 8 * s);
        }
      }
    }
    return;
  }

  // The consumers: two warpgroups, each block a persistent loop over its
  // tiles. Chunk k's slot is read by both; each warp releases it once its
  // products are done.
  const int wgi = warp >> 2, wq = warp & 3;      // warpgroup, warp in it
  // The constant vectors, once.
  for (int i = tid; i < C; i += kConsumerThreads) {
    vb1[i] = bf(b1[i]);
    vb2[i] = bf(b2[i]);
  }
  for (int i = tid; i < 3 * C; i += kConsumerThreads) vwr[i] = wrgb[i];
  if (tid < 3) vrb[tid] = bf(rgb_b[tid]);
  if (tid == 0) {
    vnw[0] = bf(nw1[0]);
    vnw[1] = bf(nw2[0]);
  }
  request<C>(blockIdx.x, raw, tt, vec, x, s1, d1, s2, d2, s3, n1, n2, hi, wi, tiles_x, tiles_y,
             tid);

#pragma unroll 1
  for (int it = 0, tile = blockIdx.x; tile < tiles; ++it, tile += gridDim.x) {
    int b, y0, x0;
    origin(tile, tiles_x, tiles_y, b, y0, x0);
    const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;  // input tile origin
    const int p = it & 1;
    const bf16* vr = raw + p * RAW;                // s1 [2C], d1, s2, d2, s3 [C]
    const bf16* nz1 = vr + 6 * C;                  // noise1 [18][32], from (y0 - 1, x0 - 8)
    const bf16* nz2 = nz1 + kMid * kNRow;          // noise2 [16][16], from (y0, x0)
    const bf16* xb = x + (size_t)b * CI * hi * wi;
    if (!vec) {                                    // the noise rows, element by element
      bf16* n = raw + p * RAW + 6 * C;
      for (int i = tid; i < kMid * kNRow + kTile * kTile; i += kConsumerThreads) {
        const bool first = i < kMid * kNRow;
        const int gy = first ? y0 - 1 + i / kNRow : y0 + (i - kMid * kNRow) / kTile;
        const int gx = first ? x0 - 8 + i % kNRow : x0 + (i - kMid * kNRow) % kTile;
        const bf16* src = first ? n1 : n2;
        n[i] = gy >= 0 && gy < h && gx >= 0 && gx < w ? src[(size_t)gy * w + gx]
                                                      : __ushort_as_bfloat16(0);
      }
    }
    tcc::cp_async_wait<0>();
    wgm::sync_threads<kConsumerThreads>();       // the tile's copies have landed (everyone's)

    // 1. The input tile times s1, rounded to bf16, channel-last: from the
    // copied rows, a thread eight channels of a pixel, one 16-byte store; else
    // from device memory, a thread two channels of a pixel.
    if (vec) {
      const bf16* rows = reinterpret_cast<const bf16*>(tt);
      for (int i = tid; i < kInPix * (CI / 8); i += kConsumerThreads) {
        const int q = i % kInPix, oct = i / kInPix;
        const int r = q / kInWin, c = q - r * kInWin;
        const bf16* src = rows + (8 * oct * kInWin + r) * kRow + c + 6;
        uint32_t pk[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = 8 * oct + 2 * e;
          pk[e] = tc::pack_bf16x2(bf(src[2 * e * kInWin * kRow]) * bf(vr[ci]),
                                  bf(src[(2 * e + 1) * kInWin * kRow]) * bf(vr[ci + 1]));
        }
        *reinterpret_cast<uint4*>(act + q * K::IN_ROW + 16 * oct) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
    } else {
      tcc::stage_nchw<kConsumerThreads>(act, K::IN_ROW, xb, CI, hi, wi, iy0, ix0, kInWin,
                                        [vr](int ci, float v) { return v * bf(vr[ci]); }, tid);
    }
    wgm::sync_threads<kConsumerThreads>();

    // 2. The transposed conv into the pre-blur window T (21 x 21, from (y0 -
    // 2, x0 - 2)). Window pixel (2u + pr, 2v + pc) takes the kernel taps ky =
    // pr (mod 2), kx = pc (mod 2): 4, 2, 2 and 1 taps for the parity groups (0,
    // 0), (0, 1), (1, 0), (1, 1) of 11 x 11, 11 x 10, 10 x 11 and 10 x 10
    // positions; tap (ky, kx) reads input pixel (u + 1 - ky / 2, v + 1 - kx /
    // 2) of the tile. Each group is an implicit GEMM, M = its positions in two
    // m64 tiles, N = C, K = its taps x 2C; warpgroup g owns m64 tile g of every
    // group. Rows past the group's positions repeat its last and are not
    // stored. The loop over the nine chunks is unrolled: a chunk's A fragments
    // load while the chunk before is multiplied, and within a group its
    // products queue behind that chunk's.
    const int k0 = it * kChunks;                 // the tile's first chunk
    {
      float acc[NT * 4];
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
      uint32_t a[2][CI / 16][4];
      uint32_t abase[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int nc = kEven - (g & 1), npos = (kEven - (g >> 1)) * nc;
        const int q = min(64 * wgi + 16 * wq + tcc::a_row(lane), npos - 1);
        const int u = q / nc, v = q - u * nc;
        abase[g] = act_a + ((u + 1) * kInWin + v + 1) * K::IN_ROW + 2 * tcc::a_k(lane);
      }
      load_a(a[0], abase[0]);
#pragma unroll
      for (int j = 0; j < kUpChunks; ++j) {
        const int g = up_group(j);
        const bool first = j == 0 || up_group(j - 1) != g;
        const bool last = j == kUpChunks - 1 || up_group(j + 1) != g;
        const uint32_t slot = take<S, K::UP_BYTES>(ring, full, k0 + j);
        wgm::fence_operand(acc);
        wgm::fence();
#pragma unroll
        for (int ks = 0; ks < CI / 16; ++ks)
          wgm::mma<C>(acc, a[j & 1][ks], wgm::desc_b(slot + 32 * C * ks));   // up-conv products
        wgm::commit();
        if (!first) {
          wgm::wait<1>();                     // chunk j - 1's products are done
          release<S>(empty, lane, k0 + j - 1);
        }
        if (j + 1 < kUpChunks)
          load_a(a[(j + 1) & 1], abase[up_group(j + 1)] -
                                     ((up_ky(j + 1) >> 1) * kInWin + (up_kx(j + 1) >> 1)) *
                                         K::IN_ROW);
        if (last) {
          wgm::wait<0>();
          wgm::fence_operand(acc);
          release<S>(empty, lane, k0 + j);
          // The group's positions into T; the input tile and T are apart.
          const int pr = g >> 1, pc = g & 1;
          const int nc = kEven - pc, npos = (kEven - pr) * nc;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = 64 * wgi + 16 * wq + gq + 8 * hh;
            if (q >= npos) continue;
            const int qu = q / nc, qv = q - qu * nc;
            float* row = tt + ((2 * qu + pr) * kT + 2 * qv + pc) * TS + 2 * tq;
#pragma unroll
            for (int n = 0; n < NT; ++n)
              *reinterpret_cast<float2*>(row + 8 * n) = make_float2(acc[4 * n + 2 * hh],
                                                                    acc[4 * n + 2 * hh + 1]);
          }
#pragma unroll
          for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
        }
      }
    }
    wgm::sync_threads<kConsumerThreads>();   // T is whole; the input tile is no longer read

    // 3. The blur in f32: the columns in place in T, then the rows, whose
    // epilogue (* d1, + nw1 * noise1 + b1, leaky * sqrt 2, * s2) leaves the 18
    // x 18 mid tile (from (y0 - 1, x0 - 1)) in bf16 in the input tile's room;
    // mid pixels outside the image are zero. A thread owns two channels of a
    // column, then of half a row, and loads all of its window's pixels at once.
    constexpr int CP = C / 2;
    for (int item = tid; item < kT * CP; item += kConsumerThreads) {   // the columns' pass
      float2* col = reinterpret_cast<float2*>(tt + (item / CP) * TS) + item % CP;
      float2 t[kT];
#pragma unroll
      for (int r = 0; r < kT; ++r) t[r] = col[r * (kT * TS / 2)];
#pragma unroll
      for (int r = 0; r < kMid; ++r)
        col[r * (kT * TS / 2)] = make_float2(blur4(t[r].x, t[r + 1].x, t[r + 2].x, t[r + 3].x),
                                             blur4(t[r].y, t[r + 1].y, t[r + 2].y, t[r + 3].y));
    }
    wgm::sync_threads<kConsumerThreads>();
    constexpr int kHalf = kMid / 2;          // the rows' pass: half a row of the mid tile a thread
    for (int item = tid; item < kMid * 2 * CP; item += kConsumerThreads) {   // the rows' pass
      const int cp = item % CP, j0 = kHalf * ((item / CP) & 1), i = item / (2 * CP), co = 2 * cp;
      const float2* row = reinterpret_cast<const float2*>(tt + (i * kT + j0) * TS) + cp;
      uint32_t* mid = reinterpret_cast<uint32_t*>(act + (i * kMid + j0) * K::MID_ROW) + cp;
      const int gy = y0 - 1 + i;
      const bool row_in = gy >= 0 && gy < h;
      const float nw = vnw[0];
      const float dd0 = bf(vr[CI + co]), dd1 = bf(vr[CI + co + 1]);
      const float ss0 = bf(vr[CI + C + co]), ss1 = bf(vr[CI + C + co + 1]);
      const float bb0 = vb1[co], bb1 = vb1[co + 1];
      float2 t[kHalf + 3];
#pragma unroll
      for (int r = 0; r < kHalf + 3; ++r) t[r] = row[r * (TS / 2)];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const int gx = x0 - 1 + j0 + jj;
        const bool inside = row_in && gx >= 0 && gx < w;
        const float nz = nw * bf(nz1[i * kNRow + j0 + jj + 7]);
        const float v0 = blur4(t[jj].x, t[jj + 1].x, t[jj + 2].x, t[jj + 3].x);
        const float v1 = blur4(t[jj].y, t[jj + 1].y, t[jj + 2].y, t[jj + 3].y);
        mid[jj * (K::MID_ROW / 4)] =
            inside ? tc::pack_bf16x2(act_fn(fmaf(v0, dd0, nz + bb0)) * ss0,
                                     act_fn(fmaf(v1, dd1, nz + bb1)) * ss1)
                   : 0u;
      }
    }
    wgm::sync_threads<kConsumerThreads>();   // the mid tile is whole; T is no longer read
    // The next tile's copies travel while this one's same-conv runs.
    if (tile + gridDim.x < tiles)
      request<C>(tile + gridDim.x, raw + (p ^ 1) * RAW, tt, vec, x, s1, d1, s2, d2, s3, n1, n2, hi,
                 wi, tiles_x, tiles_y, tid);

    // 4. Same-conv from the mid tile: M = the 256 output pixels, N = C, K = 9
    // taps x C; warpgroup g owns m64 tiles 2g and 2g + 1, each four output rows
    // (warp wq: row 4 tile + wq, its 16 columns the m16 rows). Unrolled as the
    // transposed conv: a tap's A fragments load while the tap before is
    // multiplied, and its products queue behind that tap's.
    float acc[2][NT * 4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) acc[i][e] = 0.f;
    {
      uint32_t apx[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        apx[i] = act_a + ((4 * (2 * wgi + i) + wq) * kMid + tcc::a_row(lane)) * K::MID_ROW +
                 2 * tcc::a_k(lane);
      uint32_t a[2][2][C / 16][4];
      load_a(a[0][0], apx[0]);
      load_a(a[0][1], apx[1]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t slot = take<S, K::UP_BYTES>(ring, full, k0 + kUpChunks + tap);
        wgm::fence_operand(acc[0]);
        wgm::fence_operand(acc[1]);
        wgm::fence();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int ks = 0; ks < C / 16; ++ks)
            wgm::mma<C>(acc[i], a[tap & 1][i][ks],
                        wgm::desc_b(slot + 32 * C * ks));   // same-conv products
        wgm::commit();
        if (tap > 0) {
          wgm::wait<1>();                     // tap - 1's products are done
          release<S>(empty, lane, k0 + kUpChunks + tap - 1);
        }
        if (tap + 1 < 9) {
          const uint32_t off = (((tap + 1) / 3) * kMid + (tap + 1) % 3) * K::MID_ROW;
          load_a(a[(tap + 1) & 1][0], apx[0] + off);
          load_a(a[(tap + 1) & 1][1], apx[1] + off);
        }
      }
      wgm::wait<0>();
      wgm::fence_operand(acc[0]);
      wgm::fence_operand(acc[1]);
      release<S>(empty, lane, k0 + kChunks - 1);
    }

    // 5. Epilogue: * d2, + nw2 * noise2 + b2, leaky * sqrt 2 is x2; ToRGB of
    // x2 * s3 from the accumulators (a quad's partials) + bias. The
    // per-channel values are read once for the four pixels a lane holds of a
    // channel.
    float out[2][2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) out[i][hh][0] = out[i][hh][1] = out[i][hh][2] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = 8 * n + 2 * tq + e;
        const float dd = bf(vr[CI + 2 * C + co]), ss = bf(vr[CI + 3 * C + co]), bb = vb2[co];
        const float wr[3] = {vwr[co], vwr[C + co], vwr[2 * C + co]};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float nz = vnw[1] * bf(nz2[(4 * (2 * wgi + i) + wq) * kTile + gq + 8 * hh]);
            const float v = act_fn(fmaf(acc[i][4 * n + 2 * hh + e], dd, nz + bb));
            acc[i][4 * n + 2 * hh + e] = v;
            const float m = v * ss;
#pragma unroll
            for (int o = 0; o < 3; ++o) out[i][hh][o] = fmaf(m, wr[o], out[i][hh][o]);
          }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = y0 + 4 * (2 * wgi + i) + wq, gx = x0 + gq + 8 * hh;
#pragma unroll
        for (int o = 0; o < 3; ++o) out[i][hh][o] = tc::quad_sum(out[i][hh][o]);
        if (gy < h && gx < w && tq < 3) {
          const float r = tq == 0 ? out[i][hh][0] : (tq == 1 ? out[i][hh][1] : out[i][hh][2]);
          rgb[(((size_t)b * 3 + tq) * h + gy) * w + gx] = __float2bfloat16(r + vrb[tq]);
        }
      }
    if (x2 == nullptr) continue;
    // x2 as bf16 into the tile room ([C][16 x 16], a channel kXs elements) once
    // both warpgroups are done with the mid tile, then row by row: 16-byte
    // stores where vec, else one element a thread, neighbours on neighbours.
    wgm::sync_threads<kConsumerThreads>();
    bf16* xs = reinterpret_cast<bf16*>(act);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            xs[(8 * n + 2 * tq + e) * kXs + (4 * (2 * wgi + i) + wq) * kTile + gq + 8 * hh] =
                __float2bfloat16(acc[i][4 * n + 2 * hh + e]);
    wgm::sync_threads<kConsumerThreads>();
    bf16* x2b = x2 + (size_t)b * C * h * w;
    if (vec) {
      for (int i = tid; i < C * kTile * 2; i += kConsumerThreads) {
        const int u = i & 1, row = (i >> 1) % kTile, co = (i >> 1) / kTile;
        const int gy = y0 + row, gx = x0 + 8 * u;
        if (gy < h && gx < w)
          *reinterpret_cast<uint4*>(x2b + ((size_t)co * h + gy) * w + gx) =
              *reinterpret_cast<const uint4*>(xs + co * kXs + row * kTile + 8 * u);
      }
    } else {
      for (int i = tid; i < C * kTile * kTile; i += kConsumerThreads) {
        const int col = i % kTile, row = (i / kTile) % kTile, co = i / (kTile * kTile);
        const int gy = y0 + row, gx = x0 + col;
        if (gy < h && gx < w)
          x2b[((size_t)co * h + gy) * w + gx] = xs[co * kXs + row * kTile + col];
      }
    }
  }
}

template <int C>
cudaError_t launch_c(const void* const* in, void* rgb, void* x2, int b, int hi, int wi,
                     cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(section_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long tiles = (long long)b * tiles_x * tiles_y;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  // Persistent blocks: as many as the card holds at once, each walking its
  // tiles gridDim.x apart.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long held = (long long)sms * kBlocksPerSM<C>;
  const long long grid = tiles < held ? tiles : held;
  auto t = [&](int i) { return static_cast<const bf16*>(in[i]); };
  section_kernel<C><<<(unsigned)grid, kThreads, smem, stream>>>(
      t(0), t(1), t(2), static_cast<const float*>(in[3]), t(4), t(5), t(6), t(7), t(8), t(9),
      t(10), t(11), t(12), t(13), t(14), t(15), static_cast<bf16*>(rgb), static_cast<bf16*>(x2),
      hi, wi, tiles_x, tiles_y, (int)tiles);
  return cudaGetLastError();
}

cudaError_t launch(const void* const* in, void* rgb, void* x2, int b, int c, int hi, int wi,
                   cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch_c<16>(in, rgb, x2, b, hi, wi, stream);
    case 32:
      return launch_c<32>(in, rgb, x2, b, hi, wi, stream);
    case 64:
      return launch_c<64>(in, rgb, x2, b, hi, wi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// The operands every design takes, checked before any launch: 0 (with
// *empty when there is nothing to do) or the cudaError_t to return.
static int check_args(void* x2, int b, int c, int hi, int wi, int want_x2, bool* empty) {
  *empty = false;
  if (b < 0 || hi < 0 || wi < 0 || hi > 0x3fffffff || wi > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if ((x2 != nullptr) != (want_x2 != 0)) return (int)cudaErrorInvalidValue;
  if (c != 16 && c != 32 && c != 64) return (int)cudaErrorInvalidValue;
  *empty = b == 0 || hi == 0 || wi == 0;
  return (int)cudaSuccess;
}

// C entry point (loaded with ctypes). x is (B, 2C, hi, wi); s1 (B, 2C), d1,
// s2, d2, s3 (B, C); n1, n2 (2 hi, 2 wi); nw1, nw2 one element; b1, b2 (C);
// rgb_b (3); rgb (B, 3, 2 hi, 2 wi); x2 (B, C, 2 hi, 2 wi) when want_x2, else
// null. x, the vectors, the noise and the outputs are all f32 (is_bf16 == 0)
// or all bf16 (is_bf16 == 1); every tensor contiguous on one device. The
// weights as the wrapper prepares them, wrgb the f32 ToRGB weights (3, C) for
// both, the transposed conv's taps in the order (0, 0), (0, 2), (2, 0), (2,
// 2), (0, 1), (2, 1), (1, 0), (1, 2), (1, 1); f32: wu the raw taps and wsame
// the same-conv's as split 16-byte records, (9 x 2C / 16 chunks, 2, C / 8,
// 32, 4) and (9 x C / 16, 2, C / 8, 32, 4) f32 in tf::fetch_chunk's layout;
// bf16: wu the raw taps (9, 2C / 16, C / 8, 2, 8, 8) and wsame (9, C / 16, C
// / 8, 2, 8, 8) as [tap][k16 step][n8 group][k half][n][k] (tc_wgmma.cuh).
// Returns a cudaError_t; 0 is success.
extern "C" int sg2_tail_section_launch(const void* x, const void* wu, const void* wsame,
                                       const void* wrgb, const void* s1, const void* d1,
                                       const void* s2, const void* d2, const void* s3,
                                       const void* n1, const void* nw1, const void* b1,
                                       const void* n2, const void* nw2, const void* b2,
                                       const void* rgb_b, void* rgb, void* x2, int is_bf16,
                                       int b, int c, int hi, int wi, int want_x2,
                                       void* stream) {
  bool empty;
  const int bad = check_args(x2, b, c, hi, wi, want_x2, &empty);
  if (bad != 0 || empty) return bad;
  const void* in[16] = {x, wu, wsame, wrgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? wg::launch(in, rgb, x2, b, c, hi, wi, s)
                                  : tf::launch(in, rgb, x2, b, c, hi, wi, s);
  return (int)err;
}

// The f32 design on the CUDA cores that the split-precision design replaced,
// kept for comparison only (ops/sg2_tail_cuda_cores.py): the operands of
// sg2_tail_section_launch in f32, wu the polyphase up-conv (2C, 4, 9, C) as
// [ci][phase][tap][co] and wsame (C, 3, 3, C) as [ci][ky][kx][co].
extern "C" int sg2_tail_section_cc_launch(const void* x, const void* wu, const void* wsame,
                                          const void* wrgb, const void* s1, const void* d1,
                                          const void* s2, const void* d2, const void* s3,
                                          const void* n1, const void* nw1, const void* b1,
                                          const void* n2, const void* nw2, const void* b2,
                                          const void* rgb_b, void* rgb, void* x2, int b, int c,
                                          int hi, int wi, int want_x2, void* stream) {
  bool empty;
  const int bad = check_args(x2, b, c, hi, wi, want_x2, &empty);
  if (bad != 0 || empty) return bad;
  const void* in[16] = {x, wu, wsame, wrgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b};
  return (int)cc::launch<float>(in, rgb, x2, b, c, hi, wi, static_cast<cudaStream_t>(stream));
}

// The bf16 design on mma.sync that the wgmma design replaced, kept for
// comparison only (ops/sg2_tail_polyphase.py): the operands of
// sg2_tail_section_launch in bf16, wu the polyphase up-conv (9, 4, C, 2C) as
// [tap][phase][co][ci] and wsame (9, C, C) as [tap][co][ci].
extern "C" int sg2_tail_section_tc_launch(const void* x, const void* wu, const void* wsame,
                                          const void* wrgb, const void* s1, const void* d1,
                                          const void* s2, const void* d2, const void* s3,
                                          const void* n1, const void* nw1, const void* b1,
                                          const void* n2, const void* nw2, const void* b2,
                                          const void* rgb_b, void* rgb, void* x2, int b, int c,
                                          int hi, int wi, int want_x2, void* stream) {
  bool empty;
  const int bad = check_args(x2, b, c, hi, wi, want_x2, &empty);
  if (bad != 0 || empty) return bad;
  const void* in[16] = {x, wu, wsame, wrgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b};
  return (int)tc::launch(in, rgb, x2, b, c, hi, wi, static_cast<cudaStream_t>(stream));
}

// Which design serves an operand type: the tensor cores for both, the
// transposed conv and blur for both; bf16 products on wgmma, split TF32
// products on mma.sync for f32.
extern "C" const char* sg2_tail_design(int is_bf16) {
  return is_bf16 ? "tensor cores (wgmma m64nNk16, bulk-copy weight ring), transposed conv + blur"
                 : "tensor cores (mma.sync m16n8k8, 3xTF32), transposed conv + blur";
}
