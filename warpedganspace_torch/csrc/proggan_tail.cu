// One fused section of ProgGAN's thin-channel tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// warpedganspace_tpu/ops/proggan_tail_pallas.py::_section_kernel (launched by
// fused_section). One launch takes 2C channels at (Hi, Wi) to C channels (or, on
// the last section, 3 RGB channels) at (2 Hi, 2 Wi):
//
//   PixelNorm -> nearest 2x up -> conv3x3 pad 1 (2C -> C) -> x * s_up + b_up -> LeakyReLU(0.2)
//   -> PixelNorm -> conv3x3 pad 1 (C -> C) -> x * s_same + b_same -> LeakyReLU(0.2)
//   [-> PixelNorm -> conv1x1 (C -> 3) -> x * s_head + b_head]
//
// PixelNorm is x * rsqrt(mean_c(x^2) + 1e-8). None of the intermediates (the 4x
// upsampled input, the mid activation, the normalised copies) reaches device
// memory: a section is one read of its input and one write of its output.
//
// What bounds it: the least arithmetic for a section is the phase-merged
// up-conv (4 taps of 2C x C per output pixel, see below) plus the same-conv
// (9 taps of C x C): 2 (8 C^2 + 9 C^2) R^2 flop, 9.1 GFLOP per image for each
// of the three full-width sections (C = 64, 32, 16 at R = 256, 512, 1024),
// against 25-50 MB of input and output per image in f32. On the CUDA cores at
// the data-sheet 67 TFLOP/s that is 0.14 ms per image, nine to eighteen times
// the bytes' time at 3.35 TB/s; on the tensor cores at 495 TFLOP/s TF32 (f32)
// 0.018 ms, or at 989 TFLOP/s bf16 (bf16 operands, f32 accumulation) 0.009
// ms, still operations.
//
// Three designs. The C launch function takes bf16 to the tensor cores as
// bf16 products (namespace tc) and f32 to the tensor cores in split precision
// (namespace tf); the f32 design on the CUDA cores (namespace cc), which the
// split-precision design replaced, has its own C entry for comparison only.
// All take NCHW activations, the port's model layout, and a block per (image,
// 16 x 16 output tile); nothing of the TPU kernel's fold-x lanes, selection
// matrices or row stripes is carried over. All recompute the same-conv's halo
// of the 18 x 18 mid tile (1.27x) and split that tile into four parity groups
// of 9 x 9 pixels: nearest-up followed by a 3x3 conv is, for each parity of the
// mid pixel's row and column, a 2x2 conv on the small input with merged taps
// (rows: an even row Y reads input row Y/2-1 with tap 0 and row Y/2 with taps
// 1+2; an odd row reads row (Y-1)/2 with taps 0+1 and row (Y+1)/2 with tap 2;
// columns alike), 4 taps instead of 9: the least up-conv arithmetic there is.
// Mid pixels outside the image are set to ZERO, not computed: the same-conv
// pads the normalised mid tensor with zeros. Ragged edges are masked: any Hi,
// Wi >= 1; tiles past the right and bottom edge store nothing outside the
// image. Offsets are 64-bit; the limits are 2^31 - 1 blocks (B x tiles) and C
// in {16, 32, 64}.
//
// f32 (tf): both convolutions are implicit GEMMs on mma.sync m16n8k8 in split
// precision (tc_tf32.cuh: each operand as TF32 hi + lo rounded to nearest,
// three products lo hi + hi lo + hi hi, f32 accumulation), from shared
// memory; 8 warps. The algebra and the warp maps are the bf16 design's (tc,
// below); what differs:
// - The staging pass copies the NCHW input tile by 4-byte cp.async, all in
//   flight at once, PixelNorms each pixel in f32 and stores each value as its
//   {hi, lo} pair in place: the up-conv's A operand is split once, where every
//   value is read by 4 taps x 4 parity warps.
// - Up-conv: M = the 81 positions of a parity group (padded to 96), N = C per
//   parity, K = 4 merged taps x 2C; a warp owns one parity and 3 m16 tiles,
//   all C output columns. The merged taps are summed in f32 and split into
//   16-byte records of B fragments {hi b0, hi b1, lo b0, lo b1} by the
//   wrapper, one chunk per tap x 16 input channels for all four parities, in
//   the kernel's order.
// - The epilogues run in the accumulator layout in f32 (WScale, LeakyReLU,
//   PixelNorm by a lane's partial and two quad shuffles, the head's 1x1 conv
//   alike). The mid tile is f32 in the input tile's room, and the same-conv's
//   warps split their A fragments as they load them.
// - The tensor cores round their f32 sums toward zero: each chunk's products
//   (two k8 steps) go into an accumulator of their own, added into the f32
//   sums (tests/test_torch_proggan_tail_f32_split_numerics.py chose it).
// - Weights go through a ring of three shared slots by 16-byte cp.async, one
//   chunk a step, one block barrier a chunk; a warp holds its parity's records
//   of both k8 steps of a chunk in registers.
// - Shared memory: C = 64 (256^2 section): input tile 100 x 1,056 B = 105.6
//   KB, mid tile 324 x 272 B = 88.1 KB in its room, ring 3 x 32 KB: 203.9 KB,
//   one block an SM. C = 32 (512^2): 54.4 and 46.7 KB, ring 3 x 16 KB: 103.6
//   KB, two blocks. C = 16 (1024^2, the head's section): 28.8 and 25.9 KB,
//   ring 3 x 8 KB: 53.4 KB, three blocks (kBlocksPerSM).
//
// f32 (cc), for comparison: 8 C threads; all arithmetic and every
// intermediate f32. The block stages the 10 x 10 input tile of all 2C
// channels as f32 and PixelNorms it in place (PixelNorm commutes with the
// nearest upsampling). Weights stream through shared memory in chunks of 8
// input channels: each thread fetches the 9 raw taps of one (input channel,
// output channel) pair from the OIHW tensor, merges them for the up-conv, and
// the next chunk's taps are in flight in registers while the current one is
// multiplied; weight reads in the inner loops are uniform float4 broadcasts.
// Up-conv: a warp owns one (parity group, 16 output channels), 27 lanes
// holding 3 pixels x 16 channels. Same-conv: a thread holds 4 rows x 8
// channels of one output column. With the head, the C channels of a pixel
// meet once more in shared memory.
//
// bf16 (tc): both convolutions are implicit GEMMs on mma.sync m16n8k16 with
// bf16 operands and f32 accumulation, from shared memory (tc_conv.cuh); 8
// warps.
// - Activations are bf16 and channel-last in shared memory, [pixel][channel]
//   rows padded to an odd number of 16-byte units (conflict-free ldmatrix);
//   the staging pass transposes the NCHW input, then PixelNorms each pixel in
//   f32 and rounds it to bf16 once.
// - Up-conv: M = the 81 positions (A, V) of a parity group (padded to 96), N =
//   C per parity, K = 4 merged taps x 2C. Position (A, V) of every parity reads
//   input pixels (A + a, V + b), so one A operand serves the four parities'
//   weights. A warp owns one parity and 3 m16 tiles, all C output columns.
//   The merged taps are prepared by the wrapper ([tap][parity][co][ci], bf16).
// - Epilogue in the accumulator layout: WScale, LeakyReLU, then PixelNorm over
//   the C channels of each mid pixel from a lane's partial and two quad
//   shuffles; the mid tile is written back as bf16 channel-last in the input
//   tile's room.
// - Same-conv: M = the 256 output pixels (an m16 tile is one output row), N =
//   C, K = 9 taps x C; a warp owns two output rows. The head's PixelNorm and
//   the 1x1 conv (C -> 3) are quad sums of the accumulators in f32.
// - Weights go through a ring of three shared slots by 16-byte cp.async, one
//   chunk a step (a merged tap x 32 input channels for all four parities; 3 or
//   9 taps x 16 channels of the same-conv): two chunks are in flight while one
//   is multiplied, one block barrier a chunk.
// - Rounding. The products see bf16 operands: the normalised input, the merged
//   taps (sums of two or four bf16 weights, rounded once) and the normalised mid
//   tile. A bf16 rounding of an intermediate is 2^-9 relative, and the output
//   of a section without the head stays within ~0.02 of the f32 section on
//   the same operands (tests/test_torch_tail_tc_numerics.py). The RGB head
//   PixelNorms the output's C channels: at a pixel whose channels are all small
//   it magnifies their absolute errors, and at C = 16 one rounding alone gives
//   up to 0.05 there, over the 3e-2 bound. So the section with the head carries
//   the normalised input, the merged taps and the mid tile as bf16 hi + lo
//   pairs (x = hi + lo, both bf16; hi x hi + hi x lo + lo x hi in the up-conv,
//   hi x W + lo x W in the same-conv, where the raw weights are exact): three
//   and two products a step, and only the output's rounding is left.
// - Shared memory: C = 64 (256^2 section): input tile 100 x 272 B = 27.2 KB,
//   mid tile 324 x 144 B = 46.7 KB in its room, ring 3 x 20.5 KB: 108.1 KB,
//   two blocks (16 warps) an SM. C = 32 (512^2): 14.4 and 25.9 KB, ring 3 x
//   13.8 KB: 67.4 KB, three blocks. C = 16 with the head (1024^2, hi + lo): 14.4
//   and 25.9 KB, ring 3 x 6.9 KB: 46.7 KB, four blocks. __launch_bounds__
//   holds the registers to those counts (kMinBlocks; -Xptxas -v prints them).
// - Tensor memory accelerator loads, wgmma and persistent blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_conv.cuh"
#include "tc_tf32.cuh"

namespace {

constexpr int kTile = 16;                       // output tile, rows and columns
constexpr int kMid = kTile + 2;                 // mid tile with the same-conv's halo
constexpr int kGroup = kMid / 2;                // a parity group of the mid tile is 9 x 9
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

}  // namespace

// ---------------------------------------------------------------------------
// f32 on the CUDA cores, for comparison (the split-precision design, namespace
// tf, replaced it). The template also takes bf16 storage, the design bf16 had
// before the tensor cores: scripts/measure_sg2_tail_tc_rate.py times it so.
namespace cc {

constexpr int kMidStride = 20;                  // floats per mid row: 4 rows apart = 16 banks
constexpr int kMidPlane = kMid * kMidStride;    // floats per mid channel
constexpr int kIn = kTile / 2 + 2;              // input tile with the up-conv's halo
constexpr int kInPlane = kIn * kIn;
constexpr int kKC = 8;                          // input channels per weight chunk
static_assert(kTile == 16 && kKC == 8, "thread maps assume a 16 x 16 tile and 8-channel chunks");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// The taps of one 3-tap axis that land on input offset a (0 or 1) for a mid
// pixel of local parity p: local index 2u + p sits at global coordinate
// origin - 1 + 2u + p with an even origin, so p = 0 is an ODD coordinate
// (taps 0+1, then tap 2) and p = 1 an EVEN one (tap 0, then taps 1+2).
__device__ __forceinline__ float merge3(float t0, float t1, float t2, int p, int a) {
  if (p == 0) return a == 0 ? t0 + t1 : t2;
  return a == 0 ? t0 : t1 + t2;
}

// Shared memory, in floats: input tile, mid tile, one weight chunk (the
// up-conv's 16 merged taps are the larger).
__host__ __device__ constexpr size_t smem_floats(int c) {
  return (size_t)2 * c * kInPlane + (size_t)c * kMidPlane + (size_t)16 * kKC * c;
}

template <typename T>
__device__ __forceinline__ void load_taps(const T* __restrict__ p, float (&raw)[9]) {
#pragma unroll
  for (int t = 0; t < 9; ++t) raw[t] = to_f32(p[t]);
}

template <typename T, int C>
__global__ void __launch_bounds__(8 * C)
section_kernel(const T* __restrict__ x, const T* __restrict__ w_up, const T* __restrict__ b_up,
               const T* __restrict__ s_up, const T* __restrict__ w_same,
               const T* __restrict__ b_same, const T* __restrict__ s_same,
               const T* __restrict__ w_head, const T* __restrict__ b_head,
               const T* __restrict__ s_head, T* __restrict__ out, int hi, int wi, int tiles_x,
               int tiles_y) {
  constexpr int NT = 8 * C;
  constexpr int CI = 2 * C;
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);   // [CI][kIn][kIn]
  float* mid = xin + CI * kInPlane;               // [C][kMid][kMidStride]
  float* ws = mid + C * kMidPlane;                // one weight chunk, 16-byte aligned

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
  const int iy0 = y0 / 2 - 1, ix0 = x0 / 2 - 1;   // input tile origin

  // Staging role of this thread in both convolutions: the 9 taps of one
  // (input channel sk of the chunk, output channel sco) pair.
  const int sk = tid / C;
  const int sco = tid % C;
  float raw[9];
  load_taps(w_up + ((size_t)sco * CI + sk) * 9, raw);

  // 1. The input tile, zero outside the image.
  const T* xb = x + (size_t)b * CI * hi * wi;
  for (int idx = tid; idx < CI * kInPlane; idx += NT) {
    const int ci = idx / kInPlane;
    const int rem = idx - ci * kInPlane;
    const int r = rem / kIn;
    const int c = rem - r * kIn;
    const int iy = iy0 + r, ix = ix0 + c;
    float v = 0.f;
    if (iy >= 0 && iy < hi && ix >= 0 && ix < wi) v = to_f32(xb[((size_t)ci * hi + iy) * wi + ix]);
    xin[idx] = v;
  }
  __syncthreads();

  // 2. PixelNorm over the 2C channels of each input pixel (zero stays zero).
  for (int p = tid; p < kInPlane; p += NT) {
    float ss = 0.f;
#pragma unroll 8
    for (int ci = 0; ci < CI; ++ci) {
      const float v = xin[ci * kInPlane + p];
      ss = fmaf(v, v, ss);
    }
    const float inv = rsqrtf(ss * (1.f / CI) + kEps);
#pragma unroll 8
    for (int ci = 0; ci < CI; ++ci) xin[ci * kInPlane + p] *= inv;
  }

  // 3. Up-conv: warp = (parity group, 16 output channels); lane < 27 holds mid
  // pixels (2 (rg + 3 r) + pi, 2 v + pj), r = 0..2, which read input rows
  // rg + 3 r + a and columns v + b (a, b = 0, 1). Lanes of one warp read
  // addresses 10 rg + v: distinct banks.
  {
    const int ph = warp & 3, g = warp >> 2;
    const int pi = ph >> 1, pj = ph & 1;
    const bool active = lane < 3 * kGroup;
    const int rg = active ? lane / kGroup : 0;
    const int v = active ? lane % kGroup : 0;
    float acc[3][16];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[r][q] = 0.f;

    for (int chunk = 0; chunk < CI / kKC; ++chunk) {
      __syncthreads();   // the tile is normalised; the previous chunk is no longer read
      // ws[k][parity group][a][b][co]: the 16 merged taps of this thread's pair.
#pragma unroll
      for (int qi = 0; qi < 2; ++qi)
#pragma unroll
        for (int qj = 0; qj < 2; ++qj)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              const float m = merge3(merge3(raw[0], raw[1], raw[2], qj, bb),
                                     merge3(raw[3], raw[4], raw[5], qj, bb),
                                     merge3(raw[6], raw[7], raw[8], qj, bb), qi, a);
              ws[(((sk * 4 + qi * 2 + qj) * 2 + a) * 2 + bb) * C + sco] = m;
            }
      __syncthreads();
      // The next chunk's taps (the same-conv's first chunk after the last)
      // travel while this chunk is multiplied.
      if (chunk + 1 < CI / kKC)
        load_taps(w_up + ((size_t)sco * CI + (chunk + 1) * kKC + sk) * 9, raw);
      else
        load_taps(w_same + ((size_t)sco * C + sk) * 9, raw);
      if (active) {
#pragma unroll 2
        for (int k = 0; k < kKC; ++k) {
          const float* xp = xin + (chunk * kKC + k) * kInPlane + rg * kIn + v;
          float av[2][6];
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
              for (int a = 0; a < 2; ++a) av[bb][2 * r + a] = xp[(3 * r + a) * kIn + bb];
          const float4* wp = reinterpret_cast<const float4*>(ws + (k * 4 + ph) * 4 * C + 16 * g);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              float wv[16];
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4) {
                const float4 f = wp[(a * 2 + bb) * (C / 4) + q4];
                wv[4 * q4] = f.x;
                wv[4 * q4 + 1] = f.y;
                wv[4 * q4 + 2] = f.z;
                wv[4 * q4 + 3] = f.w;
              }
#pragma unroll
              for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int q = 0; q < 16; ++q)
                  acc[r][q] = fmaf(av[bb][2 * r + a], wv[q], acc[r][q]);
            }
        }
      }
    }
    if (active) {
      const float s = to_f32(s_up[0]);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int co = 16 * g + q;
        const float bias = to_f32(b_up[co]);
#pragma unroll
        for (int r = 0; r < 3; ++r)
          mid[co * kMidPlane + (2 * (rg + 3 * r) + pi) * kMidStride + 2 * v + pj] =
              leaky(fmaf(acc[r][q], s, bias));
      }
    }
  }
  __syncthreads();

  // 4. PixelNorm over the C channels of each mid pixel; a mid pixel outside the
  // image is the same-conv's zero padding.
  for (int p = tid; p < kMid * kMid; p += NT) {
    const int i = p / kMid, j = p - i * kMid;
    const int gy = y0 - 1 + i, gx = x0 - 1 + j;
    float* mp = mid + i * kMidStride + j;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
#pragma unroll 8
      for (int c = 0; c < C; ++c) mp[c * kMidPlane] = 0.f;
    } else {
      float ss = 0.f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        const float v = mp[c * kMidPlane];
        ss = fmaf(v, v, ss);
      }
      const float inv = rsqrtf(ss * (1.f / C) + kEps);
#pragma unroll 8
      for (int c = 0; c < C; ++c) mp[c * kMidPlane] *= inv;
    }
  }

  // 5. Same-conv: thread = (column ox, 4 rows from 4 rg, 8 output channels);
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

  for (int chunk = 0; chunk < C / kKC; ++chunk) {
    __syncthreads();   // the mid tile is normalised; the previous chunk is no longer read
#pragma unroll
    for (int t = 0; t < 9; ++t) ws[(t * kKC + sk) * C + sco] = raw[t];   // ws[tap][k][co]
    __syncthreads();
    if (chunk + 1 < C / kKC)
      load_taps(w_same + ((size_t)sco * C + (chunk + 1) * kKC + sk) * 9, raw);
#pragma unroll 2
    for (int k = 0; k < kKC; ++k) {
      const float* mp = mid + (chunk * kKC + k) * kMidPlane + 4 * rg * kMidStride + ox;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float av[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) av[q] = mp[q * kMidStride + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(ws + ((ky * 3 + kx) * kKC + k) * C + 8 * g);
          const float4 f0 = wp[0], f1 = wp[1];
          const float wv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p + ky], wv[q], acc[p][q]);
        }
      }
    }
  }

  const float s = to_f32(s_same[0]);
  const int gx = x0 + ox;
  if (w_head == nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int co = 8 * g + q;
      const float bias = to_f32(b_same[co]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int gy = y0 + 4 * rg + p;
        if (gy < h && gx < w)
          from_f32(leaky(fmaf(acc[p][q], s, bias)),
                   out + (((size_t)b * C + co) * h + gy) * w + gx);
      }
    }
    return;
  }

  // 6. The RGB head: the C channels of each output pixel meet in shared memory
  // (the mid tile's room) for PixelNorm and the 1x1 conv.
  __syncthreads();   // every warp is done reading the mid tile
  float* hv = mid;   // [C][kTile][kTile]
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = 8 * g + q;
    const float bias = to_f32(b_same[co]);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      hv[co * kTile * kTile + (4 * rg + p) * kTile + ox] = leaky(fmaf(acc[p][q], s, bias));
  }
  __syncthreads();
  const float sh = to_f32(s_head[0]);
  for (int p = tid; p < kTile * kTile; p += NT) {
    const int gy = y0 + p / kTile, gxp = x0 + p % kTile;
    if (gy >= h || gxp >= w) continue;
    float ss = 0.f, rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float v = hv[c * kTile * kTile + p];
      ss = fmaf(v, v, ss);
#pragma unroll
      for (int o = 0; o < 3; ++o) rgb[o] = fmaf(to_f32(w_head[o * C + c]), v, rgb[o]);
    }
    const float inv = rsqrtf(ss * (1.f / C) + kEps);
#pragma unroll
    for (int o = 0; o < 3; ++o)
      from_f32(fmaf(rgb[o] * inv, sh, to_f32(b_head[o])),
               out + (((size_t)b * 3 + o) * h + gy) * w + gxp);
  }
}

template <typename T, int C>
cudaError_t launch_c(const void* x, const void* w_up, const void* b_up, const void* s_up,
                     const void* w_same, const void* b_same, const void* s_same,
                     const void* w_head, const void* b_head, const void* s_head, void* out,
                     int b, int hi, int wi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(C);
  cudaError_t err = cudaFuncSetAttribute(
      section_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  section_kernel<T, C><<<(unsigned)blocks, 8 * C, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up), static_cast<const T*>(b_up),
      static_cast<const T*>(s_up), static_cast<const T*>(w_same), static_cast<const T*>(b_same),
      static_cast<const T*>(s_same), static_cast<const T*>(w_head),
      static_cast<const T*>(b_head), static_cast<const T*>(s_head), static_cast<T*>(out), hi, wi,
      tiles_x, tiles_y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w_up, const void* b_up, const void* s_up,
                   const void* w_same, const void* b_same, const void* s_same,
                   const void* w_head, const void* b_head, const void* s_head, void* out, int b,
                   int c, int hi, int wi, cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch_c<T, 16>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,
                             out, b, hi, wi, stream);
    case 32:
      return launch_c<T, 32>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,
                             out, b, hi, wi, stream);
    case 64:
      return launch_c<T, 64>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,
                             out, b, hi, wi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation).
namespace tc {

constexpr int kThreads = 256;                   // 8 warps
constexpr int kInWin = kTile / 2 + 2;           // input tile with the up-conv's halo
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

// Sizes in bytes. With the RGB head (HEAD), activations and the merged
// up-conv weights are carried as bf16 hi + lo pairs (three products a step in
// the up-conv, two in the same-conv): the head's PixelNorm over the output's C
// channels turns one bf16 rounding of an intermediate into up to ~0.05 at the
// output (see the note at the top of this file).
template <int C, bool HEAD>
struct Cfg {
  static constexpr bool SPLIT = HEAD;
  static constexpr int CI = 2 * C;
  static constexpr int NT = C / 8;                          // n8 tiles of one product
  static constexpr int IN_ROW = 2 * ((SPLIT ? 2 : 1) * CI + 8);   // [hi | lo | pad]
  static constexpr int MID_ROW = 2 * ((SPLIT ? 2 : 1) * C + 8);
  // Up-conv chunk j: merged tap t = j / UP_KB, input channels (j % UP_KB) * UPK
  // + [0, UPK); rows (parity, co) of [hi UPK | lo UPK] or [32 hi] + 8 pad.
  static constexpr int UPK = SPLIT ? 16 : 32;
  static constexpr int UP_ROW = 2 * (32 + 8);
  static constexpr int UP_KB = CI / UPK;
  static constexpr int NUP = 4 * UP_KB;
  // Same-conv chunk: ST taps x 16 input channels, rows (tap, co).
  static constexpr int ST = C == 64 ? 3 : 9;
  static constexpr int SAME_ROW = 2 * (16 + 8);
  static constexpr int SAME_KB = C / 16;
  static constexpr int NCHUNK = NUP + (9 / ST) * SAME_KB;
  static constexpr int UP_SLOT = 4 * C * UP_ROW;
  static constexpr int SAME_SLOT = ST * C * SAME_ROW;
  static constexpr int SLOT = UP_SLOT > SAME_SLOT ? UP_SLOT : SAME_SLOT;
  // The input tile, then the mid tile in its room.
  static constexpr int ACT = kInPix * IN_ROW > kMidPix * MID_ROW ? kInPix * IN_ROW
                                                                 : kMidPix * MID_ROW;
  static constexpr int SMEM = ACT + kStages * SLOT;
  static_assert((IN_ROW / 16) % 2 == 1 && (MID_ROW / 16) % 2 == 1 && (UP_ROW / 16) % 2 == 1 &&
                    (SAME_ROW / 16) % 2 == 1,
                "odd 16-byte units per row: conflict-free ldmatrix");
};

// Weight chunk j into a ring slot (nothing past the last chunk). wup is the
// merged up-conv weight [hi, lo][tap (a, b)][parity (pi, pj)][co][ci], wsame
// the same-conv weight [tap][co][ci].
template <int C, bool HEAD>
__device__ __forceinline__ void fetch_chunk(uint32_t slot, const bf16* __restrict__ wup,
                                            const bf16* __restrict__ wsame, int j, int tid) {
  using K = Cfg<C, HEAD>;
  if (j >= K::NCHUNK) return;
  if (j < K::NUP) {
    const int t = j / K::UP_KB, kb = j - t * K::UP_KB;
    const bf16* src = wup + (size_t)t * 4 * C * K::CI + kb * K::UPK;
    if (K::SPLIT) {
      tcc::fetch_rows<kThreads>(slot, K::UP_ROW, src, K::CI, 4 * C, 2, tid);
      tcc::fetch_rows<kThreads>(slot + 32, K::UP_ROW, src + (size_t)16 * C * K::CI, K::CI,
                                4 * C, 2, tid);
    } else {
      tcc::fetch_rows<kThreads>(slot, K::UP_ROW, src, K::CI, 4 * C, 4, tid);
    }
  } else {
    const int s = j - K::NUP, tg = s / K::SAME_KB, kb = s - tg * K::SAME_KB;
    tcc::fetch_rows<kThreads>(slot, K::SAME_ROW, wsame + (size_t)tg * K::ST * C * C + kb * 16, C,
                              K::ST * C, 2, tid);
  }
}

template <int C, bool HEAD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>)
section_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wup,
               const bf16* __restrict__ b_up, const bf16* __restrict__ s_up,
               const bf16* __restrict__ wsame, const bf16* __restrict__ b_same,
               const bf16* __restrict__ s_same, const bf16* __restrict__ w_head,
               const bf16* __restrict__ b_head, const bf16* __restrict__ s_head,
               bf16* __restrict__ out, int hi, int wi, int tiles_x, int tiles_y) {
  using K = Cfg<C, HEAD>;
  constexpr int CI = K::CI, NT = K::NT;
  constexpr bool SPLIT = K::SPLIT;
  extern __shared__ float4 smem4[];
  char* act = reinterpret_cast<char*>(smem4);     // input tile [pixel][ch], then mid tile
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
  const int iy0 = y0 / 2 - 1, ix0 = x0 / 2 - 1;   // input tile origin

  // The first two weight chunks travel while the input is staged.
  fetch_chunk<C, HEAD>(ring, wup, wsame, 0, tid);
  tc::cp_async_commit();
  fetch_chunk<C, HEAD>(ring + K::SLOT, wup, wsame, 1, tid);
  tc::cp_async_commit();

  // 1. The input tile as it is (bf16, exact), channel-last, zero outside.
  tcc::stage_nchw<kThreads>(act, K::IN_ROW, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0, ix0,
                            kInWin, [](int, float v) { return v; }, tid);
  __syncthreads();

  // 2. PixelNorm over the 2C channels of each input pixel in f32, rounded to
  // bf16 once (and the remainder to bf16 for the lo half): 8 lanes a pixel.
  // 100 pixels, 32 a pass: a warp's four pixels are all in or all out.
  {
    constexpr int PER = CI / 8;
    const int sub = tid & 7;
    for (int p = tid >> 3; p < kInPix; p += kThreads / 8) {
      uint32_t* v = reinterpret_cast<uint32_t*>(act + p * K::IN_ROW) + sub * (PER / 2);
      float f[PER];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < PER / 2; ++i) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(v + i);
        f[2 * i] = __low2float(pr);
        f[2 * i + 1] = __high2float(pr);
        ss = fmaf(f[2 * i], f[2 * i], fmaf(f[2 * i + 1], f[2 * i + 1], ss));
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      ss += __shfl_xor_sync(0xffffffffu, ss, 4);
      const float inv = rsqrtf(ss * (1.f / CI) + kEps);
#pragma unroll
      for (int i = 0; i < PER / 2; ++i) {
        const float n0 = f[2 * i] * inv, n1 = f[2 * i + 1] * inv;
        const uint32_t hv = tc::pack_bf16x2(n0, n1);
        v[i] = hv;
        if constexpr (SPLIT) {
          const __nv_bfloat162 hp = *reinterpret_cast<const __nv_bfloat162*>(&hv);
          v[i + CI / 2] = tc::pack_bf16x2(n0 - __low2float(hp), n1 - __high2float(hp));
        }
      }
    }
  }

  // 3. Up-conv: nearest-up + conv3x3 as, for each parity (pi, pj) of the mid
  // pixel (2 A + pi, 2 V + pj), a 2x2 conv of input pixels (A + a, V + b) with
  // merged taps. The A operand (positions x input channels) is the same for
  // all four parities; warp = (parity, 3 m16 tiles of the 81 positions), all
  // C output channels. Rows past the 81st repeat the last and are not stored.
  const int par = warp & 3, grp = warp >> 2;
  const int pi = par >> 1, pj = par & 1;
  {
    float acc[kUpMT][NT][4];
    tcc::zero(acc);
    uint32_t apos[kUpMT];
#pragma unroll
    for (int i = 0; i < kUpMT; ++i) {
      const int q = min(16 * (kUpMT * grp + i) + tcc::a_row(lane), kPos - 1);
      apos[i] = act_a + ((q / kGroup) * kInWin + q % kGroup) * K::IN_ROW + 2 * tcc::a_k(lane);
    }
    const uint32_t blane = (par * C + tcc::b_row(lane)) * K::UP_ROW + 2 * tcc::b_k(lane);
    for (int j = 0; j < K::NUP; ++j) {
      tcc::cp_async_wait<1>();   // chunk j has landed (this thread's copies)
      __syncthreads();           // (everyone's); chunk j - 1's slot is free
      fetch_chunk<C, HEAD>(ring + ((j + 2) % kStages) * K::SLOT, wup, wsame, j + 2, tid);
      tc::cp_async_commit();
      const int t = j / K::UP_KB, kb = j - t * K::UP_KB;
      const int shift = ((t >> 1) * kInWin + (t & 1)) * K::IN_ROW + 2 * kb * K::UPK;
      const uint32_t bs = ring + (j % kStages) * K::SLOT + blane;
#pragma unroll
      for (int ks = 0; ks < K::UPK / 16; ++ks) {
        uint32_t a[kUpMT];
#pragma unroll
        for (int i = 0; i < kUpMT; ++i) a[i] = apos[i] + shift + 32 * ks;
        tcc::mma_step(acc, a, bs + 32 * ks, 16 * K::UP_ROW);
        if constexpr (SPLIT) {
          tcc::mma_step(acc, a, bs + 32, 16 * K::UP_ROW);            // A hi x W lo
#pragma unroll
          for (int i = 0; i < kUpMT; ++i) a[i] += 2 * CI;
          tcc::mma_step(acc, a, bs, 16 * K::UP_ROW);                 // A lo x W hi
        }
      }
    }
    __syncthreads();   // every warp is done with the input tile: the mid tile takes its room

    // Epilogue: WScale, LeakyReLU, PixelNorm over the C channels of each mid
    // pixel (a quad's partials), bf16 into the mid tile; zero outside the image.
    const float su = __bfloat162float(s_up[0]);
    float bias[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bias[n][0] = __bfloat162float(b_up[8 * n + 2 * tq]);
      bias[n][1] = __bfloat162float(b_up[8 * n + 2 * tq + 1]);
    }
#pragma unroll
    for (int i = 0; i < kUpMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 16 * (kUpMT * grp + i) + gq + 8 * hh;
        const int mi = 2 * (q / kGroup) + pi, mj = 2 * (q % kGroup) + pj;
        const int gy = y0 - 1 + mi, gx = x0 - 1 + mj;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        float v[NT][2];
        float ss = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[n][e] = leaky(fmaf(acc[i][n][2 * hh + e], su, bias[n][e]));
            ss = fmaf(v[n][e], v[n][e], ss);
          }
        ss = tc::quad_sum(ss);
        const float inv = inside ? rsqrtf(ss * (1.f / C) + kEps) : 0.f;
        if (q < kPos) {
          uint32_t* row = reinterpret_cast<uint32_t*>(act + (mi * kMid + mj) * K::MID_ROW);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float n0 = v[n][0] * inv, n1 = v[n][1] * inv;
            const uint32_t hv = tc::pack_bf16x2(n0, n1);
            row[4 * n + tq] = hv;
            if constexpr (SPLIT) {
              const __nv_bfloat162 hp = *reinterpret_cast<const __nv_bfloat162*>(&hv);
              row[C / 2 + 4 * n + tq] = tc::pack_bf16x2(n0 - __low2float(hp), n1 - __high2float(hp));
            }
          }
        }
      }
  }

  // 4. Same-conv from the mid tile: warp = output rows 2 warp, 2 warp + 1 (one
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
    fetch_chunk<C, HEAD>(ring + ((j + 2) % kStages) * K::SLOT, wup, wsame, j + 2, tid);
    tc::cp_async_commit();
    const int s = j - K::NUP, tg = s / K::SAME_KB, kb = s - tg * K::SAME_KB;
    const uint32_t bs = ring + (j % kStages) * K::SLOT + blane;
#pragma unroll
    for (int tt = 0; tt < K::ST; ++tt) {
      const int tap = tg * K::ST + tt;
      const int shift = ((tap / 3) * kMid + tap % 3) * K::MID_ROW + 32 * kb;
      uint32_t a[kSameMT];
#pragma unroll
      for (int i = 0; i < kSameMT; ++i) a[i] = apx[i] + shift;
      tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < kSameMT; ++i) a[i] += 2 * C;
        tcc::mma_step(acc, a, bs + tt * C * K::SAME_ROW, 16 * K::SAME_ROW);   // A lo x W
      }
    }
  }

  // 5. Epilogue: WScale, LeakyReLU, then the store, or PixelNorm and the 1x1
  // RGB conv from the accumulators (a quad's partials).
  const float s2 = __bfloat162float(s_same[0]);
  float bias[NT][2], wh[3][NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias[n][e] = __bfloat162float(b_same[8 * n + 2 * tq + e]);
#pragma unroll
      for (int o = 0; o < 3; ++o)
        wh[o][n][e] = HEAD ? __bfloat162float(w_head[o * C + 8 * n + 2 * tq + e]) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kSameMT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gy = y0 + kSameMT * warp + i, gx = x0 + gq + 8 * hh;
      const bool inside = gy < h && gx < w;
      float v[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[n][e] = leaky(fmaf(acc[i][n][2 * hh + e], s2, bias[n][e]));
      if constexpr (!HEAD) {
        if (inside) {
          bf16* o = out + (((size_t)b * C) * h + gy) * w + gx;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              o[(size_t)(8 * n + 2 * tq + e) * h * w] = __float2bfloat16(v[n][e]);
        }
      } else {
        float ss = 0.f, rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ss = fmaf(v[n][e], v[n][e], ss);
#pragma unroll
            for (int o = 0; o < 3; ++o) rgb[o] = fmaf(wh[o][n][e], v[n][e], rgb[o]);
          }
        ss = tc::quad_sum(ss);
#pragma unroll
        for (int o = 0; o < 3; ++o) rgb[o] = tc::quad_sum(rgb[o]);
        if (inside && tq < 3) {
          const float inv = rsqrtf(ss * (1.f / C) + kEps);
          const float r = tq == 0 ? rgb[0] : (tq == 1 ? rgb[1] : rgb[2]);
          out[(((size_t)b * 3 + tq) * h + gy) * w + gx] = __float2bfloat16(
              fmaf(r * inv, __bfloat162float(s_head[0]), __bfloat162float(b_head[tq])));
        }
      }
    }
}

template <int C, bool HEAD>
cudaError_t launch_c(const void* x, const void* w_up, const void* b_up, const void* s_up,
                     const void* w_same, const void* b_same, const void* s_same,
                     const void* w_head, const void* b_head, const void* s_head, void* out,
                     int b, int hi, int wi, cudaStream_t stream) {
  constexpr int smem = Cfg<C, HEAD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(section_kernel<C, HEAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto p = [](const void* v) { return static_cast<const bf16*>(v); };
  section_kernel<C, HEAD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      p(x), p(w_up), p(b_up), p(s_up), p(w_same), p(b_same), p(s_same), p(w_head), p(b_head),
      p(s_head), static_cast<bf16*>(out), hi, wi, tiles_x, tiles_y);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w_up, const void* b_up, const void* s_up,
                   const void* w_same, const void* b_same, const void* s_same,
                   const void* w_head, const void* b_head, const void* s_head, void* out, int b,
                   int c, int hi, int wi, cudaStream_t stream) {
  const bool head = w_head != nullptr;
#define WGS_TAIL_CASE(CC)                                                                   \
  case CC:                                                                                  \
    return head ? launch_c<CC, true>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head,  \
                                      b_head, s_head, out, b, hi, wi, stream)               \
                 : launch_c<CC, false>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, \
                                       b_head, s_head, out, b, hi, wi, stream);
  switch (c) {
    WGS_TAIL_CASE(16)
    WGS_TAIL_CASE(32)
    WGS_TAIL_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef WGS_TAIL_CASE
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: tensor cores in split precision (3xTF32 on mma.sync m16n8k8,
// tc_tf32.cuh).
namespace tf {

using tc::FragA;

constexpr int kThreads = 256;                   // 8 warps
constexpr int kInWin = kTile / 2 + 2;           // input tile with the up-conv's halo
constexpr int kInPix = kInWin * kInWin;
constexpr int kMidPix = kMid * kMid;
constexpr int kPos = kGroup * kGroup;           // positions of one parity group
constexpr int kUpMT = 3;                        // up-conv m16 tiles a warp: 2 warps x 48 rows cover 81
constexpr int kSameMT = 2;                      // same-conv m16 tiles (output rows) a warp
constexpr int kChunkSteps = 2;                  // k8 steps (16 input channels) of a weight chunk
constexpr int kRing = 3;                        // weight chunks: ring of shared slots
// The tensor cores round their float32 sums toward zero. Each weight chunk's
// products (two k8 steps, chains of 6 mma.sync) go into an accumulator of
// their own, from 0, which is added into the float32 sums (rounded to
// nearest). The CPU emulation (tests/test_torch_proggan_tail_f32_split_numerics.py)
// holds flushes every 2 or 4 k8 steps within 1.5x the plain f32 section's
// own distance from float64 at every shape, and one chain over the whole K
// (up to 3 x 64 products at C = 64) 9x beyond it; a chain of two chunks
// would keep two steps' more B records in registers.
//
// Blocks an SM, as shared memory allows them; __launch_bounds__ holds the
// registers to it.
template <int C>
constexpr int kBlocksPerSM = C == 64 ? 1 : (C == 32 ? 2 : 3);
static_assert(kThreads / 32 == 4 * 2 && 2 * kUpMT * 16 >= kPos && 8 * kSameMT == kTile,
              "warp maps: 4 parities x 2 row groups; 8 warps x 2 output rows");

// Sizes: strides in floats, regions in bytes.
template <int C>
struct Cfg {
  static constexpr int CI = 2 * C;
  static constexpr int NT = C / 8;                              // n8 tiles of one parity
  // A pixel of the input tile: {hi, lo} pairs of its 2C normalised channels
  // and 8 floats of padding (a stride of 8 mod 32 words: a half-warp's
  // 8-byte fragment loads, 4 pixels x 4 channels, fall in 32 banks).
  static constexpr int IN_STRIDE = 2 * CI + 8;
  static constexpr int MID_STRIDE = 4 * tc::f32_row_units(C);  // a pixel of the mid tile
  // Up-conv chunk j: merged tap t = j / UP_KB (row-major (a, b)), input
  // channels 16 (j % UP_KB) + [0, 16), records [k8 step][parity x n8 tile][lane];
  // same-conv chunk: tap (ky, kx) row-major, 16 channels, [k8 step][n8 tile][lane].
  static constexpr int UP_KB = CI / 16, SAME_KB = C / 16;
  static constexpr int NUP = 4 * UP_KB;
  static constexpr int NCHUNK = NUP + 9 * SAME_KB;
  static constexpr int UP_CHUNK = kChunkSteps * 4 * NT * 32 * 16;
  static constexpr int SAME_CHUNK = kChunkSteps * NT * 32 * 16;
  // The input tile, then the mid tile in its room.
  static constexpr int IN = kInPix * IN_STRIDE * 4;
  static constexpr int MID = kMidPix * MID_STRIDE * 4;
  static constexpr int ACT = IN > MID ? IN : MID;
  static constexpr int SMEM = ACT + kRing * UP_CHUNK;
  static_assert(IN_STRIDE % 32 == 8 && MID_STRIDE % 8 == 4 && ACT % 16 == 0,
                "conflict-free fragment loads, 16-byte aligned ring");
};

// Weight chunk j into a ring slot (nothing past the last chunk): records as
// the wrapper lays them out (ops/proggan_tail_cuda.py::f32_records), the
// up-conv's chunks first.
template <int C>
__device__ __forceinline__ void fetch_chunk(uint32_t slot, const uint4* __restrict__ wup,
                                            const uint4* __restrict__ wsame, int j, int tid) {
  using K = Cfg<C>;
  if (j >= K::NCHUNK) return;
  const bool up = j < K::NUP;
  const int units = (up ? K::UP_CHUNK : K::SAME_CHUNK) / 16;
  const uint4* src = up ? wup + (size_t)j * units : wsame + (size_t)(j - K::NUP) * units;
  tcc::fetch_units<kThreads>(slot, src, units, tid);
}

// The A fragment of four {hi, lo} pairs split at staging (register order of
// tc_tf32.cuh).
__device__ __forceinline__ FragA frag_pairs(float2 v0, float2 v1, float2 v2, float2 v3) {
  FragA f;
  f.hi[0] = __float_as_uint(v0.x), f.lo[0] = __float_as_uint(v0.y);
  f.hi[1] = __float_as_uint(v1.x), f.lo[1] = __float_as_uint(v1.y);
  f.hi[2] = __float_as_uint(v2.x), f.lo[2] = __float_as_uint(v2.y);
  f.hi[3] = __float_as_uint(v3.x), f.lo[3] = __float_as_uint(v3.y);
  return f;
}

// acc += p (float32, rounded to nearest).
template <int NT>
__device__ __forceinline__ void add_into(float (&acc)[NT][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += p[n][e];
}

template <int C, bool HEAD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<C>)
section_kernel(const float* __restrict__ x, const uint4* __restrict__ wup,
               const float* __restrict__ b_up, const float* __restrict__ s_up,
               const uint4* __restrict__ wsame, const float* __restrict__ b_same,
               const float* __restrict__ s_same, const float* __restrict__ w_head,
               const float* __restrict__ b_head, const float* __restrict__ s_head,
               float* __restrict__ out, int hi, int wi, int tiles_x, int tiles_y) {
  using K = Cfg<C>;
  constexpr int CI = K::CI, NT = K::NT, IS = K::IN_STRIDE, MS = K::MID_STRIDE;
  extern __shared__ float4 smem4[];
  float* in = reinterpret_cast<float*>(smem4);    // input tile [pixel][{hi, lo} x 2C], then mid
  float* mid = in;                                // mid tile [pixel][C]
  const uint4* ring = reinterpret_cast<const uint4*>(reinterpret_cast<char*>(smem4) + K::ACT);
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
  const int iy0 = y0 / 2 - 1, ix0 = x0 / 2 - 1;   // input tile origin

  // The input tile's copies (raw values in the first 2C floats of each row,
  // zero outside the image), then the first weight chunks.
  tcc::stage_nchw_f32<kThreads>(in, IS, x + (size_t)b * CI * hi * wi, CI, hi, wi, iy0, ix0,
                                kInWin, tid);
  tc::cp_async_commit();
  for (int s = 0; s < kRing - 1; ++s) {
    fetch_chunk<C>(ring_a + s * K::UP_CHUNK, wup, wsame, s, tid);
    tc::cp_async_commit();
  }
  // Chunk j has landed for everyone, and the slot of chunk j - 1 is free: it
  // takes chunk j + kRing - 1. One block barrier a chunk.
  auto land = [&](int j) {
    tcc::cp_async_wait<kRing - 2>();
    __syncthreads();
    fetch_chunk<C>(ring_a + ((j + kRing - 1) % kRing) * K::UP_CHUNK, wup, wsame, j + kRing - 1,
                   tid);
    tc::cp_async_commit();
    return ring + (j % kRing) * (K::UP_CHUNK / 16);
  };
  tcc::cp_async_wait<kRing - 1>();   // this thread's input copies (the oldest group)
  __syncthreads();

  // 1. PixelNorm over the 2C channels of each input pixel in f32 (zero stays
  // zero), then each value as TF32 hi + lo in place: 8 lanes a pixel, each
  // reading its 2C / 8 raw channels before the shuffles and writing their
  // pairs after them. 100 pixels, 32 a pass: a warp's four pixels are all in
  // or all out.
  {
    constexpr int PER = CI / 8;
    const int sub = tid & 7;
    for (int p = tid / 8; p < kInPix; p += kThreads / 8) {
      float* row = in + p * IS;
      float f[PER];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < PER / 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(row + sub * PER)[i];
        f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z, f[4 * i + 3] = v.w;
        ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      ss += __shfl_xor_sync(0xffffffffu, ss, 4);
      const float inv = rsqrtf(ss * (1.f / CI) + kEps);
#pragma unroll
      for (int i = 0; i < PER / 2; ++i) {
        uint32_t h0, l0, h1, l1;
        tc::split_tf32(f[2 * i] * inv, h0, l0);
        tc::split_tf32(f[2 * i + 1] * inv, h1, l1);
        reinterpret_cast<float4*>(row + 2 * sub * PER)[i] = make_float4(
            __uint_as_float(h0), __uint_as_float(l0), __uint_as_float(h1), __uint_as_float(l1));
      }
    }
  }

  // 2. Up-conv: nearest-up + conv3x3 as, for each parity (pi, pj) of the mid
  // pixel (2 A + pi, 2 V + pj), a 2x2 conv of input pixels (A + a, V + b) with
  // merged taps: an implicit GEMM of the 81 positions by the four parities' C
  // channels, K = 4 taps x 2C, whose A operand is the same for all four
  // parities. Warp = (parity, 3 m16 tiles of the 81 positions), all C output
  // channels. Rows past the 81st repeat the last and are not stored. (The
  // first chunk's barrier covers the normalised input tile.)
  const int par = warp & 3, grp = warp >> 2;
  const int pi = par >> 1, pj = par & 1;
  int j = 0;   // weight chunks used
  {
    float acc[kUpMT][NT][4];
    tcc::zero(acc);
    const float2* ap[kUpMT][2];
#pragma unroll
    for (int i = 0; i < kUpMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; hh++) {
        const int q = min(16 * (kUpMT * grp + i) + gq + 8 * hh, kPos - 1);
        const float* row = in + ((q / kGroup) * kInWin + q % kGroup) * IS;
        ap[i][hh] = reinterpret_cast<const float2*>(row) + tq;
      }
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const int shift = ((t >> 1) * kInWin + (t & 1)) * (IS / 2);   // in {hi, lo} pairs
#pragma unroll 1
      for (int kb = 0; kb < K::UP_KB; ++kb, ++j) {
        const uint4* rec = land(j) + par * NT * 32 + lane;
        uint4 bw[kChunkSteps][NT];
#pragma unroll
        for (int s = 0; s < kChunkSteps; ++s)
#pragma unroll
          for (int n = 0; n < NT; ++n) bw[s][n] = rec[(s * 4 * NT + n) * 32];
#pragma unroll
        for (int i = 0; i < kUpMT; ++i) {
          float p[NT][4] = {};
#pragma unroll
          for (int s = 0; s < kChunkSteps; ++s) {
            const int k = shift + 16 * kb + 8 * s;
            const FragA a = frag_pairs(ap[i][0][k], ap[i][1][k], ap[i][0][k + 4], ap[i][1][k + 4]);
            tc::mma3_records<NT>(p, a, bw[s], NT);   // up-conv products
          }
          add_into(acc[i], p);   // the chunk's up-conv sums
        }
      }
    }
    __syncthreads();   // every warp is done with the input tile: the mid tile takes its room

    // Epilogue: WScale, LeakyReLU, PixelNorm over the C channels of each mid
    // pixel (a quad's partials), f32 into the mid tile; zero outside the image.
    const float su = s_up[0];
    float bias[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bias[n][0] = b_up[8 * n + 2 * tq];
      bias[n][1] = b_up[8 * n + 2 * tq + 1];
    }
#pragma unroll
    for (int i = 0; i < kUpMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; hh++) {
        const int q = 16 * (kUpMT * grp + i) + gq + 8 * hh;
        const int mi = 2 * (q / kGroup) + pi, mj = 2 * (q % kGroup) + pj;
        const int gy = y0 - 1 + mi, gx = x0 - 1 + mj;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        float v[NT][2];
        float ss = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[n][e] = leaky(fmaf(acc[i][n][2 * hh + e], su, bias[n][e]));
            ss = fmaf(v[n][e], v[n][e], ss);
          }
        ss = tc::quad_sum(ss);
        const float inv = inside ? rsqrtf(ss * (1.f / C) + kEps) : 0.f;
        if (q < kPos) {
          float* row = mid + (mi * kMid + mj) * MS + 2 * tq;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(row + 8 * n) = make_float2(v[n][0] * inv, v[n][1] * inv);
        }
      }
  }

  // 3. Same-conv from the mid tile: M = the 256 output pixels (an m16 tile is
  // one output row), N = C, K = 9 taps x C; warp = output rows 2 warp and 2
  // warp + 1, all C channels; the warps split their A fragments as they load
  // them. (The first chunk's barrier covers the mid tile.)
  float acc[kSameMT][NT][4];
  tcc::zero(acc);
  const float* apx[kSameMT];
#pragma unroll
  for (int i = 0; i < kSameMT; ++i) apx[i] = mid + ((kSameMT * warp + i) * kMid + gq) * MS + tq;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * kMid + tap % 3) * MS;
#pragma unroll 1
    for (int kb = 0; kb < K::SAME_KB; ++kb, ++j) {
      const uint4* rec = land(j) + lane;
      uint4 bw[kChunkSteps][NT];
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s)
#pragma unroll
        for (int n = 0; n < NT; ++n) bw[s][n] = rec[(s * NT + n) * 32];
#pragma unroll
      for (int i = 0; i < kSameMT; ++i) {
        float p[NT][4] = {};
#pragma unroll
        for (int s = 0; s < kChunkSteps; ++s) {
          const float* pp = apx[i] + off + 16 * kb + 8 * s;
          const FragA a = tc::frag_a(pp[0], pp[8 * MS], pp[4], pp[8 * MS + 4]);
          tc::mma3_records<NT>(p, a, bw[s], NT);   // same-conv products
        }
        add_into(acc[i], p);   // the chunk's same-conv sums
      }
    }
  }

  // 4. Epilogue: WScale, LeakyReLU, then the store, or PixelNorm and the 1x1
  // RGB conv from the sums (a quad's partials).
  const float s2 = s_same[0];
  float bias[NT][2], wh[3][NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias[n][e] = b_same[8 * n + 2 * tq + e];
#pragma unroll
      for (int o = 0; o < 3; ++o) wh[o][n][e] = HEAD ? w_head[o * C + 8 * n + 2 * tq + e] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kSameMT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; hh++) {
      const int gy = y0 + kSameMT * warp + i, gx = x0 + gq + 8 * hh;
      const bool inside = gy < h && gx < w;
      float v[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[n][e] = leaky(fmaf(acc[i][n][2 * hh + e], s2, bias[n][e]));
      if constexpr (!HEAD) {
        if (inside) {
          float* o = out + (((size_t)b * C) * h + gy) * w + gx;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) o[(size_t)(8 * n + 2 * tq + e) * h * w] = v[n][e];
        }
      } else {
        float ss = 0.f, rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ss = fmaf(v[n][e], v[n][e], ss);
#pragma unroll
            for (int o = 0; o < 3; ++o) rgb[o] = fmaf(wh[o][n][e], v[n][e], rgb[o]);
          }
        ss = tc::quad_sum(ss);
#pragma unroll
        for (int o = 0; o < 3; ++o) rgb[o] = tc::quad_sum(rgb[o]);
        if (inside && tq < 3) {
          const float inv = rsqrtf(ss * (1.f / C) + kEps);
          const float r = tq == 0 ? rgb[0] : (tq == 1 ? rgb[1] : rgb[2]);
          out[(((size_t)b * 3 + tq) * h + gy) * w + gx] = fmaf(r * inv, s_head[0], b_head[tq]);
        }
      }
    }
}

template <int C, bool HEAD>
cudaError_t launch_c(const void* x, const void* w_up, const void* b_up, const void* s_up,
                     const void* w_same, const void* b_same, const void* s_same,
                     const void* w_head, const void* b_head, const void* s_head, void* out,
                     int b, int hi, int wi, cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(section_kernel<C, HEAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (2 * wi + kTile - 1) / kTile;
  const int tiles_y = (2 * hi + kTile - 1) / kTile;
  const long long blocks = (long long)b * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto r = [](const void* v) { return static_cast<const uint4*>(v); };
  section_kernel<C, HEAD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      f(x), r(w_up), f(b_up), f(s_up), r(w_same), f(b_same), f(s_same), f(w_head), f(b_head),
      f(s_head), static_cast<float*>(out), hi, wi, tiles_x, tiles_y);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w_up, const void* b_up, const void* s_up,
                   const void* w_same, const void* b_same, const void* s_same,
                   const void* w_head, const void* b_head, const void* s_head, void* out, int b,
                   int c, int hi, int wi, cudaStream_t stream) {
  const bool head = w_head != nullptr;
#define WGS_TAIL_CASE(CC)                                                                   \
  case CC:                                                                                  \
    return head ? launch_c<CC, true>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head,  \
                                      b_head, s_head, out, b, hi, wi, stream)               \
                 : launch_c<CC, false>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, \
                                       b_head, s_head, out, b, hi, wi, stream);
  switch (c) {
    WGS_TAIL_CASE(16)
    WGS_TAIL_CASE(32)
    WGS_TAIL_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef WGS_TAIL_CASE
}

}  // namespace tf

// The operands every design takes, checked before any launch: 0 (with
// *empty when there is nothing to do) or the cudaError_t to return.
static int check_args(const void* w_head, const void* b_head, const void* s_head, int b, int c,
                      int hi, int wi, bool* empty) {
  *empty = false;
  if (b < 0 || hi < 0 || wi < 0 || hi > 0x3fffffff || wi > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if ((w_head == nullptr) != (b_head == nullptr) || (w_head == nullptr) != (s_head == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c != 16 && c != 32 && c != 64) return (int)cudaErrorInvalidValue;
  *empty = b == 0 || hi == 0 || wi == 0;
  return (int)cudaSuccess;
}

// C entry point (loaded with ctypes). x is (B, 2C, hi, wi); the biases (C),
// the scales one element each; with a head, w_head is (3, C), b_head (3),
// s_head one element and out (B, 3, 2 hi, 2 wi); without, the three head
// pointers are null and out is (B, C, 2 hi, 2 wi). All f32 (is_bf16 == 0) or
// all bf16 (is_bf16 == 1), contiguous on one device. The weights as the
// wrapper prepares them: f32, split 16-byte records of B fragments
// (ops/proggan_tail_cuda.py::f32_records), w_up the merged taps (4 x 2C / 16
// chunks, 2, 4C / 8, 32, 4) and w_same (9 x C / 16, 2, C / 8, 32, 4), f32
// records in tf::fetch_chunk's layout; bf16, w_up the merged taps
// (2, 4, 4, C, 2C) as [hi, lo][tap (a, b)][parity (pi, pj)][co][ci] and w_same
// (9, C, C) as [tap][co][ci]. Returns a cudaError_t; 0 is success.
extern "C" int proggan_tail_section_launch(const void* x, const void* w_up, const void* b_up,
                                           const void* s_up, const void* w_same,
                                           const void* b_same, const void* s_same,
                                           const void* w_head, const void* b_head,
                                           const void* s_head, void* out, int is_bf16, int b,
                                           int c, int hi, int wi, void* stream) {
  bool empty;
  const int bad = check_args(w_head, b_head, s_head, b, c, hi, wi, &empty);
  if (bad != 0 || empty) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? tc::launch(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,
                           out, b, c, hi, wi, s)
              : tf::launch(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head, s_head,
                           out, b, c, hi, wi, s);
  return (int)err;
}

// The f32 design on the CUDA cores that the split-precision design replaced,
// kept for comparison only (ops/proggan_tail_cuda_cores.py): the operands of
// proggan_tail_section_launch in f32, w_up (C, 2C, 3, 3) and w_same (C, C, 3, 3)
// as the model holds them (OIHW).
extern "C" int proggan_tail_section_cc_launch(const void* x, const void* w_up, const void* b_up,
                                              const void* s_up, const void* w_same,
                                              const void* b_same, const void* s_same,
                                              const void* w_head, const void* b_head,
                                              const void* s_head, void* out, int b, int c,
                                              int hi, int wi, void* stream) {
  bool empty;
  const int bad = check_args(w_head, b_head, s_head, b, c, hi, wi, &empty);
  if (bad != 0 || empty) return bad;
  return (int)cc::launch<float>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head,
                                s_head, out, b, c, hi, wi, static_cast<cudaStream_t>(stream));
}

// Which design serves an operand type: the tensor cores for both, bf16
// products for bf16, split TF32 products for f32.
extern "C" const char* proggan_tail_design(int is_bf16) {
  return is_bf16 ? "tensor cores (mma.sync m16n8k16)" : "tensor cores (mma.sync m16n8k8, 3xTF32)";
}
