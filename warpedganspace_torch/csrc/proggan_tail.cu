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
// PixelNorm is x * rsqrt(mean_c(x^2) + 1e-8). Storage is f32 or bf16, all
// arithmetic and every intermediate f32 (the TPU kernel rounds its mid tile to
// the storage type; keeping it f32 is nearer to the f32 result). None of the
// intermediates (the 4x upsampled input, the mid activation, the three
// normalised copies) reaches device memory: a section is one read of its input
// and one write of its output.
//
// What bounds it: the least arithmetic for a section is the phase-merged
// up-conv (4 taps of 2C x C per output pixel, see below) plus the same-conv
// (9 taps of C x C): 2 (8 C^2 + 9 C^2) R^2 flop, 9.1 GFLOP per image for each
// of the three full-width sections (C = 64, 32, 16 at R = 256, 512, 1024),
// against 25-50 MB of input and output per image in f32. On the CUDA cores at
// the data-sheet 67 TFLOP/s that is 0.14 ms per image, nine to eighteen times
// the bytes' time at 3.35 TB/s: operations bound it. With bf16 storage the
// card's peak is the tensor cores' 989 TFLOP/s (bf16 operands, f32
// accumulation) and the bound falls to 0.009 ms per image, still operations;
// this kernel does its arithmetic on the CUDA cores for both storage types.
//
// Layout: NCHW activations and OIHW weights, the port's model layouts. A tile
// row of one channel is a contiguous run (16 outputs, 10 inputs) whatever C is;
// NHWC would give runs of only C = 16..64 values and a transpose on both sides
// of the tail.
//
// Design (nothing of the TPU kernel's fold-x lanes, selection matrices or row
// stripes is carried over).
// - One block per (image, 16 x 16 output tile), 8 C threads. The block stages
//   the 10 x 10 input tile (halo 1) of all 2C channels in shared memory as f32
//   and PixelNorms it there: PixelNorm commutes with the nearest upsampling, so
//   the upsampled tensor never exists.
// - Up-conv on the 18 x 18 mid tile (the same-conv's halo is recomputed, 1.27x).
//   Nearest-up followed by a 3x3 conv is, for each parity of the mid pixel's
//   row and column, a 2x2 conv on the small input with merged taps
//   (rows: even Y reads input row Y/2-1 with tap 0 and row Y/2 with taps 1+2;
//   odd Y reads row (Y-1)/2 with taps 0+1 and row (Y+1)/2 with tap 2; columns
//   alike): 4 taps instead of 9, exact. The mid tile splits into four parity
//   groups of 9 x 9 pixels; a warp owns one (parity group, 16 output channels),
//   27 lanes each holding 3 pixels x 16 channels in registers.
// - Weights do not fit in shared memory (section 1's up-conv is 295 KB in f32),
//   so they stream through it in chunks of 8 input channels: each thread
//   fetches the 9 raw taps of one (input channel, output channel) pair straight
//   from the OIHW tensor, merges them for the up-conv, and the next chunk's
//   taps are already in flight in registers while the current chunk is
//   multiplied. Weight reads in the inner loops are uniform float4 broadcasts;
//   activation reads are conflict-free (mid rows are padded to 20 floats).
// - Up-conv results get WScale and LeakyReLU, land in the mid tile, and are
//   PixelNorm'd in place. Mid pixels outside the image are set to ZERO, not
//   computed: the same-conv pads the normalised mid tensor with zeros.
// - Same-conv from shared memory: a thread holds 4 rows x 8 channels of one
//   output column; a warp covers 16 columns x 8 rows of one channel group.
//   Then WScale, LeakyReLU and the store; with the head, the C channels of a
//   pixel meet once more in shared memory for PixelNorm and the 1x1 conv.
// - Ragged edges are masked: any Hi, Wi >= 1; tiles past the right and bottom
//   edge store nothing outside the image. Offsets are 64-bit; the limits are
//   2^31 - 1 blocks (B x tiles) and C in {16, 32, 64}.
// - Tensor cores (wgmma / mma.sync), TMA and persistent blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                       // output tile, rows and columns
constexpr int kMid = kTile + 2;                 // mid tile with the same-conv's halo
constexpr int kMidStride = 20;                  // floats per mid row: 4 rows apart = 16 banks
constexpr int kMidPlane = kMid * kMidStride;    // floats per mid channel
constexpr int kIn = kTile / 2 + 2;              // input tile with the up-conv's halo
constexpr int kInPlane = kIn * kIn;
constexpr int kGroup = kMid / 2;                // a parity group of the mid tile is 9 x 9
constexpr int kKC = 8;                          // input channels per weight chunk
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-8f;
static_assert(kTile == 16 && kKC == 8, "thread maps assume a 16 x 16 tile and 8-channel chunks");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

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

}  // namespace

// C entry point (loaded with ctypes). x is (B, 2C, hi, wi), w_up (C, 2C, 3, 3),
// w_same (C, C, 3, 3), the biases (C), the scales one element each; with a head,
// w_head is (3, C), b_head (3), s_head one element and out (B, 3, 2 hi, 2 wi);
// without, the three head pointers are null and out is (B, C, 2 hi, 2 wi). All
// f32 (is_bf16 == 0) or all bf16 (is_bf16 == 1), contiguous on one device.
// Returns a cudaError_t; 0 is success.
extern "C" int proggan_tail_section_launch(const void* x, const void* w_up, const void* b_up,
                                           const void* s_up, const void* w_same,
                                           const void* b_same, const void* s_same,
                                           const void* w_head, const void* b_head,
                                           const void* s_head, void* out, int is_bf16, int b,
                                           int c, int hi, int wi, void* stream) {
  if (b < 0 || hi < 0 || wi < 0 || hi > 0x3fffffff || wi > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if ((w_head == nullptr) != (b_head == nullptr) || (w_head == nullptr) != (s_head == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c != 16 && c != 32 && c != 64) return (int)cudaErrorInvalidValue;
  if (b == 0 || hi == 0 || wi == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head,
                                      b_head, s_head, out, b, c, hi, wi, s)
              : launch<float>(x, w_up, b_up, s_up, w_same, b_same, s_same, w_head, b_head,
                              s_head, out, b, c, hi, wi, s);
  return (int)err;
}
