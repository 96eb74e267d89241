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
// batch. Storage is f32 or bf16; all arithmetic and every intermediate are
// f32 (the TPU kernel rounds its epilogues to the storage type). Only rgb, and
// x2 when the caller asks for it (the next block's input), reach device
// memory: the mid activation lives in shared memory.
//
// What bounds it: the up-conv as four polyphase 3x3 convs costs 9 taps of
// 2C x C per output pixel, the same-conv 9 taps of C x C: about 29 G
// multiply-adds per image for each of StyleGAN2-1024's two sections (C = 64 at
// 512^2, C = 32 at 1024^2), against some 50 MB of input and output per image
// in f32. On the CUDA cores at the data-sheet 67 TFLOP/s that is 0.87 ms per
// image, thirty times the bytes' time at 3.35 TB/s: operations bound it. (The
// least arithmetic, the transposed conv's 2.25 taps of 2C x C and then the
// depthwise blur, is a quarter of the composite's up-conv.) With bf16 storage
// the card's peak is the tensor cores' 989 TFLOP/s (bf16 operands, f32
// accumulation); this kernel does its arithmetic on the CUDA cores for both
// storage types.
//
// Layout: NCHW activations, weights prepared by the wrapper in f32: the up-conv
// as [2C][4 phases][9 taps][C], the same-conv as [C][9 taps][C], ToRGB [3][C].
// Nothing of the TPU kernel's fold-x lanes, K-window builds, k-merged RGB or
// row stripes is carried over.
//
// Design.
// - One block per (image, 16 x 16 output tile), 8 C threads. The block stages
//   the 12 x 12 input tile (halo 2 on the input grid) of all 2C channels in
//   shared memory as f32, already multiplied by s1.
// - Up-conv on the 18 x 18 mid tile (the same-conv's halo is recomputed,
//   1.27x). The stride-2 transposed conv followed by the 4-tap blur is, for
//   each parity (py, px) of the output pixel (2u + py, 2v + px), a 3x3 conv
//   of the input pixels (u - 1 .. u + 1, v - 1 .. v + 1) with its own weights
//   (the wrapper derives them from the plain transposed conv and blur). The
//   mid tile splits into four parity groups of 9 x 9 pixels; a warp owns one
//   (parity group, 16 output channels), 27 lanes each holding 3 pixels x 16
//   channels in registers and reading its 9 x 3 input window once per input
//   channel.
// - Weights do not fit in shared memory (the C = 64 section's composite is
//   1.2 MB in f32), so they stream through two shared buffers in chunks of 4
//   input channels with 16-byte cp.async copies: the next chunk is in flight
//   while the current one is multiplied, and the same-conv's first chunk while
//   the up-conv's epilogue runs. Weight reads in the inner loops are uniform
//   float4 broadcasts.
// - Up-conv epilogue: * d1, + nw1 * noise1 + b1, leaky * sqrt 2, * s2 into the
//   mid tile, which takes the input tile's room. Mid pixels outside the image
//   are set to ZERO, not computed: the same-conv zero-pads x * s2.
// - Same-conv from shared memory: a thread holds 4 rows x 8 channels of one
//   output column; a warp covers 16 columns x 8 rows of one channel group.
//   Epilogue * d2, + nw2 * noise2 + b2, leaky * sqrt 2 is x2 (stored when
//   asked); x2 * s3 meets the other channels of its pixel in shared memory for
//   the 1x1 ToRGB.
// - Ragged edges are masked: any Hi, Wi >= 1; tiles past the right and bottom
//   edge store nothing outside the image. Offsets are 64-bit; the limits are
//   2^31 - 1 blocks (B x tiles) and C in {16, 32, 64}.
// - Tensor cores (mma.sync / wgmma), TMA and persistent blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                       // output tile, rows and columns
constexpr int kMid = kTile + 2;                 // mid tile with the same-conv's halo
constexpr int kMidStride = 20;                  // floats per mid row: 4 rows apart = 16 banks
constexpr int kMidPlane = kMid * kMidStride;    // floats per mid channel
constexpr int kIn = kTile / 2 + 4;              // input tile with the up-conv's halo
constexpr int kInPlane = kIn * kIn;
constexpr int kGroup = kMid / 2;                // a parity group of the mid tile is 9 x 9
constexpr int kKC = 4;                          // input channels per weight chunk
constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;   // sqrt 2
static_assert(kTile == 16 && kGroup == 9, "thread maps assume a 16 x 16 tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float act(float v) { return kGain * (v >= 0.f ? v : kSlope * v); }

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
              inside[r] ? act(fmaf(acc[r][q], dd, nz[r] + bb)) * ss : 0.f;
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
      const float val = act(fmaf(acc[p][q], dd, nz[p] + bb));
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

}  // namespace

// C entry point (loaded with ctypes). x is (B, 2C, hi, wi); wu the f32 up-conv
// polyphase weights (2C, 4, 9, C), wsame the f32 same-conv weights (C, 3, 3,
// C) as [ci][ky][kx][co], wrgb the f32 ToRGB weights (3, C); s1 (B, 2C), d1,
// s2, d2, s3 (B, C); n1, n2 (2 hi, 2 wi); nw1, nw2 one element; b1, b2 (C);
// rgb_b (3); rgb (B, 3, 2 hi, 2 wi); x2 (B, C, 2 hi, 2 wi) when want_x2, else
// null. x, the vectors, the noise and the outputs are all f32 (is_bf16 == 0)
// or all bf16 (is_bf16 == 1); every tensor contiguous on one device. Returns a
// cudaError_t; 0 is success.
extern "C" int sg2_tail_section_launch(const void* x, const void* wu, const void* wsame,
                                       const void* wrgb, const void* s1, const void* d1,
                                       const void* s2, const void* d2, const void* s3,
                                       const void* n1, const void* nw1, const void* b1,
                                       const void* n2, const void* nw2, const void* b2,
                                       const void* rgb_b, void* rgb, void* x2, int is_bf16,
                                       int b, int c, int hi, int wi, int want_x2,
                                       void* stream) {
  if (b < 0 || hi < 0 || wi < 0 || hi > 0x3fffffff || wi > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if ((x2 != nullptr) != (want_x2 != 0)) return (int)cudaErrorInvalidValue;
  if (c != 16 && c != 32 && c != 64) return (int)cudaErrorInvalidValue;
  if (b == 0 || hi == 0 || wi == 0) return (int)cudaSuccess;
  const void* in[16] = {x, wu, wsame, wrgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(in, rgb, x2, b, c, hi, wi, s)
                                  : launch<float>(in, rgb, x2, b, c, hi, wi, s);
  return (int)err;
}
