// Hopper (sm_90a) building blocks of sg2_tail.cu's bf16 design: warpgroup
// MMA (wgmma.mma_async m64nNk16, bf16 operands, f32 accumulation) with A
// from registers and B from shared memory, mbarriers, and the bulk copy
// (cp.async.bulk, the TMA unit without a tensor map) that fills B.
//
// - A (64 x 16, the activations) comes from registers: warp w of the
//   warpgroup holds rows 16 w .. 16 w + 15 in mma.sync m16n8k16's A layout
//   (tc_bf16.cuh), so ldmatrix loads it from a channel-last tile exactly as
//   for mma.sync (tcc::a_row, tcc::a_k).
// - B (16 x N, the weights) is read by the tensor cores from shared memory
//   through a descriptor, K-major without swizzle: core matrices of 8 rows
//   (n) x 16 bytes (8 k), 128 contiguous bytes each; the two core matrices of
//   a k16 step lie LBO = 128 bytes apart along k, the N / 8 row groups SBO =
//   256 bytes apart. A weight chunk of K x N is laid out [k / 16][n / 8][k %
//   16 / 8][n % 8][k % 8] (the wrapper does it), so k16 step s starts 32 N s
//   bytes into the chunk.
// - The accumulator of m64nN is N / 2 floats a thread: entries 4 j .. 4 j +
//   3 are n8 tile j in mma.sync's accumulator layout, rows 16 w + gq and 16 w
//   + gq + 8 of the 64.
// - wgmma is asynchronous: its A registers and accumulators are not touched
//   between the issue and wgmma.wait_group; fence_operand keeps the compiler
//   from moving accesses across, wgmma.fence orders the registers' earlier
//   writes before the products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgm {

// The descriptor of a K-major B operand without swizzle at shared address addr.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  constexpr uint64_t kLbo = 128, kSbo = 256;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((kLbo >> 4) << 16) | ((kSbo >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += a (64 x 16 bf16, registers) b (16 x N bf16 at descriptor bd).
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t bd);

template <>
__device__ __forceinline__ void mma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1));
}

template <>
__device__ __forceinline__ void mma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1));
}

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1));
}

// mbarriers in shared memory (addresses from __cvta_generic_to_shared).
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the initialised barriers visible to the async proxy (the bulk copies).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrive and expect `bytes` more of the bulk copies to land before the phase ends.
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the TMA unit, completed on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A named barrier of the first `threads` threads of the block (id 1; id 0 is
// __syncthreads()).
template <int THREADS>
__device__ __forceinline__ void sync_threads() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

}  // namespace wgm
