// Hopper's asynchronous machinery for hand-written kernels on sm_90a: TMA
// tensor maps and loads, mbarrier rings, wgmma descriptors and products,
// named barriers, and the register hand-over of warp specialisation.
// Shared by the bfloat16 faces of matmul.cu, conv3x3.cu and the flash
// forward and backward (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// TMA. A tensor map (CUtensorMap, 128 bytes) describes a 2-D or 3-D
// row-major bfloat16 array in device memory (or a 1-D float32 vector,
// unswizzled) and the box one load copies. It is encoded on the host at
// each launch (encode_tma_2d, encode_tma_3d, encode_tma_1d_f32) and
// passed to the kernel as a `const __grid_constant__ CUtensorMap`
// parameter, so the copy engine reads it from the parameter space. One
// thread issues a load (tma_load_1d, tma_load_2d, tma_load_3d); the bytes
// land in shared memory with the 128-byte swizzle (the 16-byte chunk c
// of row r of a 128-byte-wide box stored at chunk c ^ (r % 8)), zeros
// where the box lies past an edge of the array, and their arrival is
// counted on an mbarrier. The tensor-map encoders are driver functions:
// they are fetched through the runtime's entry-point query, so the
// library needs no -lcuda. The rules they check: the base address
// 16-byte aligned, each pitch a multiple of 16 bytes.
//
// TMA in im2col mode (encode_im2col_3x3, tma_load_im2col_4d) copies the
// shifted pixels of a convolution: the map describes an NHWC tensor
// [N, H, W, C] and a bounding box of the pixels a walk may start from; a
// load names a starting pixel (w, h, n), the first channel and the
// filter tap (dw, dh) as an offset, and copies `pixels` rows of
// `channels` values: row i is the pixel the walk reaches after i steps
// (along W, wrapping at the box's edge to the next row of H, then to the
// next image), shifted by the tap. For a 3 x 3, stride-1, pad-1
// convolution the box's corners are one pixel inside each lower and
// upper edge (-1, -1), so the walk visits exactly the output pixels in
// order, the load's starting pixel is the output pixel less one row and
// one column, and the halo, the images past the last and the channels
// past C arrive as zeros.
//
// mbarrier rings. A ring of stages has a "full" barrier a stage (one
// arrival, the producer's expect_tx, plus the bytes of the loads) and an
// "empty" one (an arrival from each consumer thread). Waits name the
// parity of the phase they wait for: a consumer's n-th use of a stage
// waits full with parity n & 1, the producer's waits empty with parity
// (n & 1) ^ 1, which the fresh barrier passes at once (its preceding
// phase counts as complete).
//
// wgmma. A warpgroup (4 warps, 128 threads) multiplies a 64 x N x 16
// product asynchronously, A and B read from shared memory through 64-bit
// descriptors: start address, leading and stride byte offsets (in 16-byte
// units) and the swizzle mode. For the 128-byte swizzle:
// - K-major (A, x as it lies: k contiguous), 64 bf16 a row: rows are 128
//   bytes apart, 8-row groups 1024 (the stride offset); the k16 slice kk
//   starts 32 kk bytes into the rows;
// - MN-major (B, w as it lies: n contiguous), boxes of 64 k rows x 64 n:
//   k rows 128 bytes apart, 8-row groups 1024 (the stride offset), the
//   next 64 columns one box (8192 bytes) further (the leading offset);
//   the k16 slice kk starts 2048 kk bytes on. For 16-bit types wgmma
//   takes this MN-major B as it lies through its transpose operand
//   (imm-trans-b 1); only TF32 operands must be K-major.
// - A K-major B (imm-trans-b 0: k contiguous, as the keys of q k^T lie,
//   [key][d]) takes A's descriptor: rows 128 bytes apart, 8-row groups
//   1024, the k16 slice kk 32 kk bytes in.
// - A may also come from registers (wgmma_m64n64k16_rs): the thread's
//   bfloat16 pairs in mma.sync's A fragment layout.
// The sum of a wgmma stays in registers: element i of a thread's
// accumulator is row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2 of the 64 x N tile. wgmma_fence
// orders the thread's register accesses before the products that read or
// write them; a commit closes a group, wait<0> waits for all of them.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- shared memory, mbarriers ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to the
// copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more to come from TMA loads
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A phase that
// never completes is a fault of the kernel: after 2^26 tries (each
// suspends the thread for a while) it traps, so the launch fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  for (uint32_t tries = 0; !mbar_try_wait(b, parity);)
    if (++tries == (1u << 26)) __trap();
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box at (c0 inner, c1 outer) of `map` into `dst` (1024-byte aligned
// for the 128-byte swizzle), counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the box at (c0, c1, c2), innermost first, of a 3-D `map` into `dst`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the box at c0 of a 1-D `map` into `dst` (128-byte aligned)
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// the im2col box of `map` whose walk starts at pixel (w, h, n), channel
// c, each pixel shifted by the tap (dw, dh), into `dst`
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   uint16_t dw, uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n), "h"(dw), "h"(dh)
      : "memory");
}

// -- warp specialisation ------------------------------------------------------

// all four warps of a warpgroup lower (producer) or raise (consumer) their
// register budget; the counts are multiples of 8 in [24, 256]
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Named barriers (1..15; 0 is __syncthreads): `count` threads, a multiple
// of 32, meet at barrier `id`. bar_arrive counts the caller and goes on;
// bar_sync counts it and waits for the rest. Two consumer warpgroups take
// turns on the tensor cores this way.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- wgmma -------------------------------------------------------------------

// a shared-memory operand with the 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler does not see the products run on after their asm
// statements: pinning each accumulator register here, after a wait (and
// before the products), keeps its reads and writes on the right side.
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register A operands: pinned after the wait, they are not
// reused while a product may still read them
template <int N, int M>
__device__ __forceinline__ void wgmma_fence_operands(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The products d (+)= A B of bfloat16 operands summed in float32: A 64 x 16
// K-major, B 16 x N MN-major (imm-trans-b 1), both from shared memory;
// `add` false (scale-d 0) overwrites d with the product.
// m64n32k16
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
    uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"((int)add), "n"(TRANS_B));
}

// m64n64k16
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
    uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"((int)add), "n"(TRANS_B));
}

// m64n128k16
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
    uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"((int)add), "n"(TRANS_B));
}

// m64n192k16
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a,
    uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"((int)add), "n"(TRANS_B));
}

template <int N, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, bool add) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192, "wgmma width");
  if constexpr (N == 32) wgmma_m64n32k16<TRANS_B>(d, a, b, add);
  if constexpr (N == 64) wgmma_m64n64k16<TRANS_B>(d, a, b, add);
  if constexpr (N == 128) wgmma_m64n128k16<TRANS_B>(d, a, b, add);
  if constexpr (N == 192) wgmma_m64n192k16<TRANS_B>(d, a, b, add);
}

// d (+)= A B with A 64 x 16 from registers: the four bfloat16 pairs a
// thread holds, in the layout of an mma.sync m16n8k16 A fragment for the
// warp's 16 rows (a[0] row g, columns 2t and 2t + 1; a[1] row g + 8;
// a[2], a[3] the same at columns + 8). B 16 x 64 MN-major from shared
// memory (imm-trans-b 1). For 16-bit types, the accumulator elements 8j
// .. 8j + 7 of a product (columns 16j .. 16j + 15) are that fragment as
// they lie, once packed in pairs: a product's output goes back into the
// tensor cores as the A of the next with no shuffle.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"((int)add));
}

// -- host: tensor maps ---------------------------------------------------------

// a driver function by name, through the runtime's entry-point query
// (null if the driver has none)
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                          &found);
#endif
  return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? p
                                                                  : nullptr;
}

// cuTensorMapEncodeTiled from the driver, fetched once (null if the driver
// has none)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn =
      reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(
          driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// cuTensorMapEncodeIm2col likewise
inline decltype(&cuTensorMapEncodeIm2col) encode_im2col_fn() {
  static decltype(&cuTensorMapEncodeIm2col) fn =
      reinterpret_cast<decltype(&cuTensorMapEncodeIm2col)>(
          driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// A 2-D row-major bfloat16 array [outer][inner] at `base`, rows `pitch`
// bytes apart, loaded in boxes of box_outer rows x box_inner values with
// the 128-byte swizzle (box_inner * 2 <= 128), zeros past the edges.
// Returns a CUDA error code (0 on success).
inline int encode_tma_2d(CUtensorMap* map, const void* base, uint64_t inner,
                         uint64_t outer, uint64_t pitch, uint32_t box_inner,
                         uint32_t box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous 3-D bfloat16 array [d2][d1][d0] at `base`, loaded in boxes
// of 1 x box1 x box0 values with the 128-byte swizzle (box0 * 2 <= 128),
// zeros past the edges: a box never reads across an edge of d1 into the
// next d2.
inline int encode_tma_3d(CUtensorMap* map, const void* base, uint64_t d0,
                         uint64_t d1, uint64_t d2, uint32_t box0,
                         uint32_t box1) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous float32 vector of n values at `base`, loaded in boxes of
// `box` values (box * 4 a multiple of 16 bytes), no swizzle, zeros past
// its end. A 1-D map takes any length: a 2-D one would want its pitch a
// multiple of 16 bytes. A load's first value must lie on 16 bytes (c0 a
// multiple of 4): a load that started elsewhere made the launch fault on
// an H100.
inline int encode_tma_1d_f32(CUtensorMap* map, const void* base, uint64_t n,
                             uint32_t box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {n * 4};  // unread at rank 1
  const cuuint32_t boxes[1] = {box};
  const cuuint32_t elem[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous NHWC bfloat16 tensor [N][H][W][C] at `base` in im2col mode
// for a 3 x 3 / stride-1 / pad-1 walk: the box's corners one pixel in
// from each edge, `pixels` rows of `channels` values a load (channels * 2
// <= 128), the 128-byte swizzle, zeros past every edge.
inline int encode_im2col_3x3(CUtensorMap* map, const void* base, int N,
                             int H, int W, int C, uint32_t channels,
                             uint32_t pixels) {
  decltype(&cuTensorMapEncodeIm2col) encode = encode_im2col_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const int lower[2] = {-1, -1};  // {W, H}
  const int upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, lower, upper, channels, pixels, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
