// Float32-exact products on Hopper's tensor cores through 3xTF32, and the
// asynchronous copies that feed them: the device helpers shared by
// flash_attention_fwd.cu, flash_attention_bwd.cu and matmul.cu.
//
// 3xTF32. Each float32 operand x is split into hi, x rounded to TF32 (to
// nearest, ties away: the rounding of cvt.rna.tf32.f32), and lo = x - hi,
// and a product a * b is accumulated in float32 registers as lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b) (the small terms first), three
// mma.sync.m16n8k8 tf32 instructions: the scheme of CUTLASS's
// OpMultiplyAddFastF32. One TF32 product alone errs by ~1e-3; the dropped
// lo * lo term is ~2^-22 of a product.
//
// The split is done as a fragment is loaded from shared memory (or, for a
// fragment that stays in registers, once), so tiles land there as they are
// in device memory, straight from cp.async. It costs three instructions
// (an integer add of half a TF32 ulp, a mask, a subtraction): the tensor
// cores read only the top 19 bits of a TF32 operand, so hi and lo need no
// mask of their own. cvt.rna.tf32.f32 adds an infinity test and a select
// to each half (seven instructions for the pair on sm_90a).
//
// The tensor cores add into their accumulator with truncation, so a long
// sum left in the mma accumulator drifts; a caller sums each streamed tile
// from zero on the tensor cores and adds the tile's sum to a float32
// accumulator in registers (add4).
//
// Fragments follow the PTX ISA's m16n8k8 tf32 layouts; g = lane / 4 and
// t = lane % 4 (its groupID and threadID_in_group). Element i of a C
// fragment is row g + 8 (i / 2), column 2 t + i % 2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- 3xTF32 on mma.sync ------------------------------------------------------

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

// x = hi + lo: hi is x rounded to TF32 once its low 13 bits are dropped,
// which the tensor cores do as they read it; lo is the rest, exact in
// float32, of which they read the top 19 bits as well
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t r = __float_as_uint(x) + 0x1000u;
  hi = r;
  lo = __float_as_uint(x - __uint_as_float(r & 0xffffe000u));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += c[i];
}

// d += a * b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// the same, the large term into d and the two small ones into e, so that
// the caller's large sum takes a third as many truncating adds; d + e is
// the product
__device__ __forceinline__ void mma3_apart(float (&d)[4], float (&e)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(e, a.lo, b.hi);
  mma_tf32(e, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Fragment loads; `s` points at the tile's first element.

// A = rows 0..15, columns 0..7 of a row-major tile
template <int LD>
__device__ __forceinline__ FragA load_a(const float* s, int g, int t) {
  FragA f;
  split(s[g * LD + t], f.hi[0], f.lo[0]);
  split(s[(g + 8) * LD + t], f.hi[1], f.lo[1]);
  split(s[g * LD + t + 4], f.hi[2], f.lo[2]);
  split(s[(g + 8) * LD + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// A = the four values of an A fragment held in registers, in its order
__device__ __forceinline__ FragA split_a(const float (&x)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
  return f;
}

// A = a 16 x 8 C fragment, its columns taken in the order 0, 2, 4, 6, 1,
// 3, 5, 7 (what load_b_perm's rows follow)
__device__ __forceinline__ FragA a_of_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B = rows 0..7, columns 0..7 of a row-major tile (B[k][n] = Y[k][n]):
// the weights of x w
template <int LD>
__device__ __forceinline__ FragB load_b(const float* s, int g, int t) {
  FragB f;
  split(s[t * LD + g], f.hi[0], f.lo[0]);
  split(s[(t + 4) * LD + g], f.hi[1], f.lo[1]);
  return f;
}

// B = Y^T, Y the rows 0..7, columns 0..7 of a row-major tile (B[k][n] =
// Y[n][k]): the keys of q k^T, the queries of k q^T
template <int LD>
__device__ __forceinline__ FragB load_b_t(const float* s, int g, int t) {
  FragB f;
  split(s[g * LD + t], f.hi[0], f.lo[0]);
  split(s[g * LD + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// B = rows 0..7, columns 0..7 of a row-major tile, its rows in the order
// 0, 2, 4, 6, 1, 3, 5, 7, to meet an A from a_of_c
template <int LD>
__device__ __forceinline__ FragB load_b_perm(const float* s, int g, int t) {
  FragB f;
  split(s[2 * t * LD + g], f.hi[0], f.lo[0]);
  split(s[(2 * t + 1) * LD + g], f.hi[1], f.lo[1]);
  return f;
}

// -- asynchronous copies -----------------------------------------------------

// 16 bytes from device to shared memory; zeros when `in` is false (src
// is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups (the newest N) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 of one head (`src` at its row 0; rows
// `stride` floats apart) into a [ROWS][D + 4] tile by the block's
// NTHREADS threads, 16 bytes a copy; rows past S read zeros
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0,
                                          int S, size_t stride) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + 4) + 4 * c,
               src + (in ? (size_t)(r0 + r) * stride : 0) + 4 * c, in);
  }
}

}  // namespace
