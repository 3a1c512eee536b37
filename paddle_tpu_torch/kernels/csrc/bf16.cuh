// bfloat16 products on Hopper's tensor cores, summed in float32: the device
// helpers shared by the bfloat16 faces of conv3x3.cu, matmul.cu,
// flash_attention_fwd.cu and flash_attention_bwd.cu.
//
// A product of two bfloat16 values is exact in float32 (8 + 8 significant
// bits), so mma.sync.m16n8k16 (or m16n8k8) bf16 x bf16 -> f32 computes the
// JAX kernels' `jnp.dot(..., preferred_element_type=float32)` up to the
// order of the sums. As with 3xTF32 (tf32x3.cuh), a caller sums each
// streamed tile from zero on the tensor cores and adds the tile's sum to
// a float32 accumulator in registers.
//
// Fragments follow the PTX ISA's m16n8k16 / m16n8k8 bf16 layouts; g =
// lane / 4 and t = lane % 4. A register holds two bfloat16 values, the
// lower column (A) or row (B) in its low half. A is read from a row-major
// [m][k] tile with 32-bit loads. B is read from a row-major [k][n] tile
// (n contiguous, the layout of the weights in device memory) with
// ldmatrix.trans, which hands each lane the two k-adjacent values of its
// column. The C fragment is that of tf32x3.cuh: element i is row
// g + 8 (i / 2), column 2 t + i % 2.
//
// A float32 operand against a bfloat16 one (the flash kernels' p and ds,
// which the JAX kernels keep in float32): each value x is split into
// hi = bf16(x) and lo = bf16(x - hi), and x * b is taken as hi * b + lo *
// b, two mmas, exact products of a value within 2^-17 of x (hi carries 8
// significant bits, lo the next 8). Two C fragments side by side (columns
// 0..7 and 8..15) are the A fragment of a k16 step as they lie in the
// registers, so p and ds go back into the tensor cores with no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// d += a * b, a 16 x 16, b 16 x 8
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, a 16 x 8, b 8 x 8
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A = rows 0..15, columns 0..15 of a row-major tile `s` of pitch LD
template <int LD>
__device__ __forceinline__ void load_a16(uint32_t (&a)[4], const bf16* s,
                                         int g, int t) {
  a[0] = ld32(s + g * LD + 2 * t);
  a[1] = ld32(s + (g + 8) * LD + 2 * t);
  a[2] = ld32(s + g * LD + 2 * t + 8);
  a[3] = ld32(s + (g + 8) * LD + 2 * t + 8);
}

// A = rows 0..15, columns 0..7
template <int LD>
__device__ __forceinline__ void load_a8(uint32_t (&a)[2], const bf16* s,
                                        int g, int t) {
  a[0] = ld32(s + g * LD + 2 * t);
  a[1] = ld32(s + (g + 8) * LD + 2 * t);
}

// B = rows 0..15, columns 0..7 of a row-major [k][n] tile `s` of pitch LD
// (rows 16-byte aligned): lanes 0..15 name the rows, the .trans load
// gives lane (g, t) the values at rows 2t, 2t + 1 (b[0]) and 2t + 8,
// 2t + 9 (b[1]) of column g
template <int LD>
__device__ __forceinline__ void load_b16(uint32_t (&b)[2], const bf16* s,
                                         int lane) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(s + (lane % 16) * LD));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// B = rows 0..7, columns 0..7: lanes 0..7 name the rows
template <int LD>
__device__ __forceinline__ uint32_t load_b8(const bf16* s, int lane) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(s + (lane % 8) * LD));
  uint32_t b;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
      : "=r"(b)
      : "r"(addr));
  return b;
}

// B = Y^T, Y the rows 0..7, columns 0..15 of a row-major tile `s` of
// pitch LD (B[k][n] = Y[n][k]): the keys of q k^T, the queries of k q^T;
// 32-bit loads, the k-adjacent pair of each lane lies side by side
template <int LD>
__device__ __forceinline__ void load_b16_t(uint32_t (&b)[2], const bf16* s,
                                           int g, int t) {
  b[0] = ld32(s + g * LD + 2 * t);
  b[1] = ld32(s + g * LD + 2 * t + 8);
}

// two floats as a bfloat16 pair (rounded to nearest even), the first in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a = hi + lo for a pair of floats, each half a bfloat16 pair
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// A = a 16 x 16 float32 operand, split, from the C fragments of its
// columns 0..7 (c0) and 8..15 (c1)
struct FragA16 {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA16 a_of_c2(const float (&c0)[4],
                                           const float (&c1)[4]) {
  FragA16 f;
  split_bf16(c0[0], c0[1], f.hi[0], f.lo[0]);
  split_bf16(c0[2], c0[3], f.hi[1], f.lo[1]);
  split_bf16(c1[0], c1[1], f.hi[2], f.lo[2]);
  split_bf16(c1[2], c1[3], f.hi[3], f.lo[3]);
  return f;
}

// d += a * b for a split float32 a: the small term first
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA16& a,
                                          const uint32_t (&b)[2]) {
  mma_bf16_k16(d, a.lo, b);
  mma_bf16_k16(d, a.hi, b);
}

// 16 bytes (8 values) from device to shared memory; zeros when `in` is
// false (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// rows r0 .. r0 + ROWS - 1 of one head (`src` at its row 0; rows
// `stride` values apart) into a [ROWS][D + 8] tile by the block's
// NTHREADS threads, 16 bytes (8 values) a copy; rows past S read zeros
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void copy_rows_bf16(bf16* dst, const bf16* src,
                                               int r0, int S, size_t stride) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + 8) + 8 * c,
               src + (in ? (size_t)(r0 + r) * stride : 0) + 8 * c, in);
  }
}

// Two float32 sums to the output: bfloat16 rounded to nearest even (the
// rounding of torch's .to(bfloat16) and of JAX's astype), or float32.
// `pair`: both columns are in and the address is 4-byte (bfloat16) or
// 8-byte (float) aligned.
__device__ __forceinline__ void store2(bf16* o, float v0, float v1,
                                       bool in0, bool in1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (in0) o[0] = __float2bfloat16_rn(v0);
    if (in1) o[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void store2(float* o, float v0, float v1,
                                       bool in0, bool in1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    if (in0) o[0] = v0;
    if (in1) o[1] = v1;
  }
}

}  // namespace
