// Flash attention backward on Hopper's tensor cores, float32-exact through
// 3xTF32, for sm_90a: two kernels, dK/dV and dQ.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, `_fa_backward` (its two
// pallas_calls) with the kernel bodies `_fa_bwd_dkv_kernel` and
// `_fa_bwd_dq_kernel`, reached through the custom vjp of
// `flash_attention_with_lse`. The FlashAttention-2 recompute scheme: with
// p = exp(s - lse), s = q k^T * scale,
//   dv = p^T dO;  dp = dO v^T;  ds = p * (dp - delta) * scale;
//   dk = ds^T q;  dq = ds k,
// where delta = rowsum(dO * o) - dlse is computed by the wrapper (the JAX
// package computes it outside its kernels too). No [S, S] tile ever
// reaches device memory.
//
// What bounds it on the H100: operations. Per (query, key) pair that
// attends, the dK/dV kernel does 8 * D flops (q.k, dO.v, p*dO, ds*q) and
// the dQ kernel 6 * D (q.k, dO.v, ds*k); a causal head of length S has
// S * (S + 1) / 2 such pairs on 9 * S * D * 4 bytes of q, k, v, o, dO and
// the three gradients. Every product runs on the tensor cores in 3xTF32,
// three TF32 products for each float32 one, so the least time is 3 * flops
// over the card's 495 TFLOP/s dense TF32 (the bytes take a tenth of that
// at S = 1024, D = 64).
//
// Design.
// - 3xTF32. Each float32 operand x is split into hi, x rounded to TF32
//   (to nearest, ties away: the rounding of cvt.rna.tf32.f32), and lo =
//   x - hi, and a product a * b is accumulated in float32 registers as
//   lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) (the small terms first), three
//   mma.sync.m16n8k8 tf32 instructions: the scheme of CUTLASS's
//   OpMultiplyAddFastF32, which PyTorch's memory-efficient attention runs
//   for float32. One TF32 product alone errs by ~1e-3; the dropped lo * lo
//   term is ~2^-22 of a product. All five products (s, dp, dv, dk, dq)
//   take the split, p and ds included.
// - The split is done as a fragment is loaded from shared memory, so
//   tiles land there as they are in device memory, straight from
//   cp.async. It costs three instructions (an integer add of half a TF32
//   ulp, a mask, a subtraction): the tensor cores read only the top 19
//   bits of a TF32 operand, so hi and lo need no mask of their own. With
//   cvt.rna.tf32.f32, which adds an infinity test and a select to each
//   half (seven instructions for the pair on sm_90a), the kernels ran 1.3
//   to 1.4 times slower on an H100; splitting each landed tile once into
//   hi and lo planes in shared memory made dK/dV 1.25 times slower (one
//   more pass and barrier a tile, twice the fragment loads).
// - Accumulation. The tensor cores add into their accumulator with
//   truncation, so a sum over a walk of S = 2048 queries, left in the mma
//   accumulator, drifts by over 2e-5 of dk's and dv's largest magnitude.
//   The long sums (dk and dv over the queries, dq over the keys) are
//   therefore taken on the tensor cores one streamed tile at a time, from
//   zero, and each tile's sum is added to the float32 accumulator with an
//   ordinary rounded add: ~2e-6 at any S.
// - Tiles. A block is 4 warps and owns 64 rows of one (batch, head): 64 key
//   rows for dK/dV, 64 query rows for dQ, 16 a warp, with the warp's dK
//   and dV (or dQ) in registers. It walks the other side in tiles of
//   BN = 32 rows, the dK/dV kernel from the causal diagonal to S, the dQ
//   kernel from key 0 to the diagonal. A warp computes its 16 x BN tile of
//   s (or s^T) and dp, forms p and ds in registers, and feeds them straight
//   back as the A operand of the next products: the C fragment of m16n8k8
//   holds columns 2t and 2t + 1 where the A fragment wants t and t + 4, so
//   the 8 columns of each k step are taken in the order 0, 2, 4, 6, 1, 3,
//   5, 7 and the B operand's rows are loaded in the same order. A sum does
//   not depend on the order of its terms' names, so no shuffle and no trip
//   through shared memory is needed.
// - Shared memory rows are D + 4 floats apart, so each fragment load puts
//   the 32 lanes on 32 distinct banks (the row-wise loads at bank 4 g + t,
//   the permuted column-wise loads at 8 t + g).
// - Copies. Tiles come from device memory by 16-byte cp.async, double
//   buffered: the next tile is in flight while the tensor cores work on
//   the current one. Rows past the ragged end of S are zero-filled
//   (src-size 0). Dynamic shared memory (37 to 136 KB a block) is raised
//   with cudaFuncSetAttribute; its error comes back through the entry
//   point's return code.
// - Causal work. Tiles wholly above the diagonal are never visited; only
//   the tiles the diagonal cuts, and the tile at the ragged end, mask
//   pairs (p = 0). The first query tile of the dK/dV walk and the last key
//   tile of the dQ walk follow from the block's own offsets, so the two
//   tile heights need not match. The dQ blocks are issued last diagonal
//   first, the longest walks first, as the dK/dV blocks already are.
// - Determinism. Two kernels and no atomics, as the TPU's two pallas_calls:
//   each output element is written once, by one thread, after sums taken
//   in a fixed order, so two launches on the same inputs agree bit for bit.
// tools/torch_flash_bwd_study.py builds the alternatives named here and
// measures them against this source.
//
// Tensors are [B, S, H, D], contiguous, 16-byte aligned (the layout of the
// forward's inputs); lse and delta are [B, H, S]. The kernels allocate
// nothing. The entry points launch on the stream they are given and return
// a CUDA error code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // rows a block owns: 16 a warp
constexpr int BN = 32;          // rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

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

// Fragment loads; g = lane / 4, t = lane % 4 (the PTX ISA's groupID and
// threadID_in_group). `s` points at the tile's first element.

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

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

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows r0 .. r0 + ROWS - 1 of one head (`src` at its row 0; rows
// `stride` floats apart) into a [ROWS][D + 4] tile; rows past S read zeros
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0,
                                          int S, size_t stride) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + 4) + 4 * c,
               src + (in ? (size_t)(r0 + r) * stride : 0) + 4 * c, in);
  }
}

// entries r0 .. r0 + ROWS - 1 of a length-S vector; past S read zeros
template <int ROWS>
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool in = r0 + i < S;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in);
  }
}

// -- dK / dV -----------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  return ((2 * BR + 4 * BN) * (D + 4) + 4 * BN) * 4;
}

// One block: 64 key rows [k0, k0 + 64) of one (batch, head). Warp w holds
// dK and dV of keys k0 + 16 w .. + 15 in registers and walks the query
// tiles of BN rows.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int causal,
                     float scale) {
  constexpr int LD = D + 4;
  constexpr int NT = BN / 8;  // 8-query steps of a tile
  constexpr int DT = D / 8;   // 8-wide steps of the head dim
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BR][LD]
  float* vs = ks + BR * LD;         // [BR][LD]
  float* qs = vs + BR * LD;         // [2][BN][LD]
  float* dos = qs + 2 * BN * LD;    // [2][BN][LD]
  float* ls = dos + 2 * BN * LD;    // [2][BN]
  float* dls = ls + 2 * BN;         // [2][BN]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BR;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const size_t stride = (size_t)H * D;
  const size_t head = (size_t)b * S * stride + (size_t)h * D;
  const float* lse_h = lse + (size_t)bh * S;
  const float* delta_h = delta + (size_t)bh * S;

  // keys of this block attend only to queries at or after k0
  const int q_first = causal ? (k0 / BN) * BN : 0;
  const int n_tiles = (S - q_first + BN - 1) / BN;

  auto copy_tile = [&](int it) {
    const int q0 = q_first + it * BN;
    const int buf = it & 1;
    copy_rows<D, BN>(qs + buf * BN * LD, q + head, q0, S, stride);
    copy_rows<D, BN>(dos + buf * BN * LD, dout + head, q0, S, stride);
    copy_vec<BN>(ls + buf * BN, lse_h, q0, S);
    copy_vec<BN>(dls + buf * BN, delta_h, q0, S);
  };
  copy_rows<D, BR>(ks, k + head, k0, S, stride);
  copy_rows<D, BR>(vs, v + head, k0, S, stride);
  copy_tile(0);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dn][i] = dva[dn][i] = 0.f;

  const float* kw = ks + warp * 16 * LD;
  const float* vw = vs + warp * 16 * LD;
  const int key = k0 + warp * 16 + g;  // and key + 8
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_first + it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait_all_but_newest();
    __syncthreads();
    const float* qt = qs + (it & 1) * BN * LD;
    const float* dot = dos + (it & 1) * BN * LD;
    const float* lt = ls + (it & 1) * BN;
    const float* dlt = dls + (it & 1) * BN;

    // s^T = k q^T and dp^T = v dO^T: 16 keys x BN queries a warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const FragA ka = load_a<LD>(kw + kk * 8, g, t);
      const FragA va = load_a<LD>(vw + kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(st[n], ka, load_b_t<LD>(qt + n * 8 * LD + kk * 8, g, t));
        mma3(dpt[n], va, load_b_t<LD>(dot + n * 8 * LD + kk * 8, g, t));
      }
    }

    // p^T and ds^T in place; element i of a C fragment is key row
    // g + 8 (i / 2), query column 2 t + i % 2
    const bool masked = (causal && q0 < k0 + BR - 1) || q0 + BN > S;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        float p = exp2f(fmaf(st[n][i], scale_log2, -lt[qi] * LOG2E));
        if (masked) {
          const int qpos = q0 + qi;
          if (qpos >= S || (causal && key + 8 * (i >> 1) > qpos)) p = 0.f;
        }
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - dlt[qi]) * scale;
      }
    }

    // dv += p^T dO and dk += ds^T q, over the tile's queries: the tile's
    // sum leaves the tensor cores and is added to dv and dk in float32
    FragA pa[NT], dsa[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      pa[n] = a_of_c(st[n]);
      dsa[n] = a_of_c(dpt[n]);
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      float cv[4] = {0.f, 0.f, 0.f, 0.f}, ck[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int off = n * 8 * LD + dn * 8;
        mma3(cv, pa[n], load_b_perm<LD>(dot + off, g, t));
        mma3(ck, dsa[n], load_b_perm<LD>(qt + off, g, t));
      }
      add4(dva[dn], cv);
      add4(dka[dn], ck);
    }
    __syncthreads();  // the tile's buffer is refilled next iteration
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = key + 8 * half;
    if (row >= S) continue;
    const size_t off = head + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<float2*>(dk + off + dn * 8) =
          make_float2(dka[dn][2 * half], dka[dn][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + off + dn * 8) =
          make_float2(dva[dn][2 * half], dva[dn][2 * half + 1]);
    }
  }
}

// -- dQ ----------------------------------------------------------------------

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BR + 4 * BN) * (D + 4) * 4;
}

// One block: 64 query rows [q0, q0 + 64) of one (batch, head). Warp w
// holds dQ of queries q0 + 16 w .. + 15 in registers and walks the key
// tiles of BN rows up to the diagonal. Blocks are issued last tile first.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int NT = BN / 8;  // 8-key steps of a tile
  constexpr int DT = D / 8;   // 8-wide steps of the head dim
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BR][LD]
  float* dos = qs + BR * LD;      // [BR][LD]
  float* ks = dos + BR * LD;      // [2][BN][LD]
  float* vs = ks + 2 * BN * LD;   // [2][BN][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const size_t stride = (size_t)H * D;
  const size_t head = (size_t)b * S * stride + (size_t)h * D;

  // queries of this block attend only to keys before q0 + 64
  const int k_end = causal ? min(S, q0 + BR) : S;
  const int n_tiles = (k_end + BN - 1) / BN;

  auto copy_tile = [&](int it) {
    const int buf = it & 1;
    copy_rows<D, BN>(ks + buf * BN * LD, k + head, it * BN, S, stride);
    copy_rows<D, BN>(vs + buf * BN * LD, v + head, it * BN, S, stride);
  };
  copy_rows<D, BR>(qs, q + head, q0, S, stride);
  copy_rows<D, BR>(dos, dout + head, q0, S, stride);
  copy_tile(0);
  cp_async_commit();

  // this thread's two query rows, and their lse (base 2) and delta
  const int row = q0 + warp * 16 + g;  // and row + 8
  float l2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    const size_t off = (size_t)bh * S + r;
    l2[half] = r < S ? lse[off] * LOG2E : 0.f;
    dl[half] = r < S ? delta[off] : 0.f;
  }

  float dqa[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[dn][i] = 0.f;

  const float* qw = qs + warp * 16 * LD;
  const float* ow = dos + warp * 16 * LD;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait_all_but_newest();
    __syncthreads();
    const float* kt = ks + (it & 1) * BN * LD;
    const float* vt = vs + (it & 1) * BN * LD;

    // s = q k^T and dp = dO v^T: 16 queries x BN keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const FragA qa = load_a<LD>(qw + kk * 8, g, t);
      const FragA oa = load_a<LD>(ow + kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(s[n], qa, load_b_t<LD>(kt + n * 8 * LD + kk * 8, g, t));
        mma3(dp[n], oa, load_b_t<LD>(vt + n * 8 * LD + kk * 8, g, t));
      }
    }

    // p and ds in place; element i of a C fragment is query row g + 8
    // (i / 2), key column 2 t + i % 2
    const bool masked = (causal && kt0 + BN - 1 > q0) || kt0 + BN > S;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int half = i >> 1;
        float p = exp2f(fmaf(s[n][i], scale_log2, -l2[half]));
        if (masked) {
          const int kpos = kt0 + n * 8 + 2 * t + (i & 1);
          if (kpos >= S || (causal && kpos > row + 8 * half)) p = 0.f;
        }
        dp[n][i] = p * (dp[n][i] - dl[half]) * scale;
      }
    }

    // dq += ds k, over the tile's keys: the tile's sum leaves the tensor
    // cores and is added to dq in float32
    FragA dsa[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) dsa[n] = a_of_c(dp[n]);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3(c, dsa[n], load_b_perm<LD>(kt + n * 8 * LD + dn * 8, g, t));
      add4(dqa[dn], c);
    }
    __syncthreads();  // the tile's buffer is refilled next iteration
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= S) continue;
    const size_t off = head + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(dq + off + dn * 8) =
          make_float2(dqa[dn][2 * half], dqa[dn][2 * half + 1]);
  }
}

// -- launch ------------------------------------------------------------------

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  int B, S, H, causal;
  float scale;
  cudaStream_t stream;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int S, int H,
               int causal, float scale, void* stream) {
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, S, H, causal, scale,
              static_cast<cudaStream_t>(stream)};
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int D>
int launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr int smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.S + BR - 1) / BR);
  kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                            a.delta, dk, dv, a.S, a.H,
                                            a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, float* dq) {
  constexpr int smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.S + BR - 1) / BR);
  kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                            a.delta, dq, a.S, a.H, a.causal,
                                            a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv [B, S, H, D] and lse, delta [B, H, S], float32,
// contiguous, on one device; the [B, S, H, D] tensors 16-byte aligned. D
// must be 32, 64 or 128.
int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int S, int H, int D, int causal, float scale,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, causal, scale,
                           stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  switch (D) {
    case 32: return launch_dkv<32>(a, dkf, dvf);
    case 64: return launch_dkv<64>(a, dkf, dvf);
    case 128: return launch_dkv<128>(a, dkf, dvf);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same inputs; dq [B, S, H, D].
int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int S,
                               int H, int D, int causal, float scale,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return (int)cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, causal, scale,
                           stream);
  float* dqf = static_cast<float*>(dq);
  switch (D) {
    case 32: return launch_dq<32>(a, dqf);
    case 64: return launch_dq<64>(a, dqf);
    case 128: return launch_dq<128>(a, dqf);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of either kernel takes at head dim D
// (0 for a D without a kernel): which 0 is dK/dV, 1 dQ.
int flash_attention_bwd_smem_bytes(int D, int which) {
  switch (D) {
    case 32: return which ? dq_smem_bytes<32>() : dkv_smem_bytes<32>();
    case 64: return which ? dq_smem_bytes<64>() : dkv_smem_bytes<64>();
    case 128: return which ? dq_smem_bytes<128>() : dkv_smem_bytes<128>();
    default: return 0;
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
