// Flash attention backward on Hopper's tensor cores, float32-exact through
// 3xTF32, for sm_90a: two kernels, dK/dV and dQ, each with a bfloat16
// face.
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
// The 3xTF32 split, the mma, the fragment loads and the cp.async wrappers
// are the shared helpers of tf32x3.cuh.
// tools/torch_flash_bwd_study.py builds the alternatives named here and
// measures them against this source.
//
// The bfloat16 faces (flash_attention_bwd_dkv_bf16 / _dq_bf16, pure AMP):
// the kernel bodies on bfloat16 refs, all arithmetic float32 on the
// bfloat16 values and each gradient rounded once to bfloat16. Two paths,
// picked by head dim before the launch: at D 64 (every main path) two
// TMA-fed, warp-specialised wgmma kernels, at D 32 and 128 the float32
// kernels' walks, tiles, causal skips and double buffers on bfloat16
// tiles with mma.sync (see the kernels). Bound: the larger of the bytes (q, k, v, dO and the
// gradients at 2 bytes, lse and delta at 4) over 3.35 TB/s and the flops
// over 989 TFLOP/s dense bf16: 0.026 ms (dK/dV) and 0.0195 ms (dQ) at the
// LM step's shape, both by operations; the split products of p and ds
// make the tensor-core work 1.5x (dK/dV) and 1.33x (dQ) those flops.
//
// Tensors are [B, S, H, D], contiguous, 16-byte aligned (the layout of the
// forward's inputs); lse and delta are [B, H, S], float32 on both faces.
// The kernels allocate nothing. The entry points launch on the stream they are given and return
// a CUDA error code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // rows a block owns: 16 a warp
constexpr int BN = 32;          // rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

// -- copies of tiles --------------------------------------------------------

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
    copy_rows<D, BN, THREADS>(qs + buf * BN * LD, q + head, q0, S, stride);
    copy_rows<D, BN, THREADS>(dos + buf * BN * LD, dout + head, q0, S, stride);
    copy_vec<BN>(ls + buf * BN, lse_h, q0, S);
    copy_vec<BN>(dls + buf * BN, delta_h, q0, S);
  };
  copy_rows<D, BR, THREADS>(ks, k + head, k0, S, stride);
  copy_rows<D, BR, THREADS>(vs, v + head, k0, S, stride);
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
    cp_async_wait<1>();
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
    copy_rows<D, BN, THREADS>(ks + buf * BN * LD, k + head, it * BN, S, stride);
    copy_rows<D, BN, THREADS>(vs + buf * BN * LD, v + head, it * BN, S, stride);
  };
  copy_rows<D, BR, THREADS>(qs, q + head, q0, S, stride);
  copy_rows<D, BR, THREADS>(dos, dout + head, q0, S, stride);
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
    cp_async_wait<1>();
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

// -- the bfloat16 faces on mma.sync: D 32 and 128 -------------------------
//
// q, k, v, dO, dk, dv and dq bfloat16; lse and delta float32:
// `_fa_bwd_dkv_kernel` and `_fa_bwd_dq_kernel` on bfloat16 refs, which
// cast their tiles to float32, compute in float32 and write each gradient
// once in its operand's dtype. Each float32 kernel's walk, tiles, causal
// skip and double buffer, on tiles of [rows][D + 8] bfloat16 (a 16-byte
// cp.async moves 8 values; the pitch puts a warp's 32-bit fragment loads
// on 32 distinct banks and keeps rows 16-byte aligned for ldmatrix).
// - s (or s^T) and dp (or dp^T): both operands bfloat16, one bf16
//   mma.sync.m16n8k16 a 16-wide step of the head dim, exact products
//   summed in float32. The B operand (the streamed or the owned rows, as
//   Y^T) is read with 32-bit loads: its k index, the head dim, runs along
//   the rows.
// - p^T dO, ds^T q (dK/dV) and ds k (dQ): p and ds stay float32, as the
//   JAX kernels keep them. Two C fragments are split into a bfloat16 hi and
//   lo (bf16.cuh) and taken in two mmas; the B operand's k index (the
//   query, or the key) runs down the tile's rows, so it comes by
//   ldmatrix.trans.
// - Each tile's sums leave the tensor cores from zero and are added in
//   float32; the gradients are rounded once to bfloat16 (to nearest even).

template <int D>
constexpr int dkv_bf16_mma_smem_bytes() {
  // K and V of the block, q and dO two buffers each; then lse and delta
  return (2 * BR + 4 * BN) * (D + 8) * (int)sizeof(bf16) +
         4 * BN * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int S, int H, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;   // 8-query column tiles of s^T
  constexpr int KT = BN / 16;  // 16-query steps of p^T dO and ds^T q
  constexpr int DK = D / 16;   // 16-wide steps of the head dim
  constexpr int DT = D / 8;    // 8-wide column tiles of dk and dv
  extern __shared__ __align__(16) float smem_f[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_f);  // [BR][LD]
  bf16* v_s = k_s + BR * LD;                    // [BR][LD]
  bf16* q_s = v_s + BR * LD;                    // [2][BN][LD]
  bf16* do_s = q_s + 2 * BN * LD;               // [2][BN][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LD);  // [2][BN]
  float* delta_s = lse_s + 2 * BN;                              // [2][BN]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BR;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t stride = (size_t)H * D;
  const size_t head = (size_t)b * S * stride + (size_t)h * D;
  const float* lse_h = lse + (size_t)bh * S;
  const float* delta_h = delta + (size_t)bh * S;

  const int q_first = causal ? (k0 / BN) * BN : 0;
  const int n_tiles = (S - q_first + BN - 1) / BN;

  auto copy_tile = [&](int it) {
    const int q0 = q_first + it * BN;
    const int buf = it & 1;
    copy_rows_bf16<D, BN, THREADS>(q_s + buf * BN * LD, q + head, q0, S,
                                   stride);
    copy_rows_bf16<D, BN, THREADS>(do_s + buf * BN * LD, dout + head, q0, S,
                                   stride);
    copy_vec<BN>(lse_s + buf * BN, lse_h, q0, S);
    copy_vec<BN>(delta_s + buf * BN, delta_h, q0, S);
  };
  copy_rows_bf16<D, BR, THREADS>(k_s, k + head, k0, S, stride);
  copy_rows_bf16<D, BR, THREADS>(v_s, v + head, k0, S, stride);
  copy_tile(0);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dn][i] = dv_acc[dn][i] = 0.f;

  const bf16* k_w = k_s + warp * 16 * LD;
  const bf16* v_w = v_s + warp * 16 * LD;
  const int key = k0 + warp * 16 + g;  // and key + 8
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_first + it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const bf16* q_t = q_s + (it & 1) * BN * LD;
    const bf16* do_t = do_s + (it & 1) * BN * LD;
    const float* lse_t = lse_s + (it & 1) * BN;
    const float* delta_t = delta_s + (it & 1) * BN;

    // s^T = k q^T and dp^T = v dO^T: 16 keys x BN queries a warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ka[4], va[4];
      load_a16<LD>(ka, k_w + kk * 16, g, t);
      load_a16<LD>(va, v_w + kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t qb[2], ob[2];
        load_b16_t<LD>(qb, q_t + n * 8 * LD + kk * 16, g, t);
        load_b16_t<LD>(ob, do_t + n * 8 * LD + kk * 16, g, t);
        mma_bf16_k16(st[n], ka, qb);
        mma_bf16_k16(dpt[n], va, ob);
      }
    }

    // p^T and ds^T in place, float32; element i of a C fragment is key row
    // g + 8 (i / 2), query column 2 t + i % 2
    const bool masked = (causal && q0 < k0 + BR - 1) || q0 + BN > S;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        float p = exp2f(fmaf(st[n][i], scale_log2, -lse_t[qi] * LOG2E));
        if (masked) {
          const int qpos = q0 + qi;
          if (qpos >= S || (causal && key + 8 * (i >> 1) > qpos)) p = 0.f;
        }
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - delta_t[qi]) * scale;
      }
    }

    // dv += p^T dO and dk += ds^T q over the tile's queries, each tile's
    // sum from zero on the tensor cores, added in float32
    FragA16 pa[KT], dsa[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      pa[j] = a_of_c2(st[2 * j], st[2 * j + 1]);
      dsa[j] = a_of_c2(dpt[2 * j], dpt[2 * j + 1]);
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      float tile_v[4] = {0.f, 0.f, 0.f, 0.f};
      float tile_k[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t ob[2], qb[2];
        load_b16<LD>(ob, do_t + j * 16 * LD + dn * 8, lane);
        load_b16<LD>(qb, q_t + j * 16 * LD + dn * 8, lane);
        mma_split(tile_v, pa[j], ob);
        mma_split(tile_k, dsa[j], qb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv_acc[dn][i] += tile_v[i];
        dk_acc[dn][i] += tile_k[i];
      }
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
      store2(dk + off + dn * 8, dk_acc[dn][2 * half],
             dk_acc[dn][2 * half + 1], true, true, true);
      store2(dv + off + dn * 8, dv_acc[dn][2 * half],
             dv_acc[dn][2 * half + 1], true, true, true);
    }
  }
}

template <int D>
constexpr int dq_bf16_mma_smem_bytes() {
  // q and dO of the block, K and V two buffers each
  return (2 * BR + 4 * BN) * (D + 8) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int S, int H, int causal,
                             float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;   // 8-key column tiles of s
  constexpr int KT = BN / 16;  // 16-key steps of ds k
  constexpr int DK = D / 16;   // 16-wide steps of the head dim
  constexpr int DT = D / 8;    // 8-wide column tiles of dq
  extern __shared__ __align__(16) float smem_f[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_f);  // [BR][LD]
  bf16* do_s = q_s + BR * LD;                   // [BR][LD]
  bf16* k_s = do_s + BR * LD;                   // [2][BN][LD]
  bf16* v_s = k_s + 2 * BN * LD;                // [2][BN][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t stride = (size_t)H * D;
  const size_t head = (size_t)b * S * stride + (size_t)h * D;

  const int k_end = causal ? min(S, q0 + BR) : S;
  const int n_tiles = (k_end + BN - 1) / BN;

  auto copy_tile = [&](int it) {
    const int buf = it & 1;
    copy_rows_bf16<D, BN, THREADS>(k_s + buf * BN * LD, k + head, it * BN, S,
                                   stride);
    copy_rows_bf16<D, BN, THREADS>(v_s + buf * BN * LD, v + head, it * BN, S,
                                   stride);
  };
  copy_rows_bf16<D, BR, THREADS>(q_s, q + head, q0, S, stride);
  copy_rows_bf16<D, BR, THREADS>(do_s, dout + head, q0, S, stride);
  copy_tile(0);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // and row + 8
  float l2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    const size_t off = (size_t)bh * S + r;
    l2[half] = r < S ? lse[off] * LOG2E : 0.f;
    dl[half] = r < S ? delta[off] : 0.f;
  }

  float dq_acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[dn][i] = 0.f;

  const bf16* q_w = q_s + warp * 16 * LD;
  const bf16* do_w = do_s + warp * 16 * LD;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_t = k_s + (it & 1) * BN * LD;
    const bf16* v_t = v_s + (it & 1) * BN * LD;

    // s = q k^T and dp = dO v^T: 16 queries x BN keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4], oa[4];
      load_a16<LD>(qa, q_w + kk * 16, g, t);
      load_a16<LD>(oa, do_w + kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t kb[2], vb[2];
        load_b16_t<LD>(kb, k_t + n * 8 * LD + kk * 16, g, t);
        load_b16_t<LD>(vb, v_t + n * 8 * LD + kk * 16, g, t);
        mma_bf16_k16(s[n], qa, kb);
        mma_bf16_k16(dp[n], oa, vb);
      }
    }

    // ds in place, float32; element i of a C fragment is query row
    // g + 8 (i / 2), key column 2 t + i % 2
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

    // dq += ds k over the tile's keys: the tile's sum from zero on the
    // tensor cores, added in float32
    FragA16 dsa[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) dsa[j] = a_of_c2(dp[2 * j], dp[2 * j + 1]);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      float tile_q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t kb[2];
        load_b16<LD>(kb, k_t + j * 16 * LD + dn * 8, lane);
        mma_split(tile_q, dsa[j], kb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dq_acc[dn][i] += tile_q[i];
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
      store2(dq + off + dn * 8, dq_acc[dn][2 * half],
             dq_acc[dn][2 * half + 1], true, true, true);
  }
}

// -- the bfloat16 faces at D 64: TMA + wgmma ---------------------------------
//
// The same functions as the mma.sync kernels above, for the head dim of
// GPT-2 small and every main path: D 64, one 128-byte swizzled row of
// bfloat16. Each kernel is FlashAttention-3's skeleton, as the forward's
// flash_fwd_bf16_wgmma_kernel: warpgroup 0 is the producer (one thread
// issues TMA), warpgroups 1 and 2 the consumers, 64 owned rows each.
// q, k, v and dO are 3-D maps {H D, S, B} loaded in boxes of 64 values
// by 64 (or BQ_W) rows at (h D, row, b): rows past S arrive as zeros and
// no box reads the next batch's rows. The owned rows land once; the
// streamed tiles come through a ring of RING_W stages (a full and an
// empty mbarrier a stage).
// - dK/dV: a block owns BK_W = 128 keys and walks the query tiles of
//   BQ_W rows from the causal diagonal to S. A stage holds the tile's q
//   and dO and its lse and delta, each a box of a 1-D float32 map over
//   [B H S] (a 2-D map [B H][S] would want S * 4 a multiple of 16 bytes).
//   A box must start on 16 bytes (one that started elsewhere made the
//   launch fault), so it starts at the tile's first entry rounded down to
//   4 and holds BQ_W + 4 values; past S they are the next head's, and the masks drop
//   them by select. For each tile a consumer warpgroup takes
//   - s^T = k q^T and dp^T = v dO^T on wgmma m64nBQ_Wk16, A its k or v
//     rows from shared memory, B the q or dO tile as it lands ([query][d],
//     K-major: imm-trans-b 0);
//   - p^T = 2^(s^T scale log2 e - lse log2 e) and ds^T = p^T (dp^T -
//     delta) scale in registers, lse and delta read from the stage as
//     they are used, masked by select only on the tiles that the
//     diagonal or the end of S cuts, each split into a bfloat16 hi and
//     lo pair (bf16.cuh): s^T is kept transposed so that its accumulator's
//     elements 8j .. 8j + 7 are the A fragment of k16 step j as they lie;
//   - dv += p^T dO and dk += ds^T q on wgmma m64n64k16 with A from
//     registers, B the same dO or q tile read MN-major (imm-trans-b 1),
//     summed in the wgmma accumulator over the whole walk (below).
// - dQ: a block owns BM_W = 128 queries (the last block first: the
//   longest causal walks start first) and walks the key tiles of BN_W
//   rows up to the diagonal; lse and delta of its rows are read once
//   into registers. For each tile: s = q k^T and dp = dO v^T (B the K or
//   V tile K-major), ds in registers, dq += ds k (B the K tile MN-major,
//   summed in the accumulator over the walk).
// The two consumer warpgroups take turns on the tensor cores (named
// barriers 1 and 2), as the forward's do: in its turn a warpgroup issues
// this tile's s (and dp) and the previous tile's register-A products as
// one group, waits for it and hands the turn over; its exponentials and
// splits then run while the other warpgroup's group does. (Handing the
// turn over before the wait let both groups queue back to back on the
// tensor cores, and both warpgroups then formed p and ds at once while
// the tensor cores idled: ~1900 cycles a tile a warpgroup against the
// group's ~360, clock64 marks of the study's timeline variant.) A warpgroup skips a tile that lies wholly above the diagonal of
// its own 64 rows (dK/dV: warpgroup 2's first 64 queries; dQ: warpgroup
// 1's last key tile) but still takes its turn and releases the tile's
// stage, so the turns and the ring's parities stay matched.
// Registers and sums, a measured decision. ptxas gives a thread of a
// 384-thread block 168 registers whatever setmaxnreg asks. A dK/dV
// consumer holds dk and dv (64 floats) for its whole walk and, in a
// turn's group, the previous tile's p^T and ds^T pairs and this tile's
// s^T and dp^T: 128 floats of arrays at BQ_W = 32 (the forward's
// budget), 192 at 64. Each tile's sum taken from zero and added in
// float32, as the float32 faces do (the accumulator truncates), needs a
// 32-float temporary beside them and a wait for each sum: that form
// spent ~2200 cycles a 32-query tile a warpgroup, three round trips to
// the tensor cores in series (0.146 ms at the LM step's shape on an
// H100). Summed straight in the accumulator, the bfloat16 gradients
// still meet the faces' gate on a walk of S 2048 (B 2, H 4; largest
// error over one ulp of its own magnitude plus 2e-5 of the largest: dq
// 0.980, dk 0.989, dv 0.988, against 0.980, 0.978, 0.977 with each tile
// from zero; tools/torch_flash_bwd_study.py), so dk, dv and dq stay in
// the accumulator and a tile takes one group and one wait.
constexpr int DW = 64;          // the head dim: one 128-byte swizzled row
constexpr int THREADS_W = 384;  // a producer warpgroup and two consumers
constexpr int RING_W = 4;       // stages of either kernel's ring
constexpr int BK_W = 128;       // dK/dV: keys a block, 64 a warpgroup
constexpr int BQ_W = 32;        // dK/dV: queries a streamed tile
constexpr int BM_W = 128;       // dQ: queries a block, 64 a warpgroup
constexpr int BN_W = 64;        // dQ: keys a streamed tile
constexpr int BOX_W = 64 * DW;  // values of a 64-row box
constexpr int QT_W = BQ_W * DW;  // of a dK/dV stage's q or dO tile
constexpr int KT_W = BN_W * DW;  // of a dQ stage's K or V tile
constexpr int LBOX_W = BQ_W + 4;  // lse or delta values a dK/dV stage loads
constexpr int LPAD_W = BQ_W + 32;  // and the floats it keeps for them
// the bytes a dK/dV stage loads: the q and dO tiles, lse and delta
constexpr int DKV_STAGE_BYTES_W =
    2 * QT_W * (int)sizeof(bf16) + 2 * LBOX_W * (int)sizeof(float);
// K and V of the block, the ring (lse and delta 128-byte aligned), and
// slack to align them to 1024 bytes
constexpr int DKV_SMEM_BYTES_W = 2 * BK_W * DW * (int)sizeof(bf16) +
                                 RING_W * 2 * QT_W * (int)sizeof(bf16) +
                                 RING_W * 2 * LPAD_W * (int)sizeof(float) +
                                 1024;
constexpr int DQ_STAGE_BYTES_W = 2 * KT_W * (int)sizeof(bf16);
// q and dO of the block, the ring, and the slack
constexpr int DQ_SMEM_BYTES_W =
    2 * BM_W * DW * (int)sizeof(bf16) + RING_W * DQ_STAGE_BYTES_W + 1024;
constexpr int PRODUCER_REGS_W = 40;
constexpr int CONSUMER_REGS_W = 232;
static_assert(RING_W >= 2, "a warpgroup waits for a stage before its turn");
static_assert(BQ_W % 16 == 0 && 64 % BQ_W == 0, "k16 steps; skipped tiles");
static_assert(BN_W == 64, "dQ's s and dp: m64n64");

// a lambda inlined at every call, so that the register arrays it takes by
// reference stay in registers
#define INLINE __attribute__((always_inline))

// 2^x on the special-function unit (outputs below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared memory from its first 1024-byte boundary (the 128-byte swizzle's
// period)
__device__ __forceinline__ bf16* align1024(uint8_t* raw) {
  return reinterpret_cast<bf16*>(raw +
                                ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// d (float32) of the accumulator elements of a 64 x 64 product: element i
// of a thread is row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2; `row` is the thread's first row
__device__ __forceinline__ void store_rows(bf16* out, const float (&d)[32],
                                           int row, int S, int H, int b,
                                           int h, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= S) continue;
    const size_t off = ((size_t)b * S + r) * H * DW + (size_t)h * DW + 2 * t;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c)
      store2(out + off + 8 * c, d[4 * c + 2 * half], d[4 * c + 2 * half + 1],
             true, true, true);
  }
}

__global__ void __launch_bounds__(THREADS_W, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap dmap,
                                const __grid_constant__ CUtensorMap lmap,
                                const __grid_constant__ CUtensorMap emap,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int S, int H, int causal, float scale) {
  constexpr int NS = BQ_W / 2;   // s^T and dp^T accumulator floats a thread
  constexpr int KS = BQ_W / 16;  // k16 steps of p^T dO and ds^T q
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kvfull, full[RING_W], empty[RING_W];
  bf16* ks = align1024(smem_raw);  // [BK_W][DW]
  bf16* vs = ks + BK_W * DW;       // [BK_W][DW]
  bf16* qs = vs + BK_W * DW;       // [RING_W][BQ_W][DW]
  bf16* os = qs + RING_W * QT_W;   // dO [RING_W][BQ_W][DW]
  // lse and delta [RING_W][LPAD_W]
  float* ls = reinterpret_cast<float*>(os + RING_W * QT_W);
  float* es = ls + RING_W * LPAD_W;

  // 0 the producer, 1 and 2 consumers, taken from lane 0 so that ptxas
  // knows it is the same across the warp (else it serialises every
  // wgmma of the kernel, C7518)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // block 0 has the longest causal walk, and is issued first
  const int k0 = blockIdx.y * BK_W;
  const int q_first = causal ? k0 : 0;
  const int n_tiles = (S - q_first + BQ_W - 1) / BQ_W;

  if (threadIdx.x == 0) {
    mbar_init(&kvfull, 1);
#pragma unroll
    for (int s = 0; s < RING_W; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS_W>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&dmap);
      tma_prefetch(&lmap);
      tma_prefetch(&emap);
      // the boxes of 64 keys that start before S (a box wholly past S
      // is not issued: its rows are keys no thread stores)
      const int boxes = min(BK_W, S - k0 + 63) / 64;
      mbar_expect_tx(&kvfull, boxes * 2 * BOX_W * (int)sizeof(bf16));
      for (int r = 0; r < boxes * 64; r += 64) {
        tma_load_3d(ks + r * DW, &kmap, &kvfull, h * DW, k0 + r, b);
        tma_load_3d(vs + r * DW, &vmap, &kvfull, h * DW, k0 + r, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % RING_W;
        const int q0 = q_first + it * BQ_W;
        mbar_wait(&empty[s], ((it / RING_W) & 1) ^ 1);
        mbar_expect_tx(&full[s], DKV_STAGE_BYTES_W);
        tma_load_3d(qs + s * QT_W, &qmap, &full[s], h * DW, q0, b);
        tma_load_3d(os + s * QT_W, &dmap, &full[s], h * DW, q0, b);
        const int c = (bh * S + q0) & ~3;  // 16-byte aligned
        tma_load_1d(ls + s * LPAD_W, &lmap, &full[s], c);
        tma_load_1d(es + s * LPAD_W, &emap, &full[s], c);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS_W>();
    const int wk = wg - 1;  // the warpgroup's keys: k0 + 64 wk ..
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int kw0 = k0 + 64 * wk;
    const int key = kw0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // + 8
    // the tiles before `first` lie wholly above the diagonal of the
    // warpgroup's keys
    const int first = causal ? 64 * wk / BQ_W : 0;
    float dka[32], dva[32], st[NS], dpt[NS];
    uint32_t ph[KS][4], pl[KS][4], dh[KS][4], dl[KS][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
    const float scale_log2 = scale * LOG2E;
    const uint32_t ka = smem_u32(ks + 64 * wk * DW);
    const uint32_t va = smem_u32(vs + 64 * wk * DW);
    mbar_wait(&kvfull, 0);

    // The products of a turn go out as one group and are waited for once,
    // each group's issue and wait on one straight path (C7518).
    // s^T = k q^T and dp^T = v dO^T of the tile in ring stage `s`
    auto s_products = [&](int s) INLINE {
      const uint32_t qa = smem_u32(qs + s * QT_W);
      const uint32_t oa = smem_u32(os + s * QT_W);
      wgmma_fence_operands(st);
      wgmma_fence_operands(dpt);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk)
        wgmma_bf16<BQ_W, 0>(st, desc_sw128(ka + 32 * kk, 16, 1024),
                            desc_sw128(qa + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk)
        wgmma_bf16<BQ_W, 0>(dpt, desc_sw128(va + 32 * kk, 16, 1024),
                            desc_sw128(oa + 32 * kk, 16, 1024), kk > 0);
    };
    // d += A Y over the tile's queries: A split in hi / lo, Y the tile `y`
    // ([query][d], MN-major)
    auto sum_into = [&](float(&d)[32], uint32_t(&hi)[KS][4],
                        uint32_t(&lo)[KS][4], const bf16* y) INLINE {
      const uint32_t ya = smem_u32(y);
      wgmma_fence_operands(d);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint64_t yd = desc_sw128(ya + 2048 * j, QT_W * 2, 1024);
        wgmma_m64n64k16_rs(d, hi[j], yd, true);
        wgmma_m64n64k16_rs(d, lo[j], yd, true);
      }
    };
    // dv += p^T dO and dk += ds^T q of the tile in stage `s`
    auto dkv_products = [&](int s) INLINE {
      sum_into(dva, ph, pl, os + s * QT_W);
      sum_into(dka, dh, dl, qs + s * QT_W);
    };
    // after a group's wait: the registers of its products pinned
    auto pin_s = [&]() INLINE {
      wgmma_fence_operands(st);
      wgmma_fence_operands(dpt);
    };
    auto pin_dkv = [&]() INLINE {
      wgmma_fence_operands(dka);
      wgmma_fence_operands(dva);
      wgmma_fence_operands(ph);
      wgmma_fence_operands(pl);
      wgmma_fence_operands(dh);
      wgmma_fence_operands(dl);
    };
    // p^T and ds^T of tile `it` in stage `s` (s^T and dp^T waited for),
    // split into the A fragments; element i: key `key` + 8 ((i / 2) % 2),
    // query q0 + 8 (i / 4) + 2 t + i % 2
    auto p_ds = [&](int it, int s) INLINE {
      const int q0 = q_first + it * BQ_W;
      const int at = (bh * S + q0) & 3;  // the tile's first entry in the box
      const float* lt = ls + s * LPAD_W + at;
      const float* et = es + s * LPAD_W + at;
      const bool masked = (causal && q0 < kw0 + 63) || q0 + BQ_W > S;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * j + 2 * r;
          const int qi = 16 * j + 8 * (r >> 1) + 2 * t;
          float p0 = ex2(fmaf(st[i], scale_log2, lt[qi] * -LOG2E));
          float p1 = ex2(fmaf(st[i + 1], scale_log2, lt[qi + 1] * -LOG2E));
          float d0 = p0 * (dpt[i] - et[qi]) * scale;
          float d1 = p1 * (dpt[i + 1] - et[qi + 1]) * scale;
          if (masked) {
            // selects, not branches; past S, lse and delta are another
            // head's, and any value they give is dropped
            const int kr = key + 8 * (r & 1);
            const int qp = q0 + qi;
            const bool out0 = qp >= S || (causal && kr > qp);
            const bool out1 = qp + 1 >= S || (causal && kr > qp + 1);
            p0 = out0 ? 0.f : p0;
            d0 = out0 ? 0.f : d0;
            p1 = out1 ? 0.f : p1;
            d1 = out1 ? 0.f : d1;
          }
          split_bf16(p0, p1, ph[j][r], pl[j][r]);
          split_bf16(d0, d1, dh[j][r], dl[j][r]);
        }
      }
    };

    // The turns: warpgroup 1 waits on barrier 1, warpgroup 2 on barrier
    // 2, each hands the turn to the other once its group is done;
    // warpgroup 1 goes first. Turn it: s^T and dp^T of tile it and the dv
    // and dk of tile it - 1, one group; p^T and ds^T of tile it run under
    // the other's group.
    const int mine = 1 + wk, other = 2 - wk;
    if (wk == 1) bar_arrive(1, 256);
    const int n_first = min(first, n_tiles);
    for (int it = 0; it < n_first; ++it) {  // above the diagonal
      const int s = it % RING_W;
      mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      mbar_arrive(&empty[s]);  // released unread
      bar_arrive(other, 256);
    }
    for (int it = n_first; it < n_tiles; ++it) {
      const int s = it % RING_W;
      mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > first) {
        wgmma_fence();
        s_products(s);
        dkv_products((it - 1) % RING_W);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
        pin_dkv();
        mbar_arrive(&empty[(it - 1) % RING_W]);
      } else {
        wgmma_fence();
        s_products(s);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
      }
      p_ds(it, s);
    }
    // the last tile's dv and dk, in a turn of their own; every turn of
    // warpgroup 1 meets one of warpgroup 2, whose last hands nothing on
    bar_sync(mine, 256);
    if (n_tiles > first) {
      wgmma_fence();
      dkv_products((n_tiles - 1) % RING_W);
      wgmma_commit();
      wgmma_wait<0>();
      pin_dkv();
      mbar_arrive(&empty[(n_tiles - 1) % RING_W]);
    }
    if (wk == 0) bar_arrive(other, 256);
    store_rows(dk, dka, key, S, H, b, h, t);
    store_rows(dv, dva, key, S, H, b, h, t);
  }
}

__global__ void __launch_bounds__(THREADS_W, 1)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap dmap,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dq, int S, int H,
                               int causal, float scale) {
  constexpr int KS = BN_W / 16;  // k16 steps of ds k
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qfull, full[RING_W], empty[RING_W];
  bf16* qs = align1024(smem_raw);  // [BM_W][DW]
  bf16* os = qs + BM_W * DW;       // dO [BM_W][DW]
  bf16* ks = os + BM_W * DW;       // [RING_W][BN_W][DW]
  bf16* vs = ks + RING_W * KT_W;   // [RING_W][BN_W][DW]

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // the last query tile first: the longest causal walks start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM_W;
  const int k_end = causal ? min(S, q0 + BM_W) : S;
  const int n_tiles = (k_end + BN_W - 1) / BN_W;

  if (threadIdx.x == 0) {
    mbar_init(&qfull, 1);
#pragma unroll
    for (int s = 0; s < RING_W; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS_W>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&dmap);
      // the boxes of 64 queries that start before S
      const int boxes = min(BM_W, S - q0 + 63) / 64;
      mbar_expect_tx(&qfull, boxes * 2 * BOX_W * (int)sizeof(bf16));
      for (int r = 0; r < boxes * 64; r += 64) {
        tma_load_3d(qs + r * DW, &qmap, &qfull, h * DW, q0 + r, b);
        tma_load_3d(os + r * DW, &dmap, &qfull, h * DW, q0 + r, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % RING_W;
        mbar_wait(&empty[s], ((it / RING_W) & 1) ^ 1);
        mbar_expect_tx(&full[s], DQ_STAGE_BYTES_W);
        tma_load_3d(ks + s * KT_W, &kmap, &full[s], h * DW, it * BN_W, b);
        tma_load_3d(vs + s * KT_W, &vmap, &full[s], h * DW, it * BN_W, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS_W>();
    const int wq = wg - 1;  // the warpgroup's queries: q0 + 64 wq ..
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int rw0 = q0 + 64 * wq;
    const int row = rw0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // + 8
    // the tiles from `last` on lie wholly above the diagonal of the
    // warpgroup's queries
    const int last = causal ? min(n_tiles, rw0 / BN_W + 1) : n_tiles;
    // the thread's two rows' lse (base 2) and delta
    float l2[2], dl[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      const size_t off = (size_t)bh * S + r;
      l2[half] = r < S ? lse[off] * LOG2E : 0.f;
      dl[half] = r < S ? delta[off] : 0.f;
    }
    float dqa[32], sc[32], dp[32];
    uint32_t dsh[KS][4], dsl[KS][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = sc[i] = dp[i] = 0.f;
    const float scale_log2 = scale * LOG2E;
    const uint32_t qa = smem_u32(qs + 64 * wq * DW);
    const uint32_t oa = smem_u32(os + 64 * wq * DW);
    mbar_wait(&qfull, 0);

    // s = q k^T and dp = dO v^T of the tile in ring stage `s`
    auto s_products = [&](int s) INLINE {
      const uint32_t kt = smem_u32(ks + s * KT_W);
      const uint32_t vt = smem_u32(vs + s * KT_W);
      wgmma_fence_operands(sc);
      wgmma_fence_operands(dp);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk)
        wgmma_bf16<BN_W, 0>(sc, desc_sw128(qa + 32 * kk, 16, 1024),
                            desc_sw128(kt + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk)
        wgmma_bf16<BN_W, 0>(dp, desc_sw128(oa + 32 * kk, 16, 1024),
                            desc_sw128(vt + 32 * kk, 16, 1024), kk > 0);
    };
    // dq += ds k over the tile's keys in stage `s` (K MN-major)
    auto dq_products = [&](int s) INLINE {
      const uint32_t kt = smem_u32(ks + s * KT_W);
      wgmma_fence_operands(dqa);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint64_t kd = desc_sw128(kt + 2048 * j, KT_W * 2, 1024);
        wgmma_m64n64k16_rs(dqa, dsh[j], kd, true);
        wgmma_m64n64k16_rs(dqa, dsl[j], kd, true);
      }
    };
    auto pin_s = [&]() INLINE {
      wgmma_fence_operands(sc);
      wgmma_fence_operands(dp);
    };
    auto pin_dq = [&]() INLINE {
      wgmma_fence_operands(dqa);
      wgmma_fence_operands(dsh);
      wgmma_fence_operands(dsl);
    };
    // ds of tile `it` (s and dp waited for), split into the A fragments;
    // element i: query `row` + 8 ((i / 2) % 2), key kt0 + 8 (i / 4) + 2 t
    // + i % 2
    auto ds_pairs = [&](int it) INLINE {
      const int kt0 = it * BN_W;
      const bool masked = (causal && kt0 + BN_W - 1 > rw0) || kt0 + BN_W > S;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * j + 2 * r;
          const int half = r & 1;
          const float p0 = ex2(fmaf(sc[i], scale_log2, -l2[half]));
          const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -l2[half]));
          float d0 = p0 * (dp[i] - dl[half]) * scale;
          float d1 = p1 * (dp[i + 1] - dl[half]) * scale;
          if (masked) {
            const int kp = kt0 + 16 * j + 8 * (r >> 1) + 2 * t;
            const int rr = row + 8 * half;
            d0 = kp >= S || (causal && kp > rr) ? 0.f : d0;
            d1 = kp + 1 >= S || (causal && kp + 1 > rr) ? 0.f : d1;
          }
          split_bf16(d0, d1, dsh[j][r], dsl[j][r]);
        }
      }
    };

    // The turns, as the dK/dV kernel's: turn it takes s and dp of tile it
    // and dq of tile it - 1, one group.
    const int mine = 1 + wq, other = 2 - wq;
    if (wq == 1) bar_arrive(1, 256);
    for (int it = 0; it < last; ++it) {
      const int s = it % RING_W;
      mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > 0) {
        wgmma_fence();
        s_products(s);
        dq_products((it - 1) % RING_W);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
        pin_dq();
        mbar_arrive(&empty[(it - 1) % RING_W]);
      } else {
        wgmma_fence();
        s_products(s);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
      }
      ds_pairs(it);
    }
    // the tiles from `last` on (above the diagonal) and the final turn:
    // tile last - 1's dq in the first of them
    for (int it = last; it <= n_tiles; ++it) {
      const int s = it % RING_W;
      if (it < n_tiles) mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it == last) {
        wgmma_fence();
        dq_products((it - 1) % RING_W);
        wgmma_commit();
        wgmma_wait<0>();
        pin_dq();
        mbar_arrive(&empty[(it - 1) % RING_W]);
      }
      if (it < n_tiles) {
        mbar_arrive(&empty[s]);  // released unread
        bar_arrive(other, 256);
      } else if (wq == 0) {
        bar_arrive(other, 256);
      }
    }
    store_rows(dq, dqa, row, S, H, b, h, t);
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

struct ArgsB {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  int B, S, H, causal;
  float scale;
  cudaStream_t stream;
};

ArgsB make_args_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     int B, int S, int H, int causal, float scale,
                     void* stream) {
  return ArgsB{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, S, H, causal, scale,
               static_cast<cudaStream_t>(stream)};
}

template <int D>
int launch_dkv_bf16(const ArgsB& a, bf16* dk, bf16* dv) {
  constexpr int smem = dkv_bf16_mma_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_bf16_mma_kernel<D>;
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
int launch_dq_bf16(const ArgsB& a, bf16* dq) {
  constexpr int smem = dq_bf16_mma_smem_bytes<D>();
  auto kernel = flash_bwd_dq_bf16_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.S + BR - 1) / BR);
  kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                            a.delta, dq, a.S, a.H, a.causal,
                                            a.scale);
  return (int)cudaGetLastError();
}

// q, k, v and dO [B, S, H, 64] as 3-D maps {H 64, S, B} in boxes of 64
// values by `rows` rows
int encode_heads(CUtensorMap* map, const bf16* x, const ArgsB& a,
                 uint32_t rows) {
  return encode_tma_3d(map, x, (uint64_t)a.H * DW, a.S, a.B, DW, rows);
}

int launch_dkv_bf16_wgmma(const ArgsB& a, bf16* dk, bf16* dv) {
  CUtensorMap qmap, kmap, vmap, dmap, lmap, emap;
  const uint64_t n = (uint64_t)a.B * a.H * a.S;
  int code = encode_heads(&qmap, a.q, a, BQ_W);
  if (!code) code = encode_heads(&kmap, a.k, a, 64);
  if (!code) code = encode_heads(&vmap, a.v, a, 64);
  if (!code) code = encode_heads(&dmap, a.dout, a, BQ_W);
  if (!code) code = encode_tma_1d_f32(&lmap, a.lse, n, LBOX_W);
  if (!code) code = encode_tma_1d_f32(&emap, a.delta, n, LBOX_W);
  if (code) return code;
  auto kernel = flash_bwd_dkv_bf16_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM_BYTES_W);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.S + BK_W - 1) / BK_W);
  kernel<<<grid, THREADS_W, DKV_SMEM_BYTES_W, a.stream>>>(
      qmap, kmap, vmap, dmap, lmap, emap, dk, dv, a.S, a.H, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

int launch_dq_bf16_wgmma(const ArgsB& a, bf16* dq) {
  CUtensorMap qmap, kmap, vmap, dmap;
  int code = encode_heads(&qmap, a.q, a, 64);
  if (!code) code = encode_heads(&kmap, a.k, a, BN_W);
  if (!code) code = encode_heads(&vmap, a.v, a, BN_W);
  if (!code) code = encode_heads(&dmap, a.dout, a, 64);
  if (code) return code;
  auto kernel = flash_bwd_dq_bf16_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM_BYTES_W);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.S + BM_W - 1) / BM_W);
  kernel<<<grid, THREADS_W, DQ_SMEM_BYTES_W, a.stream>>>(
      qmap, kmap, vmap, dmap, a.lse, a.delta, dq, a.S, a.H, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

// The path of the bfloat16 faces by head dim: the wgmma kernels at D 64,
// the mma.sync kernels at D 32 and 128.
bool wgmma_path(int D) { return D == DW; }

// the bfloat16 entry points' checks and casts; `mma` forces the mma.sync
// kernel, else the path of D. The wgmma dK/dV kernel also reads lse and
// delta through TMA, which wants them 16-byte aligned.
int bwd_dkv_bf16(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int B, int S, int H, int D, int causal,
                 float scale, void* stream, bool mma) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  const ArgsB a = make_args_bf16(q, k, v, dout, lse, delta, B, S, H, causal,
                                 scale, stream);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  if (!mma && wgmma_path(D)) {
    if (!aligned16(lse) || !aligned16(delta))
      return (int)cudaErrorMisalignedAddress;
    return launch_dkv_bf16_wgmma(a, dkb, dvb);
  }
  switch (D) {
    case 32: return launch_dkv_bf16<32>(a, dkb, dvb);
    case 64: return launch_dkv_bf16<64>(a, dkb, dvb);
    case 128: return launch_dkv_bf16<128>(a, dkb, dvb);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_dq_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int S, int H, int D, int causal, float scale,
                void* stream, bool mma) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return (int)cudaErrorMisalignedAddress;
  const ArgsB a = make_args_bf16(q, k, v, dout, lse, delta, B, S, H, causal,
                                 scale, stream);
  bf16* dqb = static_cast<bf16*>(dq);
  if (!mma && wgmma_path(D)) return launch_dq_bf16_wgmma(a, dqb);
  switch (D) {
    case 32: return launch_dq_bf16<32>(a, dqb);
    case 64: return launch_dq_bf16<64>(a, dqb);
    case 128: return launch_dq_bf16<128>(a, dqb);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The same on bfloat16 q, k, v, dout, dk and dv; lse and delta float32
// (16-byte aligned at D 64). D 64 runs the wgmma kernel, D 32 and 128 the
// mma.sync kernel (the path is picked by D before the launch).
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int S, int H, int D, int causal, float scale,
                                 void* stream) {
  return bwd_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, B, S, H, D, causal,
                      scale, stream, false);
}

// The same inputs, bfloat16; dq [B, S, H, D] bfloat16.
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int S,
                                int H, int D, int causal, float scale,
                                void* stream) {
  return bwd_dq_bf16(q, k, v, dout, lse, delta, dq, B, S, H, D, causal, scale,
                     stream, false);
}

// The same two on the mma.sync kernels at any of their head dims: the
// faces' design before their wgmma kernels, timed beside them.
int flash_attention_bwd_dkv_bf16_mma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int S, int H,
                                     int D, int causal, float scale,
                                     void* stream) {
  return bwd_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, B, S, H, D, causal,
                      scale, stream, true);
}

int flash_attention_bwd_dq_bf16_mma(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int S, int H, int D,
                                    int causal, float scale, void* stream) {
  return bwd_dq_bf16(q, k, v, dout, lse, delta, dq, B, S, H, D, causal, scale,
                     stream, true);
}

// The path the bfloat16 entry points take at head dim D: 1 the wgmma
// kernels, 0 the mma.sync kernels, -1 none.
int flash_attention_bwd_bf16_path(int D) {
  if (D != 32 && D != 64 && D != 128) return -1;
  return wgmma_path(D) ? 1 : 0;
}

// Dynamic shared memory a block of either kernel takes at head dim D
// (0 for a D without a kernel): which 0 is dK/dV, 1 dQ; face 0 the
// float32 kernels', 1 the bfloat16 face's on the path of D, 2 the
// bfloat16 mma.sync kernels'.
int flash_attention_bwd_smem_bytes(int D, int which, int face) {
  if (face == 1 && wgmma_path(D)) return which ? DQ_SMEM_BYTES_W
                                               : DKV_SMEM_BYTES_W;
  if (face != 0) {
    switch (D) {
      case 32: return which ? dq_bf16_mma_smem_bytes<32>()
                            : dkv_bf16_mma_smem_bytes<32>();
      case 64: return which ? dq_bf16_mma_smem_bytes<64>()
                            : dkv_bf16_mma_smem_bytes<64>();
      case 128: return which ? dq_bf16_mma_smem_bytes<128>()
                             : dkv_bf16_mma_smem_bytes<128>();
      default: return 0;
    }
  }
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
