// Flash attention forward on Hopper's tensor cores, float32-exact through
// 3xTF32, for sm_90a, with a bfloat16 face.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, `_fa_forward` (its
// pallas_call) with the kernel body `_fa_kernel`, reached through
// `flash_attention_with_lse`. It computes o = softmax(q k^T * scale) v,
// causal or not, and the per-row logsumexp lse = m + log(den) with the
// denominator floored at 1e-20, as the TPU kernel does.
//
// What bounds it on the H100: operations. A causal head of length S has
// S * (S + 1) / 2 (query, key) pairs that attend, each 4 * D flops (q.k
// and p.v), on 4 * S * D * 4 bytes of q, k, v and o. Every product runs
// on the tensor cores in 3xTF32, three TF32 products for each float32
// one, so the least time is 3 * flops over the card's 495 TFLOP/s dense
// TF32: 0.0098 ms at the prefill's shape (B 1, S 1024, H 12, D 64,
// causal) and 0.078 ms at the LM step's (B 8); the bytes take a tenth of
// that.
//
// Design.
// - 3xTF32 (tf32x3.cuh): each float32 operand is split into a TF32 hi and
//   a lo part, and a * b is taken as lo(a) hi(b) + hi(a) lo(b) + hi(a)
//   hi(b) on mma.sync.m16n8k8, rounded by hand (add, mask, subtract) as
//   the fragments are loaded.
// - Tiles. The TPU kernel holds a head's whole K and V in VMEM; here a
//   block of 4 warps owns 64 query rows of one (batch, head), 16 a warp,
//   and streams K and V through shared memory in tiles of BN = 32 rows.
//   A warp's q rows are read once, straight from device memory into
//   registers, and split once into the A fragments of every 8-wide step
//   of the head dim; they stay there for the whole walk. At D 128 that
//   would spill, so there the block's q waits in shared memory and its
//   fragments are loaded and split on every tile, as K's are.
// - s = q k^T on the tensor cores, K's B fragments read transposed
//   (load_b_t). The causal mask and the ragged end of S are applied in
//   registers, and only on the tiles that the diagonal or the end cuts; a
//   warp whose rows all precede a diagonal tile skips it.
// - Online softmax on the C fragments. A row lives in one quad of 4
//   lanes, so a tile's row maximum takes 2 shuffles; the row sum is kept
//   in parts, one a lane, and gathered once at the end. Scores are taken
//   in base 2 (scale * log2 e folded into one multiply, exp2f), and lse is
//   brought back to natural logarithms at the end.
// - o += p v. The C fragment of s holds columns 2t and 2t + 1 where an A
//   fragment wants t and t + 4, so p goes straight from registers into
//   the A operand with the k columns of each step taken in the order 0,
//   2, 4, 6, 1, 3, 5, 7 (a_of_c), and V's B rows read in the same order
//   (load_b_perm): no shuffle and no trip through shared memory.
// - Accumulation. The tensor cores truncate as they accumulate, so each
//   tile's p v is summed from zero on the tensor cores and added in
//   float32 to the rescaled accumulator (acc = acc * alpha + tile). Within
//   a tile, the large products (hi hi) and the two small ones of each
//   3xTF32 product run in separate accumulators (mma3_apart), joined in
//   float32 once a tile: a third as many truncating adds land on the
//   large sum, and the errors against a float64 forward fall by about
//   half, for a time that stays within the spread between runs
//   (tools/torch_flash_bwd_study.py --kernel fwd, variant one_chain).
// - Copies. K and V tiles come by 16-byte cp.async, double buffered: the
//   next tile is in flight while the tensor cores work on the current one.
//   Rows sit D + 4 floats apart, so each fragment load puts the 32 lanes
//   on 32 distinct banks; rows past S are zero-filled. Dynamic shared
//   memory (18 to 99 KB a block) is raised with cudaFuncSetAttribute; its
//   error comes back through the entry point's return code.
// - Causal blocks are issued last query tile first, the longest walks
//   first. Determinism: no atomics, each output written once by one
//   thread after sums in a fixed order, so relaunches agree bit for bit.
//
// The bfloat16 face (flash_attention_fwd_bf16, pure AMP: the q / k / v
// projections keep their outputs in bfloat16): `_fa_kernel` on bfloat16
// refs, all arithmetic float32 on the bfloat16 values (p kept float32, as
// the JAX kernel keeps it) and o rounded once to bfloat16.
// - What bounds it. The bytes: 4 * S * D * 2 a head over 3.35 TB/s,
//   0.0151 ms at the LM step's shape (B 8, S 1024, H 12, D 64, causal),
//   the bound the tables quote. The work sets a higher floor. In 128 x
//   128 tiles a causal head takes 36 tiles; each is one q k^T product and
//   p v taken twice (p as a bfloat16 hi and lo), about 6.3 MFLOP, 21.7
//   GFLOP a call at that shape: 0.022 ms at 989 TFLOP/s dense bf16. The
//   same tiles hold 56.6 M scores, whose exponentials take about 0.0145 ms
//   at the special-function units' ~3.9 T a second (FlashAttention-3's
//   figure), and each score costs about six more float32 instructions
//   (scale, max, row sum, the hi / lo split). Only a kernel that runs one
//   tile's exponentials while the tensor cores work on another can come
//   near either floor.
// - Design at D 64, the head dim of every main path: a TMA-fed,
//   warp-specialised wgmma kernel (flash_fwd_bf16_wgmma_kernel, on
//   hopper.cuh; see there): 128 query rows a block, one producer warp and
//   two consumer warpgroups that take turns on the tensor cores, so one
//   warpgroup's softmax runs under the other's products; 128-key tiles
//   through a ring of four stages; q k^T with B the K tile K-major, p v
//   with A from registers. The design before it: mma.sync, 32-key
//   tiles, two __syncthreads and a cp.async group a tile issued by every
//   thread, K's B fragments by 32-bit shared loads, softmax and products
//   in series in each warp.
// - What holds it now (tools/torch_flash_bwd_study.py --kernel fwd,
//   variant timeline: clock64 marks): a warpgroup spends about 1600
//   cycles a tile on its softmax against about 1000 waiting for its own
//   products, and never waits for its turn, so the tensor cores idle
//   about half of each period. Hiding the softmax under the warpgroup's
//   own products (variant intra_wg) holds the next tile's s beside this
//   tile's p, about 217 registers a thread, past the 168 ptxas gives a
//   thread of a 384-thread block whatever setmaxnreg asks: it spills.
// - D 32 (a 64-byte row, another swizzle) and D 128 (two boxes a row, and
//   more accumulator than the registers hold at 128-key tiles) keep that
//   mma.sync kernel (flash_fwd_bf16_mma_kernel): the float32 kernel's
//   walk, tiles, causal skip and double buffer on bfloat16 tiles, q k^T
//   on bf16 mma.sync.m16n8k16, p split into two bfloat16 terms against V.
//   The entry point picks the path by D before the launch.

// Tensors are [B, S, H, D], contiguous, 16-byte aligned: the layout the
// prefill's projections produce, so no transpose is needed. lse is
// [B, H, S], float32 on both faces. The kernels allocate nothing. The
// entry points launch on the stream they are given and return a CUDA
// error code (0 on success).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // query rows a block owns: 16 a warp
constexpr int BN = 32;          // key rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// q's A fragments are split once, into registers, for the whole walk where
// the registers allow it. At D 128 the split fragments (128 registers a
// lane) beside the output accumulator (64) and the tile's p (32) spill, so
// there the block's q waits in shared memory and each tile loads and
// splits its fragments again. (q kept in registers as floats and split at
// each use is no cure: the compiler hoists the split out of the walk.)
template <int D>
constexpr bool Q_IN_REGS = D < 128;

template <int D>
constexpr int fwd_smem_bytes() {
  // K and V, two buffers each, and at D 128 the block's q
  return (4 * BN + (Q_IN_REGS<D> ? 0 : BR)) * (D + 4) * 4;
}

// One block: 64 query rows [q0, q0 + 64) of one (batch, head). Warp w
// holds q, the output accumulator and the softmax state of queries q0 +
// 16 w .. + 15 in registers and walks the key tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int causal,
                 float scale) {
  constexpr int LD = D + 4;
  constexpr int NT = BN / 8;  // 8-key steps of a tile
  constexpr int DT = D / 8;   // 8-wide steps of the head dim
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // [2][BN][LD]
  float* vs = ks + 2 * BN * LD;  // [2][BN][LD]
  float* qs = vs + 2 * BN * LD;  // [BR][LD], where q is not in registers

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
  constexpr bool QREG = Q_IN_REGS<D>;
  if constexpr (!QREG) copy_rows<D, BR, THREADS>(qs, q + head, q0, S, stride);
  copy_tile(0);
  cp_async_commit();

  // this thread's two query rows, and the warp's q split once into A
  // fragments (a 16 x 8 A fragment holds row g, column t; row g + 8,
  // column t; then both at column t + 4), straight from device memory
  const int w0 = q0 + warp * 16;
  const int row = w0 + g;  // and row + 8
  FragA qa[QREG ? DT : 1];
  if constexpr (QREG) {
    const float* r0 = q + head + (size_t)min(row, S - 1) * stride;
    const float* r1 = q + head + (size_t)min(row + 8, S - 1) * stride;
    const bool in0 = row < S, in1 = row + 8 < S;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const int c = kk * 8 + t;
      const float x[4] = {in0 ? r0[c] : 0.f, in1 ? r1[c] : 0.f,
                          in0 ? r0[c + 4] : 0.f, in1 ? r1[c + 4] : 0.f};
      qa[kk] = split_a(x);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  // per row half: the running maximum of the base-2 scores, and this
  // lane's part of the denominator
  float m[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    // a warp whose 16 rows all precede the tile adds nothing to them
    if (!causal || kt0 <= w0 + 15) {
      const float* kt = ks + (it & 1) * BN * LD;
      const float* vt = vs + (it & 1) * BN * LD;

      // s = q k^T: 16 queries x BN keys a warp, the large products and
      // the small ones summed in separate chains and joined once
      float s[NT][4], sl[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = sl[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        FragA a;
        if constexpr (QREG)
          a = qa[kk];
        else
          a = load_a<LD>(qs + warp * 16 * LD + kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3_apart(s[n], sl[n], a,
                     load_b_t<LD>(kt + n * 8 * LD + kk * 8, g, t));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) add4(s[n], sl[n]);

      // base-2 scores, masked pairs at -inf, and each row's maximum;
      // element i of a C fragment is query row g + 8 (i / 2), key column
      // 2 t + i % 2
      const bool masked = (causal && kt0 + BN - 1 > w0) || kt0 + BN > S;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[n][i] * scale_log2;
          if (masked) {
            const int kpos = kt0 + n * 8 + 2 * t + (i & 1);
            if (kpos >= S || (causal && kpos > row + 8 * (i >> 1)))
              x = -INFINITY;
          }
          s[n][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = mx[half];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[half], x);
        // a row with every column so far masked has nothing to rescale
        m_use[half] = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = exp2f(m[half] - m_use[half]);
        m[half] = m_new;
        den[half] *= alpha[half];
      }

      // p in place, then into A fragments
      FragA pa[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(s[n][i] - m_use[i >> 1]);
          den[i >> 1] += p;
          s[n][i] = p;
        }
        pa[n] = a_of_c(s[n]);
      }

      // o = o * alpha + p v, the tile's sum taken from zero on the tensor
      // cores (in two chains, as s) and added in float32
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3_apart(c, cl, pa[n],
                     load_b_perm<LD>(vt + n * 8 * LD + dn * 8, g, t));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[dn][i] = fmaf(acc[dn][i], alpha[i >> 1], c[i] + cl[i]);
      }
    }
    __syncthreads();  // the tile's buffer is refilled next iteration
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float d = den[half];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const int r = row + 8 * half;
    if (r >= S) continue;
    const float den_safe = fmaxf(d, 1e-20f);
    const size_t off = head + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(o + off + dn * 8) =
          make_float2(acc[dn][2 * half] / den_safe,
                      acc[dn][2 * half + 1] / den_safe);
    if (t == 0)
      lse[(size_t)bh * S + r] = m[half] * LN2 + logf(den_safe);
  }
}

// -- the bfloat16 face: mma.sync (D 32 and 128) ------------------------------
//
// q, k, v and o bfloat16, lse float32: `_fa_kernel` on bfloat16 refs, which
// casts its tiles to float32, computes in float32 and writes o once in
// q's dtype. The float32 kernel's walk, tiles, causal skip and double
// buffer, on tiles of [BN][D + 8] bfloat16 (a 16-byte cp.async moves 8
// values; rows 16 bytes + D * 2 apart put the 32-bit fragment loads of a
// warp on 32 distinct banks and keep every row 16-byte aligned for
// ldmatrix). q k^T takes one bf16 mma.sync.m16n8k16 a 16-wide step of the
// head dim (bfloat16 products are exact in float32), q's A fragments held
// in registers for the whole walk at every D (D / 4 registers), K's B
// fragments read straight from its rows. p stays float32, as the JAX
// kernel keeps it: two C fragments of p are split into a bfloat16 hi and
// lo (bf16.cuh) and taken against V in two mmas, V's B fragments by
// ldmatrix.trans (its k index, the key, runs along the tile's rows). Each
// tile's p v is summed from zero on the tensor cores and added in float32
// to the rescaled accumulator; o is rounded once to bfloat16 (to nearest
// even).
template <int D>
constexpr int fwd_bf16_mma_smem_bytes() {
  return 4 * BN * (D + 8) * (int)sizeof(bf16);  // K and V, two buffers each
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int causal,
                          float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;   // 8-key column tiles of s
  constexpr int KT = BN / 16;  // 16-key steps of p v
  constexpr int DK = D / 16;   // 16-wide steps of the head dim in q k^T
  constexpr int DT = D / 8;    // 8-wide column tiles of o
  extern __shared__ __align__(16) float smem_f[];
  bf16* ks = reinterpret_cast<bf16*>(smem_f);  // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;                 // [2][BN][LD]

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
    copy_rows_bf16<D, BN, THREADS>(ks + buf * BN * LD, k + head, it * BN, S,
                                   stride);
    copy_rows_bf16<D, BN, THREADS>(vs + buf * BN * LD, v + head, it * BN, S,
                                   stride);
  };
  copy_tile(0);
  cp_async_commit();

  // the warp's q as the A fragments of every k16 step, straight from
  // device memory: row g, columns 2 t, 2 t + 1; row g + 8; both at + 8
  const int w0 = q0 + warp * 16;
  const int row = w0 + g;  // and row + 8
  uint32_t qa[DK][4];
  {
    const bf16* r0 = q + head + (size_t)min(row, S - 1) * stride;
    const bf16* r1 = q + head + (size_t)min(row + 8, S - 1) * stride;
    const bool in0 = row < S, in1 = row + 8 < S;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = in0 ? ld32(r0 + c) : 0u;
      qa[kk][1] = in1 ? ld32(r1 + c) : 0u;
      qa[kk][2] = in0 ? ld32(r0 + c + 8) : 0u;
      qa[kk][3] = in1 ? ld32(r1 + c + 8) : 0u;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * BN;
    if (it + 1 < n_tiles) copy_tile(it + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    if (!causal || kt0 <= w0 + 15) {
      const bf16* kt = ks + (it & 1) * BN * LD;
      const bf16* vt = vs + (it & 1) * BN * LD;

      // s = q k^T: 16 queries x BN keys a warp
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t kb[2];
          load_b16_t<LD>(kb, kt + n * 8 * LD + kk * 16, g, t);
          mma_bf16_k16(s[n], qa[kk], kb);
        }
      }

      const bool masked = (causal && kt0 + BN - 1 > w0) || kt0 + BN > S;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[n][i] * scale_log2;
          if (masked) {
            const int kpos = kt0 + n * 8 + 2 * t + (i & 1);
            if (kpos >= S || (causal && kpos > row + 8 * (i >> 1)))
              x = -INFINITY;
          }
          s[n][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = mx[half];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[half], x);
        m_use[half] = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = exp2f(m[half] - m_use[half]);
        m[half] = m_new;
        den[half] *= alpha[half];
      }

      // p in place (float32), then split into the A fragments of p v
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(s[n][i] - m_use[i >> 1]);
          den[i >> 1] += p;
          s[n][i] = p;
        }
      }
      FragA16 pa[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) pa[j] = a_of_c2(s[2 * j], s[2 * j + 1]);

      // o = o * alpha + p v, the tile's sum taken from zero on the tensor
      // cores and added in float32
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t vb[2];
          load_b16<LD>(vb, vt + j * 16 * LD + dn * 8, lane);
          mma_split(pv, pa[j], vb);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[dn][i] = fmaf(acc[dn][i], alpha[i >> 1], pv[i]);
      }
    }
    __syncthreads();  // the tile's buffer is refilled next iteration
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float d = den[half];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const int r = row + 8 * half;
    if (r >= S) continue;
    const float den_safe = fmaxf(d, 1e-20f);
    const size_t off = head + (size_t)r * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      store2(o + off + dn * 8, acc[dn][2 * half] / den_safe,
             acc[dn][2 * half + 1] / den_safe, true, true, true);
    if (t == 0)
      lse[(size_t)bh * S + r] = m[half] * LN2 + logf(den_safe);
  }
}

// -- the bfloat16 face at D 64: TMA + wgmma ---------------------------------
//
// The same function as flash_fwd_bf16_mma_kernel, for the head dim GPT-2
// small and every main path run: D 64, one 128-byte swizzled row of
// bfloat16. A block owns BM_W = 128 query rows of one (batch, head):
// warpgroup 0 is the producer (one thread issues TMA), warpgroups 1 and 2
// the consumers, 64 rows each. q, k and v are 3-D maps {H D, S, B}
// loaded in boxes of 64 values by BM_W or BN_W rows at (h D, row, b):
// rows past S arrive as zeros and no box reads the next batch's rows. q
// lands once; K and V tiles of BN_W keys come through a ring of RING_W
// stages (a full and an empty mbarrier a stage). For each tile a
// consumer warpgroup takes
// - s = q k^T on wgmma m64n128k16, A q from shared memory, B the K tile
//   as it lands ([key][d], K-major: imm-trans-b 0), four k16 steps;
// - the online softmax in registers on the accumulator (a row lives in
//   one quad: two shuffles for its maximum), masked only on the tiles
//   that the diagonal or the end of S cuts, scale * log2 e and the
//   running maximum folded into one FFMA before ex2;
// - p v on wgmma m64n64k16 with A from registers: p, float32, split into
//   a bfloat16 hi and lo pair by pair (bf16.cuh), each taken against the
//   V tile as it lands ([key][d], MN-major: imm-trans-b 1); the
//   accumulator's elements 8j .. 8j + 7 are the A fragment of k16 step j
//   as they lie. The tile's p v is summed from zero (scale-d 0 on its
//   first product) and added in float32 to the rescaled accumulator.
// The two consumer warpgroups take turns on the tensor cores (named
// barriers 1 and 2): in its turn a warpgroup issues the previous tile's
// p v, waits for it (p's 64 registers are then free), issues this
// tile's q k^T and hands the turn over; its softmax then runs while the
// other warpgroup's products do (FlashAttention-3's ping-pong). Holding
// the next tile's s beside this tile's p instead (the overlap within one
// warpgroup) would want 64 + 64 + 32 + 32 accumulator registers, past
// the 168 that ptxas gives a thread of a 384-thread block.
constexpr int BM_W = 128;    // query rows a block: two warpgroups of 64
constexpr int BN_W = 128;    // key rows a tile
constexpr int DW = 64;       // the head dim: one 128-byte swizzled row
constexpr int RING_W = 4;    // K / V stages of the ring
constexpr int THREADS_W = 384;  // a producer warpgroup and two consumers
constexpr int Q_TILE_W = BM_W * DW;  // values of the q box
constexpr int KV_TILE_W = BN_W * DW;  // of a K or a V box
constexpr int STAGE_BYTES_W = 2 * KV_TILE_W * (int)sizeof(bf16);
// q, the ring, and slack to align them to the swizzle's 1024 bytes
constexpr int SMEM_BYTES_W =
    Q_TILE_W * (int)sizeof(bf16) + RING_W * STAGE_BYTES_W + 1024;
constexpr int PRODUCER_REGS_W = 40;
constexpr int CONSUMER_REGS_W = 232;
static_assert(RING_W >= 2, "a warpgroup waits for a stage before its turn");
static_assert(BN_W % 64 == 0 && BN_W <= 128, "wgmma width of s");

// a lambda inlined at every call, so that the register arrays it takes by
// reference stay in registers (CUTLASS's CUTLASS_LAMBDA_FUNC_INLINE)
#define INLINE __attribute__((always_inline))

// 2^x on the special-function unit (outputs below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(THREADS_W, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int S, int H, int causal, float scale) {
  constexpr int NS = BN_W / 2;   // s accumulator floats a thread
  constexpr int KS = BN_W / 16;  // k16 steps of p v
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qfull, full[RING_W], empty[RING_W];
  bf16* qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* ks = qs + Q_TILE_W;            // [RING_W][BN_W][DW]
  bf16* vs = ks + RING_W * KV_TILE_W;  // [RING_W][BN_W][DW]

  // 0 the producer, 1 and 2 consumers. Taken from lane 0, so that the
  // compiler knows it is the same across the warp: a branch on a value
  // it takes for divergent while a wgmma is in flight makes ptxas
  // serialise every wgmma of the kernel (C7518).
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
      mbar_expect_tx(&qfull, Q_TILE_W * (int)sizeof(bf16));
      tma_load_3d(qs, &qmap, &qfull, h * DW, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % RING_W;
        mbar_wait(&empty[s], ((it / RING_W) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES_W);
        tma_load_3d(ks + s * KV_TILE_W, &kmap, &full[s], h * DW, it * BN_W,
                    b);
        tma_load_3d(vs + s * KV_TILE_W, &vmap, &full[s], h * DW, it * BN_W,
                    b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS_W>();
    const int wq = wg - 1;  // the warpgroup's rows: q0 + 64 wq ..
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r_first = q0 + 64 * wq;
    const int row = r_first + 16 * ((threadIdx.x / 32) % 4) + g;  // and + 8
    float acc[32], pv[32], s[NS];
    uint32_t phi[KS][4], plo[KS][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = pv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    // per row half: the running maximum of the base-2 scores, this lane's
    // part of the denominator, and the rescale of the last tile's softmax
    float m[2] = {-INFINITY, -INFINITY};
    float den[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    const float scale_log2 = scale * LOG2E;
    const uint32_t qa = smem_u32(qs + 64 * wq * DW);
    mbar_wait(&qfull, 0);

    // Each product is issued and waited for on one straight path: a path
    // on which one is still in flight where the code diverges makes ptxas
    // serialise every wgmma of the kernel (C7518).
    // s = q k^T of the tile in ring stage `st`, issued
    auto qk_issue = [&](int st) INLINE {
      const uint32_t ka = smem_u32(ks + st * KV_TILE_W);
      wgmma_fence();
      wgmma_fence_operands(s);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk)
        wgmma_bf16<BN_W, 0>(s, desc_sw128(qa + 32 * kk, 16, 1024),
                            desc_sw128(ka + 32 * kk, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // p v of a tile, p split in ph / pl and V in ring stage `st`, summed
    // from zero on the tensor cores: issued, then (pv_done, after the
    // wait) its registers pinned and the stage released
    auto pv_issue = [&](int st, uint32_t(&ph)[KS][4],
                        uint32_t(&pl)[KS][4]) INLINE {
      const uint32_t va = smem_u32(vs + st * KV_TILE_W);
      wgmma_fence();
      wgmma_fence_operands(pv);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint64_t vd = desc_sw128(va + 2048 * j, KV_TILE_W * 2, 1024);
        wgmma_m64n64k16_rs(pv, ph[j], vd, j > 0);
        wgmma_m64n64k16_rs(pv, pl[j], vd, true);
      }
      wgmma_commit();
    };
    auto pv_done = [&](int st, uint32_t(&ph)[KS][4],
                       uint32_t(&pl)[KS][4]) INLINE {
      wgmma_fence_operands(pv);
      wgmma_fence_operands(ph);
      wgmma_fence_operands(pl);
      mbar_arrive(&empty[st]);
    };
    // o = o * alpha + the tile's p v, in float32
    auto rescale_add = [&](float a0, float a1) INLINE {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = fmaf(acc[i], (i >> 1) & 1 ? a1 : a0, pv[i]);
    };
    // the online softmax of tile `it` on s (waited for): m, den and alpha
    // updated, p split into ph / pl
    auto softmax = [&](int it, uint32_t(&ph)[KS][4],
                       uint32_t(&pl)[KS][4]) INLINE {
      // element i of s: row `row` + 8 ((i / 2) % 2), key kt0 + 8 (i / 4)
      // + 2 t + i % 2
      const int kt0 = it * BN_W;
      if ((causal && kt0 + BN_W - 1 > r_first) || kt0 + BN_W > S) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kpos = kt0 + 8 * (i / 4) + 2 * t + (i & 1);
          // a select, not a branch: no accumulator register is written
          // on a divergent path
          s[i] = kpos >= S || (causal && kpos > row + 8 * ((i >> 1) & 1))
                     ? -INFINITY
                     : s[i];
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float neg_m[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = mx[half];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        // scale > 0: the maximum of the scaled scores is the scaled
        // maximum, to the bit
        const float m_new = fmaxf(m[half], x * scale_log2);
        // a row with every column so far masked has nothing to rescale
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = ex2(m[half] - m_use);
        m[half] = m_new;
        den[half] *= alpha[half];
        neg_m[half] = -m_use;
      }
      // p = 2^(s scale log2 e - m), float32, split into the A fragments
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * j + 2 * r;
          const float p0 = ex2(fmaf(s[i], scale_log2, neg_m[r & 1]));
          const float p1 = ex2(fmaf(s[i + 1], scale_log2, neg_m[r & 1]));
          den[r & 1] += p0;
          den[r & 1] += p1;
          split_bf16(p0, p1, ph[j][r], pl[j][r]);
        }
      }
    };

    // The turns: warpgroup 1 waits on barrier 1, warpgroup 2 on barrier
    // 2, each hands the turn to the other; warpgroup 1 goes first. Turn
    // it: the p v of tile it - 1, then the q k^T of tile it.
    const int mine = 1 + wq, other = 2 - wq;
    if (wq == 1) bar_arrive(1, 256);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % RING_W;
      mbar_wait(&full[st], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > 0) {
        pv_issue((it - 1) % RING_W, phi, plo);
        wgmma_wait<0>();
        pv_done((it - 1) % RING_W, phi, plo);
      }
      qk_issue(st);
      bar_arrive(other, 256);
      if (it > 0) rescale_add(alpha[0], alpha[1]);
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      softmax(it, phi, plo);
    }
    // the last tile's p v, in a turn of its own; every turn of warpgroup
    // 1 meets one of warpgroup 2, whose last turn hands nothing on
    bar_sync(mine, 256);
    pv_issue((n_tiles - 1) % RING_W, phi, plo);
    wgmma_wait<0>();
    pv_done((n_tiles - 1) % RING_W, phi, plo);
    if (wq == 0) bar_arrive(other, 256);
    rescale_add(alpha[0], alpha[1]);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d = den[half];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int r = row + 8 * half;
      if (r >= S) continue;
      const float den_safe = fmaxf(d, 1e-20f);
      const size_t off =
          ((size_t)b * S + r) * H * DW + (size_t)h * DW + 2 * t;
#pragma unroll
      for (int c = 0; c < DW / 8; ++c)
        store2(o + off + 8 * c, acc[4 * c + 2 * half] / den_safe,
               acc[4 * c + 2 * half + 1] / den_safe, true, true, true);
      if (t == 0)
        lse[(size_t)bh * S + r] = m[half] * LN2 + logf(den_safe);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The path of the bfloat16 face by head dim: the wgmma kernel at D 64,
// the mma.sync kernel at D 32 and 128.
bool wgmma_path(int D) { return D == DW; }

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int H, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BR - 1) / BR);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, S, H, causal,
                                          scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int B, int S, int H, int causal, float scale,
                cudaStream_t stream) {
  constexpr int smem = fwd_bf16_mma_smem_bytes<D>();
  auto kernel = flash_fwd_bf16_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BR - 1) / BR);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, S, H, causal,
                                          scale);
  return (int)cudaGetLastError();
}

// q, k and v [B, S, H, 64] as 3-D maps {H 64, S, B} in boxes of 64 values
// by `rows` rows
int launch_bf16_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                      float* lse, int B, int S, int H, int causal,
                      float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t d0 = (uint64_t)H * DW;
  int code = encode_tma_3d(&qmap, q, d0, S, B, DW, BM_W);
  if (!code) code = encode_tma_3d(&kmap, k, d0, S, B, DW, BN_W);
  if (!code) code = encode_tma_3d(&vmap, v, d0, S, B, DW, BN_W);
  if (code) return code;
  auto kernel = flash_fwd_bf16_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES_W);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BM_W - 1) / BM_W);
  kernel<<<grid, THREADS_W, SMEM_BYTES_W, stream>>>(qmap, kmap, vmap, o, lse,
                                                    S, H, causal, scale);
  return (int)cudaGetLastError();
}

// the mma.sync kernel at D 32, 64 or 128
int launch_bf16_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                    float* lse, int B, int S, int H, int D, int causal,
                    float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_bf16<32>(q, k, v, o, lse, B, S, H, causal, scale, st);
    case 64:
      return launch_bf16<64>(q, k, v, o, lse, B, S, H, causal, scale, st);
    case 128:
      return launch_bf16<128>(q, k, v, o, lse, B, S, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bfloat16 entry points' checks and casts; `mma` forces the mma.sync
// kernel, else the path of D
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int S, int H, int D, int causal, float scale,
             void* stream, bool mma) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mma && wgmma_path(D))
    return launch_bf16_wgmma(qb, kb, vb, ob, lf, B, S, H, causal, scale, st);
  return launch_bf16_mma(qb, kb, vb, ob, lf, B, S, H, D, causal, scale, st);
}

}  // namespace

extern "C" {

// q, k, v, o [B, S, H, D] and lse [B, H, S], float32, contiguous, on one
// device; the [B, S, H, D] tensors 16-byte aligned. D must be 32, 64 or
// 128.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int H, int D,
                            int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qf, kf, vf, of, lf, B, S, H, causal, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, lf, B, S, H, causal, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, B, S, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same on bfloat16 q, k, v and o; lse float32. D 64 runs the wgmma
// kernel, D 32 and 128 the mma.sync kernel (the path is picked by D
// before the launch).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             int causal, float scale, void* stream) {
  return fwd_bf16(q, k, v, o, lse, B, S, H, D, causal, scale, stream, false);
}

// The same on the mma.sync kernel at any of its head dims: the face's
// design before its wgmma kernel, timed beside it.
int flash_attention_fwd_bf16_mma(const void* q, const void* k,
                                 const void* v, void* o, void* lse, int B,
                                 int S, int H, int D, int causal,
                                 float scale, void* stream) {
  return fwd_bf16(q, k, v, o, lse, B, S, H, D, causal, scale, stream, true);
}

// The path flash_attention_fwd_bf16 takes at head dim D: 1 the wgmma
// kernel, 0 the mma.sync kernel, -1 none.
int flash_attention_fwd_bf16_path(int D) {
  if (D != 32 && D != 64 && D != 128) return -1;
  return wgmma_path(D) ? 1 : 0;
}

// Dynamic shared memory a block takes at head dim D: face 0 the float32
// kernel's, 1 the bfloat16 face's on the path of D, 2 the bfloat16 mma.sync
// kernel's (0 for a D without a kernel).
int flash_attention_fwd_smem_bytes(int D, int face) {
  if (face == 1 && D == DW) return SMEM_BYTES_W;
  const bool mma = face != 0;
  switch (D) {
    case 32:
      return mma ? fwd_bf16_mma_smem_bytes<32>() : fwd_smem_bytes<32>();
    case 64:
      return mma ? fwd_bf16_mma_smem_bytes<64>() : fwd_smem_bytes<64>();
    case 128:
      return mma ? fwd_bf16_mma_smem_bytes<128>() : fwd_smem_bytes<128>();
    default: return 0;
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
