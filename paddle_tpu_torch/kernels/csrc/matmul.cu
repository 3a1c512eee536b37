// Blocked matrix product x [M, K] @ w [K, N] -> out [M, N] on Hopper's
// tensor cores, float32-exact through 3xTF32, with a bfloat16 face, for
// sm_90a.
//
// Replaces: paddle_tpu/kernels/matmul.py, `_matmul_fwd` (its pallas_call)
// with the kernel body `_kernel`, reached through `matmul`. It computes
//   out[m, n] = sum_k x[m, k] * w[k, n]
// summed in float32. On the TPU the grid is (M/bm, N/bn, K/bk) with k
// innermost, and a VMEM scratch tile carries the sum from one k step to
// the next; the tiling (block_m, block_n, block_k) is what the autotuner
// searches.
//
// What bounds it on the H100: operations. One call does 2*M*N*K flops on
// (M*K + K*N + M*N) floats; at the transformer projections of GPT-2 small
// (M 8192 tokens, K and N 768 or 3072) that is 190 to 330 flops a byte.
// Every product runs on the tensor cores in 3xTF32, three TF32 products
// for each float32 one, so the least time is 3 * 2*M*N*K over the card's
// 495 TFLOP/s dense TF32: 0.0586 ms at 8192 x 768 x 768 and 0.2343 ms at
// 8192 x 768 x 3072 and 8192 x 3072 x 768 (the bytes take a fifth to a
// ninth of that).
//
// Design.
// - 3xTF32 (tf32x3.cuh): each float32 operand is split into a TF32 hi and
//   a lo part, and x w is taken as lo(x) hi(w) + hi(x) lo(w) + hi(x)
//   hi(w) on mma.sync.m16n8k8, rounded by hand (add, mask, subtract) as
//   the fragments are loaded from shared memory.
// - Tiles. The TPU's sequential k axis becomes a loop inside the block.
//   One block of 8 warps owns a BM x BN output tile, the warps 2 along M
//   and 4 along N, so a warp owns BM/2 x BN/4: (BM/32) x (BN/32) m16n8
//   fragments of float32 sums in registers.
// - Copies. Each BK-deep step's x tile, stored [BM][BK + 4], and w tile,
//   stored [BK][BN + 8], come by cp.async into a ring of three stages: two
//   steps are in flight while the tensor cores work on the third, and one
//   barrier a step suffices. These pitches put the 32 lanes of a fragment
//   load on 32 distinct banks (the A lanes on a permutation of 4 g + t,
//   the B lanes on 8 t + g).
// - Ragged shapes. When K and N are multiples of 4 and the pointers are
//   16-byte aligned the copies are 16 bytes, else 4 bytes; every copy
//   past an edge of M, N or K is zero-filled, and the stores are masked,
//   so the kernel is right at any shape.
// - Sum order. The tensor cores truncate as they accumulate, so each BK
//   step is summed from zero on them (BK/8 mma k-steps) and added in
//   float32 to the register accumulator: the tile-level order of the
//   plain version (a float32 sum of the k tiles' products), and no drift
//   over K = 3072.
// - Determinism: no atomics, each output written once, so relaunches agree
//   bit for bit.
//
// Tilings: one template instantiation for each (BM, BN, BK) in
// {64, 128} x {64, 128} x {8, 16, 32}, the `params` of the port's
// MatmulSpace (paddle_tpu_torch/tune/space.py); the entry point selects
// one by a switch and refuses any other.
//
// The bfloat16 face (matmul_bf16, a tuned gemm under AMP) computes `_kernel`
// on bf16 operands, its f32 scratch flushed as `out_dtype or x.dtype`: each
// product exact in float32, summed in float32, written once in bfloat16
// (rounded to nearest even) or float32. Bound: 2*M*N*K over 989 TFLOP/s
// dense bf16, 0.0391 ms at 8192 x 768 x 3072, 0.0195 ms a launch on mean
// over a GPT-2-small step's 72 gemms (the bytes, 2 per value, take about
// two thirds of that). mma.sync cannot reach that rate on Hopper; only
// wgmma can. So the face is a warp-specialised wgmma GEMM fed by TMA
// (hopper.cuh):
// - Loads. One producer warp issues TMA: x's BM x 64 box (K-major, the
//   rows 128 bytes) and w's BN / 64 boxes of 64 k x 64 n as w lies in
//   device memory (N-major), all with the 128-byte swizzle, into a ring
//   of RING_BF16 stages with a full and an empty mbarrier each. wgmma
//   reads the N-major B through its transpose operand (16-bit types
//   allow it; TF32 would need a K-major copy), so w needs no transposed
//   copy. The boxes past the edges of M, N and K are zero-filled.
// - Products. BM / 64 consumer warpgroups each own 64 rows x BN: four
//   wgmma.m64n{BN}k16 a 64-deep stage, both operands by shared-memory
//   descriptor. The producer warpgroup drops to 40 registers, the
//   consumers rise to 232 (setmaxnreg).
// - Sum order. The tensor cores truncate as they accumulate, so each
//   stage is summed from zero (scale-d 0 on its first wgmma) and added in
//   float32 to a second accumulator in registers: the plain version's
//   float32 sum of 64-deep tiles. BN / 2 + BN / 2 registers a thread.
// - Epilogue. Rounded in registers (bf16 RNE, or float32 kept) and
//   stored, masked at the ragged M and N edges; no atomics, no split-K,
//   each output written once, so relaunches agree bit for bit.
// - Grid. One block an output tile, the N tiles fastest, so the blocks in
//   flight share x's rows (at 8192 x 3072 x 768, x is 48 MiB and would
//   not stay in the L2 between columns). On 132 SMs, one block an SM:
//   128 x 128 takes 384 tiles (2.9 waves) at N 768 and 1536 (11.6) at N
//   3072; 64 x 192 512 (3.9) and 2048 (15.5). A persistent tile
//   scheduler is a later step.
// - Tilings: BM 64 with BN 64, 128 or 192, BM 128 with BN 64 or 128; BK
//   64 (one swizzled row of bf16). Two accumulators of BN / 2 registers
//   must fit a consumer's budget: 128 x 192 spills (its 384 threads
//   compile at 168 registers), 64 x 256 would need 256.
// TMA needs 16-byte-aligned bases and row pitches that are multiples of
// 16 bytes: K % 8 == 0 and N % 8 == 0 (the population supports_matmul
// admits always meets the pitch rule). Other operands (a misaligned
// view, ragged K or N, K 0) take the face's ragged path, the mma.sync
// kernel of the float32 design with bf16 tiles (matmul_bf16_ragged_kernel,
// one tiling, 128 x 128 x 32): B fragments by ldmatrix.trans from the
// [k][n] tile, tiles staged by plain loads where cp.async cannot take
// them. The entry point picks the path by that rule and reports it.
//
// Tensors are contiguous, row-major. The kernel allocates nothing. The
// entry point launches on the stream it is given and returns a CUDA error
// code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "bf16.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 along M, 4 along N
constexpr int STAGES = 3;     // the ring of x and w tiles
constexpr int X_PAD = 4;      // row padding of the x tile
constexpr int W_PAD = 8;      // row padding of the w tile

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int WM = BM / 2;           // a warp's rows
  static constexpr int WN = BN / 4;           // a warp's columns
  static constexpr int MI = WM / 16;          // its m16 fragments
  static constexpr int NI = WN / 8;           // its n8 fragments
  static constexpr int XLD = BK + X_PAD;      // [m][k] pitch
  static constexpr int WLD = BN + W_PAD;      // [k][n] pitch
  static constexpr int XS = BM * XLD;         // one stage of x
  static constexpr int WS = BK * WLD;         // one stage of w
  static constexpr int SMEM_BYTES = STAGES * (XS + WS) * (int)sizeof(float);
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 8 == 0, "tiling");
};

// The x and w tiles of the k step at k0 into one stage; zeros past every
// edge
template <int BM, int BN, int BK, bool VEC>
__device__ __forceinline__ void load_stage(
    float* xs, float* ws, const float* __restrict__ x,
    const float* __restrict__ w, int M, int N, int K, int m0, int n0,
    int k0) {
  using T = Tile<BM, BN, BK>;
  if (VEC) {  // K % 4 == 0 and N % 4 == 0: a chunk is all in or all out
    for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async16(xs + r * T::XLD + c,
                 x + (in ? (size_t)(m0 + r) * K + k0 + c : 0), in);
    }
    for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async16(ws + r * T::WLD + c,
                 w + (in ? (size_t)(k0 + r) * N + n0 + c : 0), in);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async4(xs + r * T::XLD + c,
                x + (in ? (size_t)(m0 + r) * K + k0 + c : 0), in);
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async4(ws + r * T::WLD + c,
                w + (in ? (size_t)(k0 + r) * N + n0 + c : 0), in);
    }
  }
}

template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BM, BN, BK>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // STAGES x [BM][BK + 4]
  float* ws = smem + STAGES * T::XS;  // STAGES x [BK][BN + 8]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int wm = (warp / 4) * T::WM;  // the warp's first row in the tile
  const int wn = (warp % 4) * T::WN;  // and first column
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, BK, VEC>(xs + s * T::XS, ws + s * T::WS, x, w, M,
                                  N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    // step kt has landed (only the groups of the later steps may still be
    // in flight), and every warp is done with step kt - 1's stage, which
    // the copy below refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<BM, BN, BK, VEC>(xs + (nxt % STAGES) * T::XS,
                                  ws + (nxt % STAGES) * T::WS, x, w, M, N, K,
                                  m0, n0, nxt * BK);
    cp_async_commit();  // an empty group near the end keeps the count

    const float* xt = xs + (kt % STAGES) * T::XS + wm * T::XLD;
    const float* wt = ws + (kt % STAGES) * T::WS + wn;
    // the step's sum, from zero on the tensor cores
    float c[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mi][ni][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      FragA a[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        a[mi] = load_a<T::XLD>(xt + mi * 16 * T::XLD + kk * 8, g, t);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const FragB b = load_b<T::WLD>(wt + kk * 8 * T::WLD + ni * 8, g, t);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma3(c[mi][ni], a[mi], b);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) add4(acc[mi][ni], c[mi][ni]);
  }

  // element i of a C fragment is row g + 8 (i / 2), column 2 t + i % 2
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        if (VEC) {
          if (n < N)  // N % 4 == 0: n + 1 < N too
            *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
        }
      }
    }
  }
}


// -- the bfloat16 face's ragged path ------------------------------------------
//
// Tiles x [BM][BK + 8] and w [BK][BN + 8] in bfloat16, staged by plain
// loads and stores, zeros past every edge, into the ring: an operand that
// comes here (K or N not a multiple of 8, or a pointer not 16-byte
// aligned; K 0 loads nothing) is one a 16-byte copy cannot take either.
constexpr int X_PAD_BF16 = 8;
constexpr int W_PAD_BF16 = 8;

template <int BM, int BN, int BK>
struct TileB {
  static constexpr int WM = BM / 2;
  static constexpr int WN = BN / 4;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int XLD = BK + X_PAD_BF16;
  static constexpr int WLD = BN + W_PAD_BF16;
  static constexpr int XS = BM * XLD;
  static constexpr int WS = BK * WLD;
  static constexpr int SMEM_BYTES = STAGES * (XS + WS) * (int)sizeof(bf16);
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 8 == 0, "tiling");
};

template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage_bf16(
    bf16* xs, bf16* ws, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int M, int N, int K, int m0, int n0,
    int k0) {
  using T = TileB<BM, BN, BK>;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    xs[r * T::XLD + c] = m0 + r < M && k0 + c < K
                             ? x[(size_t)(m0 + r) * K + k0 + c]
                             : zero;
  }
  for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    ws[r * T::WLD + c] = k0 + r < K && n0 + c < N
                             ? w[(size_t)(k0 + r) * N + n0 + c]
                             : zero;
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_ragged_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   void* __restrict__ out, bool out_f32, int M, int N,
                   int K) {
  using T = TileB<BM, BN, BK>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // STAGES x [BM][BK + 8]
  bf16* ws = xs + STAGES * T::XS;            // STAGES x [BK][BN + 8]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 4) * T::WM;
  const int wn = (warp % 4) * T::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage_bf16<BM, BN, BK>(xs + s * T::XS, ws + s * T::WS, x, w,
                                       M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage_bf16<BM, BN, BK>(xs + (nxt % STAGES) * T::XS,
                                       ws + (nxt % STAGES) * T::WS, x, w, M,
                                       N, K, m0, n0, nxt * BK);
    cp_async_commit();

    const bf16* xt = xs + (kt % STAGES) * T::XS + wm * T::XLD;
    const bf16* wt = ws + (kt % STAGES) * T::WS + wn;
    float step[MI][NI][4];  // the step's sum, from zero
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) step[mi][ni][i] = 0.f;
    if constexpr (BK % 16 == 0) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          load_a16<T::XLD>(a[mi], xt + mi * 16 * T::XLD + kk * 16, g, t);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          uint32_t b[2];
          load_b16<T::WLD>(b, wt + kk * 16 * T::WLD + ni * 8, lane);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
          mma_bf16_k16(step[mi][ni], a[mi], b);
        }
      }
    } else {  // BK 8: one m16n8k8 slice
      uint32_t a[MI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        load_a8<T::XLD>(a[mi], xt + mi * 16 * T::XLD, g, t);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t b = load_b8<T::WLD>(wt + ni * 8, lane);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16_k8(step[mi][ni], a[mi], b);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) add4(acc[mi][ni], step[mi][ni]);
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        const size_t o = (size_t)m * N + n;
        if (out_f32)
          store2(static_cast<float*>(out) + o, v0, v1, n < N, n + 1 < N,
                 false);
        else
          store2(static_cast<bf16*>(out) + o, v0, v1, n < N, n + 1 < N,
                 false);
      }
    }
  }
}

// -- the bfloat16 face: TMA + wgmma --------------------------------------------

constexpr int BK_BF16 = 64;   // one 128-byte swizzled row of bfloat16
constexpr int RING_BF16 = 4;  // stages of the ring

template <int BM, int BN>
struct TileW {
  static constexpr int CONSUMERS = BM / 64;  // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int XS = BM * BK_BF16;    // values of a stage's x box
  static constexpr int WS = BK_BF16 * BN;    // of its w boxes
  static constexpr int STAGE_BYTES = (XS + WS) * (int)sizeof(bf16);
  // the ring, and slack to align it to the swizzle's 1024 bytes
  static constexpr int SMEM_BYTES = RING_BF16 * STAGE_BYTES + 1024;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN % 64 == 0 && BN <= 192, "wgmma width");
};

template <int BM, int BN>
__global__ void __launch_bounds__(TileW<BM, BN>::THREADS, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         void* __restrict__ out, bool out_f32, int M, int N,
                         int K) {
  using T = TileW<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[RING_BF16], empty[RING_BF16];
  // the ring: RING_BF16 x boxes, then RING_BF16 x w stages, 1024-aligned
  bf16* xs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* ws = xs + RING_BF16 * T::XS;

  const int wg = threadIdx.x / 128;  // 0 the producer, 1.. the consumers
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK_BF16 - 1) / BK_BF16;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < RING_BF16; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * T::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % RING_BF16;
        mbar_wait(&empty[s], ((kt / RING_BF16) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load_2d(xs + s * T::XS, &xmap, &full[s], kt * BK_BF16, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(ws + s * T::WS + j * 64 * BK_BF16, &wmap, &full[s],
                      n0 + 64 * j, kt * BK_BF16);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int rows = (wg - 1) * 64;  // the warpgroup's rows in the tile
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % RING_BF16;
      mbar_wait(&full[s], (kt / RING_BF16) & 1);
      const uint32_t a = smem_u32(xs + s * T::XS + rows * BK_BF16);
      const uint32_t b = smem_u32(ws + s * T::WS);
      // the stage's sum, from zero on the tensor cores
      wgmma_fence();
      wgmma_fence_operands(part);
#pragma unroll
      for (int kk = 0; kk < BK_BF16 / 16; ++kk)
        wgmma_bf16<BN>(part, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(b + 2048 * kk, 64 * BK_BF16 * 2, 1024),
                       kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    const int lane = threadIdx.x % 32;
    const int m = m0 + rows + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = m + 8 * ((i / 2) % 2);
      const int n = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (r >= M || n >= N) continue;  // N % 8 == 0: n + 1 < N too
      const size_t o = (size_t)r * N + n;
      if (out_f32)
        store2(static_cast<float*>(out) + o, acc[i], acc[i + 1], true, true,
               true);
      else
        store2(static_cast<bf16*>(out) + o, acc[i], acc[i + 1], true, true,
               true);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int BM, int BN, int BK>
int launch(const float* x, const float* w, float* out, int M, int N, int K,
           bool vec, cudaStream_t st) {
  using T = Tile<BM, BN, BK>;
  const long long mblocks = ((long long)M + BM - 1) / BM;
  const long long nblocks = ((long long)N + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)nblocks);
  auto kernel = vec ? matmul_kernel<BM, BN, BK, true>
                    : matmul_kernel<BM, BN, BK, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, M, N, K);
  return (int)cudaGetLastError();
}

// the ragged path: one tiling
constexpr int RBM = 128, RBN = 128, RBK = 32;

int launch_bf16_ragged(const bf16* x, const bf16* w, void* out, bool out_f32,
                       int M, int N, int K, cudaStream_t st) {
  using T = TileB<RBM, RBN, RBK>;
  const long long mblocks = ((long long)M + RBM - 1) / RBM;
  const long long nblocks = ((long long)N + RBN - 1) / RBN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)nblocks);
  auto kernel = matmul_bf16_ragged_kernel<RBM, RBN, RBK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, out_f32, M, N, K);
  return (int)cudaGetLastError();
}

// x [M, K] in BM x 64 boxes, w [K, N] in 64 x 64 ones
template <int BM>
int encode_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                const void* w, int M, int N, int K) {
  int e = encode_tma_2d(xmap, x, K, M, (uint64_t)K * 2, BK_BF16, BM);
  return e ? e : encode_tma_2d(wmap, w, N, K, (uint64_t)N * 2, 64, BK_BF16);
}

template <int BM, int BN>
int launch_wgmma(const void* x, const void* w, void* out, bool out_f32,
                 int M, int N, int K, cudaStream_t st) {
  using T = TileW<BM, BN>;
  const long long mblocks = ((long long)M + BM - 1) / BM;
  const long long nblocks = ((long long)N + BN - 1) / BN;
  if (nblocks > 0x7fffffffLL || mblocks > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  int code = encode_maps<BM>(&xmap, &wmap, x, w, M, N, K);
  if (code) return code;
  auto kernel = matmul_bf16_wgmma_kernel<BM, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nblocks, (unsigned)mblocks);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, st>>>(xmap, wmap, out, out_f32,
                                                  M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K], w [K, N] and out [M, N], float32, contiguous, on one device;
// (bm, bn, bk) one of the compiled tilings.
int matmul_f32(const void* x, const void* w, void* out, int M, int N, int K,
               int bm, int bn, int bk, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
#define TILING(BM_, BN_, BK_)                                       \
  if (bm == BM_ && bn == BN_ && bk == BK_)                          \
    return launch<BM_, BN_, BK_>(xf, wf, of, M, N, K, vec, st);
  TILING(64, 64, 8) TILING(64, 64, 16) TILING(64, 64, 32)
  TILING(64, 128, 8) TILING(64, 128, 16) TILING(64, 128, 32)
  TILING(128, 64, 8) TILING(128, 64, 16) TILING(128, 64, 32)
  TILING(128, 128, 8) TILING(128, 128, 16) TILING(128, 128, 32)
#undef TILING
  return (int)cudaErrorInvalidValue;   // not a compiled tiling
}

// The compiled tilings of the bfloat16 face, (BM, BN): BK is 64.
#define BF16_TILINGS(X) \
  X(64, 64) X(64, 128) X(64, 192) X(128, 64) X(128, 128)

// x [M, K] and w [K, N] bfloat16, out [M, N] float32 when out_f32 is
// non-zero, else bfloat16; contiguous, on one device; (bm, bn, bk) one of
// the compiled tilings. Operands TMA can take (K and N multiples of 8, K
// not 0, every pointer 16-byte aligned) run the wgmma kernel at that
// tiling, any other the ragged path; *ragged says which.
int matmul_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                int bm, int bn, int bk, int out_f32, int* ragged,
                void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0;
  bool compiled = false;
#define IS_TILING(BM_, BN_) compiled |= bm == BM_ && bn == BN_;
  BF16_TILINGS(IS_TILING)
#undef IS_TILING
  if (!compiled || bk != BK_BF16) return (int)cudaErrorInvalidValue;
  *ragged = !(K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
              aligned16(w) && aligned16(out));
  if (*ragged)
    return launch_bf16_ragged(static_cast<const bf16*>(x),
                              static_cast<const bf16*>(w), out, f32, M, N,
                              K, st);
#define TILING(BM_, BN_) \
  if (bm == BM_ && bn == BN_) \
    return launch_wgmma<BM_, BN_>(x, w, out, f32, M, N, K, st);
  BF16_TILINGS(TILING)
#undef TILING
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one bfloat16 block: the wgmma kernel's at its
// tilings, the ragged path's at 128 x 128 x 32; -1 for any other.
int matmul_bf16_smem_bytes(int bm, int bn, int bk) {
#define TILING(BM_, BN_) \
  if (bm == BM_ && bn == BN_ && bk == BK_BF16) return TileW<BM_, BN_>::SMEM_BYTES;
  BF16_TILINGS(TILING)
#undef TILING
  if (bm == RBM && bn == RBN && bk == RBK)
    return TileB<RBM, RBN, RBK>::SMEM_BYTES;
  return -1;
}

// Host microseconds, on mean over `reps`, to encode the two tensor maps a
// launch of the wgmma kernel at row tiling bm needs; negative on an error.
double matmul_bf16_encode_us(const void* x, const void* w, int M, int N,
                             int K, int bm, int reps) {
  CUtensorMap xmap, wmap;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int e = bm == 64 ? encode_maps<64>(&xmap, &wmap, x, w, M, N, K)
                           : encode_maps<128>(&xmap, &wmap, x, w, M, N, K);
    if (e) return -1.0;
  }
  const std::chrono::duration<double, std::micro> took =
      std::chrono::steady_clock::now() - t0;
  return took.count() / reps;
}

// Dynamic shared memory of one tiling's block, or -1 for a tiling that is
// not compiled.
int matmul_smem_bytes(int bm, int bn, int bk) {
#define TILING(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return Tile<BM_, BN_, BK_>::SMEM_BYTES;
  TILING(64, 64, 8) TILING(64, 64, 16) TILING(64, 64, 32)
  TILING(64, 128, 8) TILING(64, 128, 16) TILING(64, 128, 32)
  TILING(128, 64, 8) TILING(128, 64, 16) TILING(128, 64, 32)
  TILING(128, 128, 8) TILING(128, 128, 16) TILING(128, 128, 32)
#undef TILING
  return -1;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
