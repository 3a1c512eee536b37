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
// The bfloat16 face (matmul_bf16, a tuned gemm under AMP): the same
// tilings, ring and sum order on bfloat16 tiles, one bf16 mma.sync
// (m16n8k16, or m16n8k8 at BK 8) a product in place of the 3xTF32 triple,
// B fragments by ldmatrix.trans from the [k][n] tile, the output written
// in bfloat16 (rounded to nearest even) or float32: `_kernel` on bf16
// operands, its f32 scratch flushed as `out_dtype or x.dtype`. Bound:
// 2*M*N*K over 989 TFLOP/s dense bf16, 0.0391 ms at 8192 x 768 x 3072
// (the bytes, 2 per value, take about two thirds of that).
//
// Tensors are contiguous, row-major. The kernel allocates nothing. The
// entry point launches on the stream it is given and returns a CUDA error
// code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
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


// -- the bfloat16 face ------------------------------------------------------
//
// Tiles x [BM][BK + 8] and w [BK][BN + 8] in bfloat16. A 16-byte copy holds
// 8 values, so the copies are asynchronous when K and N are multiples of 8
// and the pointers 16-byte aligned; any other shape is staged by plain
// loads and stores, zeros past every edge, into the same ring.
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

template <int BM, int BN, int BK, bool VEC>
__device__ __forceinline__ void load_stage_bf16(
    bf16* xs, bf16* ws, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int M, int N, int K, int m0, int n0,
    int k0) {
  using T = TileB<BM, BN, BK>;
  if (VEC) {  // K % 8 == 0 and N % 8 == 0: a chunk is all in or all out
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async16(xs + r * T::XLD + c,
                 x + (in ? (size_t)(m0 + r) * K + k0 + c : 0), in);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async16(ws + r * T::WLD + c,
                 w + (in ? (size_t)(k0 + r) * N + n0 + c : 0), in);
    }
  } else {
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
}

template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
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
      load_stage_bf16<BM, BN, BK, VEC>(xs + s * T::XS, ws + s * T::WS, x, w,
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
      load_stage_bf16<BM, BN, BK, VEC>(xs + (nxt % STAGES) * T::XS,
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
        // VEC: N % 8 == 0, so n + 1 < N with n and the pair aligned
        if (out_f32)
          store2(static_cast<float*>(out) + o, v0, v1, n < N, n + 1 < N,
                 VEC && n < N);
        else
          store2(static_cast<bf16*>(out) + o, v0, v1, n < N, n + 1 < N,
                 VEC && n < N);
      }
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

template <int BM, int BN, int BK>
int launch_bf16(const bf16* x, const bf16* w, void* out, bool out_f32, int M,
                int N, int K, bool vec, cudaStream_t st) {
  using T = TileB<BM, BN, BK>;
  const long long mblocks = ((long long)M + BM - 1) / BM;
  const long long nblocks = ((long long)N + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)nblocks);
  auto kernel = vec ? matmul_bf16_kernel<BM, BN, BK, true>
                    : matmul_bf16_kernel<BM, BN, BK, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, out_f32, M, N, K);
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

// x [M, K] and w [K, N] bfloat16, out [M, N] float32 when out_f32 is
// non-zero, else bfloat16; contiguous, on one device; (bm, bn, bk) one of
// the compiled tilings.
int matmul_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                int bm, int bn, int bk, int out_f32, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0;
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
#define TILING(BM_, BN_, BK_)                                        \
  if (bm == BM_ && bn == BN_ && bk == BK_)                           \
    return launch_bf16<BM_, BN_, BK_>(xb, wb, out, f32, M, N, K, vec, st);
  TILING(64, 64, 8) TILING(64, 64, 16) TILING(64, 64, 32)
  TILING(64, 128, 8) TILING(64, 128, 16) TILING(64, 128, 32)
  TILING(128, 64, 8) TILING(128, 64, 16) TILING(128, 64, 32)
  TILING(128, 128, 8) TILING(128, 128, 16) TILING(128, 128, 32)
#undef TILING
  return (int)cudaErrorInvalidValue;   // not a compiled tiling
}

// Dynamic shared memory of one bfloat16 tiling's block, or -1.
int matmul_bf16_smem_bytes(int bm, int bn, int bk) {
#define TILING(BM_, BN_, BK_)              \
  if (bm == BM_ && bn == BN_ && bk == BK_) \
    return TileB<BM_, BN_, BK_>::SMEM_BYTES;
  TILING(64, 64, 8) TILING(64, 64, 16) TILING(64, 64, 32)
  TILING(64, 128, 8) TILING(64, 128, 16) TILING(64, 128, 32)
  TILING(128, 64, 8) TILING(128, 64, 16) TILING(128, 64, 32)
  TILING(128, 128, 8) TILING(128, 128, 16) TILING(128, 128, 32)
#undef TILING
  return -1;
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
