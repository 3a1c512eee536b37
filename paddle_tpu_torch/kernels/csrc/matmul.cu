// Blocked matrix product x [M, K] @ w [K, N] -> out [M, N], float32 on
// CUDA cores, for sm_90a.
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
// (M 8192 tokens, K and N 768 or 3072) that is 190 to 330 flops a byte,
// far above the float32 balance of the card (67 TFLOP/s over 3.35 TB/s,
// 20 flops a byte), so the least time is the flops over 67 TFLOP/s. This
// version runs on the CUDA cores in full float32 (FFMA): no TF32, no
// tensor cores; mma/wgmma with TMA loads are later work.
//
// Design: the TPU's sequential k axis becomes a loop inside the block.
// One thread block of 256 threads owns a BM x BN output tile; all tiles
// are in flight at once. It walks K in steps of BK: an x tile (BM x BK,
// stored transposed, [k][m], so that a thread reads its rows as 16-byte
// vectors) and a w tile (BK x BN) go through shared memory, two stages:
// while the block computes on one stage, the next tiles are loaded from
// global memory into registers and stored into the other stage after the
// products, so a single barrier a step suffices. Each thread keeps a
// TM x TN register micro-tile (TM = BM/16, TN = BN/16: 8 x 8 at 128 x 128)
// of float32 sums, and the output tile is written once. The thread's rows
// and columns are groups of 4 strided by 64, so the 16 threads of a
// half-warp read and write 256 contiguous bytes. Ragged edges (M, N or K
// not a multiple of the tile) are masked at the loads (zeros) and at the
// stores, so the kernel is right at any shape. When K and N are multiples
// of 4 and the pointers 16-byte aligned, global loads and stores are
// 16-byte vectors.
//
// Tilings: one template instantiation for each (BM, BN, BK) in
// {64, 128} x {64, 128} x {8, 16, 32}, the `params` of the port's
// MatmulSpace (paddle_tpu_torch/tune/space.py); the entry point selects
// one by a switch and refuses any other.
//
// Tensors are contiguous, row-major. The kernel allocates nothing. The
// entry point launches on the stream it is given and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, each a TM x TN micro-tile
constexpr int PAD = 4;         // row padding of the transposed x tile

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static constexpr int AS_LD = BM + PAD;            // [k][m] pitch
  static constexpr int AS = BK * AS_LD;             // one stage of x
  static constexpr int BS = BK * BN;                // one stage of w
  static constexpr int SMEM_BYTES = 2 * (AS + BS) * (int)sizeof(float);
  // vector (float4) and scalar loads of each tile, per thread, rounded up
  static constexpr int A_VEC = (BM * BK / 4 + THREADS - 1) / THREADS;
  static constexpr int B_VEC = (BK * BN / 4 + THREADS - 1) / THREADS;
  static constexpr int A_SCL = (BM * BK + THREADS - 1) / THREADS;
  static constexpr int B_SCL = (BK * BN + THREADS - 1) / THREADS;
  static_assert(BM % 64 == 0 && BN % 64 == 0, "groups of 4 strided by 64");
  static_assert(BK % 4 == 0, "x tile rows load as 16-byte vectors");
};

// Staging registers of one step's tiles.
template <int BM, int BN, int BK, bool VEC>
struct Stage {
  using T = Tile<BM, BN, BK>;
  float a[VEC ? 4 * T::A_VEC : T::A_SCL];
  float b[VEC ? 4 * T::B_VEC : T::B_SCL];
};

template <int BM, int BN, int BK, bool VEC>
__device__ __forceinline__ void load_stage(
    Stage<BM, BN, BK, VEC>& st, const float* __restrict__ x,
    const float* __restrict__ w, int M, int N, int K, int m0, int n0, int k0,
    int tid) {
  using T = Tile<BM, BN, BK>;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < T::A_VEC; ++i) {
      const int v = tid + i * THREADS;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < BM * BK / 4) {
        const int row = v / (BK / 4), kv = (v % (BK / 4)) * 4;
        const int m = m0 + row, k = k0 + kv;
        if (m < M && k < K)   // K % 4 == 0: the vector is all in or out
          val = *reinterpret_cast<const float4*>(x + (size_t)m * K + k);
      }
      st.a[4 * i] = val.x; st.a[4 * i + 1] = val.y;
      st.a[4 * i + 2] = val.z; st.a[4 * i + 3] = val.w;
    }
#pragma unroll
    for (int i = 0; i < T::B_VEC; ++i) {
      const int v = tid + i * THREADS;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < BK * BN / 4) {
        const int kr = v / (BN / 4), nv = (v % (BN / 4)) * 4;
        const int k = k0 + kr, n = n0 + nv;
        if (k < K && n < N)   // N % 4 == 0
          val = *reinterpret_cast<const float4*>(w + (size_t)k * N + n);
      }
      st.b[4 * i] = val.x; st.b[4 * i + 1] = val.y;
      st.b[4 * i + 2] = val.z; st.b[4 * i + 3] = val.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T::A_SCL; ++i) {
      const int e = tid + i * THREADS;
      float val = 0.f;
      if (e < BM * BK) {
        const int m = m0 + e / BK, k = k0 + e % BK;
        if (m < M && k < K) val = x[(size_t)m * K + k];
      }
      st.a[i] = val;
    }
#pragma unroll
    for (int i = 0; i < T::B_SCL; ++i) {
      const int e = tid + i * THREADS;
      float val = 0.f;
      if (e < BK * BN) {
        const int k = k0 + e / BN, n = n0 + e % BN;
        if (k < K && n < N) val = w[(size_t)k * N + n];
      }
      st.b[i] = val;
    }
  }
}

template <int BM, int BN, int BK, bool VEC>
__device__ __forceinline__ void store_stage(
    const Stage<BM, BN, BK, VEC>& st, float* as, float* bs, int tid) {
  using T = Tile<BM, BN, BK>;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < T::A_VEC; ++i) {
      const int v = tid + i * THREADS;
      if (v < BM * BK / 4) {
        const int row = v / (BK / 4), kv = (v % (BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) as[(kv + j) * T::AS_LD + row] = st.a[4 * i + j];
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_VEC; ++i) {
      const int v = tid + i * THREADS;
      if (v < BK * BN / 4) {
        const int kr = v / (BN / 4), nv = (v % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(bs + kr * BN + nv) =
            make_float4(st.b[4 * i], st.b[4 * i + 1], st.b[4 * i + 2],
                        st.b[4 * i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < T::A_SCL; ++i) {
      const int e = tid + i * THREADS;
      if (e < BM * BK) as[(e % BK) * T::AS_LD + e / BK] = st.a[i];
    }
#pragma unroll
    for (int i = 0; i < T::B_SCL; ++i) {
      const int e = tid + i * THREADS;
      if (e < BK * BN) bs[e] = st.b[i];
    }
  }
}

template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BM, BN, BK>;
  constexpr int TM = T::TM, TN = T::TN;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;              // 2 stages of [BK][BM + PAD]
  float* bs = smem + 2 * T::AS;  // 2 stages of [BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Stage<BM, BN, BK, VEC> st;
  if (nk > 0) {
    load_stage<BM, BN, BK, VEC>(st, x, w, M, N, K, m0, n0, 0, tid);
    store_stage<BM, BN, BK, VEC>(st, as, bs, tid);
  }
  __syncthreads();

  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more)
      load_stage<BM, BN, BK, VEC>(st, x, w, M, N, K, m0, n0, (t + 1) * BK,
                                  tid);
    const float* a_s = as + cur * T::AS;
    const float* b_s = bs + cur * T::BS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + kk * T::AS_LD + g * 64 + ty * 4);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            b_s + kk * BN + g * 64 + tx * 4);
        b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more)
      store_stage<BM, BN, BK, VEC>(st, as + (cur ^ 1) * T::AS,
                                   bs + (cur ^ 1) * T::BS, tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
    float* orow = out + (size_t)m * N;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      if (VEC) {
        if (n < N)   // N % 4 == 0
          *reinterpret_cast<float4*>(orow + n) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) orow[n + j] = acc[i][4 * g + j];
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
