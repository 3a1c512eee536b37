// 3x3 / stride-1 / pad-1 convolution, NHWC x HWIO -> NHWC, on Hopper's
// tensor cores, float32-exact through 3xTF32, with a bfloat16 face, for
// sm_90a.
//
// Replaces: paddle_tpu/kernels/conv3x3.py:97, `_conv3x3_fwd` (its
// pallas_call) with the kernel body `_kernel` (:55), reached through
// `conv3x3_s1_nhwc`. It computes
//   out[n, h, w, o] = sum_{dy, dx, c} xpad[n, h + dy, w + dx, c] * w[dy, dx, c, o]
// with xpad the input padded by one zero pixel on every side, summed in
// float32. The same kernel serves the backward's dx, as on the TPU: dx is
// the 3x3 / s1 / p1 conv of the output gradient with the spatially
// flipped, in/out-swapped filter (`_vjp_bwd`), which the wrapper forms.
//
// What bounds it on the H100: operations. One call does 2 * N*H*W * C*O*9
// flops on N*H*W*(C + O) + 9*C*O floats; at ResNet-50's stage shapes at
// batch 32 (56x56x64 to 7x7x512) that is 7.40 GFLOP a call and 100 to
// 1000 flops a byte. In 3xTF32 each float32 product is three TF32 ones,
// so the least time is 3 * 7.40 GFLOP over the card's 495 TFLOP/s dense
// TF32: 0.0448 ms a stage-shape call (the bytes take a fifth of that or
// less).
//
// Design: an implicit GEMM of M = N*H*W output pixels by O output
// channels over K = 9*C, never materialised (no im2col buffer, no padded
// copy of x). The filter w [3, 3, C, O] in its own contiguous layout is
// the row-major B [9C, O] of that GEMM, k tap-major then channel.
// - The k walk. Taps outer, input channels in chunks of BK = 32 inner:
//   9 * ceil(C / 32) steps, none straddling two taps; channels past C
//   are zero-filled.
// - Tiles. One block of 8 warps owns a BM x BN output tile, the warps 2
//   along M and 4 along N. Each step's A tile, [BM][BK + 4] (one shifted
//   pixel a row, 4 channels a 16-byte chunk), and B tile, [BK][BN + 8]
//   (the tap's filter rows), come by cp.async into a ring of three
//   stages: two steps are in flight while the tensor cores work on the
//   third, and one barrier a step suffices (matmul.cu's ring).
// - The A rows. Each thread copies chunks of one A row, and works out
//   that row's pixel (h, w) once, before the k loop; the walk then moves
//   a cursor (tap, first channel), with no division in the loop. A chunk
//   is zero-filled (cp.async with a source size of 0 and a valid dummy
//   address) where the tap falls in the 1-pixel halo, past the last
//   pixel, or past C.
// - 3xTF32 (tf32x3.cuh): each operand split into a TF32 hi and lo as its
//   fragment is loaded from shared memory, lo(a) hi(b) + hi(a) lo(b) +
//   hi(a) hi(b) on mma.sync.m16n8k8. Each step is summed from zero on the
//   tensor cores (which truncate as they accumulate) and added in float32
//   to register accumulators.
// - Ragged shapes. When C and O are multiples of 4 and the pointers are
//   16-byte aligned the copies are 16 bytes, else 4 bytes; every copy
//   past an edge is zero-filled and the stores are masked, so every shape
//   is right. Offsets are 64-bit.
// - Determinism: no atomics and no split of K, each output written once,
//   so relaunches agree bit for bit.
//
// Tilings: BM x BN in {128 x 128, 128 x 64, 64 x 64} at BK 32, template
// instances. The rule (pick_tiling): the first of them, largest first,
// whose BN is at most max(64, O) and whose grid has at least 2 blocks an
// SM; else 64 x 64. At ResNet-50's stage shapes at batch 32 on 132 SMs
// that is 128 x 64, 128 x 64, 64 x 64 and 64 x 64 (784, 392, 392 and 200
// blocks). paddle_tpu_torch/kernels/conv3x3.py mirrors the rule and the
// shared memory of each tiling.
//
// The bfloat16 face (conv3x3_s1_nhwc_bf16, under AMP): the same walk,
// ring, tilings and rule on bfloat16 tiles, one bf16 mma.sync.m16n8k16 a
// product (a bfloat16 product is exact in float32) in place of the 3xTF32
// triple, the sums in float32 as above, the output written in bfloat16
// (rounded to nearest even) or float32. The JAX kernel is dtype-generic:
// `_kernel` sums `jnp.dot(..., preferred_element_type=float32)` of the
// bf16 operands and writes `out_dtype`. Its bound is operations too, now
// at the card's 989 TFLOP/s dense bf16: 7.40 GFLOP a stage-shape call
// over that is 0.0075 ms, and the bytes (half of float32's) about as
// much, so the bound is the larger of the two, shape by shape.
//
// Tensors are contiguous: x [N, H, W, C], w [3, 3, C, O], out [N, H, W, O].
// The kernel allocates nothing. The entry point launches on the stream it
// is given and returns a CUDA error code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 along M, 4 along N
constexpr int STAGES = 3;     // the ring of A and B tiles
constexpr int BK = 32;        // input channels a step
constexpr int X_PAD = 4;      // row padding of the A tile
constexpr int W_PAD = 8;      // row padding of the B tile

template <int BM, int BN>
struct Tile {
  static constexpr int WM = BM / 2;           // a warp's rows
  static constexpr int WN = BN / 4;           // a warp's columns
  static constexpr int MI = WM / 16;          // its m16 fragments
  static constexpr int NI = WN / 8;           // its n8 fragments
  static constexpr int XLD = BK + X_PAD;      // [pixel][channel] pitch
  static constexpr int WLD = BN + W_PAD;      // [channel][o] pitch
  static constexpr int XS = BM * XLD;         // one stage of A
  static constexpr int WS = BK * WLD;         // one stage of B
  static constexpr int SMEM_BYTES = STAGES * (XS + WS) * (int)sizeof(float);
  static constexpr int TPR = THREADS / BM;    // threads copying one A row
  static_assert(BM % 32 == 0 && BN % 32 == 0 && THREADS % BM == 0 &&
                (BK / 4) % TPR == 0, "tiling");
};

// Where this thread's A row reads the k step being loaded: the step's
// tap (dy, dx) and first channel c0, and the row's source pixel for that
// tap (src, or in = false in the halo or past the last pixel).
template <typename T>
struct CursorT {
  int dy, dx, c0;
  bool in;
  const T* src;
};
typedef CursorT<float> Cursor;

template <typename T>
__device__ __forceinline__ void aim(CursorT<T>& cur, const T* __restrict__ x,
                                    bool row, long long m, int h, int w,
                                    int H, int W, int C) {
  const int ih = h + cur.dy - 1, iw = w + cur.dx - 1;
  cur.in = row && ih >= 0 && ih < H && iw >= 0 && iw < W;
  cur.src = cur.in
                ? x + (m + (long long)(cur.dy - 1) * W + (cur.dx - 1)) * C
                : x;
}

// The A and B tiles of the step at the cursor into one stage; zeros past
// every edge. `r` and `s` are this thread's A row and its place among the
// row's TPR threads.
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void load_stage(
    float* xs, float* ws, const float* __restrict__ x,
    const float* __restrict__ w, const Cursor& cur, int r, int s, int C,
    int O, int n0) {
  using T = Tile<BM, BN>;
  constexpr int TPR = T::TPR;
  float* dst = xs + r * T::XLD;
  // the tap's filter rows c0 .. c0 + BK - 1: rows of B [9C, O]
  const float* wt = w + ((long long)(cur.dy * 3 + cur.dx) * C + cur.c0) * O;
  if (VEC) {  // C % 4 == 0 and O % 4 == 0: a chunk is all in or all out
    // the thread's chunks interleave with its row's other threads', so a
    // warp's copy covers whole 32-byte sectors of each row
#pragma unroll
    for (int j = 0; j < BK / 4 / TPR; ++j) {
      const int q = 4 * (s + TPR * j);
      const bool in = cur.in && cur.c0 + q < C;
      cp_async16(dst + q, in ? cur.src + cur.c0 + q : x, in);
    }
    for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
      const int k = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool in = cur.c0 + k < C && n0 + c < O;
      cp_async16(ws + k * T::WLD + c,
                 in ? wt + (long long)k * O + n0 + c : w, in);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / TPR; ++j) {
      const int q = s + TPR * j;
      const bool in = cur.in && cur.c0 + q < C;
      cp_async4(dst + q, in ? cur.src + cur.c0 + q : x, in);
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int k = i / BN, c = i % BN;
      const bool in = cur.c0 + k < C && n0 + c < O;
      cp_async4(ws + k * T::WLD + c,
                in ? wt + (long long)k * O + n0 + c : w, in);
    }
  }
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int H, int W, int C, int O,
               long long M) {
  using T = Tile<BM, BN>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // STAGES x [BM][BK + 4]
  float* ws = smem + STAGES * T::XS;  // STAGES x [BK][BN + 8]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int wm = (warp / 4) * T::WM;  // the warp's first row in the tile
  const int wn = (warp % 4) * T::WN;  // and first column
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nc = (C + BK - 1) / BK;   // channel chunks a tap
  const int nk = 9 * nc;

  // this thread's A row and its output pixel, once
  const int ar = threadIdx.x / T::TPR, ai = threadIdx.x % T::TPR;
  const long long am = m0 + ar;
  const bool arow = am < M;
  int ah = 0, aw = 0;
  if (arow) {
    const int p = (int)(am % ((long long)H * W));
    ah = p / W;
    aw = p - ah * W;
  }
  Cursor cur{0, 0, 0, false, x};
  aim(cur, x, arow, am, ah, aw, H, W, C);
  // the cursor to the next step: the next chunk, or the next tap's first
  auto advance = [&]() {
    cur.c0 += BK;
    if (cur.c0 >= C) {
      cur.c0 = 0;
      if (++cur.dx == 3) {
        cur.dx = 0;
        ++cur.dy;
      }
      aim(cur, x, arow, am, ah, aw, H, W, C);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_stage<BM, BN, VEC>(xs + s * T::XS, ws + s * T::WS, x, w, cur, ar,
                              ai, C, O, n0);
      advance();
    }
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
    if (nxt < nk) {
      load_stage<BM, BN, VEC>(xs + (nxt % STAGES) * T::XS,
                              ws + (nxt % STAGES) * T::WS, x, w, cur, ar, ai,
                              C, O, n0);
      advance();
    }
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
      const long long m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      float* orow = out + m * O;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        if (VEC) {
          if (n < O)  // O % 4 == 0: n + 1 < O too
            *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < O) orow[n] = v0;
          if (n + 1 < O) orow[n + 1] = v1;
        }
      }
    }
  }
}


// -- the bfloat16 face ------------------------------------------------------
//
// The same walk, ring and tilings on bfloat16 tiles: A [BM][BK + 8] and
// B [BK][BN + 8] (pitches of 80 bytes and 2 BN + 16 bytes keep the 32-bit A
// fragment loads and the ldmatrix rows of B on distinct banks), one
// mma.sync.m16n8k16 a 16-deep slice, each step summed from zero on the
// tensor cores and added in float32. A 16-byte copy holds 8 channels, so
// the copies are asynchronous when C and O are multiples of 8 and the
// pointers 16-byte aligned; any other shape (C 3, 36; O 7) is staged by
// plain loads and stores, zeros past every edge, into the same ring.
constexpr int X_PAD_BF16 = 8;  // row padding of the A tile, bfloat16
constexpr int W_PAD_BF16 = 8;  // row padding of the B tile, bfloat16

template <int BM, int BN>
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
  static constexpr int TPR = THREADS / BM;
  static_assert(BM % 32 == 0 && BN % 32 == 0 && THREADS % BM == 0 &&
                (BK / 8) % TPR == 0 && BK % 16 == 0, "tiling");
};

template <int BM, int BN, bool VEC>
__device__ __forceinline__ void load_stage_bf16(
    bf16* xs, bf16* ws, const bf16* __restrict__ x,
    const bf16* __restrict__ w, const CursorT<bf16>& cur, int r, int s,
    int C, int O, int n0) {
  using T = TileB<BM, BN>;
  constexpr int TPR = T::TPR;
  bf16* dst = xs + r * T::XLD;
  const bf16* wt = w + ((long long)(cur.dy * 3 + cur.dx) * C + cur.c0) * O;
  if (VEC) {  // C % 8 == 0 and O % 8 == 0: a chunk is all in or all out
#pragma unroll
    for (int j = 0; j < BK / 8 / TPR; ++j) {
      const int q = 8 * (s + TPR * j);
      const bool in = cur.in && cur.c0 + q < C;
      cp_async16(dst + q, in ? cur.src + cur.c0 + q : x, in);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
      const int k = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool in = cur.c0 + k < C && n0 + c < O;
      cp_async16(ws + k * T::WLD + c,
                 in ? wt + (long long)k * O + n0 + c : w, in);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int j = 0; j < BK / TPR; ++j) {
      const int q = s + TPR * j;
      dst[q] = cur.in && cur.c0 + q < C ? cur.src[cur.c0 + q] : zero;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int k = i / BN, c = i % BN;
      ws[k * T::WLD + c] = cur.c0 + k < C && n0 + c < O
                               ? wt[(long long)k * O + n0 + c]
                               : zero;
    }
  }
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    void* __restrict__ out, bool out_f32, int H, int W,
                    int C, int O, long long M) {
  using T = TileB<BM, BN>;
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
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nc = (C + BK - 1) / BK;
  const int nk = 9 * nc;

  const int ar = threadIdx.x / T::TPR, ai = threadIdx.x % T::TPR;
  const long long am = m0 + ar;
  const bool arow = am < M;
  int ah = 0, aw = 0;
  if (arow) {
    const int p = (int)(am % ((long long)H * W));
    ah = p / W;
    aw = p - ah * W;
  }
  CursorT<bf16> cur{0, 0, 0, false, x};
  aim(cur, x, arow, am, ah, aw, H, W, C);
  auto advance = [&]() {
    cur.c0 += BK;
    if (cur.c0 >= C) {
      cur.c0 = 0;
      if (++cur.dx == 3) {
        cur.dx = 0;
        ++cur.dy;
      }
      aim(cur, x, arow, am, ah, aw, H, W, C);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_stage_bf16<BM, BN, VEC>(xs + s * T::XS, ws + s * T::WS, x, w, cur,
                                   ar, ai, C, O, n0);
      advance();
    }
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
    if (nxt < nk) {
      load_stage_bf16<BM, BN, VEC>(xs + (nxt % STAGES) * T::XS,
                                   ws + (nxt % STAGES) * T::WS, x, w, cur,
                                   ar, ai, C, O, n0);
      advance();
    }
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
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) add4(acc[mi][ni], step[mi][ni]);
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        // VEC: O % 8 == 0, so n + 1 < O with n and the pair aligned
        if (out_f32)
          store2(static_cast<float*>(out) + m * O + n, v0, v1, n < O,
                 n + 1 < O, VEC && n < O);
        else
          store2(static_cast<bf16*>(out) + m * O + n, v0, v1, n < O,
                 n + 1 < O, VEC && n < O);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the compiled tilings, largest first
constexpr int NTILINGS = 3;
constexpr int TILING_BM[NTILINGS] = {128, 128, 64};
constexpr int TILING_BN[NTILINGS] = {128, 64, 64};

// the SM count of the current device, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  return sms;
}

// The tiling rule: the first tiling, largest first, whose BN is at most
// max(64, O) and whose grid has at least 2 blocks an SM; else 64 x 64.
int pick_tiling(long long M, int O) {
  const long long want = 2LL * sm_count();
  for (int i = 0; i < NTILINGS; ++i) {
    const long long blocks = (M + TILING_BM[i] - 1) / TILING_BM[i] *
                             ((O + TILING_BN[i] - 1) / TILING_BN[i]);
    if (TILING_BN[i] <= (O > 64 ? O : 64) && blocks >= want) return i;
  }
  return NTILINGS - 1;
}

template <int BM, int BN>
int launch(const float* x, const float* w, float* out, int H, int W, int C,
           int O, long long M, bool vec, cudaStream_t st) {
  using T = Tile<BM, BN>;
  const long long mblocks = (M + BM - 1) / BM;
  const long long oblocks = ((long long)O + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || oblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  auto kernel = vec ? conv3x3_kernel<BM, BN, true>
                    : conv3x3_kernel<BM, BN, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, H, W, C, O, M);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_bf16(const bf16* x, const bf16* w, void* out, bool out_f32, int H,
                int W, int C, int O, long long M, bool vec, cudaStream_t st) {
  using T = TileB<BM, BN>;
  const long long mblocks = (M + BM - 1) / BM;
  const long long oblocks = ((long long)O + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || oblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  auto kernel = vec ? conv3x3_bf16_kernel<BM, BN, true>
                    : conv3x3_bf16_kernel<BM, BN, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, out_f32, H, W, C,
                                                O, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, H, W, C], w [3, 3, C, O] and out [N, H, W, O], float32,
// contiguous, on one device.
int conv3x3_s1_nhwc_f32(const void* x, const void* w, void* out, int N,
                        int H, int W, int C, int O, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && O % 4 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
  const int tiling = pick_tiling(M, O);
  switch (tiling) {
    case 0: return launch<128, 128>(xf, wf, of, H, W, C, O, M, vec, st);
    case 1: return launch<128, 64>(xf, wf, of, H, W, C, O, M, vec, st);
    default: return launch<64, 64>(xf, wf, of, H, W, C, O, M, vec, st);
  }
}

// x [N, H, W, C] and w [3, 3, C, O] bfloat16, out [N, H, W, O] float32
// when out_f32 is non-zero, else bfloat16; contiguous, on one device. The
// tiling rule is the float32 face's.
int conv3x3_s1_nhwc_bf16(const void* x, const void* w, void* out, int N,
                         int H, int W, int C, int O, int out_f32,
                         void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 8 == 0 && O % 8 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
  const bool f32 = out_f32 != 0;
  switch (pick_tiling(M, O)) {
    case 0:
      return launch_bf16<128, 128>(xb, wb, out, f32, H, W, C, O, M, vec, st);
    case 1:
      return launch_bf16<128, 64>(xb, wb, out, f32, H, W, C, O, M, vec, st);
    default:
      return launch_bf16<64, 64>(xb, wb, out, f32, H, W, C, O, M, vec, st);
  }
}

// Dynamic shared memory of a tiling's block, float32 (bf16_face 0) or
// bfloat16 face, or -1 for a tiling that is not compiled.
int conv3x3_smem_bytes(int bm, int bn, int bf16_face) {
#define TILING(BM_, BN_)                                  \
  if (bm == BM_ && bn == BN_)                             \
    return bf16_face ? TileB<BM_, BN_>::SMEM_BYTES        \
                     : Tile<BM_, BN_>::SMEM_BYTES;
  TILING(128, 128) TILING(128, 64) TILING(64, 64)
#undef TILING
  return -1;
}

// The tiling the entry point takes at a shape, as bm * 1000 + bn
// (128128, 128064 or 64064), or -1 for a shape it refuses.
int conv3x3_tiling(int N, int H, int W, int C, int O) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1) return -1;
  const int i = pick_tiling((long long)N * H * W, O);
  return TILING_BM[i] * 1000 + TILING_BN[i];
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
