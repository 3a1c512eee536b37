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
// The bfloat16 face (conv3x3_s1_nhwc_bf16, under AMP) computes the same
// function on bf16 operands: the JAX kernel is dtype-generic, `_kernel`
// sums `jnp.dot(..., preferred_element_type=float32)` of the bf16 tap
// products and writes `out_dtype`. Each product is exact in float32, the
// sums are float32, and the output is written once, in bfloat16 (rounded
// to nearest even) or float32.
// - What bounds it: at ResNet-50's stage shapes at batch 32 a call does
//   7.40 GFLOP, 7.48 us at the card's 989 TFLOP/s dense bf16; the bytes
//   (x and out read and written once, 2 bytes a value) take 7.69 us at
//   3.35 TB/s in the first stage (C = O = 64, bytes-bound) and 3.8 us or
//   less in the others (operations-bound).
// - Why a redesign: mma.sync cannot reach Hopper's bf16 rate (only wgmma
//   can); the float32 design's 32-channel steps cost a barrier and a
//   cp.async group each, its copies take every thread's issue slots and
//   registers, and its A fragments come through 32-bit shared loads.
// - Design: matmul.cu's warp-specialised wgmma GEMM (hopper.cuh) as an
//   implicit GEMM of M = N*H*W output pixels by O over K = 9*C, walked
//   tap-major, then channels in stages of CK = 64 (one 128-byte swizzled
//   row of bf16): 9 * ceil(C / 64) stages, none straddling two taps.
//   One producer thread issues TMA: A, the stage's shifted pixels, is one
//   im2col load of x as a 4-D [N, H, W, C] map (BM pixels of 64
//   channels; the tap is the load's offset, the walk's corners one pixel
//   in for pad 1, so the halo, the pixels past the last image and the
//   channels past C arrive as zeros, and a box runs on across image
//   boundaries: 128 pixels of 7 x 7 images span three). B is w [3, 3, C,
//   O] as a 3-D map {O, C, 9}, boxes of 64 o x 64 c x 1 tap, so the
//   channels past C zero-fill and never read the next tap's rows; wgmma
//   reads this N-major B through its transpose operand. A ring of RING_W
//   stages with a full and an empty mbarrier each; BM / 64 consumer
//   warpgroups on wgmma.m64n{BN}k16; the producer warpgroup drops to 40
//   registers, the consumers rise to 232 (setmaxnreg).
// - Sum order: each stage is summed from zero on the tensor cores (which
//   truncate as they accumulate) and added in float32 to a register
//   accumulator; the epilogue rounds in registers and stores pairs,
//   masked at the M and O edges. No atomics, no split of K: each output
//   is written once, so relaunches and all tilings agree bit for bit.
// - Tilings: BM in {128, 64} x BN in {128, 64}, template instances. The
//   rule (pick_tiling_wgmma): the first, largest first, whose BN is at
//   most max(64, O) and whose grid has blocks for at least half the SMs;
//   else 64 x 64. kernels/conv3x3.py mirrors it (tiling_bf16).
// - The ragged path: TMA needs 16-byte-aligned bases and pitches that
//   are multiples of 16 bytes, so C % 8 == 0 and O % 8 == 0 (and out
//   aligned). Other operands (C 3, C 36, O 7, a misaligned view) take
//   the face's first design, unchanged: the float32 design's walk, ring,
//   tilings and rule on bfloat16 tiles with mma.sync.m16n8k16
//   (conv3x3_bf16_ragged_kernel). The entry point picks the path by that
//   rule before the launch; conv3x3_s1_nhwc_bf16_ragged takes the ragged
//   path at any shape.
//
// Tensors are contiguous: x [N, H, W, C], w [3, 3, C, O], out [N, H, W, O].
// The kernel allocates nothing. The entry point launches on the stream it
// is given and returns a CUDA error code (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "bf16.cuh"
#include "hopper.cuh"
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


// -- the bfloat16 face's ragged path: mma.sync ---------------------------------
//
// The float32 design's walk, ring and tilings on bfloat16 tiles: A
// [BM][BK + 8] and B [BK][BN + 8] (pitches of 80 bytes and 2 BN + 16
// bytes keep the 32-bit A fragment loads and the ldmatrix rows of B on
// distinct banks), one mma.sync.m16n8k16 a 16-deep slice, each step
// summed from zero on the tensor cores and added in float32. A 16-byte
// copy holds 8 channels, so the copies are asynchronous when C and O are
// multiples of 8 and the pointers 16-byte aligned; any other shape (C 3,
// 36; O 7) is staged by plain loads and stores, zeros past every edge,
// into the same ring.
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
conv3x3_bf16_ragged_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           void* __restrict__ out, bool out_f32, int H,
                           int W, int C, int O, long long M) {
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

// -- the bfloat16 face: TMA + wgmma --------------------------------------------

constexpr int CK = 64;     // input channels a stage: one 128-byte swizzled row
constexpr int RING_W = 4;  // stages of the ring

template <int BM, int BN>
struct TileW {
  static constexpr int CONSUMERS = BM / 64;  // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int XS = BM * CK;         // values of a stage's pixel box
  static constexpr int WS = CK * BN;         // of its filter boxes
  static constexpr int STAGE_BYTES = (XS + WS) * (int)sizeof(bf16);
  // the ring, and slack to align it to the swizzle's 1024 bytes
  static constexpr int SMEM_BYTES = RING_W * STAGE_BYTES + 1024;
  // blocks an SM, and the registers a thread of the producer and of the
  // consumer warpgroups hold after setmaxnreg
  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "wgmma width");
};

// The pixel the im2col walk of an output tile starts from: its first
// output pixel m0 as (n, h, w), less one row and one column (pad 1).
struct WalkStart {
  int n, h, w;
};

__device__ __forceinline__ WalkStart walk_start(long long m0, int H, int W) {
  const long long hw = (long long)H * W;
  const int n = (int)(m0 / hw);
  const int p = (int)(m0 - n * hw);
  const int h = p / W;
  return WalkStart{n, h - 1, p - h * W - 1};
}

// the tile's shifted pixels of one stage: tap (dy, dx) = (tap / 3,
// tap % 3), channels c0 .. c0 + 63
__device__ __forceinline__ void load_pixels(void* dst, const CUtensorMap* map,
                                            uint64_t* bar,
                                            const WalkStart& at, int tap,
                                            int c0) {
  tma_load_im2col_4d(dst, map, bar, c0, at.w, at.h, at.n,
                     (uint16_t)(tap % 3), (uint16_t)(tap / 3));
}

template <int BM, int BN>
__global__ void __launch_bounds__(TileW<BM, BN>::THREADS,
                                  TileW<BM, BN>::BLOCKS_PER_SM)
conv3x3_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          void* __restrict__ out, bool out_f32, int H, int W,
                          int C, int O, long long M) {
  using T = TileW<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[RING_W], empty[RING_W];
  // the ring: RING_W pixel boxes, then RING_W filter stages, 1024-aligned
  bf16* xs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* ws = xs + RING_W * T::XS;

  const int wg = threadIdx.x / 128;  // 0 the producer, 1.. the consumers
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int nk = 9 * ((C + CK - 1) / CK);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < RING_W; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * T::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      const WalkStart at = walk_start(m0, H, W);
      int tap = 0, c0 = 0;  // the stage's tap and first channel
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % RING_W;
        mbar_wait(&empty[s], ((kt / RING_W) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        load_pixels(xs + s * T::XS, &xmap, &full[s], at, tap, c0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(ws + s * T::WS + j * 64 * CK, &wmap, &full[s],
                      o0 + 64 * j, c0, tap);
        c0 += CK;
        if (c0 >= C) {
          c0 = 0;
          ++tap;
        }
      }
    }
  } else {
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int rows = (wg - 1) * 64;  // the warpgroup's rows in the tile
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % RING_W;
      mbar_wait(&full[s], (kt / RING_W) & 1);
      const uint32_t a = smem_u32(xs + s * T::XS + rows * CK);
      const uint32_t b = smem_u32(ws + s * T::WS);
      // the stage's sum, from zero on the tensor cores
      wgmma_fence();
      wgmma_fence_operands(part);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)
        wgmma_bf16<BN>(part, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(b + 2048 * kk, 64 * CK * 2, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    const int lane = threadIdx.x % 32;
    const long long m = m0 + rows + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const long long r = m + 8 * ((i / 2) % 2);
      const int n = o0 + 8 * (i / 4) + 2 * (lane % 4);
      if (r >= M || n >= O) continue;  // O % 8 == 0: n + 1 < O too
      const long long o = r * O + n;
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

// the compiled tilings, largest first: the float32 face's and the bfloat16
// face's ragged path's, and the bfloat16 face's wgmma kernel's
constexpr int NTILINGS = 3;
constexpr int TILING_BM[NTILINGS] = {128, 128, 64};
constexpr int TILING_BN[NTILINGS] = {128, 64, 64};
constexpr int NTILINGS_W = 4;
constexpr int TILING_W_BM[NTILINGS_W] = {128, 128, 64, 64};
constexpr int TILING_W_BN[NTILINGS_W] = {128, 64, 128, 64};

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

// The wgmma kernel's rule (one block an SM): the first tiling, largest
// first, whose BN is at most max(64, O) and whose grid has blocks for at
// least half the SMs; else 64 x 64. A larger tile reads fewer bytes from
// the L2 a product, which at these shapes is worth more than the idle
// SMs of a wave that is not full.
int pick_tiling_wgmma(long long M, int O) {
  const long long want = (sm_count() + 1) / 2;
  for (int i = 0; i < NTILINGS_W; ++i) {
    const long long blocks = (M + TILING_W_BM[i] - 1) / TILING_W_BM[i] *
                             ((O + TILING_W_BN[i] - 1) / TILING_W_BN[i]);
    if (TILING_W_BN[i] <= (O > 64 ? O : 64) && blocks >= want) return i;
  }
  return NTILINGS_W - 1;
}

// The path of the bfloat16 face: the wgmma kernel where TMA can take the
// operands (C and O multiples of 8, every pointer 16-byte aligned), else
// the ragged path.
bool tma_path(int C, int O, const void* x, const void* w, const void* out) {
  return C % 8 == 0 && O % 8 == 0 && aligned16(x) && aligned16(w) &&
         aligned16(out);
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
int launch_bf16_ragged(const bf16* x, const bf16* w, void* out, bool out_f32,
                       int H, int W, int C, int O, long long M, bool vec,
                       cudaStream_t st) {
  using T = TileB<BM, BN>;
  const long long mblocks = (M + BM - 1) / BM;
  const long long oblocks = ((long long)O + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || oblocks > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  auto kernel = vec ? conv3x3_bf16_ragged_kernel<BM, BN, true>
                    : conv3x3_bf16_ragged_kernel<BM, BN, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, T::SMEM_BYTES, st>>>(x, w, out, out_f32, H, W, C,
                                                O, M);
  return (int)cudaGetLastError();
}

// x [N, H, W, C] in im2col boxes of BM pixels x 64 channels, w [3, 3, C,
// O] as {O, C, 9} in boxes of 64 x 64 x 1
template <int BM>
int encode_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                const void* w, int N, int H, int W, int C, int O) {
  int e = encode_im2col_3x3(xmap, x, N, H, W, C, CK, BM);
  return e ? e : encode_tma_3d(wmap, w, O, C, 9, 64, CK);
}

template <int BM, int BN>
int launch_wgmma(const void* x, const void* w, void* out, bool out_f32,
                 int N, int H, int W, int C, int O, cudaStream_t st) {
  using T = TileW<BM, BN>;
  const long long M = (long long)N * H * W;
  const long long mblocks = (M + BM - 1) / BM;
  const long long oblocks = ((long long)O + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || oblocks > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  int code = encode_maps<BM>(&xmap, &wmap, x, w, N, H, W, C, O);
  if (code) return code;
  auto kernel = conv3x3_bf16_wgmma_kernel<BM, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, st>>>(xmap, wmap, out, out_f32,
                                                  H, W, C, O, M);
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

// The bfloat16 face's ragged path at any shape: the float32 face's tiling
// rule, mma.sync; the arguments of conv3x3_s1_nhwc_bf16.
int conv3x3_s1_nhwc_bf16_ragged(const void* x, const void* w, void* out,
                                int N, int H, int W, int C, int O,
                                int out_f32, void* stream) {
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
      return launch_bf16_ragged<128, 128>(xb, wb, out, f32, H, W, C, O, M,
                                          vec, st);
    case 1:
      return launch_bf16_ragged<128, 64>(xb, wb, out, f32, H, W, C, O, M,
                                         vec, st);
    default:
      return launch_bf16_ragged<64, 64>(xb, wb, out, f32, H, W, C, O, M,
                                        vec, st);
  }
}

// The bfloat16 face's wgmma kernel at the tiling bm x bn (one of the
// compiled ones), on operands TMA can take; the arguments of
// conv3x3_s1_nhwc_bf16, then the tiling. Refuses any other tiling or
// operands.
int conv3x3_s1_nhwc_bf16_wgmma(const void* x, const void* w, void* out,
                               int N, int H, int W, int C, int O,
                               int out_f32, int bm, int bn, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 ||
      !tma_path(C, O, x, w, out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0;
#define TILING(BM_, BN_)      \
  if (bm == BM_ && bn == BN_) \
    return launch_wgmma<BM_, BN_>(x, w, out, f32, N, H, W, C, O, st);
  TILING(128, 128) TILING(128, 64) TILING(64, 128) TILING(64, 64)
#undef TILING
  return (int)cudaErrorInvalidValue;
}

// x [N, H, W, C] and w [3, 3, C, O] bfloat16, out [N, H, W, O] float32
// when out_f32 is non-zero, else bfloat16; contiguous, on one device.
// Operands TMA can take (C and O multiples of 8, every pointer 16-byte
// aligned) run the wgmma kernel at the tiling of pick_tiling_wgmma, any
// other the ragged path.
int conv3x3_s1_nhwc_bf16(const void* x, const void* w, void* out, int N,
                         int H, int W, int C, int O, int out_f32,
                         void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  if (!tma_path(C, O, x, w, out))
    return conv3x3_s1_nhwc_bf16_ragged(x, w, out, N, H, W, C, O, out_f32,
                                       stream);
  const int i = pick_tiling_wgmma((long long)N * H * W, O);
  return conv3x3_s1_nhwc_bf16_wgmma(x, w, out, N, H, W, C, O, out_f32,
                                    TILING_W_BM[i], TILING_W_BN[i], stream);
}

// Dynamic shared memory of a tiling's block, float32 (bf16_face 0) or
// the bfloat16 face's ragged path, or -1 for a tiling that is not
// compiled.
int conv3x3_smem_bytes(int bm, int bn, int bf16_face) {
#define TILING(BM_, BN_)                                  \
  if (bm == BM_ && bn == BN_)                             \
    return bf16_face ? TileB<BM_, BN_>::SMEM_BYTES        \
                     : Tile<BM_, BN_>::SMEM_BYTES;
  TILING(128, 128) TILING(128, 64) TILING(64, 64)
#undef TILING
  return -1;
}

// Dynamic shared memory of a wgmma tiling's block, or -1 for a tiling
// that is not compiled.
int conv3x3_bf16_wgmma_smem_bytes(int bm, int bn) {
#define TILING(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return TileW<BM_, BN_>::SMEM_BYTES;
  TILING(128, 128) TILING(128, 64) TILING(64, 128) TILING(64, 64)
#undef TILING
  return -1;
}

// The tiling the float32 entry point takes at a shape, as bm * 1000 + bn
// (128128, 128064 or 64064), or -1 for a shape it refuses.
int conv3x3_tiling(int N, int H, int W, int C, int O) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1) return -1;
  const int i = pick_tiling((long long)N * H * W, O);
  return TILING_BM[i] * 1000 + TILING_BN[i];
}

// The path and tiling the bfloat16 entry point takes at a shape, its
// pointers 16-byte aligned or not: 1000000 + bm * 1000 + bn for the
// wgmma kernel, bm * 1000 + bn for the ragged path, -1 for a shape it
// refuses.
int conv3x3_bf16_tiling(int N, int H, int W, int C, int O, int aligned) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1) return -1;
  const long long M = (long long)N * H * W;
  if (!(aligned && C % 8 == 0 && O % 8 == 0)) {
    const int i = pick_tiling(M, O);
    return TILING_BM[i] * 1000 + TILING_BN[i];
  }
  const int i = pick_tiling_wgmma(M, O);
  return 1000000 + TILING_W_BM[i] * 1000 + TILING_W_BN[i];
}

// Host microseconds, on mean over `reps`, to encode the two tensor maps a
// launch of the wgmma kernel at row tiling bm needs; negative on an error.
double conv3x3_bf16_encode_us(const void* x, const void* w, int N, int H,
                              int W, int C, int O, int bm, int reps) {
  CUtensorMap xmap, wmap;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int e = bm == 64
                      ? encode_maps<64>(&xmap, &wmap, x, w, N, H, W, C, O)
                      : encode_maps<128>(&xmap, &wmap, x, w, N, H, W, C, O);
    if (e) return -1.0;
  }
  const std::chrono::duration<double, std::micro> took =
      std::chrono::steady_clock::now() - t0;
  return took.count() / reps;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
