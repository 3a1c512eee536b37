// The whole LSTM recurrence of a ragged batch in one launch, float32-exact
// on Hopper's tensor cores (3xTF32), for sm_90a.
//
// Replaces: paddle_tpu/kernels/fused_lstm.py, `_forward` (its
// pallas_call) with the kernel body `_kernel`, reached through
// `fused_lstm`. For t = 0 .. T-1, with h, c starting at h0, c0:
//   g = xs[t] + h @ W                      (gate slabs c~, i, f, o)
//   c' = sigmoid(g_f) * c + sigmoid(g_i) * tanh(g_c~)
//   h' = sigmoid(g_o) * tanh(c')
//   h = h' * m + h * (1 - m),  c = c' * m + c * (1 - m),  m = mask[t, n]
// and hs[t] = h, cs[t] = c. xs [T, N, 4D] is the pre-projected gate input
// (bias folded in), W [D, 4D], h0/c0 [N, D], mask [T, N]; hs, cs
// [T, N, D]. A masked step carries the state through (ragged batches).
//
// What bounds it on the H100. Operations: 2 * T * N * D * 4D flops, in
// 3xTF32 three TF32 products each; at T 100, N 64, D 512 that is 0.0813
// ms at 495 TFLOP/s against 83.1 MB (0.025 ms at 3.35 TB/s). In fact the
// serial chain bounds it: a step needs every unit's h_{t-1}, so each
// step reads the whole of h that all blocks wrote in the step before,
// behind a grid-wide barrier, T - 1 of them in all. The bfloat16 face
// (below) does the same operations on 43.6 MB (xs 26.2, hs and cs 13.1,
// W 4.2): 0.013 ms of bytes, so 0.0813 ms of operations bounds it too.
//
// Design: one persistent cooperative launch, the design of the GRU kernel
// (fused_gru.cu) with one phase a step where the GRU has two. A block
// owns DJ = 8 units (a unit group) and all four gates of them, of the
// rows of its row group: the rows are independent, only the units cross
// blocks, so the SMs the unit groups leave free take a share of the rows
// each (at D 512, N 64: 64 unit groups, 2 row groups of 32 rows, 128
// blocks, one an SM). Rows past a launch's row groups are walked in
// pieces, each piece through all T steps. A step: h_{t-1} [rows, D] @
// W[:, c~ | i | f | o of the block's units] [D, 4 DJ], the gate math, h_t
// to hs[t] and c_t to cs[t]. What it does about the costs of a step
// (recurrence.cuh holds the parts it shares with the GRU):
//   - the products run on mma.sync.m16n8k8 tf32 in 3xTF32 (tf32x3.cuh).
//     The block's 32 W columns make 4 n8 fragment columns, one a gate, so
//     a thread finds the four gate sums of a (row, unit) pair at the same
//     place of each. They are split into hi and lo once, before the time
//     loop, and stay in shared memory as B fragments. The K = D reduction
//     is split across the 8 warps, a k tile's B fragments loaded once for
//     all its m tiles, each chain summed from zero on the tensor cores
//     (the large terms and the small ones apart); the chains and then the
//     8 warps' partial sums are added in float32 in a fixed order, so a
//     relaunch is bit-identical;
//   - a piece holds at most 32 rows (2 m tiles): the 4 gate columns of 4
//     m tiles would want 128 floats of chains alone and spill;
//   - each warp stages only its K slice of its block's rows of h_{t-1}
//     with cp.async.cg (L2 only: other SMs wrote it), in two groups of k
//     tiles, and multiplies each group as it lands: no block-wide
//     barrier between copy and product (64 KB a block a step at D 512);
//   - the gate inputs xs[t + 1] and the mask of a thread's (row, unit)
//     pairs are loaded as the step's products start, under them (a
//     __syncthreads waits for the thread's loads in flight, so none may
//     be left for the barrier's);
//   - h and c of the thread's pairs stay in registers from step to step:
//     hs[t] is written before the barrier's arrive, cs[t], which no other
//     block reads, between its arrive and its wait, and nothing is read
//     back;
//   - the grid barrier is one red.release.gpu add a block and a spin on
//     ld.acquire.gpu, with no fence pair.
// Shared memory at D 512: 128 KB of W fragments and 65 KB for the staged
// 32 rows, which the 8 warps' partial sums (40 KB) reuse. Where the split
// fragments (8 bytes a weight) leave too little room for the rows a
// block needs, W is kept as its floats and split at each load instead
// (D 1024: 16 rows a piece). Where the unit groups outnumber the SMs (D
// above 1056 on an H100), a block owns two of them, g and g + half their
// count: it stages its rows once a step and multiplies them by each
// group's columns in turn, reading W from global memory (L2) at each
// load; the partial sums then have room of their own. That reaches D 2112
// on an H100 (the CUDA-core kernel this replaced took D up to 1320).
//
// The bfloat16 face (fused_lstm_bf16) is the same kernel on bfloat16 xs,
// h0, c0, hs and cs with float32 W and mask, as the JAX kernel computes
// them under pure AMP: h0 and c0 are widened as they are loaded (the
// kernel's h_scr / c_scr start as float32 copies of h0 / c0), x_t where
// the gate math takes it (loaded a step ahead, its 16 bits kept as they
// lie: widening at the load made each step wait for the read of xs, 0.7
// us a step on an H100), the products, gates and state stay float32
// through all T steps, and hs[t] and cs[t] are rounded once to nearest
// even as they are stored. The blocks cannot exchange h through the
// rounded hs, which would multiply W by another h than the JAX kernel's
// float32 scratch: each step also writes its float32 h to the exchange
// hx [2, N, D], and step t stages h_{t-1} from slot (t - 1) & 1. Two
// slots suffice: every block has staged slot (t - 1) & 1 before it
// arrives at step t's barrier, so no block writes that slot again (at
// step t + 1) before all have read it.
// cp.async copies bytes and cannot widen, so step 0's h0 reaches slot 1
// widened by the threads that own its pairs (each its own), behind one
// grid barrier more a piece. The staged rows stay float32, so shared
// memory and the plan are the float32 face's.
//
// Tensors are contiguous. The kernel allocates nothing; the entry point
// zeroes the barrier counter on the stream, launches on it and returns
// the CUDA error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

constexpr int DJ = 8;                      // units a unit group
constexpr int GATES = 4;                   // W's slabs: c~, i, f, o
constexpr int ROWS = 32;                   // rows of a piece, at most
constexpr int MT = ROWS / 16;              // its m16 tiles
constexpr int NF = GATES * DJ / 8;         // n8 fragment columns, a gate each
constexpr int CA = 8 * NF;                 // columns of a partial sum
// its row pitch: 8 or 24 banks apart, so that the float2 stores of a C
// fragment and the gathers of its columns meet no bank twice
constexpr int RP = CA % 32 == 0 || CA % 32 == 16 ? CA + 8 : CA;
constexpr int PAIRS = ROWS * DJ / THREADS; // (row, unit) pairs a thread
static_assert(ROWS * DJ % THREADS == 0, "pairs must tile the threads");
static_assert(DJ == 8, "a gate's units fill one n8 fragment column");

// The column of W in fragment column nt (gate nt), lane row n, of the
// unit group whose first unit is j0; -1 past D.
__device__ __forceinline__ int w_col(int nt, int n, int j0, int D) {
  return j0 + n < D ? nt * D + j0 + n : -1;
}

// The gate inputs of the next step are loaded under the products and
// kept as they lie (Bits: a bfloat16's 16 bits) until the gate math
// widens them: an instruction that uses a load's value waits for it, so
// widening at the load would stall the step on the read of xs.
template <typename E>
struct Bits {
  typedef float type;
};
template <>
struct Bits<__nv_bfloat16> {
  typedef unsigned short type;
};
// an element of xs, h0 or c0 in float32 (bfloat16 widens exactly: its
// bits are the high half of the float's); and a state stored in the
// outputs' type (bfloat16 rounded to nearest even)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float((unsigned int)v << 16);
}
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ldg_bits(const float* p) { return __ldg(p); }
__device__ __forceinline__ Bits<__nv_bfloat16>::type ldg_bits(
    const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the gate inputs (as they lie) and the mask of step t at a thread's
// pairs
template <typename E>
__device__ __forceinline__ void load_x(
    typename Bits<E>::type (&x)[PAIRS][GATES], float (&m)[PAIRS],
    const E* __restrict__ xs, const float* __restrict__ mask,
    const int (&at)[PAIRS], int t, int N, int D) {
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    if (at[i] < 0) continue;
    const int row = at[i] / D, j = at[i] - row * D;
    const E* p = xs + ((size_t)t * N + row) * GATES * D + j;
#pragma unroll
    for (int q = 0; q < GATES; ++q) x[i][q] = ldg_bits(p + q * D);
    m[i] = __ldg(mask + (size_t)t * N + row);
  }
}

// E: the type of xs, h0, c0, hs and cs (float, or __nv_bfloat16 with the
// exchange hx); WS: the form of W (setup_w); G: the unit groups a block
// owns
template <typename E, typename WS, int G>
__global__ void __launch_bounds__(THREADS, 1)
fused_lstm_kernel(const E* __restrict__ xs, const float* __restrict__ w,
                  const E* __restrict__ h0, const E* __restrict__ c0,
                  const float* __restrict__ mask, E* hs, E* cs, float* hx,
                  unsigned int* barrier, int T, int N, int D, int rows) {
  // h crosses blocks through hx in float32 where the outputs are narrower
  constexpr bool EXCHANGE = sizeof(E) < sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  const int KT = (D + 7) >> 3;             // k8 tiles of D
  // row pitch of the staged rows: 8 banks apart, so that a fragment's
  // 8-byte loads meet no bank twice in a half warp
  const int ldh = 8 * KT + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // block (row group rg, unit block ub) owns the unit groups ub, ub +
  // ublocks, .. (G of them) of rows [rg rows, (rg + 1) rows) of each
  // piece of `splits` * rows
  const int ublocks = ((D + DJ - 1) / DJ + G - 1) / G;
  const int ub = blockIdx.x % ublocks;
  const int rg = blockIdx.x / ublocks, splits = gridDim.x / ublocks;
  const int k0 = warp * KT / WARPS, k1 = (warp + 1) * KT / WARPS;
  int j0[G];
#pragma unroll
  for (int g = 0; g < G; ++g) j0[g] = (ub + g * ublocks) * DJ;
  WS ws[G];
  float* hb = setup_w<NF, GATES>(ws, smem, w, j0, D, KT);
  // the partial sums: over the staged rows where a block owns one unit
  // group (its products are done with them), after them where it owns
  // more (the next group's products read them again)
  float* red = G == 1 ? hb : hb + ((rows + 15) & ~15) * ldh;

  Walk walks[GROUPS];
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) walks[q] = walk(k0, k1, q, lane);

  const size_t ND = (size_t)N * D;
  unsigned int passed = 0;
  for (int p0 = 0; p0 < N; p0 += splits * rows) {
    const int r0 = p0 + rg * rows;
    const int nr = max(0, min(rows, N - r0));  // 0: a block with no rows
                                               // still meets the barriers
    // this thread's (row, unit) pairs of each unit group: their state and
    // gate inputs
    int at[G][PAIRS];                      // row * D + unit, or -1
    float h[G][PAIRS], c[G][PAIRS], m[G][PAIRS], nm[G][PAIRS];
    typename Bits<E>::type x[G][PAIRS][GATES], nx[G][PAIRS][GATES];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int p = threadIdx.x + i * THREADS, n = p / DJ,
                  j = j0[g] + p % DJ;
        at[g][i] = n < nr && j < D ? (r0 + n) * D + j : -1;
        h[g][i] = at[g][i] >= 0 ? widen(h0[at[g][i]]) : 0.f;
        c[g][i] = at[g][i] >= 0 ? widen(c0[at[g][i]]) : 0.f;
        m[g][i] = nm[g][i] = 0.f;
#pragma unroll
        for (int q = 0; q < GATES; ++q) x[g][i][q] = nx[g][i][q] = 0;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) load_x(x[g], m[g], xs, mask, at[g], 0, N, D);
    if constexpr (EXCHANGE) {
      // h0 widened into slot 1, which step 0 stages, each pair by its
      // owner; then all blocks meet
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < PAIRS; ++i)
          if (at[g][i] >= 0) hx[ND + at[g][i]] = h[g][i];
      grid_arrive(barrier);
      grid_wait(barrier, gridDim.x * ++passed);
    }
    for (int t = 0; t < T; ++t) {
      const float* hprev;
      if constexpr (EXCHANGE)
        hprev = hx + (size_t)((t + 1) & 1) * ND;   // slot (t - 1) & 1
      else
        hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * ND;
      __syncthreads();                     // hb's last readers are done
      stage_slice(hb, ldh, hprev, r0, nr, D, walks);
      // the next step's gate inputs, landing under the products
      if (t + 1 < T) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          load_x(nx[g], nm[g], xs, mask, at[g], t + 1, N, D);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc[MT][NF][4];
        products(acc, hb, ldh, ws[g], KT, 0, k0, k1, nr, lane);
        __syncthreads();
        put_partials<RP>(red, acc, warp, lane);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] < 0) continue;
          const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
          const float cand =
              tanhf(widen(x[g][i][0]) + gather<ROWS, RP>(red, n, jl));
          const float ig = sigmoid_f(widen(x[g][i][1]) +
                                     gather<ROWS, RP>(red, n, DJ + jl));
          const float fg = sigmoid_f(widen(x[g][i][2]) +
                                     gather<ROWS, RP>(red, n, 2 * DJ + jl));
          const float og = sigmoid_f(widen(x[g][i][3]) +
                                     gather<ROWS, RP>(red, n, 3 * DJ + jl));
          const float cn = fg * c[g][i] + ig * cand;
          const float hn = og * tanhf(cn);
          h[g][i] = hn * m[g][i] + h[g][i] * (1.f - m[g][i]);
          c[g][i] = cn * m[g][i] + c[g][i] * (1.f - m[g][i]);
          put(hs + (size_t)t * ND + at[g][i], h[g][i]);
          if constexpr (EXCHANGE)              // what the others stage
            hx[(size_t)(t & 1) * ND + at[g][i]] = h[g][i];
        }
      }
      if (t + 1 < T) grid_arrive(barrier);
      // c, which no other block reads, while the other blocks arrive
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] >= 0) put(cs + (size_t)t * ND + at[g][i], c[g][i]);
          m[g][i] = nm[g][i];
#pragma unroll
          for (int q = 0; q < GATES; ++q) x[g][i][q] = nx[g][i][q];
        }
      if (t + 1 < T) grid_wait(barrier, gridDim.x * ++passed);
    }
  }
}

// the kernel's three forms of each face, in plan's order
const void* const FORMS[3] = {
    (const void*)fused_lstm_kernel<float, const uint4*, 1>,
    (const void*)fused_lstm_kernel<float, const float2*, 1>,
    (const void*)fused_lstm_kernel<float, WGlobal<NF>, 2>};
const void* const FORMS_BF16[3] = {
    (const void*)fused_lstm_kernel<__nv_bfloat16, const uint4*, 1>,
    (const void*)fused_lstm_kernel<__nv_bfloat16, const float2*, 1>,
    (const void*)fused_lstm_kernel<__nv_bfloat16, WGlobal<NF>, 2>};

// One launch of the face of type E (its forms) on the stream; hx: the
// exchange of the bfloat16 face, unused by the float32 one.
template <typename E>
int launch(const void* const (&forms)[3], const void* xs, const void* w,
           const void* h0, const void* c0, const void* mask, void* hs,
           void* cs, void* hx, void* barrier, int T, int N, int D,
           void* stream) {
  if (T < 1 || N < 1 || D < 4 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel;
  int blocks, units, rows, per_sm, sms;
  size_t smem;
  cudaError_t e =
      plan<DJ, ROWS, NF, RP>(N, D, forms, &kernel, &blocks, &units,
                             &rows, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st)) !=
      cudaSuccess)
    return (int)e;
  const E* xe = static_cast<const E*>(xs);
  const float* wf = static_cast<const float*>(w);
  const E* h0e = static_cast<const E*>(h0);
  const E* c0e = static_cast<const E*>(c0);
  const float* mf = static_cast<const float*>(mask);
  E* hse = static_cast<E*>(hs);
  E* cse = static_cast<E*>(cs);
  float* hxf = static_cast<float*>(hx);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {(void*)&xe,  (void*)&wf,  (void*)&h0e, (void*)&c0e,
                  (void*)&mf,  (void*)&hse, (void*)&cse, (void*)&hxf,
                  (void*)&bar, (void*)&T,   (void*)&N,   (void*)&D,
                  (void*)&rows};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                  smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch shape of N rows of D units on the current device (either
// face): info[7] receives blocks, units a block, rows a block's piece,
// shared bytes, threads, co-resident blocks per SM and SMs.
int fused_lstm_plan(int N, int D, int* info) {
  if (N < 1 || D < 4 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const void* kernel;
  int blocks, units, rows, per_sm, sms;
  size_t smem;
  const cudaError_t e =
      plan<DJ, ROWS, NF, RP>(N, D, FORMS, &kernel, &blocks, &units,
                             &rows, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {blocks, units, rows, (int)smem, THREADS, per_sm, sms};
  for (int i = 0; i < 7; ++i) info[i] = vals[i];
  return 0;
}

// xs [T, N, 4D], w [D, 4D], h0/c0 [N, D], mask [T, N], hs/cs [T, N, D],
// float32, contiguous, on one device; barrier: one uint32 of scratch.
int fused_lstm_f32(const void* xs, const void* w, const void* h0,
                   const void* c0, const void* mask, void* hs, void* cs,
                   void* barrier, int T, int N, int D, void* stream) {
  return launch<float>(FORMS, xs, w, h0, c0, mask, hs, cs, nullptr,
                       barrier, T, N, D, stream);
}

// The same shapes with xs, h0, c0, hs and cs bfloat16 and w and mask
// float32; hx: float32 scratch of 2 * N * D, the exchange of h.
int fused_lstm_bf16(const void* xs, const void* w, const void* h0,
                    const void* c0, const void* mask, void* hs, void* cs,
                    void* hx, void* barrier, int T, int N, int D,
                    void* stream) {
  if (hx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(FORMS_BF16, xs, w, h0, c0, mask, hs, cs,
                               hx, barrier, T, N, D, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
