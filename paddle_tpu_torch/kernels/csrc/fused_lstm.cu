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
// behind a grid-wide barrier, T - 1 of them in all.
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
// Tensors are contiguous float32. The kernel allocates nothing; the
// entry point zeroes the barrier counter on the stream, launches on it
// and returns the CUDA error code.
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

// the gate inputs and the mask of step t at a thread's pairs
__device__ __forceinline__ void load_x(float (&x)[PAIRS][GATES],
                                       float (&m)[PAIRS],
                                       const float* __restrict__ xs,
                                       const float* __restrict__ mask,
                                       const int (&at)[PAIRS], int t, int N,
                                       int D) {
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    if (at[i] < 0) continue;
    const int row = at[i] / D, j = at[i] - row * D;
    const float* p = xs + ((size_t)t * N + row) * GATES * D + j;
#pragma unroll
    for (int q = 0; q < GATES; ++q) x[i][q] = __ldg(p + q * D);
    m[i] = __ldg(mask + (size_t)t * N + row);
  }
}

// WS: the form of W (setup_w); G: the unit groups a block owns
template <typename WS, int G>
__global__ void __launch_bounds__(THREADS, 1)
fused_lstm_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ mask, float* hs, float* cs,
                  unsigned int* barrier, int T, int N, int D, int rows) {
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
    float h[G][PAIRS], c[G][PAIRS], x[G][PAIRS][GATES], m[G][PAIRS];
    float nx[G][PAIRS][GATES], nm[G][PAIRS];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int p = threadIdx.x + i * THREADS, n = p / DJ,
                  j = j0[g] + p % DJ;
        at[g][i] = n < nr && j < D ? (r0 + n) * D + j : -1;
        h[g][i] = at[g][i] >= 0 ? h0[at[g][i]] : 0.f;
        c[g][i] = at[g][i] >= 0 ? c0[at[g][i]] : 0.f;
        m[g][i] = nm[g][i] = 0.f;
#pragma unroll
        for (int q = 0; q < GATES; ++q) x[g][i][q] = nx[g][i][q] = 0.f;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) load_x(x[g], m[g], xs, mask, at[g], 0, N, D);
    for (int t = 0; t < T; ++t) {
      const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * ND;
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
              tanhf(x[g][i][0] + gather<ROWS, RP>(red, n, jl));
          const float ig =
              sigmoid_f(x[g][i][1] + gather<ROWS, RP>(red, n, DJ + jl));
          const float fg =
              sigmoid_f(x[g][i][2] + gather<ROWS, RP>(red, n, 2 * DJ + jl));
          const float og =
              sigmoid_f(x[g][i][3] + gather<ROWS, RP>(red, n, 3 * DJ + jl));
          const float cn = fg * c[g][i] + ig * cand;
          const float hn = og * tanhf(cn);
          h[g][i] = hn * m[g][i] + h[g][i] * (1.f - m[g][i]);
          c[g][i] = cn * m[g][i] + c[g][i] * (1.f - m[g][i]);
          hs[(size_t)t * ND + at[g][i]] = h[g][i];
        }
      }
      if (t + 1 < T) grid_arrive(barrier);
      // c, which no other block reads, while the other blocks arrive
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] >= 0) cs[(size_t)t * ND + at[g][i]] = c[g][i];
          m[g][i] = nm[g][i];
#pragma unroll
          for (int q = 0; q < GATES; ++q) x[g][i][q] = nx[g][i][q];
        }
      if (t + 1 < T) grid_wait(barrier, gridDim.x * ++passed);
    }
  }
}

// the kernel's three forms, in plan's order
const void* const FORMS[3] = {
    (const void*)fused_lstm_kernel<const uint4*, 1>,
    (const void*)fused_lstm_kernel<const float2*, 1>,
    (const void*)fused_lstm_kernel<WGlobal<NF>, 2>};

}  // namespace

extern "C" {

// The launch shape of N rows of D units on the current device: info[7]
// receives blocks, units a block, rows a block's piece, shared bytes,
// threads, co-resident blocks per SM and SMs.
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
  if (T < 1 || N < 1 || D < 4 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel;
  int blocks, units, rows, per_sm, sms;
  size_t smem;
  cudaError_t e =
      plan<DJ, ROWS, NF, RP>(N, D, FORMS, &kernel, &blocks, &units,
                             &rows, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st)) !=
      cudaSuccess)
    return (int)e;
  const float* xf = static_cast<const float*>(xs);
  const float* wf = static_cast<const float*>(w);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  const float* mf = static_cast<const float*>(mask);
  float* hsf = static_cast<float*>(hs);
  float* csf = static_cast<float*>(cs);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {(void*)&xf, (void*)&wf, (void*)&h0f, (void*)&c0f,
                  (void*)&mf, (void*)&hsf, (void*)&csf, (void*)&bar,
                  (void*)&T, (void*)&N, (void*)&D, (void*)&rows};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                  smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
