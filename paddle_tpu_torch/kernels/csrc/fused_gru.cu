// The whole GRU recurrence of a ragged batch in one launch, float32-exact
// on Hopper's tensor cores (3xTF32), for sm_90a.
//
// Replaces: paddle_tpu/kernels/fused_gru.py, `_forward` (its
// pallas_call) with the kernel body `_kernel`, reached through
// `fused_gru`. For t = 0 .. T-1, with h starting at h0:
//   u = sigmoid(x_u + h @ W_u),  r = sigmoid(x_r + h @ W_r)
//   cand = tanh(x_c + (r * h) @ W_c)
//   h' = (1 - u) * h + u * cand
//   h = h' * m + h * (1 - m),  m = mask[t, n]
// and hs[t] = h. xs [T, N, 3D] is the pre-projected input (bias folded
// in) in the slabs (u, r, c); W [D, 3D] is [W_u | W_r | W_c]; h0 [N, D],
// mask [T, N], hs [T, N, D]. The reset gate multiplies h before the
// candidate's product (Paddle's GRU; PyTorch's applies it after).
//
// What bounds it on the H100. Operations: 2 * T * N * D * 3D flops, in
// 3xTF32 three TF32 products each; at T 100, N 64, D 512 that is 0.0610
// ms at 495 TFLOP/s against 55.6 MB (0.017 ms at 3.35 TB/s). In fact the
// serial chain bounds it: a step needs every unit's r * h before any
// candidate, so a step is two phases with a grid-wide barrier after
// each, 2T - 1 barriers in all, and each phase reads the whole of h (or
// r * h) that all blocks wrote in the phase before.
//
// Design: one persistent cooperative launch. A block owns DJ units (a
// unit group) of the rows of its row group: the rows are independent,
// only the units cross blocks, so the SMs the unit groups leave free
// take a share of the rows each (at D 512: 64 unit groups, 2 row groups
// of 32 rows, 128 blocks, one an SM). Rows past a launch's row groups
// are walked in pieces, each piece through all T steps. A step:
//   A. h_{t-1} [rows, D] @ W[:, u | r of the block's units] [D, 2 DJ]:
//      u and r; r * h_{t-1} of the block's units to the scratch rh.
//   B. rh [rows, D] @ W[:, cand] [D, DJ]: the candidate, then h_t to
//      hs[t].
// What it does about the costs of a step (recurrence.cuh holds the parts
// it shares with the LSTM kernel, fused_lstm.cu):
//   - the products run on mma.sync.m16n8k8 tf32 in 3xTF32 (tf32x3.cuh).
//     The block's W columns are split into hi and lo once, before the
//     time loop, and stay in shared memory as B fragments (16 bytes a
//     lane, one load a fragment). The K = D reduction is split across
//     the 8 warps: warp w multiplies k tiles [w KT / 8, (w+1) KT / 8) of
//     every row, a k tile's B fragments loaded once for all its m tiles
//     and their chains side by side (the large terms and the small ones
//     apart), each sum from zero on the tensor cores; the chains and
//     then the 8 warps' partial sums are added in float32 in a fixed
//     order (the warps' through shared memory), so a relaunch is
//     bit-identical;
//   - each warp stages only its K slice of its block's rows of h_{t-1}
//     (or rh) with cp.async.cg (L2 only: other SMs wrote it), in two
//     groups of k tiles, and multiplies each group as it lands: no
//     block-wide barrier between copy and product. Staging costs a
//     phase the most (a block reads all D columns of its rows, 64 KB at
//     D 512), hence the row groups;
//   - the gate inputs xs[t + 1] and the mask of a thread's (row, unit)
//     pairs are loaded as phase B of step t starts, under its products
//     and before the barrier that precedes step t + 1 (a __syncthreads
//     waits for the thread's loads in flight, so none may be left for
//     the barrier's);
//   - u and h of the block's own units stay in registers from phase A to
//     phase B and from step to step; only rh (after A) and hs[t] (after
//     B) cross blocks, and u is computed while the block waits at the
//     barrier after A;
//   - the grid barrier is one red.release.gpu add a block and a spin on
//     ld.acquire.gpu, with no fence pair.
// Shared memory at D 512: 96 KB of W fragments, 65 KB for the staged 32
// rows, which the 8 warps' partial sums (48 KB) reuse. Where the split
// fragments (8 bytes a weight) leave too little room for the rows a
// block needs, W is kept as its floats and split at each load instead
// (D 1024). A block stages at most 64 rows, fewer (a multiple of 16)
// where they do not fit. Where the unit groups outnumber the SMs (D above
// 1056 on an H100), a block owns two of them, g and g + half their
// count: it stages its rows once a phase and multiplies them by each
// group's columns in turn, reading W from global memory (L2) at each
// load, as neither group's fragments fit beside the rows; the partial
// sums then have room of their own. That reaches D 2112 on an H100 (the
// CUDA-core kernel this replaced took D up to 1564).
//
// Tensors are contiguous float32. The kernel allocates nothing; the
// entry point zeroes the barrier counter on the stream, launches on it
// and returns the CUDA error code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

constexpr int DJ = 8;                      // units a unit group
constexpr int ROWS = 64;                   // rows of a piece, at most
constexpr int MT = ROWS / 16;              // its m16 tiles
constexpr int NA = (2 * DJ + 7) / 8;       // n8 tiles of phase A (u | r)
constexpr int NB = (DJ + 7) / 8;           // n8 tiles of phase B (cand)
constexpr int CA = 8 * NA;                 // columns of a partial sum
// its row pitch: 8 or 24 banks apart, so that the float2 stores of a C
// fragment and the gathers of its columns meet no bank twice
constexpr int RP = CA % 32 == 0 || CA % 32 == 16 ? CA + 8 : CA;
constexpr int PAIRS = ROWS * DJ / THREADS; // (row, unit) pairs a thread
static_assert(ROWS * DJ % THREADS == 0, "pairs must tile the threads");

// The column of W in fragment column nt, lane row n, of the unit group
// whose first unit is j0: phase A's column c is unit c's u (c < DJ) or
// unit c - DJ's r, phase B's unit c's candidate; -1 past D.
__device__ __forceinline__ int w_col(int nt, int n, int j0, int D) {
  if (nt < NA) {
    const int c = nt * 8 + n;
    if (c < DJ) return j0 + c < D ? j0 + c : -1;
    return c < 2 * DJ && j0 + c - DJ < D ? D + j0 + c - DJ : -1;
  }
  const int c = (nt - NA) * 8 + n;
  return c < DJ && j0 + c < D ? 2 * D + j0 + c : -1;
}

constexpr int NF = NA + NB;               // W's fragment columns

// the gate inputs and the mask of step t at a thread's pairs
__device__ __forceinline__ void load_x(float (&xu)[PAIRS], float (&xr)[PAIRS],
                                       float (&xc)[PAIRS], float (&m)[PAIRS],
                                       const float* __restrict__ xs,
                                       const float* __restrict__ mask,
                                       const int (&at)[PAIRS], int t, int N,
                                       int D) {
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    if (at[i] < 0) continue;
    const int row = at[i] / D, j = at[i] - row * D;
    const float* x = xs + ((size_t)t * N + row) * 3 * D + j;
    xu[i] = __ldg(x);
    xr[i] = __ldg(x + D);
    xc[i] = __ldg(x + 2 * D);
    m[i] = __ldg(mask + (size_t)t * N + row);
  }
}

// The gate inputs and the mask of step t at a thread's pairs of each of
// its G unit groups
template <int G>
__device__ __forceinline__ void load_x_groups(
    float (&xu)[G][PAIRS], float (&xr)[G][PAIRS], float (&xc)[G][PAIRS],
    float (&m)[G][PAIRS], const float* __restrict__ xs,
    const float* __restrict__ mask, const int (&at)[G][PAIRS], int t, int N,
    int D) {
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_x(xu[g], xr[g], xc[g], m[g], xs, mask, at[g], t, N, D);
}

// WS: the form of W (setup_w); G: the unit groups a block owns
template <typename WS, int G>
__global__ void __launch_bounds__(THREADS, 1)
fused_gru_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                 const float* __restrict__ h0,
                 const float* __restrict__ mask, float* hs, float* rh,
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
  float* hb = setup_w<NF, 3>(ws, smem, w, j0, D, KT);
  // the partial sums: over the staged rows where a block owns one unit
  // group (its products are done with them), after them where it owns
  // more (the next group's products read them again)
  float* red = G == 1 ? hb : hb + ((rows + 15) & ~15) * ldh;

  Walk walks[GROUPS];
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) walks[q] = walk(k0, k1, q, lane);

  unsigned int passed = 0;
  for (int p0 = 0; p0 < N; p0 += splits * rows) {
    const int r0 = p0 + rg * rows;
    const int nr = max(0, min(rows, N - r0));  // 0: a block with no rows
                                               // still meets the barriers
    // this thread's (row, unit) pairs of each unit group: their state and
    // gate inputs
    int at[G][PAIRS];                      // row * D + unit, or -1
    float h[G][PAIRS], u[G][PAIRS], xu[G][PAIRS], xr[G][PAIRS], xc[G][PAIRS],
        m[G][PAIRS];
    float nxu[G][PAIRS], nxr[G][PAIRS], nxc[G][PAIRS], nm[G][PAIRS];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int p = threadIdx.x + i * THREADS, n = p / DJ,
                  j = j0[g] + p % DJ;
        at[g][i] = n < nr && j < D ? (r0 + n) * D + j : -1;
        h[g][i] = at[g][i] >= 0 ? h0[at[g][i]] : 0.f;
        u[g][i] = xu[g][i] = xr[g][i] = xc[g][i] = m[g][i] = 0.f;
        nxu[g][i] = nxr[g][i] = nxc[g][i] = nm[g][i] = 0.f;
      }
    load_x_groups(xu, xr, xc, m, xs, mask, at, 0, N, D);
    for (int t = 0; t < T; ++t) {
      const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * N * D;
      // A: update and reset gates, r * h_{t-1} of the block's units to rh
      __syncthreads();
      stage_slice(hb, ldh, hprev, r0, nr, D, walks);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc[MT][NA][4];
        products(acc, hb, ldh, ws[g], KT, 0, k0, k1, nr, lane);
        __syncthreads();
        put_partials<RP>(red, acc, warp, lane);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] < 0) continue;
          const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
          const float r = sigmoid_f(xr[g][i] + gather<ROWS, RP>(red, n, DJ + jl));
          rh[at[g][i]] = r * h[g][i];
          // u, which only this block reads: the last group's while the
          // other blocks arrive, an earlier one's before the next group
          // takes its partial sums' place
          if (g + 1 < G) u[g][i] = sigmoid_f(xu[g][i] + gather<ROWS, RP>(red, n, jl));
        }
      }
      grid_arrive(barrier);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        if (at[G - 1][i] < 0) continue;
        const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
        u[G - 1][i] = sigmoid_f(xu[G - 1][i] + gather<ROWS, RP>(red, n, jl));
      }
      grid_wait(barrier, gridDim.x * ++passed);
      // B: the candidate from every unit's r * h, then h_t
      __syncthreads();
      stage_slice(hb, ldh, rh, r0, nr, D, walks);
      // the next step's gate inputs, landing under this phase's products
      // (a __syncthreads waits for a thread's loads, so they must not be
      // in flight at the barrier)
      if (t + 1 < T)
        load_x_groups(nxu, nxr, nxc, nm, xs, mask, at, t + 1, N, D);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc[MT][NB][4];
        products(acc, hb, ldh, ws[g], KT, NA, k0, k1, nr, lane);
        __syncthreads();
        put_partials<RP>(red, acc, warp, lane);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] < 0) continue;
          const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
          const float cand = tanhf(xc[g][i] + gather<ROWS, RP>(red, n, jl));
          const float hn = (1.f - u[g][i]) * h[g][i] + u[g][i] * cand;
          h[g][i] = hn * m[g][i] + h[g][i] * (1.f - m[g][i]);
          hs[(size_t)t * N * D + at[g][i]] = h[g][i];
          xu[g][i] = nxu[g][i];
          xr[g][i] = nxr[g][i];
          xc[g][i] = nxc[g][i];
          m[g][i] = nm[g][i];
        }
      }
      if (t + 1 < T) {
        grid_arrive(barrier);
        grid_wait(barrier, gridDim.x * ++passed);
      }
    }
  }
}

// the kernel's three forms, in plan's order
const void* const FORMS[3] = {
    (const void*)fused_gru_kernel<const uint4*, 1>,
    (const void*)fused_gru_kernel<const float2*, 1>,
    (const void*)fused_gru_kernel<WGlobal<NF>, 2>};

}  // namespace

extern "C" {

// The launch shape of N rows of D units on the current device: info[7]
// receives blocks, units a block, rows a block's piece, shared bytes,
// threads, co-resident blocks per SM and SMs.
int fused_gru_plan(int N, int D, int* info) {
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

// xs [T, N, 3D], w [D, 3D], h0 [N, D], mask [T, N], hs [T, N, D], float32,
// contiguous, on one device; rh: N * D floats and barrier: one uint32 of
// scratch.
int fused_gru_f32(const void* xs, const void* w, const void* h0,
                  const void* mask, void* hs, void* rh, void* barrier, int T,
                  int N, int D, void* stream) {
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
  const float* mf = static_cast<const float*>(mask);
  float* hsf = static_cast<float*>(hs);
  float* rhf = static_cast<float*>(rh);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {(void*)&xf, (void*)&wf, (void*)&h0f, (void*)&mf,
                  (void*)&hsf, (void*)&rhf, (void*)&bar, (void*)&T,
                  (void*)&N, (void*)&D, (void*)&rows};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                  smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
