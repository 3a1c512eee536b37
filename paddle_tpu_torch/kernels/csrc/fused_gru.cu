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
// What it does about the costs of a step:
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

#include "tf32x3.cuh"

namespace {

constexpr int DJ = 8;                      // units a unit group
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
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
constexpr int GROUPS = 2;                  // copy groups of a staging
static_assert(GROUPS == 2, "products_ma waits for one group, then both");

// 1 / (1 + e^-x); __frcp_rn is the correctly rounded reciprocal, the
// value of the division 1.f / y without its general path
__device__ __forceinline__ float sigmoid_f(float x) {
  return __frcp_rn(1.f + expf(-x));
}

// All blocks of the grid meet in two halves. grid_arrive: the release
// add publishes the block's writes (ordered before it by the
// __syncthreads); work that no other block waits for can go between the
// halves. grid_wait: the acquire load sees every other block's writes
// once `target` (the number of blocks times the number of barriers
// passed, this one included) have arrived. A wait of seconds (a block
// that never arrives) traps, so the launch fails with an error instead
// of hanging the card.
__device__ __forceinline__ void grid_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
                 "r"(1u)
                 : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned int* count,
                                          unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    unsigned long long spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (++spins > (1ull << 25)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// the first k tile of copy group q of the warp's k tiles [k0, k1)
__device__ __forceinline__ int group_start(int k0, int k1, int q) {
  return k0 + (k1 - k0) * q / GROUPS;
}

// How a lane walks one copy group of the warp's K slice: the group's
// first chunk c0 and chunks a row nc (16 bytes each), the lane's first
// row and chunk, and its step of 32 copies in rows and chunks (no
// division in the copy loop).
struct Walk {
  int c0, nc, r, c, dr, dc;
};

__device__ __forceinline__ Walk walk(int k0, int k1, int q, int lane) {
  Walk w;
  w.c0 = 2 * group_start(k0, k1, q);
  w.nc = 2 * group_start(k0, k1, q + 1) - w.c0;
  const int nc = max(w.nc, 1);
  w.r = lane / nc;
  w.c = lane - w.r * nc;
  w.dr = 32 / nc;
  w.dc = 32 - w.dr * nc;
  return w;
}

// The warp's K slice of rows r0 .. r0 + nr - 1 of the [*, D] matrix
// `src` into hb (pitch ldh), 16 bytes a copy, in GROUPS cp.async groups
// of half its k tiles each (at D 512 a group is one 128-byte line a
// row); rows past nr (up to the m tile) and columns past D read zeros.
__device__ __forceinline__ void stage_slice(float* hb, int ldh,
                                            const float* src, int r0, int nr,
                                            int D,
                                            const Walk (&walks)[GROUPS]) {
  const int rows = (nr + 15) & ~15;
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    const Walk& w = walks[q];
    if (w.nc > 0) {
      for (int r = w.r, c = w.c; r < rows;) {
        const int col = 4 * (w.c0 + c);
        const bool in = r < nr && col < D;
        cp_async16(hb + r * ldh + col,
                   src + (in ? (size_t)(r0 + r) * D + col : 0), in);
        r += w.dr;
        c += w.dc;
        if (c >= w.nc) {
          c -= w.nc;
          ++r;
        }
      }
    }
    cp_async_commit();
  }
}

// A = rows 0..15, columns 0..7 of a row-major tile of pitch ld, its k
// index permuted: the fragment's columns t and t + 4 hold columns 2t and
// 2t + 1, one 8-byte load a row (frag_b's rows follow the same order, so
// the product is unchanged)
__device__ __forceinline__ FragA load_a_pair(const float* s, int ld, int g,
                                             int t) {
  const float2 r0 = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  const float2 r1 =
      *reinterpret_cast<const float2*>(s + (g + 8) * ld + 2 * t);
  FragA f;
  split(r0.x, f.hi[0], f.lo[0]);
  split(r1.x, f.hi[1], f.lo[1]);
  split(r0.y, f.hi[2], f.lo[2]);
  split(r1.y, f.hi[3], f.lo[3]);
  return f;
}

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

// W's B fragments, in one of three forms: in shared memory, [NA + NB][KT]
// [32 lanes], split once before the time loop (const uint4*: hi, hi, lo,
// lo) or, where those do not fit beside the staged rows, as the lane's
// two floats (const float2*), split at each load; or, where a block owns
// more than one unit group, read from W in global memory and split at
// each load (WGlobal: the lane's column of W in each fragment column).
struct WGlobal {
  const float* w;
  size_t D3;
  int D;
  int col[NA + NB];
};

__device__ __forceinline__ void put_w(uint4* wf, int idx, float a, float b) {
  uint4 v;
  split(a, v.x, v.z);
  split(b, v.y, v.w);
  wf[idx] = v;
}

__device__ __forceinline__ void put_w(float2* wf, int idx, float a,
                                      float b) {
  wf[idx] = make_float2(a, b);
}

// B fragment column nt of k tile kt
__device__ __forceinline__ FragB frag_b(const uint4* wf, int KT, int nt,
                                       int kt, int lane) {
  const uint4 v = wf[(nt * KT + kt) * 32 + lane];
  FragB b;
  b.hi[0] = v.x;
  b.hi[1] = v.y;
  b.lo[0] = v.z;
  b.lo[1] = v.w;
  return b;
}

__device__ __forceinline__ FragB frag_b(const float2* wf, int KT, int nt,
                                       int kt, int lane) {
  const float2 v = wf[(nt * KT + kt) * 32 + lane];
  FragB b;
  split(v.x, b.hi[0], b.lo[0]);
  split(v.y, b.hi[1], b.lo[1]);
  return b;
}

// (rows 2 kk and 2 kk + 1 of the k tile, as setup_w; as D is a multiple
// of 4, both lie within D or neither does)
__device__ __forceinline__ FragB frag_b(const WGlobal& wg, int, int nt,
                                       int kt, int lane) {
  const int k = 8 * kt + 2 * (lane & 3), col = wg.col[nt];
  const bool in = col >= 0 && k < wg.D;
  const float* p = wg.w + (in ? k * wg.D3 + col : 0);
  FragB b;
  split(in ? __ldg(p) : 0.f, b.hi[0], b.lo[0]);
  split(in ? __ldg(p + wg.D3) : 0.f, b.hi[1], b.lo[1]);
  return b;
}

// The block's W in shared memory as B fragments of its one unit group
// (j0[0]): lane (n, kk) holds rows 2 kk and 2 kk + 1 of its k tile
// (load_a_pair's order); units past D and rows past D are zeros. Returns
// where the staged rows begin.
template <typename V>
__device__ float* setup_w(const V* (&ws)[1], unsigned char* smem,
                          const float* __restrict__ w, const int (&j0)[1],
                          int D, int KT) {
  V* wf = reinterpret_cast<V*>(smem);
  const size_t D3 = (size_t)3 * D;
  for (int idx = threadIdx.x; idx < (NA + NB) * KT * 32; idx += THREADS) {
    const int l = idx & 31, f = idx >> 5;
    const int nt = f / KT, kt = f - nt * KT;
    const int col = w_col(nt, l >> 2, j0[0], D);
    const int ka = 8 * kt + 2 * (l & 3), kb = ka + 1;
    const float va = col >= 0 && ka < D ? w[(size_t)ka * D3 + col] : 0.f;
    const float vb = col >= 0 && kb < D ? w[(size_t)kb * D3 + col] : 0.f;
    put_w(wf, idx, va, vb);
  }
  ws[0] = wf;
  return reinterpret_cast<float*>(wf + (NA + NB) * KT * 32);
}

// W in global memory for each of the block's G unit groups: nothing in
// shared memory
template <int G>
__device__ float* setup_w(WGlobal (&ws)[G], unsigned char* smem,
                          const float* __restrict__ w, const int (&j0)[G],
                          int D, int) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ws[g].w = w;
    ws[g].D3 = (size_t)3 * D;
    ws[g].D = D;
#pragma unroll
    for (int nt = 0; nt < NA + NB; ++nt)
      ws[g].col[nt] = w_col(nt, (threadIdx.x & 31) >> 2, j0[g], D);
  }
  return reinterpret_cast<float*>(smem);
}

// The warp's partial product of the staged rows (k tiles [k0, k1)) with
// the NT fragment columns nt0 .. nt0 + NT - 1 of wf, into acc, for the
// first MA m tiles (the rest stay zero). Each copy group is multiplied as
// it lands: a k tile's B fragments are loaded once and meet every m
// tile's A fragment, with no branch between the tiles, so that their
// loads, splits and MA x NT chains interleave (the large terms and the
// small ones apart in each chain), each summed from zero on the tensor
// cores and the two added in float32.
template <int NT, int MA, typename WS>
__device__ __forceinline__ void products_ma(float (&acc)[MT][NT][4],
                                            const float* hb, int ldh,
                                            const WS& wf, int KT, int nt0,
                                            int k0, int k1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float e[MA][NT][4];
#pragma unroll
  for (int mt = 0; mt < MA; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) e[mt][nt][i] = 0.f;
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    if (q == 0) cp_async_wait<1>();        // the first group has landed
    else cp_async_wait<0>();
    __syncwarp();
    const int kb = group_start(k0, k1, q), ke = group_start(k0, k1, q + 1);
#pragma unroll 2
    for (int kt = kb; kt < ke; ++kt) {
      FragB b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt] = frag_b(wf, KT, nt0 + nt, kt, lane);
      FragA a[MA];
#pragma unroll
      for (int mt = 0; mt < MA; ++mt)
        a[mt] = load_a_pair(hb + mt * 16 * ldh + 8 * kt, ldh, g, t);
#pragma unroll
      for (int mt = 0; mt < MA; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3_apart(acc[mt][nt], e[mt][nt], a[mt], b[nt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MA; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) add4(acc[mt][nt], e[mt][nt]);
}

// products_ma for the m tiles that hold rows: ceil(nr / 16) of them
template <int NT, typename WS>
__device__ __forceinline__ void products(float (&acc)[MT][NT][4],
                                         const float* hb, int ldh,
                                         const WS& wf, int KT, int nt0,
                                         int k0, int k1, int nr, int lane) {
  static_assert(MT == 4, "one case for each count of m tiles");
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  switch ((min(nr, ROWS) + 15) / 16) {
    case 1:
      products_ma<NT, 1>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 2:
      products_ma<NT, 2>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 3:
      products_ma<NT, 3>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 4:
      products_ma<NT, 4>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    default:                               // no rows: the copies are empty
      cp_async_wait<0>();
      break;
  }
}

// the warp's partial sums to red[warp][row][RP]
template <int NT>
__device__ __forceinline__ void put_partials(float* red,
                                             const float (&acc)[MT][NT][4],
                                             int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* r = red + warp * ROWS * RP;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            r + (mt * 16 + g + 8 * h) * RP + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// the sum over the warps of red[.][n][c], in warp order
__device__ __forceinline__ float gather(const float* red, int n, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[(w * ROWS + n) * RP + c];
  return s;
}

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
  float* hb = setup_w(ws, smem, w, j0, D, KT);
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
        products<NA>(acc, hb, ldh, ws[g], KT, 0, k0, k1, nr, lane);
        __syncthreads();
        put_partials<NA>(red, acc, warp, lane);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] < 0) continue;
          const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
          const float r = sigmoid_f(xr[g][i] + gather(red, n, DJ + jl));
          rh[at[g][i]] = r * h[g][i];
          // u, which only this block reads: the last group's while the
          // other blocks arrive, an earlier one's before the next group
          // takes its partial sums' place
          if (g + 1 < G) u[g][i] = sigmoid_f(xu[g][i] + gather(red, n, jl));
        }
      }
      grid_arrive(barrier);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        if (at[G - 1][i] < 0) continue;
        const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
        u[G - 1][i] = sigmoid_f(xu[G - 1][i] + gather(red, n, jl));
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
        products<NB>(acc, hb, ldh, ws[g], KT, NA, k0, k1, nr, lane);
        __syncthreads();
        put_partials<NB>(red, acc, warp, lane);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          if (at[g][i] < 0) continue;
          const int p = threadIdx.x + i * THREADS, n = p / DJ, jl = p % DJ;
          const float cand = tanhf(xc[g][i] + gather(red, n, jl));
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

// Shared bytes of a block that stages r16 rows, W's fragments `wbytes`,
// the partial sums over the rows or (apart) after them
size_t smem_bytes(int r16, size_t ldh, size_t wbytes, bool apart) {
  const size_t red = (size_t)WARPS * ROWS * RP, rows = (size_t)r16 * ldh;
  const size_t hb = apart ? rows + red : rows > red ? rows : red;
  return wbytes + hb * sizeof(float);
}

// The launch shape for N rows of D units: the kernel (one unit group a
// block with W split once where that leaves room for the rows a block
// needs, else split at each load; two a block with W in global memory
// where the groups outnumber the SMs), blocks (unit blocks times row
// groups), units a block, rows a block's piece and dynamic shared bytes;
// an error code when the shape cannot run.
cudaError_t plan(int N, int D, const void** kernel, int* blocks, int* units,
                 int* rows, size_t* smem, int* per_sm, int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int optin;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return e;
  const int groups = (D + DJ - 1) / DJ;
  const int G = groups > *sms ? 2 : 1;
  const int ublocks = (groups + G - 1) / G;
  // the rows split across as many blocks as the SMs left over by the
  // unit blocks allow, 16 rows a block at least
  const int splits = max(1, min(*sms / ublocks, (N + 15) / 16));
  *blocks = ublocks * splits;
  *units = G * DJ;
  const size_t KT = (size_t)(D + 7) / 8, ldh = 8 * KT + 8;
  const size_t frags = (size_t)(NA + NB) * KT * 32;
  const int need = min(ROWS, ((N + splits - 1) / splits + 15) / 16 * 16);
  size_t wbytes = 0;
  if (G == 1) {
    const bool once =
        smem_bytes(need, ldh, frags * sizeof(uint4), false) <= (size_t)optin;
    wbytes = frags * (once ? sizeof(uint4) : sizeof(float2));
    *kernel = once ? (const void*)fused_gru_kernel<const uint4*, 1>
                   : (const void*)fused_gru_kernel<const float2*, 1>;
  } else {
    *kernel = (const void*)fused_gru_kernel<WGlobal, 2>;
  }
  int r16 = need;
  for (; r16 >= 16; r16 -= 16) {
    *smem = smem_bytes(r16, ldh, wbytes, G > 1);
    if (*smem <= (size_t)optin) break;
  }
  if (r16 < 16) return cudaErrorInvalidValue;  // not even 16 rows fit
  *rows = r16 < N ? r16 : N;
  if ((e = cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, *kernel, THREADS, *smem)) != cudaSuccess)
    return e;
  if ((long long)*per_sm * *sms < *blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

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
      plan(N, D, &kernel, &blocks, &units, &rows, &smem, &per_sm, &sms);
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
      plan(N, D, &kernel, &blocks, &units, &rows, &smem, &per_sm, &sms);
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
