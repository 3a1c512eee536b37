// The device helpers and the launch plan shared by the two fused
// recurrences on Hopper's tensor cores, fused_lstm.cu and fused_gru.cu.
//
// Both kernels are one persistent cooperative launch for all T steps. A
// block owns DJ units (a unit group) of the rows of its row group, and
// each step multiplies its staged rows of the state [rows, D] by its
// columns of W [D, NF * 8] in 3xTF32 (tf32x3.cuh), then meets the other
// blocks at a grid barrier. What is shared here:
//   - sigmoid_f, and the barrier: grid_arrive (a release add) and
//     grid_wait (a spin on an acquire load), work that no other block
//     waits for between the two;
//   - the staging: each warp copies its K slice of the block's rows with
//     cp.async.cg in GROUPS copy groups (group_start, Walk, walk,
//     stage_slice), and multiplies each group as it lands;
//   - W's B fragments in their three forms (split once into shared
//     memory, kept as float pairs and split at each load, or read from
//     global memory: WGlobal), put in place by setup_w through the
//     kernel's own map of fragment columns to W's columns, w_col;
//   - the products (products_ma, products: the K reduction split over
//     the WARPS warps, each chain summed from zero on the tensor cores,
//     the large terms and the small ones apart), and the warps' partial
//     sums added in warp order through shared memory (put_partials,
//     gather), so that a relaunch is bit-identical;
//   - the host's plan, which picks a kernel form, the row groups and the
//     rows of a piece for N rows of D units.
// The constants of the step itself (the units a group, the rows a piece,
// the fragment columns and the pitch of the partial sums) are each
// kernel's own and reach these helpers as template arguments.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
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
// whose first unit is j0; -1 past D. Each kernel defines its own.
__device__ __forceinline__ int w_col(int nt, int n, int j0, int D);

// W's B fragments, in one of three forms: in shared memory, [NF][KT][32
// lanes], split once before the time loop (const uint4*: hi, hi, lo, lo)
// or, where those do not fit beside the staged rows, as the lane's two
// floats (const float2*), split at each load; or, where a block owns
// more than one unit group, read from W (rows of `ldw` floats) in global
// memory and split at each load (WGlobal: the lane's column of W in each
// of the NF fragment columns).
template <int NF>
struct WGlobal {
  const float* w;
  size_t ldw;
  int D;
  int col[NF];
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
template <int NF>
__device__ __forceinline__ FragB frag_b(const WGlobal<NF>& wg, int, int nt,
                                       int kt, int lane) {
  const int k = 8 * kt + 2 * (lane & 3), col = wg.col[nt];
  const bool in = col >= 0 && k < wg.D;
  const float* p = wg.w + (in ? k * wg.ldw + col : 0);
  FragB b;
  split(in ? __ldg(p) : 0.f, b.hi[0], b.lo[0]);
  split(in ? __ldg(p + wg.ldw) : 0.f, b.hi[1], b.lo[1]);
  return b;
}

// The block's W (rows of SLABS * D floats) in shared memory as the NF
// fragment columns of its one unit group (j0[0]): lane (n, kk) holds
// rows 2 kk and 2 kk + 1 of its k tile (load_a_pair's order); units past
// D and rows past D are zeros. Returns where the staged rows begin.
template <int NF, int SLABS, typename V>
__device__ float* setup_w(const V* (&ws)[1], unsigned char* smem,
                          const float* __restrict__ w, const int (&j0)[1],
                          int D, int KT) {
  V* wf = reinterpret_cast<V*>(smem);
  const size_t ldw = (size_t)SLABS * D;
  for (int idx = threadIdx.x; idx < NF * KT * 32; idx += THREADS) {
    const int l = idx & 31, f = idx >> 5;
    const int nt = f / KT, kt = f - nt * KT;
    const int col = w_col(nt, l >> 2, j0[0], D);
    const int ka = 8 * kt + 2 * (l & 3), kb = ka + 1;
    const float va = col >= 0 && ka < D ? w[(size_t)ka * ldw + col] : 0.f;
    const float vb = col >= 0 && kb < D ? w[(size_t)kb * ldw + col] : 0.f;
    put_w(wf, idx, va, vb);
  }
  ws[0] = wf;
  return reinterpret_cast<float*>(wf + NF * KT * 32);
}

// W in global memory for each of the block's G unit groups: nothing in
// shared memory
template <int NF, int SLABS, int G>
__device__ float* setup_w(WGlobal<NF> (&ws)[G], unsigned char* smem,
                          const float* __restrict__ w, const int (&j0)[G],
                          int D, int) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ws[g].w = w;
    ws[g].ldw = (size_t)SLABS * D;
    ws[g].D = D;
#pragma unroll
    for (int nt = 0; nt < NF; ++nt)
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
template <int MT, int NT, int MA, typename WS>
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

// products_ma for the m tiles that hold rows: ceil(nr / 16) of them (a
// case for each count, so that each count's tiles interleave)
template <int MT, int NT, typename WS>
__device__ __forceinline__ void products(float (&acc)[MT][NT][4],
                                         const float* hb, int ldh,
                                         const WS& wf, int KT, int nt0,
                                         int k0, int k1, int nr, int lane) {
  static_assert(MT >= 1 && MT <= 4, "one case for each count of m tiles");
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  switch ((min(nr, 16 * MT) + 15) / 16) {
    case 1:
      products_ma<MT, NT, 1>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 2:
      if constexpr (MT >= 2)
        products_ma<MT, NT, 2>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 3:
      if constexpr (MT >= 3)
        products_ma<MT, NT, 3>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    case 4:
      if constexpr (MT >= 4)
        products_ma<MT, NT, 4>(acc, hb, ldh, wf, KT, nt0, k0, k1, lane);
      break;
    default:                               // no rows: the copies are empty
      cp_async_wait<0>();
      break;
  }
}

// the warp's partial sums to red[warp][row][RP] (16 MT rows a warp)
template <int RP, int MT, int NT>
__device__ __forceinline__ void put_partials(float* red,
                                             const float (&acc)[MT][NT][4],
                                             int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* r = red + warp * 16 * MT * RP;
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
template <int ROWS, int RP>
__device__ __forceinline__ float gather(const float* red, int n, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[(w * ROWS + n) * RP + c];
  return s;
}

// -- the host's launch plan --------------------------------------------------

// Shared bytes of a block that stages r16 rows (pitch ldh), W's
// fragments `wbytes`, and the partial sums of ROWS rows at pitch RP over
// the rows or (apart) after them
template <int ROWS, int RP>
size_t smem_bytes(int r16, size_t ldh, size_t wbytes, bool apart) {
  const size_t red = (size_t)WARPS * ROWS * RP, rows = (size_t)r16 * ldh;
  const size_t hb = apart ? rows + red : rows > red ? rows : red;
  return wbytes + hb * sizeof(float);
}

// The launch shape for N rows of D units of a kernel with units groups of
// DJ, pieces of at most ROWS rows, NF fragment columns and partial sums
// of pitch RP: the kernel form (forms[0]: one unit group a block with W
// split once, where that leaves room for the rows a block needs;
// forms[1]: the same with W split at each load; forms[2]: two groups a
// block with W in global memory, where the groups outnumber the SMs),
// blocks (unit blocks times row groups), units a block, rows a block's
// piece and dynamic shared bytes; an error code when the shape cannot
// run.
template <int DJ, int ROWS, int NF, int RP>
cudaError_t plan(int N, int D, const void* const (&forms)[3],
                 const void** kernel, int* blocks, int* units, int* rows,
                 size_t* smem, int* per_sm, int* sms) {
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
  const size_t frags = (size_t)NF * KT * 32;
  const int need = min(ROWS, ((N + splits - 1) / splits + 15) / 16 * 16);
  size_t wbytes = 0;
  if (G == 1) {
    const bool once =
        smem_bytes<ROWS, RP>(need, ldh, frags * sizeof(uint4), false) <=
        (size_t)optin;
    wbytes = frags * (once ? sizeof(uint4) : sizeof(float2));
    *kernel = once ? forms[0] : forms[1];
  } else {
    *kernel = forms[2];
  }
  int r16 = need;
  for (; r16 >= 16; r16 -= 16) {
    *smem = smem_bytes<ROWS, RP>(r16, ldh, wbytes, G > 1);
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
