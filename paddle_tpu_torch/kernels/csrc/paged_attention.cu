// Paged attention for the decode step, float32, for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py:154, `_pa_pallas` (its
// pallas_call) with the kernel body `_pa_kernel` (:106), reached through
// `paged_attention`. One query per running row attends over that row's
// cached K/V, read through its block table from the pool
// [num_pages + 1, T, nh, dh] (the last page is the trash page). Column c
// attends iff c <= min(positions[row], MB * T - 1); the softmax is online
// (running max, numerator, denominator in f32) and the denominator is
// floored at 1e-20.
//
// What bounds it on the H100: bytes. Each (row, head) reads
// (pos + 1) * dh * 4 bytes of K and as many of V, and does 4 flops for
// every K and V element pair (8 bytes), half a flop a byte, far below the
// card's f32 balance of 20 flops a byte (67 TFLOP/s over 3.35 TB/s). The
// least time is sum_rows (pos + 1) * nh * dh * 8 bytes over 3.35 TB/s.
//
// Design: two kernels on one stream, a split pass and a merge.
//
// The split kernel. The TPU kernel walks a sequential (row block, kv
// block) grid and carries the softmax in VMEM scratch. Here a row's
// columns are cut into splits of SPLIT columns, S = ceil(MB * T / SPLIT)
// of them for every (row, head), and one block of WARPS warps takes one
// (row, head, split): the longest row no longer walks its columns in one
// block while the others' blocks sit idle, and a few rows still fill the
// card. Splits follow columns, not pages (a column finds its page as
// table[c / T]), so any T works; the rule reads neither the card nor the
// positions, which live on the device and which the host never reads. So
// the grid is one-dimensional over (row, head, split), split fastest, and
// a block whose first column lies past the row's position returns before
// it loads anything. A lane loads 16 bytes of a K or V row, so a column
// takes LPC = dh / 4 lanes and a warp load covers 32 / LPC columns; a
// lane has UNROLL loads of K and UNROLL of V in flight before it reduces
// any of them. Each q.k dot is reduced across its LPC lanes with
// shuffles; each lane group keeps its own online softmax state, the
// groups of a warp merge by shuffles, and the warps through shared memory
// in warp order.
// The block writes its split's unnormalised partial (acc[dh], m, den) to
// the workspace [R, nh, S, dh + 2]. Nothing is staged in shared memory on
// the way in: every byte of K and V is used once, so registers with
// enough loads in flight are enough.
//
// The merge kernel: one block of dh threads a (row, head) reads the live
// splits, s < ceil(n_cols / SPLIT), in the order s = 0, 1, ..., takes
// their largest m, sums den and acc scaled by exp(m_s - max) and writes
// out. It never reads a split that the split kernel skipped, so the
// workspace needs no clearing. No atomics and no order that depends on
// scheduling: a relaunch is bit-identical.
//
// Inactive rows carry an all-trash table and position 0: they read
// column 0 of the trash page, which always exists, and write an output
// the engine discards.
//
// The kernels allocate nothing: the caller passes the workspace. The
// entry point launches both on the stream it is given and returns
// cudaGetLastError() after each launch.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SPLIT = 64;   // columns a split takes
constexpr int WARPS = 4;
constexpr int UNROLL = 4;
constexpr int MERGE_CHUNK = 16;  // splits the merge loads at once
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ int columns(const int* positions, int row,
                                       int MB, int T) {
  // columns 0..pos attend; a position past the table's width attends the
  // whole table, as the masked reference does
  return min(positions[row], MB * T - 1) + 1;
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y),
                     fmaf(p, v.z, a.z), fmaf(p, v.w, a.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_split_kernel(const float* __restrict__ q,
                             const float* __restrict__ k_pages,
                             const float* __restrict__ v_pages,
                             const int* __restrict__ tables,
                             const int* __restrict__ positions,
                             float* __restrict__ work,
                             int nh, int T, int MB, int S, float scale) {
  constexpr int LPC = DH / 4;         // lanes a column, 16 bytes each
  constexpr int CPW = 32 / LPC;       // columns a warp load covers
  constexpr int STEP = CPW * UNROLL;  // columns a warp takes a round
  const int split = blockIdx.x % S;
  const int rh = blockIdx.x / S;      // row * nh + head
  const int head = rh % nh;
  const int row = rh / nh;
  const int n_cols = columns(positions, row, MB, T);
  const int c_begin = split * SPLIT;
  if (c_begin >= n_cols) return;
  const int c_end = min(c_begin + SPLIT, n_cols);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPC;
  const int sub = lane % LPC;
  const int* table = tables + (size_t)row * MB;
  const size_t slot_stride = (size_t)nh * DH;
  const size_t page_stride = (size_t)T * slot_stride;
  const size_t head_off = (size_t)head * DH + sub * 4;

  const float4 qv = reinterpret_cast<const float4*>(q + (size_t)rh * DH)[sub];
  float m = -INFINITY;
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  // the loop bound depends on the warp alone, so every lane reaches the
  // shuffles of every round
  for (int c0 = c_begin + warp * STEP; c0 < c_end; c0 += WARPS * STEP) {
    float4 kx[UNROLL];
    float4 vx[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * CPW + grp;
      if (c < c_end) {
        const size_t off = (size_t)table[c / T] * page_stride +
                           (size_t)(c % T) * slot_stride + head_off;
        kx[u] = *reinterpret_cast<const float4*>(k_pages + off);
        vx[u] = *reinterpret_cast<const float4*>(v_pages + off);
      } else {
        kx[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vx[u] = kx[u];
      }
    }
    float s[UNROLL];
    float chunk_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part = fmaf(qv.x, kx[u].x, 0.f);
      part = fmaf(qv.y, kx[u].y, part);
      part = fmaf(qv.z, kx[u].z, part);
      part = fmaf(qv.w, kx[u].w, part);
#pragma unroll
      for (int o = LPC / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(FULL_MASK, part, o);
      s[u] = (c0 + u * CPW + grp < c_end) ? part * scale : -INFINITY;
      chunk_max = fmaxf(chunk_max, s[u]);
    }
    if (chunk_max == -INFINITY) continue;  // the group's columns ran out
    const float new_m = fmaxf(m, chunk_max);
    const float alpha = expf(m - new_m);  // exp(-inf) = 0 the first time
    den *= alpha;
    acc = scale4(acc, alpha);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(s[u] - new_m);  // masked columns give exactly 0
      den += p;
      acc = fma4(p, vx[u], acc);
    }
    m = new_m;
  }

  // the lane groups of the warp merge by shuffles; lane group 0 ends up
  // with the warp's state (a group that saw no column holds m = -inf)
#pragma unroll
  for (int o = LPC; o < 32; o <<= 1) {
    const float om = __shfl_xor_sync(FULL_MASK, m, o);
    const float oden = __shfl_xor_sync(FULL_MASK, den, o);
    float4 oacc;
    oacc.x = __shfl_xor_sync(FULL_MASK, acc.x, o);
    oacc.y = __shfl_xor_sync(FULL_MASK, acc.y, o);
    oacc.z = __shfl_xor_sync(FULL_MASK, acc.z, o);
    oacc.w = __shfl_xor_sync(FULL_MASK, acc.w, o);
    const float big = fmaxf(m, om);
    const float a = (m == -INFINITY) ? 0.f : expf(m - big);
    const float b = (om == -INFINITY) ? 0.f : expf(om - big);
    den = fmaf(oden, b, den * a);
    acc = fma4(b, oacc, scale4(acc, a));
    m = big;
  }

  __shared__ float sm_m[WARPS];
  __shared__ float sm_den[WARPS];
  __shared__ __align__(16) float sm_acc[WARPS][DH];
  if (lane < LPC) reinterpret_cast<float4*>(sm_acc[warp])[sub] = acc;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_den[warp] = den;
  }
  __syncthreads();

  const int d = threadIdx.x;
  if (d < DH) {
    // column c_begin is real, so big_m is finite
    float big_m = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) big_m = fmaxf(big_m, sm_m[w]);
    float total_den = 0.f;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp that saw no column holds m = -inf and contributes nothing
      const float sc = (sm_m[w] == -INFINITY) ? 0.f : expf(sm_m[w] - big_m);
      total_den = fmaf(sm_den[w], sc, total_den);
      total = fmaf(sm_acc[w][d], sc, total);
    }
    float* part = work + ((size_t)rh * S + split) * (DH + 2);
    part[d] = total;
    if (d == 0) {
      part[DH] = big_m;
      part[DH + 1] = total_den;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(DH)
paged_attention_merge_kernel(const float* __restrict__ work,
                             const int* __restrict__ positions,
                             float* __restrict__ out,
                             int nh, int T, int MB, int S) {
  const int rh = blockIdx.x;
  const int d = threadIdx.x;
  const int n_cols = columns(positions, rh / nh, MB, T);
  const int live = (n_cols + SPLIT - 1) / SPLIT;
  const float* parts = work + (size_t)rh * S * (DH + 2);
  // the splits go in chunks of MERGE_CHUNK whose loads are all in
  // flight before any is used (a split past `live` reads as m = -inf,
  // den = acc = 0, which adds exactly nothing); the sums still run in
  // the order s = 0, 1, ...
  float big_m = -INFINITY;
  for (int s0 = 0; s0 < live; s0 += MERGE_CHUNK) {
    float pm[MERGE_CHUNK];
#pragma unroll
    for (int i = 0; i < MERGE_CHUNK; ++i)
      pm[i] = (s0 + i < live) ? parts[(size_t)(s0 + i) * (DH + 2) + DH]
                              : -INFINITY;
#pragma unroll
    for (int i = 0; i < MERGE_CHUNK; ++i) big_m = fmaxf(big_m, pm[i]);
  }
  float total_den = 0.f;
  float total = 0.f;
  for (int s0 = 0; s0 < live; s0 += MERGE_CHUNK) {
    float pm[MERGE_CHUNK], pd[MERGE_CHUNK], pa[MERGE_CHUNK];
#pragma unroll
    for (int i = 0; i < MERGE_CHUNK; ++i) {
      const float* part = parts + (size_t)(s0 + i) * (DH + 2);
      const bool in = s0 + i < live;
      pm[i] = in ? part[DH] : -INFINITY;
      pd[i] = in ? part[DH + 1] : 0.f;
      pa[i] = in ? part[d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MERGE_CHUNK; ++i) {
      const float sc = expf(pm[i] - big_m);
      total_den = fmaf(pd[i], sc, total_den);
      total = fmaf(pa[i], sc, total);
    }
  }
  out[(size_t)rh * DH + d] = total / fmaxf(total_den, 1e-20f);
}

int splits(int MB, int T) {
  return (int)(((long long)MB * T + SPLIT - 1) / SPLIT);
}

template <int DH>
int launch(const float* q, const float* k_pages, const float* v_pages,
           const int* tables, const int* positions, float* out, float* work,
           int R, int nh, int T, int MB, int S, float scale,
           cudaStream_t stream) {
  paged_attention_split_kernel<DH><<<R * nh * S, WARPS * 32, 0, stream>>>(
      q, k_pages, v_pages, tables, positions, work, nh, T, MB, S, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_merge_kernel<DH><<<R * nh, DH, 0, stream>>>(
      work, positions, out, nh, T, MB, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of splits S of a row of MB pages of T columns.
int paged_attention_splits(int MB, int T) { return splits(MB, T); }

// q [R, nh, dh], k_pages/v_pages [P + 1, T, nh, dh], tables [R, MB] int32,
// positions [R] int32, out [R, nh, dh], workspace [R, nh, S, dh + 2]
// float32 with S = paged_attention_splits(MB, T); all contiguous on one
// device, q and the pools 16-byte aligned. dh must be 32, 64 or 128.
int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* positions, void* out, void* workspace,
                        int R, int nh, int dh, int T, int MB, int S,
                        float scale, void* stream) {
  if (R < 1 || nh < 1 || T < 1 || MB < 1 || S != splits(MB, T) ||
      (long long)R * nh * S > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pages);
  const float* vf = static_cast<const float*>(v_pages);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  float* of = static_cast<float*>(out);
  float* wk = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(qf, kf, vf, tb, ps, of, wk, R, nh, T, MB, S, scale,
                        st);
    case 64:
      return launch<64>(qf, kf, vf, tb, ps, of, wk, R, nh, T, MB, S, scale,
                        st);
    case 128:
      return launch<128>(qf, kf, vf, tb, ps, of, wk, R, nh, T, MB, S, scale,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
