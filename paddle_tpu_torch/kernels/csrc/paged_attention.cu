// Paged attention for the decode step, float32, for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py, `_pa_pallas` (its
// pallas_call) with the kernel body `_pa_kernel`, reached through
// `paged_attention`. One query per running row attends over that row's
// cached K/V, read through its block table from the pool
// [num_pages + 1, T, nh, dh] (the last page is the trash page). Column c
// attends iff c <= positions[row]; the softmax is online (running max,
// numerator, denominator in f32) and the denominator is floored at 1e-20.
//
// What bounds it on the H100: bytes. Each (row, head) reads
// (pos + 1) * dh * 4 bytes of K and as many of V, and does 4 flops for
// every K and V element pair (8 bytes), half a flop a byte, far below the
// card's f32 balance of 20 flops a byte (67 TFLOP/s over 3.35 TB/s). The
// least time is sum_rows (pos + 1) * nh * dh * 2 * 4 bytes over 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential (row block, kv block) grid
// and carries the softmax in VMEM scratch; here one thread block owns one
// (row, head) and walks the block table itself, so the loop over pages
// lives inside the block and nothing is carried between blocks. It stops
// at column pos: pages past pos // T are never read (the TPU kernel
// reads all max_blocks pages and masks them). Each of the WARPS warps
// takes every WARPS-th chunk of UNROLL columns; a lane holds dh / 32
// elements (lane + 32 * i, so a warp's load of one K or V row is one
// coalesced 128-byte transaction per i), issues the loads of all UNROLL
// columns before it reduces any of them (to keep several memory requests
// in flight per warp), and reduces each q.k dot with warp shuffles. The
// warps' partial softmax states merge through shared memory at the end.
//
// Inactive rows carry an all-trash table and position 0: they read
// column 0 of the trash page, which always exists, and write an output
// the engine discards.
//
// The kernel allocates nothing. The entry point launches on the stream it
// is given and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int DPL>  // elements of the head dimension per lane: dh / 32
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       float* __restrict__ out,
                       int nh, int T, int MB, float scale) {
  constexpr int DH = DPL * 32;
  const int row = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int pos = positions[row];
  // columns 0..pos attend; a position past the table's width attends the
  // whole table, as the masked reference does
  const int n_cols = min(pos, MB * T - 1) + 1;
  const int* table = tables + (size_t)row * MB;
  const size_t slot_stride = (size_t)nh * DH;
  const size_t page_stride = (size_t)T * slot_stride;

  float qv[DPL];
  const float* qh = q + ((size_t)row * nh + head) * DH;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = qh[lane + 32 * i];

  float m = -INFINITY;
  float den = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int c0 = warp * UNROLL; c0 < n_cols; c0 += WARPS * UNROLL) {
    float kx[UNROLL][DPL];
    float vx[UNROLL][DPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u;
      if (c < n_cols) {
        const size_t off = (size_t)table[c / T] * page_stride +
                           (size_t)(c % T) * slot_stride + (size_t)head * DH;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kx[u][i] = k_pages[off + lane + 32 * i];
          vx[u][i] = v_pages[off + lane + 32 * i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kx[u][i] = 0.f;
          vx[u][i] = 0.f;
        }
      }
    }
    float s[UNROLL];
    float chunk_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part = fmaf(qv[i], kx[u][i], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(FULL_MASK, part, o);
      s[u] = (c0 + u < n_cols) ? part * scale : -INFINITY;
      chunk_max = fmaxf(chunk_max, s[u]);
    }
    // column c0 < n_cols is real, so chunk_max and new_m are finite
    const float new_m = fmaxf(m, chunk_max);
    const float alpha = expf(m - new_m);  // exp(-inf) = 0 on the first chunk
    den *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(s[u] - new_m);  // masked columns give exactly 0
      den += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vx[u][i], acc[i]);
    }
    m = new_m;
  }

  __shared__ float sm_m[WARPS];
  __shared__ float sm_den[WARPS];
  __shared__ float sm_acc[WARPS][DH];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_den[warp] = den;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < DH; d += WARPS * 32) {
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
    total_den = fmaxf(total_den, 1e-20f);
    out[((size_t)row * nh + head) * DH + d] = total / total_den;
  }
}

template <int DPL>
void launch(const float* q, const float* k_pages, const float* v_pages,
            const int* tables, const int* positions, float* out, int R,
            int nh, int T, int MB, float scale, cudaStream_t stream) {
  dim3 grid(R, nh);
  paged_attention_kernel<DPL><<<grid, WARPS * 32, 0, stream>>>(
      q, k_pages, v_pages, tables, positions, out, nh, T, MB, scale);
}

}  // namespace

extern "C" {

// q [R, nh, dh], k_pages/v_pages [P + 1, T, nh, dh], tables [R, MB] int32,
// positions [R] int32, out [R, nh, dh]; all contiguous on one device.
// dh must be 32, 64 or 128.
int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* positions, void* out, int R, int nh,
                        int dh, int T, int MB, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pages);
  const float* vf = static_cast<const float*>(v_pages);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || nh < 1 || T < 1 || MB < 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: launch<1>(qf, kf, vf, tb, ps, of, R, nh, T, MB, scale, st); break;
    case 64: launch<2>(qf, kf, vf, tb, ps, of, R, nh, T, MB, scale, st); break;
    case 128: launch<4>(qf, kf, vf, tb, ps, of, R, nh, T, MB, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
