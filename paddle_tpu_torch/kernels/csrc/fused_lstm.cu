// The whole LSTM recurrence of a ragged batch in one launch, float32 on
// CUDA cores, for sm_90a.
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
// What bounds it on the H100: operations. The recurrent products are
// 2 * T * N * D * 4D flops on (T*N*(4D + 2D) + 4D*D + 2*N*D + T*N) * 4
// bytes; at T 100, N 64, D 512 that is 13.4 GFLOP (0.200 ms at 67 TFLOP/s
// float32) against 82.9 MB (0.025 ms at 3.35 TB/s). What this design
// adds and the bound leaves out is the serial chain: T - 1 grid-wide
// barriers, each a round trip through L2, that no amount of parallel
// work hides.
//
// Design: one persistent cooperative launch, the counterpart of the TPU
// kernel's sequential (T,) grid with h/c in VMEM scratch and W resident.
// Block b owns the hidden units [b*dj, b*dj + dj) and all four gates of
// them, dj = ceil(D / SMs) (4 at D = 512 on 132 SMs: 128 blocks, one per
// SM). Its 4*dj columns of W are copied once into shared memory,
// transposed to [column][k] so that a thread reads them as float4 along
// k, and stay there for all T steps. Each step a block stages the rows
// of h_{t-1} in shared memory (128 KB at N 64, D 512: the N*D floats
// every block needs, read from L2 with ld.global.cg since other blocks
// wrote them), and thread (n, j) forms the four gate sums of row n, unit
// j from float4 loads of h and W, then the cell update. Batches too large
// for shared memory are walked in chunks of rows. h_t goes to hs[t],
// which is also the exchange buffer: after a grid-wide barrier every
// block reads it as h_{t-1} of the next step. The thread that owns
// (n, j) writes c to cs[t] and reads it back the next step, so c never
// crosses blocks. The barrier is a counter in device memory:
// __syncthreads, then thread 0 fences, adds one and waits for the
// count of all blocks (the pattern of cooperative groups' grid sync),
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be co-resident. The mask is applied in the kernel; N and a
// last block with fewer than dj units are masked at the loads. D must be
// a multiple of 4 (float4 rows).
//
// Tensors are contiguous float32. The kernel allocates nothing; the
// entry point zeroes the barrier counter on the stream, launches on it
// and returns the CUDA error code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;      // row pitch of the shared tiles: D + PAD floats
constexpr int GATES = 4;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// All blocks of the grid meet here; `target` is the number of blocks
// times the number of barriers passed so far, this one included. A wait
// of seconds (a block that never arrives) traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned long long spins = 0;
    while (*reinterpret_cast<volatile unsigned int*>(count) < target) {
      __nanosleep(32);
      if (++spins > (1ull << 27)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Copy rows [r0, r0 + nr) of the [*, D] matrix `src` into `dst` (pitch
// ld), bypassing L1: other blocks wrote `src`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int nr, int D, int ld) {
  const int d4 = D >> 2;
  for (int idx = threadIdx.x; idx < nr * d4; idx += blockDim.x) {
    const int n = idx / d4, k4 = idx - n * d4;
    const float4 v = __ldcg(
        reinterpret_cast<const float4*>(src + (size_t)(r0 + n) * D) + k4);
    *reinterpret_cast<float4*>(dst + n * ld + 4 * k4) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
fused_lstm_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ mask, float* hs, float* cs,
                  unsigned int* barrier, int T, int N, int D, int dj,
                  int rows) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + PAD;
  float* wt = smem;                        // [GATES * dj][ld]
  float* hb = smem + GATES * dj * ld;      // [rows][ld]
  const int j0 = blockIdx.x * dj;
  const int nj = min(dj, D - j0);
  const size_t D4 = (size_t)GATES * D;

  // this block's columns of W: column g*dj + jl is W[:, g*D + j0 + jl]
  for (int idx = threadIdx.x; idx < GATES * dj * D; idx += blockDim.x) {
    const int k = idx / (GATES * dj), col = idx - k * (GATES * dj);
    const int g = col / dj, jl = col - g * dj;
    wt[col * ld + k] = jl < nj ? w[(size_t)k * D4 + g * D + j0 + jl] : 0.f;
  }

  unsigned int passed = 0;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * N * D;
    const float* cprev = t == 0 ? c0 : cs + (size_t)(t - 1) * N * D;
    for (int r0 = 0; r0 < N; r0 += rows) {
      const int nr = min(rows, N - r0);
      __syncthreads();                     // hb's last readers are done
      stage_rows(hb, hprev, r0, nr, D, ld);
      __syncthreads();
      for (int p = threadIdx.x; p < nr * dj; p += blockDim.x) {
        const int n = p / dj, jl = p - n * dj;
        if (jl >= nj) continue;
        const float* hr = hb + n * ld;
        const float* wc = wt + (0 * dj + jl) * ld;
        const float* wi = wt + (1 * dj + jl) * ld;
        const float* wf = wt + (2 * dj + jl) * ld;
        const float* wo = wt + (3 * dj + jl) * ld;
        float ac = 0.f, ai = 0.f, af = 0.f, ao = 0.f;
#pragma unroll 4
        for (int k = 0; k < D; k += 4) {
          const float4 h = *reinterpret_cast<const float4*>(hr + k);
          const float4 vc = *reinterpret_cast<const float4*>(wc + k);
          const float4 vi = *reinterpret_cast<const float4*>(wi + k);
          const float4 vf = *reinterpret_cast<const float4*>(wf + k);
          const float4 vo = *reinterpret_cast<const float4*>(wo + k);
          ac = fmaf(h.x, vc.x, ac); ac = fmaf(h.y, vc.y, ac);
          ac = fmaf(h.z, vc.z, ac); ac = fmaf(h.w, vc.w, ac);
          ai = fmaf(h.x, vi.x, ai); ai = fmaf(h.y, vi.y, ai);
          ai = fmaf(h.z, vi.z, ai); ai = fmaf(h.w, vi.w, ai);
          af = fmaf(h.x, vf.x, af); af = fmaf(h.y, vf.y, af);
          af = fmaf(h.z, vf.z, af); af = fmaf(h.w, vf.w, af);
          ao = fmaf(h.x, vo.x, ao); ao = fmaf(h.y, vo.y, ao);
          ao = fmaf(h.z, vo.z, ao); ao = fmaf(h.w, vo.w, ao);
        }
        const int row = r0 + n, j = j0 + jl;
        const float* x = xs + ((size_t)t * N + row) * D4;
        const float cand = tanhf(x[j] + ac);
        const float gi = sigmoid_f(x[D + j] + ai);
        const float gf = sigmoid_f(x[2 * D + j] + af);
        const float go = sigmoid_f(x[3 * D + j] + ao);
        const size_t at = (size_t)row * D + j;
        const float cp = cprev[at];        // this thread wrote it last step
        const float hp = hr[j];
        const float cn = gf * cp + gi * cand;
        const float hn = go * tanhf(cn);
        const float m = mask[(size_t)t * N + row];
        hs[(size_t)t * N * D + at] = hn * m + hp * (1.f - m);
        cs[(size_t)t * N * D + at] = cn * m + cp * (1.f - m);
      }
    }
    if (t + 1 < T) grid_barrier(barrier, gridDim.x * ++passed);
  }
}

// The launch shape for N rows of D units: blocks, units a block (dj),
// rows a shared-memory chunk and dynamic shared bytes; an error code when
// the shape cannot run.
cudaError_t plan(int N, int D, int* blocks, int* dj, int* rows,
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
  *dj = (D + *sms - 1) / *sms;
  *blocks = (D + *dj - 1) / *dj;
  const size_t ld = (size_t)D + PAD;
  const size_t wbytes = (size_t)GATES * *dj * ld * sizeof(float);
  if (wbytes + ld * sizeof(float) > (size_t)optin)
    return cudaErrorInvalidValue;          // not even one row of h fits
  const size_t fit = ((size_t)optin - wbytes) / (ld * sizeof(float));
  *rows = (int)(fit < (size_t)N ? fit : (size_t)N);
  *smem = wbytes + (size_t)*rows * ld * sizeof(float);
  if ((e = cudaFuncSetAttribute(fused_lstm_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, fused_lstm_kernel, THREADS, *smem)) != cudaSuccess)
    return e;
  if ((long long)*per_sm * *sms < *blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch shape of N rows of D units on the current device: info[7]
// receives blocks, dj, rows a chunk, shared bytes, threads, co-resident
// blocks per SM and SMs.
int fused_lstm_plan(int N, int D, int* info) {
  if (N < 1 || D < 4 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  int blocks, dj, rows, per_sm, sms;
  size_t smem;
  const cudaError_t e =
      plan(N, D, &blocks, &dj, &rows, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {blocks, dj, rows, (int)smem, THREADS, per_sm, sms};
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
  int blocks, dj, rows, per_sm, sms;
  size_t smem;
  cudaError_t e = plan(N, D, &blocks, &dj, &rows, &smem, &per_sm, &sms);
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
                  (void*)&T, (void*)&N, (void*)&D, (void*)&dj, (void*)&rows};
  e = cudaLaunchCooperativeKernel((const void*)fused_lstm_kernel,
                                  dim3(blocks), dim3(THREADS), args, smem,
                                  st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
