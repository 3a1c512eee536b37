// The whole GRU recurrence of a ragged batch in one launch, float32 on
// CUDA cores, for sm_90a.
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
// What bounds it on the H100: operations. 2 * T * N * D * 3D flops on
// (T*N*(3D + D) + 3D*D + N*D + T*N) * 4 bytes; at T 100, N 64, D 512 that
// is 10.1 GFLOP (0.150 ms at 67 TFLOP/s float32) against 55.6 MB (0.017
// ms). The bound leaves out the serial chain of 2T - 1 grid-wide
// barriers.
//
// Design: the persistent cooperative launch of fused_lstm.cu (read its
// note), with three gate columns a unit. The candidate needs every
// unit's r * h before any block can form its product, so a step has two
// phases and a grid-wide barrier after each:
//   A. stage h_{t-1} in shared memory; thread (n, j) forms u and r,
//      writes r * h_{t-1}[n, j] to the scratch row rh[n] and u to its
//      own slot hs[t][n, j] (hs[t] is read by nobody before the step
//      ends, so it holds u in between and no other scratch is needed);
//   B. stage rh in shared memory; thread (n, j) forms the candidate, reads
//      its u back and h_{t-1}[n, j] (which it wrote itself), and writes
//      h_t to hs[t][n, j].
// The second barrier also orders the next step's writes of rh after
// this step's reads. Cross-block data (hs, rh) is read with
// ld.global.cg, past the L1, which is not coherent between SMs.
//
// Tensors are contiguous float32. The kernel allocates nothing; the
// entry point zeroes the barrier counter on the stream, launches on it
// and returns the CUDA error code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;      // row pitch of the shared tiles: D + PAD floats
constexpr int GATES = 3;

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

__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int D) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
    const float4 y = *reinterpret_cast<const float4*>(b + k);
    s0 = fmaf(x.x, y.x, s0); s1 = fmaf(x.y, y.y, s1);
    s0 = fmaf(x.z, y.z, s0); s1 = fmaf(x.w, y.w, s1);
  }
  return s0 + s1;
}

__global__ void __launch_bounds__(THREADS)
fused_gru_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                 const float* __restrict__ h0,
                 const float* __restrict__ mask, float* hs, float* rh,
                 unsigned int* barrier, int T, int N, int D, int dj,
                 int rows) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + PAD;
  float* wt = smem;                        // [GATES * dj][ld]
  float* hb = smem + GATES * dj * ld;      // [rows][ld]
  const int j0 = blockIdx.x * dj;
  const int nj = min(dj, D - j0);
  const size_t D3 = (size_t)GATES * D;

  // this block's columns of W: column g*dj + jl is W[:, g*D + j0 + jl]
  for (int idx = threadIdx.x; idx < GATES * dj * D; idx += blockDim.x) {
    const int k = idx / (GATES * dj), col = idx - k * (GATES * dj);
    const int g = col / dj, jl = col - g * dj;
    wt[col * ld + k] = jl < nj ? w[(size_t)k * D3 + g * D + j0 + jl] : 0.f;
  }

  unsigned int passed = 0;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * N * D;
    float* ht = hs + (size_t)t * N * D;
    // A: update and reset gates, r * h_{t-1} to rh, u parked in hs[t]
    for (int r0 = 0; r0 < N; r0 += rows) {
      const int nr = min(rows, N - r0);
      __syncthreads();
      stage_rows(hb, hprev, r0, nr, D, ld);
      __syncthreads();
      for (int p = threadIdx.x; p < nr * dj; p += blockDim.x) {
        const int n = p / dj, jl = p - n * dj;
        if (jl >= nj) continue;
        const float* hr = hb + n * ld;
        const int row = r0 + n, j = j0 + jl;
        const float* x = xs + ((size_t)t * N + row) * D3;
        const float u = sigmoid_f(x[j] + dot_row(hr, wt + jl * ld, D));
        const float r = sigmoid_f(x[D + j] +
                                  dot_row(hr, wt + (dj + jl) * ld, D));
        rh[(size_t)row * D + j] = r * hr[j];
        ht[(size_t)row * D + j] = u;
      }
    }
    grid_barrier(barrier, gridDim.x * ++passed);
    // B: the candidate from every unit's r * h, then h_t
    for (int r0 = 0; r0 < N; r0 += rows) {
      const int nr = min(rows, N - r0);
      __syncthreads();
      stage_rows(hb, rh, r0, nr, D, ld);
      __syncthreads();
      for (int p = threadIdx.x; p < nr * dj; p += blockDim.x) {
        const int n = p / dj, jl = p - n * dj;
        if (jl >= nj) continue;
        const int row = r0 + n, j = j0 + jl;
        const float* x = xs + ((size_t)t * N + row) * D3;
        const float cand = tanhf(x[2 * D + j] +
                                 dot_row(hb + n * ld,
                                         wt + (2 * dj + jl) * ld, D));
        const size_t at = (size_t)row * D + j;
        const float u = ht[at];            // parked in phase A
        const float hp = hprev[at];        // this thread wrote it (or h0)
        const float hn = (1.f - u) * hp + u * cand;
        const float m = mask[(size_t)t * N + row];
        ht[at] = hn * m + hp * (1.f - m);
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
  if ((e = cudaFuncSetAttribute(fused_gru_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, fused_gru_kernel, THREADS, *smem)) != cudaSuccess)
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
int fused_gru_plan(int N, int D, int* info) {
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

// xs [T, N, 3D], w [D, 3D], h0 [N, D], mask [T, N], hs [T, N, D], float32,
// contiguous, on one device; rh: N * D floats and barrier: one uint32 of
// scratch.
int fused_gru_f32(const void* xs, const void* w, const void* h0,
                  const void* mask, void* hs, void* rh, void* barrier, int T,
                  int N, int D, void* stream) {
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
  const float* mf = static_cast<const float*>(mask);
  float* hsf = static_cast<float*>(hs);
  float* rhf = static_cast<float*>(rh);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {(void*)&xf, (void*)&wf, (void*)&h0f, (void*)&mf,
                  (void*)&hsf, (void*)&rhf, (void*)&bar, (void*)&T,
                  (void*)&N, (void*)&D, (void*)&dj, (void*)&rows};
  e = cudaLaunchCooperativeKernel((const void*)fused_gru_kernel,
                                  dim3(blocks), dim3(THREADS), args, smem,
                                  st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
