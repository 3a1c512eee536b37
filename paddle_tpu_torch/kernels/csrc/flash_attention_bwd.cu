// Flash attention backward, float32 on CUDA cores, for sm_90a: two
// kernels, dK/dV and dQ.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, `_fa_backward` (its two
// pallas_calls) with the kernel bodies `_fa_bwd_dkv_kernel` and
// `_fa_bwd_dq_kernel`, reached through the custom vjp of
// `flash_attention_with_lse`. The FlashAttention-2 recompute scheme: with
// p = exp(s - lse), s = q k^T * scale,
//   dv = p^T dO;  dp = dO v^T;  ds = p * (dp - delta) * scale;
//   dk = ds^T q;  dq = ds k,
// where delta = rowsum(dO * o) - dlse is computed by the wrapper (the JAX
// package computes it outside its kernels too). No [S, S] tile ever
// reaches device memory.
//
// What bounds it on the H100: operations. Per (query, key) pair that
// attends, the dK/dV kernel does 8 * D flops (q.k, p*dO, dO.v, ds*q) and
// the dQ kernel 6 * D (q.k, dO.v, ds*k); a causal head of length S has
// S * (S + 1) / 2 such pairs on 9 * S * D * 4 bytes of q, k, v, o, dO and
// the three gradients, far above the f32 balance of the card (67 TFLOP/s
// over 3.35 TB/s, 20 flops a byte). This first version runs in full f32 on
// the CUDA cores, as the forward does; tensor cores are later work.
//
// Design. The TPU grid walks its sequential axis inside one core; a CUDA
// grid has none, so each kernel keeps its accumulator in registers and
// walks the other axis in a loop, streaming BQ- or BK-row tiles through
// shared memory.
// - dK/dV: one thread block owns one (batch * head, BK-row key tile); TPR
//   threads share a key row, each holding D / TPR elements of k, v, dk and
//   dv (element t + TPR * i, so the threads of a row read distinct banks).
//   It loads q and dO tiles (with their lse and delta) from the causal
//   diagonal down to S and, for each query row of a tile, reduces q.k and
//   dO.v over the TPR threads with two warp shuffles.
// - dQ: one thread block owns one (batch * head, BQ-row query tile), with q,
//   dO and dq in registers, and walks the K/V tiles up to the diagonal.
// Every pair past the ragged end of S, or above the diagonal, is masked in
// the kernel (p = 0); the wrapper pads nothing. Each block runs the same
// loop trip count for all its threads, so the shuffles always see the full
// warp.
//
// Tensors are [B, S, H, D], contiguous (the layout of the forward's
// inputs); lse and delta are [B, H, S]. The kernels allocate nothing. The
// entry points launch on the stream they are given and return
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;   // query rows per tile
constexpr int BK = 32;   // key rows per tile
constexpr int TPR = 4;   // threads per row
constexpr int THREADS = 32 * TPR;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(BQ == BK, "the causal start tile assumes square tiles");

__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(FULL_MASK, part, 1);
  part += __shfl_xor_sync(FULL_MASK, part, 2);
  return part;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int causal,
                     float scale) {
  constexpr int DS = D / TPR;
  __shared__ float qs[BQ][D];
  __shared__ float dos[BQ][D];
  __shared__ float ls[BQ];
  __shared__ float dls[BQ];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int r = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int kpos = k0 + r;
  const bool row_ok = kpos < S;

  const size_t row_stride = (size_t)H * D;
  const size_t head_base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t stat_base = (size_t)bh * S;

  float kv[DS], vv[DS], dka[DS], dva[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const size_t off = head_base + (size_t)kpos * row_stride + t + TPR * i;
    kv[i] = row_ok ? k[off] : 0.f;
    vv[i] = row_ok ? v[off] : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // keys of this tile attend only to queries at or after the tile start
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < S; q0 += BQ) {
    for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
      const int i = idx / D;
      const int d = idx % D;
      const int qpos = q0 + i;
      const bool in = qpos < S;
      const size_t off = head_base + (size_t)qpos * row_stride + d;
      qs[i][d] = in ? q[off] : 0.f;
      dos[i][d] = in ? dout[off] : 0.f;
    }
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int qpos = q0 + i;
      const bool in = qpos < S;
      ls[i] = in ? lse[stat_base + qpos] : 0.f;
      dls[i] = in ? delta[stat_base + qpos] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      const int qpos = q0 + i;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < DS; ++e) {
        sp = fmaf(qs[i][t + TPR * e], kv[e], sp);
        dpp = fmaf(dos[i][t + TPR * e], vv[e], dpp);
      }
      sp = row_sum(sp);
      dpp = row_sum(dpp);
      const bool valid = row_ok && qpos < S && (!causal || kpos <= qpos);
      const float p = valid ? expf(sp * scale - ls[i]) : 0.f;
      const float ds = p * (dpp - dls[i]) * scale;
#pragma unroll
      for (int e = 0; e < DS; ++e) {
        dva[e] = fmaf(p, dos[i][t + TPR * e], dva[e]);
        dka[e] = fmaf(ds, qs[i][t + TPR * e], dka[e]);
      }
    }
    __syncthreads();
  }

  if (row_ok) {
    const size_t out_off = head_base + (size_t)kpos * row_stride + t;
#pragma unroll
    for (int e = 0; e < DS; ++e) {
      dk[out_off + TPR * e] = dka[e];
      dv[out_off + TPR * e] = dva[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int causal, float scale) {
  constexpr int DS = D / TPR;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int r = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qpos = q0 + r;
  const bool row_ok = qpos < S;

  const size_t row_stride = (size_t)H * D;
  const size_t head_base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t stat_base = (size_t)bh * S;

  float qv[DS], dov[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const size_t off = head_base + (size_t)qpos * row_stride + t + TPR * i;
    qv[i] = row_ok ? q[off] : 0.f;
    dov[i] = row_ok ? dout[off] : 0.f;
    acc[i] = 0.f;
  }
  const float l = row_ok ? lse[stat_base + qpos] : 0.f;
  const float dl = row_ok ? delta[stat_base + qpos] : 0.f;

  // queries of this tile attend only to keys up to the tile's last row
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kpos = k0 + j;
      const bool in = kpos < S;
      const size_t off = head_base + (size_t)kpos * row_stride + d;
      ks[j][d] = in ? k[off] : 0.f;
      vs[j][d] = in ? v[off] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const int kpos = k0 + j;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < DS; ++e) {
        sp = fmaf(qv[e], ks[j][t + TPR * e], sp);
        dpp = fmaf(dov[e], vs[j][t + TPR * e], dpp);
      }
      sp = row_sum(sp);
      dpp = row_sum(dpp);
      const bool valid = row_ok && kpos < S && (!causal || kpos <= qpos);
      const float p = valid ? expf(sp * scale - l) : 0.f;
      const float ds = p * (dpp - dl) * scale;
#pragma unroll
      for (int e = 0; e < DS; ++e) acc[e] = fmaf(ds, ks[j][t + TPR * e], acc[e]);
    }
    __syncthreads();
  }

  if (row_ok) {
    const size_t out_off = head_base + (size_t)qpos * row_stride + t;
#pragma unroll
    for (int e = 0; e < DS; ++e) dq[out_off + TPR * e] = acc[e];
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  int B, S, H, causal;
  float scale;
  cudaStream_t stream;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int S, int H,
               int causal, float scale, void* stream) {
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, S, H, causal, scale,
              static_cast<cudaStream_t>(stream)};
}

template <int D>
void launch_dkv(const Args& a, float* dk, float* dv) {
  dim3 grid(a.B * a.H, (a.S + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.S, a.H, a.causal,
      a.scale);
}

template <int D>
void launch_dq(const Args& a, float* dq) {
  dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.S, a.H, a.causal,
      a.scale);
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv [B, S, H, D] and lse, delta [B, H, S], float32,
// contiguous, on one device. D must be 32, 64 or 128.
int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int S, int H, int D, int causal, float scale,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, causal, scale,
                           stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  switch (D) {
    case 32: launch_dkv<32>(a, dkf, dvf); break;
    case 64: launch_dkv<64>(a, dkf, dvf); break;
    case 128: launch_dkv<128>(a, dkf, dvf); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The same inputs; dq [B, S, H, D].
int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int S,
                               int H, int D, int causal, float scale,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, causal, scale,
                           stream);
  float* dqf = static_cast<float*>(dq);
  switch (D) {
    case 32: launch_dq<32>(a, dqf); break;
    case 64: launch_dq<64>(a, dqf); break;
    case 128: launch_dq<128>(a, dqf); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
