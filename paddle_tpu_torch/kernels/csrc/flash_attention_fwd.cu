// Flash attention forward, float32 on CUDA cores, for sm_90a.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, `_fa_forward` (its
// pallas_call) with the kernel body `_fa_kernel`, reached through
// `flash_attention_with_lse`. It computes o = softmax(q k^T * scale) v,
// causal or not, and the per-row logsumexp lse = m + log(den) with the
// denominator floored at 1e-20, as the TPU kernel does.
//
// What bounds it on the H100: operations. A causal head of length S does
// about 4 * D * S * (S + 1) / 2 flops (q.k and p.v) on 4 * S * D * 4
// bytes of q, k, v and o; at S = 1024, D = 64 that is about 128 flops a
// byte, above the f32 balance of the card (67 TFLOP/s over 3.35 TB/s, 20
// flops a byte), so the least time is the flops over 67 TFLOP/s. This
// first version runs on the CUDA cores in full f32; tensor cores (TF32,
// bf16 through wgmma) are later work and would change the numbers.
//
// Design. The TPU kernel holds the whole K and V of a head in VMEM and
// loops over 128-wide k blocks; a thread block here has 227 KB of shared
// memory at most, so it streams BK-row tiles of K and V through shared
// memory instead. One thread block owns one (batch * head, BQ-row q
// tile); TPR threads share one query row, each holding D / TPR elements
// of q and of the output accumulator (element t + TPR * i, so the threads
// of a row read distinct shared-memory banks). A q.k dot is reduced over
// the TPR threads with two warp shuffles. Each k tile takes its row
// maximum first and then rescales once, so the exponential of the
// rescale is paid once a tile, not once a column. For causal attention
// the loop stops at the tile that holds the q tile's last row; inside
// the diagonal tile, and past the ragged end of S, columns are masked in
// the kernel (the wrapper pads nothing).
//
// Tensors are [B, S, H, D], contiguous: the layout the prefill's
// projections produce, so no transpose is needed. lse is [B, H, S].
// The kernel allocates nothing. The entry point launches on the stream it
// is given and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 32;   // key rows per shared-memory tile
constexpr int TPR = 4;   // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int causal,
                 float scale) {
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

  float qv[DS];
  float acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    qv[i] = row_ok ? q[head_base + (size_t)qpos * row_stride + t + TPR * i]
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float den = 0.f;

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

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DS; ++i) part = fmaf(qv[i], ks[j][t + TPR * i], part);
      part += __shfl_xor_sync(FULL_MASK, part, 1);
      part += __shfl_xor_sync(FULL_MASK, part, 2);
      const int kpos = k0 + j;
      const bool valid = kpos < S && (!causal || kpos <= qpos);
      s[j] = valid ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float new_m = fmaxf(m, tile_max);
    // new_m stays -inf only while every column so far was masked (rows of
    // the ragged q tail past S); such a row has nothing to rescale yet
    if (new_m != -INFINITY) {
      const float alpha = expf(m - new_m);
      den *= alpha;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s[j] - new_m);
        den += p;
#pragma unroll
        for (int i = 0; i < DS; ++i) acc[i] = fmaf(p, vs[j][t + TPR * i], acc[i]);
      }
      m = new_m;
    }
    __syncthreads();
  }

  if (row_ok) {
    const float den_safe = fmaxf(den, 1e-20f);
    const size_t out_off = head_base + (size_t)qpos * row_stride + t;
#pragma unroll
    for (int i = 0; i < DS; ++i) o[out_off + TPR * i] = acc[i] / den_safe;
    if (t == 0) lse[(size_t)bh * S + qpos] = m + logf(den_safe);
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v, float* o,
            float* lse, int B, int S, int H, int causal, float scale,
            cudaStream_t stream) {
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(q, k, v, o, lse, S, H,
                                                     causal, scale);
}

}  // namespace

extern "C" {

// q, k, v, o [B, S, H, D] and lse [B, H, S], float32, contiguous, on one
// device. D must be 32, 64 or 128.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int H, int D,
                            int causal, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: launch<32>(qf, kf, vf, of, lf, B, S, H, causal, scale, st); break;
    case 64: launch<64>(qf, kf, vf, of, lf, B, S, H, causal, scale, st); break;
    case 128: launch<128>(qf, kf, vf, of, lf, B, S, H, causal, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
