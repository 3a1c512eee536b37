// 3x3 / stride-1 / pad-1 convolution, NHWC x HWIO -> NHWC, float32 on
// CUDA cores, for sm_90a.
//
// Replaces: paddle_tpu/kernels/conv3x3.py, `_conv3x3_fwd` (its
// pallas_call) with the kernel body `_kernel`, reached through
// `conv3x3_s1_nhwc`. It computes
//   out[n, h, w, o] = sum_{dy, dx, c} xpad[n, h + dy, w + dx, c] * w[dy, dx, c, o]
// with xpad the input padded by one zero pixel on every side, summed in
// float32. The same kernel serves the backward's dx, as on the TPU: dx is
// the 3x3 / s1 / p1 conv of the output gradient with the spatially
// flipped, in/out-swapped filter (`_vjp_bwd`), which the wrapper forms.
//
// What bounds it on the H100: operations. One call does 2 * N*H*W * C*O*9
// flops on N*H*W*(C + O) + 9*C*O floats; at ResNet-50's stage shapes
// (56x56x64 to 7x7x512, batch 32) that is 100 to 1000 flops a byte, far
// above the float32 balance of the card (67 TFLOP/s over 3.35 TB/s, 20
// flops a byte), so the least time is the flops over 67 TFLOP/s. This
// first version runs on the CUDA cores in full float32; TF32 through
// mma/wgmma and TMA loads are later work and would change the numbers.
//
// Design: an implicit GEMM. The TPU kernel keeps one whole padded image
// in VMEM and runs 9 (H*W, C) @ (C, O) matmuls on it; a thread block here
// has far less fast memory, so the conv is cut as a GEMM of
// M = N*H*W output pixels by O output channels over K = 9*C, and never
// materialised (no im2col buffer, no padded copy). One thread block owns
// a tile of BM = 64 pixels x BN = 64 output channels. It walks the 9 taps
// and, inside each, the input channels in chunks of BK = 16: a 64 x 16
// input patch (one shifted pixel per row, zero where the tap falls in the
// 1-pixel halo or past the ragged pixel tail) and a 16 x 64 slice of the
// tap's filter go through shared memory, and each of the 256 threads
// accumulates a 4 x 4 register micro-tile (4 pixels x 4 channels) with
// float32 FFMA. Channel tails (C or O not a multiple of the tile) are
// masked with zeros. When C and O are multiples of 4 the global loads and
// the stores are 16-byte vectors.
//
// Tensors are contiguous: x [N, H, W, C], w [3, 3, C, O], out [N, H, W, O].
// The kernel allocates nothing. The entry point launches on the stream it
// is given and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // input channels per shared-memory step
constexpr int TM = 4;     // pixels per thread
constexpr int TN = 4;     // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int AS_LD = BM + 4;   // row pitch of the patch tile (16 B aligned)

static_assert(THREADS == 256, "the load maps below assume 256 threads");
static_assert(BM * BK == 4 * THREADS && BK * BN == 4 * THREADS,
              "each thread loads 4 values of each tile");

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int H, int W, int C, int O,
               long long M) {
  __shared__ __align__(16) float as[BK][AS_LD];   // patch, [channel][pixel]
  __shared__ __align__(16) float bs[BK][BN];      // filter slice, [channel][o]

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the patch pixel and the 4 channels this thread loads
  const int a_p = tid >> 2;          // 0..63
  const int a_c = (tid & 3) * 4;     // 0, 4, 8, 12
  const long long pm = m0 + a_p;
  const bool a_row = pm < M;
  int an = 0, ah = 0, aw = 0;
  if (a_row) {
    const long long hw = (long long)H * W;
    an = (int)(pm / hw);
    const int r = (int)(pm - (long long)an * hw);
    ah = r / W;
    aw = r - ah * W;
  }
  // the filter row and the 4 output channels this thread loads
  const int b_k = tid >> 4;          // 0..15
  const int b_o = (tid & 15) * 4;    // 0..60
  // the micro-tile this thread computes
  const int tx = tid % (BN / TN);    // output channels tx*4 .. tx*4+3
  const int ty = tid / (BN / TN);    // pixels ty*4 .. ty*4+3

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ih = ah + tap / 3 - 1;
    const int iw = aw + tap % 3 - 1;
    const bool a_in = a_row && ih >= 0 && ih < H && iw >= 0 && iw < W;
    const long long a_off =
        a_in ? (((long long)an * H + ih) * W + iw) * (long long)C : 0;
    const float* wt = w + (long long)tap * C * O;
    for (int c0 = 0; c0 < C; c0 += BK) {
      // stage the input patch, transposed to [channel][pixel]
      const int ca = c0 + a_c;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_in && ca < C)
          v = *reinterpret_cast<const float4*>(x + a_off + ca);
        as[a_c + 0][a_p] = v.x;
        as[a_c + 1][a_p] = v.y;
        as[a_c + 2][a_p] = v.z;
        as[a_c + 3][a_p] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          as[a_c + j][a_p] = (a_in && ca + j < C) ? x[a_off + ca + j] : 0.f;
      }
      // stage the tap's filter slice, [channel][output channel]
      const int kb = c0 + b_k;
      const int ob = n0 + b_o;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < C && ob < O)
          v = *reinterpret_cast<const float4*>(wt + (long long)kb * O + ob);
        *reinterpret_cast<float4*>(&bs[b_k][b_o]) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bs[b_k][b_o + j] =
              (kb < C && ob + j < O) ? wt[(long long)kb * O + ob + j] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int o = n0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    float* dst = out + m * O;
    if constexpr (VEC) {
      if (o < O)
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (o + j < O) dst[o + j] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x [N, H, W, C], w [3, 3, C, O] and out [N, H, W, O], float32,
// contiguous, on one device.
int conv3x3_s1_nhwc_f32(const void* x, const void* w, void* out, int N,
                        int H, int W, int C, int O, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const long long mblocks = (M + BM - 1) / BM;
  const long long oblocks = (O + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || oblocks > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  const bool vec = C % 4 == 0 && O % 4 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
  if (vec)
    conv3x3_kernel<true><<<grid, THREADS, 0, st>>>(xf, wf, of, H, W, C, O, M);
  else
    conv3x3_kernel<false><<<grid, THREADS, 0, st>>>(xf, wf, of, H, W, C, O, M);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
