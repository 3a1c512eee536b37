#!/usr/bin/env python3
"""The design choices of the 3xTF32 kernels (``paddle_tpu_torch/kernels/
csrc/flash_attention_bwd.cu``, ``flash_attention_fwd.cu``, ``matmul.cu``,
``fused_gru.cu``, ``fused_lstm.cu`` and ``conv3x3.cu``) and of the paged
decode attention (``paged_attention.cu``) against alternatives, on one
NVIDIA card. Run from the root of a checkout:

    python3 tools/torch_flash_bwd_study.py
        [--kernel bwd fwd matmul gru lstm conv3x3 paged] [--against DIR]

(the flash backward alone by default). For each kernel it builds the
committed source and variants made from it and from the shared headers
(``tf32x3.cuh``, ``recurrence.cuh``) by text substitution, each with
``nvcc`` into its own directory under ``build/flash_bwd_study/``. Every
kernel but the two recurrences has these:

- ``cvt_rna``: the 3xTF32 split through ``cvt.rna.tf32.f32`` (hi =
  cvt(x), lo = cvt(x - hi)) instead of the header's integer rounding;
- ``mma_accumulator``: the long sums (bwd: dk and dv over the queries,
  dq over the keys; fwd: o over the keys; matmul: out over K) left in
  the mma accumulators for the whole walk instead of a float32 add after
  each streamed tile;
- ``tf32_once``: one TF32 product a float32 one (hi * hi) instead of
  three, so the split's lo halves go unused: not float32-exact (its
  errors are ~1e-3), timed to show what the 3xTF32 scheme costs.

The flash forward and backward also have ``p_once``: their bfloat16
faces with p and ds rounded to one bfloat16 (FlashAttention-2's
products) instead of split into a bfloat16 hi and lo (``bf16.cuh``).
The backward also has ``bn64`` (streamed tiles of 64 rows instead of 32,
timed at D 64; the D 128 templates spill at this size) and ``planes``
(the dK/dV kernel's q and dO tiles split once as they land, into hi (in
place) and lo planes in shared memory that the fragment loads then read,
instead of each warp splitting every fragment it loads; the dQ kernel as
in the source), and for its bfloat16 faces' wgmma kernels (D 64)
``timeline`` (clock64 marks: each consumer warpgroup's cycles a tile
waiting for a stage, for its turn, from issuing a turn's group of
products to holding it, and forming p and ds), ``no_pingpong`` (the
named barriers of the turns made no-ops), ``ring6`` (a ring of six
stages instead of four) and ``bq64`` (dK/dV tiles of 64 queries, a
turn's products then two groups). The forward has ``bn64`` (key tiles of 64 rows),
``br32`` (blocks of 2 warps and 32 query rows instead of 4 and 64),
``q_in_smem`` (the block's q in shared memory and its fragments split
on every tile at every D, as the source does at D 128 only),
``min_blocks3`` (registers capped for 3 blocks an SM) and ``one_chain``
(each 3xTF32 product's three terms in one mma accumulator, instead of
the large term and the two small ones in separate chains); the matmul
``stages2`` (a ring of two stages instead of three), and for its
bfloat16 face ``wgmma_accumulator`` (the sum over all of K left in the
wgmma accumulator, instead of each 64-deep stage summed from zero and
added in float32), ``ring3`` and ``ring5`` (a ring of three or five
stages instead of four). The GRU has
``dj4``: 4 units a block instead of 8 (at D 512, N 64: 128 unit groups
of all 64 rows, instead of 64 unit groups by 2 row groups of 32 rows);
``w_split_at_load``: W kept as its floats and split at each load, the
form the kernel takes only where the split fragments do not fit. The
LSTM has ``w_split_at_load`` likewise, and ``two_passes``: pieces of up
to 64 rows (4 m tiles, where the source caps them at 32 for its
registers), each step's four gate columns multiplied in two passes of
two over the same staged rows (the A fragments loaded and split twice),
instead of one pass of four. The conv3x3 has ``t128x128``, ``t128x64``
and ``t64x64`` (that tiling of the float32 face forced at every shape,
in place of the source's rule), ``stages2`` (a ring of two stages
instead of three) and ``tf32_once``, and for its bfloat16 face
``walk``, ``ring3``, ``ring6``, ``split32``, ``two_blocks``, ``cluster2``
and ``pipelined`` (below). The paged attention has ``split32``, ``split128`` and
``split256`` (splits of that many columns instead of 64), ``unroll2``
and ``unroll8`` (2 or 8 loads of K and as many of V in flight a lane
instead of 4).

With ``--against DIR`` (the root of another checkout, say a parent
commit's ``git archive``) each study also builds that checkout's source
and headers as one more variant, ``against``, so that two commits are
timed in one call.

For each it prints the registers and spills ``-Xptxas -v`` reports and:

- bwd: the largest error of dq, dk and dv over the largest magnitude of a
  float64 plain backward at causal S 1024 (B 8, H 12, D 64: the LM
  step's shape) and S 2048 (B 2, H 4), and at S 1024 the time of each
  kernel; the same of the bfloat16 faces at S 1024 (a library without
  them is skipped), with phase 9's gate against the float32 plain
  backward, each kernel's time by CUDA events and by device time and,
  beside the source, its mma.sync kernels forced at D 64 and SDPA's
  backward on bfloat16; the gate at S 2048 (B 2, H 4); and whether each
  variant's float32
  outputs equal the source's bit for bit at the LM step's shape and the
  D 32 (non-causal) and D 128 (causal) templates, S 130
  (``FLASH_SAME_CASES``; with ``--against``: the float32 faces left as
  they were);
- fwd: the largest error of o and lse against a float64 plain forward
  (o over its largest magnitude, lse absolute) at causal S 1024 (B 8, H
  12, D 64) and S 4096 (B 1, H 4), and the time at the prefill's shape
  (B 1, S 1024, H 12, D 64, causal) and the LM step's (B 8); the same of
  the bfloat16 face at the LM step's shape; and the float32 outputs' bit
  identity with the source's, as for bwd;
- matmul: at the LM step's gemm shapes (8192 x 768 x 768, 8192 x 768 x
  3072, 8192 x 3072 x 768) the largest error over the largest magnitude
  of a float64 product, worst over the tilings, the time of every
  tiling, and whether each variant's outputs equal the source's bit for
  bit at every tiling (with ``--against``: a change left the float32
  face as it was); then the bfloat16 face (bfloat16 out) of the source,
  of its variants and of ``--against``'s checkout (a parent's face
  before its wgmma kernel is called with its own arguments and
  tilings): the same errors and times, whether each variant's (and
  ``--against``'s, where it has the wgmma kernel) outputs equal the
  source's bit for bit at every tiling, ``torch.matmul`` on bfloat16
  beside them, the mean over the LM step's 72 launches at each
  library's fastest tiling a shape (also with the L2 flushed by a read),
  and a sweep over K at M 8192, N 768 whose straight line splits a
  launch's time into what every 64-deep stage costs and what is left at
  no stage;
- gru, lstm: the largest error of hs (and the LSTM's cs) over its
  largest magnitude against a float64 plain recurrence at T 100, N 64,
  D 512 (the sequence slice's shape), ragged and full, and the time at
  that shape (full lengths), at T 10 and at N 8, with the microseconds
  a step from T 10 to 100, and at T 100, N 64 and D 1024 and 1280 (W
  split at each load, and blocks of two unit groups; a variant that
  cannot launch there reads its error); and whether each variant's
  outputs equal the source's bit for bit at every shape of
  ``chip_smoke.RNN_EDGE_SHAPES`` (ragged lengths), which with
  ``--against`` shows a refactoring left a kernel's results as they
  were; and the LSTM's bfloat16 face (where a library has one) at T 100,
  N 64, D 512: its error over one ulp of each element's own magnitude
  and its time beside the cast-around yardstick's (widen, the float32
  face, round), in turns;
- conv3x3: at ResNet-50's four stage shapes at batch 32
  (``chip_smoke.R50_CONV_SHAPES``) the largest error of the forward and
  of dx (the kernel on the output gradient and the rotated filter) over
  the largest magnitude of a float64 plain conv, the time of each, the
  tiling the source's rule takes there, and whether each variant's
  outputs equal the source's bit for bit (the float32 face); then the
  bfloat16 face: first its im2col walk alone (variant ``walk``: a kernel
  that lands each box of the face's pixel loads and writes it out, at
  every edge shape TMA can take, 128-pixel boxes across three 7 x 7
  images and the stage shapes, every tap and channel chunk, BM 64 and
  128, against the padded input's slice), then at the stage shapes the
  source's face at its rule's tiling and at each wgmma tiling forced
  (times, and their outputs bit-identical), its variants ``ring3`` and
  ``ring6`` (a ring of three or six stages instead of four),
  ``split32`` (each 64-deep stage summed as two 32-deep groups from
  zero), ``two_blocks`` (the BN 64 tilings at two blocks an SM, their
  registers split to fit), ``cluster2`` (clusters of two M tiles, each
  block loading half of every stage's filter rows and multicasting them
  to both, so the filter's L2 reads halve) and ``pipelined`` (stage k's
  products issued before stage k - 1's sum is added, one wgmma group in
  flight), and ``--against``'s face: errors against a float64 conv, fwd
  and dx times, cuDNN on bfloat16 beside them, and the mean over a
  ResNet-50 step's 16 launches;
- paged: at the decode step's shape (``chip_smoke._paged_inputs``: MB
  64, T 16, nh 12, dh 64) with R 16 (phase 2's positions) and R 1 and
  4 (every row at the last column), the largest error against a float64
  plain version, the time of both launches, the same time with the L2
  flushed by a read instead of a write (so that no dirty line of the
  flush is written back during the launch), and the device time of the
  split and the merge kernel apart (``torch.profiler``), under either
  flush. A
  source without ``paged_attention_splits`` (the single-pass kernel of
  a parent commit) is called with its own arguments.

Times are CUDA-event medians over 20 launches, L2 flushed before each.
The last lines are the card's name and power limit and one JSON object
with all of it. Exits non-zero without a card, or if the sources no
longer have the text a variant replaces.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (CONV_EDGE_SHAPES, MM_COUNTS,  # noqa: E402
                        MM_SHAPES, R50_CONV_COUNTS, R50_CONV_SHAPES,
                        RNN_EDGE_SHAPES, _paged_inputs)
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3 as conv  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import fused_gru as gru  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as lstm  # noqa: E402
from paddle_tpu_torch.kernels import matmul as mm  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "flash_bwd_study")

INT_SPLIT = """  const uint32_t r = __float_as_uint(x) + 0x1000u;
  hi = r;
  lo = __float_as_uint(x - __uint_as_float(r & 0xffffe000u));
"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));
"""
PLANE_LOADS = """// B fragments read from a tile already split into hi and lo planes
template <int LD>
__device__ __forceinline__ FragB load_b_t2(const float* hi, const float* lo,
                                           int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[g * LD + t]);
  f.lo[0] = __float_as_uint(lo[g * LD + t]);
  f.hi[1] = __float_as_uint(hi[g * LD + t + 4]);
  f.lo[1] = __float_as_uint(lo[g * LD + t + 4]);
  return f;
}
template <int LD>
__device__ __forceinline__ FragB load_b_perm2(const float* hi,
                                              const float* lo, int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[2 * t * LD + g]);
  f.lo[0] = __float_as_uint(lo[2 * t * LD + g]);
  f.hi[1] = __float_as_uint(hi[(2 * t + 1) * LD + g]);
  f.lo[1] = __float_as_uint(lo[(2 * t + 1) * LD + g]);
  return f;
}

// -- asynchronous copies"""
PLANE_SPLIT = """    const float* dlt = dls + (it & 1) * BN;
    // split the landed q and dO tiles once: hi in place, lo beside
    for (int i = threadIdx.x; i < BN * D; i += THREADS) {
      const int e = (i / D) * LD + i % D;
      uint32_t hi, lo;
      split(qt[e], hi, lo);
      const_cast<float*>(qt)[e] = __uint_as_float(hi);
      qlo[e] = __uint_as_float(lo);
      split(dot[e], hi, lo);
      const_cast<float*>(dot)[e] = __uint_as_float(hi);
      dolo[e] = __uint_as_float(lo);
    }
    __syncthreads();
"""
# (text in the sources, text in the variant), shared by every kernel
COMMON = {
    "cvt_rna": [(INT_SPLIT, CVT_SPLIT)],
    "tf32_once": [("  mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n",
                   "")],
}
# the bfloat16 faces with p and ds rounded to one bfloat16 (FlashAttention-2's
# products) instead of split into a bfloat16 hi and lo
P_ONCE = [("  mma_bf16_k16(d, a.lo, b);\n  mma_bf16_k16(d, a.hi, b);\n",
           "  mma_bf16_k16(d, a.hi, b);\n")]
# the bfloat16 backward's wgmma kernels with clock64 marks: each consumer
# warpgroup sums the cycles of its walk spent waiting for a stage (0),
# waiting for its turn (1), from issuing a turn's group (s and dp of this
# tile, the register-A products of the last) to holding it (2) and
# forming p and ds (3), with its whole walk (5) and the tiles it took
# (6), into a device array per kernel that flash_bwd_timeline copies out
# (one row of 8 a warpgroup, blocks in launch order)
def _bwd_marks(array, loop_head, turn, pairs, tail, tiles):
    wait, sync, rest = turn.split("\n", 2)
    return [
        (loop_head, loop_head + "    unsigned long long tl[8] = {0, 0, 0, 0, "
         "0, 0, 0, 0}, t_a;\n    const unsigned long long t_0 = clk();\n"),
        (turn, """      t_a = clk();
%s
      tl[0] += clk() - t_a;
      t_a = clk();
%s
      tl[1] += clk() - t_a;
      t_a = clk();
%s""" % (wait, sync, rest)),
        (pairs, "      tl[2] += clk() - t_a;\n      t_a = clk();\n" + pairs
         + "      tl[3] += clk() - t_a;\n"),
        (tail, tail + """    tl[5] = clk() - t_0;
    tl[6] = %s;
    if (threadIdx.x %% 128 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        %s[(blockIdx.x * gridDim.y + blockIdx.y) %% 4096][wg - 1][i] =
            tl[i];
    }
""" % (tiles, array))]


BWD_TIMELINE = [
    ("// 2^x on the special-function unit",
     """__device__ unsigned long long g_tl_dkv[4096][2][8];
__device__ unsigned long long g_tl_dq[4096][2][8];

__device__ __forceinline__ unsigned long long clk() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;\\n" : "=l"(c));
  return c;
}

// 2^x on the special-function unit"""),
    ("const char* error_string(int code) {",
     """int flash_bwd_timeline(void* dst, int bytes, int which) {
  return (int)(which ? cudaMemcpyFromSymbol(dst, g_tl_dq, bytes)
                     : cudaMemcpyFromSymbol(dst, g_tl_dkv, bytes));
}

const char* error_string(int code) {"""),
] + _bwd_marks(
    "g_tl_dkv", "    mbar_wait(&kvfull, 0);\n",
    """      mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > first) {
""", "      p_ds(it, s);\n", "    if (wk == 0) bar_arrive(other, 256);\n",
    "max(0, n_tiles - first)") + _bwd_marks(
    "g_tl_dq", "    mbar_wait(&qfull, 0);\n",
    """      mbar_wait(&full[s], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > 0) {
""", "      ds_pairs(it);\n", """        bar_arrive(other, 256);
      }
    }
""", "last")
# the turns' named barriers made no-ops (in hopper.cuh; the backward's
# only named barriers)
NO_TURNS = [
    ('  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(count) : '
     '"memory");\n', ""),
    ('  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(count) : '
     '"memory");\n', "")]

BWD_VARIANTS = {
    "p_once": P_ONCE,
    "mma_accumulator": [
        ("      float cv[4] = {0.f, 0.f, 0.f, 0.f}, "
         "ck[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "      float (&cv)[4] = dva[dn], (&ck)[4] = dka[dn];\n"),
        ("      add4(dva[dn], cv);\n      add4(dka[dn], ck);\n", ""),
        ("      float c[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "      float (&c)[4] = dqa[dn];\n"),
        ("      add4(dqa[dn], c);\n", ""),
    ],
    "bn64": [("constexpr int BN = 32; ", "constexpr int BN = 64; ")],
    # the bfloat16 faces' wgmma kernels (D 64): clock64 marks a tile by
    # phase; the two consumer warpgroups without turns (the named
    # barriers made no-ops); a ring of 6 stages instead of 4; dK/dV
    # tiles of 64 queries, a turn's products then two groups (the last
    # tile's dv and dk waited for before this tile's s^T and dp^T are
    # issued: one group would hold 192 floats of arrays a thread)
    "timeline": BWD_TIMELINE,
    "no_pingpong": NO_TURNS,
    "ring6": [("constexpr int RING_W = 4; ", "constexpr int RING_W = 6; ")],
    "bq64": [("constexpr int BQ_W = 32; ", "constexpr int BQ_W = 64; "),
             ("""        wgmma_fence();
        s_products(s);
        dkv_products((it - 1) % RING_W);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
        pin_dkv();
        mbar_arrive(&empty[(it - 1) % RING_W]);
""", """        wgmma_fence();
        dkv_products((it - 1) % RING_W);
        wgmma_commit();
        wgmma_wait<0>();
        pin_dkv();
        mbar_arrive(&empty[(it - 1) % RING_W]);
        wgmma_fence();
        s_products(s);
        wgmma_commit();
        wgmma_wait<0>();
        bar_arrive(other, 256);
        pin_s();
""")],
    "planes": [
        ("\n// -- asynchronous copies", "\n" + PLANE_LOADS),
        ("  return ((2 * BR + 4 * BN) * (D + 4) + 4 * BN) * 4;",
         "  return ((2 * BR + 6 * BN) * (D + 4) + 4 * BN) * 4;"),
        ("  float* dls = ls + 2 * BN;         // [2][BN]\n",
         "  float* dls = ls + 2 * BN;         // [2][BN]\n"
         "  float* qlo = dls + 2 * BN;\n  float* dolo = qlo + BN * LD;\n"),
        ("    const float* dlt = dls + (it & 1) * BN;\n", PLANE_SPLIT),
        ("load_b_t<LD>(qt + n * 8 * LD + kk * 8, g, t)",
         "load_b_t2<LD>(qt + n * 8 * LD + kk * 8, qlo + n * 8 * LD + kk * 8,"
         " g, t)"),
        ("load_b_t<LD>(dot + n * 8 * LD + kk * 8, g, t)",
         "load_b_t2<LD>(dot + n * 8 * LD + kk * 8, dolo + n * 8 * LD + "
         "kk * 8, g, t)"),
        ("load_b_perm<LD>(dot + off, g, t)",
         "load_b_perm2<LD>(dot + off, dolo + off, g, t)"),
        ("load_b_perm<LD>(qt + off, g, t)",
         "load_b_perm2<LD>(qt + off, qlo + off, g, t)"),
    ],
}


# the flash forward's wgmma kernel with clock64 marks: each consumer
# warpgroup sums the cycles of its walk spent waiting for a stage (0),
# waiting for its turn (1), on the previous tile's p v (2), from issuing
# q k^T to holding s (3) and on the softmax (4), with its whole walk (5)
# and its tiles (6), into a device array that flash_fwd_timeline copies
# out (one row of 8 a warpgroup, blocks in launch order)
FWD_TIMELINE = [
    ("// 2^x on the special-function unit",
     """__device__ unsigned long long g_timeline[4096][2][8];

__device__ __forceinline__ unsigned long long clk() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;\\n" : "=l"(c));
  return c;
}

// 2^x on the special-function unit"""),
    ("    mbar_wait(&qfull, 0);\n",
     "    mbar_wait(&qfull, 0);\n"
     "    unsigned long long tl[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_a;\n"
     "    const unsigned long long t_0 = clk();\n"),
    ("""      mbar_wait(&full[st], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > 0) {
        pv_issue((it - 1) % RING_W, phi, plo);
        wgmma_wait<0>();
        pv_done((it - 1) % RING_W, phi, plo);
      }
""", """      t_a = clk();
      mbar_wait(&full[st], (it / RING_W) & 1);
      tl[0] += clk() - t_a;
      t_a = clk();
      bar_sync(mine, 256);
      tl[1] += clk() - t_a;
      t_a = clk();
      if (it > 0) {
        pv_issue((it - 1) % RING_W, phi, plo);
        wgmma_wait<0>();
        pv_done((it - 1) % RING_W, phi, plo);
      }
      tl[2] += clk() - t_a;
      t_a = clk();
"""),
    ("""      wgmma_wait<0>();
      wgmma_fence_operands(s);
      softmax(it, phi, plo);
    }
""", """      wgmma_wait<0>();
      wgmma_fence_operands(s);
      tl[3] += clk() - t_a;
      t_a = clk();
      softmax(it, phi, plo);
      tl[4] += clk() - t_a;
    }
"""),
    ("""    rescale_add(alpha[0], alpha[1]);

#pragma unroll
    for (int half = 0; half < 2; ++half) {""",
     """    rescale_add(alpha[0], alpha[1]);
    tl[5] = clk() - t_0;
    tl[6] = n_tiles;
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        g_timeline[(blockIdx.x * gridDim.y + blockIdx.y) % 4096][wq][i] =
            tl[i];
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {"""),
    ("const char* error_string(int code) {",
     """int flash_fwd_timeline(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, g_timeline, bytes);
}

const char* error_string(int code) {"""),
]

# the flash forward wgmma kernel's consumer loop as the source has it
# (turns between the two warpgroups), and the overlap within one
# warpgroup that the intra_wg variant puts in its place
FWD_PINGPONG_LOOP = """\
    const int mine = 1 + wq, other = 2 - wq;
    if (wq == 1) bar_arrive(1, 256);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % RING_W;
      mbar_wait(&full[st], (it / RING_W) & 1);
      bar_sync(mine, 256);
      if (it > 0) {
        pv_issue((it - 1) % RING_W, phi, plo);
        wgmma_wait<0>();
        pv_done((it - 1) % RING_W, phi, plo);
      }
      qk_issue(st);
      bar_arrive(other, 256);
      if (it > 0) rescale_add(alpha[0], alpha[1]);
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      softmax(it, phi, plo);
    }
    // the last tile's p v, in a turn of its own; every turn of warpgroup
    // 1 meets one of warpgroup 2, whose last turn hands nothing on
    bar_sync(mine, 256);
    pv_issue((n_tiles - 1) % RING_W, phi, plo);
    wgmma_wait<0>();
    pv_done((n_tiles - 1) % RING_W, phi, plo);
    if (wq == 0) bar_arrive(other, 256);
    rescale_add(alpha[0], alpha[1]);
"""
FWD_INTRA_WG_LOOP = """\
    uint32_t ph2[KS][4], pl2[KS][4];
    mbar_wait(&full[0], 0);
    qk_issue(0);
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    softmax(0, phi, plo);
    auto step = [&](int it, uint32_t(&ph)[KS][4], uint32_t(&pl)[KS][4],
                    uint32_t(&nh)[KS][4], uint32_t(&nl)[KS][4]) INLINE {
      const int st = it % RING_W, sp = (it - 1) % RING_W;
      mbar_wait(&full[st], (it / RING_W) & 1);
      qk_issue(st);
      pv_issue(sp, ph, pl);
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      const float a0 = alpha[0], a1 = alpha[1];
      softmax(it, nh, nl);
      wgmma_wait<0>();
      pv_done(sp, ph, pl);
      rescale_add(a0, a1);
    };
    auto last = [&](uint32_t(&ph)[KS][4], uint32_t(&pl)[KS][4]) INLINE {
      const int sp = (n_tiles - 1) % RING_W;
      pv_issue(sp, ph, pl);
      wgmma_wait<0>();
      pv_done(sp, ph, pl);
      rescale_add(alpha[0], alpha[1]);
    };
    int it = 1;
    for (; it + 1 < n_tiles; it += 2) {
      step(it, phi, plo, ph2, pl2);
      step(it + 1, ph2, pl2, phi, plo);
    }
    if (it < n_tiles) {
      step(it, phi, plo, ph2, pl2);
      last(ph2, pl2);
    } else {
      last(phi, plo);
    }
"""
FWD_VARIANTS = {
    "p_once": P_ONCE,
    "tf32_once": COMMON["tf32_once"] + [
        ("  mma_tf32(e, a.lo, b.hi);\n  mma_tf32(e, a.hi, b.lo);\n", "")],
    "mma_accumulator": [
        ("        float c[4] = {0.f, 0.f, 0.f, 0.f}, "
         "cl[4] = {0.f, 0.f, 0.f, 0.f};\n",
         """#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dn][i] *= alpha[i >> 1];
        float (&c)[4] = acc[dn];
        float (&cl)[4] = acc[dn];
"""),
        ("""#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[dn][i] = fmaf(acc[dn][i], alpha[i >> 1], c[i] + cl[i]);
""", ""),
    ],
    "one_chain": [
        ("          mma3_apart(s[n], sl[n], a,\n", "          mma3(s[n], a,\n"),
        ("          mma3_apart(c, cl, pa[n],\n", "          mma3(c, pa[n],\n")],
    "bn64": [("constexpr int BN = 32; ", "constexpr int BN = 64; ")],
    "br32": [("constexpr int WARPS = 4;", "constexpr int WARPS = 2;")],
    "q_in_smem": [("constexpr bool Q_IN_REGS = D < 128;",
                   "constexpr bool Q_IN_REGS = false;")],
    "min_blocks3": [("__launch_bounds__(THREADS)\nflash_fwd_kernel",
                     "__launch_bounds__(THREADS, 3)\nflash_fwd_kernel")],
    # the bfloat16 face's wgmma kernel (D 64)
    "no_pingpong": [
        ("      bar_sync(mine, 256);\n      if (it > 0) {\n",
         "      if (it > 0) {\n"),
        ("      bar_arrive(other, 256);\n", ""),
        ("    bar_sync(mine, 256);\n    pv_issue(", "    pv_issue("),
        ("    if (wq == 0) bar_arrive(other, 256);\n", ""),
        ("    if (wq == 1) bar_arrive(1, 256);\n", "")],
    "p_once_wgmma": [
        ("        wgmma_m64n64k16_rs(pv, pl[j], vd, true);\n", "")],
    # the other overlap: within each warpgroup, tile it's q k^T and tile
    # it - 1's p v issued together and tile it's softmax run under the
    # p v (p double-buffered in registers), no turns between warpgroups
    "intra_wg": [(FWD_PINGPONG_LOOP, FWD_INTRA_WG_LOOP)],
    # the same on 64-key tiles, whose s and two p buffers fit the 168
    # registers ptxas gives a thread of a 384-thread block
    "intra_wg_bn64": [(FWD_PINGPONG_LOOP, FWD_INTRA_WG_LOOP),
                      ("constexpr int BN_W = 128;", "constexpr int BN_W = 64;")],
    # the same on 128-key tiles with the consumers asking for 240
    # registers and the producer keeping 24
    "intra_wg_240": [(FWD_PINGPONG_LOOP, FWD_INTRA_WG_LOOP),
                     ("constexpr int PRODUCER_REGS_W = 40;",
                      "constexpr int PRODUCER_REGS_W = 24;"),
                     ("constexpr int CONSUMER_REGS_W = 232;",
                      "constexpr int CONSUMER_REGS_W = 240;")],
    "bn64_wgmma": [("constexpr int BN_W = 128;", "constexpr int BN_W = 64;")],
    "timeline": FWD_TIMELINE,
    # timing only: lo taken as zero (its conversion and subtraction gone,
    # its products kept), so the outputs are p's hi alone; what the split
    # costs the softmax, apart from the products it adds
    "lo_zero": [("          split_bf16(p0, p1, ph[j][r], pl[j][r]);", """\
          ph[j][r] = pack_bf16(p0, p1);
          pl[j][r] = 0u;""")],
    # each row half's maximum in four chains of 16 instead of two of 32
    "max_tree": [("""      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
""", """      float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx4[(i >> 1) & 3] = fmaxf(mx4[(i >> 1) & 3], s[i]);
      const float mx[2] = {fmaxf(mx4[0], mx4[2]), fmaxf(mx4[1], mx4[3])};
""")],
    # the row sum takes p0 + p1 as one add: a chain half as long
    "den_pairs": [("""          den[r & 1] += p0;
          den[r & 1] += p1;
""", """          den[r & 1] += p0 + p1;
""")],
    # p's hi on the FMA pipe (Veltkamp's split by 2^16 + 1: hi rounded to
    # nearest at 8 significant bits, packed by a byte permute) and only lo
    # converted: one conversion a pair instead of two
    "hi_fma": [("          split_bf16(p0, p1, ph[j][r], pl[j][r]);", """\
          {
            const float c0 = __fmul_rn(p0, 65537.f);
            const float c1 = __fmul_rn(p1, 65537.f);
            const float h0 = __fsub_rn(c0, __fsub_rn(c0, p0));
            const float h1 = __fsub_rn(c1, __fsub_rn(c1, p1));
            ph[j][r] = __byte_perm(__float_as_uint(h0), __float_as_uint(h1),
                                   0x7632);
            pl[j][r] = pack_bf16(__fsub_rn(p0, h0), __fsub_rn(p1, h1));
          }""")],
    # lo truncated to bfloat16 by a byte permute instead of rounded: no
    # conversion for lo (p then carries 16 bits, not 17)
    "lo_trunc": [("          split_bf16(p0, p1, ph[j][r], pl[j][r]);", """\
          {
            const __nv_bfloat162 hh = __floats2bfloat162_rn(p0, p1);
            ph[j][r] = *reinterpret_cast<const uint32_t*>(&hh);
            pl[j][r] = __byte_perm(
                __float_as_uint(__fsub_rn(p0, __low2float(hh))),
                __float_as_uint(__fsub_rn(p1, __high2float(hh))), 0x7632);
          }""")],
    "ring2": [("constexpr int RING_W = 4;", "constexpr int RING_W = 2;")],
    "ring3": [("constexpr int RING_W = 4;", "constexpr int RING_W = 3;")],
    # timing only: p taken as the exponent itself (no ex2), so the
    # outputs are wrong; what the exponentials cost
    "no_exp": [("          const float p0 = ex2(fmaf(s[i], scale_log2, "
                "neg_m[r & 1]));\n          const float p1 = ex2(fmaf(s[i + 1],"
                " scale_log2, neg_m[r & 1]));\n",
                "          const float p0 = fmaf(s[i], scale_log2, "
                "neg_m[r & 1]);\n          const float p1 = fmaf(s[i + 1], "
                "scale_log2, neg_m[r & 1]);\n")],
}
# variants of the bfloat16 face's wgmma kernel (the float32 face as in
# the source)
MATMUL_BF16_VARIANTS = {
    "wgmma_accumulator": [
        ("""      wgmma_fence();
      wgmma_fence_operands(part);
""", """      wgmma_fence();
      wgmma_fence_operands(acc);
"""),
        ("""        wgmma_bf16<BN>(part, desc_sw128(""",
         """        wgmma_bf16<BN>(acc, desc_sw128("""),
        ("""                       kk > 0);
""", """                       kt > 0 || kk > 0);
"""),
        ("""      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
""", """      wgmma_fence_operands(acc);
      mbar_arrive(&empty[s]);
""")],
    "ring3": [("constexpr int RING_BF16 = 4;", "constexpr int RING_BF16 = 3;")],
    "ring5": [("constexpr int RING_BF16 = 4;", "constexpr int RING_BF16 = 5;")],
}
MATMUL_VARIANTS = {
    **MATMUL_BF16_VARIANTS,
    "mma_accumulator": [
        ("""    float c[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mi][ni][i] = 0.f;
""", "    float (&c)[MI][NI][4] = acc;\n"),
        ("""#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) add4(acc[mi][ni], c[mi][ni]);
""", ""),
    ],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
}
W_SPLIT_AT_LOAD = [("    const bool once =\n",
                    "    const bool once = false &&\n")]
GRU_VARIANTS = {
    "dj4": [("constexpr int DJ = 8; ", "constexpr int DJ = 4; ")],
    "w_split_at_load": W_SPLIT_AT_LOAD,
}
LSTM_VARIANTS = {
    "w_split_at_load": W_SPLIT_AT_LOAD,
    # the bfloat16 face storing its rounded h after the barrier's arrive
    # (with c) instead of before it, beside the exchange
    "hs_after_arrive": [
        ('''          put(hs + (size_t)t * ND + at[g][i], h[g][i]);
          if constexpr (EXCHANGE)              // what the others stage
            hx[(size_t)(t & 1) * ND + at[g][i]] = h[g][i];
''', '''          if constexpr (EXCHANGE)
            hx[(size_t)(t & 1) * ND + at[g][i]] = h[g][i];
          else
            put(hs + (size_t)t * ND + at[g][i], h[g][i]);
'''),
        ('''          if (at[g][i] >= 0) put(cs + (size_t)t * ND + at[g][i], c[g][i]);
''', '''          if (at[g][i] >= 0) {
            put(cs + (size_t)t * ND + at[g][i], c[g][i]);
            if constexpr (EXCHANGE)
              put(hs + (size_t)t * ND + at[g][i], h[g][i]);
          }
''')],
    # the bfloat16 face widening the next step's gate inputs as it loads
    # them (its first form), instead of where the gate math uses them
    "widen_at_load": [
        ('''struct Bits<__nv_bfloat16> {
  typedef unsigned short type;''', '''struct Bits<__nv_bfloat16> {
  typedef float type;'''),
        ("  return __ldg(reinterpret_cast<const unsigned short*>(p));",
         "  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));")],
    # the bfloat16 face exchanging h through T + 1 slots, a fresh one a
    # step (h0 in slot 0, h_t in slot t + 1), as the float32 face stages
    # the fresh hs[t - 1], instead of a ring of two
    "exchange_per_step": [
        ("if (at[g][i] >= 0) hx[ND + at[g][i]] = h[g][i];",
         "if (at[g][i] >= 0) hx[at[g][i]] = h[g][i];"),
        ("hprev = hx + (size_t)((t + 1) & 1) * ND;",
         "hprev = hx + (size_t)t * ND;"),
        ("hx[(size_t)(t & 1) * ND + at[g][i]] = h[g][i];",
         "hx[(size_t)(t + 1) * ND + at[g][i]] = h[g][i];")],
    "two_passes": [
        ("constexpr int ROWS = 32; ", "constexpr int ROWS = 64; "),
        ("""        float acc[MT][NF][4];
        products(acc, hb, ldh, ws[g], KT, 0, k0, k1, nr, lane);
        __syncthreads();
        put_partials<RP>(red, acc, warp, lane);
""", """        float acc[MT][NF / 2][4], acc2[MT][NF / 2][4];
        products(acc, hb, ldh, ws[g], KT, 0, k0, k1, nr, lane);
        products(acc2, hb, ldh, ws[g], KT, NF / 2, k0, k1, nr, lane);
        __syncthreads();
        put_partials<RP>(red, acc, warp, lane);
        put_partials<RP>(red + 8 * (NF / 2), acc2, warp, lane);
""")],
}

PICK = "  const int tiling = pick_tiling(M, O);\n"
# the im2col walk alone: a kernel that lands one box of the bfloat16
# face's pixel loads (load_pixels from walk_start, as the wgmma kernel
# issues them) and writes it out unswizzled, [tiles * BM][64]
CONV_WALK_KERNEL = """template <int BM>
__global__ void __launch_bounds__(128)
conv3x3_im2col_walk_kernel(const __grid_constant__ CUtensorMap xmap,
                           bf16* __restrict__ out, int H, int W, int tap,
                           int c0) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  bf16* xs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const long long m0 = (long long)blockIdx.x * BM;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, BM * CK * 2);
    load_pixels(xs, &xmap, &bar, walk_start(m0, H, W), tap, c0);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < BM * CK; i += 128) {
    const int r = i / CK, k = i % CK;
    out[(m0 + r) * CK + k] = xs[r * CK + (((k / 8) ^ (r % 8)) * 8) + k % 8];
  }
}

}  // namespace

extern "C" {
"""
CONV_WALK_ENTRY = """int conv3x3_im2col_walk(const void* x, void* out, int N, int H, int W,
                        int C, int bm, int tap, int c0, void* stream) {
  CUtensorMap xmap;
  const long long M = (long long)N * H * W;
  const int e = encode_im2col_3x3(&xmap, x, N, H, W, C, CK, bm);
  if (e) return e;
  const int smem = bm * CK * 2 + 1024;
  auto kernel = bm == 64 ? conv3x3_im2col_walk_kernel<64>
                         : conv3x3_im2col_walk_kernel<128>;
  cudaError_t r = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (r != cudaSuccess) return (int)r;
  kernel<<<(unsigned)((M + bm - 1) / bm), 128, smem,
           static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<bf16*>(out), H, W, tap, c0);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {"""
# variants of the bfloat16 face's wgmma kernel (the float32 face and the
# ragged path as in the source), and the walk
# the filter's boxes shared by a cluster of two M tiles: each block loads
# half of each stage's filter rows and multicasts them to both
CONV_CLUSTER_HELPERS = """__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\\n"
      "barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar,
                                                 uint32_t cta) {
  asm volatile(
      "{\\n.reg .b32 ra;\\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\\n}\\n" ::"r"(
          smem_u32(bar)), "r"(cta)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d_mc(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The pixel the im2col walk of an output tile starts from"""
CONV_CLUSTER2 = [
    ("// The pixel the im2col walk of an output tile starts from",
     CONV_CLUSTER_HELPERS),
    ("""__global__ void __launch_bounds__(TileW<BM, BN>::THREADS,
                                  TileW<BM, BN>::BLOCKS_PER_SM)
conv3x3_bf16_wgmma_kernel(""", """__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(TileW<BM, BN>::THREADS, TileW<BM, BN>::BLOCKS_PER_SM)
conv3x3_bf16_wgmma_kernel("""),
    ("      mbar_init(&empty[s], 128 * T::CONSUMERS);",
     "      mbar_init(&empty[s], 2 * 4 * T::CONSUMERS);"),
    ("""  __syncthreads();

  if (wg == 0) {""", """  cluster_sync_all();
  const uint32_t rank = cluster_rank();

  if (wg == 0) {"""),
    ("""#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(ws + s * T::WS + j * 64 * CK, &wmap, &full[s],
                      o0 + 64 * j, c0, tap);""", """#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d_mc(ws + s * T::WS + j * 64 * CK + rank * 32 * 64,
                         &wmap, &full[s], o0 + 64 * j, c0 + 32 * rank, tap,
                         (uint16_t)3);"""),
    ("""      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];""", """      wgmma_fence_operands(part);
      __syncwarp();
      if (threadIdx.x % 32 == 0) {
        mbar_arrive(&empty[s]);
        // the peer's producer waits for this stage only to refill it
        if (kt < nk - RING_W) mbar_arrive_peer(&empty[s], rank ^ 1);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];"""),
    ("  return e ? e : encode_tma_3d(wmap, w, O, C, 9, 64, CK);",
     "  return e ? e : encode_tma_3d(wmap, w, O, C, 9, 64, CK / 2);"),
    ("""  dim3 grid((unsigned)mblocks, (unsigned)oblocks);
  kernel<<<grid, T::THREADS""", """  dim3 grid((unsigned)((mblocks + 1) / 2 * 2), (unsigned)oblocks);
  kernel<<<grid, T::THREADS"""),
]
# stage k's products issued before stage k - 1's sum is added (one wgmma
# group kept in flight, two stage sums in registers), the same order of
# float32 adds
CONV_PIPELINED = [("""    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % RING_W;
      mbar_wait(&full[s], (kt / RING_W) & 1);
      const uint32_t a = smem_u32(xs + s * T::XS + rows * CK);
      const uint32_t b = smem_u32(ws + s * T::WS);
      // the stage's sum, from zero on the tensor cores
      wgmma_fence();
      wgmma_fence_operands(part);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)
        wgmma_bf16<BN>(part, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(b + 2048 * kk, 64 * CK * 2, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
""", """    float acc[BN / 2], p0[BN / 2], p1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = p0[i] = p1[i] = 0.f;
    auto issue = [&](float (&d)[BN / 2], int kt) {
      const int s = kt % RING_W;
      mbar_wait(&full[s], (kt / RING_W) & 1);
      const uint32_t a = smem_u32(xs + s * T::XS + rows * CK);
      const uint32_t b = smem_u32(ws + s * T::WS);
      wgmma_fence();
      wgmma_fence_operands(d);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)
        wgmma_bf16<BN>(d, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(b + 2048 * kk, 64 * CK * 2, 1024), kk > 0);
      wgmma_commit();
    };
    auto retire = [&](float (&d)[BN / 2], int kt) {
      wgmma_fence_operands(d);
      mbar_arrive(&empty[kt % RING_W]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
    };
    for (int kt = 0; kt < nk; kt += 2) {
      issue(p0, kt);
      if (kt > 0) {
        wgmma_wait<1>();
        retire(p1, kt - 1);
      }
      if (kt + 1 < nk) {
        issue(p1, kt + 1);
        wgmma_wait<1>();
        retire(p0, kt);
      } else {
        wgmma_wait<0>();
        retire(p0, kt);
      }
    }
    if (nk % 2 == 0) {
      wgmma_wait<0>();
      retire(p1, nk - 1);
    }
""")]
CONV_BF16_VARIANTS = {
    "pipelined": CONV_PIPELINED,
    "cluster2": CONV_CLUSTER2,
    "two_blocks": [("""  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;""", """  static constexpr int BLOCKS_PER_SM = BN == 64 ? 2 : 1;
  static constexpr int PRODUCER_REGS = BLOCKS_PER_SM == 2 ? 24 : 40;
  static constexpr int CONSUMER_REGS =
      BLOCKS_PER_SM == 2
          ? ((65536 / (2 * THREADS) / 8 * 8) * THREADS - 24 * 128) /
                (THREADS - 128) / 8 * 8
          : 232;""")],
    "ring3": [("constexpr int RING_W = 4;", "constexpr int RING_W = 3;")],
    "ring6": [("constexpr int RING_W = 4;", "constexpr int RING_W = 6;")],
    "split32": [("""      wgmma_fence();
      wgmma_fence_operands(part);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)
        wgmma_bf16<BN>(part, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(b + 2048 * kk, 64 * CK * 2, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
""", """#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
        wgmma_fence_operands(part);
#pragma unroll
        for (int kk = 2 * h; kk < 2 * h + 2; ++kk)
          wgmma_bf16<BN>(part, desc_sw128(a + 32 * kk, 16, 1024),
                         desc_sw128(b + 2048 * kk, 64 * CK * 2, 1024),
                         kk > 2 * h);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operands(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
      mbar_arrive(&empty[s]);
""")],
    "walk": [("}  // namespace\n\nextern \"C\" {\n", CONV_WALK_KERNEL),
             ("const char* error_string(int code) {", CONV_WALK_ENTRY)],
}
CONV_VARIANTS = {
    **CONV_BF16_VARIANTS,
    "t128x128": [(PICK, "  const int tiling = 0;\n")],
    "t128x64": [(PICK, "  const int tiling = 1;\n")],
    "t64x64": [(PICK, "  const int tiling = 2;\n")],
    "stages2": MATMUL_VARIANTS["stages2"],
    "tf32_once": COMMON["tf32_once"],
}


def variant_sources(name, variants, common=True):
    """{variant: {file name: text}}: the source ``csrc/<name>.cu`` and the
    shared headers, as committed and as each variant edits them (with the
    COMMON variants unless ``common`` is false). Every edited text must
    occur exactly once across the files."""
    files = [name + ".cu"] + _build.headers()
    src = {}
    for f in files:
        with open(os.path.join(_build.CSRC_DIR, f)) as fh:
            src[f] = fh.read()
    out = {"source": src}
    for vname, edits in dict(COMMON if common else {}, **variants).items():
        texts = dict(src)
        for old, new in edits:
            hits = [f for f in files if old in texts[f]]
            if len(hits) != 1 or texts[hits[0]].count(old) != 1:
                sys.exit("torch_flash_bwd_study: the sources of %s no longer "
                         "have the text variant %s replaces once: %r"
                         % (name, vname, old))
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        out[vname] = texts
    return out


def against_sources(root, name):
    """{file name: text}: ``csrc/<name>.cu`` and the shared headers of the
    checkout at ``root``."""
    csrc = os.path.join(root, os.path.relpath(_build.CSRC_DIR, ROOT))
    out = {}
    for f in os.listdir(csrc):
        if f == name + ".cu" or f.endswith(".cuh"):
            with open(os.path.join(csrc, f)) as fh:
                out[f] = fh.read()
    return out


def kernel_name(run):
    """The kernel's name at the end of ``run``, a mangled entry name up to
    ``_kernel``: the tail that the decimal length before it covers (so
    that digits in the name, as in conv3x3_kernel, are kept)."""
    for i in range(1, len(run)):
        digits = re.search(r"(\d+)$", run[:i])
        if digits and run[i].isalpha() and int(digits.group(1)) == \
                len(run) - i:
            return run[i:]
    return run


def ptxas_summary(log):
    """{kernel template: 'N registers[, spills]'} from nvcc -Xptxas -v."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(\w+?_kernel)I((?:L[ib]\d+E)+)E", ln)
        if "Compiling entry function" in ln and m:
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            cur = "%s<%s>" % (kernel_name(m.group(1)), ",".join(args))
        elif "Compiling entry function" in ln:
            m = re.search(r"(\w+?_kernel)(?:I(\w+?)EE)?", ln)
            cur = None if m is None else kernel_name(m.group(1)) + (
                "<%s>" % m.group(2) if m.group(2) else "")
        elif cur and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[cur] = regs + " registers" + out.get(cur, "")
        elif cur and "spill" in ln and "0 bytes spill stores" not in ln:
            out[cur] = out.get(cur, "") + ", " + ln.strip()
        elif "Performance Loss" in ln or "setmaxnreg" in ln:
            out.setdefault("performance_loss", []).append(ln.strip())
    return out


def build(name, sources):
    """Build every variant of ``csrc/<name>.cu``, one nvcc each, all
    started together; returns ({variant: library}, {variant: ptxas})."""
    procs = {}
    for vname, texts in sources.items():
        vdir = os.path.join(OUT_DIR, name, vname)
        os.makedirs(vdir, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        so = os.path.join(vdir, name + ".so")
        procs[vname] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(vdir, name + ".cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for vname, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit("torch_flash_bwd_study: nvcc failed on %s %s:\n%s"
                     % (name, vname, log))
        lib = ctypes.CDLL(so)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[vname], ptxas[vname] = lib, ptxas_summary(log)
    return libs, ptxas


def time_ms(fn, flush, iters=20, warmup=3, by_read=False):
    """Median ms of ``fn``, the L2 flushed before each launch by writing
    ``flush`` (or, ``by_read``, by reading it: no dirty line is left)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if by_read:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, flush, iters=20):
    """Mean device ms of the kernels ``fn`` launches (torch.profiler; the
    flush's fill kernel left out), the L2 flushed before each call: the
    kernels alone, without the host's time to reach them, which CUDA
    events around a short launch also read."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                "Fill" in e.key:
            continue
        t = getattr(e, "self_device_time_total", None)
        total += (e.self_cuda_time_total if t is None else t) / 1e3
    return total / iters


class using:
    """Within the block, ``_build.load(name)`` returns ``lib``."""

    def __init__(self, name, lib):
        self.name, self.lib, self.load = name, lib, _build.load

    def __enter__(self):
        _build.load = (lambda n: self.lib if n == self.name
                       else self.load(n))

    def __exit__(self, *exc):
        _build.load = self.load


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(dev)


# (B, S, H, D, causal) at which every variant's float32 outputs are held
# to the source's bit for bit: the LM step's shape and the other head
# dims' templates (chip_smoke's phase 2 cases)
FLASH_SAME_CASES = ((8, 1024, 12, 64, True), (2, 130, 12, 32, False),
                    (2, 130, 12, 128, True))


def _bit_identity(libs, lib_name, run, dev):
    """{variant: whether ``run(q, k, v, do, causal)`` under the variant's
    library gives the source's outputs bit for bit at every case of
    FLASH_SAME_CASES (float32 operands)}."""
    rng = np.random.RandomState(1)
    same = {name: True for name in libs if name != "source"}
    for B, S, H, D, causal in FLASH_SAME_CASES:
        args = [_randn(rng, (B, S, H, D), dev) for _ in range(4)]
        with using(lib_name, libs["source"]):
            want = run(*args, causal)
        for name in same:
            with using(lib_name, libs[name]):
                got = run(*args, causal)
            same[name] = same[name] and all(
                torch.equal(g, w) for g, w in zip(got, want))
        del args, want
    torch.cuda.synchronize()
    return same


def _bf16_inputs(rng, shape, n, dev):
    return [_randn(rng, shape, dev).bfloat16() for _ in range(n)]


def study_bwd(libs, result, dev, flush):
    rng = np.random.RandomState(0)
    for B, S, H, D in ((8, 1024, 12, 64), (2, 2048, 4, 64)):
        q, k, v, do = [_randn(rng, (B, S, H, D), dev) for _ in range(4)]
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        want = fa.flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, o, lse, do)), causal=True)
        delta = fa._delta(o, do, None).contiguous()
        for name, lib in libs.items():
            with using("flash_attention_bwd", lib):
                got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True)
                torch.cuda.synchronize()
                rec = {n: float((g.double() - w).abs().max()
                                / w.abs().max())
                       for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                if S == 1024:
                    args = (q, k, v, do, lse, delta, True, D ** -0.5)
                    rec["dkv_ms"] = time_ms(lambda: fa._bwd_dkv(*args),
                                            flush)
                    rec["dq_ms"] = time_ms(lambda: fa._bwd_dq(*args), flush)
            result[name]["S%d" % S] = rec
            print(json.dumps({name: {"S%d" % S: rec}}), flush=True)
        del q, k, v, do, o, lse, want, delta
        torch.cuda.empty_cache()
    # the bfloat16 faces at the LM step's shape (a library without them
    # is skipped): errors against the float64 backward on the same
    # bfloat16 values, over each gradient's largest magnitude, and the
    # gate of chip_smoke's phase 9 against the float32 plain backward
    # (at most 1 passes); each kernel's time by CUDA events and by device
    # time; beside the source, its mma.sync kernels forced at D 64 (the
    # faces' design before their wgmma kernels) and SDPA's backward on
    # bfloat16 (dq, dk and dv, one library call for both kernels)
    F = torch.nn.functional
    B, S, H, D = 8, 1024, 12, 64
    q, k, v, do = _bf16_inputs(rng, (B, S, H, D), 4, dev)
    o, lse = fa.flash_attention_reference(q, k, v, causal=True)
    want = fa.flash_attention_bwd_reference(
        *(t.double() for t in (q, k, v, o, lse, do)), causal=True)
    plain = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True)
    delta = fa._delta(o, do, None).contiguous()
    args = (q, k, v, do, lse, delta, True, D ** -0.5)
    source_got = None
    for name, lib in libs.items():
        if not hasattr(lib, "flash_attention_bwd_dq_bf16"):
            continue
        with using("flash_attention_bwd", lib):
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
            rec = {n: float((g.double() - w).abs().max() / w.abs().max())
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            rec["gate"] = max(_bf16_gate(g, w) for g, w in zip(got, plain))
            # the bfloat16 faces' outputs against the source's, given the
            # same o and lse (with --against: a change left them as they
            # were)
            if name == "source":
                source_got = got
            elif source_got is not None:
                rec["bit_identical_to_source"] = all(
                    torch.equal(g, s) for g, s in zip(got, source_got))
            for kname, fn in (("dkv", fa._bwd_dkv), ("dq", fa._bwd_dq)):
                rec[kname + "_ms"] = time_ms(lambda: fn(*args), flush)
                rec[kname + "_device_ms"] = device_ms(lambda: fn(*args),
                                                      flush)
                if name == "source" and hasattr(
                        lib, "flash_attention_bwd_dq_bf16_mma"):
                    rec[kname + "_mma_forced_ms"] = time_ms(
                        lambda: fn(*args, mma=True), flush)
                    rec[kname + "_mma_forced_device_ms"] = device_ms(
                        lambda: fn(*args, mma=True), flush)
        if name == "source":
            qh, kh, vh = (t.transpose(1, 2).detach().clone()
                          .requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            doh = do.transpose(1, 2)

            def sdpa_bwd():
                return torch.autograd.grad(out, (qh, kh, vh), doh,
                                           retain_graph=True)
            rec["sdpa_bwd_ms"] = time_ms(sdpa_bwd, flush)
            rec["sdpa_bwd_device_ms"] = device_ms(sdpa_bwd, flush)
            del qh, kh, vh, out, doh
        result[name]["bf16_S1024"] = rec
        print(json.dumps({name: {"bf16_S1024": rec}}), flush=True)
    del q, k, v, do, o, lse, want, plain, delta, args, source_got
    torch.cuda.empty_cache()
    # the gate on a long walk (S 2048, B 2, H 4): what decides whether a
    # sum may stay in the wgmma accumulator (variant straight)
    q, k, v, do = _bf16_inputs(rng, (2, 2048, 4, 64), 4, dev)
    o, lse = fa.flash_attention_reference(q, k, v, causal=True)
    plain = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True)
    for name, lib in libs.items():
        if not hasattr(lib, "flash_attention_bwd_dq_bf16"):
            continue
        with using("flash_attention_bwd", lib):
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
        rec = {n: _bf16_gate(g, w)
               for n, g, w in zip(("dq", "dk", "dv"), got, plain)}
        result[name]["bf16_gate_S2048"] = rec
        print(json.dumps({name: {"bf16_gate_S2048": rec}}), flush=True)
    del q, k, v, do, o, lse, plain
    torch.cuda.empty_cache()

    _bwd_timeline(libs, result, dev)

    def bwd(q, k, v, do, causal):
        o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

    for name, same in _bit_identity(libs, "flash_attention_bwd", bwd,
                                    dev).items():
        result[name]["bit_identical_to_source"] = same
        print(json.dumps({name: {"bit_identical_to_source": same}}),
              flush=True)


def _bf16_gate(got, want):
    """Phase 9's gate of a bfloat16 output against its plain version: the
    larger of its largest error over one ulp of the largest magnitude and
    the largest error of an element over one ulp of its own magnitude
    plus 2e-5 of the largest (at most 1 passes)."""
    err = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0
    return max(err / ulp if ulp else float(err > 0) * float("inf"),
               _own_ulp_ratio(got, want))


def _bwd_timeline(libs, result, dev):
    """Where a tile's cycles go in the bfloat16 backward's wgmma kernels
    (variant ``timeline``): at the LM step's shape (B 8, S 1024, H 12, D
    64, causal), each consumer warpgroup's cycles a tile it takes waiting
    for a stage, for its turn, from issuing the turn's group of products
    to holding it, and forming p and ds; its whole walk a tile, over all
    blocks of each kernel."""
    lib = libs.get("timeline")
    if lib is None:
        return
    rng = np.random.RandomState(5)
    fn = lib.flash_bwd_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    names = ("stage_wait", "turn_wait", "group_issue_to_ready", "p_ds")
    B = 8
    q, k, v, do = _bf16_inputs(rng, (B, 1024, 12, 64), 4, dev)
    o, lse = fa.flash_attention_reference(q, k, v, causal=True)
    with using("flash_attention_bwd", lib):
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        for which, kname in enumerate(("dkv", "dq")):
            buf = np.zeros((4096, 2, 8), np.uint64)
            _build.check(lib, fn(buf.ctypes.data, buf.nbytes, which),
                         "timeline")
            used = buf[:B * 12 * 8].astype(np.float64)
            tiles = used[:, :, 6].sum()
            rec = {n: float(used[:, :, i].sum() / tiles)
                   for i, n in enumerate(names)}
            rec["walk_per_tile"] = float(used[:, :, 5].sum() / tiles)
            rec["tiles"] = int(tiles)
            result["timeline"]["%s_cycles_per_tile_B%d" % (kname, B)] = rec
            print(json.dumps({"timeline": {
                "%s_cycles_per_tile_B%d" % (kname, B): rec}}), flush=True)
    del q, k, v, do, o, lse


def study_fwd(libs, result, dev, flush):
    rng = np.random.RandomState(0)
    for B, S, H, D, timed in ((1, 1024, 12, 64, True),
                              (8, 1024, 12, 64, True),
                              (1, 4096, 4, 64, False)):
        q, k, v = [_randn(rng, (B, S, H, D), dev) for _ in range(3)]
        o_want, lse_want = fa.flash_attention_reference(
            *(t.double() for t in (q, k, v)), causal=True)
        tag = "B%d_S%d" % (B, S)
        for name, lib in libs.items():
            with using("flash_attention_fwd", lib):
                o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
                torch.cuda.synchronize()
                rec = {"o": float((o.double() - o_want).abs().max()
                                  / o_want.abs().max()),
                       "lse": float((lse.double() - lse_want).abs().max())}
                if timed:
                    rec["ms"] = time_ms(lambda: fa.flash_attention_with_lse(
                        q, k, v, causal=True), flush)
            result[name][tag] = rec
            print(json.dumps({name: {tag: rec}}), flush=True)
        del q, k, v, o_want, lse_want
        torch.cuda.empty_cache()
    # the bfloat16 face at the LM step's shape and the prefill's, against
    # the float64 forward on the same bfloat16 values (a parent's library
    # without it is skipped; a parent's face at D 64 is the mma.sync
    # kernel); the source's mma.sync kernel forced at D 64 and SDPA on
    # bfloat16 beside them
    F = torch.nn.functional
    for B in (8, 1):
        tag = "bf16_B%d_S1024" % B
        q, k, v = _bf16_inputs(rng, (B, 1024, 12, 64), 3, dev)
        o_want, lse_want = fa.flash_attention_reference(
            *(t.double() for t in (q, k, v)), causal=True)
        source_out = None
        for name, lib in libs.items():
            if not hasattr(lib, "flash_attention_fwd_bf16"):
                continue
            with using("flash_attention_fwd", lib):
                o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
                torch.cuda.synchronize()
                rec = {"o": float((o.double() - o_want).abs().max()
                                  / o_want.abs().max()),
                       "lse": float((lse.double() - lse_want).abs().max()),
                       # (with --against: a change left the face as it
                       # was)
                       "bit_identical_to_source": None if source_out is None
                       else bool(torch.equal(o, source_out[0])
                                 and torch.equal(lse, source_out[1])),
                       "ms": time_ms(lambda: fa.flash_attention_with_lse(
                           q, k, v, causal=True), flush),
                       "device_ms": device_ms(
                           lambda: fa.flash_attention_with_lse(
                               q, k, v, causal=True), flush)}
                if name == "source":
                    source_out = (o, lse)

                    def mma():
                        return fa._launch_fwd(q, k, v, True, 64 ** -0.5,
                                              mma=True)
                    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

                    def sdpa():
                        return F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True)
                    rec["mma_forced_ms"] = time_ms(mma, flush)
                    rec["mma_forced_device_ms"] = device_ms(mma, flush)
                    rec["sdpa_ms"] = time_ms(sdpa, flush)
                    rec["sdpa_device_ms"] = device_ms(sdpa, flush)
            result[name][tag] = rec
            print(json.dumps({name: {tag: rec}}), flush=True)
        del q, k, v, o_want, lse_want
        torch.cuda.empty_cache()

    _fwd_timeline(libs, result, dev)

    def fwd(q, k, v, do, causal):
        return fa.flash_attention_with_lse(q, k, v, causal=causal)

    for name, same in _bit_identity(libs, "flash_attention_fwd", fwd,
                                    dev).items():
        result[name]["bit_identical_to_source"] = same
        print(json.dumps({name: {"bit_identical_to_source": same}}),
              flush=True)


def _fwd_timeline(libs, result, dev):
    """Where a tile's cycles go in the bfloat16 face's wgmma kernel
    (variant ``timeline``): at B 8 and B 1 (S 1024, H 12, D 64, causal),
    each consumer warpgroup's cycles a tile waiting for a stage, for its
    turn, on p v, from q k^T's issue to s, on the softmax, and its whole
    walk a tile, over all blocks; and the walk's cycles of the blocks of
    the longest walk."""
    lib = libs.get("timeline")
    if lib is None:
        return
    rng = np.random.RandomState(5)
    fn = lib.flash_fwd_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    names = ("stage_wait", "turn_wait", "pv", "qk_to_s", "softmax")
    for B in (8, 1):
        q, k, v = _bf16_inputs(rng, (B, 1024, 12, 64), 3, dev)
        with using("flash_attention_fwd", lib):
            fa.flash_attention_with_lse(q, k, v, causal=True)
            torch.cuda.synchronize()
            buf = np.zeros((4096, 2, 8), np.uint64)
            _build.check(lib, fn(buf.ctypes.data, buf.nbytes), "timeline")
        used = buf[:B * 12 * 8].astype(np.float64)
        tiles = used[:, :, 6].sum()
        rec = {n: float(used[:, :, i].sum() / tiles)
               for i, n in enumerate(names)}
        rec["walk_per_tile"] = float(used[:, :, 5].sum() / tiles)
        longest = used[used[:, 0, 6] == used[:, 0, 6].max()]
        rec["longest_walk_tiles"] = int(longest[0, 0, 6])
        rec["longest_walk_cycles_mean"] = float(longest[:, :, 5].mean())
        rec["sm_clock_mhz"] = torch.cuda.get_device_properties(
            dev).clock_rate / 1e3 if hasattr(
            torch.cuda.get_device_properties(dev), "clock_rate") else None
        result["timeline"]["cycles_per_tile_B%d" % B] = rec
        print(json.dumps({"timeline": {"cycles_per_tile_B%d" % B: rec}}),
              flush=True)
        del q, k, v


def _parent_bf16(lib, x, w, t):
    """A launch of a parent's bfloat16 face (before its wgmma kernel: no
    ragged flag, the float32 face's tilings), bfloat16 out."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    fn = lib.matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N,
                         K, *t, 0, _build.stream_handle(x.device)), "matmul")
    return out


def study_matmul_bf16(libs, result, dev, flush):
    """The bfloat16 face at the LM step's gemm shapes: the source's, each
    bf16 variant's and (with --against) a parent's, every tiling timed,
    errors against a float64 product, torch.matmul on bfloat16 beside
    them, and the mean over a step's 72 launches at each library's
    fastest tiling a shape."""
    rng = np.random.RandomState(2)
    names = [n for n in libs
             if n in ("source", "against") or n in MATMUL_BF16_VARIANTS]
    means = {n: 0.0 for n in names + ["torch.matmul"]}
    means_read = dict(means)
    for (M, K, N), count in zip(MM_SHAPES, MM_COUNTS):
        x = _randn(rng, (M, K), dev).bfloat16()
        w = _randn(rng, (K, N), dev, 0.1).bfloat16()
        want = torch.matmul(x.double(), w.double())
        tag = "%dx%dx%d" % (M, K, N)
        lib_ms = time_ms(lambda: torch.matmul(x, w), flush)
        means["torch.matmul"] += count * lib_ms / sum(MM_COUNTS)
        source_out = {}
        for name in names:
            lib = libs[name]
            parent = not hasattr(lib, "matmul_bf16_encode_us")
            rec = {"max_rel_err": 0.0, "ms": {}}
            same = True
            with using("matmul", lib):
                for t in (mm.TILINGS if parent else mm.TILINGS_BF16):
                    def call():
                        return (_parent_bf16(lib, x, w, t) if parent
                                else mm._launch(x, w, t)[0])
                    got = call()
                    torch.cuda.synchronize()
                    rec["max_rel_err"] = max(rec["max_rel_err"], float(
                        (got.double() - want).abs().max()
                        / want.abs().max()))
                    # the wgmma face's outputs at every tiling against the
                    # source's (with --against: a change left it as it was)
                    if name == "source":
                        source_out[t] = got
                    elif not parent:
                        same = same and torch.equal(got, source_out[t])
                    rec["ms"]["%dx%dx%d" % t] = time_ms(call, flush)
                best = min(rec["ms"], key=rec["ms"].get)
                t = tuple(int(v) for v in best.split("x"))  # call reads t
                # the L2 flushed by a read: no dirty line of the flush is
                # written back during the launch
                rec["best_ms_read_flush"] = time_ms(call, flush,
                                                    by_read=True)
            if name != "source" and not parent:
                rec["bit_identical_to_source"] = same
            rec["best"] = {best: rec["ms"][best]}
            rec["torch_matmul_ms"] = lib_ms
            rec["torch_matmul_ms_read_flush"] = time_ms(
                lambda: torch.matmul(x, w), flush, by_read=True)
            means[name] += count * rec["ms"][best] / sum(MM_COUNTS)
            means_read[name] += count * rec["best_ms_read_flush"] / \
                sum(MM_COUNTS)
            if name == "source":
                means_read["torch.matmul"] += count * \
                    rec["torch_matmul_ms_read_flush"] / sum(MM_COUNTS)
            result[name]["bf16 " + tag] = rec
            print(json.dumps({name: {"bf16 " + tag: {
                k: rec.get(k) for k in ("max_rel_err", "best",
                                        "best_ms_read_flush",
                                        "torch_matmul_ms",
                                        "torch_matmul_ms_read_flush",
                                        "bit_identical_to_source")}}}),
                  flush=True)
        del x, w, want, source_out
        torch.cuda.empty_cache()
    for name, ms in means.items():
        if name in result:
            result[name]["bf16 step mean ms"] = ms
            result[name]["bf16 step mean ms, read flush"] = means_read[name]
    result["source"]["bf16 step mean ms, torch.matmul"] = \
        means["torch.matmul"]
    result["source"]["bf16 step mean ms, read flush, torch.matmul"] = \
        means_read["torch.matmul"]
    print(json.dumps({"bf16 step mean ms": means,
                      "bf16 step mean ms, read flush": means_read}),
          flush=True)
    _bf16_k_sweep(libs, result, dev, flush)


# K of the sweep at M 8192, N 768 (each a multiple of the 64-deep stage)
K_SWEEP = (64, 128, 256, 512, 768, 1536, 3072)


def _bf16_k_sweep(libs, result, dev, flush):
    """Where a launch's time goes: the source's default tiling and a
    parent's 128 x 128 x 32 at M 8192, N 768 over K_SWEEP, and a least
    squares line of ms against the 64-deep stages a tile walks (K / 64):
    the intercept is what a launch costs whatever its depth (filling the
    ring, the epilogue, the waves' tails), the slope what a stage of
    every tile costs; with the L2 flushed by a write (the default, whose
    dirty lines are written back during the launch) and by a read."""
    rng = np.random.RandomState(3)
    M, N = 8192, 768
    for name in [n for n in ("source", "against") if n in libs]:
        lib = libs[name]
        parent = not hasattr(lib, "matmul_bf16_encode_us")
        t = (128, 128, 32) if parent else mm.normalize_config(
            None, torch.bfloat16)
        ms, ms_read = {}, {}
        with using("matmul", lib):
            for K in K_SWEEP:
                x = _randn(rng, (M, K), dev).bfloat16()
                w = _randn(rng, (K, N), dev, 0.1).bfloat16()

                def call():
                    return (_parent_bf16(lib, x, w, t) if parent
                            else mm._launch(x, w, t))
                ms[K] = time_ms(call, flush)
                ms_read[K] = time_ms(call, flush, by_read=True)
        rec = {"tiling": "%dx%dx%d" % t}
        for label, by_k in (("", ms), ("read_flush_", ms_read)):
            slope, intercept = np.polyfit([K / 64 for K in K_SWEEP],
                                          [by_k[K] for K in K_SWEEP], 1)
            rec.update({label + "ms_by_K": by_k,
                        label + "ms_per_stage": float(slope),
                        label + "ms_at_no_stage": float(intercept)})
        result[name]["bf16 K sweep, M 8192, N 768"] = rec
        print(json.dumps({name: {"bf16 K sweep": rec}}), flush=True)


def study_matmul(libs, result, dev, flush):
    rng = np.random.RandomState(0)
    for M, K, N in MM_SHAPES:
        x = _randn(rng, (M, K), dev)
        w = _randn(rng, (K, N), dev, 0.1)
        want = torch.matmul(x.double(), w.double())
        tag = "%dx%dx%d" % (M, K, N)
        source_out = {}
        for name, lib in libs.items():
            if name in MATMUL_BF16_VARIANTS:
                continue
            rec = {"max_rel_err": 0.0, "ms": {}}
            same = True
            with using("matmul", lib):
                for t in mm.TILINGS:
                    got = mm._launch(x, w, t)[0]
                    torch.cuda.synchronize()
                    rec["max_rel_err"] = max(rec["max_rel_err"], float(
                        (got.double() - want).abs().max()
                        / want.abs().max()))
                    if name == "source":
                        source_out[t] = got
                    else:
                        same = same and torch.equal(got, source_out[t])
                    rec["ms"]["%dx%dx%d" % t] = time_ms(
                        lambda: mm._launch(x, w, t), flush)
            best = min(rec["ms"], key=rec["ms"].get)
            rec["best"] = {best: rec["ms"][best]}
            if name != "source":
                rec["bit_identical_to_source"] = same
            result[name][tag] = rec
            print(json.dumps({name: {tag: {
                "max_rel_err": rec["max_rel_err"], "best": rec["best"],
                "bit_identical_to_source": rec.get(
                    "bit_identical_to_source")}}}), flush=True)
        del x, w, want, source_out
        torch.cuda.empty_cache()
    study_matmul_bf16(libs, result, dev, flush)


def rnn_study(mod, name, gates):
    """The study of a fused recurrence (``mod``, the library ``name``,
    ``gates`` slabs: 3 the GRU, 4 the LSTM, which also has c0 and cs)."""
    reference = getattr(mod, name + "_reference")

    def outputs(out):
        return out if isinstance(out, tuple) else (out,)

    def study(libs, result, dev, flush):
        T, N, D = 100, 64, 512

        def wide_ms(d):
            rng = np.random.RandomState(41)
            a = [_randn(rng, (T, N, gates * d), dev, 0.5),
                 _randn(rng, (d, gates * d), dev, 1 / np.sqrt(d)),
                 *(_randn(rng, (N, d), dev, 0.2) for _ in range(gates - 2)),
                 torch.ones((T, N), device=dev)]
            try:
                return time_ms(lambda: mod._launch(*a), flush)
            except RuntimeError as e:
                return str(e)
        for ragged in (True, False):
            rng = np.random.RandomState(40)
            xs = _randn(rng, (T, N, gates * D), dev, 0.5)
            w = _randn(rng, (D, gates * D), dev, 1 / np.sqrt(D))
            state = [_randn(rng, (N, D), dev, 0.2)
                     for _ in range(gates - 2)]
            lens = rng.randint(1, T + 1, N) if ragged else np.full(N, T)
            mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :])
                                    .astype(np.float32)).to(dev)
            args = [xs, w, *state, mask]
            want = outputs(reference(*(a.double() for a in args)))
            for vname, lib in libs.items():
                with using(name, lib):
                    got = outputs(mod._launch(*args))
                    torch.cuda.synchronize()
                    result[vname]["max_rel_err_" + ("ragged" if ragged
                                                    else "full")] = max(
                        float((g.double() - w_).abs().max()
                              / w_.abs().max()) for g, w_ in zip(got, want))
                    if ragged:
                        continue
                    ms = {}
                    for t_, n_ in ((T, N), (10, N), (T, 8)):
                        a = [x.contiguous() for x in (
                            xs[:t_, :n_], w, *(h[:n_] for h in state),
                            mask[:t_, :n_])]
                        ms["T%d_N%d" % (t_, n_)] = time_ms(
                            lambda: mod._launch(*a), flush)
                    ms["us_per_step"] = 1e3 * (ms["T100_N64"]
                                               - ms["T10_N64"]) / (T - 10)
                    for d in (1024, 1280):
                        ms["T%d_N%d_D%d" % (T, N, d)] = wide_ms(d)
                    result[vname]["ms"] = ms
                    result[vname]["launch"] = mod.launch_plan(N, D)
                print(json.dumps({vname: result[vname]}), flush=True)
        edges = []
        for i, (t_, n_, d_) in enumerate(RNN_EDGE_SHAPES):
            rng = np.random.RandomState(50 + i)
            a = [_randn(rng, (t_, n_, gates * d_), dev, 0.5),
                 _randn(rng, (d_, gates * d_), dev, 1 / np.sqrt(d_)),
                 *(_randn(rng, (n_, d_), dev, 0.2) for _ in range(gates - 2))]
            lens = rng.randint(1, t_ + 1, n_)
            a.append(torch.from_numpy((np.arange(t_)[:, None] < lens[None, :])
                                      .astype(np.float32)).to(dev))
            edges.append(a)
        want = {}
        for vname, lib in libs.items():
            same = {}
            with using(name, lib):
                for a in edges:
                    key = "x".join(str(n) for n in a[0].shape[:2]) + \
                        "x%d" % a[1].shape[0]
                    try:
                        got = outputs(mod._launch(*a))
                    except RuntimeError as e:
                        same[key] = str(e)
                        continue
                    if vname == "source":
                        want[key] = got
                    else:
                        same[key] = all(torch.equal(g, w_) for g, w_ in zip(
                            got, want[key]))
            if vname != "source":
                result[vname]["edges_bit_identical_to_source"] = same
                print(json.dumps({vname: {"edges_bit_identical_to_source":
                                          same}}), flush=True)
        if gates == 4:
            lstm_bf16_study(libs, result, dev, flush)
    return study


def _own_ulp_ratio(got, want, sum_tol=2e-5):
    """The largest error of a bfloat16 element over one bfloat16 ulp of
    its reference's own magnitude plus ``sum_tol`` of the largest."""
    g, w = got.double(), want.double()
    mag = w.abs()
    own = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7),
        torch.zeros_like(mag))
    return float(((g - w).abs() / (own + sum_tol * float(mag.max()))).max())


def lstm_bf16_study(libs, result, dev, flush):
    """The LSTM's bfloat16 face of each library that has one (a parent's
    without it is skipped) at T 100, N 64, D 512, full lengths: the
    largest error of hs and cs over one ulp of each element's own
    magnitude plus 2e-5 of the largest, against the plain recurrence on
    the same operands; the face's time and the cast-around yardstick's
    (xs, h0 and c0 widened, the float32 face, hs and cs rounded), timed
    in turns (face, yardstick, yardstick, face)."""
    T, N, D = 100, 64, 512
    bf = torch.bfloat16
    rng = np.random.RandomState(42)
    xs = _randn(rng, (T, N, 4 * D), dev, 0.5).to(bf)
    w = _randn(rng, (D, 4 * D), dev, 1 / np.sqrt(D))
    h0, c0 = (_randn(rng, (N, D), dev, 0.2).to(bf) for _ in range(2))
    mask = torch.ones((T, N), device=dev)
    args = (xs, w, h0, c0, mask)
    want = lstm.fused_lstm_reference(*args)
    # the exchange: T + 1 slots, which every variant's layout fits in
    hx = torch.empty((T + 1, N, D), dtype=torch.float32, device=dev)
    barrier = torch.empty((1,), dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)

    def face(a=args):
        fn = _build.load("fused_lstm").fused_lstm_bf16
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        t_ = a[0].shape[0]
        hs = torch.empty((t_, N, D), dtype=bf, device=dev)
        cs = torch.empty_like(hs)
        code = fn(*(t.data_ptr() for t in a + (hs, cs, hx, barrier)),
                  t_, N, D, stream)
        if code:
            raise RuntimeError("fused_lstm_bf16: CUDA error %d" % code)
        return hs, cs

    # ten steps: the cost of a step, from T 10 to 100
    args10 = tuple(t[:10].contiguous() if t.dim() == 3 or t is mask
                   else t for t in args)

    def cast_around():
        hs, cs = lstm._launch(xs.float(), w, h0.float(), c0.float(), mask)
        return hs.to(bf), cs.to(bf)

    for vname, lib in libs.items():
        if not hasattr(lib, "fused_lstm_bf16"):
            continue
        with using("fused_lstm", lib):
            got = face()
            torch.cuda.synchronize()
            runs = [time_ms(f, flush) for f in (face, cast_around,
                                                cast_around, face)]
            ms10 = time_ms(lambda: face(args10), flush)
        rec = {"max_err_over_own_tol": max(_own_ulp_ratio(g, w_) for g, w_
                                           in zip(got, want)),
               "ms": (runs[0] + runs[3]) / 2,
               "cast_around_ms": (runs[1] + runs[2]) / 2, "ms_runs": runs,
               "T10_ms": ms10}
        rec["us_per_step"] = 1e3 * (rec["ms"] - ms10) / (T - 10)
        result[vname]["bf16_face"] = rec
        print(json.dumps({vname: {"bf16_face": rec}}), flush=True)


def study_conv3x3(libs, result, dev, flush):
    f32_libs = {n: lib for n, lib in libs.items()
                if n not in CONV_BF16_VARIANTS}
    for i, shape in enumerate(R50_CONV_SHAPES):
        N, H, W, C, O = shape
        rng = np.random.RandomState(60 + i)
        x = _randn(rng, (N, H, W, C), dev)
        w = _randn(rng, (3, 3, C, O), dev, (2.0 / (9 * C)) ** 0.5)
        g = _randn(rng, (N, H, W, O), dev)
        w_rot = conv.rotate_filter(w)
        want = conv.conv3x3_reference(x.double(), w.double())
        want_dx = conv.conv3x3_reference(g.double(), w_rot.double())
        tag = "x".join(str(d) for d in shape)
        for name, lib in f32_libs.items():
            with using("conv3x3", lib):
                got = conv._launch(x, w)
                got_dx = conv._launch(g, w_rot)
                torch.cuda.synchronize()
                rec = {"fwd_max_rel_err": float(
                           (got.double() - want).abs().max()
                           / want.abs().max()),
                       "dx_max_rel_err": float(
                           (got_dx.double() - want_dx).abs().max()
                           / want_dx.abs().max()),
                       "fwd_ms": time_ms(lambda: conv._launch(x, w), flush),
                       "dx_ms": time_ms(lambda: conv._launch(g, w_rot),
                                        flush)}
                if hasattr(lib, "conv3x3_tiling"):
                    rec["rule_tiling"] = "%dx%d" % conv.kernel_tiling(*shape)
            if name == "source":
                source_out = (got, got_dx)
            else:
                rec["bit_identical_to_source"] = torch.equal(
                    got, source_out[0]) and torch.equal(got_dx, source_out[1])
            result[name][tag] = rec
            print(json.dumps({name: {tag: rec}}), flush=True)
        del x, w, g, w_rot, want, want_dx, got, got_dx, source_out
        torch.cuda.empty_cache()
    study_conv3x3_bf16(libs, result, dev, flush)


# the walk's shapes: the edge shapes TMA can take (C a multiple of 8),
# 128-pixel boxes across three 7 x 7 images, and the stage shapes
WALK_SHAPES = [s for s in CONV_EDGE_SHAPES if s[3] % 8 == 0] + \
    [(4, 7, 7, 64, 64)] + R50_CONV_SHAPES


def _im2col_walk(lib, rec, dev):
    """Every box of the bfloat16 face's im2col walk (BM 64 and 128, each
    tap and channel chunk) at WALK_SHAPES, landed and written out,
    against the padded input's slice: the same bits, zeros past C, in the
    halo and past the last pixel."""
    fn = lib.conv3x3_im2col_walk
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.RandomState(4)
    for shape in WALK_SHAPES:
        N, H, W, C, _ = shape
        M = N * H * W
        x = _randn(rng, (N, H, W, C), dev).bfloat16()
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        boxes = loads = same = 0
        for bm in (64, 128):
            rows = -(-M // bm) * bm
            out = torch.empty((rows, 64), dtype=torch.bfloat16, device=dev)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                patch = xp[:, dy:dy + H, dx:dx + W, :].reshape(M, C)
                for c0 in range(0, C, 64):
                    _build.check(lib, fn(x.data_ptr(), out.data_ptr(), N, H,
                                         W, C, bm, tap, c0,
                                         _build.stream_handle(dev)),
                                 "conv3x3_im2col_walk")
                    want = torch.zeros_like(out)
                    cs = min(64, C - c0)
                    want[:M, :cs] = patch[:, c0:c0 + cs]
                    torch.cuda.synchronize()
                    boxes += rows // bm
                    loads += 1
                    same += int(torch.equal(out, want))
        tag = "x".join(str(d) for d in shape)
        rec["walk " + tag] = {"boxes": boxes, "launches": loads,
                              "every_box_equal": same == loads}
        print(json.dumps({"walk": {tag: rec["walk " + tag]}}), flush=True)
        if not rec["walk " + tag]["every_box_equal"]:
            sys.exit("torch_flash_bwd_study: the im2col walk differs from "
                     "the padded input at %s" % (shape,))


def study_conv3x3_bf16(libs, result, dev, flush):
    """The bfloat16 face at ResNet-50's stage shapes: the walk proved
    first; then the source's face at its rule's tiling and at every
    wgmma tiling forced (all bit-identical), each bfloat16 variant's and
    (with --against) a parent's face, errors against a float64 conv
    (bfloat16 out), fwd and dx times, cuDNN on bfloat16 beside them, and
    the mean over a ResNet-50 step's 16 launches."""
    if "walk" in libs:  # built unless --variants leaves it out
        _im2col_walk(libs["walk"], result["walk"], dev)
    names = [n for n in libs if n in ("source", "against")
             or (n in CONV_BF16_VARIANTS and n != "walk")]
    means = {n: {"fwd": 0.0, "dx": 0.0} for n in names + ["cudnn"]}
    total = sum(R50_CONV_COUNTS)
    F = torch.nn.functional
    for i, (shape, count) in enumerate(zip(R50_CONV_SHAPES,
                                           R50_CONV_COUNTS)):
        N, H, W, C, O = shape
        rng = np.random.RandomState(70 + i)
        x = _randn(rng, (N, H, W, C), dev).bfloat16()
        w = _randn(rng, (3, 3, C, O), dev, (2.0 / (9 * C)) ** 0.5
                   ).bfloat16()
        g = _randn(rng, (N, H, W, O), dev).bfloat16()
        w_rot = conv.rotate_filter(w)
        want = conv.conv3x3_reference(x.double(), w.double())
        want_dx = conv.conv3x3_reference(g.double(), w_rot.double())
        tag = "bf16 " + "x".join(str(d) for d in shape)
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn = {"fwd": time_ms(lambda: F.conv2d(x_cl, w_cl, padding=1),
                                flush),
                 "dx": time_ms(lambda: torch.ops.aten.convolution_backward(
                     g_cl, x_cl, w_cl, None, [1, 1], [1, 1], [1, 1], False,
                     [0, 0], 1, [True, False, False]), flush)}
        for role in ("fwd", "dx"):
            means["cudnn"][role] += count * cudnn[role] / total
        for name in names:
            lib = libs[name]
            with using("conv3x3", lib):
                got = conv._launch(x, w)
                got_dx = conv._launch(g, w_rot)
                torch.cuda.synchronize()
                rec = {"fwd_max_rel_err": float(
                           (got.double() - want).abs().max()
                           / want.abs().max()),
                       "dx_max_rel_err": float(
                           (got_dx.double() - want_dx).abs().max()
                           / want_dx.abs().max()),
                       "fwd_ms": time_ms(lambda: conv._launch(x, w), flush),
                       "dx_ms": time_ms(lambda: conv._launch(g, w_rot),
                                        flush),
                       "cudnn_ms": cudnn}
                if hasattr(lib, "conv3x3_bf16_tiling"):
                    rec["rule"] = {
                        "fwd": conv.kernel_tiling(N, H, W, C, O,
                                                  torch.bfloat16),
                        "dx": conv.kernel_tiling(N, H, W, O, C,
                                                 torch.bfloat16)}
                if name == "source":
                    rec["ms_by_tiling"], same = {}, True
                    for t in conv.TILINGS_BF16:
                        f = conv._launch(x, w, None, "wgmma", t)
                        d = conv._launch(g, w_rot, None, "wgmma", t)
                        torch.cuda.synchronize()
                        same = same and torch.equal(f, got) and \
                            torch.equal(d, got_dx)
                        rec["ms_by_tiling"]["%dx%d" % t] = {
                            "fwd": time_ms(lambda: conv._launch(
                                x, w, None, "wgmma", t), flush),
                            "dx": time_ms(lambda: conv._launch(
                                g, w_rot, None, "wgmma", t), flush)}
                    rec["tilings_bit_identical"] = same
                    source_out = (got, got_dx)
                else:
                    rec["bit_identical_to_source"] = torch.equal(
                        got, source_out[0]) and torch.equal(
                        got_dx, source_out[1])
            for role in ("fwd", "dx"):
                means[name][role] += count * rec[role + "_ms"] / total
            result[name][tag] = rec
            print(json.dumps({name: {tag: rec}}), flush=True)
        del x, w, g, w_rot, want, want_dx, got, got_dx, x_cl, g_cl, w_cl
        torch.cuda.empty_cache()
    for name, ms in means.items():
        result.setdefault(name, {})["bf16 step mean ms"] = ms
    print(json.dumps({"bf16 step mean ms": means}), flush=True)


PAGED_VARIANTS = {
    "split32": [("constexpr int SPLIT = 64;", "constexpr int SPLIT = 32;")],
    "split128": [("constexpr int SPLIT = 64;", "constexpr int SPLIT = 128;")],
    "split256": [("constexpr int SPLIT = 64;", "constexpr int SPLIT = 256;")],
    "unroll2": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")],
    "unroll8": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")],
}


def paged_call(lib, q, kp, vp, tables, positions):
    """The paged attention of ``lib`` on the operands: the split kernel
    and its merge over a workspace of the library's own split count, or
    (a library without ``paged_attention_splits``) the single-pass
    kernel."""
    R, nh, dh = q.shape
    T, MB = kp.shape[1], tables.shape[1]
    out = torch.empty_like(q)
    args = [t.data_ptr() for t in (q, kp, vp, tables, positions, out)]
    fn = lib.paged_attention_f32
    fn.restype = ctypes.c_int
    try:
        splits = lib.paged_attention_splits
    except AttributeError:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        args += [R, nh, dh, T, MB]
    else:
        splits.argtypes = [ctypes.c_int] * 2
        splits.restype = ctypes.c_int
        S = splits(MB, T)
        work = torch.empty((R, nh, S, dh + 2), dtype=torch.float32,
                           device=q.device)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        args += [work.data_ptr(), R, nh, dh, T, MB, S]
    code = fn(*args, dh ** -0.5, _build.stream_handle(q.device))
    _build.check(lib, code, "paged_attention")
    return out


def _paged_device_us(fn, flush, iters=20, by_read=False):
    """Mean device microseconds a launch of each paged attention kernel
    over ``iters`` calls of ``fn``, L2 flushed before each as
    :func:`time_ms` does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if by_read:
                flush.sum()
            else:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"paged_attention\w*", e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            out[m.group(0)] = t / iters
    return out


def study_paged(libs, result, dev, flush):
    for R in (16, 4, 1):
        ops = _paged_inputs(dev, R)
        q, kp, vp, tables, positions = ops
        want = pa.paged_attention_reference(q.double(), kp.double(),
                                            vp.double(), tables, positions)
        tag = "R%d" % R
        for name, lib in libs.items():
            got = paged_call(lib, *ops)
            torch.cuda.synchronize()

            def call():
                return paged_call(lib, *ops)
            rec = {"max_abs_err": float((got.double() - want).abs().max()),
                   "ms": time_ms(call, flush),
                   "ms_read_flush": time_ms(call, flush, by_read=True),
                   "device_us": _paged_device_us(call, flush),
                   "device_us_read_flush": _paged_device_us(
                       call, flush, by_read=True)}
            result[name][tag] = rec
            print(json.dumps({name: {tag: rec}}), flush=True)
        del ops, q, kp, vp, want
        torch.cuda.empty_cache()


STUDIES = {  # kernel: (library name, its variants, its study, COMMON too)
    "bwd": ("flash_attention_bwd", BWD_VARIANTS, study_bwd, True),
    "fwd": ("flash_attention_fwd", FWD_VARIANTS, study_fwd, True),
    "matmul": ("matmul", MATMUL_VARIANTS, study_matmul, True),
    "gru": ("fused_gru", GRU_VARIANTS, rnn_study(gru, "fused_gru", 3),
            False),
    "lstm": ("fused_lstm", LSTM_VARIANTS, rnn_study(lstm, "fused_lstm", 4),
             False),
    "conv3x3": ("conv3x3", CONV_VARIANTS, study_conv3x3, False),
    "paged": ("paged_attention", PAGED_VARIANTS, study_paged, False),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=sorted(STUDIES),
                    default=["bwd"])
    ap.add_argument("--variants", nargs="+", metavar="NAME",
                    help="build only these variants beside the source "
                    "(default: all of each kernel's)")
    ap.add_argument("--against", metavar="DIR",
                    help="the root of another checkout whose source of "
                    "each kernel is built as the variant 'against'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_study: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}
    for kernel in args.kernel:
        name, variants, study, common = STUDIES[kernel]
        sources = variant_sources(name, variants, common)
        if args.variants:
            sources = {v: t for v, t in sources.items()
                       if v == "source" or v in args.variants}
        if args.against:
            sources["against"] = against_sources(args.against, name)
        libs, ptxas = build(name, sources)
        result = {v: {"ptxas": ptxas[v]} for v in libs}
        study(libs, result, dev, flush)
        out["%s_study" % kernel] = result
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(card[0] if card else "")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
