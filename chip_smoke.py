#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch on one NVIDIA card (an H100).

Drives the port's generative serving path and its Fluid training path
at the widths of GPT-2 small, its conv-net training path on ImageNet
ResNet-50, its sequence training path on the stacked-RNN text
classifier of ``benchmark/rnn_bench.py`` and its autotune path (the
``tune`` verb, the winner cache, the tuned dispatch of ``mul`` and
``conv2d``), and holds each hand-written CUDA kernel against its plain
PyTorch version. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:

1. build: compile every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, all started together);
2. kernels: each kernel against its plain version on the card, at the
   shapes the main path gives it, with the time of the kernel, of the
   plain version and of one PyTorch library call computing the same
   function, and the least time the card could take (in float32 on the
   CUDA cores, and in 3xTF32 on the tensor cores); the flash backward
   also at the templates of D 32 (non-causal) and D 128 (causal), and a
   second launch of each of its kernels must equal the first bit for bit;
3. engine: export random GPT-2-small-wide weights (seed 0) as a
   generative artifact, load them onto the card, and serve 16 greedy
   requests (prompts of 16 to 900 tokens, 32 new tokens each) through
   the continuous-batching engine; the launch counters must show that
   every prefill and decode step went through the kernels, and two
   requests' logits, step by step, must agree with the plain
   full-sequence forward;
4. http: serve the same artifact on port 0 in-process, POST ``:generate``
   twice (tokens must equal the engine's), then raise SIGTERM while a
   third request is in flight: the server must drain it and answer;
5. train: build ``transformer_lm`` + softmax-CE + Adam at GPT-2-small
   widths with the port's layers DSL (``configs/tiny_lm.model``), run
   the startup program, hold step 1's ``@GRAD`` vars of every parameter
   against ``torch.autograd`` through the plain functional forward (and
   show that a TF32 attention misses the tolerance), train 8 Adam steps
   of 8 x 1024 synthetic tokens through ``Trainer.train`` (the loss must
   fall; the launch counters must equal 2 forward and 1 dK/dV and dQ
   launch a layer a step), profile two more steps, then export the
   trained scope, load it and serve two greedy requests whose tokens
   must be the plain forward's argmax;
6. convnet: hold the conv3x3 kernel (forward, and dx on the rotated
   filter) against its plain version at ResNet-50's four 3x3 stage
   shapes (batch 32) and two ragged ones, with kernel, plain and cuDNN
   times; build ImageNet ResNet-50 (224 x 224, 1000 classes, float32,
   ``Momentum(0.01, 0.9)``, ``conv_impl=pallas3x3``) through
   ``configs/resnet_cifar.model``, hold step 1's gradients of every
   parameter and the running statistics against ``torch.autograd``
   through a plain forward (``F.conv2d`` everywhere; a TF32 reference
   must miss the tolerance), train 8 steps on one fixed batch of 32
   through ``Trainer.train`` (the loss must fall; exactly 16 forward and
   16 dx launches a step), report ``resnet50_train_images_per_sec`` and
   profile two more steps;
7. rnn: hold the fused LSTM and GRU recurrence kernels against their
   plain versions at T 100, N 64, D 512 (ragged lengths from a seeded
   RandomState, and full ones) and at T 7, N 3, D 128 (a TF32 recurrence
   must miss the tolerance), with kernel, plain and (LSTM) cuDNN times,
   registers, shared memory and blocks; then train
   ``configs/text_rnn.model`` at rnn_bench's widths (vocab 30000, hidden
   512, 100 words, batch 64, 2 layers the second reversed, Adam 0.002,
   float32, no peepholes, ``lstm_impl=pallas``) twice, with LSTM and
   with GRU cells: step 1's gradients of every parameter against
   ``torch.autograd`` through a plain forward (the plain recurrence), 8
   steps on one fixed batch through ``Trainer.train`` (the loss must
   fall; exactly 2 launches of the cell's kernel per layer a step, the
   forward and its replay in the generic grad, and no other kernel),
   tokens/s and two profiled steps;
8. tune: hold the blocked matmul kernel against its plain version at
   every compiled tiling, at the LM step's gemm shapes (8192 x 768 x 768,
   8192 x 768 x 3072, 8192 x 3072 x 768) and a ragged one (a TF32
   product must miss the tolerance), with every tiling's, the plain
   version's and ``torch.matmul``'s times; run ``python -m
   paddle_tpu_torch tune`` on phase 5's config with the wall timer
   against an empty cache of its own (exit 0) and print its table of the
   stock rung's and each tiling's times; write a cache whose winner for
   each gemm population is the race's fastest kernel tiling and train
   phase 5's 8 Adam steps against it: step-1 gradients against the plain
   reference, exactly 72 matmul launches and 72 tune hits and 1 fallback
   a step, the losses within 1e-3 of phase 5's, and two profiled steps;
   then one ResNet-50 step against a cache that says stock for the first
   stage's 3x3 population and the kernel for the second's
   (``conv_impl=conv``): the conv3x3 kernel runs forward and dx for
   exactly the second stage's 4 convs.

Each phase prints its wall time. Before phase 1 the tune cache is set
to a fresh, empty directory under ``build/`` (printed), so that no
winner left in the home directory reroutes phases 1-7; phase 8 fails
unless they made no tune hit.

The last lines printed are the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), the ``{"kernels": [...]}`` line, and then
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
import argparse
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 flops/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# and the tensor cores' dense TF32 flops/s: a float32-exact product in
# 3xTF32 takes three TF32 products
PEAK_TF32_FLOPS = 495e12

# GPT-2 small widths (Radford et al. 2019; Hugging Face "gpt2" config)
GPT2_SMALL = dict(vocab_size=50257, hidden=768, num_layers=12, num_heads=12,
                  ffn_mult=4, max_seq=1024)

# Kernel against plain version, same inputs, both float32 on the card:
# only the order of the float32 sums differs (online vs dense softmax,
# other reduction trees), worth ~1e-6 on outputs of size ~1. Rounding the
# inputs of the products to TF32 (10-bit mantissa) errs by ~1e-3.
KERNEL_TOL = 5e-5
# Logits of the kernel path (prefill and decode steps) against the plain
# full-sequence forward: the same sum-order differences carried through
# 12 layers. A forward whose attention inputs are rounded to TF32 (what a
# TF32 kernel computes) is measured in the same run and must miss this
# tolerance, so a kernel run in TF32 or bf16 would fail it.
LOGIT_TOL = 1e-3
# Flash backward kernels against the plain backward, same inputs, both
# float32: max abs error over the largest magnitude of the plain dq, dk
# or dv. Only sum orders differ (~1e-6 relative); the plain backward on
# inputs rounded to TF32 errs by ~1e-3 and is shown to miss it.
BWD_REL_TOL = 2e-5
# the flash backward's cases (S, D, causal): the training shape's ragged
# lengths and S 1024 (timed), and the other head dims' templates
FLASH_BWD_CASES = [(17, 64, True), (130, 64, True), (1024, 64, True),
                   (130, 32, False), (130, 128, True)]
# Step-1 gradients of every parameter from the Executor (flash kernels,
# the op lowerings and their grads) against torch.autograd through the
# plain functional forward: the norm of the difference over the norm of
# that parameter's reference gradient. Sum orders differ through 12
# layers and 8192 tokens, and a ReLU whose input lies within float32
# noise of 0 can open in one run and stay shut in the other, moving one
# token's whole contribution (so an elementwise maximum is no measure):
# together some 1e-3 for the worst parameter on the H100. A reference
# whose attention inputs are rounded to TF32 moves them by 1e-2 and more;
# it is measured in the same run and must miss this tolerance.
GRAD_REL_TOL = 5e-3
# The same check on phase 8's tuned run, whose 72 gemms a step go through
# the matmul kernel: 1e-3. Both the kernel and the reference are
# deterministic, so the reading repeats exactly from run to run on one
# card (8.92e-4 for blk11_ln2_b on the H100); the cuBLAS gemms of phase 5
# read 1.05e-3 and keep 5e-3 above.
TUNED_GRAD_REL_TOL = 1e-3
# the training drive: GPT-2-small widths, 8 sequences of 1024 tokens a
# step, 2 batches of synthetic next-token data repeated over 4 passes
TRAIN_BATCH = 8
TRAIN_PASSES = 4
TRAIN_LR = 1e-3
# conv3x3 kernel against its plain version (9 tap matmuls), same inputs,
# both float32: the largest error over the largest magnitude of the
# plain output. Only sum orders differ (sums of 9 * C products, C up to
# 512: ~1e-6 relative); the plain version on inputs rounded to TF32 errs
# by ~1e-3 and is shown to miss it at every shape.
CONV_REL_TOL = 2e-5
# ResNet-50's 3x3 convs (N, H, W, C, O) at batch 32, stage by stage, and
# how many of each a step runs; and ragged shapes (pixel and channel
# tails, the vector and the scalar load path)
R50_CONV_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                   (32, 14, 14, 256, 256), (32, 7, 7, 512, 512)]
R50_CONV_COUNTS = [3, 4, 6, 3]
CONV_RAGGED_SHAPES = [(3, 7, 9, 24, 40), (2, 5, 6, 3, 7)]
# the conv-net drive: ImageNet ResNet-50, 224 x 224, 1000 classes, one
# fixed batch of 32, Momentum(0.01, 0.9), 8 steps
R50_BATCH = 32
R50_STEPS = 8
R50_LR = 0.01
# Step-1 gradients of every parameter from the Executor (conv3x3 kernel,
# cuDNN for the other convs, the op lowerings and their grads) against
# torch.autograd through a plain forward (F.conv2d everywhere,
# F.batch_norm): the norm of the difference over the norm of that
# parameter's reference gradient. Sum orders differ through 53 convs and
# batch norms, so the forwards differ by ~1e-5 relative in the deep
# layers, and a ReLU input within that noise of 0 opens in one and stays
# shut in the other, moving that pixel's whole gradient: two float32
# computations of the step at 224 x 224 on the CPU differ by up to 1.7e-2
# (median 1.0e-2), while in float64 the port's lowerings and the
# reference agree to 2e-14. A reference whose conv operands are rounded
# to TF32 moves them by ~0.2-0.3; it is measured in the same run and
# must miss this tolerance.
R50_GRAD_REL_TOL = 5e-2
# a parameter whose reference gradient norm is below this fraction of the
# largest is zero but for float32 noise (each bottleneck's last batch-norm
# bias: the residual add carries no relu); the port's must be as small
ZERO_GRAD_FRAC = 1e-5
# running means and variances after step 1 against the reference's:
# relative norm over each stat vector, plus ZERO_GRAD_FRAC of the largest
# stat's norm (the running means of convs fed by a residual sum are zero
# but for noise: their input has zero mean, again for want of the relu)
R50_STAT_REL_TOL = 1e-4
# The fused recurrences (phase 7) at the slice's shape, T 100 steps of N
# 64 rows and D 512 units, and an odd one (N and D tails of the launch)
RNN_SHAPE = (100, 64, 512)
RNN_ODD_SHAPE = (7, 3, 128)
# Kernel against plain version, same inputs, both float32: the largest
# error over the largest magnitude of the plain hs (and cs). Only the
# order of each step's D-term sums differs (~1e-7 relative), and the
# state carries it through T steps of a contracting recurrence: 4e-7 on
# an H100. The plain recurrence with its products in TF32 (10-bit
# mantissa) errs by ~2e-4 there and is shown to miss this at the slice's
# shape.
RNN_REL_TOL = 1e-4
# the sequence drive: benchmark/rnn_bench.py's widths, one fixed batch,
# Adam(0.002), 8 steps, once with LSTM cells and once with GRU cells
RNN_BENCH = dict(vocab=30000, hidden=512, layers=2, seq_len=100, batch=64,
                 learning_rate=0.002)
RNN_STEPS = 8
# Step-1 gradients of every parameter from the Executor (the kernel
# forward, its replay in the generic grad, the plain backward loop with
# its batched recompute) against torch.autograd through the plain
# forward (the time loop): the norm of the difference over the norm of
# the reference gradient. Sum orders differ through 100 steps of two
# recurrences, forward and back (~1e-6 relative on an H100); a max-pool
# argmax that flips on a near tie would move one entry's whole gradient.
# A reference with its products in TF32 moves them by ~3e-2; it is
# measured in the same run and must miss this tolerance.
RNN_GRAD_REL_TOL = 1e-3
# the profiler range around the recurrences' plain backward loop
RNN_BWD_RANGE = "rnn_plain_backward_loop"
# The gemms of a GPT-2-small training step (M, K, N) that fall in the
# matmul kernel's population (q, k, v and the attention output; FFN up;
# FFN down), how many of each a layer runs, and a ragged shape (edges of
# every tile, the scalar load path)
MM_SHAPES = [(8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768)]
MM_COUNTS = [4, 1, 1]
MM_RAGGED_SHAPE = (100, 130, 200)
# matmul kernel against its plain version (the sum of k tiles of
# torch.matmul), same inputs, both float32: the largest error over the
# largest magnitude of the plain output. Only sum orders differ over K
# <= 3072 (~1e-6 relative); a product of inputs rounded to TF32 errs by
# ~1e-4 and is shown to miss it at every shape.
MM_REL_TOL = 1e-5
# losses of the tuned run (matmul kernel) against phase 5's (cuBLAS) at
# each of the 8 steps: the same start, only gemm sum orders differ
LOSS_REL_TOL = 1e-3
# the tune cache of phases 1-7: a fresh, empty directory, so that no
# winner left in the home directory reroutes them
TUNE_EMPTY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke", "tune_empty")


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def time_ms(fn, iters=20, warmup=3, flush=None):
    """Median ms of ``fn`` over ``iters`` launches, each between its own
    CUDA events; ``flush`` (a large tensor) is zeroed before each launch
    so that no input is served from the 50 MB L2 of the previous one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _no_launches():
    """{kernel name: 0} over every launch counter of the port."""
    from paddle_tpu_torch import kernels
    return {name: 0 for name in kernels.KERNEL_COUNTERS}


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(nbytes, flops):
    """The least ms of the same float32 work on the tensor cores in
    3xTF32: the larger of the bytes over the memory rate and three TF32
    products a flop over their rate."""
    return max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_FLOPS) * 1e3


# -- phase 1 -----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.monotonic()
    took = _build.build_all()
    total = time.monotonic() - t0
    for name in _build.sources():
        _build.load(name)
        ptxas = [ln.strip() for ln in (_build.build_log(name) or "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        log("build %s: %s" % (name, " | ".join(ptxas)))
    log(json.dumps({"build": {"seconds": round(total, 3),
                              "per_source_s": {k: round(v, 3)
                                               for k, v in took.items()}}}))


# -- phase 2 -----------------------------------------------------------------

def _paged_inputs(dev):
    R, MB, T, nh, dh = 16, 64, 16, 12, 64
    P = R * MB
    rng = np.random.RandomState(11)
    kp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(R, nh, dh).astype(np.float32))
    tables = rng.permutation(P).reshape(R, MB).astype(np.int32)
    positions = rng.randint(0, MB * T, (R,)).astype(np.int32)
    positions[:4] = [0, T - 1, T, MB * T - 1]
    tables[-2:] = P                      # two inactive rows: all trash
    positions[-2:] = 0
    return [t.to(dev) for t in (q, kp, vp, torch.from_numpy(tables),
                                torch.from_numpy(positions))]


def phase_kernels(dev):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    F = torch.nn.functional
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}

    # paged attention, the decode step's shape: R=16, MB=64, T=16, nh=12
    q, kp, vp, tables, positions = _paged_inputs(dev)
    R, nh, dh = q.shape
    T, MB = kp.shape[1], tables.shape[1]
    got = pa.paged_attention(q, kp, vp, tables, positions)
    want = pa.paged_attention_reference(q, kp, vp, tables, positions)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not np.isfinite(err) or err > KERNEL_TOL:
        fail("paged_attention disagrees with its plain version: max abs "
             "err %g > %g" % (err, KERNEL_TOL))
    cols = (torch.clamp(positions.long(), max=MB * T - 1) + 1).sum().item()
    nbytes = (cols * nh * dh * 2 * 4 + 2 * R * nh * dh * 4 + R * 4
              + int(((positions.long().clamp(max=MB * T - 1) // T) + 1)
                    .sum()) * 4)
    b_ms, b_by = bound(nbytes, 4 * cols * nh * dh)
    tc_ms = tc_bound(nbytes, 4 * cols * nh * dh)
    colmask = (torch.arange(MB * T, device=dev)[None, :]
               <= positions.long()[:, None])[:, None, None, :]

    def library():
        kc = kp[tables.long()].reshape(R, MB * T, nh, dh).transpose(1, 2)
        vc = vp[tables.long()].reshape(R, MB * T, nh, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None, :], kc, vc,
                                              attn_mask=colmask)

    lib_err = float((library()[:, :, 0] - want).abs().max())
    out["paged_attention"] = {
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:154",
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: pa.paged_attention(q, kp, vp, tables,
                                                  positions), flush=flush),
        "plain_ms": time_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, tables, positions), flush=flush),
        "bound_ms": b_ms, "bound_by": b_by, "tc_bound_ms": tc_ms,
        "library_ms": time_ms(library, flush=flush),
        "library": "gather + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "shape": {"R": R, "MB": MB, "T": T, "nh": nh, "dh": dh,
                  "positions": positions.tolist()}}

    # flash forward, the prefill's shape: causal, [1, S, 12, 64]
    rng = np.random.RandomState(12)
    shapes, errs = {}, []
    for S in (17, 128, 1024):
        qkv = [torch.from_numpy(rng.randn(1, S, 12, 64).astype(np.float32)
                                ).to(dev) for _ in range(3)]
        o, lse = fa.flash_attention_with_lse(*qkv, causal=True)
        o_ref, lse_ref = fa.flash_attention_reference(*qkv, causal=True)
        torch.cuda.synchronize()
        e = max(float((o - o_ref).abs().max()),
                float((lse - lse_ref).abs().max()))
        if not np.isfinite(e) or e > KERNEL_TOL:
            fail("flash_attention_fwd disagrees with its plain version at "
                 "S=%d: max abs err %g > %g" % (S, e, KERNEL_TOL))
        errs.append(e)
        BH, D = 12, 64
        pairs = S * (S + 1) // 2
        work = ((4 * S * D + S) * BH * 4, 4 * pairs * D * BH)
        b_ms, b_by = bound(*work)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in qkv)
        shapes[S] = {
            "max_abs_err": e,
            "ms": time_ms(lambda: fa.flash_attention_with_lse(
                *qkv, causal=True), flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_attention_reference(
                *qkv, causal=True), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_bound(*work),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), flush=flush)}
    big = shapes[1024]
    out["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:119",
        "max_abs_err": max(errs), "tolerance": KERNEL_TOL,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "tc_bound_ms": big["tc_bound_ms"],
        "library_ms": big["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True)",
        "shape": {"B": 1, "H": 12, "D": 64, "S_timed": 1024},
        "per_S": {str(k): v for k, v in shapes.items()}}
    out.update(_flash_bwd_kernels(dev, flush))
    del flush
    torch.cuda.empty_cache()
    return out


def _rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _flash_bwd_kernels(dev, flush):
    """dK/dV and dQ against the plain backward at the training shape (B
    8, H 12, D 64, causal, S 1024), at the ragged S = 17 and 130, and at
    the other head dims' templates (D 32 non-causal, D 128 causal, S
    130); a second launch of each kernel must equal the first bit for
    bit. Each kernel is timed alone at S 1024 on the delta its wrapper
    forms."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    B, H = TRAIN_BATCH, 12
    rng = np.random.RandomState(13)
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    per_case = {}
    for S, D, causal in FLASH_BWD_CASES:
        scale = D ** -0.5
        q, k, v, do = [torch.from_numpy(rng.randn(B, S, H, D).astype(
            np.float32)).to(dev) for _ in range(4)]
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal=causal)
        tf32 = fa.flash_attention_bwd_reference(
            *(_tf32_round(t) for t in (q, k, v)), o, lse, _tf32_round(do),
            causal=causal)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        rel = {n: _rel_err([g], [w]) for n, g, w in zip(names, got, want)}
        err = {n: float((g - w).abs().max())
               for n, g, w in zip(names, got, want)}
        same = {n: bool(torch.equal(a, b))
                for n, a, b in zip(names, got, again)}
        tf32_rel = _rel_err(tf32, want)
        case = "S%d_D%d_%s" % (S, D, "causal" if causal else "full")
        if not all(np.isfinite(x) and x <= BWD_REL_TOL
                   for x in rel.values()):
            fail("flash backward kernels disagree with the plain backward "
                 "at %s: relative errors %s > %g" % (case, rel, BWD_REL_TOL))
        if not all(same.values()):
            fail("flash backward kernels are not deterministic at %s: a "
                 "second launch differs (bit-identical: %s)" % (case, same))
        if not tf32_rel > BWD_REL_TOL:
            fail("a TF32 backward errs by only %g <= BWD_REL_TOL %g at %s: "
                 "the tolerance cannot tell float32 from TF32"
                 % (tf32_rel, BWD_REL_TOL, case))
        qh, kh, vh = (t.transpose(1, 2).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                 is_causal=causal)
        doh = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                       retain_graph=True)

        rec = {"S": S, "D": D, "causal": causal,
               "max_rel_err": rel, "max_abs_err": err,
               "tolerance_rel": BWD_REL_TOL,
               "second_launch_bit_identical": same,
               "tf32_inputs_max_rel_err": tf32_rel,
               "library_max_rel_err": _rel_err(
                   [g.transpose(1, 2) for g in library()], want),
               "smem_bytes": {
                   "dkv": lib.flash_attention_bwd_smem_bytes(D, 0),
                   "dq": lib.flash_attention_bwd_smem_bytes(D, 1)},
               "ptxas": {
                   "dkv": _ptxas("flash_attention_bwd",
                                 "flash_bwd_dkv_kernelILi%dE" % D),
                   "dq": _ptxas("flash_attention_bwd",
                                "flash_bwd_dq_kernelILi%dE" % D)}}
        if S == 1024:
            delta = fa._delta(o, do, None).contiguous()
            pairs = S * (S + 1) // 2 if causal else S * S
            head = S * D * 4
            dkv_work = (B * H * (6 * head + 2 * S * 4), B * H * pairs * 8 * D)
            dq_work = (B * H * (5 * head + 2 * S * 4), B * H * pairs * 6 * D)
            dkv_bound, dq_bound = bound(*dkv_work), bound(*dq_work)
            rec.update({
                "dkv_ms": time_ms(lambda: fa._bwd_dkv(
                    q, k, v, do, lse, delta, causal, scale), flush=flush),
                "dq_ms": time_ms(lambda: fa._bwd_dq(
                    q, k, v, do, lse, delta, causal, scale), flush=flush),
                "plain_ms": time_ms(lambda: fa.flash_attention_bwd_reference(
                    q, k, v, o, lse, do, causal=causal), flush=flush),
                "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
                "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
                "dkv_tc_bound_ms": tc_bound(*dkv_work),
                "dq_tc_bound_ms": tc_bound(*dq_work),
                "library_ms": time_ms(library, flush=flush)})
            rec["dkv_plus_dq_ms"] = rec["dkv_ms"] + rec["dq_ms"]
            del delta
        log(json.dumps({"flash_bwd_check": {case: rec}}))
        per_case[case] = rec
        del q, k, v, do, o, lse, got, again, want, tf32, lib_out, qh, kh, vh
    big = per_case["S1024_D64_causal"]
    out = {}
    for name, line, key, what in (
            ("flash_attention_bwd_dkv", 231, "dkv", ("dk", "dv")),
            ("flash_attention_bwd_dq", 254, "dq", ("dq",))):
        out[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:%d" % line,
            "max_abs_err": max(r["max_abs_err"][n]
                               for r in per_case.values() for n in what),
            "max_rel_err": max(r["max_rel_err"][n]
                               for r in per_case.values() for n in what),
            "tolerance_rel": BWD_REL_TOL,
            "ms": big[key + "_ms"], "plain_ms": big["plain_ms"],
            "plain": "flash_attention_bwd_reference (dq, dk and dv)",
            "bound_ms": big[key + "_bound_ms"],
            "bound_by": big[key + "_bound_by"],
            "tc_bound_ms": big[key + "_tc_bound_ms"],
            "library_ms": big["library_ms"],
            "library": "autograd.grad through scaled_dot_product_attention"
                       "(is_causal=True): dq, dk and dv, to be compared "
                       "with the sum of both kernels",
            "dkv_plus_dq_ms": big["dkv_plus_dq_ms"],
            "shape": {"B": B, "H": H, "D": 64, "causal": True,
                      "S_timed": 1024},
            "per_case": per_case}
    return out


# -- phase 3 -----------------------------------------------------------------

def _tf32_round(t):
    """Round float32 values to TF32's 10-bit mantissa (toward zero)."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _logit_checks(model, prompts, results, dev):
    """For two requests: logits of the kernel path (prefill_step, then one
    decode_step per generated token, through a fresh pool) against the
    plain full forward over prompt + generated tokens; the engine's
    greedy tokens and logprobs against the same forward; and the error a
    TF32 attention would make, which must exceed LOGIT_TOL."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.serving import PagePool, bucket_for, \
        padding_buckets, pages_for
    cfg = model.config
    p = model.params
    order = np.argsort([len(x) for x in prompts])
    picks = [int(order[0]), int(order[-1])]
    T = 16
    MB = pages_for(cfg.max_seq, T)
    pool = PagePool(2 * MB, T, *model.kv_spec)
    kp, vp = pool.zeros(dev)
    R = 4                                   # rows 2 and 3 stay inactive
    tables = np.full((R, MB), pool.trash_page, np.int32)
    tables[0] = np.arange(MB)
    tables[1] = np.arange(MB, 2 * MB)
    worst = {"prefill": 0.0, "decode": 0.0, "engine_logprob": 0.0,
             "tf32_attention": 0.0}
    fulls, last = [], []
    for row, j in enumerate(picks):
        seq = list(prompts[j]) + list(results[j].tokens)
        ids = torch.tensor([seq], dtype=torch.int32, device=dev)
        full = model(ids)[0]                                  # [N, V]
        fulls.append(full)
        n = len(prompts[j])
        padded = np.zeros((bucket_for(n, padding_buckets(cfg.max_seq)),),
                          np.int32)
        padded[:n] = prompts[j]
        got = tt.prefill_step(p, kp, vp, torch.from_numpy(padded).to(dev),
                              n, torch.from_numpy(tables[row]).to(dev), cfg)
        worst["prefill"] = max(worst["prefill"],
                               float((got - full[n - 1]).abs().max()))
        last.append(n)
        logp = torch.log_softmax(full, dim=-1)
        for t, tok in enumerate(results[j].tokens):
            row_l = full[n - 1 + t]
            if float(row_l.max() - row_l[tok]) > LOGIT_TOL:
                fail("engine token %d of request %d is not the plain "
                     "forward's argmax" % (t, j))
            worst["engine_logprob"] = max(
                worst["engine_logprob"],
                abs(results[j].logprobs[t] - float(logp[n - 1 + t, tok])))

        def tf32_attention(q, k, v):
            return fa.flash_attention_reference(
                _tf32_round(q), _tf32_round(k), _tf32_round(v),
                causal=True)[0]

        x, _, _ = tt._forward_hidden(p, ids, cfg, tf32_attention)
        worst["tf32_attention"] = max(
            worst["tf32_attention"],
            float(((x[0] @ p["lm_head"]) - full).abs().max()))
    steps = len(results[picks[0]].tokens) - 1
    for t in range(steps):
        toks = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        active = np.zeros((R,), bool)
        for row, j in enumerate(picks):
            toks[row] = results[j].tokens[t]
            pos[row] = last[row] + t
            active[row] = True
        logits = tt.decode_step(
            p, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(toks).to(dev),
            torch.from_numpy(active).to(dev), cfg)
        for row in range(2):
            worst["decode"] = max(worst["decode"], float(
                (logits[row] - fulls[row][pos[row]]).abs().max()))
    torch.cuda.synchronize()
    for key in ("prefill", "decode", "engine_logprob"):
        if not np.isfinite(worst[key]) or worst[key] > LOGIT_TOL:
            fail("%s logits differ from the plain forward by %g > %g"
                 % (key, worst[key], LOGIT_TOL))
    if not worst["tf32_attention"] > LOGIT_TOL:
        fail("a TF32 attention errs by only %g <= LOGIT_TOL %g: the "
             "tolerance is too loose to tell float32 from TF32"
             % (worst["tf32_attention"], LOGIT_TOL))
    return {"requests": picks, "decode_steps_checked": steps,
            "max_abs_err": worst, "tolerance": LOGIT_TOL}


def _profile_window(engine, prompts):
    """Drive the same requests again under torch.profiler: device kernel
    time by name and its share of the window's wall time (the profiler's
    own host overhead makes the window longer than an unprofiled one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        again = [h.wait(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return again, _device_kernels(prof, wall)


def _device_kernels(prof, wall, ranges=()):
    """Device kernel time by name from a profile over ``wall`` seconds:
    the busy share and the top 12 kernels. ``ranges`` names
    ``record_function`` ranges, which the profiler mirrors on the device
    as spans over their kernels; they are left out, or their kernels
    would count twice."""
    kern = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key in ranges:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kern[e.key] = (t_us / 1e3, e.count)
    busy = sum(t for t, _ in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    return {"window_wall_ms": wall * 1e3, "device_kernel_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "top_kernels": [{"name": k[:120], "ms": t, "count": c}
                            for k, (t, c) in top]}


def phase_engine(dev, art_dir):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.inference import export_generative, \
        load_generative
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.serving import GenerationEngine
    cfg = tt.TransformerConfig(**GPT2_SMALL)
    t0 = time.monotonic()
    export_generative(art_dir, cfg, params=tt.init_params(cfg, seed=0))
    model = load_generative(art_dir, device=dev)
    setup_s = time.monotonic() - t0
    rng = np.random.RandomState(1)
    lengths = rng.randint(16, 901, 16)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in lengths]
    engine = GenerationEngine(model, max_running=16, kv_pages=16 * 1024 // 16,
                              page_tokens=16, queue_depth=64, warm=True,
                              name="gpt2")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        results = [h.wait(timeout=600) for h in handles]
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        st = engine.stats
        again, profile = _profile_window(engine, prompts)
    finally:
        engine.close()
    profile["repeat_tokens_identical"] = \
        [r.tokens for r in again] == [r.tokens for r in results]
    profile["device_busy_share_of_unprofiled_wall"] = \
        profile["device_kernel_ms"] / (wall * 1e3)
    for r in results:
        if len(r.tokens) != 32 or r.finish_reason != "length":
            fail("a request ended with %d tokens (%s)"
                 % (len(r.tokens), r.finish_reason))
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail("a token id out of the vocabulary")
    L = cfg.num_layers
    want = dict(_no_launches(), flash_attention_fwd=L * st["prefills"],
                paged_attention=L * st["decode_steps"])
    if launches != want or st["prefills"] < 16 or st["decode_steps"] < 31:
        fail("launch counts %s, expected %s (prefills %d, decode steps %d)"
             % (launches, want, st["prefills"], st["decode_steps"]))
    checks = _logit_checks(model, prompts, results, dev)
    tokens = sum(len(r.tokens) for r in results)
    metrics = {
        "config": dict(GPT2_SMALL, dtype="float32", seed=0),
        "requests": len(prompts), "prompt_tokens": int(lengths.sum()),
        "prompt_len_min": int(lengths.min()),
        "prompt_len_max": int(lengths.max()),
        "new_tokens_each": 32, "max_running": 16, "page_tokens": 16,
        "kv_pages": 1024, "setup_s": setup_s, "warmup_ms": engine.warmup_ms,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "engine_busy_s": st["busy_s"],
        "intertoken_ms_p50": st["intertoken_ms_p50"],
        "intertoken_ms_p99": st["intertoken_ms_p99"],
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "prefills": st["prefills"], "decode_steps": st["decode_steps"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "logit_checks": checks, "profile": profile}
    log(json.dumps({"engine": metrics}))
    del model
    torch.cuda.empty_cache()
    return prompts, results, launches


# -- phase 4 -----------------------------------------------------------------

def _post(base, body, timeout=600):
    req = urllib.request.Request(
        base + "/v1/models/gpt2:generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def phase_http(dev, art_dir, prompts, results):
    from paddle_tpu_torch.serving import InferenceService, make_server, \
        serve_until_shutdown
    service = InferenceService()
    service.load_model("gpt2", art_dir, device=dev, max_running=16,
                       kv_pages=1024, page_tokens=16)
    server = make_server(service, host="127.0.0.1", port=0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    outcome = {"errors": []}
    in_flight = {}

    def inflight_post():
        try:
            in_flight["answer"] = _post(
                base, {"tokens": [int(t) for t in prompts[2]],
                       "max_new_tokens": 32})
        except Exception as e:          # reported by the main thread
            in_flight["error"] = repr(e)

    def client():
        try:
            for j in (0, 1):
                code, out = _post(base, {"tokens": [int(t) for t in
                                                    prompts[j]],
                                         "max_new_tokens": 32})
                if code != 200 or out["tokens"] != results[j].tokens:
                    outcome["errors"].append(
                        "POST %d answered %d with tokens that differ from "
                        "the engine's" % (j, code))
            t = threading.Thread(target=inflight_post, daemon=True)
            t.start()
            in_flight["thread"] = t
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and t.is_alive():
                st = service.stats["generation"]["gpt2"]
                if st["running"] or st["queued"]:
                    break
                time.sleep(0.005)
            outcome["running_at_signal"] = \
                service.stats["generation"]["gpt2"]["running"]
        except Exception as e:          # reported by the main thread
            outcome["errors"].append(repr(e))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
    signum = serve_until_shutdown(server)
    server.server_close()
    service.close()                     # drains the in-flight request
    t = in_flight.get("thread")
    if t is not None:
        t.join(timeout=600)
    if outcome["errors"]:
        fail("; ".join(outcome["errors"]))
    if signum != signal.SIGTERM:
        fail("the server stopped on %r, not SIGTERM" % (signum,))
    ans = in_flight.get("answer")
    if ans is None or ans[0] != 200 or \
            ans[1]["tokens"] != results[2].tokens:
        fail("the request in flight at SIGTERM was not drained: %r"
             % (in_flight.get("error") or ans,))
    log(json.dumps({"http": {"posts": 3, "signal": "SIGTERM",
                             "running_at_signal":
                                 outcome["running_at_signal"],
                             "drained_tokens": len(ans[1]["tokens"])}}))


# -- phase 5 -----------------------------------------------------------------

def _up_biases(program, num_layers):
    """{layer: name of the FFN-up fc's auto-named bias}: the Y of the
    elementwise_add that takes the output of the mul by blk<i>_up."""
    ops = program.global_block().ops
    mul_out = {op.input("Y")[0]: op.output("Out")[0]
               for op in ops if op.type == "mul"}
    bias_of = {op.input("X")[0]: op.input("Y")[0]
               for op in ops if op.type == "elementwise_add"}
    return {i: bias_of[mul_out["blk%d_up" % i]] for i in range(num_layers)}


def _reference_grads(params, feed, cfg, attention=None):
    """{name: grad} of the mean next-token cross entropy through the
    plain functional forward (``attention`` maps q/k/v to the attention
    output; default the plain causal attention)."""
    from paddle_tpu_torch.models import transformer as tt
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in params.items()}
    if attention is None:
        logits = tt.forward(leaves, feed["toks"], cfg)
    else:
        x, _, _ = tt._forward_hidden(leaves, feed["toks"], cfg, attention)
        logits = x @ leaves["lm_head"]
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), feed["tgt"].reshape(-1))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return dict(zip(names, grads)), float(loss.detach())


def _tf32_attention(q, k, v):
    """Plain causal attention on inputs rounded to TF32; the rounding
    passes gradients straight through."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    r = [_tf32_straight(t) for t in (q, k, v)]
    return fa.flash_attention_reference(*r, causal=True)[0]


def _grad_check(trainer, spec, cfg, feed, up_b, label="train",
                tol=GRAD_REL_TOL):
    """Step 1 through the Executor, fetching every parameter's @GRAD,
    against torch.autograd through the plain forward on the parameters
    the step started from."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    params = [p.name for p in trainer.main_program.all_parameters()]
    start = {n: scope.find_var(n).clone() for n in params}
    outs = trainer.exe.run(trainer.main_program, feed=feed,
                           fetch_list=[spec["cost"]]
                           + [n + "@GRAD" for n in params],
                           return_numpy=False)
    got = dict(zip(params, outs[1:]))
    # the serving face names the FFN-up bias blk<i>_up_b
    ref_name = {b: "blk%d_up_b" % i for i, b in up_b.items()}
    ref_params = {ref_name.get(n, n): t for n, t in start.items()}
    stats = {}
    for ref_kind, attention in (("float32", None), ("tf32_attention",
                                                    _tf32_attention)):
        want, ref_loss = _reference_grads(ref_params, feed, cfg, attention)
        norm_rel, max_rel = {}, {}
        for n in params:
            d, w = got[n] - want[ref_name.get(n, n)], want[ref_name.get(n, n)]
            norm_rel[n] = float(d.norm() / w.norm())
            max_rel[n] = float(d.abs().max() / w.abs().max())
        worst = max(norm_rel, key=norm_rel.get)
        stats[ref_kind] = {
            "norm_rel_err": norm_rel[worst], "worst_param": worst,
            "norm_rel_err_median": float(np.median(list(norm_rel.values()))),
            "elementwise_max_rel_err": max(max_rel.values()),
            "elementwise_worst_param": max(max_rel, key=max_rel.get),
            "loss_abs_err": abs(float(outs[0].reshape(-1)[0]) - ref_loss)}
        del want
    torch.cuda.synchronize()
    checks = {"params_checked": len(params), "tolerance_rel": tol,
              "float32": stats["float32"],
              "tf32_attention": stats["tf32_attention"]}
    log(json.dumps({label + "_grad_check": checks}))
    if not stats["float32"]["norm_rel_err"] <= tol:
        fail("step-1 gradient of %s differs from the autograd reference "
             "by %g (relative norm) > %g"
             % (stats["float32"]["worst_param"],
                stats["float32"]["norm_rel_err"], tol))
    if not stats["tf32_attention"]["norm_rel_err"] > tol:
        fail("a TF32 attention moves the gradients by only %g <= "
             "tolerance %g: the tolerance cannot tell float32 from TF32"
             % (stats["tf32_attention"]["norm_rel_err"], tol))
    return checks


def _serve_trained(dev, art_dir, cfg, scope):
    """Export the trained scope, load it with the serving stack and serve
    two greedy requests; each token must be the plain forward's argmax
    over the exported weights."""
    from paddle_tpu_torch.inference import export_generative, \
        load_generative
    from paddle_tpu_torch.serving import GenerationEngine
    export_generative(art_dir, cfg, scope=scope)
    model = load_generative(art_dir, device=dev)
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, cfg.vocab_size, n))
               for n in (16, cfg.max_seq // 4)]
    with GenerationEngine(model, max_running=2, kv_pages=64,
                          page_tokens=16, queue_depth=8, warm=False,
                          name="trained") as eng:
        results = [h.wait(timeout=600) for h in
                   [eng.submit(p, max_new_tokens=8) for p in prompts]]
    worst = 0.0
    for p, r in zip(prompts, results):
        ids = torch.tensor([list(p) + r.tokens], dtype=torch.int32,
                           device=dev)
        logits = model(ids)[0, len(p) - 1:-1]
        for row, tok in zip(logits, r.tokens):
            worst = max(worst, float(row.max() - row[tok]))
    if len(results[0].tokens) != 8 or not worst <= LOGIT_TOL:
        fail("the trained model's greedy tokens are not the plain "
             "forward's argmax (margin %g > %g)" % (worst, LOGIT_TOL))
    return {"requests": len(prompts), "prompt_lens": [len(p)
                                                      for p in prompts],
            "tokens": [r.tokens for r in results],
            "max_argmax_margin": worst}


def _lm_train(dev, label, after=None, want_matmul=0,
              grad_tol=GRAD_REL_TOL):
    """Build ``transformer_lm`` + softmax-CE + Adam at GPT-2-small widths
    through ``configs/tiny_lm.model``, init it, hold step 1's gradients
    against the plain reference, train TRAIN_PASSES passes of 2 batches
    through ``Trainer.train`` with the launch counters zeroed just before
    (and the tune counters read before and after), and profile two more
    steps. ``want_matmul`` is the
    matmul kernel's expected launches a step; ``after(cfg, scope)`` runs
    inside the trained scope. Returns the record the phase logs."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels, tune
    from paddle_tpu_torch.configs import tiny_lm
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    widths = dict(vocab=GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_seq"],
                  hidden=GPT2_SMALL["hidden"],
                  num_layers=GPT2_SMALL["num_layers"],
                  num_heads=GPT2_SMALL["num_heads"],
                  ffn_mult=GPT2_SMALL["ffn_mult"])
    cfg = tiny_lm.lm_config(**widths)
    L = cfg.num_layers
    t0 = time.monotonic()
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = tiny_lm.model(batch=TRAIN_BATCH, samples=2 * TRAIN_BATCH,
                             learning_rate=TRAIN_LR, seed=0, **widths)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    build_s = time.monotonic() - t0
    n_ops = len(main_prog.global_block().ops)
    with scope_guard(Scope()):
        t0 = time.monotonic()
        trainer._maybe_init()
        torch.cuda.synchronize()
        startup_s = time.monotonic() - t0
        n_params = sum(p.numel() for p in (
            global_scope().find_var(v.name)
            for v in main_prog.all_parameters()))
        first = next(iter(spec["reader"]()))
        checks = _grad_check(trainer, spec, cfg, trainer.feeder.feed(first),
                             _up_biases(main_prog, L), label, grad_tol)
        torch.cuda.empty_cache()

        losses, step_s, marks = [], [], {}

        def handler(e):
            if isinstance(e, BeginIteration):
                marks["t"] = time.monotonic()
            elif isinstance(e, EndIteration):
                step_s.append(time.monotonic() - marks["t"])
                losses.append(e.cost)

        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        tune_before = tune.counters()
        t0 = time.monotonic()
        trainer.train(spec["reader"], num_passes=TRAIN_PASSES,
                      event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        # Executor.stats mirror the process counters: this run's share
        tune_stats = {k: trainer.exe.stats[k] - v
                      for k, v in tune_before.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        want = dict(_no_launches(), flash_attention_fwd=2 * L * steps,
                    flash_attention_bwd_dkv=L * steps,
                    flash_attention_bwd_dq=L * steps,
                    matmul=want_matmul * steps)
        if steps != 2 * TRAIN_PASSES or launches != want:
            fail("%s launch counts %s over %d steps, expected %s"
                 % (label, launches, steps, want))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail("%s loss did not fall: %s" % (label, losses))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            trainer.train(spec["reader"], num_passes=1)
            torch.cuda.synchronize()
            prof_wall = time.monotonic() - t1
        profile_window = _device_kernels(prof, prof_wall)
        profile_window["steps"] = 2
        for kernel in ("matmul_kernel", "flash_fwd_kernel",
                       "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"):
            profile_window[kernel] = _kernel_share(prof, kernel)
        extra = after(cfg, global_scope()) if after else None
    p50 = float(np.median(step_s))
    tokens = TRAIN_BATCH * cfg.max_seq
    rec = {
        "config": dict(widths, dtype="float32", batch=TRAIN_BATCH,
                       tokens_per_step=tokens, optimizer="adam",
                       learning_rate=TRAIN_LR, seed=0),
        "params": n_params, "program_ops": n_ops, "build_s": build_s,
        "startup_s": startup_s, "grad_check": checks, "losses": losses,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50, "wall_s": wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "tune": tune_stats, "profile": profile_window}
    if after:
        rec["served"] = extra
    del trainer
    torch.cuda.empty_cache()
    return rec


def _kernel_share(prof, name):
    """Device time of the kernels whose name holds ``name`` over a
    profile, and their share of all device kernel time."""
    total = mine = 0.0
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        total += t
        if name in e.key:
            mine += t
            count += e.count
    return {"ms": mine, "count": count,
            "share": mine / total if total else 0.0}


def phase_train(dev, art_dir):
    rec = _lm_train(dev, "train",
                    after=lambda cfg, scope: _serve_trained(dev, art_dir,
                                                            cfg, scope))
    log(json.dumps({"train": rec}))
    return rec

# -- phase 6 -----------------------------------------------------------------

def _conv_inputs(shape, seed, dev):
    N, H, W, C, O = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(3, 3, C, O) * (2.0 / (9 * C)) ** 0.5)
                         .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(N, H, W, O).astype(np.float32)).to(dev)
    return x, w, g


def _conv3x3_kernel_check(dev):
    """The conv3x3 kernel against its plain version, forward and dx, at
    the four ResNet-50 stage shapes (batch 32) and two ragged ones, with
    the kernel, plain and cuDNN times at the stage shapes. Returns the
    two entries of the kernels line."""
    from paddle_tpu_torch.kernels import conv3x3
    F = torch.nn.functional
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    per_shape = {}
    for i, shape in enumerate(R50_CONV_SHAPES + CONV_RAGGED_SHAPES):
        N, H, W, C, O = shape
        x, w, g = _conv_inputs(shape, 20 + i, dev)
        w_rot = conv3x3.rotate_filter(w)
        got = conv3x3.conv3x3_s1_nhwc(x, w)
        got_dx, _ = conv3x3.conv3x3_bwd(x, w, g, want_dw=False)
        want = conv3x3.conv3x3_reference(x, w)
        want_dx = conv3x3.conv3x3_reference(g, w_rot)
        tf32 = conv3x3.conv3x3_reference(_tf32_round(x), _tf32_round(w))
        tf32_dx = conv3x3.conv3x3_reference(_tf32_round(g),
                                            _tf32_round(w_rot))
        torch.cuda.synchronize()
        rec = {"fwd_max_rel_err": _rel_err([got], [want]),
               "dx_max_rel_err": _rel_err([got_dx], [want_dx]),
               "fwd_max_abs_err": float((got - want).abs().max()),
               "dx_max_abs_err": float((got_dx - want_dx).abs().max()),
               "tf32_fwd_max_rel_err": _rel_err([tf32], [want]),
               "tf32_dx_max_rel_err": _rel_err([tf32_dx], [want_dx])}
        per_shape["x".join(str(d) for d in shape)] = rec
        log(json.dumps({"conv3x3_check": {"shape": shape, **rec}}))
        if not (rec["fwd_max_rel_err"] <= CONV_REL_TOL
                and rec["dx_max_rel_err"] <= CONV_REL_TOL):
            fail("conv3x3 disagrees with its plain version at %s: %s > %g"
                 % (shape, rec, CONV_REL_TOL))
        if not (rec["tf32_fwd_max_rel_err"] > CONV_REL_TOL
                and rec["tf32_dx_max_rel_err"] > CONV_REL_TOL):
            fail("a TF32 conv errs by only %s <= CONV_REL_TOL %g: the "
                 "tolerance cannot tell float32 from TF32" % (rec,
                                                             CONV_REL_TOL))
        if shape not in R50_CONV_SHAPES:
            continue
        # cuDNN on the same bytes: x and g as NCHW views of the NHWC
        # tensors, the filters in channels-last OIHW
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        work = (4 * (N * H * W * (C + O) + 9 * C * O),
                2 * N * H * W * C * O * 9)
        b_ms, b_by = bound(*work)
        rec.update({
            "fwd_ms": time_ms(lambda: conv3x3._launch(x, w), flush=flush),
            "dx_ms": time_ms(lambda: conv3x3._launch(g, w_rot),
                             flush=flush),
            "fwd_plain_ms": time_ms(lambda: conv3x3.conv3x3_reference(x, w),
                                    flush=flush),
            "dx_plain_ms": time_ms(
                lambda: conv3x3.conv3x3_reference(g, conv3x3.rotate_filter(
                    w)), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_bound(*work),
            "fwd_library_ms": time_ms(lambda: F.conv2d(x_cl, w_cl,
                                                       padding=1),
                                      flush=flush),
            "dx_library_ms": time_ms(
                lambda: torch.ops.aten.convolution_backward(
                    g_cl, x_cl, w_cl, None, [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [True, False, False]), flush=flush)})
        del x, w, g, w_rot, got, got_dx, want, want_dx, tf32, tf32_dx
    del flush
    torch.cuda.empty_cache()
    weights = {"x".join(str(d) for d in s): n
               for s, n in zip(R50_CONV_SHAPES, R50_CONV_COUNTS)}
    total = sum(weights.values())

    def per_launch(key):
        # mean over the 16 launches of a step: 3, 4, 6 and 3 at the stages
        return sum(per_shape[k][key] * n for k, n in weights.items()) / total

    out = {}
    for name, role in (("conv3x3_fwd", "fwd"), ("conv3x3_dx", "dx")):
        out[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/conv3x3.cu",
            "replaces": "paddle_tpu/kernels/conv3x3.py:97",
            "role": "forward" if role == "fwd" else
                    "dx of the backward, the same kernel on the rotated "
                    "filter (_vjp_bwd, conv3x3.py:165)",
            "max_abs_err": max(r[role + "_max_abs_err"]
                               for r in per_shape.values()),
            "max_rel_err": max(r[role + "_max_rel_err"]
                               for r in per_shape.values()),
            "tolerance_rel": CONV_REL_TOL,
            "tf32_inputs_min_rel_err": min(r["tf32_%s_max_rel_err" % role]
                                           for r in per_shape.values()),
            "ms": per_launch(role + "_ms"),
            "plain_ms": per_launch(role + "_plain_ms"),
            "bound_ms": per_launch("bound_ms"), "bound_by": "operations",
            "tc_bound_ms": per_launch("tc_bound_ms"),
            "library_ms": per_launch(role + "_library_ms"),
            "library": "cuDNN through F.conv2d" if role == "fwd" else
                       "cuDNN through convolution_backward (dx only)",
            "timed_as": "mean over a ResNet-50 step's 16 launches: the "
                        "stage shapes weighted 3, 4, 6, 3",
            "per_shape": per_shape}
    log(json.dumps({"conv3x3_times": {
        k: {f: v for f, v in r.items() if f.endswith("ms")}
        for k, r in per_shape.items() if "fwd_ms" in r}}))
    return out


def _plain_resnet_loss(program, params, feed, cost, conv_round=None):
    """The loss of ``program``'s forward recomputed with plain torch
    functions (``F.conv2d`` for every conv, ``F.batch_norm`` with batch
    statistics) from ``params`` and ``feed``, differentiable through
    autograd; returns (loss, {MeanOut/VarianceOut name: new running
    stat}). ``conv_round`` maps each conv operand before the conv (the
    TF32 contrast)."""
    F = torch.nn.functional
    env = dict(feed)
    env.update(params)
    stats = {}
    for op in program.global_block().ops:
        a = op.attr
        if op.type == "conv2d":
            x, w = env[op.input("Input")[0]], env[op.input("Filter")[0]]
            if conv_round is not None:
                x, w = conv_round(x), conv_round(w)
            y = F.conv2d(x, w, None, a("strides"), a("paddings"),
                         a("dilations"), a("groups"))
            env[op.output("Output")[0]] = y
        elif op.type == "batch_norm":
            x = env[op.input("X")[0]]
            m = a("momentum")
            bv, bm = torch.var_mean(x.detach(), dim=(0, 2, 3),
                                    unbiased=False)
            stats[op.output("MeanOut")[0]] = \
                m * env[op.input("Mean")[0]] + (1 - m) * bm
            stats[op.output("VarianceOut")[0]] = \
                m * env[op.input("Variance")[0]] + (1 - m) * bv
            env[op.output("Y")[0]] = F.batch_norm(
                x, None, None, env[op.input("Scale")[0]],
                env[op.input("Bias")[0]], True, 0.0, a("epsilon"))
        elif op.type == "relu":
            env[op.output("Out")[0]] = F.relu(env[op.input("X")[0]])
        elif op.type == "pool2d":
            x = env[op.input("X")[0]]
            if a("global_pooling"):
                y = x.mean(dim=(2, 3), keepdim=True)
            else:
                y = F.max_pool2d(x, a("ksize"), a("strides"), a("paddings"))
            env[op.output("Out")[0]] = y
        elif op.type == "elementwise_add":
            x, y = env[op.input("X")[0]], env[op.input("Y")[0]]
            env[op.output("Out")[0]] = x + (y if y.shape == x.shape
                                            else y.reshape(1, -1))
        elif op.type == "mul":
            x = env[op.input("X")[0]]
            env[op.output("Out")[0]] = x.reshape(x.shape[0], -1) \
                @ env[op.input("Y")[0]]
        elif op.type == "softmax":
            env[op.output("Out")[0]] = torch.softmax(env[op.input("X")[0]],
                                                     dim=-1)
        elif op.type == "cross_entropy":
            p = env[op.input("X")[0]]
            lab = env[op.input("Label")[0]].long().reshape(-1, 1)
            env[op.output("Y")[0]] = -torch.log(
                torch.clamp(p, 1e-15, 1.0)).gather(1, lab)
        elif op.type == "mean":
            env[op.output("Out")[0]] = env[op.input("X")[0]].mean() \
                .reshape(1)
        elif op.type in ("top_k", "accuracy"):
            continue
        else:
            fail("the plain ResNet forward has no rule for op %r" % op.type)
        if cost in op.output_arg_names:
            return env[cost], stats
    fail("the plain ResNet forward never reached the loss %r" % cost)


def _convnet_grad_check(trainer, spec, feed):
    """Step 1 through the Executor, fetching every parameter's @GRAD
    and the running statistics after it, against torch.autograd through
    the plain forward on the state the step started from; and the same
    reference with every conv operand rounded to TF32, which must miss
    the tolerance."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    prog = trainer.main_program
    cost = spec["cost"].name
    params = [p.name for p in prog.all_parameters() if p.trainable]
    stat_names = [op.output(s)[0] for op in prog.global_block().ops
                  if op.type == "batch_norm"
                  for s in ("MeanOut", "VarianceOut")]
    start = {n: scope.find_var(n).clone()
             for n in params + stat_names}
    outs = trainer.exe.run(prog, feed=feed,
                           fetch_list=[cost] + [n + "@GRAD" for n in params],
                           return_numpy=False)
    got = dict(zip(params, outs[1:]))
    got_stats = {n: scope.find_var(n) for n in stat_names}
    stats = {}
    for label, rnd in (("float32", None), ("tf32_convs", _tf32_straight)):
        leaves = {n: start[n].detach().clone().requires_grad_(n in params)
                  for n in start}
        loss, new_stats = _plain_resnet_loss(prog, leaves, feed, cost, rnd)
        want = dict(zip(params, torch.autograd.grad(
            loss, [leaves[n] for n in params])))
        largest = max(float(w.norm()) for w in want.values())
        # gradients that are zero but for float32 noise (the bias of each
        # bottleneck's last batch norm: no relu after the residual add)
        zero = {n for n in params
                if float(want[n].norm()) <= ZERO_GRAD_FRAC * largest}
        rel = {n: float((got[n] - want[n]).norm() / want[n].norm())
               for n in params if n not in zero}
        worst = max(rel, key=rel.get)
        # err <= tol * |want| + floor, as err / (|want| + floor / tol)
        slack = ZERO_GRAD_FRAC * max(float(t.norm())
                                     for t in new_stats.values()) \
            / R50_STAT_REL_TOL
        stat_rel = {n: float((got_stats[n] - new_stats[n]).norm())
                    / (float(new_stats[n].norm()) + slack)
                    for n in stat_names}
        stats[label] = {
            "norm_rel_err": rel[worst], "worst_param": worst,
            "norm_rel_err_median": float(np.median(list(rel.values()))),
            "zero_grad_params": len(zero),
            "zero_grad_max_abs_err": max(
                [float((got[n] - want[n]).abs().max()) for n in zero]
                or [0.0]),
            "largest_grad_norm": largest,
            "running_stats_norm_rel_err": max(stat_rel.values()),
            "running_stats_worst": max(stat_rel, key=stat_rel.get),
            "loss_abs_err": abs(float(outs[0].reshape(-1)[0])
                                - float(loss.detach()))}
        del leaves, loss, new_stats, want
    torch.cuda.synchronize()
    checks = {"params_checked": len(params), "running_stats": len(stat_names),
              "tolerance_rel": R50_GRAD_REL_TOL,
              "stats_tolerance_rel": R50_STAT_REL_TOL,
              "loss": float(outs[0].reshape(-1)[0]), **stats}
    log(json.dumps({"convnet_grad_check": checks}))
    f32, tf32 = stats["float32"], stats["tf32_convs"]
    if not f32["norm_rel_err"] <= R50_GRAD_REL_TOL:
        fail("step-1 gradient of %s differs from the autograd reference by "
             "%g (relative norm) > %g" % (f32["worst_param"],
                                          f32["norm_rel_err"],
                                          R50_GRAD_REL_TOL))
    if not f32["zero_grad_max_abs_err"] <= ZERO_GRAD_FRAC * \
            f32["largest_grad_norm"]:
        fail("a gradient that is zero in the reference is %g in the port"
             % f32["zero_grad_max_abs_err"])
    if not f32["running_stats_norm_rel_err"] <= R50_STAT_REL_TOL:
        fail("running statistic %s differs from the reference by %g > %g"
             % (f32["running_stats_worst"],
                f32["running_stats_norm_rel_err"], R50_STAT_REL_TOL))
    if not tf32["norm_rel_err"] > R50_GRAD_REL_TOL:
        fail("TF32 convs move the gradients by only %g <= %g: the tolerance "
             "cannot tell float32 from TF32" % (tf32["norm_rel_err"],
                                                R50_GRAD_REL_TOL))
    return checks


def _tf32_straight(t):
    """``t`` rounded to TF32, passing gradients straight through."""
    return t + (_tf32_round(t) - t).detach()


def _conv_share(prof):
    """Device time by kind of kernel over a profile: the conv3x3 kernel,
    cuDNN convolutions (forward, dgrad, wgrad), GEMMs (the dw tap
    contractions and the fc), reductions (batch norm statistics and their
    grads) and the rest (elementwise, copies, pooling)."""
    kinds = {"conv3x3": 0.0, "cudnn_conv": 0.0, "gemm": 0.0,
             "reduction": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        k = e.key.lower()
        if "conv3x3_kernel" in k:
            kinds["conv3x3"] += t
        elif any(s in k for s in ("conv", "cudnn", "xmma", "implicit",
                                  "dgrad", "wgrad", "fprop")):
            kinds["cudnn_conv"] += t
        elif any(s in k for s in ("gemm", "cutlass", "gemv")):
            kinds["gemm"] += t
        elif "reduce" in k:
            kinds["reduction"] += t
        else:
            kinds["other"] += t
    busy = sum(kinds.values())
    return {k: {"ms": v, "share": v / busy if busy else 0.0}
            for k, v in kinds.items()}


def phase_convnet(dev):
    """ImageNet ResNet-50 at 224 x 224, 1000 classes, float32, batch 32,
    Momentum(0.01, 0.9), conv_impl=pallas3x3, built by the CIFAR config's
    model(); step-1 gradients and running stats against the plain
    reference, then R50_STEPS steps on one fixed batch through
    Trainer.train, then two profiled steps."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    t0 = time.monotonic()
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = resnet_cifar.model(variant="imagenet", depth=50, image=224,
                                  class_dim=1000, batch=R50_BATCH,
                                  learning_rate=R50_LR)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    build_s = time.monotonic() - t0
    n_ops = len(main_prog.global_block().ops)
    # one fixed batch, as bench.py's ResNet-50 rung makes it
    rng = np.random.RandomState(0)
    imgs = rng.rand(R50_BATCH, 3, 224, 224).astype(np.float32)
    labels = rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)
    batch = list(zip(imgs, labels))

    def fixed(n):
        return lambda: (batch for _ in range(n))

    with scope_guard(Scope()):
        t0 = time.monotonic()
        trainer._maybe_init()
        torch.cuda.synchronize()
        startup_s = time.monotonic() - t0
        n_params = sum(global_scope().find_var(v.name).numel()
                       for v in main_prog.all_parameters() if v.trainable)
        checks = _convnet_grad_check(trainer, spec, trainer.feeder.feed(
            batch))
        torch.cuda.empty_cache()
        losses, step_s, marks = [], [], {}

        def handler(e):
            if isinstance(e, BeginIteration):
                marks["t"] = time.monotonic()
            elif isinstance(e, EndIteration):
                step_s.append(time.monotonic() - marks["t"])
                losses.append(e.cost)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.monotonic()
        trainer.train(fixed(R50_STEPS), num_passes=1, event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        want = dict(_no_launches(), conv3x3_fwd=16 * steps,
                    conv3x3_dx=16 * steps)
        log(json.dumps({"convnet_losses": losses, "launches": launches}))
        if steps != R50_STEPS or launches != want:
            fail("convnet launch counts %s over %d steps, expected %s"
                 % (launches, steps, want))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail("ResNet-50 loss did not fall on the fixed batch: %s"
                 % losses)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            trainer.train(fixed(2), num_passes=1)
            torch.cuda.synchronize()
            prof_wall = time.monotonic() - t1
        profile_window = _device_kernels(prof, prof_wall)
        profile_window["steps"] = 2
        profile_window["by_kind"] = _conv_share(prof)
    p50 = float(np.median(step_s))
    log(json.dumps({"convnet": {
        "config": {"model": "resnet_imagenet", "depth": 50, "image": 224,
                   "class_dim": 1000, "dtype": "float32",
                   "batch": R50_BATCH, "optimizer": "momentum(0.9)",
                   "learning_rate": R50_LR, "conv_impl": "pallas3x3",
                   "data": "one fixed batch, RandomState(0) rand/randint"},
        "params": n_params, "program_ops": n_ops, "build_s": build_s,
        "startup_s": startup_s, "grad_check": checks, "losses": losses,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
        "resnet50_train_images_per_sec": R50_BATCH / p50, "wall_s": wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "profile": profile_window}}))
    log("resnet50_train_images_per_sec %.3f (batch %d, step p50 %.3f ms)"
        % (R50_BATCH / p50, R50_BATCH, p50 * 1e3))
    del trainer
    torch.cuda.empty_cache()
    return launches


# -- phase 7 -----------------------------------------------------------------

def _rnn_inputs(gates, T, N, D, seed, ragged, dev):
    """Inputs of a fused recurrence: xs at the scale of the model's fc
    projections, W at 1/sqrt(D), h0/c0 small; lengths from a seeded
    RandomState in [1, T] when ``ragged``, else all T."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(T, N, gates * D).astype(np.float32) * 0.5
    w = (rng.randn(D, gates * D) / np.sqrt(D)).astype(np.float32)
    h0 = rng.randn(N, D).astype(np.float32) * 0.2
    c0 = rng.randn(N, D).astype(np.float32) * 0.2
    lens = rng.randint(1, T + 1, N) if ragged else np.full(N, T)
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (xs, w, h0, c0, mask)]


def _ptxas(name, kernel):
    """The compiler's register / shared-memory / spill lines of one
    kernel of ``csrc/<name>.cu``."""
    from paddle_tpu_torch.kernels import _build
    lines = (_build.build_log(name) or "").splitlines()
    out, hit = [], False
    for ln in lines:
        if "Compiling entry function" in ln:
            hit = kernel in ln
        elif hit and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def _cudnn_lstm(xs, w, h0, c0):
    """One cuDNN ``torch.nn.LSTM`` layer computing the fused LSTM on an
    unmasked batch: input size 4D, an input weight that permutes
    Paddle's gate slabs (c~, i, f, o) to PyTorch's (i, f, g, o), the
    recurrent weight in the same order, no biases. Returns a call that
    runs it on ``xs`` from (h0, c0)."""
    T, N, D4 = xs.shape
    D = D4 // 4
    lstm = torch.nn.LSTM(D4, D, num_layers=1, bias=False).to(xs.device)
    order = [1, 2, 0, 3]            # PyTorch's i, f, g, o in Paddle's slabs
    eye = torch.eye(D4, device=xs.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([eye[k * D:(k + 1) * D]
                                           for k in order]))
        lstm.weight_hh_l0.copy_(torch.cat([w[:, k * D:(k + 1) * D].t()
                                           for k in order]))
    lstm.flatten_parameters()
    state = (h0[None].contiguous(), c0[None].contiguous())

    def call():
        with torch.no_grad():
            return lstm(xs, state)[0]
    return call


def _rnn_kernel_check(dev):
    """Each fused recurrence against its plain version at the slice's
    shape (T 100, N 64, D 512), ragged and full masks, and at an odd one
    (T 7, N 3, D 128); a recurrence run with TF32 products must miss the
    tolerance. Times at the training drive's input (full lengths), with
    cuDNN's LSTM beside row 7. Returns the two entries of the kernels
    line."""
    from paddle_tpu_torch.kernels import fused_gru, fused_lstm
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}
    for name, gates, mod in (("fused_lstm", 4, fused_lstm),
                             ("fused_gru", 3, fused_gru)):
        def run(args, plain=False):
            xs, w, h0, c0, mask = args
            if name == "fused_lstm":
                f = fused_lstm.fused_lstm_reference if plain \
                    else fused_lstm.fused_lstm
                return list(f(xs, w, h0, c0, mask))
            f = fused_gru.fused_gru_reference if plain \
                else fused_gru.fused_gru
            return [f(xs, w, h0, mask)]

        checks = []
        for seed, (T, N, D) in enumerate((RNN_SHAPE, RNN_ODD_SHAPE)):
            for ragged in (True, False):
                args = _rnn_inputs(gates, T, N, D, 40 + seed, ragged, dev)
                got = run(args)
                want = run(args, plain=True)
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32 = run(args, plain=True)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.cuda.synchronize()
                rec = {"shape": [T, N, D], "ragged": ragged,
                       "lengths_sum": int(args[4].sum()),
                       "max_rel_err": _rel_err(got, want),
                       "max_abs_err": max(float((g - w_).abs().max())
                                          for g, w_ in zip(got, want)),
                       "tf32_products_max_rel_err": _rel_err(tf32, want),
                       "launch": mod.launch_plan(N, D)}
                checks.append(rec)
                log(json.dumps({name + "_check": rec}))
                if not rec["max_rel_err"] <= RNN_REL_TOL:
                    fail("%s disagrees with its plain version at %s: %s > %g"
                         % (name, rec["shape"], rec["max_rel_err"],
                            RNN_REL_TOL))
                # (at the odd shape cuBLAS may keep a 3-row product in
                # float32 even with TF32 allowed, so only the slice's
                # shape is held to the contrast)
                if (T, N, D) == RNN_SHAPE and \
                        not rec["tf32_products_max_rel_err"] > RNN_REL_TOL:
                    fail("a TF32 recurrence errs by only %g <= %g: the "
                         "tolerance cannot tell float32 from TF32"
                         % (rec["tf32_products_max_rel_err"], RNN_REL_TOL))
        T, N, D = RNN_SHAPE
        args = _rnn_inputs(gates, T, N, D, 40, False, dev)
        xs, w, h0, c0, mask = args
        # the bound: each input read once, each output written once; the
        # recurrent products over every step (full lengths, the drive's)
        nbytes = 4 * (xs.numel() + w.numel() + h0.numel() + mask.numel()
                      + (c0.numel() if gates == 4 else 0)
                      + (2 if gates == 4 else 1) * T * N * D)
        flops = 2 * T * N * D * gates * D
        b_ms, b_by = bound(nbytes, flops)
        launch = mod._launch
        kargs = args if gates == 4 else (xs, w, h0, mask)
        # where a step's time goes: the cost of one more step (T 10 -> 100),
        # and of a batch of 8 rows against 64 (the products shrink 8x, the
        # barriers and the staging of h do not)
        scaling = {}
        for t_, n_ in ((10, N), (T, 8)):
            xs_, h0_, c0_, m_ = (a.contiguous() for a in (
                xs[:t_, :n_], h0[:n_], c0[:n_], mask[:t_, :n_]))
            sargs = (xs_, w, h0_, c0_, m_) if gates == 4 \
                else (xs_, w, h0_, m_)
            scaling["T%d_N%d_ms" % (t_, n_)] = time_ms(
                lambda: launch(*sargs), flush=flush)
        rec = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/%s.cu" % name,
            "replaces": "paddle_tpu/kernels/%s.py:%d" % (
                name, 73 if gates == 4 else 63),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_rel_err": max(c["max_rel_err"] for c in checks),
            "tolerance_rel": RNN_REL_TOL,
            "tf32_products_min_rel_err": min(
                c["tf32_products_max_rel_err"] for c in checks
                if c["shape"] == list(RNN_SHAPE)),
            "ms": time_ms(lambda: launch(*kargs), flush=flush),
            "scaling": scaling,
            "plain_ms": time_ms(lambda: run(args, plain=True), iters=5,
                                flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_bound(nbytes, flops),
            "launch": mod.launch_plan(N, D),
            "ptxas": _ptxas(name, name + "_kernel"),
            "shape": {"T": T, "N": N, "D": D, "timed_lengths": "all T"},
            "checks": checks}
        if gates == 4:
            lib = _cudnn_lstm(xs, w, h0, c0)
            rec["library_max_abs_err"] = float(
                (lib() - run(args)[0]).abs().max())
            rec["library_ms"] = time_ms(lib, flush=flush)
            rec["library"] = ("cuDNN torch.nn.LSTM, one layer, input 4D with "
                              "a gate-permuting identity input weight (one "
                              "extra [T*N, 4D] x [4D, 4D] GEMM), no biases, "
                              "unmasked")
        else:
            rec["library_ms"] = None
            rec["library"] = ("none, a different function: PyTorch's GRU "
                              "applies r after the recurrent product")
        rec["scaling"]["us_per_step"] = 1e3 * (
            rec["ms"] - scaling["T10_N%d_ms" % N]) / (T - 10)
        out[name] = rec
        del args, xs, w, h0, c0, mask
    del flush
    torch.cuda.empty_cache()
    return out


def _plain_rnn_loss(program, params, feed, cost):
    """The loss of ``program``'s forward recomputed with plain torch
    functions from ``params`` and ``feed``, differentiable through
    autograd: every sequence of the batch has the same length T (the
    benchmark's batch), so the ragged rows are a [N, T, ...] grid, and
    each recurrence is the kernels' plain version over the whole grid."""
    from paddle_tpu_torch.kernels import fused_gru, fused_lstm
    words = feed["words"]
    N = words.lod[0].numel() - 1
    T = words.max_lens[0]
    env = {"words": words.data.reshape(-1), "label": feed["label"]}
    env.update(params)
    for op in program.global_block().ops:
        ins = {s: [env.get(n) for n in op.input(s)] for s in op.inputs}
        x = ins.get("X", ins.get("Input", [None]))[0]
        if op.type == "lookup_table":
            out = {"Out": env[op.input("W")[0]][env[op.input("Ids")[0]]]}
        elif op.type == "mul":
            out = {"Out": x.reshape(x.shape[0], -1) @ ins["Y"][0]}
        elif op.type == "elementwise_add":
            out = {"Out": x + ins["Y"][0]}
        elif op.type in ("lstm", "gru"):
            D = ins["Weight"][0].shape[0]
            xs = (x.reshape(N, T, -1) + ins["Bias"][0].reshape(-1)
                  [:x.shape[1]]).transpose(0, 1)
            rev = op.attr("is_reverse")
            if rev:
                xs = xs.flip(0)
            zeros = xs.new_zeros((N, D))
            ones = xs.new_ones((T, N))
            if op.type == "lstm":
                hs, _ = fused_lstm.fused_lstm_reference(
                    xs, ins["Weight"][0], zeros, zeros, ones)
            else:
                hs = fused_gru.fused_gru_reference(xs, ins["Weight"][0],
                                                   zeros, ones)
            if rev:
                hs = hs.flip(0)
            out = {"Hidden": hs.transpose(0, 1).reshape(N * T, D)}
        elif op.type == "sequence_pool":
            out = {"Out": x.reshape(N, T, -1).amax(dim=1)}
        elif op.type == "softmax":
            out = {"Out": torch.softmax(x, dim=-1)}
        elif op.type == "cross_entropy":
            lab = ins["Label"][0].long().reshape(-1, 1)
            out = {"Y": -torch.log(torch.clamp(x, 1e-15, 1.0)).gather(1, lab)}
        elif op.type == "mean":
            out = {"Out": x.mean().reshape(1)}
        else:
            fail("the plain RNN forward has no rule for op %r" % op.type)
        for slot, value in out.items():
            env[op.output(slot)[0]] = value
        if cost in op.output_arg_names:
            return env[cost]
    fail("the plain RNN forward never reached the loss %r" % cost)


def _rnn_grad_check(trainer, spec, feed):
    """Step 1 through the Executor (the kernel forward, its replay and
    the plain backward loop), fetching every parameter's @GRAD, against
    torch.autograd through the plain forward on the state the step
    started from; the same reference with TF32 products must miss the
    tolerance."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    prog = trainer.main_program
    cost = spec["cost"].name
    params = [p.name for p in prog.all_parameters() if p.trainable]
    start = {n: scope.find_var(n).clone() for n in params}
    outs = trainer.exe.run(prog, feed=feed,
                           fetch_list=[cost] + [n + "@GRAD" for n in params],
                           return_numpy=False)
    got = dict(zip(params, outs[1:]))
    stats = {}
    for label, tf32 in (("float32", False), ("tf32_products", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        leaves = {n: start[n].detach().clone().requires_grad_(True)
                  for n in params}
        loss = _plain_rnn_loss(prog, leaves, feed, cost)
        want = dict(zip(params, torch.autograd.grad(
            loss, [leaves[n] for n in params])))
        torch.backends.cuda.matmul.allow_tf32 = False
        rel = {n: float((got[n] - want[n]).norm() / want[n].norm())
               for n in params}
        worst = max(rel, key=rel.get)
        stats[label] = {"norm_rel_err": rel[worst], "worst_param": worst,
                        "norm_rel_err_median": float(np.median(
                            list(rel.values()))),
                        "loss_abs_err": abs(float(outs[0].reshape(-1)[0])
                                            - float(loss.detach()))}
        del leaves, loss, want
    torch.cuda.synchronize()
    checks = {"params_checked": len(params),
              "tolerance_rel": RNN_GRAD_REL_TOL,
              "loss": float(outs[0].reshape(-1)[0]), **stats}
    log(json.dumps({"rnn_grad_check": checks}))
    if not stats["float32"]["norm_rel_err"] <= RNN_GRAD_REL_TOL:
        fail("step-1 gradient of %s differs from the autograd reference by "
             "%g (relative norm) > %g"
             % (stats["float32"]["worst_param"],
                stats["float32"]["norm_rel_err"], RNN_GRAD_REL_TOL))
    if not stats["tf32_products"]["norm_rel_err"] > RNN_GRAD_REL_TOL:
        fail("TF32 products move the gradients by only %g <= %g: the "
             "tolerance cannot tell float32 from TF32"
             % (stats["tf32_products"]["norm_rel_err"], RNN_GRAD_REL_TOL))
    return checks


def _rnn_share(prof, kernel):
    """Device time by kind over a profile: the fused recurrence kernel,
    GEMMs (the fc projections, the backward's recompute, dh and dW
    products) and the rest (elementwise gate arithmetic of the backward
    loop, the pads and scatters, Adam); and, across those kinds, the
    device time spent inside the plain backward loop (its
    ``record_function`` range, whose own device-side span is left
    out)."""
    kinds = {"rnn_kernel": 0.0, "gemm": 0.0, "other": 0.0}
    loop_ms = 0.0
    for e in prof.key_averages():
        if e.key == RNN_BWD_RANGE:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                t = getattr(e, "device_time_total", None)
                loop_ms += (e.cuda_time_total if t is None else t) / 1e3
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        k = e.key.lower()
        if kernel in k:
            kinds["rnn_kernel"] += t
        elif any(s in k for s in ("gemm", "cutlass", "gemv")):
            kinds["gemm"] += t
        else:
            kinds["other"] += t
    busy = sum(kinds.values())
    out = {k: {"ms": v, "share": v / busy if busy else 0.0}
           for k, v in kinds.items()}
    out["plain_backward_loop"] = {"ms": loop_ms,
                                  "share": loop_ms / busy if busy else 0.0}
    return out


def phase_rnn(dev, cell):
    """``configs/text_rnn.model`` at ``benchmark/rnn_bench.py``'s widths
    (vocab 30000, hidden 512, 100 words, batch 64, 2 layers, the second
    reversed, Adam 0.002, float32) with ``cell``: step-1 gradients
    against the plain reference, RNN_STEPS steps on one fixed batch
    through Trainer.train, then two profiled steps."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import text_rnn
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.kernels import fused_gru, fused_lstm
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    t0 = time.monotonic()
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = text_rnn.model(cell=cell, samples=RNN_BENCH["batch"],
                              **RNN_BENCH)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    build_s = time.monotonic() - t0
    n_ops = len(main_prog.global_block().ops)
    # the config's first batch is rnn_bench's: RandomState(0) word ids
    batch = next(iter(spec["reader"]()))

    def fixed(n):
        return lambda: (batch for _ in range(n))

    with scope_guard(Scope()):
        t0 = time.monotonic()
        trainer._maybe_init()
        torch.cuda.synchronize()
        startup_s = time.monotonic() - t0
        n_params = sum(global_scope().find_var(v.name).numel()
                       for v in main_prog.all_parameters() if v.trainable)
        checks = _rnn_grad_check(trainer, spec, trainer.feeder.feed(batch))
        torch.cuda.empty_cache()
        losses, step_s, marks = [], [], {}

        def handler(e):
            if isinstance(e, BeginIteration):
                marks["t"] = time.monotonic()
            elif isinstance(e, EndIteration):
                step_s.append(time.monotonic() - marks["t"])
                losses.append(e.cost)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.monotonic()
        trainer.train(fixed(RNN_STEPS), num_passes=1, event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        # per RNN layer a step: the forward, and its replay in the generic
        # grad, which the plain backward loop then differentiates
        want = dict(_no_launches(), **{
            "fused_" + cell: 2 * RNN_BENCH["layers"] * steps})
        log(json.dumps({"rnn_%s_losses" % cell: losses,
                        "launches": launches}))
        if steps != RNN_STEPS or launches != want:
            fail("rnn %s launch counts %s over %d steps, expected %s"
                 % (cell, launches, steps, want))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail("the %s text classifier's loss did not fall on the fixed "
                 "batch: %s" % (cell, losses))
        mod = fused_lstm if cell == "lstm" else fused_gru
        bwd_name = "fused_%s_bwd" % cell
        plain_bwd = getattr(mod, bwd_name)

        def marked_bwd(*a):
            with record_function(RNN_BWD_RANGE):
                return plain_bwd(*a)

        setattr(mod, bwd_name, marked_bwd)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.monotonic()
                trainer.train(fixed(2), num_passes=1)
                torch.cuda.synchronize()
                prof_wall = time.monotonic() - t1
        finally:
            setattr(mod, bwd_name, plain_bwd)
        profile_window = _device_kernels(prof, prof_wall,
                                         ranges=(RNN_BWD_RANGE,))
        profile_window["steps"] = 2
        profile_window["by_kind"] = _rnn_share(prof, "fused_%s_kernel" % cell)
        profile_window["host_share"] = 1.0 - profile_window[
            "device_busy_share"]
    p50 = float(np.median(step_s))
    tokens = RNN_BENCH["batch"] * RNN_BENCH["seq_len"]
    log(json.dumps({"rnn_train_" + cell: {
        "config": dict(RNN_BENCH, cell=cell, dtype="float32",
                       optimizer="adam", use_peepholes=False,
                       lstm_impl="pallas",
                       data="one fixed batch, RandomState(0) randint "
                            "(benchmark/rnn_bench.py)"),
        "params": n_params, "program_ops": n_ops, "build_s": build_s,
        "startup_s": startup_s, "grad_check": checks, "losses": losses,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50, "wall_s": wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "profile": profile_window}}))
    log("rnn_%s_train_tokens_per_sec %.3f (batch %d x %d words, step p50 "
        "%.3f ms)" % (cell, tokens / p50, RNN_BENCH["batch"],
                      RNN_BENCH["seq_len"], p50 * 1e3))
    del trainer
    torch.cuda.empty_cache()
    return launches


# -- phase 8 -----------------------------------------------------------------

def _mm_inputs(shape, seed, dev):
    M, K, N = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(K, N) * 0.1).astype(np.float32)).to(dev)
    return x, w


def _mm_config(tiling):
    return dict(zip(("block_m", "block_n", "block_k"), tiling))


def _matmul_kernel_check(dev):
    """The matmul kernel against its plain version at every compiled
    tiling, at the LM step's three gemm shapes and a ragged one, with the
    kernel (every tiling), plain, library and bound times at the step's
    shapes. Returns {shape: record}."""
    from paddle_tpu_torch.kernels import matmul as mm
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    per_shape = {}
    for i, shape in enumerate(MM_SHAPES + [MM_RAGGED_SHAPE]):
        M, K, N = shape
        x, w = _mm_inputs(shape, 30 + i, dev)
        plain = mm.matmul_reference(x, w)
        tf32 = torch.matmul(_tf32_round(x), _tf32_round(w))
        rec = {"max_rel_err": {}, "max_abs_err": 0.0, "ms": {},
               "tf32_inputs_rel_err": _rel_err([tf32], [plain])}
        for t in mm.TILINGS:
            cfg = _mm_config(t)
            got = mm.matmul(x, w, config=cfg)
            want = mm.matmul_reference(x, w, cfg)
            torch.cuda.synchronize()
            rec["max_rel_err"]["%dx%dx%d" % t] = _rel_err([got], [want])
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     float((got - want).abs().max()))
            if shape in MM_SHAPES:
                rec["ms"]["%dx%dx%d" % t] = time_ms(
                    lambda: mm._launch(x, w, t), flush=flush)
        worst = max(rec["max_rel_err"].values())
        log(json.dumps({"matmul_check": {
            "shape": shape, "max_rel_err_all_tilings": worst,
            "tf32_inputs_rel_err": rec["tf32_inputs_rel_err"]}}))
        if not worst <= MM_REL_TOL:
            fail("matmul disagrees with its plain version at %s: %s > %g"
                 % (shape, rec["max_rel_err"], MM_REL_TOL))
        if not rec["tf32_inputs_rel_err"] > MM_REL_TOL:
            fail("a TF32 product errs by only %g <= MM_REL_TOL %g: the "
                 "tolerance cannot tell float32 from TF32"
                 % (rec["tf32_inputs_rel_err"], MM_REL_TOL))
        if shape in MM_SHAPES:
            work = (4 * (M * K + K * N + M * N), 2 * M * N * K)
            b_ms, b_by = bound(*work)
            rec.update({
                "plain_ms": time_ms(lambda: mm.matmul_reference(x, w),
                                    flush=flush),
                "library_ms": time_ms(lambda: torch.matmul(x, w),
                                      flush=flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "tc_bound_ms": tc_bound(*work)})
        per_shape["x".join(str(d) for d in shape)] = rec
        del x, w, plain, tf32
    del flush
    torch.cuda.empty_cache()
    log(json.dumps({"matmul_times": {
        k: {f: r[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
        for k, r in per_shape.items() if "plain_ms" in r}}))
    return per_shape


def _tune_race(root, work):
    """``python -m paddle_tpu_torch tune`` on a config at GPT-2-small
    widths with the wall timer, against an empty cache of its own. Exit
    0; returns the evidence rows (one per population, every candidate's
    seconds)."""
    cfg_path = os.path.join(work, "tune_gpt2_small.py")
    with open(cfg_path, "w") as f:
        f.write(
            "from paddle_tpu_torch.configs import tiny_lm\n\n\n"
            "def model():\n"
            "    return tiny_lm.model(vocab=%d, seq=%d, hidden=%d, "
            "num_layers=%d,\n"
            "                         num_heads=%d, ffn_mult=%d, batch=%d)\n"
            % (GPT2_SMALL["vocab_size"], GPT2_SMALL["max_seq"],
               GPT2_SMALL["hidden"], GPT2_SMALL["num_layers"],
               GPT2_SMALL["num_heads"], GPT2_SMALL["ffn_mult"], TRAIN_BATCH))
    race_dir = _fresh_dir(os.path.join(work, "tune_race"))
    evidence = os.path.join(work, "tune_race.json")
    env = dict(os.environ, PADDLE_TPU_FLAG_TUNE_CACHE_DIR=race_dir,
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "tune", cfg_path,
           "--timer", "wall", "--batch", str(TRAIN_BATCH), "--device",
           "cuda", "--out", evidence]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log("tune| " + line)
    if proc.returncode != 0:
        fail("the tune race exited %d:\n%s" % (proc.returncode,
                                               proc.stderr[-4000:]))
    with open(evidence) as f:
        rows = json.load(f)["rows"]
    table = []
    for row in rows:
        ms = {("xla" if r["config"].get("use") == "xla" else
               "%(block_m)dx%(block_n)dx%(block_k)d" % r["config"]):
              (None if r["seconds"] is None else r["seconds"] * 1e3)
              for r in row["records"]}
        table.append({"sig": row["sig"], "winner": row["winner"],
                      "stock_ms": ms.pop("xla"), "tiling_ms": ms,
                      "failed": row["failed"]})
    log(json.dumps({"tune_race": {"seconds": time.monotonic() - t0,
                                  "cache_dir": race_dir,
                                  "winners": table}}))
    if len(rows) != len(MM_SHAPES):
        fail("the tune race found %d populations, expected the %d gemm "
             "shapes of the LM step" % (len(rows), len(MM_SHAPES)))
    bad = [(row["sig"], r["config"], r["status"], r["note"])
           for row in rows for r in row["records"] if r["status"] != "ok"]
    if bad:
        fail("the tune race skipped %d candidate(s): %s" % (len(bad), bad))
    return rows


def _fresh_dir(path):
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _seed_kernel_cache(rows, cache_dir):
    """A winner cache whose entry for each gemm population is the fastest
    kernel tiling of the race (the stock rung left out), written through
    WinnerCache.put. Returns {signature: tiling}."""
    from paddle_tpu_torch import tune
    cache = tune.WinnerCache(cache_dir)
    picked = {}
    for row in rows:
        ok = [r for r in row["records"] if r["status"] == "ok"
              and r["config"].get("use") != "xla"]
        if not ok:
            fail("no kernel tiling passed the race's parity gate at %s"
                 % row["sig"])
        best = min(ok, key=lambda r: r["seconds"])
        cache.put(tune.cache_key(tune.device_kind(), "matmul", row["sig"]),
                  best["config"], time_ms=best["seconds"] * 1e3,
                  timer="wall", meta={"kernel": "matmul", "sig": row["sig"],
                                      "device": tune.device_kind()})
        picked[row["sig"]] = dict(best["config"])
    return picked


def _conv_consult(dev, cache_dir):
    """One ResNet-50 step (224 x 224, batch R50_BATCH, conv_impl=conv, so
    a miss runs cuDNN) against a cache that says stock for the first
    stage's 3x3 population and {} (the kernel) for the second's: the
    kernel must run forward and dx exactly for the second stage's convs."""
    from paddle_tpu_torch import kernels, tune
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.trainer import EndIteration, Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = resnet_cifar.model(variant="imagenet", depth=50, image=224,
                                  class_dim=1000, batch=R50_BATCH,
                                  learning_rate=R50_LR, conv_impl="conv")
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    keys = [dict(zip("nhwco", s), dtype="float32")
            for s in R50_CONV_SHAPES[:2]]
    cache = tune.WinnerCache(cache_dir)
    for key, cfg in zip(keys, (tune.XLA_CONFIG, {})):
        cache.put(tune.cache_key(tune.device_kind(), "conv3x3",
                                 tune.signature(key)), cfg)
    # the program's convs at the second stage's 3x3 shape
    kernel_convs = sum(
        1 for op in main_prog.global_block().ops if op.type == "conv2d"
        and tuple(main_prog.global_block().var(
            op.input("Filter")[0]).shape) == (128, 128, 3, 3)
        and list(op.attr("strides")) == [1, 1])
    stock_convs = sum(
        1 for op in main_prog.global_block().ops if op.type == "conv2d"
        and tuple(main_prog.global_block().var(
            op.input("Filter")[0]).shape) == (64, 64, 3, 3))
    rng = np.random.RandomState(0)
    batch = list(zip(rng.rand(R50_BATCH, 3, 224, 224).astype(np.float32),
                     rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)))
    old_dir = FLAGS.tune_cache_dir
    FLAGS.tune_cache_dir = cache_dir
    tune.clear_memory_cache()
    losses = []
    try:
        with scope_guard(Scope()):
            trainer._maybe_init()
            kernels.reset_launches()
            tune.reset_counters()
            trainer.train(lambda: iter([batch]), num_passes=1,
                          event_handler=lambda e: losses.append(e.cost)
                          if isinstance(e, EndIteration) else None)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            stats = {k: trainer.exe.stats[k] for k in
                     ("tune_hits", "tune_misses", "tune_fallbacks")}
    finally:
        FLAGS.tune_cache_dir = old_dir
        tune.clear_memory_cache()
    rec = {"seeded": {tune.signature(k): c for k, c in
                      zip(keys, (tune.XLA_CONFIG, {}))},
           "kernel_seeded_convs": kernel_convs,
           "stock_seeded_convs": stock_convs, "tune": stats,
           "launches": launches, "losses": losses}
    log(json.dumps({"conv3x3_consult": rec}))
    want = dict(_no_launches(), conv3x3_fwd=kernel_convs,
                conv3x3_dx=kernel_convs)
    if not (kernel_convs == 4 and stock_convs == 3 and launches == want):
        fail("conv3x3 consult: launches %s, expected %s" % (launches, want))
    # forward and grad ask the cache for each seeded conv
    if stats["tune_hits"] != 2 * (kernel_convs + stock_convs) \
            or stats["tune_misses"] != 0:
        fail("conv3x3 consult: tune counters %s, expected %d hits and no "
             "miss" % (stats, 2 * (kernel_convs + stock_convs)))
    if not (len(losses) == 1 and np.isfinite(losses[0])):
        fail("conv3x3 consult: the step's loss is %s" % losses)
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_tune(dev, root, train5):
    """The autotune path: the matmul kernel against its plain version,
    the wall-clock race of the tune verb, 8 Adam steps of GPT-2 small
    against a cache of the race's fastest kernel tilings (held against
    phase 5's losses), and the conv3x3 consult on ResNet-50."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    before = tune.counters()
    log(json.dumps({"tune_counters_phases_1_to_7": before}))
    if before["tune_hits"] != 0:
        fail("phases 1-7 hit the tune cache %d times: a stray winner "
             "rerouted them" % before["tune_hits"])
    work = os.path.join(root, "build", "chip_smoke")
    per_shape = _matmul_kernel_check(dev)
    rows = _tune_race(root, work)
    picked = _seed_kernel_cache(
        rows, _fresh_dir(os.path.join(work, "tune_kernel_tilings")))
    log(json.dumps({"tune_kernel_cache": picked}))
    FLAGS.tune_cache_dir = os.path.join(work, "tune_kernel_tilings")
    tune.clear_memory_cache()
    L = GPT2_SMALL["num_layers"]
    per_layer = sum(MM_COUNTS)
    try:
        rec = _lm_train(dev, "tuned_train", want_matmul=per_layer * L,
                        grad_tol=TUNED_GRAD_REL_TOL)
    finally:
        FLAGS.tune_cache_dir = TUNE_EMPTY_DIR
        tune.clear_memory_cache()
    steps = len(rec["losses"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(rec["losses"], train5["losses"]))
    rec.update({
        "kernel_cache": picked,
        "phase5_losses": train5["losses"],
        "losses_max_rel_err_vs_phase5": loss_rel,
        "loss_tolerance_rel": LOSS_REL_TOL,
        "phase5_step_ms_p50": train5["step_ms_p50"],
        "phase5_tokens_per_s": train5["tokens_per_s"],
        "phase5_peak_memory_bytes": train5["peak_memory_bytes"]})
    log(json.dumps({"tuned_train": rec}))
    if rec["tune"] != {"tune_hits": per_layer * L * steps, "tune_misses": 0,
                       "tune_fallbacks": steps}:
        fail("tuned train tune counters %s over %d steps, expected %d hits "
             "and 1 fallback a step" % (rec["tune"], steps, per_layer * L))
    if not loss_rel <= LOSS_REL_TOL:
        fail("tuned train losses differ from phase 5's by %g > %g"
             % (loss_rel, LOSS_REL_TOL))
    consult = _conv_consult(dev, _fresh_dir(os.path.join(
        work, "tune_conv_consult")))
    # the kernels line's row: timed at the tilings the tuned run used,
    # the mean over a step's 72 launches
    weights = {}
    for shape, n in zip(MM_SHAPES, MM_COUNTS):
        key = {"m": shape[0], "k": shape[1], "n": shape[2],
               "dtype": "float32"}
        t = picked[tune.signature(key)]
        weights["x".join(str(d) for d in shape)] = (
            n, "%(block_m)dx%(block_n)dx%(block_k)d" % t)

    def per_launch(f):
        return sum(f(per_shape[k], tag) * n
                   for k, (n, tag) in weights.items()) / per_layer

    entry = {
        "name": "matmul", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/matmul.cu",
        "replaces": "paddle_tpu/kernels/matmul.py:91",
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "max_rel_err": max(max(r["max_rel_err"].values())
                           for r in per_shape.values()),
        "tolerance_rel": MM_REL_TOL,
        "tf32_inputs_min_rel_err": min(r["tf32_inputs_rel_err"]
                                       for r in per_shape.values()),
        "ms": per_launch(lambda r, t: r["ms"][t]),
        "plain_ms": per_launch(lambda r, t: r["plain_ms"]),
        "bound_ms": per_launch(lambda r, t: r["bound_ms"]),
        "tc_bound_ms": per_launch(lambda r, t: r["tc_bound_ms"]),
        "bound_by": "operations",
        "library_ms": per_launch(lambda r, t: r["library_ms"]),
        "library": "torch.matmul (cuBLAS), TF32 off",
        "timed_as": "mean over a GPT-2-small step's 72 launches (48 at "
                    "8192x768x768, 12 each at 8192x768x3072 and "
                    "8192x3072x768), each at the tiling the tuned run "
                    "used",
        "tilings_used": {k: t for k, (_, t) in weights.items()},
        "per_shape": per_shape}
    return {"matmul": entry}, rec["launches"], consult


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "matmul.allow_tf32":
                        torch.backends.cuda.matmul.allow_tf32,
                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}))
    card = card_line()
    log(card)
    t_start = time.monotonic()

    def timed(num, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        log(json.dumps({"phase": num,
                        "seconds": round(time.monotonic() - t0, 3)}))
        return out

    root = os.path.dirname(os.path.abspath(__file__))
    art_dir = os.path.join(root, "build", "chip_smoke", "gpt2_small_seed0")
    from paddle_tpu_torch.flags import FLAGS
    FLAGS.tune_cache_dir = _fresh_dir(TUNE_EMPTY_DIR)
    log(json.dumps({"tune_cache_dir": FLAGS.tune_cache_dir,
                    "tune": FLAGS.tune}))
    timed(1, phase_build)
    kernels = timed(2, phase_kernels, dev)
    prompts, results, serve_launches = timed(3, phase_engine, dev, art_dir)
    timed(4, phase_http, dev, art_dir, prompts, results)
    train5 = timed(5, phase_train, dev, os.path.join(
        root, "build", "chip_smoke", "gpt2_small_trained"))
    conv_kernels, convnet_launches = timed(
        6, lambda: (_conv3x3_kernel_check(dev), phase_convnet(dev)))
    kernels.update(conv_kernels)
    rnn_kernels, lstm_launches, gru_launches = timed(
        7, lambda: (_rnn_kernel_check(dev), phase_rnn(dev, "lstm"),
                    phase_rnn(dev, "gru")))
    kernels.update(rnn_kernels)
    mm_kernels, tuned_launches, consult_launches = timed(
        8, phase_tune, dev, root, train5)
    kernels.update(mm_kernels)
    log(json.dumps({"seconds": round(time.monotonic() - t_start, 3)}))
    paths = {"serve": serve_launches, "train": train5["launches"],
             "convnet_train": convnet_launches,
             "rnn_train_lstm": lstm_launches,
             "rnn_train_gru": gru_launches,
             "tuned_train": tuned_launches,
             "convnet_conv3x3_consult": consult_launches}
    for name, entry in kernels.items():
        # each main path is read with the counts set to 0 just before it
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["launches"] == 0:
            fail("kernel %s was launched on no main path" % name)
        entry["kernel_ms"] = entry["ms"]
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
