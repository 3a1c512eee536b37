#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch on one NVIDIA card (an H100).

Drives the port's generative serving path (plain, speculative,
prefix-shared and disaggregated) and its Fluid training path
at the widths of GPT-2 small, its conv-net training path on ImageNet
ResNet-50, its sequence training path on the stacked-RNN text
classifier of ``benchmark/rnn_bench.py``, its autotune path (the
``tune`` verb, the winner cache, the tuned dispatch of ``mul`` and
``conv2d``) and AMP (bfloat16) training of ResNet-50 and the LM, and
holds each hand-written CUDA kernel against its plain PyTorch version;
and pure-AMP training of the bias-free LSTM classifier. Run from the
root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:

1. build: compile every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, all started together);
2. kernels: each kernel against its plain version on the card, at the
   shapes the main path gives it, with the time of the kernel, of the
   plain version and of one PyTorch library call computing the same
   function, and the least time the card could take (in float32 on the
   CUDA cores, and in 3xTF32 on the tensor cores); the paged attention
   also at R 1 and 4 (every row at the last column; kernel, device
   (profiled), bound and library times at R 1, 4 and 16 in its entry's
   ``by_R``) and at its edges (``PAGED_EDGE_SHAPES``: dh 32 and 128, T
   24, one split, positions past the table), each launched twice (the
   second launch bit-identical) and its split count held to the mirror
   (``paged_attention.splits``); its k-wide face
   (``paged_attention_kwide``) at phase 10's verify shape, 16 rows of
   ``SPEC_K`` + 1 lanes at phase 3's prompt lengths plus 0 .. ``SPEC_K``
   (one launch on the lanes flattened onto 80 rows, each row's table
   repeated), held to its plain version in the same way and timed beside
   it and a gather + SDPA, its bound from the pages that shape reads
   (the entry's ``kwide``);
   the flash forward and backward also at the templates of D 32
   (non-causal) and D 128 (causal), a second launch of each of their
   kernels must equal the first bit for bit, and their TF32-rounded
   counterparts must miss the tolerance; the forward is timed at the
   prefill's batch (1) and the LM step's (8), where it is also held
   against the plain forward and relaunched, with registers, spills and
   shared memory of every template; the backward's cases first hold the
   forward's o and lse at B 8;
3. engine: export random GPT-2-small-wide weights (seed 0) as a
   generative artifact, load them onto the card, and serve 16 greedy
   requests (prompts of 16 to 900 tokens, 32 new tokens each) through
   the continuous-batching engine; the launch counters must show that
   every prefill and decode step went through the kernels, and two
   requests' logits, step by step, must agree with the plain
   full-sequence forward; a profiled repeat reports device time by
   kernel and the paged attention kernels' share;
4. http: serve the same artifact on port 0 in-process, POST ``:generate``
   twice (tokens must equal the engine's), then raise SIGTERM while a
   third request is in flight: the server must drain it and answer;
5. train: build ``transformer_lm`` + softmax-CE + Adam at GPT-2-small
   widths with the port's layers DSL (``configs/tiny_lm.model``), run
   the startup program, hold step 1's ``@GRAD`` vars of every parameter
   against ``torch.autograd`` through the plain functional forward run
   in float64 (and log it in float32, and show that a TF32 attention
   misses the tolerance), train 8 Adam steps
   of 8 x 1024 synthetic tokens through ``Trainer.train`` (the loss must
   fall; the launch counters must equal 2 forward and 1 dK/dV and dQ
   launch a layer a step), profile two more steps, then export the
   trained scope, load it and serve two greedy requests whose tokens
   must be the plain forward's argmax;
6. convnet: hold the conv3x3 kernel (forward, and dx on the rotated
   filter) against its plain version at ResNet-50's four 3x3 stage
   shapes (batch 32) and at edge shapes that reach each tiling and each
   tail (``CONV_EDGE_SHAPES``), each launched twice (the second launch
   bit-identical), the tiling the kernel took recorded and held to the
   rule's mirror (``conv3x3.tiling``), with kernel, plain and cuDNN times
   at the stage shapes; build ImageNet ResNet-50 (224 x 224, 1000 classes, float32,
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
   must miss the tolerance), both also at their edges
   (``RNN_EDGE_SHAPES``: N 65, D 36, T 400, D 1024 (W split at each
   load), pieces of rows (N 64 at D 1024, N 160 at D 512), two unit
   groups a block at D 1152, 1280, 1320 and 1536), each launched twice
   at each shape (the second launch bit-identical), with kernel, plain
   and (LSTM) cuDNN times, the cost of a step (T 10 against T 100, N 8
   against N 64), the registers of each kernel form, shared memory and
   blocks; then train
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
   product must miss the tolerance; a second launch must equal the first
   bit for bit), with every tiling's, the plain version's and
   ``torch.matmul``'s times and every template's registers, spills and
   shared memory; run ``python -m paddle_tpu_torch tune`` on phase 5's
   config with the wall timer against an empty cache of its own (exit
   0), print its table of the stock rung's and each tiling's times and
   which rung it cached at each population, by what margin; hold step
   1's gradients at each of the 12 tilings (one cache a tiling, 72
   matmul launches each) against the float64 reference; write a
   cache whose winner for each gemm population is the race's fastest
   kernel tiling (whatever the race cached) and train phase 5's 8 Adam
   steps against it: step-1 gradients against the plain
   reference, exactly 72 matmul launches and 72 tune hits and 1 fallback
   a step, the losses within 1e-3 of phase 5's, and two profiled steps;
   then one ResNet-50 step against a cache that says stock for the first
   stage's 3x3 population and the kernel for the second's
   (``conv_impl=conv``): the conv3x3 kernel runs forward and dx for
   exactly the second stage's 4 convs;
9. amp: hold the bfloat16 faces of the conv3x3 kernel (its TMA-fed
   wgmma implicit GEMM and its ragged path, forward with a bfloat16 and
   a float32 output, and dx, at ResNet-50's stage shapes and
   ``CONV_EDGE_SHAPES``, each launch counted on the path its shape
   takes, the paths and tilings held to the mirror, the face's parent
   design timed beside it at the stage shapes, every template's
   registers and spills (none allowed) and the host microseconds of its
   two TMA maps) and of the matmul kernel (its TMA-fed wgmma kernel at every tiling at the LM's
   three gemm shapes, its ragged path at ``MM_RAGGED_SHAPE``, both
   outputs, each launch counted on the path its shape takes) against
   their plain versions within one bfloat16 ulp (float32 out:
   ``AMP_F32_REL_TOL``), each relaunched bit-identically, a plain
   variant that sums in bfloat16 shown to miss, with kernel, plain,
   library (on bfloat16) and bfloat16-bound times, the matmul face's
   registers and spills (none allowed) and the host microseconds its
   two TMA maps add to a launch;
   hold the bfloat16 faces of the flash forward, dK/dV and dQ kernels
   against their plain versions at ``FLASH_BF16_CASES`` (the LM step's
   shape, the prefill's, D 32 non-causal and D 128 causal) within one
   ulp element by element (lse at KERNEL_TOL), the elements that differ
   counted, each relaunched bit-identically, a forward with bfloat16
   scores shown to miss and faces that round p and ds to one bfloat16
   measured, with kernel, plain, SDPA (on bfloat16) and bfloat16-bound
   times at B 8 and B 1 and every template's registers, spills and
   shared memory; train ResNet-50 as phase 6 does under plain AMP
   (step-1 gradients against a plain reference rounded as AMP rounds,
   the unrounded one measured beside it; exactly 16 forward and 16 dx
   launches a step of the bfloat16 face's wgmma kernel, none of its
   ragged path, the kernel's symbol in the profile) and under pure AMP (conv and batch-norm
   outputs fetched as bfloat16, parameters float32), images/s beside
   phase 6's; train phase 5's LM under plain AMP and under pure AMP
   against a cache of the matmul face's fastest tilings: step 1 held op
   by op (every mul, and under pure AMP every flash_attention and its
   generic grad, on the step's own tensors; the end-to-end gradients
   against float64 references reported), exactly 72 launches a step of
   the bfloat16 matmul's wgmma kernel and none of its ragged path, and
   under pure AMP 24 bfloat16 flash forward, 12
   dK/dV and 12 dQ launches a step and no float32 flash launch, the loss
   falling; tokens/s, step p50 and device time of both beside phase 8's
   tuned float32 run; hold the fused LSTM's bfloat16 face (bfloat16 xs,
   h0, c0, hs and cs, float32 w and mask) against the plain recurrence
   at phase 7's shapes and ``RNN_EDGE_SHAPES`` within one ulp of each
   element's own magnitude, each relaunched bit-identically, a
   recurrence carrying h and c in bfloat16 shown to miss, with the
   face's, the cast-around yardstick's (widen, the float32 face, round),
   the plain version's and cuDNN's LSTM on bfloat16 times and the bound;
   train phase 7's LSTM classifier without biases (``bias=False``) under
   pure AMP: step 1 held op by op (every mul, and every lstm's Hidden
   and Cell against the plain recurrence on the op's own inputs, the
   bfloat16-state recurrence shown to miss), exactly 2 launches of the
   bfloat16 face per layer a step and no float32 LSTM launch, the loss
   falling; tokens/s, step p50 and device time beside phase 7's float32
   LSTM run;
10. speculative: export phase 3's weights as two speculative pairings at
   ``SPEC_K`` 4 (``export_speculative``): a self-draft, and a draft of
   the same weights plus seeded noise at the first of
   ``DRAFT_NOISE_SCALES`` whose greedy agreement with the target is at
   most ``DRAFT_AGREE_MAX`` (printed); serve phase 3's 16 greedy prompts
   through each (``load_speculative``, the engine's rounds: the draft's
   propose steps and the target's verify step through the paged kernel,
   the prefills of both through the flash forward), then 4 tempered
   requests twice: the greedy tokens must equal phase 3's, unless a
   request diverges where the plain step's top-two logit margin is
   within ``LOGIT_TOL`` (each divergence printed with that margin); the
   self-draft's greedy drafts all accepted but for at most ``SPEC_K``
   for each plain step with such a margin (the bound printed beside the
   count), the perturbed draft's acceptance strictly between 0 and 1; the tempered repeats identical;
   exactly L paged launches at 80 rows and (k + 1) x L at 16 rows a
   round and no other, (L + L) flash launches a prefill, no
   ``speculation_degraded`` or ``prefix_degraded`` event; then 8 greedy
   requests sharing a 512-token prefix (tails of 16 to 64), queued
   before admission, with prefix sharing off and on: tokens identical,
   prefix hits, a lower peak of live pages; tokens/s, inter-token p50
   and acceptance of each engine beside phase 3's plain engine;
11. disaggregated: two ``InferenceService``s in this process,
   ``tier="prefill"`` and ``tier="decode"``, each behind its own server
   at phase 3's geometry; POST phase 3's 16 prompts to ``:prefill`` (32
   new tokens, greedy), then all 16 artifacts at once to ``:decode``:
   the prefill tier launches exactly L x 16 flash forwards and no paged
   attention, the decode tier L paged launches a decode step and no
   flash forward, 16 handoff installs and no prefill, no
   ``handoff_failed`` event, the tokens phase 3's (a divergence only
   where the plain step's top-two margin is within ``LOGIT_TOL``), and
   the longest request's installed pages, read back through its block
   table, the artifact's bytes exactly; 4 tempered requests with
   distinct seeds through both hops equal to the same 4 through the
   decode tier's ``:generate``; ``serving.ship`` armed for 2 handoffs
   (``decode_handoff`` in process): 2 ``handoff_failed`` events, 2
   prefills and L x 2 flash forwards on the decode tier, the tokens
   phase 3's; ``python -m paddle_tpu_torch serve --tier prefill`` as a
   subprocess: its readiness line and ``/statz`` say the tier, one
   ``:prefill`` answer decodes in this process's decode tier to phase
   3's tokens, SIGTERM exits 0; PT034: the artifact validates against
   the card's memory and fails at a 0.5 GB budget. It prints the
   artifacts' bytes, the ms of each hop's pieces and the two-hop TTFT
   beside the single-hop one, and the decode tier's tokens/s;
12. compiled: the Executor's compiled step (a step captured as a CUDA
   graph and replayed) against its per-op path, each from one saved
   state, ``COMPILED_STEPS`` steps of each then ``PROFILE_STEPS``
   profiled ones, on the LM at GPT-2 small's widths in float32 (also
   ``repeat=REPEAT_K`` against as many single runs, the state bit for
   bit) and under pure AMP, ResNet-50 at 224 x 224, batch 32 (cuDNN's
   algorithms deterministic in both runs: two eager steps with its
   default ones differ, and the first op output that differs is
   printed), and the text classifier at rnn_bench widths with LSTM and
   with GRU cells: the losses and the state after the steps bit-identical
   to the eager run's, one capture, a replay a step from the capture on,
   no eager fallback, every launch count equal to the eager run's; the
   captured graph's kernel nodes of each symbol, read from the driver,
   equal to the launches its wrappers add a replay (so the counts a
   replay adds are what the card launches; the profiler's counts of
   each symbol in both modes are printed, as it misses a record now and
   then); ragged LSTM batches of
   ``RAGGED_LENS`` longest sequences, each a key of its own, run twice
   then once more in turn, compiled against eager: losses bit-identical,
   one capture and two replays a key, the graphs in one shared pool,
   step time, peak memory and the pool's bytes after each run printed;
   printed beside the eager run, not gated: step p50 by CUDA events,
   device busy share and device ms by kind over the profiled steps,
   peak memory, the tune consults; the pipelined Trainer (depth
   ``PIPE_DEPTH``, ``PIPE_BATCHES`` batches) on the LSTM classifier
   bit-identical to the synchronous one, its feed wait printed; a
   program with a ``save`` between two device segments on the hybrid
   path (both captured, the file the eager run's); a test-only op that
   reads a value to the host: its capture fails with a warning, the run
   is right, and the next program captures.

Phases 5-9 train through ``Trainer.train``, which runs the compiled
path: each holds its steps to one capture and a replay a step, and the
tune consults of phases 8 and 9 to the steps that ran their lowerings
(the warm-up and the capture). Their windows that patch a wrapper or
mark a Python range (phase 7's backward loop, phase 9's parent faces)
and phase 8's tiling sweep run on the per-op path.

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
import collections
import ctypes
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
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
# The paged attention kernel timed at R 1, 4 and 16 rows (phase 2): one
# user's long context, a small batch, and the engine's full batch of the
# serving drive
PAGED_BY_R = (1, 4, 16)
# and held at its edges (R, MB, T, nh, dh, positions of rows 2..; row 0
# is inactive, row 1 at position 0): the other head dims, T 24 (splits
# end inside pages), MB * T below 64 (one split a row), positions at and
# past the table's width
PAGED_EDGE_SHAPES = [
    (8, 32, 16, 12, 32, (15, 16, 511, 63, 64, 300)),
    (8, 32, 16, 12, 128, (15, 16, 511, 63, 64, 300)),
    (8, 20, 24, 12, 64, (23, 24, 479, 71, 64, 200)),
    (8, 3, 16, 12, 64, (15, 16, 47, 30, 1, 2)),
    (6, 8, 16, 12, 64, (127, 128, 1000, 2 ** 30)),
]
# Logits of the kernel path (prefill and decode steps) against the plain
# full-sequence forward: the same sum-order differences carried through
# 12 layers. A forward whose attention inputs are rounded to TF32 (what a
# TF32 kernel computes) is measured in the same run and must miss this
# tolerance, so a kernel run in TF32 or bf16 would fail it.
LOGIT_TOL = 1e-3
# Phase 10 (speculative and prefix-shared serving): the speculation
# depth of both pairings; the perturbed draft's noise, relative to each
# weight array's standard deviation, is the first of these scales whose
# greedy tokens agree with the target's on at most DRAFT_AGREE_MAX of
# two prompts' positions (so that its acceptance lies strictly between 0
# and 1); 4 tempered requests (prompts, seeds), each served twice
SPEC_K = 4
DRAFT_NOISE_SCALES = (0.05, 0.1, 0.2, 0.4, 0.8, 1.6)
DRAFT_AGREE_MAX = 0.8
SPEC_TEMPERATURE = 0.8
# 8 greedy requests sharing a 512-token prefix (32 pages of 16) with
# distinct tails of 16 to 64 tokens, served with sharing off, then on
PREFIX_TOKENS = 512
PREFIX_TAILS = (16, 23, 30, 37, 44, 51, 58, 64)
# Flash backward kernels against the plain backward, same inputs, both
# float32: max abs error over the largest magnitude of the plain dq, dk
# or dv. Only sum orders differ (~1e-6 relative); the plain backward on
# inputs rounded to TF32 errs by ~1e-3 and is shown to miss it.
BWD_REL_TOL = 2e-5
# the flash forward's cases (S, D, causal) at B 1, H 12: the prefill's
# ragged lengths and S 1024 (timed), and the other head dims' templates
FLASH_FWD_CASES = [(17, 64, True), (128, 64, True), (1024, 64, True),
                   (130, 32, False), (130, 128, True)]
# the flash backward's cases (S, D, causal): the training shape's ragged
# lengths and S 1024 (timed), and the other head dims' templates
FLASH_BWD_CASES = [(17, 64, True), (130, 64, True), (1024, 64, True),
                   (130, 32, False), (130, 128, True)]
# Step-1 gradients of every parameter from the Executor (flash kernels,
# the op lowerings and their grads) against torch.autograd through the
# plain functional forward run in float64: the norm of the difference
# over the norm of that parameter's reference gradient. The float32 run
# sums in other orders through 12 layers and 8192 tokens, and a ReLU
# whose input lies within float32 noise of 0 can open in it and stay
# shut in the exact run, moving one token's whole contribution (so an
# elementwise maximum is no measure). Against a float32 reference, which
# carries the same noise of its own, that read some 1e-3 for the worst
# parameter on the H100; the float32 reference's reading is still
# logged. A reference whose attention inputs are rounded to TF32 moves
# the gradients by 1e-2 and more; it is measured in the same run and
# must miss this tolerance.
GRAD_REL_TOL = 5e-3
# The same check on phase 8's tuned run, whose 72 gemms a step go through
# the matmul kernel, and on each of the 12 tilings: 1e-3.
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
# how many of each a step runs; and edge shapes, each with the tiling its
# forward takes on an H100's 132 SMs (its dx, on the rotated filter,
# swaps C and O)
R50_CONV_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                   (32, 14, 14, 256, 256), (32, 7, 7, 512, 512)]
R50_CONV_COUNTS = [3, 4, 6, 3]
CONV_EDGE_SHAPES = [
    (3, 7, 9, 24, 40),      # 64 x 64; C 24 a short chunk, O 40 a BN tail
    (2, 5, 6, 3, 7),        # 64 x 64; C 3, O 7: the 4-byte copies
    (2, 9, 11, 36, 64),     # 64 x 64; C 36: a chunk of 4 past the first 32
    (2, 7, 7, 512, 512),    # 64 x 64; the deep stage at batch 2
    (4, 95, 97, 64, 40),    # 128 x 64; 36860 pixels (a BM tail), O 40
    (16, 33, 33, 32, 200),  # 128 x 128; 17424 pixels, O 200 (BN tail)
]
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
# and both tensor-core kernels at their edges: a last row group of one
# row (N 65 at D 128: 5 row groups of 16 rows), a partial k8 tile and
# last block of units (D 36), a long chain of 3xTF32 sums (T 400), W split
# at each load (D 1024), pieces of rows, each through all T steps (N 64 at
# D 1024: 32 rows a piece for the GRU, 16 for the LSTM; N 160 at D 512:
# 2 row groups of 64 rows, then 32, for the GRU, of 32 rows a piece for
# the LSTM), and two unit groups a block with W read from global memory
# (D 1152, N 40; D 1280, N 40, the widest multiple of 128 the lstm and
# gru lowerings send to the kernels; D 1320, the widest the LSTM's
# CUDA-core kernel took; D 1536, N 24), in pieces
RNN_EDGE_SHAPES = ((9, 65, 128), (9, 5, 36), (400, 64, 512),
                   (5, 16, 1024), (5, 64, 1024), (3, 160, 512),
                   (4, 40, 1152), (3, 40, 1280), (3, 24, 1320),
                   (3, 24, 1536))
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
# Phase 9 (AMP). The bfloat16 faces of rows 5 and 6 against their plain
# versions (bfloat16 operands, float32 sums, rounded once), same inputs:
# a bfloat16 output within one bfloat16 ulp of the largest magnitude of
# the plain output (2^(floor(log2 max) - 7)): both sum the exact products
# in float32 in other orders, so an output within float32 noise of a
# rounding boundary may land one ulp apart. A plain variant that rounds
# the running sum to bfloat16 after each k step (a tap's 64 channels, or
# a k tile of 64: the wgmma faces' stages) errs by several ulps and is
# shown to miss it. A float32
# output (bfloat16 operands) within AMP_F32_REL_TOL of the largest
# magnitude: the sum orders only.
AMP_F32_REL_TOL = 1e-5
# the peak of the tensor cores in bfloat16, dense (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# Step-1 gradients under AMP, end to end: torch.autograd through a plain
# forward whose gemm and conv operands (and output gradients) are rounded
# to bfloat16 as the port rounds them, and through the unrounded one
# (float64 for the LM, float32 for ResNet-50), both reported as the norm
# of the difference over the reference's. They do not gate: bfloat16
# rounding turns sum-order noise into whole ulps (a value within float32
# noise of a rounding boundary moves 2^-8 in one computation and not in
# the other), and a deep network carries that to the gradients. The
# rounded ResNet-50 reference run in float32 and in float64 differs by a
# median 0.39 per parameter (64 x 64, batch 4, on the CPU); on the card
# the port read a median 0.39 against it and 0.58 against float32.
# The gate is per op, where no noise is carried: every mul and conv2d of
# step 1, forward and grad, on the tensors the step gave it, against the
# same op rounded as AMP rounds, within one bfloat16 ulp of the largest
# magnitude (a bfloat16 value) or AMP_F32_REL_TOL of it (a float32 sum).
# The bfloat16 faces of the flash kernels (rows 2-4) against their plain
# versions (float32 on the bfloat16 values, o, dq, dk and dv rounded
# once): both sum in float32 in other orders, so an output within float32
# noise of a rounding boundary lands one ulp of its own magnitude apart.
# Held so element by element: within one ulp of its own magnitude plus
# BWD_REL_TOL of the largest (the float32 noise of an element near 0),
# and the largest error within one ulp of the largest magnitude. The
# second part alone cannot tell a forward that rounds its scores and
# softmax to bfloat16 (the port's first plain forward on bfloat16) from
# the face: it errs by 0.5-2 ulps of the largest magnitude, but by 35-125
# ulps of the small outputs' own, which the first part catches. lse,
# float32, within KERNEL_TOL (the float32 face's tolerance).
# The faces' shapes (B, S, H, D, causal): the LM step's and the
# prefill's, a length that is no multiple of the forward's 128-row tiles
# in a batch of two (the first batch's last tiles lie across the end of S,
# where the second batch's rows follow), and the other head dims'
# templates (the forward's mma.sync path).
FLASH_BF16_CASES = [(8, 1024, 12, 64, True), (1, 1024, 12, 64, True),
                    (2, 300, 12, 64, False), (2, 130, 12, 32, False),
                    (2, 130, 12, 128, True)]
# The fused LSTM's bfloat16 face (row 7-bf16: bfloat16 xs, h0, c0, hs
# and cs, float32 w and mask) against the plain recurrence, which widens
# the operands and rounds hs and cs once: both carry the state in
# float32, so an element lands at most one ulp of its own magnitude
# apart (plus BWD_REL_TOL of the largest: float32 noise near 0), the
# flash faces' rule. The same recurrence with h and c carried in
# bfloat16 (rounded every step: what staging the rounded hs would give)
# must miss it, at the slice's shape and on the pure-AMP step's own
# tensors.

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


def _device_ms(fn, name, flush, iters=20):
    """Device ms a call of ``fn`` spends in the kernels whose name holds
    ``name``, from torch.profiler over ``iters`` calls, ``flush`` zeroed
    before each as in :func:`time_ms`: the kernels alone, without the
    host's time to reach them, which CUDA events around a short call
    also read."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return _kernel_share(prof, name)["ms"] / iters


def _device_ms_all(fn, flush, iters=20):
    """Device ms a call of ``fn`` spends in all the kernels it launches
    (torch.profiler; the flush's fill kernel left out), ``flush`` zeroed
    before each call: for a library call whose kernels' names are not
    known in advance."""
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

def _paged_inputs(dev, R=16):
    """The decode step's operands at the engine's pool geometry (MB 64
    pages of T 16, nh 12, dh 64; seed 11): at R 16 mixed positions (0, T
    - 1, T, the last column, random) and two inactive rows on the trash
    page; at a smaller R every row at the last column (one user's long
    context, or a verify step)."""
    MB, T, nh, dh = 64, 16, 12, 64
    P = R * MB
    rng = np.random.RandomState(11)
    kp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(R, nh, dh).astype(np.float32))
    tables = rng.permutation(P).reshape(R, MB).astype(np.int32)
    positions = rng.randint(0, MB * T, (R,)).astype(np.int32)
    if R == 16:
        positions[:4] = [0, T - 1, T, MB * T - 1]
        tables[-2:] = P                  # two inactive rows: all trash
        positions[-2:] = 0
    else:
        positions[:] = MB * T - 1
    return [t.to(dev) for t in (q, kp, vp, torch.from_numpy(tables),
                                torch.from_numpy(positions))]


def _paged_edge_inputs(dev, R, MB, T, nh, dh, rest, seed):
    """Operands of one of PAGED_EDGE_SHAPES: row 0 inactive (trash page,
    position 0), row 1 at position 0, the other rows at ``rest``."""
    rng = np.random.RandomState(seed)
    P = R * MB
    kp = rng.randn(P + 1, T, nh, dh).astype(np.float32)
    vp = rng.randn(P + 1, T, nh, dh).astype(np.float32)
    q = rng.randn(R, nh, dh).astype(np.float32)
    tables = rng.permutation(P).reshape(R, MB).astype(np.int32)
    positions = np.array([0, 0] + list(rest), dtype=np.int32)
    tables[0] = P
    return [torch.from_numpy(a).to(dev)
            for a in (q, kp, vp, tables, positions)]


def _paged_check(pa, ops, label):
    """The kernel against its plain version within KERNEL_TOL, a second
    launch bit-identical to the first, and the library's split count the
    mirror's; returns the largest error."""
    q, kp, vp, tables, positions = ops
    MB, T = tables.shape[1], kp.shape[1]
    got = pa.paged_attention(*ops)
    again = pa.paged_attention(*ops)
    want = pa.paged_attention_reference(*ops)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not np.isfinite(err) or err > KERNEL_TOL:
        fail("paged_attention disagrees with its plain version at %s: max "
             "abs err %g > %g" % (label, err, KERNEL_TOL))
    if not torch.equal(got, again):
        fail("paged_attention at %s: a second launch differs from the "
             "first" % label)
    if pa.kernel_splits(MB, T) != pa.splits(MB, T):
        fail("paged_attention at %s: the library cuts a row into %d "
             "splits, the mirror into %d"
             % (label, pa.kernel_splits(MB, T), pa.splits(MB, T)))
    return err


def _paged_bound(q, tables, positions, T):
    """(bytes, flops) the decode attention needs: each attended column's
    K and V row of every head read once, q and out, positions and the
    table entries of the pages attended."""
    R, nh, dh = q.shape
    MB = tables.shape[1]
    last = positions.long().clamp(max=MB * T - 1)
    cols = int((last + 1).sum())
    nbytes = (cols * nh * dh * 2 * 4 + 2 * R * nh * dh * 4 + R * 4
              + int((last // T + 1).sum()) * 4)
    return nbytes, 4 * cols * nh * dh


def _paged_library(q, kp, vp, tables, positions):
    """One library call computing the same function: gather the pages,
    then scaled_dot_product_attention under the column mask."""
    F = torch.nn.functional
    R, nh, dh = q.shape
    C = tables.shape[1] * kp.shape[1]
    colmask = (torch.arange(C, device=q.device)[None, :]
               <= positions.long()[:, None])[:, None, None, :]

    def library():
        kc = kp[tables.long()].reshape(R, C, nh, dh).transpose(1, 2)
        vc = vp[tables.long()].reshape(R, C, nh, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None, :], kc, vc,
                                              attn_mask=colmask)[:, :, 0]
    return library


def _kwide_inputs(dev, K1):
    """The verify step's attention operands at phase 10's first round:
    16 rows at phase 3's prompt lengths (the first draw of its seed-1
    stream), lane i of a row at its length + i, each row on 64 pages of
    its own (T 16, nh 12, dh 64; seed 13)."""
    R, MB, T, nh, dh = 16, 64, 16, 12, 64
    P = R * MB
    lengths = np.random.RandomState(1).randint(16, 901, R)
    rng = np.random.RandomState(13)
    kp = rng.randn(P + 1, T, nh, dh).astype(np.float32)
    vp = rng.randn(P + 1, T, nh, dh).astype(np.float32)
    q = rng.randn(R, K1, nh, dh).astype(np.float32)
    tables = rng.permutation(P).reshape(R, MB).astype(np.int32)
    positions = (lengths[:, None] + np.arange(K1)[None, :]).astype(np.int32)
    return [torch.from_numpy(a).to(dev)
            for a in (q, kp, vp, tables, positions)]


def _kwide_bound(q, tables, positions, T):
    """(bytes, flops) of the k-wide face: the K and V rows of each row's
    columns up to its last lane's position read once (the lanes of a row
    share them), q and out, positions and the table entries of the pages
    those columns lie in; each lane's products over its own columns."""
    R, K1, nh, dh = q.shape
    last = positions.long().clamp(max=tables.shape[1] * T - 1)
    cols = int((last.max(dim=1).values + 1).sum())
    pages = int((last.max(dim=1).values // T + 1).sum())
    nbytes = (cols * nh * dh * 2 * 4 + 2 * R * K1 * nh * dh * 4
              + R * K1 * 4 + pages * 4)
    return nbytes, 4 * int((last + 1).sum()) * nh * dh


def _kwide_library(q, kp, vp, tables, positions):
    """One library call computing the k-wide face: gather each row's
    pages once, then scaled_dot_product_attention of its K1 lanes under
    each lane's column mask."""
    F = torch.nn.functional
    R, K1, nh, dh = q.shape
    C = tables.shape[1] * kp.shape[1]
    colmask = (torch.arange(C, device=q.device)[None, None, :]
               <= positions.long()[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def library():
        kc = kp[tables.long()].reshape(R, C, nh, dh).transpose(1, 2)
        vc = vp[tables.long()].reshape(R, C, nh, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=colmask).transpose(1, 2)
    return library


def _kwide_record(pa, dev, flush):
    """The k-wide face at the verify shape: one kernel launch a call,
    held to its plain version within KERNEL_TOL, a second call
    bit-identical, timed beside its plain version and the library call,
    and its bound from the pages that shape reads."""
    K1 = SPEC_K + 1
    ops = _kwide_inputs(dev, K1)
    q, kp, vp, tables, positions = ops
    before = pa.launches
    got = pa.paged_attention_kwide(*ops)
    again = pa.paged_attention_kwide(*ops)
    want = pa.paged_attention_kwide_reference(*ops)
    torch.cuda.synchronize()
    launched = pa.launches - before
    err = float((got - want).abs().max())
    if launched != 2:
        fail("paged_attention_kwide: 2 calls made %d kernel launches"
             % launched)
    if not np.isfinite(err) or err > KERNEL_TOL:
        fail("paged_attention_kwide disagrees with its plain version at "
             "the verify shape: max abs err %g > %g" % (err, KERNEL_TOL))
    if not torch.equal(got, again):
        fail("paged_attention_kwide: a second call differs from the first")
    library = _kwide_library(*ops)
    nbytes, flops = _kwide_bound(q, tables, positions, kp.shape[1])
    rec = {
        "shape": {"R": q.shape[0], "K1": K1, "MB": tables.shape[1],
                  "T": kp.shape[1], "nh": q.shape[2], "dh": q.shape[3],
                  "kernel_rows": q.shape[0] * K1,
                  "positions": positions.tolist()},
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "second_call_bit_identical": True,
        "ms": time_ms(lambda: pa.paged_attention_kwide(*ops), flush=flush),
        "device_ms": _device_ms(lambda: pa.paged_attention_kwide(*ops),
                                "paged_attention", flush),
        "plain_ms": time_ms(
            lambda: pa.paged_attention_kwide_reference(*ops), flush=flush),
        "library": "gather once a row + scaled_dot_product_attention",
        "library_ms": time_ms(library, flush=flush),
        "library_max_abs_err": float((library() - want).abs().max())}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    return rec


def phase_kernels(dev):
    from paddle_tpu_torch.kernels import paged_attention as pa
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}

    # paged attention at the engine's pool geometry (MB=64, T=16, nh=12,
    # dh=64): R 16 is the decode step's shape and the kernel's entry, R 1
    # and 4 its by_R records beside R 16's
    by_r = {}
    for r in PAGED_BY_R:
        q, kp, vp, tables, positions = ops = _paged_inputs(dev, r)
        nbytes, flops = _paged_bound(q, tables, positions, kp.shape[1])
        library = _paged_library(*ops)
        rec = by_r[str(r)] = {
            "max_abs_err": _paged_check(pa, ops, "R %d" % r),
            "ms": time_ms(lambda: pa.paged_attention(*ops), flush=flush),
            "device_ms": _device_ms(lambda: pa.paged_attention(*ops),
                                    "paged_attention", flush),
            "library_ms": time_ms(library, flush=flush)}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        if r != 16:
            continue
        R, nh, dh = q.shape
        T, MB = kp.shape[1], tables.shape[1]
        out["paged_attention"] = dict(
            rec, name="paged_attention", route="cuda",
            source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            replaces="paddle_tpu/kernels/paged_attention.py:154",
            tolerance=KERNEL_TOL,
            plain_ms=time_ms(lambda: pa.paged_attention_reference(*ops),
                             flush=flush),
            tc_bound_ms=tc_bound(nbytes, flops),
            library="gather + scaled_dot_product_attention",
            library_max_abs_err=float(
                (library() - pa.paged_attention_reference(*ops))
                .abs().max()),
            shape={"R": R, "MB": MB, "T": T, "nh": nh, "dh": dh,
                   "positions": positions.tolist()},
            splits=pa.splits(MB, T))
    del q, kp, vp, tables, positions, ops, library
    out["paged_attention"]["by_R"] = by_r
    edges = []
    for i, (r, mb, t, h, d, rest) in enumerate(PAGED_EDGE_SHAPES):
        ops = _paged_edge_inputs(dev, r, mb, t, h, d, rest, 70 + i)
        edges.append({"R": r, "MB": mb, "T": t, "nh": h, "dh": d,
                      "splits": pa.splits(mb, t),
                      "positions": ops[4].tolist(),
                      "max_abs_err": _paged_check(
                          pa, ops, "R %d MB %d T %d nh %d dh %d"
                          % (r, mb, t, h, d))})
        del ops
    out["paged_attention"]["edges"] = edges
    kwide = out["paged_attention"]["kwide"] = _kwide_record(pa, dev, flush)
    log(json.dumps({"paged_attention_kwide": kwide}))
    torch.cuda.empty_cache()

    out.update(_flash_fwd_kernel(dev, flush))
    out.update(_flash_bwd_kernels(dev, flush))
    del flush
    torch.cuda.empty_cache()
    return out


def _flash_fwd_kernel(dev, flush):
    """The forward kernel against the plain forward at FLASH_FWD_CASES (B
    1, H 12), a second launch that must equal the first bit for bit, and
    at S 1024 a plain forward on TF32-rounded inputs that must miss
    KERNEL_TOL; then, at the prefill's shape (B 1) and the LM step's (B
    8), S 1024, D 64, causal, the kernel held against the plain forward
    and relaunched in the same way, and timed beside the plain forward
    and SDPA."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    H = 12
    rng = np.random.RandomState(12)
    lib = _build.load("flash_attention_fwd")
    lib.flash_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_int

    def err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    per_case = {}
    for S, D, causal in FLASH_FWD_CASES:
        qkv = [torch.from_numpy(rng.randn(1, S, H, D).astype(np.float32)
                                ).to(dev) for _ in range(3)]
        got = fa.flash_attention_with_lse(*qkv, causal=causal)
        again = fa.flash_attention_with_lse(*qkv, causal=causal)
        want = fa.flash_attention_reference(*qkv, causal=causal)
        torch.cuda.synchronize()
        case = "S%d_D%d_%s" % (S, D, "causal" if causal else "full")
        rec = {"S": S, "D": D, "causal": causal,
               "max_abs_err": err(got, want), "tolerance": KERNEL_TOL,
               "second_launch_bit_identical": all(
                   bool(torch.equal(a, b)) for a, b in zip(got, again)),
               "smem_bytes": lib.flash_attention_fwd_smem_bytes(D, 0),
               "ptxas": _ptxas("flash_attention_fwd",
                               "flash_fwd_kernelILi%dE" % D)}
        if S == 1024:
            rec["tf32_inputs_max_abs_err"] = err(fa.flash_attention_reference(
                *(_tf32_round(t) for t in qkv), causal=causal), want)
        log(json.dumps({"flash_fwd_check": {case: rec}}))
        if not (np.isfinite(rec["max_abs_err"])
                and rec["max_abs_err"] <= KERNEL_TOL):
            fail("flash_attention_fwd disagrees with its plain version at "
                 "%s: max abs err %g > %g" % (case, rec["max_abs_err"],
                                              KERNEL_TOL))
        if not rec["second_launch_bit_identical"]:
            fail("flash_attention_fwd is not deterministic at %s: a second "
                 "launch differs" % case)
        if S == 1024 and not rec["tf32_inputs_max_abs_err"] > KERNEL_TOL:
            fail("a TF32 forward errs by only %g <= KERNEL_TOL %g at %s: the "
                 "tolerance cannot tell float32 from TF32"
                 % (rec["tf32_inputs_max_abs_err"], KERNEL_TOL, case))
        per_case[case] = rec
        del qkv, got, again, want
    per_shape = {}
    for B in (1, TRAIN_BATCH):
        S, D = 1024, 64
        qkv = [torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)
                                ).to(dev) for _ in range(3)]
        got = fa.flash_attention_with_lse(*qkv, causal=True)
        again = fa.flash_attention_with_lse(*qkv, causal=True)
        fwd_err = err(got, fa.flash_attention_reference(*qkv, causal=True))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        del got, again
        if not (np.isfinite(fwd_err) and fwd_err <= KERNEL_TOL):
            fail("flash_attention_fwd disagrees with its plain version at "
                 "B %d, S %d: max abs err %g > %g" % (B, S, fwd_err,
                                                     KERNEL_TOL))
        if not same:
            fail("flash_attention_fwd is not deterministic at B %d, S %d: "
                 "a second launch differs" % (B, S))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in qkv)
        work = ((4 * S * D + S) * B * H * 4,
                4 * (S * (S + 1) // 2) * D * B * H)
        b_ms, b_by = bound(*work)
        per_shape["B%d" % B] = {
            "B": B, "S": S, "H": H, "D": D, "causal": True,
            "max_abs_err": fwd_err, "tolerance": KERNEL_TOL,
            "second_launch_bit_identical": same,
            "ms": time_ms(lambda: fa.flash_attention_with_lse(
                *qkv, causal=True), flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_attention_reference(
                *qkv, causal=True), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_bound(*work),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), flush=flush)}
        log(json.dumps({"flash_fwd_times": per_shape["B%d" % B]}))
        del qkv, qh, kh, vh
    big = per_shape["B1"]
    return {"flash_attention_fwd": {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:119",
        "max_abs_err": max(r["max_abs_err"] for r in
                           list(per_case.values()) + list(per_shape.values())),
        "tolerance": KERNEL_TOL,
        "tf32_inputs_max_abs_err": per_case["S1024_D64_causal"][
            "tf32_inputs_max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "tc_bound_ms": big["tc_bound_ms"],
        "library_ms": big["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True)",
        "shape": {"B": 1, "H": H, "D": 64, "causal": True, "S_timed": 1024},
        "per_shape": per_shape, "per_case": per_case}}


def _rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _flash_bwd_kernels(dev, flush):
    """dK/dV and dQ against the plain backward at the training shape (B
    8, H 12, D 64, causal, S 1024), at the ragged S = 17 and 130, and at
    the other head dims' templates (D 32 non-causal, D 128 causal, S
    130); a second launch of each kernel must equal the first bit for
    bit. The forward kernel's o and lse, which both backwards take, are
    held against the plain forward at each case first (B 8). Each kernel is timed alone at S 1024 on the delta its wrapper
    forms."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    B, H = TRAIN_BATCH, 12
    rng = np.random.RandomState(13)
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    per_case = {}
    for S, D, causal in FLASH_BWD_CASES:
        scale = D ** -0.5
        q, k, v, do = [torch.from_numpy(rng.randn(B, S, H, D).astype(
            np.float32)).to(dev) for _ in range(4)]
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        # the forward kernel's o and lse feed both backwards: held first
        fwd_err = max(float((g - w).abs().max()) for g, w in zip(
            (o, lse), fa.flash_attention_reference(q, k, v, causal=causal)))
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
        if not (np.isfinite(fwd_err) and fwd_err <= KERNEL_TOL):
            fail("flash_attention_fwd disagrees with its plain version at "
                 "B %d, %s: max abs err %g > %g" % (B, case, fwd_err,
                                                   KERNEL_TOL))
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
               "fwd_max_abs_err": fwd_err, "fwd_tolerance": KERNEL_TOL,
               "max_rel_err": rel, "max_abs_err": err,
               "tolerance_rel": BWD_REL_TOL,
               "second_launch_bit_identical": same,
               "tf32_inputs_max_rel_err": tf32_rel,
               "library_max_rel_err": _rel_err(
                   [g.transpose(1, 2) for g in library()], want),
               "smem_bytes": {
                   "dkv": lib.flash_attention_bwd_smem_bytes(D, 0, 0),
                   "dq": lib.flash_attention_bwd_smem_bytes(D, 1, 0)},
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
    own host overhead makes the window longer than an unprofiled one),
    and the paged attention kernels' device time and share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        again = [h.wait(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return again, dict(_device_kernels(prof, wall),
                       paged_attention=_kernel_share(prof, "paged_attention"))


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
    return prompts, results, launches, metrics


# -- phase 4 -----------------------------------------------------------------

def _post(base, body, timeout=600, route="generate"):
    """POST ``body`` (a dict, or JSON already encoded) to
    ``/v1/models/gpt2:<route>``; returns (status, answer)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        base + "/v1/models/gpt2:" + route, data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _client_ttft_ms(wall_ms, answer):
    """Client-side ms from a POST to its engine's first sampled token:
    the POST's wall time less what the answer says the engine spent
    after that token (``latency_ms - ttft_ms``)."""
    return wall_ms - (answer["latency_ms"] - answer["ttft_ms"])


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
                t0 = time.monotonic()
                code, out = _post(base, {"tokens": [int(t) for t in
                                                    prompts[j]],
                                         "max_new_tokens": 32})
                wall_ms = (time.monotonic() - t0) * 1e3
                if code != 200 or out["tokens"] != results[j].tokens:
                    outcome["errors"].append(
                        "POST %d answered %d with tokens that differ from "
                        "the engine's" % (j, code))
                    continue
                outcome.setdefault("ttft_ms", []).append(out["ttft_ms"])
                outcome.setdefault("client_ttft_ms", []).append(
                    _client_ttft_ms(wall_ms, out))
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
    ttft = {"ttft_ms": outcome["ttft_ms"],
            "client_ttft_ms": outcome["client_ttft_ms"]}
    log(json.dumps({"http": dict(ttft, posts=3, signal="SIGTERM",
                                 running_at_signal=outcome[
                                     "running_at_signal"],
                                 drained_tokens=len(ans[1]["tokens"]))}))
    return ttft


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


def _reference_grads(params, feed, cfg, attention=None,
                     dtype=torch.float32):
    """{name: grad} of the mean next-token cross entropy through the
    plain functional forward, run in ``dtype`` (``attention`` maps q/k/v
    to the attention output; default the plain causal attention)."""
    from paddle_tpu_torch.models import transformer as tt
    leaves = {n: p.detach().to(dtype, copy=True).requires_grad_(True)
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


def _ref_names(up_b):
    """{program parameter: its name in the plain forward's params}: the
    serving face names the FFN-up bias blk<i>_up_b."""
    return {b: "blk%d_up_b" % i for i, b in up_b.items()}


def _grad_stats(got, want, ref_name):
    """The worst parameter's norm of (got - want) over the norm of want,
    the median over parameters, and the elementwise worst."""
    norm_rel, max_rel = {}, {}
    for n, g in got.items():
        w = want[ref_name.get(n, n)]
        d = g.to(w.dtype) - w
        norm_rel[n] = float(d.norm() / w.norm())
        max_rel[n] = float(d.abs().max() / w.abs().max())
    worst = max(norm_rel, key=norm_rel.get)
    return {"norm_rel_err": norm_rel[worst], "worst_param": worst,
            "norm_rel_err_median": float(np.median(list(norm_rel.values()))),
            "elementwise_max_rel_err": max(max_rel.values()),
            "elementwise_worst_param": max(max_rel, key=max_rel.get)}


def _grad_check(trainer, spec, cfg, feed, up_b, label="train",
                tol=GRAD_REL_TOL):
    """Step 1 through the Executor, fetching every parameter's @GRAD,
    against torch.autograd through the plain forward on the parameters
    the step started from: run in float64 (the gate), in float32 and in
    float32 with TF32-rounded attention inputs (which must miss)."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    params = [p.name for p in trainer.main_program.all_parameters()]
    start = {n: scope.find_var(n).clone() for n in params}
    outs = trainer.exe.run(trainer.main_program, feed=feed,
                           fetch_list=[spec["cost"]]
                           + [n + "@GRAD" for n in params],
                           return_numpy=False)
    got = dict(zip(params, outs[1:]))
    ref_name = _ref_names(up_b)
    ref_params = {ref_name.get(n, n): t for n, t in start.items()}
    stats = {}
    for ref_kind, attention, dtype in (
            ("float64", None, torch.float64),
            ("float32", None, torch.float32),
            ("tf32_attention", _tf32_attention, torch.float32)):
        want, ref_loss = _reference_grads(ref_params, feed, cfg, attention,
                                          dtype)
        stats[ref_kind] = dict(
            _grad_stats(got, want, ref_name),
            loss_abs_err=abs(float(outs[0].reshape(-1)[0]) - ref_loss))
        del want
    torch.cuda.synchronize()
    checks = {"params_checked": len(params), "tolerance_rel": tol,
              "gate": "float64", **stats}
    log(json.dumps({label + "_grad_check": checks}))
    if not stats["float64"]["norm_rel_err"] <= tol:
        fail("step-1 gradient of %s differs from the float64 autograd "
             "reference by %g (relative norm) > %g"
             % (stats["float64"]["worst_param"],
                stats["float64"]["norm_rel_err"], tol))
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


def _lm_build(dev):
    """``transformer_lm`` + softmax-CE + Adam at GPT-2-small widths
    through ``configs/tiny_lm.model`` (seed 0, TRAIN_BATCH sequences):
    (widths, config, spec, trainer, main program)."""
    from paddle_tpu_torch.configs import tiny_lm
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    widths = dict(vocab=GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_seq"],
                  hidden=GPT2_SMALL["hidden"],
                  num_layers=GPT2_SMALL["num_layers"],
                  num_heads=GPT2_SMALL["num_heads"],
                  ffn_mult=GPT2_SMALL["ffn_mult"])
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = tiny_lm.model(batch=TRAIN_BATCH, samples=2 * TRAIN_BATCH,
                             learning_rate=TRAIN_LR, seed=0, **widths)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    return widths, tiny_lm.lm_config(**widths), spec, trainer, main_prog


def _lm_train(dev, label, after=None, want_matmul=0,
              grad_tol=GRAD_REL_TOL, amp=False):
    """Build ``transformer_lm`` + softmax-CE + Adam at GPT-2-small widths
    through ``configs/tiny_lm.model``, init it, hold step 1's gradients
    against the plain reference, train TRAIN_PASSES passes of 2 batches
    through ``Trainer.train`` with the launch counters zeroed just before
    (and the tune counters read before and after), and profile two more
    steps. ``want_matmul`` is the
    matmul kernel's expected launches a step; ``after(cfg, scope)`` runs
    inside the trained scope. ``amp``: the program under plain AMP
    (True) or pure AMP ("pure"), the gemms on the matmul kernel's
    bfloat16 face (under pure AMP the attention too, on the flash
    kernels' bfloat16 faces) and step 1 held op by op against the
    bfloat16-rounded reference (:func:`_amp_lm_grad_check`). Returns
    the record the phase logs."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels, tune
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration
    t0 = time.monotonic()
    widths, cfg, spec, trainer, main_prog = _lm_build(dev)
    if amp:
        from paddle_tpu_torch import amp as amp_mod
        amp_mod.enable(main_prog, pure=amp == "pure")
    L = cfg.num_layers
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
        feed, up_b = trainer.feeder.feed(first), _up_biases(main_prog, L)
        checks = (_amp_lm_grad_check(trainer, spec, cfg, feed, up_b, label,
                                     pure=amp == "pure")
                  if amp else _grad_check(trainer, spec, cfg, feed, up_b,
                                          label, grad_tol))
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
        exe_before = dict(trainer.exe.stats)
        t0 = time.monotonic()
        trainer.train(spec["reader"], num_passes=TRAIN_PASSES,
                      event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        exe_runs = _exe_delta(trainer.exe, exe_before)
        # Executor.stats mirror the process counters: this run's share
        tune_stats = {k: trainer.exe.stats[k] - v
                      for k, v in tune_before.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        flash = "_bf16" if amp == "pure" else ""
        want = dict(_no_launches(), **{
            "flash_attention_fwd" + flash: 2 * L * steps,
            "flash_attention_bwd_dkv" + flash: L * steps,
            "flash_attention_bwd_dq" + flash: L * steps,
            "matmul_bf16" if amp else "matmul": want_matmul * steps})
        if steps != 2 * TRAIN_PASSES or launches != want:
            fail("%s launch counts %s over %d steps, expected %s"
                 % (label, launches, steps, want))
        _compiled_gate(label, exe_runs, steps)
        # under pure AMP the loss is a bfloat16 value: it falls only by
        # more than one bfloat16 ulp
        fall = _bf16_ulp(abs(losses[0])) if amp == "pure" else 0.0
        if not (np.all(np.isfinite(losses))
                and losses[-1] < losses[0] - fall):
            fail("%s loss did not fall: %s" % (label, losses))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            trainer.train(spec["reader"], num_passes=1)
            torch.cuda.synchronize()
            prof_wall = time.monotonic() - t1
        profile_window = _device_kernels(prof, prof_wall)
        profile_window["steps"] = 2
        for kernel in ("matmul_kernel", "matmul_bf16_wgmma_kernel",
                       "matmul_bf16_ragged_kernel") + FLASH_KERNELS:
            profile_window[kernel] = _kernel_share(prof, kernel)
        profile_window["flash_ms"] = sum(profile_window[k]["ms"]
                                         for k in FLASH_KERNELS)
        if amp == "pure":
            # the faces' wgmma kernels in the profile (over two steps: 24
            # forwards a step, 12 of each backward kernel) and none of
            # the mma.sync path
            for kernel, n in (("flash_fwd_bf16", 4 * L),
                              ("flash_bwd_dkv_bf16", 2 * L),
                              ("flash_bwd_dq_bf16", 2 * L)):
                got = (profile_window[kernel + "_wgmma_kernel"]["count"],
                       profile_window[kernel + "_mma_kernel"]["count"])
                if got != (n, 0):
                    fail("%s profile shows %d %s_wgmma_kernel and %d "
                         "%s_mma_kernel launches over two steps, expected "
                         "%d and 0" % (label, got[0], kernel, got[1],
                                       kernel, n))
            profile_window["bwd_bf16_ms"] = sum(
                profile_window[k]["ms"] for k in FLASH_KERNELS
                if k.startswith("flash_bwd_d") and "_bf16_" in k)
            profile_window["parent_face"] = _parent_face_window(trainer,
                                                                spec)
        extra = after(cfg, global_scope()) if after else None
    p50 = float(np.median(step_s))
    tokens = TRAIN_BATCH * cfg.max_seq
    rec = {
        "config": dict(widths, batch=TRAIN_BATCH,
                       dtype={True: "plain AMP (bfloat16 gemm operands)",
                              "pure": "pure AMP (bfloat16 gemm operands "
                                      "and outputs, bfloat16 attention)",
                              False: "float32"}[amp],
                       tokens_per_step=tokens, optimizer="adam",
                       learning_rate=TRAIN_LR, seed=0),
        "params": n_params, "program_ops": n_ops, "build_s": build_s,
        "startup_s": startup_s, "grad_check": checks, "losses": losses,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50, "wall_s": wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "tune": tune_stats, "executor": exe_runs,
        "traces": _traces(exe_runs, steps), "profile": profile_window}
    if after:
        rec["served"] = extra
    trainer.exe.close()
    del trainer
    torch.cuda.empty_cache()
    return rec


def _parent_face_window(trainer, spec):
    """Two more profiled steps of the pure-AMP LM with each bfloat16
    flash forward, dK/dV and dQ sent to the mma.sync kernels (the faces'
    design before their wgmma kernels, the parents' sources under new
    names): the device time and the faces' shares beside theirs, in the
    same run, on the per-op path (so that the patched wrappers run). A
    measurement only: the main path's launches were read before it."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import flash_attention as fa
    saved = {n: getattr(fa, n) for n in ("_launch_fwd", "_bwd_dkv",
                                         "_bwd_dq")}

    def forced(fn):
        def call(q, *args, mma=False):
            return fn(q, *args, mma=mma or q.dtype == torch.bfloat16)
        return call

    for n, fn in saved.items():
        setattr(fa, n, forced(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            # on the per-op path: a replay would not call the wrappers
            _eager_steps(trainer, spec["reader"]())
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        for n, fn in saved.items():
            setattr(fa, n, fn)
    window = _device_kernels(prof, wall)
    window["steps"] = 2
    for kernel in FLASH_KERNELS:
        if "_bf16_" in kernel:
            window[kernel] = _kernel_share(prof, kernel)
    window["bwd_bf16_ms"] = sum(
        window[k]["ms"] for k in window if k.startswith("flash_bwd_d"))
    return window


# the flash kernels by name in a profile: the float32 faces', then the
# bfloat16 faces' on both paths
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel", "flash_fwd_bf16_wgmma_kernel",
                 "flash_fwd_bf16_mma_kernel",
                 "flash_bwd_dkv_bf16_wgmma_kernel",
                 "flash_bwd_dkv_bf16_mma_kernel",
                 "flash_bwd_dq_bf16_wgmma_kernel",
                 "flash_bwd_dq_bf16_mma_kernel")


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
    the four ResNet-50 stage shapes (batch 32) and the edge shapes, each
    relaunched (bit-identical) and its tilings recorded, with the kernel,
    plain and cuDNN times at the stage shapes. Returns the two entries of
    the kernels line."""
    from paddle_tpu_torch.kernels import conv3x3
    F = torch.nn.functional
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_shape = {}
    for i, shape in enumerate(R50_CONV_SHAPES + CONV_EDGE_SHAPES):
        N, H, W, C, O = shape
        x, w, g = _conv_inputs(shape, 20 + i, dev)
        w_rot = conv3x3.rotate_filter(w)
        got = conv3x3.conv3x3_s1_nhwc(x, w)
        got_dx, _ = conv3x3.conv3x3_bwd(x, w, g, want_dw=False)
        again = conv3x3._launch(x, w)
        again_dx = conv3x3._launch(g, w_rot)
        want = conv3x3.conv3x3_reference(x, w)
        want_dx = conv3x3.conv3x3_reference(g, w_rot)
        tf32 = conv3x3.conv3x3_reference(_tf32_round(x), _tf32_round(w))
        tf32_dx = conv3x3.conv3x3_reference(_tf32_round(g),
                                            _tf32_round(w_rot))
        torch.cuda.synchronize()
        tilings = {"fwd": conv3x3.kernel_tiling(N, H, W, C, O),
                   "dx": conv3x3.kernel_tiling(N, H, W, O, C)}
        rec = {"tiling": {k: "%dx%d" % t for k, t in tilings.items()},
               "fwd_max_rel_err": _rel_err([got], [want]),
               "dx_max_rel_err": _rel_err([got_dx], [want_dx]),
               "fwd_max_abs_err": float((got - want).abs().max()),
               "dx_max_abs_err": float((got_dx - want_dx).abs().max()),
               "relaunch_bit_identical": bool(torch.equal(got, again)
                                              and torch.equal(got_dx,
                                                              again_dx)),
               "tf32_fwd_max_rel_err": _rel_err([tf32], [want]),
               "tf32_dx_max_rel_err": _rel_err([tf32_dx], [want_dx])}
        per_shape["x".join(str(d) for d in shape)] = rec
        log(json.dumps({"conv3x3_check": {"shape": shape, **rec}}))
        if not (rec["fwd_max_rel_err"] <= CONV_REL_TOL
                and rec["dx_max_rel_err"] <= CONV_REL_TOL):
            fail("conv3x3 disagrees with its plain version at %s: %s > %g"
                 % (shape, rec, CONV_REL_TOL))
        if not rec["relaunch_bit_identical"]:
            fail("conv3x3 relaunched at %s differs from its first launch"
                 % (shape,))
        mirror = {"fwd": conv3x3.tiling(N, H, W, C, O, sms),
                  "dx": conv3x3.tiling(N, H, W, O, C, sms)}
        if tilings != mirror:
            fail("conv3x3 at %s took the tilings %s, its rule's mirror "
                 "says %s" % (shape, tilings, mirror))
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
        del x, w, g, w_rot, got, got_dx, again, again_dx, want, want_dx
        del tf32, tf32_dx
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


def _plain_resnet_loss(program, params, feed, cost, conv_round=None,
                       amp=False):
    """The loss of ``program``'s forward recomputed with plain torch
    functions (``F.conv2d`` for every conv, ``F.batch_norm`` with batch
    statistics) from ``params`` and ``feed``, differentiable through
    autograd; returns (loss, {MeanOut/VarianceOut name: new running
    stat}). ``conv_round`` maps each conv operand before the conv (the
    TF32 contrast); ``amp`` rounds the convs and the fc the way plain
    AMP does (:class:`_AmpConv`, :class:`_AmpMm`)."""
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
            conv = (_AmpConv.apply if amp else
                    lambda *c: F.conv2d(c[0], c[1], None, *c[2:]))
            y = conv(x, w, a("strides"), a("paddings"), a("dilations"),
                     a("groups"))
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
            x = env[op.input("X")[0]].reshape(env[op.input("X")[0]]
                                              .shape[0], -1)
            w = env[op.input("Y")[0]]
            env[op.output("Out")[0]] = _AmpMm.apply(x, w, False) if amp \
                else x @ w
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


def _resnet_ref_stats(prog, params, stat_names, start, got, got_stats,
                      feed, cost, got_loss, refs, zero_from_first=False):
    """For each (label, keywords of :func:`_plain_resnet_loss`) of
    ``refs``: the port's step-1 gradients ``got`` and running statistics
    ``got_stats`` against torch.autograd through that plain forward on
    the state the step started from (``start``). ``zero_from_first``:
    the gradients that are zero but for noise are those of the first
    reference, for all of them (under AMP they are bfloat16 noise in
    the rounded reference, not zero)."""
    stats, zero = {}, None
    for label, kw in refs:
        leaves = {n: start[n].detach().clone().requires_grad_(n in params)
                  for n in start}
        loss, new_stats = _plain_resnet_loss(prog, leaves, feed, cost, **kw)
        want = dict(zip(params, torch.autograd.grad(
            loss, [leaves[n] for n in params])))
        largest = max(float(w.norm()) for w in want.values())
        # gradients that are zero but for float32 noise (the bias of each
        # bottleneck's last batch norm: no relu after the residual add)
        if zero is None or not zero_from_first:
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
            "loss_abs_err": abs(got_loss - float(loss.detach()))}
        del leaves, loss, new_stats, want
    torch.cuda.synchronize()
    return stats


def _resnet_step1(trainer, spec, feed, refs, zero_from_first=False):
    """Step 1 through the Executor, fetching every parameter's @GRAD
    and the running statistics after it, against the references
    ``refs`` (:func:`_resnet_ref_stats`). Returns (loss, stats, number
    of parameters, number of running statistics)."""
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
    loss = float(outs[0].reshape(-1)[0])
    stats = _resnet_ref_stats(prog, params, stat_names, start, got,
                              got_stats, feed, cost, loss, refs,
                              zero_from_first)
    return loss, stats, len(params), len(stat_names)


def _convnet_grad_check(trainer, spec, feed):
    """Step 1's gradients and running statistics against torch.autograd
    through the plain forward on the state the step started from; and
    the same reference with every conv operand rounded to TF32, which
    must miss the tolerance."""
    loss, stats, n_params, n_stats = _resnet_step1(
        trainer, spec, feed,
        (("float32", {}), ("tf32_convs", {"conv_round": _tf32_straight})))
    checks = {"params_checked": n_params, "running_stats": n_stats,
              "tolerance_rel": R50_GRAD_REL_TOL,
              "stats_tolerance_rel": R50_STAT_REL_TOL, "loss": loss, **stats}
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


def _bf16_values(t):
    """``t`` rounded to bfloat16 (to nearest even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _AmpMm(torch.autograd.Function):
    """``mul`` and ``mul_grad`` under plain AMP, as the port computes
    them: the operands (and the output gradient) rounded to bfloat16,
    the products summed in the reference's dtype; ``rounded`` (a tuned
    gemm: the matmul kernel's bfloat16 face writes bfloat16) rounds the
    output to bfloat16 too."""

    @staticmethod
    def forward(ctx, x, w, rounded):
        xb, wb = _bf16_values(x), _bf16_values(w)
        ctx.save_for_backward(xb, wb)
        out = xb @ wb
        return _bf16_values(out) if rounded else out

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = _bf16_values(g)
        return gb @ wb.t(), xb.t() @ gb, None


class _AmpConv(torch.autograd.Function):
    """``conv2d`` and ``conv2d_grad`` under plain AMP, as the port
    computes them (the conv3x3 kernel's bfloat16 face and cuDNN on
    bfloat16 alike): the operands and the output gradient rounded to
    bfloat16, float32 sums, the output, dx and dw rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x, w, s, p, d, groups):
        xb, wb = _bf16_values(x), _bf16_values(w)
        ctx.save_for_backward(xb, wb)
        ctx.conv = (list(s), list(p), list(d), groups)
        return _bf16_values(torch.nn.functional.conv2d(
            xb, wb, None, s, p, d, groups))

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        s, p, d, groups = ctx.conv
        dx, dw, _ = torch.ops.aten.convolution_backward(
            _bf16_values(g), xb, wb, None, s, p, d, False, [0, 0], groups,
            [True, True, False])
        return _bf16_values(dx), _bf16_values(dw), None, None, None, None


def _op_err(got, want, rounded):
    """(largest error, its tolerance) of a port value against its AMP
    reference: one bfloat16 ulp of the largest magnitude for a rounded
    (bfloat16-valued) one, AMP_F32_REL_TOL of it for a float32 sum."""
    err = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    return err, (_bf16_ulp(m) if rounded else AMP_F32_REL_TOL * max(1.0, m))


def _amp_op_check(trainer, feed, label, tuned=True):
    """One step under plain or pure AMP fetching every mul's, conv2d's
    and flash_attention's inputs, output, output gradient and input
    gradients, and every lstm's Input, Hidden and Cell (the scope put
    back as it was before the step); each op against the same op rounded
    as AMP rounds (:class:`_AmpMm`, :class:`_AmpConv`, in float32 with
    TF32 off) on those tensors and the parameters the step started from.
    With ``tuned`` (a cache of winners) a gemm inside the matmul kernel's
    population runs tuned here (its output rounded to bfloat16); the LM
    head and the fc of ResNet-50 lie outside it; a value the step wrote
    in bfloat16 (pure AMP: every mul's output, dX of a bfloat16 X) is
    held against its reference rounded to bfloat16. Fails past the
    tolerance of :func:`_op_err`. A flash_attention op and its generic
    grad are held against the plain forward and backward (float32, o
    and the gradients rounded once to the operands' dtype) on the
    step's q, k, v, o and dO: within one ulp (:func:`_flash_bf16_err`)
    on bfloat16 operands, KERNEL_TOL and BWD_REL_TOL on float32 ones. An
    lstm op (bias-free, no initial state: the fused kernel's bfloat16
    face under pure AMP) is held against the plain recurrence on its own
    Input and Weight, Hidden and Cell within one ulp of each element's
    own magnitude plus BWD_REL_TOL of the largest (:func:`_flash_bf16_err`),
    and the recurrence with h and c carried in bfloat16 must miss that.
    Returns the worst error over tolerance by role."""
    from paddle_tpu_torch.core.executor import raw_data
    from paddle_tpu_torch.core.scope import global_scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_lstm
    from paddle_tpu_torch.kernels.matmul import supports_matmul
    from paddle_tpu_torch.ops import sequence_ops
    from paddle_tpu_torch.ops.common import flatten_to_2d
    F = torch.nn.functional
    prog = trainer.main_program
    scope = global_scope()
    params = {p.name for p in prog.all_parameters()}
    # the step leaves the scope as it found it: every persistable
    # (parameters, optimizer state, running statistics) is put back
    state = {v.name: scope.find_var(v.name).clone() for v in prog.list_vars()
             if v.persistable and isinstance(scope.find_var(v.name),
                                             torch.Tensor)}
    start = {n: state[n] for n in params}
    ops = prog.global_block().ops
    slots = {"mul": ("X", "Y", "Out"), "conv2d": ("Input", "Filter", "Output")}
    # a grad op takes its forward op's operands by name
    grads = {(op.type[:-5],) + tuple(op.input(s_)[0] for s_ in
                                     slots[op.type[:-5]][:2]): op
             for op in ops if op.type in ("mul_grad", "conv2d_grad")}
    flash_grads = {tuple(op.input(s_)[0] for s_ in ("Q", "K", "V")): op
                   for op in ops if op.type == "generic_grad"
                   and op.attr("__fwd_type__") == "flash_attention"}
    checks, fetch, flash, lstms = [], [], [], []
    for op in ops:
        if op.type == "lstm":
            if op.input("Bias") or op.input("H0") or op.input("C0"):
                fail("%s: the op check takes a bias-free lstm with no "
                     "initial state" % label)
            lstms.append(op)
            fetch += [op.input("Input")[0], op.output("Hidden")[0],
                      op.output("Cell")[0]]
        if op.type == "flash_attention":
            qkv = tuple(op.input(s_)[0] for s_ in ("Q", "K", "V"))
            g = flash_grads.get(qkv)
            dout = g.input("Out@GRAD")[0] if g is not None else None
            dqkv = [g.output(s_ + "@GRAD")[0] if g is not None
                    and g.output(s_ + "@GRAD") else None for s_ in "QKV"]
            flash.append((op, qkv, op.output("Out")[0], dout, dqkv))
            fetch += [n for n in qkv + (op.output("Out")[0], dout)
                      + tuple(dqkv) if n]
        if op.type not in slots:
            continue
        x_slot, w_slot, o_slot = slots[op.type]
        out = op.output(o_slot)[0]
        g = grads.get((op.type, op.input(x_slot)[0], op.input(w_slot)[0]))
        dout = g.input(o_slot + "@GRAD")[0] if g is not None else None
        dx = g.output(x_slot + "@GRAD") if g is not None else []
        dw = g.output(w_slot + "@GRAD") if g is not None else []
        checks.append((op, out, dout, dx[0] if dx else None,
                       dw[0] if dw else None))
        fetch += [n for n in (op.input(x_slot)[0], out) if n not in params]
        if g is not None:
            fetch += [dout] + dx + dw
    fetch = sorted(set(fetch))
    # ragged values (an lstm's Input) keep their LoD; the rest are tensors
    lod_vals = dict(zip(fetch, trainer.exe.run(prog, feed=feed,
                                               fetch_list=fetch,
                                               return_numpy=False)))
    vals = {n: raw_data(v) for n, v in lod_vals.items()}
    for n, t in state.items():
        scope.set_var(n, t.clone())
    vals.update(start)
    worst = {}

    def hold(role, got, want, rounded, where):
        err, tol = _op_err(got, want, rounded)
        worst[role] = max(worst.get(role, 0.0), err / tol)
        if not err <= tol:
            fail("%s: AMP %s of %s differs from its rounded reference by "
                 "%g > %g" % (label, role, where, err, tol))

    def hold_flash(role, got, want, where):
        if got.dtype != want.dtype:
            fail("%s: %s of %s is %s, its plain version %s"
                 % (label, role, where, got.dtype, want.dtype))
        if got.dtype == torch.bfloat16:
            ratio = max(_flash_bf16_err(got, want)[:2])
        else:
            tol = KERNEL_TOL if role == "flash_out" else \
                BWD_REL_TOL * float(want.abs().max())
            ratio = float((got - want).abs().max()) / tol
        worst[role] = max(worst.get(role, 0.0), ratio)
        if not ratio <= 1:
            fail("%s: %s of %s differs from the plain flash attention by "
                 "%g of its tolerance" % (label, role, where, ratio))

    for op, qkv, out, dout, dqkv in flash:
        q, k, v = (vals[n] for n in qkv)
        causal = bool(op.attr("causal", False))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
        hold_flash("flash_out", vals[out], o_ref, out)
        if dout is None:
            continue
        want_grads = fa.flash_attention_bwd_reference(
            q, k, v, vals[out], lse_ref, vals[dout].reshape(q.shape),
            causal=causal)
        for role, name, w in zip(("flash_dq", "flash_dk", "flash_dv"), dqkv,
                                 want_grads):
            if name:
                hold_flash(role, vals[name], w, out)
        del o_ref, lse_ref, want_grads

    control = []
    for op in lstms:
        x = lod_vals[op.input("Input")[0]]
        w = vals[op.input("Weight")[0]]
        rev = bool(op.attr("is_reverse", False))
        xs, ms, layout = sequence_ops._ragged_time_major(x, rev)
        zeros = xs.new_zeros((xs.shape[1], w.shape[0]))
        args = (xs, w, zeros, zeros, ms.to(torch.float32))
        for outs, kind in ((fused_lstm.fused_lstm_reference(*args), "plain"),
                           (_bf16_state_lstm(*args), "bf16_state")):
            for slot, t in zip(("Hidden", "Cell"), outs):
                want = raw_data(sequence_ops._back_to_lod(x, t, rev, layout))
                got = vals[op.output(slot)[0]]
                if got.dtype != want.dtype:
                    fail("%s: lstm %s is %s, its plain version %s"
                         % (label, slot, got.dtype, want.dtype))
                ratio = _flash_bf16_err(got, want)[1]
                role = "lstm_" + slot.lower()
                if kind == "bf16_state":
                    control.append(ratio)
                    continue
                worst[role] = max(worst.get(role, 0.0), ratio)
                if not ratio <= 1:
                    fail("%s: lstm %s of %s differs from the plain "
                         "recurrence by %g of its tolerance"
                         % (label, slot, op.output(slot)[0], ratio))
    if control and not min(control) > 1:
        fail("%s: an lstm carrying h and c in bfloat16 errs by only %g of "
             "the tolerance: it cannot tell the face from it"
             % (label, min(control)))

    for op, out, dout, dx_name, dw_name in checks:
        a = op.attr
        if op.type == "conv2d":
            x, w = vals[op.input("Input")[0]], vals[op.input("Filter")[0]]
            conf = (list(a("strides")), list(a("paddings")),
                    list(a("dilations")), a("groups") or 1)
            xb, wb = _bf16_values(x), _bf16_values(w)
            hold("conv_out", vals[out], _bf16_values(
                F.conv2d(xb, wb, None, *conf)), True, out)
            if dout is not None:
                rx, rw, _ = torch.ops.aten.convolution_backward(
                    _bf16_values(vals[dout]), xb, wb, None,
                    conf[0], conf[1], conf[2], False, [0, 0], conf[3],
                    [dx_name is not None, dw_name is not None, False])
                if dx_name:
                    hold("conv_dx", vals[dx_name], _bf16_values(rx), True,
                         out)
                if dw_name:
                    hold("conv_dw", vals[dw_name], _bf16_values(rw), True,
                         out)
            continue
        x2 = flatten_to_2d(vals[op.input("X")[0]], a("x_num_col_dims", 1))
        w2 = flatten_to_2d(vals[op.input("Y")[0]], a("y_num_col_dims", 1))
        on_kernel = tuned and supports_matmul(
            tuple(x2.shape), tuple(w2.shape), "bfloat16")
        xb, wb = _bf16_values(x2).float(), _bf16_values(w2).float()
        want = xb @ wb
        got = vals[out].reshape(want.shape)
        rounded = on_kernel or got.dtype == torch.bfloat16
        hold("mul_out_tuned" if on_kernel else "mul_out", got,
             _bf16_values(want) if rounded else want, rounded, out)
        if dout is not None:
            gb = _bf16_values(vals[dout].reshape(want.shape)).float()
            if dx_name:
                got = vals[dx_name].reshape(x2.shape)
                rounded = got.dtype == torch.bfloat16
                want_dx = gb @ wb.t()
                hold("mul_dx", got,
                     _bf16_values(want_dx) if rounded else want_dx, rounded,
                     out)
            if dw_name:
                hold("mul_dw", vals[dw_name].reshape(w2.shape), xb.t() @ gb,
                     False, out)
    del vals
    torch.cuda.empty_cache()
    rec = {"ops": len(checks), "flash_ops": len(flash),
           "max_err_over_tol": worst}
    if lstms:
        rec["lstm_ops"] = len(lstms)
        rec["lstm_bf16_state_min_err_over_tol"] = min(control)
    log(json.dumps({label + "_op_check": rec}))
    return rec


def _amp_convnet_grad_check(trainer, spec, feed):
    """Step 1 under plain AMP: every conv and the fc against its rounded
    reference (the gate, :func:`_amp_op_check`); then the step's
    gradients end to end against torch.autograd through the rounded
    plain forward and through the unrounded float32 one, reported."""
    ops = _amp_op_check(trainer, feed, "convnet_amp")
    loss, stats, n_params, n_stats = _resnet_step1(
        trainer, spec, feed,
        (("float32", {}), ("bf16_rounded", {"amp": True})),
        zero_from_first=True)
    rounded, f32 = stats["bf16_rounded"], stats["float32"]
    checks = {"op_check": ops, "params_checked": n_params,
              "running_stats": n_stats, "gate": "op_check",
              "separates": f32["norm_rel_err_median"]
              > 2 * rounded["norm_rel_err_median"], "loss": loss, **stats}
    log(json.dumps({"convnet_amp_grad_check": checks}))
    return checks


def _pure_amp_fetch_check(trainer, spec, feed):
    """One step under pure AMP fetching the first conv's and the first
    batch norm's outputs: both bfloat16 (numpy ``ml_dtypes.bfloat16``
    on the host), while every parameter stays float32."""
    import ml_dtypes
    from paddle_tpu_torch.core.scope import global_scope
    prog = trainer.main_program
    ops = prog.global_block().ops
    conv = next(op.output("Output")[0] for op in ops if op.type == "conv2d")
    bn = next(op.output("Y")[0] for op in ops if op.type == "batch_norm")
    cost, conv_out, bn_out = trainer.exe.run(
        prog, feed=feed, fetch_list=[spec["cost"], conv, bn])
    params = {p.name: global_scope().find_var(p.name).dtype
              for p in prog.all_parameters()}
    checks = {"conv_out": str(conv_out.dtype), "bn_out": str(bn_out.dtype),
              "loss_dtype": str(cost.dtype),
              "param_dtypes": sorted({str(d) for d in params.values()})}
    log(json.dumps({"convnet_pure_amp_fetch": checks}))
    bf16 = np.dtype(ml_dtypes.bfloat16)
    if conv_out.dtype != bf16 or bn_out.dtype != bf16:
        fail("pure AMP fetched the conv and batch-norm outputs as %s and %s, "
             "not bfloat16" % (conv_out.dtype, bn_out.dtype))
    if set(params.values()) != {torch.float32}:
        fail("pure AMP left parameters in %s" % checks["param_dtypes"])
    return checks


def _conv_share(prof):
    """Device time by kind of kernel over a profile: the conv3x3 kernel
    (either face), cuDNN convolutions (forward, dgrad, wgrad), GEMMs (the
    dw tap contractions and the fc), reductions (batch norm statistics
    and their grads) and the rest (elementwise, copies, pooling)."""
    kinds = {"conv3x3": 0.0, "cudnn_conv": 0.0, "gemm": 0.0,
             "reduction": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        k = e.key.lower()
        if "conv3x3_kernel" in k or "conv3x3_bf16_" in k:
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


def phase_convnet(dev, amp=False):
    """ImageNet ResNet-50 at 224 x 224, 1000 classes, float32, batch 32,
    Momentum(0.01, 0.9), conv_impl=pallas3x3, built by the CIFAR config's
    model(); step-1 gradients and running stats against the plain
    reference, then R50_STEPS steps on one fixed batch through
    Trainer.train, then two profiled steps. ``amp`` (phase 9): True runs
    it under plain AMP (the gradients against the bfloat16-rounded
    reference), "pure" under pure AMP (the conv and batch-norm outputs
    fetched as bfloat16, the parameters float32); either way each step
    makes 16 launches of each of the conv3x3 kernel's bfloat16 roles.
    Returns (the launch counts, images/s)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    label = {False: "convnet", True: "convnet_amp",
             "pure": "convnet_pure_amp"}[amp]
    metric = {False: "resnet50_train_images_per_sec",
              True: "resnet50_amp_train_images_per_sec",
              "pure": "resnet50_pure_amp_train_images_per_sec"}[amp]
    t0 = time.monotonic()
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = resnet_cifar.model(variant="imagenet", depth=50, image=224,
                                  class_dim=1000, batch=R50_BATCH,
                                  learning_rate=R50_LR, amp=amp)
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
        check = {False: _convnet_grad_check, True: _amp_convnet_grad_check,
                 "pure": _pure_amp_fetch_check}[amp]
        checks = check(trainer, spec, trainer.feeder.feed(batch))
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
        exe_before = dict(trainer.exe.stats)
        t0 = time.monotonic()
        trainer.train(fixed(R50_STEPS), num_passes=1, event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        _compiled_gate(label, _exe_delta(trainer.exe, exe_before),
                       len(losses))
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        face = "_bf16" if amp else ""
        want = dict(_no_launches(), **{"conv3x3_fwd" + face: 16 * steps,
                                       "conv3x3_dx" + face: 16 * steps})
        log(json.dumps({label + "_losses": losses, "launches": launches}))
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
        if amp:
            # the bfloat16 face's symbol in the profile: the wgmma kernel,
            # 16 launches a role a step, and no launch of the ragged path
            wgmma = _kernel_share(prof, "conv3x3_bf16_wgmma_kernel")
            ragged = _kernel_share(prof, "conv3x3_bf16_ragged_kernel")
            profile_window["conv3x3_bf16_wgmma"] = wgmma
            if wgmma["count"] != 2 * 2 * 16 or ragged["count"] != 0:
                fail("%s profile: %d launches of conv3x3_bf16_wgmma_kernel "
                     "and %d of the ragged kernel over two steps, expected "
                     "64 and 0" % (label, wgmma["count"], ragged["count"]))
    p50 = float(np.median(step_s))
    log(json.dumps({label: {
        "config": {"model": "resnet_imagenet", "depth": 50, "image": 224,
                   "class_dim": 1000,
                   "dtype": {False: "float32", True: "plain AMP",
                             "pure": "pure AMP"}[amp],
                   "batch": R50_BATCH, "optimizer": "momentum(0.9)",
                   "learning_rate": R50_LR, "conv_impl": "pallas3x3",
                   "data": "one fixed batch, RandomState(0) rand/randint"},
        "params": n_params, "program_ops": n_ops, "build_s": build_s,
        "startup_s": startup_s, "grad_check": checks, "losses": losses,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
        metric: R50_BATCH / p50, "wall_s": wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "profile": profile_window}}))
    log("%s %.3f (batch %d, step p50 %.3f ms)"
        % (metric, R50_BATCH / p50, R50_BATCH, p50 * 1e3))
    trainer.exe.close()
    del trainer
    torch.cuda.empty_cache()
    return launches, R50_BATCH / p50


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


def _ptxas(name, *kernel):
    """The compiler's register / shared-memory / spill lines of one
    kernel of ``csrc/<name>.cu``: the entry whose mangled name holds each
    of the ``kernel`` texts."""
    from paddle_tpu_torch.kernels import _build
    lines = (_build.build_log(name) or "").splitlines()
    out, hit = [], False
    for ln in lines:
        if "Compiling entry function" in ln:
            hit = all(k in ln for k in kernel)
        elif hit and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def _rnn_ptxas(name, elem=""):
    """The registers and spills of each of a recurrence kernel's three
    forms: W split once (the main path), split at each load (where the
    split fragments do not fit) and read from global memory by blocks of
    two unit groups (where the groups outnumber the SMs); ``elem``: the
    mangled element type that the LSTM's kernel takes first ("f" float32,
    "13__nv_bfloat16" its bfloat16 face)."""
    return {form: _ptxas(name, name + "_kernelI" + elem, tag)
            for form, tag in (("w_split_once", "5uint4"),
                              ("w_split_at_load", "6float2"),
                              ("w_global_two_groups", "7WGlobal"))}


def _cudnn_lstm(xs, w, h0, c0):
    """One cuDNN ``torch.nn.LSTM`` layer computing the fused LSTM on an
    unmasked batch: input size 4D, an input weight that permutes
    Paddle's gate slabs (c~, i, f, o) to PyTorch's (i, f, g, o), the
    recurrent weight in the same order, no biases, in xs's dtype (on
    bfloat16 its weights and state are rounded to bfloat16). Returns a
    call that runs it on ``xs`` from (h0, c0)."""
    T, N, D4 = xs.shape
    D = D4 // 4
    lstm = torch.nn.LSTM(D4, D, num_layers=1, bias=False).to(
        xs.device, xs.dtype)
    order = [1, 2, 0, 3]            # PyTorch's i, f, g, o in Paddle's slabs
    eye = torch.eye(D4, device=xs.device, dtype=xs.dtype)
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
    (T 7, N 3, D 128), and at RNN_EDGE_SHAPES; each launched twice at
    every shape, the second launch bit-identical to the first;
    a recurrence run with TF32 products must miss the tolerance. Times at
    the training drive's input (full lengths), with cuDNN's LSTM beside
    row 7. Returns the two entries of the kernels line."""
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
        shapes = (RNN_SHAPE, RNN_ODD_SHAPE) + RNN_EDGE_SHAPES
        for seed, (T, N, D) in enumerate(shapes):
            for ragged in (True, False):
                args = _rnn_inputs(gates, T, N, D, 40 + seed, ragged, dev)
                got = run(args)
                again = run(args)
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
                rec["second_launch_bit_identical"] = all(
                    torch.equal(a, b) for a, b in zip(got, again))
                checks.append(rec)
                log(json.dumps({name + "_check": rec}))
                if not rec["max_rel_err"] <= RNN_REL_TOL:
                    fail("%s disagrees with its plain version at %s: %s > %g"
                         % (name, rec["shape"], rec["max_rel_err"],
                            RNN_REL_TOL))
                if not rec["second_launch_bit_identical"]:
                    fail("%s: a second launch at %s is not bit-identical to "
                         "the first" % (name, rec["shape"]))
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
            "ptxas": _rnn_ptxas(name, "f" if gates == 4 else ""),
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


def phase_rnn(dev, cell, amp=False):
    """``configs/text_rnn.model`` at ``benchmark/rnn_bench.py``'s widths
    (vocab 30000, hidden 512, 100 words, batch 64, 2 layers, the second
    reversed, Adam 0.002, float32) with ``cell``: step-1 gradients
    against the plain reference, RNN_STEPS steps on one fixed batch
    through Trainer.train, then two profiled steps. ``amp="pure"`` (phase
    9, LSTM): the bias-free net (``bias=False``) under pure AMP, its
    lstm ops on the fused kernel's bfloat16 face, step 1 held op by op
    (every mul, and every lstm's Hidden and Cell against the plain
    recurrence on the op's own inputs: :func:`_amp_op_check`). Returns
    (the launch counts, a summary of the run: tokens/s, step p50, device
    time and busy share of the profiled steps, the fused kernel's
    share)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import text_rnn
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.kernels import fused_gru, fused_lstm
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    label = "rnn_%s%s" % (cell, "_pure_amp" if amp else "")
    t0 = time.monotonic()
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = text_rnn.model(cell=cell, samples=RNN_BENCH["batch"],
                              bias=not amp, **RNN_BENCH)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    if amp:
        from paddle_tpu_torch import amp as amp_mod
        amp_mod.enable(main_prog, pure=True)
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
        feed = trainer.feeder.feed(batch)
        checks = (_amp_op_check(trainer, feed, label, tuned=False) if amp
                  else _rnn_grad_check(trainer, spec, feed))
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
        exe_before = dict(trainer.exe.stats)
        t0 = time.monotonic()
        trainer.train(fixed(RNN_STEPS), num_passes=1, event_handler=handler)
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        _compiled_gate(label, _exe_delta(trainer.exe, exe_before),
                       len(losses))
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(losses)
        # per RNN layer a step: the forward, and its replay in the generic
        # grad, which the plain backward loop then differentiates
        kernel = "fused_" + cell + ("_bf16" if amp else "")
        want = dict(_no_launches(), **{
            kernel: 2 * RNN_BENCH["layers"] * steps})
        log(json.dumps({label + "_losses": losses, "launches": launches}))
        if steps != RNN_STEPS or launches != want:
            fail("%s launch counts %s over %d steps, expected %s"
                 % (label, launches, steps, want))
        # under pure AMP the loss is a bfloat16 value: it falls only by
        # more than one bfloat16 ulp
        fall = _bf16_ulp(abs(losses[0])) if amp else 0.0
        if not (np.all(np.isfinite(losses))
                and losses[-1] < losses[0] - fall):
            fail("the %s text classifier's loss did not fall on the fixed "
                 "batch: %s" % (label, losses))
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
                # on the per-op path, so that the marked loop runs (phase
                # 12 profiles the compiled steps)
                _eager_steps(trainer, fixed(2)())
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
    log(json.dumps({"rnn_train_" + label[4:]: {
        "config": dict(RNN_BENCH, cell=cell,
                       dtype="pure AMP (bfloat16 projections and "
                             "recurrence outputs), no biases" if amp
                       else "float32",
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
    log("%s_train_tokens_per_sec %.3f (batch %d x %d words, step p50 "
        "%.3f ms)" % (label, tokens / p50, RNN_BENCH["batch"],
                      RNN_BENCH["seq_len"], p50 * 1e3))
    trainer.exe.close()
    del trainer
    torch.cuda.empty_cache()
    return launches, {
        "tokens_per_s": tokens / p50, "step_ms_p50": p50 * 1e3,
        "device_kernel_ms_two_steps": profile_window["device_kernel_ms"],
        "device_busy_share": profile_window["device_busy_share"],
        "kernel_share_of_device_time":
            profile_window["by_kind"]["rnn_kernel"]["share"],
        "kernel_ms_two_steps": profile_window["by_kind"]["rnn_kernel"]["ms"]}


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
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import matmul as mm
    lib = _build.load("matmul")
    templates = {"%dx%dx%d" % t: {
        "smem_bytes": lib.matmul_smem_bytes(*t),
        "ptxas_vec": _ptxas("matmul", "matmul_kernelILi%dELi%dELi%dELb1E" % t),
        "ptxas_scalar": _ptxas("matmul",
                               "matmul_kernelILi%dELi%dELi%dELb0E" % t)}
        for t in mm.TILINGS}
    log(json.dumps({"matmul_templates": templates}))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    per_shape = {}
    for i, shape in enumerate(MM_SHAPES + [MM_RAGGED_SHAPE]):
        M, K, N = shape
        x, w = _mm_inputs(shape, 30 + i, dev)
        plain = mm.matmul_reference(x, w)
        tf32 = torch.matmul(_tf32_round(x), _tf32_round(w))
        rec = {"max_rel_err": {}, "max_abs_err": 0.0, "ms": {},
               "tf32_inputs_rel_err": _rel_err([tf32], [plain]),
               "second_launch_bit_identical": True}
        for t in mm.TILINGS:
            cfg = _mm_config(t)
            got = mm.matmul(x, w, config=cfg)
            again = mm.matmul(x, w, config=cfg)
            want = mm.matmul_reference(x, w, cfg)
            torch.cuda.synchronize()
            rec["max_rel_err"]["%dx%dx%d" % t] = _rel_err([got], [want])
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     float((got - want).abs().max()))
            if not torch.equal(got, again):
                fail("matmul is not deterministic at %s, tiling %s: a "
                     "second launch differs" % (shape, t))
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
        del x, w, plain, tf32, got, again, want
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
    seconds) and {population: the rung the race cached, with its
    margin}."""
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
    # which rung the race cached at each population, and by how much the
    # best of the other kind was slower
    cached = {}
    for row in table:
        kernel_ms = {t: v for t, v in row["tiling_ms"].items()
                     if v is not None}
        best = min(kernel_ms, key=kernel_ms.get) if kernel_ms else None
        stock = (row["winner"] or {}).get("use") == "xla"
        won, other = ((row["stock_ms"], kernel_ms.get(best)) if stock
                      else (kernel_ms.get(best), row["stock_ms"]))
        cached[row["sig"]] = {
            "rung": "stock" if stock else "kernel",
            "config": row["winner"], "best_kernel_tiling": best,
            "winner_ms": won, "runner_up_ms": other,
            "margin": (other / won - 1.0) if won and other else None}
    log(json.dumps({"tune_race_cached": cached}))
    if len(rows) != len(MM_SHAPES):
        fail("the tune race found %d populations, expected the %d gemm "
             "shapes of the LM step" % (len(rows), len(MM_SHAPES)))
    bad = [(row["sig"], r["config"], r["status"], r["note"])
           for row in rows for r in row["records"] if r["status"] != "ok"]
    if bad:
        fail("the tune race skipped %d candidate(s): %s" % (len(bad), bad))
    return rows, cached


def _tiling_grad_sweep(dev, work, rows):
    """Step 1's gradients of the LM at each of the 12 matmul tilings (a
    winner cache of its own naming that tiling at all three gemm
    populations), each run from the same parameters and held against
    the float64 reference as _grad_check holds the tuned run's: every
    tiling must be within TUNED_GRAD_REL_TOL, so that phase 8's check
    holds whichever tiling the race caches. The float32 reference's
    reading is logged beside it, with the tiling's race time over the
    race's best kernel time at each population."""
    from paddle_tpu_torch import kernels, tune
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.kernels import matmul as mm
    _, cfg, spec, trainer, main_prog = _lm_build(dev)
    L = cfg.num_layers
    want_launches = dict(_no_launches(), flash_attention_fwd=2 * L,
                         flash_attention_bwd_dkv=L,
                         flash_attention_bwd_dq=L,
                         matmul=sum(MM_COUNTS) * L)
    race = {}
    for row in rows:
        ms = {"%(block_m)dx%(block_n)dx%(block_k)d" % r["config"]:
              r["seconds"] for r in row["records"]
              if r["config"].get("use") != "xla"}
        race[row["sig"]] = {t: v / min(ms.values()) for t, v in ms.items()}
    sweep = {}
    with scope_guard(Scope()):
        trainer._maybe_init()
        scope = global_scope()
        params = [p.name for p in main_prog.all_parameters()]
        start = {n: scope.find_var(n).clone() for n in params}
        feed = trainer.feeder.feed(next(iter(spec["reader"]())))
        ref_name = _ref_names(_up_biases(main_prog, L))
        ref_params = {ref_name.get(n, n): t for n, t in start.items()}
        want = {kind: _reference_grads(ref_params, feed, cfg, dtype=dtype)[0]
                for kind, dtype in (("float64", torch.float64),
                                    ("float32", torch.float32))}
        try:
            for t in mm.TILINGS:
                tag = "%dx%dx%d" % t
                cache_dir = _fresh_dir(os.path.join(work, "tune_sweep"))
                cache = tune.WinnerCache(cache_dir)
                for row in rows:
                    cache.put(tune.cache_key(tune.device_kind(), "matmul",
                                             row["sig"]), _mm_config(t))
                FLAGS.tune_cache_dir = cache_dir
                tune.clear_memory_cache()
                for n in params:
                    scope.set_var(n, start[n].clone())
                kernels.reset_launches()
                # per-op: a compiled step would replay the first
                # tiling's kernels whatever the cache says
                outs = trainer.exe.run(main_prog, feed=feed, fetch_list=[
                    n + "@GRAD" for n in params], return_numpy=False,
                    use_jit=False)
                torch.cuda.synchronize()
                launches = kernels.launch_counts()
                got = dict(zip(params, outs))
                del outs
                sweep[tag] = {kind: _grad_stats(got, w, ref_name)
                              for kind, w in want.items()}
                sweep[tag]["race_ms_over_best"] = {
                    sig: r[tag] for sig, r in race.items()}
                del got
                if launches != want_launches:
                    fail("gradient sweep at %s: launch counts %s, expected "
                         "%s" % (tag, launches, want_launches))
        finally:
            FLAGS.tune_cache_dir = TUNE_EMPTY_DIR
            tune.clear_memory_cache()
    del want, trainer
    torch.cuda.empty_cache()
    log(json.dumps({"tuned_grad_sweep": {"tolerance_rel": TUNED_GRAD_REL_TOL,
                                         "gate": "float64",
                                         "tilings": sweep}}))
    bad = {t: r["float64"]["norm_rel_err"] for t, r in sweep.items()
           if not r["float64"]["norm_rel_err"] <= TUNED_GRAD_REL_TOL}
    if bad:
        fail("step-1 gradients differ from the float64 autograd reference "
             "by more than %g (relative norm) at tilings %s"
             % (TUNED_GRAD_REL_TOL, bad))
    return sweep


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
    trainer.exe.close()
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_tune(dev, root, train5):
    """The autotune path: the matmul kernel against its plain version,
    the wall-clock race of the tune verb, step 1's gradients at every
    tiling, 8 Adam steps of GPT-2 small against a cache of the race's
    fastest kernel tilings (held against phase 5's losses), and the
    conv3x3 consult on ResNet-50."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    before = tune.counters()
    log(json.dumps({"tune_counters_phases_1_to_7": before}))
    if before["tune_hits"] != 0:
        fail("phases 1-7 hit the tune cache %d times: a stray winner "
             "rerouted them" % before["tune_hits"])
    work = os.path.join(root, "build", "chip_smoke")
    per_shape = _matmul_kernel_check(dev)
    rows, race_cached = _tune_race(root, work)
    sweep = _tiling_grad_sweep(dev, work, rows)
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
        "race_cached": race_cached,
        "grad_sweep": {t: r["float64"]["norm_rel_err"]
                       for t, r in sweep.items()},
        "phase5_losses": train5["losses"],
        "losses_max_rel_err_vs_phase5": loss_rel,
        "loss_tolerance_rel": LOSS_REL_TOL,
        "phase5_step_ms_p50": train5["step_ms_p50"],
        "phase5_tokens_per_s": train5["tokens_per_s"],
        "phase5_peak_memory_bytes": train5["peak_memory_bytes"]})
    log(json.dumps({"tuned_train": rec}))
    # the consults run where the lowerings run: the warm-up and the
    # capture, not the replays (ROADMAP Queue 3 #4)
    traces = rec["traces"]
    if rec["tune"] != {"tune_hits": per_layer * L * traces,
                       "tune_misses": 0, "tune_fallbacks": traces}:
        fail("tuned train tune counters %s over %d steps (%d traced), "
             "expected %d hits and 1 fallback a traced step"
             % (rec["tune"], steps, traces, per_layer * L))
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
    return {"matmul": entry}, rec["launches"], consult, rec


# -- phase 9 -----------------------------------------------------------------

def _bf16_ulp(m):
    """One bfloat16 ulp at magnitude ``m`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _face_err(got, want):
    """(largest error, its tolerance) of a bfloat16 face's output against
    its plain version: one bfloat16 ulp of the largest magnitude for a
    bfloat16 output, AMP_F32_REL_TOL of it for a float32 one."""
    err = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    tol = _bf16_ulp(m) if want.dtype == torch.bfloat16 \
        else AMP_F32_REL_TOL * max(1.0, m)
    return err, tol


def bf16_bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the flops over the tensor cores' dense bfloat16 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_step_sums_conv(x, w, ck=64):
    """The plain forward with the running sum rounded to bfloat16 after
    each k step (a tap's ``ck`` channels: the wgmma face's 64-deep
    stage): what a bfloat16 accumulator would give, which must miss the
    faces' tolerance."""
    from paddle_tpu_torch.kernels import conv3x3
    N, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy, dx, patch in conv3x3._taps(xp, H, W):
        for c0 in range(0, C, ck):
            t = patch[:, c0:c0 + ck].float() @ w[dy, dx, c0:c0 + ck].float()
            acc = (t if acc is None else acc.float() + t).bfloat16()
    return acc.reshape(N, H, W, w.shape[3])


def _bf16_step_sums_mm(x, w, bk=64):
    """The plain gemm with the running sum rounded to bfloat16 after each
    k tile (the wgmma face's 64-deep stage)."""
    acc = None
    for k0 in range(0, x.shape[1], bk):
        t = x[:, k0:k0 + bk].float() @ w[k0:k0 + bk].float()
        acc = (t if acc is None else acc.float() + t).bfloat16()
    return acc


def _flash_bf16_err(got, want):
    """(largest error over one bfloat16 ulp of the largest magnitude,
    largest error of an element over one ulp of its own magnitude plus
    BWD_REL_TOL of the largest, elements that differ) of a bfloat16
    output against its plain version; both ratios at most 1 pass."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    m = float(w.abs().max())
    mag = w.abs()
    own = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7),
        torch.zeros_like(mag))
    return (float(err.max()) / _bf16_ulp(m),
            float((err / (own + BWD_REL_TOL * m)).max()),
            int(torch.count_nonzero(err)))


def _bf16_scores_forward(q, k, v, causal):
    """The plain forward as the port first computed it on bfloat16:
    scores, softmax and p v each written in bfloat16. Must miss the
    faces' tolerance."""
    S, D = q.shape[1], q.shape[3]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        vh).transpose(1, 2)


def _bf16_state_lstm(xs, w, h0, c0, mask):
    """The LSTM recurrence with h and c carried in bfloat16, rounded
    every step, its arithmetic in float32: another function than the
    bfloat16 face's, which must miss the face's tolerance."""
    D = w.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xs.shape[0]):
        g = xs[t].float() + h.float() @ w
        cand, i, f, o = (torch.tanh(g[:, :D]), torch.sigmoid(g[:, D:2 * D]),
                         torch.sigmoid(g[:, 2 * D:3 * D]),
                         torch.sigmoid(g[:, 3 * D:]))
        c_new = f * c.float() + i * cand
        m = mask[t][:, None]
        h = (o * torch.tanh(c_new) * m + h.float() * (1.0 - m)).bfloat16()
        c = (c_new * m + c.float() * (1.0 - m)).bfloat16()
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def _amp_lstm_check(dev, flush):
    """Row 7-bf16, the fused LSTM's bfloat16 face, against the plain
    recurrence on the same bfloat16 operands (float32 w and mask) at the
    slice's shape (ragged and full), the odd one and RNN_EDGE_SHAPES:
    hs and cs within one ulp of each element's own magnitude
    (:func:`_flash_bf16_err`), each launched twice (the second launch
    bit-identical); the recurrence carrying h and c in bfloat16 must
    miss at the slice's shape. At the slice's shape (full lengths) the
    face's time, the cast-around yardstick's (xs, h0 and c0 widened, the
    float32 face, hs and cs rounded: one timed call), the plain
    version's and cuDNN's LSTM on bfloat16 (its weights and state
    rounded to bfloat16: not the same function, its error reported), the
    bound and the registers of the face's three forms. Returns the
    kernels line's entry."""
    from paddle_tpu_torch.kernels import fused_lstm
    bf = torch.bfloat16

    def face_args(T, N, D, seed, ragged):
        xs, w, h0, c0, mask = _rnn_inputs(4, T, N, D, seed, ragged, dev)
        return [xs.to(bf), w, h0.to(bf), c0.to(bf), mask]

    checks = []
    for seed, (T, N, D) in enumerate((RNN_SHAPE, RNN_ODD_SHAPE)
                                     + RNN_EDGE_SHAPES):
        for ragged in (True, False):
            args = face_args(T, N, D, 70 + seed, ragged)
            got = fused_lstm.fused_lstm(*args)
            again = fused_lstm.fused_lstm(*args)
            want = fused_lstm.fused_lstm_reference(*args)
            torch.cuda.synchronize()
            errs = [_flash_bf16_err(g, w_) for g, w_ in zip(got, want)]
            rec = {"shape": [T, N, D], "ragged": ragged,
                   "dtypes": [str(g.dtype) for g in got],
                   "max_abs_err": max(float((g.double() - w_.double())
                                            .abs().max())
                                      for g, w_ in zip(got, want)),
                   "max_err_over_ulp_of_max": max(e[0] for e in errs),
                   "max_err_over_own_tol": max(e[1] for e in errs),
                   "elements_differing": sum(e[2] for e in errs),
                   "second_launch_bit_identical": all(
                       torch.equal(a, b) for a, b in zip(got, again))}
            if (T, N, D) == RNN_SHAPE:
                control = _bf16_state_lstm(*args)
                rec["bf16_state_err_over_own_tol"] = min(
                    _flash_bf16_err(c, w_)[1] for c, w_ in zip(control,
                                                               want))
                del control
            checks.append(rec)
            log(json.dumps({"fused_lstm_bf16_check": rec}))
            if rec["dtypes"] != ["torch.bfloat16"] * 2:
                fail("fused_lstm_bf16 wrote %s" % rec["dtypes"])
            if not rec["max_err_over_own_tol"] <= 1:
                fail("fused_lstm_bf16 disagrees with the plain recurrence at "
                     "%s: %g of its tolerance" % (rec["shape"],
                                                  rec["max_err_over_own_tol"]))
            if not rec["second_launch_bit_identical"]:
                fail("fused_lstm_bf16: a second launch at %s is not "
                     "bit-identical to the first" % (rec["shape"],))
            if (T, N, D) == RNN_SHAPE and \
                    not rec["bf16_state_err_over_own_tol"] > 1:
                fail("a recurrence carrying h and c in bfloat16 errs by only "
                     "%g of the tolerance: it cannot tell the face from it"
                     % rec["bf16_state_err_over_own_tol"])
            del args, got, again, want
    T, N, D = RNN_SHAPE
    xs, w, h0, c0, mask = args = face_args(T, N, D, 70, False)
    # the bound: each input read once (xs, h0, c0 in bfloat16; w and the
    # mask in float32), hs and cs written once in bfloat16; the recurrent
    # products of every step (full lengths), in 3xTF32 on float32 W
    nbytes = 2 * (xs.numel() + h0.numel() + c0.numel() + 2 * T * N * D) \
        + 4 * (w.numel() + mask.numel())
    flops = 2 * T * N * D * 4 * D

    def cast_around():
        hs, cs = fused_lstm._launch(xs.float(), w, h0.float(), c0.float(),
                                    mask)
        return hs.to(bf), cs.to(bf)

    lib = _cudnn_lstm(xs, w, h0, c0)
    plain = fused_lstm.fused_lstm_reference(*args)
    rec = {
        "name": "fused_lstm_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_lstm.cu",
        "replaces": "paddle_tpu/kernels/fused_lstm.py:73",
        "role": "the fused LSTM on bfloat16 xs, h0 and c0 with float32 w "
                "and mask (pure AMP, no bias): the state in float32, hs "
                "and cs rounded once, h exchanged between blocks in "
                "float32",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "max_err_over_own_tol": max(c["max_err_over_own_tol"]
                                    for c in checks),
        "tolerance": "one bfloat16 ulp of each element's own magnitude "
                     "plus %g of the largest" % BWD_REL_TOL,
        "bf16_state_min_err_over_own_tol": min(
            c["bf16_state_err_over_own_tol"] for c in checks
            if "bf16_state_err_over_own_tol" in c),
        "ms": time_ms(lambda: fused_lstm._launch(*args), flush=flush),
        "cast_around_ms": time_ms(cast_around, flush=flush),
        "plain_ms": time_ms(lambda: fused_lstm.fused_lstm_reference(*args),
                            iters=5, flush=flush),
        "bound_ms": tc_bound(nbytes, flops), "bound_by": "operations",
        "f32_bound_ms": bound(nbytes, flops)[0],
        "library_ms": time_ms(lib, flush=flush),
        "library_max_abs_err": float((lib() - plain[0]).abs().max()),
        "library": "cuDNN torch.nn.LSTM on bfloat16 (weights and state "
                   "rounded to bfloat16), one layer, input 4D with a "
                   "gate-permuting identity input weight (one extra "
                   "[T*N, 4D] x [4D, 4D] GEMM), no biases, unmasked",
        "launch": fused_lstm.launch_plan(N, D),
        "ptxas": _rnn_ptxas("fused_lstm", "13__nv_bfloat16"),
        "shape": {"T": T, "N": N, "D": D, "timed_lengths": "all T"},
        "checks": checks}
    log(json.dumps({"fused_lstm_bf16": {k: v for k, v in rec.items()
                                        if k != "checks"}}))
    del args, xs, w, h0, c0, mask, lib, plain
    torch.cuda.empty_cache()
    return rec


def _p_rounded_flash(q, k, v, do, causal):
    """A plain emulation of faces that round p and ds to one bfloat16
    each (FlashAttention-2's products, where the faces split them into
    two): ``exp(s - rowmax)`` rounded before p v and divided by its
    float32 sum, p and ds rounded before p^T dO, ds k and ds^T q.
    Returns (o, (dq, dk, dv)), rounded to bfloat16; reported, not
    gated."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    S, D = q.shape[1], q.shape[3]
    scale = D ** -0.5
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", e.bfloat16().float(), vh) \
        / e.sum(dim=-1, keepdim=True)
    del e
    o = o.transpose(1, 2).bfloat16()
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    delta = fa._delta(o, do, None)
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
    p = p.bfloat16().float()
    grads = (torch.einsum("bhqk,bhkd->bhqd", ds, kh),
             torch.einsum("bhqk,bhqd->bhkd", ds, qh),
             torch.einsum("bhqk,bhqd->bhkd", p, doh))
    return o, tuple(g.transpose(1, 2).bfloat16() for g in grads)


def _amp_flash_check(dev, flush):
    """Rows 2-4's bfloat16 faces against their plain versions at
    FLASH_BF16_CASES: o, dq, dk and dv within one ulp
    (:func:`_flash_bf16_err`, the count of elements that differ
    reported), lse within KERNEL_TOL, each kernel launched twice (the
    second launch bit-identical), the bfloat16-score forward shown to
    miss, the error of faces that round p and ds to one bfloat16
    reported; at B 8 and B 1 the kernels', the plain versions' and SDPA's
    (on bfloat16) times and the bfloat16 bound, and the backward's
    parent design (its mma.sync kernels forced at D 64) and device
    times beside them; at the D 128 case the mma.sync path's times;
    every template's registers, spills and shared memory, each path held
    to its mirror. Returns the six entries of the kernels line."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    rng = np.random.RandomState(14)
    per_case = {}
    for B, S, H, D, causal in FLASH_BF16_CASES:
        scale = D ** -0.5
        q, k, v, do = [torch.from_numpy(rng.randn(B, S, H, D).astype(
            np.float32)).to(dev).bfloat16() for _ in range(4)]
        # the forward's path: the library's rule, the mirror's, and the
        # counter its two launches land on
        path = fa.fwd_bf16_path(D)
        if fa.kernel_fwd_bf16_path(D) != path:
            fail("flash bf16 forward at D %d takes the %s path, its mirror "
                 "says %s" % (D, fa.kernel_fwd_bf16_path(D), path))
        kernels.reset_launches()
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        o2, lse2 = fa.flash_attention_with_lse(q, k, v, causal=causal)
        counts = {n: c for n, c in kernels.launch_counts().items() if c}
        want_counts = {"flash_attention_fwd_bf16" + (
            "" if path == "wgmma" else "_mma"): 2}
        if counts != want_counts:
            fail("flash bf16 forward at D %d (%s path) counted %s, expected "
                 "%s" % (D, path, counts, want_counts))
        # the backward's path likewise: both kernels, twice each
        bwd_path = fa.bwd_bf16_path(D)
        if fa.kernel_bwd_bf16_path(D) != bwd_path:
            fail("flash bf16 backward at D %d takes the %s path, its mirror "
                 "says %s" % (D, fa.kernel_bwd_bf16_path(D), bwd_path))
        kernels.reset_launches()
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        counts = {n: c for n, c in kernels.launch_counts().items() if c}
        tail = "" if bwd_path == "wgmma" else "_mma"
        want_counts = {"flash_attention_bwd_dkv_bf16" + tail: 2,
                       "flash_attention_bwd_dq_bf16" + tail: 2}
        if counts != want_counts:
            fail("flash bf16 backward at D %d (%s path) counted %s, "
                 "expected %s" % (D, bwd_path, counts, want_counts))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal=causal)
        torch.cuda.synchronize()
        case = "B%d_S%d_D%d_%s" % (B, S, D, "causal" if causal else "full")
        rec = {"B": B, "S": S, "H": H, "D": D, "causal": causal,
               "fwd_path": path, "bwd_path": bwd_path,
               "lse_max_abs_err": float((lse - lse_ref).abs().max()),
               "lse_tolerance": KERNEL_TOL,
               "relaunch_bit_identical": {
                   "fwd": bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
                   **{n: bool(torch.equal(g, a)) for n, g, a in
                      zip(("dq", "dk", "dv"), grads, again)}}}
        names = ("o", "dq", "dk", "dv")
        for n, g, w in zip(names, (o,) + tuple(grads), (o_ref,) + want):
            if g.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
                fail("flash bf16 %s at %s is %s, its plain version %s"
                     % (n, case, g.dtype, w.dtype))
            max_ulps, own_ulps, differ = _flash_bf16_err(g, w)
            rec[n] = {"max_abs_err": float((g.double() - w.double()).abs()
                                           .max()),
                      "err_over_max_ulp": max_ulps,
                      "err_over_own_tol": own_ulps,
                      "elements_differ": differ, "elements": g.numel()}
            if not (max_ulps <= 1 and own_ulps <= 1):
                fail("flash bf16 %s disagrees with its plain version at %s: "
                     "%g ulps of the largest, %g of its own tolerance"
                     % (n, case, max_ulps, own_ulps))
        if not rec["lse_max_abs_err"] <= KERNEL_TOL:
            fail("flash bf16 lse disagrees with its plain version at %s: %g "
                 "> %g" % (case, rec["lse_max_abs_err"], KERNEL_TOL))
        if not all(rec["relaunch_bit_identical"].values()):
            fail("flash bf16 relaunched at %s differs from its first launch: "
                 "%s" % (case, rec["relaunch_bit_identical"]))
        old = _flash_bf16_err(_bf16_scores_forward(q, k, v, causal), o_ref)
        rec["bf16_scores_forward"] = {"err_over_max_ulp": old[0],
                                      "err_over_own_tol": old[1],
                                      "elements_differ": old[2]}
        if not max(old[:2]) > 1:
            fail("at %s a forward with bfloat16 scores errs by only %s: the "
                 "tolerance cannot tell it from the face" % (case, old))
        po, pg = _p_rounded_flash(q, k, v, do, causal)
        rec["p_ds_rounded_once"] = {
            n: dict(zip(("err_over_max_ulp", "err_over_own_tol",
                         "elements_differ"), _flash_bf16_err(g, w)))
            for n, g, w in zip(names, (po,) + pg, (o_ref,) + want)}
        del po, pg, o2, lse2, again
        rec["smem_bytes"] = {
            "fwd": fa.kernel_fwd_smem_bytes(D, "bf16"),
            "dkv": fa.kernel_bwd_smem_bytes(D, "dkv", "bf16"),
            "dq": fa.kernel_bwd_smem_bytes(D, "dq", "bf16")}
        mirror = {"fwd": fa.fwd_bf16_smem_bytes(D),
                  "dkv": fa.bwd_bf16_smem_bytes(D, "dkv"),
                  "dq": fa.bwd_bf16_smem_bytes(D, "dq")}
        if rec["smem_bytes"] != mirror:
            fail("the flash bf16 faces at D %d take %s bytes of shared "
                 "memory, their mirrors say %s" % (D, rec["smem_bytes"],
                                                   mirror))
        rec["ptxas"] = {
            "fwd": _ptxas("flash_attention_fwd",
                          "flash_fwd_bf16_wgmma_kernel" if path == "wgmma"
                          else "flash_fwd_bf16_mma_kernelILi%dE" % D),
            **{which: _ptxas("flash_attention_bwd",
                             "flash_bwd_%s_bf16_wgmma_kernel" % which
                             if bwd_path == "wgmma" else
                             "flash_bwd_%s_bf16_mma_kernelILi%dE" % (which, D))
               for which in ("dkv", "dq")}}
        for which, lines in rec["ptxas"].items():
            if not lines or any(part.split()[0] != "0" for ln in lines
                                for part in ln.split(",") if "spill" in part):
                fail("the flash bf16 %s template at D %d spills (or has no "
                     "ptxas lines): %s" % (which, D, lines))
        # the forward at every case: kernel, the face's parent design (the
        # mma.sync kernel, forced at D 64), plain, SDPA on bfloat16, bound
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * S
        fwd_work = (B * H * (4 * S * D * 2 + S * 4), B * H * pairs * 4 * D)
        b_ms, b_by = bf16_bound(*fwd_work)
        rec["fwd_times"] = {
            "ms": time_ms(lambda: fa.flash_attention_with_lse(
                q, k, v, causal=causal), flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal=causal), flush=flush),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by}
        if path == "wgmma":
            rec["fwd_times"]["parent_ms"] = time_ms(
                lambda: fa._launch_fwd(q, k, v, causal, scale, mma=True),
                flush=flush)
        if S == 1024:
            # the kernels' own device time (the profiler): at B 1 a CUDA
            # event pair around the call also reads the host's launch path
            rec["fwd_times"].update({
                "device_ms": _device_ms(
                    lambda: fa.flash_attention_with_lse(q, k, v,
                                                        causal=causal),
                    "flash_fwd_bf16_wgmma_kernel", flush),
                "parent_device_ms": _device_ms(
                    lambda: fa._launch_fwd(q, k, v, causal, scale,
                                           mma=True),
                    "flash_fwd_bf16_mma_kernel", flush),
                "library_device_ms": _device_ms_all(
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=causal), flush)})
        del qh, kh, vh
        if S == 1024 or D == 128:
            # the backward at the LM step's and the prefill's shapes (the
            # wgmma path, its parent design beside it), and at the D 128
            # case (the mma.sync path)
            delta = fa._delta(o, do, None).contiguous()
            pairs = S * (S + 1) // 2 if causal else S * S
            head, vec = S * D * 2, S * 4
            work = {"dkv": (B * H * (6 * head + 2 * vec),
                            B * H * pairs * 8 * D),
                    "dq": (B * H * (5 * head + 2 * vec),
                           B * H * pairs * 6 * D)}
            qh, kh, vh = (t.transpose(1, 2).detach().clone()
                          .requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                     is_causal=causal)
            doh = do.transpose(1, 2)
            args = (q, k, v, do, lse, delta, causal, scale)

            def sdpa_bwd():
                return torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                           retain_graph=True)
            rec["times"] = {
                "dkv_ms": time_ms(lambda: fa._bwd_dkv(*args), flush=flush),
                "dq_ms": time_ms(lambda: fa._bwd_dq(*args), flush=flush),
                "bwd_plain_ms": time_ms(
                    lambda: fa.flash_attention_bwd_reference(
                        q, k, v, o, lse, do, causal=causal), flush=flush),
                "bwd_library_ms": time_ms(sdpa_bwd, flush=flush)}
            if bwd_path == "wgmma":
                # the faces' parent design: the mma.sync kernels forced at
                # D 64, same operands; and every time by the profiler too
                t = rec["times"]
                for which, fn in (("dkv", fa._bwd_dkv), ("dq", fa._bwd_dq)):
                    t[which + "_parent_ms"] = time_ms(
                        lambda: fn(*args, mma=True), flush=flush)
                    t[which + "_device_ms"] = _device_ms(
                        lambda: fn(*args),
                        "flash_bwd_%s_bf16_wgmma_kernel" % which, flush)
                    t[which + "_parent_device_ms"] = _device_ms(
                        lambda: fn(*args, mma=True),
                        "flash_bwd_%s_bf16_mma_kernel" % which, flush)
                t["bwd_library_device_ms"] = _device_ms_all(sdpa_bwd, flush)
            rec["bound"] = {}
            for kname, (nbytes, flops) in work.items():
                b_ms, b_by = bf16_bound(nbytes, flops)
                rec["bound"][kname] = {"ms": b_ms, "by": b_by,
                                       "bytes": nbytes, "flops": flops}
            del delta, qh, kh, vh, lib_out, args
        log(json.dumps({"flash_bf16_check": {case: rec}}))
        per_case[case] = rec
        del q, k, v, do, o, lse, grads, o_ref, lse_ref, want
    torch.cuda.empty_cache()
    lm = per_case["B8_S1024_D64_causal"]
    prefill = per_case["B1_S1024_D64_causal"]
    # the forward's mma.sync path is timed at the D 128 case
    mma_case = per_case["B2_S130_D128_causal"]
    tolerance = ("one bfloat16 ulp: every element within one ulp of its own "
                 "magnitude plus %g of the largest, the largest error within "
                 "one ulp of the largest magnitude" % BWD_REL_TOL)
    out = {}
    for name, line, key, what, split in (
            ("flash_attention_fwd_bf16", 119, "fwd", ("o",), 1.5),
            ("flash_attention_fwd_bf16_mma", 119, "fwd_mma", ("o",), 1.5),
            ("flash_attention_bwd_dkv_bf16", 231, "dkv", ("dk", "dv"), 1.5),
            ("flash_attention_bwd_dq_bf16", 254, "dq", ("dq",), 4 / 3),
            ("flash_attention_bwd_dkv_bf16_mma", 231, "dkv_mma",
             ("dk", "dv"), 1.5),
            ("flash_attention_bwd_dq_bf16_mma", 254, "dq_mma", ("dq",),
             4 / 3)):
        fwd = key.startswith("fwd")
        mma = key.endswith("_mma")
        cases = {c: r for c, r in per_case.items()
                 if r["fwd_path" if fwd else "bwd_path"] ==
                 ("mma" if mma else "wgmma")}
        entry = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_%s.cu"
                      % ("fwd" if fwd else "bwd"),
            "replaces": "paddle_tpu/kernels/flash_attention.py:%d" % line,
            "role": "the bfloat16 face (pure AMP): bfloat16 q, k, v%s, "
                    "float32 arithmetic, %s rounded once to bfloat16; %s"
                    % ("" if fwd else " and dO", "/".join(what),
                       "D 32 and 128: the mma.sync kernel" if mma else
                       "D 64: the TMA-fed, warp-specialised wgmma kernel"),
            "max_abs_err": max(r[n]["max_abs_err"] for r in cases.values()
                               for n in what),
            "max_err_over_tol": max(max(r[n]["err_over_max_ulp"],
                                        r[n]["err_over_own_tol"])
                                    for r in cases.values() for n in what),
            "tolerance": tolerance,
            "bf16_scores_forward_min_err_over_tol": min(
                max(r["bf16_scores_forward"]["err_over_max_ulp"],
                    r["bf16_scores_forward"]["err_over_own_tol"])
                for r in cases.values()),
            "p_ds_rounded_once_max_err_over_tol": max(
                max(r["p_ds_rounded_once"][n]["err_over_max_ulp"],
                    r["p_ds_rounded_once"][n]["err_over_own_tol"])
                for r in cases.values() for n in what),
            "plain": "flash_attention_reference" if fwd else
                     "flash_attention_bwd_reference (dq, dk and dv)",
            "bound_note": "bytes over 3.35 TB/s or flops over 989 TFLOP/s "
                          "dense bf16; the face's split products (p or ds "
                          "as two bfloat16 terms) take %.3gx those flops"
                          % split,
            "library": "scaled_dot_product_attention on bfloat16" if fwd
                       else "autograd.grad through scaled_dot_product_"
                            "attention(is_causal=True) on bfloat16: dq, dk "
                            "and dv, to be compared with the sum of both "
                            "kernels",
            "per_case": {c: {n: r[n] for n in what}
                         for c, r in cases.items()}}
        d128 = {"B": 2, "H": 12, "D": 128, "causal": True, "S": 130}
        if key == "fwd_mma":
            t = mma_case["fwd_times"]
            entry.update({
                "main_path": False,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "shape": d128,
                "per_case_ms": {c: r["fwd_times"] for c, r in cases.items()}})
        elif mma:
            t, kind = mma_case["times"], key[:-4]
            entry.update({
                "main_path": False,
                "ms": t[kind + "_ms"], "plain_ms": t["bwd_plain_ms"],
                "bound_ms": mma_case["bound"][kind]["ms"],
                "bound_by": mma_case["bound"][kind]["by"],
                "library_ms": t["bwd_library_ms"], "shape": d128})
        elif key == "fwd":
            t, t1 = lm["fwd_times"], prefill["fwd_times"]
            entry.update({
                "ms": t["ms"], "parent_ms": t["parent_ms"],
                "parent": "the face's design before its wgmma kernel (the "
                          "mma.sync kernel, forced at D 64) on the same "
                          "operands",
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "shape": {"B": 8, "H": 12, "D": 64, "causal": True,
                          "S": 1024},
                "device_ms": t["device_ms"],
                "parent_device_ms": t["parent_device_ms"],
                "library_device_ms": t["library_device_ms"],
                "prefill_B1": {k: t1[k] for k in (
                    "ms", "parent_ms", "plain_ms", "bound_ms",
                    "library_ms", "device_ms", "parent_device_ms",
                    "library_device_ms")},
                "per_case_ms": {c: r["fwd_times"] for c, r in cases.items()}})
        else:
            t, t1 = lm["times"], prefill["times"]
            entry.update({
                "ms": t[key + "_ms"], "parent_ms": t[key + "_parent_ms"],
                "parent": "the face's design before its wgmma kernel (the "
                          "mma.sync kernel, forced at D 64) on the same "
                          "operands",
                "plain_ms": t["bwd_plain_ms"],
                "bound_ms": lm["bound"][key]["ms"],
                "bound_by": lm["bound"][key]["by"],
                "library_ms": t["bwd_library_ms"],
                "shape": {"B": 8, "H": 12, "D": 64, "causal": True,
                          "S": 1024},
                "device_ms": t[key + "_device_ms"],
                "parent_device_ms": t[key + "_parent_device_ms"],
                "library_device_ms": t["bwd_library_device_ms"],
                "prefill_B1": {
                    "ms": t1[key + "_ms"], "parent_ms": t1[key + "_parent_ms"],
                    "plain_ms": t1["bwd_plain_ms"],
                    "bound_ms": prefill["bound"][key]["ms"],
                    "library_ms": t1["bwd_library_ms"],
                    "device_ms": t1[key + "_device_ms"],
                    "parent_device_ms": t1[key + "_parent_device_ms"],
                    "library_device_ms": t1["bwd_library_device_ms"]}})
        out[name] = entry
    return out


# the bfloat16 face's ragged path is timed at this shape (C 36: not a
# multiple of 8), where the entry point takes it
CONV_RAGGED_SHAPE = (2, 9, 11, 36, 64)


def _amp_conv_templates(dev):
    """The bfloat16 face's templates: the library's shared memory held to
    the mirror's, registers and spills (``-Xptxas -v``) of each wgmma
    tiling and of each ragged one, and the host microseconds that
    encoding the two TMA maps adds to a launch at ResNet-50's stage
    shapes."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv3x3
    lib = _build.load("conv3x3")
    out = {}
    for path, tilings in (("wgmma", conv3x3.TILINGS_BF16),
                          ("ragged", conv3x3.TILINGS)):
        for t in tilings:
            got = conv3x3.kernel_smem_bytes(*t, torch.bfloat16, path)
            want = conv3x3.smem_bytes_wgmma(*t) if path == "wgmma" \
                else conv3x3.smem_bytes(*t, torch.bfloat16)
            if got != want:
                fail("conv3x3 bf16 %s tiling %s: the library's shared "
                     "memory %d, the mirror's %d" % (path, t, got, want))
            if path == "wgmma":
                lines = {"": _ptxas("conv3x3", "conv3x3_bf16_wgmma_kernel"
                                    "ILi%dELi%dE" % t)}
            else:
                lines = {vec: _ptxas("conv3x3", "conv3x3_bf16_ragged_kernel"
                                     "ILi%dELi%dELb%dE" % (t + (b,)))
                         for vec, b in (("vec", 1), ("plain", 0))}
            for kind, ptxas in lines.items():
                out[" ".join(filter(None, (path, "%dx%d" % t, kind)))] = {
                    "smem_bytes": got, "ptxas": ptxas}
    # the wgmma kernel's templates may not spill; the ragged path's are
    # the face's first kernel, unchanged (its 128 x 128 cp.async form
    # spilled 24 bytes there too, and no main path takes it), reported
    for key, rec in out.items():
        if not rec["ptxas"] or (key.startswith("wgmma") and any(
                part.split()[0] != "0" for ln in rec["ptxas"]
                for part in ln.split(",") if "spill" in part)):
            fail("a conv3x3 bf16 wgmma template spills (or a template has "
                 "no ptxas lines): %s" % out)
    fn = lib.conv3x3_bf16_encode_us
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    fn.restype = ctypes.c_double
    encode = {}
    for N, H, W, C, O in R50_CONV_SHAPES:
        x = torch.empty(N, H, W, C, dtype=torch.bfloat16, device=dev)
        w = torch.empty(3, 3, C, O, dtype=torch.bfloat16, device=dev)
        for bm in (64, 128):
            us = fn(x.data_ptr(), w.data_ptr(), N, H, W, C, O, bm, 2000)
            if not us > 0:
                fail("encoding the conv3x3 bf16 TMA maps failed at %s"
                     % ((N, H, W, C, O),))
            encode["%dx%dx%dx%dx%d bm %d" % (N, H, W, C, O, bm)] = us
    return {"templates": out, "host_us_to_encode_the_maps": encode}


def _amp_conv_check(dev, flush):
    """Row 6's bfloat16 face against its plain version at ResNet-50's
    stage shapes (batch 32) and the edge shapes: the forward with a
    bfloat16 and a float32 output and dx on the rotated filter, each
    launched twice (bit-identical) and counted on the path its shape
    takes, the path and tiling held to the rule's mirror, the bfloat16
    step-sum variant shown to miss; the face's, its parent design's (the
    ragged path's mma.sync kernel, which the face ran before its wgmma
    kernel, timed in the same call), the plain version's, cuDNN on
    bfloat16's and the bound's times at the stage shapes, and the ragged
    path's at CONV_RAGGED_SHAPE. Returns the four entries of the kernels
    line."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import conv3x3
    F = torch.nn.functional
    log(json.dumps({"conv3x3_bf16_templates": _amp_conv_templates(dev)}))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_shape = {}
    for i, shape in enumerate(R50_CONV_SHAPES + CONV_EDGE_SHAPES):
        N, H, W, C, O = shape
        x, w, g = (t.bfloat16() for t in _conv_inputs(shape, 90 + i, dev))
        w_rot = conv3x3.rotate_filter(w)
        tilings = {"fwd": conv3x3.kernel_tiling(N, H, W, C, O,
                                                torch.bfloat16),
                   "dx": conv3x3.kernel_tiling(N, H, W, O, C,
                                               torch.bfloat16)}
        mirror = {"fwd": conv3x3.tiling_bf16(N, H, W, C, O, sms),
                  "dx": conv3x3.tiling_bf16(N, H, W, O, C, sms)}
        if tilings != mirror:
            fail("conv3x3 bf16 at %s took the paths and tilings %s, the "
                 "rule's mirror says %s" % (shape, tilings, mirror))
        got, counts = {}, {}
        for k, call in (
                ("fwd", lambda: conv3x3.conv3x3_s1_nhwc(x, w)),
                ("fwd_f32", lambda: conv3x3.conv3x3_s1_nhwc(
                    x, w, torch.float32)),
                ("dx", lambda: conv3x3.conv3x3_bwd(x, w, g,
                                                   want_dw=False)[0])):
            kernels.reset_launches()
            got[k] = call()
            counts[k] = {n: c for n, c in kernels.launch_counts().items()
                         if c}
            role = "dx" if k == "dx" else "fwd"
            path = tilings[role][0]
            want_count = {"conv3x3_%s_bf16%s" % (
                role, "_ragged" if path == "ragged" else ""): 1}
            if counts[k] != want_count:
                fail("conv3x3 bf16 %s at %s counted %s, its path %s wants "
                     "%s" % (k, shape, counts[k], path, want_count))
        again = {"fwd": conv3x3._launch(x, w),
                 "fwd_f32": conv3x3._launch(x, w, torch.float32),
                 "dx": conv3x3._launch(g, w_rot)}
        want = {"fwd": conv3x3.conv3x3_reference(x, w),
                "fwd_f32": conv3x3.conv3x3_reference(x, w, torch.float32),
                "dx": conv3x3.conv3x3_reference(g, w_rot)}
        torch.cuda.synchronize()
        rec = {"path": {k: t[0] for k, t in tilings.items()},
               "tiling": {k: "%dx%d" % t[1] for k, t in tilings.items()},
               "relaunch_bit_identical": all(
                   torch.equal(got[k], again[k]) for k in got)}
        for k in got:
            if got[k].dtype != want[k].dtype:
                fail("conv3x3 bf16 %s at %s wrote %s, its plain version %s"
                     % (k, shape, got[k].dtype, want[k].dtype))
            err, tol = _face_err(got[k], want[k])
            rec[k + "_max_abs_err"], rec[k + "_tol"] = err, tol
            if not err <= tol:
                fail("conv3x3 bf16 %s disagrees with its plain version at "
                     "%s: %g > %g" % (k, shape, err, tol))
        if not rec["relaunch_bit_identical"]:
            fail("conv3x3 bf16 relaunched at %s differs from its first "
                 "launch" % (shape,))
        tag = "x".join(str(d) for d in shape)
        per_shape[tag] = rec
        b_ms, b_by = bf16_bound(2 * (N * H * W * (C + O) + 9 * C * O),
                                2 * N * H * W * C * O * 9)
        timed = shape in R50_CONV_SHAPES or shape == CONV_RAGGED_SHAPE
        if shape in R50_CONV_SHAPES:
            step_sums = _bf16_step_sums_conv(x, w)
            rec["bf16_step_sums_max_abs_err"], _ = _face_err(step_sums,
                                                             want["fwd"])
            if not rec["bf16_step_sums_max_abs_err"] > rec["fwd_tol"]:
                fail("at %s a conv summed in bfloat16 errs by only %g <= "
                     "one ulp %g: the tolerance cannot tell the face from "
                     "it" % (shape, rec["bf16_step_sums_max_abs_err"],
                             rec["fwd_tol"]))
            del step_sums
            # the parent's design: the face's first kernel, now its
            # ragged path, on the same aligned operands
            rec.update({
                "fwd_parent_ms": time_ms(
                    lambda: conv3x3._launch(x, w, None, "ragged"),
                    flush=flush),
                "dx_parent_ms": time_ms(
                    lambda: conv3x3._launch(g, w_rot, None, "ragged"),
                    flush=flush)})
        if timed:
            x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rec.update({
                "fwd_ms": time_ms(lambda: conv3x3._launch(x, w),
                                  flush=flush),
                "dx_ms": time_ms(lambda: conv3x3._launch(g, w_rot),
                                 flush=flush),
                "fwd_plain_ms": time_ms(
                    lambda: conv3x3.conv3x3_reference(x, w), flush=flush),
                "dx_plain_ms": time_ms(
                    lambda: conv3x3.conv3x3_reference(
                        g, conv3x3.rotate_filter(w)), flush=flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "fwd_library_ms": time_ms(
                    lambda: F.conv2d(x_cl, w_cl, padding=1), flush=flush),
                "dx_library_ms": time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        g_cl, x_cl, w_cl, None, [1, 1], [1, 1], [1, 1],
                        False, [0, 0], 1, [True, False, False]),
                    flush=flush)})
            del x_cl, g_cl, w_cl
        log(json.dumps({"conv3x3_bf16_check": {"shape": shape, **rec}}))
        del x, w, g, w_rot, got, again, want
    torch.cuda.empty_cache()
    weights = {"x".join(str(d) for d in s_): n
               for s_, n in zip(R50_CONV_SHAPES, R50_CONV_COUNTS)}

    def per_launch(key):
        return sum(per_shape[k][key] * n for k, n in weights.items()) \
            / sum(weights.values())

    by = {b: sum(n for k, n in weights.items()
                 if per_shape[k]["bound_by"] == b)
          for b in ("bytes", "operations")}
    tolerance = ("one bfloat16 ulp of the largest magnitude (bfloat16 "
                 "out); %g of it (float32 out)" % AMP_F32_REL_TOL)
    ragged_tag = "x".join(str(d) for d in CONV_RAGGED_SHAPE)
    out = {}
    for role in ("fwd", "dx"):
        keys = ("fwd", "fwd_f32") if role == "fwd" else ("dx",)
        library = ("cuDNN on bfloat16 through F.conv2d" if role == "fwd"
                   else "cuDNN on bfloat16 through convolution_backward "
                        "(dx only)")
        for path in ("wgmma", "ragged"):
            recs = [r for r in per_shape.values() if r["path"][role] == path]
            name = "conv3x3_%s_bf16%s" % (role, "_ragged" * (path ==
                                                             "ragged"))
            entry = {
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/kernels/csrc/conv3x3.cu",
                "replaces": "paddle_tpu/kernels/conv3x3.py:97",
                "role": ("forward" if role == "fwd" else
                         "dx of the backward, the same face on the rotated "
                         "filter (_vjp_bwd, conv3x3.py:165)")
                + (", bfloat16 operands (AMP): the TMA-fed, "
                   "warp-specialised wgmma implicit GEMM" if path == "wgmma"
                   else ", bfloat16 operands TMA cannot take (C or O not a "
                        "multiple of 8, a misaligned pointer): the "
                        "mma.sync kernel"),
                "max_abs_err": max(r[k + "_max_abs_err"] for r in recs
                                   for k in keys),
                "max_err_over_tol": max(r[k + "_max_abs_err"] / r[k + "_tol"]
                                        for r in recs for k in keys),
                "tolerance": tolerance, "library": library,
                "shapes": [k for k, r in per_shape.items()
                           if r["path"][role] == path]}
            if path == "wgmma":
                entry.update({
                    "bf16_step_sums_min_err_over_tol": min(
                        r["bf16_step_sums_max_abs_err"] / r["fwd_tol"]
                        for r in recs if "bf16_step_sums_max_abs_err" in r),
                    "ms": per_launch(role + "_ms"),
                    "parent_ms": per_launch(role + "_parent_ms"),
                    "plain_ms": per_launch(role + "_plain_ms"),
                    "bound_ms": per_launch("bound_ms"),
                    "bound_by": max(by, key=by.get),
                    "library_ms": per_launch(role + "_library_ms"),
                    "tilings": {k: per_shape[k]["tiling"][role]
                                for k in weights},
                    "timed_as": "mean over a ResNet-50 step's 16 launches: "
                                "the stage shapes weighted 3, 4, 6, 3; "
                                "parent_ms the face's parent design (the "
                                "ragged path's kernel) on the same "
                                "operands",
                    "per_shape": per_shape})
            else:
                r = per_shape[ragged_tag]
                entry.update({
                    "main_path": False,
                    "ms": r[role + "_ms"], "plain_ms": r[role + "_plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r[role + "_library_ms"],
                    "timed_as": "one launch at %s" % (CONV_RAGGED_SHAPE,)})
            out[name] = entry
    return out


def _amp_matmul_templates(dev):
    """The bfloat16 face's templates: the library's shared memory held to
    the mirror's, registers and spills (``-Xptxas -v``) of each wgmma
    tiling and of the ragged path, and the host microseconds that
    encoding the two TMA maps adds to a launch at the LM's shapes."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import matmul as mm
    lib = _build.load("matmul")
    out = {}
    for t in mm.TILINGS_BF16 + (mm.RAGGED_TILING,):
        got = mm.kernel_smem_bytes(*t, dtype=torch.bfloat16)
        if got != mm.smem_bytes(*t, torch.bfloat16):
            fail("matmul bf16 tiling %s: the library's shared memory %d, "
                 "the mirror's %d" % (t, got,
                                      mm.smem_bytes(*t, torch.bfloat16)))
        ragged = t == mm.RAGGED_TILING
        name = ("matmul_bf16_ragged_kernelILi%dELi%dELi%dEE" % t
                if ragged else "matmul_bf16_wgmma_kernelILi%dELi%dE" % t[:2])
        out["ragged %dx%dx%d" % t if ragged else "%dx%dx%d" % t] = {
            "smem_bytes": got, "ptxas": _ptxas("matmul", name)}
    for rec in out.values():
        if not rec["ptxas"] or any(
                part.split()[0] != "0" for ln in rec["ptxas"]
                for part in ln.split(",") if "spill" in part):
            fail("a matmul bf16 template spills (or has no ptxas "
                 "lines): %s" % out)
    fn = lib.matmul_bf16_encode_us
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_double
    encode = {}
    for M, K, N in MM_SHAPES:
        x = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
        w = torch.empty(K, N, dtype=torch.bfloat16, device=dev)
        for bm in (64, 128):
            us = fn(x.data_ptr(), w.data_ptr(), M, N, K, bm, 2000)
            if not us > 0:
                fail("encoding the matmul bf16 TMA maps failed at %s"
                     % ((M, K, N),))
            encode["%dx%dx%d bm %d" % (M, K, N, bm)] = us
    return {"templates": out, "host_us_to_encode_the_maps": encode}


def _amp_matmul_check(dev, flush):
    """Row 5's bfloat16 face against its plain version at every wgmma
    tiling, at the LM step's three gemm shapes, and its ragged path at
    MM_RAGGED_SHAPE (every tiling asked for), with a bfloat16 and a
    float32 output, each launched twice (bit-identical) and counted on
    the path the shape takes; the bfloat16 step-sum variant shown to
    miss; every tiling's, the plain version's, torch.matmul's (bfloat16)
    and the bound's times at the step's shapes, and the ragged path's at
    its shape. Returns {shape: record}."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import matmul as mm
    log(json.dumps({"matmul_bf16_templates": _amp_matmul_templates(dev)}))
    per_shape = {}
    for i, shape in enumerate(MM_SHAPES + [MM_RAGGED_SHAPE]):
        M, K, N = shape
        x, w = (t.bfloat16() for t in _mm_inputs(shape, 95 + i, dev))
        path = "matmul_bf16" if shape in MM_SHAPES else "matmul_bf16_ragged"
        rec = {"path": path, "max_err_over_tol": 0.0, "max_abs_err": 0.0,
               "ms": {}, "relaunch_bit_identical": True}
        for t in mm.TILINGS_BF16:
            cfg = _mm_config(t)
            for out_dtype in (None, torch.float32):
                kernels.reset_launches()
                got = mm.matmul(x, w, out_dtype, cfg)
                again = mm.matmul(x, w, out_dtype, cfg)
                want = mm.matmul_reference(x, w, cfg, out_dtype)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                if counts != dict(_no_launches(), **{path: 2}):
                    fail("matmul bf16 at %s, tiling %s: launches %s, "
                         "expected 2 on %s" % (shape, t, counts, path))
                err, tol = _face_err(got, want)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["max_err_over_tol"] = max(rec["max_err_over_tol"],
                                              err / tol)
                if got.dtype != want.dtype or not err <= tol:
                    fail("matmul bf16 disagrees with its plain version at "
                         "%s, tiling %s, out %s: %g > %g (%s)"
                         % (shape, t, out_dtype, err, tol, got.dtype))
                if not torch.equal(got, again):
                    fail("matmul bf16 is not deterministic at %s, tiling %s"
                         % (shape, t))
            if shape in MM_SHAPES:
                rec["ms"]["%dx%dx%d" % t] = time_ms(
                    lambda: mm._launch(x, w, t), flush=flush)
        b_ms, b_by = bf16_bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
        rec.update({
            "plain_ms": time_ms(lambda: mm.matmul_reference(x, w),
                                flush=flush),
            "library_ms": time_ms(lambda: torch.matmul(x, w), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by})
        if shape in MM_SHAPES:
            # at the step's shapes (12 or 48 k tiles of 64; the ragged K
            # 130 has 5 tiles of 32, too few to leave an ulp)
            want = mm.matmul_reference(x, w)
            err, tol = _face_err(_bf16_step_sums_mm(x, w), want)
            rec["bf16_step_sums_err_over_tol"] = err / tol
            if not err > tol:
                fail("at %s a gemm summed in bfloat16 errs by only %g <= "
                     "one ulp %g: the tolerance cannot tell the face from "
                     "it" % (shape, err, tol))
        else:  # the entry point takes its ragged path at any tiling
            rec["ms"]["ragged %dx%dx%d" % mm.RAGGED_TILING] = time_ms(
                lambda: mm._launch(x, w, mm.normalize_config(
                    None, torch.bfloat16)), flush=flush)
        per_shape["x".join(str(d) for d in shape)] = rec
        log(json.dumps({"matmul_bf16_check": {"shape": shape, **rec}}))
        del x, w, got, again, want
    torch.cuda.empty_cache()
    return per_shape


def _amp_lm_reference(params, feed, cfg, dtype=torch.float64):
    """{name: grad} and the loss of the plain functional LM forward
    (``models/transformer._forward_hidden``, written out) under plain
    AMP with tuned gemms: the 6 projections of each block through
    :class:`_AmpMm` with their outputs rounded to bfloat16 (the kernel's
    bfloat16 face), the LM head (outside the kernel's population) with
    its float32 sum; run in ``dtype``."""
    from paddle_tpu_torch.models import transformer as tt
    F = torch.nn.functional
    p = {n: t.detach().to(dtype, copy=True).requires_grad_(True)
         for n, t in params.items()}
    nh, dh = cfg.num_heads, cfg.head_dim
    toks = feed["toks"]
    B, S = toks.shape

    def mm(h, w, rounded=True):
        out = _AmpMm.apply(h.reshape(-1, h.shape[-1]), w, rounded)
        return out.reshape(*h.shape[:-1], w.shape[1])

    x = F.embedding(toks.long(), p["tok_emb"]) + p["pos_emb"][:S][None]
    for i in range(cfg.num_layers):
        pre = "blk%d" % i
        h = tt._ln(x, p[pre + "_ln1_w"], p[pre + "_ln1_b"])
        q, k, v = (mm(h, p[pre + s_]).view(B, S, nh, dh)
                   for s_ in ("_q", "_k", "_v"))
        att = tt._plain_causal(q, k, v).reshape(B, S, nh * dh)
        x = x + mm(att, p[pre + "_proj"])
        h2 = tt._ln(x, p[pre + "_ln2_w"], p[pre + "_ln2_b"])
        up = mm(h2, p[pre + "_up"]) + p[pre + "_up_b"]
        x = x + mm(torch.relu(up), p[pre + "_down"])
    x = tt._ln(x, p["final_ln_w"], p["final_ln_b"])
    logits = mm(x, p["lm_head"], rounded=False)
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           feed["tgt"].reshape(-1))
    names = sorted(p)
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    return dict(zip(names, grads)), float(loss.detach())


def _amp_lm_grad_check(trainer, spec, cfg, feed, up_b, label, pure=False):
    """Step 1 under plain or pure AMP: every mul and flash_attention
    against its rounded reference (the gate, :func:`_amp_op_check`); then
    every parameter's @GRAD end to end against torch.autograd through
    the unrounded float64 plain forward and, under plain AMP, through
    the bfloat16-rounded one in float64 (:func:`_amp_lm_reference`
    rounds as plain AMP does), reported."""
    from paddle_tpu_torch.core.scope import global_scope
    ops = _amp_op_check(trainer, feed, label)
    scope = global_scope()
    params = [p.name for p in trainer.main_program.all_parameters()]
    start = {n: scope.find_var(n).clone() for n in params}
    outs = trainer.exe.run(trainer.main_program, feed=feed,
                           fetch_list=[spec["cost"]]
                           + [n + "@GRAD" for n in params],
                           return_numpy=False)
    got = dict(zip(params, outs[1:]))
    loss = float(outs[0].reshape(-1)[0])
    ref_name = _ref_names(up_b)
    ref_params = {ref_name.get(n, n): t for n, t in start.items()}
    stats = {}
    for kind in ("float64",) if pure else ("bf16_rounded", "float64"):
        want, ref_loss = (
            _amp_lm_reference(ref_params, feed, cfg) if kind != "float64"
            else _reference_grads(ref_params, feed, cfg,
                                  dtype=torch.float64))
        stats[kind] = dict(_grad_stats(got, want, ref_name),
                           loss_abs_err=abs(loss - ref_loss))
        del want
    torch.cuda.synchronize()
    checks = {"op_check": ops, "params_checked": len(params),
              "gate": "op_check", **stats}
    if not pure:
        checks["separates"] = stats["float64"]["norm_rel_err_median"] \
            > 2 * stats["bf16_rounded"]["norm_rel_err_median"]
    log(json.dumps({label + "_grad_check": checks}))
    return checks


def _seed_bf16_cache(per_shape, cache_dir):
    """A winner cache whose entry for each of the LM's bfloat16 gemm
    populations is the fastest tiling of the face (row 5's check),
    written through WinnerCache.put. Returns {signature: tiling}."""
    from paddle_tpu_torch import tune
    cache = tune.WinnerCache(cache_dir)
    picked = {}
    for M, K, N in MM_SHAPES:
        ms = per_shape["%dx%dx%d" % (M, K, N)]["ms"]
        best = min(ms, key=ms.get)
        cfg = _mm_config(tuple(int(v) for v in best.split("x")))
        sig = tune.signature({"m": M, "k": K, "n": N, "dtype": "bfloat16"})
        cache.put(tune.cache_key(tune.device_kind(), "matmul", sig), cfg,
                  time_ms=ms[best], timer="cuda_events",
                  meta={"kernel": "matmul", "sig": sig,
                        "device": tune.device_kind()})
        picked[sig] = cfg
    return picked


def phase_amp(dev, root, f32_images_s, tuned, rnn32):
    """AMP: the bfloat16 faces of rows 6, 5, 2-4 and 7 against their
    plain versions, ResNet-50 under plain and pure AMP, the LM under plain
    and pure AMP on a cache of the matmul face's fastest tilings, and the
    bias-free LSTM text classifier under pure AMP beside phase 7's
    float32 run (``rnn32``). Returns (kernel entries, {path: launch
    counts})."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    entries = _amp_conv_check(dev, flush)
    entries.update(_amp_flash_check(dev, flush))
    entries["fused_lstm_bf16"] = _amp_lstm_check(dev, flush)
    mm_shapes = _amp_matmul_check(dev, flush)
    del flush
    torch.cuda.empty_cache()
    paths = {}
    paths["convnet_train_amp"], amp_images_s = phase_convnet(dev, amp=True)
    paths["convnet_train_pure_amp"], pure_images_s = phase_convnet(
        dev, amp="pure")
    log(json.dumps({"resnet50_images_per_sec": {
        "float32": f32_images_s, "amp": amp_images_s,
        "pure_amp": pure_images_s}}))
    work = os.path.join(root, "build", "chip_smoke")
    cache_dir = _fresh_dir(os.path.join(work, "tune_bf16_tilings"))
    picked = _seed_bf16_cache(mm_shapes, cache_dir)
    log(json.dumps({"tune_bf16_cache": picked}))
    FLAGS.tune_cache_dir = cache_dir
    tune.clear_memory_cache()
    L = GPT2_SMALL["num_layers"]
    per_layer = sum(MM_COUNTS)
    runs = {}
    try:
        for label, mode in (("amp_train", True), ("pure_amp_train", "pure")):
            runs[label] = _lm_train(dev, label, want_matmul=per_layer * L,
                                    amp=mode)
    finally:
        FLAGS.tune_cache_dir = TUNE_EMPTY_DIR
        tune.clear_memory_cache()
    for label, rec in runs.items():
        steps = len(rec["losses"])
        rec.update({"kernel_cache": picked,
                    "float32_tuned_tokens_per_s": tuned["tokens_per_s"],
                    "float32_tuned_step_ms_p50": tuned["step_ms_p50"]})
        log(json.dumps({label: rec}))
        traces = rec["traces"]
        if rec["tune"] != {"tune_hits": per_layer * L * traces,
                           "tune_misses": 0, "tune_fallbacks": traces}:
            fail("%s tune counters %s over %d steps (%d traced), expected "
                 "%d hits and 1 fallback a traced step"
                 % (label, rec["tune"], steps, traces, per_layer * L))
        paths[label] = rec["launches"]
    paths["rnn_train_lstm_pure_amp"], rnn_pure = phase_rnn(dev, "lstm",
                                                           amp="pure")
    log(json.dumps({"rnn_train_lstm": {"float32": rnn32,
                                       "pure_amp": rnn_pure}}))
    log(json.dumps({"lm_train": {
        kind: {"tokens_per_s": r["tokens_per_s"],
               "step_ms_p50": r["step_ms_p50"],
               "device_kernel_ms_two_steps":
                   r["profile"].get("device_kernel_ms"),
               "device_busy_share": r["profile"].get("device_busy_share"),
               "flash_ms_two_steps": r["profile"].get("flash_ms")}
        for kind, r in (("float32_tuned", tuned),
                        ("amp", runs["amp_train"]),
                        ("pure_amp", runs["pure_amp_train"]))}}))
    pure = runs["pure_amp_train"]["profile"]
    parent = pure["parent_face"]
    log(json.dumps({"pure_amp_lm_flash_faces": {
        "device_kernel_ms_two_steps": pure["device_kernel_ms"],
        "fwd_wgmma_ms": pure["flash_fwd_bf16_wgmma_kernel"]["ms"],
        "fwd_wgmma_share": pure["flash_fwd_bf16_wgmma_kernel"]["share"],
        "bwd_ms": pure["bwd_bf16_ms"],
        "bwd_launches": {k: pure[k]["count"] for k in FLASH_KERNELS
                         if k.startswith("flash_bwd_d") and "_bf16_" in k},
        "parent_faces_device_kernel_ms_two_steps":
            parent["device_kernel_ms"],
        "parent_faces_fwd_mma_ms": parent["flash_fwd_bf16_mma_kernel"]["ms"],
        "parent_faces_bwd_ms": parent["bwd_bf16_ms"],
        "parent_faces_bwd_launches": {
            k: parent[k]["count"] for k in FLASH_KERNELS
            if k.startswith("flash_bwd_d") and "_bf16_" in k}}}))
    weights = {}
    for shape, n in zip(MM_SHAPES, MM_COUNTS):
        sig = tune.signature({"m": shape[0], "k": shape[1], "n": shape[2],
                              "dtype": "bfloat16"})
        weights["x".join(str(d) for d in shape)] = (
            n, "%(block_m)dx%(block_n)dx%(block_k)d" % picked[sig])

    def per_launch(f):
        return sum(f(mm_shapes[k], tag) * n
                   for k, (n, tag) in weights.items()) / per_layer

    tolerance = ("one bfloat16 ulp of the largest magnitude (bfloat16 "
                 "out); %g of it (float32 out)" % AMP_F32_REL_TOL)
    step = [mm_shapes[k] for k in weights]
    entries["matmul_bf16"] = {
        "name": "matmul_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/matmul.cu",
        "replaces": "paddle_tpu/kernels/matmul.py:91",
        "role": "a tuned gemm under AMP: bfloat16 operands, written in "
                "bfloat16 (x.dtype) as the JAX kernel with out_dtype None; "
                "TMA-fed, warp-specialised wgmma",
        "max_abs_err": max(r["max_abs_err"] for r in step),
        "max_err_over_tol": max(r["max_err_over_tol"] for r in step),
        "tolerance": tolerance,
        "bf16_step_sums_min_err_over_tol": min(
            r["bf16_step_sums_err_over_tol"] for r in step),
        "ms": per_launch(lambda r, t: r["ms"][t]),
        "plain_ms": per_launch(lambda r, t: r["plain_ms"]),
        "bound_ms": per_launch(lambda r, t: r["bound_ms"]),
        "bound_by": "operations",
        "library_ms": per_launch(lambda r, t: r["library_ms"]),
        "library": "torch.matmul on bfloat16 (cuBLAS)",
        "timed_as": "mean over a GPT-2-small step's 72 launches (48 at "
                    "8192x768x768, 12 each at 8192x768x3072 and "
                    "8192x3072x768), each at the tiling the AMP run used",
        "tilings_used": {k: t for k, (_, t) in weights.items()},
        "per_shape": {k: mm_shapes[k] for k in weights}}
    # the face's ragged path: no main path takes it (every LM gemm is
    # aligned, and the LM runs above fail on any ragged launch), so its
    # launches are 0 and main() does not require one
    from paddle_tpu_torch.kernels import matmul as mm
    ragged = mm_shapes["x".join(str(d) for d in MM_RAGGED_SHAPE)]
    entries["matmul_bf16_ragged"] = {
        "name": "matmul_bf16_ragged", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/matmul.cu",
        "replaces": "paddle_tpu/kernels/matmul.py:91",
        "role": "the bfloat16 face's path for operands TMA cannot take "
                "(K or N not a multiple of 8, a pointer not 16-byte "
                "aligned): mma.sync at one tiling, 128x128x32",
        "main_path": False,
        "max_abs_err": ragged["max_abs_err"],
        "max_err_over_tol": ragged["max_err_over_tol"],
        "tolerance": tolerance,
        "ms": ragged["ms"]["ragged %dx%dx%d" % mm.RAGGED_TILING],
        "plain_ms": ragged["plain_ms"], "bound_ms": ragged["bound_ms"],
        "bound_by": ragged["bound_by"],
        "library_ms": ragged["library_ms"],
        "library": "torch.matmul on bfloat16 (cuBLAS)",
        "timed_as": "one launch at %s" % (MM_RAGGED_SHAPE,),
        "per_shape": {"x".join(str(d) for d in MM_RAGGED_SHAPE): ragged}}
    return entries, paths


# -- phase 10 -----------------------------------------------------------------

def _paged_rows_spy():
    """Count the paged attention kernel's launches by the rows each took:
    wraps the wrapper where the model's steps call it (the decode step
    and the k-wide face). Returns (Counter, restore)."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import transformer as tt
    orig = pa.paged_attention
    rows = collections.Counter()

    def spy(q, *args):
        before = pa.launches
        out = orig(q, *args)
        if pa.launches != before:
            rows[int(q.shape[0])] += 1
        return out

    def restore():
        pa.paged_attention = tt.paged_attention = orig

    pa.paged_attention = tt.paged_attention = spy
    return rows, restore


def _plain_margins(model, prompts, results):
    """The plain full forward's top-two logit margin at each generated
    step of each request, over prompt + the plain engine's tokens."""
    out = []
    with torch.no_grad():
        for pr, r in zip(prompts, results):
            ids = torch.tensor([list(pr) + list(r.tokens)],
                               dtype=torch.int32, device=model.device)
            n = len(pr)
            logits = model(ids)[0, n - 1:n - 1 + len(r.tokens)]
            top = torch.topk(logits, 2, dim=-1).values
            out.append((top[:, 0] - top[:, 1]).cpu().numpy())
    return out


def _perturbed_params(params, model, dev, prompts):
    """The target's weights plus seeded noise at the first scale of
    DRAFT_NOISE_SCALES whose greedy argmax agrees with the target's on at
    most DRAFT_AGREE_MAX of two prompts' positions. Returns (params,
    scale, agreement by scale)."""
    from paddle_tpu_torch.models import transformer as tt
    rng = np.random.RandomState(5)
    noise = {n: rng.randn(*a.shape).astype(np.float32) * float(a.std())
             for n, a in params.items()}
    ids = [torch.tensor([list(p)], dtype=torch.int32, device=dev)
           for p in prompts[:2]]
    with torch.no_grad():
        want = [model(i)[0].argmax(-1) for i in ids]
        agree = {}
        for scale in DRAFT_NOISE_SCALES:
            cand = {n: a + scale * noise[n] for n, a in params.items()}
            m = tt.TransformerLM.from_numpy(cand, model.config, device=dev)
            same = sum(int((m(i)[0].argmax(-1) == w).sum())
                       for i, w in zip(ids, want))
            agree[scale] = same / float(sum(w.numel() for w in want))
            del m
            if agree[scale] <= DRAFT_AGREE_MAX:
                return cand, scale, agree
    fail("no draft noise scale of %s brings the greedy agreement to %g "
         "or below: %s" % (DRAFT_NOISE_SCALES, DRAFT_AGREE_MAX, agree))


def _round_times(target, draft, k, dev, prompts):
    """CUDA-event ms of one plain decode step, one propose round (k + 1
    draft decode steps) and one verify step at the engine's 16 rows, all
    rows at phase 3's prompt lengths over a pool of their own (what a
    round costs against the step it replaces; launches of the steps, not
    of the kernels alone)."""
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.serving import PagePool
    R, MB, T = 16, 64, 16
    kp, vp = PagePool(R * MB, T, *target.kv_spec).zeros(dev)
    dkp, dvp = PagePool(R * MB, T, *draft.kv_spec).zeros(dev)
    tables = torch.arange(R * MB, dtype=torch.int32,
                          device=dev).reshape(R, MB)
    pos = torch.tensor([len(p) for p in prompts[:R]], dtype=torch.int32,
                       device=dev)
    toks = torch.zeros((R,), dtype=torch.int32, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    temps = torch.zeros((R,), dtype=torch.float32, device=dev)
    seeds = torch.zeros((R,), dtype=torch.int32, device=dev)
    caps = torch.full((R,), k, dtype=torch.int32, device=dev)
    tp, dp = target.params, draft.params
    with torch.no_grad():
        drafts, dlogits = tt.draft_propose_step(
            dp, dkp, dvp, tables, pos, toks, active, temps, seeds, caps, k,
            draft.config)
        return {
            "rows": R, "lanes": k + 1,
            "decode_step_ms": time_ms(lambda: tt.decode_step_sampled(
                tp, kp, vp, tables, pos, toks, active, temps, seeds,
                target.config), iters=10),
            "propose_ms": time_ms(lambda: tt.draft_propose_step(
                dp, dkp, dvp, tables, pos, toks, active, temps, seeds, caps,
                k, draft.config), iters=10),
            "verify_ms": time_ms(lambda: tt.verify_step_sampled(
                tp, kp, vp, tables, pos, toks, drafts, dlogits, active,
                temps, seeds, caps, target.config), iters=10)}


def _spec_serve(dev, pair_dir, name, prompts, results, margins, L):
    """Serve phase 3's greedy prompts and 4 tempered requests (twice)
    through a speculative pairing loaded with load_speculative; hold the
    tokens, the launches and the events. Returns (metrics, launches)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.inference import load_speculative
    from paddle_tpu_torch.resilience import events
    from paddle_tpu_torch.serving import GenerationEngine
    target, draft, k = load_speculative(pair_dir, device=dev)
    L_d = draft.config.num_layers
    engine = GenerationEngine(target, max_running=16, kv_pages=1024,
                              page_tokens=16, queue_depth=64, warm=True,
                              name=name, draft_model=draft, spec_k=k)
    rows, restore = _paged_rows_spy()
    try:
        torch.cuda.synchronize()
        events.clear_events()
        kernels.reset_launches()
        rows.clear()
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        got = [h.wait(timeout=600) for h in handles]
        wall = time.monotonic() - t0
        st_greedy = engine.stats
        tempered = []
        for _ in range(2):
            hs = [engine.submit(prompts[j], max_new_tokens=32,
                                temperature=SPEC_TEMPERATURE, seed=100 + j)
                  for j in range(4)]
            tempered.append([h.wait(timeout=600).tokens for h in hs])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        st = engine.stats
    finally:
        restore()
        engine.close()
    round_ms = _round_times(target, draft, k, dev, prompts)
    del target, draft
    degraded = [e for e in events.events()
                if e["kind"] in ("speculation_degraded", "prefix_degraded")]
    if degraded:
        fail("%s: degraded during phase 10: %s" % (name, degraded))
    if not st["speculative"] or st["failed"] or st["spec_k"] != SPEC_K:
        fail("%s: speculative %s, spec_k %d, failed %d"
             % (name, st["speculative"], st["spec_k"], st["failed"]))
    diverged = []
    for j, (r, g) in enumerate(zip(results, got)):
        if g.tokens == r.tokens:
            continue
        t = next(i for i, (a, b) in enumerate(zip(r.tokens, g.tokens))
                 if a != b)
        diverged.append({"request": j, "step": t,
                         "plain_top2_margin": float(margins[j][t])})
        log("%s: request %d diverges from the plain engine at step %d, "
            "the plain step's top-two logit margin there %g"
            % (name, j, t, margins[j][t]))
        if not margins[j][t] <= LOGIT_TOL:
            fail("%s: request %d diverges at step %d where the plain "
                 "step's top-two margin %g is past LOGIT_TOL %g"
                 % (name, j, t, margins[j][t], LOGIT_TOL))
    if tempered[0] != tempered[1]:
        fail("%s: the tempered repeats differ" % name)
    want = dict(_no_launches(),
                paged_attention=(L + (k + 1) * L_d) * st["spec_steps"],
                flash_attention_fwd=(L + L_d) * st["prefills"])
    want_rows = {16 * (k + 1): L * st["spec_steps"],
                 16: (k + 1) * L_d * st["spec_steps"]}
    if launches != want or dict(rows) != want_rows or \
            st["spec_steps"] != st["decode_steps"]:
        fail("%s: launches %s (rows %s), expected %s (rows %s): %d rounds, "
             "%d decode steps, %d prefills"
             % (name, launches, dict(rows), want, want_rows,
                st["spec_steps"], st["decode_steps"], st["prefills"]))
    tokens = sum(len(g.tokens) for g in got)
    metrics = {
        "pairing": name, "spec_k": k, "draft_layers": L_d,
        "requests": len(prompts), "tempered_requests": 4,
        "tempered_repeats_identical": True,
        "diverged_requests": len(diverged), "divergences": diverged,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "intertoken_ms_p50": st_greedy["intertoken_ms_p50"],
        "ttft_ms_p50": st_greedy["ttft_ms_p50"],
        "rounds_greedy": st_greedy["spec_steps"],
        "acceptance_rate_greedy": st_greedy["acceptance_rate"],
        "draft_tokens_greedy": st_greedy["draft_tokens"],
        "accepted_tokens_greedy": st_greedy["accepted_tokens"],
        "acceptance_rate": st["acceptance_rate"],
        "draft_tokens": st["draft_tokens"],
        "accepted_tokens": st["accepted_tokens"],
        "rounds": st["spec_steps"], "prefills": st["prefills"],
        "engine_busy_s_greedy": st_greedy["busy_s"],
        "round_times": round_ms, "warmup_ms": engine.warmup_ms,
        "paged_launch_rows": {str(r): c for r, c in sorted(rows.items())},
        "launches": {n: c for n, c in launches.items() if c}}
    return metrics, launches, st_greedy


def _prefix_serve(dev, art_dir, cfg):
    """8 greedy requests sharing a PREFIX_TOKENS-token prefix, queued
    before the engine admits any, with sharing off and then on: the
    tokens identical, hits, and a lower peak of live pages with it on."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.inference import load_generative
    from paddle_tpu_torch.resilience import events
    from paddle_tpu_torch.serving import GenerationEngine
    rng = np.random.RandomState(2)
    prefix = list(rng.randint(0, cfg.vocab_size, PREFIX_TOKENS))
    prompts = [prefix + list(rng.randint(0, cfg.vocab_size, n))
               for n in PREFIX_TAILS]
    model = load_generative(art_dir, device=dev)
    L = cfg.num_layers
    runs, paths = {}, {}
    for sharing in (False, True):
        engine = GenerationEngine(model, max_running=16, kv_pages=1024,
                                  page_tokens=16, queue_depth=64, warm=True,
                                  name="gpt2_prefix", prefix_sharing=sharing)
        try:
            torch.cuda.synchronize()
            events.clear_events()
            kernels.reset_launches()
            t0 = time.monotonic()
            with engine._cond:    # every request queued before admission
                handles = [engine.submit(p, max_new_tokens=32)
                           for p in prompts]
            got = [h.wait(timeout=600).tokens for h in handles]
            wall = time.monotonic() - t0
            launches = kernels.launch_counts()
            st = engine.stats
        finally:
            engine.close()
        if [e for e in events.events() if e["kind"] == "prefix_degraded"] \
                or st["prefix_degraded"] or st["failed"]:
            fail("prefix sharing %s: degraded or failed: %s"
                 % (sharing, events.events()))
        want = dict(_no_launches(), flash_attention_fwd=L * st["prefills"],
                    paged_attention=L * st["decode_steps"])
        if launches != want:
            fail("prefix sharing %s: launches %s, expected %s"
                 % (sharing, launches, want))
        runs[sharing] = {
            "tokens": got, "wall_s": wall,
            "tokens_per_s": sum(len(t) for t in got) / wall,
            "intertoken_ms_p50": st["intertoken_ms_p50"],
            "ttft_ms_p50": st["ttft_ms_p50"],
            "max_live_pages": st["page_utilization"]["max_live"],
            "prefix_hits": st["prefix_hits"],
            "prefix_hit_requests": st["prefix_hit_requests"],
            "prefix_published": st["prefix_published"],
            "cow_copies": st["cow_copies"]}
        paths["serve_prefix_" + ("on" if sharing else "off")] = launches
    del model
    off, on = runs[False], runs[True]
    if on["tokens"] != off["tokens"]:
        fail("prefix sharing changed the greedy tokens")
    if not on["prefix_hits"] > 0:
        fail("prefix sharing made no hit")
    if not on["max_live_pages"] < off["max_live_pages"]:
        fail("prefix sharing did not lower the peak of live pages: %d "
             "against %d" % (on["max_live_pages"], off["max_live_pages"]))
    for r in runs.values():
        del r["tokens"]
    out = {"requests": len(prompts), "prefix_tokens": PREFIX_TOKENS,
           "tails": list(PREFIX_TAILS), "new_tokens_each": 32,
           "off": off, "on": on,
           "pages_saved": off["max_live_pages"] - on["max_live_pages"]}
    return out, paths


def phase_speculative(dev, root, art_dir, prompts, results, plain):
    """Phase 10: speculative serving through two pairings exported with
    SPEC_K (a self-draft and a perturbed draft) and prefix-shared
    serving, each beside phase 3's plain engine."""
    from paddle_tpu_torch.inference import export_speculative, \
        load_generative
    from paddle_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**GPT2_SMALL)
    params = tt.init_params(cfg, seed=0)
    model = load_generative(art_dir, device=dev)
    margins = _plain_margins(model, prompts, results)
    noisy, scale, agree = _perturbed_params(params, model, dev, prompts)
    del model
    torch.cuda.empty_cache()
    base = os.path.join(root, "build", "chip_smoke")
    out, paths = {"noise_scale": scale, "greedy_agreement_by_scale": {
        str(k): v for k, v in agree.items()},
        "plain": {k: plain[k] for k in ("tokens_per_s", "intertoken_ms_p50",
                                        "ttft_ms_p50", "decode_steps",
                                        "engine_busy_s")},
        "min_plain_top2_margin": float(min(m.min() for m in margins))}, {}
    for name, draft_params in (("self_draft", params),
                               ("perturbed_draft", noisy)):
        pair_dir = os.path.join(base, "gpt2_small_spec_" + name)
        export_speculative(pair_dir, cfg, cfg, SPEC_K, params=params,
                           draft_params=draft_params)
        metrics, launches, st = _spec_serve(
            dev, pair_dir, "gpt2_" + name, prompts, results, margins,
            cfg.num_layers)
        out[name] = metrics
        paths["serve_speculative_" + name] = launches
        torch.cuda.empty_cache()
    # The self-draft's greedy drafts are the plain step's argmax; the
    # verify step can reject one only where its products, on 5x the
    # rows, flip a near tie. A rejection costs its round at most SPEC_K
    # drafts and settles that step, so the greedy pass may fall short of
    # full acceptance by SPEC_K drafts for each plain step whose top-two
    # margin is within LOGIT_TOL, and by no more
    gs = out["self_draft"]
    near_ties = sum(int((m <= LOGIT_TOL).sum()) for m in margins)
    shortfall = gs["draft_tokens_greedy"] - gs["accepted_tokens_greedy"]
    out["plain_steps_within_logit_tol"] = near_ties
    out["self_draft_greedy_shortfall"] = shortfall
    out["self_draft_greedy_shortfall_bound"] = SPEC_K * near_ties
    log("self-draft greedy acceptance %g: %d of %d drafts rejected, at "
        "most %d allowed (SPEC_K x %d plain steps with a top-two margin "
        "within LOGIT_TOL)"
        % (gs["acceptance_rate_greedy"], shortfall,
           gs["draft_tokens_greedy"], SPEC_K * near_ties, near_ties))
    if shortfall > SPEC_K * near_ties:
        fail("the self-draft rejected %d greedy drafts, past SPEC_K x %d "
             "near-tie plain steps" % (shortfall, near_ties))
    rate = out["perturbed_draft"]["acceptance_rate"]
    if not 0.0 < rate < 1.0:
        fail("the perturbed draft's acceptance %g is not strictly between "
             "0 and 1" % rate)
    out["prefix"], prefix_paths = _prefix_serve(dev, art_dir, cfg)
    paths.update(prefix_paths)
    log(json.dumps({"speculative": out}))
    return paths


# -- phase 11 -----------------------------------------------------------------

def _near_tie(label, model, prompt, want, got):
    """None when ``got`` equals ``want``; else the first divergence, which
    is admitted only where the plain full forward's top-two logit margin
    over prompt + ``want`` is within LOGIT_TOL (printed either way)."""
    if list(got) == list(want):
        return None
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    if t >= min(len(want), len(got)):
        fail("%s: %d tokens where %d were expected"
             % (label, len(got), len(want)))
    margin = float(_plain_margins(
        model, [prompt], [types.SimpleNamespace(tokens=list(want))])[0][t])
    log("%s diverges at step %d, the plain step's top-two logit margin "
        "there %g" % (label, t, margin))
    if not margin <= LOGIT_TOL:
        fail("%s diverges at step %d where the plain step's top-two "
             "margin %g is past LOGIT_TOL %g" % (label, t, margin,
                                                 LOGIT_TOL))
    return {"request": label, "step": t, "plain_top2_margin": margin}


def _pcts(values):
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "n": int(v.size)}


def _tier_servers(dev, art_dir):
    """A prefill-class and a decode-class InferenceService over phase 3's
    artifact at its geometry, each behind its own server on port 0:
    ({tier: (service, base URL)}, stop)."""
    from paddle_tpu_torch.serving import InferenceService, make_server
    tiers, servers = {}, []

    def stop():
        for srv, svc in servers:
            srv.shutdown()
            srv.server_close()
            svc.close()

    try:
        for tier in ("prefill", "decode"):
            svc = InferenceService(tier=tier)
            servers.append((None, svc))
            svc.load_model("gpt2", art_dir, device=dev, max_running=16,
                           kv_pages=1024, page_tokens=16)
            srv = make_server(svc, host="127.0.0.1", port=0)
            servers[-1] = (srv, svc)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            tiers[tier] = (svc, "http://127.0.0.1:%d"
                           % srv.server_address[1])
    except BaseException:
        for srv, svc in servers:
            if srv is not None:
                srv.server_close()
            svc.close()
        raise
    return tiers, stop


def _install_spy(engine, readback_prompt=None):
    """Wrap the engine's install: time each (device synchronized around
    it), stamp its end on the monotonic clock, and read the pages of the
    request whose prompt is ``readback_prompt`` back through its block
    table right after its install, before it can retire. Returns
    (install ms, end stamps, readback dict, restore)."""
    orig = engine._install_handoff
    install_ms, ends, readback = [], [], {}

    def install(table, artifact):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        orig(table, artifact)
        torch.cuda.synchronize()
        ends.append(time.monotonic())
        install_ms.append((ends[-1] - t0) * 1e3)
        if artifact.prompt == readback_prompt and not readback:
            ids = torch.as_tensor(table.pages[:artifact.pages],
                                  dtype=torch.int64, device=engine.device)
            readback.update(k=engine._kp[:, ids].cpu().numpy(),
                            v=engine._vp[:, ids].cpu().numpy(),
                            artifact=artifact)

    def restore():
        del engine._install_handoff

    engine._install_handoff = install
    return install_ms, ends, readback, restore


def _disagg_greedy(tiers, model, prompts, results, L):
    """The greedy leg: phase 3's prompts through :prefill one after
    another, then every artifact to :decode at once; the gates of both
    tiers. Returns (metrics, prefill launches, decode launches,
    artifacts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.resilience import events
    from paddle_tpu_torch.serving import HandoffArtifact
    pre_base = tiers["prefill"][1]
    dec_svc, dec_base = tiers["decode"]
    engine = dec_svc._gen_entry("gpt2").engine
    events.clear_events()
    torch.cuda.synchronize()
    kernels.reset_launches()
    payloads, hop_ms = [], []
    for pr in prompts:
        t0 = time.monotonic()
        code, ans = _post(pre_base, {"tokens": [int(t) for t in pr],
                                     "max_new_tokens": 32},
                          route="prefill")
        hop_ms.append((time.monotonic() - t0) * 1e3)
        if code != 200:
            fail(":prefill answered %d: %s" % (code, ans))
        payloads.append(ans["artifact"])
    torch.cuda.synchronize()
    pre_launches = kernels.launch_counts()
    want = dict(_no_launches(), flash_attention_fwd=L * len(prompts))
    if pre_launches != want:
        fail("prefill tier launches %s, expected %s"
             % (pre_launches, want))
    # what the servers do to each artifact, timed here on the same
    # bodies: the decode side's parse, the prefill side's encode
    bodies = [json.dumps({"artifact": p}).encode() for p in payloads]
    del payloads
    parse_ms, encode_ms, arts = [], [], []
    for b in bodies:
        t0 = time.monotonic()
        art = HandoffArtifact.from_payload(json.loads(b)["artifact"])
        parse_ms.append((time.monotonic() - t0) * 1e3)
        t0 = time.monotonic()
        json.dumps({"model": "gpt2", "artifact": art.to_payload()})
        encode_ms.append((time.monotonic() - t0) * 1e3)
        arts.append(art)
    check = int(np.argmax([len(p) for p in prompts]))
    install_ms, _, readback, restore = _install_spy(
        engine, [int(t) for t in prompts[check]])
    answers = [None] * len(bodies)

    def post(j):
        try:
            answers[j] = _post(dec_base, bodies[j], route="decode")
        except Exception as e:          # reported below
            answers[j] = (None, repr(e))

    st0 = engine.stats
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=post, args=(j,))
                   for j in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        decode_wall = time.monotonic() - t0
        torch.cuda.synchronize()
        dec_launches = kernels.launch_counts()
        st = engine.stats
    finally:
        restore()
    steps = st["decode_steps"] - st0["decode_steps"]
    installs = st["handoff_installs"] - st0["handoff_installs"]
    prefills = st["prefills"] - st0["prefills"]
    failed = [e for e in events.events() if e["kind"] == "handoff_failed"]
    want = dict(_no_launches(), paged_attention=L * steps)
    if dec_launches != want or steps < 31:
        fail("decode tier launches %s, expected %s (%d decode steps)"
             % (dec_launches, want, steps))
    if installs != len(prompts) or prefills or failed:
        fail("decode tier: %d handoff installs, %d prefills, "
             "handoff_failed %s" % (installs, prefills, failed))
    diverged = []
    for j, (code, ans) in enumerate(answers):
        if code != 200:
            fail(":decode of request %d answered %s: %s" % (j, code, ans))
        d = _near_tie("disagg greedy request %d" % j, model, prompts[j],
                      results[j].tokens, ans["tokens"])
        if d:
            diverged.append(d)
    ra = readback.get("artifact")
    if ra is None or not (np.array_equal(readback["k"], ra.k_pages)
                          and np.array_equal(readback["v"], ra.v_pages)):
        fail("the installed pages of request %d differ from its "
             "artifact's bytes" % check)
    kv = [a.kv_bytes for a in arts]
    generated = st["tokens_generated"] - st0["tokens_generated"]
    # the engine thread's time in installs and steps (device time and
    # its host bookkeeping), without the uploads and parses
    busy = st["busy_s"] - st0["busy_s"]
    metrics = {
        "requests": len(prompts), "new_tokens_each": 32,
        "artifact_kv_bytes": {"p50": float(np.percentile(kv, 50)),
                              "max": int(max(kv)), "total": int(sum(kv))},
        "payload_body_bytes": {"p50": float(np.percentile(
            [len(b) for b in bodies], 50)),
            "max": max(len(b) for b in bodies),
            "total": sum(len(b) for b in bodies)},
        "decode_body_limit": dec_svc.handoff_body_limit("gpt2"),
        "prefill_hop_ms": _pcts(hop_ms),
        "to_payload_and_json_ms": _pcts(encode_ms),
        "decode_parse_ms": _pcts(parse_ms),
        "decode_install_ms": _pcts(install_ms),
        "decode_parse_and_install_ms": _pcts(
            [a + b for a, b in zip(parse_ms, install_ms)]),
        "decode_wall_s": decode_wall,
        "decode_tier_tokens_generated": generated,
        "decode_tier_tokens_per_s": generated / decode_wall,
        "decode_tier_busy_s": busy,
        "decode_tier_tokens_per_busy_s": generated / busy,
        "decode_steps": steps, "handoff_installs": installs,
        "readback_request": check,
        "readback_pages": int(readback["artifact"].pages),
        "diverged_requests": len(diverged), "divergences": diverged}
    return metrics, pre_launches, dec_launches, arts


def _few(values):
    """Each value of a leg of a few requests, their median and n (no
    tail: a p99 of 4 samples is their maximum)."""
    return {"values": [float(v) for v in values],
            "p50": float(np.percentile(values, 50)), "n": len(values)}


def _disagg_seeded(tiers, model, prompts):
    """4 tempered requests (distinct seeds) through both hops, one after
    another, and the same 4 through the decode tier's :generate: tokens
    equal, and the client's times of each path.

    A handoff's first token is sampled on the prefill tier, so the
    decode engine's ``ttft_ms`` stamps the second token. The two-hop
    TTFT is therefore the :prefill POST's wall time plus the time from
    the :decode POST to the end of the row's install (upload, parse,
    queue, install: the point from which the decode tier owns the
    request); the time to the second token is reported beside it, with
    the one-hop TTFT of :generate."""
    from paddle_tpu_torch.resilience import events
    pre_base, dec_base = tiers["prefill"][1], tiers["decode"][1]
    engine = tiers["decode"][0]._gen_entry("gpt2").engine
    events.clear_events()
    two_hop, second, one_hop, diverged = [], [], [], []
    _, ends, _, restore = _install_spy(engine)
    try:
        for j in range(4):
            body = {"tokens": [int(t) for t in prompts[j]],
                    "max_new_tokens": 32,
                    "temperature": SPEC_TEMPERATURE, "seed": 300 + j}
            t0 = time.monotonic()
            code, pre = _post(pre_base, body, route="prefill")
            pre_ms = (time.monotonic() - t0) * 1e3
            if code != 200:
                fail("seeded :prefill %d answered %d" % (j, code))
            t0 = time.monotonic()
            code, hop = _post(dec_base, {"artifact": pre["artifact"]},
                              route="decode")
            dec_ms = (time.monotonic() - t0) * 1e3
            if code != 200 or len(ends) != j + 1:
                fail("seeded :decode %d answered %d after %d installs"
                     % (j, code, len(ends)))
            two_hop.append(pre_ms + (ends[j] - t0) * 1e3)
            second.append(pre_ms + _client_ttft_ms(dec_ms, hop))
            t0 = time.monotonic()
            code, gen = _post(dec_base, body)
            gen_ms = (time.monotonic() - t0) * 1e3
            if code != 200:
                fail("seeded :generate %d answered %d" % (j, code))
            one_hop.append(_client_ttft_ms(gen_ms, gen))
            d = _near_tie("disagg seeded request %d" % j, model,
                          prompts[j], gen["tokens"], hop["tokens"])
            if d:
                diverged.append(d)
    finally:
        restore()
    failed = [e for e in events.events() if e["kind"] == "handoff_failed"]
    if failed:
        fail("seeded leg: handoff_failed %s" % failed)
    return {"requests": 4, "temperature": SPEC_TEMPERATURE,
            "two_hop_ttft_ms": _few(two_hop),
            "two_hop_second_token_ms": _few(second),
            "one_hop_ttft_ms": _few(one_hop),
            "diverged_requests": len(diverged), "divergences": diverged}


def _disagg_fault(tiers, model, prompts, results, arts, L):
    """``serving.ship`` armed for 2 handoffs through decode_handoff in
    process: both prefill again on the decode tier, recorded."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.resilience import events, faults
    dec_svc = tiers["decode"][0]
    engine = dec_svc._gen_entry("gpt2").engine
    picks = [int(j) for j in np.argsort([len(p) for p in prompts])[:2]]
    events.clear_events()
    st0 = engine.stats
    torch.cuda.synchronize()
    kernels.reset_launches()
    faults.arm("serving.ship", "raise", nth=1, times=2)
    try:
        got = [dec_svc.decode_handoff("gpt2", arts[j], timeout=600)
               for j in picks]
    finally:
        faults.disarm("serving.ship")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    st = engine.stats
    failed = [e for e in events.events() if e["kind"] == "handoff_failed"]
    prefills = st["prefills"] - st0["prefills"]
    steps = st["decode_steps"] - st0["decode_steps"]
    want = dict(_no_launches(), flash_attention_fwd=L * 2,
                paged_attention=L * steps)
    if len(failed) != 2 or prefills != 2 or launches != want or \
            st["handoff_installs"] != st0["handoff_installs"]:
        fail("armed serving.ship: %d handoff_failed, %d prefills, "
             "launches %s (expected %s)"
             % (len(failed), prefills, launches, want))
    for j, res in zip(picks, got):
        _near_tie("disagg re-prefilled request %d" % j, model, prompts[j],
                  results[j].tokens, res.tokens)
    return {"armed_handoffs": 2, "handoff_failed": len(failed),
            "reprefills": prefills, "requests": picks}


def _disagg_cli(root, art_dir, tiers, model, prompts, results):
    """``serve --tier prefill`` as a subprocess: readiness line and /statz
    carry the tier, one :prefill answer decodes in this process's decode
    tier to phase 3's tokens, SIGTERM exits 0."""
    err_path = os.path.join(os.path.dirname(art_dir), "serve_tier.err")
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "serve", art_dir,
           "--tier", "prefill", "--port", "0", "--device", "cuda",
           "--name", "gpt2", "--max_running", "16", "--kv_pages", "1024",
           "--page_tokens", "16"]
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=err, text=True,
                                env=dict(os.environ, PYTHONPATH=root))
    killer = threading.Timer(600, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        try:
            ready = json.loads(line)["serving"]
        except ValueError:
            fail("serve --tier prefill printed %r; stderr: %s"
                 % (line, open(err_path).read()[-4000:]))
        ready_s = time.monotonic() - t0
        base = "http://%s:%d" % (ready["host"], ready["port"])
        with urllib.request.urlopen(base + "/statz", timeout=60) as r:
            statz_tier = json.loads(r.read())["tier"]
        if ready.get("tier") != "prefill" or statz_tier != "prefill":
            fail("serve --tier prefill: readiness tier %r, /statz tier %r"
                 % (ready.get("tier"), statz_tier))
        code, pre = _post(base, {"tokens": [int(t) for t in prompts[0]],
                                 "max_new_tokens": 32}, route="prefill")
        if code != 200:
            fail("the CLI's :prefill answered %d" % code)
        res = tiers["decode"][0].decode_handoff("gpt2", pre["artifact"],
                                                timeout=600)
        _near_tie("disagg CLI request 0", model, prompts[0],
                  results[0].tokens, res.tokens)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail("serve --tier prefill exited %d after SIGTERM: %s"
             % (proc.returncode, open(err_path).read()[-4000:]))
    stopped = json.loads(out.strip().splitlines()[-1])["serving_stopped"]
    return {"ready_s": ready_s, "tier": ready["tier"],
            "exit_code": proc.returncode,
            "prefills": stopped["stats"]["prefill"]["gpt2"]["prefills"]}


def _disagg_pt034(dev, art_dir, peak_bytes):
    """PT034 on the card: the artifact passes against the card's memory
    with no flag, and fails at a 0.5 GB budget."""
    from paddle_tpu_torch.analysis import memory as mem
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.inference import generative_memory_bytes, \
        validate_generative_artifact
    geo = dict(kv_pages=1024, page_tokens=16)
    prev = FLAGS.memory_budget_gb
    try:
        FLAGS.memory_budget_gb = 0.0
        budget = mem.resolve_budget_bytes(device=dev)
        loose = validate_generative_artifact(art_dir, **geo)
        FLAGS.memory_budget_gb = 0.5
        tight = validate_generative_artifact(art_dir, **geo)
    finally:
        FLAGS.memory_budget_gb = prev
    if not budget or loose:
        fail("PT034 against the card's memory (%s bytes): %s"
             % (budget, loose))
    if len(tight) != 1 or not tight[0].startswith("PT034 error"):
        fail("PT034 at a 0.5 GB budget: %s" % tight)
    log(tight[0])
    return {"card_budget_bytes": budget,
            "generative_memory_bytes": generative_memory_bytes(art_dir,
                                                               **geo),
            "phase3_peak_memory_bytes": peak_bytes,
            "problem_at_0_5_gb": tight[0]}


def phase_disagg(dev, root, art_dir, prompts, results, plain, http):
    """Phase 11: disaggregated serving, a prefill tier and a decode tier
    over phase 3's artifact, through the HTTP routes, the service, the
    ``serve --tier`` verb and the PT034 check."""
    from paddle_tpu_torch.models import transformer as tt
    L = tt.TransformerConfig(**GPT2_SMALL).num_layers
    tiers, stop = _tier_servers(dev, art_dir)
    try:
        model = tiers["decode"][0]._gen_entry("gpt2").engine.model
        greedy, pre_l, dec_l, arts = _disagg_greedy(tiers, model, prompts,
                                                    results, L)
        seeded = _disagg_seeded(tiers, model, prompts)
        fault = _disagg_fault(tiers, model, prompts, results, arts, L)
        del arts
        cli = _disagg_cli(root, art_dir, tiers, model, prompts, results)
        prefill_stats = tiers["prefill"][0].stats["prefill"]["gpt2"]
    finally:
        stop()
    out = {"card": card_line(), "greedy": greedy, "seeded": seeded,
           "fault": fault, "cli": cli, "prefill_engine": prefill_stats,
           "pt034": _disagg_pt034(dev, art_dir,
                                  plain["peak_memory_bytes"]),
           "single_hop": {"phase3_ttft_ms_p50": plain["ttft_ms_p50"],
                          "phase3_tokens_per_s": plain["tokens_per_s"],
                          "phase4_ttft_ms": http["ttft_ms"],
                          "phase4_client_ttft_ms": http["client_ttft_ms"]}}
    log(json.dumps({"disaggregated": out}))
    return {"disagg_prefill": pre_l, "disagg_decode": dec_l}


# -- phase 12 -----------------------------------------------------------------

# Phase 12 (compiled): each training path runs COMPILED_STEPS steps on the
# per-op path (use_jit=False) and COMPILED_STEPS on the compiled path
# (warm-up, capture, replays) from one saved state, then PROFILE_STEPS
# profiled steps of each
COMPILED_STEPS = 6
PROFILE_STEPS = 2
# repeat=K on the LM; the pipelined Trainer's batches and ring depth
REPEAT_K = 4
PIPE_BATCHES = 8
PIPE_DEPTH = 2
# the longest sequences of the ragged LSTM batches: one key each
RAGGED_LENS = (90, 64, 100, 77)
# kernel symbol on the card -> the launch counts its wrappers keep (one
# kernel in two roles counts under both)
KERNEL_SYMBOLS = {
    "flash_fwd_kernel": ("flash_attention_fwd",),
    "flash_bwd_dkv_kernel": ("flash_attention_bwd_dkv",),
    "flash_bwd_dq_kernel": ("flash_attention_bwd_dq",),
    "flash_fwd_bf16_wgmma_kernel": ("flash_attention_fwd_bf16",),
    "flash_fwd_bf16_mma_kernel": ("flash_attention_fwd_bf16_mma",),
    "flash_bwd_dkv_bf16_wgmma_kernel": ("flash_attention_bwd_dkv_bf16",),
    "flash_bwd_dq_bf16_wgmma_kernel": ("flash_attention_bwd_dq_bf16",),
    "flash_bwd_dkv_bf16_mma_kernel": ("flash_attention_bwd_dkv_bf16_mma",),
    "flash_bwd_dq_bf16_mma_kernel": ("flash_attention_bwd_dq_bf16_mma",),
    "paged_attention_split_kernel": ("paged_attention",),
    "conv3x3_kernel": ("conv3x3_fwd", "conv3x3_dx"),
    "conv3x3_bf16_wgmma_kernel": ("conv3x3_fwd_bf16", "conv3x3_dx_bf16"),
    "conv3x3_bf16_ragged_kernel": ("conv3x3_fwd_bf16_ragged",
                                   "conv3x3_dx_bf16_ragged"),
    "fused_lstm_kernel": ("fused_lstm", "fused_lstm_bf16"),
    "fused_gru_kernel": ("fused_gru",),
    "matmul_kernel": ("matmul",),
    "matmul_bf16_wgmma_kernel": ("matmul_bf16",),
    "matmul_bf16_ragged_kernel": ("matmul_bf16_ragged",),
}
# the Executor's run counters a compiled path is held to
_EXE_KEYS = ("jit_runs", "eager_runs", "hybrid_runs", "graph_captures",
             "graph_replays")


def _exe_delta(exe, before):
    return {k: exe.stats[k] - before[k] for k in _EXE_KEYS}


def _compiled_gate(label, delta, steps):
    """``steps`` Trainer steps ran compiled: the warm-up, the capture,
    one replay a step from the capture on, and no eager fallback."""
    want = {"jit_runs": steps, "eager_runs": 0, "hybrid_runs": 0,
            "graph_captures": 1 if steps > 1 else 0,
            "graph_replays": steps - 1}
    if delta != want:
        fail("%s: the Executor's runs %s over %d steps, expected %s (a "
             "capture failed or a step left the compiled path)"
             % (label, delta, steps, want))


def _traces(delta, steps):
    """How many of ``steps`` compiled steps ran their lowerings (and so
    the tune consults): the eager ones and the captures."""
    return steps - delta["graph_replays"] + delta["graph_captures"]


def _eager_steps(trainer, batches):
    """Run ``batches`` through the trainer's program on the per-op path
    (a window that patches a Python function needs its lowerings run)."""
    for data in batches:
        trainer.exe.run(trainer.main_program,
                        feed=trainer.feeder.feed(data),
                        fetch_list=trainer.fetch_list, use_jit=False)


def _by_kind(prof):
    """Device ms by kind of kernel over a profile."""
    kinds = collections.OrderedDict((k, 0.0) for k in (
        "gemm", "flash", "conv", "rnn", "copy", "other"))
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        k = e.key.lower()
        if "flash_" in k:
            kinds["flash"] += t
        elif "fused_lstm" in k or "fused_gru" in k:
            kinds["rnn"] += t
        elif any(w in k for w in ("conv", "cudnn", "implicit", "dgrad",
                                  "wgrad", "fprop")):
            kinds["conv"] += t
        elif any(w in k for w in ("gemm", "cutlass", "gemv", "matmul",
                                  "xmma")):
            kinds["gemm"] += t
        elif "memcpy" in k or "memset" in k:
            kinds["copy"] += t
        else:
            kinds["other"] += t
    return kinds


def _symbol_launches(prof, counted):
    """Device launches of each kernel symbol over a profile against the
    launches its wrappers ``counted`` over the same steps: {symbol:
    (device, counted)} for every symbol either saw."""
    import re
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for sym, names in KERNEL_SYMBOLS.items():
        pat = re.compile(r"(^|[\s:])%s[<(]" % sym)
        dev_n = sum(e.count for e in device if pat.search(e.key))
        want = sum(counted[n] for n in names)
        if dev_n or want:
            out[sym] = (dev_n, want)
    return out


def _kept_graph_class():
    """A CUDA graph class whose graphs keep their ``cudaGraph_t`` after
    the capture (``keep_graph``), so that their nodes can be read; each
    is instantiated at its first replay."""

    class KeptGraph(torch.cuda.CUDAGraph):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    return KeptGraph


def _graph_symbol_nodes(graph, delta):
    """What one replay of a captured step launches, read from the
    driver: {symbol: (kernel nodes of the graph that run it, launches
    its wrappers add a replay)} for every symbol either has."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            fail("cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_char * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params):
            fail("cuGraphKernelNodeGetParams_v2 failed")
        func = ctypes.c_void_p.from_buffer(params).value
        name = ctypes.c_char_p()
        if cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)):
            fail("cuFuncGetName failed")
        names.append(name.value.decode())
    out = {}
    for sym, counters in KERNEL_SYMBOLS.items():
        # a mangled name holds the symbol after its length
        tag = "%d%s" % (len(sym), sym)
        got = sum(1 for nm in names if tag in nm)
        want = sum(delta.get(c, 0) for c in counters)
        if got or want:
            out[sym] = (got, want)
    return out


def _persistables(program, scope):
    return {v.name: scope.find_var(v.name).clone()
            for v in program.list_vars() if v.persistable
            and isinstance(scope.find_var(v.name), torch.Tensor)}


def _mode_run(dev, program, cost, feed, state, use_jit, keep=False):
    """COMPILED_STEPS steps of ``program`` on ``feed`` from ``state`` in a
    fresh scope and Executor, then PROFILE_STEPS profiled ones: the loss
    tensors, each step's CUDA-event ms, the launch counts, the
    Executor's run and tune counters, the peak memory, the state after
    the timed steps and the profile window. ``keep``: also return the
    Executor and scope."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels, tune
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    exe, scope = Executor(dev), Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    before, tune0 = dict(exe.stats), tune.counters()
    losses, ms = [], []
    plain_graph = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = _kept_graph_class()
    try:
        for _ in range(COMPILED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = exe.run(program, feed=feed, fetch_list=[cost],
                          scope=scope, use_jit=use_jit, return_numpy=False)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(out[0])
    finally:
        torch.cuda.CUDAGraph = plain_graph
    steps = [e for e in exe._cache.values() if e.graph is not None]
    rec = {"launches": kernels.launch_counts(),
           "executor": _exe_delta(exe, before),
           "tune": {k: v - tune0[k] for k, v in tune.counters().items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "step_ms": ms, "step_ms_p50": float(np.median(ms)),
           "step_ms_p50_from_step3": float(np.median(ms[2:]))}
    if steps:
        rec["graph_kernel_nodes"] = _graph_symbol_nodes(steps[-1].graph,
                                                        steps[-1].delta)
    final = _persistables(program, scope)
    counts0 = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(PROFILE_STEPS):
            exe.run(program, feed=feed, fetch_list=[cost], scope=scope,
                    use_jit=use_jit, return_numpy=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    counted = {k: v - counts0[k] for k, v in kernels.launch_counts().items()}
    window = _device_kernels(prof, wall)
    window["by_kind_ms"] = _by_kind(prof)
    window["steps"] = PROFILE_STEPS
    window["symbol_launches"] = _symbol_launches(prof, counted)
    rec["profile"] = window
    if keep:
        return rec, losses, final, exe, scope
    exe.close()
    return rec, losses, final


def _compiled_path(dev, label, program, cost, feed, state, kernel,
                   repeat=False):
    """One path of phase 12: eager against compiled from ``state``, the
    gates, and (``repeat``) repeat=REPEAT_K against REPEAT_K single
    compiled runs. Returns the record and the compiled run's launches."""
    eager, e_losses, e_final = _mode_run(dev, program, cost, feed, state,
                                         use_jit=False)
    comp, c_losses, c_final, exe, scope = _mode_run(
        dev, program, cost, feed, state, use_jit=True, keep=True)
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(e_losses, c_losses)]
    same_loss = all(torch.equal(a, b) for a, b in zip(e_losses, c_losses))
    state_diff = {n: float((t.double() - c_final[n].double()).abs().max())
                  for n, t in e_final.items()}
    same_state = all(torch.equal(t, c_final[n]) for n, t in e_final.items())
    rec = {"losses": [float(l.float().reshape(-1)[0]) for l in c_losses],
           "max_abs_loss_diff_vs_eager": max(diffs),
           "losses_bit_identical": same_loss,
           "state_bit_identical": same_state,
           "max_abs_state_diff_vs_eager": max(state_diff.values()),
           "eager": eager, "compiled": comp}
    if repeat:
        snap = _persistables(program, scope)
        exe.run(program, feed=feed, fetch_list=[cost], scope=scope,
                repeat=REPEAT_K)
        rep = _persistables(program, scope)
        for n, t in snap.items():
            scope.set_var(n, t.clone())
        for _ in range(REPEAT_K):
            exe.run(program, feed=feed, fetch_list=[cost], scope=scope)
        single = _persistables(program, scope)
        rec["repeat"] = {
            "k": REPEAT_K,
            "state_bit_identical": all(torch.equal(t, single[n])
                                       for n, t in rep.items()),
            "executor_after": {k: exe.stats[k] for k in _EXE_KEYS}}
        del snap, rep, single
    exe.close()
    del exe, scope, e_final, c_final
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"compiled_" + label: rec}))
    if not (same_loss and same_state):
        fail("%s: compiled steps differ from the eager ones (losses %s, "
             "largest loss difference %g, largest state difference %g)"
             % (label, "identical" if same_loss else "different",
                max(diffs), rec["max_abs_state_diff_vs_eager"]))
    _compiled_gate(label + " (phase 12)", comp["executor"], COMPILED_STEPS)
    if eager["executor"]["eager_runs"] != COMPILED_STEPS:
        fail("%s: the eager run took another path: %s"
             % (label, eager["executor"]))
    if comp["launches"] != eager["launches"] or \
            not comp["launches"][kernel]:
        fail("%s: compiled launches %s, eager %s (kernel %s expected)"
             % (label, comp["launches"], eager["launches"], kernel))
    # the kernel nodes of the captured graph, which every replay launches,
    # against the launches the wrappers add a replay; the profiler's
    # counts are printed, not gated: in both modes it misses a record now
    # and then (47 of 48 flash forwards in the LM's 2-step windows)
    nodes = comp.get("graph_kernel_nodes", {})
    off = {sym: n for sym, n in nodes.items() if n[0] != n[1]}
    if off or not nodes:
        fail("%s: the captured graph's kernel nodes of each symbol differ "
             "from the launches its wrappers add a replay {symbol: (graph, "
             "counted)}: %s" % (label, off or nodes))
    for sym, (got, _) in nodes.items():
        if comp["profile"]["symbol_launches"].get(sym, (0, 0))[1] != \
                got * PROFILE_STEPS:
            fail("%s: the wrappers counted %s over %d replays, the graph "
                 "launches %d %s a replay"
                 % (label, comp["profile"]["symbol_launches"].get(sym),
                    PROFILE_STEPS, got, sym))
    if repeat and not rec["repeat"]["state_bit_identical"]:
        fail("%s: repeat=%d left another state than %d single compiled "
             "runs" % (label, REPEAT_K, REPEAT_K))
    return rec, comp["launches"]


def _compiled_lm(dev, amp=False):
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    widths, cfg, spec, trainer, main_prog = _lm_build(dev)
    if amp:
        from paddle_tpu_torch import amp as amp_mod
        amp_mod.enable(main_prog, pure=True)
    with scope_guard(Scope()) as _:
        trainer._maybe_init()
        from paddle_tpu_torch.core.scope import global_scope
        state = _persistables(main_prog, global_scope())
        feed = trainer.feeder.feed(next(iter(spec["reader"]())))
    label = "lm_pure_amp" if amp else "lm"
    kernel = "flash_attention_fwd" + ("_bf16" if amp else "")
    out = _compiled_path(dev, label, main_prog, spec["cost"], feed, state,
                         kernel, repeat=not amp)
    trainer.exe.close()
    return out


def _first_divergence(dev, program, feed, state):
    """Run one step's lowerings twice on the per-op path from ``state``
    and compare every op output by name, in program order: (index, op
    type, var, largest difference) of the first that differs and how many
    do, or None. Two runs of one step differ only where a library's
    algorithm is not deterministic."""
    from paddle_tpu_torch.core.executor import raw_data, trace_ops
    block = program.global_block()

    def run():
        env = dict(feed)
        env.update({n: t.clone() for n, t in state.items()})
        with torch.no_grad():
            trace_ops(block, env, torch.Generator(device=dev).manual_seed(0),
                      dev)
        torch.cuda.synchronize()
        return env

    a, b = run(), run()
    first, n_diff = None, 0
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names:
            x, y = raw_data(a.get(n)), raw_data(b.get(n))
            if isinstance(x, torch.Tensor) and not torch.equal(x, y):
                n_diff += 1
                if first is None:
                    first = {"op_index": i, "op": op.type, "var": n,
                             "max_abs_diff": float((x.double() - y.double())
                                                   .abs().max())}
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"first": first, "outputs_differing": n_diff}


def _compiled_resnet(dev):
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = resnet_cifar.model(variant="imagenet", depth=50, image=224,
                                  class_dim=1000, batch=R50_BATCH,
                                  learning_rate=R50_LR)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    rng = np.random.RandomState(0)
    batch = list(zip(rng.rand(R50_BATCH, 3, 224, 224).astype(np.float32),
                     rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)))
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feed = trainer.feeder.feed(batch)
    # cuDNN's default algorithms for the convs' weight gradients are not
    # deterministic: two eager runs of one step differ (printed), so the
    # compiled run is held to the eager one with deterministic algorithms
    # in both
    probe = _first_divergence(dev, main_prog, feed, state)
    log(json.dumps({"resnet50_eager_vs_eager": probe}))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = _compiled_path(dev, "resnet50", main_prog, spec["cost"], feed,
                             state, "conv3x3_fwd")
    finally:
        torch.backends.cudnn.deterministic = saved
    out[0]["eager_vs_eager"] = probe
    out[0]["cudnn_deterministic"] = True
    trainer.exe.close()
    return out


def _rnn_trainer(dev, cell, samples):
    from paddle_tpu_torch.configs import text_rnn
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = text_rnn.model(cell=cell, samples=samples, **RNN_BENCH)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    return spec, trainer, main_prog


def _compiled_rnn(dev, cell):
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    spec, trainer, main_prog = _rnn_trainer(dev, cell, RNN_BENCH["batch"])
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feed = trainer.feeder.feed(next(iter(spec["reader"]())))
    out = _compiled_path(dev, "rnn_" + cell, main_prog, spec["cost"], feed,
                         state, "fused_" + cell)
    trainer.exe.close()
    return out


def _pool_bytes(pool):
    """Bytes the caching allocator holds in a graph memory pool."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in
               torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _ragged_feeds(trainer, rng):
    """One LSTM batch for each of RAGGED_LENS: sequence lengths drawn up
    to the longest, which one sequence has."""
    vocab, batch = RNN_BENCH["vocab"], RNN_BENCH["batch"]
    feeds = []
    for top in RAGGED_LENS:
        lens = rng.randint(top // 2, top + 1, batch)
        lens[rng.randint(batch)] = top
        samples = [(rng.randint(0, vocab, (n, 1)).astype(np.int64),
                    rng.randint(0, 2, (1,)).astype(np.int64)) for n in lens]
        feeds.append(trainer.feeder.feed(samples))
    return feeds


def _compiled_ragged(dev):
    """Ragged LSTM batches whose longest sequences differ, so each is a
    key of its own: each twice (warm-up, capture and replay) then each
    once more (a replay), compiled against eager from one state. The
    losses bit-identical, one capture and two replays a key, the graphs
    in the Executor's one pool; step ms and memory printed."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    spec, trainer, main_prog = _rnn_trainer(dev, "lstm", RNN_BENCH["batch"])
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feeds = _ragged_feeds(trainer, np.random.RandomState(3))
    order = [i for i in range(len(feeds)) for _ in range(2)] + \
        list(range(len(feeds)))
    runs = {}
    for use_jit in (False, True):
        exe, scope = Executor(dev), Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
        losses, ms, reserved, pool = [], [], [], []
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = exe.run(main_prog, feed=feeds[i],
                          fetch_list=[spec["cost"]], scope=scope,
                          use_jit=use_jit, return_numpy=False)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(out[0])
            reserved.append(torch.cuda.memory_reserved(dev) - reserved0)
            pool.append(_pool_bytes(exe._pool))
        k = len(feeds)
        runs[use_jit] = {
            "losses": losses, "step_ms": ms,
            "step_ms_p50_last_pass": float(np.median(ms[2 * k:])),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
            "reserved_growth_bytes": reserved, "graph_pool_bytes": pool,
            "graphs_in_pool": exe._pool_graphs.get(exe._pool, 0),
            "executor": {n: exe.stats[n] for n in _EXE_KEYS}}
        exe.close()
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(runs[False]["losses"],
                                                 runs[True]["losses"]))
    rec = {"longest": list(RAGGED_LENS), "order": order,
           "losses_bit_identical": same}
    for use_jit, r in runs.items():
        r["losses"] = [float(l.reshape(-1)[0]) for l in r["losses"]]
        rec["compiled" if use_jit else "eager"] = r
    log(json.dumps({"compiled_ragged": rec}))
    k = len(RAGGED_LENS)
    want = {"jit_runs": 3 * k, "eager_runs": 0, "hybrid_runs": 0,
            "graph_captures": k, "graph_replays": 2 * k}
    if not same or rec["compiled"]["executor"] != want \
            or rec["compiled"]["graphs_in_pool"] != k:
        fail("ragged LSTM keys: losses %s, executor %s (expected %s), %d "
             "graphs in the shared pool"
             % ("identical" if same else "different",
                rec["compiled"]["executor"], want,
                rec["compiled"]["graphs_in_pool"]))
    trainer.exe.close()
    return rec


def _compiled_pipeline(dev):
    """The pipelined Trainer (depth PIPE_DEPTH) on the LSTM classifier
    over PIPE_BATCHES distinct batches against the synchronous Trainer
    from the same state: losses bit-identical."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import EndIteration
    spec, trainer, main_prog = _rnn_trainer(
        dev, "lstm", PIPE_BATCHES * RNN_BENCH["batch"])
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    runs = {}
    for pipelined in (False, True):
        trainer.exe.close()
        trainer.exe = Executor(dev)
        with scope_guard(Scope()):
            for n, t in state.items():
                global_scope().set_var(n, t.clone())
            trainer._initialized = True
            costs = []
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trainer.train(spec["reader"], num_passes=1,
                          event_handler=lambda e: costs.append(e)
                          if isinstance(e, EndIteration) else None,
                          pipeline=pipelined, pipeline_depth=PIPE_DEPTH)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            runs[pipelined] = {
                "losses": [e.cost for e in costs], "wall_s": wall,
                "executor": {k: trainer.exe.stats[k] for k in
                             _EXE_KEYS + ("lazy_fetches", "feed_wait_ms",
                                          "dispatch_depth")},
                "feed_pipeline": trainer.pipeline_stats}
    trainer.exe.close()
    rec = {"sync": runs[False], "pipelined": runs[True],
           "depth": PIPE_DEPTH, "batches": PIPE_BATCHES}
    log(json.dumps({"compiled_pipeline": rec}))
    if runs[True]["losses"] != runs[False]["losses"] or \
            len(runs[True]["losses"]) != PIPE_BATCHES:
        fail("pipelined Trainer losses %s differ from the synchronous %s"
             % (runs[True]["losses"], runs[False]["losses"]))
    piped = runs[True]["feed_pipeline"] or {}
    if piped.get("slot_reuse") != PIPE_BATCHES - PIPE_DEPTH \
            or piped.get("fallback_sync"):
        fail("pipelined Trainer's ring: %s, expected %d slot reuses and no "
             "fallback" % (piped, PIPE_BATCHES - PIPE_DEPTH))
    for mode, r in runs.items():
        _compiled_gate("pipeline=%s" % mode, {
            k: r["executor"][k] for k in _EXE_KEYS}, PIPE_BATCHES)
    return rec


def _compiled_hybrid(dev, work):
    """A save between two device segments: hybrid runs, both segments
    captured, the file the eager run's."""
    import pickle
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    xs = np.random.RandomState(0).rand(1024, 1024).astype(np.float32)
    files, outs, stats = {}, {}, {}
    for use_jit in (True, False):
        path = os.path.join(work, "hybrid_%s" % use_jit, "a")
        prog = ir.Program()
        blk = prog.global_block()
        x = blk.create_var(name="x", shape=(1024, 1024), dtype="float32")
        a = blk.create_var(name="a", shape=(1024, 1024), dtype="float32")
        b = blk.create_var(name="b", shape=(1024, 1024), dtype="float32")
        blk.append_op("scale", inputs={"X": [x]}, outputs={"Out": [a]},
                      attrs={"scale": 2.0, "bias": 1.0})
        blk.append_op("save", inputs={"X": [a]}, attrs={"file_path": path})
        blk.append_op("scale", inputs={"X": [a]}, outputs={"Out": [b]},
                      attrs={"scale": 3.0})
        exe, scope = Executor(dev), Scope()
        for _ in range(3):
            outs[use_jit] = exe.run(prog, feed={"x": xs}, fetch_list=[b],
                                    scope=scope, use_jit=use_jit)[0]
        stats[use_jit] = {k: exe.stats[k] for k in _EXE_KEYS}
        exe.close()
        with open(path, "rb") as f:
            files[use_jit] = pickle.load(f)["data"]
    rec = {"compiled": stats[True], "eager": stats[False],
           "file_equal": bool(np.array_equal(files[True], files[False])),
           "fetch_equal": bool(np.array_equal(outs[True], outs[False]))}
    log(json.dumps({"compiled_hybrid": rec}))
    if not (rec["file_equal"] and rec["fetch_equal"]
            and stats[True]["hybrid_runs"] == 3
            and stats[True]["graph_captures"] == 2
            and stats[True]["graph_replays"] == 4):
        fail("hybrid program: %s" % rec)
    return rec


def _compiled_fallback(dev):
    """A test-only op that reads a value back to the host: the capture
    fails, warns, the run falls back and is right; then another program
    captures."""
    import warnings
    from paddle_tpu_torch.configs import fit_a_line
    from paddle_tpu_torch.core import ir, registry, unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope

    if registry.lookup("smoke_host_read") is None:
        @registry.register_op("smoke_host_read", no_gradient=True)
        def _host_read(ctx):
            x = ctx.input("X")
            ctx.set_output("Out", x * float(x.abs().max().item()))

    prog = ir.Program()
    blk = prog.global_block()
    x = blk.create_var(name="x", shape=(4,), dtype="float32")
    out = blk.create_var(name="out", shape=(4,), dtype="float32")
    blk.append_op("smoke_host_read", inputs={"X": [x]},
                  outputs={"Out": [out]})
    exe, scope = Executor(dev), Scope()
    xs = np.array([1.0, -3.0, 2.0, 0.5], np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [exe.run(prog, feed={"x": xs}, fetch_list=[out],
                       scope=scope)[0] for _ in range(3)]
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = fit_a_line.model()
        spec["optimizer"].minimize(spec["cost"])
    b = next(iter(spec["reader"]()))
    feed = {"x": np.stack([r[0] for r in b]),
            "y": np.stack([r[1] for r in b])}
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main_prog, feed=feed, fetch_list=[spec["cost"]],
                scope=scope)
    rec = {"warnings": msgs, "executor": {k: exe.stats[k]
                                          for k in _EXE_KEYS},
           "results_right": all(np.array_equal(g, xs * 3.0) for g in got)}
    exe.close()
    log(json.dumps({"compiled_fallback": rec}))
    if not (len(msgs) == 1 and "smoke_host_read" in msgs[0]
            and rec["results_right"]
            and rec["executor"]["eager_runs"] == 2
            and rec["executor"]["graph_captures"] == 1):
        fail("capture fallback: %s" % rec)
    return rec


def phase_compiled(dev, root):
    """Phase 12: the Executor's compiled step against its per-op path on
    every training path, in one call. Returns ({path: launches}, the
    summary)."""
    t0 = time.monotonic()
    work = _fresh_dir(os.path.join(root, "build", "chip_smoke", "compiled"))
    paths, summary = {}, {}
    for label, fn in (("lm", lambda: _compiled_lm(dev)),
                      ("lm_pure_amp", lambda: _compiled_lm(dev, amp=True)),
                      ("resnet50", lambda: _compiled_resnet(dev)),
                      ("rnn_lstm", lambda: _compiled_rnn(dev, "lstm")),
                      ("rnn_gru", lambda: _compiled_rnn(dev, "gru"))):
        rec, launches = fn()
        paths["compiled_" + label] = launches
        summary[label] = {
            mode: {"step_ms_p50": rec[mode]["step_ms_p50"],
                   "step_ms_p50_from_step3":
                       rec[mode]["step_ms_p50_from_step3"],
                   "device_busy_share":
                       rec[mode]["profile"]["device_busy_share"],
                   "device_kernel_ms_two_steps":
                       rec[mode]["profile"]["device_kernel_ms"],
                   "peak_memory_bytes": rec[mode]["peak_memory_bytes"],
                   "tune": rec[mode]["tune"]}
            for mode in ("eager", "compiled")}
        summary[label]["max_abs_loss_diff_vs_eager"] = \
            rec["max_abs_loss_diff_vs_eager"]
        if "eager_vs_eager" in rec:
            summary[label]["eager_vs_eager"] = rec["eager_vs_eager"]
    summary["ragged"] = _compiled_ragged(dev)
    summary["pipeline"] = _compiled_pipeline(dev)
    summary["hybrid"] = _compiled_hybrid(dev, work)
    summary["fallback"] = _compiled_fallback(dev)
    summary["wall_s"] = time.monotonic() - t0
    log(json.dumps({"compiled": summary}))
    return paths


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
    prompts, results, serve_launches, plain_serving = timed(
        3, phase_engine, dev, art_dir)
    http = timed(4, phase_http, dev, art_dir, prompts, results)
    train5 = timed(5, phase_train, dev, os.path.join(
        root, "build", "chip_smoke", "gpt2_small_trained"))
    conv_kernels, (convnet_launches, f32_images_s) = timed(
        6, lambda: (_conv3x3_kernel_check(dev), phase_convnet(dev)))
    kernels.update(conv_kernels)
    rnn_kernels, (lstm_launches, lstm_run), (gru_launches, _) = timed(
        7, lambda: (_rnn_kernel_check(dev), phase_rnn(dev, "lstm"),
                    phase_rnn(dev, "gru")))
    kernels.update(rnn_kernels)
    mm_kernels, tuned_launches, consult_launches, tuned = timed(
        8, phase_tune, dev, root, train5)
    kernels.update(mm_kernels)
    amp_kernels, amp_paths = timed(9, phase_amp, dev, root, f32_images_s,
                                   tuned, lstm_run)
    kernels.update(amp_kernels)
    spec_paths = timed(10, phase_speculative, dev, root, art_dir, prompts,
                       results, plain_serving)
    disagg_paths = timed(11, phase_disagg, dev, root, art_dir, prompts,
                         results, plain_serving, http)
    compiled_paths = timed(12, phase_compiled, dev, root)
    log(json.dumps({"seconds": round(time.monotonic() - t_start, 3)}))
    paths = {"serve": serve_launches, **spec_paths, **disagg_paths,
             "train": train5["launches"],
             "convnet_train": convnet_launches,
             "rnn_train_lstm": lstm_launches,
             "rnn_train_gru": gru_launches,
             "tuned_train": tuned_launches,
             "convnet_conv3x3_consult": consult_launches, **amp_paths,
             **compiled_paths}
    for name, entry in kernels.items():
        # each main path is read with the counts set to 0 just before it
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["launches"] == 0 and entry.get("main_path", True):
            fail("kernel %s was launched on no main path" % name)
        entry["kernel_ms"] = entry["ms"]
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
