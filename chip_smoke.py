#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch on one NVIDIA card (an H100).

Drives the port's generative serving path (plain, speculative,
prefix-shared and disaggregated) and its Fluid training path (with
gradient clipping, weight decay, learning-rate schedules and every
optimizer) at the widths of GPT-2 small, its conv-net training path on ImageNet
ResNet-50, its sequence training path on the stacked-RNN text
classifier of ``benchmark/rnn_bench.py``, its autotune path (the
``tune`` verb, the winner cache, the tuned dispatch of ``mul`` and
``conv2d``) and AMP (bfloat16) training of ResNet-50 and the LM, and
holds each hand-written CUDA kernel against its plain PyTorch version;
and pure-AMP training of the bias-free LSTM classifier; and the dense
tensor and loss ops, on the word2vec and recommender book models and
at GPT-2 small's attention shapes; and the rest of the conv-net path
(its ops, the conv knobs) on VGG-16, GoogLeNet and AlexNet at ImageNet
widths; and the sequence stack (its ops, the book's sentiment nets and
semantic role tagger). Run from the root of a checkout:

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
   reference, exactly 72 matmul launches a step, 72 tune hits and 1
   fallback for the run's one step key, the losses within 1e-3 of phase 5's, and two profiled steps;
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
   is right, and the next program captures;
13. checkpoint: the LM at GPT-2 small's widths (float32, 8 x 1024 tokens
   a step, Adam, the compiled Trainer): run A trains ``CKPT_BATCHES``
   distinct batches, run B on a ``checkpoint_dir`` calls
   ``request_preempt()`` from its handler at batch ``CKPT_PREEMPT_AT``
   (one ``preempt_checkpoint`` event there), run C (a new Trainer,
   Executor and scope on the same directory) resumes and trains the rest:
   C's losses and final persistables bit-identical to A's; an async save
   at step k and step k + 1 at once (a replay writing the state in place):
   the files bit-equal to the host copy of step k's state; three saves
   with ``keep_last=2`` leave two directories and ``load_latest`` the
   newest; ``Trainer.test`` on a held-out batch three times: one capture,
   12 flash forwards a run and no backward, the cost within
   ``TEST_COST_REL_TOL`` of the next training step's on that batch; the
   logits' inference model loaded in a new Executor and scope and run
   twice: bit-equal to the test program's logits, 12 flash forwards a
   run, no Adam moment among its files; ResNet-50 at 224 x 224, batch 32,
   trained 2 steps and exported: 16 conv3x3 forwards a run of the loaded
   model, image 0's logits alone within ``R50_TEST_REL_TOL`` of row 0 of
   the batch's (``batch_norm`` on its running statistics), and the
   loaded program's logits within it of the same program's with every
   conv on cuDNN; ``python -m
   paddle_tpu_torch train`` of text_rnn with ``--checkpoint_dir`` as a
   subprocess, SIGTERM after its first logged batch: exit 0, and the
   checkpoint resumes in this process (2 batches on the fused LSTM
   kernel); the book config recognize_digits_conv trained by the CLI,
   exit 0. It prints the save and load ms, bytes and MB/s of each
   checkpoint, the async save's snapshot ms beside its write ms, and the
   test program's ms at its warm-up, capture and replay;
14. optimization: the training recipes of clipping, weight decay and
   learning-rate schedules, each compiled (a warm-up, a capture,
   replays) from one saved state: the LM at GPT-2
   small's widths (float32, 8 x 1024 tokens a step) under Adam on a
   ``polynomial_decay`` schedule with ``GradientClipByGlobalNorm(1.0)``
   on every parameter and ``L2Decay(0.01)``, and ResNet-50 at 224 x 224,
   batch 32 (cuDNN deterministic) under Momentum 0.9, ``L2Decay(1e-4)``
   and a ``piecewise_decay`` schedule: ``OPT_STEPS`` compiled steps
   bit-identical to as many per-op steps in losses, LRs and every
   persistable (the int64 step counter included), one capture, a replay
   a step, no fallback; every LR at its closed form in float64 (the
   pieces exactly); each parameter's update at every LM step and at
   ResNet-50's step 1 within ``OPT_UPDATE_TOL`` of max(1, |p|) of its
   float64 recomputation from the step's fetched gradients (global
   norm, clip scale, decay, the update op's formula; the steps where
   the clip binds printed), and, as the recipe's clip does not bind at
   the LM's first steps, the same LM with a clip of
   ``OPT_LM_BIND_CLIP`` held so over ``OPT_LM_BIND_STEPS`` steps, its
   clip binding at each; 24 flash forward
   and 12 of each flash backward launch a LM step, 16 conv3x3 forward
   and 16 dx a ResNet-50 step; the step p50 and the captured graph's
   kernel nodes printed beside phase 12's plain-Adam and plain-Momentum
   steps; the LSTM classifier at rnn_bench widths once under each of
   ``OPT_RNN_RECIPES`` (Adagrad, RMSProp with momentum, Adamax,
   DecayedAdagrad, Ftrl with l1, Adadelta clipped by value, SGD clipped
   by norm, each on its schedule), compiled (warm-up, capture, 2
   replays, 2 fused LSTM launches a layer a step): the update at the
   capture's replay within ``OPT_RNN_UPDATE_TOL`` of its float64
   recomputation and every LR at its closed form; ``ModelAverage`` on
   the LM (2 steps, ``apply``, ``Trainer.test``, ``restore``, 2 steps):
   the losses bit-identical to a run without it, ``apply`` and
   ``restore`` ms printed;
15. memory: the verifier and the memory planner with ``FLAGS.verify``
   on, at phase 5's LM (GPT-2 small's widths, Adam 1e-3, 8 x 1024
   tokens): the main and startup programs verify with 0 errors (the
   warnings by code, the host ms of each verify and of
   ``append_backward``'s post-pass printed), and the Executor's hook
   walks the program once an Executor; the plan (peak, classes,
   high-water op, PT033 count) equal to ``LM_PLAN_PEAK_BYTES``, which
   the CPU tests compute in both packages; from one saved state, one
   step through ``trace_ops`` keeping every value (the parent's
   Executor) against one through ``Executor.run(use_jit=False)``, which
   frees each value at its last use: the loss and every persistable
   bit-identical, the release's peak at most ``RELEASE_PEAK_SHARE`` of
   the keep-all peak and at least the plan's, 24 / 12 / 12 flash
   launches; ``MEM_STEPS`` compiled runs with the release and as many
   keeping every value: bit-identical, one capture each, the peak
   allocated and reserved bytes, the graph pool's bytes and the replay
   p50 of both printed; the LM at ``MEM_REFUSE_BATCH`` against the
   card's own memory refused with PT030 naming the high-water op, with
   no CUDA OOM, no step run and under ``MEM_REFUSED_BYTES`` allocated;
   the batch-8 step refused at a budget 1 MiB under its preflight's
   peak and run 1 MiB over; ResNet-50 at batch 32, one compiled step
   under the hook and the preflight, 16 conv3x3 forward and 16 dx
   launches, the plan's peak beside the measured one; ``python -m
   paddle_tpu_torch lint`` of the conv-net config with ``--memory
   --batch 32`` exits 0 and prints the residency table;
16. resilience: the step watchdog, the numeric guardrails and the
   profiler at phase 5's LM (GPT-2 small's widths, Adam 1e-3, 8 x 1024
   tokens, compiled, ``checkpoint_dir`` under ``build/chip_smoke/``):
   a clean pipelined pass of 3 batches ends with a save (its first two
   batches' warm-up plus capture ms printed); a pass of 6 under
   ``loss_skip_budget=2``, ``pipeline=True``, with a NaN written
   through the scope into a weight before batch 2: batches 2 and 3
   skipped (``nonfinite``), one ``guard_rewind``, batches 4-5 accepted
   and finite, ``graph_captures`` unmoved and one replay a step, the
   profiler's ``batches_skipped`` 2 and ``guard_rewinds`` 1, the flash
   forward and backward launched; the accepted losses bit-identical to
   a rerun of batches 4-5 from the same checkpoint on the same Trainer;
   the rewind's ms and the step p50 with the guard on and off
   (``RESILIENCE_TIMED`` pipelined steps each) printed; ``python -m
   paddle_tpu_torch train`` of the fit_a_line config under
   ``PADDLE_TPU_FLAGS=step_timeout_s=2`` and
   ``PADDLE_TPU_FAULT_SPEC=trainer.step:delay:nth=3,delay=3600`` exits
   75 within the deadline plus the clean run's wall plus 30 s, with one
   ``step_hung`` line at ``pass0/batch2`` in ``events.jsonl`` and a
   timeline of ``trainer.steps_hung`` 1; the same command without the
   fault spec exits 0; a fresh LM Trainer trains 3 batches under a
   watchdog of ``DEADLINE_MULTIPLE`` times the warm-up plus capture ms,
   with an injected ``on_hang``, which must not fire; a fresh LM
   Trainer trains 3 batches under ``profiler(timeline_path=...)`` and
   one more under ``cuda_profiler``: the ``programs`` entry's flash
   nodes equal phase 12's captured graph's, ``host_events`` holds the
   3 runs, and the trace names the three flash kernels;
17. dense: every op of the dense slice (the 24 tensor ops, ``matmul``,
   ``norm``, ``maximum``, ``isfinite``, the 12 losses) and its grad
   (``matmul_grad``, or the generic one) run on the card and on the CPU
   on the same seeded inputs, at the op-contract suite's shapes, their
   edges and the book models' shapes (``_dense_cases``): data movement,
   index and bool outputs bit-identical, float ones within
   ``DENSE_OP_TOL`` of max(1, |CPU value|), the largest error printed
   per op; ``range`` on the hybrid path; the random ops' 2^16 draws
   within 5 standard errors of their law's mean and variance on both
   devices; ``matmul`` at GPT-2 small's attention shapes (q, k, v of
   [8, 12, 1024, 64], TF32 off): q kᵀ (``transpose_Y``, alpha 1/8), the
   [8, 12, 1024, 1024] product with v and ``matmul_grad`` of both
   against float64 (``DENSE_MM_TOL`` of the largest magnitude), again
   under pure AMP (one bfloat16 ulp of it plus 2e-5 of it), and a
   [64, 1024] Y broadcast over the batch dims (dY summed over both),
   each timed; word2vec at fluid's book widths (``W2V_BOOK``: 2074
   words, embeddings 32, hidden 256, batch 32, SGD) and the
   recommender at MovieLens-1M's id ranges and chapter 5's widths
   (``REC_BOOK``: batch 256 of one fixed ragged batch): step-1
   gradients of every parameter against float64 autograd of each model
   written out in torch (``shared_w``'s the sum over its four lookups;
   ``BOOK_GRAD_REL_TOL``), ``BOOK_STEPS`` steps through
   ``Trainer.train`` (the loss falls; one capture and a replay a step),
   the step p50 and samples/s compiled and on the per-op path;
   ``python -m paddle_tpu_torch train`` of ``configs/word2vec.py``
   exits 0. The tune cache is a fresh directory of its own for the
   phase;
18. convnet zoo: the rest of the conv-net path. Every op of the slice
   (``prelu``, ``log_softmax``, ``maxout``, ``lrn``, ``l2_normalize``,
   ``scale_sub_region``, ``depthwise_conv2d``, ``conv2d_transpose``,
   ``conv3d``, ``conv3d_transpose``, ``pool3d``, ``dropout`` at
   ``is_test``, ``dropout_grad`` on one fed mask, and the metric ops
   ``auc``, ``precision_recall``, ``edit_distance``,
   ``positive_negative_pair``) and its grad on the card and on the CPU
   on the same seeded inputs (``_convnet_cases``): counts, distances,
   masks and selections bit-identical, floats within
   ``CONVNET_OP_TOL`` of max(1, |CPU value|), the largest error printed
   per op; the dropout train mask's kept share over 2^16 draws within
   ``DROPOUT_Z`` standard errors on both devices, Out = X * Mask, a
   seeded rerun equal; the conv knobs (``conv_impl=matmul``,
   ``PADDLE_TPU_CONV_LAYOUT=nhwc``, ``PADDLE_TPU_CONV_S2D=1``) each
   against the default conv at ResNet-50's stem ([32, 3, 224, 224],
   7x7 / s2 / p3 -> 64) and first 3x3 stage ([32, 64, 56, 56]), output
   and both gradients within ``KNOB_REL_TOL``, each with its ms; the
   conv3x3 kernel at VGG-16's first conv ([32, 224, 224, 3] -> 64, K
   27) against its plain version at full shape, its ms beside
   ``F.conv2d``'s and the bound of its 411 MB output write; the kernel
   forward and dx against its plain version at every other conv3x3
   shape of VGG-16, GoogLeNet and AlexNet (``CONV_REL_TOL``, a TF32
   control missing it at each); VGG-16 with batch norm at ImageNet
   widths (``models.vgg16``, 224 x 224, 1000 classes, float32, batch
   32, TF32 off, ``conv_impl=pallas3x3``, ``Momentum(0.1, 0.9)``):
   step-1 gradients of every parameter against torch.autograd through a
   plain VGG-16 written here (``F.conv2d``, the step's fetched dropout
   masks; ``VGG_GRAD_REL_TOL``, which the same model on TF32-rounded
   conv operands must miss), ``VGG_STEPS`` compiled steps on one fixed
   batch through ``Trainer.train`` (the loss falls; one capture and a
   replay a step; 13 conv3x3 forward and 12 dx launches a step, the
   image wanting no dx), the step p50 and images/s compiled and on the
   per-op path, each step feeding the batch from the host, and both
   again on the batch fed once, the peak memory, one per-op step's
   device time by kind of kernel;
   GoogLeNet and AlexNet the same at 224 x 224, batch 32,
   ``Momentum(0.01, 0.9)``, ``ZOO_STEPS`` steps, their conv3x3 launches
   a step equal to the 3x3 / s1 / p1 convs the smoke counts in each
   program (10 and 3). The tune cache is a fresh directory of its own;
19. sequence: the sequence stack. Every op of the slice (the 25 of
   ``ops/sequence_ops.py``, ``im2sequence``, ``hierarchical_sigmoid``,
   ``sequence_pool``'s stride windows) and its grad on the card and on
   the CPU on the same seeded inputs (``_sequence_cases``: the shapes of
   the three models below and the CPU tests' edges): offsets, paths,
   selections and chunk counts bit-identical, floats within
   ``SEQ_OP_TOL`` of max(1, |CPU value|), the largest error printed per
   op; the three int samplers' 2^16 draws within ``SEQ_Z`` standard
   errors a bucket of their laws on both devices (widened by Bonferroni
   for the bucket count at ``SEQ_FAMILY_ALPHA``); the book's
   ``convolution_net`` (embedding and hidden 32, two
   ``nets.sequence_conv_pool``) and ``stacked_lstm_net`` (embedding 128,
   hidden 512, 3 LSTMs with peepholes on the time loop) over imdb's 5147
   words, batch 128 reviews of 20 to 250 words, Adam 0.002, and the same
   LSTM net without peepholes under ``lstm_impl="pallas"`` (row 7 at
   N 128, D 128: 2 launches a layer a step, held against the time loop
   at step 1, loss, Hidden and every gradient, on the card); ``db_lstm``
   of the book's semantic role labelling (word embedding 32, mark 5,
   hidden 512, depth 8, vocabularies of 44068 words, 3162 predicates and
   59 labels, batch 10 sentences of 4 to 60 words, SGD 0.01, ``crfw`` at
   learning rate 1e-3, tanh fcs and the word embedding not trained, as
   upstream) with its CRF: each at float32, TF32 off, step-1
   gradients of every parameter within ``SEQ_GRAD_REL_TOL`` (relative
   norm) of the port's own CPU run of the same program built in
   float64 (``SEQ_FLIP_GRAD_REL_TOL`` where a max pool picked another
   row, each such flip at a near tie: ``SEQ_TIE_TOL``), ``SEQ_STEPS``
   compiled steps on one fixed batch through ``Trainer.train`` (the
   loss falls; one capture and a replay a step),
   as many per-op steps, the step p50, sequences/s, tokens/s and peak
   memory; the tagger's decoded path against the CPU's on the same
   emissions where the CPU's float64 margin exceeds
   ``VITERBI_MARGIN_TOL`` (the skipped positions printed), and the chunk
   counts of a ``ChunkEvaluator`` program (on the hybrid path) over it;
   row 7 at that population against its plain version, its time beside
   the plain version's, cuDNN's and the bound (the kernels line's
   ``fused_lstm.d128_n128``). The tune cache is a fresh directory of its
   own.

Since phase 15's slice every path of the Executor frees each value at
its last use, so phases 1-14 run on the freeing Executor and their
peaks are those of the step that frees.

Phases 5-9 train through ``Trainer.train``, which runs the compiled
path: each holds its steps to one capture and a replay a step, and the
tune consults of phases 8 and 9 to one count a step key (its warm-up),
as the JAX package counts once a trace. Their windows that patch a wrapper or
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
import contextlib
import ctypes
import gc
import json
import math
import os
import shutil
import signal
import statistics
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
        "traces": _traces(exe_runs), "profile": profile_window}
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
    # the consults count once a step key, at its warm-up: the capture
    # and the replays count nothing (ROADMAP Queue 3 #4)
    traces = rec["traces"]
    if traces != 1 or rec["tune"] != {"tune_hits": per_layer * L,
                                      "tune_misses": 0,
                                      "tune_fallbacks": 1}:
        fail("tuned train tune counters %s over %d steps (%d keys), "
             "expected %d hits and 1 fallback for its one key"
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
        if traces != 1 or rec["tune"] != {"tune_hits": per_layer * L,
                                          "tune_misses": 0,
                                          "tune_fallbacks": 1}:
            fail("%s tune counters %s over %d steps (%d keys), expected "
                 "%d hits and 1 fallback for its one key"
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


def _traces(delta):
    """How many step keys a compiled run warmed up: the runs that were
    not replays. The tune consults count there and only there, once a
    key, as the JAX package counts once a trace (ROADMAP Queue 3 #4)."""
    return delta["jit_runs"] - delta["graph_replays"]


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


def _graph_kernel_names(graph):
    """The function name of every kernel node of a captured graph, read
    from the driver (``profiler.graph_kernel_names``)."""
    from paddle_tpu_torch import profiler
    return profiler.graph_kernel_names(graph)


def _graph_symbol_nodes(graph, delta):
    """What one replay of a captured step launches, read from the
    driver: {symbol: (kernel nodes of the graph that run it, launches
    its wrappers add a replay)} for every symbol either has."""
    names = _graph_kernel_names(graph)
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
        rec["graph_kernel_nodes_total"] = len(
            _graph_kernel_names(steps[-1].graph))
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
    out[0]["program_ops"] = len(main_prog.global_block().ops)
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
    out[0]["program_ops"] = len(main_prog.global_block().ops)
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
    from paddle_tpu_torch import profiler
    return profiler.graph_pool_bytes(pool)


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
        summary[label]["graph_kernel_nodes_total"] = \
            rec["compiled"].get("graph_kernel_nodes_total")
        summary[label]["program_ops"] = rec.get("program_ops")
        if "eager_vs_eager" in rec:
            summary[label]["eager_vs_eager"] = rec["eager_vs_eager"]
        summary[label]["graph_kernel_nodes"] = {
            sym: n[0] for sym, n in
            rec["compiled"].get("graph_kernel_nodes", {}).items()}
    summary["ragged"] = _compiled_ragged(dev)
    summary["pipeline"] = _compiled_pipeline(dev)
    summary["hybrid"] = _compiled_hybrid(dev, work)
    summary["fallback"] = _compiled_fallback(dev)
    summary["wall_s"] = time.monotonic() - t0
    log(json.dumps({"compiled": summary}))
    # the plain-Adam LM and plain-Momentum ResNet-50 steps that phase 14
    # prints its recipes' steps beside
    plain = {label: {"step_ms_p50": summary[label]["compiled"]["step_ms_p50"],
                     "graph_kernel_nodes_total":
                         summary[label]["graph_kernel_nodes_total"],
                     "graph_kernel_nodes":
                         summary[label]["graph_kernel_nodes"],
                     "program_ops": summary[label].get("program_ops")}
             for label in ("lm", "resnet50")}
    return paths, plain


# -- phase 13 -----------------------------------------------------------------

# Phase 13 (checkpoint): run A trains CKPT_BATCHES distinct batches of the
# GPT-2-small LM; run B preempts at batch CKPT_PREEMPT_AT; run C resumes
# from B's checkpoint and trains the rest
CKPT_BATCHES = 8
CKPT_PREEMPT_AT = 3
# Trainer.test's cost against the cost the next training step fetches on
# the same batch: the same forward ops, kernels and parameters
TEST_COST_REL_TOL = 1e-6
# ResNet-50's test-mode logits: image 0 alone against row 0 of the batch,
# and the conv3x3 kernel against every conv on cuDNN; the relative norm
# of the difference, at phase 6's tolerance on forward quantities
R50_TEST_REL_TOL = R50_STAT_REL_TOL


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if os.path.isfile(os.path.join(d, f)))


def _rate(nbytes, seconds):
    return {"bytes": nbytes, "ms": seconds * 1e3,
            "mb_per_s": nbytes / 1e6 / seconds if seconds > 0 else None}


def _ckpt_lm(dev, checkpoint_dir=None):
    """``configs/tiny_lm.model`` at GPT-2-small widths, CKPT_BATCHES
    distinct batches of TRAIN_BATCH sequences, Adam, a compiled
    Trainer: (spec, trainer, main program)."""
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
        spec = tiny_lm.model(batch=TRAIN_BATCH,
                             samples=CKPT_BATCHES * TRAIN_BATCH,
                             learning_rate=TRAIN_LR, seed=0, **widths)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev,
                          checkpoint_dir=checkpoint_dir)
    return spec, trainer, main_prog


def _train_losses(trainer, reader, preempt_at=None):
    """Train one pass, the handler reading each cost (and preempting at
    ``preempt_at``): the losses."""
    from paddle_tpu_torch.trainer import EndIteration
    losses = []

    def handler(e):
        if isinstance(e, EndIteration):
            losses.append(e.cost)
            if e.batch_id == preempt_at:
                trainer.request_preempt()

    trainer.train(reader, num_passes=1, event_handler=handler,
                  pipeline=False)
    return losses


def _free(trainer):
    trainer.exe.close()
    gc.collect()
    torch.cuda.empty_cache()


def _ckpt_resume(dev, work):
    """Runs A (uninterrupted), B (preempted at CKPT_PREEMPT_AT) and C
    (resumed on B's directory); C's losses and final persistables must be
    A's bit for bit. Returns (record, the launches of the three runs,
    run C's trainer and spec, live in the current global scope)."""
    from itertools import islice
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.resilience import events
    kernels.reset_launches()
    with scope_guard(Scope()):
        spec, tr_a, prog = _ckpt_lm(dev)
        tr_a._maybe_init()
        init = _persistables(prog, global_scope())
        losses_a = _train_losses(tr_a, spec["reader"])
        final_a = _persistables(prog, global_scope())
        _free(tr_a)
    ck = _fresh_dir(os.path.join(work, "lm_preempt"))
    events.clear_events()
    with scope_guard(Scope()):
        spec, tr_b, prog = _ckpt_lm(dev, checkpoint_dir=ck)
        tr_b._maybe_init(load=False)
        for n, t in init.items():
            global_scope().set_var(n, t.clone())
        del init
        losses_b = _train_losses(tr_b, spec["reader"],
                                 preempt_at=CKPT_PREEMPT_AT)
        save_s = tr_b._last_ckpt_secs
        _free(tr_b)
    evs = events.events(kind="preempt_checkpoint")
    if not tr_b.preempted or len(losses_b) != CKPT_PREEMPT_AT + 1 or \
            [(e["pass_id"], e["batch_id"]) for e in evs] != \
            [(0, CKPT_PREEMPT_AT)]:
        fail("checkpoint: run B preempted=%s after %d batches, "
             "preempt_checkpoint events %s" % (tr_b.preempted,
                                                len(losses_b), evs))
    nbytes, n_files = _dir_bytes(ck), len(os.listdir(ck))
    scope_c = Scope()
    with scope_guard(scope_c):
        spec, tr_c, prog = _ckpt_lm(dev, checkpoint_dir=ck)
        tr_c._maybe_init(load=False)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tr_c._load_checkpoint_state()
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        rest = lambda: islice(spec["reader"](), CKPT_PREEMPT_AT + 1, None)
        losses_c = _train_losses(tr_c, rest)
        final_c = _persistables(prog, global_scope())
    launches = kernels.launch_counts()
    want = losses_a[CKPT_PREEMPT_AT + 1:]
    if losses_b != losses_a[:CKPT_PREEMPT_AT + 1] or losses_c != want:
        fail("checkpoint: the resumed losses %s are not run A's %s"
             % (losses_b + losses_c, losses_a))
    differ = [n for n, t in final_a.items()
              if not torch.equal(t, final_c[n])]
    if sorted(final_a) != sorted(final_c) or differ:
        fail("checkpoint: %d persistables of the resumed run differ from "
             "run A's (%s)" % (len(differ), differ[:5]))
    del final_a, final_c
    torch.cuda.empty_cache()
    shutil.rmtree(ck)
    rec = {"losses_a": losses_a, "losses_b": losses_b, "losses_c": losses_c,
           "persistables": sum(1 for v in prog.list_vars() if v.persistable),
           "preempt_event": {k: evs[0][k] for k in ("pass_id", "batch_id")},
           "preempt_save": _rate(nbytes, save_s),
           "resume_load": _rate(nbytes, load_s), "files": n_files}
    return rec, launches, (tr_c, spec, scope_c)


def _ckpt_async_and_retention(trainer, spec, work):
    """An async save at step k, then step k + 1 at once: the files must
    be the host copy of step k's state, bit for bit. Then three saves
    with keep_last=2: two directories left, load_latest the newest."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.core.scope import Scope, global_scope, \
        scope_to_numpy
    prog = trainer.main_program
    names = sorted(v.name for v in prog.list_vars() if v.persistable)
    want = scope_to_numpy(global_scope(), names)
    d = os.path.join(work, "lm_async")
    shutil.rmtree(d, ignore_errors=True)
    batch = next(iter(spec["reader"]()))
    t0 = time.monotonic()
    handle = trainer.save_checkpoint(d, async_=True, step=CKPT_BATCHES)
    snapshot_s = trainer._last_ckpt_secs
    trainer.exe.run(prog, feed=trainer.feeder.feed(batch),
                    fetch_list=trainer.fetch_list)  # step k + 1, replayed
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0 - snapshot_s
    handle.result(timeout=600)
    write_s = time.monotonic() - t0 - snapshot_s
    nbytes = _dir_bytes(d)
    t0 = time.monotonic()
    host = Scope()
    step = checkpoint.load_checkpoint(d, prog, scope=host, device="cpu")
    load_s = time.monotonic() - t0
    got = scope_to_numpy(host, names)
    del host
    differ = [n for n in names if not np.array_equal(got[n], want[n])]
    moved = scope_to_numpy(global_scope(), names[:4])
    if step != CKPT_BATCHES or sorted(got) != sorted(want) or differ:
        fail("checkpoint: the async save at step %d holds %d values that "
             "differ from the host copy of that step (%s)"
             % (CKPT_BATCHES, len(differ), differ[:5]))
    if all(np.array_equal(moved[n], want[n]) for n in moved):
        fail("checkpoint: step k + 1 moved no state (the race was not run)")
    del got, want
    t0 = time.monotonic()
    card = Scope()
    checkpoint.load_checkpoint(d, prog, scope=card, device=trainer.exe.device)
    torch.cuda.synchronize()
    card_load_s = time.monotonic() - t0
    del card
    shutil.rmtree(d)
    root = os.path.join(work, "lm_keep2")
    shutil.rmtree(root, ignore_errors=True)
    save_ms = []
    for _ in range(3):
        t0 = time.monotonic()
        last = checkpoint.save_checkpoint(root, prog, keep_last=2)
        save_ms.append((time.monotonic() - t0) * 1e3)
    left = sorted(os.listdir(root))
    newest = checkpoint.load_latest(root, prog, scope=Scope(),
                                    device=trainer.exe.device)
    if left != ["ckpt-00000001", "ckpt-00000002"] or newest != (last, 2):
        fail("checkpoint: keep_last=2 left %s, load_latest gave %s"
             % (left, newest))
    shutil.rmtree(root)
    return {"async": {"snapshot_ms": snapshot_s * 1e3,
                      "next_step_ms": step_s * 1e3,
                      "write": _rate(nbytes, write_s),
                      "load_to_host": _rate(nbytes, load_s),
                      "load_to_card": _rate(nbytes, card_load_s)},
            "retention": {"left": left, "load_latest_step": newest[1],
                          "save_ms": save_ms}}


def _ckpt_test_and_export(trainer, spec, work):
    """Trainer.test on a held-out batch (one capture, 12 flash forwards a
    run, no backward; the cost within TEST_COST_REL_TOL of the next
    training step's), then the logits' inference model loaded in a new
    Executor and scope, run twice: bit-equal to the test program's
    logits, 12 flash forwards a run, no Adam moment in the directory.
    Returns (record, {path: launches})."""
    from paddle_tpu_torch import io, kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    prog, cost = trainer.main_program, spec["cost"]
    layers_n = GPT2_SMALL["num_layers"]
    rng = np.random.RandomState(99)
    vocab, seq = GPT2_SMALL["vocab_size"], GPT2_SMALL["max_seq"]
    held = []
    for _ in range(TRAIN_BATCH):
        xs = rng.randint(0, vocab, (seq,)).astype(np.int64)
        held.append((xs, (xs + 1) % vocab))
    paths = {}
    before = dict(trainer.exe.stats)
    kernels.reset_launches()
    results, per_run, test_ms = [], [], []
    for _ in range(3):  # warm-up, capture, replay
        c0 = kernels.launch_counts()
        t0 = time.monotonic()
        results.append(trainer.test(lambda: iter([held]), pipeline=False))
        torch.cuda.synchronize()
        test_ms.append((time.monotonic() - t0) * 1e3)
        per_run.append({k: v - c0[k] for k, v in
                        kernels.launch_counts().items() if v - c0[k]})
    paths["ckpt_lm_test"] = kernels.launch_counts()
    delta = _exe_delta(trainer.exe, before)
    if delta["graph_captures"] != 1 or delta["eager_runs"] != 0 or \
            any(r != {"flash_attention_fwd": layers_n} for r in per_run):
        fail("checkpoint: Trainer.test ran %s with launches %s a run, "
             "expected one capture and %d flash forwards a run"
             % (delta, per_run, layers_n))
    if len({r[0] for r in results}) != 1:
        fail("checkpoint: Trainer.test gave %s over three runs" % results)
    test_cost = results[0][0]
    t_step = trainer.exe.run(prog, feed=trainer.feeder.feed(held),
                             fetch_list=[cost])[0]
    step_cost = float(np.asarray(t_step).reshape(-1)[0])
    cost_rel = abs(test_cost - step_cost) / abs(step_cost)
    if not cost_rel <= TEST_COST_REL_TOL:
        fail("checkpoint: Trainer.test's cost %r vs the training step's %r:"
             " %g relative > %g" % (test_cost, step_cost, cost_rel,
                                   TEST_COST_REL_TOL))
    # the logits: the reshape feeding softmax_with_cross_entropy reads them
    block = cost.block
    ce = block.var(cost.op.input("X")[0]).op
    logits = block.var(ce.input("Logits")[0]).op.input("X")[0]
    d = _fresh_dir(os.path.join(work, "lm_inference"))
    t0 = time.monotonic()
    trainer.save_inference_model(d, ["toks"], [logits])
    export_s = time.monotonic() - t0
    feed = {"toks": np.stack([s[0] for s in held])}
    test_prog = trainer._test_program([logits])
    want = [trainer.exe.run(test_prog, feed=feed, fetch_list=[logits],
                            return_numpy=False)[0] for _ in range(2)]
    files = sorted(os.listdir(d))
    if any("moment" in f for f in files):
        fail("checkpoint: the inference model holds Adam moments: %s"
             % [f for f in files if "moment" in f][:4])
    with scope_guard(Scope()):
        exe = Executor(trainer.exe.device)
        t0 = time.monotonic()
        program, feeds, fetches = io.load_inference_model(d, exe)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        kernels.reset_launches()
        got, per_run = [], []
        for _ in range(2):
            c0 = kernels.launch_counts()
            got.append(exe.run(program, feed=feed, fetch_list=fetches,
                               return_numpy=False)[0])
            torch.cuda.synchronize()
            per_run.append({k: v - c0[k] for k, v in
                            kernels.launch_counts().items() if v - c0[k]})
        paths["ckpt_lm_inference"] = kernels.launch_counts()
        st = dict(exe.stats)
        exe.close()
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    if not all(equal) or st["graph_captures"] != 1 or \
            any(r != {"flash_attention_fwd": layers_n} for r in per_run):
        fail("checkpoint: the loaded LM's logits bit-equal %s, runs %s, "
             "launches %s a run" % (equal, {k: st[k] for k in _EXE_KEYS},
                                    per_run))
    del got, want
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    return {"test_cost": test_cost, "next_step_cost": step_cost,
            "test_cost_rel_diff": cost_rel,
            "test_ms_warmup_capture_replay": test_ms,
            "test_executor": delta,
            "inference": {"files": len(files), "export_ms": export_s * 1e3,
                          "load_ms": load_s * 1e3, "feeds": feeds,
                          "fetches": fetches, "logits_bit_equal": equal,
                          "launches_a_run": per_run}}, paths


def _rel_norm(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def _ckpt_resnet(dev, work):
    """Phase 6's ResNet-50 trained 2 steps, its inference model saved and
    loaded: 16 conv3x3 forwards a run and no dx; image 0 alone gives row
    0 of the batch output; and the loaded program against itself with
    every conv on cuDNN (TF32 off). Returns (record, launches)."""
    from paddle_tpu_torch import io, kernels
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.trainer import Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = resnet_cifar.model(variant="imagenet", depth=50, image=224,
                                  class_dim=1000, batch=R50_BATCH,
                                  learning_rate=R50_LR)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    rng = np.random.RandomState(0)
    imgs = rng.rand(R50_BATCH, 3, 224, 224).astype(np.float32)
    labels = rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)
    batch = list(zip(imgs, labels))
    cost = spec["cost"]
    pred = cost.block.var(cost.op.input("X")[0]).op.input("X")[0]
    # the softmax's input: the gates compare these, as the probabilities
    # of a net this young sit near 0 or 1
    logits = cost.block.var(pred).op.input("X")[0]
    d = _fresh_dir(os.path.join(work, "resnet50_inference"))
    with scope_guard(Scope()):
        trainer.train(lambda: iter([batch, batch]), pipeline=False)
        trainer.save_inference_model(d, ["img"], [pred])
        _free(trainer)
    with scope_guard(Scope()):
        exe = Executor(dev)
        program, feeds, fetches = io.load_inference_model(d, exe)
        feed = {"img": imgs}
        both = fetches + [logits]
        kernels.reset_launches()
        per_run, outs = [], []
        for _ in range(2):
            c0 = kernels.launch_counts()
            outs.append(exe.run(program, feed=feed, fetch_list=both,
                                return_numpy=False))
            torch.cuda.synchronize()
            per_run.append({k: v - c0[k] for k, v in
                            kernels.launch_counts().items() if v - c0[k]})
        launches = kernels.launch_counts()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        if any(r != {"conv3x3_fwd": 16} for r in per_run) or not same:
            fail("checkpoint: the loaded ResNet-50 launched %s a run "
                 "(expected 16 conv3x3 forwards), runs bit-equal %s"
                 % (per_run, same))
        bns = [op for op in program.global_block().ops
               if op.type == "batch_norm"]
        if not bns or not all(op.attrs.get("is_test") for op in bns):
            fail("checkpoint: the inference program's batch norms are not "
                 "in test mode")
        one = exe.run(program, feed={"img": imgs[:1]}, fetch_list=both,
                      return_numpy=False)
        alone = _rel_norm(one[1][0], outs[1][1][0])
        alone_probs = _rel_norm(one[0][0], outs[1][0][0])
        cudnn = program.clone()
        for op in cudnn.global_block().ops:
            if op.type == "conv2d":
                op.attrs["conv_impl"] = "conv"
        kernels.reset_launches()
        ref = exe.run(cudnn, feed=feed, fetch_list=both,
                      return_numpy=False)
        ref_conv3x3 = kernels.launch_counts()["conv3x3_fwd"]
        vs_cudnn = _rel_norm(outs[1][1], ref[1])
        vs_cudnn_probs = _rel_norm(outs[1][0], ref[0])
        logit_spread = float(outs[1][1].std())
        exe.close()
    if not (alone <= R50_TEST_REL_TOL and vs_cudnn <= R50_TEST_REL_TOL) \
            or ref_conv3x3 != 0:
        fail("checkpoint: ResNet-50 in test mode: image 0 alone vs row 0 "
             "%g, kernel vs cuDNN %g (tolerance %g), conv3x3 launches in "
             "the cuDNN run %d" % (alone, vs_cudnn, R50_TEST_REL_TOL,
                                   ref_conv3x3))
    files = len(os.listdir(d))
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    return {"batch_norms_in_test_mode": len(bns), "files": files,
            "launches_a_run": per_run,
            "logits_std": logit_spread,
            "image0_alone_vs_row0_logits_rel_norm": alone,
            "image0_alone_vs_row0_probs_rel_norm": alone_probs,
            "kernel_vs_cudnn_logits_rel_norm": vs_cudnn,
            "kernel_vs_cudnn_probs_rel_norm": vs_cudnn_probs,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}, launches


def _start_cli(root, args, err_path):
    err = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "train"] + args,
        cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
        env=dict(os.environ, PYTHONPATH=root))
    err.close()
    return proc


def _ckpt_cli_start(root, work):
    """Start the two CLI runs: text_rnn with --checkpoint_dir, sent
    SIGTERM after its first logged batch (by a thread), and the book
    config recognize_digits_conv."""
    ck = _fresh_dir(os.path.join(work, "text_rnn_cli"))
    rnn = _start_cli(root, [os.path.join(root, "paddle_tpu_torch", "configs",
                                         "text_rnn.py"),
                            "--checkpoint_dir", ck, "--num_passes", "100000",
                            "--log_period", "1"],
                     os.path.join(work, "text_rnn_cli.err"))
    book = _start_cli(root, [os.path.join(root, "paddle_tpu_torch", "configs",
                                          "recognize_digits_conv.py"),
                             "--log_period", "1"],
                      os.path.join(work, "recognize_digits_cli.err"))
    state = {"t0": time.monotonic(), "lines": []}

    def watch():
        for line in rnn.stdout:
            state["lines"].append(line.rstrip("\n"))
            if "first" not in state and line.startswith("pass 0 batch 0"):
                state["first"] = time.monotonic() - state["t0"]
                rnn.send_signal(signal.SIGTERM)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return {"ck": ck, "rnn": rnn, "book": book, "state": state,
            "watcher": watcher}


def _ckpt_cli_finish(dev, work, cli):
    """Wait for both CLI runs, then resume text_rnn in this process from
    the checkpoint the SIGTERM wrote (2 batches on the fused LSTM
    kernel). Returns (record, launches of the resume)."""
    from itertools import islice
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import text_rnn
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.trainer import Trainer
    rnn, book, state = cli["rnn"], cli["book"], cli["state"]
    for proc in (rnn, book):
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    cli["watcher"].join(timeout=60)
    book_out = book.stdout.read()
    rnn_s = time.monotonic() - state["t0"]
    if rnn.returncode != 0 or "first" not in state or \
            not any(ln.startswith("preempted at pass") for ln in
                    state["lines"]):
        fail("checkpoint: train text_rnn --checkpoint_dir exited %s after "
             "SIGTERM (first batch after %s s): %s %s"
             % (rnn.returncode, state.get("first"), state["lines"][-3:],
                open(os.path.join(work, "text_rnn_cli.err")).read()[-4000:]))
    if book.returncode != 0 or "pass 0 done" not in book_out:
        fail("checkpoint: train recognize_digits_conv exited %s: %s %s"
             % (book.returncode, book_out[-2000:],
                open(os.path.join(work,
                                  "recognize_digits_cli.err")).read()[-4000:]))
    ck = cli["ck"]
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = text_rnn.model()
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev, checkpoint_dir=ck)
    params = [p.name for p in main_prog.all_parameters()]
    with scope_guard(Scope()):
        trainer._maybe_init(load=False)
        fresh = _persistables(main_prog, global_scope())
        trainer._load_checkpoint_state()
        loaded = _persistables(main_prog, global_scope())
        moved = [n for n in params if not torch.equal(fresh[n], loaded[n])]
        beta1 = float(loaded["beta1_pow_acc_0"].reshape(-1)[0])
        # each step launches each layer's kernel twice: the forward and
        # the generic grad's replay
        kernels.reset_launches()
        losses = _train_losses(trainer,
                               lambda: islice(spec["reader"](), 0, 2))
        launches = kernels.launch_counts()
        _free(trainer)
    if len(moved) != len(params) or not beta1 < 0.9 or \
            launches["fused_lstm"] != 2 * 2 * 2 or \
            not np.all(np.isfinite(losses)):
        fail("checkpoint: the CLI's text_rnn checkpoint: %d of %d "
             "parameters trained, beta1_pow %r, resumed losses %s, "
             "fused_lstm launches %d (expected 8)"
             % (len(moved), len(params), beta1, losses,
                launches["fused_lstm"]))
    shutil.rmtree(ck)
    return {"text_rnn": {"exit_code": rnn.returncode,
                         "first_batch_s": state["first"],
                         "process_s": rnn_s,
                         "preempted_line": [ln for ln in state["lines"]
                                            if ln.startswith("preempted")],
                         "checkpoint_persistables": len(loaded),
                         "resumed_losses": losses},
            "recognize_digits_conv": {
                "exit_code": book.returncode,
                "last_line": book_out.strip().splitlines()[-1]}}, launches


def phase_checkpoint(dev, root):
    """Phase 13: resume, preemption, async and retained checkpoints,
    Trainer.test and inference models on the card, and the CLI's
    --checkpoint_dir. Returns {path: launches}."""
    t0 = time.monotonic()
    work = _fresh_dir(os.path.join(root, "build", "chip_smoke", "checkpoint"))
    rec, paths = {}, {}
    rec["resume"], paths["ckpt_lm_train"], (trainer, spec, scope) = \
        _ckpt_resume(dev, work)
    from paddle_tpu_torch.core.scope import scope_guard
    with scope_guard(scope):
        rec.update(_ckpt_async_and_retention(trainer, spec, work))
        rec["test"], more = _ckpt_test_and_export(trainer, spec, work)
        paths.update(more)
        trainer.checkpoint_dir = None
        _free(trainer)
    del trainer, scope
    gc.collect()
    torch.cuda.empty_cache()
    cli = _ckpt_cli_start(root, work)
    rec["resnet50"], paths["ckpt_resnet_inference"] = _ckpt_resnet(dev, work)
    rec["cli"], paths["ckpt_rnn_resume"] = _ckpt_cli_finish(dev, work, cli)
    shutil.rmtree(work, ignore_errors=True)
    rec["wall_s"] = time.monotonic() - t0
    log(json.dumps({"checkpoint": rec}))
    return paths


# -- phase 14 -----------------------------------------------------------------

# Phase 14 (optimization): the training recipes that clipping, weight
# decay and schedules make possible, compiled against eager on the card.
# The LM at GPT-2 small's widths: Adam on a polynomial schedule,
# global-norm clipping on every parameter, L2 decay on the optimizer
OPT_STEPS = 6
OPT_LM_CLIP = 1.0
OPT_LM_DECAY = 0.01
# the recipe's clip does not bind at this LM's first steps (global norms
# 0.29-0.96 on the card): the same program with a clip of 0.1, which
# binds, is held to its float64 recomputation over OPT_LM_BIND_STEPS
OPT_LM_BIND_CLIP = 0.1
OPT_LM_BIND_STEPS = 2
OPT_LM_SCHEDULE = ("polynomial_decay",
                   dict(learning_rate=6e-4, decay_steps=8,
                        end_learning_rate=6e-5))
# ResNet-50: Momentum 0.9, L2 1e-4, a step schedule over OPT_STEPS steps
OPT_R50_DECAY = 1e-4
OPT_R50_SCHEDULE = ("piecewise_decay",
                    dict(boundaries=[2, 4],
                         values=[0.0125, 0.00125, 0.000125]))
# a parameter's update against its float64 recomputation from the
# step's fetched gradients, over max(1, |p|): a few float32 ulps of a
# weight on the LM and ResNet-50; the classifier runs' Ftrl writes p
# afresh rather than as a step
OPT_UPDATE_TOL = 1e-6
OPT_RNN_UPDATE_TOL = 1e-5
# a fetched LR against its closed form in float64, relative
OPT_LR_TOL = 1e-6
# the LM steps whose update is recomputed on the host: all of them, so
# that the steps where the global-norm clip binds are among them
OPT_CHECK_STEPS = tuple(range(1, OPT_STEPS + 1))
# the LSTM classifier's runs: warm-up, capture, 2 replays; the update
# is recomputed at the capture's replay (step 2)
OPT_RNN_STEPS = 4
OPT_RNN_CHECK_STEP = 2
# (label, optimizer, its kwargs, schedule or None, clip or None)
OPT_RNN_RECIPES = [
    ("adagrad_exponential", "Adagrad", {},
     ("exponential_decay", dict(learning_rate=0.01, decay_steps=2,
                                decay_rate=0.5)), None),
    ("rmsprop_momentum_natural_exp", "RMSProp", dict(momentum=0.9),
     ("natural_exp_decay", dict(learning_rate=0.001, decay_steps=2,
                                decay_rate=0.5)), None),
    ("adamax_polynomial_power2", "Adamax", {},
     ("polynomial_decay", dict(learning_rate=0.002, decay_steps=4,
                               end_learning_rate=0.0002, power=2.0)),
     None),
    ("decayed_adagrad_piecewise", "DecayedAdagrad", {},
     ("piecewise_decay", dict(boundaries=[1, 3],
                              values=[0.001, 0.0005, 0.0001])), None),
    ("ftrl_l1_exponential_staircase", "Ftrl", dict(l1=1e-4),
     ("exponential_decay", dict(learning_rate=0.01, decay_steps=2,
                                decay_rate=0.5, staircase=True)), None),
    ("adadelta_clip_by_value", "Adadelta", {}, None, ("value", 1.0)),
    ("sgd_inverse_time_clip_by_norm", "SGD", {},
     ("inverse_time_decay", dict(learning_rate=0.1, decay_steps=2,
                                 decay_rate=0.5)), ("norm", 5.0)),
]
OPT_RNN_LR = 1.0  # the learning rate of a recipe with no schedule
# ModelAverage on the LM: steps before apply / test / restore, and after
OPT_AVG_STEPS = (2, 2)


def lr_closed_form(kind, kw, s):
    """A schedule of ``learning_rate_decay.py`` at step ``s`` (the
    counter's first value is 0), in float64."""
    if kind == "piecewise_decay":
        return float(kw["values"][sum(1 for b in kw["boundaries"]
                                      if b <= s)])
    lr = kw["learning_rate"]
    ds = float(kw["decay_steps"])
    if kind == "polynomial_decay":
        end, power = kw.get("end_learning_rate", 1e-4), kw.get("power", 1.0)
        if kw.get("cycle"):
            ds, step = ds * max(math.ceil(s / ds), 1.0), s
        else:
            step = min(s, ds)
        frac = 1.0 - step / ds
        if power != 1.0:
            frac = min(max(frac, 1e-12), 1.0)  # the schedule's clip
        return (lr - end) * frac ** power + end
    div = s / ds
    if kw.get("staircase"):
        div = math.floor(div)
    if kind == "exponential_decay":
        return lr * kw["decay_rate"] ** div
    if kind == "natural_exp_decay":
        return lr * math.exp(-kw["decay_rate"] * div)
    if kind == "inverse_time_decay":
        return lr / (1.0 + kw["decay_rate"] * div)
    raise ValueError(kind)


def recipe_grads(grads, params, clip=None, decay=None):
    """The gradients the update ops read, recomputed in float64 from the
    raw ones (``{param: grad}``): clipped as ``clip`` says (``("value",
    v)``, ``("norm", v)`` each alone, ``("global_norm", v)`` over all of
    them), then ``decay`` x p added (L2). Returns (grads, the global
    norm, the scale; both None without a global-norm clip)."""
    g = {n: t.double() for n, t in grads.items()}
    norm = scale = None
    if clip and clip[0] == "global_norm":
        norm = math.sqrt(sum(float(torch.sum(t * t)) for t in g.values()))
        scale = clip[1] / max(clip[1], norm)
    out = {}
    for n, t in g.items():
        if clip is None:
            c = t
        elif clip[0] == "value":
            c = torch.clamp(t, -clip[1], clip[1])
        elif clip[0] == "norm":
            nrm = float(torch.sqrt(torch.sum(t * t)))
            c = t * (clip[1] / nrm) if nrm > clip[1] else t
        else:
            c = t * scale
        if decay:
            c = c + decay * params[n].double()
        out[n] = c
    return out, norm, scale


def update_float64(op, p, g, state, lr):
    """The new value of parameter ``p`` under update op ``op`` (its type
    and attrs), in float64 from float64 ``g``, the op's accumulator
    inputs ``state`` ({slot: tensor}, before the step) and ``lr``."""
    t, a = op.type, op.attrs
    p = p.double()
    s = {k: v.double() for k, v in state.items()}
    if t == "sgd":
        return p - lr * g
    if t == "momentum":
        v = a["mu"] * s["Velocity"] + g
        if a.get("use_nesterov", False):
            return p - (g + a["mu"] * v) * lr
        return p - lr * v
    if t == "adam":
        b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
        b1p, b2p = float(s["Beta1Pow"].reshape(-1)[0]), \
            float(s["Beta2Pow"].reshape(-1)[0])
        lr_t = lr * math.sqrt(1.0 - b2p) / (1.0 - b1p)
        m1 = b1 * s["Moment1"] + (1.0 - b1) * g
        m2 = b2 * s["Moment2"] + (1.0 - b2) * g * g
        return p - lr_t * m1 / (torch.sqrt(m2) + a.get("epsilon", 1e-8))
    if t == "adamax":
        b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
        b1p = float(s["Beta1Pow"].reshape(-1)[0])
        m = b1 * s["Moment"] + (1.0 - b1) * g
        inf = torch.maximum(b2 * s["InfNorm"], torch.abs(g))
        return p - lr / (1.0 - b1p) * m / (inf + a.get("epsilon", 1e-8))
    if t == "adagrad":
        m = s["Moment"] + g * g
        return p - lr * g / (torch.sqrt(m) + a.get("epsilon", 1e-6))
    if t == "decayed_adagrad":
        d = a.get("decay", 0.95)
        m = d * s["Moment"] + (1.0 - d) * g * g
        return p - lr * g / (torch.sqrt(m) + a.get("epsilon", 1e-6))
    if t == "adadelta":
        rho, eps = a.get("rho", 0.95), a.get("epsilon", 1e-6)
        ag = rho * s["AvgSquaredGrad"] + (1.0 - rho) * g * g
        return p - torch.sqrt((s["AvgSquaredUpdate"] + eps) / (ag + eps)) * g
    if t == "rmsprop":
        rho, eps = a.get("decay", 0.9), a.get("epsilon", 1e-10)
        ms = rho * s["MeanSquare"] + (1.0 - rho) * g * g
        mom = a.get("momentum", 0.0) * s["Moment"] + lr * g / torch.sqrt(
            ms + eps)
        return p - mom
    if t == "ftrl":
        l1, l2 = a.get("l1", 0.0), a.get("l2", 0.0)
        power = -a.get("lr_power", -0.5)
        sq, lin = s["SquaredAccumulator"], s["LinearAccumulator"]
        new_sq = sq + g * g
        sigma = (new_sq ** power - sq ** power) / lr
        new_lin = lin + g - sigma * p
        denom = new_sq ** power / lr + 2.0 * l2
        return (torch.clamp(new_lin, -l1, l1) - new_lin) / denom
    raise ValueError("no float64 update for op %r" % t)


_UPDATE_STATE_SLOTS = ("Velocity", "Moment1", "Moment2", "Beta1Pow",
                       "Beta2Pow", "Moment", "InfNorm", "AvgSquaredGrad",
                       "AvgSquaredUpdate", "MeanSquare",
                       "SquaredAccumulator", "LinearAccumulator")


def update_state_names(program):
    """{param: (update op, {slot: var name})} of every update op."""
    out = {}
    for op in program.global_block().ops:
        if op.output("ParamOut"):
            out[op.output("ParamOut")[0]] = (op, {
                s: op.input(s)[0] for s in _UPDATE_STATE_SLOTS
                if op.input(s)})
    return out


def update_errors(program, before, grads, after, lr, clip=None,
                  decay=None):
    """Each parameter's update against its float64 recomputation:
    ``before`` / ``after`` hold every parameter and accumulator before
    and after the step, ``grads`` the raw gradients ({param: tensor}),
    ``lr`` the step's fetched learning rate. Returns ({param: largest
    difference over max(1, |p|)}, the global norm, the clip scale)."""
    ops = update_state_names(program)
    params = {n: before[n] for n in grads}
    g64, norm, scale = recipe_grads(grads, params, clip, decay)
    errs = {}
    for n, g in g64.items():
        op, slots = ops[n]
        want = update_float64(op, before[n], g,
                              {s: before[v] for s, v in slots.items()}, lr)
        got = after[n].double()
        # an element NaN on both sides agrees (the JAX ftrl formula
        # divides 0 by 0 where a row's squared accumulator stays 0); NaN
        # on one side only fails
        d = (got - want).abs().masked_fill(
            torch.isnan(got) & torch.isnan(want), 0.0)
        errs[n] = float(d.max()) / max(
            1.0, float(torch.nan_to_num(before[n].double()).abs().max()))
    return errs, norm, scale


def _opt_state_names(program):
    ops = update_state_names(program)
    names = set(ops)
    for _, slots in ops.values():
        names.update(slots.values())
    return sorted(names)


def _clone_state(scope, names):
    return {n: scope.find_var(n).detach().clone() for n in names}


def _opt_build(dev, kind, recipe=None, lm_clip=OPT_LM_CLIP):
    """A Trainer of ``kind`` ('lm', 'resnet50' or 'rnn') under its phase
    14 recipe (the LM's global-norm clip at ``lm_clip``): (spec, trainer,
    main program, LR var, recipe record)."""
    from paddle_tpu_torch import clip as clip_mod
    from paddle_tpu_torch import learning_rate_decay as lrd
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch import regularizer
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        if kind == "lm":
            from paddle_tpu_torch.configs import tiny_lm
            widths = dict(vocab=GPT2_SMALL["vocab_size"],
                          seq=GPT2_SMALL["max_seq"],
                          hidden=GPT2_SMALL["hidden"],
                          num_layers=GPT2_SMALL["num_layers"],
                          num_heads=GPT2_SMALL["num_heads"],
                          ffn_mult=GPT2_SMALL["ffn_mult"])
            spec = tiny_lm.model(batch=TRAIN_BATCH, samples=8 * TRAIN_BATCH,
                                 learning_rate=TRAIN_LR, seed=0, **widths)
            clip_mod.set_gradient_clip(
                clip_mod.GradientClipByGlobalNorm(lm_clip))
            schedule = OPT_LM_SCHEDULE
            lr = getattr(lrd, schedule[0])(**schedule[1])
            opt = opt_mod.Adam(learning_rate=lr,
                               regularization=regularizer.L2Decay(
                                   OPT_LM_DECAY))
            rec = {"optimizer": "Adam", "schedule": schedule,
                   "clip": ("global_norm", lm_clip),
                   "decay": OPT_LM_DECAY}
        elif kind == "resnet50":
            from paddle_tpu_torch.configs import resnet_cifar
            spec = resnet_cifar.model(variant="imagenet", depth=50,
                                      image=224, class_dim=1000,
                                      batch=R50_BATCH, learning_rate=R50_LR)
            schedule = OPT_R50_SCHEDULE
            lr = getattr(lrd, schedule[0])(**schedule[1])
            opt = opt_mod.Momentum(learning_rate=lr, momentum=0.9,
                                   regularization=regularizer.L2Decay(
                                       OPT_R50_DECAY))
            rec = {"optimizer": "Momentum(0.9)", "schedule": schedule,
                   "clip": None, "decay": OPT_R50_DECAY}
        else:
            from paddle_tpu_torch.configs import text_rnn
            _, opt_name, kw, schedule, clip = recipe
            spec = text_rnn.model(cell="lstm", samples=RNN_BENCH["batch"],
                                  **RNN_BENCH)
            if clip is not None:
                clip_mod.set_gradient_clip(
                    clip_mod.GradientClipByValue(clip[1])
                    if clip[0] == "value"
                    else clip_mod.GradientClipByNorm(clip[1]))
            lr = (getattr(lrd, schedule[0])(**schedule[1]) if schedule
                  else OPT_RNN_LR)
            opt = getattr(opt_mod, opt_name)(learning_rate=lr, **kw)
            rec = {"optimizer": opt_name, "kwargs": kw, "schedule": schedule,
                   "clip": clip, "decay": None}
        trainer = Trainer(spec["cost"], opt, spec["feed_list"], device=dev)
        lr_var = opt._global_learning_rate(main_prog)
    if not any(op.input("LearningRate") == [lr_var.name]
               for op, _ in update_state_names(main_prog).values()):
        lr_var = None  # adadelta reads no learning rate
    return spec, trainer, main_prog, lr_var, rec


def _opt_run(dev, program, head, feed, state, use_jit, steps, grads=(),
             check_steps=(), names=(), check=None, keep_graph=False):
    """``steps`` runs of ``program`` on ``feed`` from ``state`` in a fresh
    Executor and scope, fetching ``head`` (the cost, and the LR var
    where an update op reads one) and ``grads``. At each of
    ``check_steps``, ``check(step, before, grads, after, lr)`` gets the
    state ``names`` before and after the step, its fetched gradients and
    its LR. Returns the record, the ``head`` fetches of each step, the
    final persistables and {step: what ``check`` returned}."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    exe, scope = Executor(dev), Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    kernels.reset_launches()
    before = dict(exe.stats)
    outs, ms, checks = [], [], {}
    plain_graph = torch.cuda.CUDAGraph
    if keep_graph:
        torch.cuda.CUDAGraph = _kept_graph_class()
    try:
        for step in range(1, steps + 1):
            pre = _clone_state(scope, names) if step in check_steps else None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = exe.run(program, feed=feed,
                          fetch_list=list(head) + list(grads), scope=scope,
                          use_jit=use_jit, return_numpy=False)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            outs.append(out[:len(head)])
            if pre is not None:
                lr = (float(out[1].reshape(-1)[0]) if len(head) > 1
                      else OPT_RNN_LR)
                checks[step] = check(step, pre, out[len(head):],
                                     _clone_state(scope, names), lr)
                del pre
            del out
    finally:
        torch.cuda.CUDAGraph = plain_graph
    rec = {"launches": kernels.launch_counts(),
           "executor": _exe_delta(exe, before),
           "step_ms": ms, "step_ms_p50": float(np.median(ms))}
    graphs = [e for e in exe._cache.values() if e.graph is not None]
    if keep_graph and graphs:
        rec["graph_kernel_nodes"] = len(_graph_kernel_names(graphs[-1].graph))
    final = _persistables(program, scope)
    exe.close()
    del exe, scope
    return rec, outs, final, checks


def _opt_lr_check(label, schedule, lrs, first_step=0):
    """Each fetched LR against the schedule's closed form (``first_step``
    is the counter's value at the first): the largest relative error."""
    worst = 0.0
    for i, got in enumerate(lrs):
        want = (lr_closed_form(schedule[0], schedule[1], first_step + i)
                if schedule else OPT_RNN_LR)
        worst = max(worst, abs(got - want) / abs(want))
    if not worst <= OPT_LR_TOL:
        fail("%s: the fetched LRs %s miss the closed form of %s by %g "
             "relative > %g" % (label, lrs, schedule, worst, OPT_LR_TOL))
    return worst


def _opt_compare(label, eager, compiled):
    """Compiled against eager: losses, LRs and every persistable (the
    step counter included) bit for bit, one capture, a replay a step."""
    (e_rec, e_outs, e_final, _), (c_rec, c_outs, c_final, _) = \
        eager, compiled
    same_loss = all(all(torch.equal(x, y) for x, y in zip(a, b))
                    for a, b in zip(e_outs, c_outs))
    diff = {n: float((t.double() - c_final[n].double()).abs().max())
            for n, t in e_final.items()}
    same_state = set(e_final) == set(c_final) and all(
        torch.equal(t, c_final[n]) for n, t in e_final.items())
    if not (same_loss and same_state):
        fail("%s: the compiled steps differ from the eager ones (losses "
             "and LRs %s, largest state difference %g)"
             % (label, "identical" if same_loss else "different",
                max(diff.values())))
    if "@LR_DECAY_COUNTER@" in c_final and \
            c_final["@LR_DECAY_COUNTER@"].dtype != torch.int64:
        fail("%s: the step counter is %s, not int64"
             % (label, c_final["@LR_DECAY_COUNTER@"].dtype))
    _compiled_gate(label + " (phase 14)", c_rec["executor"],
                   len(c_outs))
    if e_rec["executor"]["eager_runs"] != len(e_outs):
        fail("%s: the eager run took another path: %s"
             % (label, e_rec["executor"]))
    if c_rec["launches"] != e_rec["launches"]:
        fail("%s: compiled launches %s, eager %s"
             % (label, c_rec["launches"], e_rec["launches"]))


def _opt_update_gate(label, program, tol, clip=None, decay=None):
    """A ``check`` for :func:`_opt_run`: the step's update of every
    parameter against its float64 recomputation, within ``tol`` of
    max(1, |p|); returns the step's record."""
    names = [p.name for p in program.all_parameters()
             if p.name in update_state_names(program)]

    def check(step, pre, grads, post, lr):
        errs, norm, scale = update_errors(
            program, pre, dict(zip(names, grads)), post, lr, clip, decay)
        worst = max(errs, key=errs.get)
        rec = {"max_err_over_max1_p": errs[worst], "param": worst,
               "params": len(errs), "lr": lr, "global_norm": norm,
               "clip_scale": scale}
        if not errs[worst] <= tol:
            fail("%s step %d: %s's update misses its float64 "
                 "recomputation by %g of max(1, |p|) > %g (global norm "
                 "%s, scale %s)" % (label, step, worst, errs[worst], tol,
                                    norm, scale))
        return rec

    return check


def _opt_grad_fetch(program):
    """The raw gradient of every parameter an update op reads, in the
    order of ``program.all_parameters()``."""
    ops = update_state_names(program)
    return [p.name + "@GRAD" for p in program.all_parameters()
            if p.name in ops]


def _opt_lm(dev, plain):
    """The LM under its recipe: eager then compiled from one state; the
    update at each of OPT_CHECK_STEPS recomputed from the eager run's
    fetched gradients. ``plain`` is phase 12's plain-Adam LM record."""
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    spec, trainer, main_prog, lr_var, recipe = _opt_build(dev, "lm")
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feed = trainer.feeder.feed(next(iter(spec["reader"]())))
    trainer.exe.close()
    L = GPT2_SMALL["num_layers"]
    head = [spec["cost"].name, lr_var.name]
    eager = _opt_run(dev, main_prog, head, feed, state, False, OPT_STEPS,
                     grads=_opt_grad_fetch(main_prog),
                     check_steps=OPT_CHECK_STEPS,
                     names=_opt_state_names(main_prog),
                     check=_opt_update_gate("optim lm", main_prog,
                                            OPT_UPDATE_TOL, recipe["clip"],
                                            recipe["decay"]))
    updates = eager[3]
    gc.collect()
    torch.cuda.empty_cache()
    # the compiled run fetches the cost and the LR alone, so that its
    # step time holds no copy of the gradients
    compiled = _opt_run(dev, main_prog, head, feed, state, True, OPT_STEPS,
                        keep_graph=True)
    _opt_compare("optim lm", eager, compiled)
    c_rec, c_outs = compiled[0], compiled[1]
    lrs = [float(o[1].reshape(-1)[0]) for o in c_outs]
    lr_err = _opt_lr_check("optim lm", recipe["schedule"], lrs)
    want = dict(_no_launches(), **{
        "flash_attention_fwd": 2 * L * OPT_STEPS,
        "flash_attention_bwd_dkv": L * OPT_STEPS,
        "flash_attention_bwd_dq": L * OPT_STEPS})
    if c_rec["launches"] != want:
        fail("optim lm: launches %s over %d steps, expected %s"
             % (c_rec["launches"], OPT_STEPS, want))
    losses = [float(o[0].reshape(-1)[0]) for o in c_outs]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("optim lm: the loss did not fall: %s" % losses)
    # the same program with a clip that binds, from the same state
    e_p50 = eager[0]["step_ms_p50"]
    del eager, compiled
    gc.collect()
    torch.cuda.empty_cache()
    bspec, btrainer, bprog, blr, brecipe = _opt_build(
        dev, "lm", lm_clip=OPT_LM_BIND_CLIP)
    btrainer.exe.close()
    bound = _opt_run(dev, bprog, [bspec["cost"].name, blr.name], feed, state,
                     False, OPT_LM_BIND_STEPS, grads=_opt_grad_fetch(bprog),
                     check_steps=range(1, OPT_LM_BIND_STEPS + 1),
                     names=_opt_state_names(bprog),
                     check=_opt_update_gate("optim lm (clip %g)"
                                            % OPT_LM_BIND_CLIP, bprog,
                                            OPT_UPDATE_TOL, brecipe["clip"],
                                            brecipe["decay"]))[3]
    if not all(u["clip_scale"] < 1.0 for u in bound.values()):
        fail("optim lm: a global-norm clip of %g did not bind: %s"
             % (OPT_LM_BIND_CLIP, bound))
    types_ = [op.type for op in main_prog.global_block().ops]
    rec = {"recipe": recipe, "params": len(main_prog.all_parameters()),
           "program_ops": len(types_),
           "clip_and_decay_ops": {t: types_.count(t) for t in (
               "squared_l2_norm", "sum", "sqrt", "elementwise_max",
               "elementwise_div", "elementwise_mul", "scale")},
           "losses": losses, "lrs": lrs, "lr_max_rel_err": lr_err,
           "update_check": updates,
           # the steps whose global norm passed the clip (scale < 1)
           "clip_bound_steps": [k for k, u in sorted(updates.items())
                                if u["clip_scale"] < 1.0],
           "update_check_clip_%g" % OPT_LM_BIND_CLIP: bound,
           "launches_per_step": {k: v / OPT_STEPS
                                 for k, v in c_rec["launches"].items() if v},
           "step_ms_p50": c_rec["step_ms_p50"],
           "step_ms": c_rec["step_ms"],
           "eager_step_ms_p50": e_p50,
           "graph_kernel_nodes": c_rec.get("graph_kernel_nodes"),
           "phase12_plain_adam_step_ms_p50": plain.get("step_ms_p50"),
           "phase12_plain_adam_graph_kernel_nodes":
               plain.get("graph_kernel_nodes_total"),
           "phase12_plain_adam_program_ops": plain.get("program_ops")}
    return rec, c_rec["launches"]


def _opt_resnet(dev, plain):
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    spec, trainer, main_prog, lr_var, recipe = _opt_build(dev, "resnet50")
    rng = np.random.RandomState(0)
    batch = list(zip(rng.rand(R50_BATCH, 3, 224, 224).astype(np.float32),
                     rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)))
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feed = trainer.feeder.feed(batch)
    trainer.exe.close()
    head = [spec["cost"].name, lr_var.name]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = _opt_run(dev, main_prog, head, feed, state, False,
                         OPT_STEPS, grads=_opt_grad_fetch(main_prog),
                         check_steps=(1,),
                         names=_opt_state_names(main_prog),
                         check=_opt_update_gate(
                             "optim resnet50", main_prog, OPT_UPDATE_TOL,
                             recipe["clip"], recipe["decay"]))
        updates = eager[3]
        gc.collect()
        torch.cuda.empty_cache()
        compiled = _opt_run(dev, main_prog, head, feed, state, True,
                            OPT_STEPS, keep_graph=True)
    finally:
        torch.backends.cudnn.deterministic = saved
    _opt_compare("optim resnet50", eager, compiled)
    c_rec, c_outs = compiled[0], compiled[1]
    lrs = [float(o[1].reshape(-1)[0]) for o in c_outs]
    # each piece at its step, exactly (the table is float64, as declared)
    want_lrs = [lr_closed_form(recipe["schedule"][0], recipe["schedule"][1],
                               s) for s in range(OPT_STEPS)]
    if lrs != want_lrs:
        fail("optim resnet50: LRs %s, the pieces are %s" % (lrs, want_lrs))
    want = dict(_no_launches(), conv3x3_fwd=16 * OPT_STEPS,
                conv3x3_dx=16 * OPT_STEPS)
    if c_rec["launches"] != want:
        fail("optim resnet50: launches %s over %d steps, expected %s"
             % (c_rec["launches"], OPT_STEPS, want))
    losses = [float(o[0].reshape(-1)[0]) for o in c_outs]
    if not np.all(np.isfinite(losses)):
        fail("optim resnet50: losses %s" % losses)
    rec = {"recipe": recipe, "losses": losses, "lrs": lrs,
           "update_check": updates, "cudnn_deterministic": True,
           "launches_per_step": {k: v / OPT_STEPS
                                 for k, v in c_rec["launches"].items() if v},
           "step_ms_p50": c_rec["step_ms_p50"], "step_ms": c_rec["step_ms"],
           "eager_step_ms_p50": eager[0]["step_ms_p50"],
           "graph_kernel_nodes": c_rec.get("graph_kernel_nodes"),
           "phase12_plain_momentum_step_ms_p50": plain.get("step_ms_p50"),
           "phase12_plain_momentum_graph_kernel_nodes":
               plain.get("graph_kernel_nodes_total"),
           "program_ops": len(main_prog.global_block().ops),
           "phase12_plain_momentum_program_ops": plain.get("program_ops")}
    return rec, c_rec["launches"]


def _opt_rnn(dev, recipe):
    """One classifier run under ``recipe``, compiled: warm-up, capture,
    2 replays, the raw gradients fetched every step; the update at the
    capture's replay recomputed in float64."""
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    label = recipe[0]
    spec, trainer, main_prog, lr_var, rec = _opt_build(dev, "rnn", recipe)
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    feed = trainer.feeder.feed(next(iter(spec["reader"]())))
    trainer.exe.close()
    head = [spec["cost"].name] + ([lr_var.name] if lr_var else [])
    run = _opt_run(dev, main_prog, head, feed, state, True, OPT_RNN_STEPS,
                   grads=_opt_grad_fetch(main_prog),
                   check_steps=(OPT_RNN_CHECK_STEP,),
                   names=_opt_state_names(main_prog),
                   check=_opt_update_gate("optim rnn " + label, main_prog,
                                          OPT_RNN_UPDATE_TOL, rec["clip"],
                                          rec["decay"]))
    r, outs, updates = run[0], run[1], run[3]
    _compiled_gate("optim rnn " + label + " (phase 14)", r["executor"],
                   OPT_RNN_STEPS)
    lrs = [float(o[1].reshape(-1)[0]) if lr_var else None for o in outs]
    lr_err = (_opt_lr_check("optim rnn " + label, rec["schedule"], lrs)
              if lr_var else None)
    want = dict(_no_launches(), fused_lstm=2 * RNN_BENCH["layers"]
                * OPT_RNN_STEPS)
    if r["launches"] != want:
        fail("optim rnn %s: launches %s over %d steps, expected %s"
             % (label, r["launches"], OPT_RNN_STEPS, want))
    losses = [float(o[0].reshape(-1)[0]) for o in outs]
    if not np.all(np.isfinite(losses)):
        fail("optim rnn %s: losses %s" % (label, losses))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return {"recipe": rec, "losses": losses, "lrs": lrs,
            "lr_max_rel_err": lr_err, "update_check": updates,
            "step_ms": r["step_ms"]}, r["launches"]


def _opt_average(dev):
    """ModelAverage on the LM: 2 steps (``update()`` after each),
    ``apply()``, ``Trainer.test``, ``restore()``, 2 more steps; against
    4 steps of a run with no average from the same state."""
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.optimizer import ModelAverage
    from paddle_tpu_torch.trainer import EndIteration
    n1, n2 = OPT_AVG_STEPS
    runs = {}
    for mode in ("plain", "average"):
        spec, trainer, main_prog, _, _ = _opt_build(dev, "lm")
        batches = list(spec["reader"]())[:n1 + n2 + 1]
        with scope_guard(Scope()):
            trainer._maybe_init()
            losses, avg, rec = [], None, {}
            if mode == "average":
                avg = ModelAverage(min_average_window=2,
                                   max_average_window=4,
                                   program=main_prog, scope=global_scope())

            def handler(e):
                if isinstance(e, EndIteration):
                    losses.append(e.cost)
                    if avg is not None:
                        avg.update()

            trainer.train(lambda: iter(batches[:n1]), num_passes=1,
                          event_handler=handler, pipeline=False)
            if avg is not None:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                avg.apply()
                torch.cuda.synchronize()
                rec["apply_ms"] = (time.monotonic() - t0) * 1e3
                test = trainer.test(lambda: iter(batches[n1 + n2:]))
                rec["test_cost_averaged"] = float(np.asarray(
                    test[0]).reshape(-1)[0])
                t0 = time.monotonic()
                avg.restore()
                torch.cuda.synchronize()
                rec["restore_ms"] = (time.monotonic() - t0) * 1e3
                avg = None  # no update over the last steps
            trainer.train(lambda: iter(batches[n1:n1 + n2]), num_passes=1,
                          event_handler=handler, pipeline=False)
            rec["losses"] = losses
            rec["executor"] = {k: trainer.exe.stats[k] for k in _EXE_KEYS}
        trainer.exe.close()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        runs[mode] = rec
    plain, averaged = runs["plain"]["losses"], runs["average"]["losses"]
    if averaged[n1:] != plain[n1:] or averaged[:n1] != plain[:n1]:
        fail("ModelAverage: the losses after restore %s differ from a run "
             "without the average %s" % (averaged, plain))
    return runs


def phase_optimization(dev, plain):
    """Phase 14: clipping, weight decay, schedules and the optimizers on
    the card. ``plain`` holds phase 12's LM and ResNet-50 records.
    Returns {path: launches}."""
    t0 = time.monotonic()
    rec, paths = {}, {}
    rec["lm"], paths["optim_lm"] = _opt_lm(dev, plain.get("lm", {}))
    gc.collect()
    torch.cuda.empty_cache()
    rec["resnet50"], paths["optim_resnet50"] = _opt_resnet(
        dev, plain.get("resnet50", {}))
    gc.collect()
    torch.cuda.empty_cache()
    rec["rnn"] = {}
    for recipe in OPT_RNN_RECIPES:
        rec["rnn"][recipe[0]], paths["optim_rnn_" + recipe[0]] = \
            _opt_rnn(dev, recipe)
    rec["model_average"] = _opt_average(dev)
    rec["wall_s"] = time.monotonic() - t0
    log(json.dumps({"optimization": rec}))
    return paths


# -- phase 15 -----------------------------------------------------------------

# Phase 15 (verifier and memory). The memory planner's predicted peak of
# the GPT-2-small LM's training step (Adam, TRAIN_BATCH x 1024 tokens,
# the cost fetched), which tests/test_torch_memory_plan.py computes in
# both packages on the CPU: a lower bound (199 vars of unknown size,
# PT033)
LM_PLAN_PEAK_BYTES = 10386670672
# the release's per-op peak against keeping every value (the parent's
# Executor): at most this share
RELEASE_PEAK_SHARE = 0.8
# the LM at this batch must be refused by the preflight against the
# card's own memory, before it allocates more than MEM_REFUSED_BYTES
MEM_REFUSE_BATCH = 128
MEM_REFUSED_BYTES = 64 << 20
MEM_STEPS = 5  # a compiled run: warm-up, capture, 3 replays
FLASH_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd_dkv": 12,
                  "flash_attention_bwd_dq": 12}
CONV_PER_STEP = {"conv3x3_fwd": 16, "conv3x3_dx": 16}


def _tensor_bytes(values):
    from paddle_tpu_torch.core.executor import raw_data
    return sum(raw_data(v).numel() * raw_data(v).element_size()
               for v in values)


def _footprint(dev, run, resident):
    """(result of ``run()``, the bytes the step held at its peak): the
    allocator's peak during ``run`` over what was allocated before it,
    plus ``resident`` (the state and feeds the step holds from its
    start), so that tensors of no concern to the step do not count."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = run()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base + resident


@contextlib.contextmanager
def _keep_every_value():
    """The parent's Executor: a release schedule that drops nothing."""
    from paddle_tpu_torch.analysis import memory as mem
    real = mem.release_schedule
    mem.release_schedule = lambda block, ops, keep: [()] * len(ops)
    try:
        yield
    finally:
        mem.release_schedule = real


def _mem_verify(main_prog, startup):
    """Step 1: the verifier on the LM's programs, timed, and the
    post-pass of append_backward timed on the built program."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core import backward
    rec = {}
    for label, prog in (("main", main_prog), ("startup", startup)):
        t0 = time.perf_counter()
        diags = analysis.verify(prog)
        rec[label + "_verify_ms"] = (time.perf_counter() - t0) * 1e3
        rec[label + "_errors"] = sum(1 for d in diags if d.is_error)
        rec[label + "_warnings_by_code"] = dict(collections.Counter(
            d.code for d in diags if not d.is_error))
        if rec[label + "_errors"]:
            fail("phase 15: the %s program verifies with errors:\n%s"
                 % (label, analysis.render_diagnostics(diags)))
    t0 = time.perf_counter()
    backward._check_backward_pass(main_prog)
    rec["append_backward_post_pass_ms"] = (time.perf_counter() - t0) * 1e3
    return rec


def _mem_plan(main_prog, cost):
    """Step 2: the plan at TRAIN_BATCH, held to the CPU test's peak."""
    from paddle_tpu_torch.analysis import memory as mem
    plan, diags = mem.check_memory(main_prog, batch=TRAIN_BATCH,
                                   fetches=[cost])
    rec = {"plan": plan.summary(), "pt033_unknown_vars": len(plan.unknown),
           "codes": sorted({d.code for d in diags}),
           "top_residents": [(r.name, r.nbytes, r.cls)
                             for r in plan.top_residents(5)]}
    log(plan.table())
    if plan.peak_bytes != LM_PLAN_PEAK_BYTES:
        fail("phase 15: the plan's peak %d differs from the CPU test's %d"
             % (plan.peak_bytes, LM_PLAN_PEAK_BYTES))
    return plan, rec


def _mem_per_op(dev, main_prog, cost, feed, state, plan):
    """Step 3: one step from ``state`` through trace_ops with no schedule
    (every value kept) and one through Executor.run(use_jit=False): the
    same bits, the release's peak at most RELEASE_PEAK_SHARE of the
    keep-all peak and at least the plan's."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor, trace_ops
    from paddle_tpu_torch.core.scope import Scope
    resident = _tensor_bytes(list(state.values()) + list(feed.values()))

    def keep_all():
        env = dict(feed)
        env.update({n: t.clone() for n, t in state.items()})
        with torch.no_grad():
            trace_ops(main_prog.global_block(), env,
                      torch.Generator(device=dev).manual_seed(0), dev)
        return env[cost].clone(), {n: env[n] for n in state}

    (k_loss, k_state), k_peak = _footprint(dev, keep_all, resident)
    gc.collect()
    torch.cuda.empty_cache()
    scope = Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    exe = Executor(dev)
    kernels.reset_launches()
    (r_loss,), r_peak = _footprint(dev, lambda: exe.run(
        main_prog, feed=feed, fetch_list=[cost], scope=scope, use_jit=False,
        return_numpy=False), resident)
    launches = kernels.launch_counts()
    same = torch.equal(k_loss, r_loss) and all(
        torch.equal(k_state[n], scope.find_var(n)) for n in state)
    rec = {"keep_all_peak_bytes": k_peak, "release_peak_bytes": r_peak,
           "release_over_keep_all": r_peak / k_peak,
           "plan_peak_bytes": plan.peak_bytes,
           "plan_over_release": plan.peak_bytes / r_peak,
           "preflight_predicted_peak_bytes":
               exe.stats["mem_predicted_peak_bytes"],
           "loss": float(r_loss.reshape(-1)[0]), "bit_identical": same}
    del k_state, scope, exe
    if not same:
        fail("phase 15: the release changed the step's loss or state")
    if r_peak > RELEASE_PEAK_SHARE * k_peak:
        fail("phase 15: the release's peak %d is above %.2f of the "
             "keep-all peak %d" % (r_peak, RELEASE_PEAK_SHARE, k_peak))
    if plan.peak_bytes > r_peak:
        fail("phase 15: the plan's peak %d is above the measured %d (it "
             "is a lower bound)" % (plan.peak_bytes, r_peak))
    for name, n in FLASH_PER_STEP.items():
        if launches[name] != n:
            fail("phase 15: the per-op step launched %s %d times, expected "
                 "%d" % (name, launches[name], n))
    return rec, launches


def _mem_compiled(dev, main_prog, cost, feed, state, keep_all=False):
    """Step 4: MEM_STEPS compiled runs from ``state`` (a warm-up, the
    capture, replays): the peak allocated and reserved bytes, the graph
    pool's bytes and the replays' step p50 by CUDA events."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    scope = Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    exe = Executor(dev)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    alloc0 = torch.cuda.memory_allocated(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    kernels.reset_launches()
    ms, losses = [], []
    with (_keep_every_value() if keep_all else contextlib.nullcontext()):
        for _ in range(MEM_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = exe.run(main_prog, feed=feed, fetch_list=[cost],
                          scope=scope, return_numpy=False)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(out[0])
    launches = kernels.launch_counts()
    rec = {"peak_allocated_bytes":
               torch.cuda.max_memory_allocated(dev) - alloc0,
           "peak_reserved_bytes":
               torch.cuda.max_memory_reserved(dev) - reserved0,
           "graph_pool_bytes": _pool_bytes(exe._pool),
           "step_ms": ms, "replay_ms_p50": float(np.median(ms[2:])),
           "executor": {k: exe.stats[k] for k in _EXE_KEYS}}
    _compiled_gate("memory_lm" + ("_keep_all" if keep_all else ""),
                   rec["executor"], MEM_STEPS)
    for name, n in FLASH_PER_STEP.items():
        if launches[name] != n * MEM_STEPS:
            fail("phase 15: %d compiled steps launched %s %d times, "
                 "expected %d a step" % (MEM_STEPS, name, launches[name], n))
    final = _persistables(main_prog, scope)
    exe.close()
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    return rec, losses, final, launches


def _mem_refusals(dev, state, predicted, main8, cost8, feed8):
    """Step 5: the LM at MEM_REFUSE_BATCH against the card's memory (no
    budget flag) refused with PT030 before it allocates; then the
    batch-8 step just under (refused) and just over (runs) the peak its
    preflight ``predicted``."""
    from paddle_tpu_torch.analysis import ProgramVerifyError
    from paddle_tpu_torch.analysis import memory as mem
    from paddle_tpu_torch.configs import tiny_lm
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.flags import flags_guard
    widths = dict(vocab=GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_seq"],
                  hidden=GPT2_SMALL["hidden"],
                  num_layers=GPT2_SMALL["num_layers"],
                  num_heads=GPT2_SMALL["num_heads"],
                  ffn_mult=GPT2_SMALL["ffn_mult"])
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = tiny_lm.model(batch=MEM_REFUSE_BATCH, samples=1,
                             learning_rate=TRAIN_LR, seed=0, **widths)
        spec["optimizer"].minimize(spec["cost"])
    cost = spec["cost"].name
    big = mem.plan_memory(main_prog, batch=MEM_REFUSE_BATCH, fetches=[cost],
                          vmem=False)
    toks = np.random.RandomState(0).randint(
        0, widths["vocab"], (MEM_REFUSE_BATCH, widths["seq"])).astype(np.int64)
    exe, scope = Executor(dev), Scope()
    for n, t in state.items():
        scope.set_var(n, t)
    feed = exe.prepare_feed({"toks": toks, "tgt": (toks + 1) % widths["vocab"]})
    budget = mem.resolve_budget_bytes(device=dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    jit0 = exe.stats["jit_runs"]
    t0 = time.perf_counter()
    try:
        with flags_guard(verify=True, memory_budget_gb=0.0):
            exe.run(main_prog, feed=feed, fetch_list=[cost], scope=scope)
        fail("phase 15: the batch-%d LM (plan %d bytes) ran against the "
             "card's %d" % (MEM_REFUSE_BATCH, big.peak_bytes, budget))
    except torch.cuda.OutOfMemoryError as e:
        fail("phase 15: the batch-%d LM met a CUDA OOM instead of PT030: %s"
             % (MEM_REFUSE_BATCH, e))
    except ProgramVerifyError as e:
        msg = str(e)
    refuse_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    grown = torch.cuda.memory_allocated(dev) - before
    rec = {"refused_batch": MEM_REFUSE_BATCH,
           "refused_plan_peak_bytes": big.peak_bytes,
           "refused_plan_peak_op": big.peak_op_ref(),
           "card_budget_bytes": budget, "refusal_host_ms": refuse_ms,
           "allocated_growth_bytes": grown,
           "jit_runs_moved": exe.stats["jit_runs"] - jit0}
    if "PT030" not in msg or big.peak_op_ref() not in msg:
        fail("phase 15: the refusal does not name PT030 and the high-water "
             "op %s:\n%s" % (big.peak_op_ref(), msg[:2000]))
    if grown >= MEM_REFUSED_BYTES or rec["jit_runs_moved"]:
        fail("phase 15: the refused run allocated %d bytes / ran %d steps"
             % (grown, rec["jit_runs_moved"]))
    del feed, scope, exe
    # the batch-8 step just under and just over its own plan
    for label, delta in (("under", -(1 << 20)), ("over", 1 << 20)):
        exe, scope = Executor(dev), Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        gb = (predicted + delta) / float(1 << 30)
        try:
            with flags_guard(verify=True, memory_budget_gb=gb):
                out = exe.run(main8, feed=feed8, fetch_list=[cost8],
                              scope=scope, use_jit=False)
            ran = bool(np.isfinite(np.asarray(out[0])).all())
        except ProgramVerifyError:
            ran = False
        rec["budget_%s_ran" % label] = ran
        if ran != (label == "over"):
            fail("phase 15: at a budget %s the plan (%.6f GiB) the step %s"
                 % (label, gb, "ran" if ran else "was refused"))
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _mem_resnet(dev):
    """Step 6: ResNet-50 at R50_BATCH, one compiled step (its warm-up)
    with the verifier and the preflight on: the plan's peak beside the
    measured one, and the conv3x3 launches."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import resnet_cifar
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.flags import flags_guard
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
    trainer.exe.close()
    feed = trainer.feeder.feed(batch)
    exe, scope = Executor(dev), Scope()
    for n, t in state.items():
        scope.set_var(n, t)
    resident = _tensor_bytes(list(state.values()) + list(feed.values()))
    kernels.reset_launches()
    with flags_guard(verify=True):
        (loss,), peak = _footprint(dev, lambda: exe.run(
            main_prog, feed=feed, fetch_list=[spec["cost"]], scope=scope,
            return_numpy=False), resident)
    launches = kernels.launch_counts()
    rec = {"plan_peak_bytes": exe.stats["mem_predicted_peak_bytes"],
           "measured_peak_bytes": peak,
           "plan_over_measured":
               exe.stats["mem_predicted_peak_bytes"] / peak,
           "loss": float(loss.reshape(-1)[0]),
           "launches": {k: launches[k] for k in CONV_PER_STEP},
           "executor": {k: exe.stats[k] for k in _EXE_KEYS}}
    if {k: launches[k] for k in CONV_PER_STEP} != CONV_PER_STEP:
        fail("phase 15: ResNet-50's step launched %s, expected %s"
             % (rec["launches"], CONV_PER_STEP))
    if not math.isfinite(rec["loss"]) or rec["executor"]["jit_runs"] != 1:
        fail("phase 15: ResNet-50's step: %s" % rec)
    exe.close()
    del exe, scope, state, feed
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def _mem_cli(root):
    """Step 7: the lint verb with the memory pass on the conv-net
    config."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "lint",
         os.path.join("paddle_tpu_torch", "configs", "resnet_cifar.py"),
         "--memory", "--batch", "32"], cwd=root, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=root))
    rec = {"rc": out.returncode, "seconds": time.monotonic() - t0}
    if out.returncode != 0 or \
            "predicted per-device HBM residency (batch=32" not in out.stdout:
        fail("phase 15: lint --memory exited %d:\n%s\n%s"
             % (out.returncode, out.stdout[-3000:], out.stderr[-3000:]))
    log(out.stdout.strip())
    return rec


def phase_memory(dev, root, plain):
    """Phase 15: the verifier and the memory planner on the card, with
    ``FLAGS.verify`` on. ``plain`` holds phase 12's LM and ResNet-50
    records. Returns {path: launches}."""
    from paddle_tpu_torch.analysis import runner
    from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
    from paddle_tpu_torch.flags import flags_guard
    t0 = time.monotonic()
    rec, paths = {}, {}
    widths, cfg, spec, trainer, main_prog = _lm_build(dev)
    cost = spec["cost"].name
    rec["verify"] = _mem_verify(main_prog, trainer.startup_program)
    plan, rec["plan"] = _mem_plan(main_prog, cost)
    with scope_guard(Scope()):
        trainer._maybe_init()
        state = _persistables(main_prog, global_scope())
    trainer.exe.close()
    feed = trainer.feeder.feed(next(iter(spec["reader"]())))
    # the hook verifies a program version once: count its walks
    calls, real = [], runner.verify

    def counted(program, *a, **kw):
        calls.append(program._uid)
        return real(program, *a, **kw)

    runner.verify = counted
    try:
        with flags_guard(verify=True):
            rec["per_op"], paths["memory_lm_per_op"] = _mem_per_op(
                dev, main_prog, cost, feed, state, plan)
            comp, c_losses, c_final, paths["memory_lm_compiled"] = \
                _mem_compiled(dev, main_prog, cost, feed, state)
    finally:
        runner.verify = real
    rec["verify"]["hook_walks"] = calls.count(main_prog._uid)
    if rec["verify"]["hook_walks"] != 2:
        # one for the per-op Executor, one for the compiled one: a second
        # run of a program on an Executor does not verify it again
        fail("phase 15: the verify hook walked the LM %d times over two "
             "Executors" % rec["verify"]["hook_walks"])
    keep, k_losses, k_final, _ = _mem_compiled(dev, main_prog, cost, feed,
                                               state, keep_all=True)
    if not (all(torch.equal(a, b) for a, b in zip(c_losses, k_losses))
            and all(torch.equal(t, k_final[n]) for n, t in c_final.items())):
        fail("phase 15: compiled steps with the release differ from those "
             "keeping every value")
    rec["compiled"] = {"release": comp, "keep_all": keep,
                       "pool_release_over_keep_all":
                           comp["graph_pool_bytes"]
                           / max(keep["graph_pool_bytes"], 1),
                       "phase12_step_ms_p50":
                           plain.get("lm", {}).get("step_ms_p50")}
    del c_final, k_final
    rec["refusals"] = _mem_refusals(
        dev, state, rec["per_op"]["preflight_predicted_peak_bytes"],
        main_prog, cost, feed)
    del state, feed
    gc.collect()
    torch.cuda.empty_cache()
    rec["resnet50"], paths["memory_resnet50"] = _mem_resnet(dev)
    rec["cli"] = _mem_cli(root)
    rec["wall_s"] = time.monotonic() - t0
    log(json.dumps({"memory": rec}))
    return paths


# -- phase 16 -----------------------------------------------------------------

# Phase 16 (resilience): the LM's clean pass, its guarded pass with a NaN
# written into a weight before batch RESILIENCE_NAN_AT, the step timings
RESILIENCE_CLEAN = 3
RESILIENCE_GUARDED = 6
RESILIENCE_NAN_AT = 2
RESILIENCE_BUDGET = 2
RESILIENCE_TIMED = 6
# the hang subprocess's deadline, and the deadline of the LM's watched
# pass as a multiple of its first two batches' warm-up plus capture
HANG_TIMEOUT_S = 2
DEADLINE_MULTIPLE = 3.0
FLASH_SYMBOLS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel")


def _res_lm(dev, checkpoint_dir=None):
    """The GPT-2-small LM of phase 13, enough distinct batches for the
    phase: (spec, trainer, main program, the batches)."""
    from paddle_tpu_torch.configs import tiny_lm
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    widths = dict(vocab=GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_seq"],
                  hidden=GPT2_SMALL["hidden"],
                  num_layers=GPT2_SMALL["num_layers"],
                  num_heads=GPT2_SMALL["num_heads"],
                  ffn_mult=GPT2_SMALL["ffn_mult"])
    n = RESILIENCE_CLEAN + RESILIENCE_GUARDED
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = tiny_lm.model(batch=TRAIN_BATCH, samples=n * TRAIN_BATCH,
                             learning_rate=TRAIN_LR, seed=0, **widths)
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev,
                          checkpoint_dir=checkpoint_dir)
    return spec, trainer, main_prog, list(spec["reader"]())


def _res_reader(batches):
    return lambda: iter(list(batches))


def _res_pass(trainer, batches, pipeline=True, nan_into=None):
    """One pass through ``Trainer.train``: ({batch: loss} as the handler
    reads them, [ms from the pass start to each EndIteration], the
    skipped batches' losses included). ``nan_into`` names a weight that
    gets a NaN through the scope before batch RESILIENCE_NAN_AT."""
    from paddle_tpu_torch.core.scope import global_scope
    losses, marks = {}, []
    t0 = [None]

    def handler(e):
        name = type(e).__name__
        if name == "BeginPass":
            t0[0] = time.perf_counter()
        elif name == "BeginIteration" and nan_into and \
                e.batch_id == RESILIENCE_NAN_AT:
            global_scope().find_var(nan_into)[0, 0] = float("nan")
        elif name == "EndIteration":
            losses[e.batch_id] = e.cost          # a sync point
            marks.append((time.perf_counter() - t0[0]) * 1e3)

    trainer.train(_res_reader(batches), num_passes=1, event_handler=handler,
                  pipeline=pipeline)
    return losses, marks


def _res_step_ms(trainer, batches, guarded):
    """``batches`` pipelined steps of a captured key, the guard on or
    off, the handler reading nothing: the p50 of the per-step intervals
    between BeginIterations and the pass's mean step (its wall, the
    pass-end sync included, over the steps)."""
    from paddle_tpu_torch.flags import flags_guard
    stamps = []

    def handler(e):
        if type(e).__name__ == "BeginIteration":
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with flags_guard(loss_skip_budget=RESILIENCE_BUDGET if guarded else 0):
        trainer.train(_res_reader(batches), num_passes=1,
                      event_handler=handler, pipeline=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return {"step_ms_p50": float(np.median(gaps)),
            "step_ms_mean": wall / len(batches), "steps": len(batches),
            "gaps_ms": gaps, "first_step_from_start_ms":
                (stamps[0] - t0) * 1e3}


def _res_guarded(dev, work):
    """Step a: the guarded LM. Returns (record, launches of the path,
    the warm-up plus capture ms)."""
    from paddle_tpu_torch import kernels, profiler
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.flags import flags_guard
    from paddle_tpu_torch.resilience import events
    ck = _fresh_dir(os.path.join(work, "lm_guarded"))
    clean = os.path.join(work, "lm_clean_copy")
    shutil.rmtree(clean, ignore_errors=True)
    rec = {}
    with scope_guard(Scope()):
        spec, tr, prog, batches = _res_lm(dev, checkpoint_dir=ck)
        tr._maybe_init()
        weight = sorted(p.name for p in
                        prog.global_block().all_parameters()
                        if len(p.shape) == 2)[0]
        kernels.reset_launches()
        losses0, marks0 = _res_pass(tr, batches[:RESILIENCE_CLEAN])
        # batch 0 ran the warm-up, batch 1 the capture and its replay
        warm_capture_ms = marks0[1]
        rec["clean_pass"] = {"losses": [losses0[b] for b in sorted(losses0)],
                             "warmup_plus_capture_ms": warm_capture_ms,
                             "save_ms": tr._last_ckpt_secs * 1e3}
        shutil.copytree(ck, clean)
        events.clear_events()
        profiler.reset_trainer_counters()
        before = {k: tr.exe.stats[k] for k in _EXE_KEYS}
        rewinds = []
        real_rewind = tr._guard_rewind

        def timed_rewind():
            t0 = time.perf_counter()
            ok = real_rewind()
            torch.cuda.synchronize()
            rewinds.append((time.perf_counter() - t0) * 1e3)
            return ok

        tr._guard_rewind = timed_rewind
        with flags_guard(loss_skip_budget=RESILIENCE_BUDGET):
            losses, marks = _res_pass(
                tr, batches[RESILIENCE_CLEAN:], nan_into=weight)
        del tr._guard_rewind
        delta = _exe_delta(tr.exe, before)
        trail = [(e["kind"], e.get("reason"), e["pass_id"], e["batch_id"])
                 for e in events.events()
                 if e["kind"] in ("batch_skipped", "guard_rewind",
                                  "checkpoint_skipped_tainted")]
        counters = profiler.trainer_counters()
        accepted = [losses[b] for b in range(RESILIENCE_NAN_AT + 2,
                                             RESILIENCE_GUARDED)]
        # the same batches again, from the same checkpoint, same Trainer
        tr.checkpoint_dir = clean
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._load_checkpoint_state()
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        tr.checkpoint_dir = None
        rerun, _ = _res_pass(
            tr, batches[RESILIENCE_CLEAN + RESILIENCE_NAN_AT + 2:])
        rerun = [rerun[b] for b in sorted(rerun)]
        timed = batches[RESILIENCE_CLEAN:RESILIENCE_CLEAN + RESILIENCE_TIMED]
        rec["steps_guard_off"] = _res_step_ms(tr, timed, guarded=False)
        rec["steps_guard_on"] = _res_step_ms(tr, timed, guarded=True)
        rec["steps_guard_off_again"] = _res_step_ms(tr, timed, guarded=False)
        launches = kernels.launch_counts()
        tr.exe.close()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(clean, ignore_errors=True)
    shutil.rmtree(ck, ignore_errors=True)
    n = RESILIENCE_NAN_AT
    rec.update({"trail": trail, "trainer_counters": counters,
                "losses": [losses[b] for b in sorted(losses)],
                "accepted_after_rewind": accepted, "rerun": rerun,
                "executor_delta": delta, "rewind_ms": rewinds,
                "reload_ms": load_ms,
                "flash_launches": {k: launches[k] for k in (
                    "flash_attention_fwd", "flash_attention_bwd_dkv",
                    "flash_attention_bwd_dq")}})
    want_trail = [("batch_skipped", "nonfinite", 0, n),
                  ("batch_skipped", "nonfinite", 0, n + 1),
                  ("guard_rewind", "nonfinite", 0, n + 1)]
    if trail != want_trail:
        fail("phase 16: the guard's trail %s, expected %s"
             % (trail, want_trail))
    if counters != {"batches_skipped": 2.0, "guard_rewinds": 1.0}:
        fail("phase 16: profiler.trainer_counters() %s" % counters)
    if not all(math.isfinite(v) for v in accepted) or len(rewinds) != 1:
        fail("phase 16: after the rewind the losses %s (%d rewinds)"
             % (accepted, len(rewinds)))
    # the rewind's load and the pass end's save are programs of host ops,
    # each a hybrid run on the Trainer's Executor
    if delta != {"jit_runs": RESILIENCE_GUARDED, "eager_runs": 0,
                 "hybrid_runs": 2, "graph_captures": 0,
                 "graph_replays": RESILIENCE_GUARDED}:
        fail("phase 16: the guarded pass's runs %s: a recapture, a "
             "fallback, or not one replay a step" % delta)
    if rerun != accepted:
        fail("phase 16: the accepted losses after the rewind %s differ "
             "from a rerun from the same checkpoint %s" % (accepted, rerun))
    if not all(rec["flash_launches"].values()):
        fail("phase 16: the flash kernels did not launch on the guarded "
             "path: %s" % rec["flash_launches"])
    return rec, launches, warm_capture_ms


def _res_cli(root, work, spec):
    """One ``train`` subprocess of the fit_a_line config on the card:
    (exit code, wall s, the state dir, stderr's tail)."""
    state = _fresh_dir(os.path.join(work, "hang_state"))
    env = dict(os.environ, PYTHONPATH=root,
               PADDLE_TPU_FLAGS="step_timeout_s=%d" % HANG_TIMEOUT_S,
               PADDLE_TPU_ELASTIC_STATE=state)
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    if spec:
        env["PADDLE_TPU_FAULT_SPEC"] = spec
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "fit_a_line.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    return out.returncode, time.monotonic() - t0, state, out.stderr[-3000:]


def _res_hang(root, work):
    """Step b: a wedged step of the CLI's Trainer exits 75."""
    rc0, wall0, state0, err0 = _res_cli(root, work, None)
    if rc0 != 0 or os.path.exists(os.path.join(state0, "events.jsonl")):
        fail("phase 16: train without the fault exited %d:\n%s" % (rc0, err0))
    rc, wall, state, err = _res_cli(
        root, work, "trainer.step:delay:nth=3,delay=3600")
    rec = {"clean_rc": rc0, "clean_wall_s": wall0, "hang_rc": rc,
           "hang_wall_s": wall, "deadline_s": HANG_TIMEOUT_S}
    if rc != 75 or wall > HANG_TIMEOUT_S + wall0 + 30:
        fail("phase 16: the wedged step exited %d after %.1f s (clean run "
             "%.1f s):\n%s" % (rc, wall, wall0, err))
    rows = [json.loads(ln) for ln in
            open(os.path.join(state, "events.jsonl"))]
    hung = [r for r in rows if r["kind"] == "step_hung"]
    if len(hung) != 1 or hung[0]["label"] != "pass0/batch2":
        fail("phase 16: step_hung events %s" % hung)
    with open(hung[0]["timeline"]) as f:
        art = json.load(f)
    rec["timeline"] = os.path.basename(hung[0]["timeline"])
    rec["timeline_trainer"] = art.get("trainer")
    if art.get("schema") != "paddle_tpu.timeline.v1" or \
            art.get("trainer", {}).get("steps_hung") != 1.0:
        fail("phase 16: the hang's timeline: schema %s, trainer %s"
             % (art.get("schema"), art.get("trainer")))
    shutil.rmtree(state, ignore_errors=True)
    return rec


def _res_deadline(dev, warm_capture_ms):
    """Step c: a fresh LM Trainer under a watchdog of DEADLINE_MULTIPLE
    times the warm-up plus capture, with an injected on_hang."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import trainer as trainer_mod
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.flags import flags_guard
    from paddle_tpu_torch.resilience.watchdog import StepWatchdog
    fired = []
    deadline = DEADLINE_MULTIPLE * warm_capture_ms / 1e3
    real = trainer_mod.StepWatchdog
    trainer_mod.StepWatchdog = lambda t, **kw: StepWatchdog(
        t, on_hang=fired.append, poll_s=0.02)
    try:
        with scope_guard(Scope()):
            spec, tr, prog, batches = _res_lm(dev)
            tr._maybe_init()
            kernels.reset_launches()
            with flags_guard(step_timeout_s=deadline):
                losses, marks = _res_pass(tr, batches[:RESILIENCE_CLEAN],
                                          pipeline=False)
            launches = kernels.launch_counts()
            tr.exe.close()
    finally:
        trainer_mod.StepWatchdog = real
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"step_timeout_s": deadline, "multiple": DEADLINE_MULTIPLE,
           "fired": fired, "batch_end_ms": marks}
    if fired:
        fail("phase 16: the watchdog fired on the LM's pass: %s" % fired)
    return rec, launches


def _res_profiler(dev, work, plain):
    """Step d: profiler(timeline_path=...) around 3 compiled LM steps of a
    fresh Trainer, cuda_profiler around one more."""
    from paddle_tpu_torch import kernels, profiler
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    timeline = os.path.join(work, "lm_timeline.json")
    trace = os.path.join(work, "lm_trace.json")
    with scope_guard(Scope()):
        spec, tr, prog, batches = _res_lm(dev)
        tr._maybe_init()
        kernels.reset_launches()
        with profiler.profiler(timeline_path=timeline):
            tr.train(_res_reader(batches[:3]), num_passes=1, pipeline=False)
        with profiler.cuda_profiler(output_file=trace):
            tr.train(_res_reader(batches[3:4]), num_passes=1,
                     pipeline=False)
        launches = kernels.launch_counts()
        uid = prog._uid
        tr.exe.close()
    gc.collect()
    torch.cuda.empty_cache()
    with open(timeline) as f:
        art = json.load(f)
    with open(trace) as f:
        text = f.read()
    entry = art["programs"].get("program_%d" % uid, {})
    nodes = {s: entry.get("kernel_nodes", {}).get(s, 0)
             for s in FLASH_SYMBOLS}
    want = {s: plain.get("lm", {}).get("graph_kernel_nodes", {}).get(s)
            for s in FLASH_SYMBOLS}
    runs = [r for r in art["host_events"]
            if r["name"] == "program_%d_run" % uid]
    rec = {"programs_flash_nodes": nodes, "phase12_flash_nodes": want,
           "kernel_nodes_total": entry.get("kernel_nodes_total"),
           "pool_bytes": entry.get("pool_bytes"),
           "feed_shapes": entry.get("feed_shapes"),
           "launches_a_replay": {k: v for k, v in
                                 entry.get("launches", {}).items()},
           "host_runs": runs, "trace_bytes": len(text),
           "trace_names": {s: text.count(s) for s in FLASH_SYMBOLS},
           "timeline_sections": sorted(art)}
    if nodes != want or not all(nodes.values()):
        fail("phase 16: the programs entry's flash nodes %s, phase 12's "
             "graph %s (entry %s)" % (nodes, want, entry))
    if not runs or runs[0]["calls"] != 3:
        fail("phase 16: host_events %s" % art["host_events"])
    if not all(rec["trace_names"].values()):
        fail("phase 16: the trace names %s" % rec["trace_names"])
    os.remove(trace)
    return rec, launches


def phase_resilience(dev, root, plain):
    """Phase 16: the step watchdog, the numeric guardrails and the
    profiler on the LM. ``plain`` holds phase 12's LM record. Returns
    {path: launches}."""
    t0 = time.monotonic()
    work = _fresh_dir(os.path.join(root, "build", "chip_smoke", "resilience"))
    paths = {}
    guarded, paths["resilience_lm_guarded"], warm = _res_guarded(dev, work)
    log(json.dumps({"resilience_guarded": guarded}))
    deadline, paths["resilience_lm_deadline"] = _res_deadline(dev, warm)
    log(json.dumps({"resilience_deadline": deadline}))
    prof, paths["resilience_lm_profiled"] = _res_profiler(dev, work, plain)
    log(json.dumps({"resilience_profiler": prof}))
    log(json.dumps({"resilience_hang": _res_hang(root, work)}))
    log(json.dumps({"resilience_wall_s": time.monotonic() - t0,
                    "card": card_line()}))
    return paths


# -- phase 17 ------------------------------------------------------------------

# card against CPU: a float32 arithmetic output or gradient within this of
# max(1, the CPU value's largest magnitude) (sums and transcendentals in
# other orders and libraries); data movement, index and bool outputs equal
DENSE_OP_TOL = 1e-5
# matmul against float64 on the card: float32 within this of the
# largest magnitude (TF32 off); bfloat16 (pure AMP) within one bfloat16
# ulp of it plus 2e-5 of it
DENSE_MM_TOL = 2e-5
DENSE_MM_SHAPE = (8, 12, 1024, 64)  # GPT-2 small's q, k, v at batch 8
DENSE_EXACT = ("concat", "split", "slice", "transpose", "squeeze",
               "unsqueeze", "expand", "pad", "crop", "one_hot", "scatter",
               "shape", "range", "fill", "fill_zeros_like", "reverse",
               "arg_max", "arg_min", "argsort", "is_empty", "isfinite",
               "maximum")
DENSE_RANDOM = ("uniform_random_batch_size_like",
                "gaussian_random_batch_size_like",
                "truncated_gaussian_random", "sampling_id")
DENSE_DRAWS = 1 << 16
# fluid's tests/book/test_word2vec.py: EMBED_SIZE 32, HIDDEN_SIZE 256,
# N 5, over paddle_tpu.dataset.imikolov.build_dict()'s 2074 words
# (the config's own batch of 32 and SGD at 0.001)
W2V_BOOK = dict(vocab=2074, emb=32, hidden=256, batch=32)
# tests/book/test_recommender_system.py's model at MovieLens-1M's id
# ranges and the widths of the Paddle book's chapter 5
REC_BOOK = dict(users=6040, movies=3952, jobs=21, ages=7, categories=18,
                titles=5175, emb=32, small_emb=16, user_fc=32, small_fc=16,
                fused=200, batch=256, max_categories=6, max_title=15,
                learning_rate=0.2)
BOOK_STEPS = 8
# step-1 gradients of the book models against float64 autograd: the
# relative norm of each parameter's error
BOOK_GRAD_REL_TOL = 1e-5


def _dense_array(seed, *shape, kind="normal"):
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.rand(*shape).astype(np.float32)
    if kind == "bits":
        return rng.randint(0, 2, shape).astype(np.float32)
    if kind == "ties":
        return rng.randint(0, 3, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _dense_cases():
    """(label, op, inputs {slot: [(name, array or (array, lod))]}, outputs
    {slot: [name]}, attrs, differentiated input names, the output the
    loss reads): every new op at the op-contract suite's small shapes,
    its edges, and the shapes the two book models give it."""
    a = _dense_array
    lod_x = (a(2, 5, 4), [[0, 2, 5]])
    ties = a(27, 4, 6, kind="ties")
    w2v, rec = W2V_BOOK, REC_BOOK
    embs = [("e%d" % i, a(40 + i, w2v["batch"], w2v["emb"]))
            for i in range(4)]
    usr = a(50, rec["batch"], rec["fused"])
    mov = a(51, rec["batch"], rec["fused"])
    rank = np.array([[80.0], [-3.0], [0.5], [84.0]], np.float32)
    return [
        ("fill", "fill", {}, {"Out": ["o"]},
         {"shape": [2, 3], "value": [0.5, -1.0, 2.0, 3.5, 0.0, 1.25],
          "dtype": "float32"}, (), None),
        ("fill_zeros_like", "fill_zeros_like", {"X": [("x", lod_x)]},
         {"Out": ["o"]}, {}, (), None),
        ("shape", "shape", {"Input": [("x", a(1, 2, 3, 4))]},
         {"Out": ["o"]}, {}, (), None),
        ("squeeze", "squeeze", {"X": [("x", a(3, 2, 1, 3, 1))]},
         {"Out": ["o"]}, {"axes": []}, ("x",), None),
        ("unsqueeze", "unsqueeze", {"X": [("x", a(5, 2, 3))]},
         {"Out": ["o"]}, {"axes": [0, 2]}, ("x",), None),
        ("transpose", "transpose", {"X": [("x", a(1, 2, 3, 4))]},
         {"Out": ["o"]}, {"axis": [2, 0, 1]}, ("x",), None),
        ("transpose_heads", "transpose",
         {"X": [("x", a(6, 8, 1024, 12, 64))]}, {"Out": ["o"]},
         {"axis": [0, 2, 1, 3]}, ("x",), None),
        ("expand", "expand", {"X": [("x", a(6, 2, 3))]}, {"Out": ["o"]},
         {"expand_times": [2, 1, 2]}, ("x",), None),
        ("concat", "concat",
         {"X": [("a", a(8, 2, 3)), ("b", a(9, 2, 4)), ("c", a(10, 2, 1))]},
         {"Out": ["o"]}, {"axis": 1}, ("a", "b", "c"), None),
        ("concat_lod", "concat",
         {"X": [("a", lod_x), ("b", (a(11, 5, 2), [[0, 2, 5]]))]},
         {"Out": ["o"]}, {"axis": 1}, ("a", "b"), None),
        ("concat_word2vec", "concat", {"X": embs}, {"Out": ["o"]},
         {"axis": 1}, tuple(n for n, _ in embs), None),
        ("concat_recommender", "concat",
         {"X": [("u", a(52, rec["batch"], rec["user_fc"])),
                ("g", a(53, rec["batch"], rec["small_fc"])),
                ("ag", a(54, rec["batch"], rec["small_fc"])),
                ("j", a(55, rec["batch"], rec["small_fc"]))]},
         {"Out": ["o"]}, {"axis": 1}, ("u", "g", "ag", "j"), None),
        ("split_num", "split", {"X": [("x", a(13, 2, 6))]},
         {"Out": ["o0", "o1"]}, {"axis": 1, "num": 2, "sections": []},
         ("x",), "o1"),
        ("split_sections", "split", {"X": [("x", a(14, 2, 6))]},
         {"Out": ["o0", "o1", "o2"]},
         {"axis": 1, "num": 0, "sections": [1, 2, 3]}, ("x",), "o2"),
        ("scatter", "scatter",
         {"X": [("x", a(17, 5, 3))],
          "Ids": [("i", np.array([[0], [-1], [2]], np.int64))],
          "Updates": [("u", a(18, 3, 3))]}, {"Out": ["o"]}, {},
         ("x", "u"), None),
        ("one_hot", "one_hot",
         {"X": [("x", np.array([[0], [3], [-1], [4], [2], [-4]],
                               np.int64))]},
         {"Out": ["o"]}, {"depth": 4}, (), None),
        ("pad", "pad", {"X": [("x", a(19, 2, 3))]}, {"Out": ["o"]},
         {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ("x",), None),
        ("slice", "slice", {"Input": [("x", a(20, 4, 5, 6))]},
         {"Out": ["o"]}, {"axes": [1, 2], "starts": [-3, 1],
                          "ends": [10, -1]}, ("x",), None),
        ("slice_lod", "slice", {"Input": [("x", lod_x)]}, {"Out": ["o"]},
         {"axes": [1], "starts": [1], "ends": [3]}, ("x",), None),
        ("crop", "crop",
         {"X": [("x", a(22, 4, 5))],
          "Y": [("y", np.zeros((3, 2), np.float32))]},
         {"Out": ["o"]}, {"offsets": [0, 3], "shape": [1, 1]}, ("x",),
         None),
        ("reverse", "reverse", {"X": [("x", a(23, 3, 4))]}, {"Out": ["o"]},
         {"axis": [0, 1]}, ("x",), None),
        ("is_empty", "is_empty", {"X": [("x", a(24, 2, 3))]},
         {"Out": ["o"]}, {}, (), None),
        ("arg_max", "arg_max", {"X": [("x", ties)]}, {"Out": ["o"]},
         {"axis": 1}, (), None),
        ("arg_min", "arg_min", {"X": [("x", ties)]}, {"Out": ["o"]},
         {"axis": 0}, (), None),
        ("argsort", "argsort", {"X": [("x", a(28, 3, 5000, kind="ties"))]},
         {"Out": ["o"], "Indices": ["i"]}, {"axis": -1}, (), None),
        ("maximum", "maximum", {"X": [("x", ties)], "Y": [("y", ties.T.copy()
                                                              .reshape(4, 6))]},
         {"Out": ["o"]}, {}, ("x", "y"), None),
        ("norm", "norm", {"X": [("x", a(30, 3, 4))]},
         {"Norm": ["n"], "Out": ["o"]}, {"axis": 1, "epsilon": 1e-10},
         ("x",), "o"),
        ("isfinite", "isfinite",
         {"X": [("x", a(31, 3, 4)),
                ("y", np.array([1.0, np.inf], np.float32))]},
         {"Out": ["o"]}, {}, (), None),
        ("matmul_ty_alpha", "matmul",
         {"X": [("x", a(33, 2, 3, 4, 5))], "Y": [("y", a(34, 2, 3, 6, 5))]},
         {"Out": ["o"]}, {"transpose_X": False, "transpose_Y": True,
                          "alpha": 0.125}, ("x", "y"), None),
        ("matmul_bcast", "matmul",
         {"X": [("x", a(35, 3, 4, 5))], "Y": [("y", a(36, 2, 1, 5, 6))]},
         {"Out": ["o"]}, {"transpose_X": False, "transpose_Y": False,
                          "alpha": 2.0}, ("x", "y"), None),
        ("matmul_vec", "matmul",
         {"X": [("x", a(37, 5))], "Y": [("y", a(38, 5, 6))]},
         {"Out": ["o"]}, {"transpose_X": False, "transpose_Y": False,
                          "alpha": 1.0}, ("x", "y"), None),
        ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
         {"X": [("x", a(60, 4, 5))],
          "Label": [("l", a(61, 4, 5, kind="uniform"))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("squared_l2_distance", "squared_l2_distance",
         {"X": [("x", a(62, 4, 5))], "Y": [("y", a(63, 1, 5))]},
         {"sub_result": ["s"], "Out": ["o"]}, {}, ("x", "y"), "o"),
        ("label_smooth", "label_smooth",
         {"X": [("x", a(64, 4, 5, kind="bits"))],
          "PriorDist": [("p", a(65, 1, 5, kind="uniform"))]},
         {"Out": ["o"]}, {"epsilon": 0.2}, ("x", "p"), None),
        ("l1_norm", "l1_norm", {"X": [("x", a(66, 4, 5))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("modified_huber_loss", "modified_huber_loss",
         {"X": [("x", a(67, 8, 1) * 2)], "Y": [("y", a(68, 8, 1,
                                                       kind="bits"))]},
         {"IntermediateVal": ["v"], "Out": ["o"]}, {}, ("x",), "o"),
        ("hinge_loss", "hinge_loss",
         {"Logits": [("x", a(69, 6, 1))],
          "Labels": [("y", a(70, 6, 1, kind="bits"))]},
         {"Loss": ["o"]}, {}, ("x",), None),
        ("huber_loss", "huber_loss",
         {"X": [("x", a(71, 6, 3) * 2)], "Y": [("y", a(72, 6, 3))]},
         {"Residual": ["r"], "Out": ["o"]}, {"delta": 1.0}, ("x", "y"),
         "o"),
        ("smooth_l1_loss", "smooth_l1_loss",
         {"X": [("x", a(73, 4, 2, 3))], "Y": [("y", a(74, 4, 2, 3))],
          "InsideWeight": [("iw", a(75, 4, 2, 3, kind="uniform"))],
          "OutsideWeight": [("ow", a(76, 4, 2, 3, kind="uniform"))]},
         {"Diff": ["d"], "Out": ["o"]}, {"sigma": 2.0}, ("x", "y"), "o"),
        ("log_loss", "log_loss",
         {"Predicted": [("p", a(77, 6, 1, kind="uniform") * 0.9 + 0.05)],
          "Labels": [("y", a(78, 6, 1, kind="bits"))]},
         {"Loss": ["o"]}, {"epsilon": 1e-4}, ("p",), None),
        ("rank_loss", "rank_loss",
         {"Label": [("l", a(79, 4, 1, kind="bits"))],
          "Left": [("x", rank)], "Right": [("y", np.zeros_like(rank))]},
         {"Out": ["o"]}, {}, ("x", "y"), None),
        ("margin_rank_loss", "margin_rank_loss",
         {"Label": [("l", np.array([[1], [-1], [1], [-1]], np.float32))],
          "X1": [("x", a(80, 4, 1))], "X2": [("y", a(81, 4, 1))]},
         {"Out": ["o"], "Activated": ["act"]}, {"margin": 0.1},
         ("x", "y"), "o"),
        ("cos_sim", "cos_sim",
         {"X": [("x", a(82, 4, 5))], "Y": [("y", a(83, 1, 5))]},
         {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {}, ("x", "y"),
         "o"),
        ("cos_sim_recommender", "cos_sim",
         {"X": [("x", usr)], "Y": [("y", mov)]},
         {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {}, ("x", "y"),
         "o"),
    ]


def _dense_program(op_type, inputs, outputs, attrs, diff=(), loss_of=None,
                   loss_w=None):
    """``op_type`` alone in a program; with ``diff``, the backward of
    mean(``loss_of`` * w) appended (w fed as ``loss_w``)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.backward import append_backward
    main = ir.Program()
    with unique_name.guard(), ir.program_guard(main, ir.Program()):
        blk = main.global_block()
        ins = {}
        for slot, items in inputs.items():
            ins[slot] = []
            for name, v in items:
                arr = v[0] if isinstance(v, tuple) else v
                var = blk.create_var(name=name, shape=arr.shape,
                                     dtype=str(arr.dtype),
                                     lod_level=len(v[1]) if isinstance(
                                         v, tuple) else 0)
                var.stop_gradient = name not in diff
                ins[slot].append(name)
        for names in outputs.values():
            for n in names:
                blk.create_var(name=n, dtype=None)
        blk.append_op(type=op_type, inputs=ins, outputs=dict(outputs),
                      attrs=dict(attrs))
        if diff:
            w = blk.create_var(name="loss_w", shape=loss_w.shape,
                               dtype="float32")
            w.stop_gradient = True
            append_backward(layers.mean(layers.elementwise_mul(
                blk.var(loss_of), w)))
    return main


def _dense_feed(inputs, loss_w=None):
    from paddle_tpu_torch.core.lod import LoDTensor
    feed = {n: (LoDTensor(v[0], v[1]) if isinstance(v, tuple) else v)
            for items in inputs.values() for n, v in items}
    if loss_w is not None:
        feed["loss_w"] = loss_w
    return feed


def _fetched(v):
    return np.asarray(v.numpy()) if hasattr(v, "lod") and \
        not isinstance(v, np.ndarray) else np.asarray(v)


def _dense_compare(label, op, names, card, cpu, exact, tol=DENSE_OP_TOL,
                   what="dense op"):
    """Largest errors of the card's fetches against the CPU's; fails on
    a shape, dtype, LoD, inf or NaN mismatch, an exact output that
    differs, or a float one past ``tol``."""
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for i, (n, g, w) in enumerate(zip(names, card, cpu)):
        lg = g.lod() if hasattr(g, "lod") and not isinstance(
            g, np.ndarray) else None
        lw = w.lod() if hasattr(w, "lod") and not isinstance(
            w, np.ndarray) else None
        g, w = _fetched(g), _fetched(w)
        if lg != lw or g.shape != w.shape or g.dtype != w.dtype:
            fail("%s %s (%s) output %s: card %s %s lod %s, CPU %s %s "
                 "lod %s" % (what, op, label, n, g.shape, g.dtype, lg,
                             w.shape, w.dtype, lw))
        is_grad = n.endswith("@GRAD")
        if not np.issubdtype(w.dtype, np.floating) or (exact and not is_grad):
            if not np.array_equal(g, w, equal_nan=np.issubdtype(
                    w.dtype, np.floating)):
                fail("%s %s (%s) output %s is not bit-identical to "
                     "the CPU's" % (what, op, label, n))
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if not (np.array_equal(np.isnan(g64), np.isnan(w64))
                and np.array_equal(g64[np.isinf(g64)], w64[np.isinf(w64)])
                and np.array_equal(np.isinf(g64), np.isinf(w64))):
            fail("%s %s (%s) output %s: inf / NaN places differ from "
                 "the CPU's" % (what, op, label, n))
        fin = np.isfinite(w64)
        if not fin.any():
            continue
        err = float(np.abs(g64[fin] - w64[fin]).max())
        rel = err / max(1.0, float(np.abs(w64[fin]).max()))
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_err"] = max(worst["max_rel_err"], rel)
        if not rel <= tol:
            fail("%s %s (%s) output %s differs from the CPU's by %g "
                 "of max(1, |value|) > %g" % (what, op, label, n, rel, tol))
    return worst


def _dense_random_check(dev):
    """The random ops on the card and the CPU: shapes, bounds, and the
    mean and variance of DENSE_DRAWS draws within 5 standard errors of
    the law's (the devices' generators differ: distribution only)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    n = DENSE_DRAWS
    trunc_var = 1.0 - 4.0 * math.exp(-2.0) / (
        math.sqrt(2 * math.pi) * math.erf(2.0 / math.sqrt(2.0)))
    cases = [
        ("uniform_random_batch_size_like",
         {"Input": [("ref", np.zeros((n // 4, 3), np.float32))]},
         {"shape": [-1, 4], "min": -2.0, "max": 3.0},
         (0.5, 25.0 / 12.0, -2.0, 3.0)),
        ("gaussian_random_batch_size_like",
         {"Input": [("ref", np.zeros((n // 4, 3), np.float32))]},
         {"shape": [-1, 4], "mean": 1.5, "std": 0.5},
         (1.5, 0.25, None, None)),
        ("truncated_gaussian_random", {},
         {"shape": [n // 16, 16], "mean": 1.0, "std": 2.0},
         (1.0, 4.0 * trunc_var, -3.0, 5.0)),
    ]
    out = {}
    for op, inputs, attrs, (mean, var, lo, hi) in cases:
        main = _dense_program(op, inputs, {"Out": ["o"]}, attrs)
        main.random_seed = 11
        rec = {}
        for d in (dev, torch.device("cpu")):
            v = Executor(d).run(main, feed=_dense_feed(inputs),
                                fetch_list=["o"], scope=Scope(),
                                use_jit=False)[0].astype(np.float64)
            if v.size != n or (lo is not None and (v.min() < lo
                                                   or v.max() > hi)):
                fail("%s on %s: %d draws in [%g, %g]" % (
                    op, d, v.size, v.min(), v.max()))
            z_mean = abs(v.mean() - mean) / math.sqrt(var / n)
            z_var = abs(v.var() - var) / math.sqrt(2 * var * var / n)
            if not (z_mean <= 5 and z_var <= 5):
                fail("%s on %s: mean %g, variance %g, against %g and %g "
                     "(%g and %g standard errors)" % (
                         op, d, v.mean(), v.var(), mean, var, z_mean,
                         z_var))
            rec[d.type] = {"mean": float(v.mean()), "var": float(v.var()),
                           "z_mean": z_mean, "z_var": z_var}
        out[op] = rec
    weights = np.tile(np.array([[1.0, 2.0, 5.0]], np.float32), (n, 1))
    p = np.array([1.0, 2.0, 5.0]) / 8.0
    hot = np.eye(5, dtype=np.float32)[[3, 0, 4, 1]]
    rec = {}
    for d in (dev, torch.device("cpu")):
        for x, check in ((hot, "hot"), (weights, "weights")):
            inputs = {"X": [("x", x)]}
            main = _dense_program("sampling_id", inputs, {"Out": ["o"]}, {})
            ids = Executor(d).run(main, feed=_dense_feed(inputs),
                                  fetch_list=["o"], scope=Scope(),
                                  use_jit=False)[0]
            if check == "hot":
                if ids.tolist() != [3, 0, 4, 1]:
                    fail("sampling_id on %s of one-hot rows gave %s"
                         % (d, ids.tolist()))
                continue
            share = np.bincount(ids, minlength=3) / n
            z = np.abs(share - p) / np.sqrt(p * (1 - p) / n)
            if ids.dtype != np.int64 or not (z <= 5).all():
                fail("sampling_id on %s: shares %s against %s" % (
                    d, share.tolist(), p.tolist()))
            rec[d.type] = {"shares": share.tolist(), "z": z.tolist()}
    out["sampling_id"] = rec
    return out


def _dense_ops_check(dev):
    """Every case of :func:`_dense_cases` (its op and, where it has
    differentiated inputs, their grads) on the card and on the CPU on the
    same inputs, per op: the largest error, by op."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    per_op = collections.OrderedDict()
    cpu = torch.device("cpu")
    for label, op, inputs, outputs, attrs, diff, loss_of in _dense_cases():
        fetch = [n for ns in outputs.values() for n in ns]
        loss_w = None
        if diff:
            loss_of = loss_of or fetch[0]
            probe = _dense_program(op, inputs, outputs, attrs)
            shape = np.shape(_fetched(Executor(cpu).run(
                probe, feed=_dense_feed(inputs), fetch_list=[loss_of],
                scope=Scope(), use_jit=False)[0]))
            loss_w = np.asarray(np.random.RandomState(7).randn(*shape),
                                np.float32)
            fetch = fetch + [n + "@GRAD" for n in diff]
        main = _dense_program(op, inputs, outputs, attrs, diff, loss_of,
                              loss_w)
        got = {}
        for d in (dev, cpu):
            got[d.type] = Executor(d).run(
                main, feed=_dense_feed(inputs, loss_w), fetch_list=fetch,
                scope=Scope(), use_jit=False, return_numpy=True)
        worst = _dense_compare(label, op, fetch, got[dev.type], got["cpu"],
                               op in DENSE_EXACT)
        types_ = [o.type for o in main.global_block().ops]
        rec = per_op.setdefault(op, {"cases": 0, "max_abs_err": 0.0,
                                     "max_rel_err": 0.0, "grad": None,
                                     "bit_identical": op in DENSE_EXACT})
        rec["cases"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], worst["max_abs_err"])
        rec["max_rel_err"] = max(rec["max_rel_err"], worst["max_rel_err"])
        if diff:
            kind = "matmul_grad" if "matmul_grad" in types_ \
                else "generic_grad"
            rec["grad"] = sorted(set(rec["grad"] or []) | {kind})
            if kind == "matmul_grad":
                g = per_op.setdefault("matmul_grad", {
                    "cases": 0, "max_abs_err": 0.0, "max_rel_err": 0.0,
                    "grad": None, "bit_identical": False})
                g["cases"] += 1
                g["max_abs_err"] = max(g["max_abs_err"],
                                       worst["max_abs_err"])
                g["max_rel_err"] = max(g["max_rel_err"],
                                       worst["max_rel_err"])
    # range is a host op: a program of its own, on the hybrid path
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import ir
    main, start = ir.Program(), ir.Program()
    with ir.program_guard(main, start):
        bounds = [layers.fill_constant([1], "float32", v)
                  for v in (2.0, 11.0, 3.0)]
        r = main.global_block().create_var(name="r", dtype=None)
        main.global_block().append_op(
            type="range", inputs={"Start": [bounds[0]], "End": [bounds[1]],
                                  "Step": [bounds[2]]},
            outputs={"Out": [r]})
    got = {}
    for d in (dev, cpu):
        exe = Executor(d)
        got[d.type] = exe.run(main, fetch_list=["r"], scope=Scope())
        if exe.stats["hybrid_runs"] != 1:
            fail("range on %s did not run on the hybrid path: %s"
                 % (d, exe.stats))
    _dense_compare("hybrid", "range", ["r"], got[dev.type], got["cpu"], True)
    if got["cpu"][0].tolist() != [2, 5, 8]:
        fail("range gave %s" % got["cpu"][0].tolist())
    per_op["range"] = {"cases": 1, "max_abs_err": 0.0, "max_rel_err": 0.0,
                       "grad": None, "bit_identical": True}
    return per_op


def _op_fn(op_type, in_slots, out_slots, attrs, dev, pure=None):
    """The lowering of ``op_type`` as a function of tensors on ``dev``
    (``run(slot=tensor, ...) -> [output tensors]``), its program marked
    for AMP when ``pure`` is not None."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import ir, registry
    from paddle_tpu_torch.core.executor import FunctionalContext
    main = ir.Program()
    blk = main.global_block()
    ins = {s: [blk.create_var(name="in_" + s).name] for s in in_slots}
    outs = {s: [blk.create_var(name="out_" + s).name] for s in out_slots}
    op = blk.append_op(type=op_type, inputs=ins, outputs=outs,
                       attrs=dict(attrs))
    if pure is not None:
        amp.enable(main, pure=pure)
    lower = registry.lookup_checked(op_type).lower

    def run(**vals):
        ctx = FunctionalContext(op, {s: [vals[s]] for s in in_slots},
                                dict(op.attrs), dev, type=op_type)
        lower(ctx)
        return [ctx.collected[s][0] for s in out_slots]
    return run


def _mm_err(got, want, bf16):
    """(relative error, gate): the largest error over the largest
    magnitude of ``want``; a bfloat16 output's gate is one bfloat16 ulp
    of that magnitude plus 2e-5 of it."""
    m = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    gate = (_bf16_ulp(m) + 2e-5 * m) if bf16 else DENSE_MM_TOL * m
    return err / m, gate / m


def _dense_matmul(dev):
    """``matmul`` and ``matmul_grad`` at GPT-2 small's attention shapes,
    float32 and pure AMP, against float64 on the card, timed."""
    B, H, S, D = DENSE_MM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    q, k, v = rand(B, H, S, D), rand(B, H, S, D), rand(B, H, S, D)
    ds, do = rand(B, H, S, S), rand(B, H, S, D)
    w2 = rand(D, S)
    alpha = 1.0 / math.sqrt(D)
    for mode, pure in (("float32", None), ("pure_amp", True)):
        cast = (lambda t: t.to(torch.bfloat16)) if pure else (lambda t: t)
        bf16 = pure is not None
        qk, qk_grad = _mm_fns(dev, pure, transpose_Y=True, alpha=alpha)
        sv, sv_grad = _mm_fns(dev, pure)
        xq, xk, xv, xds, xdo = (cast(t) for t in (q, k, v, ds, do))
        s, = qk(X=xq, Y=xk)
        o, = sv(X=s, Y=xv)
        dq, dk = qk_grad(X=xq, Y=xk, **{"Out@GRAD": xds})
        dsv, dv = sv_grad(X=s, Y=xv, **{"Out@GRAD": xdo})
        q64, k64, v64, s64 = (t.double() for t in (xq, xk, xv, s))
        ds64, do64 = xds.double(), xdo.double()
        refs = {
            "qk": (s, torch.matmul(q64, k64.transpose(-1, -2)) * alpha),
            "sv": (o, torch.matmul(s64, v64)),
            "qk_grad_dx": (dq, torch.matmul(ds64, k64) * alpha),
            "qk_grad_dy": (dk, torch.matmul(ds64.transpose(-1, -2), q64)
                           * alpha),
            "sv_grad_dx": (dsv, torch.matmul(do64, v64.transpose(-1, -2))),
            "sv_grad_dy": (dv, torch.matmul(s64.transpose(-1, -2), do64)),
        }
        errs = {}
        for name, (got, want) in refs.items():
            if (got.dtype == torch.bfloat16) != bf16:
                fail("matmul %s %s came out %s" % (mode, name, got.dtype))
            errs[name] = _mm_err(got, want, bf16)
        ms = {
            "qk": time_ms(lambda: qk(X=xq, Y=xk)),
            "sv": time_ms(lambda: sv(X=s, Y=xv)),
            "qk_grad": time_ms(lambda: qk_grad(X=xq, Y=xk,
                                               **{"Out@GRAD": xds})),
            "sv_grad": time_ms(lambda: sv_grad(X=s, Y=xv,
                                               **{"Out@GRAD": xdo})),
        }
        rows.append({"mode": mode, "shape": list(DENSE_MM_SHAPE),
                     "rel_err": {n: e for n, (e, _) in errs.items()},
                     "gate": {n: g for n, (_, g) in errs.items()},
                     "ms": ms})
        for name, (e, g) in errs.items():
            if not e <= g:
                fail("matmul %s %s: error %g of the largest magnitude > "
                     "%g against float64" % (mode, name, e, g))
        del s, o, dq, dk, dsv, dv, refs
        torch.cuda.empty_cache()
    # Y of one [64, 1024] matrix broadcast over the 8 x 12 batch
    bc, bc_grad = _mm_fns(dev, None)
    out, = bc(X=q, Y=w2)
    dout = rand(B, H, S, S)
    dx, dw = bc_grad(X=q, Y=w2, **{"Out@GRAD": dout})
    q64, w64, d64 = q.double(), w2.double(), dout.double()
    errs = {"bcast": _mm_err(out, torch.matmul(q64, w64), False),
            "bcast_grad_dx": _mm_err(dx, torch.matmul(
                d64, w64.transpose(-1, -2)), False),
            "bcast_grad_dy": _mm_err(dw, torch.matmul(
                q64.transpose(-1, -2), d64).sum(dim=(0, 1)), False)}
    if tuple(dw.shape) != (D, S):
        fail("broadcast matmul_grad dY has shape %s" % (tuple(dw.shape),))
    rows.append({"mode": "float32", "shape": [list(q.shape),
                                              list(w2.shape)],
                 "rel_err": {n: e for n, (e, _) in errs.items()},
                 "gate": {n: g for n, (_, g) in errs.items()},
                 "ms": {"bcast": time_ms(lambda: bc(X=q, Y=w2)),
                        "bcast_grad": time_ms(lambda: bc_grad(
                            X=q, Y=w2, **{"Out@GRAD": dout}))}})
    for name, (e, g) in errs.items():
        if not e <= g:
            fail("matmul %s: error %g of the largest magnitude > %g "
                 "against float64" % (name, e, g))
    del q, k, v, ds, do, dout, out, dx, dw
    torch.cuda.empty_cache()
    return rows


def _mm_fns(dev, pure, **extra):
    """``matmul`` and ``matmul_grad`` under the attrs ``extra`` sets, as
    functions of tensors (:func:`_op_fn`)."""
    attrs = dict({"transpose_X": False, "transpose_Y": False,
                  "alpha": 1.0}, **extra)
    return (_op_fn("matmul", ("X", "Y"), ("Out",), attrs, dev, pure),
            _op_fn("matmul_grad", ("X", "Y", "Out@GRAD"),
                   ("X@GRAD", "Y@GRAD"), attrs, dev, pure))


def _rec_model(w):
    """``tests/book/test_recommender_system.py``'s model (the titles and
    categories pooled by ``sequence_pool(sum)``, as there) at the widths
    ``w``: embeddings of ``emb`` for user, movie, category and title and
    of ``small_emb`` for gender, age and job; fcs of ``user_fc`` (user),
    ``small_fc`` (gender, age, job) and ``emb`` (movie); both fused fcs
    ``fused`` wide with tanh; ``cos_sim``, ``scale`` 5,
    ``square_error_cost``, SGD."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import optimizer

    def ids(name, lod_level=0):
        return L.data(name=name, shape=[1], dtype="int64",
                      lod_level=lod_level)

    def emb_fc(v, rows, width, size):
        return L.fc(input=L.embedding(input=v, size=[rows, width]),
                    size=size)

    uid, gender, age, job = (ids(n) for n in ("user_id", "gender_id",
                                               "age_id", "job_id"))
    usr = L.fc(input=L.concat(input=[
        emb_fc(uid, w["users"] + 1, w["emb"], w["user_fc"]),
        emb_fc(gender, 2, w["small_emb"], w["small_fc"]),
        emb_fc(age, w["ages"], w["small_emb"], w["small_fc"]),
        emb_fc(job, w["jobs"], w["small_emb"], w["small_fc"])], axis=1),
        size=w["fused"], act="tanh")
    mov_id = ids("movie_id")
    mov_fc = emb_fc(mov_id, w["movies"] + 1, w["emb"], w["emb"])
    category = ids("category_id", lod_level=1)
    mov_cat = L.sequence_pool(input=L.embedding(
        input=category, size=[w["categories"], w["emb"]]), pool_type="sum")
    title = ids("title_ids", lod_level=1)
    title_pool = L.sequence_pool(input=L.embedding(
        input=title, size=[w["titles"], w["emb"]]), pool_type="sum")
    mov = L.fc(input=L.concat(input=[mov_fc, mov_cat, title_pool], axis=1),
               size=w["fused"], act="tanh")
    scale_infer = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
    label = L.data(name="score", shape=[1], dtype="float32")
    cost = L.mean(L.square_error_cost(input=scale_infer, label=label))
    return {"cost": cost,
            "feed_list": [uid, gender, age, job, mov_id, category, title,
                          label],
            "optimizer": optimizer.SGD(learning_rate=w["learning_rate"])}


def _rec_batch(w, seed=0):
    """One fixed batch of ``w["batch"]`` MovieLens-1M-shaped rows from a
    seed: ids in the corpus' ranges, 1 to ``max_categories`` distinct
    categories and 1 to ``max_title`` title words a row, scores 1-5."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(w["batch"]):
        cats = sorted(rng.choice(w["categories"], rng.randint(
            1, w["max_categories"] + 1), replace=False).tolist())
        title = rng.randint(0, w["titles"], rng.randint(
            1, w["max_title"] + 1)).tolist()
        rows.append((int(rng.randint(1, w["users"] + 1)),
                     int(rng.randint(0, 2)), int(rng.randint(0, w["ages"])),
                     int(rng.randint(0, w["jobs"])),
                     int(rng.randint(1, w["movies"] + 1)), cats, title,
                     np.array([float(rng.randint(1, 6))], np.float32)))
    return rows


def _book_param_shapes(kind, w):
    """The parameters of ``kind`` at the widths ``w``, by name in the
    order the layers create them: {name: shape}."""
    if kind == "word2vec":
        return {"shared_w": (w["vocab"], w["emb"]),
                "fc_0.w_0": (4 * w["emb"], w["hidden"]),
                "fc_0.b_0": (w["hidden"],),
                "fc_1.w_0": (w["hidden"], w["vocab"]),
                "fc_1.b_0": (w["vocab"],)}
    e, s = w["emb"], w["small_emb"]
    # (rows, width) of embedding_i; (in, out) of fc_i
    tables = [(w["users"] + 1, e), (2, s), (w["ages"], s), (w["jobs"], s),
              (w["movies"] + 1, e), (w["categories"], e), (w["titles"], e)]
    fcs = [(e, w["user_fc"]), (s, w["small_fc"]), (s, w["small_fc"]),
           (s, w["small_fc"]), (w["user_fc"] + 3 * w["small_fc"], w["fused"]),
           (e, e), (3 * e, w["fused"])]
    shapes = {"embedding_%d.w_0" % i: t for i, t in enumerate(tables)}
    for i, (n_in, n_out) in enumerate(fcs):
        shapes["fc_%d.w_0" % i] = (n_in, n_out)
        shapes["fc_%d.b_0" % i] = (n_out,)
    return shapes


def _feed_ids(feed, name):
    v = feed[name]
    return (v.data if hasattr(v, "lod") else v).reshape(-1).long()


def _plain_w2v_loss(p, feed):
    """The word2vec N-gram model written out in torch from its
    parameters ``p``: the four context words looked up in one table,
    concatenated, fc + sigmoid, fc + softmax, the mean cross entropy
    against the next word."""
    w = p["shared_w"]
    emb = torch.cat([w[_feed_ids(feed, "w%d" % i)] for i in range(4)], 1)
    h = torch.sigmoid(emb @ p["fc_0.w_0"] + p["fc_0.b_0"])
    prob = torch.softmax(h @ p["fc_1.w_0"] + p["fc_1.b_0"], dim=1)
    label = _feed_ids(feed, "next_word").reshape(-1, 1)
    return -torch.log(prob.gather(1, label)).mean()


def _plain_rec_loss(p, feed):
    """``tests/book/test_recommender_system.py``'s model written out in
    torch from its parameters ``p``: each id's embedding through a
    linear fc, the user's four and the movie's id fc with the summed
    category and title embeddings concatenated, each through an fc with
    tanh; 5 x their cosine against the score, the mean squared error."""
    def fc(x, i):
        return x @ p["fc_%d.w_0" % i] + p["fc_%d.b_0" % i]

    def look(i, name):
        return p["embedding_%d.w_0" % i][_feed_ids(feed, name)]

    def sum_pool(i, name):
        rows = look(i, name)
        offs = feed[name].lod[0].to(rows.device).long()
        seg = torch.repeat_interleave(
            torch.arange(offs.numel() - 1, device=rows.device),
            offs[1:] - offs[:-1])
        return torch.zeros((offs.numel() - 1, rows.shape[1]),
                           dtype=rows.dtype, device=rows.device) \
            .index_add(0, seg, rows)

    usr = torch.tanh(fc(torch.cat([
        fc(look(0, "user_id"), 0), fc(look(1, "gender_id"), 1),
        fc(look(2, "age_id"), 2), fc(look(3, "job_id"), 3)], 1), 4))
    mov = torch.tanh(fc(torch.cat([
        fc(look(4, "movie_id"), 5), sum_pool(5, "category_id"),
        sum_pool(6, "title_ids")], 1), 6))
    cos = (usr * mov).sum(1, keepdim=True) / (
        usr.norm(dim=1, keepdim=True) * mov.norm(dim=1, keepdim=True)
        + 1e-12)
    score = feed["score"].to(cos.dtype).reshape(-1, 1)
    return ((5.0 * cos - score) ** 2).mean()


def _book_grad_check(trainer, spec, feed, label, kind, width):
    """Step 1 through the Executor, fetching every parameter's @GRAD,
    against float64 torch.autograd of the model written out in torch
    (:func:`_plain_w2v_loss`, :func:`_plain_rec_loss`) on the state the
    step started from; the program's parameters must be that model's,
    at the widths ``width``."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    prog = trainer.main_program
    cost = spec["cost"].name
    params = [p.name for p in prog.all_parameters() if p.trainable]
    shapes = {n: tuple(scope.find_var(n).shape) for n in params}
    want_shapes = _book_param_shapes(kind, width)
    if shapes != want_shapes:
        fail("%s: the program's parameters %s are not the model's %s"
             % (label, shapes, want_shapes))
    start = {n: scope.find_var(n).detach().double().clone()
             .requires_grad_(True) for n in params}
    outs = trainer.exe.run(prog, feed=feed,
                           fetch_list=[cost] + [n + "@GRAD" for n in params],
                           return_numpy=False)
    plain = _plain_w2v_loss if kind == "word2vec" else _plain_rec_loss
    loss = plain(start, feed)
    want = dict(zip(params, torch.autograd.grad(
        loss, [start[n] for n in params])))
    rel = {n: float((g.double() - want[n]).norm() / want[n].norm())
           for n, g in zip(params, outs[1:])}
    worst = max(rel, key=rel.get)
    checks = {"params_checked": len(params),
              "tolerance_rel": BOOK_GRAD_REL_TOL,
              "norm_rel_err": rel[worst], "worst_param": worst,
              "norm_rel_err_median": float(np.median(list(rel.values()))),
              "loss": float(outs[0].reshape(-1)[0]),
              "loss_abs_err": abs(float(outs[0].reshape(-1)[0])
                                  - float(loss.detach()))}
    if "shared_w" in rel:
        checks["shared_w_norm_rel_err"] = rel["shared_w"]
    log(json.dumps({label + "_grad_check": checks}))
    if not rel[worst] <= BOOK_GRAD_REL_TOL:
        fail("%s: step-1 gradient of %s differs from float64 autograd by "
             "%g (relative norm) > %g" % (label, worst, rel[worst],
                                          BOOK_GRAD_REL_TOL))
    return checks


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dense_book(dev, kind):
    """``kind`` ("word2vec" or "recommender") at its book widths: step-1
    gradients against float64 autograd, BOOK_STEPS compiled steps on one
    fixed batch through ``Trainer.train`` (the loss falls; one capture
    and a replay a step), then BOOK_STEPS steps on the per-op path:
    (launch counts of the compiled run, a summary)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.configs import word2vec
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    label = "dense_" + kind
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        if kind == "word2vec":
            spec = word2vec.model(vocab=W2V_BOOK["vocab"],
                                  emb=W2V_BOOK["emb"],
                                  hidden=W2V_BOOK["hidden"])
            batch = next(iter(spec["reader"]()))
            width = W2V_BOOK
            if len(batch) != width["batch"]:
                fail("word2vec: the config's batch is %d, not %d"
                     % (len(batch), width["batch"]))
        else:
            spec = _rec_model(REC_BOOK)
            batch = _rec_batch(REC_BOOK)
            width = REC_BOOK
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=dev)
    names = [p.name for p in main_prog.all_parameters()]
    if kind == "word2vec" and names.count("shared_w") != 1:
        fail("word2vec: %d parameters named shared_w"
             % names.count("shared_w"))
    with scope_guard(Scope()):
        trainer._maybe_init()
        feed = trainer.feeder.feed(batch)
        checks = _book_grad_check(trainer, spec, feed, label, kind,
                                  width)
        losses, step_s, marks = [], [], {}

        def handler(e):
            if isinstance(e, BeginIteration):
                marks["t"] = time.monotonic()
            elif isinstance(e, EndIteration):
                step_s.append(time.monotonic() - marks["t"])
                losses.append(e.cost)

        _sync(dev)
        kernels.reset_launches()
        exe_before = dict(trainer.exe.stats)
        trainer.train(lambda: (batch for _ in range(BOOK_STEPS)),
                      num_passes=1, event_handler=handler)
        launches = kernels.launch_counts()
        delta = _exe_delta(trainer.exe, exe_before)
        _compiled_gate(label, delta, len(losses))
        if len(losses) != BOOK_STEPS or not (
                np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail("%s: the loss did not fall on the fixed batch: %s"
                 % (label, losses))
        eager_s = []
        for _ in range(BOOK_STEPS):
            t0 = time.monotonic()
            trainer.exe.run(main_prog, feed=trainer.feeder.feed(batch),
                            fetch_list=[spec["cost"]], use_jit=False)
            _sync(dev)
            eager_s.append(time.monotonic() - t0)
    p50, ep50 = float(np.median(step_s)), float(np.median(eager_s))
    rec = {"config": {k: v for k, v in width.items()},
           "program_ops": len(main_prog.global_block().ops),
           "grad_check": checks, "losses": losses, "executor": delta,
           "step_ms_compiled": [t * 1e3 for t in step_s],
           "step_ms_p50_compiled": p50 * 1e3,
           "step_ms_p50_eager": ep50 * 1e3,
           "samples_per_s_compiled": width["batch"] / p50,
           "samples_per_s_eager": width["batch"] / ep50,
           "launches": {k: v for k, v in launches.items() if v}}
    log(json.dumps({label: rec}))
    log("%s_train_samples_per_sec %.3f compiled, %.3f eager (batch %d, "
        "step p50 %.3f / %.3f ms)" % (
            label, width["batch"] / p50, width["batch"] / ep50,
            width["batch"], p50 * 1e3, ep50 * 1e3))
    trainer.exe.close()
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rec


def _dense_cli(root):
    """``python -m paddle_tpu_torch train`` of the word2vec config (its
    own widths and reader), on the card by default: exit 0."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "word2vec.py")],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=root))
    rec = {"rc": out.returncode, "seconds": time.monotonic() - t0,
           "last_line": (out.stdout.strip().splitlines() or [""])[-1]}
    if out.returncode != 0:
        fail("phase 17: train word2vec.py exited %d:\n%s\n%s"
             % (out.returncode, out.stdout[-3000:], out.stderr[-3000:]))
    return rec


def phase_dense(dev, root):
    """Phase 17: the dense tensor and loss ops and their grads on the
    card against the CPU, ``matmul`` at GPT-2 small's attention shapes
    against float64, and the word2vec and recommender book models.
    Returns {path: launches}."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    t0 = time.monotonic()
    old_dir = FLAGS.tune_cache_dir
    FLAGS.tune_cache_dir = _fresh_dir(os.path.join(
        root, "build", "chip_smoke", "tune_dense"))
    tune.clear_memory_cache()
    try:
        per_op = _dense_ops_check(dev)
        log(json.dumps({"dense_ops": per_op}))
        log(json.dumps({"dense_random": _dense_random_check(dev)}))
        log(json.dumps({"dense_matmul": _dense_matmul(dev)}))
        paths, books = {}, {}
        for kind in ("word2vec", "recommender"):
            paths["dense_" + kind], books[kind] = _dense_book(dev, kind)
        log(json.dumps({"dense_cli_word2vec": _dense_cli(root)}))
    finally:
        FLAGS.tune_cache_dir = old_dir
        tune.clear_memory_cache()
    log(json.dumps({"dense_wall_s": time.monotonic() - t0,
                    "word2vec_step_ms_p50": books["word2vec"][
                        "step_ms_p50_compiled"],
                    "recommender_step_ms_p50": books["recommender"][
                        "step_ms_p50_compiled"],
                    "card": card_line()}))
    return paths


# -- phase 18 ------------------------------------------------------------------

# card against CPU for the conv-net slice's ops: float outputs within this
# of max(1, |CPU value|) (convolutions, pools, norms and the AUC's sums in
# other orders and libraries); counts, distances, masks and selections
# bit-identical
CONVNET_OP_TOL = 1e-5
CONVNET_EXACT = ("maxout", "scale_sub_region", "dropout", "dropout_grad",
                 "edit_distance", "positive_negative_pair")
# the dropout train mask's kept share over DROPOUT_DRAWS draws: within
# this many standard errors of 1 - p
DROPOUT_DRAWS = 1 << 16
DROPOUT_Z = 4.0
# each conv knob against the default conv (cuDNN, TF32 off), output and
# both gradients, at ResNet-50's stem and its first 3x3 stage: the
# largest error over the largest magnitude of the default's value (sums
# of 147 / 576 products in the forward and dx, of 401,408 / 100,352 in
# dW, in other orders)
KNOB_REL_TOL = 1e-4
KNOB_SHAPES = [("stem_7x7_s2", (32, 3, 224, 224), (64, 3, 7, 7), 2, 3),
               ("stage_3x3", (32, 64, 56, 56), (64, 64, 3, 3), 1, 1)]
KNOBS = [("matmul", {"PADDLE_TPU_CONV_IMPL": "matmul"}),
         ("nhwc", {"PADDLE_TPU_CONV_LAYOUT": "nhwc"}),
         ("s2d", {"PADDLE_TPU_CONV_S2D": "1"})]
KNOB_ENV = ("PADDLE_TPU_CONV_IMPL", "PADDLE_TPU_CONV_LAYOUT",
            "PADDLE_TPU_CONV_S2D")
# VGG-16 with batch norm at ImageNet widths (``models.vgg16``: 224 x 224,
# 1000 classes), float32, one fixed batch of 32, Momentum(0.1, 0.9) as
# ``benchmark/image_bench.py:45``, conv_impl=pallas3x3: all 13 convs are
# 3x3 / s1 / p1, the first at C = 3
VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
VGG_BATCH = 32
# a warm-up, the capture and 3 replays: at 0.1 with momentum 0.9 the loss
# on one fixed batch turns up again after ~5 steps (momentum overshoot)
VGG_STEPS = 5
VGG_LR = 0.1
# step-1 gradients of every parameter against torch.autograd through a
# plain VGG-16 written here (F.conv2d, F.batch_norm, the step's fetched
# dropout masks), float32 on both sides: the relative norm of each
# parameter's error. As for ResNet-50 (R50_GRAD_REL_TOL), a relu whose
# input lies within the sums' float32 noise of 0 opens in one and stays
# shut in the other through 14 batch norms, moving that pixel's whole
# gradient (7.67e-3 measured on an H100). A reference whose conv
# operands are rounded to TF32 moves them by ~0.35; it is measured in
# the same run and must miss this tolerance.
VGG_GRAD_REL_TOL = 5e-2
# GoogLeNet and AlexNet at 224 x 224, batch 32, float32, Momentum(0.01,
# 0.9) (phase 6's rate), a few compiled steps on one fixed batch
ZOO_STEPS = 6
ZOO_LR = 0.01
ZOO_BATCH = 32
ZOO_IMAGE = 224


def _convnet_cases():
    """(label, op, inputs, outputs, attrs, differentiated input names,
    the output the loss reads) of every op of the slice at the
    op-contract suite's shapes (``tests/test_op_contract_suite.py``) and
    the ones ``tests/test_torch_convnet_ops.py`` adds."""
    a = _dense_array
    x = a(1, 2, 4, 5, 5)
    v = a(2, 2, 4, 5, 5, 5)
    zrow = a(3, 3, 4)
    zrow[1] = 0.0
    rng = np.random.RandomState(4)
    p = rng.rand(40).astype(np.float32)

    def ints(seed, hi, *shape):
        return np.random.RandomState(seed).randint(0, hi, shape).astype(
            np.int64)

    conv2 = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1]}
    return [
        ("all", "prelu", {"X": [("x", x)], "Alpha": [
            ("al", np.array([0.2], np.float32))]}, {"Out": ["o"]},
         {"mode": "all"}, ("x", "al"), None),
        ("channel", "prelu", {"X": [("x", x)], "Alpha": [
            ("al", np.array([0.2, 0.3, 0.1, 0.5], np.float32))]},
         {"Out": ["o"]}, {"mode": "channel"}, ("x", "al"), None),
        ("element", "prelu", {"X": [("x", x)], "Alpha": [
            ("al", a(5, 4, 5, 5))]}, {"Out": ["o"]}, {"mode": "element"},
         ("x", "al"), None),
        ("rows", "log_softmax", {"X": [("x", a(6, 3, 7))]}, {"Out": ["o"]},
         {}, ("x",), None),
        ("groups2", "maxout", {"X": [("x", x)]}, {"Out": ["o"]},
         {"groups": 2}, ("x",), None),
        ("n5", "lrn", {"X": [("x", x)]}, {"Out": ["o"], "MidOut": ["m"]},
         {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ("x",), "o"),
        ("zero_row", "l2_normalize", {"X": [("x", zrow)]}, {"Out": ["o"]},
         {"axis": 1, "epsilon": 1e-12}, ("x",), None),
        ("regions", "scale_sub_region", {"X": [("x", x)], "Indices": [
            ("i", np.array([[1, 2, 2, 4, 1, 3], [2, 4, 1, 5, 3, 5]],
                           np.int64))]}, {"Out": ["o"]}, {"value": 2.5},
         ("x",), None),
        ("groups4", "depthwise_conv2d", {"Input": [("x", x)],
                                         "Filter": [("w", a(9, 4, 1, 3, 3))]},
         {"Output": ["o"]}, dict(conv2, groups=4), ("x", "w"), None),
        ("mult2_strided", "depthwise_conv2d", {
            "Input": [("x", x)], "Filter": [("w", a(10, 8, 1, 3, 3))]},
         {"Output": ["o"]}, {"strides": [2, 2], "paddings": [1, 0],
                             "dilations": [1, 2], "groups": 4},
         ("x", "w"), None),
        ("s2", "conv2d_transpose", {"Input": [("x", x)],
                                    "Filter": [("w", a(11, 4, 3, 3, 3))]},
         {"Output": ["o"]}, {"strides": [2, 2], "paddings": [1, 1],
                             "dilations": [1, 1]}, ("x", "w"), None),
        ("dilated_grouped", "conv2d_transpose", {
            "Input": [("x", x)], "Filter": [("w", a(12, 4, 3, 3, 2))]},
         {"Output": ["o"]}, {"strides": [2, 3], "paddings": [1, 0],
                             "dilations": [2, 1], "groups": 2},
         ("x", "w"), None),
        ("p1", "conv3d", {"Input": [("x", v)],
                          "Filter": [("w", a(13, 6, 4, 3, 3, 3))]},
         {"Output": ["o"]}, {"strides": [1, 1, 1], "paddings": [1, 1, 1],
                             "dilations": [1, 1, 1], "groups": 1},
         ("x", "w"), None),
        ("strided_dilated_grouped", "conv3d", {
            "Input": [("x", v)], "Filter": [("w", a(14, 6, 2, 3, 3, 3))]},
         {"Output": ["o"]}, {"strides": [2, 1, 1], "paddings": [1, 0, 1],
                             "dilations": [1, 1, 2], "groups": 2},
         ("x", "w"), None),
        ("s2", "conv3d_transpose", {
            "Input": [("x", v)], "Filter": [("w", a(15, 4, 2, 2, 2, 2))]},
         {"Output": ["o"]}, {"strides": [2, 2, 2], "paddings": [0, 0, 0],
                             "dilations": [1, 1, 1]}, ("x", "w"), None),
        ("dilated_grouped", "conv3d_transpose", {
            "Input": [("x", v)], "Filter": [("w", a(16, 4, 3, 2, 3, 2))]},
         {"Output": ["o"]}, {"strides": [2, 1, 2], "paddings": [0, 1, 1],
                             "dilations": [1, 2, 1], "groups": 2},
         ("x", "w"), None),
        ("max", "pool3d", {"X": [("x", v)]}, {"Out": ["o"]},
         {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
          "paddings": [0, 0, 0]}, ("x",), None),
        ("max_ceil_pad", "pool3d", {"X": [("x", v)]}, {"Out": ["o"]},
         {"pooling_type": "max", "ksize": [3, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 0], "ceil_mode": True}, ("x",), None),
        ("avg_pad", "pool3d", {"X": [("x", v)]}, {"Out": ["o"]},
         {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
          "paddings": [1, 1, 1]}, ("x",), None),
        ("avg_ceil_pad", "pool3d", {"X": [("x", v)]}, {"Out": ["o"]},
         {"pooling_type": "avg", "ksize": [3, 2, 3], "strides": [2, 2, 2],
          "paddings": [1, 0, 1], "ceil_mode": True}, ("x",), None),
        ("global_avg", "pool3d", {"X": [("x", v)]}, {"Out": ["o"]},
         {"pooling_type": "avg", "ksize": [1, 1, 1],
          "global_pooling": True}, ("x",), None),
        ("is_test", "dropout", {"X": [("x", x)]},
         {"Out": ["o"], "Mask": ["m"]},
         {"dropout_prob": 0.3, "is_test": True}, ("x",), "o"),
        ("fed_mask", "dropout_grad", {
            "Mask": [("m", (rng.rand(2, 4, 5, 5) >= 0.3).astype(
                np.float32))], "Out@GRAD": [("g", x)]},
         {"X@GRAD": ["o"]}, {"dropout_prob": 0.3}, (), None),
        ("two_columns", "auc", {"Out": [("p", np.stack([1 - p, p], 1))],
                                "Label": [("l", ints(18, 2, 40, 1))]},
         {"AUC": ["o"]}, {"num_thresholds": 200}, (), None),
        ("classes4", "precision_recall", {
            "MaxProbs": [("mp", rng.rand(9, 1).astype(np.float32))],
            "Indices": [("i", ints(21, 4, 9, 1))],
            "Labels": [("l", ints(22, 4, 9, 1))]},
         {"BatchMetrics": ["o"]}, {"class_number": 4}, (), None),
        ("ids_out_of_range", "precision_recall", {
            "MaxProbs": [("mp", rng.rand(6, 1).astype(np.float32))],
            "Indices": [("i", np.array([[0], [5], [-1], [2], [-4], [1]],
                                       np.int64))],
            "Labels": [("l", np.array([[0], [2], [3], [-2], [1], [9]],
                                      np.int64))]},
         {"BatchMetrics": ["o"]}, {"class_number": 3}, (), None),
        ("unequal", "edit_distance", {"Hyps": [("h", ints(23, 4, 3, 6))],
                                      "Refs": [("r", ints(24, 4, 3, 4))]},
         {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": False}, (),
         None),
        ("normalized", "edit_distance", {"Hyps": [("h", ints(25, 3, 4, 3))],
                                         "Refs": [("r", ints(26, 3, 4, 7))]},
         {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": True}, (),
         None),
        ("query_id", "positive_negative_pair", {
            "Score": [("s", np.round(rng.rand(12, 1), 1).astype(
                np.float32))],
            "Label": [("l", ints(30, 3, 12, 1).astype(np.float32))],
            "QueryID": [("q", ints(31, 3, 12, 1))]},
         {"PositivePair": ["pp"], "NegativePair": ["np"],
          "NeutralPair": ["nt"]}, {}, (), None),
        ("lod", "positive_negative_pair", {
            "Score": [("s", (np.round(rng.rand(9, 1), 1).astype(np.float32),
                             [[0, 4, 4, 9]]))],
            "Label": [("l", ints(33, 3, 9, 1).astype(np.float32))]},
         {"PositivePair": ["pp"], "NegativePair": ["np"],
          "NeutralPair": ["nt"]}, {}, (), None),
    ]


def _convnet_ops_check(dev):
    """Every case of :func:`_convnet_cases` (and its grads) on the card
    and on the CPU on the same inputs: the largest error per op; then
    the dropout train mask's kept share over DROPOUT_DRAWS draws on both
    devices, Out = X * Mask exactly, and a second run from the seed
    equal."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    per_op = collections.OrderedDict()
    cpu = torch.device("cpu")
    for label, op, inputs, outputs, attrs, diff, loss_of in \
            _convnet_cases():
        fetch = [n for ns in outputs.values() for n in ns]
        loss_w = None
        if diff:
            loss_of = loss_of or fetch[0]
            probe = _dense_program(op, inputs, outputs, attrs)
            shape = np.shape(_fetched(Executor(cpu).run(
                probe, feed=_dense_feed(inputs), fetch_list=[loss_of],
                scope=Scope(), use_jit=False)[0]))
            loss_w = np.asarray(np.random.RandomState(7).randn(*shape),
                                np.float32)
            fetch = fetch + [n + "@GRAD" for n in diff]
        main = _dense_program(op, inputs, outputs, attrs, diff, loss_of,
                              loss_w)
        got = {}
        for d in (dev, cpu):
            got[d.type] = Executor(d).run(
                main, feed=_dense_feed(inputs, loss_w), fetch_list=fetch,
                scope=Scope(), use_jit=False, return_numpy=True)
        exact = op in CONVNET_EXACT and not attrs.get("normalized")
        worst = _dense_compare(op + " " + label, op, fetch, got[dev.type],
                               got["cpu"], exact)
        if not worst["max_rel_err"] <= CONVNET_OP_TOL:
            fail("convnet op %s (%s) differs from the CPU by %g > %g"
                 % (op, label, worst["max_rel_err"], CONVNET_OP_TOL))
        rec = per_op.setdefault(op, {"cases": 0, "max_abs_err": 0.0,
                                     "max_rel_err": 0.0,
                                     "bit_identical": exact, "grads": []})
        rec["cases"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], worst["max_abs_err"])
        rec["max_rel_err"] = max(rec["max_rel_err"], worst["max_rel_err"])
        for o in main.global_block().ops:
            if o.type.endswith("_grad") and o.type not in rec["grads"] \
                    and o.type not in ("mean_grad", "elementwise_mul_grad"):
                rec["grads"].append(o.type)
    n = DROPOUT_DRAWS
    masks = {}
    for p in (0.1, 0.5):
        inputs = {"X": [("x", np.random.RandomState(5).rand(n).astype(
            np.float32) + 1.0)]}
        main = _dense_program("dropout", inputs,
                              {"Out": ["o"], "Mask": ["m"]},
                              {"dropout_prob": p, "is_test": False})
        main.random_seed = 11
        for d in (dev, cpu):
            runs = [Executor(d).run(main, feed=_dense_feed(inputs),
                                    fetch_list=["o", "m"], scope=Scope(),
                                    use_jit=False) for _ in range(2)]
            (o, m), (o2, m2) = runs
            kept = float(m.mean())
            z = abs(kept - (1 - p)) / math.sqrt(p * (1 - p) / n)
            if not (z <= DROPOUT_Z and np.array_equal(o, inputs["X"][0][1]
                                                      * m)
                    and np.array_equal(m, m2) and np.array_equal(o, o2)):
                fail("dropout train mask on %s at p %g: kept %g (%g "
                     "standard errors), Out = X * Mask %s, seeded rerun "
                     "equal %s" % (d, p, kept, z, np.array_equal(
                         o, inputs["X"][0][1] * m), np.array_equal(m, m2)))
            masks["%s_p%g" % (d.type, p)] = {"kept": kept, "z": z}
    per_op["dropout"]["train_mask"] = masks
    return per_op


def _knob_env(env):
    for k in KNOB_ENV:
        os.environ.pop(k, None)
    os.environ.update(env)


def _knob_check(dev):
    """Each conv knob (matmul, nhwc, s2d) against the default conv at
    ResNet-50's stem and first 3x3 stage, batch 32: a one-op conv2d
    program with its grads (the loss mean(y * w)), on the per-op path;
    the largest error of y, dX and dW over the default's largest
    magnitude, and the ms of the program's run (forward and both grads,
    median of 5 after a warm-up)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    out = {}
    saved = {k: os.environ.get(k) for k in KNOB_ENV}
    try:
        for label, xs, ws, s, p in KNOB_SHAPES:
            rng = np.random.RandomState(len(label))
            x = rng.randn(*xs).astype(np.float32)
            w = (rng.randn(*ws) * np.sqrt(2.0 / np.prod(ws[1:]))).astype(
                np.float32)
            attrs = {"strides": [s, s], "paddings": [p, p],
                     "dilations": [1, 1], "groups": 1}
            oh = (xs[2] + 2 * p - ws[2]) // s + 1
            loss_w = rng.randn(xs[0], ws[0], oh, oh).astype(np.float32)
            inputs = {"Input": [("x", x)], "Filter": [("w", w)]}
            main = _dense_program("conv2d", inputs, {"Output": ["y"]},
                                  attrs, ("x", "w"), "y", loss_w)
            feed = {n: torch.from_numpy(a).to(dev) for n, a in
                    _dense_feed(inputs, loss_w).items()}
            fetch = ["y", "x@GRAD", "w@GRAD"]
            rec = {}
            base = None
            for knob, env in [("default", {})] + KNOBS:
                _knob_env(env)
                exe = Executor(dev)

                def run():
                    return exe.run(main, feed=feed, fetch_list=fetch,
                                   scope=Scope(), use_jit=False,
                                   return_numpy=False)
                got = run()
                torch.cuda.synchronize()
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                r = {"ms": float(np.median(times))}
                if base is None:
                    base = got
                else:
                    for n, g, b in zip(fetch, got, base):
                        err = float((g - b).abs().max())
                        r[n + "_rel_err"] = err / float(b.abs().max())
                    worst = max(v for k, v in r.items()
                                if k.endswith("_rel_err"))
                    if not worst <= KNOB_REL_TOL:
                        fail("conv knob %s at %s differs from the default "
                             "conv by %g > %g: %s" % (knob, label, worst,
                                                      KNOB_REL_TOL, r))
                rec[knob] = r
                del got
            out[label] = rec
            log(json.dumps({"conv_knobs": {label: rec}}))
            del base, feed
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    return out


def _vgg_first_conv(dev):
    """The conv3x3 kernel at VGG-16's first conv, [32, 224, 224, 3] ->
    64 (K 27, 1.6 M output rows), forward only (the image wants no dx),
    against its plain version at full shape; its ms beside ``F.conv2d``'s
    (cuDNN, TF32 off) and the bound: the 411 MB output write over the
    card's memory rate."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import conv3x3
    F = torch.nn.functional
    shape = (VGG_BATCH, 224, 224, 3, 64)
    N, H, W, C, O = shape
    x, w, _ = _conv_inputs(shape, 60, dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    # launches made to compare the kernel with its plain version count
    # toward no main path
    before = kernels.launch_counts()
    got = conv3x3._launch(x, w)
    want = conv3x3.conv3x3_reference(x, w)
    torch.cuda.synchronize()
    err = _rel_err([got], [want])
    if not err <= CONV_REL_TOL:
        fail("conv3x3 at VGG-16's first conv %s differs from its plain "
             "version by %g > %g" % (shape, err, CONV_REL_TOL))
    x_cl = x.permute(0, 3, 1, 2)
    w_cl = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    work = (4 * (N * H * W * (C + O) + 9 * C * O),
            2 * N * H * W * C * O * 9)
    b_ms, b_by = bound(*work)
    rec = {"shape": list(shape), "max_rel_err": err,
           "max_abs_err": float((got - want).abs().max()),
           "tolerance_rel": CONV_REL_TOL,
           "tiling": "%dx%d" % conv3x3.kernel_tiling(N, H, W, C, O),
           "ms": time_ms(lambda: conv3x3._launch(x, w), flush=flush),
           "plain_ms": time_ms(lambda: conv3x3.conv3x3_reference(x, w),
                               flush=flush),
           "library_ms": time_ms(lambda: F.conv2d(x_cl, w_cl, padding=1),
                                 flush=flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "output_bytes": 4 * N * H * W * O}
    kernels.restore_launches(before)
    log(json.dumps({"vgg16_first_conv": rec}))
    del x, w, got, want, flush, x_cl, w_cl
    torch.cuda.empty_cache()
    return rec


def _plain_vgg16_loss(p, img, label, masks, conv_round=None):
    """VGG-16 with batch norm (``models.vgg16``) written out in torch:
    13 3x3 / s1 / p1 convs by ``F.conv2d`` (no bias), each followed by
    ``F.batch_norm`` on the batch's statistics and relu, a 2x2 max pool
    after each block; the first dropout as ``* masks[0]``, fc 4096, batch
    norm over its features, relu, ``* masks[1]``, fc 4096 relu, fc 1000
    softmax, and the mean cross entropy. ``p``: {parameter name:
    tensor}. ``conv_round`` maps each conv operand before the conv."""
    F = torch.nn.functional
    x, i = img, 0
    for _, convs in VGG_CFG:
        for _ in range(convs):
            w = p["conv2d_%d.w_0" % i]
            if conv_round is not None:
                x, w = conv_round(x), conv_round(w)
            x = F.conv2d(x, w, None, 1, 1)
            x = F.relu(F.batch_norm(
                x, None, None, p["batch_norm_%d.w_0" % i],
                p["batch_norm_%d.b_0" % i], True, 0.0, 1e-5))
            i += 1
        x = F.max_pool2d(x, 2, 2)
    x = (x * masks[0]).reshape(x.shape[0], -1)
    x = x @ p["fc_0.w_0"] + p["fc_0.b_0"]
    x = F.relu(F.batch_norm(x, None, None, p["batch_norm_%d.w_0" % i],
                            p["batch_norm_%d.b_0" % i], True, 0.0, 1e-5))
    x = F.relu((x * masks[1]) @ p["fc_1.w_0"] + p["fc_1.b_0"])
    prob = torch.softmax(x @ p["fc_2.w_0"] + p["fc_2.b_0"], dim=1)
    lab = label.long().reshape(-1, 1)
    return -torch.log(torch.clamp(prob, 1e-15, 1.0)).gather(1, lab).mean()


def _vgg_grad_check(trainer, spec, feed):
    """Step 1 through the Executor, fetching the loss, every parameter's
    @GRAD and the two dropout masks the step drew, against
    torch.autograd through :func:`_plain_vgg16_loss` from the state the
    step started at, fed those masks; and the same reference with every
    conv operand rounded to TF32, which must miss the tolerance."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    prog = trainer.main_program
    params = [q.name for q in prog.all_parameters() if q.trainable]
    masks = [op.output("Mask")[0] for op in prog.global_block().ops
             if op.type == "dropout"]
    if len(masks) != 2:
        fail("vgg16 holds %d dropout ops, not 2" % len(masks))
    start = {n: scope.find_var(n).detach().clone() for n in params}
    outs = trainer.exe.run(prog, feed=feed, fetch_list=[spec["cost"].name]
                           + masks + [n + "@GRAD" for n in params],
                           return_numpy=False)
    loss = float(outs[0].reshape(-1)[0])
    got_masks, got = outs[1:3], dict(zip(params, outs[3:]))
    img = feed["img"] if isinstance(feed["img"], torch.Tensor) else \
        torch.as_tensor(np.asarray(feed["img"]), device=got_masks[0].device)
    label = feed["label"] if isinstance(feed["label"], torch.Tensor) else \
        torch.as_tensor(np.asarray(feed["label"]),
                        device=got_masks[0].device)

    def reference(conv_round):
        leaves = {n: t.clone().requires_grad_(True) for n, t in start.items()}
        want_loss = _plain_vgg16_loss(leaves, img, label, got_masks,
                                      conv_round)
        want = dict(zip(params, torch.autograd.grad(
            want_loss, [leaves[n] for n in params])))
        return float(want_loss.detach()), want

    want_loss, want = reference(None)
    largest = max(float(w.norm()) for w in want.values())
    # the bias of the fc ahead of a batch norm: zero but for float32
    # noise (the norm takes its mean away); the port's must be as small
    zero = [n for n in params
            if float(want[n].norm()) <= ZERO_GRAD_FRAC * largest]

    def rel_errs(ref):
        return {n: float((got[n] - ref[n]).norm() / ref[n].norm())
                for n in params if n not in zero}
    rel = rel_errs(want)
    worst = max(rel, key=rel.get)
    kept = [float(m.float().mean()) for m in got_masks]
    zero_err = max([float((got[n] - want[n]).abs().max()) for n in zero]
                   or [0.0])
    del want
    _, tf32_want = reference(_tf32_straight)
    tf32_rel = rel_errs(tf32_want)
    tf32_worst = max(tf32_rel, key=tf32_rel.get)
    del tf32_want
    rec = {"params_checked": len(rel), "tolerance_rel": VGG_GRAD_REL_TOL,
           "norm_rel_err": rel[worst], "worst_param": worst,
           "norm_rel_err_median": float(np.median(list(rel.values()))),
           "tf32_convs_norm_rel_err": tf32_rel[tf32_worst],
           "tf32_convs_worst_param": tf32_worst,
           "tf32_convs_norm_rel_err_median": float(
               np.median(list(tf32_rel.values()))),
           "zero_grad_params": zero, "zero_grad_max_abs_err": zero_err,
           "largest_grad_norm": largest,
           "loss": loss, "loss_abs_err": abs(loss - want_loss),
           "dropout_kept": kept}
    log(json.dumps({"vgg16_grad_check": rec}))
    if not rel[worst] <= VGG_GRAD_REL_TOL:
        fail("vgg16 step-1 gradient of %s differs from the plain model's "
             "autograd by %g (relative norm) > %g" % (
                 worst, rel[worst], VGG_GRAD_REL_TOL))
    if not zero_err <= ZERO_GRAD_FRAC * largest:
        fail("vgg16: a gradient that is zero in the plain model is %g in "
             "the port" % zero_err)
    if not all(0.4 < k < 0.6 for k in kept):
        fail("vgg16's dropout masks keep %s, not about half" % kept)
    if not tf32_rel[tf32_worst] > VGG_GRAD_REL_TOL:
        fail("vgg16: TF32 convs move the gradients by only %g <= %g: the "
             "tolerance cannot tell float32 from TF32"
             % (tf32_rel[tf32_worst], VGG_GRAD_REL_TOL))
    del start, got, outs
    return rec


def _conv3x3_convs(prog, batch):
    """((N, H, W, C, O), wants dx) of each conv of ``prog`` that the
    conv3x3 population takes under pallas3x3 (every 3x3 / s1 / p1 conv),
    in program order, at batch ``batch``."""
    from paddle_tpu_torch.kernels import conv3x3
    blk = prog.global_block()
    convs = []
    for op in blk.ops:
        if op.type != "conv2d":
            continue
        w = blk._find_var_recursive(op.input("Filter")[0])
        if conv3x3.supports_conv3x3(
                tuple(w.shape), op.attr("strides"), op.attr("paddings"),
                op.attr("dilations"), op.attr("groups") or 1):
            x = blk._find_var_recursive(op.input("Input")[0])
            _, C, H, W = x.shape
            convs.append(((batch, H, W, C, w.shape[0]), not x.stop_gradient))
    return convs


def _n_conv3x3(prog):
    """(forward, dx) launches a step of the conv3x3 population of
    ``prog``'s conv2d ops under pallas3x3: every 3x3 / s1 / p1 conv, and
    those whose input wants a gradient."""
    convs = _conv3x3_convs(prog, 1)
    return len(convs), sum(dx for _, dx in convs)


def _conv_inputs_on(shape, seed, dev):
    """:func:`_conv_inputs` drawn on ``dev`` (a [32, 224, 224, 64] input
    takes seconds to draw on the host)."""
    N, H, W, C, O = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    return (randn(N, H, W, C),
            randn(3, 3, C, O) * (2.0 / (9 * C)) ** 0.5,
            randn(N, H, W, O))


def _zoo_conv_check(dev, prog, batch, seen):
    """The conv3x3 kernel against its plain version at each distinct
    shape of ``prog``'s conv3x3 population not in ``seen`` (which it
    extends): the forward, and the dx where the conv's input wants one,
    within CONV_REL_TOL; the plain version on TF32-rounded inputs must
    miss it; the tilings those of the rule's mirror. Launches made here
    count toward no main path. Returns {shape: record}."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import conv3x3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wants = {}
    for shape, dx in _conv3x3_convs(prog, batch):
        wants[shape] = wants.get(shape, False) or dx
    before = kernels.launch_counts()
    out = {}
    for i, (shape, dx) in enumerate(wants.items()):
        if (shape, dx) in seen or (shape, True) in seen:
            continue
        seen.add((shape, dx))
        N, H, W, C, O = shape
        x, w, g = _conv_inputs_on(shape, 80 + i, dev)
        got = conv3x3.conv3x3_s1_nhwc(x, w)
        want = conv3x3.conv3x3_reference(x, w)
        tf32 = conv3x3.conv3x3_reference(_tf32_round(x), _tf32_round(w))
        rec = {"fwd_max_rel_err": _rel_err([got], [want]),
               "tf32_fwd_max_rel_err": _rel_err([tf32], [want]),
               "tiling": {"fwd": "%dx%d" % conv3x3.kernel_tiling(
                   N, H, W, C, O)}}
        mirror = {"fwd": "%dx%d" % conv3x3.tiling(N, H, W, C, O, sms)}
        del got, want, tf32
        if dx:
            w_rot = conv3x3.rotate_filter(w)
            got, _ = conv3x3.conv3x3_bwd(x, w, g, want_dw=False)
            want = conv3x3.conv3x3_reference(g, w_rot)
            tf32 = conv3x3.conv3x3_reference(_tf32_round(g),
                                             _tf32_round(w_rot))
            rec.update({"dx_max_rel_err": _rel_err([got], [want]),
                        "tf32_dx_max_rel_err": _rel_err([tf32], [want])})
            rec["tiling"]["dx"] = "%dx%d" % conv3x3.kernel_tiling(
                N, H, W, O, C)
            mirror["dx"] = "%dx%d" % conv3x3.tiling(N, H, W, O, C, sms)
            del got, want, tf32, w_rot
        torch.cuda.synchronize()
        del x, w, g
        out["x".join(str(d) for d in shape)] = rec
        errs = [v for k, v in rec.items() if k in ("fwd_max_rel_err",
                                                   "dx_max_rel_err")]
        tf32s = [v for k, v in rec.items() if k.startswith("tf32_")]
        if not max(errs) <= CONV_REL_TOL:
            fail("conv3x3 disagrees with its plain version at %s: %s > %g"
                 % (shape, rec, CONV_REL_TOL))
        if not min(tf32s) > CONV_REL_TOL:
            fail("a TF32 conv errs by only %s <= CONV_REL_TOL %g at %s: the "
                 "tolerance cannot tell float32 from TF32"
                 % (rec, CONV_REL_TOL, shape))
        if rec["tiling"] != mirror:
            fail("conv3x3 at %s took the tilings %s, its rule's mirror "
                 "says %s" % (shape, rec["tiling"], mirror))
    kernels.restore_launches(before)
    torch.cuda.empty_cache()
    return out


def _one_step_profile(trainer, prog, feed, cost, dev):
    """One step on the per-op path under ``torch.profiler``: device ms by
    kind (:func:`_conv_share`) and the eight kernels with the most
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.exe.run(prog, feed=feed, fetch_list=[cost], use_jit=False)
        _sync(dev)
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3
        top.append((t, e.count, e.key[:90]))
    top.sort(reverse=True)
    return {"by_kind": _conv_share(prof),
            "top_kernels": [{"ms": t, "launches": n, "kernel": k}
                            for t, n, k in top[:8]]}


def _zoo_train(dev, name, seen):
    """``models.<name>`` (vgg16, googlenet or alexnet) at 224 x 224, 1000
    classes, float32, every 3x3 / s1 / p1 conv on the conv3x3 kernel
    (``conv_impl=pallas3x3``). The kernel is first held to its plain
    version at each of the program's conv3x3 shapes not in ``seen``
    (:func:`_zoo_conv_check`). Then the model trains on one fixed seeded
    batch through ``Trainer.train``, compiled: the loss finite and
    falling, one capture and a replay a step, the conv3x3 launches a
    step equal to the program's 3x3 / s1 / p1 convs (forward) and those
    whose input wants a gradient (dx). VGG-16 holds step 1's gradients
    to the plain model first. Each step is then timed on the per-op path
    doing the Trainer's work (the batch fed from the host, the loss read
    back), and both paths once more on the batch fed once (the device's
    work and the dispatch alone). Returns (launches, record)."""
    from paddle_tpu_torch import kernels, layers, models, optimizer
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration, \
        Trainer
    vgg = name == "vgg16"
    batch, steps = (VGG_BATCH, VGG_STEPS) if vgg else (ZOO_BATCH, ZOO_STEPS)
    label = "convnet_" + name
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        img = layers.data("img", shape=[3, ZOO_IMAGE, ZOO_IMAGE],
                          dtype="float32")
        lab = layers.data("label", shape=[1], dtype="int64")
        pred = getattr(models, name)(img, class_dim=1000)
        cost = layers.mean(layers.cross_entropy(pred, lab))
        for op in main_prog.global_block().ops:
            if op.type == "conv2d":
                op.attrs["conv_impl"] = "pallas3x3"
        spec = {"cost": cost}
        trainer = Trainer(cost, optimizer.Momentum(
            learning_rate=VGG_LR if vgg else ZOO_LR, momentum=0.9),
            [img, lab], device=dev)
    n_fwd, n_dx = _n_conv3x3(main_prog)
    if vgg and (n_fwd, n_dx) != (13, 12):
        fail("vgg16 holds %d 3x3 / s1 / p1 convs, %d wanting dx, not 13 "
             "and 12" % (n_fwd, n_dx))
    rng = np.random.RandomState(len(name))
    sample = [(rng.rand(3, ZOO_IMAGE, ZOO_IMAGE).astype(np.float32),
               rng.randint(0, 1000, (1,)).astype(np.int64))
              for _ in range(batch)]
    rec = {"batch": batch, "steps": steps,
           "program_ops": len(main_prog.global_block().ops),
           "conv3x3_per_step": {"fwd": n_fwd, "dx": n_dx},
           "conv3x3_checks": _zoo_conv_check(dev, main_prog, batch, seen)}
    with scope_guard(Scope()):
        trainer._maybe_init()
        feed = trainer.feeder.feed(sample)
        if vgg:
            rec["grad_check"] = _vgg_grad_check(trainer, spec, feed)
        losses, step_s, marks = [], [], {}

        def handler(e):
            if isinstance(e, BeginIteration):
                marks["t"] = time.monotonic()
            elif isinstance(e, EndIteration):
                step_s.append(time.monotonic() - marks["t"])
                losses.append(e.cost)

        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        exe_before = dict(trainer.exe.stats)
        trainer.train(lambda: (sample for _ in range(steps)),
                      num_passes=1, event_handler=handler)
        launches = kernels.launch_counts()
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        delta = _exe_delta(trainer.exe, exe_before)
        _compiled_gate(label, delta, len(losses))
        if len(losses) != steps or not (np.all(np.isfinite(losses))
                                        and losses[-1] < losses[0]):
            fail("%s: the loss did not fall on the fixed batch: %s"
                 % (label, losses))
        want = {"conv3x3_fwd": n_fwd * steps, "conv3x3_dx": n_dx * steps}
        got = {k: launches[k] for k in want}
        others = {k: v for k, v in launches.items() if v and k not in want}
        if got != want or others:
            fail("%s: conv3x3 launches %s in %d steps, expected %s (%d "
                 "forward and %d dx a step); other kernels %s"
                 % (label, got, steps, want, n_fwd, n_dx, others))
        fetch = trainer.fetch_list

        def timed_steps(fed, use_jit):
            out = []
            for _ in range(steps):
                t0 = time.monotonic()
                trainer.exe.run(main_prog, feed=feed if fed else
                                trainer.feeder.feed(sample),
                                fetch_list=fetch, use_jit=use_jit)
                _sync(dev)
                out.append(time.monotonic() - t0)
            return out
        eager_s = timed_steps(False, False)
        # the Trainer's graph replayed on the batch fed once
        exe_before = dict(trainer.exe.stats)
        fed_s = timed_steps(True, True)
        fed_delta = _exe_delta(trainer.exe, exe_before)
        want_fed = {"jit_runs": steps, "eager_runs": 0, "hybrid_runs": 0,
                    "graph_captures": 0, "graph_replays": steps}
        if fed_delta != want_fed:
            fail("%s: the batch fed once ran %s, expected %s (the "
                 "Trainer's graph replayed)" % (label, fed_delta, want_fed))
        eager_fed_s = timed_steps(True, False)
        if vgg:
            rec["profile_eager_step"] = _one_step_profile(
                trainer, main_prog, feed, cost, dev)
    # the replays' p50 (the steps from the third on: the first two are
    # the warm-up and the capture); the per-op path's over all its steps
    p50 = float(np.median(step_s[2:]))
    ep50 = float(np.median(eager_s))
    fp50, efp50 = float(np.median(fed_s)), float(np.median(eager_fed_s))
    rec.update({"losses": losses, "executor": delta,
                "step_ms_compiled": [t * 1e3 for t in step_s],
                "step_ms_eager": [t * 1e3 for t in eager_s],
                "step_ms_p50_compiled": p50 * 1e3,
                "step_ms_p50_eager": ep50 * 1e3,
                "images_per_s_compiled": batch / p50,
                "images_per_s_eager": batch / ep50,
                # the batch fed once: no host batch, no copy
                "fed_once": {"executor": fed_delta,
                             "step_ms_p50_compiled": fp50 * 1e3,
                             "step_ms_p50_eager": efp50 * 1e3,
                             "images_per_s_compiled": batch / fp50,
                             "images_per_s_eager": batch / efp50},
                "launches": {k: v for k, v in launches.items() if v}})
    log(json.dumps({label: rec}))
    log("%s_train_images_per_sec %.3f compiled, %.3f eager (batch %d, step "
        "p50 %.3f / %.3f ms, each feeding the batch; fed once %.3f / %.3f "
        "ms; peak %.3f GB; %s)" % (
            label, batch / p50, batch / ep50, batch, p50 * 1e3, ep50 * 1e3,
            fp50 * 1e3, efp50 * 1e3, rec["peak_memory_bytes"] / 1e9,
            card_line()))
    trainer.exe.close()
    del trainer, feed
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def phase_convnet_zoo(dev, root):
    """Phase 18: the rest of the conv-net path. Every new op and grad on
    the card against the CPU; the conv knobs against the default conv at
    ResNet-50's stem and first stage; the conv3x3 kernel at VGG-16's
    first conv (C = 3) against its plain version; VGG-16, GoogLeNet and
    AlexNet at ImageNet widths through ``Trainer.train``. Returns
    ({path: launches}, the first-conv record)."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    t0 = time.monotonic()
    old_dir = FLAGS.tune_cache_dir
    FLAGS.tune_cache_dir = _fresh_dir(os.path.join(
        root, "build", "chip_smoke", "tune_convnet_zoo"))
    tune.clear_memory_cache()
    paths, recs = {}, {}
    try:
        log(json.dumps({"convnet_ops": _convnet_ops_check(dev)}))
        knobs = _knob_check(dev)
        first = _vgg_first_conv(dev)
        # the first conv's forward is held above (its image wants no dx)
        seen = {(tuple(first["shape"]), False)}
        for name in ("vgg16", "googlenet", "alexnet"):
            paths["convnet_" + name], recs[name] = _zoo_train(dev, name,
                                                              seen)
    finally:
        FLAGS.tune_cache_dir = old_dir
        tune.clear_memory_cache()
    log(json.dumps({
        "convnet_zoo_wall_s": time.monotonic() - t0,
        "vgg16_step_ms_p50": recs["vgg16"]["step_ms_p50_compiled"],
        "vgg16_images_per_s": recs["vgg16"]["images_per_s_compiled"],
        "googlenet_step_ms_p50": recs["googlenet"]["step_ms_p50_compiled"],
        "alexnet_step_ms_p50": recs["alexnet"]["step_ms_p50_compiled"],
        "vgg16_first_conv_ms": first["ms"],
        "knob_ms": {k: {n: r["ms"] for n, r in v.items()}
                    for k, v in knobs.items()},
        "card": card_line()}))
    return paths, first


# -- phase 19 -----------------------------------------------------------------

# card against CPU for the sequence slice's ops: float outputs and
# gradients within this of max(1, |CPU value|) (recurrences, context
# products and log-sum-exps summed in other orders); offsets, paths,
# selections, counts and data movement bit-identical
SEQ_OP_TOL = 1e-5
SEQ_EXACT = ("sequence_expand", "sequence_concat", "sequence_reshape",
             "lod_reset", "sequence_reverse", "kmax_seq_score",
             "sub_nested_seq", "sequence_slice", "sequence_erase",
             "ctc_align", "chunk_eval", "crf_decoding", "context_project",
             "im2sequence")
SEQ_SAMPLERS = ("uniform_random_int", "log_uniform_random_int",
                "custom_dist_random_int")
SEQ_DRAWS = 1 << 16
# a sampler's bucket shares: within SEQ_Z standard errors a bucket,
# widened (Bonferroni) so that the buckets of a right sampler all pass
# but once in 1 / SEQ_FAMILY_ALPHA runs (50 buckets: 4.75)
SEQ_Z = 4.0
SEQ_FAMILY_ALPHA = 1e-4
# upstream book test_understand_sentiment.py: imdb's 5147 words
# (paddle_tpu/dataset/imdb.py:24), Adam 0.002; batch 128 reviews of 20
# to 250 words; convolution_net at embedding and hidden 32,
# stacked_lstm_net at embedding 128, hidden 512 (LSTM D 128), 3 layers
SENT_BOOK = dict(vocab=5147, batch=128, min_len=20, max_len=250,
                 learning_rate=0.002)
SENT_CONV = dict(emb=32, hid=32)
SENT_LSTM = dict(emb=128, hid=512, stacked=3)
# upstream book test_label_semantic_roles.py's db_lstm defaults and the
# CoNLL-05 dictionary sizes it prints; batch 10 sentences of 4 to 60
SRL_BOOK = dict(words=44068, preds=3162, labels=59, marks=2, word_dim=32,
                mark_dim=5, hidden=512, depth=8, mix_hidden_lr=1e-3,
                learning_rate=0.01, batch=10, min_len=4, max_len=60)
SRL_FEED_NAMES = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                  "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
                  "target")
SEQ_STEPS = 8
# step-1 gradients of the card's float32 step against the port's own
# CPU run of the same program built in float64, from the same weights
# and feed: the relative norm of each parameter's error
SEQ_GRAD_REL_TOL = 1e-4
# a max pool over a sequence may pick another row on the card where its
# two largest inputs lie within SEQ_TIE_TOL of max(1, |value|) on the
# reference side; one such flip routes a feature's gradient to another
# step (1.57e-3 of fc_0's weight gradient in the LSTM net on an H100),
# so a step with flips, all at such ties, is held to
# SEQ_FLIP_GRAD_REL_TOL instead
SEQ_TIE_TOL = 1e-5
SEQ_FLIP_GRAD_REL_TOL = 1e-2
# the peephole-free LSTM net through row 7 against the same net on the
# time loop, on the card: loss, Hidden and every parameter's gradient
FUSED_LOOP_REL_TOL = 1e-4
# Viterbi: a position whose CPU (float64) best-path margin is under this
# may decode either way on the card
VITERBI_MARGIN_TOL = 1e-3


def _seq_array(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _seq_lod(lengths):
    return [[int(v) for v in np.concatenate([[0], np.cumsum(lengths)])]]


def _seq_ragged(seed, lengths, width, scale=1.0):
    return (_seq_array(seed, int(sum(lengths)), width, scale=scale),
            _seq_lod(lengths))


def _seq_ids(seed, lengths, high):
    return (np.random.RandomState(seed).randint(
        0, high, (int(sum(lengths)), 1)).astype(np.int64), _seq_lod(lengths))


def _sent_lengths(seed=0):
    return np.random.RandomState(seed).randint(
        SENT_BOOK["min_len"], SENT_BOOK["max_len"] + 1, SENT_BOOK["batch"])


def _srl_lengths(seed=0):
    return np.random.RandomState(seed).randint(
        SRL_BOOK["min_len"], SRL_BOOK["max_len"] + 1, SRL_BOOK["batch"])


def _sequence_cases():
    """(label, op, inputs, outputs, attrs, differentiated inputs, the
    output the loss reads): every op of the sequence slice at the shapes
    of the sentiment nets and the role tagger, and at the CPU tests'
    edges (an empty and a length-1 sequence, 2-level LoD, the CTC and
    CRF corner cases, stride windows)."""
    r, ragged, ids = _seq_array, _seq_ragged, _seq_ids
    lens = [3, 1, 0, 5, 2]
    nested = (r(1, 12, 3), [[0, 2, 5], [0, 1, 3, 3, 7, 12]])
    sent, srl = _sent_lengths(7), _srl_lengths(7)
    K = SRL_BOOK["labels"]
    emb = SENT_CONV["emb"]
    crf = {"Emission": [("em", ragged(2, srl, K))],
           "Transition": [("tr", r(3, K + 2, K, scale=0.1))],
           "Label": [("lab", ids(4, srl, K))]}
    edge_crf = {"Emission": [("em", ragged(5, lens, 4))],
                "Transition": [("tr", r(6, 6, 4, scale=0.5))],
                "Label": [("lab", ids(7, lens, 4))]}
    tags = ids(8, srl, K)
    pred = (np.where(np.random.RandomState(9).rand(*tags[0].shape) < 0.3,
                     np.random.RandomState(10).randint(0, K, tags[0].shape),
                     tags[0]).astype(np.int64), tags[1])

    def ctc(seed, xl, yl, k, labels=None):
        y = ids(seed + 1, yl, k) if labels is None else (
            np.asarray(labels, np.int64).reshape(-1, 1), _seq_lod(yl))
        return {"Logits": [("x", ragged(seed, xl, k))], "Label": [("y", y)]}

    rng = np.random.RandomState(11)
    nce_in = {"Input": [("x", r(12, 64, 32))],
              "Label": [("lab", rng.randint(0, 1000, (64, 1)))],
              "Weight": [("w", r(13, 1000, 32, scale=0.1))],
              "Bias": [("b", r(14, 1000, 1, scale=0.1))],
              "Samples": [("s", rng.randint(0, 1000, (20,)))]}
    probs = rng.rand(1000).astype(np.float32) + 0.01
    cases = [
        ("softmax", "sequence_softmax", {"X": [("x", ragged(15, lens, 1))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("softmax_nested", "sequence_softmax",
         {"X": [("x", (r(16, 12, 1), nested[1]))]}, {"Out": ["o"]}, {},
         ("x",), None),
        ("expand_rows", "sequence_expand",
         {"X": [("x", r(17, 5, 4))], "Y": [("y", ragged(18, lens, 2))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("expand_seqs", "sequence_expand",
         {"X": [("x", ragged(19, [2, 1, 1, 3, 1], 4))],
          "Y": [("y", ragged(20, [4, 3, 0, 3, 2], 2))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("concat", "sequence_concat",
         {"X": [("a", ragged(21, lens, 3)),
                ("b", ragged(22, [0, 2, 1, 1, 3], 3))]},
         {"Out": ["o"]}, {}, ("a", "b"), None),
        ("reshape", "sequence_reshape",
         {"X": [("x", ragged(23, [2, 4, 0, 2], 3))]}, {"Out": ["o"]},
         {"new_dim": 6}, ("x",), None),
        ("lod_reset_target", "lod_reset", {"X": [("x", r(24, 11, 2))]},
         {"Out": ["o"]}, {"target_lod": [0, 4, 4, 5, 11]}, ("x",), None),
        ("lod_reset_y", "lod_reset",
         {"X": [("x", ragged(25, [5, 6], 2))],
          "Y": [("y", ragged(26, lens, 1))]}, {"Out": ["o"]}, {}, ("x",),
         None),
        ("lod_reset_plain_y", "lod_reset",
         {"X": [("x", r(27, 11, 2))],
          "Y": [("y", np.array([0, 2, 2, 7, 11], np.int64))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("reverse_nested", "sequence_reverse", {"X": [("x", nested)]},
         {"Y": ["o"]}, {}, ("x",), None),
        ("kmax_ties", "kmax_seq_score",
         {"X": [("x", (np.array([[1.], [2.], [2.], [1.], [2.], [0.], [0.]],
                                np.float32), [[0, 5, 7]]))]},
         {"Out": ["o"]}, {"beam_size": 4}, (), None),
        ("sub_nested", "sub_nested_seq",
         {"X": [("x", nested)],
          "SelectedIndices": [("sel", np.array([[1, 0, -1], [2, 5, 0]],
                                               np.int64))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("slice", "sequence_slice",
         {"X": [("x", ragged(28, lens, 2))],
          "Offset": [("off", np.array([[1], [0], [0], [2], [1]], np.int64))],
          "Length": [("len", np.array([[2], [1], [0], [3], [0]],
                                      np.int64))]},
         {"Out": ["o"]}, {}, ("x",), None),
        ("erase", "sequence_erase", {"X": [("x", ids(29, lens, 5))]},
         {"Out": ["o"]}, {"tokens": [0, 3]}, (), None),
        ("ctc_align", "ctc_align", {"Input": [("x", ids(30, lens, 4))]},
         {"Output": ["o"]}, {"blank": 2, "merge_repeated": True}, (), None),
        ("chunk_eval_srl", "chunk_eval",
         {"Inference": [("inf", pred)], "Label": [("lab", tags)]},
         {"Precision": ["p"], "Recall": ["rc"], "F1-Score": ["f"],
          "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
          "NumCorrectChunks": ["nc"]},
         {"num_chunk_types": (K - 1) // 2, "chunk_scheme": "IOB"}, (), None),
        ("conv_sentiment_3", "sequence_conv",
         {"X": [("x", ragged(31, sent, emb))],
          "Filter": [("f", r(32, 3 * emb, SENT_CONV["hid"], scale=0.1))]},
         {"Out": ["o"]}, {"contextLength": 3, "contextStart": -1,
                          "contextStride": 1}, ("x", "f"), None),
        ("conv_sentiment_4", "sequence_conv",
         {"X": [("x", ragged(33, sent, emb))],
          "Filter": [("f", r(34, 4 * emb, SENT_CONV["hid"], scale=0.1))]},
         {"Out": ["o"]}, {"contextLength": 4, "contextStart": -2,
                          "contextStride": 1}, ("x", "f"), None),
        ("context_project_padding", "context_project",
         {"X": [("x", ragged(35, [1, 2, 0, 3], 2))],
          "PaddingData": [("pad", r(36, 4, 2))]}, {"Out": ["o"]},
         {"contextLength": 5, "contextStart": -2}, ("x", "pad"), None),
        ("row_conv", "row_conv",
         {"X": [("x", ragged(37, lens, 3))],
          "Filter": [("f", r(38, 3, 3, scale=0.5))]},
         {"Out": ["o"]}, {}, ("x", "f"), None),
        ("lstmp", "lstmp",
         {"Input": [("x", ragged(39, lens, 12, scale=0.5))],
          "Weight": [("w", r(40, 2, 12, scale=0.4))],
          "ProjWeight": [("wp", r(41, 3, 2, scale=0.4))],
          "Bias": [("b", r(42, 1, 21, scale=0.2))]},
         {"Projection": ["o"], "Cell": ["c"]}, {"is_reverse": True},
         ("x", "w", "wp", "b"), None),
        ("lstm_unit", "lstm_unit",
         {"X": [("x", r(43, 4, 12))], "C_prev": [("c", r(44, 4, 3))]},
         {"C": ["cn"], "H": ["o"]}, {"forget_bias": 0.5}, ("x", "c"), None),
        ("gru_unit", "gru_unit",
         {"Input": [("x", r(45, 4, 9))], "HiddenPrev": [("h", r(46, 4, 3))],
          "Weight": [("w", r(47, 3, 9, scale=0.5))],
          "Bias": [("b", r(48, 1, 9, scale=0.2))]},
         {"Gate": ["g"], "ResetHiddenPrev": ["rh"], "Hidden": ["o"]}, {},
         ("x", "h", "w", "b"), None),
        ("simple_rnn", "simple_rnn",
         {"Input": [("x", ragged(49, lens, 3))],
          "Weight": [("w", r(50, 3, 3, scale=0.5))]},
         {"Hidden": ["o"]}, {"is_reverse": True}, ("x", "w"), None),
        ("crf_srl", "linear_chain_crf", crf, {"LogLikelihood": ["o"]}, {},
         ("em", "tr"), None),
        ("crf_edges", "linear_chain_crf", edge_crf,
         {"LogLikelihood": ["o"], "Alpha": ["a"]}, {}, ("em", "tr"), None),
        ("crf_t1", "linear_chain_crf",
         {"Emission": [("em", ragged(51, [1, 1], 3))],
          "Transition": [("tr", r(52, 5, 3))],
          "Label": [("lab", ids(53, [1, 1], 3))]},
         {"LogLikelihood": ["o"]}, {}, ("em", "tr"), None),
        ("decode_edges", "crf_decoding",
         {k: v for k, v in edge_crf.items() if k != "Label"},
         {"ViterbiPath": ["o"]}, {}, (), None),
        ("decode_label", "crf_decoding", edge_crf, {"ViterbiPath": ["o"]},
         {}, (), None),
        ("ctc", "warpctc", ctc(54, [6, 4, 7], [3, 2, 4], 5),
         {"Loss": ["o"]}, {}, ("x",), None),
        ("ctc_repeats_blank3_norm", "warpctc",
         ctc(55, [6, 5], [3, 2], 5, labels=[1, 1, 2, 4, 4]),
         {"Loss": ["o"]}, {"blank": 3, "norm_by_times": True}, ("x",), None),
        # the loss only: its gradient is float32 noise (ROADMAP Queue 3 #31)
        ("ctc_longer_label", "warpctc", ctc(56, [2, 5], [4, 2], 5),
         {"Loss": ["o"]}, {}, (), None),
        ("ctc_empty_label", "warpctc",
         ctc(57, [4, 3], [0, 2], 4, labels=[2, 1]), {"Loss": ["o"]}, {},
         ("x",), None),
        ("nce_uniform", "nce_core", nce_in, {"Cost": ["o"]},
         {"num_total_classes": 1000, "num_neg_samples": 20}, ("x", "w", "b"),
         None),
        ("nce_log_uniform", "nce_core", nce_in, {"Cost": ["o"]},
         {"num_total_classes": 1000, "num_neg_samples": 20,
          "sampler": "log_uniform"}, ("x", "w"), None),
        ("nce_custom_dist", "nce_core",
         dict(nce_in, CustomDistProbs=[("p", probs / probs.sum())]),
         {"Cost": ["o"]}, {"num_total_classes": 1000, "num_neg_samples": 20,
                           "sampler": "custom_dist"}, ("x", "w"), None),
        ("lambda_rank", "lambda_rank_cost",
         {"Score": [("s", ragged(58, [4, 1, 5], 1))],
          "Label": [("r", (rng.randint(0, 3, (10, 1)).astype(np.float32),
                           [[0, 4, 5, 10]]))]},
         {"Out": ["o"]}, {"ndcg_num": 3}, ("s",), None),
        ("im2sequence", "im2sequence", {"X": [("x", r(59, 2, 2, 7, 5))]},
         {"Out": ["o"]}, {"kernels": [3, 2], "strides": [2, 3],
                          "paddings": [1, 0, 2, 1]}, ("x",), None),
        ("hsigmoid", "hierarchical_sigmoid",
         {"X": [("x", r(60, 6, 4))], "W": [("w", r(61, 6, 4, scale=0.5))],
          "Label": [("lab", np.array([[0], [6], [3], [5], [1], [2]],
                                     np.int64))],
          "Bias": [("b", r(62, 6, 1, scale=0.3))]},
         {"Out": ["o"]}, {"num_classes": 7}, ("x", "w", "b"), None),
    ]
    for ptype in ("sum", "max", "last"):
        for stride in (1, 3, 9):
            cases.append(("stride_%s_%d" % (ptype, stride), "sequence_pool",
                          {"X": [("x", ragged(63 + stride, lens, 3))]},
                          {"Out": ["o"]}, {"pooltype": ptype.upper(),
                                           "stride": stride}, ("x",), None))
    return cases


def _sequence_ops_check(dev):
    """Every case of :func:`_sequence_cases` and its grads on the card
    and on the CPU on the same inputs (the per-op path, where the host
    ops run between the others), and the three int samplers' 2^16 draws
    on both devices against their laws: by op, the largest error."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    per_op = collections.OrderedDict()
    cpu = torch.device("cpu")
    for label, op, inputs, outputs, attrs, diff, loss_of in \
            _sequence_cases():
        fetch = [n for ns in outputs.values() for n in ns]
        loss_w = None
        if diff:
            loss_of = loss_of or fetch[0]
            probe = _dense_program(op, inputs, outputs, attrs)
            shape = np.shape(_fetched(Executor(cpu).run(
                probe, feed=_dense_feed(inputs), fetch_list=[loss_of],
                scope=Scope(), use_jit=False)[0]))
            loss_w = np.asarray(np.random.RandomState(7).randn(*shape),
                                np.float32)
            fetch = fetch + [n + "@GRAD" for n in diff]
        main = _dense_program(op, inputs, outputs, attrs, diff, loss_of,
                              loss_w)
        got = {}
        for d in (dev, cpu):
            got[d.type] = Executor(d).run(
                main, feed=_dense_feed(inputs, loss_w), fetch_list=fetch,
                scope=Scope(), use_jit=False)
        worst = _dense_compare(label, op, fetch, got[dev.type], got["cpu"],
                               op in SEQ_EXACT, tol=SEQ_OP_TOL,
                               what="sequence op")
        rec = per_op.setdefault(op, {"cases": 0, "max_abs_err": 0.0,
                                     "max_rel_err": 0.0, "grad": bool(diff),
                                     "bit_identical": op in SEQ_EXACT})
        rec["cases"] += 1
        rec["grad"] = rec["grad"] or bool(diff)
        rec["max_abs_err"] = max(rec["max_abs_err"], worst["max_abs_err"])
        rec["max_rel_err"] = max(rec["max_rel_err"], worst["max_rel_err"])
    per_op.update(_sequence_sampler_check(dev))
    return per_op


def _sequence_sampler_check(dev):
    """2^16 draws of each int sampler on each device: in range, int64,
    and each bucket's share within SEQ_Z standard errors of the law's."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    n = SEQ_DRAWS
    probs = np.array([0.1, 0.0, 0.5, 0.15, 0.25], np.float32)
    k = np.arange(50)
    laws = [("uniform_random_int", {}, {"shape": [n], "low": 2, "high": 9},
             np.r_[np.zeros(2), np.full(7, 1 / 7)]),
            ("log_uniform_random_int", {}, {"shape": [n], "range": 50},
             np.log((k + 2.0) / (k + 1.0)) / math.log(51.0)),
            ("custom_dist_random_int", {"Probs": [("p", probs)]},
             {"shape": [n]}, probs / probs.sum())]
    out = {}
    for op, inputs, attrs, p in laws:
        main = _dense_program(op, inputs, {"Out": ["o"]}, attrs)
        main.random_seed = 11
        rec = {"cases": 1, "max_abs_err": 0.0, "max_rel_err": 0.0,
               "grad": False, "bit_identical": False}
        for d in (dev, torch.device("cpu")):
            v = Executor(d).run(main, feed=_dense_feed(inputs),
                                fetch_list=["o"], scope=Scope(),
                                use_jit=False)[0]
            counts = np.bincount(v, minlength=len(p)).astype(np.float64)
            live = p > 0
            gate = max(SEQ_Z, statistics.NormalDist().inv_cdf(
                1 - SEQ_FAMILY_ALPHA / (2 * int(live.sum()))))
            z = np.zeros_like(p)
            z[live] = np.abs(counts[live] / n - p[live]) / np.sqrt(
                p[live] * (1 - p[live]) / n)
            if (v.dtype != np.int64 or v.shape != (n,) or v.min() < 0
                    or v.max() >= len(p) or counts[~live].any()
                    or not (z <= gate).all()):
                fail("%s on %s: dtype %s, range [%d, %d], z %s (gate %g)"
                     % (op, d, v.dtype, v.min(), v.max(), z.tolist(), gate))
            rec["z_max_" + d.type] = float(z.max())
            rec["z_gate"] = gate
        out[op] = rec
    return out


def _sent_model(net, dtype="float32", use_peepholes=True, lstm_impl=None):
    """The book's ``convolution_net`` (``net="conv"``) or
    ``stacked_lstm_net`` (``"lstm"``) at SENT_BOOK's widths, in
    ``dtype``; ``lstm_impl`` set on every lstm op."""
    from paddle_tpu_torch import layers, nets, optimizer
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    if net == "conv":
        emb = layers.embedding(input=data, dtype=dtype,
                               size=[SENT_BOOK["vocab"], SENT_CONV["emb"]])
        convs = [nets.sequence_conv_pool(input=emb,
                                         num_filters=SENT_CONV["hid"],
                                         filter_size=fs, act="tanh",
                                         pool_type="sqrt") for fs in (3, 4)]
        prediction = layers.fc(input=convs, size=2, act="softmax")
    else:
        hid = SENT_LSTM["hid"]
        emb = layers.embedding(input=data, dtype=dtype,
                               size=[SENT_BOOK["vocab"], SENT_LSTM["emb"]])
        fc1 = layers.fc(input=emb, size=hid)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid, dtype=dtype,
                                       use_peepholes=use_peepholes)
        inputs = [fc1, lstm1]
        for i in range(2, SENT_LSTM["stacked"] + 1):
            fc = layers.fc(input=inputs, size=hid)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid, dtype=dtype,
                                          is_reverse=(i % 2) == 0,
                                          use_peepholes=use_peepholes)
            inputs = [fc, lstm]
        pools = [layers.sequence_pool(input=v, pool_type="max")
                 for v in inputs]
        prediction = layers.fc(input=pools, size=2, act="softmax")
    cost = layers.mean(layers.cross_entropy(input=prediction, label=label))
    if lstm_impl is not None:
        for op in cost.block.ops:
            if op.type == "lstm":
                op.attrs["lstm_impl"] = lstm_impl
    return {"cost": cost, "feed_list": [data, label],
            "optimizer": optimizer.Adam(
                learning_rate=SENT_BOOK["learning_rate"])}


def _srl_model(dtype="float32"):
    """``db_lstm`` of the book's test_label_semantic_roles.py at
    SRL_BOOK's widths in ``dtype``, with its CRF head: the cost the mean
    of ``linear_chain_crf`` over ``crfw`` (learning rate
    ``mix_hidden_lr``), ``crf_decoding`` the decoded path. As upstream,
    every fc is tanh and the word embedding ``emb`` is not trained (the
    book loads it pretrained; here it keeps its seeded values)."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.param_attr import ParamAttr
    w = SRL_BOOK
    feeds = [layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
             for n in SRL_FEED_NAMES]
    words, predicate, mark, target = feeds[:6], feeds[6], feeds[7], feeds[8]
    embs = [layers.embedding(input=x, size=[w["words"], w["word_dim"]],
                             dtype=dtype, param_attr=ParamAttr(
                                 name="emb", trainable=False))
            for x in words]
    embs.append(layers.embedding(input=predicate, dtype=dtype,
                                 size=[w["preds"], w["word_dim"]],
                                 param_attr=ParamAttr(name="vemb")))
    embs.append(layers.embedding(input=mark, dtype=dtype,
                                 size=[w["marks"], w["mark_dim"]]))
    hidden_0 = layers.sums(input=[layers.fc(input=e, size=w["hidden"],
                                            act="tanh") for e in embs])
    lstm_0, _ = layers.dynamic_lstm(input=hidden_0, size=w["hidden"],
                                    dtype=dtype, candidate_activation="relu",
                                    gate_activation="sigmoid",
                                    cell_activation="sigmoid")
    tmp = [hidden_0, lstm_0]
    for i in range(1, w["depth"]):
        mix = layers.sums(input=[
            layers.fc(input=tmp[0], size=w["hidden"], act="tanh"),
            layers.fc(input=tmp[1], size=w["hidden"], act="tanh")])
        lstm, _ = layers.dynamic_lstm(input=mix, size=w["hidden"],
                                      dtype=dtype,
                                      candidate_activation="relu",
                                      gate_activation="sigmoid",
                                      cell_activation="sigmoid",
                                      is_reverse=((i % 2) == 1))
        tmp = [mix, lstm]
    feature_out = layers.sums(input=[
        layers.fc(input=tmp[0], size=w["labels"], act="tanh"),
        layers.fc(input=tmp[1], size=w["labels"], act="tanh")])
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name="crfw",
                             learning_rate=w["mix_hidden_lr"]))
    decode = layers.crf_decoding(input=feature_out,
                                 param_attr=ParamAttr(name="crfw"))
    return {"cost": layers.mean(crf_cost), "feed_list": feeds,
            "decode": decode, "feature_out": feature_out,
            "optimizer": optimizer.SGD(learning_rate=w["learning_rate"])}


def _sent_batch(seed=0):
    """One fixed batch: SENT_BOOK["batch"] reviews of seeded lengths and
    ids, labels 0 / 1."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, SENT_BOOK["vocab"], (int(n), 1)).astype(
        np.int64), rng.randint(0, 2, (1,)).astype(np.int64))
        for n in _sent_lengths(seed)]


def _srl_batch(seed=0):
    """One fixed batch of SRL_BOOK["batch"] seeded CoNLL-05-shaped rows:
    words, the predicate's +-2 context broadcast over the sentence, the
    predicate, the 0 / 1 mark near it, the labels."""
    rng = np.random.RandomState(seed)
    out = []
    for n in _srl_lengths(seed):
        n = int(n)
        words = rng.randint(0, SRL_BOOK["words"], n)
        v = rng.randint(0, n)
        ctx = [np.full(n, words[min(max(v + o, 0), n - 1)])
               for o in (-2, -1, 0, 1, 2)]
        mark = (np.abs(np.arange(n) - v) <= 1).astype(np.int64)
        rows = [words] + ctx + [np.full(n, rng.randint(
            0, SRL_BOOK["preds"])), mark,
            rng.randint(0, SRL_BOOK["labels"], n)]
        out.append(tuple(np.asarray(r_, np.int64).reshape(-1, 1)
                         for r_ in rows))
    return out


def _seq_host_feed(names, batch):
    """The batch as host feeds: a LoDTensor a ragged slot, an array a
    dense one."""
    from paddle_tpu_torch.core.lod import build_lod_tensor
    feed = {}
    for j, n in enumerate(names):
        vals = [s[j] for s in batch]
        feed[n] = np.stack(vals) if n == "label" else \
            build_lod_tensor(vals)
    return feed


def _seq_build(build, device, dtype="float32"):
    """(main, startup, spec, trainer) of ``build(dtype)`` on ``device``,
    under a name guard."""
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        spec = build(dtype)
        fetch = [spec["decode"]] if "decode" in spec else None
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=device,
                          fetch_list=fetch, main_program=main_prog,
                          startup_program=startup)
    return main_prog, startup, spec, trainer


def _max_pools(prog):
    """(MaxIndex, X) names of each max ``sequence_pool`` of ``prog``."""
    return [(op.output("MaxIndex")[0], op.input("X")[0])
            for op in prog.global_block().ops if op.type == "sequence_pool"
            and str(op.attrs.get("pooltype", "")).upper() == "MAX"
            and op.output("MaxIndex")]


def _pool_flips(pools, got, ref):
    """Each max pool position where ``got``'s MaxIndex differs from
    ``ref``'s: the gap between the two largest inputs there in ``ref``
    over max(1, |the largest|)."""
    gaps = []
    for mi, x in pools:
        a, b = _fetched(got[mi]), _fetched(ref[mi])
        xv, offs = _fetched(ref[x]).astype(np.float64), ref[x].lod()[-1]
        for i, f in zip(*np.nonzero(a != b)):
            col = np.sort(xv[offs[i]:offs[i + 1], f])
            gaps.append(float((col[-1] - col[-2])
                              / max(1.0, abs(col[-1]))))
    return gaps


def _grad_gate(label, what, rel, gaps):
    """The gate of a step's gradients: SEQ_GRAD_REL_TOL (``tol``) with
    no max-pool flip, else every flip at a tie and SEQ_FLIP_GRAD_REL_TOL.
    Returns the gate."""
    worst = max(rel, key=rel.get)
    if gaps and not max(gaps) <= SEQ_TIE_TOL:
        fail("%s: a max pool picked another row where its inputs are %g "
             "apart (> %g)" % (label, max(gaps), SEQ_TIE_TOL))
    tol = SEQ_FLIP_GRAD_REL_TOL if gaps else SEQ_GRAD_REL_TOL
    if not rel[worst] <= tol:
        fail("%s: step-1 gradient of %s differs from %s by %g (relative "
             "norm) > %g, with %d max-pool flips" % (
                 label, worst, what, rel[worst], tol, len(gaps)))
    return tol


def _seq_grad_check(label, trainer, spec, feed, build):
    """Step 1 on the card (float32), fetching every parameter's @GRAD,
    against the port's own CPU run of ``build`` in float64 from the same
    weights and feed: the relative norm of each parameter's error, and
    the max pools that picked another row (``_grad_gate``)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, global_scope
    scope = global_scope()
    prog = trainer.main_program
    params = [p.name for p in prog.all_parameters() if p.trainable]
    # every parameter's value, the frozen ones too
    start = {p.name: scope.find_var(p.name).detach().cpu().double()
             for p in prog.all_parameters()}
    pools = _max_pools(prog)
    fetch = ([spec["cost"].name] + [n + "@GRAD" for n in params]
             + [n for pair in pools for n in pair])
    outs = trainer.exe.run(prog, feed=feed, fetch_list=fetch)
    main64, start64, spec64, tr64 = _seq_build(build, "cpu", "float64")
    scope64, exe64 = Scope(), Executor("cpu")
    exe64.run(start64, scope=scope64)
    for n, v in start.items():
        if tuple(scope64.find_var(n).shape) != tuple(v.shape):
            fail("%s: the float64 program's %s is %s, not %s" % (
                label, n, tuple(scope64.find_var(n).shape), tuple(v.shape)))
        scope64.set_var(n, v.clone())
    want = exe64.run(main64, feed=feed, fetch_list=fetch, scope=scope64,
                     use_jit=False)
    tr64.exe.close()
    rel = {}
    for n, g, w in zip(params, outs[1:], want[1:]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        rel[n] = float(np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                                   1e-30))
    gaps = _pool_flips(pools, dict(zip(fetch, outs)), dict(zip(fetch, want)))
    worst = max(rel, key=rel.get)
    checks = {"params_checked": len(params), "reference": "port, CPU, "
              "float64", "norm_rel_err": rel[worst], "worst_param": worst,
              "norm_rel_err_median": float(np.median(list(rel.values()))),
              "max_pool_flips": len(gaps), "flip_gaps": gaps,
              "loss": float(np.asarray(outs[0]).reshape(-1)[0]),
              "loss_abs_err": abs(float(np.asarray(outs[0]).reshape(-1)[0])
                                  - float(np.asarray(want[0]).reshape(-1)[0]))}
    log(json.dumps({label + "_grad_check": checks}))
    checks["tolerance_rel"] = _grad_gate(label, "the CPU's float64 run", rel,
                                         gaps)
    return checks, outs


def _seq_fused_vs_loop(label, trainer, spec, feed,
                       head_tol=FUSED_LOOP_REL_TOL):
    """The peephole-free LSTM net through row 7 against the same program
    on the time loop (``lstm_impl="scan"``, its generic grads too), on
    the card from the same state and feed: the loss and each lstm's
    Hidden within ``head_tol`` (relative norm), every @GRAD under
    ``_grad_gate``. The state is put back."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope()
    prog = trainer.main_program
    persist = [v.name for v in prog.list_vars() if v.persistable
               and scope.find_var(v.name) is not None]
    saved = {n: scope.find_var(n).clone() for n in persist}
    ops = prog.global_block().ops
    lstms = [op for op in ops if op.type == "lstm"]
    # the lstms and the generic grads that replay them
    routed = lstms + [op for op in ops if op.type == "generic_grad"
                      and op.attrs.get("__fwd_type__") == "lstm"]
    params = [p.name for p in prog.all_parameters() if p.trainable]
    pools = _max_pools(prog)
    heads = [spec["cost"].name] + [op.output("Hidden")[0] for op in lstms]
    grads = [n + "@GRAD" for n in params]
    fetch = heads + grads + [n for pair in pools for n in pair]
    got = {}
    for impl in ("pallas", "scan"):
        for op in routed:
            op.attrs["lstm_impl"] = impl
        for n, v in saved.items():
            scope.find_var(n).copy_(v)
        got[impl] = dict(zip(fetch, trainer.exe.run(
            prog, feed=feed, fetch_list=fetch, use_jit=False)))
    for op in routed:
        op.attrs["lstm_impl"] = "pallas"
    for n, v in saved.items():
        scope.find_var(n).copy_(v)
    rel = {}
    for n in heads + grads:
        a = _fetched(got["pallas"][n]).astype(np.float64)
        b = _fetched(got["scan"][n]).astype(np.float64)
        rel[n] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    gaps = _pool_flips(pools, got["pallas"], got["scan"])
    rec = {"loss_rel_err": rel[heads[0]],
           "hidden_rel_err": max(rel[n] for n in heads[1:]),
           "forward_tolerance_rel": head_tol,
           "grad_rel_err": max(rel[n] for n in grads),
           "grad_worst": max(grads, key=rel.get),
           "max_pool_flips": len(gaps), "flip_gaps": gaps}
    log(json.dumps({label + "_fused_vs_loop": rec}))
    worst_head = max(heads, key=rel.get)
    if not rel[worst_head] <= head_tol:
        fail("%s: %s through row 7 differs from the time loop by %g > %g"
             % (label, worst_head, rel[worst_head], head_tol))
    rec["grad_tolerance_rel"] = _grad_gate(
        label, "the time loop's", {n: rel[n] for n in grads}, gaps)
    return rec


def _seq_train(label, trainer, spec, batch, feed):
    """SEQ_STEPS compiled steps on the fixed batch through
    ``Trainer.train`` (one capture, a replay a step, the loss falls), then
    SEQ_STEPS per-op steps, each feeding the batch: (launch counts of the
    compiled run, a summary)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.trainer import BeginIteration, EndIteration
    dev = trainer.exe.device
    losses, step_s, marks = [], [], {}

    def handler(e):
        if isinstance(e, BeginIteration):
            marks["t"] = time.monotonic()
        elif isinstance(e, EndIteration):
            step_s.append(time.monotonic() - marks["t"])
            losses.append(e.cost)

    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    exe_before = dict(trainer.exe.stats)
    trainer.train(lambda: (batch for _ in range(SEQ_STEPS)), num_passes=1,
                  event_handler=handler)
    launches = kernels.launch_counts()
    delta = _exe_delta(trainer.exe, exe_before)
    _compiled_gate(label, delta, len(losses))
    if len(losses) != SEQ_STEPS or not (
            np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("%s: the loss did not fall on the fixed batch: %s"
             % (label, losses))
    peak = torch.cuda.max_memory_allocated(dev)
    eager_s = []
    for _ in range(SEQ_STEPS):
        t0 = time.monotonic()
        trainer.exe.run(trainer.main_program,
                        feed=trainer.feeder.feed(batch),
                        fetch_list=[spec["cost"]], use_jit=False)
        _sync(dev)
        eager_s.append(time.monotonic() - t0)
    p50, ep50 = float(np.median(step_s)), float(np.median(eager_s))
    n_seq = len(batch)
    tokens = int(sum(s[0].shape[0] for s in batch))
    rec = {"losses": losses, "executor": delta,
           "program_ops": len(trainer.main_program.global_block().ops),
           "step_ms_compiled": [t * 1e3 for t in step_s],
           "step_ms_p50_compiled": p50 * 1e3,
           "step_ms_p50_eager": ep50 * 1e3,
           "sequences_per_s_compiled": n_seq / p50,
           "sequences_per_s_eager": n_seq / ep50,
           "tokens_per_s_compiled": tokens / p50,
           "tokens_per_s_eager": tokens / ep50,
           "tokens": tokens, "peak_mem_bytes": peak,
           "launches": {k: v for k, v in launches.items() if v}}
    return launches, rec


def _viterbi_margins(em, trans, offs):
    """The CPU's float64 max-marginal margin of each position of each
    sequence: the best path's score less the best score of a path with
    another tag there; and the best paths."""
    start, end, tr = trans[0], trans[1], trans[2:]
    margins, paths = [], []
    for a, b in zip(offs, offs[1:]):
        e = em[a:b]
        T, K = e.shape
        fwd, bwd = np.zeros((T, K)), np.zeros((T, K))
        fwd[0] = start + e[0]
        for t in range(1, T):
            fwd[t] = (fwd[t - 1][:, None] + tr).max(0) + e[t]
        bwd[T - 1] = end
        for t in range(T - 2, -1, -1):
            bwd[t] = (tr + (e[t + 1] + bwd[t + 1])[None, :]).max(1)
        tot = fwd + bwd                       # best score through (t, k)
        best = tot.max(1)
        srt = np.sort(tot, axis=1)
        margins.append(best - srt[:, -2] if K > 1 else np.full(T, np.inf))
        paths.append(tot.argmax(1))
    return (np.concatenate(margins) if margins else np.zeros(0),
            np.concatenate(paths) if paths else np.zeros(0, np.int64))


def _srl_decode_check(trainer, spec, batch, feed):
    """The card's decoded path of the step's emissions against the
    CPU's (the same emissions and transition), compared where the CPU's
    float64 margin exceeds VITERBI_MARGIN_TOL; the chunk counts of a
    ``ChunkEvaluator`` program over the card's paths (the hybrid path)
    against the CPU's chunk_eval of the same paths, and of the CPU's
    own paths where no position was skipped."""
    from paddle_tpu_torch import evaluator, layers
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.scope import Scope, global_scope
    dev = trainer.exe.device
    em, path = trainer.exe.run(
        trainer.main_program, feed=feed,
        fetch_list=[spec["feature_out"], spec["decode"]], use_jit=False)
    offs = em.lod()[0]
    em_np = np.asarray(em.numpy())
    trans = global_scope().find_var("crfw").detach().cpu().numpy()
    margins, cpu_best = _viterbi_margins(em_np.astype(np.float64),
                                         trans.astype(np.float64), offs)
    card_path = np.asarray(path.numpy()).reshape(-1)
    sure = margins > VITERBI_MARGIN_TOL
    if not np.array_equal(card_path[sure], cpu_best[sure]):
        bad = int(np.flatnonzero(card_path[sure] != cpu_best[sure])[0])
        fail("srl: the card's decoded path differs from the CPU's at a "
             "position with margin %g > %g" % (margins[sure][bad],
                                               VITERBI_MARGIN_TOL))
    # the port's crf_decoding on the CPU, on the same emissions
    dec = _dense_program("crf_decoding",
                         {"Emission": [("em", (em_np, [offs]))],
                          "Transition": [("tr", trans)]},
                         {"ViterbiPath": ["o"]}, {})
    cpu_path = np.asarray(Executor("cpu").run(
        dec, feed=_dense_feed({"Emission": [("em", (em_np, [offs]))],
                               "Transition": [("tr", trans)]}),
        fetch_list=["o"], scope=Scope(), use_jit=False)[0]).reshape(-1)
    if not np.array_equal(cpu_path[sure], card_path[sure]):
        fail("srl: the port's CPU decode differs from the card's at a "
             "position past the margin")
    labels = np.concatenate([s[8] for s in batch])
    n_types = (SRL_BOOK["labels"] - 1) // 2
    main_prog, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        inf = layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = evaluator.ChunkEvaluator(inf, lab, "IOB", n_types)
    counts = {}
    for name, d, p in (("card", dev, card_path), ("cpu", "cpu", cpu_path)):
        exe, scope = Executor(d), Scope()
        exe.run(startup, scope=scope)
        exe.run(main_prog, feed={
            "inf": LoDTensor(p.reshape(-1, 1).astype(np.int64), [offs]),
            "lab": LoDTensor(labels, [offs])},
            fetch_list=[ev.metrics[0]], scope=scope)
        if exe.stats["hybrid_runs"] != 1:
            fail("srl: the ChunkEvaluator program did not run on the hybrid "
                 "path on %s: %s" % (d, exe.stats))
        counts[name] = [int(scope.find_var(s.name).cpu().numpy()[0])
                        for s in ev.states]
        exe.close()
    skipped = int((~sure).sum())
    if skipped == 0 and counts["card"] != counts["cpu"]:
        fail("srl: chunk counts %s on the card, %s on the CPU" % (
            counts["card"], counts["cpu"]))
    return {"positions": int(len(card_path)), "skipped_near_ties": skipped,
            "min_margin": float(margins.min()) if len(margins) else None,
            "chunk_counts_card": counts["card"],
            "chunk_counts_cpu": counts["cpu"],
            "paths_equal": bool(np.array_equal(card_path, cpu_path))}


def _seq_model(dev, label, build, names, batch, fused=False,
               grad_batch=None, loop_tol=FUSED_LOOP_REL_TOL, keep=None):
    """One model of phase 19 (and of phase 20): built on the card, step-1
    gradients against the CPU's float64 run on ``grad_batch`` (default
    ``batch``), (the fused net against the time loop, its heads within
    ``loop_tol``), the compiled and per-op runs: (launches, record).
    ``keep(trainer, spec, feed)``, when given, runs last in the trainer's
    scope and its result goes into the record as ``kept``."""
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    main_prog, startup, spec, trainer = _seq_build(build, dev)
    feed = _seq_host_feed(names, batch)
    grad_feed = feed if grad_batch is None else _seq_host_feed(names,
                                                               grad_batch)
    seconds, extra, t0 = {}, {}, [time.monotonic()]

    def lap(name):
        seconds[name] = time.monotonic() - t0[0]
        t0[0] += seconds[name]

    with scope_guard(Scope()):
        trainer._maybe_init()
        if fused:
            extra["fused_vs_loop"] = _seq_fused_vs_loop(label, trainer, spec,
                                                        feed, loop_tol)
        lap("init")
        checks, _ = _seq_grad_check(label, trainer, spec, grad_feed, build)
        lap("grad_check")
        launches, rec = _seq_train(label, trainer, spec, batch, feed)
        lap("train")
        if "decode" in spec:
            extra["decode"] = _srl_decode_check(trainer, spec, batch, feed)
            lap("decode")
        kept = keep(trainer, spec, feed) if keep is not None else None
    rec.update(extra, grad_check=checks, seconds=seconds)
    log(json.dumps({label: rec}))
    if keep is not None:
        rec["kept"] = kept
    trainer.exe.close()
    del trainer
    torch.cuda.empty_cache()
    return launches, rec


def _d128_record(dev, lengths):
    """Row 7 at the peephole-free sentiment LSTM's population (N 128
    ragged rows, D 128, T the longest review)."""
    return _row7_record(dev, lengths, SENT_LSTM["hid"] // 4,
                        "fused_lstm_d128_n128")


def _row7_record(dev, lengths, D, name):
    """Row 7 at a model's population (N ragged rows of ``lengths``, D, T
    the longest): against its plain version (a second launch
    bit-identical), the kernel's, the plain version's and cuDNN's times,
    and the bound of this batch's work (each input read once, each
    output written once; the recurrent products of the steps inside the
    sequences)."""
    from paddle_tpu_torch.kernels import fused_lstm
    N, T = len(lengths), int(max(lengths))
    rng = np.random.RandomState(3)
    xs = torch.from_numpy((rng.randn(T, N, 4 * D) * 0.5).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(D, 4 * D) / np.sqrt(D)).astype(
        np.float32)).to(dev)
    h0 = torch.zeros(N, D, device=dev)
    c0 = torch.zeros(N, D, device=dev)
    mask = torch.from_numpy((np.arange(T)[:, None] < np.asarray(
        lengths)[None, :]).astype(np.float32)).to(dev)
    got = fused_lstm.fused_lstm(xs, w, h0, c0, mask)
    again = fused_lstm.fused_lstm(xs, w, h0, c0, mask)
    want = fused_lstm.fused_lstm_reference(xs, w, h0, c0, mask)
    err = _rel_err(list(got), list(want))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    nbytes = 4 * (xs.numel() + w.numel() + h0.numel() + c0.numel()
                  + mask.numel() + 2 * T * N * D)
    flops = 2 * int(sum(lengths)) * D * 4 * D
    b_ms, b_by = bound(nbytes, flops)
    lib = _cudnn_lstm(xs, w, h0, c0)
    rec = {"shape": {"T": T, "N": N, "D": D,
                     "lengths_sum": int(sum(lengths))},
           "max_rel_err": err, "tolerance_rel": RNN_REL_TOL,
           "max_abs_err": max(float((g - w_).abs().max())
                              for g, w_ in zip(got, want)),
           "second_launch_bit_identical": all(
               torch.equal(a, b) for a, b in zip(got, again)),
           "launch": fused_lstm.launch_plan(N, D),
           "ms": time_ms(lambda: fused_lstm._launch(xs, w, h0, c0, mask),
                         flush=flush),
           "plain_ms": time_ms(lambda: fused_lstm.fused_lstm_reference(
               xs, w, h0, c0, mask), iters=5, flush=flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "tc_bound_ms": tc_bound(nbytes, flops),
           "library_ms": time_ms(lib, flush=flush),
           "library": "cuDNN torch.nn.LSTM as in phase 7 (unmasked, all T "
                      "steps of every row)"}
    del flush
    log(json.dumps({name: rec}))
    if not err <= RNN_REL_TOL or not rec["second_launch_bit_identical"]:
        fail("row 7 at D %d, N %d: error %g (gate %g), relaunch "
             "bit-identical %s" % (D, N, err, RNN_REL_TOL,
                                   rec["second_launch_bit_identical"]))
    return rec


def phase_sequence(dev, root):
    """Phase 19: the sequence stack. Every new op and grad on the card
    against the CPU (and the samplers against their laws); the two
    sentiment nets and the semantic role tagger at the book's widths
    through ``Trainer.train``; row 7 at the peephole-free sentiment LSTM's
    population. Returns ({path: launches}, row 7's D 128 record)."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    t0 = time.monotonic()
    old_dir = FLAGS.tune_cache_dir
    FLAGS.tune_cache_dir = _fresh_dir(os.path.join(
        root, "build", "chip_smoke", "tune_sequence"))
    tune.clear_memory_cache()
    paths, recs = {}, {}
    try:
        t_ops = time.monotonic()
        log(json.dumps({"sequence_ops": _sequence_ops_check(dev),
                        "seconds": time.monotonic() - t_ops}))
        sent = _sent_batch(0)
        for label, build, fused in (
                ("sentiment_conv", lambda dt: _sent_model("conv", dt),
                 False),
                ("sentiment_lstm", lambda dt: _sent_model("lstm", dt),
                 False),
                ("sentiment_lstm_fused", lambda dt: _sent_model(
                    "lstm", dt, use_peepholes=False, lstm_impl="pallas"),
                 True)):
            paths["sequence_" + label], recs[label] = _seq_model(
                dev, label, build, ("words", "label"), sent, fused)
        fused = recs["sentiment_lstm_fused"]["launches"].get("fused_lstm", 0)
        want = 2 * SENT_LSTM["stacked"] * SEQ_STEPS
        if fused != want:
            fail("sentiment_lstm_fused: %d fused_lstm launches over %d "
                 "steps, expected %d (%d layers, the forward and its replay "
                 "in the generic grad)" % (fused, SEQ_STEPS, want,
                                           SENT_LSTM["stacked"]))
        if recs["sentiment_lstm"]["launches"].get("fused_lstm", 0):
            fail("sentiment_lstm (peepholes) launched the fused LSTM")
        paths["sequence_srl"], recs["srl"] = _seq_model(
            dev, "srl", _srl_model, SRL_FEED_NAMES, _srl_batch(0))
        d128 = _d128_record(dev, [s[0].shape[0] for s in sent])
    finally:
        FLAGS.tune_cache_dir = old_dir
        tune.clear_memory_cache()
    log(json.dumps({
        "sequence_wall_s": time.monotonic() - t0,
        "summary": {k: {"step_ms_p50_compiled": r["step_ms_p50_compiled"],
                        "step_ms_p50_eager": r["step_ms_p50_eager"],
                        "sequences_per_s": r["sequences_per_s_compiled"],
                        "tokens_per_s": r["tokens_per_s_compiled"],
                        "peak_mem_bytes": r["peak_mem_bytes"]}
                    for k, r in recs.items()},
        "fused_lstm_d128_n128_ms": d128["ms"],
        "card": card_line()}))
    return paths, d128


# -- phase 20: control flow ---------------------------------------------------

# the RNN encoder-decoder of tests/book/test_rnn_encoder_decoder.py:21-62
# at the widths of the Paddle book's chapter 8: dictionaries of 30000
# words (source and target), words, hidden and decoder 512; a batch of 64
# pairs of 10 to 30 source tokens by the rule of the JAX package's
# synthetic wmt14 (the target the shifted, reversed source). Adagrad at
# 1e-4: at the book test's 0.05 (its widths are 16) the first step moves
# each weight by about 0.05, and on the card the loss of the fixed batch
# rose from 10.29 to 18.53 over 8 steps
ENCDEC_BOOK = dict(dict_size=30000, word_dim=512, hidden=512, batch=64,
                   min_len=10, max_len=30, learning_rate=1e-4)
ENCDEC_FEEDS = ("source_sequence", "target_sequence", "label_sequence")
# the step-1 gradient check's float64 CPU run takes the first 16 pairs
ENCDEC_GRAD_PAIRS = 16
# row 7's Hidden (and the loss) against the time loop on the same
# program on the card, relative norm
ROW7_LOOP_TOL = 1e-6
# the beam-search translator of tests/book/test_machine_translation.py
# :55-92 at the same widths: 16 sources, beam 3, 30 steps, end id 1
# (wmt14's <e>), every beam started from <s>
DECODE_BOOK = dict(sources=16, beam_size=3, max_length=30, end_id=1)
DECODE_RUNS = 4
# a step where the CPU's candidates at a source's beam edge (the beam's
# last and the first left out, or two adjacent inside it) lie within
# this relative gap may select either way on the card
DECODE_TIE_TOL = 1e-5
# the path the JAX package's Executor takes on the decode program on the
# CPU, a run (a host op in a While body: the per-op path);
# tests/test_torch_control_flow_book.py holds the JAX package to it
DECODE_PATH = {"jit_runs": 0, "eager_runs": 1, "hybrid_runs": 0}
# the op sweep's ragged batch: 64 sequences of 10 to 30, ties among them
# and one of length 1 (a row dead from the second step)
CF_LENGTHS = tuple([1, 30, 30] + list(np.random.RandomState(20).randint(
    10, 31, 61)))
CF_WIDTH = 512


def _cf_programs(build):
    """(main, startup, fetch names) of ``build(layers)`` under a name
    guard, the startup seeded."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import ir, unique_name
    main_prog, startup = ir.Program(), ir.Program()
    startup.random_seed = 20
    with unique_name.guard(), ir.program_guard(main_prog, startup):
        fetch = build(layers)
    return main_prog, startup, [f if isinstance(f, str) else f.name
                                for f in fetch]


def _cf_loss_grads(L, loss, inputs):
    """[loss] and its gradients against every parameter of its program
    and the vars ``inputs`` (``calc_gradient``)."""
    from paddle_tpu_torch.core.backward import calc_gradient
    for v in inputs:
        v.stop_gradient = False
    wrt = list(loss.block.program.all_parameters()) + list(inputs)
    return [loss] + [g for g in calc_gradient(loss, wrt) if g is not None]


def _cf_case_while_sum(L):
    d = [L.data("d%d" % k, shape=[CF_WIDTH], append_batch_size=False)
         for k in range(3)]
    i = L.zeros(shape=[1], dtype="int64")
    mem = L.array_write(x=L.zeros(shape=[CF_WIDTH], dtype="float32"), i=i)
    data = L.array_write(x=d[0], i=i)
    for k in (1, 2):
        i = L.increment(i)
        L.array_write(d[k], i, array=data)
    i = L.zeros(shape=[1], dtype="int64")
    n = L.fill_constant(shape=[1], dtype="int64", value=3)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        s = L.sums(input=[L.array_read(array=data, i=i),
                          L.array_read(array=mem, i=i)])
        i = L.increment(x=i, in_place=True)
        L.array_write(s, i=i, array=mem)
        L.less_than(x=i, y=n, cond=cond)
    return [L.array_read(array=mem, i=i), L.logical_and(
        L.greater_equal(i, n), L.logical_or(L.equal(i, n),
                                            L.not_equal(i, n)))]


def _cf_case_dynamic_rnn(L):
    x = L.data("x", shape=[CF_WIDTH], dtype="float32", lod_level=1)
    c = L.data("c", shape=[CF_WIDTH], dtype="float32")
    context = L.fc(c, size=CF_WIDTH, act="tanh")
    rnn = L.DynamicRNN()
    with rnn.block():
        w_t = rnn.step_input(x)
        pre = rnn.memory(init=context)
        cur = L.fc([w_t, pre], size=CF_WIDTH, act="tanh")
        rnn.update_memory(pre, cur)
        rnn.output(cur)
    out = rnn()
    last = L.sequence_last_step(out)
    loss = L.elementwise_add(L.mean(out), L.mean(L.elementwise_mul(last,
                                                                   last)))
    return [out, last] + _cf_loss_grads(L, loss, [x, c])


def _cf_case_arrays(L):
    x = L.data("x", shape=[CF_WIDTH], dtype="float32", lod_level=1)
    table = L.lod_rank_table(x)
    arr = L.lod_tensor_to_array(x, table)
    i0 = L.zeros(shape=[1], dtype="int64")
    first = L.shrink_memory(L.array_read(arr, i0), i0, table)
    back = L.array_to_lod_tensor(arr, table)
    ranked = L.reorder_lod_tensor_by_rank(x, table)
    loss = L.sums([L.mean(first), L.mean(L.elementwise_mul(back, back)),
                   L.mean(L.scale(ranked, scale=3.0))])
    return [back, ranked, L.array_length(arr), L.max_sequence_len(table)] \
        + _cf_loss_grads(L, loss, [x])


def _cf_case_static_rnn(L):
    T, N = max(CF_LENGTHS), len(CF_LENGTHS)
    x = L.data("xs", shape=[T, N, CF_WIDTH], append_batch_size=False)
    boot = L.data("boot", shape=[N, CF_WIDTH], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_pre = rnn.memory(init=boot)
        h = L.fc([x_t, h_pre], size=CF_WIDTH, act="tanh")
        rnn.update_memory(h_pre, h)
        rnn.step_output(h)
    out = rnn()
    return [out] + _cf_loss_grads(L, L.mean(out), [x, boot])


def _cf_case_ifelse(L):
    N = len(CF_LENGTHS)
    x = L.data("xd", shape=[N, CF_WIDTH], append_batch_size=False)
    y = L.data("y", shape=[N, 1], dtype="int64", append_batch_size=False)
    ie = L.IfElse(L.less_than(y, L.fill_constant(shape=[N, 1],
                                                 dtype="int64", value=5)))
    for block, act in ((ie.true_block, "tanh"), (ie.false_block, "relu")):
        with block():
            ie.output(L.fc(ie.input(x), size=CF_WIDTH, act=act))
    out = ie()[0]
    return [out] + _cf_loss_grads(L, L.mean(L.elementwise_mul(out, out)),
                                  [x])


def _cf_case_split_merge_lod(L):
    x = L.data("x", shape=[CF_WIDTH], dtype="float32", lod_level=1)
    m = L.data("m", shape=[len(CF_LENGTHS)], dtype="bool",
               append_batch_size=False)
    t, f = L.split_lod_tensor(x, m)
    out = L.merge_lod_tensor(in_true=L.scale(t, scale=2.0),
                             in_false=L.tanh(f), x=x, mask=m)
    return [t, f, out] + _cf_loss_grads(L, L.reduce_sum(out), [x])


def _cf_case_switch(L):
    a = L.data("a", shape=[1], append_batch_size=False)
    out = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                              persistable=True, name="cf_switch_out")
    sw = L.Switch()
    with sw.case(L.less_than(a, L.fill_constant([1], "float32", 0.0))):
        L.assign(L.scale(a, scale=-1.0), out)
    with sw.case(L.less_equal(a, L.fill_constant([1], "float32", 1.0))):
        L.assign(L.scale(a, scale=10.0), out)
    with sw.default():
        L.assign(a, out)
    return [out]


def _cf_case_beam(L):
    pre = L.data("pre", shape=[1], dtype="int64", lod_level=2)
    ids = L.data("ids", shape=[3], dtype="int64")
    sc = L.data("sc", shape=[3], dtype="float32")
    sel_ids, sel_sc = L.beam_search(pre, ids, sc, beam_size=3, end_id=1)
    i = L.zeros(shape=[1], dtype="int64")
    ids_arr = L.array_write(pre, i)
    sc_arr = L.array_write(L.data("pre_sc", shape=[1], dtype="float32",
                                  lod_level=2), i)
    i = L.increment(i)
    L.array_write(sel_ids, i, array=ids_arr)
    L.array_write(sel_sc, i, array=sc_arr)
    sent, sent_sc = L.beam_search_decode(ids_arr, sc_arr)
    return [sel_ids, sel_sc, sent, sent_sc]


def _cf_feed(rng, lod_mod):
    """The sweep's feeds, made from ``rng``."""
    N, W = len(CF_LENGTHS), CF_WIDTH
    T = max(CF_LENGTHS)
    x = lod_mod.build_lod_tensor([
        (rng.randn(n, W) * 0.5).astype(np.float32) for n in CF_LENGTHS])
    n_pref = 2 * N
    lod2 = [list(range(0, n_pref + 1, 2)), list(range(n_pref + 1))]
    pre_ids = rng.randint(2, 50, (n_pref, 1)).astype(np.int64)
    pre_ids[::7] = 1  # ended prefixes carry themselves on
    return {"x": x, "c": rng.randn(N, W).astype(np.float32),
            "d0": rng.randn(W).astype(np.float32),
            "d1": rng.randn(W).astype(np.float32),
            "d2": rng.randn(W).astype(np.float32),
            "xs": (rng.randn(T, N, W) * 0.5).astype(np.float32),
            "boot": rng.randn(N, W).astype(np.float32),
            "xd": rng.randn(N, W).astype(np.float32),
            "y": rng.randint(0, 10, (N, 1)).astype(np.int64),
            "m": rng.rand(N) < 0.5, "a": np.array([0.5], np.float32),
            "pre": lod_mod.LoDTensor(pre_ids, lod2),
            "pre_sc": lod_mod.LoDTensor(rng.rand(n_pref, 1).astype(
                np.float32), lod2),
            "ids": rng.randint(2, 30000, (n_pref, 3)).astype(np.int64),
            "sc": np.sort(rng.rand(n_pref, 3).astype(np.float32))[:, ::-1]
            .copy()}


# (label, the op types it runs beside the grads, builder)
CF_CASES = [
    ("while_array_sum", ("while", "write_to_array", "read_from_array",
                         "less_than", "greater_equal", "equal",
                         "not_equal", "logical_and", "logical_or"),
     _cf_case_while_sum),
    ("dynamic_rnn", ("lod_rank_table", "max_sequence_len",
                     "lod_tensor_to_array", "lod_tensor_to_array_grad",
                     "array_to_lod_tensor", "array_to_lod_tensor_grad",
                     "shrink_rnn_memory", "reorder_lod_tensor_by_rank",
                     "while", "while_grad", "write_to_array",
                     "write_to_array_grad", "read_from_array"),
     _cf_case_dynamic_rnn),
    ("arrays", ("lod_rank_table", "lod_tensor_to_array",
                "lod_tensor_to_array_grad", "read_from_array",
                "read_from_array_grad", "shrink_rnn_memory",
                "shrink_rnn_memory_grad", "array_to_lod_tensor",
                "array_to_lod_tensor_grad", "reorder_lod_tensor_by_rank",
                "lod_array_length", "max_sequence_len"), _cf_case_arrays),
    ("static_rnn", ("recurrent",), _cf_case_static_rnn),
    ("ifelse_dense", ("split_lod_tensor", "split_lod_tensor_grad",
                      "merge_lod_tensor", "merge_lod_tensor_grad"),
     _cf_case_ifelse),
    ("split_merge_lod", ("split_lod_tensor", "split_lod_tensor_grad",
                         "merge_lod_tensor", "merge_lod_tensor_grad"),
     _cf_case_split_merge_lod),
    ("switch", ("conditional_block", "less_equal"), _cf_case_switch),
    ("beam_search", ("beam_search", "beam_search_decode"), _cf_case_beam),
]


def _control_flow_ops_check(dev):
    """Every case of CF_CASES, its grads with it, on the card and on the
    CPU from one seeded state on one seeded feed, on the per-op path:
    ids, offsets and selections bit-identical, floats within SEQ_OP_TOL
    of max(1, |CPU value|). By op, the largest error; every op of the
    slice is among them."""
    from paddle_tpu_torch.core import lod as tlod
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.registry import registered_ops
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    cpu = torch.device("cpu")
    per_op = collections.OrderedDict()
    for label, ops, build in CF_CASES:
        main_prog, startup, fetch = _cf_programs(build)
        scope = Scope()
        Executor(cpu).run(startup, scope=scope)
        state = scope_to_numpy(scope)
        got = {}
        for d in (dev, cpu):
            feed = _cf_feed(np.random.RandomState(20), tlod)
            sc = scope_from_numpy(state, device=d)
            got[d.type] = Executor(d).run(main_prog, feed=feed,
                                          fetch_list=fetch, scope=sc,
                                          use_jit=False)
        worst = _dense_compare(label, label, fetch, got[dev.type],
                               got["cpu"], False, tol=SEQ_OP_TOL,
                               what="control flow case")
        ran = {op.type for blk in main_prog.blocks for op in blk.ops}
        grads = {op.attr("__fwd_type__") + "_grad" for blk in
                 main_prog.blocks for op in blk.ops
                 if op.type == "generic_grad"}
        for op in ops:
            if op not in ran and op not in grads:
                fail("control flow case %s runs no %s" % (label, op))
        for op in sorted(ran | grads):
            rec = per_op.setdefault(op, {"cases": [], "max_abs_err": 0.0,
                                         "max_rel_err": 0.0})
            rec["cases"].append(label)
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     worst["max_abs_err"])
            rec["max_rel_err"] = max(rec["max_rel_err"],
                                     worst["max_rel_err"])
    from paddle_tpu_torch.core import registry
    missing = sorted(n for n in registered_ops() if registry.lookup(
        n).lower.__module__.endswith(".control_flow_ops") and n not in per_op)
    if missing:
        fail("the control flow sweep ran no %s" % missing)
    return per_op


def _encdec_model(dtype="float32"):
    """The RNN encoder-decoder at ENCDEC_BOOK's widths, both encoder
    LSTMs on row 7 (``lstm_impl="pallas"``)."""
    from paddle_tpu_torch.models import machine_translation as tmt
    w = ENCDEC_BOOK
    return tmt.encoder_decoder(dict_size=w["dict_size"],
                               word_dim=w["word_dim"], hidden=w["hidden"],
                               dtype=dtype, lstm_impl="pallas",
                               learning_rate=w["learning_rate"])


def _encdec_batch(seed=0):
    from paddle_tpu_torch.models import machine_translation as tmt
    w = ENCDEC_BOOK
    return tmt.wmt14_pairs(w["batch"], w["dict_size"], seed=seed,
                           min_len=w["min_len"], max_len=w["max_len"])


def _encdec_memory(trainer, spec, feed):
    """The memory planner's predicted peak of the step, priced as the
    Executor's preflight prices it (state and feeds from their tensors,
    the batch the feeds' longest dim), and the parameters, for the
    decode."""
    from paddle_tpu_torch.analysis import memory as mem
    from paddle_tpu_torch.core.scope import global_scope
    prog = trainer.main_program
    scope = global_scope()
    dev_feed = trainer.exe.prepare_feed(feed)
    sizes, batch = {}, 0
    for n in trainer.exe._state_inputs(prog, scope, dev_feed):
        v = scope.find_var(n)
        sizes[n] = v.numel() * v.element_size()
    for n, v in dev_feed.items():
        data = v.data if hasattr(v, "lod") else v
        sizes[n] = data.numel() * data.element_size()
        batch = max(batch, int(data.shape[0]))
    plan = mem.plan_memory(prog, batch=batch, fetches=[spec["cost"]],
                           sizes_override=sizes, vmem=False)
    params = {p.name: scope.find_var(p.name).detach().cpu().clone()
              for p in prog.all_parameters()}
    return {"predicted_peak_bytes": plan.peak_bytes,
            "params": params}


def _edge_gaps(scores, pre_ids, src_offs, beam, end_id):
    """Per source, the smallest relative gap between adjacent candidates
    among the best ``beam`` + 1 (the CPU's), as ``beam_search`` ranks
    them."""
    gaps = []
    for s in range(len(src_offs) - 1):
        cands = []
        for p in range(src_offs[s], src_offs[s + 1]):
            if pre_ids[p] == end_id:
                cands.append(float(scores[p, 0]))
            else:
                cands.extend(float(v) for v in scores[p])
        top = sorted(cands, reverse=True)[:beam + 1]
        gaps.append(min((abs(a - b) / max(abs(a), abs(b), 1e-30)
                         for a, b in zip(top, top[1:])), default=np.inf))
    return gaps


def _decode_spy():
    """Wrap ``beam_search``'s lowering: each call's candidates, the
    prefixes' last ids and source offsets, and its selection, as host
    arrays, appended to the list returned; ``restore()`` unwraps."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor import read_on_host
    opdef = registry.lookup_checked("beam_search")
    real, steps = opdef.lower, []

    def spy(ctx):
        real(ctx)
        pre = ctx.input("pre_ids")
        steps.append({
            "scores": read_on_host(ctx.input("scores")),
            "pre_ids": read_on_host(pre).reshape(-1),
            "src_offs": read_on_host(pre.lod[0]).tolist(),
            "selected": read_on_host(ctx.env[ctx.op.output(
                "selected_ids")[0]]).reshape(-1).tolist(),
            "selected_lod": [l.tolist() for l in ctx.env[ctx.op.output(
                "selected_ids")[0]].lod]})

    opdef.lower = spy

    def restore():
        opdef.lower = real
    return steps, restore


def _decode_check(dev, trained):
    """(c): the translator's decode program at the encoder-decoder's
    widths over 16 synthetic sources, from one state on the card and on
    the CPU: the seeded startup's weights, those of the trained (b)
    where a name and a shape agree. Sentences (ids, LoD) equal but after
    a step whose CPU candidates tie at a beam's edge (DECODE_TIE_TOL,
    each printed), scores within SEQ_OP_TOL of max(1, |score|), each
    run's path DECODE_PATH; ms a decoded batch."""
    from paddle_tpu_torch.models import machine_translation as tmt
    from paddle_tpu_torch.core import lod as tlod
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    w, d = ENCDEC_BOOK, DECODE_BOOK
    main_prog, startup, fetch = _cf_programs(lambda L: tmt.nmt_decode(
        L, dict_size=w["dict_size"], word_dim=w["word_dim"],
        hidden=w["hidden"], beam_size=d["beam_size"],
        max_length=d["max_length"], end_id=d["end_id"]))
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    state = scope_to_numpy(scope)
    taken = sorted(n for n, v in trained.items()
                   if n in state and tuple(v.shape) == state[n].shape)
    for n in taken:
        state[n] = trained[n].numpy()
    sources = [r[0] for r in tmt.wmt14_pairs(
        d["sources"], w["dict_size"], seed=1, min_len=w["min_len"],
        max_len=w["max_len"])]
    spied, outs, ms = {}, {}, []
    for where in ("cpu", "card"):
        device = dev if where == "card" else torch.device("cpu")
        exe = Executor(device)
        sc = scope_from_numpy(state, device=device)
        for run in range(DECODE_RUNS if where == "card" else 1):
            feed = tmt.decode_feed(tlod, sources)
            before = dict(exe.stats)
            steps, restore = _decode_spy() if run == 0 else (None, None)
            _sync(device)
            t0 = time.monotonic()
            try:
                got = exe.run(main_prog, feed=feed, fetch_list=fetch,
                              scope=sc)
            finally:
                if restore is not None:
                    restore()
            _sync(device)
            if run > 0:
                ms.append((time.monotonic() - t0) * 1e3)
            path = {k: exe.stats[k] - before[k] for k in DECODE_PATH}
            if path != DECODE_PATH:
                fail("decode on the %s took %s a run, the JAX package's "
                     "Executor %s" % (where, path, DECODE_PATH))
            if run == 0:
                spied[where], outs[where] = steps, got
    ties, diverged = [], None
    for t, (a, b) in enumerate(zip(spied["card"], spied["cpu"])):
        gaps = _edge_gaps(b["scores"], b["pre_ids"], b["src_offs"],
                          d["beam_size"], d["end_id"])
        tied = [s for s, g in enumerate(gaps) if g <= DECODE_TIE_TOL]
        if tied:
            ties.append({"step": t, "sources": tied,
                         "gaps": [gaps[s] for s in tied]})
            log(json.dumps({"decode_tie": ties[-1]}))
        if diverged is None and (a["selected"] != b["selected"] or
                                 a["selected_lod"] != b["selected_lod"]):
            diverged = t
            if not tied:
                fail("decode: step %d selects other ids on the card with "
                     "no tie at a beam's edge on the CPU (smallest gap %g)"
                     % (t, min(gaps)))
    (ids_c, sc_c), (ids_h, sc_h) = outs["card"], outs["cpu"]
    rec = {"sources": d["sources"], "beam_size": d["beam_size"],
           "max_length": d["max_length"], "steps": len(spied["cpu"]),
           "params_from_train": taken, "ties": ties,
           "diverged_at_step": diverged, "path": DECODE_PATH,
           "ms_per_batch": ms, "ms_per_batch_p50": float(np.median(ms)),
           "sentences": len(ids_h.lod()[1]) - 1,
           "tie_tolerance_rel": DECODE_TIE_TOL}
    if diverged is None:
        if ids_c.lod() != ids_h.lod() or not np.array_equal(
                _fetched(ids_c), _fetched(ids_h)):
            fail("decode: the card's sentences differ from the CPU's")
        err = float(np.abs(_fetched(sc_c).astype(np.float64)
                           - _fetched(sc_h)).max())
        rec["score_max_abs_err"] = err
        if not err <= SEQ_OP_TOL * max(1.0, float(np.abs(_fetched(
                sc_h)).max())):
            fail("decode: scores differ from the CPU's by %g" % err)
    n_src = len(ids_h.lod()[0]) - 1
    if n_src != d["sources"] or ids_h.lod()[0][-1] != n_src * d[
            "beam_size"]:
        fail("decode: %d sources, %d sentences" % (n_src,
                                                    ids_h.lod()[0][-1]))
    log(json.dumps({"decode": rec}))
    return rec


def phase_control_flow(dev, root):
    """Phase 20: control flow. Every op of the slice and its grad on the
    card against the CPU; the RNN encoder-decoder at the book's widths
    (step-1 gradients against the CPU's float64 run on 16 pairs, row 7
    against the time loop, compiled and per-op steps); the beam-search
    translator's decode against the CPU; row 7 at the encoder's
    population. Returns ({path: launches}, row 7's record)."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.flags import FLAGS
    t0 = time.monotonic()
    old_dir = FLAGS.tune_cache_dir
    FLAGS.tune_cache_dir = _fresh_dir(os.path.join(
        root, "build", "chip_smoke", "tune_control_flow"))
    tune.clear_memory_cache()
    try:
        t_ops = time.monotonic()
        log(json.dumps({"control_flow_ops": _control_flow_ops_check(dev),
                        "seconds": time.monotonic() - t_ops}))
        batch = _encdec_batch(0)
        launches, rec = _seq_model(
            dev, "encdec", _encdec_model, ENCDEC_FEEDS, batch, fused=True,
            grad_batch=batch[:ENCDEC_GRAD_PAIRS], loop_tol=ROW7_LOOP_TOL,
            keep=_encdec_memory)
        kept = rec.pop("kept")
        want = 2 * 2 * SEQ_STEPS
        if launches.get("fused_lstm", 0) != want:
            fail("encdec: %d fused_lstm launches over %d steps, expected %d "
                 "(two LSTMs, the forward and its replay in the generic "
                 "grad)" % (launches.get("fused_lstm", 0), SEQ_STEPS, want))
        trg_tokens = int(sum(s[1].shape[0] for s in batch))
        rec["target_tokens"] = trg_tokens
        rec["target_tokens_per_s_compiled"] = (
            trg_tokens / rec["step_ms_p50_compiled"] * 1e3)
        rec["target_tokens_per_s_eager"] = (
            trg_tokens / rec["step_ms_p50_eager"] * 1e3)
        rec["predicted_peak_bytes"] = kept["predicted_peak_bytes"]
        decode = _decode_check(dev, kept["params"])
        row7 = _row7_record(dev, [s[0].shape[0] for s in batch],
                            ENCDEC_BOOK["hidden"],
                            "fused_lstm_encdec_d512_n64")
        row7["population"] = ("the encoder's forward and is_reverse LSTMs "
                              "of phase 20 (b)")
    finally:
        FLAGS.tune_cache_dir = old_dir
        tune.clear_memory_cache()
    log(json.dumps({
        "control_flow_wall_s": time.monotonic() - t0,
        "summary": {"encdec": {
            k: rec[k] for k in ("step_ms_p50_compiled", "step_ms_p50_eager",
                                "target_tokens_per_s_compiled",
                                "target_tokens_per_s_eager",
                                "peak_mem_bytes", "predicted_peak_bytes")},
            "row7_launches": launches.get("fused_lstm", 0),
            "decode_ms_per_batch_p50": decode["ms_per_batch_p50"],
            "decode_ties": len(decode["ties"])},
        "fused_lstm_encdec_d512_n64_ms": row7["ms"],
        "card": card_line()}))
    return {"control_flow_encdec": launches}, row7


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
    compiled_paths, plain_steps = timed(12, phase_compiled, dev, root)
    checkpoint_paths = timed(13, phase_checkpoint, dev, root)
    optim_paths = timed(14, phase_optimization, dev, plain_steps)
    memory_paths = timed(15, phase_memory, dev, root, plain_steps)
    resilience_paths = timed(16, phase_resilience, dev, root, plain_steps)
    dense_paths = timed(17, phase_dense, dev, root)
    zoo_paths, first_conv = timed(18, phase_convnet_zoo, dev, root)
    kernels["conv3x3_fwd"]["vgg16_first_conv"] = first_conv
    seq_paths, d128 = timed(19, phase_sequence, dev, root)
    kernels["fused_lstm"]["d128_n128"] = d128
    cf_paths, encdec = timed(20, phase_control_flow, dev, root)
    kernels["fused_lstm"]["encdec_d512_n64"] = encdec
    log(json.dumps({"seconds": round(time.monotonic() - t_start, 3)}))
    paths = {"serve": serve_launches, **spec_paths, **disagg_paths,
             "train": train5["launches"],
             "convnet_train": convnet_launches,
             "rnn_train_lstm": lstm_launches,
             "rnn_train_gru": gru_launches,
             "tuned_train": tuned_launches,
             "convnet_conv3x3_consult": consult_launches, **amp_paths,
             **compiled_paths, **checkpoint_paths, **optim_paths,
             **memory_paths, **resilience_paths, **dense_paths,
             **zoo_paths, **seq_paths, **cf_paths}
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
