"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu, for an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Module names mirror the JAX package's. Five slices
are ported, the serving path, three training paths and the autotune
path, over shared kernels, with AMP on the training paths:

- the generative serving path: ``models/transformer.py``'s serving face,
  ``serving/`` (paged KV pool, continuous-batching engine, disaggregated
  prefill and decode tiers, service and the ``:generate`` /
  ``:prefill`` / ``:decode`` HTTP endpoint), ``inference.py`` (the
  generative artifact, the JAX package's format) and the PT034
  memory-budget check;
- static checks: ``analysis/`` (the program verifier's rules
  PT001-PT017, the memory planner PT030-PT034, the Executor's verify
  hook and memory preflight under ``FLAGS.verify``) and ``debugger.py``
  (pseudo-code printer, graphviz ``.dot`` drawer);
- the Fluid training path: ``core/`` (Program IR, registry, scope, the
  ``Executor`` with its compiled step captured as a CUDA graph, its
  per-op and hybrid paths, each value freed at its last use,
  ``append_backward`` and ``calc_gradient``), ``layers/``, ``ops/``
  (the lowerings of the transformer LM's training step, the host IO
  ops), ``optimizer.py`` (the nine optimizers and ``ModelAverage``),
  ``clip.py``, ``regularizer.py``, ``learning_rate_decay.py``,
  ``reader/``,
  ``data_feeder.py``, ``io.py`` (save and load, inference models),
  ``checkpoint.py`` (async, atomic, CRC-checked checkpoints),
  ``core/serialize.py`` (the protostr), ``pipeline.py`` (the feed
  pipeline), ``trainer.py`` (with resume, preemption and ``test``), the
  ``transformer_lm`` Program builder and ``models/lenet.py``;
- the conv-net training path: the conv2d, pool2d, batch_norm, softmax,
  cross_entropy and metric ops and ``models/resnet.py``; the conv knobs
  (``matmul``, ``nhwc``, the s2d stem), the transposed, 3-D and
  depthwise convs, ``pool3d``, dropout, ``lrn`` and the rest of the nn
  and metric ops, ``nets.py``, ``evaluator.py`` and
  ``models/{mlp,vgg,alexnet,googlenet}.py``;
- the sequence (LoD) training path: ``core/lod.py``, ragged feeds and
  the Executor's ``LoDValue``, ``ops/sequence_ops.py`` (sequence_pool,
  lstm, gru) and ``layers/sequence.py``;
- the autotune path: ``tune/`` (search spaces over the kernels'
  compiled tilings, the autotune loop, the CRC-checked winner cache,
  the dispatch counters) and its consult in ``mul`` and ``conv2d``;
- resilience and observability: ``resilience/`` (the event log, durable
  events, the fault sites and the ``PADDLE_TPU_FAULT_SPEC`` grammar, the
  step watchdog and the numeric guardrails the Trainer arms under
  ``FLAGS.step_timeout_s`` / ``loss_skip_budget``) and ``profiler.py``
  (every subsystem's counters, the timeline artifact, a
  ``torch.profiler`` trace of the card);
- ``kernels/``: hand-written CUDA kernels (paged-attention decode,
  flash-attention forward and backward, the 3x3 / s1 / p1 convolution,
  the fused LSTM and GRU recurrences, the blocked matmul), each beside
  its plain PyTorch version;
- AMP: ``amp.py`` (``enable(program, pure=)``, bfloat16 operands and
  float32 sums in ``mul`` and ``conv2d`` and their grads, the bfloat16
  faces of the conv3x3 and matmul kernels);
- ``cli.py``: ``python -m paddle_tpu_torch train <config.py>``,
  ``serve <artifact_dir>``, ``tune <config.py>`` and ``lint
  <config.py>``.

Entry points take ``device`` (default ``"cuda"``) and raise when no card
is present, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from . import amp
from .core.backward import append_backward, calc_gradient
from .device import DEFAULT_DEVICE, NoDeviceError, resolve_device

__all__ = ["DEFAULT_DEVICE", "NoDeviceError", "amp", "append_backward",
           "calc_gradient", "resolve_device"]
