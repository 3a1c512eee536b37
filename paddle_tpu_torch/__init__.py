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
  generative artifact, the JAX package's format) and
  ``analysis/memory.py`` (its PT034 memory-budget check);
- the Fluid training path: ``core/`` (Program IR, registry, scope, the
  ``Executor`` with its compiled step captured as a CUDA graph, its
  per-op and hybrid paths, ``append_backward``), ``layers/``, ``ops/``
  (the lowerings of the transformer LM's training step, the host IO
  ops), ``optimizer.py`` (SGD, Momentum, Adam), ``reader/``,
  ``data_feeder.py``, ``io.py`` (save and load), ``pipeline.py`` (the
  feed pipeline), ``trainer.py`` and the ``transformer_lm`` Program
  builder;
- the conv-net training path: the conv2d, pool2d, batch_norm, softmax,
  cross_entropy and metric ops and ``models/resnet.py``;
- the sequence (LoD) training path: ``core/lod.py``, ragged feeds and
  the Executor's ``LoDValue``, ``ops/sequence_ops.py`` (sequence_pool,
  lstm, gru) and ``layers/sequence.py``;
- the autotune path: ``tune/`` (search spaces over the kernels'
  compiled tilings, the autotune loop, the CRC-checked winner cache,
  the dispatch counters), its consult in ``mul`` and ``conv2d``, and
  ``resilience/`` (the event log and the two tune fault sites);
- ``kernels/``: hand-written CUDA kernels (paged-attention decode,
  flash-attention forward and backward, the 3x3 / s1 / p1 convolution,
  the fused LSTM and GRU recurrences, the blocked matmul), each beside
  its plain PyTorch version;
- AMP: ``amp.py`` (``enable(program, pure=)``, bfloat16 operands and
  float32 sums in ``mul`` and ``conv2d`` and their grads, the bfloat16
  faces of the conv3x3 and matmul kernels);
- ``cli.py``: ``python -m paddle_tpu_torch train <config.py>``,
  ``serve <artifact_dir>`` and ``tune <config.py>``.

Entry points take ``device`` (default ``"cuda"``) and raise when no card
is present, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from . import amp
from .device import DEFAULT_DEVICE, NoDeviceError, resolve_device

__all__ = ["DEFAULT_DEVICE", "NoDeviceError", "amp", "resolve_device"]
