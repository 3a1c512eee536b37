"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu, for an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Module names mirror the JAX package's. Four slices
are ported, the serving path and three training paths, over shared
kernels:

- the generative serving path: ``models/transformer.py``'s serving face,
  ``serving/`` (paged KV pool, continuous-batching engine, service and
  the ``:generate`` HTTP endpoint), ``inference.py`` (the generative
  artifact, the JAX package's format);
- the Fluid training path: ``core/`` (Program IR, registry, scope, the
  per-op ``Executor``, ``append_backward``), ``layers/``, ``ops/`` (the
  lowerings of the transformer LM's training step), ``optimizer.py``
  (SGD, Momentum, Adam), ``reader/``, ``data_feeder.py``,
  ``trainer.py`` and the ``transformer_lm`` Program builder;
- the conv-net training path: the conv2d, pool2d, batch_norm, softmax,
  cross_entropy and metric ops and ``models/resnet.py``;
- the sequence (LoD) training path: ``core/lod.py``, ragged feeds and
  the Executor's ``LoDValue``, ``ops/sequence_ops.py`` (sequence_pool,
  lstm, gru) and ``layers/sequence.py``;
- ``kernels/``: hand-written CUDA kernels (paged-attention decode,
  flash-attention forward and backward, the 3x3 / s1 / p1 convolution,
  the fused LSTM and GRU recurrences), each beside its plain PyTorch
  version;
- ``cli.py``: ``python -m paddle_tpu_torch train <config.py>`` and
  ``serve <artifact_dir>``.

Entry points take ``device`` (default ``"cuda"``) and raise when no card
is present, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from .device import DEFAULT_DEVICE, NoDeviceError, resolve_device

__all__ = ["DEFAULT_DEVICE", "NoDeviceError", "resolve_device"]
