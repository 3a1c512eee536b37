"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu, for an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Module names mirror the JAX package's. The first
slice is the generative serving path:

- ``models/transformer.py``: the transformer LM's serving face;
- ``kernels/``: hand-written CUDA kernels (paged-attention decode,
  flash-attention forward), each beside its plain PyTorch version;
- ``serving/``: paged KV pool, continuous-batching engine, service and
  the ``:generate`` HTTP endpoint;
- ``inference.py``: the generative artifact, the JAX package's format;
- ``cli.py``: ``python -m paddle_tpu_torch serve <artifact_dir>``.

Entry points take ``device`` (default ``"cuda"``) and raise when no card
is present, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from .device import DEFAULT_DEVICE, NoDeviceError, resolve_device

__all__ = ["DEFAULT_DEVICE", "NoDeviceError", "resolve_device"]
