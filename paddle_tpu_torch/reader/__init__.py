"""Reader decorators (the ``batch`` part of ``paddle_tpu/reader``). A
reader is a no-argument function returning an iterable of samples."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Group the samples of ``reader`` into lists of ``batch_size``; the
    last, shorter list is kept unless ``drop_last``."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
