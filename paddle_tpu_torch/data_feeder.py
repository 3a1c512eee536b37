"""DataFeeder: reader minibatches -> the Executor's feed dict
(counterpart of ``paddle_tpu/data_feeder.py``). Each field of the
samples is stacked into a numpy array of its variable's dtype and shape
and moved to the feeder's device as a tensor. Ragged (LoD) fields are
not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from .core.ir import Variable, default_main_program
from .core.types import convert_dtype
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DataFeeder"]


class DataFeeder(object):
    def __init__(self, feed_list, device=DEFAULT_DEVICE, program=None):
        self.device = resolve_device(device)
        self.feed_names, self.feed_shapes, self.feed_dtypes = [], [], []
        for var in feed_list:
            if isinstance(var, str):
                var = (program or default_main_program()).global_block() \
                    .var(var)
            if not isinstance(var, Variable):
                raise TypeError("feed_list entries must be Variables/names")
            if var.lod_level:
                raise NotImplementedError(
                    "feed %r has lod_level %d: ragged feeds are not ported "
                    "to paddle_tpu_torch yet" % (var.name, var.lod_level))
            self.feed_names.append(var.name)
            self.feed_shapes.append(tuple(s for s in (var.shape or ())
                                          if s != -1))
            self.feed_dtypes.append(convert_dtype(var.dtype))

    def feed(self, iterable):
        """Minibatch (iterable of per-sample field tuples) -> {name:
        tensor on the device}."""
        fields = [[] for _ in self.feed_names]
        for sample in iterable:
            if len(sample) != len(fields):
                raise ValueError("sample has %d fields, feed_list expects %d"
                                 % (len(sample), len(fields)))
            for value, acc in zip(sample, fields):
                acc.append(value)
        out = {}
        for name, shape, dtype, acc in zip(self.feed_names, self.feed_shapes,
                                           self.feed_dtypes, fields):
            arr = np.array(acc, dtype=dtype)
            if shape and arr.ndim == 1:
                arr = arr.reshape((-1,) + shape)
            out[name] = torch.as_tensor(arr, device=self.device)
        return out
