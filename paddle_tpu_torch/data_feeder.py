"""DataFeeder: reader minibatches -> the Executor's feed dict
(counterpart of ``paddle_tpu/data_feeder.py``). Each field of the
samples is stacked into a numpy array of its variable's dtype and shape
and moved to the feeder's device as a tensor. A field of a variable
with ``lod_level > 0`` holds one sequence a sample (nested lists for
deeper levels): :class:`DataToLoDTensorConverter` concatenates them
into a host ``LoDTensor`` with the offsets of every level, and the
feeder moves it to the device as a ``LoDValue``."""
from __future__ import annotations

import numpy as np
import torch

from .core.executor import to_lod_value
from .core.ir import Variable, default_main_program
from .core.lod import LoDTensor, lengths_to_offsets
from .core.types import convert_dtype
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DataFeeder", "DataToLoDTensorConverter"]


class DataToLoDTensorConverter(object):
    """One ragged field of a minibatch (copy of
    ``paddle_tpu/data_feeder.py:16``): ``feed`` takes a sample's value,
    ``done`` returns the ``LoDTensor`` of all of them, its data shaped
    ``(-1,) + shape`` and each level's lengths turned into offsets."""

    def __init__(self, lod_level, shape, dtype):
        self.lod_level = lod_level
        self.shape = tuple(s for s in shape if s != -1) if shape else ()
        self.dtype = dtype
        self.data = []
        self.lod = [[] for _ in range(lod_level)]

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def done(self):
        flat = np.array(self.data, dtype=self.dtype)
        if self.shape:
            try:
                flat = flat.reshape((-1,) + self.shape)
            except ValueError:
                pass
        if flat.ndim == 1:
            flat = flat.reshape(-1, 1)
        return LoDTensor(flat, [lengths_to_offsets(l) for l in self.lod])


class DataFeeder(object):
    def __init__(self, feed_list, device=DEFAULT_DEVICE, program=None):
        self.device = resolve_device(device)
        self.feed_names, self.feed_shapes, self.feed_dtypes = [], [], []
        self.feed_lod_levels = []
        for var in feed_list:
            if isinstance(var, str):
                var = (program or default_main_program()).global_block() \
                    .var(var)
            if not isinstance(var, Variable):
                raise TypeError("feed_list entries must be Variables/names")
            self.feed_names.append(var.name)
            self.feed_lod_levels.append(var.lod_level or 0)
            self.feed_shapes.append(tuple(s for s in (var.shape or ())
                                          if s != -1))
            self.feed_dtypes.append(convert_dtype(var.dtype))

    def feed(self, iterable, device=None):
        """Minibatch (iterable of per-sample field tuples) -> {name:
        tensor, or ``LoDValue`` for a ragged field, on the feeder's
        device, or on ``device`` (the feed pipeline builds on the host)}."""
        device = self.device if device is None else torch.device(device)
        fields = [[] for _ in self.feed_names]
        for sample in iterable:
            if len(sample) != len(fields):
                raise ValueError("sample has %d fields, feed_list expects %d"
                                 % (len(sample), len(fields)))
            for value, acc in zip(sample, fields):
                acc.append(value)
        out = {}
        for name, shape, dtype, lod_level, acc in zip(
                self.feed_names, self.feed_shapes, self.feed_dtypes,
                self.feed_lod_levels, fields):
            if lod_level:
                conv = DataToLoDTensorConverter(lod_level, shape, dtype)
                for value in acc:
                    conv.feed(value)
                out[name] = to_lod_value(conv.done(), device)
                continue
            arr = np.array(acc, dtype=dtype)
            if shape and arr.ndim == 1:
                arr = arr.reshape((-1,) + shape)
            out[name] = torch.as_tensor(arr, device=device)
        return out
