"""LoDTensor: a ragged batch of sequences on the host (copy of
``paddle_tpu/core/lod.py``).

A dense array plus "level of detail" offsets: a minibatch of
variable-length sequences is stored concatenated, with no padding, and
``lod()[level]`` holds the row offsets of each sequence (reference:
paddle/fluid/framework/lod_tensor.h). The Executor turns a fed
``LoDTensor`` into a ``LoDValue`` on the device
(``core/executor.py``), whose sequence ops rebuild segment ids or a
padded layout from the offsets.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["LoDTensor", "build_lod_tensor", "lengths_to_offsets",
           "offsets_to_lengths", "offsets_to_segment_ids"]


class LoDTensor(object):
    def __init__(self, data=None, lod: Sequence[Sequence[int]] = None):
        self._data = None if data is None else np.asarray(data)
        self._lod: List[List[int]] = [list(l) for l in lod] if lod else []

    # -- reference-parity API ------------------------------------------------
    def set(self, array, place=None):
        self._data = np.asarray(array)

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self) -> List[List[int]]:
        return self._lod

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = [lengths_to_offsets(l) for l in lengths]

    def recursive_sequence_lengths(self):
        return [offsets_to_lengths(l) for l in self._lod]

    def has_valid_recursive_sequence_lengths(self) -> bool:
        if not self._lod:
            return True
        for level, offs in enumerate(self._lod):
            if not offs or offs[0] != 0 or any(b < a for a, b in zip(offs, offs[1:])):
                return False
            nxt = (self._lod[level + 1] if level + 1 < len(self._lod)
                   else list(range(self.shape[0] + 1)) if self._data is not None else None)
            if nxt is not None and offs[-1] != len(nxt) - 1:
                return False
        return True

    def numpy(self) -> np.ndarray:
        return self._data

    def __array__(self, dtype=None):
        return self._data if dtype is None else self._data.astype(dtype)

    @property
    def shape(self):
        return self._data.shape if self._data is not None else None

    @property
    def dtype(self):
        return self._data.dtype if self._data is not None else None

    @property
    def lod_level(self):
        return len(self._lod)

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self.shape, self._lod)


# -- offset/length/segment-id conversions ------------------------------------

def lengths_to_offsets(lengths) -> List[int]:
    offs = [0]
    for l in lengths:
        offs.append(offs[-1] + int(l))
    return offs


def offsets_to_lengths(offsets) -> List[int]:
    return [int(b - a) for a, b in zip(offsets, offsets[1:])]


def offsets_to_segment_ids(offsets, total=None) -> np.ndarray:
    """[0,2,5] -> [0,0,1,1,1]; the device-side form sequence ops consume.
    A mark at ``total`` (a trailing empty sequence) is dropped, as the
    device-side ``ops/sequence_ops.segment_ids`` drops it; the JAX
    package's host copy raises ``IndexError`` there."""
    offsets = np.asarray(offsets, dtype=np.int64)
    total = int(offsets[-1]) if total is None else total
    ids = np.zeros(total, dtype=np.int32)
    marks = offsets[1:-1]
    np.add.at(ids, marks[marks < total], 1)
    return np.cumsum(ids).astype(np.int32)


def build_lod_tensor(data_list, place=None) -> LoDTensor:
    """Concatenate a python list of per-sequence arrays into one LoDTensor.

    reference: python/paddle/fluid/data_feeder.py:118 (DataToLoDTensorConverter)
    and lod_tensor.md's create_lod_tensor.
    """
    arrays = [np.asarray(a) for a in data_list]
    lengths = [a.shape[0] for a in arrays]
    t = LoDTensor(np.concatenate(arrays, axis=0) if arrays else np.zeros((0,)),
                  [lengths_to_offsets(lengths)])
    return t
