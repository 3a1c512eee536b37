"""Variable kinds and dtypes (copy of ``paddle_tpu/core/types.py``), with
the map from the Program's numpy dtypes to ``torch`` dtypes."""
from __future__ import annotations

import enum

import numpy as np
import torch

try:
    import ml_dtypes

    bfloat16 = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover
    bfloat16 = np.dtype("float32")

__all__ = ["VarType", "bfloat16", "convert_dtype", "is_floating",
           "torch_dtype"]


class VarType(enum.Enum):
    """Kinds of variables a Block can hold (the JAX package's enum)."""

    LOD_TENSOR = 1
    SELECTED_ROWS = 2
    LOD_TENSOR_ARRAY = 3
    LOD_RANK_TABLE = 4
    STEP_SCOPES = 5
    FETCH_LIST = 6
    FEED_MINIBATCH = 7
    READER = 8
    RAW = 9


_DTYPES = {
    "float32": np.dtype("float32"),
    "float64": np.dtype("float64"),
    "float16": np.dtype("float16"),
    "bfloat16": bfloat16,
    "int8": np.dtype("int8"),
    "uint8": np.dtype("uint8"),
    "int16": np.dtype("int16"),
    "int32": np.dtype("int32"),
    "int64": np.dtype("int64"),
    "bool": np.dtype("bool"),
}

_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def convert_dtype(dtype) -> np.dtype:
    """Normalise any dtype spec (str | np.dtype | torch.dtype) to np.dtype."""
    if dtype is None:
        return _DTYPES["float32"]
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        if dtype in _DTYPES:
            return _DTYPES[dtype]
        return np.dtype(dtype)
    return np.dtype(dtype)


def is_floating(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in (_DTYPES["float32"], _DTYPES["float64"], _DTYPES["float16"],
                 _DTYPES["bfloat16"])


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a Program dtype spec."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = convert_dtype(dtype)
    name = "bfloat16" if d == bfloat16 and d != _DTYPES["float32"] \
        else d.name
    return _TORCH[name]
