"""Type vocabulary of the IR — the port's copy of
``paddle_tpu/fluid/core/types.py``.

Dtypes are canonical numpy dtype strings, the spelling the serialized
program carries; ``torch_dtype`` maps one onto the runtime type.
"""

from __future__ import annotations

import numpy as np
import torch


class VarType:
    """Kinds of variables a Block can declare (reference
    framework.proto:119).  The port runs dense tensors; the sequence
    (``lod_tensor``) and sparse-row kinds are declared for the wire
    format only."""

    DENSE_TENSOR = "dense_tensor"
    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    RNG_STATE = "rng_state"
    RAW = "raw"


FP32 = "float32"
FP64 = "float64"
FP16 = "float16"
BF16 = "bfloat16"
INT8 = "int8"
INT16 = "int16"
INT32 = "int32"
INT64 = "int64"
BOOL = "bool"

_ALL_DTYPES = {FP32, FP64, FP16, BF16, INT8, INT16, INT32, INT64, BOOL, "uint8"}


def canonical_dtype(dtype) -> str:
    """Normalise any dtype spelling (np dtype, torch dtype, str) to a
    canonical string."""
    if dtype is None:
        return FP32
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", None) or str(dtype)
    if name in ("bfloat16", "bf16"):
        return BF16
    if name not in _ALL_DTYPES:
        raise ValueError(f"unsupported dtype: {dtype!r} -> {name}")
    return name


def torch_dtype(name: str) -> torch.dtype:
    """Canonical string -> torch dtype."""
    return getattr(torch, canonical_dtype(name))


# the reference's runtime has no 64-bit types: int64 and float64 values
# narrow to int32 and float32, and programs record the narrowed dtype
_NARROW = {INT64: INT32, FP64: FP32}


def runtime_dtype(dtype) -> str:
    """The canonical dtype a value of ``dtype`` has at run time."""
    name = canonical_dtype(dtype)
    return _NARROW.get(name, name)


def is_float_dtype(name: str) -> bool:
    return name in (FP32, FP64, FP16, BF16)
