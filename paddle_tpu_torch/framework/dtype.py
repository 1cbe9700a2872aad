"""Dtype names (the JAX package's strings) to torch dtypes."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; a torch dtype passes through."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
