"""Weight bridge: fill a port model from the JAX model's parameters.

The caller builds the numpy dict (``{n: np.asarray(p._array) for n, p in
jax_model.named_parameters()}``); this module never imports the JAX
package. Names and shapes must match exactly — linear weights keep the
(in, out) layout on both sides, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def load_numpy_params(model, params: dict) -> None:
    """Copy ``params`` ({name: ndarray}) into ``model``'s parameters, cast
    to each parameter's dtype. Raises on a missing or extra name or a
    shape mismatch; nothing is copied unless every entry matches."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, arr in params.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(own[name].shape)}")
    with torch.no_grad():
        for name, arr in params.items():
            a = np.asarray(arr)
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)  # e.g. bfloat16 from ml_dtypes
            own[name].copy_(torch.tensor(a))
