"""Activation recomputation (``paddle_tpu/distributed/recompute.py``).

The JAX package lowers ``recompute`` to ``jax.checkpoint``; the port runs
``torch.utils.checkpoint`` in its non-reentrant form: the block's
activations are dropped after the forward and rebuilt by running the block
again when backward first needs them. What a granularity keeps beyond the
block input is the caller's choice (``models/llama.py``: under
``core_attn`` with ``flash_save_residuals`` the attention's (out, lse)).
Every argument rides the recompute as an input, never as a closure: an
attention mask passed here reaches the recomputed block as the same tensor
and gets no gradient (the attention returns none for it).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    backward; a plain call when autograd is not recording."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
