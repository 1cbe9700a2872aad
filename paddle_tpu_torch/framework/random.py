"""Seeded random state: an explicit ``torch.Generator`` per use.

The JAX package threads ``jax.random`` keys; the port hands an explicit
generator to every initializer. The two give different numbers from the
same seed, so tests make shared inputs with numpy.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        int(seed))
