"""Power-of-two length buckets (``paddle_tpu/jit/bucketing.py``).

PyTorch runs eagerly and needs no static shapes, but the serving path
keeps the JAX package's prompt-width rule so both pad prompts alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def default_buckets(max_len: int, min_bucket: int = 64) -> Tuple[int, ...]:
    """Powers of two from min_bucket up to max_len (inclusive)."""
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(f"length {length} exceeds largest bucket "
                     f"{max(buckets)}")
