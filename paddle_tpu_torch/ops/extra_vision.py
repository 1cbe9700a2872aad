"""Weight-only quantization (``paddle_tpu/ops/extra_vision.py``, the two
functions the serving path needs).

Codes are symmetric absmax: int8 in [-127, 127], or int4 in [-7, 7]
nibble-packed to (ceil(K/2), N) int8 — byte i holds row 2i in its low
nibble and row 2i+1 in its high nibble, with a zero pad row for odd K.
Scales are f32, per output channel (N,) or group-wise (ceil(K/g), N).
Rounding is half to even, as ``jnp.round``, and every division has a
tensor divisor (CUDA turns a division by a Python scalar into a
multiplication by its reciprocal), so the codes and scales equal the JAX
package's bit for bit on either device.
"""

from __future__ import annotations

import torch


def _unpack_int4(packed):
    """(ceil(in/2), out) int8 → (in, out) int8 values in [-7, 7] (the
    packer's zero pad row included)."""
    p = packed.to(torch.int32)
    low = ((p & 0xF) ^ 8) - 8                  # sign-extend the low nibble
    high = p >> 4                              # arithmetic shift
    return torch.stack([low, high], dim=1).reshape(
        -1, packed.shape[-1]).to(torch.int8)


def _weight_quantize_pure(weight, algo="weight_only_int8", group_size=-1):
    """(in, out) weight → (codes, f32 scales); ``group_size`` -1 gives
    per-output-channel scales (out,), 64/128 group-wise (ceil(in/g), out)."""
    from ..quantization.observers import groupwise_absmax_scales

    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1, 64 or 128, "
                         f"got {group_size}")
    if algo == "weight_only_int4":
        qmax, bits = 7.0, 4
    elif algo in ("weight_only_int8", "llm.int8"):
        qmax, bits = 127.0, 8
    else:
        raise NotImplementedError(f"algo {algo!r} not supported")
    if group_size == -1:
        absmax = weight.abs().amax(dim=0)
        scale = torch.clamp(absmax / weight.new_tensor(qmax), min=1e-12)
        rows = scale[None, :]
    else:
        scale = torch.clamp(
            groupwise_absmax_scales(weight, group_size, bits), min=1e-12)
        rows = scale.repeat_interleave(group_size, dim=0)[:weight.shape[0]]
    q = torch.clamp(torch.round(weight / rows), -qmax, qmax)
    if algo == "weight_only_int4":
        q = q.to(torch.int32)
        if q.shape[0] % 2:
            q = torch.cat([q, q.new_zeros((1, q.shape[1]))])
        packed = ((q[1::2] & 0xF) << 4) | (q[0::2] & 0xF)
        return (packed.to(torch.uint8).view(torch.int8),
                scale.to(torch.float32))
    return q.to(torch.int8), scale.to(torch.float32)
