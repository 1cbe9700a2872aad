"""Group-wise absmax scales (``paddle_tpu/quantization/observers.py``)."""

from __future__ import annotations

import torch


def groupwise_absmax_scales(x, group_size, quant_bits):
    """THE group-wise absmax scale rule: an (in, out) weight → (ceil(in/g),
    out) scales over groups of ``group_size`` input channels, K zero-padded
    up to a multiple of the group. ``ops/extra_vision._weight_quantize_pure``
    uses it, so the packer and the kernels dequantize against one layout.
    The divisor is a tensor, so CUDA divides exactly (IEEE) as the JAX
    package does rather than multiplying by a rounded reciprocal."""
    k, n = x.shape
    pad = (-k) % group_size
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    grouped = xp.reshape(-1, group_size, n)
    qmax = 2.0 ** (quant_bits - 1) - 1
    return grouped.abs().amax(dim=1) / x.new_tensor(qmax)  # (ceil(k/g), n)
