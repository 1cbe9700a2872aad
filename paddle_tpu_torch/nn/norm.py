"""``RMSNorm`` — the weight is initialized to ones, as in the JAX package.

The serving path applies it through ``models.llama._pure_rms`` (folded into
the following matmul by the fusion pass), so the module holds the weight.
"""

from __future__ import annotations

from .layer import Layer


class RMSNorm(Layer):
    def __init__(self, hidden_size, dtype, device):
        super().__init__()
        self.weight = self.create_parameter((hidden_size,), dtype, device,
                                            fill=1.0)
