"""``RMSNorm`` — the weight is initialized to ones, as in the JAX package.

The serving path applies it through ``models.llama._pure_rms`` (folded into
the following matmul by the fusion pass), so there the module only holds
the weight. Its ``forward`` (training) is ``fused_rms_norm``: kernel K6
forward saving rstd, K7 backward (``ops/kernels/fused_norm_rope.py``), as
the JAX package's ``F.rms_norm`` reaches its ``fused_rms_norm``.
"""

from __future__ import annotations

from .layer import Layer


class RMSNorm(Layer):
    def __init__(self, hidden_size, dtype, device, epsilon=1e-6):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter((hidden_size,), dtype, device,
                                            fill=1.0)

    def forward(self, x, plain=False):
        """``plain``: the kernels' plain versions on any device (the
        on-card reference)."""
        from ..ops.kernels.fused_norm_rope import fused_rms_norm

        return fused_rms_norm(x, self.weight, self._epsilon, plain=plain)
