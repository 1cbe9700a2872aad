"""``Linear`` and ``Embedding`` with the JAX package's parameter layouts.

They hold weights; the serving path reads them as a flat ``{name: tensor}``
dict (``Layer.param_dict``) and applies them through the fusion pass, as
the training forward does with ``named_parameters``. ``Embedding.forward``
is the training forward's token gather.
"""

from __future__ import annotations

import torch

from ..framework.contract import refuse_unported
from .layer import Layer

#: std of the seeded normal init for matmul and embedding weights
INIT_STD = 0.02


class Linear(Layer):
    """y = x @ W (+ b), W shaped (in_features, out_features) — the JAX
    package's layout, which the kernels read as K×N row-major. As there,
    ``bias_attr=None`` makes a zero bias and ``bias_attr=False`` none (the
    models' projections)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        refuse_unported("Linear", weight_attr=(weight_attr, None))
        if bias_attr is not False:
            refuse_unported("Linear", bias_attr=(bias_attr, None))
        self.weight = self.create_parameter(
            (in_features, out_features), dtype=dtype, device=device,
            generator=generator, std=INIT_STD)
        self.bias = self.create_parameter(
            (out_features,), attr=False if bias_attr is False else None,
            dtype=dtype, is_bias=True, device=device)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(Layer):
    """Padding rows and sparse gradients are not ported."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        refuse_unported("Embedding", padding_idx=(padding_idx, None),
                        sparse=(sparse, False),
                        weight_attr=(weight_attr, None))
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), dtype=dtype, device=device,
            generator=generator, std=INIT_STD)

    def forward(self, x):
        return self.weight[x]
