"""``Linear`` and ``Embedding`` with the JAX package's parameter layouts.

They hold weights; the serving path reads them as a flat ``{name: tensor}``
dict (``Layer.param_dict``) and applies them through the fusion pass, as
the training forward does with ``named_parameters``. ``Embedding.forward``
is the training forward's token gather.
"""

from __future__ import annotations

from .layer import Layer

#: std of the seeded normal init for matmul and embedding weights
INIT_STD = 0.02


class Linear(Layer):
    """y = x @ W, no bias, W shaped (in_features, out_features) — the JAX
    package's layout, which the kernels read as K×N row-major."""

    def __init__(self, in_features, out_features, dtype, device,
                 generator=None):
        super().__init__()
        self.weight = self.create_parameter(
            (in_features, out_features), dtype, device, generator,
            std=INIT_STD)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, dtype, device,
                 generator=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), dtype, device, generator,
            std=INIT_STD)

    def forward(self, ids):
        return self.weight[ids]
