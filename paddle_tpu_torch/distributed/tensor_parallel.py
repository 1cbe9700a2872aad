"""``TensorParallel`` (``paddle_tpu/distributed/tensor_parallel.py``), one
process a rank.

The layers already hold their shards and run their collectives (a model
after ``models.llama.apply_llama_tensor_parallel``, or built from
``mp_layers``). The wrapper adds the hybrid data-parallel half: with a dp
degree above 1 it broadcasts the parameters from the first rank of this
rank's dp group (the ranks holding the same shards) and attaches a
``GradReducer`` over the dp group (``sharding_configs["comm_buffer_size_MB"]``
a bucket), which ``jit.TrainStep`` picks up as ``_grad_reducer``. Inputs are
each rank's local batch: the dp ranks' batches in dp-rank order are the
global batch, and the mp ranks of one dp group take the same batch.
"""

from __future__ import annotations

from ..nn.layer import Layer


class TensorParallel(Layer):
    def __init__(self, layers: Layer, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        if hcg is not None and hcg.get_data_parallel_world_size() > 1:
            from .data_parallel import GradReducer, broadcast_parameters

            cfg = getattr(strategy, "sharding_configs", None) or {}
            group = hcg.get_data_parallel_group()
            named = list(layers.named_parameters())
            broadcast_parameters(named, group)
            self._grad_reducer = GradReducer(
                bucket_mb=cfg.get("comm_buffer_size_MB", 25)).attach(
                    named, group)
            layers._grad_reducer = self._grad_reducer

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True, *, recurse=None):
        return self._layers.parameters(
            include_sublayers if recurse is None else recurse)

    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        return self._layers.named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)
