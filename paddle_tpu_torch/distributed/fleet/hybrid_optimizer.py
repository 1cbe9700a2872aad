"""``HybridParallelOptimizer`` and ``HybridParallelClipGrad``
(``paddle_tpu/distributed/fleet/hybrid_optimizer.py``).

One process a rank: the gradient reduction is the model's (the
``GradReducer`` of ``DataParallel`` / ``group_sharded_parallel``); what the
wrapper adds is the global-norm clip over every rank's share. Under ZeRO
stages 2 and 3 each rank holds gradient shards, and the optimizer hands
them to the clip with the sharding group: the sum of squares over the
local shards is all-reduced before the scale (``nn/clip.py``), so every
parameter counts once. Under tensor parallelism (an mp degree above 1)
the hybrid clip sums the squares of the cut gradients (parameters marked
``mp_cut``) over the model-parallel group and counts the whole
ones (the norms) once. A plain ``ClipGradByGlobalNorm`` on the inner
optimizer is replaced by the hybrid one, as in the reference.
"""

from __future__ import annotations

from ...nn.clip import ClipGradByGlobalNorm


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip over every parallel dimension's share."""

    def __init__(self, clip, hcg):
        super().__init__(clip.clip_norm)
        self._hcg = hcg

    def __call__(self, params_grads, *, group=None, mp_group=None):
        if mp_group is None and self._hcg is not None and \
                self._hcg.get_model_parallel_world_size() > 1:
            mp_group = self._hcg.get_model_parallel_group()
        return super().__call__(params_grads, group=group,
                                mp_group=mp_group)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm) and \
                not isinstance(clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self, *, grads=None):
        self._inner.step(grads=grads)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, state):
        return self._inner.set_state_dict(state)
