"""Gradient clipping (``paddle_tpu/nn/clip.py``).

A clip maps a list of (param, grad) pairs to a new list, leaving out of
the clip every parameter whose ``need_clip`` attribute is False (and every
missing grad). The optimizer hands it all gradients at once, in sorted
parameter-name order, before any update: the JAX package's
``apply_gradients_tree`` clips the whole {name: grad} tree, whose leaves
``jax.tree_util`` visits in sorted-key order, so the global norm's f32 sum
runs over the tensors in the same order.

Scaling rounds as the JAX package's ``(g * scale).astype(g.dtype)`` with an
f32 ``scale``: a bf16 gradient is multiplied in f32 and cast back
(``g.float() * scale``; a bf16 tensor times a 0-d f32 tensor would round
the scale to bf16 first). The clip ratio divides tensor by tensor: PyTorch
turns a Python scalar over a tensor into a multiplication by a reciprocal,
an ulp off the IEEE quotient the JAX package computes.

Under ZeRO (``distributed/sharding.py``) the optimizer hands each rank's
gradient shards with ``group=``: the norm-based clips all-reduce their
squared sums over the group before the scale (every rank calls the
all-reduce, with zeros where it holds no shard).

Under tensor parallelism (``mp_group=``, the model-parallel group) a
parameter marked ``mp_cut`` holds this rank's shard of a tensor
cut over the group, and the others (the norms) are whole on every rank:
the norm-based clips all-reduce the squared sums of the cut tensors over
the group and count the whole ones once (Paddle's
``HybridParallelClipGrad``).
"""

from __future__ import annotations

import torch


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _scale_for(clip_norm, norm):
    """min(clip_norm / max(norm, 1e-12), 1) in f32, an IEEE quotient."""
    num = torch.full_like(norm, clip_norm)
    return torch.clamp(num / torch.clamp(norm, min=1e-12), max=1.0)


def _apply_scale(g, scale):
    return (g.float() * scale).to(g.dtype)


def _group_sum(sq, group, device):
    """``sq`` (f32, or None for nothing) summed over ``group``'s ranks."""
    from ..distributed.collective import all_reduce

    sq = torch.zeros((), dtype=torch.float32, device=device) \
        if sq is None else sq
    return all_reduce(sq, group=group)


def _cut(p, mp_group) -> bool:
    return mp_group is not None and getattr(p, "mp_cut", False)


class ClipGradBase:
    def __call__(self, params_grads, *, group=None, mp_group=None):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp each gradient element to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads, *, group=None, mp_group=None):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads, *, group=None, mp_group=None):
        params_grads = list(params_grads)
        sums = [torch.sum(torch.square(g.float())) if _clipped(p, g)
                else None for p, g in params_grads]
        for grp, which in ((group, lambda p: True),
                           (mp_group, lambda p: _cut(p, mp_group))):
            if grp is None or not params_grads:
                continue
            dev = params_grads[0][1].device
            idx = [i for i, (p, _) in enumerate(params_grads)
                   if sums[i] is not None and which(p)]
            vec = _group_sum(torch.stack([sums[i] for i in idx]) if idx
                             else torch.zeros((0,), device=dev), grp, dev)
            for i, v in zip(idx, vec):
                sums[i] = v
        out = []
        for (p, g), s in zip(params_grads, sums):
            if s is None:
                out.append((p, g))
                continue
            out.append((p, _apply_scale(g, _scale_for(self.clip_norm,
                                                      torch.sqrt(s)))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every clipped gradient by min(1, clip_norm / global norm),
    the global norm over all of them. ``last_global_norm`` keeps the
    pre-clip global norm of the last call (a 0-d f32 tensor on the grads'
    device, read by no one on the training path)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.last_global_norm = None

    def global_norm(self, params_grads, *, group=None, mp_group=None):
        """The f32 L2 norm over every clipped gradient, summed per tensor
        in list order (then over ``group``'s ranks; the ``mp_cut``
        shards' sum over ``mp_group``'s, added to the whole tensors'
        sum); None when there is none."""
        sq, cut = None, None
        for p, g in params_grads:
            if _clipped(p, g):
                s = torch.sum(torch.square(g.float()))
                if _cut(p, mp_group):
                    cut = s if cut is None else cut + s
                else:
                    sq = s if sq is None else sq + s
        dev = params_grads[0][1].device if params_grads else "cpu"
        if mp_group is not None:
            cut = _group_sum(cut, mp_group, dev)
            sq = cut if sq is None else sq + cut
        if group is not None:
            sq = _group_sum(sq, group, dev)
        return None if sq is None else torch.sqrt(sq)

    def __call__(self, params_grads, *, group=None, mp_group=None):
        params_grads = list(params_grads)
        norm = self.global_norm(params_grads, group=group,
                                mp_group=mp_group)
        self.last_global_norm = norm
        if norm is None:
            return params_grads
        scale = _scale_for(self.clip_norm, norm)
        return [(p, _apply_scale(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale the ``.grad`` of ``parameters`` in place to a total norm of
    at most ``max_norm``; returns the total norm before scaling (f32)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack(
            [torch.max(torch.abs(p.grad)).float() for p in params]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(p.grad.float()) ** norm_type)
             for p in params])) ** (1.0 / norm_type)
    scale = _scale_for(max_norm, total)
    for p in params:
        p.grad.copy_(_apply_scale(p.grad, scale))
    return total
