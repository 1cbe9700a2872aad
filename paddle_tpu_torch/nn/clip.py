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


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp each gradient element to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            out.append((p, _apply_scale(g, _scale_for(self.clip_norm, norm))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every clipped gradient by min(1, clip_norm / global norm),
    the global norm over all of them. ``last_global_norm`` keeps the
    pre-clip global norm of the last call (a 0-d f32 tensor on the grads'
    device, read by no one on the training path)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.last_global_norm = None

    def global_norm(self, params_grads):
        """The f32 L2 norm over every clipped gradient, summed per tensor
        in list order; None when there is none."""
        sq = None
        for p, g in params_grads:
            if _clipped(p, g):
                s = torch.sum(torch.square(g.float()))
                sq = s if sq is None else sq + s
        return None if sq is None else torch.sqrt(sq)

    def __call__(self, params_grads):
        params_grads = list(params_grads)
        norm = self.global_norm(params_grads)
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
