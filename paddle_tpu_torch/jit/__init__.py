"""``TrainStep`` (``paddle_tpu/jit/__init__.py``): one training step.

The JAX package compiles forward, backward and the optimizer into one XLA
executable with donated buffers; PyTorch runs eagerly, so the port's step
is forward, loss, ``backward()``, then one optimizer sweep over the
parameters, updating them in place. ``accumulate_steps`` > 1 merges the
gradients of that many microbatches (inputs and labels carry a leading
microbatch dim) in f32 before the one update, as the JAX package's scan
does. Under an ``LRScheduler`` the step reads ``optimizer.get_lr()`` before
the update and steps the scheduler after it, as the JAX package's does;
``last_lr`` keeps the rate of the last update. Inputs are passed to the
model positionally: ``step((ids, attn_mask), labels)``. Sharding plans and
donation are not ported.
"""

from __future__ import annotations

import torch

from ..optimizer.lr import LRScheduler


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, accumulate_steps: int = 1):
        self.model = model.train()
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = int(accumulate_steps)
        self._named = list(model.named_parameters())
        optimizer.register_named(self._named)
        self.last_lr = None

    def _loss(self, inputs, labels):
        return self.loss_fn(self.model(*inputs), *labels)

    def __call__(self, inputs, labels):
        """One step; returns the (microbatch-mean) loss, detached."""
        inputs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        labels = labels if isinstance(labels, (tuple, list)) else (labels,)
        self.optimizer.clear_grad()
        self.last_lr = self.optimizer.get_lr()
        loss = self._update(inputs, labels)
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        return loss

    def _update(self, inputs, labels):
        m = self.accumulate_steps
        if m == 1:
            loss = self._loss(inputs, labels)
            loss.backward()
            self.optimizer.step()
            return loss.detach()
        g_sum, l_sum = {}, 0.0
        for i in range(m):
            loss = self._loss(tuple(x[i] for x in inputs),
                              tuple(y[i] for y in labels))
            loss.backward()
            l_sum = l_sum + loss.detach().float()
            for name, p in self._named:
                if p.grad is not None:
                    g = p.grad.float()
                    g_sum[name] = g if name not in g_sum else g_sum[name] + g
                    p.grad = None
        self.optimizer.step({n: g / m for n, g in g_sum.items()})
        return l_sum / m
