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
model positionally: ``step((ids, attn_mask), labels)``.

Data parallelism and ZeRO (one process a rank): as the JAX package, the
step picks up ``model._grad_reducer`` (``distributed.DataParallel``,
``group_sharded_parallel`` stages 1 and 2) and ``model._zero_plan``
(``group_sharded_parallel``; or ``sharding_plan=``). Then ``loss_fn`` is
called as ``loss_fn(outputs, *labels, count_group=group)`` with the
data-parallel group, which it passes to the mean losses it runs (the
models' ``loss`` take it), so that a "mean" counts the whole group's valid
targets (``ops/loss_ops.py``); a loss function that cannot take it raises
at construction. The reducer's buckets flush during backward and the step
waits for every flush before the optimizer reads a gradient; the step
refuses to run inside ``DataParallel.no_sync`` (it reduces every step:
its gradient merge is ``accumulate_steps``). With ``accumulate_steps`` > 1
the flushes are held and the merged gradients reduced once, one flush a
bucket, as the JAX package averages inside its scan and then reduces
(stage 3 reduce-scatters each microbatch's gradients into the shards: its
full gradients do not outlive a backward). The returned loss is the
group's mean, the JAX package's global loss. ``mesh`` is kept; the inputs
are each rank's local batch. ``in_shardings`` and ``donate=False`` are not
ported: they raise.

ZeRO stage 3: the step turns on the plan's prefetch (``plan.prefetch``;
``overlap.zero_prefetch`` under the ``zero_prefetch`` flag, as the JAX
package's step calls it), so each decoder layer's gather is in flight
while the layer before it runs.

Tensor parallelism (``models.llama.apply_llama_tensor_parallel``, or
``distributed.TensorParallel`` around it for hybrid dp x mp): each rank's
parameters are its shards and the optimizer updates them as they are (K8
on each local shard for ``AdamW8bit``); the step hands the optimizer the
model-parallel group for its clip (``_mp_group``). The reducer, the
``count_group`` and the returned loss's mean are the data-parallel
group's: the mp ranks of a dp group see the same batch. ZeRO together
with tensor parallelism is not ported.
"""

from __future__ import annotations

import contextlib
import inspect

import torch

from ..framework.contract import refuse_unported
from ..optimizer.lr import LRScheduler


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, in_shardings=None,
                 donate: bool = True, mesh=None, sharding_plan=None,
                 accumulate_steps: int = 1):
        refuse_unported("TrainStep", in_shardings=(in_shardings, None),
                        donate=(donate, True))
        self.model = model.train()
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self._plan = sharding_plan or getattr(model, "_zero_plan", None)
        self._reducer = getattr(model, "_grad_reducer", None)
        if self._plan is not None:
            inner = getattr(optimizer, "_inner", optimizer)
            if getattr(inner, "_zero_plan", None) is None:
                inner._zero_plan = self._plan
        tp = getattr(model, "_tp_overlap", None) or getattr(
            getattr(model, "_layers", None), "_tp_overlap", None)
        if tp is not None and self._plan is not None:
            raise NotImplementedError("ZeRO together with tensor "
                                      "parallelism is not ported")
        if tp is not None and tp["group"] is not None:
            getattr(optimizer, "_inner", optimizer)._mp_group = tp["group"]
        if self._plan is not None and self._plan.stage >= 3:
            self._plan.prefetch = True
        self._group = (self._reducer.group if self._reducer is not None
                       else self._plan.group if self._plan is not None
                       else None)
        if self._group is not None:
            params = inspect.signature(loss_fn).parameters.values()
            if not any(p.name == "count_group" or p.kind == p.VAR_KEYWORD
                       for p in params):
                raise TypeError(
                    "under data parallelism or ZeRO, TrainStep calls "
                    "loss_fn(outputs, *labels, count_group=group): give it "
                    "a count_group keyword and pass it to the mean losses "
                    "(e.g. the model's loss)")
        self.accumulate_steps = int(accumulate_steps)
        self._named = list(model.named_parameters())
        optimizer.register_named(self._named)
        self.last_lr = None

    def _loss(self, inputs, labels):
        kw = {} if self._group is None else {"count_group": self._group}
        return self.loss_fn(self.model(*inputs), *labels, **kw)

    def __call__(self, inputs, labels):
        """One step; returns the (microbatch-mean) loss, detached."""
        if self._reducer is not None and self._reducer.suppressing:
            raise RuntimeError(
                "TrainStep reduces its gradients every step and cannot run "
                "inside no_sync; merge gradients with accumulate_steps")
        inputs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        labels = labels if isinstance(labels, (tuple, list)) else (labels,)
        self.optimizer.clear_grad()
        self.last_lr = self.optimizer.get_lr()
        loss = self._update(inputs, labels)
        if self._group is not None:
            from ..distributed.collective import ReduceOp, all_reduce

            loss = all_reduce(loss.clone(), ReduceOp.AVG, self._group)
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        return loss

    def _backward(self, inputs, labels):
        """Forward, loss and backward of one (micro)batch, the stage-3
        root gathered around them."""
        if self._plan is not None:
            self._plan.begin_step()
        try:
            loss = self._loss(inputs, labels)
            loss.backward()
        finally:
            if self._plan is not None:
                self._plan.end_step()
        return loss.detach()

    def _update(self, inputs, labels):
        m, red = self.accumulate_steps, self._reducer
        if m == 1:
            if red is not None:
                red.prepare()
            loss = self._backward(inputs, labels)
            grads = red.finish() if red is not None else None
            self.optimizer.step(grads=grads)
            return loss
        g_sum, l_sum = {}, 0.0
        held = red.suppressed() if red is not None else \
            contextlib.nullcontext()
        with held:
            for i in range(m):
                loss = self._backward(tuple(x[i] for x in inputs),
                                      tuple(y[i] for y in labels))
                l_sum = l_sum + loss.float()
                for name, p in self._named:
                    if p.grad is not None:
                        g = p.grad.float()
                        g_sum[name] = (g if name not in g_sum
                                       else g_sum[name] + g)
                        p.grad = None
        grads = {n: g / m for n, g in g_sum.items()}
        if red is not None:
            red.prepare()
            grads = red.reduce_grads(grads)
        self.optimizer.step(grads=grads)
        return l_sum / m
