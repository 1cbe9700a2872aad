"""Optimizer base (``paddle_tpu/optimizer/optimizer.py``).

Every optimizer is a per-parameter update rule (``init_state`` /
``update``) over named parameters, as in the JAX package. The port applies
it eagerly and IN PLACE (``step``): each parameter's data and state tensors
are overwritten, where the JAX package's pure rule returns new arrays.
What is ported: a float learning rate or an ``lr.LRScheduler`` (``get_lr``
reads it; ``jit.TrainStep`` steps it after each update), a global weight
decay with ``apply_decay_param_fun``, f32 master weights for
low-precision params (``multi_precision``), and ``grad_clip``
(``nn.clip``), which acts on the whole {name: grad} set before any update,
in sorted-name order, as the JAX package's ``apply_gradients_tree`` does.

Under ZeRO (``_zero_plan``, attached by
``distributed.sharding.group_sharded_parallel``) the state is held on this
rank's shard of each parameter only: ``step`` updates the shard (a flat
view of the parameter's data; the shard of its gradient: sliced from the
all-reduced one at stage 1, the reduce-scattered one at stage 2, the
shard parameter's own at stage 3), skips a parameter whose shard is empty,
clips with the squared sums all-reduced over the group, then all-gathers
the parameters (stages 1 and 2). ``state_dict`` carries the shard ranges.

Under tensor parallelism each rank's parameters are its shards, and the
optimizer updates them as whole tensors (K8's blocks are the shard's);
``_mp_group`` (set by ``jit.TrainStep`` from the model's tensor-parallel
plan) makes the clips sum the shards' squares over the group.
"""

from __future__ import annotations

import torch

from .lr import LRScheduler


def needs_master(param, multi_precision) -> bool:
    """An f32 master copy for low-precision float params."""
    return (multi_precision and param.dtype.is_floating_point
            and param.dtype != torch.float32)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._grad_clip = grad_clip
        params = list(parameters) if parameters is not None else []
        # (name, param) pairs; a bare parameter list is named by position
        self._named = [p if isinstance(p, tuple) else (f"param_{i}", p)
                       for i, p in enumerate(params)]
        self._weight_decay = float(weight_decay or 0.0)
        self._state = {}
        self._global_step = 0
        self._apply_decay_param_fun = None
        self._multi_precision = True
        self._zero_plan = None
        self._mp_group = None

    def register_named(self, named_params) -> None:
        """Name this optimizer's parameters after ``named_params`` (e.g.
        ``model.named_parameters()``), matched by identity: the names that
        ``apply_decay_param_fun`` and the state keys see."""
        names = {id(p): n for n, p in named_params}
        self._named = [(names.get(id(p), n), p) for n, p in self._named]

    # ---- per-parameter settings (the JAX package's rules)
    def _decay_for(self, name) -> float:
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return self._weight_decay

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # ---- the rule (subclasses)
    def init_state(self, param) -> dict:
        return {}

    def update(self, param, grad, state, lr, step, weight_decay,
               lr_scale=1.0) -> None:
        """Update ``param`` and ``state`` in place."""
        raise NotImplementedError

    # ---- application
    def _grad_of(self, name, p, grads):
        if grads is not None:
            return grads.get(name)
        plan = self._zero_plan
        if plan is not None and plan.stage == 2:
            return plan.grads.get(name)
        return p.grad

    def _targets(self, grads):
        """(name, param, the data to update, its gradient) of every
        parameter with a gradient (under ZeRO: this rank's shards, empty
        ones included, so that every rank clips over the same list)."""
        plan, out = self._zero_plan, []
        for name, p in self._named:
            g = self._grad_of(name, p, grads)
            if g is None:
                continue
            if plan is None:
                out.append((name, p, p.data, g))
            else:
                out.append((name, p, plan.param_shard(name, p),
                            plan.grad_shard(name, g)))
        return out

    @torch.no_grad()
    def step(self, *, grads=None):
        """One update of every parameter that has a gradient (``grads``:
        optional {name: tensor} overriding ``param.grad``, shards under
        ZeRO stages 2 and 3), all gradients clipped first when
        ``grad_clip`` is set."""
        lr = self.get_lr()
        self._global_step += 1
        plan = self._zero_plan
        named = self._targets(grads)
        if self._grad_clip is not None:
            order = sorted(range(len(named)), key=lambda i: named[i][0])
            pairs = [(named[i][1], named[i][3]) for i in order]
            kw = {} if plan is None else {"group": plan.group}
            if self._mp_group is not None:
                kw["mp_group"] = self._mp_group
            clipped = self._grad_clip(pairs, **kw)
            for i, (_, g) in zip(order, clipped):
                named[i] = named[i][:3] + (g,)
        for name, p, data, g in named:
            if plan is not None and data.numel() == 0:
                continue
            if name not in self._state:
                self._state[name] = self.init_state(data)
            self.update(data, g, self._state[name], lr, self._global_step,
                        self._decay_for(name))
        if plan is not None and plan.stage < 3:
            plan.gather_params()

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient, or zero it in place (``set_to_zero``)."""
        for _, p in self._named:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None
        if self._zero_plan is not None:
            self._zero_plan.grads.clear()

    def state(self) -> dict:
        """{param name: {state key: tensor}} (the live tensors)."""
        return self._state

    def state_dict(self) -> dict:
        """``global_step``, every state tensor as ``"<name>.<key>"``, and
        the scheduler's state as ``LR_Scheduler`` (the JAX package's
        layout); under ZeRO also ``shard_ranges``, {name: (lo, hi)} of
        this rank's state."""
        out = {"global_step": self._global_step}
        for name, st in self._state.items():
            for k, v in st.items():
                out[f"{name}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        if self._zero_plan is not None:
            out["shard_ranges"] = {n: self._zero_plan.shard_range(n)
                                   for n, _ in self._named}
        return out

    def set_state_dict(self, state) -> None:
        """Load what ``state_dict`` returned; a parameter with no entry
        keeps a fresh state. Under ZeRO the state's shard ranges must be
        this rank's."""
        plan = self._zero_plan
        if plan is not None:
            mine = {n: plan.shard_range(n) for n, _ in self._named}
            got = {n: tuple(r) for n, r in
                   state.get("shard_ranges", {}).items()}
            if got != mine:
                raise ValueError("the optimizer state holds other shard "
                                 "ranges than this rank's")
        self._global_step = state.get("global_step", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for name, p in self._named:
            if plan is not None:
                lo, hi = plan.shard_range(name)
                if lo == hi:
                    continue
                p = plan.param_shard(name, p)
            proto = self.init_state(p)
            self._state[name] = {
                k: (state[f"{name}.{k}"].to(v.device).clone()
                    if f"{name}.{k}" in state else v)
                for k, v in proto.items()}
