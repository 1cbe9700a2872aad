"""Optimizer base (``paddle_tpu/optimizer/optimizer.py``).

Every optimizer is a per-parameter update rule (``init_state`` /
``update``) over named parameters, as in the JAX package. The port applies
it eagerly and IN PLACE (``step``): each parameter's data and state tensors
are overwritten, where the JAX package's pure rule returns new arrays.
What is ported: a constant float learning rate, a global weight decay with
``apply_decay_param_fun``, and f32 master weights for
low-precision params (``multi_precision``). Grad clipping and learning-rate
schedulers are not ported yet.
"""

from __future__ import annotations

import torch


def needs_master(param, multi_precision) -> bool:
    """An f32 master copy for low-precision float params."""
    return (multi_precision and param.dtype.is_floating_point
            and param.dtype != torch.float32)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError("grad clipping is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float")
        self._lr = float(learning_rate)
        params = list(parameters) if parameters is not None else []
        # (name, param) pairs; a bare parameter list is named by position
        self._named = [p if isinstance(p, tuple) else (f"param_{i}", p)
                       for i, p in enumerate(params)]
        self._weight_decay = float(weight_decay or 0.0)
        self._state = {}
        self._global_step = 0
        self._apply_decay_param_fun = None
        self._multi_precision = True

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
        return self._lr

    def set_lr(self, value: float):
        self._lr = float(value)

    # ---- the rule (subclasses)
    def init_state(self, param) -> dict:
        return {}

    def update(self, param, grad, state, lr, step, weight_decay,
               lr_scale=1.0) -> None:
        """Update ``param`` and ``state`` in place."""
        raise NotImplementedError

    # ---- application
    @torch.no_grad()
    def step(self, grads=None):
        """One update of every parameter that has a gradient (``grads``:
        optional {name: tensor} overriding ``param.grad``)."""
        lr = self.get_lr()
        self._global_step += 1
        for name, p in self._named:
            g = p.grad if grads is None else grads.get(name)
            if g is None:
                continue
            if name not in self._state:
                self._state[name] = self.init_state(p)
            self.update(p.data, g, self._state[name], lr, self._global_step,
                        self._decay_for(name))

    def clear_grad(self):
        for _, p in self._named:
            p.grad = None

    def state(self) -> dict:
        """{param name: {state key: tensor}} (the live tensors)."""
        return self._state
