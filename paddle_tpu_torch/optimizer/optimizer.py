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
    @torch.no_grad()
    def step(self, *, grads=None):
        """One update of every parameter that has a gradient (``grads``:
        optional {name: tensor} overriding ``param.grad``), all gradients
        clipped first when ``grad_clip`` is set."""
        lr = self.get_lr()
        self._global_step += 1
        named = [(name, p, p.grad if grads is None else grads.get(name))
                 for name, p in self._named]
        named = [(name, p, g) for name, p, g in named if g is not None]
        if self._grad_clip is not None:
            order = sorted(range(len(named)), key=lambda i: named[i][0])
            clipped = self._grad_clip([named[i][1:] for i in order])
            for i, (_, g) in zip(order, clipped):
                named[i] = (named[i][0], named[i][1], g)
        for name, p, g in named:
            if name not in self._state:
                self._state[name] = self.init_state(p)
            self.update(p.data, g, self._state[name], lr, self._global_step,
                        self._decay_for(name))

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient, or zero it in place (``set_to_zero``)."""
        for _, p in self._named:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    def state(self) -> dict:
        """{param name: {state key: tensor}} (the live tensors)."""
        return self._state

    def state_dict(self) -> dict:
        """``global_step``, every state tensor as ``"<name>.<key>"``, and
        the scheduler's state as ``LR_Scheduler`` (the JAX package's
        layout)."""
        out = {"global_step": self._global_step}
        for name, st in self._state.items():
            for k, v in st.items():
                out[f"{name}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        """Load what ``state_dict`` returned; a parameter with no entry
        keeps a fresh state."""
        self._global_step = state.get("global_step", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for name, p in self._named:
            proto = self.init_state(p)
            self._state[name] = {
                k: (state[f"{name}.{k}"].to(v.device).clone()
                    if f"{name}.{k}" in state else v)
                for k, v in proto.items()}
