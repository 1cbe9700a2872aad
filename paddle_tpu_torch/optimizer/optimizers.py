"""AdamW and AdamW8bit (``paddle_tpu/optimizer/optimizers.py``).

``AdamW`` is plain PyTorch: the JAX package has no kernel for it. Its
scalars are 0-d f32 tensors on the parameter's device, so each op rounds
once as the JAX rule's scalar-times-array ops do. ``AdamW8bit`` keeps
float8 (e4m3) moments in 2048-element blocks with f32 scales and routes
every update through ``ops/kernels/fused_optimizer_update.adamw8bit_update``
(kernel K8 on the card).
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer, needs_master


def _t(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class AdamW(Optimizer):
    """Adam with decoupled weight decay, f32 moments."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._apply_decay_param_fun = apply_decay_param_fun
        self._multi_precision = multi_precision

    def init_state(self, param):
        st = {"moment1": torch.zeros(param.shape, dtype=torch.float32,
                                     device=param.device),
              "moment2": torch.zeros(param.shape, dtype=torch.float32,
                                     device=param.device)}
        if needs_master(param, self._multi_precision):
            st["master"] = param.detach().float().clone()
        return st

    def update(self, param, grad, state, lr, step, weight_decay,
               lr_scale=1.0):
        b1, b2 = self._beta1, self._beta2
        g = grad.float()
        m = _t(b1, g) * state["moment1"] + _t(1 - b1, g) * g
        v = _t(b2, g) * state["moment2"] + _t(1 - b2, g) * g.square()
        m_hat = m / _t(1.0 - b1 ** step, g)
        v_hat = v / _t(1.0 - b2 ** step, g)
        upd = (_t(lr * lr_scale, g) * m_hat
               / (torch.sqrt(v_hat) + _t(self._eps, g)))
        p32 = state["master"] if "master" in state else param.float()
        if weight_decay:
            p32 = p32 * _t(1.0 - lr * lr_scale * weight_decay, g)
        new_p32 = p32 - upd
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        if "master" in state:
            state["master"].copy_(new_p32)
        param.copy_(new_p32)


class AdamW8bit(Optimizer):
    """AdamW with float8 (e4m3) blockwise-quantized moments and f32 master
    weights for low-precision params; the update is kernel K8."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._apply_decay_param_fun = apply_decay_param_fun
        self._multi_precision = multi_precision

    def init_state(self, param):
        from ..ops.kernels.fused_optimizer_update import init_state

        return init_state(param, needs_master(param, self._multi_precision))

    def update(self, param, grad, state, lr, step, weight_decay,
               lr_scale=1.0):
        from ..ops.kernels.fused_optimizer_update import adamw8bit_update

        adamw8bit_update(param, grad, state, lr, step, weight_decay,
                         lr_scale, self._beta1, self._beta2, self._eps)
