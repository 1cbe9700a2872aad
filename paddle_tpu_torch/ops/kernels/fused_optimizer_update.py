"""The one-sweep AdamW8bit update (``paddle_tpu/ops/pallas/fused_optimizer_update.py``).

Kernel K8 (``csrc/adamw8bit.cu``) replaces the TPU's ``_pallas_adamw8bit``:
per parameter, one pass over the grad (bf16 read as it is, no f32 copy),
the f32 master, the float8 (e4m3) moment codes and their per-2048-element
block scales, writing the new master, the bf16 param, the codes and the
scales. Bound: bytes, ~16 per bf16 parameter with a master.

The port updates the state IN PLACE (the JAX package returns new arrays):
a second copy of the master and the codes would cost ~14 GB at the 8-layer
Llama-3-8B train step's 2.8B parameters.

Numerics contract: the codes are bit-identical to ``adamw8bit_reference``
(the unfused update), scales within 3e-7 relative and the master within
step * 3e-7 of the JAX package's reference (the bars of its own fused
kernel). Both versions here take the scalars rounded once to f32 from
Python doubles (``_scalars``), and the plain version divides by tensors on
the parameter's device: CUDA PyTorch divides by a Python scalar (or a CPU
scalar tensor) as a multiplication by its reciprocal, an ulp off IEEE.

On CUDA tensors ``adamw8bit_update`` launches K8 or raises, also when the
``optimizer_update`` train fusion is off (the plain chain would do K8's
work as plain ops); only ``plain=True`` runs the plain version there (the
on-card reference). Integer params raise (the weight-only rule: quantized
codes are constants of the forward, never optimizer targets).
"""

from __future__ import annotations

import torch

from . import _build

Q8_BLOCK = 2048

#: K8 launches since the last reset (incremented only where it launches)
launches = 0


def q8_meta(numel):
    """(n, padded, blocks) of a parameter's flat quantized layout."""
    n = max(int(numel), 1)
    padded = -(-n // Q8_BLOCK) * Q8_BLOCK
    return n, padded, padded // Q8_BLOCK


def init_state(param, master: bool):
    """Zero moments (codes and scales) and, when ``master``, an f32 copy."""
    _, padded, nb = q8_meta(param.numel())
    dev = param.device
    st = {"m_q": torch.zeros((padded,), dtype=torch.float8_e4m3fn, device=dev),
          "m_s": torch.zeros((nb,), dtype=torch.float32, device=dev),
          "v_q": torch.zeros((padded,), dtype=torch.float8_e4m3fn, device=dev),
          "v_s": torch.zeros((nb,), dtype=torch.float32, device=dev)}
    if master:
        st["master"] = param.detach().float().clone()
    return st


def _scalars(lr, step, weight_decay, lr_scale, beta1, beta2, eps):
    """The update's scalars from Python doubles, each to be rounded once to
    f32 — the reference's scalar-times-array rounding points."""
    lrls = lr * lr_scale
    return {"b1": beta1, "omb1": 1 - beta1, "b2": beta2, "omb2": 1 - beta2,
            "lrls": lrls, "bc1": 1.0 - beta1 ** step,
            "bc2": 1.0 - beta2 ** step, "eps": eps,
            "wdm": 1.0 - lrls * weight_decay}


def q8_quant(x32):
    """(n,) f32 -> (e4m3 codes, per-block f32 scales), the reference rule."""
    blocks = x32.reshape(-1, Q8_BLOCK)
    c448 = torch.tensor(448.0, dtype=torch.float32, device=x32.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=x32.device)
    scale = torch.maximum(blocks.abs().amax(dim=1, keepdim=True) / c448,
                          tiny)
    return (blocks / scale).to(torch.float8_e4m3fn).reshape(-1), scale[:, 0]


def q8_dequant(q, scale):
    return (q.float().reshape(scale.shape[0], Q8_BLOCK)
            * scale[:, None]).reshape(-1)


def adamw8bit_reference(param, grad, state, lr, step, weight_decay,
                        lr_scale, beta1, beta2, eps):
    """K8's plain version — the unfused op-by-op update, each op rounded
    once. Returns (new param, new state) without touching its inputs."""
    n, padded, _ = q8_meta(param.numel())
    dev = param.device
    s = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in _scalars(lr, step, weight_decay, lr_scale, beta1, beta2,
                              eps).items()}
    g = torch.nn.functional.pad(grad.float().reshape(-1), (0, padded - n))
    m = q8_dequant(state["m_q"], state["m_s"])
    v = q8_dequant(state["v_q"], state["v_s"])
    m = s["b1"] * m + s["omb1"] * g
    v = s["b2"] * v + s["omb2"] * g.square()
    upd = (s["lrls"] * (m / s["bc1"])
           / (torch.sqrt(v / s["bc2"]) + s["eps"]))[:n].reshape(param.shape)
    p32 = state["master"] if "master" in state else param.float()
    if weight_decay:
        p32 = p32 * s["wdm"]
    new_p32 = p32 - upd
    m_q, m_s = q8_quant(m)
    v_q, v_s = q8_quant(v)
    new_state = {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}
    if "master" in state:
        new_state["master"] = new_p32
    return new_p32.to(param.dtype), new_state


def _check_weight_only_rule(param):
    if not (param.dtype.is_floating_point):
        raise ValueError(
            f"AdamW8bit update target has integer dtype {param.dtype} — "
            "quantized weight codes are constants of the forward (the "
            "weight-only rule of quant_matmul) and are never optimizer "
            "targets; train the full-precision master weights instead")


def adamw8bit_update(param, grad, state, lr, step, weight_decay, lr_scale,
                     beta1, beta2, eps, plain=False):
    """Update ``param`` (a tensor, in place) and ``state`` (in place) by one
    AdamW8bit step. K8 on CUDA tensors (with the ``optimizer_update`` train
    fusion on), the plain version on CPU tensors or with ``plain=True``."""
    global launches
    from . import fusion

    _check_weight_only_rule(param)
    if not param.is_cuda or plain:
        new_p, new_st = adamw8bit_reference(param, grad, state, lr, step,
                                            weight_decay, lr_scale, beta1,
                                            beta2, eps)
        param.copy_(new_p)
        for k, val in new_st.items():
            state[k].copy_(val)
        return
    if not fusion.train_fusion_on("optimizer_update"):
        raise NotImplementedError(
            "the unfused AdamW8bit chain does not run on CUDA tensors; enable "
            "the optimizer_update train fusion (flags fused_train, "
            "fused_train_fusions)")
    n, padded, nb = q8_meta(param.numel())
    if param.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"adamw8bit kernel takes bf16 or f32 params, got "
                         f"{param.dtype}")
    if grad.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"adamw8bit kernel takes bf16 or f32 grads, got "
                         f"{grad.dtype}")
    _build.check_cuda("param", param, shape=tuple(grad.shape))
    _build.check_cuda("grad", grad)
    for k, dt, size in (("m_q", torch.float8_e4m3fn, padded),
                        ("v_q", torch.float8_e4m3fn, padded),
                        ("m_s", torch.float32, nb), ("v_s", torch.float32, nb)):
        _build.check_cuda(k, state[k], dt, (size,))
    master = state.get("master")
    if master is not None:
        _build.check_cuda("master", master, torch.float32, tuple(param.shape))
        p32, pb = master, (param if param.dtype == torch.bfloat16 else None)
        if pb is None:
            raise ValueError("an f32 param keeps no master copy")
    elif param.dtype == torch.float32:
        p32, pb = param, None
    else:
        p32, pb = None, param
    s = _scalars(lr, step, weight_decay, lr_scale, beta1, beta2, eps)
    _build.launch(
        "pt_adamw8bit", grad.data_ptr(), int(grad.dtype == torch.float32),
        None if p32 is None else p32.data_ptr(),
        None if pb is None else pb.data_ptr(), state["m_q"].data_ptr(),
        state["m_s"].data_ptr(), state["v_q"].data_ptr(),
        state["v_s"].data_ptr(), param.numel(), s["b1"], s["omb1"], s["b2"],
        s["omb2"], s["lrls"], s["bc1"], s["bc2"], s["eps"], s["wdm"],
        int(bool(weight_decay)), _build.stream_of(param))
    launches += 1
