"""Weight bridge: fill a port model from the JAX model's parameters.

The caller builds the numpy dict (``{n: np.asarray(p._array) for n, p in
jax_model.named_parameters()}``); this module never imports the JAX
package. Names and shapes must match exactly — linear weights keep the
(in, out) layout on both sides, so nothing is transposed.

``quantized_params_from_numpy`` does the same for a weight-only quantized
params dict (the JAX package's ``quantize_for_inference`` output): each
quantized entry is any object with ``codes``, ``scales``, ``weight_dtype``,
``group_size`` and ``shape`` (the JAX ``QuantizedWeight`` works as is),
read through numpy.

``expert_quant_from_numpy`` carries a quantized MoE model's expert codes
and scales across: one entry per layer, the JAX ``MoEMLP._expert_quant``
dict (``weight_dtype``, ``group_size`` and a (codes, scales) pair for each
of ``w_gate``, ``w_up`` and ``w_down``), read through numpy.

``optimizer_state_to_numpy`` / ``optimizer_state_from_numpy`` carry an
AdamW or AdamW8bit state ({param name: {key: array}}, the JAX package's
``TrainStep._opt_state`` layout) across; the float8 (e4m3) moment codes
travel as ``uint8`` views (ml_dtypes on the JAX side, ``float8_e4m3fn``
here).
"""

from __future__ import annotations

import numpy as np
import torch


def load_numpy_params(model, params: dict) -> None:
    """Copy ``params`` ({name: ndarray}) into ``model``'s parameters, cast
    to each parameter's dtype. Raises on a missing or extra name or a
    shape mismatch; nothing is copied unless every entry matches."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, arr in params.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(own[name].shape)}")
    with torch.no_grad():
        for name, arr in params.items():
            a = np.asarray(arr)
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)  # e.g. bfloat16 from ml_dtypes
            own[name].copy_(torch.tensor(a))


def _check_quantized(name, qw, want_shape):
    """Raise unless ``qw``'s metadata and arrays agree with each other and
    with the model parameter's (K, N) shape."""
    shape = tuple(qw.shape)
    if shape != tuple(want_shape):
        raise ValueError(f"{name}: logical shape {shape} != "
                         f"{tuple(want_shape)}")
    if qw.weight_dtype not in ("int8", "int4"):
        raise ValueError(f"{name}: weight_dtype {qw.weight_dtype!r}")
    k, n = shape
    rows = -(-k // 2) if qw.weight_dtype == "int4" else k
    gs = int(qw.group_size)
    if gs not in (-1, 64, 128):
        raise ValueError(f"{name}: group_size {gs}")
    s_shape = (n,) if gs == -1 else (-(-k // gs), n)
    codes, scales = np.asarray(qw.codes), np.asarray(qw.scales)
    if codes.dtype != np.int8 or codes.shape != (rows, n):
        raise ValueError(f"{name}: codes {codes.dtype}{codes.shape}, "
                         f"expected int8{(rows, n)} for {qw.weight_dtype}")
    if scales.dtype != np.float32 or scales.shape != s_shape:
        raise ValueError(f"{name}: scales {scales.dtype}{scales.shape}, "
                         f"expected float32{s_shape} for group_size {gs}")
    return codes, scales


def quantized_params_from_numpy(model, params: dict) -> dict:
    """The port's serving params from a quantized params dict: quantized
    entries become ``QuantizedWeight``s of torch tensors, the rest tensors
    in the model parameter's dtype, all on the model's device. Raises on a
    missing or extra name, a shape mismatch or inconsistent metadata; the
    model itself is not changed."""
    from ..ops.kernels.quant_matmul import QuantizedWeight

    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    arrays = {}
    for name, val in params.items():
        if hasattr(val, "codes"):
            arrays[name] = _check_quantized(name, val, own[name].shape)
        else:
            a = np.asarray(val)
            if tuple(a.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(own[name].shape)}")
            arrays[name] = a
    out = {}
    for name, val in params.items():
        dev = own[name].device
        if hasattr(val, "codes"):
            codes, scales = arrays[name]
            out[name] = QuantizedWeight(
                torch.tensor(codes, device=dev),
                torch.tensor(scales, device=dev), val.weight_dtype,
                val.group_size, val.shape)
        else:
            a = arrays[name]
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)
            out[name] = torch.tensor(a, device=dev).to(own[name].dtype)
    return out


def _check_expert_quant(where, eq, mlp):
    """The (codes, scales) numpy pairs of one layer's ``_expert_quant``,
    each expert checked as ``_check_quantized`` checks a weight against
    the layer's (K, N) stacks."""
    from types import SimpleNamespace

    from .moe import EXPERT_STACKS

    missing = sorted({"weight_dtype", "group_size", *EXPERT_STACKS}
                     - set(eq))
    if missing:
        raise KeyError(f"{where}: missing {missing}")
    out = {}
    for name in EXPERT_STACKS:
        e, k, n = getattr(mlp, name).shape
        codes, scales = (np.asarray(a) for a in eq[name])
        if len(codes) != e or len(scales) != e:
            raise ValueError(f"{where}.{name}: {len(codes)} code and "
                             f"{len(scales)} scale experts, expected {e}")
        for i in range(e):
            _check_quantized(f"{where}.{name}[{i}]", SimpleNamespace(
                codes=codes[i], scales=scales[i], shape=(k, n),
                weight_dtype=eq["weight_dtype"],
                group_size=eq["group_size"]), (k, n))
        out[name] = (codes, scales)
    return out


def expert_quant_from_numpy(model, quant) -> None:
    """Set each MoE layer's quantized experts from ``quant``: one
    ``_expert_quant`` dict a layer, in layer order (arrays read through
    numpy), as ``MoEMLP.quantize_experts`` stores them, on the model's
    device. Raises on a layer count, key, dtype, packed-row or scale-shape
    mismatch or a group size not in {-1, 64, 128}; nothing changes unless
    every layer matches."""
    layers = list(model.layers)
    quant = list(quant)
    if len(quant) != len(layers):
        raise ValueError(f"{len(quant)} layers of expert codes for "
                         f"{len(layers)} layers")
    arrays = [_check_expert_quant(f"layers.{i}.mlp", eq, layer.mlp)
              for i, (eq, layer) in enumerate(zip(quant, layers))]
    for eq, layer, arr in zip(quant, layers, arrays):
        dev = layer.mlp.w_gate.device
        layer.mlp._expert_quant = {
            "weight_dtype": eq["weight_dtype"],
            "group_size": int(eq["group_size"]),
            **{name: (torch.tensor(c, device=dev), torch.tensor(s, device=dev))
               for name, (c, s) in arr.items()}}


def optimizer_state_to_numpy(optimizer) -> dict:
    """{param name: {key: ndarray}} of an optimizer's state; float8 codes as
    uint8 views."""
    out = {}
    for name, st in optimizer.state().items():
        out[name] = {k: (v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn
                         else v).detach().cpu().numpy()
                     for k, v in st.items()}
    return out


def optimizer_state_from_numpy(optimizer, state: dict,
                               global_step=None) -> None:
    """Fill an optimizer's state from {param name: {key: ndarray}} (float8
    codes as uint8 or ml_dtypes arrays), on each parameter's device, and
    set its step count. Raises on an unknown name, a missing or extra key
    or a shape mismatch; nothing changes unless every entry matches."""
    params = dict(optimizer._named)
    unknown = sorted(set(state) - set(params))
    if unknown:
        raise KeyError(f"no parameter named {unknown}")
    new = {}
    for name, entries in state.items():
        proto = optimizer.init_state(params[name])
        if set(entries) != set(proto):
            raise KeyError(f"{name}: state keys {sorted(entries)} != "
                           f"{sorted(proto)}")
        st = {}
        for key, arr in entries.items():
            a = np.asarray(arr)
            want = proto[key]
            if tuple(a.shape) != tuple(want.shape):
                raise ValueError(f"{name}.{key}: shape {tuple(a.shape)} != "
                                 f"{tuple(want.shape)}")
            if want.dtype == torch.float8_e4m3fn:
                st[key] = torch.tensor(a.view(np.uint8)).to(
                    want.device).view(torch.float8_e4m3fn)
            else:
                st[key] = torch.tensor(a.astype(np.float32)).to(
                    want.device, want.dtype)
        new[name] = st
    optimizer._state.update(new)
    if global_step is not None:
        optimizer._global_step = int(global_step)
