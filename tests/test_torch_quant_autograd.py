"""Weight-only quantized weights under autograd: the port vs the JAX package.

The JAX package attaches the weight-only backward to its quantized kernels:
``quant_matmul``'s ``_pallas_with_vjp`` (dx = g in f32 @ dequant(W)^T in
f32, cast to x's dtype), ``fused_norm_matmul``'s ``_fnm_kc_bwd`` (the
unfused chain differentiated for dx and d norm_w) and
``fused_norm_multi_matmul_pure``'s quantized route (the norm, then one
weight-only matmul a consumer). The port runs the same rules (on CPU tensors
over its kernels' plain versions). Here the same numpy-seeded inputs go
through both packages in f32:

  * ``quant_matmul_pure``'s forward and dx, int8 / int4, per channel and
    group 64 / 128, against ``jax.grad`` of the JAX function, on its
    reference lowering and on its Pallas kernel in interpret mode (the
    custom VJP);
  * dx and d norm_w of ``fused_norm_matmul_pure`` and
    ``fused_norm_multi_matmul_pure`` (one, two and three quantized
    consumers, and a mixed group) against the JAX ``train=True`` seams;
  * one decoder layer + the final norm and LM head in
    ``quantize_for_inference`` form through ``run_train_decoder_layer`` /
    ``run_train_lm_head`` (the fused train plan and the unfused one) against
    the JAX executors: logits, dh and every norm weight's gradient;
  * ``fusion.quantized_train_launches`` (the card's launch plan of that
    layer and head) against the calls of the kernel wrappers on the CPU;
  * codes and scales never take a gradient, and the AdamW8bit seam refuses
    integer codes as update targets.

Tolerances: forward values and gradients within rtol 1e-5, atol 1e-5
(``tests/test_train_fusion.py``'s bar for gradients); f32 throughout, so the
two packages differ only in summation order.
"""

from __future__ import annotations

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.models.llama import apply_rotary_pos_emb
from paddle_tpu.models.llama import \
    quantize_for_inference as jax_quantize
from paddle_tpu.ops.extra_vision import \
    _weight_quantize_pure as jax_weight_quantize
from paddle_tpu.ops.pallas import fused_norm_matmul as jfnm
from paddle_tpu.ops.pallas import fusion as jfusion
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pure
from paddle_tpu.ops.pallas.quant_matmul import \
    QuantizedWeight as JaxQuantizedWeight

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models.llama import LlamaConfig, _train_attend
from paddle_tpu_torch.ops.kernels import fused_norm_matmul as tfnm
from paddle_tpu_torch.ops.kernels import fused_norm_rope as tfnr
from paddle_tpu_torch.ops.kernels import fused_optimizer_update as tfou
from paddle_tpu_torch.ops.kernels import fusion as tfusion
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm

TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-5
FORMS = [("int8", -1), ("int8", 64), ("int8", 128), ("int4", -1),
         ("int4", 64), ("int4", 128)]
ALGO = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
TRAIN_FAMS = "norm_matmul,attn_epilogue,optimizer_update,moe_grouped_bwd"


@contextlib.contextmanager
def _flags(**kw):
    old_j = {k: jflags.get_flag(k) for k in kw}
    old_t = {k: tflags.get_flag(k) for k in kw}
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    try:
        yield
    finally:
        jflags.set_flags(old_j)
        tflags.set_flags(old_t)


def _quantized(w, wd, gs):
    """(JAX QuantizedWeight, the port's) of one f32 (K, N) weight, the
    codes and scales the JAX package's."""
    codes, scales = jax_weight_quantize(jnp.asarray(w, jnp.float32),
                                        algo=ALGO[wd], group_size=gs)
    jw = JaxQuantizedWeight(codes, scales, wd, gs, w.shape)
    tw = tqm.QuantizedWeight(torch.tensor(np.asarray(codes)),
                             torch.tensor(np.asarray(scales)), wd, gs,
                             w.shape)
    return jw, tw


def _close(port, ref, what):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               err_msg=what, **TOL)


# ------------------------------------------------------------------- K4


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["reference_lowering", "pallas_interpret"])
@pytest.mark.parametrize("wd,gs", FORMS)
def test_quant_matmul_grad_matches_jax(monkeypatch, wd, gs, interpret):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 128)) * 0.05).astype(np.float32)
    g = rng.normal(size=(2, 4, 128)).astype(np.float32)
    jw, tw = _quantized(w, wd, gs)
    if interpret:
        monkeypatch.setattr(jqm, "_INTERPRET", True)

    def jloss(xa):
        y = jqm.quant_matmul_qw(xa, jw)
        return jnp.sum(y * g), y

    (_, jy), jdx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty = tqm.quant_matmul_qw(xt, tw)
    (ty * torch.tensor(g)).sum().backward()
    _close(ty, jy, "y")
    _close(xt.grad, jdx, "dx")
    # the rule itself: the f32 product with the dequantized weight
    rule = tqm.quant_matmul_dx(torch.tensor(g), tw.codes, tw.scales, wd, gs,
                               256, torch.float32)
    assert torch.equal(rule, xt.grad)


# ------------------------------------------------------ K2 and its group


def _norm_inputs(seed, k=256, m=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.normal(size=(k,))).astype(np.float32)
    return rng, x, nw


@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int4", 128),
                                   ("int8", 64)])
def test_fused_norm_matmul_quant_grads(wd, gs):
    rng, x, nw = _norm_inputs(11)
    jw, tw = _quantized((rng.normal(size=(256, 384)) * 0.05)
                        .astype(np.float32), wd, gs)
    g = rng.normal(size=(12, 384)).astype(np.float32)

    def jloss(xa, nwa):
        y = jfnm.fused_norm_matmul_pure(xa, nwa, EPS, jw, train=True)
        return jnp.sum(y * g), y

    (_, jy), (jdx, jdnw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(nw))
    xt = torch.tensor(x, requires_grad=True)
    nwt = torch.tensor(nw, requires_grad=True)
    ty = tfnm.fused_norm_matmul_pure(xt, nwt, EPS, tw)
    (ty * torch.tensor(g)).sum().backward()
    _close(ty, jy, "y")
    _close(xt.grad, jdx, "dx")
    _close(nwt.grad, jdnw, "d norm_w")


@pytest.mark.parametrize("group", ["one", "two", "three", "mixed"])
def test_fused_norm_multi_matmul_quant_grads(group):
    rng, x, nw = _norm_inputs(13)
    widths = {"one": (256,), "two": (384, 128),
              "three": (256, 128, 128), "mixed": (256, 128)}[group]
    forms = [("int8", -1), ("int4", 128), ("int8", 64)]
    jws, tws = [], []
    for i, n in enumerate(widths):
        w = (rng.normal(size=(256, n)) * 0.05).astype(np.float32)
        if group == "mixed" and i == 1:
            jws.append(jnp.asarray(w))
            tws.append(torch.tensor(w))
            continue
        jw, tw = _quantized(w, *forms[i])
        jws.append(jw)
        tws.append(tw)
    gs = [rng.normal(size=(12, n)).astype(np.float32) for n in widths]

    def jloss(xa, nwa):
        ys = jfnm.fused_norm_multi_matmul_pure(xa, nwa, EPS, tuple(jws),
                                               train=True)
        return sum(jnp.sum(y * g) for y, g in zip(ys, gs)), ys

    (_, jys), (jdx, jdnw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(nw))
    xt = torch.tensor(x, requires_grad=True)
    nwt = torch.tensor(nw, requires_grad=True)
    tys = tfnm.fused_norm_multi_matmul_pure(xt, nwt, EPS, tuple(tws))
    sum((y * torch.tensor(g)).sum() for y, g in zip(tys, gs)).backward()
    assert len(tys) == len(widths)
    for i, (ty, jy) in enumerate(zip(tys, jys)):
        _close(ty, jy, f"y{i}")
    _close(xt.grad, jdx, "dx")
    _close(nwt.grad, jdnw, "d norm_w")


# ------------------------------------------- the train executors, a layer

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0)
LAYER_SHAPES = {
    "input_layernorm.weight": (128,),
    "self_attn.q_proj.weight": (128, 128),
    "self_attn.k_proj.weight": (128, 64),
    "self_attn.v_proj.weight": (128, 64),
    "self_attn.o_proj.weight": (128, 128),
    "post_attention_layernorm.weight": (128,),
    "mlp.gate_proj.weight": (128, 256),
    "mlp.up_proj.weight": (128, 256),
    "mlp.down_proj.weight": (256, 128),
}
HEAD_SHAPES = {"model.norm.weight": (128,), "lm_head.weight": (128, 256)}
NORMS = ("input_layernorm.weight", "post_attention_layernorm.weight",
         "model.norm.weight")


def _layer_params(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in {**LAYER_SHAPES, **HEAD_SHAPES}.items():
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.normal(size=shape)).astype(
                np.float32)
        else:
            out[name] = (rng.normal(size=shape) * 0.06).astype(np.float32)
    return out


def _jax_attend(b, s):
    nh, hk = CFG["num_attention_heads"], CFG["num_key_value_heads"]
    hd = CFG["hidden_size"] // nh
    cos, sin = jax_rope_tables(s, hd, CFG["rope_theta"], jnp.float32)

    def attend(q, k, v, residual=None, o_w=None):
        qa, ka = q.reshape(b, s, nh, hd), k.reshape(b, s, hk, hd)
        q2, k2 = apply_rotary_pos_emb(qa.astype(jnp.float32),
                                      ka.astype(jnp.float32), cos, sin)
        epilogue = ()
        if o_w is not None:
            epilogue = (("matmul", o_w), ("residual_add", residual))
        out = flash_attention_pure(q2.astype(qa.dtype), k2.astype(ka.dtype),
                                   v.reshape(b, s, hk, hd), causal=True,
                                   epilogue=epilogue or None)
        return out if o_w is not None else out.reshape(b, s, nh * hd)

    return attend


def _layer_pair(wd, gs):
    """(f32 numpy params, the JAX package's quantized dict, the port's
    bridged copy)."""
    raw = _layer_params(5)
    jq = jax_quantize({n: jnp.asarray(v) for n, v in raw.items()},
                      algo=ALGO[wd], group_size=gs)
    tq = {}
    for name, val in jq.items():
        if isinstance(val, JaxQuantizedWeight):
            tq[name] = tqm.QuantizedWeight(
                torch.tensor(np.asarray(val.codes)),
                torch.tensor(np.asarray(val.scales)), wd, gs, val.shape)
        else:
            tq[name] = torch.tensor(np.asarray(val))
    return raw, jq, tq


def _port_layer_and_head(tq, raw, h, g, enabled):
    """The port's forward + backward of the quantized layer and head with
    cotangent ``g`` on the logits: (logits, h, {norm name: leaf})."""
    cfg = LlamaConfig(num_hidden_layers=1, **CFG)

    def attend(q, k, v, residual=None, o_w=None):
        return _train_attend(cfg, q, k, v, False, None, residual, o_w)

    ht = torch.tensor(h, requires_grad=True)
    norms = {n: torch.tensor(raw[n], requires_grad=True) for n in NORMS}
    prms = {**tq, **norms}
    out = tfusion.run_train_decoder_layer(
        {n: prms[n] for n in LAYER_SHAPES}, ht, EPS, attend, enabled=enabled)
    logits = tfusion.run_train_lm_head({n: prms[n] for n in HEAD_SHAPES},
                                       out, EPS, enabled=enabled)
    (logits * torch.tensor(g)).sum().backward()
    return logits, ht, norms


def _layer_inputs(b, s):
    rng = np.random.default_rng(9)
    return (rng.normal(size=(b, s, 128)).astype(np.float32),
            rng.normal(size=(b, s, 256)).astype(np.float32))


@pytest.mark.parametrize("plan", ["fused", "unfused"])
@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int4", 128)])
def test_train_layer_and_head_grads_quantized(wd, gs, plan):
    """dh and the three norm weights' gradients of one quantized decoder
    layer + final norm + LM head (every 2-D weight a QuantizedWeight, as
    ``quantize_for_inference`` leaves a layer) against the JAX package's
    train executors, with a seeded cotangent on the logits."""
    b, s = 2, 16
    raw, jq, tq = _layer_pair(wd, gs)
    h, g = _layer_inputs(b, s)
    jattend = _jax_attend(b, s)

    with _flags(fused_train=True, fused_train_fusions=TRAIN_FAMS):
        def jloss(ha, norms):
            prms = {**jq, **dict(zip(NORMS, norms))}
            out = jfusion.run_train_decoder_layer(
                {n: prms[n] for n in LAYER_SHAPES}, ha, EPS, jattend)
            logits = jfusion.run_train_lm_head(
                {n: prms[n] for n in HEAD_SHAPES}, out, EPS)
            return jnp.sum(logits * g), logits

        (_, jlogits), (jdh, jdn) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(h), tuple(jnp.asarray(raw[n]) for n in NORMS))
        logits, ht, norms = _port_layer_and_head(
            tq, raw, h, g, () if plan == "unfused" else None)
    _close(logits, jlogits, "logits")
    _close(ht.grad, jdh, "dh")
    for name, jd in zip(NORMS, jdn):
        _close(norms[name].grad, jd, f"d {name}")
    for name, val in tq.items():
        if isinstance(val, tqm.QuantizedWeight):
            assert val.scales.grad is None and val.codes.grad is None


@pytest.mark.parametrize("plan", ["fused", "unfused"])
def test_quantized_train_plan_counts_the_wrappers(monkeypatch, plan):
    """``fusion.quantized_train_launches`` against the calls one CPU
    forward + backward of the quantized layer and head makes of the K2, K4,
    K6 and K7 wrappers (each launches its kernel where it is called on CUDA
    tensors): K2 once (the head), K4 for q/k/v, o, gate/up, down, K6/K7
    for the two multi-consumer norms (unfused: every norm, every matmul
    K4)."""
    calls = collections.Counter()

    def count(mod, name, key):
        orig = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    count(tqm, "_quant_matmul", "quant_matmul")
    count(tfnm, "_norm_matmul", "fused_norm_matmul")
    count(tfnr, "rms_norm_fwd", "rms_norm_fwd")
    count(tfnr, "rms_norm_bwd", "rms_norm_bwd")
    enabled = () if plan == "unfused" else None
    raw, _, tq = _layer_pair("int8", -1)
    with _flags(fused_train=True, fused_train_fusions=TRAIN_FAMS):
        _port_layer_and_head(tq, raw, *_layer_inputs(2, 16), enabled)
        want = tfusion.quantized_train_launches(1, enabled=enabled)
    assert want["fused_norm_matmul"] == (0 if enabled == () else 1)
    for key in ("quant_matmul", "fused_norm_matmul", "rms_norm_fwd",
                "rms_norm_bwd"):
        assert calls[key] == want[key], (key, dict(calls), want)


# ------------------------------------------------ the weight-only rule


def test_codes_and_scales_take_no_gradient():
    """Scales that require grad get none through K4, K2's quantized form
    or a quantized group (codes are integers: they cannot require grad);
    x and the norm weight do."""
    rng, x, nw = _norm_inputs(17)
    _, tw = _quantized((rng.normal(size=(256, 128)) * 0.05)
                       .astype(np.float32), "int8", 128)
    tw.scales.requires_grad_(True)
    with pytest.raises(RuntimeError):
        tw.codes.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    nwt = torch.tensor(nw, requires_grad=True)
    outs = [tqm.quant_matmul_qw(xt, tw),
            tfnm.fused_norm_matmul_pure(xt, nwt, EPS, tw),
            *tfnm.fused_norm_multi_matmul_pure(xt, nwt, EPS, (tw, tw))]
    sum(o.sum() for o in outs).backward()
    assert tw.scales.grad is None
    assert xt.grad is not None and nwt.grad is not None


@pytest.mark.parametrize("fused", [True, False])
def test_adamw8bit_seam_refuses_codes(fused):
    """Quantized codes are never update targets: the AdamW8bit seam raises
    on an integer param with the fused family on and off (the JAX
    package's ``test_fused_adamw8bit_weight_only_rule``)."""
    g = torch.zeros((16, 16))
    for codes in (torch.zeros((16, 16), dtype=torch.int8),
                  torch.zeros((16, 16), dtype=torch.int32)):
        st = tfou.init_state(g, master=False)
        with _flags(fused_train=fused):
            with pytest.raises(ValueError, match="weight-only"):
                tfou.adamw8bit_update(codes, g, st, 1e-3, 1, 0.0, 1.0, 0.9,
                                      0.999, 1e-8)
