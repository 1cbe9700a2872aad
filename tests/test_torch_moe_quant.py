"""Quantized experts: the port's int8/int4 grouped matmul and ``quantize_experts`` vs the JAX package's, on CPU.

The same numpy inputs (f32) go through the JAX function and the port's
counterpart; a JAX ``MoEForCausalLM`` built from ``paddle.seed(0)`` is
carried into the port through ``models/bridge.py``, and each side
quantizes its own experts (or the bridge carries the JAX codes across).
Where the JAX function reaches a Pallas kernel it runs in interpret mode
(``_INTERPRET``), as ``tests/test_moe_dropless.py`` runs it. Bars:

  * ``quantize_grouped_weight``: codes and scales bit-identical for every
    (algorithm, group size) pair, K a multiple of 64 but not of 128 (the
    128-row groups' last one short);
  * the quantized forward against ``grouped_matmul_reference`` and the
    interpret-mode Pallas kernel at 1e-5 over ``OFFSETS`` (int8 and int4,
    per channel and group 64; measured equal here);
  * dx against ``jax.grad`` through the JAX quantized custom VJP (the
    dequant-transpose oracle of ``test_int8_grad_flows_to_x_only``) at
    the fp grads' bars (rtol 1e-4, atol 1e-5); codes, scales and offsets
    take no gradient (the JAX scales cotangent is zero);
  * ``MoEForCausalLM.quantize_experts``: logits, aux and loss, dropless
    on and off, at 1e-5 (the fp model's bar; measured ~1.4e-6); step-1
    gradients of every parameter at 1e-6 absolute (read off a JAX
    ``SGD(learning_rate=1.0)`` step, as ``tests/test_torch_moe_train.py``
    does), the expert stacks' gradients zero in the JAX package and
    absent in the port (their parameters are not used);
  * the bridge (``expert_quant_from_numpy``) carries the JAX codes across
    (logits at 1e-5, codes equal to the port's own) and refuses a wrong
    layer count, key, dtype, packed-row count, scale shape or group size;
  * the quantized launch plan, and a CPU forward + backward calling each
    plain version as often as the plan says its kernel launches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import moe as jmoe
from paddle_tpu.ops.pallas import grouped_matmul as jgm

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import moe as tmoe
from paddle_tpu_torch.models.bridge import (expert_quant_from_numpy,
                                            load_numpy_params)
from paddle_tpu_torch.ops import kernels as tkernels
from paddle_tpu_torch.ops.kernels import _build, fusion
from paddle_tpu_torch.ops.kernels import grouped_matmul as tgm

#: group offsets over 64 rows of 4 groups (``tests/test_torch_moe.py``'s)
OFFSETS = ([0, 16, 32, 48, 64], [0, 5, 5, 40, 64], [0, 0, 0, 0, 64],
           [0, 64, 64, 64, 64], [0, 0, 21, 50, 64], [0, 9, 30, 64, 64])
ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
#: (weight type, group size) of the forward and gradient cases
FORMS = [("int8", -1), ("int8", 64), ("int4", -1), ("int4", 64)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgm, "_INTERPRET", True)


@pytest.fixture
def dropless_flag(request):
    """Set ``moe_dropless`` on both sides for one test."""
    old = (jflags.get_flag("moe_dropless"), tflags.get_flag("moe_dropless"))
    jflags.set_flags({"moe_dropless": request.param})
    tflags.set_flags({"moe_dropless": request.param})
    yield request.param
    jflags.set_flags({"moe_dropless": old[0]})
    tflags.set_flags({"moe_dropless": old[1]})


def _arrays(*shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _codes(w, wd, gs):
    """The JAX package's (codes, scales) of the stack w, as numpy."""
    c, s = jgm.quantize_grouped_weight(jnp.asarray(w), ALGOS[wd], gs)
    return np.asarray(c), np.asarray(s)


# ---------------------------------------------------------------------------
# the grouped matmul's quantized forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group_size", [-1, 64, 128])
@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_quantize_grouped_weight_is_bit_identical(wd, group_size):
    (w,) = _arrays((3, 192, 80), seed=2, scale=0.1)
    jc, js = _codes(w, wd, group_size)
    tc, ts = tgm.quantize_grouped_weight(torch.tensor(w), ALGOS[wd],
                                         group_size)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("wd,group_size", FORMS)
@pytest.mark.parametrize("off", OFFSETS)
def test_quantized_forward_matches_jax(interpret, off, wd, group_size):
    x, w = _arrays((64, 128), (4, 128, 256), seed=1)
    codes, scales = _codes(w * 0.1, wd, group_size)
    jo = jnp.asarray(off, jnp.int32)
    args = (jnp.asarray(codes), jnp.asarray(scales), wd, group_size)
    ref = np.asarray(jgm.grouped_matmul_reference(jnp.asarray(x), jo, *args))
    kern = np.asarray(jgm._pallas_grouped_matmul(
        jnp.asarray(x), jo, *args, (16, 128, 128)))
    got = tgm.grouped_matmul(torch.tensor(x),
                             torch.tensor(off, dtype=torch.int32),
                             torch.tensor(codes), torch.tensor(scales), wd,
                             group_size).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wd,group_size", FORMS)
@pytest.mark.parametrize("off", OFFSETS[1:4])
def test_quantized_dx_matches_jax_grad(interpret, off, wd, group_size):
    x, w, coef = _arrays((64, 128), (4, 128, 256), (64, 256), seed=3)
    codes, scales = _codes(w * 0.1, wd, group_size)
    jo = jnp.asarray(off, jnp.int32)

    def loss(x2, s2):
        return jnp.sum(jgm.grouped_matmul(x2, jo, jnp.asarray(codes), s2,
                                          wd, group_size) * coef)

    dx0, ds0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(scales))
    assert not np.asarray(ds0).any()
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(scales, requires_grad=True)
    y = tgm.grouped_matmul(xt, torch.tensor(off, dtype=torch.int32),
                           torch.tensor(codes), st, wd, group_size)
    (y * torch.tensor(coef)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx0), rtol=1e-4,
                               atol=1e-5)
    assert st.grad is None


def test_quantized_grouped_matmul_refusals():
    x, w = _arrays((8, 128), (2, 128, 16))
    off = torch.tensor([0, 4, 8], dtype=torch.int32)
    codes, scales = (torch.tensor(a) for a in _codes(w, "int8", -1))
    with pytest.raises(ValueError, match="requires scales"):
        tgm.grouped_matmul(torch.tensor(x), off, codes, None, "int8")
    with pytest.raises(ValueError, match="fp, int8 or int4"):
        tgm.grouped_matmul(torch.tensor(x), off, codes, scales, "int2")
    with pytest.raises(ValueError, match="trans_w"):
        tgm.grouped_matmul_reference(torch.tensor(x), off, codes, scales,
                                     "int8", trans_w=True)


def test_cpu_quantized_wrapper_runs_plain_and_builds_nothing():
    x, w = _arrays((40, 128), (3, 128, 32), seed=4)
    codes, scales = (torch.tensor(a) for a in _codes(w, "int4", 64))
    off = torch.tensor([0, 0, 17, 40], dtype=torch.int32)
    before = tkernels.launch_counts()
    y = tgm.gmm_quant(torch.tensor(x), off, codes, scales, "int4", 64)
    dense = tgm._expand_expert_weight(codes, scales, "int4", 64, 128,
                                      torch.float32)
    torch.testing.assert_close(y[:17], torch.tensor(x[:17]) @ dense[1])
    torch.testing.assert_close(y[17:], torch.tensor(x[17:]) @ dense[2])
    assert tkernels.launch_counts() == before
    assert _build._lib is None
    assert "pt_grouped_matmul_quant" in _build._SIGNATURES


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _models(wd=None, group_size=-1, **kw):
    """(JAX model, port model, the JAX model's fp params); with ``wd``
    both quantize their own experts."""
    paddle.seed(0)
    jm = jmoe.MoEForCausalLM(jmoe.MoEConfig.tiny(**kw))
    params = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    tm = tmoe.MoEForCausalLM(tmoe.MoEConfig.tiny(**kw), device="cpu")
    load_numpy_params(tm, params)
    if wd is not None:
        assert jm.quantize_experts(ALGOS[wd], group_size) is jm
        assert tm.quantize_experts(ALGOS[wd], group_size) is tm
    return jm, tm, params


def _ids(vocab=256, shape=(2, 16), seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _assert_logits_match(jm, tm, ids):
    jl, ja = jm(paddle.to_tensor(ids.astype(np.int64)))
    with torch.no_grad():
        tl, ta = tm(torch.tensor(ids))
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    jloss = float(jm.loss((jl, ja), paddle.to_tensor(ids.astype(np.int64))))
    np.testing.assert_allclose(float(tm.loss((tl, ta), torch.tensor(ids))),
                               jloss, rtol=1e-5)


@pytest.mark.parametrize("dropless_flag", [True, False], indirect=True)
@pytest.mark.parametrize("wd,group_size", [("int8", -1), ("int8", 128),
                                           ("int4", 64)])
def test_quantized_model_matches_jax(dropless_flag, wd, group_size):
    jm, tm, _ = _models(wd, group_size)
    for jl_, tl_ in zip(jm.layers, tm.layers):
        jq, tq = jl_.mlp._expert_quant, tl_.mlp._expert_quant
        assert (tq["weight_dtype"], tq["group_size"]) == (wd, group_size)
        for name in ("w_gate", "w_up", "w_down"):
            for a, b in zip(jq[name], tq[name]):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _assert_logits_match(jm, tm, _ids())


def test_quantized_model_with_a_shared_expert_matches_jax():
    jm, tm, _ = _models("int8", -1, num_shared_experts=1)
    _assert_logits_match(jm, tm, _ids(seed=2))


@pytest.mark.parametrize("dropless_flag", [True, False], indirect=True)
@pytest.mark.parametrize("wd,group_size", [("int8", -1), ("int4", 64)])
def test_quantized_model_gradients_match_jax(dropless_flag, wd, group_size):
    jm, tm, params = _models(wd, group_size)
    ids = _ids()
    step = JaxTrainStep(jm, lambda o, lb: jm.loss(o, lb),
                        jopt.SGD(learning_rate=1.0,
                                 parameters=jm.parameters()))
    t = paddle.to_tensor(ids.astype(np.int64))
    jloss = float(step(t, t))
    jgrad = {n: params[n] - np.asarray(a) for n, a in step.params.items()}
    tm.train()
    loss = tm.loss(tm(torch.tensor(ids)), torch.tensor(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert sorted(jgrad) == sorted(n for n, _ in tm.named_parameters())
    stacks = 0
    for n, p in tm.named_parameters():
        if n.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            # unused once the experts are codes: zero in the JAX package,
            # no gradient at all in the port
            assert not jgrad[n].any() and p.grad is None, n
            stacks += 1
            continue
        np.testing.assert_allclose(p.grad.numpy(), jgrad[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    assert stacks == 3 * tm.config.num_hidden_layers


def test_quantize_experts_refuses_an_unknown_algo():
    _, tm, _ = _models()
    with pytest.raises(ValueError, match="unsupported expert quant algo"):
        tm.quantize_experts("llm.int8")
    with pytest.raises(ValueError, match="group_size"):
        tm.quantize_experts("weight_only_int8", 32)
    assert all(layer.mlp._expert_quant is None for layer in tm.layers)


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def _jax_quant(jm):
    return [layer.mlp._expert_quant for layer in jm.layers]


@pytest.mark.parametrize("wd,group_size", [("int8", -1), ("int4", 64)])
def test_bridge_carries_jax_expert_codes(wd, group_size):
    jm, tm, _ = _models()
    jm.quantize_experts(ALGOS[wd], group_size)
    expert_quant_from_numpy(tm, _jax_quant(jm))
    _assert_logits_match(jm, tm, _ids())
    _, own, _ = _models(wd, group_size)
    for a, b in zip(tm.layers, own.layers):
        qa, qb = a.mlp._expert_quant, b.mlp._expert_quant
        assert (qa["weight_dtype"], qa["group_size"]) == (wd, group_size)
        for name in ("w_gate", "w_up", "w_down"):
            for u, v in zip(qa[name], qb[name]):
                assert torch.equal(u, v), name


def _edit(quant, layer, **changes):
    """A copy of ``quant`` with numpy arrays and ``changes`` in one layer."""
    out = [{k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else v) for k, v in eq.items()} for eq in quant]
    out[layer].update(changes)
    return out


def test_bridge_refuses_bad_expert_codes():
    jm, tm, _ = _models()
    jm.quantize_experts("weight_only_int4", 64)
    good = _edit(_jax_quant(jm), 0)
    codes, scales = good[1]["w_up"]
    e, rows, n = codes.shape
    cases = [
        (good[:1], ValueError, "1 layers of expert codes for 2"),
        ([{k: v for k, v in good[0].items() if k != "w_down"}, good[1]],
         KeyError, "missing"),
        (_edit(good, 1, w_up=(codes.astype(np.int32), scales)), ValueError,
         r"layers\.1\.mlp\.w_up\[0\]: codes int32"),
        (_edit(good, 1, w_up=(np.zeros((e, 2 * rows, n), np.int8), scales)),
         ValueError, "codes int8"),
        (_edit(good, 1, w_up=(codes, scales[..., :n // 2])), ValueError,
         "scales float32"),
        (_edit(good, 1, w_up=(codes[:2], scales)), ValueError, "experts"),
        (_edit(good, 0, group_size=32), ValueError, "group_size 32"),
        (_edit(good, 0, weight_dtype="int2"), ValueError, "weight_dtype"),
    ]
    for quant, err, match in cases:
        with pytest.raises(err, match=match):
            expert_quant_from_numpy(tm, quant)
    assert all(layer.mlp._expert_quant is None for layer in tm.layers)
    expert_quant_from_numpy(tm, good)
    assert all(layer.mlp._expert_quant["weight_dtype"] == "int4"
               for layer in tm.layers)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


def test_quantized_launch_plan_counts(monkeypatch):
    """The plan at 3 layers: three K13 int8/int4 forwards and three K13 dX
    a layer, no K14; a CPU forward + backward of the quantized tiny model
    calls each plain version as often as the plan says its kernel
    launches."""
    plan = fusion.moe_train_kernel_launches_per_step(
        3, 0, enabled=fusion.TRAIN_FUSIONS, quantized_experts=True)
    fp = fusion.moe_train_kernel_launches_per_step(
        3, 0, enabled=fusion.TRAIN_FUSIONS)
    assert plan == {**fp, "grouped_matmul": 9, "grouped_matmul_quant": 9,
                    "segment_dw": 0}
    calls = {"grouped_matmul": 0, "grouped_matmul_quant": 0,
             "segment_dw": 0}

    def count(key, orig):
        def wrapped(*a, **kw):
            quant = (a[4] if len(a) > 4 else kw.get("weight_dtype", "fp"))
            if key == "grouped_matmul" and quant in ("int8", "int4"):
                calls["grouped_matmul_quant"] += 1
            else:
                calls[key] += 1
            return orig(*a, **kw)
        return wrapped

    for fn, key in (("grouped_matmul_reference", "grouped_matmul"),
                    ("segment_dw_reference", "segment_dw")):
        monkeypatch.setattr(tgm, fn, count(key, getattr(tgm, fn)))
    _, tm, _ = _models("int4", 64)
    tm.train()
    ids = torch.tensor(_ids())
    tm.loss(tm(ids), ids).backward()
    want = fusion.moe_train_kernel_launches_per_step(
        tm.config.num_hidden_layers, 0, quantized_experts=True)
    assert calls == {k: want[k] for k in calls}
