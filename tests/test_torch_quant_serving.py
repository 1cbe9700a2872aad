"""int8-weight + int8-KV serving: the PyTorch port vs the JAX package, end
to end on CPU.

A JAX ``LlamaForCausalLM`` is built from ``paddle.seed(0)`` and copied into
the port (``models/bridge.py``), as tests/test_torch_llama_serving.py does,
on the same two configs (tiny, and head_dim 128). Both quantize with
``quantize_for_inference``; both serve with ``cache_dtype="int8"`` on their
plain paths in float32. Checked:

  * the port's ``quantize_for_inference`` codes and scales are bit-identical
    to the JAX package's (int8 per channel, int4 group 64);
  * the quantized-params bridge carries the JAX dict over unchanged, and
    refuses a missing or extra name, a bad shape or inconsistent metadata;
  * quantized ``prompt_logits_pure`` within 1e-4 (f32; summation order);
  * greedy ``generate_paged(params=..., cache_dtype="int8")`` tokens are
    identical. The prompt seed is one where the rollout has no near-tie:
    the smallest top-1/top-2 gap of the logits each token was picked from
    is printed and must exceed 1e-3, an order above what the two sides'
    summation orders can move;
  * chip_smoke.py's yardstick for the int8 path on the card (a
    teacher-forced plain forward with ``int8_cache_attention``) reproduces
    the served int8 logits here, where serving runs the same plain ops.

The gate is port-int8 vs reference-int8, never int8 vs fp.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import prompt_logits_pure as jax_prompt_logits
from paddle_tpu.models.llama import \
    quantize_for_inference as jax_quantize_for_inference

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            quantized_params_from_numpy)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           prompt_logits_pure,
                                           quantize_for_inference)
from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

CONFIGS = {
    "tiny": {},
    "kernel_shaped": dict(vocab_size=128, hidden_size=256,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=64, rope_theta=10000.0),
}
QUANT = [("weight_only_int8", -1), ("weight_only_int4", 64)]
# (prompt length, new tokens, page size, prompt seed)
ROLLOUT = (9, 6, 8, 8)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    paddle.seed(0)
    np.random.seed(0)
    jcfg = JaxConfig.tiny(**kw) if request.param == "tiny" else JaxConfig(**kw)
    jmodel = JaxLlama(jcfg)
    params = {n: np.asarray(p._array) for n, p in jmodel.named_parameters()}
    cfg = (LlamaConfig.tiny(**kw) if request.param == "tiny"
           else LlamaConfig(**kw))
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_params(tmodel, params)
    return request.param, jmodel, jcfg, tmodel


def _jax_qparams(jmodel, algo, gs):
    return jax_quantize_for_inference(
        {n: p._array for n, p in jmodel.named_parameters()}, algo, gs)


def _ids(cfg, s0, seed, b=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s0)).astype(np.int32)


@pytest.mark.parametrize("algo,gs", QUANT)
def test_quantize_for_inference_matches_jax_bitwise(pair, algo, gs):
    name, jmodel, _, tmodel = pair
    jq = _jax_qparams(jmodel, algo, gs)
    tq = quantize_for_inference(tmodel, algo, gs)
    assert sorted(tq) == sorted(jq)
    n_quant = 0
    for n, jv in jq.items():
        tv = tq[n]
        if isinstance(tv, QuantizedWeight):
            n_quant += 1
            assert (tv.weight_dtype, tv.group_size, tv.shape) == \
                (jv.weight_dtype, jv.group_size, jv.shape), n
            np.testing.assert_array_equal(tv.codes.numpy(),
                                          np.asarray(jv.codes), err_msg=n)
            np.testing.assert_array_equal(tv.scales.numpy(),
                                          np.asarray(jv.scales), err_msg=n)
        else:
            assert not hasattr(jv, "codes"), n
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=n)
    # 7 matmuls per layer and the untied head; embedding and norms stay
    assert n_quant == 7 * tmodel.config.num_hidden_layers + 1, name


@pytest.mark.parametrize("algo,gs", QUANT)
def test_quantized_bridge_matches_port_quantization(pair, algo, gs):
    _, jmodel, _, tmodel = pair
    bridged = quantized_params_from_numpy(tmodel,
                                          _jax_qparams(jmodel, algo, gs))
    own = quantize_for_inference(tmodel, algo, gs)
    for n, tv in own.items():
        bv = bridged[n]
        if isinstance(tv, QuantizedWeight):
            assert isinstance(bv, QuantizedWeight), n
            assert torch.equal(bv.codes, tv.codes), n
            assert torch.equal(bv.scales, tv.scales), n
            assert (bv.weight_dtype, bv.group_size, bv.shape) == \
                (tv.weight_dtype, tv.group_size, tv.shape)
        else:
            assert torch.equal(bv, tv), n


def test_quantized_bridge_refuses_mismatches(pair):
    _, jmodel, _, tmodel = pair
    jq = _jax_qparams(jmodel, "weight_only_int8", -1)
    name = "model.layers.0.mlp.down_proj.weight"
    qw = jq[name]
    bad = {
        "missing": {n: v for n, v in jq.items() if n != name},
        "extra": {**jq, "extra.weight": np.zeros(3, np.float32)},
        "shape": {**jq, "model.norm.weight": np.zeros(3, np.float32)},
        "logical shape": {**jq, name: QuantizedWeight(
            qw.codes, qw.scales, "int8", -1, qw.shape[::-1])},
        "weight_dtype": {**jq, name: QuantizedWeight(
            qw.codes, qw.scales, "int4", -1, qw.shape)},
        "group_size": {**jq, name: QuantizedWeight(
            qw.codes, qw.scales, "int8", 64, qw.shape)},
    }
    for what, params in bad.items():
        with pytest.raises((KeyError, ValueError)):
            quantized_params_from_numpy(tmodel, params)
            pytest.fail(f"accepted a {what} mismatch")


@pytest.mark.parametrize("algo,gs", QUANT)
def test_quantized_prompt_logits_match_jax(pair, algo, gs):
    name, jmodel, jcfg, tmodel = pair
    ids = _ids(tmodel.config, 11, seed=1)
    jq = _jax_qparams(jmodel, algo, gs)
    j = np.asarray(jax_prompt_logits(jq, jnp.asarray(ids), jcfg))
    t = prompt_logits_pure(quantized_params_from_numpy(tmodel, jq),
                           torch.tensor(ids), tmodel.config).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("algo,gs", QUANT)
def test_generate_paged_int8_tokens_match_jax(pair, algo, gs):
    name, jmodel, _, tmodel = pair
    s0, new, page, seed = ROLLOUT
    ids = _ids(tmodel.config, s0, seed)
    jq = _jax_qparams(jmodel, algo, gs)
    j = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=new, page_size=page,
        params=jq, cache_dtype="int8")._array)
    t, logits = tmodel.generate_paged(
        ids, max_new_tokens=new, page_size=page, return_logits=True,
        params=quantize_for_inference(tmodel, algo, gs), cache_dtype="int8")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    top2 = np.sort(logits.numpy(), axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    print(f"{name} {algo} g{gs}: smallest top-1/top-2 logit gap "
          f"{margin:.4g}")
    assert margin > 1e-3, f"near-tie in the rollout ({margin})"
    np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{name} {algo}")


def test_generate_paged_int8_unfused_chain_matches_fused(pair):
    """Flags off (the op-by-op chain, CPU only) decodes the same tokens on
    the int8 path."""
    _, _, _, tmodel = pair
    s0, new, page, seed = ROLLOUT
    ids = _ids(tmodel.config, s0, seed)
    qp = quantize_for_inference(tmodel)
    fused = tmodel.generate_paged(ids, max_new_tokens=new, page_size=page,
                                  params=qp, cache_dtype=torch.int8)
    old = tflags.get_flag("fused_decode")
    tflags.set_flags({"fused_decode": False})
    try:
        plain = tmodel.generate_paged(ids, max_new_tokens=new,
                                      page_size=page, params=qp,
                                      cache_dtype="int8")
    finally:
        tflags.set_flags({"fused_decode": old})
    torch.testing.assert_close(plain, fused, rtol=0, atol=0)


def test_generate_paged_rejects_other_cache_dtypes(pair):
    _, _, _, tmodel = pair
    ids = _ids(tmodel.config, 4, seed=2)
    for bad in ("int4", torch.float16, "bfloat16"):
        with pytest.raises(ValueError):
            tmodel.generate_paged(ids, max_new_tokens=2, cache_dtype=bad)


def test_chip_smoke_int8_reference_reproduces_the_int8_path(pair,
                                                           monkeypatch):
    """chip_smoke.py holds the card's int8w+int8kv logits to a
    teacher-forced plain forward of the quantized function whose decode
    rows attend over quantize->dequantized K/V (``int8_cache_attention``).
    On the CPU, where serving runs those same plain ops, that forward
    reproduces the served logits at every generated position (f32,
    summation order only: 1e-4)."""
    import chip_smoke
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    _, _, _, tmodel = pair
    s0, new, page, seed = ROLLOUT
    ids = _ids(tmodel.config, s0, seed)
    qp = quantize_for_inference(tmodel)
    out, logits = tmodel.generate_paged(
        ids, max_new_tokens=new, page_size=page, return_logits=True,
        params=qp, cache_dtype="int8")
    monkeypatch.setattr(chip_smoke, "PROMPT", s0)
    monkeypatch.setattr(tfa, "_reference_attention",
                        chip_smoke.int8_cache_attention(
                            tfa._reference_attention))
    ref = prompt_logits_pure(qp, out[:, :-1].long(), tmodel.config,
                             plain=True)[:, s0 - 1:]
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
