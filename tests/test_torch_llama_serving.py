"""Llama serving: the PyTorch port vs the JAX package, end to end on CPU.

A JAX ``LlamaForCausalLM`` is built from ``paddle.seed(0)``; its
parameters go through numpy into the port (``models/bridge.py``). Both run
their plain paths on the CPU in float32. Checked on the tiny config and on
the kernel-shaped config of tests/test_fused_decode.py (head_dim 128):

  * ``prompt_logits_pure`` logits agree within 1e-4 (f32; only summation
    order differs between XLA and torch);
  * greedy ``generate_paged`` tokens are identical. The prompts are drawn
    from seeds where the JAX reference has no near-tie: the smallest
    top-1/top-2 logit gap along the rollout is printed and must exceed
    1e-3, two orders above the logits tolerance.
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

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models.bridge import load_numpy_params
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

CONFIGS = {
    "tiny": {},
    # tests/test_fused_decode.py kmodel: head_dim 128, GQA 2:1
    "kernel_shaped": dict(vocab_size=128, hidden_size=256,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=64, rope_theta=10000.0),
}
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


def _ids(cfg, s0, seed, b=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s0)).astype(np.int32)


def _jax_logits(jmodel, jcfg, ids):
    prms = {n: p._array for n, p in jmodel.named_parameters()}
    return np.asarray(jax_prompt_logits(prms, jnp.asarray(ids), jcfg))


def test_bridge_copies_every_parameter(pair):
    _, jmodel, _, tmodel = pair
    jp = {n: np.asarray(p._array) for n, p in jmodel.named_parameters()}
    tp = {n: p.detach().numpy() for n, p in tmodel.named_parameters()}
    assert sorted(jp) == sorted(tp)
    for n in jp:
        np.testing.assert_array_equal(tp[n], jp[n], err_msg=n)


def test_prompt_logits_match_jax(pair):
    name, jmodel, jcfg, tmodel = pair
    ids = _ids(tmodel.config, 11, seed=1)
    j = _jax_logits(jmodel, jcfg, ids)
    t = tmodel(ids).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=name)


def test_generate_paged_tokens_match_jax(pair):
    name, jmodel, jcfg, tmodel = pair
    s0, new, page, seed = ROLLOUT
    ids = _ids(tmodel.config, s0, seed)
    j = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=new, page_size=page)._array)
    t = tmodel.generate_paged(ids, max_new_tokens=new, page_size=page)
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    # the reference's own decision margin along this rollout (teacher-
    # forced logits at the positions that chose each generated token)
    logits = _jax_logits(jmodel, jcfg, j[:, :-1])[:, s0 - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    print(f"{name}: smallest top-1/top-2 logit gap {margin:.4g}")
    assert margin > 1e-3, f"near-tie in the reference rollout ({margin})"
    np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def test_generate_paged_unfused_chain_matches_fused(pair):
    """Flag off (the op-by-op chain, CPU only) decodes the same tokens."""
    _, _, _, tmodel = pair
    s0, new, page, seed = ROLLOUT
    ids = _ids(tmodel.config, s0, seed)
    fused = tmodel.generate_paged(ids, max_new_tokens=new, page_size=page)
    old = tflags.get_flag("fused_decode")
    tflags.set_flags({"fused_decode": False})
    try:
        plain = tmodel.generate_paged(ids, max_new_tokens=new,
                                      page_size=page)
    finally:
        tflags.set_flags({"fused_decode": old})
    torch.testing.assert_close(plain, fused, rtol=0, atol=0)


def test_generate_paged_single_token_is_prefill_argmax(pair):
    """max_new_tokens=1 is the prefill alone: its token is the argmax of
    the prompt logits at the last position."""
    _, _, _, tmodel = pair
    ids = _ids(tmodel.config, 7, seed=3)
    out = tmodel.generate_paged(ids, max_new_tokens=1, page_size=4)
    assert tuple(out.shape) == (2, 8)
    np.testing.assert_array_equal(out[:, :7].numpy(), ids)
    np.testing.assert_array_equal(
        out[:, 7].numpy(), tmodel(ids)[:, -1].argmax(-1).numpy())
    with pytest.raises(ValueError):
        tmodel.generate_paged(ids, max_new_tokens=0)
