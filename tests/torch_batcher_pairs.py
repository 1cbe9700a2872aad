"""The port's ContinuousBatcher against the JAX package's, on the CPU.

Shared by ``tests/test_torch_prefix_cache.py``,
``tests/test_torch_kv_tiering.py`` and ``tests/test_torch_unified_arena.py``:
the tiny model of the JAX package's prefix-cache tests built from
``paddle.seed(0)`` and bridged into the port, its int8 weights (quantized by
the JAX package and bridged), and ``serve_pair``, which runs the same
submissions through both engines — the port under both attention plans —
and holds every token and every non-timing ``stats`` value equal.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    quantize_for_inference as jax_quantize

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            quantized_params_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

#: the JAX package's prefix-cache test model
MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=96,
             rope_theta=10000.0)
PLANS = ("norm_matmul,rope_append_attend", "norm_matmul")


def build_pair():
    """(JAX model, port model) with the same weights."""
    paddle.seed(0)
    np.random.seed(0)
    jmodel = JaxLlama(JaxConfig(**MODEL))
    params = {n: np.asarray(p._array) for n, p in jmodel.named_parameters()}
    tmodel = LlamaForCausalLM(LlamaConfig(**MODEL), device="cpu")
    load_numpy_params(tmodel, params)
    return jmodel, tmodel


def int8_params(jmodel, tmodel):
    """(JAX int8 params, the port's bridged copy)."""
    jq = jax_quantize({n: p._array for n, p in jmodel.named_parameters()})
    return jq, quantized_params_from_numpy(tmodel, jq)


def stack_kw(stack, jq=None, tq=None):
    """(JAX engine kwargs, port engine kwargs) of a stack: "fp", or "int8"
    (int8 weights + int8 KV)."""
    if stack == "fp":
        return {}, {}
    return (dict(quantized_params=jq, cache_dtype="int8"),
            dict(quantized_params=tq, cache_dtype="int8"))


def comparable(stats):
    """Every stat but the wall-clock timings (``*_s``, ``*_ms``)."""
    return {k: v for k, v in stats.items()
            if not (k.endswith("_s") or k.endswith("_ms"))}


def with_plan(plan, fn):
    old = tflags.get_flag("fused_decode_fusions")
    tflags.set_flags({"fused_decode_fusions": plan})
    try:
        return fn()
    finally:
        tflags.set_flags({"fused_decode_fusions": old})


def serve_pair(jmodel, tmodel, subs, jkw=None, tkw=None, drive=None,
               **kw):
    """Serve ``subs`` ((prompt, max_new, arrival) each) on a JAX engine
    and on the port's under each plan, with engine kwargs ``kw`` (+ the
    stack's ``jkw``/``tkw``). ``drive(engine, rids)`` runs an engine and
    returns its {rid: request} (default: one ``run()``). Asserts the
    port's tokens, statuses and non-timing stats equal the JAX engine's;
    returns (JAX engine, its done, [port engine, its done] per plan,
    rids)."""
    drive = drive or (lambda eng, rids: eng.run())

    def serve(eng):
        rids = [eng.submit(p, n, arrival_segment=a) for p, n, a in subs]
        return rids, drive(eng, rids)

    jeng = JaxBatcher(jmodel, **kw, **(jkw or {}))
    rids, jdone = serve(jeng)
    ports = []
    for plan in PLANS:
        teng = with_plan(plan, lambda: ContinuousBatcher(
            tmodel, **kw, **(tkw or {})))
        trids, tdone = with_plan(plan, lambda: serve(teng))
        assert trids == rids
        for r in rids:
            assert tdone[r].output_ids == jdone[r].output_ids, (plan, r)
            assert tdone[r].status == jdone[r].status, (plan, r)
            assert tdone[r].prefix_len == jdone[r].prefix_len, (plan, r)
        want, got = comparable(jeng.stats), comparable(teng.stats)
        assert set(want) <= set(got), sorted(set(want) - set(got))
        for k in want:
            assert got[k] == want[k], (plan, k, got[k], want[k])
        ports.append((teng, tdone))
    return jeng, jdone, ports, rids
