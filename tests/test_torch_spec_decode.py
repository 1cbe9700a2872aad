"""Speculative decoding end to end: the PyTorch port vs the JAX package, on CPU.

The model is tests/test_spec_decode.py's (vocab 128, hidden 64, 2 layers,
4/2 heads), built by the JAX package from ``paddle.seed(0)`` and bridged
into the port (``models/bridge.py``); int8w+int8kv runs bridge the JAX
package's ``quantize_for_inference`` dict and serve ``cache_dtype="int8"``
on both sides (port-int8 against reference-int8). Seeds are the
reference's own, clear of near-ties: 12 for the engine, 7 for the solo
oracle, 11 for budget and EOS.

  * solo ``generate_paged(spec_decode=True)``: tokens identical to the JAX
    package's spec and non-spec runs and to the port's non-spec run;
  * the batcher (``ContinuousBatcher(spec_decode=True, spec_k=4)``), in the
    fused plan and the unfused one: tokens and every ragged-path and spec
    stat equal to the JAX engine's, tokens equal to the port's spec-off
    engine, with real acceptance (drafts accepted, more than one token per
    target step);
  * budget and EOS act on accepted tokens; a proposer that raises fails its
    request alone; a custom ``DraftProposer`` slots in; the per-request
    draft counters sum to the engine's; the constructor's rules.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    quantize_for_inference as jax_quantize

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.inference.speculative import DraftProposer
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            quantized_params_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

CONFIG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              rope_theta=10000.0)
PLANS = ("norm_matmul,rope_append_attend", "norm_matmul")
STATS = ("ragged_steps", "segments", "prefills", "prefill_dispatches",
         "prefill_tokens_admitted", "token_budget_util", "host_sync_count",
         "wasted_slot_steps", "decode_steps", "tokens_emitted",
         "bucket_pad_tokens", "spec_steps", "draft_tokens_proposed",
         "draft_tokens_accepted", "acceptance_rate",
         "tokens_per_target_step")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    np.random.seed(0)
    jmodel = JaxLlama(JaxConfig(**CONFIG))
    params = {n: np.asarray(p._array) for n, p in jmodel.named_parameters()}
    tmodel = LlamaForCausalLM(LlamaConfig(**CONFIG), device="cpu")
    load_numpy_params(tmodel, params)
    jq = jax_quantize({n: p._array for n, p in jmodel.named_parameters()})
    return jmodel, tmodel, jq, quantized_params_from_numpy(tmodel, jq)


def _with_plan(plan, fn):
    old = tflags.get_flag("fused_decode_fusions")
    tflags.set_flags({"fused_decode_fusions": plan})
    try:
        return fn()
    finally:
        tflags.set_flags({"fused_decode_fusions": old})


def _rep_prompts(rng, reps=3):
    """tests/test_spec_decode.py's prompts: a tiled motif (drafts hit) and
    a random one (no match: the plain decode row)."""
    base = rng.integers(0, 128, size=4).astype(np.int32)
    return [np.tile(base, reps), rng.integers(0, 128, size=9).astype(
        np.int32)]


def _serve(eng, prompts, news):
    rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    done = eng.run()
    return [done[r] for r in rids]


def _engine(tmodel, spec, **kw):
    return ContinuousBatcher(tmodel, max_batch=2, max_seq=64, page_size=8,
                             prefix_caching=False, spec_decode=spec, **kw)


# ------------------------------------------------------------- the oracle


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_solo_spec_oracle_matches_jax(pair, int8):
    jmodel, tmodel, jq, tq = pair
    rng = np.random.default_rng(7)
    base = rng.integers(0, 128, size=4).astype(np.int32)
    ids = np.stack([np.tile(base, 3),
                    rng.integers(0, 128, size=12).astype(np.int32)])
    jkw = {"params": jq, "cache_dtype": "int8"} if int8 else {}
    tkw = {"params": tq, "cache_dtype": "int8"} if int8 else {}
    j_plain = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=10, page_size=8,
        **jkw)._array)
    j_spec = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=10, page_size=8,
        spec_decode=True, spec_k=3, **jkw)._array)
    np.testing.assert_array_equal(j_spec, j_plain)
    for plan in PLANS:
        got = _with_plan(plan, lambda: tmodel.generate_paged(
            ids, max_new_tokens=10, page_size=8, spec_decode=True,
            spec_k=3, **tkw))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), j_spec, err_msg=plan)
    plain = tmodel.generate_paged(ids, max_new_tokens=10, page_size=8, **tkw)
    np.testing.assert_array_equal(plain.numpy(), j_plain)


def test_solo_spec_counts_one_sync_and_real_acceptance(pair, monkeypatch):
    """The oracle verifies every row in one wave a step and accepts drafts
    on the tiled row (fewer verify steps than new tokens)."""
    _, tmodel, _, _ = pair
    from paddle_tpu_torch.models import llama as tllama

    steps = []
    real = tllama.LlamaForCausalLM._build_spec_verify_step

    def build(self, b, K):
        step = real(self, b, K)

        def counted(*a):
            steps.append(a[1].shape[0])
            return step(*a)

        return counted

    monkeypatch.setattr(tllama.LlamaForCausalLM, "_build_spec_verify_step",
                        build)
    base = np.random.default_rng(7).integers(0, 128, size=4)
    ids = np.tile(base, 3)[None].astype(np.int32)
    tmodel.generate_paged(ids, max_new_tokens=10, page_size=8,
                          spec_decode=True, spec_k=3)
    assert steps and all(t == 8 for t in steps)   # ceil(1 * 4 / 8) * 8
    assert len(steps) < 9


def test_solo_spec_k_validation(pair):
    _, tmodel, _, _ = pair
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="spec_k"):
        tmodel.generate_paged(ids, max_new_tokens=4, spec_decode=True,
                              spec_k=0)
    with pytest.raises(ValueError):
        tmodel.generate_paged(ids, max_new_tokens=4, spec_decode=True,
                              return_logits=True)


# ------------------------------------------------------------ the batcher


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_batcher_spec_tokens_and_stats_match_jax(pair, int8):
    jmodel, tmodel, jq, tq = pair
    prompts = _rep_prompts(np.random.default_rng(12))
    news = [14, 10]
    jkw = {"quantized_params": jq, "cache_dtype": "int8"} if int8 else {}
    tkw = {"quantized_params": tq, "cache_dtype": "int8"} if int8 else {}
    jeng = JaxBatcher(jmodel, max_batch=2, max_seq=64, page_size=8,
                      ragged=True, prefix_caching=False, spec_decode=True,
                      spec_k=4, **jkw)
    want = _serve(jeng, prompts, news)
    off = _serve(_engine(tmodel, False, **tkw), prompts, news)
    for plan in PLANS:
        eng = _with_plan(plan, lambda: _engine(tmodel, True, spec_k=4,
                                               **tkw))
        got = _with_plan(plan, lambda: _serve(eng, prompts, news))
        for g, w, o, n in zip(got, want, off, news):
            assert g.status == w.status == "ok"
            assert g.output_ids == w.output_ids, (plan, g.rid)
            assert g.tokens == o.tokens, (plan, g.rid)
            assert len(g.tokens) == n
            assert (g.draft_proposed, g.draft_accepted) == (
                w.draft_proposed, w.draft_accepted)
        for key in STATS:
            assert eng.stats[key] == jeng.stats[key], (plan, key)
        assert eng.stats["draft_tokens_accepted"] > 0
        assert eng.stats["tokens_per_target_step"] > 1.0
        assert eng.stats["wasted_slot_steps"] == 0
        # one readback a wave, and the spec loop runs no segment
        assert eng.stats["host_sync_count"] == eng.stats["ragged_steps"]
        assert eng.stats["segments"] == 0


def test_batcher_spec_mixed_wave_late_arrival_matches_jax(pair):
    """Verify segments ride beside a late arrival's prompt chunks (budget
    8: its 13-token prompt takes two waves), fused and unfused."""
    jmodel, tmodel, _, _ = pair
    rng = np.random.default_rng(9)
    base = rng.integers(0, 128, size=4).astype(np.int32)
    prompts = [np.tile(base, 4), rng.integers(0, 128, size=13).astype(
        np.int32)]
    kw = dict(max_batch=2, max_seq=40, page_size=8, prefill_chunk=8,
              spec_decode=True, spec_k=3)

    def serve(eng):
        ra = eng.submit(prompts[0], 10)
        rb = eng.submit(prompts[1], 6, arrival_segment=2)
        done = eng.run()
        return [done[ra].tokens, done[rb].tokens]

    jeng = JaxBatcher(jmodel, ragged=True, prefix_caching=False, **kw)
    want = serve(jeng)
    for plan in PLANS:
        eng = _with_plan(plan, lambda: ContinuousBatcher(
            tmodel, prefix_caching=False, **kw))
        assert _with_plan(plan, lambda: serve(eng)) == want, plan
        for key in STATS:
            assert eng.stats[key] == jeng.stats[key], (plan, key)
        assert eng.stats["draft_tokens_accepted"] > 0


@pytest.mark.parametrize("eos", [False, True], ids=["budget", "eos"])
def test_batcher_spec_budget_and_eos_on_accepted_tokens(pair, eos):
    """Emission never passes max_new_tokens even when a whole window is
    accepted, and an accepted EOS stops its slot as the plain path does
    (spec-off port, spec-on JAX). The EOS is the third token of the first
    request's spec-off rollout, so it fires inside a verify window."""
    jmodel, tmodel, _, _ = pair
    rng = np.random.default_rng(11)
    base = rng.integers(0, 128, size=3).astype(np.int32)
    prompts = [np.tile(base, 5), np.tile(base[::-1].copy(), 4)]
    news = [7, 5]
    eos_id = None
    if eos:
        eos_id = _serve(_engine(tmodel, False), prompts, news)[0].tokens[2]
    on = _serve(_engine(tmodel, True, spec_k=4, eos_token_id=eos_id),
                prompts, news)
    off = _serve(_engine(tmodel, False, eos_token_id=eos_id), prompts, news)
    jon = _serve(JaxBatcher(jmodel, max_batch=2, max_seq=64, page_size=8,
                            ragged=True, prefix_caching=False,
                            spec_decode=True, spec_k=4,
                            eos_token_id=eos_id), prompts, news)
    for r_on, r_off, r_j, n in zip(on, off, jon, news):
        assert r_on.tokens == r_off.tokens == r_j.tokens
        assert len(r_on.tokens) <= n
        if eos_id is not None and eos_id in r_on.tokens:
            assert r_on.tokens[-1] == eos_id
    if eos:
        assert any(eos_id in r.tokens for r in on), "EOS never emitted"


def test_raising_proposer_fails_its_request_alone(pair):
    """A proposer that raises for one request's history fails that request
    ("error", counted in request_errors); its neighbours' tokens equal a
    fault-free spec run's."""
    _, tmodel, _, _ = pair
    rng = np.random.default_rng(18)
    base = rng.integers(0, 128, size=4).astype(np.int32)
    prompts = [np.tile(base, 3), rng.integers(0, 128, size=7).astype(
        np.int32), np.tile(base[::-1].copy(), 3)]
    news = [8, 6, 8]
    victim = prompts[1]

    class Raising(DraftProposer):
        def __init__(self):
            from paddle_tpu_torch.inference.speculative import NGramDraft

            self.inner = NGramDraft()

        def propose(self, history, k):
            if np.array_equal(history[:len(victim)], victim):
                raise RuntimeError("draft source failed")
            return self.inner.propose(history, k)

    def run(draft):
        eng = ContinuousBatcher(tmodel, max_batch=3, max_seq=64, page_size=8,
                                prefix_caching=False, spec_decode=True,
                                spec_k=3, draft=draft)
        return _serve(eng, prompts, news), eng

    ref, _ = run(None)
    got, eng = run(Raising())
    assert got[1].status == "error" and "draft source failed" in got[1].error
    assert eng.stats["request_errors"] == 1
    for i in (0, 2):
        assert got[i].status == "ok"
        assert got[i].tokens == ref[i].tokens, f"neighbour {i} drifted"


def test_custom_draft_proposer_slots_in(pair):
    """A proposer that drafts the true continuation (from the spec-off
    run) gets every draft accepted; one that drafts a constant token gets
    almost none; both keep the tokens of the spec-off engine."""
    _, tmodel, _, _ = pair
    prompts = _rep_prompts(np.random.default_rng(21))
    news = [8, 6]
    off = _serve(_engine(tmodel, False), prompts, news)
    truth = {tuple(p): r.tokens for p, r in zip(prompts, off)}

    class Oracle(DraftProposer):
        def propose(self, history, k):
            for p, toks in truth.items():
                if tuple(history[:len(p)]) == p:
                    done = len(history) - len(p)
                    return np.asarray(toks[done:done + k], np.int32)
            return np.zeros((0,), np.int32)

    class Constant(DraftProposer):
        def propose(self, history, k):
            return np.full((k,), 7, np.int32)

    for draft in (Oracle(), Constant()):
        eng = _engine(tmodel, True, draft=draft, spec_k=3)
        got = _serve(eng, prompts, news)
        assert [r.tokens for r in got] == [r.tokens for r in off]
        assert eng.stats["draft_tokens_proposed"] > 0
        if isinstance(draft, Oracle):
            assert (eng.stats["draft_tokens_accepted"]
                    == eng.stats["draft_tokens_proposed"])
            assert eng.stats["tokens_per_target_step"] > 2.0


def test_per_request_draft_counters_sum_to_the_stats(pair):
    _, tmodel, _, _ = pair
    prompts = _rep_prompts(np.random.default_rng(17), reps=4)
    eng = _engine(tmodel, True, spec_k=4)
    results = _serve(eng, prompts, [14, 8])
    assert sum(r.draft_proposed for r in results) == \
        eng.stats["draft_tokens_proposed"]
    assert sum(r.draft_accepted for r in results) == \
        eng.stats["draft_tokens_accepted"]
    for r in results:
        assert 0 <= r.draft_accepted <= r.draft_proposed
    assert results[0].draft_accepted > 0
    assert eng.stats["acceptance_rate"] == pytest.approx(
        eng.stats["draft_tokens_accepted"]
        / eng.stats["draft_tokens_proposed"])


def test_spec_k_cap_zero_is_the_plain_decode_row(pair):
    """``_spec_k_cap = 0`` verifies one row a slot (no drafts): the tokens
    of the spec-off engine, one token per target step."""
    _, tmodel, _, _ = pair
    prompts = _rep_prompts(np.random.default_rng(12))
    off = _serve(_engine(tmodel, False), prompts, [6, 5])
    eng = _engine(tmodel, True)
    eng._spec_k_cap = 0
    got = _serve(eng, prompts, [6, 5])
    assert [r.tokens for r in got] == [r.tokens for r in off]
    assert eng.stats["draft_tokens_proposed"] == 0
    assert eng.stats["tokens_per_target_step"] == 1.0


# ---------------------------------------------------- the constructor


@pytest.mark.parametrize("kw,err,match", [
    (dict(ragged=False, spec_decode=True), ValueError, "ragged"),
    (dict(temperature=0.7, spec_decode=True), ValueError, "greedy"),
    (dict(spec_decode=True, spec_k=0), ValueError, "spec_k"),
    (dict(spec_decode=True, lora=True), ValueError, "lora"),
])
def test_constructor_errors(pair, kw, err, match):
    _, tmodel, _, _ = pair
    with pytest.raises(err, match=match):
        ContinuousBatcher(tmodel, max_batch=2, max_seq=32,
                          prefix_caching=False, **kw)


def test_flag_default_arms_spec_where_legal(pair):
    """The ``spec_decode`` flag arms a ragged greedy batcher (the stats
    gain the spec keys, ``spec_k`` from its flag) and serves; spec-off
    engines have no spec keys."""
    _, tmodel, _, _ = pair
    old = {k: tflags.get_flag(k) for k in ("spec_decode", "spec_k")}
    tflags.set_flags({"spec_decode": True, "spec_k": 2})
    try:
        armed = ContinuousBatcher(tmodel, max_batch=2, max_seq=32,
                                  prefix_caching=False)
    finally:
        tflags.set_flags(old)
    assert armed._spec and armed._spec_k == 2
    p = np.random.default_rng(13).integers(0, 128, size=5).astype(np.int32)
    rid = armed.submit(p, 4)
    assert len(armed.run()[rid].tokens) == 4
    assert "spec_steps" in armed.stats
    plain = ContinuousBatcher(tmodel, max_batch=2, max_seq=32,
                              prefix_caching=False)
    assert not plain._spec and "spec_steps" not in plain.stats
