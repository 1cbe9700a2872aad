"""The continuous-batching server: the PyTorch port vs the JAX package, on CPU.

A JAX ``LlamaForCausalLM`` is built from ``paddle.seed(0)``; its
parameters go through numpy into the port (``models/bridge.py``). For the
same submissions, the port's ``ContinuousBatcher`` and the JAX package's,
both with default flags (prefix caching, host tier and arena on), give
identical per-request greedy tokens (f32 on the CPU, where the two sides
differ only in summation order; on these seeds no near-tie flips a
token), which also equal the port's solo
``generate_paged``; and the ragged-path ``stats`` agree. Each case
runs the port in the default fused plan and with
``fused_decode_fusions="norm_matmul"`` (on the CPU both reach the plain
chains, so their tokens are identical). Configs: the tiny one and the
head_dim-128 one of tests/test_torch_llama_serving.py. The int8 case
serves ``quantized_params`` with ``cache_dtype="int8"`` on both sides
(port-int8 vs reference-int8). chip_smoke.py's yardstick for the int8
batcher on the card (``chunk_map`` of each request's ``chunk_starts``,
then ``int8_batcher_attention``) reproduces the port's int8 batcher's
logits here, where the batcher runs the same plain ops.
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
from paddle_tpu_torch.inference import (Backpressure, ContinuousBatcher,
                                        GenRequest)
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            quantized_params_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

CONFIGS = {
    "tiny": {},
    "head_dim_128": dict(vocab_size=128, hidden_size=256,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1,
                         max_position_embeddings=64, rope_theta=10000.0),
}
STATS = ("ragged_steps", "segments", "prefills", "prefill_tokens_admitted",
         "token_budget_util", "host_sync_count", "wasted_slot_steps",
         "decode_steps", "tokens_emitted", "bucket_pad_tokens")


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
    return request.param, jmodel, tmodel


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


# name -> (engine kwargs, prompt lengths, max_new, arrival segments, seed)
CASES = {
    "more_requests_than_slots": (
        dict(max_batch=2, max_seq=32, segment=2), (6,) * 5, (5,) * 5,
        (0,) * 5, 2),
    "staggered_arrivals": (
        dict(max_batch=3, max_seq=48, segment=4), (7, 4, 11, 5),
        (9, 6, 5, 8), (0, 1, 3, 6), 3),
    "multi_chunk_prefill": (
        dict(max_batch=2, max_seq=64, segment=4, prefill_chunk=8), (29,),
        (8,), (0,), 1),
    "decode_through_neighbor_prefill": (
        dict(max_batch=2, max_seq=64, segment=2, prefill_chunk=6), (5, 24),
        (20, 6), (0, 2), 2),
    "eos_mid_segment": (
        dict(max_batch=2, max_seq=48, segment=16), (8, 6), (8, 7), (0, 0),
        4),
}


def _serve(engine, prompts, news, arrivals):
    rids = [engine.submit(p, n, arrival_segment=a)
            for p, n, a in zip(prompts, news, arrivals)]
    done = engine.run()
    assert sorted(done) == sorted(rids)
    return [done[r] for r in rids]


def _port_runs(tmodel, kw, prompts, news, arrivals):
    """The port's engine in the default fused plan and with only
    norm_matmul fused: (finished requests, stats) of each."""
    runs = {}
    old = tflags.get_flag("fused_decode_fusions")
    for plan in ("norm_matmul,rope_append_attend", "norm_matmul"):
        tflags.set_flags({"fused_decode_fusions": plan})
        try:
            eng = ContinuousBatcher(tmodel, **kw)
            runs[plan] = (_serve(eng, prompts, news, arrivals), eng.stats)
        finally:
            tflags.set_flags({"fused_decode_fusions": old})
    return runs


def _eos(jmodel, prompt, n):
    """EOS = the third generated token of the reference's solo rollout, so
    the rollout stops mid-segment."""
    out = jmodel.generate_paged(paddle.to_tensor(prompt[None]),
                                max_new_tokens=n)
    return int(np.asarray(out._array)[0, len(prompt) + 2])


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_and_stats_match_jax_and_solo(pair, case):
    name, jmodel, tmodel = pair
    kw, lens, news, arrivals, seed = CASES[case]
    kw = dict(kw)
    prompts = _prompts(tmodel.config.vocab_size, lens, seed)
    if case == "eos_mid_segment":
        kw["eos_token_id"] = _eos(jmodel, prompts[0], news[0])
    jeng = JaxBatcher(jmodel, **kw)
    want = _serve(jeng, prompts, news, arrivals)
    for plan, (got, stats) in _port_runs(tmodel, kw, prompts, news,
                                         arrivals).items():
        for g, w, p, n in zip(got, want, prompts, news):
            assert g.status == w.status == "ok"
            assert g.output_ids == w.output_ids, (name, case, plan, g.rid)
            if kw.get("eos_token_id") is None:
                solo = tmodel.generate_paged(p[None], max_new_tokens=n)
                assert g.output_ids == solo[0].tolist(), (name, case, plan)
                assert len(g.tokens) == n
        for key in STATS:
            assert stats[key] == jeng.stats[key], (name, case, plan, key)
        assert stats["wasted_slot_steps"] == 0
        assert stats["bucket_pad_tokens"] == 0
    if case == "eos_mid_segment":
        eos = kw["eos_token_id"]
        assert got[0].tokens[-1] == eos and len(got[0].tokens) == 3


def test_int8_engine_matches_jax_int8_engine(pair):
    """int8 weights + int8 KV through token-budget scheduling: the port's
    engine reproduces the JAX package's int8 engine and its own int8 solo
    rollout token for token (fused and unfused plans). The weights are
    quantized by the JAX package and bridged."""
    name, jmodel, tmodel = pair
    jq = jax_quantize({n: p._array for n, p in jmodel.named_parameters()})
    tq = quantized_params_from_numpy(tmodel, jq)
    kw = dict(max_batch=2, max_seq=48, segment=3, cache_dtype="int8")
    prompts = _prompts(tmodel.config.vocab_size, (5, 9, 13), 4)
    news, arrivals = (6, 9, 4), (0, 0, 0)
    jeng = JaxBatcher(jmodel, quantized_params=jq, **kw)
    want = _serve(jeng, prompts, news, arrivals)
    runs = _port_runs(tmodel, dict(kw, quantized_params=tq), prompts, news,
                      arrivals)
    for plan, (got, stats) in runs.items():
        for g, w, p, n in zip(got, want, prompts, news):
            assert g.output_ids == w.output_ids, (name, plan, g.rid)
            solo = tmodel.generate_paged(p[None], max_new_tokens=n,
                                         params=tq, cache_dtype="int8")
            assert g.output_ids == solo[0].tolist(), (name, plan)
        for key in STATS:
            assert stats[key] == jeng.stats[key], (name, plan, key)


class _Capture:
    """Every LM-head call of a port engine's run, with the emission masks
    and slot admissions that give each logits row its request: patched
    over ``continuous_batching``'s ``_pure_lm_head_logits``, ``_Record``
    and the ragged step."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.inference import continuous_batching as cb

        self.log = []
        real_head, real_record = cb._pure_lm_head_logits, cb._Record
        real_build = cb.ContinuousBatcher._build_ragged_step
        log = self.log

        def head(*a, **kw):
            out = real_head(*a, **kw)
            log.append(("logits", out.detach().clone()))
            return out

        class Record(real_record):
            def __init__(self, *tensors):
                super().__init__(*tensors)
                emitted = tensors[1]
                log.append(("emitted", emitted.reshape(-1, emitted.shape[-1])
                            .clone()))

        def build(engine):
            rstep = real_build(engine)

            def wrapped(*a):
                log.append(("new_slot", a[9].clone()))
                return rstep(*a)

            return wrapped

        monkeypatch.setattr(cb, "_pure_lm_head_logits", head)
        monkeypatch.setattr(cb, "_Record", Record)
        monkeypatch.setattr(cb.ContinuousBatcher, "_build_ragged_step",
                            build)

    def logits_by_request(self, rids, slots):
        """{rid: (emitted tokens' logits rows, in order)}: requests enter
        the slots in ``rids`` order (first come, first placed)."""
        occupant, pending, order = [None] * slots, [], iter(rids)
        out = {r: [] for r in rids}
        for kind, x in self.log:
            if kind == "new_slot":
                for b in range(slots):
                    if bool(x[b]):
                        occupant[b] = next(order)
            elif kind == "logits":
                pending.append(x)
            else:
                assert len(pending) == x.shape[0]
                for lg, em in zip(pending, x):
                    for b in range(slots):
                        if bool(em[b]):
                            out[occupant[b]].append(lg[b])
                pending = []
        return {r: torch.stack(v) for r, v in out.items()}


def test_chip_smoke_int8_batcher_reference_reproduces_the_batcher(
        pair, monkeypatch):
    """chip_smoke.py holds the card's int8w+int8kv batcher to a
    teacher-forced plain forward of the quantized function whose attention
    reads each key through the int8 cache (quantize->dequantize) or fresh,
    as the batcher did: ``chunk_map`` over the request's own
    ``chunk_starts`` (the batcher's admission record), then
    ``int8_batcher_attention``. On the CPU, where the batcher runs those
    same plain ops, that forward reproduces the logits of every emitted
    token (f32, summation order only: 1e-4), in both plans, on chunks the
    shared token budget cuts unevenly; the solo-prefill map (every prompt
    row fresh) misses them."""
    import chip_smoke
    from paddle_tpu_torch.models.llama import (prompt_logits_pure,
                                               quantize_for_inference)
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    _, _, tmodel = pair
    qp = quantize_for_inference(tmodel)
    kw = dict(max_batch=2, max_seq=48, segment=3, prefill_chunk=5,
              cache_dtype="int8", quantized_params=qp)
    prompts = _prompts(tmodel.config.vocab_size, (13, 9, 11, 4), 5)
    news, arrivals = (6, 5, 4, 7), (0, 0, 1, 1)
    plain = tfa._reference_attention
    old = tflags.get_flag("fused_decode_fusions")
    for plan in ("norm_matmul,rope_append_attend", "norm_matmul"):
        cap = _Capture(monkeypatch)
        tflags.set_flags({"fused_decode_fusions": plan})
        try:
            eng = ContinuousBatcher(tmodel, **kw)
            got = _serve(eng, prompts, news, arrivals)
        finally:
            tflags.set_flags({"fused_decode_fusions": old})
        served = cap.logits_by_request([g.rid for g in got], 2)
        uneven = 0
        for g, prompt in zip(got, prompts):
            n0, seq = len(prompt), torch.tensor([g.output_ids[:-1]])
            starts = g.chunk_starts
            sizes = np.diff(starts + [n0])
            assert starts[0] == 0 and (sizes > 0).all() and (sizes <= 5).all()
            uneven += int((sizes[:-1] < 5).any())
            want = served[g.rid]
            assert want.shape[0] == len(g.tokens)
            assert want.argmax(-1).tolist() == g.tokens
            diffs = []
            for chunks in (starts, [0]):
                monkeypatch.setattr(
                    tfa, "_reference_attention",
                    chip_smoke.int8_batcher_attention(
                        plain, chip_smoke.chunk_map(n0, chunks,
                                                    seq.shape[1])))
                ref = prompt_logits_pure(qp, seq, tmodel.config,
                                         plain=True)[0, n0 - 1:]
                diffs.append(float((ref - want).abs().max()))
            monkeypatch.setattr(tfa, "_reference_attention", plain)
            assert diffs[0] <= 1e-4 + 1e-4 * float(want.abs().max()), (
                plan, g.rid, diffs)
            if len(starts) > 1:
                assert diffs[1] > 1e-3, (plan, g.rid, diffs)
        assert uneven, "no chunk was cut short by the shared budget"


# ------------------------------------------------ contract of the engine


@pytest.fixture(scope="module")
def tiny():
    # the port's init draws from its own seeded generator; the global
    # seed is pinned too, as every model-building fixture here does
    paddle.seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)


@pytest.mark.parametrize("kw,err", [
    (dict(lora_hbm_adapters=2), None),
    (dict(ragged=False), NotImplementedError),
    (dict(lora=True), None),
    (dict(temperature=0.7), None),
    (dict(retry_policy=object()), None),
    (dict(adapter_pool=object()), ValueError),
    (dict(prefix_caching=False, host_tier=True), ValueError),
    (dict(prefix_caching=False, unified_arena=True), ValueError),
    (dict(prefill_chunk=0), ValueError),
    (dict(cache_dtype="fp8"), ValueError),
])
def test_unported_features_raise(tiny, kw, err):
    """What the port still refuses raises NotImplementedError, an illegal
    configuration ValueError; ``err`` None: the reference builds this
    engine, and so does the port (sampling, multi-LoRA)."""
    if err is None:
        eng = ContinuousBatcher(tiny, max_batch=2, max_seq=32, **kw)
        assert eng._lora == bool(kw.get("lora"))
        assert (eng.sampling is None) == ("temperature" not in kw)
        return
    with pytest.raises(err):
        ContinuousBatcher(tiny, max_batch=2, max_seq=32, **kw)


def test_defaults_build_the_reference_features(tiny):
    """With default flags the batcher resolves prefix caching, the host
    tier and the unified arena on, as the JAX package's does."""
    eng = ContinuousBatcher(tiny, max_batch=2, max_seq=32)
    assert eng._prefix_caching and eng._host_tier
    assert eng._arena is not None and eng._arena_kv_pages == 2 * 2 + 2
    assert "prefix_hits" in eng.stats and "parks" in eng.stats
    assert "arena_steals" in eng.stats


def test_submit_contract_and_drain(tiny):
    eng = ContinuousBatcher(tiny, max_batch=1, max_seq=32, segment=4,
                            max_pending=2)
    assert eng._ragged_T == 40                # 1 + 32, padded to 8
    with pytest.raises(ValueError):
        eng.submit([], 4)
    with pytest.raises(ValueError):
        eng.submit(np.arange(30), 4)          # exceeds the capacity
    p = np.arange(1, 6, dtype=np.int32)
    r0 = eng.submit(torch.tensor(p), 3)
    eng.submit(p, 3)
    with pytest.raises(Backpressure):
        eng.submit(p, 3)
    assert eng.try_submit(p, 3) is None
    assert eng.stats["rejected"] == 2 and eng.pending == 2
    eng.drain()
    assert eng.draining and eng.run() == {} and eng.pending == 2
    eng.reopen()
    done = eng.run()
    assert len(done) == 2 and eng.pending == 0
    assert done[r0].output_ids == tiny.generate_paged(
        p[None], max_new_tokens=3)[0].tolist()
    assert isinstance(done[r0], GenRequest) and done[r0].done


def test_deadline_expired_request_times_out(tiny):
    eng = ContinuousBatcher(tiny, max_batch=1, max_seq=32, segment=2)
    clock = [0.0]
    eng._clock = lambda: clock[0]
    p = np.arange(3, 9, dtype=np.int32)
    late = eng.submit(p, 4, arrival_segment=3, deadline_s=1.0)
    ok = eng.submit(p, 4)
    clock[0] = 5.0                            # `late` expires while queued
    done = eng.run()
    assert done[late].status == "timeout" and done[late].tokens == []
    assert done[ok].status == "ok" and len(done[ok].tokens) == 4
    assert eng.stats["timeouts"] == 1


def test_poisoned_request_is_quarantined_alone(tiny):
    """Non-finite logits in one slot fail that request only; the other
    slot decodes its solo tokens."""
    params = {n: p.clone() for n, p in tiny.param_dict().items()}
    bad_tok = 7
    params["model.embed_tokens.weight"][bad_tok] = float("nan")
    eng = ContinuousBatcher(tiny, max_batch=2, max_seq=32, segment=4,
                            quantized_params=params)
    good = np.arange(10, 16, dtype=np.int32)
    bad = np.array([1, 2, bad_tok, 3], np.int32)
    r_good, r_bad = eng.submit(good, 5), eng.submit(bad, 5)
    done = eng.run()
    assert done[r_bad].status == "poisoned" and done[r_bad].tokens == []
    assert eng.stats["quarantined"] == [r_bad]
    assert done[r_good].output_ids == tiny.generate_paged(
        good[None], max_new_tokens=5)[0].tolist()
