"""The serving fault sites' chaos cases: the port against the JAX package.

Restates the chaos cases of ``tests/test_prefix_cache.py`` (prefix.match,
prefix.evict), ``tests/test_kv_tiering.py`` (prefix.prefetch,
prefix.offload, engine.park), ``tests/test_unified_arena.py`` (arena.steal,
arena.demote), ``tests/test_multi_lora.py`` (adapter.load, adapter.evict),
``tests/test_ragged_batching.py`` (engine.admit_chunk, ragged.dispatch, a
poison prompt mid chunked prefill), ``tests/test_spec_decode.py``
(engine.draft, engine.dispatch on the spec wave) and
``tests/test_moe_dropless.py`` (moe.dispatch; its expert-parallel case
waits for the port's ep route). Each case runs the same submissions and
the same armed site on a JAX engine and on the port's: the statuses, the
surviving tokens and the fault counters are equal, and a fault that
propagates does so as a FaultError out of both.

The reference's ``test_chaos_ragged_dispatch_fault_propagates_cleanly``
plants ``ragged.dispatch`` at trace time, so it fires only in a process
that has not traced the ragged step yet; the port's site sits in its
ragged attention seam (``ops/kernels/fusion.ragged_attend``) and fires at
every call, so its case here is deterministic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.models.lora import make_lora_adapter as jax_adapter
from paddle_tpu.reliability import faults as jfaults

from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models.lora import make_lora_adapter
from paddle_tpu_torch.reliability import faults as tfaults

from torch_batcher_pairs import build_pair
from torch_fleet_pairs import clear_faults


@pytest.fixture(autouse=True)
def _clean_registry():
    clear_faults()
    yield
    clear_faults()


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _sides(pair):
    """(name, engine class, model, registry) of each package."""
    return (("jax", JaxBatcher, pair[0], jfaults),
            ("port", ContinuousBatcher, pair[1], tfaults))


def _both(pair, drive):
    """``drive(cls, model, reg)`` on each package; returns {name: result}."""
    out = {}
    for name, cls, m, reg in _sides(pair):
        reg.clear()
        try:
            out[name] = drive(cls, m, reg)
        finally:
            reg.clear()
    return out


def _toks(done, rids):
    return [(done[r].status, done[r].tokens) for r in rids]


# ------------------------------------------------------------ prefix cache


@pytest.mark.chaos
def test_chaos_prefix_match_fault_fails_one_request_alone(pair):
    rng = np.random.default_rng(6)
    ps = [rng.integers(0, 128, size=10).astype(np.int32) for _ in range(3)]

    def drive(cls, m, reg):
        kw = dict(max_batch=3, max_seq=32, segment=4, page_size=8)
        ref = cls(m, **kw)
        for p in ps:
            ref.submit(p, 6)
        ref_done = ref.run()
        eng = cls(m, **kw)
        rids = [eng.submit(p, 6) for p in ps]
        reg.inject("prefix.match", nth=2)       # the second admission
        done = eng.run()
        return (_toks(done, rids), eng.stats["request_errors"],
                [ref_done[r].tokens for r in sorted(ref_done)])

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    got, errors, ref = out["port"]
    assert got[1] == ("error", []) and errors == 1
    assert [got[0], got[2]] == [("ok", ref[0]), ("ok", ref[2])]


@pytest.mark.chaos
def test_chaos_prefix_evict_fault_propagates_cleanly(pair):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 128, size=24).astype(np.int32) for _ in range(4)]

    def drive(cls, m, reg):
        kw = dict(max_batch=2, max_seq=32, segment=2, page_size=8,
                  prefix_pages=0)
        eng = cls(m, **kw)
        for p in ps:
            eng.submit(p, 6)
        before = reg.fired("prefix.evict")
        with reg.injected("prefix.evict"):
            with pytest.raises(reg.FaultError):
                eng.run()
        fired = reg.fired("prefix.evict") - before
        eng2 = cls(m, **kw)
        rids = [eng2.submit(p, 6) for p in ps]
        done = eng2.run()
        return fired, _toks(done, rids)

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1
    assert all(s == "ok" for s, _ in out["port"][1])


# --------------------------------------------------------- tiered KV memory


def _tiered(cls, m, rng, **ekw):
    """A, thrash, A+divergence through an under-provisioned pool: the
    divergent request's shared prefix is served from the host tier."""
    A = rng.integers(0, 128, size=24).astype(np.int32)
    thrash = rng.integers(0, 128, size=24).astype(np.int32)
    Adiv = np.concatenate([A, rng.integers(0, 128, size=2).astype(
        np.int32)])
    eng = cls(m, max_batch=1, max_seq=32, segment=2, page_size=8,
              page_pool_pages=6, **ekw)
    r = [eng.submit(A, 6), eng.submit(thrash, 6, arrival_segment=8),
         eng.submit(Adiv, 6, arrival_segment=16)]
    return eng, r, eng.run()


@pytest.mark.chaos
def test_chaos_prefetch_fault_cold_recompute_alone(pair):
    def drive(cls, m, reg):
        ref, rr, ref_done = _tiered(cls, m, np.random.default_rng(15))
        reg.inject("prefix.prefetch", nth=1)
        eng, r, done = _tiered(cls, m, np.random.default_rng(15))
        eng._host_pager.check()
        return (ref.stats["host_tier_hits"] >= 1,
                eng.stats["prefetch_faults"], _toks(done, r),
                [ref_done[x].tokens for x in rr],
                eng.stats["prefill_tokens_admitted"]
                > ref.stats["prefill_tokens_admitted"])

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    hits, n_faults, got, ref, recomputed = out["port"]
    assert hits and n_faults == 1 and recomputed
    assert got == [("ok", t) for t in ref]


@pytest.mark.chaos
def test_chaos_offload_fault_degrades_to_discard(pair):
    def drive(cls, m, reg):
        reg.inject("prefix.offload", nth=1)
        eng, r, done = _tiered(cls, m, np.random.default_rng(16))
        eng._pager.check()
        eng._host_pager.check()
        return eng._prefix.stats["offload_faults"], _toks(done, r)

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1
    assert all(s == "ok" for s, _ in out["port"][1])


@pytest.mark.chaos
def test_chaos_park_fault_stream_keeps_decoding(pair):
    rng = np.random.default_rng(17)
    p = rng.integers(0, 128, size=16).astype(np.int32)

    def drive(cls, m, reg):
        eng = cls(m, max_batch=1, max_seq=32, segment=2, page_size=8)
        rid = eng.submit(p, 8)
        fired = {"done": False}

        def hook(t):
            if not fired["done"]:
                eng.park(rid)
                fired["done"] = True

        eng._on_tick = hook
        reg.inject("engine.park", nth=1)
        done = eng.run()
        return eng.stats["park_faults"], eng.parked, _toks(done, [rid])

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (1, [])
    assert out["port"][2][0][0] == "ok"


# ------------------------------------------------ unified arena, multi-LoRA


def _adapters(name, cfg):
    mk = jax_adapter if name == "jax" else make_lora_adapter
    return {"A": mk(cfg, rank=4, seed=1), "B": mk(cfg, rank=2, seed=2)}


def _lora_engine(cls, m, adapters, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("segment", 4)
    kw.setdefault("lora_max_rank", 4)
    kw.setdefault("lora_hbm_adapters", 2)
    eng = cls(m, lora=True, **kw)
    for aid, w in adapters.items():
        eng.register_adapter(aid, w)
    return eng


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["arena.steal", "arena.demote"])
def test_chaos_faulted_steal_fails_only_acquirer(pair, site):
    rng = np.random.default_rng(23)
    base_ps = [rng.integers(0, 128, size=24).astype(np.int32)
               for _ in range(3)]
    tenant_p = rng.integers(0, 128, size=9).astype(np.int32)

    def drive(cls, m, reg):
        ad = _adapters("jax" if cls is JaxBatcher else "port", m.config)

        def mk():
            return _lora_engine(cls, m, ad, max_batch=1, max_seq=32,
                                segment=2, lora_hbm_adapters=1,
                                unified_arena=True, arena_hbm_pages=12)

        def submit(eng):
            rids = [eng.submit(p, 4, arrival_segment=8 * i)
                    for i, p in enumerate(base_ps)]
            return rids, eng.submit(tenant_p, 4, adapter_id="B",
                                    arrival_segment=24)

        ref = mk()
        ref_rids, ref_t = submit(ref)
        ref_done = ref.run()
        eng = mk()
        reg.inject(site, nth=1)
        rids, rt = submit(eng)
        done = eng.run()
        reg.clear()
        rt2 = eng.submit(tenant_p, 4, adapter_id="B")
        redo = eng.run()
        return (ref.stats["arena_steals"].get("kv->adapter", 0) >= 1,
                done[rt].status, "FaultError" in (done[rt].error or ""),
                eng.stats["request_errors"],
                _toks(done, rids) == _toks(ref_done, ref_rids),
                redo[rt2].status,
                redo[rt2].output_ids == ref_done[ref_t].output_ids,
                _toks(done, rids))

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][:7] == (True, "error", True, 1, True, "ok", True)


@pytest.mark.chaos
def test_chaos_adapter_load_fails_only_requesting_stream(pair):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 128, size=s).astype(np.int32) for s in (9, 7, 5)]

    def drive(cls, m, reg):
        ad = _adapters("jax" if cls is JaxBatcher else "port", m.config)

        def solo(p, aid, n):
            e = _lora_engine(cls, m, ad)
            rid = e.submit(p, n, adapter_id=aid)
            return e.run()[rid].tokens

        eng = _lora_engine(cls, m, ad)
        eng.submit(ps[1], 2, adapter_id="A")       # A resident
        eng.run()
        reg.inject("adapter.load", nth=1)          # the next load: B's
        r0 = eng.submit(ps[0], 6)
        r1 = eng.submit(ps[1], 6, adapter_id="A")
        r2 = eng.submit(ps[2], 6, adapter_id="B")
        done = eng.run()
        reg.clear()
        r3 = eng.submit(ps[2], 6, adapter_id="B")
        redo = eng.run()
        return (done[r2].status, "FaultError" in (done[r2].error or ""),
                eng.stats["request_errors"],
                _toks(done, [r0, r1]) == [("ok", solo(ps[0], None, 6)),
                                          ("ok", solo(ps[1], "A", 6))],
                redo[r3].tokens == solo(ps[2], "B", 6),
                _toks(done, [r0, r1]), redo[r3].tokens)

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][:5] == ("error", True, 1, True, True)


@pytest.mark.chaos
def test_chaos_adapter_evict_fails_only_requesting_stream(pair):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 128, size=s).astype(np.int32) for s in (9, 7, 5)]

    def drive(cls, m, reg):
        ad = _adapters("jax" if cls is JaxBatcher else "port", m.config)
        kw = dict(lora_hbm_adapters=1, unified_arena=False)
        eng = _lora_engine(cls, m, ad, **kw)
        eng.submit(ps[0], 4, adapter_id="A")
        eng.run()                                   # A resident, idle
        reg.inject("adapter.evict", nth=1)
        rb = eng.submit(ps[1], 4, adapter_id="B")
        done = eng.run()
        reg.clear()
        resident = list(eng._adapters.resident)
        rb2 = eng.submit(ps[1], 4, adapter_id="B")
        again = eng.run()
        solo = _lora_engine(cls, m, ad, **kw)
        rs = solo.submit(ps[1], 4, adapter_id="B")
        return (done[rb].status, resident,
                again[rb2].tokens == solo.run()[rs].tokens,
                again[rb2].tokens)

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    assert out["port"][:3] == ("error", ["A"], True)


# ---------------------------------------------------------- ragged batching


@pytest.mark.chaos
def test_chaos_admit_chunk_fault_fails_one_request_alone(pair):
    rng = np.random.default_rng(9)
    ps = [rng.integers(0, 128, size=6).astype(np.int32) for _ in range(3)]

    def drive(cls, m, reg):
        kw = dict(max_batch=3, max_seq=32, segment=4)
        ref = cls(m, **kw)
        ref_rids = [ref.submit(p, 6) for p in ps]
        ref_done = ref.run()
        eng = cls(m, **kw)
        rids = [eng.submit(p, 6) for p in ps]
        bad = rids[1]
        reg.inject("engine.admit_chunk", when=lambda ctx: ctx["rid"] == bad)
        done = eng.run()
        return (_toks(done, rids), eng.stats["request_errors"],
                done[bad].error is not None,
                [ref_done[r].tokens for r in ref_rids])

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    got, errors, has_error, ref = out["port"]
    assert got[1] == ("error", []) and errors == 1 and has_error
    assert [got[0], got[2]] == [("ok", ref[0]), ("ok", ref[2])]


@pytest.mark.chaos
@pytest.mark.parametrize("plan", ["norm_matmul,rope_append_attend",
                                  "norm_matmul"])
def test_chaos_ragged_dispatch_fault_propagates_cleanly(pair, plan):
    """ragged.dispatch fires at the port's ragged attention seam under both
    attention plans: a clean FaultError out of run(), the site fired once,
    and a fresh engine serves the reference's tokens."""
    from paddle_tpu_torch.framework import flags as tflags

    rng = np.random.default_rng(10)
    p0 = rng.integers(0, 128, size=5).astype(np.int32)
    p = rng.integers(0, 128, size=5).astype(np.int32)
    old = tflags.get_flag("fused_decode_fusions")
    tflags.set_flags({"fused_decode_fusions": plan})
    try:
        eng = ContinuousBatcher(pair[1], max_batch=1, max_seq=32, segment=2)
        eng.submit(p0, 4)
        before = tfaults.fired("ragged.dispatch")
        with tfaults.injected("ragged.dispatch"):
            with pytest.raises(tfaults.FaultError):
                eng.run()
        assert tfaults.fired("ragged.dispatch") == before + 1
        eng2 = ContinuousBatcher(pair[1], max_batch=1, max_seq=32,
                                 segment=2)
        rid = eng2.submit(p, 4)
        got = eng2.run()[rid].output_ids
    finally:
        tflags.set_flags({"fused_decode_fusions": old})
    ref = JaxBatcher(pair[0], max_batch=1, max_seq=32, segment=2)
    jrid = ref.submit(p, 4)
    assert got == ref.run()[jrid].output_ids


@pytest.mark.chaos
def test_chaos_poison_prompt_quarantined_during_chunked_prefill(pair):
    rng = np.random.default_rng(11)
    poison_tok = 77
    clean = rng.integers(0, 128, size=6).astype(np.int32)
    clean[clean == poison_tok] = 5
    bad = rng.integers(0, 128, size=20).astype(np.int32)
    bad[bad == poison_tok] = 5
    bad[17] = poison_tok                    # lands in the LAST chunk

    def drive(cls, m, reg):
        kw = dict(max_batch=2, max_seq=48, segment=4, prefill_chunk=6)
        ref = cls(m, **kw)
        ref_rid = ref.submit(clean, 8)
        ref_done = ref.run()
        eng = cls(m, **kw)
        w = eng.params["model.embed_tokens.weight"]
        eng.params = dict(eng.params)
        if isinstance(w, torch.Tensor):
            w = w.clone()
            w[poison_tok] = float("nan")
        else:
            w = w.at[poison_tok].set(np.nan)
        eng.params["model.embed_tokens.weight"] = w
        r_clean = eng.submit(clean, 8)
        r_bad = eng.submit(bad, 8)
        done = eng.run()
        return (_toks(done, [r_bad, r_clean]), eng.stats["poisoned"],
                ref_done[ref_rid].tokens)

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    got, poisoned, ref = out["port"]
    assert got == [("poisoned", []), ("ok", ref)] and poisoned == 1


# ------------------------------------------------------ speculative decoding


@pytest.mark.chaos
def test_chaos_draft_fault_fails_one_request_neighbors_exact(pair):
    rng = np.random.default_rng(18)
    base = rng.integers(0, 128, size=4).astype(np.int32)
    ps = [np.tile(base, 3), rng.integers(0, 128, size=7).astype(np.int32),
          np.tile(base[::-1].copy(), 3)]
    news = [8, 6, 8]

    def drive(cls, m, reg):
        def run(inject):
            eng = cls(m, max_batch=3, max_seq=64, page_size=8, ragged=True,
                      spec_decode=True, spec_k=3)
            rids = [eng.submit(p, n) for p, n in zip(ps, news)]
            if inject:
                reg.inject("engine.draft",
                           when=lambda ctx: ctx["rid"] == rids[1])
            try:
                return rids, eng.run(), eng
            finally:
                reg.clear()

        ref_rids, ref_done, _ = run(False)
        rids, done, eng = run(True)
        return (_toks(done, rids), eng.stats["request_errors"],
                _toks(ref_done, ref_rids))

    out = _both(pair, drive)
    assert out["port"] == out["jax"]
    got, errors, ref = out["port"]
    assert got[1][0] == "error" and errors == 1
    assert [got[0], got[2]] == [ref[0], ref[2]]


@pytest.mark.chaos
def test_chaos_spec_dispatch_fault_is_clean(pair):
    rng = np.random.default_rng(19)
    p = rng.integers(0, 128, size=5).astype(np.int32)

    def drive(cls, m, reg):
        eng = cls(m, max_batch=2, max_seq=32, ragged=True, spec_decode=True)
        eng.submit(p, 4)
        seen = []
        reg.inject("engine.dispatch",
                   when=lambda ctx: seen.append(dict(ctx)) or ctx.get("spec"))
        with pytest.raises(reg.FaultError):
            eng.run()
        return sorted(seen[-1])

    out = _both(pair, drive)
    assert out["port"] == out["jax"] == ["spec", "tick", "tokens"]


# -------------------------------------------------------------------- MoE


@pytest.mark.chaos
@pytest.mark.parametrize("dropless", [True, False])
def test_chaos_moe_dispatch_fails_cleanly(dropless):
    import paddle_tpu as paddle
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu.models import moe as jmoe

    from paddle_tpu_torch.framework import flags as tflags
    from paddle_tpu_torch.models import moe as tmoe
    from paddle_tpu_torch.models.bridge import load_numpy_params

    cfg = dict(num_experts=4, top_k=2, capacity_factor=8.0,
               hidden_size=64, intermediate_size=128)
    paddle.seed(0)
    jm = jmoe.MoEForCausalLM(jmoe.MoEConfig.tiny(**cfg))
    tm = tmoe.MoEForCausalLM(tmoe.MoEConfig.tiny(**cfg), device="cpu")
    load_numpy_params(tm, {n: np.asarray(p._array)
                           for n, p in jm.named_parameters()})
    ids = np.random.default_rng(0).integers(
        0, jm.config.vocab_size, size=(2, 16))
    olds = (jflags.get_flag("moe_dropless"), tflags.get_flag("moe_dropless"))
    jflags.set_flags({"moe_dropless": dropless})
    tflags.set_flags({"moe_dropless": dropless})
    try:
        out = {}
        for name, reg, call in (
                ("jax", jfaults, lambda: jm(paddle.to_tensor(
                    ids.astype(np.int32), dtype="int64"))),
                ("port", tfaults, lambda: tm(torch.as_tensor(ids)))):
            before = reg.fired("moe.dispatch")
            with reg.injected("moe.dispatch"):
                with pytest.raises(reg.FaultError):
                    call()
            logits, _ = call()                      # recovered
            arr = (logits.numpy() if hasattr(logits, "numpy")
                   else np.asarray(logits._array))
            out[name] = (reg.fired("moe.dispatch") - before,
                         bool(np.isfinite(np.asarray(arr)).all()),
                         np.asarray(arr, np.float32))
    finally:
        jflags.set_flags({"moe_dropless": olds[0]})
        tflags.set_flags({"moe_dropless": olds[1]})
    assert out["port"][:2] == out["jax"][:2] == (1, True)
    np.testing.assert_allclose(out["port"][2], out["jax"][2], rtol=1e-4,
                               atol=1e-4)
