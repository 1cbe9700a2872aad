"""The reliability layer: the port against the JAX package, on the CPU.

Restates the fault-registry, retry and serving cases of
``tests/test_reliability.py`` (its checkpoint cases wait for the port's
checkpoint module): the port's registry triggers exactly as the JAX
package's (nth, seeded probability, predicates, scopes, the
``PADDLE_TPU_FAULTS`` grammar, delay mode), its ``RetryPolicy`` retries,
backs off and counts alike, and its ``ContinuousBatcher`` meets the
reference's serving contract — bounded queue, deadlines, poison isolation,
the readback and dispatch fault sites with and without a retry policy,
drain — with the statuses and tokens of the JAX engine on the same inputs.
``health_snapshot()`` carries every surface of the reference's, key for
key, the fleet and disaggregation records among them.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu.reliability import health as jhealth
from paddle_tpu.reliability import retry as jretry

from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.inference.continuous_batching import Backpressure
from paddle_tpu_torch.reliability import (FaultError, RetryError,
                                          RetryPolicy, faults,
                                          health_snapshot)
from paddle_tpu_torch.reliability import health as thealth
from paddle_tpu_torch.reliability.retry import (reset_retry_counters,
                                                retry_counters)

from torch_batcher_pairs import build_pair
from torch_fleet_pairs import clear_faults, solo, stop, wait


@pytest.fixture(autouse=True)
def _clean_registry():
    clear_faults()
    yield
    clear_faults()


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def jax_ns(pair):
    from types import SimpleNamespace

    return SimpleNamespace(model=pair[0], jq=None)


# ------------------------------------------------------------ fault registry


def test_registry_disabled_by_default():
    assert os.environ.get("PADDLE_TPU_FAULTS", "") == ""
    assert not faults.enabled()
    assert faults.active_sites() == []
    faults.maybe_fail("engine.readback")     # a silent no-op
    assert not faults.should_fire("engine.dispatch")


@pytest.mark.chaos
@pytest.mark.parametrize("reg", [faults, jfaults], ids=["port", "jax"])
def test_nth_call_trigger_is_one_shot(reg):
    reg.inject("a.b", nth=3)
    reg.maybe_fail("a.b")
    reg.maybe_fail("a.b")
    with pytest.raises(reg.FaultError):
        reg.maybe_fail("a.b")
    reg.maybe_fail("a.b")
    assert reg.fired("a.b") == 1


@pytest.mark.chaos
def test_probabilistic_trigger_is_seeded_as_the_reference():
    def fires(reg, seed):
        reg.clear()
        reg.inject("p.site", p=0.5, seed=seed, times=10 ** 9)
        return [reg.should_fire("p.site") for _ in range(64)]

    a = fires(faults, 7)
    assert a == fires(faults, 7) == fires(jfaults, 7)
    assert any(a) and not all(a)
    assert fires(faults, 8) == fires(jfaults, 8) != a


@pytest.mark.chaos
def test_custom_exception_and_predicate():
    faults.inject("ctx.site", exc=OSError, when=lambda c: c.get("rid") == 2,
                  times=None)
    faults.maybe_fail("ctx.site", rid=1)
    with pytest.raises(OSError):
        faults.maybe_fail("ctx.site", rid=2)
    faults.maybe_fail("ctx.site", rid=3)


@pytest.mark.chaos
def test_injected_scope_disarms_on_exit():
    with faults.injected("scoped.site"):
        assert faults.enabled()
        with pytest.raises(FaultError):
            faults.maybe_fail("scoped.site")
    assert not faults.enabled()
    faults.maybe_fail("scoped.site")


@pytest.mark.chaos
def test_env_var_activation_and_grammar():
    spec = "env.site:nth=2;other.site:p=0.25,seed=3,times=5"
    assert faults.load_env(spec) == jfaults.load_env(spec) == 2
    assert set(faults.active_sites()) == {"env.site", "other.site"}
    assert faults.active_sites() == jfaults.active_sites()
    faults.maybe_fail("env.site")
    with pytest.raises(FaultError):
        faults.maybe_fail("env.site")
    for bad in ("x.y:bogus=1", "x.y:nth=0", "x.y:p=2"):
        with pytest.raises(ValueError):
            faults.load_env(bad)
    assert faults._ENV_VAR == jfaults._ENV_VAR == "PADDLE_TPU_FAULTS"


@pytest.mark.chaos
def test_delay_mode_stalls_without_raising():
    faults.inject("slow.site", delay_s=0.05)
    t0 = time.monotonic()
    faults.maybe_fail("slow.site")
    assert time.monotonic() - t0 >= 0.05
    assert faults.fired("slow.site") == 1
    st = faults.stats()
    assert st["site_fired"]["slow.site"] == 1
    assert st["site_calls"]["slow.site"] == 1
    assert set(st) == set(jfaults.stats())


@pytest.mark.chaos
def test_delay_mode_composes_with_triggers():
    faults.inject("slow.nth", delay_s=0.05, nth=2)
    t0 = time.monotonic()
    faults.maybe_fail("slow.nth")
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    faults.maybe_fail("slow.nth")
    assert time.monotonic() - t0 >= 0.05
    faults.maybe_fail("slow.nth")
    assert faults.fired("slow.nth") == 1
    faults.inject("slow.ctx", delay_s=0.05,
                  when=lambda c: c.get("replica") == "r1")
    t0 = time.monotonic()
    faults.maybe_fail("slow.ctx", replica="r0")
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    faults.maybe_fail("slow.ctx", replica="r1")
    assert time.monotonic() - t0 >= 0.05
    assert faults.fired("slow.ctx") == 1


@pytest.mark.chaos
def test_delay_mode_should_fire_sleeps_and_reports_false():
    faults.inject("slow.poll", delay_s=0.05)
    t0 = time.monotonic()
    assert faults.should_fire("slow.poll") is False
    assert time.monotonic() - t0 >= 0.05
    assert faults.fired("slow.poll") == 1


@pytest.mark.chaos
def test_delay_mode_env_grammar_and_validation():
    assert faults.load_env("env.slow:delay_s=0.05,nth=1") == 1
    t0 = time.monotonic()
    faults.maybe_fail("env.slow")
    assert time.monotonic() - t0 >= 0.05
    assert faults.fired("env.slow") == 1
    with pytest.raises(ValueError, match="delay_s"):
        faults.inject("bad.site", delay_s=-1.0)


# ------------------------------------------------------------------- retry


def test_retry_recovers_after_transient_failures():
    reset_retry_counters()
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise OSError("transient")
        return "ok"

    p = RetryPolicy(max_attempts=5, base_delay_s=0.0, jitter=0.0,
                    sleep=lambda s: None, name="t.recover")
    assert p.call(flaky) == "ok"
    assert calls[0] == 3
    c = retry_counters()["t.recover"]
    assert c == {"attempts": 3, "retries": 2, "failures": 2, "gave_up": 0}


def test_retry_exhaustion_raises_retry_error_with_cause():
    p = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                    sleep=lambda s: None, name="t.exhaust")
    with pytest.raises(RetryError) as ei:
        p.call(lambda: (_ for _ in ()).throw(OSError("always")))
    assert isinstance(ei.value.__cause__, OSError)
    assert ei.value.attempts == 3
    assert retry_counters()["t.exhaust"]["gave_up"] == 1


def test_retry_non_retryable_passes_through_immediately():
    calls = [0]

    def poison():
        calls[0] += 1
        raise ValueError("corrupt state")

    p = RetryPolicy(max_attempts=5, base_delay_s=0.0, sleep=lambda s: None,
                    name="t.poison")
    with pytest.raises(ValueError):
        p.call(poison)
    assert calls[0] == 1


def test_retry_backoff_schedule_matches_the_reference():
    kw = dict(max_attempts=6, base_delay_s=0.1, multiplier=2.0,
              max_delay_s=0.4, jitter=0.0)
    want = [jretry.RetryPolicy(**kw).delay_for(k) for k in range(5)]
    assert [RetryPolicy(**kw).delay_for(k) for k in range(5)] == want \
        == [0.1, 0.2, 0.4, 0.4, 0.4]
    j = RetryPolicy(base_delay_s=1.0, multiplier=1.0, max_delay_s=1.0,
                    jitter=0.25)
    for _ in range(32):
        assert 0.75 <= j.delay_for(0) <= 1.0


def test_retry_deadline_bounds_total_wall_time():
    now = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        now[0] += s

    p = RetryPolicy(max_attempts=100, base_delay_s=1.0, multiplier=1.0,
                    jitter=0.0, deadline_s=2.5, sleep=sleep,
                    clock=lambda: now[0], name="t.deadline")
    with pytest.raises(RetryError):
        p.call(lambda: (_ for _ in ()).throw(TimeoutError("down")))
    assert len(slept) == 2


@pytest.mark.chaos
def test_retry_absorbs_injected_faults():
    faults.inject("flaky.op", nth=1)
    p = RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0,
                    sleep=lambda s: None, name="t.faults")
    assert p.call(lambda: (faults.maybe_fail("flaky.op"), 7)[1]) == 7


def test_bump_counter_keys():
    from paddle_tpu_torch.reliability import bump_counter

    bump_counter("t.bump", "failures")
    assert retry_counters()["t.bump"]["failures"] == 1
    with pytest.raises(ValueError):
        bump_counter("t.bump", "import_failures")


# --------------------------------------------------- engine: serving paths


def _pair_run(pair, build, drive):
    """``build(cls, model)`` an engine of each package, ``drive(eng)`` it;
    returns (JAX (engine, result), port (engine, result))."""
    out = []
    for cls, m in ((JaxBatcher, pair[0]), (ContinuousBatcher, pair[1])):
        eng = build(cls, m)
        out.append((eng, drive(eng)))
    return out


@pytest.mark.chaos
def test_bounded_queue_backpressure(pair):
    rng = np.random.default_rng(0)
    p = rng.integers(0, 128, size=4).astype(np.int32)

    def drive(eng):
        eng.submit(p, 3)
        eng.submit(p, 3)
        raised = False
        try:
            eng.submit(p, 3)
        except Exception as e:
            raised = type(e).__name__ == "Backpressure"
        none = eng.try_submit(p, 3) is None
        done = eng.run()
        return (raised, none, eng.stats["rejected"],
                sorted(r.status for r in done.values()),
                eng.try_submit(p, 3) is not None)

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=2, max_seq=32, segment=2, max_pending=2), drive)
    assert t == j == (True, True, 2, ["ok", "ok"], True)
    assert issubclass(Backpressure, RuntimeError)


@pytest.mark.chaos
def test_deadline_expired_before_admission_times_out_without_prefill(pair):
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, 128, size=4).astype(np.int32) for _ in range(2)]

    def drive(eng):
        now = [0.0]
        eng._clock = lambda: now[0]
        r_dead = eng.submit(ps[0], 4, deadline_s=5.0)
        r_live = eng.submit(ps[1], 4)
        now[0] = 10.0
        done = eng.run()
        return (done[r_dead].status, done[r_dead].tokens,
                done[r_live].status, done[r_live].output_ids,
                eng.stats["timeouts"], eng.stats["prefills"])

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=2, max_seq=32, segment=2), drive)
    assert t == j
    assert t[:3] == ("timeout", [], "ok") and t[4:] == (1, 1)


@pytest.mark.chaos
def test_deadline_blown_mid_decode_finishes_with_partial_tokens(pair,
                                                                jax_ns):
    rng = np.random.default_rng(2)
    p_slow = rng.integers(0, 128, size=5).astype(np.int32)
    p_fast = rng.integers(0, 128, size=5).astype(np.int32)

    def drive(eng):
        eng._clock = lambda: 0.0 if eng.stats["segments"] < 2 else 100.0
        r_slow = eng.submit(p_slow, 24, deadline_s=50.0)
        r_fast = eng.submit(p_fast, 24)
        done = eng.run()
        return (done[r_slow].status, done[r_slow].tokens,
                done[r_fast].status, done[r_fast].output_ids,
                eng.stats["timeouts"])

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=2, max_seq=64, segment=2), drive)
    assert t == j
    got = len(t[1])
    assert t[0] == "timeout" and 0 < got < 24
    assert t[1] == solo(jax_ns, p_slow, 24)[5:5 + got]
    assert t[2] == "ok" and t[3] == solo(jax_ns, p_fast, 24)


def _poison(eng, token_id):
    """NaN the embedding row of ``token_id`` on the engine's params."""
    w = eng.params["model.embed_tokens.weight"]
    eng.params = dict(eng.params)
    if isinstance(w, torch.Tensor):
        w = w.clone()
        w[token_id] = float("nan")
    else:
        w = w.at[token_id].set(np.nan)
    eng.params["model.embed_tokens.weight"] = w


@pytest.mark.chaos
def test_poison_prompt_fails_alone_others_token_identical(pair):
    rng = np.random.default_rng(3)
    poison_tok = 77
    clean = [rng.integers(0, 128, size=6).astype(np.int32)
             for _ in range(2)]
    for p in clean:
        p[p == poison_tok] = 5
    bad = np.array([poison_tok, 3, 9], np.int32)

    def drive(eng):
        ref = type(eng)(eng.model, max_batch=3, max_seq=48, segment=4)
        ref_rids = [ref.submit(p, 6) for p in clean]
        ref_done = ref.run()
        _poison(eng, poison_tok)
        r_bad = eng.submit(bad, 6)
        rids = [eng.submit(p, 6) for p in clean]
        done = eng.run()
        return (done[r_bad].status, done[r_bad].tokens,
                eng.stats["poisoned"], eng.stats["quarantined"] == [r_bad],
                [done[r].status for r in rids],
                [done[r].tokens == ref_done[q].tokens
                 for r, q in zip(rids, ref_rids)],
                [done[r].tokens for r in rids])

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=3, max_seq=48, segment=4), drive)
    assert t == j
    assert t[:4] == ("poisoned", [], 1, True)
    assert t[4] == ["ok", "ok"] and t[5] == [True, True]


@pytest.mark.chaos
def test_poison_mid_decode_quarantines_with_partial_tokens(pair, jax_ns):
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 128, size=6).astype(np.int32)
    want = solo(jax_ns, prompt, 10)[6:]
    # a token the model WILL generate and the prompt does not hold (else
    # the prefill catches it)
    poison_tok = next(t for t in want[2:] if t not in prompt.tolist())
    first = want.index(poison_tok)

    def drive(eng):
        _poison(eng, poison_tok)
        rid = eng.submit(prompt, 10)
        done = eng.run()
        return done[rid].status, done[rid].tokens, eng.stats["poisoned"]

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=1, max_seq=64, segment=4), drive)
    assert t == j == ("poisoned", want[:first + 1], 1)


@pytest.mark.chaos
def test_readback_fault_fails_only_affected_request(pair, jax_ns):
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, 128, size=5).astype(np.int32) for _ in range(2)]

    def drive(eng):
        reg = faults if isinstance(eng, ContinuousBatcher) else jfaults
        r0 = eng.submit(ps[0], 8)
        r1 = eng.submit(ps[1], 8)
        reg.inject("engine.readback", when=lambda c: c.get("rid") == r1)
        try:
            done = eng.run()
        finally:
            reg.clear()
        return (done[r1].status, done[r1].error is not None,
                eng.stats["request_errors"], done[r0].status,
                done[r0].output_ids)

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=2, max_seq=48, segment=4), drive)
    assert t == j
    assert t[:4] == ("error", True, 1, "ok")
    assert t[4] == solo(jax_ns, ps[0], 8)


@pytest.mark.chaos
@pytest.mark.parametrize("site,ctx", [
    ("engine.dispatch", {}),              # the segments
    ("engine.prefill", {}),               # the ragged wave
])
def test_dispatch_fault_retried_under_policy(pair, jax_ns, site, ctx):
    """The gate retries under the engine's policy (the wave or segment
    runs once); stats["retries"] counts it, as the reference's."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 128, size=5).astype(np.int32)

    def build(cls, m):
        mod = jretry if cls is JaxBatcher else None
        pol = (mod.RetryPolicy if mod else RetryPolicy)(
            max_attempts=3, base_delay_s=0.0, jitter=0.0,
            sleep=lambda s: None, name="engine.dispatch")
        return cls(m, max_batch=1, max_seq=32, segment=2, retry_policy=pol)

    def drive(eng):
        reg = faults if isinstance(eng, ContinuousBatcher) else jfaults
        rid = eng.submit(prompt, 6)
        reg.inject(site, nth=1 if site == "engine.prefill" else 2)
        try:
            done = eng.run()
        finally:
            reg.clear()
        return done[rid].status, done[rid].output_ids, eng.stats["retries"]

    (_, j), (_, t) = _pair_run(pair, build, drive)
    assert t == j == ("ok", solo(jax_ns, prompt, 6), 1)


@pytest.mark.chaos
def test_dispatch_fault_exhausting_the_policy_counts_its_retries(pair):
    """A gate fault that outlasts the policy raises RetryError out of
    run(), with every retry counted."""
    rng = np.random.default_rng(6)
    pol = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                      sleep=lambda s: None, name="engine.dispatch")
    eng = ContinuousBatcher(pair[1], max_batch=1, max_seq=32, segment=2,
                            retry_policy=pol)
    eng.submit(rng.integers(0, 128, size=5).astype(np.int32), 6)
    faults.inject("engine.prefill", times=None)
    with pytest.raises(RetryError):
        eng.run()
    assert eng.stats["retries"] == 2


@pytest.mark.chaos
def test_dispatch_fault_without_policy_propagates(pair):
    rng = np.random.default_rng(7)
    for cls, m, reg in ((JaxBatcher, pair[0], jfaults),
                        (ContinuousBatcher, pair[1], faults)):
        eng = cls(m, max_batch=1, max_seq=32, segment=2)
        eng.submit(rng.integers(0, 128, size=5).astype(np.int32), 6)
        reg.inject("engine.prefill", nth=1)
        try:
            with pytest.raises(reg.FaultError):
                eng.run()
        finally:
            reg.clear()


@pytest.mark.chaos
def test_drain_stops_admission_finishes_inflight(pair, jax_ns):
    rng = np.random.default_rng(8)
    p_now = rng.integers(0, 128, size=5).astype(np.int32)
    p_later = rng.integers(0, 128, size=5).astype(np.int32)

    def drive(eng):
        r_now = eng.submit(p_now, 8)
        r_later = eng.submit(p_later, 8, arrival_segment=3)

        def on_tick(tick):
            if tick >= 1:
                eng.drain()

        eng._on_tick = on_tick
        done = eng.run()
        first = (done[r_now].status, done[r_now].output_ids,
                 r_later in done, eng.pending)
        eng._on_tick = None
        eng.reopen()
        return first, eng.run()[r_later].output_ids

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=1, max_seq=48, segment=2), drive)
    assert t == j
    assert t[0] == ("ok", solo(jax_ns, p_now, 8), False, 1)
    assert t[1] == solo(jax_ns, p_later, 8)


@pytest.mark.chaos
def test_drain_before_run_returns_immediately(pair):
    rng = np.random.default_rng(9)
    eng = ContinuousBatcher(pair[1], max_batch=1, max_seq=32, segment=2)
    eng.submit(rng.integers(0, 128, size=4).astype(np.int32), 4)
    eng.drain()
    assert eng.run() == {}
    assert eng.pending == 1


def test_engine_stats_reliability_keys_zero_on_clean_run(pair):
    rng = np.random.default_rng(10)
    eng = ContinuousBatcher(pair[1], max_batch=2, max_seq=32, segment=2)
    rids = [eng.submit(rng.integers(0, 128, size=5).astype(np.int32), 4)
            for _ in range(3)]
    done = eng.run()
    assert set(done) == set(rids)
    for key in ("timeouts", "rejected", "poisoned", "retries",
                "request_errors"):
        assert eng.stats[key] == 0, key
    assert eng.stats["quarantined"] == []


# ------------------------------------------------------- stats + health


def test_health_digest_keys_match_the_reference(pair):
    def drive(eng):
        eng.submit(np.arange(9, dtype=np.int32), 3)
        eng.run()
        return eng.health_digest()

    (_, j), (_, t) = _pair_run(pair, lambda c, m: c(
        m, max_batch=1, max_seq=32, segment=2, page_size=8), drive)
    assert set(t) == set(j)
    for k in ("queue_depth", "active_slots", "draining", "tokens_emitted",
              "prefix_hit_rate", "adapters_resident"):
        assert t[k] == j[k], k
    assert t["arena_pressure"] > 0.0


def test_health_snapshot_surfaces_match_the_reference(pair):
    """Every key of the reference's snapshot, the retries rollup, the
    flight-record tail the reference gives without a watchdog, and each
    engine surface's record keys."""
    reset_retry_counters()
    calls = [0]

    def probe():
        calls[0] += 1
        if calls[0] == 1:
            raise OSError("once")
        return True

    RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0,
                sleep=lambda s: None, name="h.probe").call(probe)
    thealth.note_watchdog_timeout("barrier(health-test)")
    engines = []
    for cls, m in ((JaxBatcher, pair[0]), (ContinuousBatcher, pair[1])):
        e = cls(m, max_batch=1, max_seq=32, segment=2, page_size=8)
        e.submit(np.arange(9, dtype=np.int32), 3)
        e.run()
        engines.append(e)
    snap, ref = health_snapshot(), jhealth.health_snapshot()
    assert set(snap) == set(ref)
    assert snap["flight_record_tail"] == []
    assert "h.probe" in snap["retry_counters"]
    assert snap["retries"]["counters"] == snap["retry_counters"]
    assert snap["retries"]["totals"]["retries"] >= 1
    assert any(t["site"] == "barrier(health-test)"
               for t in snap["watchdog_timeouts"])
    assert snap["faults"]["enabled"] is False
    assert set(snap["faults"]) == set(ref["faults"])
    assert set(snap["elastic"]) == set(ref["elastic"])
    for surface in ("fleet", "disagg", "autoscaler"):
        assert isinstance(snap[surface], list)
    for surface, fn in (("kv_tiers", "kv_tier_snapshot"),
                        ("arena", "arena_snapshot")):
        got = getattr(engines[1], fn)()
        want = getattr(engines[0], fn)()
        assert got in snap[surface]
        assert set(got) == set(want), surface
    assert any("timeouts" in e for e in snap["engines"])


def test_health_snapshot_adapters_surface(pair):
    from paddle_tpu_torch.models.lora import make_lora_adapter

    rng = np.random.default_rng(33)
    eng = ContinuousBatcher(pair[1], max_batch=2, max_seq=32, segment=2,
                            page_size=8, lora=True, lora_max_rank=2,
                            lora_hbm_adapters=2)
    eng.register_adapter("t0", make_lora_adapter(pair[1].config, rank=2,
                                                 seed=40))
    eng.submit(rng.integers(0, 128, size=9).astype(np.int32), 3,
               adapter_id="t0")
    eng.submit(rng.integers(0, 128, size=7).astype(np.int32), 3,
               adapter_id="t0")
    eng.run()
    recs = [r for r in health_snapshot()["adapters"]
            if r.get("resident_ids") == ["t0"]]
    assert recs
    rec = recs[-1]
    assert rec["adapter_swap_stalls"] == 1 and rec["adapter_hits"] == 1
    assert rec["refcounts"] == {"t0": 0}
    assert eng.health_digest()["adapters_resident"] == ["t0"]


def test_health_snapshot_fleet_and_disagg_surfaces(pair):
    """A live router's fleet_health() and the disagg workers' records are
    in the snapshot, key for key as the reference's; a collected router
    drops out."""
    from paddle_tpu.inference.fleet import make_fleet as jax_make_fleet
    from paddle_tpu.inference.router import FleetRouter as JaxRouter

    from paddle_tpu_torch.inference.fleet import FleetWorker, make_fleet
    from paddle_tpu_torch.inference.router import FleetRouter

    recs = {}
    for name, mk, router_cls, mod, m in (
            ("jax", jax_make_fleet, JaxRouter, jhealth, pair[0]),
            ("port", make_fleet, FleetRouter, thealth, pair[1])):
        registry, workers = mk(
            m, 2, heartbeat_interval=0.05, lease_ttl=2.0,
            roles=["prefill", "decode"], max_batch=2, max_seq=64,
            page_size=16, segment=2, host_tier=True)
        for w in workers:
            w.start()
        try:
            router = router_cls(workers, registry, disagg=True, max_queue=1)
            r_ok = router.submit(np.arange(6, dtype=np.int32), 10)
            r_shed = router.submit(np.arange(4, dtype=np.int32), 4)
            done = router.join(timeout=60)
            snap = mod.health_snapshot()
            fl = [f for f in snap["fleet"]
                  if f.get("generation") == registry.generation
                  and f.get("job") == registry.job_id
                  and f.get("shed_by_tier", {}).get(2) == 1]
            dis = {r["name"]: r for r in snap["disagg"]
                   if r.get("name") in router.workers}
            recs[name] = dict(
                status=(done[r_ok].status, done[r_shed].status,
                        done[r_ok].migrated),
                fleet_keys=set(fl[0]) if fl else None,
                gray_keys=set(fl[0]["gray"]) if fl else None,
                lease_keys=set(next(iter(fl[0]["leases"].values())))
                if fl else None,
                disagg={n: (r["role"], r["migrations_in"],
                            r["migrations_out"], r["resumes_recovered"],
                            r["bytes_migrated"] > 0)
                        for n, r in dis.items()},
                disagg_keys=[set(r) for r in dis.values()])
            job, gen = registry.job_id, registry.generation
        finally:
            stop(workers)
        del router
        gc.collect()
        assert not [f for f in mod.health_snapshot()["fleet"]
                    if f.get("job") == job and f.get("generation") == gen
                    and f.get("shed_by_tier", {}).get(2) == 1]
    assert recs["port"] == recs["jax"]
    assert recs["port"]["status"] == ("ok", "shed", 1)
    assert recs["port"]["disagg"] == {
        "replica0": ("prefill", 0, 1, 0, False),
        "replica1": ("decode", 1, 0, 1, True)}
    mono = FleetWorker("mono", ContinuousBatcher(
        pair[1], max_batch=1, max_seq=64, page_size=16, segment=2),
        registry, heartbeat_interval=0.05)
    assert mono.role == "both" and mono.disagg_snapshot() is None


def test_autoscaler_and_elastic_registries():
    """The autoscaler and elastic registries are plain registries (their
    modules come later): a registered object's record shows in the
    snapshot and drops out once collected; elastic events keep the
    reference's view."""
    class Scaler:
        def autoscaler_snapshot(self):
            return {"cooldown_s": 9.75, "replicas": 1}

    s = Scaler()
    thealth.register_autoscaler(s)
    assert {"cooldown_s": 9.75, "replicas": 1} in \
        health_snapshot()["autoscaler"]
    del s
    gc.collect()
    assert not [a for a in health_snapshot()["autoscaler"]
                if a.get("cooldown_s") == 9.75]
    thealth.note_elastic_event("rescale", generation=3, world=2, rank=0,
                               alive_hosts=2)
    jhealth.note_elastic_event("rescale", generation=3, world=2, rank=0,
                               alive_hosts=2)
    got, want = thealth.elastic_state(), jhealth.elastic_state()
    assert set(got) == set(want)
    assert got["generation"] == 3 and got["alive_host_count"] == 2
    assert got["events"][-1]["kind"] == "rescale"


def test_worker_wait_helper_times_out():
    """The drills' waits fail loudly instead of hanging."""
    with pytest.raises(AssertionError, match="within"):
        wait(lambda: False, timeout=0.05)


def test_launch_counter_is_exact_under_many_threads():
    """The kernels' launch counters bump under one lock
    (``_build.count``): 16 threads x 5,000 bumps with a switch interval
    of 1 µs lose none (a bare ``+= 1`` on a module global can)."""
    import sys
    import threading

    from paddle_tpu_torch.ops.kernels import _build

    counters = {"launches": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(counters) for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counters["launches"] == 16 * 5000
