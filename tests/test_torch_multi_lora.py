"""Multi-LoRA serving: the PyTorch port vs the JAX package, on the CPU.

The cases of ``tests/test_multi_lora.py`` (all but its two fault-injection
cases: the port has no fault sites yet), on the port, against the JAX
package on the same model (``torch_batcher_pairs.build_pair``: the JAX
package's LoRA test model bridged into the port) and the same adapters
(the numpy dicts of ``make_lora_adapter``, registered on both engines):

  * ``AdapterPool``: validation, residency, refcounts, LRU eviction,
    deferral and rank padding, step for step with the reference's pool;
  * ``lora_delta_pure`` against the per-row f32 oracle and the reference;
  * the plans (a ``lora_delta`` node after each adapted projection,
    fused or not) and the launch count: two grouped matmuls per
    projection whatever the number of adapters;
  * the batcher: a mixed wave of base, adapter-A and adapter-B requests,
    fp and int8w+int8kv, in both attention plans, gives the reference's
    tokens, each request's solo-with-adapter tokens, and every non-timing
    stat of the reference (the adapter stats among them); the merged-
    weights solo arm; the eviction/reload cycle; deferral; the contracts
    and the flag default; park and resume; sampling at ``top_k=1``;
  * the prefix cache with adapters: the reference matches and inserts on
    prompt tokens alone, so an adapter request whose prompt shares full
    pages with a base request's reads the base request's K/V (its tokens
    differ from its solo run, asserted here as the reference's behaviour);
    the port keys its tree by adapter, and its tokens equal the solo
    oracle's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.models import lora as jlora
from paddle_tpu.ops.pallas import fusion as jfusion

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models.lora import (LORA_PROJS, AdapterPool,
                                          lora_delta_pure, make_lora_adapter,
                                          merge_lora)
from paddle_tpu_torch.ops.kernels import fusion
from paddle_tpu_torch.ops.kernels import grouped_matmul as gm

from torch_batcher_pairs import (PLANS, build_pair, comparable, int8_params,
                                 with_plan)

ENGINE = dict(max_batch=3, max_seq=32, page_size=8, segment=4,
              lora_max_rank=4, lora_hbm_adapters=2)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def tmodel(pair):
    return pair[1]


@pytest.fixture(scope="module")
def qpair(pair):
    return int8_params(*pair)


@pytest.fixture(scope="module")
def adapters(tmodel):
    return {"A": make_lora_adapter(tmodel.config, rank=4, seed=1),
            "B": make_lora_adapter(tmodel.config, rank=2, seed=2)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, size=s).astype(np.int32)
            for s in (9, 7, 5)]


def _engine(cls, model, adapters, **kw):
    eng = cls(model, lora=True, **{**ENGINE, **kw})
    for aid, w in adapters.items():
        eng.register_adapter(aid, w)
    return eng


def _serve(eng, subs, drive=None):
    """Submit ``subs`` ((prompt, max_new, adapter) each) and run: (rids,
    {rid: request})."""
    rids = [eng.submit(p, n, adapter_id=a) for p, n, a in subs]
    return rids, (drive(eng) if drive else eng.run())


def _solo(model, adapters, prompt, aid, max_new=8, **kw):
    eng = _engine(ContinuousBatcher, model, adapters, **kw)
    rid = eng.submit(prompt, max_new, adapter_id=aid)
    return eng.run()[rid].tokens


def _serve_pair(pair, adapters, subs, jkw=None, tkw=None, drive=None,
                **kw):
    """``subs`` on the JAX engine and on the port's in both attention
    plans: every request's tokens and status and every non-timing stat
    equal. Returns (JAX done, [(port engine, port done)], rids)."""
    jmodel, tmodel = pair
    jeng = _engine(JaxBatcher, jmodel, adapters, **kw, **(jkw or {}))
    rids, jdone = _serve(jeng, subs, drive)
    ports = []
    for plan in PLANS:
        teng = with_plan(plan, lambda: _engine(
            ContinuousBatcher, tmodel, adapters, **kw, **(tkw or {})))
        trids, tdone = with_plan(plan, lambda: _serve(teng, subs, drive))
        assert trids == rids
        for r in rids:
            assert tdone[r].tokens == jdone[r].tokens, (plan, r)
            assert tdone[r].status == jdone[r].status, (plan, r)
        want, got = comparable(jeng.stats), comparable(teng.stats)
        assert set(want) <= set(got), sorted(set(want) - set(got))
        for k in want:
            assert got[k] == want[k], (plan, k, got[k], want[k])
        ports.append((teng, tdone))
    return jdone, ports, rids


# ---------------------------------------------------------------- pool


def test_adapters_are_the_reference_draws(tmodel, pair):
    ref = jlora.make_lora_adapter(pair[0].config, rank=4, seed=1)
    got = make_lora_adapter(tmodel.config, rank=4, seed=1)
    assert sorted(got) == sorted(ref)
    for name in ref:
        for a, b in zip(got[name], ref[name]):
            assert np.array_equal(a, b)


def test_pool_register_validates(tmodel):
    pool = AdapterPool(tmodel, max_rank=4, hbm_slots=2)
    good = make_lora_adapter(tmodel.config, rank=4, seed=0)
    pool.register("ok", good)
    with pytest.raises(ValueError, match="already registered"):
        pool.register("ok", good)
    with pytest.raises(ValueError, match="exceeds lora_max_rank"):
        pool.register("big", make_lora_adapter(tmodel.config, rank=8))
    with pytest.raises(ValueError, match="not an adaptable projection"):
        pool.register("weird", {"model.layers.0.input_layernorm.weight":
                                (np.zeros((64, 2)), np.zeros((2, 64)))})
    name = "model.layers.0.self_attn.q_proj.weight"
    with pytest.raises(ValueError, match="wants A"):
        pool.register("shape", {name: (np.zeros((3, 2), np.float32),
                                       np.zeros((2, 64), np.float32))})
    with pytest.raises(KeyError):
        pool.acquire("never-registered")


def test_pool_residency_refcount_lru_defer(pair):
    """The reference's lifecycle, step for step on both pools: slots,
    residency, refcounts and stats after every call."""
    jmodel, tmodel = pair
    pools = (jlora.AdapterPool(jmodel, max_rank=2, hbm_slots=2),
             AdapterPool(tmodel, max_rank=2, hbm_slots=2))
    for pool in pools:
        for i, aid in enumerate(("a", "b", "c")):
            pool.register(aid, make_lora_adapter(tmodel.config, rank=2,
                                                 seed=i))
    steps = [("acquire", "a"), ("acquire", "b"), ("acquire", "c"),
             ("acquire", "a"), ("release", "a"), ("release", "a"),
             ("release", "b"), ("acquire", "c"), ("release", "c"),
             ("acquire", "b"), ("acquire", "a")]
    for op, aid in steps:
        outs = [getattr(pool, op)(aid) for pool in pools]
        assert outs[0] == outs[1], (op, aid)
        assert pools[0].resident == pools[1].resident
        assert pools[0].refcounts() == pools[1].refcounts()
        assert pools[0].stats == pools[1].stats
    pool = pools[1]
    assert pool.stats == {"adapter_hits": 1, "adapter_swap_stalls": 5,
                          "adapter_loads": 5, "adapter_evictions": 3}
    assert pool.snapshot() == pools[0].snapshot()
    with pytest.raises(ValueError, match="double release"):
        pool.release("c")


def test_pool_subset_adapter_zeroes_previous_occupant(tmodel):
    pool = AdapterPool(tmodel, max_rank=2, hbm_slots=1)
    pool.register("full", make_lora_adapter(tmodel.config, rank=2, seed=3))
    qname = "model.layers.0.self_attn.q_proj.weight"
    sub = {qname: make_lora_adapter(tmodel.config, rank=2, seed=4)[qname]}
    pool.register("qonly", sub)
    slot = pool.acquire("full")
    gname = "model.layers.0.mlp.gate_proj.weight"
    assert float(pool.stacks[gname][0][slot].abs().max()) > 0
    pool.release("full")
    assert pool.acquire("qonly") == slot
    assert float(pool.stacks[gname][0][slot].abs().max()) == 0.0
    assert float(pool.stacks[qname][0][slot].abs().max()) > 0
    assert float(pool.stacks[qname][0][-1].abs().max()) == 0.0


# --------------------------------------------------------------- delta


def _oracle_delta(x, a_stack, b_stack, row_group):
    out = np.zeros((x.shape[0], b_stack.shape[-1]), np.float32)
    for r in range(x.shape[0]):
        g = int(row_group[r])
        out[r] = (x[r].astype(np.float32) @ a_stack[g]) @ b_stack[g]
    return out


def test_lora_delta_matches_per_row_oracle_and_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    t, k, r, n, g = 16, 24, 3, 10, 4      # group 3 = all-zeros base
    x = rng.normal(size=(t, k)).astype(np.float32)
    a = np.concatenate([rng.normal(size=(g - 1, k, r)),
                        np.zeros((1, k, r))]).astype(np.float32)
    b = np.concatenate([rng.normal(size=(g - 1, r, n)),
                        np.zeros((1, r, n))]).astype(np.float32)
    row_group = rng.integers(0, g, size=t)
    srt = np.argsort(row_group, kind="stable").astype(np.int32)
    inv = np.empty_like(srt)
    inv[srt] = np.arange(t, dtype=np.int32)
    offs = np.concatenate(
        [[0], np.cumsum(np.bincount(row_group, minlength=g))]).astype(
            np.int32)
    got = lora_delta_pure(*(torch.as_tensor(v) for v in (x, a, b, srt, inv,
                                                          offs))).numpy()
    np.testing.assert_allclose(got, _oracle_delta(x, a, b, row_group),
                               rtol=2e-5, atol=2e-5)
    assert np.all(got[row_group == g - 1] == 0.0)
    ref = np.asarray(jlora.lora_delta_pure(*(jnp.asarray(v) for v in (
        x, a, b, srt, inv, offs))))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # leading dims flatten into the rows (the prompt-logits forward's
    # (B, S, K) input)
    got3 = lora_delta_pure(torch.as_tensor(x).reshape(2, 8, k),
                           *(torch.as_tensor(v) for v in (a, b, srt, inv,
                                                          offs)))
    assert torch.equal(got3.reshape(t, n), torch.as_tensor(got))


def test_rank_padding_is_exact(tmodel):
    pool = AdapterPool(tmodel, max_rank=4, hbm_slots=1)
    ad = make_lora_adapter(tmodel.config, rank=2, seed=5)
    pool.register("x", ad)
    slot = pool.acquire("x")
    name = "model.layers.0.self_attn.q_proj.weight"
    a_pad = pool.stacks[name][0][slot].numpy()
    b_pad = pool.stacks[name][1][slot].numpy()
    assert np.all(a_pad[:, 2:] == 0.0) and np.all(b_pad[2:, :] == 0.0)
    x = np.random.default_rng(2).normal(size=(5, a_pad.shape[0])).astype(
        np.float32)
    a, b = ad[name]
    assert np.all((x @ a_pad)[:, 2:] == 0.0)
    np.testing.assert_allclose((x @ a_pad) @ b_pad, (x @ a) @ b,
                               rtol=1e-4, atol=1e-7)


# ------------------------------------------------------- plans / pins


@pytest.mark.parametrize("enabled", [(), ("norm_matmul",),
                                     ("norm_matmul", "rope_append_attend")])
def test_lora_plan_matches_the_reference(enabled):
    plan = fusion.layer_plan(enabled=enabled, lora=True)
    ref = jfusion.layer_plan(enabled=enabled, lora=True)
    assert [tuple(n) for n in plan] == [tuple(n) for n in ref]
    deltas = [n for n in plan if n.kind == "lora_delta"]
    assert len(deltas) == len(LORA_PROJS) == 7
    assert len(plan) == len(fusion.layer_plan(enabled=enabled)) + 7
    by_proj = {n.w[0]: n for n in deltas}
    fused = "norm_matmul" in enabled
    assert by_proj["self_attn.q_proj.weight"].w[1] == (
        "input_layernorm.weight" if fused else None)
    assert by_proj["mlp.up_proj.weight"].w[1] == (
        "post_attention_layernorm.weight" if fused else None)
    assert by_proj["self_attn.o_proj.weight"].w[1] is None
    assert by_proj["mlp.down_proj.weight"].w[1] is None


def test_launch_count_independent_of_adapter_count(tmodel, monkeypatch):
    """Two grouped matmuls per adapted projection and layer, whatever the
    number of adapter slots, every one over all T rows; the plan counts
    agree with the reference's."""
    L = tmodel.config.num_hidden_layers
    for fused in (True, False):
        off = fusion.kernel_launches_per_token(L, fused=fused)
        on = fusion.kernel_launches_per_token(L, fused=fused, lora=True)
        assert on - off == 2 * 7 * L
        assert on == jfusion.kernel_launches_per_token(L, fused=fused,
                                                       lora=True)
    plan = fusion.planned_kernel_launches(L, enabled=fusion.FUSIONS,
                                          lora=True)
    assert plan["grouped_matmul"] == 2 * 7 * L
    calls = []
    orig = gm.gmm
    monkeypatch.setattr(gm, "gmm", lambda x, *a, **kw: (
        calls.append(x.shape) or orig(x, *a, **kw)))
    prms = tmodel.param_dict()
    t = 8
    for slots in (2, 8):
        calls.clear()
        pool = AdapterPool(tmodel, max_rank=2, hbm_slots=slots)
        pool.register("a", make_lora_adapter(tmodel.config, rank=2))
        pool.acquire("a")
        srt, inv, offs = pool.route_rows(np.zeros((t,), np.int32))
        ctx = {"sort": srt, "inv": inv, "offsets": offs,
               "params": pool.stacks}
        hidden = torch.zeros((t, tmodel.config.hidden_size))

        def attend(q, k, v):
            return torch.zeros((t, tmodel.config.num_attention_heads
                                * tmodel.config.head_dim))

        fusion.run_decoder_layer(prms, 0, hidden, tmodel.config.rms_norm_eps,
                                 attend, ctx)
        assert len(calls) == 14
        assert all(s[0] == t for s in calls)


def test_fused_delta_reads_the_unfused_chains_input(tmodel):
    """A fused norm_matmul's delta reads the normed input the unfused
    chain computes: the fused and unfused plans give the same layer."""
    pool = AdapterPool(tmodel, max_rank=4, hbm_slots=2)
    pool.register("a", make_lora_adapter(tmodel.config, rank=4, seed=8,
                                         scale=1.0))
    pool.acquire("a")
    t = 6
    srt, inv, offs = pool.route_rows(np.array([0, 2, 0, 2, 0, 0]))
    ctx = {"sort": srt, "inv": inv, "offsets": offs, "params": pool.stacks}
    hidden = torch.as_tensor(np.random.default_rng(1).normal(
        size=(t, tmodel.config.hidden_size)).astype(np.float32))

    def attend(q, k, v):
        return q

    prms = tmodel.param_dict()
    outs = [fusion.run_decoder_layer(prms, 1, hidden,
                                     tmodel.config.rms_norm_eps, attend,
                                     ctx, enabled=en)
            for en in ((), ("norm_matmul",))]
    base = fusion.run_decoder_layer(prms, 1, hidden,
                                    tmodel.config.rms_norm_eps, attend,
                                    enabled=("norm_matmul",))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    # the base rows (group 2) get exactly the base layer, adapter rows not
    assert torch.equal(outs[1][[1, 3]], base[[1, 3]])
    assert not torch.allclose(outs[1][[0, 2]], base[[0, 2]])


# ------------------------------------------------ the exactness gate


@pytest.mark.parametrize("stack", ("fp", "int8"))
def test_mixed_wave_parity(pair, qpair, adapters, prompts, stack):
    """Base + adapter-A + adapter-B in one wave: the reference's tokens
    and stats, each request's solo-with-adapter tokens, and the base
    request's tokens from a lora-off engine."""
    jq, tq = qpair
    jkw, tkw = ({}, {}) if stack == "fp" else (
        dict(quantized_params=jq, cache_dtype="int8"),
        dict(quantized_params=tq, cache_dtype="int8"))
    subs = [(prompts[0], 8, None), (prompts[1], 8, "A"),
            (prompts[2], 8, "B")]
    jdone, ports, rids = _serve_pair(pair, adapters, subs, jkw, tkw)
    _, tdone = ports[0]
    tmodel = pair[1]
    for r, (p, n, aid) in zip(rids, subs):
        assert tdone[r].status == "ok"
        assert tdone[r].tokens == _solo(tmodel, adapters, p, aid, n,
                                        **tkw), aid
    off = ContinuousBatcher(tmodel, max_batch=3, max_seq=32, page_size=8,
                            segment=4, **tkw)
    ro = off.submit(prompts[0], 8)
    assert tdone[rids[0]].tokens == off.run()[ro].tokens
    assert tdone[rids[1]].tokens != _solo(tmodel, adapters, prompts[1],
                                          None, 8, **tkw)


def test_merged_weights_solo_arm(pair, adapters, prompts):
    _, tmodel = pair
    merged = merge_lora(tmodel.param_dict(), adapters["A"])
    out = tmodel.generate_paged(prompts[1][None, :], max_new_tokens=8,
                                page_size=8, params=merged)
    assert out[0, len(prompts[1]):].tolist() == _solo(
        tmodel, adapters, prompts[1], "A")


def test_eviction_reload_cycle_parity(pair, adapters, prompts):
    """One slot, two adapters: B's admission evicts A, A's return reloads
    it; stats and tokens equal the reference's, tokens equal solo. On the
    legacy pool: the unified arena grows the adapter class instead of
    evicting (the reference's own eviction case needs the same)."""
    def drive(eng):
        done = {}
        for p, aid in ((prompts[0], "A"), (prompts[1], "B"),
                       (prompts[2], "A")):
            rid = eng.submit(p, 6, adapter_id=aid)
            done.update(eng.run())
        return done

    jdone, ports, _ = _serve_pair(pair, adapters, [], drive=drive,
                                  lora_hbm_adapters=1, unified_arena=False)
    teng, tdone = ports[0]
    assert teng.stats["adapter_swap_stalls"] >= 3
    assert teng.stats["adapter_evictions"] >= 2
    for rid, (p, aid) in enumerate(((prompts[0], "A"), (prompts[1], "B"),
                                    (prompts[2], "A"))):
        assert tdone[rid].tokens == _solo(pair[1], adapters, p, aid, 6,
                                          lora_hbm_adapters=1,
                                          unified_arena=False)


def test_adapter_defer_when_all_slots_pinned(pair, adapters, prompts):
    """Two tenants through one slot (the legacy pool): the second defers
    until the first retires, then serves as solo and as the reference."""
    subs = [(prompts[0], 6, "A"), (prompts[1], 6, "B")]
    jdone, ports, rids = _serve_pair(pair, adapters, subs,
                                     lora_hbm_adapters=1,
                                     unified_arena=False)
    teng, tdone = ports[0]
    assert teng.stats["adapter_deferrals"] >= 1
    for r, (p, n, aid) in zip(rids, subs):
        assert tdone[r].status == "ok"
        assert tdone[r].tokens == _solo(pair[1], adapters, p, aid, n,
                                        lora_hbm_adapters=1,
                                        unified_arena=False)


def test_affinity_reorder_and_legacy_pool_parity(pair, adapters, prompts):
    """More tenants than slots on the legacy pool (no arena): admission
    pulls a resident tenant's request ahead of a head that would load;
    stats (adapter_batched, deferrals, evictions) and tokens equal the
    reference's."""
    rng = np.random.default_rng(21)
    subs = [(rng.integers(0, 128, size=int(rng.integers(5, 12)))
             .astype(np.int32), 5, aid)
            for aid in ("A", "B", "A", None, "B", "A", "B")]
    jdone, ports, _ = _serve_pair(pair, adapters, subs, max_batch=2,
                                  lora_hbm_adapters=1, unified_arena=False)
    teng, _ = ports[0]
    assert teng.stats["adapter_batched"] > 0
    assert teng.stats["adapter_evictions"] > 0


# --------------------------------------------------------- contracts


def test_ctor_and_submit_contracts(tmodel, adapters, prompts):
    with pytest.raises(ValueError, match="requires ragged"):
        ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8,
                          ragged=False, lora=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8,
                          spec_decode=True, lora=True)
    with pytest.raises(ValueError, match="adapter_pool needs lora"):
        ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8,
                          adapter_pool=AdapterPool(tmodel, 2, 2))
    plain = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8)
    with pytest.raises(ValueError, match="needs lora serving"):
        plain.submit(prompts[0], 4, adapter_id="A")
    with pytest.raises(ValueError, match="requires lora serving"):
        plain.register_adapter("A", adapters["A"])
    eng = _engine(ContinuousBatcher, tmodel, adapters)
    with pytest.raises(ValueError, match="not registered"):
        eng.submit(prompts[0], 4, adapter_id="nope")
    # an injected pool serves as the engine's own
    pool = AdapterPool(tmodel, max_rank=4, hbm_slots=2)
    shared = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8,
                               lora=True, adapter_pool=pool)
    assert shared._adapters is pool


def test_flag_driven_default(tmodel):
    assert tflags.get_flag("lora_serving") is False
    assert tflags.get_flag("lora_max_rank") == 16
    assert tflags.get_flag("lora_hbm_adapters") == 8
    plain = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8)
    assert plain._lora is False and plain._adapters is None
    old = tflags.get_flag("lora_serving")
    try:
        tflags.set_flags({"lora_serving": True})
        on = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8)
        assert on._lora is True and on._adapters is not None
        assert on._adapters.max_rank == 16
        spec = ContinuousBatcher(tmodel, max_batch=2, max_seq=32,
                                 page_size=8, spec_decode=True)
        assert spec._lora is False
        legacy = ContinuousBatcher(tmodel, max_batch=2, max_seq=32,
                                   page_size=8, unified_arena=False)
        assert legacy._adapters.hbm_slots == 8
    finally:
        tflags.set_flags({"lora_serving": old})


def test_stats_surface_scheduler_specific(tmodel, adapters, prompts):
    eng = _engine(ContinuousBatcher, tmodel, adapters)
    for key in ("adapters_resident", "adapter_hits", "adapter_swap_stalls",
                "adapter_evictions", "adapter_deferrals", "adapter_batched"):
        assert key in eng.stats
    plain = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8)
    assert "adapter_swap_stalls" not in plain.stats
    assert plain.adapter_snapshot() is None
    eng.submit(prompts[0], 4, adapter_id="A")
    eng.run()
    snap = eng.adapter_snapshot()
    assert snap["adapters_resident"] == 1 and snap["resident_ids"] == ["A"]
    assert snap["refcounts"] == {"A": 0}
    assert snap["adapter_swap_stalls"] == 1
    assert eng.arena_snapshot()["classes"]["adapter"]["host_resident"] == 2


# -------------------------------------------------- cross-subsystem


def test_park_resume_releases_and_reacquires_adapter(pair, adapters,
                                                     prompts):
    """A parked stream drops its adapter pin, B takes the single slot,
    resume re-pins A (a reload) and finishes as the reference does and
    as its uninterrupted solo run."""
    def drive(eng):
        rid = 0
        req = eng._queue[0]
        parked = {"done": False}

        def hook(tick):
            if not parked["done"] and len(req.tokens) >= 3:
                eng.park(rid)
                parked["done"] = True

        eng._on_tick = hook
        eng.run()
        assert parked["done"] and eng.parked == [rid]
        assert eng._adapters.refcounts().get("A", 0) == 0
        rb = eng.submit(prompts[1], 4, adapter_id="B")
        eng._on_tick = None
        done = dict(eng.run())
        eng.resume(rid)
        done.update(eng.run())
        assert done[rb].status == "ok"
        return done

    jdone, ports, rids = _serve_pair(
        pair, adapters, [(prompts[0], 10, "A")], drive=drive, max_seq=64,
        lora_hbm_adapters=1, host_tier=True)
    teng, tdone = ports[0]
    solo = _solo(pair[1], adapters, prompts[0], "A", 10, max_seq=64)
    assert tdone[0].status == "ok" and tdone[0].tokens == solo
    assert teng.stats["adapter_swap_stalls"] >= 2


def test_sampling_top_k1_with_adapters(tmodel, adapters, prompts):
    subs = [(prompts[0], 6, None), (prompts[1], 6, "A"),
            (prompts[2], 6, "B")]
    _, greedy = _serve(_engine(ContinuousBatcher, tmodel, adapters), subs)
    _, sampled = _serve(_engine(ContinuousBatcher, tmodel, adapters,
                                temperature=0.9, top_k=1, seed=4), subs)
    assert [sampled[r].tokens for r in range(3)] == [
        greedy[r].tokens for r in range(3)]
    _, hot = _serve(_engine(ContinuousBatcher, tmodel, adapters,
                            temperature=1.0, seed=4), subs)
    _, hot2 = _serve(_engine(ContinuousBatcher, tmodel, adapters,
                             temperature=1.0, seed=4), subs)
    assert [hot[r].tokens for r in range(3)] == [
        hot2[r].tokens for r in range(3)]


def test_prefix_cache_keys_by_adapter(pair):
    """A base request and a later adapter-A request sharing a two-page
    prompt prefix. The reference hands A the base request's pages (its
    tokens differ from A served alone); the port keys the tree by adapter,
    matches nothing for A, and A's tokens equal its solo run. A second A
    request on the same prefix still hits A's own pages."""
    jmodel, tmodel = pair
    strong = {"A": make_lora_adapter(tmodel.config, rank=4, seed=1,
                                     scale=1.0)}
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 128, size=16).astype(np.int32)
    pb = np.concatenate([shared, rng.integers(0, 128, 3).astype(np.int32)])
    pa = np.concatenate([shared, rng.integers(0, 128, 5).astype(np.int32)])
    pa2 = np.concatenate([shared, rng.integers(0, 128, 4).astype(np.int32)])
    kw = dict(max_seq=48)

    def serve(cls, model):
        eng = _engine(cls, model, strong, **kw)
        rb = eng.submit(pb, 16)
        ra = eng.submit(pa, 16, arrival_segment=3, adapter_id="A")
        ra2 = eng.submit(pa2, 8, arrival_segment=12, adapter_id="A")
        done = eng.run()
        return eng, done[rb].tokens, done[ra].tokens, done[ra2].tokens

    def solo(cls, model, p, n):
        eng = _engine(cls, model, strong, **kw)
        rid = eng.submit(p, n, adapter_id="A")
        return eng.run()[rid].tokens

    jeng, _, j_a, _ = serve(JaxBatcher, jmodel)
    assert jeng.stats["prefix_tokens_matched"] >= 16
    assert j_a != solo(JaxBatcher, jmodel, pa, 16)   # the reference fault
    for plan in PLANS:
        teng, t_b, t_a, t_a2 = with_plan(plan, lambda: serve(
            ContinuousBatcher, tmodel))
        assert t_a == solo(ContinuousBatcher, tmodel, pa, 16), plan
        assert t_a2 == solo(ContinuousBatcher, tmodel, pa2, 8), plan
        # A's first request missed, its second hit A's own two pages
        assert teng.stats["prefix_hits"] == 1
        assert teng.stats["prefix_tokens_matched"] == 16
        off = ContinuousBatcher(tmodel, max_batch=3, max_seq=48,
                                page_size=8, segment=4)
        rb = off.submit(pb, 16)
        assert t_b == off.run()[rb].tokens
