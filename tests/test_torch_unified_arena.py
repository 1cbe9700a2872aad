"""The unified arena: the port against the JAX package, on the CPU.

Restates the arena-only cases of ``tests/test_unified_arena.py`` as port
against reference: each case runs the same operations on the port's
``models/arena.py`` and on the JAX package's and must give the same
results (floors parsing, constructor validation, the physical ceiling,
steal / floor / deferral, no self-steal, refcounts, the view's allocator
contract, the snapshot's shape, the demotion cost model off and on and
its flag, and the 320-step cross-class lifecycle step for step); and
``ContinuousBatcher`` with the arena on and off, fp and int8w+int8kv, both
attention plans, on the tiered thrash workload, against the reference's
tokens and ``stats``, with the engine's ``arena_snapshot``. The
multi-LoRA, fleet, health-snapshot and chaos cases wait for multi-LoRA
serving and the fault sites (ROADMAP.md, Queue 1 items 4 and 6).
"""

from __future__ import annotations

import numpy as np
import pytest

from paddle_tpu.framework import flags as jflags
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.models import arena as jarena
from paddle_tpu.models import kv_cache as jkv

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.models import arena as tarena
from paddle_tpu_torch.models import kv_cache as tkv

from torch_batcher_pairs import (build_pair, int8_params, serve_pair,
                                 stack_kw)

SIDES = {"jax": (jarena, jkv, jpc, jflags), "port": (tarena, tkv, tpc,
                                                     tflags)}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def q8(pair):
    return int8_params(*pair)


def _both(case):
    """The case's results on each side; equal, returned once."""
    got, want = case(*SIDES["port"]), case(*SIDES["jax"])
    assert got == want
    return got


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError("did not raise")


# ------------------------------------------------------------ mechanics


def test_parse_class_floors():
    def case(arena, *_):
        p = arena.parse_class_floors
        return [p("kv=1,adapter=1,weight=0"), p(""), p(" kv=2 "),
                _raises(lambda: p("bogus=1")), _raises(lambda: p("kv")),
                _raises(lambda: p("kv=-1"))]
    out = _both(case)
    assert out[0] == {"kv": 1, "adapter": 1, "weight": 0}


def test_arena_ctor_validates():
    def case(arena, *_):
        A = arena.UnifiedArena
        a = A(8, {"kv": (4, 2)})
        return [_raises(lambda: A(0, {"kv": (4, 2)})),
                _raises(lambda: A(8, {"blob": (4, 2)})),
                _raises(lambda: A(8, {"kv": (0, 2)})),
                _raises(lambda: a.view("adapter")),
                _raises(lambda: a.set_reclaimer("adapter", lambda n: 0)),
                a.classes(), list(arena.ARENA_CLASSES)]
    _both(case)


def test_physical_ceiling_denies_without_steal():
    def case(arena, *_):
        a = arena.UnifiedArena(1000, {"kv": (4, 2), "adapter": (10, 2)})
        calls = []
        a.set_reclaimer("adapter", lambda n: calls.append(n) or 0)
        out = [a.alloc("kv", 3), list(calls), a.stats["budget_deferrals"],
               a.alloc("kv", 2), a.alloc("kv", 1), list(calls)]
        a.check()
        return out
    assert _both(case)[3] == [0, 1]


def test_budget_steal_floor_and_deferral():
    def case(arena, *_):
        a = arena.UnifiedArena(44, {"kv": (4, 16), "adapter": (10, 3)},
                               floors={"adapter": 1})
        residents = list(a.alloc("adapter", 3))

        def reclaim(n):
            freed = 0
            while freed < n and residents:
                a.release("adapter", [residents.pop()])
                freed += 1
            return freed

        a.set_reclaimer("adapter", reclaim)
        out = [a.alloc("kv", 4), dict(a.stats["steals"]),
               a.stats["demotions"], a.resident("adapter")]
        n = 0
        while a.alloc("kv", 1) is not None:
            n += 1
        out += [n, a.resident("adapter"), a.stats["budget_deferrals"]]
        a.check()
        return out
    out = _both(case)
    assert out[1] == {"adapter->kv": 1} and out[5] == 1 and out[6] >= 1


def test_same_class_never_self_steals():
    def case(arena, *_):
        a = arena.UnifiedArena(8, {"kv": (4, 4)})
        calls = []
        a.set_reclaimer("kv", lambda n: calls.append(n) or 0)
        out = [a.alloc("kv", 2), a.alloc("kv", 1), calls,
               a.stats["budget_deferrals"]]
        a.check()
        return out
    assert _both(case)[2:] == [[], 1]


def test_refcount_lifecycle_contracts():
    def case(arena, *_):
        a = arena.UnifiedArena(100, {"kv": (4, 4)})
        pages = a.alloc("kv", 2)
        a.retain("kv", pages)
        out = [a.release("kv", pages), sorted(a.release("kv", pages)),
               _raises(lambda: a.release("kv", [pages[0]])),
               _raises(lambda: a.retain("kv", [pages[0]])),
               a.alloc("kv", 0), _raises(lambda: a.alloc("kv", -1))]
        pg = a.alloc("kv", 1)
        out += [pg, a.resident("kv")]
        a.reset_class("kv")
        out += [a.resident("kv"), a.available("kv")]
        a.check()
        return out
    _both(case)


def test_arena_view_page_allocator_contract():
    def case(arena, *_):
        a = arena.UnifiedArena(1000, {"kv": (4, 3), "adapter": (10, 2)})
        kv, ad = a.view("kv"), a.view("adapter")
        out = [type(kv).__name__, kv.n_pages, ad.n_pages]
        pg = ad.alloc(1)
        ad.retain(pg)
        out += [pg, int(ad.refcount[0]),
                int(a.refcount[a._base["adapter"]])]
        a.release("adapter", pg)
        out += [int(ad.refcount[0]), kv.available()]
        ps = kv.alloc(2)
        out += [ps, int(kv.refcount[ps[0]])]
        kv.release(ps)
        kv.check()
        ad.release(pg)
        a.check()
        return out
    assert _both(case)[:3] == ["ArenaView", 3, 2]


def test_snapshot_shape():
    def case(arena, *_):
        a = arena.UnifiedArena(44, {"kv": (4, 4), "adapter": (10, 2)},
                               floors={"kv": 1, "adapter": 1})
        a.alloc("kv", 2)
        return a.snapshot()
    snap = _both(case)
    assert snap["classes"]["kv"] == {"unit_bytes": 4, "hbm_pages": 4,
                                     "hbm_resident": 2, "hbm_free": 2,
                                     "floor": 1}


def _cost_model_case(cost_model):
    """The reference's opposite-rankings arena: ``weight`` cold and dear
    to restore, ``adapter`` warm and cheap; a kv deficit makes one
    yield."""
    def case(arena, *_):
        a = arena.UnifiedArena(150, {"kv": (4, 8), "adapter": (10, 4),
                                     "weight": (100, 1)},
                               cost_model=cost_model)
        demoted = []
        w_res = list(a.alloc("weight", 1))
        a_res = list(a.alloc("adapter", 4))

        def mk(cls, residents):
            def reclaim(n):
                freed = 0
                while freed < n and residents:
                    a.release(cls, [residents.pop()])
                    demoted.append(cls)
                    freed += 1
                return freed
            return reclaim

        a.set_reclaimer("weight", mk("weight", w_res))
        a.set_reclaimer("adapter", mk("adapter", a_res))
        a.release("adapter", [a_res.pop()])
        a_res.extend(a.alloc("adapter", 1))
        got = a.alloc("kv", 4)
        a.check()
        return [got, demoted, dict(a.stats["steals"]), a.resident("weight"),
                a.resident("adapter"), a.stats["demotions"]]
    return case


def test_cost_model_off_demotes_by_recency():
    assert _both(_cost_model_case(False))[1] == ["weight"]
    assert _both(_cost_model_case(None))[2] == {"weight->kv": 1}


def test_cost_model_on_demotes_cheaper_restore():
    out = _both(_cost_model_case(True))
    assert out[1] == ["adapter"] and out[3:] == [1, 3, 1]


def test_cost_model_flag_drives_ctor_default():
    for fl in (tflags, jflags):
        fl.set_flags({"arena_cost_model": True})
    try:
        assert _both(_cost_model_case(None))[1] == ["adapter"]
    finally:
        for fl in (tflags, jflags):
            fl.set_flags({"arena_cost_model": False})
    assert _both(_cost_model_case(None))[1] == ["weight"]


# ------------------------------------------------------- property suite


def _cross_class_lifecycle(arena_mod, kv_mod, pc_mod, _flags, steps=320):
    """The reference's randomized 320-step mixed lifecycle — PrefixCache
    admissions and evictions on the kv view (demote-to-host reclaim),
    synthetic adapter residency with pins, draft-weight churn, park /
    resume / export records on the host pager — recording every result
    and, after each operation, the arena's refcounts, residency and
    steal counters and the host pager's state."""
    rng = np.random.default_rng(42)
    P = 4
    arena = arena_mod.UnifiedArena(
        100, {"kv": (4, 20), "adapter": (12, 4), "weight": (4, 3)},
        floors=arena_mod.parse_class_floors("kv=1,adapter=1,weight=0"))
    kview = arena.view("kv")
    host = kv_mod.PageAllocator(16)
    moved = []
    pc = pc_mod.PrefixCache(P, kview, host_pager=host,
                            offload=lambda dps, hps: moved.extend(hps))
    arena.set_reclaimer("kv", pc.reclaim)
    a_res: dict = {}
    a_pins: dict = {}

    def a_reclaim(n):
        freed = 0
        idle = [a for a in a_res if a_pins.get(a, 0) == 0]
        for aid in idle[:n]:
            arena.release("adapter", [a_res.pop(aid)])
            a_pins.pop(aid, None)
            freed += 1
        return freed

    arena.set_reclaimer("adapter", a_reclaim)
    w_live: list = []
    arena.set_reclaimer(
        "weight",
        lambda n: len([arena.release("weight", [w_live.pop(0)])
                       for _ in range(min(n, len(w_live)))]))
    live: dict = {}
    parked: dict = {}
    streams = [[int(t) for t in rng.integers(0, 5,
                                             size=rng.integers(P, 5 * P))]
               for _ in range(6)]
    trace = []

    def kv_alloc(n):
        priv = kview.alloc(n)
        if priv is None and pc.n_nodes:
            trace.append(("evict", pc.evict(n)))
            priv = kview.alloc(n)
        return priv

    def admit(step):
        toks = streams[int(rng.integers(len(streams)))]
        m_len, pages = pc.match(toks)
        kview.retain(pages)
        need = -(-len(toks) // P) - len(pages)
        priv = kv_alloc(need)
        trace.append(("admit", m_len, pages, priv))
        if priv is None:
            kview.release(pages)
            return
        all_pages = pages + priv
        live[step] = all_pages
        n_full = len(toks) // P
        if n_full:
            trace.append(("insert", pc.insert(toks[:n_full * P],
                                              all_pages[:n_full])))

    for step in range(steps):
        op = rng.random()
        if op < 0.30 and len(live) < 5:
            admit(step)
        elif op < 0.40 and live:
            slot = list(live)[int(rng.integers(len(live)))]
            hps = host.alloc(len(live[slot]))
            if hps is None:
                pc.free_host_slots(len(live[slot]) - host.available())
                hps = host.alloc(len(live[slot]))
            trace.append(("park", hps))
            if hps is not None:
                kview.release(live.pop(slot))
                parked[slot] = hps
        elif op < 0.48 and parked:
            slot = list(parked)[int(rng.integers(len(parked)))]
            priv = kv_alloc(len(parked[slot]))
            trace.append(("resume", priv))
            if priv is not None:
                host.release(parked.pop(slot))
                live[slot] = priv
        elif op < 0.53 and parked:
            slot = list(parked)[int(rng.integers(len(parked)))]
            host.release(parked.pop(slot))
        elif op < 0.60 and live:
            kview.release(live.pop(list(live)[
                int(rng.integers(len(live)))]))
        elif op < 0.75:
            aid = f"a{int(rng.integers(6))}"
            if aid in a_res:
                arena.retain("adapter", [a_res[aid]])
                a_pins[aid] = a_pins.get(aid, 0) + 1
            else:
                pg = arena.alloc("adapter", 1)
                trace.append(("adapter", pg))
                if pg is not None:
                    a_res[aid] = pg[0]
                    a_pins[aid] = 0
        elif op < 0.85:
            pinned = [a for a, n in a_pins.items() if n > 0]
            if pinned:
                aid = pinned[int(rng.integers(len(pinned)))]
                a_pins[aid] -= 1
                arena.release("adapter", [a_res[aid]])
        elif op < 0.93:
            if len(w_live) < 3 and rng.random() < 0.6:
                pg = arena.alloc("weight", 1)
                trace.append(("weight", pg))
                if pg is not None:
                    w_live.append(pg[0])
            elif w_live:
                arena.release("weight", [w_live.pop()])
        elif op < 0.97 and pc.n_nodes:
            trace.append(("evict", pc.evict(int(rng.integers(1, 4)))))
        else:
            trace.append(("discard", pc.free_host_slots(
                int(rng.integers(1, 3)))))
        arena.check()
        host.check()
        trace.append((arena.refcount.tolist(),
                      {c: arena.resident(c) for c in arena.classes()},
                      dict(arena.stats["steals"]), arena.stats["demotions"],
                      host.refcount.tolist(), sorted(pc.pages()),
                      sorted(pc.host_pages()), len(moved)))
    for pages in live.values():
        kview.release(pages)
    for hps in parked.values():
        host.release(hps)
    for aid, n in list(a_pins.items()):
        for _ in range(n):
            arena.release("adapter", [a_res[aid]])
    for aid in list(a_res):
        arena.release("adapter", [a_res.pop(aid)])
    for pg in w_live:
        arena.release("weight", [pg])
    pc.evict_all()
    pc.drop_host_nodes()
    arena.check()
    trace.append(({c: arena.resident(c) for c in arena.classes()},
                  host.available(), arena.used_bytes(),
                  arena.stats["demotions"],
                  sum(arena.stats["steals"].values())))
    return trace


def test_property_cross_class_lifecycle_320_steps():
    got = _cross_class_lifecycle(*SIDES["port"])
    want = _cross_class_lifecycle(*SIDES["jax"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    resident, host_free, used, demotions, steals = got[-1]
    assert all(v == 0 for v in resident.values())
    assert host_free == 16 and used == 0
    assert demotions > 0 and steals > 0


# -------------------------------------------------- engine exactness


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_parity_tiered_thrash_arena_on_vs_off(pair, q8, stack):
    """The tiered thrash workload (A, thrash, A + divergence through a
    6-page pool) with the arena on and off: the reference's tokens and
    stats on each side, the same tokens on and off, and the engine's
    arena snapshot as the reference's."""
    jmodel, tmodel = pair
    jkw, tkw = stack_kw(stack, *q8)
    rng = np.random.default_rng(11)
    a = rng.integers(0, 128, size=24).astype(np.int32)
    thrash = rng.integers(0, 128, size=24).astype(np.int32)
    a_div = np.concatenate([a, rng.integers(0, 128, size=2).astype(
        np.int32)])
    subs = [(a, 6, 0), (thrash, 6, 8), (a_div, 6, 16)]
    kw = dict(max_batch=1, max_seq=32, segment=2, page_size=8,
              page_pool_pages=6)
    jon, on_done, ports, rids = serve_pair(jmodel, tmodel, subs, jkw=jkw,
                                           tkw=tkw, unified_arena=True,
                                           **kw)
    _, off_done, off_ports, _ = serve_pair(jmodel, tmodel, subs, jkw=jkw,
                                           tkw=tkw, unified_arena=False,
                                           **kw)
    for r in rids:
        assert on_done[r].output_ids == off_done[r].output_ids
    teng = ports[0][0]
    assert teng.arena_snapshot() == jon.arena_snapshot()
    assert off_ports[0][0].arena_snapshot() is None
    assert "arena_steals" in teng.stats
    assert "arena_steals" not in off_ports[0][0].stats


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_caching=False, unified_arena=True),
     "unified_arena requires"),
    (dict(arena_hbm_pages=-1), "arena_hbm_pages"),
    (dict(arena_class_floors="bogus=1"), "unknown arena class"),
])
def test_ctor_contract(pair, kw, match):
    from paddle_tpu.inference.continuous_batching import \
        ContinuousBatcher as JaxBatcher

    jmodel, tmodel = pair
    for cls, m in ((JaxBatcher, jmodel), (ContinuousBatcher, tmodel)):
        with pytest.raises(ValueError, match=match):
            cls(m, max_batch=1, **kw)


def test_auto_budget_is_the_pool_and_the_weight_class_is_reserved(pair):
    jmodel, tmodel = pair
    from paddle_tpu.inference.continuous_batching import \
        ContinuousBatcher as JaxBatcher

    for kw in ({}, dict(arena_hbm_pages=40), dict(page_pool_pages=10,
                                                  arena_hbm_pages=3)):
        t = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, page_size=8,
                              **kw)
        j = JaxBatcher(jmodel, max_batch=2, max_seq=32, page_size=8, **kw)
        assert t._arena_kv_pages == j._arena_kv_pages
        assert t._arena.snapshot() == j._arena.snapshot()
        assert t._arena.n_pages("weight") == 0
