"""The host KV tier: the port against the JAX package, on the CPU.

Restates ``tests/test_kv_tiering.py`` as port against reference:
``HostPageArena`` store/load byte-exact and bitwise the reference's in
bf16, f32 and int8 (codes and scale cells in one slot); demote, match and
promote on the tiered tree, host-pressure discards and insert upgrades,
each result equal to the reference's; the 300-step dual-arena lifecycle
(admit through ``match_tiered`` with the engine's hold/promote
choreography, park, resume, release, evict, discard) step for step
against the reference; and ``ContinuousBatcher`` with the tier on and off,
fp and int8w+int8kv, both attention plans, against the reference's
tokens and ``stats``: a prefix served from the host tier, park/resume
across runs admitting one token, a park freeing the slot for a
neighbour, the digest of a host-resident prefix, and the constructor's
contract. The fault sites' chaos cases (``prefix.prefetch``,
``prefix.offload``, ``engine.park``) are in
``tests/test_torch_fault_sites.py``, live migration
(``export_parked``/``import_parked``) in ``tests/test_torch_disagg.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import flags as jflags
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.prefix_cache import \
    page_hash_chain as jax_page_hash_chain
from paddle_tpu.models import kv_cache as jkv

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.inference.prefix_cache import (PrefixCache,
                                                     page_hash_chain)
from paddle_tpu_torch.models import kv_cache as tkv

from torch_batcher_pairs import (build_pair, int8_params, serve_pair,
                                 stack_kw)

TIER = {"jax": (jkv.PageAllocator, JaxPrefixCache),
        "port": (tkv.PageAllocator, PrefixCache)}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def q8(pair):
    return int8_params(*pair)


# --------------------------------------------------------- arena unit


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_host_arena_roundtrip_byte_exact(dtype):
    """store -> scrub -> load gives a page's bytes back (codes and, on an
    int8 cache, the scale cells of the same slot), and every pool and
    host slot equals the reference arena's after the same moves."""
    rng = np.random.default_rng(0)
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
           "int8": "int8"}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}[dtype]
    jc = jkv.create_paged_cache(2, 1, 16, 2, 4, page_size=8, extra_pages=3,
                                dtype=jdt)
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales")
                                      if dtype == "int8" else ())
    fill = {}
    for n in names:
        shape = getattr(jc, n).shape
        fill[n] = (rng.integers(-127, 128, size=shape).astype(np.int8)
                   if n.endswith("pages") and dtype == "int8"
                   else rng.normal(size=shape).astype(np.float32))
    jc = jc._replace(**{n: jnp.asarray(fill[n]).astype(getattr(jc, n).dtype)
                        for n in names})
    tc = tkv.create_paged_cache(2, 1, 16, 2, 4, page_size=8, extra_pages=3,
                                dtype=tdt)
    for n in names:
        getattr(tc, n).copy_(torch.from_numpy(fill[n]).to(
            getattr(tc, n).dtype))
    ja, ta = jkv.HostPageArena(4, jc), tkv.HostPageArena(4, tc)
    before = {n: getattr(tc, n)[:, :, 1].clone() for n in names}
    ja.store(jc, [1], [2])
    ta.store(tc, [1], [2])
    jc = jc._replace(**{n: getattr(jc, n).at[:, :, 1].set(0)
                        for n in names})
    for n in names:
        getattr(tc, n)[:, :, 1] = 0
    jc = ja.load(jc, [2], [1], depth=1)
    tc = ta.load(tc, [2], [1], depth=1)
    for n in names:
        assert torch.equal(getattr(tc, n)[:, :, 1], before[n])
    # a chunked load (two dispatches)
    ja.store(jc, [0, 1], [0, 1])
    ta.store(tc, [0, 1], [0, 1])
    jc = ja.load(jc, [0, 1], [2, 3], depth=1)
    tc = ta.load(tc, [0, 1], [2, 3], depth=1)
    for n in names:
        want = np.asarray(getattr(jc, n).astype(jnp.float32)
                          if dtype == "bfloat16" else getattr(jc, n))
        np.testing.assert_array_equal(getattr(tc, n).float().numpy()
                                      if dtype == "bfloat16"
                                      else getattr(tc, n).numpy(), want)
    np.testing.assert_array_equal(
        ta.k.float().numpy() if dtype == "bfloat16" else ta.k.numpy(),
        np.moveaxis(np.asarray(ja.k.astype(np.float32)
                               if dtype == "bfloat16" else ja.k), 2, 0))
    assert ta.page_spec() == ja.page_spec()
    assert ta.nbytes() == ja.nbytes() and not ta.pinned
    with pytest.raises(ValueError, match="host slots"):
        ta.store(tc, [0, 1], [0])


# ------------------------------------------------- tree-level tiering


def _tiered_tree(side, n_hbm=16, n_host=12, page=4):
    alloc_cls, cache_cls = TIER[side]
    hbm, host = alloc_cls(n_hbm), alloc_cls(n_host)
    moves = []
    pc = cache_cls(page, hbm, host_pager=host,
                   offload=lambda dps, hps: moves.extend(zip(dps, hps)))
    return pc, hbm, host, moves


def _demote_match_promote(side):
    pc, hbm, host, moves = _tiered_tree(side)
    out = []
    toks = list(range(12))
    pages = hbm.alloc(3)
    pc.insert(toks, pages)
    hbm.release(pages)
    digest = pc.digest()
    out += [pc.evict(3), hbm.available(), pc.stats["demotions"], moves[:],
            sorted(pc.host_pages()), pc.digest() == digest, pc.match(toks)]
    m_len, path = pc.match_tiered(toks)
    out += [m_len, [n.tier for n in path]]
    fresh = hbm.alloc(3)
    for n, d in zip(path, fresh):
        pc.promote(n, d)
        hbm.retain([d])
    m_len2, path2 = pc.match_tiered(toks)
    out += [host.available(), m_len2, [n.tier for n in path2],
            pc.match(toks)]
    hbm.release([n.page for n in path2])
    hbm.check(), host.check()
    return out


def test_demote_match_promote_metadata():
    got = _demote_match_promote("port")
    assert got == _demote_match_promote("jax")
    assert got[0] == 3 and got[5] is True and got[6] == (0, [])


def _discard_and_upgrade(side):
    pc, hbm, host, _ = _tiered_tree(side)
    a, b = list(range(8)), [9, 9, 9, 9]
    pa, pb = hbm.alloc(2), hbm.alloc(1)
    pc.insert(a, pa)
    pc.insert(b, pb)
    hbm.release(pa), hbm.release(pb)
    pc.match(a)
    out = [pc.evict(3), pc.free_host_slots(1), pc.match_tiered(b)[0],
           pc.match_tiered(a)[0], pc.stats["host_discards"]]
    pa2 = hbm.alloc(2)
    pc.insert(a, pa2)
    out += [pc.stats["insert_upgrades"],
            [n.tier for n in pc.match_tiered(a)[1]], host.available()]
    hbm.release(pa2)
    pc.evict_all()
    out += [hbm.available(), dict(pc.stats)]
    hbm.check(), host.check()
    return out


def test_only_host_pressure_discards_and_insert_upgrades():
    got = _discard_and_upgrade("port")
    assert got == _discard_and_upgrade("jax")
    assert got[:5] == [3, 1, 0, 8, 1] and got[5] == 2


def _dual_lifecycle(side, steps=300):
    """The reference's randomized offload/prefetch/park/discard lifecycle,
    recording every result and, after each operation, both arenas'
    refcounts and free lists and the tree's pages by tier."""
    rng = np.random.default_rng(42)
    P, N_HBM, N_HOST = 4, 20, 16
    pc, hbm, host, moves = _tiered_tree(side, N_HBM, N_HOST, P)
    live: dict = {}
    parked: dict = {}
    streams = [[int(t) for t in rng.integers(0, 5,
                                             size=rng.integers(P, 5 * P))]
               for _ in range(6)]
    trace = []

    def admit(step):
        toks = streams[int(rng.integers(len(streams)))]
        m_len, path = pc.match_tiered(toks)
        n_hbm_m = sum(1 for n in path if n.tier == "hbm")
        host_sfx = path[n_hbm_m:]
        need = -(-len(toks) // P) - n_hbm_m
        hbm_pages = [n.page for n in path[:n_hbm_m]]
        hbm.retain(hbm_pages)
        hold = [n.page for n in host_sfx]
        if hold:
            host.retain(hold)
        priv = hbm.alloc(need)
        if priv is None:
            trace.append(("evict", pc.evict(need - hbm.available())))
            priv = hbm.alloc(need)
        trace.append(("admit", m_len, hbm_pages, hold, priv))
        if priv is None:
            hbm.release(hbm_pages)
            if hold:
                host.release(hold)
            return
        dst = [priv.pop(0) for _ in host_sfx]
        for n, d in zip(host_sfx, dst):
            if n.parent is not None and n.tier == "host":
                pc.promote(n, d)
                hbm.retain([d])
        if hold:
            host.release(hold)
        pages = hbm_pages + dst + priv
        live[step] = pages
        n_full = len(toks) // P
        if n_full:
            trace.append(("insert", pc.insert(toks[:n_full * P],
                                              pages[:n_full])))

    for step in range(steps):
        op = rng.random()
        if op < 0.40 and len(live) < 5:
            admit(step)
        elif op < 0.55 and live:
            slot = list(live)[int(rng.integers(len(live)))]
            pages = live[slot]
            hps = host.alloc(len(pages))
            if hps is None:
                trace.append(("discard", pc.free_host_slots(
                    len(pages) - host.available())))
                hps = host.alloc(len(pages))
            trace.append(("park", hps))
            if hps is not None:
                live.pop(slot)
                hbm.release(pages)
                parked[slot] = hps
        elif op < 0.70 and parked:
            slot = list(parked)[int(rng.integers(len(parked)))]
            hps = parked[slot]
            priv = hbm.alloc(len(hps))
            if priv is None:
                trace.append(("evict", pc.evict(len(hps)
                                                - hbm.available())))
                priv = hbm.alloc(len(hps))
            trace.append(("resume", priv))
            if priv is not None:
                parked.pop(slot)
                host.release(hps)
                live[slot] = priv
        elif op < 0.85 and live:
            slot = list(live)[int(rng.integers(len(live)))]
            trace.append(("release", hbm.release(live.pop(slot))))
        elif op < 0.95 and pc.n_nodes:
            trace.append(("evict", pc.evict(int(rng.integers(1, 4)))))
        else:
            trace.append(("discard", pc.free_host_slots(
                int(rng.integers(1, 3)))))
        hbm.check()
        host.check()
        trace.append((hbm.refcount.tolist(), list(hbm._free),
                      host.refcount.tolist(), list(host._free),
                      sorted(pc.pages()), sorted(pc.host_pages()),
                      len(moves)))
    for pages in live.values():
        hbm.release(pages)
    for hps in parked.values():
        host.release(hps)
    pc.evict_all()
    trace.append((hbm.available(), host.available(), dict(pc.stats)))
    return trace


def test_property_dual_arena_lifecycle_300_steps():
    got, want = _dual_lifecycle("port"), _dual_lifecycle("jax")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    n_hbm, n_host, stats = got[-1]
    assert (n_hbm, n_host) == (20, 16)
    assert stats["demotions"] > 0 and stats["promotions"] > 0


# --------------------------------------------------- engine exactness


def _tiered_subs(seed):
    """A, thrash, A + divergence through an under-provisioned pool: the
    thrash demotes A's pages, so the divergent request's shared prefix
    comes from the host tier."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 128, size=24).astype(np.int32)
    thrash = rng.integers(0, 128, size=24).astype(np.int32)
    a_div = np.concatenate([a, rng.integers(0, 128, size=2).astype(
        np.int32)])
    return [(a, 6, 0), (thrash, 6, 8), (a_div, 6, 16)]


TIERED = dict(max_batch=1, max_seq=32, segment=2, page_size=8,
              page_pool_pages=6)


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_host_served_prefix_parity_vs_off_and_solo(pair, q8, stack):
    jmodel, tmodel = pair
    jkw, tkw = stack_kw(stack, *q8)
    subs = _tiered_subs(11)
    _, on_done, ports, rids = serve_pair(jmodel, tmodel, subs, jkw=jkw,
                                         tkw=tkw, **TIERED)
    _, off_done, off_ports, _ = serve_pair(jmodel, tmodel, subs, jkw=jkw,
                                           tkw=tkw, host_tier=False,
                                           **TIERED)
    for r in rids:
        assert on_done[r].output_ids == off_done[r].output_ids
    teng = ports[0][0]
    st = teng.stats
    assert st["host_tier_hits"] >= 1 and st["recompute_avoided_tokens"] > 0
    assert st["host_tier_pages_demoted"] > 0
    assert (off_ports[0][0].stats["prefill_tokens_admitted"]
            > st["prefill_tokens_admitted"])
    teng._pager.check()
    teng._host_pager.check()
    assert teng._prefix.host_pages() == []
    if stack == "fp":
        for (p, n, _), r in zip(subs, rids):
            assert ports[0][1][r].output_ids == tmodel.generate_paged(
                p[None], max_new_tokens=n)[0].tolist()


def _park_then_resume(target, arm=lambda t: True):
    """A ``drive`` for ``serve_pair``: the first run parks ``target`` at
    the first tick ``arm`` accepts, then ``resume`` and a second run; the
    finished requests of both."""
    def drive(eng, rids):
        fired = []

        def hook(t):
            if not fired and arm(t):
                eng.park(rids[target])
                fired.append(t)

        eng._on_tick = hook
        done = eng.run()
        eng._on_tick = None
        assert eng.parked == [rids[target]] and eng.stats["parks"] == 1
        assert eng.kv_tier_snapshot()["parked_slots"] == 1
        base = eng.stats["prefill_tokens_admitted"]
        eng.resume(rids[target])
        assert eng.parked == []
        done.update(eng.run())
        assert eng.stats["prefill_tokens_admitted"] - base == 1
        eng._host_pager.check()
        assert eng._host_pager.available() == eng._host_pager.n_pages
        return done
    return drive


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_park_resume_across_runs_no_reprefill(pair, q8, stack):
    """park() frees the slot mid-decode; resume() in a later run picks the
    stream up with exactly one admitted token: tokens and stats (parks,
    resumes, the host tier's counters, host_sync_count) as the
    reference's."""
    jmodel, tmodel = pair
    jkw, tkw = stack_kw(stack, *q8)
    p = np.random.default_rng(12).integers(0, 128, size=20).astype(np.int32)
    _, _, ports, rids = serve_pair(
        jmodel, tmodel, [(p, 10, 0)], jkw=jkw, tkw=tkw,
        drive=_park_then_resume(0), max_batch=2, max_seq=48, segment=2,
        page_size=8)
    teng, tdone = ports[0]
    assert teng.stats["resumes"] == 1 and teng.stats["host_tier_hits"] >= 1
    # the resumed stream's one chunk: its unconsumed last token
    starts = tdone[rids[0]].chunk_starts
    assert len(starts) >= 2 and starts[-1] >= len(p)
    if stack == "fp":
        assert tdone[rids[0]].output_ids == tmodel.generate_paged(
            p[None], max_new_tokens=10)[0].tolist()


def test_park_frees_the_slot_for_a_neighbor(pair):
    jmodel, tmodel = pair
    rng = np.random.default_rng(13)
    pa = rng.integers(0, 128, size=16).astype(np.int32)
    pb = rng.integers(0, 128, size=16).astype(np.int32)
    _, _, ports, rids = serve_pair(
        jmodel, tmodel, [(pa, 12, 0), (pb, 6, 2)],
        drive=_park_then_resume(0), max_batch=1, max_seq=48, segment=2,
        page_size=8)
    tdone = ports[0][1]
    for (p, n, _), r in zip(([(pa, 12, 0), (pb, 6, 2)]), rids):
        assert tdone[r].output_ids == tmodel.generate_paged(
            p[None], max_new_tokens=n)[0].tolist()


def test_digest_gossips_host_resident_prefix(pair):
    """While the tree holds a demoted prefix, its digest still lists the
    prefix's page hashes, the reference's digest at the same tick."""
    jmodel, tmodel = pair
    subs = _tiered_subs(14)
    seen = {}

    def drive_for(side):
        def drive(eng, rids):
            def hook(t):
                pc = eng._prefix
                if pc is not None and pc.host_pages():
                    seen.setdefault(side, []).append(
                        (t, pc.digest(top_k=64)))
            eng._on_tick = hook
            return eng.run()
        return drive

    jeng = JaxBatcher(jmodel, **TIERED)
    for p, n, a in subs:
        jeng.submit(p, n, arrival_segment=a)
    drive_for("jax")(jeng, None)
    teng = ContinuousBatcher(tmodel, **TIERED)
    for p, n, a in subs:
        teng.submit(p, n, arrival_segment=a)
    drive_for("port")(teng, None)
    assert seen["port"] == seen["jax"] and seen["port"]
    chain = page_hash_chain([int(t) for t in subs[0][0]], 8)
    assert chain == jax_page_hash_chain([int(t) for t in subs[0][0]], 8)
    assert any(h in set(seen["port"][0][1]) for h in chain)


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_caching=False, host_tier=True), "kv_host_tier requires"),
    (dict(prefetch_depth=0), "prefetch_depth"),
    (dict(host_tier_pages=-1), "host_tier_pages"),
])
def test_flag_and_ctor_contract(pair, kw, match):
    jmodel, tmodel = pair
    for cls, m in ((JaxBatcher, jmodel), (ContinuousBatcher, tmodel)):
        with pytest.raises(ValueError, match=match):
            cls(m, max_batch=1, **kw)


def test_park_contract_and_the_flag_default(pair):
    jmodel, tmodel = pair
    for cls, m in ((JaxBatcher, jmodel), (ContinuousBatcher, tmodel)):
        with pytest.raises(ValueError, match="park requires"):
            cls(m, max_batch=1, host_tier=False).park(0)
        with pytest.raises(KeyError):
            cls(m, max_batch=1).resume(3)
    assert ContinuousBatcher(tmodel, max_batch=1)._host_tier is True
    tflags.set_flags({"kv_host_tier": False})
    jflags.set_flags({"kv_host_tier": False})
    try:
        assert not ContinuousBatcher(tmodel, max_batch=1)._host_tier
        assert not JaxBatcher(jmodel, max_batch=1)._host_tier
    finally:
        tflags.set_flags({"kv_host_tier": True})
        jflags.set_flags({"kv_host_tier": True})
    # live migration's contract, as the reference's: nothing parked under
    # the rid, a blob without a spec, and no host tier to land in
    for cls, m in ((JaxBatcher, jmodel), (ContinuousBatcher, tmodel)):
        eng = cls(m, max_batch=1)
        for call in (lambda: eng.export_parked(0),
                     lambda: eng.import_parked({})):
            with pytest.raises(KeyError):
                call()
        with pytest.raises(ValueError, match="kv_host_tier"):
            cls(m, max_batch=1, host_tier=False).import_parked({})
