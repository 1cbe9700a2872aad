"""The prefix cache: the port against the JAX package, on the CPU.

Restates ``tests/test_prefix_cache.py`` as port against reference. The host
structures (``PageAllocator``, ``PrefixCache``) take the same operations on
both sides and must give the same results after every one of them; the
copy-on-write move (``clone_pages``) is bitwise the reference's on fp and
int8 pools; and ``ContinuousBatcher`` with the cache on and off, fp and
int8w+int8kv (the port's int8 held to the reference's int8), under both
attention plans, gives the reference's tokens and its ``stats`` (all but
the wall-clock timings): shared prefix, copy-on-write divergence,
full-prompt match, eviction under pressure, an under-provisioned pool, a
pool of pps pages, and the constructor's contract. The fault sites'
chaos cases (``prefix.match``, ``prefix.evict``) wait for the port's
fault-injection sites (ROADMAP.md, Queue 1 item 6).
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


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def q8(pair):
    return int8_params(*pair)


# ------------------------------------------------------- allocator unit


def _allocator_ops(alloc_cls):
    """The reference's allocator case, as the values it produces."""
    out = []
    a = alloc_cls(6)
    out.append(a.available())
    p = a.alloc(4)
    out += [p, a.available(), a.alloc(3), a.available()]
    a.retain(p[:2])
    out.append(a.release(p[:2]))
    out.append(sorted(a.release(p)))
    out.append(a.available())
    a.check()
    for bad, match in ((lambda: a.release([p[0]]), "double free"),
                       (lambda: a.retain([p[0]]), "only live pages")):
        with pytest.raises(ValueError, match=match):
            bad()
    out.append(a.refcount.tolist())
    return out


def test_allocator_alloc_retain_release_invariants():
    assert _allocator_ops(tkv.PageAllocator) == _allocator_ops(
        jkv.PageAllocator)


def _tree_ops(alloc_cls, cache_cls):
    out = []
    a = alloc_cls(16)
    pc = cache_cls(4, a)
    toks = list(range(12))
    pages = a.alloc(3)
    out += [pc.insert(toks, pages), pc.n_nodes, pc.match(toks),
            pc.match(toks[:11]), pc.match([99] + toks[:7])]
    fork = toks[:8] + [77, 78, 79, 80]
    fpages = a.alloc(3)
    out += [pc.insert(fork, fpages), pc.match(fork),
            int(a.refcount[fpages[0]])]
    a.release(pages)
    a.release(fpages)
    out.append(int(a.refcount[fpages[0]]))
    pc.match(toks)
    out += [pc.evict(1), pc.match(fork), pc.match(toks), pc.digest(),
            pc.stats.copy()]
    out += [pc.evict_all(), pc.n_nodes, a.available()]
    a.check()
    return out


def test_prefix_tree_match_insert_lru_evict():
    got = _tree_ops(tkv.PageAllocator, PrefixCache)
    assert got == _tree_ops(jkv.PageAllocator, JaxPrefixCache)
    assert got[2] == (12, [0, 1, 2]) and got[-3:] == [3, 0, 16]


def test_insert_rejects_partial_pages():
    for alloc_cls, cache_cls in ((tkv.PageAllocator, PrefixCache),
                                 (jkv.PageAllocator, JaxPrefixCache)):
        a = alloc_cls(4)
        with pytest.raises(ValueError, match="FULL pages"):
            cache_cls(4, a).insert([1, 2, 3], a.alloc(1))


def test_page_hash_chain_and_digest_match():
    toks = list(np.random.default_rng(7).integers(0, 50, size=37))
    assert page_hash_chain(toks, 8) == jax_page_hash_chain(toks, 8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_clone_pages_cow_never_mutates_source_fp_and_int8(int8):
    """``clone_pages`` moves codes and scale cells together, bitwise the
    reference's; writing the clone leaves the source as it was."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(1, 16, 2, 4)).astype(np.float32)
    v = rng.normal(size=(1, 16, 2, 4)).astype(np.float32)
    jdt, tdt = ("int8", torch.int8) if int8 else (jnp.float32, torch.float32)
    js = jkv.prefill_paged_cache(
        jkv.create_paged_cache(2, 1, 16, 2, 4, page_size=8, dtype=jdt), 1,
        jnp.asarray(k), jnp.asarray(v), jnp.full((1,), 16, jnp.int32))
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales")
                                      if int8 else ())
    jc = jkv.create_paged_cache(2, 1, 16, 2, 4, page_size=8, extra_pages=2,
                                dtype=jdt)
    jc = jc._replace(**{n: getattr(jc, n).at[:, :, :2].set(
        getattr(js, n)[:, :, :2]) for n in names})
    tc = tkv.create_paged_cache(2, 1, 16, 2, 4, page_size=8, extra_pages=2,
                                dtype=tdt)
    for n in names:
        getattr(tc, n).copy_(torch.from_numpy(np.array(getattr(jc, n))))
    before = {n: getattr(tc, n)[:, :, 1].clone() for n in names}
    jc = jkv.clone_pages(jc, [1], [2])
    tc = tkv.clone_pages(tc, [1], [2])
    for n in names:
        np.testing.assert_array_equal(getattr(tc, n).numpy(),
                                      np.asarray(getattr(jc, n)))
        assert torch.equal(getattr(tc, n)[:, :, 2], before[n])
        getattr(tc, n)[:, :, 2] = 0
        assert torch.equal(getattr(tc, n)[:, :, 1], before[n])


def test_identity_prompt_write_refuses_nonidentity_pool():
    cache = tkv.create_paged_cache(1, 2, 16, 2, 4, page_size=8,
                                   extra_pages=3)
    assert cache.k_pages.shape[2] == 7
    assert cache.block_tables.tolist() == np.asarray(
        jkv.create_paged_cache(1, 2, 16, 2, 4, page_size=8,
                               extra_pages=3).block_tables).tolist()
    k = torch.zeros((2, 16, 2, 4))
    with pytest.raises(ValueError, match="identity-layout"):
        tkv.prefill_paged_cache(cache, 0, k, k, torch.full((2,), 4))
    with pytest.raises(ValueError, match="total_pages"):
        tkv.create_paged_cache(1, 2, 16, 2, 4, page_size=8, total_pages=0)
    under = tkv.create_paged_cache(1, 2, 16, 2, 4, page_size=8,
                                   total_pages=3)
    assert under.block_tables.tolist() == np.asarray(
        jkv.create_paged_cache(1, 2, 16, 2, 4, page_size=8,
                               total_pages=3).block_tables).tolist()


def _lifecycle(alloc_cls, cache_cls, steps=300):
    """The reference's randomized lifecycle (simulated slots match,
    attach, insert and release on a small pool under eviction pressure),
    recording every result and, after each operation, the refcounts, the
    free list and the tree's pages."""
    rng = np.random.default_rng(42)
    P, N_PAGES = 4, 24
    alloc = alloc_cls(N_PAGES)
    pc = cache_cls(P, alloc)
    live: dict = {}
    trace = []
    for step in range(steps):
        op = rng.random()
        if op < 0.5 and len(live) < 6:
            n_tok = int(rng.integers(P, 5 * P))
            toks = [int(t) for t in rng.integers(0, 6, size=n_tok)]
            m_len, m_pages = pc.match(toks)
            need = -(-n_tok // P) - len(m_pages)
            priv = alloc.alloc(need)
            ev = None
            if priv is None:
                ev = pc.evict(need - alloc.available())
                priv = alloc.alloc(need)
            trace.append(("admit", m_len, list(m_pages), ev, priv))
            if priv is None:
                continue
            alloc.retain(m_pages)
            pages = list(m_pages) + priv
            for pg in priv:
                assert int(alloc.refcount[pg]) == 1
            live[step] = (toks, pages)
            n_full = n_tok // P
            if n_full:
                trace.append(("insert", pc.insert(toks[:n_full * P],
                                                  pages[:n_full])))
        elif op < 0.85 and live:
            slot = list(live)[int(rng.integers(len(live)))]
            trace.append(("release", sorted(alloc.release(
                live.pop(slot)[1]))))
        elif pc.n_nodes:
            trace.append(("evict", pc.evict(int(rng.integers(1, 4)))))
        alloc.check()
        trace.append((alloc.refcount.tolist(), list(alloc._free),
                      sorted(pc.pages()), pc.n_nodes))
    for _, pages in live.values():
        alloc.release(pages)
    trace.append(("evict_all", pc.evict_all(), alloc.available()))
    return trace


def test_property_lifecycle_matches_the_reference_step_for_step():
    got = _lifecycle(tkv.PageAllocator, PrefixCache)
    want = _lifecycle(jkv.PageAllocator, JaxPrefixCache)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert got[-1] == ("evict_all", got[-1][1], 24)


# ---------------------------------------------------- engine: sharing


def test_shared_prefix_prefills_once_and_exact(pair):
    """N requests sharing a 64-token prefix prefill it once, on both
    sides; tokens and stats equal the reference's with the cache on and
    off, and the cache changes no token."""
    jmodel, tmodel = pair
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 128, size=64).astype(np.int32)
    subs = [(np.concatenate([shared, rng.integers(0, 128, size=2).astype(
        np.int32)]), 4, 0 if i == 0 else 12) for i in range(16)]
    kw = dict(max_batch=2, max_seq=72, segment=4, page_size=8)
    on, on_done, ports, rids = serve_pair(jmodel, tmodel, subs, **kw)
    off, off_done, _, _ = serve_pair(jmodel, tmodel, subs,
                                     prefix_caching=False, **kw)
    for r in rids:
        assert on_done[r].output_ids == off_done[r].output_ids
    teng, tdone = ports[0]
    assert [tdone[r].prefix_len for r in rids] == [0] + [64] * 15
    st = teng.stats
    assert st["prefill_tokens_admitted"] == 66 + 15 * 2
    assert st["prefix_hits"] == 15 and st["pages_saved"] == 15 * 8
    pager = teng._prefix.allocator
    pager.check()
    assert sum(int(r) for r in pager.refcount) == len(teng._prefix.pages())


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_cow_divergence_after_shared_prefix(pair, q8, stack):
    """A full-prompt match clones its last page before recomputing its
    last token (codes and scale cells), and the original's running decode
    sees no changed byte: tokens and stats as the reference's."""
    jmodel, tmodel = pair
    jkw, tkw = stack_kw(stack, *q8)
    rng = np.random.default_rng(2)
    base = rng.integers(0, 128, size=16).astype(np.int32)
    div = np.concatenate([base, rng.integers(0, 128, size=2).astype(
        np.int32)])
    subs = [(base, 12, 0), (base, 4, 3), (div, 4, 3)]
    _, _, ports, _ = serve_pair(jmodel, tmodel, subs, jkw=jkw, tkw=tkw,
                                max_batch=2, max_seq=48, segment=3,
                                page_size=8)
    st = ports[0][0].stats
    assert st["prefix_cow_clones"] >= 1 and st["prefix_hits"] >= 2


def test_full_prompt_match_still_emits_first_token(pair):
    jmodel, tmodel = pair
    p = np.random.default_rng(3).integers(0, 128, size=24).astype(np.int32)
    _, _, ports, rids = serve_pair(jmodel, tmodel, [(p, 4, 0), (p, 1, 8)],
                                   max_batch=1, max_seq=32, segment=2,
                                   page_size=8)
    teng, tdone = ports[0]
    assert len(tdone[rids[1]].tokens) == 1
    assert tdone[rids[1]].chunk_starts == [23]
    assert teng.stats["prefix_cow_clones"] == 1
    assert teng.stats["prefill_tokens_admitted"] == len(p) + 1


# ------------------------------------- engine: pressure + flag contract


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_eviction_under_pressure_keeps_parity(pair, q8, stack):
    jmodel, tmodel = pair
    jkw, tkw = stack_kw(stack, *q8)
    rng = np.random.default_rng(4)
    subs = [(rng.integers(0, 128, size=24).astype(np.int32), 6, 0)
            for _ in range(5)]
    _, _, ports, _ = serve_pair(jmodel, tmodel, subs, jkw=jkw, tkw=tkw,
                                max_batch=2, max_seq=32, segment=2,
                                page_size=8, prefix_pages=2)
    teng = ports[0][0]
    assert teng._prefix.stats["evictions"] > 0
    assert teng.stats["cache_full_deferrals"] == 0


def test_under_provisioned_pool_defers_cleanly(pair):
    jmodel, tmodel = pair
    rng = np.random.default_rng(5)
    a = rng.integers(0, 128, size=24).astype(np.int32)
    c = rng.integers(0, 128, size=24).astype(np.int32)
    _, _, ports, _ = serve_pair(jmodel, tmodel, [(a, 6, 0), (c, 6, 2)],
                                max_batch=2, max_seq=32, segment=2,
                                page_size=8, page_pool_pages=6)
    assert ports[0][0].stats["cache_full_deferrals"] > 0


def test_match_survives_eviction_pressure_pool_equals_pps(pair):
    jmodel, tmodel = pair
    p = np.random.default_rng(8).integers(0, 128, size=24).astype(np.int32)
    _, _, ports, _ = serve_pair(jmodel, tmodel, [(p, 6, 0), (p, 6, 8)],
                                max_batch=1, max_seq=32, segment=2,
                                page_size=8, page_pool_pages=4)
    ports[0][0]._prefix.allocator.check()


@pytest.mark.parametrize("kw,match", [
    (dict(ragged=False, prefix_caching=True), "prefix_caching requires"),
    (dict(prefix_caching=False, page_pool_pages=4), "page_pool_pages needs"),
    (dict(max_seq=64, page_size=8, page_pool_pages=4),
     "page_pool_pages must be"),
    (dict(prefix_pages=-1), "prefix_pages must be"),
])
def test_flag_and_ctor_contract(pair, kw, match):
    jmodel, tmodel = pair
    for cls, m in ((JaxBatcher, jmodel), (ContinuousBatcher, tmodel)):
        with pytest.raises(ValueError, match=match):
            cls(m, max_batch=1, **kw)


def test_the_flag_resolves_the_default(pair):
    jmodel, tmodel = pair
    assert ContinuousBatcher(tmodel, max_batch=1)._prefix_caching is True
    tflags.set_flags({"prefix_caching": False})
    jflags.set_flags({"prefix_caching": False})
    try:
        assert not ContinuousBatcher(tmodel, max_batch=1)._prefix_caching
        assert not JaxBatcher(jmodel, max_batch=1)._prefix_caching
    finally:
        tflags.set_flags({"prefix_caching": True})
        jflags.set_flags({"prefix_caching": True})
