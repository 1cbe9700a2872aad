"""Sampling: the PyTorch port vs the JAX package, on the CPU.

The port splits the JAX package's ``_sample_from_logits`` in two:

  * ``_filter_logits``, the temperature / top-k / nucleus filter, held
    BITWISE against the logits the reference hands to
    ``jax.random.categorical`` (recorded by patching it, in this test only,
    while the reference's function runs eagerly): the same kept set and the
    same bits in every kept entry, over seeded rows with and without ties,
    at every (temperature, top_k, top_p) of the grid. The nucleus cut
    compares a softmax cumsum with ``top_p``, and XLA and PyTorch round
    those sums differently: a row whose cut lies within 1e-6 of ``top_p``
    (the exclusive cumulative mass, in float64, at some column) is
    excluded and counted; at most a quarter of a case's rows may be;
  * the draw, Gumbel-max from a torch generator (a Philox stream cannot
    reproduce ``jax.random``): over 200,000 draws on a fixed row the
    counts must match the filtered softmax by a chi-square test at
    p = 1e-6, with no draw outside the kept set; a temperature 10% off and
    a nucleus cut moved by one column must fail the same test.

End to end, on the JAX package's prefix-cache test model bridged into the
port: ``top_k=1`` and ``top_p <= 0`` give the reference's greedy tokens,
solo ``generate_paged`` and the batcher, fp and int8w+int8kv; the same
seed gives the same tokens; the reference's own sampling cases
(``tests/test_paged_attention.py``, ``test_continuous_batching.py``,
``test_ragged_batching.py``) hold on the port.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.llama as jllama
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher

from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models.llama import (_filter_logits, _gumbel_argmax,
                                           _sample_from_logits)

from torch_batcher_pairs import build_pair, int8_params

V = 96
ROWS = 48
NEG = np.float32(-1e30)
TEMPERATURES = (0.5, 1.0, 1.7)
TOP_KS = (None, 1, 5, V)
TOP_PS = (None, 0.0, 0.3, 0.9, 1.0)
#: a row whose cut lies this close to top_p is excluded from the bitwise
#: comparison (the two sides' softmax and cumsum round differently)
CUT_MARGIN = 1e-6
#: the chi-square test's significance
ALPHA = 1e-6
N_DRAWS = 200_000


def _rows(seed):
    """ROWS seeded f32 logit rows: plain normal rows, rows with pairs of
    equal entries, and rows on a coarse grid (many ties, at the top too)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(ROWS, V)) * 3).astype(np.float32)
    third = ROWS // 3
    for r in range(third, 2 * third):
        for _ in range(8):
            i, j = rng.integers(0, V, size=2)
            x[r, j] = x[r, i]
    x[2 * third:] = np.round(x[2 * third:] * 2) / 2
    return x


def _reference_filtered(logits, t, top_k, top_p):
    """The logits the JAX package's ``_sample_from_logits`` hands to
    ``jax.random.categorical`` (recorded by patching it)."""
    seen = []
    orig = jax.random.categorical

    def record(key, lg, axis=-1, **kw):
        seen.append(np.asarray(lg))
        return orig(key, lg, axis=axis, **kw)

    jax.random.categorical = record
    try:
        jllama._sample_from_logits(jnp.asarray(logits),
                                   jax.random.PRNGKey(0), t, top_k, top_p)
    finally:
        jax.random.categorical = orig
    assert len(seen) == 1
    return seen[0]


def _near_cut(logits, t, top_k, top_p):
    """Rows whose nucleus cut lies within CUT_MARGIN of top_p: the
    exclusive cumulative mass (float64, after the f32 temperature and
    top-k filter) at some column past the first is that close to
    top_p."""
    if top_p is None or top_p >= 1.0:
        return np.zeros(len(logits), bool)
    x = torch.as_tensor(logits).float() / torch.tensor(
        max(t, 1e-6), dtype=torch.float32)
    if top_k:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, torch.tensor(-1e30), x)
    x = torch.sort(x.double(), dim=-1, descending=True).values
    p = torch.softmax(x, dim=-1)
    excl = torch.cumsum(p, dim=-1) - p
    # column 0 is kept whatever its mass; a column the top-k filter
    # dropped stays -1e30 either way
    near = ((excl - top_p).abs() < CUT_MARGIN) & (p > 0)
    return near[:, 1:].any(dim=-1).numpy()


CASES = list(itertools.product(TEMPERATURES, TOP_KS, TOP_PS))


@pytest.mark.parametrize("t,top_k,top_p", CASES,
                         ids=[f"t{t}-k{k}-p{p}" for t, k, p in CASES])
def test_filter_is_bitwise_the_reference(t, top_k, top_p):
    logits = _rows(int(t * 10) + 7 * (top_k or 0))
    want = _reference_filtered(logits, t, top_k, top_p)
    got = _filter_logits(torch.as_tensor(logits), t, top_k, top_p).numpy()
    skip = _near_cut(logits, t, top_k, top_p)
    print(f"t={t} top_k={top_k} top_p={top_p}: {int(skip.sum())} of "
          f"{ROWS} rows within {CUT_MARGIN} of the cut, excluded")
    assert skip.sum() <= ROWS // 4
    g, w = got[~skip], want[~skip]
    assert np.array_equal(g != NEG, w != NEG), "kept sets differ"
    assert np.array_equal(g.view(np.int32), w.view(np.int32)), \
        "kept values differ in their bits"


def test_filter_keeps_the_ties_the_reference_keeps():
    """A top-k cut inside a run of equal values keeps the whole run, and
    the nucleus cut orders ties by index (the stable descending sort)."""
    row = np.array([[3.0, 1.0, 2.0, 2.0, 2.0, 0.5, 2.0, -1.0]], np.float32)
    for top_k, top_p in ((2, None), (3, None), (None, 0.5), (None, 0.9),
                         (4, 0.7)):
        want = _reference_filtered(row, 1.0, top_k, top_p)
        got = _filter_logits(torch.as_tensor(row), 1.0, top_k, top_p)
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), (top_k, top_p)


def _chi_square(draws, probs):
    """(statistic, the bound at ALPHA, draws outside the kept set)."""
    counts = np.bincount(draws, minlength=len(probs)).astype(np.float64)
    kept = probs > 0
    exp = probs[kept] * len(draws)
    stat = float(((counts[kept] - exp) ** 2 / exp).sum())
    bound = float(scipy.stats.chi2.ppf(1 - ALPHA, int(kept.sum()) - 1))
    return stat, bound, int(counts[~kept].sum())


def _draw(filtered, seed):
    gen = torch.Generator().manual_seed(seed)
    return _gumbel_argmax(filtered.expand(N_DRAWS, -1), gen).numpy()


def test_draws_follow_the_filtered_softmax():
    """Draw frequencies against the filtered softmax: the chi-square
    passes; a 10%-off temperature and a nucleus cut one column short fail
    it."""
    t, top_k, top_p = 0.9, 24, 0.9
    row = torch.as_tensor(np.random.default_rng(3).normal(
        size=(1, 48)).astype(np.float32))
    filt = _filter_logits(row, t, top_k, top_p)
    probs = torch.softmax(filt.double(), -1)[0].numpy()
    probs[filt[0].numpy() == NEG] = 0.0
    n_kept = int((probs > 0).sum())
    assert 3 < n_kept < top_k
    stat, bound, outside = _chi_square(_draw(filt, 0), probs)
    print(f"chi-square {stat:.1f} against {bound:.1f} ({n_kept - 1} df), "
          f"{outside} draws outside the kept set")
    assert outside == 0 and stat <= bound

    # control 1: the temperature 10% off
    hot = _filter_logits(row, t * 1.1, top_k, top_p)
    stat_t, _, out_t = _chi_square(_draw(hot, 0), probs)
    # control 2: the nucleus cut one column short (the kept column of the
    # least logit dropped)
    short = filt.clone()
    kept = (filt[0] != NEG).nonzero()[:, 0]
    short[0, kept[filt[0, kept].argmin()]] = float(NEG)
    stat_c, _, out_c = _chi_square(_draw(short, 0), probs)
    print(f"controls: temperature x1.1 {stat_t:.1f} ({out_t} outside), "
          f"cut one column short {stat_c:.1f} ({out_c} outside)")
    assert stat_t > bound or out_t > 0
    assert stat_c > bound or out_c > 0


def test_sample_from_logits_filters():
    """The reference's filter cases (``tests/test_paged_attention.py``)."""
    logits = torch.tensor([[10.0, 9.0, -5.0, -5.0]] * 4)
    gen = torch.Generator().manual_seed(0)
    assert (_sample_from_logits(logits, gen, 0.01) == 0).all()
    assert (_sample_from_logits(logits, gen, 5.0, top_k=1) == 0).all()
    assert (_sample_from_logits(logits, gen, 1.0, top_p=0.1) == 0).all()
    draws = {int(t) for k in range(40) for t in _sample_from_logits(
        logits[:1], torch.Generator().manual_seed(k), 3.0)}
    assert {0, 1} <= draws          # both likely tokens are reachable


def test_greedy_cases_are_exactly_argmax():
    """``top_p <= 0`` keeps only the first maximum, and ``top_k=1`` every
    entry equal to the maximum (as the reference's top-k filter does), so
    the Gumbel draw returns the argmax on every row, and with ``top_k=1``
    on every row whose maximum is not tied."""
    x = torch.as_tensor(_rows(11))
    gen = torch.Generator().manual_seed(1)
    want = torch.argmax(x, dim=-1).to(torch.int32)
    single = (x == x.amax(-1, keepdim=True)).sum(-1) == 1
    assert 0 < int(single.sum()) < ROWS
    for kw in (dict(top_k=1), dict(top_p=0.0), dict(top_p=-0.5),
               dict(top_k=5, top_p=0.0)):
        rows = single if kw == dict(top_k=1) else torch.ones_like(single)
        for _ in range(5):
            got = _sample_from_logits(x, gen, 1.3, **kw)
            assert torch.equal(got[rows], want[rows]), kw


# --------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def qpair(pair):
    return int8_params(*pair)


def _prompts(seed, n=3, lo=5, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _stack(stack, qpair):
    if stack == "fp":
        return {}, {}
    jq, tq = qpair
    return (dict(params=jq, cache_dtype="int8"),
            dict(params=tq, cache_dtype="int8"))


GREEDY_KW = (dict(top_k=1), dict(top_p=0.0), dict(top_k=3, top_p=-1.0))


@pytest.mark.parametrize("stack", ("fp", "int8"))
def test_solo_greedy_cases_match_the_reference(pair, qpair, stack):
    jmodel, tmodel = pair
    jkw, tkw = _stack(stack, qpair)
    ids = np.random.default_rng(4).integers(0, 128, (2, 9)).astype(np.int32)
    want = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=7, page_size=8,
        **jkw)._array)
    for kw in GREEDY_KW:
        got = tmodel.generate_paged(ids, 7, 8, temperature=0.8, seed=5,
                                    **kw, **tkw)
        assert np.array_equal(got.numpy(), want), kw
    # the reference's own sampled run at top_k=1 is greedy too
    ref = np.asarray(jmodel.generate_paged(
        paddle.to_tensor(ids), max_new_tokens=7, page_size=8,
        temperature=0.8, top_k=1, seed=5, **jkw)._array)
    assert np.array_equal(ref, want)


@pytest.mark.parametrize("stack", ("fp", "int8"))
def test_batcher_greedy_cases_match_the_reference(pair, qpair, stack):
    jmodel, tmodel = pair
    jq, tq = qpair
    jkw, tkw = ({}, {}) if stack == "fp" else (
        dict(quantized_params=jq, cache_dtype="int8"),
        dict(quantized_params=tq, cache_dtype="int8"))
    prompts = _prompts(9, n=4)
    eng = JaxBatcher(jmodel, max_batch=2, max_seq=48, page_size=8,
                     segment=4, **jkw)
    rids = [eng.submit(p, 6, arrival_segment=a)
            for p, a in zip(prompts, (0, 0, 1, 3))]
    done = eng.run()
    want = [done[r].tokens for r in rids]
    for kw in GREEDY_KW:
        eng = ContinuousBatcher(tmodel, max_batch=2, max_seq=48,
                                page_size=8, segment=4, temperature=0.8,
                                seed=2, **kw, **tkw)
        rids = [eng.submit(p, 6, arrival_segment=a)
                for p, a in zip(prompts, (0, 0, 1, 3))]
        done = eng.run()
        assert [done[r].tokens for r in rids] == want, kw


def test_same_seed_same_tokens(pair):
    _, tmodel = pair
    ids = np.random.default_rng(6).integers(0, 128, (3, 7)).astype(np.int32)
    kw = dict(temperature=1.0, top_k=40, top_p=0.95)
    a = tmodel.generate_paged(ids, 8, 8, seed=1, **kw)
    b = tmodel.generate_paged(ids, 8, 8, seed=1, **kw)
    c = tmodel.generate_paged(ids, 8, 8, seed=2, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)

    def serve(seed):
        eng = ContinuousBatcher(tmodel, max_batch=2, max_seq=48,
                                page_size=8, segment=4, seed=seed, **kw)
        rids = [eng.submit(p, 6) for p in _prompts(10)]
        done = eng.run()
        return [done[r].tokens for r in rids], eng.stats["host_sync_count"]

    (t1, s1), (t2, s2), (t3, _) = serve(3), serve(3), serve(4)
    assert t1 == t2 and t1 != t3
    # sampling adds no host sync: the greedy engine's count
    greedy = ContinuousBatcher(tmodel, max_batch=2, max_seq=48, page_size=8,
                               segment=4)
    for p in _prompts(10):
        greedy.submit(p, 6)
    greedy.run()
    assert s1 == greedy.stats["host_sync_count"]


def test_sampled_tokens_are_in_the_kept_sets(pair):
    """Every sampled token lies in the kept set of the logits it was drawn
    from (``return_logits``)."""
    _, tmodel = pair
    ids = np.random.default_rng(12).integers(0, 128, (4, 6)).astype(np.int32)
    t, k, p = 0.8, 10, 0.7
    out, logits = tmodel.generate_paged(ids, 10, 8, temperature=t, top_k=k,
                                        top_p=p, seed=9, return_logits=True)
    toks = out[:, 6:].long()
    filt = _filter_logits(logits, t, k, p)
    assert bool((filt.gather(-1, toks[..., None]) > -1e29).all())
    assert not torch.equal(out[:, 6:], logits.argmax(-1).to(torch.int32))


def test_reference_sampling_cases_on_the_port(pair):
    """``tests/test_paged_attention.py``'s solo case and
    ``test_continuous_batching.py`` / ``test_ragged_batching.py``'s engine
    cases, on the port."""
    _, tmodel = pair
    ids = np.random.default_rng(0).integers(0, 128, (2, 6)).astype(np.int32)
    greedy = tmodel.generate_paged(ids, max_new_tokens=6)
    topk1 = tmodel.generate_paged(ids, max_new_tokens=6, temperature=1.0,
                                  top_k=1, seed=3)
    assert torch.equal(topk1, greedy)
    s1 = tmodel.generate_paged(ids, max_new_tokens=6, temperature=1.0,
                               seed=1)
    assert torch.equal(s1, tmodel.generate_paged(
        ids, max_new_tokens=6, temperature=1.0, seed=1))
    for seed in (7, 5):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, 128, size=6).astype(np.int32)
                   for _ in range(3)]
        g = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, segment=2)
        g_rids = [g.submit(q, 5) for q in prompts]
        g_done = g.run()
        s = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, segment=2,
                              temperature=1.0, top_k=1, seed=11)
        s_rids = [s.submit(q, 5) for q in prompts]
        s_done = s.run()
        for gr, sr in zip(g_rids, s_rids):
            assert g_done[gr].output_ids == s_done[sr].output_ids
    prompt = np.random.default_rng(8).integers(0, 128, size=6).astype(
        np.int32)

    def run_once(seed):
        eng = ContinuousBatcher(tmodel, max_batch=1, max_seq=32, segment=2,
                                temperature=1.0, seed=seed)
        rid = eng.submit(prompt, 6)
        return eng.run()[rid].tokens

    assert run_once(5) == run_once(5)


def test_sampling_contracts(pair):
    _, tmodel = pair
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="greedy"):
        tmodel.generate_paged(ids, 4, temperature=0.7, spec_decode=True)
    with pytest.raises(ValueError, match="greedy"):
        ContinuousBatcher(tmodel, max_batch=2, max_seq=32, temperature=0.7,
                          spec_decode=True)
    # the flag-driven spec default stands down under sampling
    eng = ContinuousBatcher(tmodel, max_batch=2, max_seq=32, temperature=0.7)
    assert not eng._spec and eng.sampling == (0.7, None, None)
