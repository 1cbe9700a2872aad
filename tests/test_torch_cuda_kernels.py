"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
``gen`` fixture, never at import). Run on a GPU host with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda

(``--noconftest``: the root conftest imports JAX, which a GPU host need
not have; this file imports only torch and the port.)

chip_smoke.py checks the kernels at the Llama-3-8B serving shapes; these
cases cover the edges those shapes do not reach: ragged M, N and sequence
lengths, Sk > Sq, every GQA group size the kernels take, a cache position
on a page boundary and at the capacity's last cell, and the wrappers'
refusals (a kernel's wrapper, and the fusion executor when a flag turns
a fusion off). The weight-only forms (K4, K2 with int8/int4 weights, K3
on an int8 cache) run at M = 1, 5, 8, 9, 16, 17, 300 and 1024, per channel
and group-wise, at pages 16 and 32 and lengths 0 and on page boundaries;
the small-M body (M <= 16, K2 dense and quantized, K4) at M in both MMA
buckets, N off its 64-wide tile and at the decode widths, and K of one
slice, 4096 and 14336 (K split over clusters of up to 8 ranks); the tiled
(M > 16) form of K2 and K4 also with M, N and K all off its tiles (K
wrapping its ring several times); both bodies two calls bitwise equal in
every form, from a fresh thread, and with the work their CTAs decode
equal to the Python model (``quant_matmul.quant_tiles``,
``quant_matmul.small_items``). Tolerances as in
chip_smoke.py: one bf16 output rounding plus f32 summation-order
differences (K4: ``quant_matmul.tolerance``, derived from the inputs);
pool cells bit-exact, int8 codes within 1 with the differing ones counted.
The batcher's kernels — K10 (paged decode attention), K11 (ragged
two-source attention) and K3's ragged and masked forms — run on waves
that mix decode rows, chunks with and without page context, slots with
no rows and padding rows (the ragged forms on the edge waves of
``tests/ragged_wave_cases.py``, at GQA groups 1, 2, 4 and 8, pages 16
and 32, two calls bitwise equal, and the items their CTAs decode equal to
``ragged_paged_attention.ragged_items``); their pools must be
bit-identical to the plain chain's and every other cell untouched. On an
int8 cache (codes with an f32 scale a cell) K10, K11 and K3's ragged
form run the same waves and lengths: within the attention tolerance,
rows of no segment zeros, K3's written codes within 1 of the plain
chain's and its scales equal, two calls bitwise equal, the int8 plans'
cluster sizes equal to ``ragged_plan``, the dropped-range controls of
the split walks failing, and a page that is not a multiple of 4 (or a
scale pool of the wrong type or missing) refused; walks long enough to
wrap a CTA's ring of stages (bf16 and int8) give the same bits in many
calls. K11 and K3's ragged form on a speculative verify wave with
``fresh_pool_read`` (verify segments of 1 + 4 and of 1 rows beside an
unflagged chunk): within the attention tolerance of the plain versions
with the pool roundtrip, on a bf16 cache bitwise equal to the unflagged
call, on an int8 cache moving the flagged rows only; two calls bitwise
equal; a malformed flag refused. Each serving attention
wrapper raises on a q that requires grad with grad enabled and launches
under ``torch.no_grad()``. The
page walk K10 and K3's decode forms share (split over a cluster of CTAs)
also runs at caps up to 640 with lengths on page and range edges (K3's
own cell opening its CTA's range, an inactive slot), each form two calls
bitwise equal, and the (rank, page range) items its CTAs decode equal to
``paged_attention.walk_items`` for clusters of 1, 2, 4 and 8.
The prefix cache's table-routed pool: K11, K3's ragged form (with and
without ``fresh_pool_read``), K3's masked form and K10, bf16 and int8, on
a permuted table whose two slots share their first pages, whose empty
slot's row is the park page and whose unreferenced page holds NaN: within
the attention tolerance of the plain versions, every output finite, the
park page and the shared pages bitwise unchanged; ``clone_pages`` and the
pinned ``HostPageArena`` store/load bitwise; and ``ContinuousBatcher``
with default flags serving a shared-prefix workload.
The training kernels: K5 (flash backward) at sequence lengths that are not
multiples of its 64-row tiles, GQA groups 1, 4 and 8, Sk > Sq and Sq > Sk,
causal and not, two calls bitwise equal; K6/K7 (RMSNorm
forward/backward) at row counts that are not multiples of K7's 32-row
blocks; K8 (AdamW8bit) at 1, 2047 and 2049 elements and on a block of zero
grads (the 1e-30 scale floor), with a master, on an f32 param and on a bf16
param without one, over 3 steps: codes, scales and params bit-identical to
the plain version on the card. Their wrappers, the autograd entries and the
train fusion executor launch or raise.
K1 (flash forward) at query and key tile edges, Sq < Sk and Sq > Sk,
causal and not, with and without a key bias; with whole key tiles a bias
masks in one row and not another (the skipped and computed tiles meet,
rows that see no key included); two calls bitwise equal. K2's dense tiled
path (the wgmma body) at M = 17 .. 8192 against ragged N and N = 1024,
4096 and 14336, two calls bitwise equal, from a fresh thread, and with the
tiles its blocks decode equal to ``quant_matmul.quant_tiles``.
K9 (the one-pass flash backward) on the same shapes as K5, two calls
bitwise equal; K1, K5 and K9 with a left-padded key bias (whole key tiles
masked in one row and not in another, so skipped and computed tiles meet),
rows that see no key included
(dO not 0 there: every output and gradient within the tolerance of the
plain version, which follows the JAX package's reference lowering on
such rows); K12 (rope) forward and its transposed instance (the
backward, one launch) bit-identical to the plain version in bf16 and f32,
at D/2 on both sides of the 16-byte vector, odd half-widths, and the
train step's q and k, two calls bitwise equal, and the training attend
seam's output and gradients bit-identical to the f32 chain; the
gradient clip's f32 scaling bit-identical to the CPU's and to numpy's.
K13's int8/int4 forms (per channel, group 64 and 128) on the same
routings (K 128, N 144 where K13's bf16 cases leave K % 128 or N % 16),
within ``grouped_matmul.quant_tolerance`` with a shifted-scale control
failing it, the items their blocks decode at 256 and 128 columns equal
to ``gmm_items``, two calls bitwise equal, from a fresh thread, their
autograd dx (the dequantized stack through K13's transposed form)
against the plain rule, a quantized MoE's launches against its plan, and
the wrapper's refusals. The MoE kernels: K13 (grouped matmul) in both forms and K14 (segment dW,
f32 and bf16 outputs, with a scale) on uneven group offsets with an empty
first, middle or last group, one group holding every row, boundaries and
row counts that are not multiples of the 128-row tile, and K and N that
are not multiples of the 32- and 128-wide slices (tolerances from the
inputs: ``grouped_matmul.tolerance``, ``dw_tolerance``); K14's empty
groups exactly zero; the step walk the kernels compute on the card equal
to ``group_tile_walk``; the work items the kernels decode on the card
equal to the Python model (``gmm_items``, ``sdw_items``); groups of 1,
63, 65 and 4,915 rows with more items than two per SM of the
persistent grid; each form's two calls bitwise equal; the autograd
entry's gradients against its plain version; a small MoE train step
whose launches equal its plan; and the wrappers' refusals (the
``grouped_matmul_kernel`` flag or the ``moe_grouped_bwd`` family off,
wrong dtype, shape or offsets, an operand not on a 16-byte boundary).
"""

from __future__ import annotations

import math

import pytest
import torch

from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.models import kv_cache
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import fused_norm_matmul as k2
from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
from paddle_tpu_torch.ops.kernels import fused_optimizer_update as k8
from paddle_tpu_torch.ops.kernels import fused_rope_attend as k3
from paddle_tpu_torch.ops.kernels import fusion
from paddle_tpu_torch.ops.kernels import grouped_matmul as k1314
from paddle_tpu_torch.ops.kernels import paged_attention as k10
from paddle_tpu_torch.ops.kernels import quant_matmul as k4
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11
from paddle_tpu_torch.ops.extra_vision import _weight_quantize_pure

from ragged_wave_cases import edge_waves, layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on a GPU host with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


@pytest.mark.parametrize("b,sq,sk,h,hk", [
    (1, 64, 64, 1, 1), (2, 100, 100, 8, 2), (1, 128, 300, 4, 4),
    (3, 37, 37, 8, 1), (1, 200, 200, 16, 8)])
def test_flash_attention_fwd_matches_plain(gen, b, sq, sk, h, hk):
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    out, lse = k1.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= k1.fwd_tolerance(q, k, v, ref, causal=True)).all())
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_attention_fwd_not_causal(gen):
    q, k, v = (_randn(gen, 2, 96, 4, 128) for _ in range(3))
    out, _ = k1.flash_attention_fwd(q, k, v, causal=False)
    ref, _ = k1.flash_attention_fwd_reference(q, k, v, causal=False)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= k1.fwd_tolerance(q, k, v, ref)).all())


# K1 at tile edges: Sq, Sk not multiples of the 128-row query tiles or the
# 64-key tiles, Sq < Sk and Sq > Sk (queries before the first key), causal
# and not, GQA groups 1, 2 and 4, with and without a left-padded key bias
_FWD_EDGES = [
    (1, 129, 129, 4, 1, True, None), (2, 200, 333, 8, 2, True, (0, 100)),
    (1, 255, 130, 4, 4, False, None), (2, 130, 257, 8, 4, False, (65, 0)),
    (1, 300, 100, 4, 2, True, None), (2, 300, 100, 4, 2, True, (30, 0)),
    (1, 64, 64, 2, 1, True, (63,))]


@pytest.mark.parametrize("b,sq,sk,h,hk,causal,pads", _FWD_EDGES)
def test_flash_attention_fwd_tile_edges_match_plain(gen, b, sq, sk, h, hk,
                                                    causal, pads):
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    bias = None if pads is None else _left_pad_bias(b, sk, pads)[0]
    out, lse = k1.flash_attention_fwd(q, k, v, causal, None, bias)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, causal, None,
                                                    bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    tol = k1.fwd_tolerance(q, k, v, ref, causal, None, bias)
    worst = ((out.float() - ref.float()).abs() / tol).max().item()
    assert worst <= 1.0, f"worst err/tol {worst:.3f}"
    assert (lse - ref_lse).abs().max().item() <= 1e-3


# whole key tiles masked in one row and not in another: skipped and
# computed tiles meet within a query tile, and left-pad rows see no key
_SKIP_CASES = [(2, 384, 384, 8, 2, True, (192, 0)),
               (2, 520, 520, 4, 1, True, (300, 64)),
               (3, 260, 260, 4, 4, False, (128, 0, 256)),
               (2, 200, 450, 8, 1, True, (0, 257))]


@pytest.mark.parametrize("b,sq,sk,h,hk,causal,pads", _SKIP_CASES)
def test_flash_attention_fwd_skipped_tiles_match_plain(gen, b, sq, sk, h,
                                                       hk, causal, pads):
    """K1 leaves out the key tiles a bias masks whole (no switch forces
    them live): the output and lse still hold the plain version's bounds
    on every row, those that see no key included, and the skips happen."""
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    bias, _ = _left_pad_bias(b, sk, pads)
    live = k1._key_tile_live(bias, sk).tolist()
    assert any(0 in row for row in live) and any(1 in row for row in live)
    walks = k1._fwd_walks(b, sq, sk, h, causal, live)
    assert sum(k1._fwd_key_tiles(qt, sq, sk, causal) - len(w)
               for _, _, qt, w in walks) > 0
    out, lse = k1.flash_attention_fwd(q, k, v, causal, None, bias)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, causal, None,
                                                    bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(lse).all())
    tol = k1.fwd_tolerance(q, k, v, ref, causal, None, bias)
    worst = ((out.float() - ref.float()).abs() / tol).max().item()
    assert worst <= 1.0, f"worst err/tol {worst:.3f}"
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert bool((k1._dead_rows(lse) == k1._dead_rows(ref_lse)).all())


@pytest.mark.parametrize("pads", [None, (130, 0)])
def test_flash_attention_fwd_is_deterministic(gen, pads):
    """K1 sums in a fixed order: two calls give the same bits, with and
    without key tiles skipped."""
    b, s, h, hk = 2, 300, 8, 2
    q = _randn(gen, b, s, h, 128)
    k, v = _randn(gen, b, s, hk, 128), _randn(gen, b, s, hk, 128)
    bias = None if pads is None else _left_pad_bias(b, s, pads)[0]
    first = k1.flash_attention_fwd(q, k, v, True, None, bias)
    for _ in range(2):
        again = k1.flash_attention_fwd(q, k, v, True, None, bias)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


#: the small-M body's edges: M in both MMA buckets (n8: 1, 5, 8; n16: 9,
#: 16), N off its 64-wide tile (8, 40, 1000) and the decode widths, K of
#: one slice (cs 1), 4096 (cs 8 at N <= 1024) and K4's down_proj 14336
_SMALL_M = [(m, kdim, n) for m in (1, 5, 8, 9, 16)
            for n in (8, 40, 1000, 1024, 4096) for kdim in (128, 4096, 14336)]


@pytest.mark.parametrize("m,kdim,n", [(5, 256, 40), (16, 512, 1000),
                                      (17, 384, 264), (300, 1024, 520)]
                         + _SMALL_M)
def test_norm_matmul_matches_plain(gen, m, kdim, n):
    """K2 dense against the plain chain; two calls give the same bits (the
    small-M body's split-K sums its ranks in a fixed order)."""
    x = _randn(gen, m, kdim)
    nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    w = _randn(gen, kdim, n, scale=1 / math.sqrt(kdim))
    y = k2.fused_norm_matmul_pure(x, nw, 1e-5, w)
    ref = k2._reference(x, nw, 1e-5, w)
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())
    assert torch.equal(y, k2.fused_norm_matmul_pure(x, nw, 1e-5, w))


@pytest.mark.parametrize("n", [520, 1000, 1024, 4096, 14336])
@pytest.mark.parametrize("m", [17, 129, 264, 300, 1024, 8192])
def test_norm_matmul_tiled_path_matches_plain(gen, m, n):
    """K2's dense tiled path (M > 16: rstd once per row, then the wgmma
    body on 128 x 256 or 128 x 128 tiles) at ragged M and N and at the
    model's N = 1024, 4096 and 14336, K = 4096, up to the train step's
    M = 8192; two calls give the same bits (no split-K)."""
    kdim = 4096
    x = _randn(gen, m, kdim)
    nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    w = _randn(gen, kdim, n, scale=1 / math.sqrt(kdim))
    y = k2.fused_norm_matmul_pure(x, nw, 1e-5, w)
    ref = k2._reference(x, nw, 1e-5, w)
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())
    assert torch.equal(y, k2.fused_norm_matmul_pure(x, nw, 1e-5, w))


# positions on page and walk-range edges at caps up to 640: with B x Hk =
# 28 the walk runs in clusters of 8, whose last rank's range starts at
# cell 48 and 112 for walks of 49 and 113 cells (K3's own cell first in
# its CTA's range), and 639 fills the cache
_LONG_POS = (0, 1, 15, 16, 17, 47, 48, 49, 111, 112, 255, 256, 599, 639)


def _self_at_range_start(lens, hk, page, cap):
    """Whether some slot's own cell (position p, a walk of p + 1 cells)
    opens the range of the last rank of its cluster on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = cap // page
    cs, _ = k10.walk_plan(len(lens), hk, pps, sms)
    return cs > 1 and any(
        k10.walk_range(p + 1, page, pps, cs - 1, cs)[0] * page == p
        for p in lens)


@pytest.mark.parametrize("g,lens", [(1, (0, 15, 16)), (2, (31, 1, 47)),
                                    (8, (5, 32, 40)), (4, _LONG_POS),
                                    (8, _LONG_POS[::-1])])
def test_rope_append_attend_matches_plain(gen, g, lens):
    b, hk, d, page = len(lens), 2, 128, 16
    cap = max(48, -(-(max(lens) + 1) // page) * page)
    if len(lens) > 3:
        assert _self_at_range_start(lens, hk, page, cap)
    cache = kv_cache.create_paged_cache(2, b, cap, hk, d, page,
                                        dtype=torch.bfloat16, device="cuda")
    for pool in (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cache = cache._replace(seq_lens=lens_t)
    q = _randn(gen, b, hk * g, d)
    k, v = _randn(gen, b, hk, d), _randn(gen, b, hk, d)
    cos_t, sin_t = _rope_tables(cap, d, 10000.0, device="cuda")
    cos, sin = cos_t[lens_t.long()], sin_t[lens_t.long()]
    ck = cache._replace(k_pages=cache.k_pages.clone(),
                        v_pages=cache.v_pages.clone())
    cp = cache._replace(k_pages=cache.k_pages.clone(),
                        v_pages=cache.v_pages.clone())
    out, ck = k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck, 1)
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, 1, plain=True)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all())
    assert torch.equal(ck.k_pages, cp.k_pages)
    assert torch.equal(ck.v_pages, cp.v_pages)
    assert torch.equal(ck.k_pages[0], cache.k_pages[0])  # other layer


def test_wrappers_raise_instead_of_falling_back(gen):
    x = _randn(gen, 4, 100)                              # K % 128 != 0
    with pytest.raises(ValueError):
        k2.fused_norm_matmul_pure(x, x[0], 1e-5, _randn(gen, 100, 8))
    x32 = torch.randn((4, 128), device="cuda")            # f32 on the card
    with pytest.raises(ValueError):
        k2.fused_norm_matmul_pure(x32, x32[0], 1e-5,
                                  torch.randn((128, 8), device="cuda"))
    q = _randn(gen, 1, 64, 2, 64)                         # head_dim 64
    with pytest.raises(ValueError):
        k1.flash_attention_fwd(q, q, q, causal=True)
    # the serving attention kernels: a q that requires grad raises with grad
    # enabled (the launch would drop its gradient) and launches under
    # torch.no_grad()
    b, hk, g = 6, 2, 4
    cache, rows, wave = _wave_case(gen, b, hk, g, 16, 64, 48)
    q, k, v, cos, sin = rows
    dec = tuple(x[:b].contiguous() for x in rows)
    lens = cache.seq_lens + 1
    calls = {
        "K10": (k10, "launches", lambda q: k10.paged_attention_pure(
            q[:b].contiguous(), cache.k_pages[0], cache.v_pages[0],
            cache.block_tables, lens)),
        "K11": (k11, "launches", lambda q: k11.ragged_paged_attention_pure(
            q, cache.k_pages[0], cache.v_pages[0], cache.block_tables,
            *wave[3:], k, v)),
        "K3 ragged": (k3, "ragged_launches",
                      lambda q: k3.fused_rope_append_attend(
                          q, k, v, cos, sin, _copy(cache), 0, *wave)),
        "K3 decode": (k3, "launches",
                      lambda q: k3.fused_rope_append_attend_decode(
                          q[:b].contiguous(), *dec[1:], _copy(cache), 0)),
    }
    for what, (mod, counter, call) in calls.items():
        qg = q.clone().requires_grad_()
        n = getattr(mod, counter)
        with pytest.raises(RuntimeError):
            call(qg)
            pytest.fail(f"{what} launched on a q that requires grad")
        assert getattr(mod, counter) == n, what
        with torch.no_grad():
            call(qg)
        assert getattr(mod, counter) == n + 1, what


@pytest.mark.parametrize("fusions", ["rope_append_attend", ""])
def test_fusion_flags_off_raise_on_the_card(gen, fusions):
    """With norm_matmul off, the flag-resolved layer and head plans would
    run plain rms_norm and matmul on the card in place of K2: they raise.
    Only an explicit ``enabled=()`` (the plain reference) runs them."""
    h = 128
    prms = {n: _randn(gen, h, h) for n in ("lm_head.weight",)}
    prms["model.norm.weight"] = torch.ones(h, device="cuda",
                                           dtype=torch.bfloat16)
    hidden = _randn(gen, 2, h)
    old = flags.get_flag("fused_decode_fusions")
    try:
        flags.set_flags({"fused_decode_fusions": fusions})
        with pytest.raises(NotImplementedError):
            fusion.run_lm_head(prms, hidden, 1e-5)
        with pytest.raises(NotImplementedError):
            fusion.run_decoder_layer(prms, 0, hidden, 1e-5, attend=None)
        ref = fusion.run_lm_head(prms, hidden, 1e-5, enabled=())
    finally:
        flags.set_flags({"fused_decode_fusions": old})
    y = fusion.run_lm_head(prms, hidden, 1e-5)           # flags restored: K2
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())


def _qweight(gen, kdim, n, algo, gs):
    w = torch.randn((kdim, n), generator=gen, device="cuda") / math.sqrt(kdim)
    codes, scales = _weight_quantize_pure(w, algo, gs)
    wd = "int4" if algo == "weight_only_int4" else "int8"
    return k4.QuantizedWeight(codes, scales, wd, gs, (kdim, n))


_QUANT = [("weight_only_int8", -1), ("weight_only_int8", 128),
          ("weight_only_int4", -1), ("weight_only_int4", 64)]
#: M, K and N all off the tiled body's 128 x 256 (128) x 64 tiles, K
#: wrapping its 4-stage ring four and a half times
_OFF_TILE = (300, 1152, 784)
#: the small-M body's edges as in ``_SMALL_M``, N rounded up to the codes'
#: multiple of 16 (8 -> 16, 40 -> 48, 1000 -> 1008)
_SMALL_QUANT = [(m, kdim, -(-n // 16) * 16) for m, kdim, n in _SMALL_M]
_QUANT_SHAPES = [(8, 512, 4096), (17, 384, 272), (1024, 1024, 528),
                 _OFF_TILE] + _SMALL_QUANT
#: the small-M body with K split over a cluster of 8 ranks and the n16 bucket
_SMALL_SPLIT = (9, 14336, 1008)


@pytest.mark.parametrize("algo,gs", _QUANT)
@pytest.mark.parametrize("m,kdim,n", _QUANT_SHAPES)
def test_quant_matmul_matches_plain(gen, m, kdim, n, algo, gs):
    qw = _qweight(gen, kdim, n, algo, gs)
    x = _randn(gen, m, kdim)
    y = k4.quant_matmul_qw(x, qw)
    ref = k4.quant_matmul_reference(x, qw.codes, qw.scales, qw.weight_dtype,
                                    qw.group_size)
    torch.cuda.synchronize()
    tol = k4.tolerance(x, qw.codes, qw.scales, qw.weight_dtype,
                       qw.group_size, ref)
    assert bool(((y.float() - ref.float()).abs() <= tol).all())


#: K4's tiled body (M > 16) in its group-wise forms: K of 3 to 18
#: slices, 640 (10 slices: the 4-stage ring wraps off its end; 5 groups of
#: 128, an odd count) and 1152, M and N off the 128 x 128 tiles
_GROUP_WISE_SHAPES = [(17, 384, 272), (129, 640, 144), (300, 1152, 784),
                      (1024, 1024, 528)]


@pytest.mark.parametrize("algo,gs", [(a, g) for a in ("weight_only_int8",
                                                      "weight_only_int4")
                                     for g in (64, 128)])
@pytest.mark.parametrize("m,kdim,n", _GROUP_WISE_SHAPES)
def test_quant_matmul_group_wise_forms_match_plain(gen, m, kdim, n, algo,
                                                   gs):
    """Each K-group's partial sum folded into the total while the next
    group's products run: within K4's tolerance, two calls bitwise equal."""
    qw = _qweight(gen, kdim, n, algo, gs)
    x = _randn(gen, m, kdim)
    y, again = (k4.quant_matmul_qw(x, qw) for _ in range(2))
    ref = k4.quant_matmul_reference(x, qw.codes, qw.scales, qw.weight_dtype,
                                    qw.group_size)
    torch.cuda.synchronize()
    tol = k4.tolerance(x, qw.codes, qw.scales, qw.weight_dtype,
                       qw.group_size, ref)
    assert bool(((y.float() - ref.float()).abs() <= tol).all())
    assert torch.equal(y, again)


@pytest.mark.parametrize("algo,gs", _QUANT)
@pytest.mark.parametrize("m,kdim,n", _QUANT_SHAPES)
def test_norm_matmul_quantized_matches_plain(gen, m, kdim, n, algo, gs):
    """K2 dequantizes exactly as the plain chain does: only the summation
    order differs."""
    qw = _qweight(gen, kdim, n, algo, gs)
    x = _randn(gen, m, kdim)
    nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    y = k2.fused_norm_matmul_pure(x, nw, 1e-5, qw)
    ref = k2._reference(x, nw, 1e-5, qw)
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())


def _quant_forms(gen, algo, gs, shape=_OFF_TILE):
    """K4 and K2 on one quantized weight at ``shape``: the two calls."""
    m, kdim, n = shape
    qw = _qweight(gen, kdim, n, algo, gs)
    x = _randn(gen, m, kdim)
    nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    return {"K4": lambda: k4.quant_matmul_qw(x, qw),
            "K2": lambda: k2.fused_norm_matmul_pure(x, nw, 1e-5, qw)}


@pytest.mark.parametrize("shape", [_OFF_TILE, _SMALL_SPLIT])
@pytest.mark.parametrize("kernel", ["K4", "K2"])
@pytest.mark.parametrize("algo,gs", _QUANT + [("weight_only_int8", 64),
                                              ("weight_only_int4", 128)])
def test_quant_tiled_forms_are_deterministic(gen, kernel, algo, gs, shape):
    """Neither body uses atomics: the tiled one has no split-K, the small-M
    one sums its cluster ranks' partials in rank order. Two calls give the
    same bits in every form."""
    fn = _quant_forms(gen, algo, gs, shape)[kernel]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_quant_tiled_forms_launch_from_a_fresh_thread(gen):
    """The first launch of a thread binds the context the tensor maps need:
    each form of both bodies (tiled and small-M) from a new thread matches
    the same call from this one, K2's dense forms too."""
    import threading

    forms = []
    for shape in (_OFF_TILE, _SMALL_SPLIT):  # the tiled and small-M bodies
        m, kdim, n = shape
        x = _randn(gen, m, kdim)
        nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
            torch.bfloat16)
        w = _randn(gen, kdim, n, scale=1 / math.sqrt(kdim))
        forms.append(("K2 dense", shape, lambda x=x, nw=nw, w=w:
                      k2.fused_norm_matmul_pure(x, nw, 1e-5, w)))
        forms += [(kernel, (algo, gs, shape), fn) for algo, gs in _QUANT
                  for kernel, fn in _quant_forms(gen, algo, gs,
                                                 shape).items()]
    for kernel, quant, fn in forms:
        got = []
        worker = threading.Thread(target=lambda: got.append(fn()))
        worker.start()
        worker.join()
        torch.cuda.synchronize()
        assert len(got) == 1 and torch.equal(got[0], fn()), (kernel, quant)


@pytest.mark.parametrize("m,kdim,n", [
    (17, 384, 264), (300, 1024, 520), (264, 4096, 1024), (264, 4096, 4096),
    (264, 4096, 14336), (1024, 4096, 1024), (1024, 4096, 4096),
    (1024, 4096, 14336), (8192, 4096, 1024), (8192, 4096, 4096),
    (8192, 4096, 14336)])
def test_norm_matmul_tiles_on_the_card_match_the_model(gen, m, kdim, n):
    """K2's dense tiled path runs the tiled body's walk: the output tiles
    its blocks decode, in walk order, are ``quant_matmul.quant_tiles``' at
    the width ``quant_matmul.block_n(m, n)`` picks for this card, at the
    batcher's, the prefill's and the train step's shapes."""
    from paddle_tpu_torch.ops.kernels import _build

    bn = k4.block_n(m, n, sms=torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    want = k4.quant_tiles(m, kdim, n, bn)
    out = torch.full((len(want), 2), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_quant_matmul_items", m, kdim, n, bn, out.data_ptr(),
                  _build.stream_of(out))
    assert out.cpu().tolist() == [list(t) for t in want]


@pytest.mark.parametrize("kdim,n", [
    (4096, 1024), (4096, 4096), (4096, 14336), (4096, 128256),
    (14336, 4096), (128, 8), (128, 40), (4096, 1000), (14336, 1008)])
def test_small_items_on_the_card_match_the_model(gen, kdim, n):
    """The small-M body's work as its CTAs decode it for this card's plan
    (each (tile, rank): CTA, step, slice range) is
    ``quant_matmul.small_items``' at the card's SM count, at the decode
    widths of K2 and K4 and off the tile."""
    from paddle_tpu_torch.ops.kernels import _build

    want = k4.small_items(kdim, n, torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    tiles = -(-n // k4.SMALL_BN)
    out = torch.full((tiles * k4.SMALL_MAX_CS, 4), -1, dtype=torch.int32,
                     device="cuda")
    _build.launch("pt_small_matmul_items", kdim, n, out.data_ptr(),
                  _build.stream_of(out))
    got = out.cpu().tolist()
    assert got[:len(want)] == [list(r) for r in want]
    assert all(r == [-1] * 4 for r in got[len(want):])


@pytest.mark.parametrize("m,kdim,n,gs,fused_norm", [
    (17, 128, 16, -1, False), (300, 1152, 784, 64, False),
    (1024, 4096, 14336, -1, True), (1024, 4096, 1024, -1, True),
    (1024, 14336, 4096, 128, False), (8192, 4096, 14336, -1, False)])
def test_quant_tiles_on_the_card_match_the_model(gen, m, kdim, n, gs,
                                                 fused_norm):
    """The output tiles the tiled body's blocks decode, in walk order, are
    ``quant_matmul.quant_tiles``' at the tile width ``block_n`` picks."""
    from paddle_tpu_torch.ops.kernels import _build

    bn = k4.block_n(m, n, gs, fused_norm,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    want = k4.quant_tiles(m, kdim, n, bn)
    out = torch.full((len(want), 2), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_quant_matmul_items", m, kdim, n, bn, out.data_ptr(),
                  _build.stream_of(out))
    assert out.cpu().tolist() == [list(t) for t in want]


def _int8_cache(gen, n_layers, b, cap, hk, d, page):
    cache = kv_cache.create_paged_cache(n_layers, b, cap, hk, d, page,
                                        dtype=torch.int8, device="cuda")
    for pool in (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                 device="cuda", dtype=torch.int8))
    for pool in (cache.k_scales, cache.v_scales):
        pool.copy_(torch.rand(pool.shape, generator=gen, device="cuda")
                   * 0.03)
    return cache


def _clone(c):
    return c._replace(**{n: getattr(c, n).clone() for n in (
        "k_pages", "v_pages", "k_scales", "v_scales")})


@pytest.mark.parametrize("page,g,lens", [
    (16, 1, (0, 15, 16)), (16, 4, (31, 1, 47)), (32, 2, (0, 31, 32)),
    (32, 8, (63, 64, 95)), (32, 4, (5, 40, 159)),
    (32, 4, (0, 1, 31, 32, 33, 63, 64, 65, 95, 96, 224, 255, 256, 639))])
def test_rope_append_attend_int8_matches_plain(gen, page, g, lens):
    b, hk, d = len(lens), 2, 128
    cap = -(-(max(lens) + 1) // page) * page
    if len(lens) > 5:
        assert _self_at_range_start(lens, hk, page, cap)
    cache = _int8_cache(gen, 2, b, cap, hk, d, page)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cache = cache._replace(seq_lens=lens_t)
    q = _randn(gen, b, hk * g, d)
    k, v = _randn(gen, b, hk, d), _randn(gen, b, hk, d)
    cos_t, sin_t = _rope_tables(cap, d, 10000.0, device="cuda")
    cos, sin = cos_t[lens_t.long()], sin_t[lens_t.long()]
    ck, cp = _clone(cache), _clone(cache)
    out, ck = k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck, 1)
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, 1, plain=True)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all())
    for name in ("k_pages", "v_pages"):
        dq = (getattr(ck, name).int() - getattr(cp, name).int()).abs()
        print(f"{name}: {int((dq > 0).sum())} codes differ")
        assert int(dq.max()) <= 1, name
    for name in ("k_scales", "v_scales"):
        assert torch.equal(getattr(ck, name), getattr(cp, name)), name
        assert torch.equal(getattr(ck, name)[0], getattr(cache, name)[0])
    assert torch.equal(ck.k_pages[0], cache.k_pages[0])  # other layer


def test_quant_wrappers_raise_instead_of_falling_back(gen):
    qw = _qweight(gen, 256, 64, "weight_only_int8", -1)
    x = _randn(gen, 4, 256)
    nw = torch.ones(256, device="cuda", dtype=torch.bfloat16)
    bad = {
        "f32 x": (x.float(), qw),
        "scale shape": (x, k4.QuantizedWeight(qw.codes, qw.scales[:32],
                                              "int8", -1, (256, 64))),
        "group scales for per-channel": (x, k4.QuantizedWeight(
            qw.codes, qw.scales, "int8", 128, (256, 64))),
        "non-contiguous codes": (x, k4.QuantizedWeight(
            qw.codes.t().contiguous().t(), qw.scales, "int8", -1,
            (256, 64))),
        "N % 16": (x, k4.QuantizedWeight(qw.codes[:, :40].contiguous(),
                                         qw.scales[:40].contiguous(),
                                         "int8", -1, (256, 40))),
    }
    for what, (xx, w) in bad.items():
        with pytest.raises(ValueError):
            k4.quant_matmul_qw(xx, w)
            pytest.fail(f"K4 accepted {what}")
        with pytest.raises(ValueError):
            k2.fused_norm_matmul_pure(xx, nw, 1e-5, w)
            pytest.fail(f"K2 accepted {what}")
    cache = _int8_cache(gen, 1, 2, 32, 1, 128, 16)
    q = _randn(gen, 2, 2, 128)
    kv = _randn(gen, 2, 1, 128)
    cos = torch.zeros((2, 128), device="cuda")
    for what, (qq, c) in {
            "f32 q": (q.float(), cache),
            "f32 scale pool as bf16": (q, cache._replace(
                k_scales=cache.k_scales.to(torch.bfloat16))),
            "scale pool shape": (q, cache._replace(
                v_scales=cache.v_scales[:, :, :1].contiguous())),
            "non-contiguous scale pool": (q, cache._replace(
                k_scales=cache.k_scales.transpose(2, 3).contiguous()
                .transpose(2, 3))),
            "int8 k pool with bf16 v pool": (q, cache._replace(
                v_pages=cache.v_pages.to(torch.bfloat16)))}.items():
        with pytest.raises(ValueError):
            k3.fused_rope_append_attend_decode(qq, kv, kv, cos, cos, c, 0)
            pytest.fail(f"K3 accepted {what}")


@pytest.mark.parametrize("algo,gs", _QUANT)
def test_quantization_rules_match_the_cpu_bitwise(gen, algo, gs):
    """Weight codes/scales and the cache's cell codes/scales come out the
    same on the card as on the CPU (where they equal the JAX package's):
    every division is IEEE on both."""
    w = torch.randn((384, 272), generator=gen, device="cuda")
    for a, b in zip(_weight_quantize_pure(w, algo, gs),
                    _weight_quantize_pure(w.cpu(), algo, gs)):
        assert torch.equal(a.cpu(), b)
    x = torch.randn((8, 5, 128), generator=gen, device="cuda") * 3
    for a, b in zip(kv_cache.quantize_cells(x),
                    kv_cache.quantize_cells(x.cpu())):
        assert torch.equal(a.cpu(), b)
    # the stacked expert weights (MoEMLP.quantize_experts)
    w = torch.randn((3, 384, 272), generator=gen, device="cuda") * 0.02
    for a, b in zip(k1314.quantize_grouped_weight(w, algo, gs),
                    k1314.quantize_grouped_weight(w.cpu(), algo, gs)):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ------------------------------------------- the batcher's kernels (K10,
# K11, K3 ragged and masked)


def _bf16_cache(gen, n_layers, b, cap, hk, page):
    cache = kv_cache.create_paged_cache(n_layers, b, cap, hk, 128, page,
                                        dtype=torch.bfloat16, device="cuda")
    for pool in (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    return cache


def _copy(cache):
    """The cache with its own copy of every pool."""
    return cache._replace(**{n: getattr(cache, n).clone() for n in (
        "k_pages", "v_pages", "k_scales", "v_scales")
        if getattr(cache, n) is not None})


def _attn_tol(ref):
    # attention in f32 in both (order differs), one bf16 output rounding
    return 1e-2 + 1e-2 * ref.float().abs()


@pytest.mark.parametrize("g,lens", [(1, (0, 15, 16)), (4, (31, 1, 47)),
                                    (8, (5, 32, 40)), (4, _LONG_POS),
                                    (1, _LONG_POS[::-1]), (8, (640, 0, 1))])
def test_paged_attention_matches_plain(gen, g, lens):
    b, hk, page = len(lens), 2, 16
    cap = max(48, -(-max(lens) // page) * page)
    cache = _bf16_cache(gen, 1, b, cap, hk, page)
    q = _randn(gen, b, hk * g, 128)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, cache.k_pages[0], cache.v_pages[0], cache.block_tables, seq)
    out = k10.paged_attention_pure(*args)
    ref = k10.paged_attention_reference(*args)
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    if lens[0] == 0:
        assert not out[0].any()


def _wave_case(gen, b, hk, g, page, cap, t):
    """A wave over b slots with old lengths `seq`: slot 0 decodes, slot 1
    chunk-prefills 20 rows on 40 tokens of context, slot 2 starts a
    13-row prompt, slot 3 sits out, the rest decode; the last rows pad.
    Returns (cache, rows (q, k, v, cos, sin), wave args of the attend
    seams, seq)."""
    seq = torch.tensor([37, 40, 0, 5] + [16 * i + 15 for i in range(b - 4)],
                       dtype=torch.int32, device="cuda")
    cache = _bf16_cache(gen, 2, b, cap, hk, page)._replace(seq_lens=seq)
    lens_q = [1, 20, 13, 0] + [1] * (b - 4)
    fresh = [0, 20, 13, 0] + [0] * (b - 4)
    q_start, row_slot, row_pos, r = [], [], [], 0
    for i, n in enumerate(lens_q):
        q_start.append(r if n else 0)
        row_slot += [i] * n
        row_pos += [int(seq[i]) + j for j in range(n)]
        r += n
    assert r <= t
    row_slot += [-1] * (t - r)
    row_pos += [0] * (t - r)
    dec = [n == 1 and f == 0 for n, f in zip(lens_q, fresh)]
    page_lens = [int(s) + 1 if d else (int(s) if n else 0)
                 for s, d, n in zip(seq, dec, lens_q)]
    i32 = dict(dtype=torch.int32, device="cuda")
    wave = (torch.tensor(row_slot, **i32), torch.tensor(row_pos, **i32),
            torch.tensor(row_slot, **i32) >= 0,
            torch.tensor(page_lens, **i32), torch.tensor(q_start, **i32),
            torch.tensor(lens_q, **i32), torch.tensor(fresh, **i32))
    cos_t, sin_t = _rope_tables(cap, 128, 10000.0, device="cuda")
    pos = wave[1].long()
    rows = (_randn(gen, t, hk * g, 128), _randn(gen, t, hk, 128),
            _randn(gen, t, hk, 128), cos_t[pos], sin_t[pos])
    return cache, rows, wave


def _edge_case(gen, g, page, name, hk=2, int8=False):
    """A wave of ``tests/ragged_wave_cases.py`` (``name``, or a list of
    slots as ``layout`` takes them) on a 2-layer bf16 cache of
    random K/V (``int8``: random codes and scales; block tables permuted,
    old lengths in ``seq_lens``): the cache, the rows (q, k, v, cos, sin)
    and the layout (row_slot, row_pos, valid, page_lens, q_start, q_lens,
    fresh_lens) as the attend seams take them."""
    lay = layout(edge_waves(g, page)[name] if isinstance(name, str)
                 else name)
    b, cap, t = len(lay["seq"]), lay["cap"], lay["t"]
    i32 = dict(dtype=torch.int32, device="cuda")
    cache = (_int8_cache(gen, 2, b, cap, hk, 128, page) if int8
             else _bf16_cache(gen, 2, b, cap, hk, page))
    perm = torch.randperm(b * (cap // page), generator=gen, device="cuda")
    cache = cache._replace(block_tables=perm.reshape(b, -1).to(torch.int32),
                           seq_lens=torch.tensor(lay["seq"], **i32))
    rs = torch.tensor(lay["row_slot"], **i32)
    wave = (rs, torch.tensor(lay["row_pos"], **i32), rs >= 0,
            *(torch.tensor(lay[k], **i32) for k in (
                "page_lens", "q_start", "q_lens", "fresh_lens")))
    cos_t, sin_t = _rope_tables(cap, 128, 10000.0, device="cuda")
    pos = wave[1].long()
    rows = (_randn(gen, t, hk * g, 128), _randn(gen, t, hk, 128),
            _randn(gen, t, hk, 128), cos_t[pos], sin_t[pos])
    return cache, rows, wave


_EDGE_WAVES = [(g, page, name) for g in (1, 2, 4, 8) for page in (16, 32)
               for name in ("chunks", "walks")]
# the batcher's long second chunk, on both pages
_LONG_WAVES = [(g, page, "long") for g in (1, 4) for page in (16, 32)]


@pytest.mark.parametrize("g,page,name", _EDGE_WAVES + _LONG_WAVES)
def test_ragged_attention_matches_plain(gen, g, page, name):
    """K11 on the edge waves of the CPU walk tests, for every GQA group:
    within the attention tolerance of its plain version, rows of no
    segment exact zeros, a chunk row's non-finite fresh K/V leaking into
    no other row."""
    cache, (q, kf, vf, _, _), wave = _edge_case(gen, g, page, name)
    slot = int((wave[6] >= 2).nonzero()[0])    # a chunk's second row
    poisoned = int(wave[4][slot]) + 1
    kf[poisoned], vf[poisoned] = float("nan"), float("inf")
    args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            *wave[3:], kf, vf)
    out = k11.ragged_paged_attention_pure(*args)
    ref = k11.ragged_paged_attention_reference(
        *args[:8], k11.zero_non_finite(kf), k11.zero_non_finite(vf))
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[~wave[2]].any()       # rows of no segment


@pytest.mark.parametrize("g,page,name", _EDGE_WAVES + _LONG_WAVES)
def test_rope_append_attend_ragged_matches_plain(gen, g, page, name):
    """K3's ragged form on the same waves: the output within the attention
    tolerance, rows of no segment zeros, the pools bit-identical to the
    plain chain's (every segment row's cell, the other layer untouched)."""
    cache, rows, wave = _edge_case(gen, g, page, name)
    ck, cp = _copy(cache), _copy(cache)
    out, ck = k3.fused_rope_append_attend(*rows, ck, 1, *wave)
    ref, cp = k3.ragged_reference(*rows, cp, 1, *wave, plain=True)
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[~wave[2]].any()
    # the written cells: the same separately rounded rope in both
    assert torch.equal(ck.k_pages, cp.k_pages)
    assert torch.equal(ck.v_pages, cp.v_pages)
    assert torch.equal(ck.k_pages[0], cache.k_pages[0])   # other layer


@pytest.mark.parametrize("name", ["chunks", "walks"])
def test_ragged_forms_are_deterministic(gen, name):
    """K11 and K3's ragged form: two calls give the same bits (a walk's
    ranks merge in rank order, no atomics), K3's pools included."""
    cache, rows, wave = _edge_case(gen, 4, 16, name, hk=8)
    q, kf, vf = rows[:3]
    args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            *wave[3:], kf, vf)
    assert torch.equal(k11.ragged_paged_attention_pure(*args),
                       k11.ragged_paged_attention_pure(*args))
    runs = []
    for _ in range(2):
        c = _copy(cache)
        out, c = k3.fused_rope_append_attend(*rows, c, 1, *wave)
        runs.append((out, c.k_pages, c.v_pages))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("hk", [2, 8, 16, 32])
def test_ragged_items_on_the_card_match_the_model(gen, hk):
    """The (kind, slot, kv head, rank or tile, first key, end key) each CTA
    of the ragged walk decodes on the card equal
    ``ragged_paged_attention.ragged_items`` at this card's SM count, on
    every edge wave and GQA group (kv heads 2, 8, 16 and 32 give plans of
    several cluster sizes), also padded to T = 264; and the plan the two
    entries report equals ``ragged_plan``."""
    from paddle_tpu_torch.ops.kernels import _build
    import ctypes

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g, page, name in _EDGE_WAVES:
        for t in (None, 264):
            lay = layout(edge_waves(g, page)[name], t)
            b, pps, t = len(lay["seq"]), lay["cap"] // page, lay["t"]
            cs, clusters, ctas = k11.ragged_plan(t, b, hk, g, pps, sms)
            want = k11.ragged_items(lay["q_lens"], lay["page_lens"],
                                    lay["fresh_lens"], t, hk, g, pps, page,
                                    sms)
            lens = [torch.tensor(lay[k], dtype=torch.int32, device="cuda")
                    for k in ("page_lens", "q_lens", "fresh_lens")]
            out = torch.full((ctas, 6), -7, dtype=torch.int32, device="cuda")
            _build.launch("pt_ragged_items", *(x.data_ptr() for x in lens),
                          out.data_ptr(), t, b, hk * g, hk, page, pps,
                          _build.stream_of(out))
            assert out.cpu().tolist() == [list(r) for r in want], (
                g, page, name, t, cs)
            for entry in ("pt_ragged_paged_attention_plan",
                          "pt_rope_append_attend_ragged_plan",
                          "pt_ragged_paged_attention_int8_plan",
                          "pt_rope_append_attend_ragged_int8_plan"):
                plan = (ctypes.c_int * 4)()
                _build.launch(entry, t, b, hk * g, hk, page, pps,
                              ctypes.addressof(plan))
                assert list(plan)[:2] == [cs, clusters], entry
                assert plan[3] > 0, entry


@pytest.mark.parametrize("lens", [(31, 0, 47, 64), _LONG_POS])
@pytest.mark.parametrize("int8", [False, True])
def test_rope_append_attend_masked_matches_plain(gen, int8, lens):
    b, hk, g, page = len(lens), 2, 4, 32 if int8 else 16
    cap = max(96, -(-(max(lens) + 1) // page) * page)
    cache = (_int8_cache(gen, 2, b, cap, hk, 128, page) if int8
             else _bf16_cache(gen, 2, b, cap, hk, page))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cache = cache._replace(seq_lens=lens_t)
    # slot 1 inactive (and, on the long case, every third slot)
    active = torch.arange(b, device="cuda") % (3 if b > 4 else b) != 1
    q = _randn(gen, b, hk * g, 128)
    k, v = _randn(gen, b, hk, 128), _randn(gen, b, hk, 128)
    cos_t, sin_t = _rope_tables(cap, 128, 10000.0, device="cuda")
    cos, sin = cos_t[lens_t.long()], sin_t[lens_t.long()]
    ck, cp = _copy(cache), _copy(cache)
    out, ck = k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck, 1,
                                                 active)
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, 1, active,
                                  plain=True)
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[1].any()
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales") if int8
                                      else ())
    for name in names:
        assert torch.equal(getattr(ck, name), getattr(cp, name)), name


def _walk_form(gen, form, lens, hk=2, g=4):
    """One page-walk form on fresh inputs: K10 over walk lengths ``lens``
    (bf16, or ``paged_int8`` on an int8 cache at page 32); K3's decode form
    at positions ``lens`` (bf16, int8 at page 32, masked with every third
    slot inactive). Returns (run, plain): the kernel and
    its plain version, each on its own copy of the cache, returning the
    output and the pools."""
    int8 = form in ("int8", "paged_int8")
    page = 32 if int8 else 16
    b = len(lens)
    cap = max(48, -(-(max(lens) + 1) // page) * page)
    cache = (_int8_cache(gen, 2, b, cap, hk, 128, page) if int8
             else _bf16_cache(gen, 2, b, cap, hk, page))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = _randn(gen, b, hk * g, 128)
    if form.startswith("paged"):
        args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
                lens_t)
        kw = dict(zip(("k_scales", "v_scales"),
                      kv_cache.layer_scales(cache, 1)))
        return (lambda: (k10.paged_attention_pure(*args, **kw),),
                lambda: (k10.paged_attention_reference(*args, **kw),))
    cache = cache._replace(seq_lens=lens_t)
    k, v = _randn(gen, b, hk, 128), _randn(gen, b, hk, 128)
    cos_t, sin_t = _rope_tables(cap, 128, 10000.0, device="cuda")
    cos, sin = cos_t[lens_t.long()], sin_t[lens_t.long()]
    active = (torch.arange(b, device="cuda") % 3 != 1 if form == "masked"
              else None)

    def call(fn, **kw):
        c = _copy(cache)
        out, c = fn(q, k, v, cos, sin, c, 1, active, **kw)
        return (out, c.k_pages, c.v_pages) + (
            (c.k_scales, c.v_scales) if c.quantized else ())

    return (lambda: call(k3.fused_rope_append_attend_decode),
            lambda: call(k3.decode_reference, plain=True))


_WALK_FORMS = ["paged", "decode", "int8", "masked", "paged_int8"]


@pytest.mark.parametrize("form", _WALK_FORMS)
def test_paged_walk_forms_are_deterministic(gen, form):
    """K10 and K3's decode forms: two calls give the same bits (the ranks'
    partials merge in rank order, no atomics)."""
    run, _ = _walk_form(gen, form, _LONG_POS)
    a, b = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# (B, Hk) of walks in clusters of 1, 2, 4 and 8 on 132 SMs (cap 640)
_CLUSTER_SHAPES = [(17, 8), (9, 8), (8, 8), (2, 8)]


@pytest.mark.parametrize("b,hk", _CLUSTER_SHAPES)
@pytest.mark.parametrize("form", _WALK_FORMS)
def test_paged_walk_forms_match_plain_at_every_cluster_size(gen, form, b,
                                                            hk):
    """Each form against its plain version on plans of every cluster size,
    lengths spread over the cap's page and range edges: the output within
    the attention tolerance, the pools as the plain chain writes them
    (int8 codes within 1, scales equal)."""
    lens = [_LONG_POS[i % len(_LONG_POS)] for i in range(b)]
    run, plain = _walk_form(gen, form, lens, hk=hk)
    got, want = run(), plain()
    torch.cuda.synchronize()
    diff = (got[0].float() - want[0].float()).abs()
    assert bool((diff <= _attn_tol(want[0])).all())
    for x, y in zip(got[1:3], want[1:3]):
        if form == "int8":  # a rounding boundary may move a code by 1
            assert int((x.int() - y.int()).abs().max()) <= 1
        else:
            assert torch.equal(x, y)
    for x, y in zip(got[3:], want[3:]):
        assert torch.equal(x, y)


def test_walk_wrappers_refuse_unaligned_copies(gen):
    """The walk bulk-copies whole pages in 16-byte units: a K10 pool view
    off a 16-byte boundary raises, and so does an int8 cache whose page is
    not a multiple of 4 (its page * 4 bytes of scales)."""
    cache = _bf16_cache(gen, 1, 2, 32, 1, 16)
    kp = cache.k_pages[0]
    buf = torch.empty(kp.numel() + 8, dtype=kp.dtype, device="cuda")
    shifted = buf[1:1 + kp.numel()].view(kp.shape)    # 2 bytes off
    shifted.copy_(kp)
    q = _randn(gen, 2, 4, 128)
    seq = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        k10.paged_attention_pure(q, shifted, cache.v_pages[0],
                                 cache.block_tables, seq)
    cache = _int8_cache(gen, 1, 2, 36, 1, 128, 6)._replace(seq_lens=seq)
    kv = _randn(gen, 2, 1, 128)
    cs = torch.zeros((2, 128), device="cuda")
    with pytest.raises(ValueError):
        k3.fused_rope_append_attend_decode(q, kv, kv, cs, cs, cache, 0)


# (B, Hk, cap, page): plans with clusters of 8, 4, 2 and 1 on 132 SMs,
# and clusters cut short by the pages a slot holds
_WALK_PLANS = [(2, 8, 640, 16), (8, 8, 640, 16), (12, 8, 160, 32),
               (9, 8, 640, 16), (17, 8, 640, 16), (3, 2, 48, 16),
               (1, 1, 16, 16)]


@pytest.mark.parametrize("b,hk,cap,page", _WALK_PLANS)
def test_paged_walk_items_on_the_card_match_the_model(gen, b, hk, cap, page):
    """The (rank, first page, end page) each CTA of the walk decodes on
    the card, for walks of every length class (0, inside the first page,
    on page edges, the capacity), equal ``paged_attention.walk_items`` at
    this card's SM count."""
    from paddle_tpu_torch.ops.kernels import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = cap // page
    pool = (0, 1, page - 1, page, page + 1, cap // 2, cap - 1, cap)
    lens = [pool[i % len(pool)] for i in range(b)]
    cs, grid = k10.walk_plan(b, hk, pps, sms)
    want = k10.walk_items(lens, hk, pps, page, sms)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = torch.full((grid, 3), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_paged_walk_items", lens_t.data_ptr(), out.data_ptr(),
                  b, hk, page, pps, _build.stream_of(out))
    assert out.cpu().tolist() == [list(r) for r in want], (cs, grid)


# ---- the int8 pools of the batcher's kernels (K10, K11, K3 ragged): codes
# with one f32 scale a cell, read as code * scale; the fresh rows stay bf16


def _int8_wave(gen, g, page, name, hk=2):
    """An edge wave on an int8 cache: (cache, rows, wave, K11's arguments
    on layer 1 with its scales as keywords)."""
    cache, rows, wave = _edge_case(gen, g, page, name, hk=hk, int8=True)
    q, kf, vf = rows[:3]
    args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            *wave[3:], kf, vf)
    kw = dict(k_scales=cache.k_scales[1], v_scales=cache.v_scales[1])
    return cache, rows, wave, args, kw


@pytest.mark.parametrize("g,page,name", _EDGE_WAVES + _LONG_WAVES)
def test_ragged_attention_int8_matches_plain(gen, g, page, name):
    """K11 on an int8 cache, on the edge waves for every GQA group: within
    the attention tolerance of its plain version (every page cell read as
    code * scale, the fresh rows bf16), rows of no segment exact zeros, a
    chunk row's non-finite fresh K/V leaking into no other row."""
    cache, (q, kf, vf, _, _), wave, args, kw = _int8_wave(gen, g, page, name)
    slot = int((wave[6] >= 2).nonzero()[0])    # a chunk's second row
    poisoned = int(wave[4][slot]) + 1
    kf[poisoned], vf[poisoned] = float("nan"), float("inf")
    out = k11.ragged_paged_attention_pure(*args, **kw)
    ref = k11.ragged_paged_attention_reference(
        *args[:8], k11.zero_non_finite(kf), k11.zero_non_finite(vf), **kw)
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[~wave[2]].any()       # rows of no segment


def _int8_pools_check(new, ref, old, written):
    """K3's int8 pools against the plain chain's: codes within 1 (a
    rounding boundary; the differing ones counted), scales equal, every
    cell outside ``written`` ((L, Hk, P, page) mask) as it was."""
    for name in ("k_pages", "v_pages"):
        dq = (getattr(new, name).int() - getattr(ref, name).int()).abs()
        print(f"{name}: {int((dq > 0).sum())} codes differ")
        assert int(dq.max()) <= 1, name
    for name in ("k_scales", "v_scales"):
        assert torch.equal(getattr(new, name), getattr(ref, name)), name
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, o = getattr(new, name), getattr(old, name)
        keep = (~written)[..., None].expand_as(a)
        assert torch.equal(a[keep], o[keep]), name


def _written(cache, layer, wave):
    """(L, Hk, P, page) mask of the cells a wave's segment rows write."""
    page = cache.k_pages.shape[3]
    mask = torch.zeros(cache.k_pages.shape[:-1], dtype=torch.bool,
                       device="cuda")
    valid = wave[2]
    slots, pos = wave[0][valid].long(), wave[1][valid].long()
    phys = cache.block_tables[slots, pos // page].long()
    mask[layer, :, phys, pos % page] = True
    return mask


@pytest.mark.parametrize("g,page,name", _EDGE_WAVES + _LONG_WAVES)
def test_rope_append_attend_ragged_int8_matches_plain(gen, g, page, name):
    """K3's ragged form on an int8 cache, on the same waves: the output
    within the attention tolerance (a chunk's rows see their own chunk
    fresh, a decode row its own cell as code * scale), rows of no segment
    zeros, every segment row's cell quantized as the plain chain does it
    (codes within 1, scales equal), every other cell untouched."""
    cache, rows, wave, _, _ = _int8_wave(gen, g, page, name)
    ck, cp = _copy(cache), _copy(cache)
    out, ck = k3.fused_rope_append_attend(*rows, ck, 1, *wave)
    ref, cp = k3.ragged_reference(*rows, cp, 1, *wave, plain=True)
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[~wave[2]].any()
    _int8_pools_check(ck, cp, cache, _written(cache, 1, wave))


@pytest.mark.parametrize("g,lens", [(1, (0, 15, 16)), (4, (31, 1, 47)),
                                    (8, (5, 32, 40)), (4, _LONG_POS),
                                    (2, (640, 0, 1))])
@pytest.mark.parametrize("page", [16, 32])
def test_paged_attention_int8_matches_plain(gen, page, g, lens):
    """K10 on an int8 cache at lengths on page edges and up to the
    capacity: within the attention tolerance, a length-0 slot zeros."""
    b, hk = len(lens), 2
    cap = max(64, -(-max(lens) // page) * page)
    cache = _int8_cache(gen, 1, b, cap, hk, 128, page)
    q = _randn(gen, b, hk * g, 128)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, cache.k_pages[0], cache.v_pages[0], cache.block_tables, seq)
    kw = dict(k_scales=cache.k_scales[0], v_scales=cache.v_scales[0])
    out = k10.paged_attention_pure(*args, **kw)
    ref = k10.paged_attention_reference(*args, **kw)
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    if 0 in lens:
        assert not out[list(lens).index(0)].any()


@pytest.mark.parametrize("name", ["chunks", "walks"])
def test_ragged_forms_int8_are_deterministic(gen, name):
    """K11 and K3's ragged form on an int8 cache: two calls give the same
    bits, K3's codes and scales included."""
    cache, rows, wave, args, kw = _int8_wave(gen, 4, 32, name, hk=8)
    assert torch.equal(k11.ragged_paged_attention_pure(*args, **kw),
                       k11.ragged_paged_attention_pure(*args, **kw))
    runs = []
    for _ in range(2):
        c = _copy(cache)
        out, c = k3.fused_rope_append_attend(*rows, c, 1, *wave)
        runs.append((out, c.k_pages, c.v_pages, c.k_scales, c.v_scales))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


# decode rows whose walks wrap a CTA's ring of stages several times
# (clusters of 1 at 32 kv heads, of 4 at 8) beside a long prompt's second
# chunk
_LONG_WALKS = [(599, 1, 0), (511, 1, 0), (447, 1, 0), (383, 1, 0),
               (255, 1, 0), (127, 1, 0), (96, 1, 0), (256, 256, 256)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hk", [8, 32])
def test_ragged_long_walks_are_deterministic(gen, hk, int8):
    """K11 and K3's ragged form on walks that wrap each CTA's ring several
    times while a page's reader warp rotates: within the attention
    tolerance, and every call of many gives the same bits (a warp that
    reads a stage before its page has landed would not)."""
    page = 32 if int8 else 16
    cache, rows, wave = _edge_case(gen, 4, page, _LONG_WALKS, hk=hk,
                                   int8=int8)
    q, kf, vf = rows[:3]
    args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            *wave[3:], kf, vf)
    kw = dict(zip(("k_scales", "v_scales"), kv_cache.layer_scales(cache, 1)))
    ref = k11.ragged_paged_attention_reference(*args, **kw)
    first = k11.ragged_paged_attention_pure(*args, **kw)
    torch.cuda.synchronize()
    assert bool(((first.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    for _ in range(50):
        assert torch.equal(k11.ragged_paged_attention_pure(*args, **kw),
                           first)
    outs = [k3.fused_rope_append_attend(*rows, _copy(cache), 1, *wave)[0]
            for _ in range(20)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# a speculative verify wave (``fresh_pool_read``): verify segments of 1 + 4
# rows and of one row (no drafts) at lengths across page edges, beside an
# unflagged prompt chunk (its second tile included) and an idle slot
_VERIFY_SLOTS = [(97, 5, 5), (31, 1, 1), (0, 0, 0), (150, 5, 5),
                 (63, 5, 5), (70, 20, 20), (1, 1, 1), (255, 5, 5)]


def _verify_case(gen, g, int8, hk=2):
    """The verify wave on a bf16 (page 16) or int8 (page 32) cache: the
    cache, rows, layout, K11's arguments on layer 1 and the scales as
    keywords, and the flag: every slot but the chunk and the idle one."""
    page = 32 if int8 else 16
    cache, rows, wave = _edge_case(gen, g, page, _VERIFY_SLOTS, hk=hk,
                                   int8=int8)
    q, kf, vf = rows[:3]
    args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            *wave[3:], kf, vf)
    kw = dict(zip(("k_scales", "v_scales"), kv_cache.layer_scales(cache, 1)))
    kw = {k: v for k, v in kw.items() if v is not None}
    flag = torch.tensor([q == f and 0 < q <= 5 for _, q, f in _VERIFY_SLOTS],
                        dtype=torch.bool, device="cuda")
    return cache, rows, wave, args, kw, flag


def _flagged_plain(args, kw, flag, int8):
    """K11's plain version of the flagged wave: the fresh rows zeroed where
    non-finite, then through the pool (``fresh_through_pool``)."""
    kf, vf = k11.fresh_through_pool(*args[8:10], flag, args[5], args[6],
                                    int8, args[1].dtype)
    return k11.ragged_paged_attention_reference(*args[:8], kf, vf, **kw)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_forms_fresh_pool_read_match_plain(gen, int8, g):
    """K11 and K3's ragged form with ``fresh_pool_read`` on a verify wave:
    within the attention tolerance of their plain versions with the
    roundtrip, rows of no segment zeros, K3's pools as the plain chain's;
    on an int8 cache the flag moves the flagged slots' rows (the kernels'
    flag-off output is further from the flagged plain version) and no
    other row."""
    cache, rows, wave, args, kw, flag = _verify_case(gen, g, int8)
    out = k11.ragged_paged_attention_pure(*args, **kw, fresh_pool_read=flag)
    ref = _flagged_plain(args, kw, flag, int8)
    ck, cp = _copy(cache), _copy(cache)
    out3, ck = k3.fused_rope_append_attend(*rows, ck, 1, *wave,
                                           fresh_pool_read=flag)
    ref3, cp = k3.ragged_reference(*rows, cp, 1, *wave, plain=True,
                                   fresh_pool_read=flag)
    torch.cuda.synchronize()
    for o, r in ((out, ref), (out3, ref3)):
        assert bool(((o.float() - r.float()).abs() <= _attn_tol(r)).all())
        assert not o[~wave[2]].any()
    if int8:
        _int8_pools_check(ck, cp, cache, _written(cache, 1, wave))
        off = k11.ragged_paged_attention_pure(*args, **kw)
        off3, _ = k3.fused_rope_append_attend(*rows, _copy(cache), 1, *wave)
        flagged = flag[wave[0].long().clamp(min=0)] & wave[2]
        for o, o_off, r in ((out, off, ref), (out3, off3, ref3)):
            d_on = (o.float() - r.float()).abs().amax()
            d_off = (o_off.float() - r.float()).abs().amax()
            assert d_off > d_on, (float(d_off), float(d_on))
            moved = (o != o_off).any(dim=(1, 2))
            assert moved[flagged].any() and not moved[~flagged].any()
    else:
        assert torch.equal(ck.k_pages, cp.k_pages)
        assert torch.equal(ck.v_pages, cp.v_pages)


@pytest.mark.parametrize("g", [1, 4])
def test_fresh_pool_read_changes_no_bit_on_a_bf16_cache(gen, g):
    """On a bf16 cache the roundtrip is the identity (a bf16 row cast to a
    bf16 pool; K3's rotated k is already rounded to bf16): K11 and K3 with
    the flag give the unflagged bits, K3's pools included."""
    cache, rows, wave, args, kw, flag = _verify_case(gen, g, False)
    assert torch.equal(
        k11.ragged_paged_attention_pure(*args, fresh_pool_read=flag),
        k11.ragged_paged_attention_pure(*args))
    runs = []
    for f in (flag, None):
        c = _copy(cache)
        out, c = k3.fused_rope_append_attend(*rows, c, 1, *wave,
                                             fresh_pool_read=f)
        runs.append((out, c.k_pages, c.v_pages))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fresh_pool_read_forms_are_deterministic(gen, int8):
    """Two calls with the flag give the same bits, K3's pools included."""
    cache, rows, wave, args, kw, flag = _verify_case(gen, 4, int8, hk=8)
    assert torch.equal(
        k11.ragged_paged_attention_pure(*args, **kw, fresh_pool_read=flag),
        k11.ragged_paged_attention_pure(*args, **kw, fresh_pool_read=flag))
    runs = []
    for _ in range(2):
        c = _copy(cache)
        out, c = k3.fused_rope_append_attend(*rows, c, 1, *wave,
                                             fresh_pool_read=flag)
        runs.append((out,) + tuple(
            getattr(c, n) for n in ("k_pages", "v_pages", "k_scales",
                                    "v_scales") if getattr(c, n) is not None))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_fresh_pool_read_malformed_flags_raise(gen):
    """A flag of the wrong type, length or device, or not contiguous, is
    refused by both wrappers before any launch."""
    cache, rows, wave, args, kw, flag = _verify_case(gen, 4, True)
    b = flag.shape[0]
    bad = [flag.int(), flag[:-1].contiguous(),
           torch.ones(b + 1, dtype=torch.bool, device="cuda"), flag.cpu(),
           torch.ones(2 * b, dtype=torch.bool, device="cuda")[::2]]
    n11, n3 = k11.launches, k3.ragged_launches
    for f in bad:
        with pytest.raises(ValueError):
            k11.ragged_paged_attention_pure(*args, **kw, fresh_pool_read=f)
        with pytest.raises(ValueError):
            k3.fused_rope_append_attend(*rows, _copy(cache), 1, *wave,
                                        fresh_pool_read=f)
    assert (k11.launches, k3.ragged_launches) == (n11, n3)


@pytest.mark.parametrize("g", [1, 4, 8])
def test_int8_dropped_range_controls_fail(gen, g):
    """The fault control chip_smoke.py runs, on the card at int8: the split
    walks' plain models at this card's cluster size hold the kernels within
    the attention tolerance, and with each walk's last range left out
    (``drop_last``) fail it on every nonempty walk: K11 on the ``walks``
    wave, K10 over its lengths."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cache, _, wave, args, kw = _int8_wave(gen, g, 16, "walks", hk=8)
    q, bt = args[0], args[3]
    t, b, pps = q.shape[0], bt.shape[0], bt.shape[1]
    cs = k11.ragged_plan(t, b, 8, g, pps, sms)[0]
    assert cs > 1
    out = k11.ragged_paged_attention_pure(*args, **kw).float()
    tol = _attn_tol(out)
    split = k11.split_ragged_reference(*args, **kw, cs=cs).float()
    assert bool(((split - out).abs() <= tol).all())
    ctl = k11.split_ragged_reference(*args, **kw, cs=cs,
                                     drop_last=True).float()
    bad = ((ctl - out).abs() > tol).flatten(1).any(1)
    for slot, (ql, fl, n) in enumerate(zip(*(w.tolist() for w in (
            wave[5], wave[6], wave[3])))):
        if ql == 1 and fl == 0:
            assert bool(bad[int(wave[4][slot])]) == (n > 0), slot
    lens = wave[3]
    args10 = (q[:b].contiguous(), args[1], args[2], bt, lens)
    cs10 = k10.walk_plan(b, 8, pps, sms)[0]
    out10 = k10.paged_attention_pure(*args10, **kw).float()
    ctl10 = k10.split_walk_reference(*args10, **kw, cs=cs10,
                                     drop_last=True).float()
    bad10 = ((ctl10 - out10).abs() > _attn_tol(out10)).flatten(1).any(1)
    assert bad10.tolist() == [n > 0 for n in lens.tolist()]


def test_int8_batcher_wrappers_refuse_what_the_bodies_cannot_copy(gen):
    """K10, K11 and K3's ragged form on an int8 cache raise on a page that
    is not a multiple of 4 (a page's scales are copied in 16-byte pieces),
    on scales without codes' partner pool, and on bf16 scale pools."""
    cache, rows, wave = _edge_case(gen, 4, 16, "chunks", int8=True)
    q, kf, vf = rows[:3]
    odd = _int8_cache(gen, 2, len(wave[3]), 36, 2, 128, 6)._replace(
        seq_lens=cache.seq_lens)
    for c in (odd, cache._replace(k_scales=cache.k_scales.bfloat16()),
              cache._replace(v_scales=None)):
        ks, vs = c.k_scales, c.v_scales
        sc = dict(k_scales=None if ks is None else ks[1],
                  v_scales=None if vs is None else vs[1])
        with pytest.raises(ValueError):
            k11.ragged_paged_attention_pure(
                q, c.k_pages[1], c.v_pages[1], c.block_tables, *wave[3:],
                kf, vf, **sc)
        with pytest.raises(ValueError):
            k10.paged_attention_pure(q[:len(wave[3])].contiguous(),
                                     c.k_pages[1], c.v_pages[1],
                                     c.block_tables, wave[3], **sc)
        with pytest.raises(ValueError):
            k3.fused_rope_append_attend(*rows, _copy(c), 1, *wave)


def test_unfused_attend_seams_launch_k10_and_k11(gen):
    """With only norm_matmul fused, the attend seams run rope and the
    cache write as plain ops and attention in K10 / K11 — never the plain
    attention."""
    b, hk, g, page, cap, t = 6, 2, 4, 16, 64, 48
    cache, rows, wave = _wave_case(gen, b, hk, g, page, cap, t)
    old = flags.get_flag("fused_decode_fusions")
    n10, n11, n3 = k10.launches, k11.launches, k3.ragged_launches
    try:
        flags.set_flags({"fused_decode_fusions": "norm_matmul"})
        fusion.ragged_attend(*rows, cache, 0, *wave)
        q, k, v, cos, sin = (x[:b] for x in rows)
        fusion.decode_attend(q.contiguous(), k.contiguous(), v.contiguous(),
                             cos.contiguous(), sin.contiguous(), cache, 0,
                             active=torch.ones(b, dtype=torch.bool,
                                               device="cuda"))
    finally:
        flags.set_flags({"fused_decode_fusions": old})
    assert (k10.launches - n10, k11.launches - n11,
            k3.ragged_launches - n3) == (1, 1, 0)


# --------------------------------------------------------------------------
# training kernels: K5 flash backward, K6/K7 RMSNorm, K8 AdamW8bit
# --------------------------------------------------------------------------


# the backward's edges: S not a multiple of the 64-row tiles, Sq != Sk both
# ways, causal and not, GQA groups 1, 4 and 8, walks of one tile and many
_BWD_EDGES = [
    (1, 100, 100, 4, 4, True), (2, 130, 130, 8, 2, True),
    (1, 64, 200, 4, 1, True), (1, 77, 77, 4, 1, False),
    (1, 300, 300, 8, 1, True), (1, 130, 70, 8, 8, False),
    (1, 70, 190, 8, 1, False), (2, 250, 130, 8, 1, True),
    (1, 129, 130, 4, 2, True)]


@pytest.mark.parametrize("b,sq,sk,h,hk,causal", _BWD_EDGES)
def test_flash_attention_bwd_matches_plain(gen, b, sq, sk, h, hk, causal):
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    do = _randn(gen, b, sq, h, 128)
    out, lse = k1.flash_attention_fwd(q, k, v, causal=causal)
    got = k1.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    tols = k1.bwd_tolerance(q, k, v, do, *ref, causal=causal)
    for name, a, r, t in zip(("dq", "dk", "dv"), got, ref, tols):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        worst = ((a.float() - r.float()).abs() / t).max().item()
        assert worst <= 1.0, f"{name} worst err/tol {worst:.3f}"


#: K7's rows: N = 1, N below the SMs, N off the grid's split (1000 rows
#: on 132 CTAs), H at its limit, the train step's shape plus one row
_RMS_SHAPES = [(37, 4096), (1, 256), (65, 1000), (1, 4096), (1000, 4096),
               (133, 8192), (8193, 4096), (300, 8)]


@pytest.mark.parametrize("n,h", _RMS_SHAPES)
def test_rms_norm_fwd_bwd_match_plain(gen, n, h):
    x, g = _randn(gen, n, h), _randn(gen, n, h)
    w = (torch.rand((h,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    out, rstd = k67.rms_norm_fwd(x, w, 1e-5)
    dx, dw = k67.rms_norm_bwd(x, w, rstd, g)
    r_out, r_rstd = k67.rms_norm_fwd_reference(x, w, 1e-5)
    r_dx, r_dw = k67.rms_norm_bwd_reference(x, w, r_rstd, g)
    torch.cuda.synchronize()
    t_out, t_dx, t_dw = k67.tolerances(x, w, g, r_out, r_dx, r_dw)
    assert bool(((out.float() - r_out.float()).abs() <= t_out).all())
    assert bool(((rstd - r_rstd).abs() <= 1e-5 * r_rstd).all())
    assert bool(((dx.float() - r_dx.float()).abs() <= t_dx).all())
    assert bool(((dw - r_dw).abs() <= t_dw).all())


def _adam_case(gen, n, dtype, master, zero_block=False):
    p = (torch.randn((n,), generator=gen, device="cuda") * 0.02).to(dtype)
    st = k8.init_state(p, master)
    grads = []
    for step in range(3):
        gg = torch.randn((n,), generator=gen, device="cuda") * 10 ** -step
        if zero_block:
            gg[:k8.Q8_BLOCK] = 0
        grads.append(gg.to(torch.bfloat16 if dtype == torch.bfloat16
                           else torch.float32))
    return p, st, grads


@pytest.mark.parametrize("n,dtype,master,zero", [
    (1, torch.bfloat16, True, False), (2047, torch.bfloat16, True, False),
    (2049, torch.bfloat16, True, False), (4100, torch.bfloat16, True, True),
    (2049, torch.float32, False, False), (3000, torch.bfloat16, False,
                                          False)])
def test_adamw8bit_matches_plain_bitwise(gen, n, dtype, master, zero):
    p, st, grads = _adam_case(gen, n, dtype, master, zero)
    p_ref, st_ref = p.clone(), {k: v.clone() for k, v in st.items()}
    for step, g in enumerate(grads, start=1):
        for wd in (0.01,):
            k8.adamw8bit_update(p, g, st, 1e-3, step, wd, 1.0, 0.9, 0.999,
                                1e-8)
            k8.adamw8bit_update(p_ref, g, st_ref, 1e-3, step, wd, 1.0, 0.9,
                                0.999, 1e-8, plain=True)
        torch.cuda.synchronize()
        for key in ("m_q", "v_q"):
            assert torch.equal(st[key].view(torch.uint8),
                               st_ref[key].view(torch.uint8)), (key, step)
        for key in ("m_s", "v_s") + (("master",) if master else ()):
            assert torch.equal(st[key], st_ref[key]), (key, step)
        assert torch.equal(p, p_ref), step
    if zero:
        assert st["m_s"][0].item() == pytest.approx(1e-30)


@pytest.mark.parametrize("n,world", [(3 * 2048 + 100, 2), (4096, 4),
                                     (100, 2), (9 * 2048, 4)])
def test_adamw8bit_shard_form_is_bitwise_the_whole_launch(gen, n, world):
    """K8 on ZeRO's block-aligned shards (``sharding.block_shard``): one
    launch a non-empty shard over flat views of the parameter and gradient,
    with the shard's own state (``init_state`` of the shard, as the
    optimizer makes it); a rank that owns no block launches nothing. Three
    steps, the shards' states gathered end to end, bitwise equal to the
    whole-tensor launch."""
    from paddle_tpu_torch.distributed.sharding import block_shard

    p, st_whole, grads = _adam_case(gen, n, torch.bfloat16, True, False)
    whole = p.clone()
    ranges = [block_shard(n, world, r)[:2] for r in range(world)]
    shards = [(lo, hi, k8.init_state(p[lo:hi], True))
              for lo, hi in ranges if hi > lo]
    for step, g in enumerate(grads, start=1):
        k8.adamw8bit_update(whole, g, st_whole, 1e-3, step, 0.01, 1.0, 0.9,
                            0.999, 1e-8)
        before = k8.launches
        for lo, hi, st in shards:
            k8.adamw8bit_update(p[lo:hi], g[lo:hi], st, 1e-3, step, 0.01,
                                1.0, 0.9, 0.999, 1e-8)
        assert k8.launches - before == sum(hi > lo for lo, hi in ranges)
        torch.cuda.synchronize()
        assert torch.equal(p, whole), step
        for key in st_whole:
            got = torch.cat([st[key] for _, _, st in shards])
            if key in ("m_q", "v_q"):
                got, want = got.view(torch.uint8), st_whole[key].view(
                    torch.uint8)
            else:
                want = st_whole[key]
            assert torch.equal(got, want), (key, step)
    empty = torch.zeros(0, dtype=torch.bfloat16, device="cuda")
    before = k8.launches
    k8.adamw8bit_update(empty, empty, k8.init_state(empty, True), 1e-3, 1,
                        0.01, 1.0, 0.9, 0.999, 1e-8)
    assert k8.launches == before


def test_training_wrappers_raise_instead_of_falling_back(gen):
    q = _randn(gen, 1, 64, 2, 128)
    out, lse = k1.flash_attention_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError):                       # CPU/CUDA mix
        k1.flash_attention_bwd(q, q, q, out, lse.cpu(), q, causal=True)
    with pytest.raises(ValueError):                       # f32 do
        k1.flash_attention_bwd(q, q, q, out, lse, q.float(), causal=True)
    with pytest.raises(ValueError):                       # not contiguous
        k1.flash_attention_bwd(q, q, q, out, lse, q.transpose(1, 2)
                               .contiguous().transpose(1, 2), causal=True)
    old = flags.get_flag("flash_bwd_impl")
    try:                          # the fused flag launches K9, not K5
        flags.set_flags({"flash_bwd_impl": "fused"})
        qg = q.clone().requires_grad_(True)
        n5, n9 = k1.bwd_launches, k1.bwd_fused_launches
        k1.flash_attention_train(qg, q, q).backward(q)
        assert (k1.bwd_launches - n5, k1.bwd_fused_launches - n9) == (0, 1)
    finally:
        flags.set_flags({"flash_bwd_impl": old})
    x = _randn(gen, 4, 256)
    with pytest.raises(ValueError):
        k67.rms_norm_fwd(x, x[0].float(), 1e-5)          # f32 weight
    with pytest.raises(ValueError):
        k67.rms_norm_fwd(x[:, :128], x[0, :128], 1e-5)   # not contiguous
    out, rstd = k67.rms_norm_fwd(x, x[0], 1e-5)
    with pytest.raises(ValueError):
        k67.rms_norm_bwd(x, x[0], rstd.cpu(), x)
    xg = x.clone().requires_grad_(True)                   # grad would drop
    with pytest.raises(RuntimeError):
        k67.rms_norm_fwd(xg, x[0], 1e-5)
    with pytest.raises(RuntimeError):
        k2.fused_norm_matmul_pure(xg, x[0], 1e-5, _randn(gen, 256, 8))
    # K4 and K2's quantized forms differentiate x (and norm_w) under their
    # autograd.Functions; scales that require grad would drop theirs
    qw = _qweight(gen, 256, 16, "weight_only_int8", -1)
    qw.scales.requires_grad_(True)
    with pytest.raises(RuntimeError):
        k4.quant_matmul_qw(xg, qw)
    with pytest.raises(RuntimeError):
        k2.fused_norm_matmul_pure(xg, x[0], 1e-5, qw)
    with pytest.raises(RuntimeError):
        k1.flash_attention_fwd(q.clone().requires_grad_(True), q, q)
    p = _randn(gen, 100)
    st = k8.init_state(p, True)
    with pytest.raises(ValueError):                       # int8 param
        k8.adamw8bit_update(torch.zeros(100, dtype=torch.int8,
                                        device="cuda"), p, st, 1e-3, 1,
                            0.0, 1.0, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError):                       # CPU grad
        k8.adamw8bit_update(p, p.cpu(), st, 1e-3, 1, 0.0, 1.0, 0.9, 0.999,
                            1e-8)
    with pytest.raises(ValueError):                       # f16 grad
        k8.adamw8bit_update(p, p.half(), st, 1e-3, 1, 0.0, 1.0, 0.9,
                            0.999, 1e-8)
    old = flags.get_flag("fused_train_fusions")
    try:
        flags.set_flags({"fused_train_fusions": "norm_matmul"})
        with pytest.raises(NotImplementedError):
            k8.adamw8bit_update(p, p, st, 1e-3, 1, 0.0, 1.0, 0.9, 0.999,
                                1e-8)
    finally:
        flags.set_flags({"fused_train_fusions": old})


def test_train_executor_raises_with_norm_matmul_off(gen):
    """With the norm_matmul train family off, the flag-resolved TRAIN plans
    would run the q/k/v, gate/up and head matmuls apart from their norm,
    bypassing K2, on the card: they raise; ``enabled=()`` runs the
    unfused chain (the norm in K6)."""
    h = 128
    prms = {"lm_head.weight": _randn(gen, h, h),
            "model.norm.weight": torch.ones(h, device="cuda",
                                            dtype=torch.bfloat16)}
    hidden = _randn(gen, 2, h)
    old = flags.get_flag("fused_train_fusions")
    try:
        flags.set_flags({"fused_train_fusions": "attn_epilogue,"
                                                "optimizer_update"})
        with pytest.raises(NotImplementedError):
            fusion.run_train_lm_head(prms, hidden, 1e-5)
        with pytest.raises(NotImplementedError):
            fusion.run_train_decoder_layer(prms, hidden, 1e-5, attend=None)
        n6 = k67.fwd_launches
        ref = fusion.run_train_lm_head(prms, hidden, 1e-5, enabled=())
        assert k67.fwd_launches - n6 == 1
    finally:
        flags.set_flags({"fused_train_fusions": old})
    n2 = k2.launches
    y = fusion.run_train_lm_head(prms, hidden, 1e-5)     # K2, with a VJP
    assert k2.launches - n2 == 1
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())


def test_autograd_entries_launch_the_kernels(gen):
    """fused_rms_norm and flash_attention_train launch K6/K7 and K1/K5
    under autograd; their gradients equal the wrappers' own."""
    x = _randn(gen, 33, 512).requires_grad_(True)
    w = (torch.rand((512,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16).requires_grad_(True)
    g = _randn(gen, 33, 512)
    n6, n7 = k67.fwd_launches, k67.bwd_launches
    y = k67.fused_rms_norm(x, w, 1e-5)
    y.backward(g)
    assert (k67.fwd_launches - n6, k67.bwd_launches - n7) == (1, 1)
    with torch.no_grad():
        _, rstd = k67.rms_norm_fwd(x, w, 1e-5)
        dx, dw = k67.rms_norm_bwd(x, w, rstd, g)
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw.to(w.dtype))
    q = _randn(gen, 1, 70, 4, 128).requires_grad_(True)
    kv = _randn(gen, 1, 70, 2, 128).requires_grad_(True)
    do = _randn(gen, 1, 70, 4, 128)
    n1, n5 = k1.launches, k1.bwd_launches
    k1.flash_attention_train(q, kv, kv).backward(do)
    assert (k1.launches - n1, k1.bwd_launches - n5) == (1, 1)
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape


#: (group sizes, K, N): an empty middle group with boundaries inside
#: tiles, an empty first and last group, every row in one group, T = 1,
@pytest.mark.parametrize("n,h", [(1, 256), (1000, 4096), (8193, 4096)])
def test_rms_norm_bwd_is_deterministic(gen, n, h):
    """K7 sums dw per CTA in row order and the CTAs' partials in a fixed
    order, with no float atomics: two calls give the same bits."""
    x, g = _randn(gen, n, h), _randn(gen, n, h)
    w = (torch.rand((h,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    _, rstd = k67.rms_norm_fwd(x, w, 1e-5)
    (dx0, dw0), (dx1, dw1) = (k67.rms_norm_bwd(x, w, rstd, g)
                              for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(dx0, dx1) and torch.equal(dw0, dw1)


#: and K / N off the 32- and 128-wide slices
_GROUPS = [((37, 0, 200, 91), 256, 384), ((0, 300, 5, 0), 72, 200),
           ((0, 0, 513, 0), 128, 136), ((1,), 4096, 128),
           ((128, 128, 129, 127), 1024, 2048)]


#: groups of 1, 63, 65 and 4,915 rows: more K13 and K14 items (387 and
#: 288, ``gmm_items`` / ``sdw_items``) than two per SM of the persistent
#: grid
_MANY = ((1, 63, 65, 4915), 1024, 2304)
#: 64 experts, a third of them empty and many of equal size (the order
#: K14 ranks on the card), boundaries anywhere
_WIDE = (tuple(0 if i % 3 == 0 else (i * 37) % 5 * 16 + i % 7
               for i in range(64)), 256, 512)
#: K and N narrower than one 64-column TMA box
_NARROW = ((5, 0, 3), 8, 16)


def _offsets(sizes):
    off = [0]
    for n in sizes:
        off.append(off[-1] + n)
    return torch.tensor(off, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("sizes,kdim,n", _GROUPS + [_MANY, _WIDE, _NARROW])
@pytest.mark.parametrize("trans", [False, True])
def test_grouped_matmul_matches_plain(gen, sizes, kdim, n, trans):
    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    x = _randn(gen, t, kdim)
    w = _randn(gen, e, n, kdim, scale=0.05) if trans else _randn(
        gen, e, kdim, n, scale=0.05)
    n0 = k1314.launches
    got = k1314.gmm(x, off, w, trans_w=trans)
    assert k1314.launches - n0 == 1
    ref = k1314.grouped_matmul_reference(x, off, w, trans_w=trans)
    torch.cuda.synchronize()
    tol = k1314.tolerance(x, off, w, ref, trans_w=trans)
    err = ((got.float() - ref.float()).abs() / tol).max().item()
    assert err < 1.0, err


@pytest.mark.parametrize("sizes,kdim,n", _GROUPS + [_MANY, _WIDE, _NARROW,
                                                     ((0, 0, 0), 128, 256)])
@pytest.mark.parametrize("scale,dtype", [(None, torch.float32),
                                         (0.5, torch.bfloat16)])
def test_segment_dw_matches_plain(gen, sizes, kdim, n, scale, dtype):
    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    x, dy = _randn(gen, t, kdim), _randn(gen, t, n)
    n0 = k1314.dw_launches
    got = k1314.segment_dw(x, dy, off, e, scale=scale, out_dtype=dtype)
    assert k1314.dw_launches - n0 == 1 and got.dtype == dtype
    ep = ((("scale", scale),) if scale else ()) + (("cast", dtype),)
    ref = k1314.segment_dw_reference(x, dy, off, e, ep)
    torch.cuda.synchronize()
    tol = k1314.dw_tolerance(x, dy, off, e, ref)
    err = ((got.float() - ref.float()).abs() / tol).max().item()
    assert err < 1.0, err
    for g, size in enumerate(sizes):
        if not size:
            assert not got[g].any(), f"empty group {g} not zero"


@pytest.mark.parametrize("sizes,bm", [((37, 0, 200, 91), 128),
                                      ((0, 300, 5, 0), 128),
                                      ((0, 0, 513, 0), 16), ((1,), 128)])
@pytest.mark.parametrize("min_one_step", [False, True])
def test_group_walk_on_the_card_matches_group_tile_walk(gen, sizes, bm,
                                                        min_one_step):
    from paddle_tpu_torch.ops.kernels import _build

    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    n_tiles = -(-t // bm)
    n_steps = n_tiles + e - 1
    out = [torch.empty(n_steps, dtype=torch.int32, device="cuda")
           for _ in range(4)]
    _build.launch("pt_group_tile_walk", off.data_ptr(), e, t, bm, n_tiles,
                  int(min_one_step), n_steps, *(o.data_ptr() for o in out),
                  _build.stream_of(off))
    ref = k1314.group_tile_walk(off, bm, n_tiles, e, min_one_step)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("sizes,kdim,n", [_GROUPS[0], _GROUPS[1], _MANY,
                                         _WIDE])
def test_grouped_schedules_on_the_card_match_the_model(gen, sizes, kdim, n):
    from paddle_tpu_torch.ops.kernels import _build

    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    for entry, model, args in (
            ("pt_grouped_matmul_items", k1314.gmm_items,
             (t, kdim, n, e, k1314.TILE_N)),
            ("pt_segment_dw_items", k1314.sdw_items, (t, kdim, n, e))):
        want = model(off.tolist(), t, kdim, n)
        out = torch.full((len(want), 6), -1, dtype=torch.int32, device="cuda")
        _build.launch(entry, off.data_ptr(), *args, out.data_ptr(),
                      _build.stream_of(off))
        assert out.cpu().tolist() == [list(it) for it in want], entry


@pytest.mark.parametrize("form", ["forward", "dx", "dw_f32", "dw_bf16"])
def test_grouped_kernels_are_deterministic(gen, form):
    off = _offsets((300, 0, 517, 211))
    t = int(off[-1])
    x = _randn(gen, t, 512)
    if form in ("forward", "dx"):   # w (E, K, N), or (E, N, K) for dX
        w = _randn(gen, 4, *((768, 512) if form == "dx" else (512, 768)),
                   scale=0.05)
        calls = [k1314.gmm(x, off, w, trans_w=form == "dx")
                 for _ in range(2)]
    else:
        dy = _randn(gen, t, 768)
        dt = torch.float32 if form == "dw_f32" else torch.bfloat16
        calls = [k1314.segment_dw(x, dy, off, 4, scale=0.5, out_dtype=dt)
                 for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*calls)


def test_grouped_kernels_launch_from_a_fresh_thread(gen):
    """The first launch of a thread (an autograd worker's, say) binds the
    context the tensor maps need: each form from a new thread matches the
    same call from this one."""
    import threading

    off = _offsets((100, 0, 200, 57))
    x, dy = _randn(gen, 357, 256), _randn(gen, 357, 512)
    w = _randn(gen, 4, 256, 512, scale=0.05)
    forms = [lambda: k1314.gmm(x, off, w),
             lambda: k1314.gmm(dy, off, w, trans_w=True),
             lambda: k1314.segment_dw(x, dy, off, 4)]
    for fn in forms:
        got = []
        worker = threading.Thread(target=lambda: got.append(fn()))
        worker.start()
        worker.join()
        torch.cuda.synchronize()
        assert len(got) == 1 and torch.equal(got[0], fn())


def test_grouped_matmul_autograd_matches_plain(gen):
    off = _offsets((100, 0, 200, 57))
    x = _randn(gen, 357, 256).requires_grad_(True)
    w = _randn(gen, 4, 256, 512, scale=0.05).requires_grad_(True)
    dy = _randn(gen, 357, 512)
    n13, n14 = k1314.launches, k1314.dw_launches
    k1314.grouped_matmul(x, off, w).backward(dy)
    assert (k1314.launches - n13, k1314.dw_launches - n14) == (2, 1)
    xp, wp = (a.detach().clone().requires_grad_(True) for a in (x, w))
    k1314.grouped_matmul(xp, off, wp, plain=True).backward(dy)
    assert (k1314.launches - n13, k1314.dw_launches - n14) == (2, 1)
    with torch.no_grad():
        t_dx = k1314.tolerance(dy, off, w, xp.grad, trans_w=True)
        t_dw = k1314.dw_tolerance(x, dy, off, 4, wp.grad)
    assert ((x.grad.float() - xp.grad.float()).abs() / t_dx).max() < 1
    assert ((w.grad.float() - wp.grad.float()).abs() / t_dw).max() < 1
    assert not w.grad[1].any()


def test_moe_train_step_launches_its_plan(gen):
    """A small bf16 MoE (every projection a multiple of 128) takes one
    AdamW8bit TrainStep on the card: the launches equal its plan and the
    loss is finite."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW8bit

    cfg = MoEConfig(vocab_size=512, hidden_size=256, intermediate_size=384,
                    num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=1, num_experts=4, top_k=2,
                    dtype="bfloat16")
    model = MoEForCausalLM(cfg, seed=0)
    n_tensors = sum(1 for _ in model.parameters())
    step = TrainStep(model, lambda o, lb: model.loss(o, lb),
                     AdamW8bit(learning_rate=1e-3,
                               parameters=model.parameters()))
    ids = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    loss = step(ids, ids)
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(fusion.moe_train_kernel_launches_per_step(2, n_tensors))
    assert counts == want
    assert math.isfinite(loss.item())


def test_grouped_wrappers_raise_instead_of_falling_back(gen):
    off = _offsets((10, 0, 22))
    x, w, dy = _randn(gen, 32, 128), _randn(gen, 3, 128, 64), _randn(gen,
                                                                      32, 64)
    for name, val in (("grouped_matmul_kernel", False),
                      ("fused_train_fusions", "norm_matmul")):
        old = flags.get_flag(name)
        try:
            flags.set_flags({name: val})
            with pytest.raises(NotImplementedError):
                if name == "grouped_matmul_kernel":
                    k1314.gmm(x, off, w)
                else:
                    k1314.segment_dw_pure(x, dy, off, 3,
                                          epilogue=(("cast", w.dtype),))
        finally:
            flags.set_flags({name: old})
    with pytest.raises(ValueError):                       # f32 x
        k1314.gmm(x.float(), off, w)
    with pytest.raises(ValueError):                       # K % 8
        k1314.gmm(x[:, :100].contiguous(), off, w[:, :100].contiguous())
    with pytest.raises(ValueError):                       # K mismatch
        k1314.gmm(x, off, w, trans_w=True)
    with pytest.raises(ValueError):                       # int64 offsets
        k1314.gmm(x, off.long(), w)
    with pytest.raises(ValueError):                       # E + 1 offsets
        k1314.gmm(x, off[:-1], w)
    with pytest.raises(ValueError):                       # dy rows
        k1314.segment_dw(x, dy[:16], off, 3)
    with pytest.raises(ValueError):                       # f16 output
        k1314.segment_dw(x, dy, off, 3, out_dtype=torch.float16)
    with pytest.raises(NotImplementedError):              # epilogue order
        k1314.segment_dw_pure(x, dy, off, 3, epilogue=(
            ("cast", torch.float32), ("scale", 2.0)))
    with pytest.raises(RuntimeError):                     # grad would drop
        k1314.gmm(x.clone().requires_grad_(True), off, w)
    # an operand off a 16-byte boundary (TMA's): a contiguous view one
    # element into its storage
    def shifted(a):
        return torch.cat([a.reshape(-1), a.reshape(-1)[:8]])[
            1:1 + a.numel()].view(a.shape)

    for a in (shifted(x), shifted(w), shifted(dy)):
        assert a.is_contiguous() and a.data_ptr() % 16
    with pytest.raises(ValueError):
        k1314.gmm(shifted(x), off, w)
    with pytest.raises(ValueError):
        k1314.gmm(x, off, shifted(w))
    with pytest.raises(ValueError):
        k1314.segment_dw(x, shifted(dy), off, 3)


#: K13's int8/int4 forms take K % 128 == 0 and N % 16 == 0: the routings
#: of ``_GROUPS + [_MANY, _WIDE]`` that meet it, and the others' routings
#: at K 128, N 144
_QUANT_ROUTINGS = [r for r in _GROUPS + [_MANY, _WIDE]
                   if r[1] % 128 == 0 and r[2] % 16 == 0] + [
    (sizes, 128, 144) for sizes, kdim, n in _GROUPS + [_NARROW]
    if kdim % 128 or n % 16]
#: the group-wise forms' own edges: K = 1152 is 18 slices (the 4-stage
#: ring wraps off its end) and 9 groups of 128 (an odd count) or 18 of
#: 64; group boundaries at rows 37, 167 and 467, inside row tiles; N one
#: 16-column piece past three 128-column tiles
_GROUP_WISE_EDGES = ((37, 130, 0, 300), 1152, 400)
_QUANT_ROUTINGS.append(_GROUP_WISE_EDGES)
#: (weight type, group size) of every quantized form
_QUANT_FORMS = [("int8", -1), ("int8", 64), ("int8", 128), ("int4", -1),
                ("int4", 64), ("int4", 128)]


def _experts(gen, e, kdim, n, wd, gs):
    """A seeded (E, K, N) expert stack quantized on the card."""
    w = torch.randn((e, kdim, n), generator=gen, device="cuda") / math.sqrt(
        kdim)
    return k1314.quantize_grouped_weight(w, f"weight_only_{wd}", gs)


def test_quant_routings_cover_every_grouping():
    assert len(_QUANT_ROUTINGS) == 9
    assert sorted(r[0] for r in _QUANT_ROUTINGS) == sorted(
        r[0] for r in _GROUPS + [_MANY, _WIDE, _NARROW, _GROUP_WISE_EDGES])


@pytest.mark.parametrize("wd,gs", _QUANT_FORMS)
@pytest.mark.parametrize("sizes,kdim,n", _QUANT_ROUTINGS)
def test_grouped_matmul_quant_matches_plain(gen, sizes, kdim, n, wd, gs):
    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    x = _randn(gen, t, kdim)
    codes, scales = _experts(gen, e, kdim, n, wd, gs)
    n0, n13 = k1314.quant_launches, k1314.launches
    got = k1314.gmm_quant(x, off, codes, scales, wd, gs)
    assert (k1314.quant_launches - n0, k1314.launches - n13) == (1, 0)
    ref = k1314.grouped_matmul_reference(x, off, codes, scales, wd, gs)
    torch.cuda.synchronize()
    tol = k1314.quant_tolerance(x, off, codes, scales, wd, gs, ref)
    err = ((got.float() - ref.float()).abs() / tol).max().item()
    assert err < 1.0, err
    if t * n >= 32768:
        # the fault control: the scales shifted by 16 columns fail the
        # rule (a few hundred outputs may all sit inside its 2^-8 term)
        bad = k1314.gmm_quant(x, off, codes,
                              scales.roll(16, -1).contiguous(), wd, gs)
        assert ((bad.float() - ref.float()).abs() / tol).max().item() > 1


@pytest.mark.parametrize("gs", [-1, 64])
@pytest.mark.parametrize("sizes,kdim,n", [_QUANT_ROUTINGS[0], _MANY, _WIDE,
                                         _QUANT_ROUTINGS[-1]])
def test_grouped_quant_items_on_the_card_match_the_model(gen, sizes, kdim, n,
                                                        gs):
    from paddle_tpu_torch.ops.kernels import _build

    off = _offsets(sizes)
    t, e = int(off[-1]), len(sizes)
    bn = k1314.quant_tile_n(gs)
    want = k1314.gmm_items(off.tolist(), t, kdim, n, bn)
    out = torch.full((len(want), 6), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_grouped_matmul_items", off.data_ptr(), t, kdim, n, e,
                  bn, out.data_ptr(), _build.stream_of(off))
    assert out.cpu().tolist() == [list(it) for it in want]


@pytest.mark.parametrize("wd,gs", _QUANT_FORMS)
def test_grouped_matmul_quant_is_deterministic(gen, wd, gs):
    off = _offsets((300, 0, 517, 211))
    x = _randn(gen, int(off[-1]), 512)
    codes, scales = _experts(gen, 4, 512, 768, wd, gs)
    calls = [k1314.gmm_quant(x, off, codes, scales, wd, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*calls)


def test_grouped_matmul_quant_launches_from_a_fresh_thread(gen):
    import threading

    off = _offsets((100, 0, 200, 57))
    x = _randn(gen, 357, 256)
    for wd, gs in (("int8", -1), ("int4", 128)):
        codes, scales = _experts(gen, 4, 256, 512, wd, gs)
        got = []
        worker = threading.Thread(target=lambda: got.append(
            k1314.gmm_quant(x, off, codes, scales, wd, gs)))
        worker.start()
        worker.join()
        torch.cuda.synchronize()
        assert len(got) == 1 and torch.equal(
            got[0], k1314.gmm_quant(x, off, codes, scales, wd, gs))


@pytest.mark.parametrize("wd,gs", [("int8", -1), ("int4", 64)])
def test_grouped_matmul_quant_autograd_matches_plain(gen, wd, gs):
    """dx through the bf16 dequantized stack and K13's transposed form
    against the plain rule (f32 stack, f32 dy): K13's summation bound
    (``tolerance``) plus one bf16 rounding of each dequantized weight,
    2^-8 * (|dy| @ |W|^T)."""
    off = _offsets((100, 0, 200, 57))
    x = _randn(gen, 357, 256).requires_grad_(True)
    codes, scales = _experts(gen, 4, 256, 512, wd, gs)
    dy = _randn(gen, 357, 512)
    n13, nq, n14 = k1314.launches, k1314.quant_launches, k1314.dw_launches
    k1314.grouped_matmul(x, off, codes, scales, wd, gs).backward(dy)
    assert (k1314.launches - n13, k1314.quant_launches - nq,
            k1314.dw_launches - n14) == (1, 1, 0)
    xp = x.detach().clone().requires_grad_(True)
    k1314.grouped_matmul(xp, off, codes, scales, wd, gs,
                         plain=True).backward(dy)
    assert (k1314.launches - n13, k1314.quant_launches - nq) == (1, 1)
    with torch.no_grad():
        w32 = k1314._expand_expert_weight(codes, scales, wd, gs, 256,
                                          torch.float32)
        spread = k1314.grouped_matmul_reference(dy.float().abs(), off,
                                                w32.abs(), trans_w=True)
        tol = (k1314.tolerance(dy, off, w32.to(torch.bfloat16), xp.grad,
                               trans_w=True) + 2.0 ** -8 * spread)
    assert ((x.grad.float() - xp.grad.float()).abs() / tol).max() < 1


def test_quantized_moe_launches_its_plan(gen):
    """A small bf16 MoE (every expert width a multiple of 128) after
    ``quantize_experts``: one forward + backward launches the plan's K13
    int8 forwards and K13 dX, no K14, and gives finite logits."""
    from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.ops import kernels

    cfg = MoEConfig(vocab_size=512, hidden_size=256, intermediate_size=384,
                    num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=1, num_experts=4, top_k=2,
                    dtype="bfloat16")
    model = MoEForCausalLM(cfg, seed=0).quantize_experts("weight_only_int8")
    model.train()
    ids = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    logits, aux = model(ids)
    model.loss((logits, aux), ids).backward()
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(fusion.moe_train_kernel_launches_per_step(
        2, 0, quantized_experts=True))
    assert counts == want
    assert torch.isfinite(logits).all()


def test_grouped_matmul_quant_raises_instead_of_falling_back(gen):
    off = _offsets((10, 0, 22))
    x = _randn(gen, 32, 128)
    codes, scales = _experts(gen, 3, 128, 64, "int8", -1)
    old = flags.get_flag("grouped_matmul_kernel")
    try:
        flags.set_flags({"grouped_matmul_kernel": False})
        with pytest.raises(NotImplementedError):
            k1314.gmm_quant(x, off, codes, scales, "int8", -1)
    finally:
        flags.set_flags({"grouped_matmul_kernel": old})
    with pytest.raises(RuntimeError):                     # grad would drop
        k1314.gmm_quant(x.clone().requires_grad_(True), off, codes, scales,
                        "int8", -1)
    c4, s4 = _experts(gen, 3, 128, 64, "int4", 64)
    for what, args in {
            "f32 x": (x.float(), off, codes, scales, "int8", -1),
            "K % 128": (x[:, :64].contiguous(), off,
                        codes[:, :64].contiguous(), scales, "int8", -1),
            "N % 16": (x, off, codes[..., :56].contiguous(),
                       scales[..., :56].contiguous(), "int8", -1),
            "int4 codes of K rows": (x, off, codes, s4, "int4", 64),
            "per-channel scales for group-wise": (x, off, c4, scales,
                                                  "int4", 64),
            "f64 scales": (x, off, codes, scales.double(), "int8", -1),
            "group size 32": (x, off, codes, scales, "int8", 32),
            "uint8 codes": (x, off, codes.view(torch.uint8), scales, "int8",
                            -1),
            "int64 offsets": (x, off.long(), codes, scales, "int8", -1),
            "E + 1 offsets": (x, off[:-1], codes, scales, "int8", -1),
            "int2": (x, off, codes, scales, "int2", -1)}.items():
        with pytest.raises(ValueError):
            k1314.gmm_quant(*args)
            pytest.fail(f"K13 int8/int4 accepted {what}")



# --------------------------------------------------------------------------
# fine-tuning: K1/K5 with a key bias, K9 one-pass backward, K12 rope, clip
# --------------------------------------------------------------------------


def _left_pad_bias(b, sk, pads):
    """The (B, Sk) f32 key bias of a left-padded batch: row i's first
    pads[i] keys masked (-1e30)."""
    keep = torch.arange(sk, device="cuda")[None, :] >= torch.tensor(
        pads, device="cuda")[:, None]
    return k1._key_bias_from_mask(keep, b, sk)[0], keep


@pytest.mark.parametrize("b,sq,sk,h,hk,causal,pads", [
    (2, 130, 130, 8, 2, True, (0, 70)), (2, 100, 100, 4, 4, True, (99, 3)),
    (1, 64, 200, 4, 1, True, (150,)), (2, 77, 77, 4, 1, False, (10, 0)),
    # the first whole key tiles masked in one row and not in the other:
    # skipped and computed tiles meet, rows that see no key (dO not 0)
    (2, 300, 300, 8, 1, True, (200, 0)), (2, 150, 260, 8, 8, False, (0, 140)),
    (2, 200, 300, 4, 1, True, (129, 64))])
@pytest.mark.parametrize("impl", ["split", "fused"])
def test_flash_attention_bias_forms_match_plain(gen, b, sq, sk, h, hk,
                                                causal, pads, impl):
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    bias, _ = _left_pad_bias(b, sk, pads)
    do = _randn(gen, b, sq, h, 128)      # not 0 on the rows that see no key
    out, lse = k1.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
    ref, r_lse = k1.flash_attention_fwd_reference(q, k, v, causal, None,
                                                  bias)
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(lse).all())
    t = k1.fwd_tolerance(q, k, v, ref, causal=causal, bias=bias)
    worst = ((out.float() - ref.float()).abs() / t).max().item()
    assert worst <= 1.0, f"K1 with bias: worst err/tol {worst:.3f}"
    lse_err = (lse - r_lse).abs().max().item()
    assert lse_err <= 1e-3
    bwd = (k1.flash_attention_bwd_fused if impl == "fused"
           else k1.flash_attention_bwd)
    got = bwd(q, k, v, out, lse, do, causal=causal, bias=bias)
    r = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                         None, bias)
    torch.cuda.synchronize()
    tols = k1.bwd_tolerance(q, k, v, do, *r, causal=causal, bias=bias)
    for name, a, rr, tt in zip(("dq", "dk", "dv"), got, r, tols):
        assert bool(torch.isfinite(a.float()).all()), name
        w = ((a.float() - rr.float()).abs() / tt).max().item()
        assert w <= 1.0, f"{impl} {name} worst err/tol {w:.3f}"
    # the bias matters: without it the real rows' output moves
    free, _ = k1.flash_attention_fwd(q, k, v, causal=causal)
    if any(pads):
        assert ((free.float() - ref.float()).abs() / t).max() > 1.0


@pytest.mark.parametrize("b,sq,sk,h,hk,causal",
                         _BWD_EDGES + [(1, 200, 64, 4, 2, True)])
def test_flash_attention_bwd_fused_matches_plain(gen, b, sq, sk, h, hk,
                                                 causal):
    q = _randn(gen, b, sq, h, 128)
    k, v = _randn(gen, b, sk, hk, 128), _randn(gen, b, sk, hk, 128)
    do = _randn(gen, b, sq, h, 128)
    out, lse = k1.flash_attention_fwd(q, k, v, causal=causal)
    n9 = k1.bwd_fused_launches
    got = k1.flash_attention_bwd_fused(q, k, v, out, lse, do, causal=causal)
    assert k1.bwd_fused_launches - n9 == 1
    ref = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    tols = k1.bwd_tolerance(q, k, v, do, *ref, causal=causal)
    for name, a, r, t in zip(("dq", "dk", "dv"), got, ref, tols):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        worst = ((a.float() - r.float()).abs() / t).max().item()
        assert worst <= 1.0, f"{name} worst err/tol {worst:.3f}"


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("pads", [None, (130, 0)])
def test_flash_attention_bwd_is_deterministic(gen, impl, pads):
    """K5 and K9 sum in a fixed order with no atomics: two calls on the
    same inputs give the same bits, with and without key tiles skipped."""
    b, s, h, hk = 2, 260, 8, 2
    q, do = _randn(gen, b, s, h, 128), _randn(gen, b, s, h, 128)
    k, v = _randn(gen, b, s, hk, 128), _randn(gen, b, s, hk, 128)
    bias = None if pads is None else _left_pad_bias(b, s, pads)[0]
    out, lse = k1.flash_attention_fwd(q, k, v, True, None, bias)
    bwd = (k1.flash_attention_bwd_fused if impl == "fused"
           else k1.flash_attention_bwd)
    first = bwd(q, k, v, out, lse, do, True, None, bias)
    for _ in range(2):
        again = bwd(q, k, v, out, lse, do, True, None, bias)
        for name, a, c in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, c), f"{impl} {name} differs between calls"


def test_flash_fused_wrapper_raises_instead_of_falling_back(gen):
    q = _randn(gen, 1, 64, 2, 128)
    out, lse = k1.flash_attention_fwd(q, q, q, causal=True)
    bias, _ = _left_pad_bias(1, 64, (3,))
    for bad in (dict(lse=lse.cpu()), dict(do=q.float()),
                dict(do=q.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(bias=bias.to(torch.bfloat16)), dict(bias=bias[:, :32]),
                dict(q=_randn(gen, 1, 64, 2, 64))):
        args = dict(q=q, k=q, v=q, out=out, lse=lse, do=q, bias=bias)
        args.update(bad)
        with pytest.raises(ValueError):
            k1.flash_attention_bwd_fused(args["q"], args["k"], args["v"],
                                         args["out"], args["lse"],
                                         args["do"], causal=True,
                                         bias=args["bias"])
    with pytest.raises(ValueError):                       # f16 bias in K1
        k1.flash_attention_fwd(q, q, q, True, None, bias.half())
    with pytest.raises(RuntimeError):                     # grad would drop
        k1.flash_attention_bwd_fused(q.clone().requires_grad_(True), q, q,
                                     out, lse, q, causal=True)


#: K12's shapes: D/2 on either side of 16 bytes of elements (8 bf16, 4 f32:
#: the vector instance at D 16 / 8, the scalar one at D 14 / 12, 6, 250),
#: a CTA of several positions (H 3, H 8), more column groups than threads
#: (D 4112), and the train step's q and k
ROPE_SHAPES = [
    ((2, 37, 3, 128), torch.bfloat16), ((1, 5, 2, 6), torch.float32),
    ((4, 64, 8, 128), torch.float32), ((1, 9, 1, 250), torch.bfloat16),
    ((2, 7, 3, 16), torch.bfloat16), ((2, 7, 3, 14), torch.bfloat16),
    ((2, 7, 3, 8), torch.float32), ((2, 7, 3, 12), torch.float32),
    ((1, 2, 1, 4112), torch.float32)] + [
    ((4, 2048, h, 128), dt) for h in (32, 8)
    for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape,dtype", ROPE_SHAPES)
def test_rope_matches_plain_bitwise(gen, shape, dtype):
    b, s, h, d = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    emb = torch.randn((s, d), generator=gen, device="cuda")
    cos, sin = emb.cos(), emb.sin()               # random tables
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    n = k67.rope_launches
    xk = x.clone().requires_grad_(True)
    y = k67.fused_rope(xk, cos, sin)
    y.backward(g)
    assert k67.rope_launches - n == 2             # forward, transposed
    xr = x.clone().requires_grad_(True)
    yr = k67.fused_rope(xr, cos, sin, plain=True)
    yr.backward(g)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, yr)
    assert torch.equal(xk.grad, xr.grad)
    # the transposed instance alone: one launch, the plain route's bits
    n = k67.rope_launches
    dx = k67.rope_fwd(g, cos, sin, transpose=True)
    assert k67.rope_launches - n == 1
    assert torch.equal(dx, k67.rope_reference(g, cos,
                                              k67.rope_bwd_table(sin)))
    # two calls, the same bits
    assert torch.equal(k67.rope_fwd(x, cos, sin), y)
    assert torch.equal(k67.rope_fwd(g, cos, sin, transpose=True), dx)
    # the VJP: <rope(x), g> = <x, rope^T(g)> up to f32 rounding
    lhs = (yr.double() * g.double()).sum()
    rhs = (x.double() * xr.grad.double()).sum()
    assert abs(lhs - rhs) <= 1e-2 * (1 + abs(lhs))


def test_rope_wrapper_raises_instead_of_falling_back(gen):
    x = _randn(gen, 1, 8, 2, 128)
    cos = torch.ones((8, 128), device="cuda")
    for transpose in (False, True):
        for bad in (dict(x=x.half()), dict(x=x.cpu()), dict(cos=cos.half()),
                    dict(cos=cos[:4]), dict(sin=cos.t().contiguous()[:8]),
                    dict(sin=cos.half()), dict(x=x.transpose(1, 2)),
                    dict(x=_randn(gen, 1, 8, 2, 7))):
            args = dict(x=x, cos=cos, sin=cos)
            args.update(bad)
            with pytest.raises((ValueError, RuntimeError)):
                k67.rope_fwd(args["x"], args["cos"], args["sin"],
                             transpose=transpose)
        with pytest.raises(RuntimeError):                 # grad would drop
            k67.rope_fwd(x.clone().requires_grad_(True), cos, cos,
                         transpose=transpose)


def test_train_attend_seam_equals_the_chain_bitwise(gen):
    """The training attend seam ropes q and k in K12: its output and its
    q/k/v gradients equal those of the f32 rotate-half chain it ran
    before (``apply_rotary_pos_emb`` on f32 copies, cast back) feeding the
    same flash attention."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig(hidden_size=512, num_attention_heads=4,
                            num_key_value_heads=2)
    b, s, hd = 2, 256, cfg.head_dim
    q, k, v = (_randn(gen, b, s, n * hd) for n in (4, 2, 2))
    g = _randn(gen, b, s, 4 * hd)
    cos, sin = _rope_tables(s, hd, cfg.rope_theta, device="cuda")

    def chain(q, k, v):
        q2, k2 = llama.apply_rotary_pos_emb(q.reshape(b, s, 4, hd).float(),
                                            k.reshape(b, s, 2, hd).float(),
                                            cos, sin)
        return k1.flash_attention_train(
            q2.to(q.dtype), k2.to(k.dtype), v.reshape(b, s, 2, hd),
            causal=True).reshape(b, s, 4 * hd)

    runs = []
    for seam in (lambda *a: llama._train_attend(cfg, *a, False, None),
                 chain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n = k67.rope_launches
        out = seam(*leaves)
        out.backward(g)
        runs.append(([out.detach()] + [t.grad for t in leaves],
                     k67.rope_launches - n))
    torch.cuda.synchronize()
    assert runs[0][1] == 4 and runs[1][1] == 0
    for got, want in zip(runs[0][0], runs[1][0]):
        assert torch.equal(got, want)


def test_clip_scale_matches_the_cpu_bitwise(gen):
    """ClipGradByGlobalNorm multiplies a bf16 gradient by its f32 scale in
    f32 and casts once, as the JAX package's ``(g * scale).astype``: the
    card, the CPU and numpy's f32 product agree bit for bit. The gradients'
    squares sum exactly (small multiples of 1/8), so the norm and the scale
    do not depend on the summation order."""
    import numpy as np

    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    vals = torch.randint(-24, 25, (3, 4097), generator=gen, device="cuda")
    grads = [(vals[i] / 8).to(dt) for i, dt in enumerate(
        (torch.bfloat16, torch.bfloat16, torch.float32))]
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    clip = ClipGradByGlobalNorm(1.0)
    got = [g for _, g in clip(list(zip(params, grads)))]
    cpu = [g for _, g in clip([(p.cpu(), g.cpu()) for p, g in
                               zip(params, grads)])]
    cpu_norm = clip.last_global_norm
    sq = sum(np.square(g.float().cpu().numpy().astype(np.float64)).sum()
             for g in grads)                      # exact, and so in f32
    norm = np.sqrt(np.float32(sq))
    want_scale = np.minimum(np.float32(1.0) / norm, np.float32(1.0))
    for a, c, g in zip(got, cpu, grads):
        assert a.dtype == g.dtype and torch.equal(a.cpu(), c)
        ref = g.float().cpu().numpy() * want_scale
        assert torch.equal(c, torch.from_numpy(ref).to(g.dtype))
    assert cpu_norm.item() == float(norm)


# ------------------------------------------- the prefix cache's routed pool

_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
         torch.int8: torch.int8}


def _bits(x):
    """Bit patterns: a NaN cell compares equal to itself."""
    return x.view(_BITS[x.dtype])


def _routed_case(gen, int8, page=16, g=4, hk=2, cap=128):
    """A wave on the prefix cache's table-routed pool (B * pps + pps + 1
    pages, the last the park page): slot 0 decodes at 40 and slot 2 at 70,
    both reading the same first 2 pages; slot 1 prefills 10 rows on 20
    cells; slot 3 is empty, its row all park page; each row's entries past
    the slot's pages repeat its own last page; page P - 2, referenced by no
    row, is full of NaN (int8: its scales). Returns (cache, rows, wave,
    park, nan page, shared pages)."""
    b, pps = 4, cap // page
    p_total = b * pps + pps + 1
    park, nan_page = p_total - 1, p_total - 2
    cache = kv_cache.create_paged_cache(
        2, b, cap, hk, 128, page, dtype=torch.int8 if int8 else torch.bfloat16,
        extra_pages=pps + 1, device="cuda")
    if int8:
        for pool in (cache.k_pages, cache.v_pages):
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        for pool in (cache.k_scales, cache.v_scales):
            pool.copy_(torch.rand(pool.shape, generator=gen, device="cuda")
                       * 0.03)
    else:
        for pool in (cache.k_pages, cache.v_pages):
            pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    free = torch.randperm(nan_page, generator=gen, device="cuda").tolist()
    shared = [free.pop() for _ in range(2)]
    seq, lens_q, fresh = [40, 20, 70, 0], [1, 10, 1, 0], [0, 10, 0, 0]
    bt = torch.full((b, pps), park, dtype=torch.int32)
    for i in range(3):
        n = -(-(seq[i] + lens_q[i] + 1) // page)
        own = [free.pop() for _ in range(n)]
        if i in (0, 2):
            own[:2] = shared
        bt[i, :n] = torch.tensor(own)
        bt[i, n:] = own[-1]
    poison = cache.k_scales if int8 else cache.k_pages
    poison[:, :, nan_page] = float("nan")
    i32 = dict(dtype=torch.int32, device="cuda")
    cache = cache._replace(block_tables=bt.to("cuda"),
                           seq_lens=torch.tensor(seq, **i32))
    t = 16
    q_start, row_slot, row_pos, r = [], [], [], 0
    for i, n in enumerate(lens_q):
        q_start.append(r if n else 0)
        row_slot += [i] * n
        row_pos += [seq[i] + j for j in range(n)]
        r += n
    row_slot += [-1] * (t - r)
    row_pos += [0] * (t - r)
    page_lens = [s + 1 if (n == 1 and f == 0) else (s if n else 0)
                 for s, n, f in zip(seq, lens_q, fresh)]
    rs = torch.tensor(row_slot, **i32)
    wave = (rs, torch.tensor(row_pos, **i32), rs >= 0,
            torch.tensor(page_lens, **i32), torch.tensor(q_start, **i32),
            torch.tensor(lens_q, **i32), torch.tensor(fresh, **i32))
    cos_t, sin_t = _rope_tables(cap, 128, 10000.0, device="cuda")
    pos = wave[1].long()
    rows = (_randn(gen, t, hk * g, 128), _randn(gen, t, hk, 128),
            _randn(gen, t, hk, 128), cos_t[pos], sin_t[pos])
    return cache, rows, wave, park, nan_page, shared


def _routed_pools_check(new, ref, old, written, park, shared):
    """Pools against the plain chain's (bf16 bitwise; int8 codes within 1,
    scales bitwise), every cell outside ``written`` as it was, and the
    park page and the shared pages bitwise unchanged."""
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, r, o = (getattr(c, name) for c in (new, ref, old))
        if a is None:
            continue
        if a.dtype == torch.int8:
            assert int((a.int() - r.int()).abs().max()) <= 1, name
        else:
            assert torch.equal(_bits(a), _bits(r)), name
        keep = (~written)[..., None].expand_as(a)
        assert torch.equal(_bits(a)[keep], _bits(o)[keep]), name
        for pg in [park] + shared:
            assert torch.equal(_bits(a[:, :, pg]), _bits(o[:, :, pg])), \
                (name, pg)


@pytest.mark.parametrize("form", ["K11", "K3 ragged", "K3 fresh_pool_read",
                                  "K3 masked", "K10"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_batcher_kernels_on_a_routed_pool(gen, form, int8):
    """The batcher's attention kernels on the prefix cache's table-routed
    pool (``_routed_case``): within the attention tolerance of their plain
    versions, every output finite (the NaN page, a scrubbed neighbour's,
    leaks nowhere), rows of no segment and the empty slot zeros; K3's
    pools as the plain chain's, and no write reaching the park page or the
    pages two slots share."""
    cache, rows, wave, park, nan_page, shared = _routed_case(gen, int8)
    kw = ({"k_scales": cache.k_scales[1], "v_scales": cache.v_scales[1]}
          if int8 else {})
    q, kf, vf, cos, sin = rows
    layer = 1
    written = torch.zeros(cache.k_pages.shape[:-1], dtype=torch.bool,
                          device="cuda")
    new = cache
    if form == "K11":
        args = (q, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
                *wave[3:], kf, vf)
        out = k11.ragged_paged_attention_pure(*args, **kw)
        ref = k11.ragged_paged_attention_reference(*args, **kw)
        valid = wave[2]
    elif form == "K10":
        active = torch.tensor([True, True, True, False], device="cuda")
        lens = torch.where(active, cache.seq_lens + 1, 0).to(torch.int32)
        qd = q[:4]
        args = (qd, cache.k_pages[1], cache.v_pages[1], cache.block_tables,
                lens)
        out = k10.paged_attention_pure(*args, **kw)
        ref = k10.paged_attention_reference(*args, **kw)
        valid = active
    elif form == "K3 masked":
        active = torch.tensor([True, True, True, False], device="cuda")
        pos = cache.seq_lens.long()
        cos_t, sin_t = _rope_tables(128, 128, 10000.0, device="cuda")
        drows = (q[:4], kf[:4], vf[:4], cos_t[pos], sin_t[pos])
        new, cp = _copy(cache), _copy(cache)
        out, new = k3.fused_rope_append_attend_decode(*drows, new, layer,
                                                      active)
        ref, cp = k3.decode_reference(*drows, cp, layer, active, plain=True)
        page = cache.k_pages.shape[3]
        idx = torch.arange(3, device="cuda")
        phys = cache.block_tables[idx, pos[:3] // page].long()
        written[layer, :, phys, pos[:3] % page] = True
        valid = active
    else:
        flag = (torch.tensor([False, True, False, False], device="cuda")
                if form == "K3 fresh_pool_read" else None)
        new, cp = _copy(cache), _copy(cache)
        out, new = k3.fused_rope_append_attend(*rows, new, layer, *wave,
                                               fresh_pool_read=flag)
        ref, cp = k3.ragged_reference(*rows, cp, layer, *wave, plain=True,
                                      fresh_pool_read=flag)
        written = _written(cache, layer, wave)
        valid = wave[2]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    assert bool(((out.float() - ref.float()).abs() <= _attn_tol(ref)).all())
    assert not out[~valid].any()
    if new is not cache:
        _routed_pools_check(new, cp, cache, written, park, shared)
    assert torch.equal(_bits(new.k_pages[:, :, park]),
                       _bits(cache.k_pages[:, :, park]))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_clone_pages_and_host_arena_are_bitwise_on_the_card(gen, int8):
    """``clone_pages`` copies a page's codes and scale cells bitwise, in
    place; ``HostPageArena`` (one pinned buffer) stores pages to host slots
    and loads them back into other pages bitwise, a load ordered before a
    later store into the same slots."""
    page, pps = 16, 4
    cache = kv_cache.create_paged_cache(
        2, 2, page * pps, 2, 128, page,
        dtype=torch.int8 if int8 else torch.bfloat16, extra_pages=5,
        device="cuda")
    pools = [p for p in (cache.k_pages, cache.v_pages, cache.k_scales,
                         cache.v_scales) if p is not None]
    for p in pools:
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen,
                                  device="cuda", dtype=torch.int8))
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda"))
    before = [p.clone() for p in pools]
    kv_cache.clone_pages(cache, [1, 6], [9, 3])
    for p, b in zip(pools, before):
        assert torch.equal(_bits(p[:, :, [9, 3]]), _bits(b[:, :, [1, 6]]))
        keep = [i for i in range(p.shape[2]) if i not in (9, 3)]
        assert torch.equal(_bits(p[:, :, keep]), _bits(b[:, :, keep]))
    arena = kv_cache.HostPageArena(6, cache)
    assert arena.pinned
    arena.store(cache, [0, 5, 12], [4, 1, 2])
    snap = [p[:, :, [0, 5, 12]].clone() for p in pools]
    arena.load(cache, [4, 1, 2], [7, 8, 11], depth=2)
    # a store into a slot the load just read waits for the load
    arena.store(cache, [2, 2, 2], [4, 1, 2])
    torch.cuda.synchronize()
    for p, s in zip(pools, snap):
        assert torch.equal(_bits(p[:, :, [7, 8, 11]]), _bits(s))


def test_batcher_with_defaults_serves_on_the_card(gen):
    """``ContinuousBatcher(model)`` with default flags (prefix caching,
    host tier, unified arena) builds and serves on the card: requests that
    share a prefix hit the tree, every request finishes with its tokens,
    the allocator's invariant holds, and the waves ran K2 and K3's ragged
    and masked forms."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=0)
    eng = ContinuousBatcher(model, max_batch=2, max_seq=128, page_size=16,
                            segment=4, prefill_chunk=32)
    shared = torch.randint(0, 256, (48,), generator=gen,
                           device="cuda").tolist()
    rids = [eng.submit(shared + [i, i + 1, i + 2], 6, arrival_segment=2 * i)
            for i in range(3)]
    kernels.reset_launch_counts()
    done = eng.run()
    counts = kernels.launch_counts()
    for r in rids:
        assert done[r].status == "ok" and len(done[r].tokens) == 6
    assert eng.stats["prefix_hits"] > 0 and eng.stats["pages_saved"] > 0
    eng._pager.check()
    assert counts["fused_norm_matmul"] > 0
    assert counts["fused_rope_attend_ragged"] > 0
    assert counts["fused_rope_attend"] > 0


# ------------------------------------------------ multi-LoRA and sampling

#: the LoRA delta's K13 shapes at Llama-3-8B width and rank 16: the shrink
#: x (T, K) @ A (G, K, 16) and the expand u (T, 16) @ B (G, 16, N)
_LORA_KN = [(4096, 16), (14336, 16), (16, 1024), (16, 4096), (16, 14336)]


def _lora_offsets(t, groups=9, seed=0):
    """A wave's routing over ``groups`` slots: three adapters' rows, the
    base group (the last) with the rest, the other slots empty."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = np.zeros(groups, np.int64)
    live = rng.choice(groups - 1, size=3, replace=False)
    counts[live] = rng.multinomial(t // 2, [1 / 3] * 3)
    counts[-1] = t - counts.sum()
    return _offsets(counts.tolist())


@pytest.mark.parametrize("t", [264, 8])
@pytest.mark.parametrize("kdim,n", _LORA_KN)
def test_grouped_matmul_at_lora_shapes_matches_plain(gen, t, kdim, n):
    """K13 at the LoRA delta's shapes (N or K = the rank 16, 9 groups, most
    of them empty) within its tolerance of the plain version, two calls
    bitwise equal."""
    off = _lora_offsets(t)
    x = _randn(gen, t, kdim)
    w = _randn(gen, 9, kdim, n, scale=kdim ** -0.5)
    got = k1314.gmm(x, off, w)
    again = k1314.gmm(x, off, w)
    ref = k1314.grouped_matmul_reference(x, off, w)
    torch.cuda.synchronize()
    tol = k1314.tolerance(x, off, w, ref)
    err = ((got.float() - ref.float()).abs() / tol).max().item()
    assert err < 1.0, err
    assert torch.equal(got, again)


def test_lora_delta_on_the_card_is_two_k13_launches(gen):
    """``lora_delta_pure`` on CUDA tensors: two K13 launches, the gathered
    rows' products scattered back bitwise, the base rows exactly 0; with
    the kernel flag off it raises."""
    from paddle_tpu_torch.models.lora import lora_delta_pure

    t, kdim, r, n = 264, 4096, 16, 1024
    off = _lora_offsets(t, seed=1)
    rows = torch.repeat_interleave(
        torch.arange(9, device="cuda"), torch.diff(off).long())
    perm = torch.randperm(t, generator=gen, device="cuda")
    group = rows[perm]                          # wave order: unsorted
    srt = torch.sort(group, stable=True).indices.to(torch.int32)
    inv = torch.empty_like(srt)
    inv[srt.long()] = torch.arange(t, dtype=torch.int32, device="cuda")
    x = _randn(gen, t, kdim)
    a = _randn(gen, 9, kdim, r, scale=kdim ** -0.5)
    b = _randn(gen, 9, r, n, scale=r ** -0.5)
    a[-1].zero_()
    b[-1].zero_()
    n0 = k1314.launches
    got = lora_delta_pure(x, a, b, srt, inv, off)
    assert k1314.launches - n0 == 2
    want = k1314.gmm(k1314.gmm(x[srt.long()], off, a), off, b)[inv.long()]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[group == 8].any()
    old = flags.get_flag("grouped_matmul_kernel")
    flags.set_flags({"grouped_matmul_kernel": False})
    try:
        with pytest.raises(NotImplementedError):
            lora_delta_pure(x, a, b, srt, inv, off)
    finally:
        flags.set_flags({"grouped_matmul_kernel": old})
    plain = lora_delta_pure(x, a, b, srt, inv, off, plain=True)
    assert k1314.launches - n0 == 4
    assert plain.shape == got.shape


def test_lora_batcher_serves_on_the_card(gen):
    """The batcher with ``lora=True`` on the card: base and adapter
    requests finish, adapters steer their tokens, and the waves and
    segment steps ran 2 K13 per adapted projection and layer."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.lora import make_lora_adapter
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=0)
    eng = ContinuousBatcher(model, max_batch=3, max_seq=128, page_size=16,
                            segment=4, prefill_chunk=32, lora=True,
                            lora_hbm_adapters=2, prefix_caching=False)
    for i, aid in enumerate("AB"):
        eng.register_adapter(aid, make_lora_adapter(cfg, 16 >> i, seed=i,
                                                    scale=1.0))
    prompt = torch.randint(0, 256, (40,), generator=gen,
                           device="cuda").tolist()
    kernels.reset_launch_counts()
    rids = [eng.submit(prompt, 8, adapter_id=a) for a in (None, "A", "B")]
    done = eng.run()
    counts = kernels.launch_counts()
    st = eng.stats
    toks = [done[r].tokens for r in rids]
    assert all(done[r].status == "ok" and len(done[r].tokens) == 8
               for r in rids)
    assert toks[0] != toks[1] and toks[0] != toks[2]
    plan = fusion.planned_kernel_launches(2, lora=True)
    assert plan["grouped_matmul"] == 28
    assert counts["grouped_matmul"] == 28 * (st["ragged_steps"]
                                             + st["decode_steps"])
    assert st["adapter_loads"] == 2


def test_gumbel_draws_on_the_card_follow_the_filtered_softmax(gen):
    """200,000 draws from the card's generator on one filtered row: the
    chi-square against the filtered softmax passes at p = 1e-6, with no
    draw outside the kept set; a 10%-off temperature fails it."""
    import numpy as np
    import scipy.stats

    from paddle_tpu_torch.models.llama import _filter_logits, _gumbel_argmax

    row = torch.randn((1, 4096), generator=gen, device="cuda")
    t, k, p = 0.8, 50, 0.95

    def chi2(filt, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        draws = _gumbel_argmax(filt.expand(200_000, -1), g)
        counts = torch.bincount(draws.long(), minlength=4096).double()
        kept = (want_filt[0] > -1e29)
        probs = torch.softmax(want_filt[0].double(), -1)
        exp = probs[kept] * 200_000
        stat = float(((counts[kept] - exp) ** 2 / exp).sum())
        return stat, int(counts[~kept].sum()), int(kept.sum())

    want_filt = _filter_logits(row, t, k, p)
    stat, outside, n_kept = chi2(want_filt, 1)
    bound = float(scipy.stats.chi2.ppf(1 - 1e-6, n_kept - 1))
    assert 5 < n_kept <= k
    assert outside == 0 and stat <= bound, (stat, bound)
    hot, out_hot, _ = chi2(_filter_logits(row, t * 1.1, k, p), 1)
    assert hot > bound or out_hot > 0
    # the draw never leaves the kept set on a batch of rows either
    rows = torch.randn((64, 4096), generator=gen, device="cuda")
    filt = _filter_logits(rows, t, k, p)
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = _gumbel_argmax(filt, g).long()
    assert bool((filt.gather(1, toks[:, None]) > -1e29).all())
    assert np.isfinite(stat)


def test_sampling_and_lora_delta_make_no_host_sync(gen):
    """The filter and the draw, the LoRA delta's two K13 launches with its
    gather and scatter, and the pool's routing upload all enqueue without
    waiting for the device: under ``torch.cuda.set_sync_debug_mode
    ("error")`` none of them raises."""
    import numpy as np

    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               _sample_from_logits)
    from paddle_tpu_torch.models.lora import (AdapterPool, lora_delta_pure,
                                              make_lora_adapter)

    logits = torch.randn((8, 128256), generator=gen, device="cuda")
    draw = torch.Generator(device="cuda").manual_seed(0)
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, dtype="bfloat16")
    pool = AdapterPool(LlamaForCausalLM(cfg, seed=0), max_rank=16,
                       hbm_slots=2)
    pool.register("a", make_lora_adapter(cfg, 16, seed=1))
    pool.acquire("a")
    a, b = pool.stacks["model.layers.0.self_attn.q_proj.weight"]
    x = _randn(gen, 40, 256)
    groups = np.array([0, 2] * 20, np.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kw in (dict(top_k=50, top_p=0.95), dict(top_p=0.0), {}):
            _sample_from_logits(logits, draw, 0.8, **kw)
        srt, inv, off = pool.route_rows(groups)
        lora_delta_pure(x, a, b, srt, inv, off)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ------------------------------------------------------------ serving fleet


def _fleet_model(int8=False):
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               quantize_for_inference)

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=0)
    kw = {}
    if int8:
        kw = dict(quantized_params=quantize_for_inference(model),
                  cache_dtype="int8")
    return model, kw


def test_fleet_launch_counter_is_exact_under_two_threads(gen):
    """Two threads launch K2 2,000 times each at once: the counter gains
    exactly 4,000 (the increment is under ``_build.count``'s lock; the
    ctypes call releases the GIL)."""
    import threading

    x = _randn(gen, 8, 256)
    w = _randn(gen, 256, 256, scale=0.05)
    nw = torch.ones(256, device="cuda", dtype=torch.bfloat16)
    want = k2.fused_norm_matmul_pure(x, nw, 1e-5, w)
    before = k2.launches
    outs = []

    def worker():
        y = None
        for _ in range(2000):
            y = k2.fused_norm_matmul_pure(x, nw, 1e-5, w)
        torch.cuda.current_stream().synchronize()
        outs.append(y)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert k2.launches - before == 4000
    for y in outs:
        assert torch.equal(_bits(y), _bits(want))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fleet_parked_stream_crosses_the_chunked_wire_bitwise(gen, int8):
    """A parked stream's pages leave engine A's pinned host tier, cross
    the chunked wire as raw bytes and land in engine B's host tier
    bitwise (codes and, on int8, scales); B resumes it with one admitted
    token and serves it to its budget."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.inference.migration import KVMigrator

    model, kw = _fleet_model(int8)
    ekw = dict(max_batch=2, max_seq=128, page_size=16, segment=4,
               prefill_chunk=32, **kw)
    prompt = torch.randint(0, 256, (40,), generator=gen,
                           device="cuda").tolist()
    a = ContinuousBatcher(model, **ekw)
    rid = a.submit(prompt, 12)
    asked = []

    def hook(t):
        if not asked:
            a.park(rid)
            asked.append(t)

    a._on_tick = hook
    a.run()
    assert a.parked == [rid]
    blob = a.export_parked(rid)
    src = a._host_arena.export_pages(a._parked[rid].host_pages)
    wired = KVMigrator("chunked", chunk_pages=1).transfer(blob, rid=rid)
    b = ContinuousBatcher(model, **ekw)
    rid_b = b.import_parked(wired)
    landed = b._host_arena.export_pages(b._parked[rid_b].host_pages)
    assert len(landed) == len(src) == len(blob["pages"])
    for got, want in zip(landed, src):
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(_bits(got[name]), _bits(want[name])), name
    a.discard_parked(rid)
    b.resume(rid_b)
    done = b.run()
    assert done[rid_b].status == "ok" and len(done[rid_b].tokens) == 12
    assert b.stats["prefill_tokens_admitted"] == 1
    a._host_pager.check()
    b._host_pager.check()


def test_fleet_kill_leaves_the_survivor_serving(gen):
    """Two replicas on one card; one killed mid-run (its in-flight work
    left to finish on the stream): every request completes on the
    survivor, and the survivor's next wave runs free of CUDA errors."""
    import time

    import numpy as np

    from paddle_tpu_torch.inference.fleet import make_fleet
    from paddle_tpu_torch.inference.router import FleetRouter

    model, _ = _fleet_model()
    registry, workers = make_fleet(model, 2, heartbeat_interval=0.05,
                                   lease_ttl=0.5, max_batch=2, max_seq=128,
                                   page_size=16, segment=4, prefill_chunk=32)
    for w in workers:
        w.start()
    try:
        router = FleetRouter(workers, registry)
        rng = np.random.default_rng(0)
        rids = [router.submit(rng.integers(0, 256, size=30), 24)
                for _ in range(4)]
        deadline = time.monotonic() + 60
        while not any(router.request(r).replica == "replica1"
                      and len(router.request(r)._journal) >= 3
                      for r in rids):
            assert time.monotonic() < deadline
            router.poll()
            time.sleep(0.002)
        workers[1].kill()
        done = router.join(timeout=120)
        assert all(done[r].status == "ok" and len(done[r].tokens) == 24
                   for r in rids)
        assert router.stats["failovers"] == 1
        torch.cuda.synchronize()
        nxt = router.submit(rng.integers(0, 256, size=30), 8)
        assert router.join(timeout=60)[nxt].status == "ok"
        torch.cuda.synchronize()
        workers[0].engine._pager.check()
    finally:
        for w in workers:
            if w.alive():
                w.terminate()
        for w in workers:
            w.join(10)


# ---------------------------------------------------------------------------
# Quantized weights under autograd: K4 and K2's quantized forms forward,
# the weight-only rule backward
# ---------------------------------------------------------------------------

#: the small-M body (M 8) and the tiled body (M 300, off its tiles)
_QUANT_GRAD = [(m, algo, gs) for m in (8, 300)
               for algo, gs in (("weight_only_int8", -1),
                                ("weight_only_int4", 128))]


def _rel(a, ref):
    return ((a.float() - ref).norm() / ref.norm()).item()


def _shift_the_backward(monkeypatch):
    """The control: the weight-only rule reads every column's scale from
    the column 16 places on (the forward stays as it is)."""
    rule = k4.quant_matmul_dx
    monkeypatch.setattr(k4, "quant_matmul_dx",
                        lambda g, codes, scales, *a: rule(
                            g, codes, scales.roll(16, -1), *a))


@pytest.mark.parametrize("m,algo,gs", _QUANT_GRAD)
def test_quant_grad_k4_forward_bitwise_and_dx_rule(gen, monkeypatch, m,
                                                   algo, gs):
    """K4 under autograd: the forward is the launch, bitwise equal to the
    no-grad call (one launch each); dx (the weight-only rule) against plain
    f32 within twice the plain bf16 chain's relative L2 error; the rule with
    the scales shifted fails it."""
    kdim, n = 512, 784
    qw = _qweight(gen, kdim, n, algo, gs)
    x = _randn(gen, m, kdim)
    g = _randn(gen, m, n)
    n0 = k4.launches
    with torch.no_grad():
        y0 = k4.quant_matmul_qw(x, qw)
    xk = x.clone().requires_grad_(True)
    y = k4.quant_matmul_qw(xk, qw)
    assert k4.launches - n0 == 2
    assert torch.equal(y, y0)
    y.backward(g)
    w32 = k4.dequant_weight(qw.codes, qw.scales, qw.weight_dtype, gs,
                            k=kdim, dtype=torch.float32)
    ref = g.float() @ w32.T
    xp = x.clone().requires_grad_(True)
    k4.quant_matmul_reference(xp, qw.codes, qw.scales, qw.weight_dtype,
                              gs).backward(g)
    ek, ep = _rel(xk.grad, ref), _rel(xp.grad, ref)
    assert ek <= 2 * ep, (ek, ep)
    _shift_the_backward(monkeypatch)
    xc = x.clone().requires_grad_(True)
    k4.quant_matmul_qw(xc, qw).backward(g)
    assert _rel(xc.grad, ref) > 2 * ep


@pytest.mark.parametrize("m,algo,gs", _QUANT_GRAD)
def test_quant_grad_k2_forward_bitwise_and_grads_rule(gen, monkeypatch, m,
                                                      algo, gs):
    """K2's quantized form under autograd (a single consumer) and a
    quantized consumer group (the norm in K6/K7, one K4 each): forwards
    bitwise equal to the no-grad calls; dx and d norm_w against the plain
    f32 chain within twice the plain bf16 chain's error; the backward with
    the scales shifted fails it."""
    kdim, n, eps = 512, 784, 1e-5
    qw = _qweight(gen, kdim, n, algo, gs)
    qw2 = _qweight(gen, kdim, 272, algo, gs)
    x = _randn(gen, m, kdim)
    nw = (torch.rand((kdim,), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    g, g2 = _randn(gen, m, n), _randn(gen, m, 272)

    def run(fn, dtype=None, ws=(qw, qw2)):
        xa = (x if dtype is None else x.to(dtype)).clone().requires_grad_()
        na = (nw if dtype is None else nw.to(dtype)).clone().requires_grad_()
        outs = fn(xa, na, ws)
        sum((o.float() * gg.float()).sum()
            for o, gg in zip(outs, (g, g2))).backward()
        return outs, xa.grad, na.grad

    n2, n4 = k2.launches, k4.launches
    with torch.no_grad():
        y0 = k2.fused_norm_matmul_pure(x, nw, eps, qw)
        m0 = k2.fused_norm_multi_matmul_pure(x, nw, eps, (qw, qw2))
    (y,), dx1, dn1 = run(lambda a, b, ws: (k2.fused_norm_matmul_pure(
        a, b, eps, ws[0]),))
    assert (k2.launches - n2, k4.launches - n4) == (2, 2)
    assert torch.equal(y, y0)
    outs, dxm, dnm = run(lambda a, b, ws: k2.fused_norm_multi_matmul_pure(
        a, b, eps, ws))
    assert all(torch.equal(a, b) for a, b in zip(outs, m0))
    assert k4.launches - n4 == 4

    def f32_chain(a, b, ws):
        xn = (a * torch.rsqrt(a.square().mean(-1, keepdim=True) + eps)) * b
        return tuple(xn @ k4.dequant_weight(
            w.codes, w.scales, w.weight_dtype, w.group_size, k=kdim,
            dtype=torch.float32) for w in ws)

    def plain_chain(a, b, ws):
        return tuple(k2._reference(a, b, eps, w) for w in ws)

    for label, fn, ws in (("single", k2.fused_norm_matmul_pure, (qw,)),
                          ("group", None, (qw, qw2))):
        def kern(a, b, ws_, fn=fn):
            if fn is not None:
                return (fn(a, b, eps, ws_[0]),)
            return k2.fused_norm_multi_matmul_pure(a, b, eps, ws_)

        _, rx, rn = run(f32_chain, torch.float32, ws)
        _, px, pn = run(plain_chain, None, ws)
        _, kx, kn = run(kern, None, ws)
        assert _rel(kx, rx) <= 2 * _rel(px, rx), label
        assert _rel(kn, rn) <= 2 * _rel(pn, rn), label
        _shift_the_backward(monkeypatch)
        _, cx, _ = run(kern, None, ws)
        monkeypatch.undo()
        assert _rel(cx, rx) > 2 * _rel(px, rx), label
    del dx1, dn1, dxm, dnm
