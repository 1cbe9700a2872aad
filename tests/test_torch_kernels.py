"""The PyTorch port's kernel modules vs the JAX package's kernels.

Each port module that holds a CUDA kernel runs its plain PyTorch version
on CPU tensors; here it gets the same numpy-made inputs as the JAX
function, whose Pallas kernel runs in interpret mode (the module's
``_INTERPRET`` toggle, as tests/test_fused_decode.py does). Head dim 128
keeps the Pallas path eligible; a spy asserts the Pallas body really ran.
Also covered: the plain helpers the kernels' plain versions are built
from (paged attention, the paged KV cache, rope, rms_norm), the fusion
plans, the flags and the bucket ladder.

Tolerances (f32 throughout): 2e-5 where the two sides sum in a different
order (online vs two-pass softmax, XLA dot vs torch matmul); 3e-6 for
freshly rotated pool cells (XLA may fuse a*cos + b*sin into an FMA, the
port rounds each op — tests/test_fused_decode.py uses the same bound);
exact where the arithmetic is the same op sequence.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import bucketing as jbucket
from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_norm_matmul as jfnm
from paddle_tpu.ops.pallas import fused_rope_attend as jfra
from paddle_tpu.ops.pallas import fusion as jfusion
from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import bucketing as tbucket
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tkernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_norm_matmul as tfnm
from paddle_tpu_torch.ops.kernels import fused_rope_attend as tfra
from paddle_tpu_torch.ops.kernels import fusion as tfusion
from paddle_tpu_torch.ops.kernels import grouped_matmul as tgm
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm

# importlib: the package re-exports a flash_attention op under this name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


# ------------------------------------------------------ flash forward (K1)


@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256)])
def test_flash_forward_matches_jax_kernel(monkeypatch, sq, sk):
    """Causal GQA forward with offset Sk - Sq: out and lse."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfa, "_pallas_fwd")
    rng = np.random.default_rng(0)
    b, h, hk, d = 1, 4, 2, 128
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = jfa.flash_chunk_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, scale)
    assert calls, "the Pallas forward did not run"
    t_out, t_lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(t_lse), np.asarray(j_lse), rtol=2e-5,
                               atol=2e-5)
    assert tfa.launches == 0  # CPU tensors never launch


def test_flash_attention_pure_matches_jax_entry(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 128, n, 128)).astype(np.float32)
               for n in (2, 1, 1))
    j = jfa.flash_attention_pure(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True)
    t = tfa.flash_attention_pure(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- norm_matmul (K2)


@pytest.mark.parametrize("m,variant", [(8, "_pallas_fnm"),
                                       (1536, "_pallas_fnm_streamed")])
def test_norm_matmul_matches_jax_kernel(monkeypatch, m, variant):
    """M <= 1024 reaches the resident TPU kernel, M > 1024 the streamed
    one; the port's single K2 has one plain version for both."""
    monkeypatch.setattr(jfnm, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfnm, variant)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, 256)).astype(np.float32)
    nw = (rng.random(256) + 0.5).astype(np.float32)
    w = rng.normal(size=(256, 384)).astype(np.float32)
    j = jfnm.fused_norm_matmul_pure(jnp.asarray(x), jnp.asarray(nw), 1e-5,
                                    jnp.asarray(w))
    assert calls, f"{variant} did not run"
    t = tfnm.fused_norm_matmul_pure(_t(x), _t(nw), 1e-5, _t(w))
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)
    assert tfnm.launches == 0


@pytest.mark.parametrize("m,n,kdim", [
    (17, 264, 384), (129, 1000, 4096), (264, 14336, 4096), (300, 520, 1024),
    (1024, 14336, 4096), (1024, 4096, 4096), (8192, 1024, 4096),
    (2049, 136, 4096), (4000, 8, 256), (600, 14336, 4096),
    (264, 1024, 4096), (8192, 14336, 4096)])
def test_norm_matmul_block_order_covers_each_tile_once(m, n, kdim):
    """K2's dense tiled path runs the tiled body of K4 and K2's quantized
    forms, so its walk is ``quant_matmul.quant_tiles`` at the width
    ``quant_matmul.block_n(m, n)`` picks: 128-wide tiles exactly where
    256-wide ones would fill at most half of the H100's 132 SMs; every
    element of the ragged M x N output lies in exactly one 128-row tile
    (a last row tile that M cuts included); ``_band(K)`` row tiles walk
    fastest, then the column tiles, band after band; the persistent
    blocks take every tile once."""
    bn = tqm.block_n(m, n)
    assert bn == (128 if 2 * -(-m // 128) * -(-n // 256) <= 132 else 256)
    tiles = tqm.quant_tiles(m, kdim, n, bn)
    n_mt, n_nt = -(-m // 128), -(-n // bn)
    assert len(tiles) == n_mt * n_nt
    # the tiles partition a grid whose last row and column tiles hold
    # y's last rows and columns: each element lies in exactly one tile
    assert sorted(tiles) == [(mt, nt) for mt in range(n_mt)
                             for nt in range(n_nt)]
    assert (n_mt - 1) * 128 < m <= n_mt * 128
    assert (n_nt - 1) * bn < n <= n_nt * bn
    band = min(max(16 * 2**20 // (128 * kdim * 2), 1), 16)
    assert tiles == [(mt, nt) for first in range(0, n_mt, band)
                     for nt in range(n_nt)
                     for mt in range(first, min(first + band, n_mt))]
    blocks = tgm.persistent_blocks(len(tiles))
    assert sorted(i for b in blocks for i in b) == list(range(len(tiles)))


def test_norm_matmul_keeps_leading_dims():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(2, 5, 64)).astype(np.float32))
    nw = _t(rng.random(64).astype(np.float32))
    w = _t(rng.normal(size=(64, 24)).astype(np.float32))
    y = tfnm.fused_norm_matmul_pure(x, nw, 1e-6, w)
    assert tuple(y.shape) == (2, 5, 24)
    torch.testing.assert_close(y, tllama._pure_rms(x, nw, 1e-6) @ w,
                               rtol=0, atol=0)


# ------------------------------------------- rope -> append -> attend (K3)


def _caches(rng, b=2, hk=2, d=128, page=8, cap=32, lens=(19, 9)):
    s = max(lens)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    jc = jkv.prefill_paged_cache(
        jkv.create_paged_cache(1, b, cap, hk, d, page_size=page),
        0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens, jnp.int32))
    tc = tkv.prefill_paged_cache(
        tkv.create_paged_cache(1, b, cap, hk, d, page_size=page),
        0, _t(k), _t(v), torch.tensor(lens, dtype=torch.int32))
    return jc, tc


def _assert_same_cache(tc, jc, atol=0.0):
    for name in ("k_pages", "v_pages", "block_tables", "seq_lens"):
        np.testing.assert_allclose(_np(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)),
                                   rtol=atol, atol=atol, err_msg=name)


def test_rope_append_attend_decode_matches_jax_kernel(monkeypatch):
    """Attention output AND the pools: the new cells written at each
    slot's position, every other cell untouched."""
    monkeypatch.setattr(jfra, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfra, "_pallas_fused")
    rng = np.random.default_rng(3)
    jc, tc = _caches(rng)
    _assert_same_cache(tc, jc)
    q = rng.normal(size=(2, 4, 128)).astype(np.float32)
    k = rng.normal(size=(2, 2, 128)).astype(np.float32)
    v = rng.normal(size=(2, 2, 128)).astype(np.float32)
    jcos, jsin = jllama._rope_tables(64, 128, 10000.0, jnp.float32)
    pos = np.asarray(jc.seq_lens)
    cos, sin = np.asarray(jcos)[pos], np.asarray(jsin)[pos]
    j_out, j_cache = jfra.fused_rope_append_attend_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos),
        jnp.asarray(sin), jc, 0)
    assert calls, "the Pallas fused kernel did not run"
    t_out, t_cache = tfra.fused_rope_append_attend_decode(
        _t(q), _t(k), _t(v), _t(cos), _t(sin), tc, 0)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), rtol=2e-5,
                               atol=2e-5)
    _assert_same_cache(t_cache, j_cache, atol=3e-6)
    assert tfra.launches == 0


def test_decode_reference_matches_jax_chain():
    """The plain chain on both sides (rope, append_token, paged attention)."""
    rng = np.random.default_rng(4)
    jc, tc = _caches(rng, hk=1, d=64, page=4, cap=24, lens=(3, 16))
    q = rng.normal(size=(2, 2, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 1, 64)).astype(np.float32) for _ in "kv")
    cos = rng.normal(size=(2, 64)).astype(np.float32)
    sin = rng.normal(size=(2, 64)).astype(np.float32)
    j_out, j_cache = jfra.decode_reference(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), jc, 0)
    t_out, t_cache = tfra.decode_reference(
        *(_t(a) for a in (q, k, v, cos, sin)), tc, 0)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), rtol=2e-5,
                               atol=2e-5)
    _assert_same_cache(t_cache, j_cache, atol=3e-6)


# ----------------------------------------------- plain helpers and caches


@pytest.mark.parametrize("lens", [(5, 12, 0), (16, 1, 9)])
def test_paged_attention_reference_matches_jax(lens):
    rng = np.random.default_rng(5)
    b, h, hk, d, page, pps = 3, 4, 2, 32, 4, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(hk, b * pps, page, d)).astype(np.float32)
    vp = rng.normal(size=(hk, b * pps, page, d)).astype(np.float32)
    bt = rng.permutation(b * pps).reshape(b, pps).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    j = jpa.paged_attention_reference(*(jnp.asarray(a)
                                        for a in (q, kp, vp, bt, sl)))
    t = tpa.paged_attention_reference(*(_t(a) for a in (q, kp, vp, bt, sl)))
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)
    assert not _np(t)[sl == 0].any()


def test_kv_cache_prefill_append_advance_match_jax():
    rng = np.random.default_rng(6)
    jc, tc = _caches(rng, b=3, hk=2, d=8, page=4, cap=12, lens=(4, 7, 1))
    _assert_same_cache(tc, jc)
    for layer_step in range(3):
        k, v = (rng.normal(size=(3, 2, 8)).astype(np.float32) for _ in "kv")
        jc = jkv.advance(jkv.append_token(jc, 0, jnp.asarray(k),
                                          jnp.asarray(v)))
        tc = tkv.advance(tkv.append_token(tc, 0, _t(k), _t(v)))
        _assert_same_cache(tc, jc)
    assert tkv.layer_scales(tc, 0) == (None, None)


def test_append_token_masked_matches_jax():
    rng = np.random.default_rng(7)
    jc, tc = _caches(rng, b=3, hk=2, d=8, page=4, cap=12, lens=(4, 7, 1))
    k, v = (rng.normal(size=(3, 2, 8)).astype(np.float32) for _ in "kv")
    active = np.array([True, False, True])
    jc = jkv.append_token_masked(jc, 0, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(active))
    tc = tkv.append_token_masked(tc, 0, _t(k), _t(v), torch.tensor(active))
    _assert_same_cache(tc, jc)


def test_rope_and_rms_helpers_match_jax():
    rng = np.random.default_rng(8)
    jcos, jsin = jllama._rope_tables(40, 16, 500000.0, jnp.float32)
    tcos, tsin = tllama._rope_tables(40, 16, 500000.0)
    np.testing.assert_allclose(_np(tcos), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(_np(tsin), np.asarray(jsin), atol=1e-6)
    q = rng.normal(size=(5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(5, 2, 16)).astype(np.float32)
    c, s = np.asarray(jcos)[:5], np.asarray(jsin)[:5]
    jq, jk = jllama.apply_rotary_rows(*(jnp.asarray(a) for a in (q, k, c, s)))
    tq, tk = tllama.apply_rotary_rows(*(_t(a) for a in (q, k, c, s)))
    np.testing.assert_allclose(_np(tq), np.asarray(jq), atol=3e-6)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=3e-6)
    q4 = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    jq4, _ = jllama.apply_rotary_pos_emb(*(jnp.asarray(a)
                                           for a in (q4, q4, c, s)))
    tq4, _ = tllama.apply_rotary_pos_emb(*(_t(a) for a in (q4, q4, c, s)))
    np.testing.assert_allclose(_np(tq4), np.asarray(jq4), atol=3e-6)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w = rng.random(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(tllama._pure_rms(_t(x), _t(w), 1e-5)),
        np.asarray(jllama._pure_rms(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=2e-6, atol=2e-6)


# ---------------------------------------------- fusion plans, flags, buckets


_ENABLED = [(), ("norm_matmul",), ("rope_append_attend",),
            ("norm_matmul", "rope_append_attend")]


@pytest.mark.parametrize("enabled", _ENABLED)
def test_fusion_plans_match_jax(enabled):
    for chain in ("LAYER_CHAIN", "ATTEND_CHAIN", "HEAD_CHAIN"):
        j = jfusion.fuse_chain(getattr(jfusion, chain), enabled)
        t = tfusion.fuse_chain(getattr(tfusion, chain), enabled)
        assert [tuple(n) for n in t] == [tuple(n) for n in j], chain


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("tied", [True, False])
def test_kernel_launches_per_token_matches_jax(fused, tied):
    for layers in (2, 32):
        assert (tfusion.kernel_launches_per_token(layers, tied, fused)
                == jfusion.kernel_launches_per_token(layers, tied, fused))


def test_planned_kernel_launches_llama3_8b():
    """The per-token launches chip_smoke.py holds the counters to."""
    assert tfusion.planned_kernel_launches(32) == {
        "norm_matmul": 161, "rope_append_attend": 32, "paged_attention": 0}
    assert tfusion.planned_kernel_launches(2, tied=True) == {
        "norm_matmul": 10, "rope_append_attend": 2, "paged_attention": 0}
    old = tflags.get_flag("fused_decode_fusions")
    try:
        tflags.set_flags({"fused_decode_fusions": "rope_append_attend"})
        assert tfusion.planned_kernel_launches(32) == {
            "norm_matmul": 0, "rope_append_attend": 32,
            "paged_attention": 0}
        assert tfusion.planned_kernel_launches(
            32, enabled=tfusion.FUSIONS) == {
            "norm_matmul": 161, "rope_append_attend": 32,
            "paged_attention": 0}
    finally:
        tflags.set_flags({"fused_decode_fusions": old})


def test_flags_match_jax_defaults_and_set():
    for name in ("fused_decode", "fused_decode_fusions"):
        assert tflags.get_flag(name) == jflags.get_flag(name)
    old = tflags.get_flag("fused_decode")
    try:
        tflags.set_flags({"FLAGS_fused_decode": "0"})
        assert tflags.get_flag("fused_decode") is False
        assert tfusion.enabled_fusions() == ()
    finally:
        tflags.set_flags({"fused_decode": old})
    with pytest.raises(ValueError):
        tflags.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("n,cap,floor", [(9, 16, 1), (1, 8, 1), (128, 160, 1),
                                         (100, 512, 64), (33, 48, 8)])
def test_bucketing_matches_jax(n, cap, floor):
    assert tbucket.default_buckets(cap, floor) == \
        jbucket.default_buckets(cap, floor)
    assert tllama._pow2_bucket(n, cap, floor) == \
        jllama._pow2_bucket(n, cap, floor)
    with pytest.raises(ValueError):
        tbucket.bucket_for(cap + 1, tbucket.default_buckets(cap, floor))


def test_cpu_path_never_builds_kernels():
    """The CPU tests run no nvcc: the library is neither built nor loaded,
    and the launch counters stay at zero."""
    x = torch.ones((2, 128))
    tfnm.fused_norm_matmul_pure(x, torch.ones(128), 1e-6, torch.ones(128, 8))
    assert _build._lib is None
    assert set(tkernels.launch_counts().values()) == {0}
    assert _build.library_path().name.endswith(".so")
