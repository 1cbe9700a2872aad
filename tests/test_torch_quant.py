"""The port's weight-only quantization and int8 KV cache vs the JAX package.

Same numpy-made inputs through the JAX function and its port counterpart.
Where the JAX function reaches a Pallas kernel (``_pallas_quant_matmul``,
``_pallas_fnm``/``_pallas_fnm_streamed`` with a ``QuantizedWeight``,
``_pallas_fused`` on an int8 cache) it runs in interpret mode (the module's
``_INTERPRET`` toggle) and a spy asserts the Pallas body ran; the port
runs the kernel's plain version on CPU tensors.

Tolerances (f32): quantization codes and scales bit-identical (same IEEE
ops, round half to even on both sides); 2e-5 where only the summation
order differs, or where the TPU kernel applies a per-channel scale to the
sum while the plain version scales each weight (one f32 rounding apart);
cells written by the fused decode kernel: codes within 1 of the plain
chain's and scales within 1e-6 relative (the JAX kernel may fuse the rope's
a*cos + b*sin into an FMA, which moves a rotated value by an ulp —
``paddle_tpu/ops/pallas/fused_rope_attend.py`` documents the same bound).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import extra_vision as jev
from paddle_tpu.ops.pallas import fused_norm_matmul as jfnm
from paddle_tpu.ops.pallas import fused_rope_attend as jfra
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quantization import observers as jobs

from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops import extra_vision as tev
from paddle_tpu_torch.ops import kernels as tkernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_norm_matmul as tfnm
from paddle_tpu_torch.ops.kernels import fused_rope_attend as tfra
from paddle_tpu_torch.ops.kernels import fusion as tfusion
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from paddle_tpu_torch.quantization import observers as tobs

# importlib: the ops package re-exports functions under these names
jqm = importlib.import_module("paddle_tpu.ops.pallas.quant_matmul")

ALGOS = ("weight_only_int8", "weight_only_int4")


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


def _quantized(w, algo, gs):
    """(JAX QuantizedWeight, port QuantizedWeight) of one f32 weight."""
    jc, js = jev._weight_quantize_pure(jnp.asarray(w), algo, gs)
    tc, ts = tev._weight_quantize_pure(_t(w), algo, gs)
    wd = "int4" if algo == "weight_only_int4" else "int8"
    return (jqm.QuantizedWeight(jc, js, wd, gs, w.shape),
            tqm.QuantizedWeight(tc, ts, wd, gs, w.shape))


# -------------------------------------------------- weight quantization


@pytest.mark.parametrize("k", [256, 193])   # 193: int4 pad row, ragged group
@pytest.mark.parametrize("group_size", [-1, 64, 128])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_matches_jax_bitwise(algo, group_size, k):
    """Codes, scales, the int4 unpack and the dequantized weight."""
    w = np.random.default_rng(0).normal(size=(k, 48)).astype(np.float32)
    w[3, 5] = 0.0
    jq, tq = _quantized(w, algo, group_size)
    np.testing.assert_array_equal(_np(tq.codes), np.asarray(jq.codes))
    np.testing.assert_array_equal(_np(tq.scales), np.asarray(jq.scales))
    assert tq.codes.dtype == torch.int8 and tq.scales.dtype == torch.float32
    assert tq.nbytes == jq.nbytes
    if algo == "weight_only_int4":
        assert tq.codes.shape == ((k + 1) // 2, 48)
        np.testing.assert_array_equal(
            _np(tev._unpack_int4(tq.codes)),
            np.asarray(jev._unpack_int4(jq.codes)))
    wd = tq.weight_dtype
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        t = tqm.dequant_weight(tq.codes, tq.scales, wd, group_size, k=k,
                               dtype=dtype)
        j = jqm.dequant_weight(jq.codes, jq.scales, wd, group_size, k=k,
                               dtype=jdtype)
        np.testing.assert_array_equal(_np(t.float()),
                                      np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
def test_groupwise_absmax_scales_match_jax(bits):
    w = np.random.default_rng(1).normal(size=(200, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tobs.groupwise_absmax_scales(_t(w), 64, bits)),
        np.asarray(jobs.groupwise_absmax_scales(jnp.asarray(w), 64, bits)))


def test_weight_quantize_rejects_bad_arguments():
    w = torch.ones((8, 8))
    with pytest.raises(ValueError):
        tev._weight_quantize_pure(w, group_size=32)
    with pytest.raises(NotImplementedError):
        tev._weight_quantize_pure(w, algo="weight_only_fp8")


# ------------------------------------------------- quant matmul (K4)


@pytest.mark.parametrize("group_size", [-1, 128])
@pytest.mark.parametrize("algo", ALGOS)
def test_quant_matmul_matches_jax_kernel(monkeypatch, algo, group_size):
    """quant_matmul_pure: the TPU kernel scales the f32 sum (per channel)
    or each group's partial sum; the plain version scales each weight."""
    monkeypatch.setattr(jqm, "_INTERPRET", True)
    calls = _spy(monkeypatch, jqm, "_pallas_quant_matmul")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 384)) / 16).astype(np.float32)
    jq, tq = _quantized(w, algo, group_size)
    j = jqm.quant_matmul_qw(jnp.asarray(x), jq)
    assert calls, "the Pallas quant matmul did not run"
    t = tqm.quant_matmul_qw(_t(x), tq)
    assert tuple(t.shape) == (2, 4, 384)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)
    assert tqm.launches == 0  # CPU tensors never launch


# ----------------------------------------- norm -> quant matmul (K2 int8/4)


@pytest.mark.parametrize("algo,group_size", [("weight_only_int8", -1),
                                             ("weight_only_int4", 64)])
@pytest.mark.parametrize("m,variant", [(8, "_pallas_fnm"),
                                       (1536, "_pallas_fnm_streamed")])
def test_norm_matmul_quantized_matches_jax_kernel(monkeypatch, m, variant,
                                                  algo, group_size):
    monkeypatch.setattr(jfnm, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfnm, variant)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(m, 256)).astype(np.float32)
    nw = (rng.random(256) + 0.5).astype(np.float32)
    w = (rng.normal(size=(256, 384)) / 16).astype(np.float32)
    jq, tq = _quantized(w, algo, group_size)
    j = jfnm.fused_norm_matmul_pure(jnp.asarray(x), jnp.asarray(nw), 1e-5, jq)
    assert calls, f"{variant} did not run"
    t = tfnm.fused_norm_matmul_pure(_t(x), _t(nw), 1e-5, tq)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)
    assert tfnm.launches == 0


# ------------------------------------------ int8 KV cache helpers


def _int8_caches(rng, b=2, hk=2, d=128, page=8, cap=32, lens=(19, 9),
                 layers=1):
    s = max(lens)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    jc = jkv.create_paged_cache(layers, b, cap, hk, d, page_size=page,
                                dtype=jnp.int8)
    tc = tkv.create_paged_cache(layers, b, cap, hk, d, page_size=page,
                                dtype=torch.int8)
    lens_np = np.asarray(lens, np.int32)
    for layer in range(layers):
        jc = jkv.prefill_paged_cache(jc, layer, jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens_np))
        tc = tkv.prefill_paged_cache(tc, layer, _t(k), _t(v),
                                     torch.tensor(lens_np))
    return jc, tc


_POOLS = ("k_pages", "v_pages", "k_scales", "v_scales", "block_tables",
          "seq_lens")


def _assert_same_cache(tc, jc):
    for name in _POOLS:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)


def test_int8_cache_prefill_append_match_jax_bitwise():
    """Quantize-on-write in the prefill, the masked append and advance:
    codes and scale pools identical to the JAX package's."""
    rng = np.random.default_rng(4)
    jc, tc = _int8_caches(rng, b=3, hk=2, d=16, page=4, cap=12,
                          lens=(4, 7, 1), layers=2)
    assert tc.quantized and tc.k_pages.dtype == torch.int8
    assert tuple(tc.k_scales.shape) == (2, 2, 9, 4, 1)
    _assert_same_cache(tc, jc)
    for active in ([True, False, True], [True, True, True]):
        k, v = (rng.normal(size=(3, 2, 16)).astype(np.float32) * 3
                for _ in "kv")
        act = np.asarray(active)
        jc = jkv.advance(jkv.append_token_masked(
            jc, 1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(act)))
        tc = tkv.advance(tkv.append_token_masked(tc, 1, _t(k), _t(v),
                                                 torch.tensor(act)))
        _assert_same_cache(tc, jc)
    ks, vs = tkv.layer_scales(tc, 1)
    assert ks.shape == (2, 9, 4, 1) and vs.shape == ks.shape


def test_quantize_cells_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0                   # an all-zero cell takes the 1e-12 floor
    x[1, 1, :4] = [0.5, -0.5, 1.5, 127 / 127]
    jq, js = jkv._quantize_cells(jnp.asarray(x))
    tq, ts = tkv.quantize_cells(_t(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_page_nbytes_matches_jax(dtype):
    for args in ((32, 8, 32, 128), (2, 1, 16, 64)):
        assert tkv.kv_page_nbytes(*args, dtype=getattr(torch, dtype)) == \
            jkv.kv_page_nbytes(*args, dtype=getattr(jnp, dtype))


def test_create_paged_cache_rejects_other_int_dtypes():
    with pytest.raises(ValueError):
        tkv.create_paged_cache(1, 1, 8, 1, 8, dtype=torch.int32)
    assert tkv.create_paged_cache(1, 1, 8, 1, 8).k_scales is None


@pytest.mark.parametrize("lens", [(5, 12, 0), (16, 1, 9)])
def test_paged_attention_reference_int8_matches_jax(lens):
    rng = np.random.default_rng(6)
    b, h, hk, d, page, pps = 3, 4, 2, 32, 4, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp, vp = (rng.integers(-127, 128, size=(hk, b * pps, page, d)).astype(
        np.int8) for _ in "kv")
    ks, vs = (rng.random((hk, b * pps, page, 1)).astype(np.float32) * 0.02
              for _ in "kv")
    bt = rng.permutation(b * pps).reshape(b, pps).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    j = jpa.paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, sl)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    t = tpa.paged_attention_reference(*(_t(a) for a in (q, kp, vp, bt, sl)),
                                      k_scales=_t(ks), v_scales=_t(vs))
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=2e-5)
    assert not _np(t)[sl == 0].any()


def test_decode_reference_int8_matches_jax_chain():
    """rope -> quantized append -> paged attention with dequant, the plain
    chain on both sides."""
    rng = np.random.default_rng(7)
    jc, tc = _int8_caches(rng, hk=1, d=64, page=4, cap=24, lens=(3, 16))
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
    _assert_written_cells_close(t_cache, j_cache)


def _assert_written_cells_close(tc, jc):
    """Codes within 1, scales within 1e-6 relative, and the number of
    differing codes printed (see the module docstring)."""
    for name in ("k_pages", "v_pages"):
        t = _np(getattr(tc, name)).astype(np.int32)
        j = np.asarray(getattr(jc, name)).astype(np.int32)
        print(f"{name}: {(t != j).sum()} of {t.size} codes differ")
        assert np.abs(t - j).max() <= 1, name
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(_np(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)), rtol=1e-6,
                                   atol=0, err_msg=name)
    for name in ("block_tables", "seq_lens"):
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)))


# ----------------------------------- rope -> append -> attend, int8 (K3)


@pytest.mark.parametrize("page", [16, 32])
def test_rope_append_attend_int8_matches_jax_kernel(monkeypatch, page):
    """The decode form on an int8 cache: attention output, the written
    cells' codes and scales, every other cell untouched."""
    monkeypatch.setattr(jfra, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfra, "_pallas_fused")
    rng = np.random.default_rng(8)
    jc, tc = _int8_caches(rng, b=2, hk=1, d=128, page=page, cap=64,
                          lens=(page - 1, 2 * page - 7))
    before = {n: _np(getattr(tc, n)).copy() for n in _POOLS[:4]}
    q = rng.normal(size=(2, 2, 128)).astype(np.float32)
    k = rng.normal(size=(2, 1, 128)).astype(np.float32)
    v = rng.normal(size=(2, 1, 128)).astype(np.float32)
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
    _assert_written_cells_close(t_cache, j_cache)
    # only each slot's cell at its position changed
    written = np.zeros(before["k_scales"].shape, bool)
    bt = _np(tc.block_tables)
    for b_, p_ in enumerate(pos):
        written[0, :, bt[b_, p_ // page], p_ % page] = True
    for name, old in before.items():
        new = _np(getattr(t_cache, name))
        keep = np.broadcast_to(~written, old.shape)
        np.testing.assert_array_equal(new[keep], old[keep], err_msg=name)
    assert tfra.launches == 0


# ---------------------------------------------- plans, counters


def test_planned_kernel_launches_quantized():
    """Weight-only params send the two matmuls no norm precedes (o_proj,
    down_proj) through K4: 64 per token for Llama-3-8B."""
    assert tfusion.planned_kernel_launches(32, quantized=True) == {
        "norm_matmul": 161, "rope_append_attend": 32, "paged_attention": 0,
        "quant_matmul": 64}
    assert tfusion.planned_kernel_launches(2, tied=True, quantized=True) == {
        "norm_matmul": 10, "rope_append_attend": 2, "paged_attention": 0,
        "quant_matmul": 4}


def test_cpu_quant_path_never_builds_kernels():
    x = torch.ones((3, 128))
    tq = tqm.QuantizedWeight(torch.ones((128, 16), dtype=torch.int8),
                             torch.ones(16), "int8", -1, (128, 16))
    y = tqm.quant_matmul_qw(x, tq)
    torch.testing.assert_close(y, torch.full((3, 16), 128.0))
    tfnm.fused_norm_matmul_pure(x, torch.ones(128), 1e-6, tq)
    assert _build._lib is None
    assert tkernels.launch_counts() == {
        "flash_attention": 0, "fused_norm_matmul": 0,
        "fused_rope_attend": 0, "fused_rope_attend_ragged": 0,
        "paged_attention": 0, "ragged_paged_attention": 0,
        "quant_matmul": 0, "flash_attention_bwd": 0, "rms_norm_fwd": 0,
        "rms_norm_bwd": 0, "adamw8bit": 0, "grouped_matmul": 0,
        "grouped_matmul_quant": 0, "segment_dw": 0,
        "flash_attention_bwd_fused": 0, "fused_rope": 0}
    assert "pt_quant_matmul" in _build._SIGNATURES
