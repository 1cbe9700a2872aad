"""Dropless MoE: the port's grouped matmul, gating, routes and model vs the JAX package's, on CPU.

The same numpy inputs (f32) go through the JAX function and the port's
counterpart; a JAX ``MoEForCausalLM`` built from ``paddle.seed(0)`` is
carried into the port through ``models/bridge.py``. Where the JAX function
reaches a Pallas kernel, it runs in interpret mode (``_INTERPRET``), as
``tests/test_moe_dropless.py`` runs it. Bars:

  * ``group_tile_walk``: the four integer vectors identical, with and
    without ``min_one_step``, for offsets with empty first/middle/last
    groups, one group holding every row, boundaries inside tiles, and a
    row count that is not a multiple of the tile;
  * the grouped matmul forward (and its transposed form) against
    ``grouped_matmul_reference`` and the interpret-mode Pallas kernel at
    1e-5; dx and dw against ``jax.grad`` through the kernel's custom VJP
    at the JAX test's bars (rtol 1e-4, atol 1e-5); ``segment_dw_pure``
    with ``("scale", s), ("cast", dt)`` against the JAX seam (f32 at
    1e-5; bf16 at one bf16 ulp), empty groups exactly zero;
  * gating (``_top_k_gating``, ``_topk_select`` with ties: ids equal,
    ``_aux_loss``, ``dense_dropped_token_rate``) at 1e-6;
  * both routes (top_k 1, 2 and 3) and the model's logits, aux and
    router probe at 1e-5
    (the logits measured ~1.4e-6 here), with a shared expert too;
  * the quantized forms run (``tests/test_torch_moe_quant.py`` holds
    them to the JAX package) and the expert-parallel form raises; the CPU
    wrappers run
    their plain versions and never build; the bridge refuses a missing,
    extra or misshapen MoE parameter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import moe as jmoe
from paddle_tpu.ops.pallas import grouped_matmul as jgm

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import moe as tmoe
from paddle_tpu_torch.models.bridge import load_numpy_params
from paddle_tpu_torch.ops import kernels as tkernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import grouped_matmul as tgm

#: group offsets over 64 rows of 4 groups: balanced, empty middle group
#: with boundaries inside 16-row tiles, all rows in the last group, all in
#: the first, an empty first and an empty last group
OFFSETS = ([0, 16, 32, 48, 64], [0, 5, 5, 40, 64], [0, 0, 0, 0, 64],
           [0, 64, 64, 64, 64], [0, 0, 21, 50, 64], [0, 9, 30, 64, 64])


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgm, "_INTERPRET", True)


@pytest.fixture
def dropless_flag(request):
    """Set ``moe_dropless`` on both sides for one test."""
    old = (jflags.get_flag("moe_dropless"), tflags.get_flag("moe_dropless"))
    jflags.set_flags({"moe_dropless": request.param})
    tflags.set_flags({"moe_dropless": request.param})
    yield request.param
    jflags.set_flags({"moe_dropless": old[0]})
    tflags.set_flags({"moe_dropless": old[1]})


def _arrays(*shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the walk and the kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_one_step", [False, True])
@pytest.mark.parametrize("off,bm", [(o, bm) for o in OFFSETS
                                    for bm in (8, 16)]
                         + [([0, 0, 130, 131, 300], 128),
                            ([0, 300, 300], 128), ([0, 0, 300], 128)])
def test_group_tile_walk_matches_jax(off, bm, min_one_step):
    t, e = off[-1], len(off) - 1
    n_tiles = -(-t // bm)
    ref = jgm.group_tile_walk(jnp.asarray(off, jnp.int32), bm, n_tiles, e,
                              min_one_step=min_one_step)
    got = tgm.group_tile_walk(torch.tensor(off, dtype=torch.int32), bm,
                              n_tiles, e, min_one_step=min_one_step)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("off", OFFSETS)
def test_grouped_matmul_forward_matches_jax(interpret, off):
    x, w = _arrays((64, 128), (4, 128, 256), scale=1.0)
    w *= 0.1
    jo = jnp.asarray(off, jnp.int32)
    ref = np.asarray(jgm.grouped_matmul_reference(jnp.asarray(x), jo,
                                                  jnp.asarray(w)))
    kern = np.asarray(jgm._pallas_grouped_matmul(
        jnp.asarray(x), jo, jnp.asarray(w), None, "fp", -1, (16, 128, 128)))
    to = torch.tensor(off, dtype=torch.int32)
    got = tgm.grouped_matmul(torch.tensor(x), to, torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
    # the transposed form (the backward's dX) on the (E, N, K) stack
    wt = np.ascontiguousarray(np.swapaxes(w, 1, 2))
    got_t = tgm.gmm(torch.tensor(np.ascontiguousarray(ref)), to,
                    torch.tensor(w), trans_w=True).numpy()
    ref_t = np.asarray(jgm.grouped_matmul_reference(jnp.asarray(ref), jo,
                                                    jnp.asarray(wt)))
    np.testing.assert_allclose(got_t, ref_t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("off", OFFSETS[1:4])
def test_grouped_matmul_grads_match_jax(interpret, off):
    x, w, coef = _arrays((64, 128), (4, 128, 128), (64, 128), seed=3)
    w *= 0.1
    jo = jnp.asarray(off, jnp.int32)

    def loss(x2, w2):
        return jnp.sum(jgm.grouped_matmul(x2, jo, w2) * coef)

    dx0, dw0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = tgm.grouped_matmul(xt, torch.tensor(off, dtype=torch.int32), wt)
    (y * torch.tensor(coef)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw0), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("epilogue,tol", [
    ((("cast", "float32"),), 1e-5),
    ((("scale", 0.5), ("cast", "float32")), 1e-5),
    ((("scale", 0.25), ("cast", "bfloat16")), 2.0 ** -8)])
def test_segment_dw_pure_matches_jax(interpret, epilogue, tol):
    """Through both seams with the family on (the JAX kernel in interpret
    mode); the bf16 cast may round the two f32 sums to neighbouring bf16
    values: one ulp, 2^-8 relative."""
    x, dy = _arrays((64, 128), (64, 256), seed=8)
    off = [0, 20, 20, 50, 64]
    jep = tuple((k, jnp.dtype(a) if k == "cast" else a) for k, a in epilogue)
    tep = tuple((k, getattr(torch, a) if k == "cast" else a)
                for k, a in epilogue)
    ref = np.asarray(jgm.segment_dw_pure(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(off, jnp.int32), 4,
        epilogue=jep), np.float32)
    got = tgm.segment_dw_pure(torch.tensor(x), torch.tensor(dy),
                              torch.tensor(off, dtype=torch.int32), 4,
                              epilogue=tep)
    assert got.dtype == tep[-1][1]
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=1e-5)
    assert not got[1].any()                               # the empty group
    with pytest.raises(ValueError, match="unknown dw epilogue"):
        tgm.segment_dw_pure(torch.tensor(x), torch.tensor(dy),
                            torch.tensor(off, dtype=torch.int32), 4,
                            epilogue=(("relu", None),))


def test_cpu_wrappers_run_plain_and_build_nothing():
    x, w = _arrays((40, 16), (3, 16, 24), seed=4)
    off = torch.tensor([0, 0, 17, 40], dtype=torch.int32)
    before = tkernels.launch_counts()
    y = tgm.gmm(torch.tensor(x), off, torch.tensor(w))
    dw = tgm.segment_dw(torch.tensor(x), y, off, 3, scale=2.0,
                        out_dtype=torch.bfloat16)
    assert dw.dtype == torch.bfloat16 and not dw[0].float().any()
    torch.testing.assert_close(y[:17], torch.tensor(x[:17] @ w[1]))
    torch.testing.assert_close(y[17:], torch.tensor(x[17:] @ w[2]))
    assert tkernels.launch_counts() == before
    assert _build._lib is None
    for name in ("pt_grouped_matmul", "pt_segment_dw", "pt_group_tile_walk"):
        assert name in _build._SIGNATURES


def test_quantized_and_expert_parallel_forms_raise():
    """Quantized experts now run (``tests/test_torch_moe_quant.py`` holds
    them to the JAX package); expert parallelism still raises."""
    x, w = _arrays((8, 16), (2, 16, 16))
    off = torch.tensor([0, 4, 8], dtype=torch.int32)
    codes = torch.tensor(w).to(torch.int8)
    y = tgm.grouped_matmul(torch.tensor(x), off, codes, torch.ones(2, 16),
                           "int8")
    torch.testing.assert_close(y[:4], torch.tensor(x[:4]) @ codes[0].float())
    torch.testing.assert_close(y[4:], torch.tensor(x[4:]) @ codes[1].float())
    codes, scales = tgm.quantize_grouped_weight(torch.tensor(w))
    assert codes.shape == (2, 16, 16) and scales.shape == (2, 16)
    model = tmoe.MoEForCausalLM(tmoe.MoEConfig.tiny(), device="cpu")
    assert model.quantize_experts() is model
    assert model.layers[0].mlp._expert_quant["weight_dtype"] == "int8"
    mlp = model.layers[0].mlp
    assert mlp.quantize_experts("weight_only_int4", 64) is mlp
    assert mlp._expert_quant["weight_dtype"] == "int4"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmoe.apply_moe_expert_parallel(model, None)


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------


def _logits(seed=1, g=2, s=16, e=4, ties=False):
    (lg,) = _arrays((g, s, e), seed=seed)
    if ties:  # equal logits: the first index must win in both
        lg[0, :4] = 0.5
        lg[1, 2, 1:3] = lg[1, 2].max() + 1.0
    return lg


@pytest.mark.parametrize("k,capacity,ties", [(2, 4, False), (2, 16, False),
                                             (1, 3, True), (2, 8, True),
                                             (5, 2, False)])
def test_top_k_gating_matches_jax(k, capacity, ties):
    lg = _logits(ties=ties)
    jd, jc, ja = jmoe._top_k_gating(jnp.asarray(lg), k, capacity)
    td, tc, ta = tmoe._top_k_gating(torch.tensor(lg), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    np.testing.assert_allclose(
        float(tmoe.dense_dropped_token_rate(torch.tensor(lg), k, capacity)),
        float(jmoe.dense_dropped_token_rate(jnp.asarray(lg), k, capacity)),
        rtol=1e-6)


@pytest.mark.parametrize("k,ties", [(1, True), (2, True), (3, False)])
def test_topk_select_and_aux_loss_match_jax(k, ties):
    probs = jax.nn.softmax(jnp.asarray(_logits(seed=2, ties=ties)), axis=-1)
    pt = torch.tensor(np.asarray(probs))
    ji, jg = jmoe._topk_select(probs, k)
    ti, tg = tmoe._topk_select(pt, k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(float(tmoe._aux_loss(pt)),
                               float(jmoe._aux_loss(probs)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the routes, the layer and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,k", [
    pytest.param(r, k, id=r if k == 2 else f"{r}-top{k}")
    for r in ("dropless", "dense") for k in (2, 1, 3)])
def test_routes_match_jax(route, k):
    x, lg, wg, wu, wd = _arrays((2, 16, 32), (2, 16, 4), (4, 32, 64),
                                (4, 32, 64), (4, 64, 32), seed=5)
    wg, wu, wd = wg * 0.1, wu * 0.1, wd * 0.1
    j = [jnp.asarray(a) for a in (x, lg, wg, wu, wd)]
    t = [torch.tensor(a) for a in (x, lg, wg, wu, wd)]
    if route == "dropless":
        jy, ja = jmoe._dropless_route(*j, k)
        ty, ta = tmoe._dropless_route(*t, k)
    else:
        jy, ja = jmoe._dense_route(*j, k, 6)
        ty, ta = tmoe._dense_route(*t, k, 6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def _models(shared=0, **kw):
    paddle.seed(0)
    jm = jmoe.MoEForCausalLM(jmoe.MoEConfig.tiny(num_shared_experts=shared,
                                                 **kw))
    params = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    tm = tmoe.MoEForCausalLM(tmoe.MoEConfig.tiny(num_shared_experts=shared,
                                                 **kw), device="cpu")
    load_numpy_params(tm, params)
    return jm, tm, params


def _ids(vocab=256, shape=(2, 16), seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


@pytest.mark.parametrize("dropless_flag", [True, False], indirect=True)
@pytest.mark.parametrize("shared", [0, 1])
def test_model_logits_aux_and_probe_match_jax(dropless_flag, shared):
    jm, tm, _ = _models(shared)
    ids = _ids()
    jprobe, tprobe = [], []
    jl, ja = jm(paddle.to_tensor(ids.astype(np.int64)), router_probe=jprobe)
    with torch.no_grad():
        tl, ta = tm(torch.tensor(ids), router_probe=tprobe)
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert len(tprobe) == len(jprobe) == 2
    for a, b in zip(tprobe, jprobe):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    jloss = float(jm.loss((jl, ja), paddle.to_tensor(ids.astype(np.int64))))
    np.testing.assert_allclose(float(tm.loss((tl, ta), torch.tensor(ids))),
                               jloss, rtol=1e-5)
    for seq in (16, 128):
        assert (tm.layers[0].mlp.capacity(seq)
                == jm.layers[0].mlp.capacity(seq))
    assert (tmoe.MoEForCausalLM.flops_per_token(tm.config, 16)
            == jmoe.MoEForCausalLM.flops_per_token(jm.config, 16))


def test_bridge_refuses_bad_moe_params():
    _, tm, params = _models()
    bad = dict(params)
    del bad["layers.1.mlp.w_down"]
    with pytest.raises(KeyError, match="layers.1.mlp.w_down"):
        load_numpy_params(tm, bad)
    with pytest.raises(KeyError, match="model.norm.weight"):
        load_numpy_params(tm, {**params, "model.norm.weight": params[
            "norm.weight"]})
    bad = {**params, "layers.0.mlp.gate.weight": np.zeros((4, 64),
                                                          np.float32)}
    with pytest.raises(ValueError, match="layers.0.mlp.gate.weight"):
        load_numpy_params(tm, bad)
