"""Tensor and sequence parallelism for the Llama train step across
processes: the port against the JAX package.

The rank processes (``torch_dist_workers.case_tp_train``, gloo on the
CPU, the port only) and the JAX package's single-controller runs take the
inputs of ``test_torch_distributed.py``: ``LlamaConfig.tiny()`` from
``paddle.seed(0)`` (and the tied-embedding model, and ``tiny(
num_attention_heads=8, num_key_value_heads=4)`` for mp 4) and the global
B=4 x S=16 batch whose rows hold 11, 11, 15 and 14 labelled targets. Both
sides run ``apply_llama_tensor_parallel`` + ``TrainStep`` at the same mesh
(``TensorParallel`` around it at dp 2 x mp 2); the port's parameters and
gradients are gathered over the model-parallel group.

  * meshes mp 2, mp 2 with SP, dp 2 x mp 2 and mp 4, each with
    ``collective_matmul`` on (the rings) and off: the step-1 gradients
    (the JAX package's read off its ``SGD(learning_rate=1.0)`` step: p0 -
    p1) within 1e-6 absolute, and 3 ``AdamW`` steps: losses within 1e-5
    relative, parameters within 1e-5 absolute;
  * ``fused_head_loss`` off (mp 2, dp 2 x mp 2) and on (SP, mp 4); tied
    embeddings with ``core_attn`` recompute under SP (its parameters on
    ``test_torch_distributed.py``'s tied bar, the test says why); dp 2 x
    mp 2 through ``fleet.init`` / ``distributed_model``
    (``TensorParallel``);
  * ``AdamW8bit``, one step at mp 2, on ``test_torch_train.py``'s per-step
    bar against the JAX package's step (K8 quantizes the shard's own
    2048-element blocks; ROADMAP Queue 3);
  * ``ClipGradByGlobalNorm(0.5)`` at mp 2: the global norm within 1e-6
    relative of the JAX package's step-1 gradient norm, the clipped step
    within 1e-5;
  * fault controls, each of which must fail the gradient bar: layer 0's
    row-parallel (o_proj) all-reduce skipped, and SP's norm-gradient
    all-reduce hooks removed;
  * refusals: a pipe degree, an mp degree that does not divide a width (or
    exceeds the kv heads), and the ring's hop with a CUDA tensor on a gloo
    group raise; the hybrid groups equal the reference topology's
    ``get_comm_list``;
  * ``zero_prefetch``: ZeRO stage 3 (``p_g_os``, 2 ranks) with the flag on
    prefetches every later decoder layer and is bitwise the flag off, and
    within 1e-5 of the JAX package's ``p_g_os`` run (``test_torch_zero.py``'s
    bars).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.mesh import set_mesh
from paddle_tpu.distributed.tensor_parallel import \
    TensorParallel as JaxTensorParallel
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    apply_llama_tensor_parallel as jax_apply_tp

import torch_dist_workers as W
from paddle_tpu_torch.distributed import CommunicateTopology, ProcessMesh
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           apply_llama_tensor_parallel)
from test_torch_distributed import (assert_run_matches, global_batch,
                                    jax_run, write_inputs)

HEADS8 = (("num_attention_heads", 8), ("num_key_value_heads", 4))
FHL = (("fused_head_loss", True),)
TIED_REMAT = (("fused_head_loss", True), ("tie_word_embeddings", True),
              ("recompute", True), ("recompute_granularity", "core_attn"))
#: (tag, dp, mp, sp, cfg items, parameter prefix): the meshes
MESHES = (("mp2", 1, 2, False, (), "p."),
          ("sp2", 1, 2, True, FHL, "p."),
          ("dp2mp2", 2, 2, False, (), "p."),
          ("mp4", 1, 4, False, HEADS8 + FHL, "h."))
BY_TAG = {m[0]: m[1:] for m in MESHES}


def _spec(mesh, cm=True, **kw):
    dp, mp, sp, cfg, prefix = BY_TAG[mesh]
    return {"case": "tp_train", "dp": dp, "mp": mp, "sp": sp, "cm": cm,
            "cfg": dict(cfg), "prefix": prefix,
            "tag": f"{mesh}_cm{int(cm)}", **kw}


def _write_tp_inputs(out):
    write_inputs(out)
    paddle.seed(0)
    m = JaxLlama(JaxConfig.tiny(**dict(HEADS8)))
    path = os.path.join(out, "inputs.npz")
    with np.load(path) as f:
        arrays = dict(f)
    arrays.update({"h." + n: np.asarray(p._array)
                   for n, p in m.named_parameters()})
    np.savez(path, **arrays)


@functools.lru_cache(maxsize=None)
def jax_tp_run(dp, mp, sp=False, opt="AdamW", steps=3, cfg=(), clip=None):
    """The JAX package's run of ``apply_llama_tensor_parallel`` +
    ``TrainStep`` on a dp x mp hybrid mesh (``SGD`` at lr 1.0 reads off
    the gradient): (losses, {name: parameter})."""
    paddle.seed(0)
    m = JaxLlama(JaxConfig.tiny(**dict(cfg)))
    try:
        hcg = jdist.create_hybrid_group(dp=dp, mp=mp)
        jax_apply_tp(m, hcg.mesh, sequence_parallel=sp)
        model = JaxTensorParallel(m, hcg) if dp > 1 else m
        o = getattr(jopt, opt)(
            learning_rate=1.0 if opt == "SGD" else 1e-3,
            parameters=m.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(clip) if clip else None)
        step = JaxTrainStep(model, lambda lg, lb: m.loss(lg, lb), o)
        x, y = (paddle.to_tensor(a.astype(np.int64)) for a in global_batch())
        losses = [float(step(x, y)) for _ in range(steps)]
        return losses, {n: np.asarray(a) for n, a in step.params.items()}
    finally:
        jtopology._hcg = None
        set_mesh(None)
        JC.destroy_process_group()


def jax_grads(tag):
    """{name: step-1 gradient} of the JAX package at mesh ``tag``."""
    dp, mp, sp, cfg, prefix = BY_TAG[tag]
    _, p1 = jax_tp_run(dp, mp, sp, "SGD", 1, cfg)
    p0 = _initial(prefix)
    return {n: p0[n] - p1[n] for n in p0}


@functools.lru_cache(maxsize=None)
def _initial(prefix):
    paddle.seed(0)
    cfg = {"h.": dict(HEADS8), "t.": {"tie_word_embeddings": True}}.get(
        prefix, {})
    m = JaxLlama(JaxConfig.tiny(**cfg))
    return {n: np.asarray(p._array) for n, p in m.named_parameters()}


def _jax_runs(tags):
    def run():
        for tag in tags:
            dp, mp, sp, cfg, _ = BY_TAG[tag]
            jax_grads(tag)
            jax_tp_run(dp, mp, sp, "AdamW", 3, cfg)
        if "mp2" in tags:
            jax_tp_run(1, 2, True, "SGD", 1, TIED_REMAT)
            jax_tp_run(1, 2, True, "AdamW", 3, TIED_REMAT)
            jax_tp_run(1, 2, False, "AdamW", 1, (), 0.5)
            jax_tp_run(1, 2, False, "AdamW8bit", 1, ())
            jax_run("p_g_os", 2)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    _write_tp_inputs(out)
    two = [_spec(t, cm) for t in ("mp2", "sp2") for cm in (True, False)]
    two += [
        {**_spec("sp2", cfg=dict(TIED_REMAT), prefix="t."),
         "tag": "sp2_tied_remat"},
        _spec("mp2", clip=0.5, steps=1, tag="mp2_clip"),
        _spec("mp2", opt="AdamW8bit", steps=1, tag="mp2_8bit"),
        _spec("mp2", steps=1, control="skip row all-reduce", tag="ctl_row"),
        _spec("sp2", steps=1, control="skip sp hooks", tag="ctl_sp"),
        {"case": "tp_refusals"},
        {"case": "train", "placement": "p_g_os", "tag": "prefetch_on",
         "flags": {"zero_prefetch": True}},
        {"case": "train", "placement": "p_g_os", "tag": "prefetch_off",
         "flags": {"zero_prefetch": False}}]
    W.run_ranks(2, two, out, timeout_s=120.0,
                meanwhile=_jax_runs(("mp2", "sp2")))
    four = [_spec(t, cm) for t in ("dp2mp2", "mp4") for cm in (True, False)]
    four += [_spec("dp2mp2", fleet=True, tag="fleet_dp2mp2"),
             {"case": "tp_topology", "dp": 2, "mp": 2, "tag": "topo_dp_mp"},
             {"case": "tp_topology", "sep": 2, "mp": 2,
              "tag": "topo_sep_mp"}]
    W.run_ranks(4, four, out, timeout_s=120.0,
                meanwhile=_jax_runs(("dp2mp2", "mp4")))
    return out


def _max_grad_err(got, ref):
    return max(float(np.abs(got["g." + n] - ref[n]).max()) for n in ref)


# ---------------------------------------------------------------------------
# the Llama train step at each mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cm", [True, False], ids=["ring", "monolithic"])
@pytest.mark.parametrize("tag", [m[0] for m in MESHES])
def test_step1_gradients_match_jax(runs, tag, cm):
    got = W.load(runs, f"{tag}_cm{int(cm)}")
    ref = jax_grads(tag)
    assert sorted(k[2:] for k in got if k.startswith("g.")) == sorted(ref)
    for n, g in ref.items():
        np.testing.assert_allclose(got["g." + n], g, rtol=0, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("cm", [True, False], ids=["ring", "monolithic"])
@pytest.mark.parametrize("tag", [m[0] for m in MESHES])
def test_three_adamw_steps_match_jax(runs, tag, cm):
    dp, mp, sp, cfg, _ = BY_TAG[tag]
    got = W.load(runs, f"{tag}_cm{int(cm)}")
    assert str(got["wrapped"]) == ("TensorParallel" if dp > 1
                                   else "LlamaForCausalLM")
    assert_run_matches(got, jax_tp_run(dp, mp, sp, "AdamW", 3, cfg))


def test_tied_core_attn_recompute_under_sp(runs):
    """Tied embeddings (the vocab-cut table is also the head) under SP with
    ``core_attn`` recompute: step-1 gradients within 1e-6, losses within
    1e-5; the parameters after 3 steps on ``test_torch_distributed.py``'s
    tied bar (every element within 5e-3, all but 4 a tensor within 1e-5):
    Adam's step-1 conditioning again, the JAX package's own TP run moves
    one element of ``layers.1.mlp.up_proj`` 1.58e-5 from its unsharded run
    here."""
    got = W.load(runs, "sp2_tied_remat")
    _, p1 = jax_tp_run(1, 2, True, "SGD", 1, TIED_REMAT)
    p0 = _initial("t.")
    for n in p0:
        np.testing.assert_allclose(got["g." + n], p0[n] - p1[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    losses, params = jax_tp_run(1, 2, True, "AdamW", 3, TIED_REMAT)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for n, ref in params.items():
        diff = np.abs(got["p." + n] - ref)
        assert diff.max() <= 5e-3, (n, diff.max())
        assert (diff > 1e-5).sum() <= 4, (n, (diff > 1e-5).sum())


def test_fleet_hybrid_front_end(runs):
    got = W.load(runs, "fleet_dp2mp2")
    assert str(got["wrapped"]) == "TensorParallel"
    assert_run_matches(got, jax_tp_run(2, 2, False, "AdamW", 3, ()))


@pytest.mark.parametrize("tag", ["mp2_cm1", "mp4_cm1"])
def test_cut_parameters_are_marked(runs, tag):
    """The cut parameters carry ``mp_cut``; the bridge's cut of the full
    tree (``tp_shards_from_numpy``) is each rank's shards bitwise."""
    got = W.load(runs, tag)
    assert bool(got["bridge_cut_ok"])
    cut = set(got["distributed"].tolist())
    assert "model.embed_tokens.weight" in cut and "lm_head.weight" in cut
    assert not any("norm" in n for n in cut)
    assert len(cut) == 2 + 7 * 2


def test_adamw8bit_step_on_the_per_step_bar(runs):
    """K8 quantizes each shard's own blocks: a column-cut shard's blocks
    hold other elements than the reference's, so the update is held to
    ``test_torch_train.py``'s per-step bar (each tensor within 5e-3, all
    but 4 elements within 1e-5)."""
    got = W.load(runs, "mp2_8bit")
    losses, ref = jax_tp_run(1, 2, False, "AdamW8bit", 1, ())
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    before = _initial("p.")
    for n, r in ref.items():
        diff = np.abs((got["p." + n] - before[n]) - (r - before[n]))
        assert diff.max() <= 5e-3, f"{n}: update differs by {diff.max()}"
        assert (diff > 1e-5).sum() <= 4, n


def test_clip_under_tp_matches_jax(runs):
    got = W.load(runs, "mp2_clip")
    sq = sum(np.sum(np.square(g.astype(np.float64)))
             for g in jax_grads("mp2").values())
    np.testing.assert_allclose(got["global_norm"], np.sqrt(sq), rtol=1e-6)
    assert got["global_norm"] > 0.5           # the clip scales the step
    assert_run_matches(got, jax_tp_run(1, 2, False, "AdamW", 1, (), 0.5))


@pytest.mark.parametrize("tag,mesh", [("ctl_row", "mp2"), ("ctl_sp", "sp2")])
def test_fault_controls_fail_the_gradient_bar(runs, tag, mesh):
    err = _max_grad_err(W.load(runs, tag), jax_grads(mesh))
    assert err > 1e-4, f"the {tag} control passed the bar ({err})"


# ---------------------------------------------------------------------------
# topology and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag,dims", [("topo_dp_mp", {"data": 2, "model": 2}),
                                      ("topo_sep_mp", {"sep": 2,
                                                       "model": 2})])
def test_groups_match_the_reference_topology(runs, tag, dims):
    names = ["data", "pipe", "sharding", "sep", "model"]
    shape = [dims.get(n, 1) for n in names]
    ref = jtopology.CommunicateTopology(names, shape)
    port = CommunicateTopology(names, shape)
    for axis, key in (("model", "mp"), ("data", "dp"), ("sep", "sep")):
        assert port.get_comm_list(axis) == ref.get_comm_list(axis)
        for r in range(4):
            got = W.load(runs, tag, r)[key].tolist()
            assert got in ref.get_comm_list(axis) and r in got, (axis, r)
    for r in range(4):
        assert str(W.load(runs, tag, r)["mode"]) == "hybrid"


def test_ring_refuses_cuda_tensors_on_gloo(runs):
    msg = str(W.load(runs, "tp_refusals")["ring_cuda_gloo"])
    assert "gloo" in msg and "CUDA" in msg, msg


def test_pipe_degree_raises():
    from paddle_tpu_torch.distributed import create_hybrid_group

    with pytest.raises(NotImplementedError, match="pipe"):
        create_hybrid_group(pp=2)


@pytest.mark.parametrize("mp,cfg,err,what", [
    (2, {"intermediate_size": 129}, ValueError, "intermediate_size"),
    (2, {"vocab_size": 255}, ValueError, "vocab_size"),
    (4, {"num_attention_heads": 6, "num_key_value_heads": 6,
         "hidden_size": 96}, ValueError, "num_attention_heads"),
    (4, {}, NotImplementedError, "key/value heads"),
    (3, {"num_attention_heads": 6, "num_key_value_heads": 3,
         "hidden_size": 96}, ValueError, "intermediate_size")])
def test_widths_that_do_not_divide_raise(mp, cfg, err, what):
    m = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    with pytest.raises(err, match=what):
        apply_llama_tensor_parallel(m, ProcessMesh(np.arange(mp), ["mp"]))


# ---------------------------------------------------------------------------
# ZeRO stage 3 prefetch
# ---------------------------------------------------------------------------
def test_zero_prefetch_is_bitwise_and_matches_jax(runs):
    on, off = W.load(runs, "prefetch_on"), W.load(runs, "prefetch_off")
    assert int(off["prefetches"]) == 0
    # every decoder layer after the first, each of 3 steps: 9 parameters
    assert int(on["prefetches"]) == 3 * 9
    for k in on:
        if k.startswith("p.") or k == "losses":
            np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    assert_run_matches(on, jax_run("p_g_os", 2))
