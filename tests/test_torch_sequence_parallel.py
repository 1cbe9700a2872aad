"""Tensor- and sequence-parallel layers across processes: the port against
the JAX package, layer by layer.

Two port ranks (``torch_dist_workers.case_tp_layers``, gloo on the CPU,
the port only) run each layer on their shards of the same numpy inputs,
with ``collective_matmul`` on (the rings of point-to-point hops) and off
(monolithic collectives); this process runs the JAX package's layer on
the whole arrays over a 2-device mesh, its flag off (its eager ring
programs take seconds each to compile; the reference's ring and
monolithic forms are held together by its own ``tests/test_overlap.py``).
The forward and the input and weight gradients of a seeded cotangent,
gathered over the ranks, must agree within 1e-6 absolute (the inputs are
O(1) and the cotangents 0.2 x N(0, 1), so every result is O(1)), for both
of the port's forms:

  * ``ColumnParallelLinear`` with and without ``gather_output``,
    ``RowParallelLinear`` with and without ``input_is_parallel``,
    ``VocabParallelEmbedding`` and ``ParallelCrossEntropy`` (vocab-cut
    logits, labels with ``ignore_index`` rows);
  * ``ColumnSequenceParallelLinear`` and ``RowSequenceParallelLinear``
    (its bias gradient all-reduced by
    ``register_sequence_parallel_allreduce_hooks``);
  * ``scatter`` and ``all_gather``;
  * the overlap products ``ag_matmul``, ``matmul_rs``, ``matmul_ar``,
    ``ring_all_gather`` and ``shard_seq``, and within the port each
    product's ring against its monolithic form;
  * ``ulysses_attention`` over a sep group of 2 (GQA: 4 q heads, 2 kv
    heads).

The mapping of cotangents: a replicated output's cotangent is the whole
array on every rank, except where the port's backward sums the ranks'
cotangents (``all_gather`` / ``ring_all_gather`` before a column-cut
consumer): there rank r takes a share of it and the shares sum to the
reference's cotangent (``torch_dist_workers._share``).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed import overlap as joverlap
from paddle_tpu.distributed import sequence_parallel as jsp
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.mesh import ProcessMesh as JaxMesh
from paddle_tpu.distributed.mesh import set_mesh
from paddle_tpu.framework import flags as jflags

import torch_dist_workers as W

B, S, K, F, V = 2, 8, 16, 32, 64
LAYERS = ("col_gather", "col_cut", "row_par", "row_rep", "emb", "ce",
          "col_sp", "row_sp", "scatter", "all_gather", "ulysses")
PRODUCTS = ("ag_matmul", "matmul_rs", "matmul_ar", "ring_all_gather",
            "shard_seq")


def layer_inputs():
    """The per-layer gates' arrays (``L.`` in ``inputs.npz``)."""
    rng = np.random.default_rng(5)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    labels = rng.integers(0, V, size=(B * S,))
    labels[[1, 6, 11]] = -100
    c = 0.2         # cotangents: the gradients' sums stay O(1)
    return {"x": f(B, S, K), "cot_col": f(B, S, F, scale=c),
            "w_col": f(K, F, scale=0.2), "b_col": f(F), "x_row": f(B, S, F),
            "cot_row": f(B, S, K, scale=c), "w_row": f(F, K, scale=0.2),
            "b_row": f(K), "w_emb": f(V, K),
            "ids": rng.integers(0, V, size=(B, S)),
            "cot_emb": f(B, S, K, scale=c), "logits": f(B * S, V, scale=2.0),
            "labels": labels, "cot_ce": f(B * S, scale=c),
            "cot_x": f(B, S, K, scale=c), "q": f(B, S, 4, K),
            "k": f(B, S, 2, K), "v": f(B, S, 2, K),
            "cot_att": f(B, S, 4, K, scale=c)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sp_layers"))
    np.savez(os.path.join(out, "inputs.npz"),
             **{"L." + k: v for k, v in layer_inputs().items()})
    W.run_ranks(2, [{"case": "tp_layers", "cm": True, "tag": "layers_cm1"},
                    {"case": "tp_layers", "cm": False, "tag": "layers_cm0"}],
                out, meanwhile=jax_layers)
    return out


def _t(a, grad=True):
    return paddle.to_tensor(np.ascontiguousarray(a), stop_gradient=not grad)


def _grads(out, cot, x, layer=None):
    (out * _t(cot, False)).sum().backward()
    got = {"y": out.numpy(), "dx": x.grad.numpy()}
    if layer is not None:
        got["dw"] = layer.weight.grad.numpy()
        if layer.bias is not None:
            got["db"] = layer.bias.grad.numpy()
    return got


def _set(layer, w, b=None):
    layer.weight._set_array(jnp.asarray(w))
    if b is not None:
        layer.bias._set_array(jnp.asarray(b))


@functools.lru_cache(maxsize=None)
def jax_layers():
    """{layer: {y, dx, dw, db}} of the JAX package's layers on the whole
    arrays, mp (and sep) of 2, ``collective_matmul`` off."""
    L = layer_inputs()
    old = jflags.get_flag("collective_matmul")
    jflags.set_flags({"collective_matmul": False})
    ref = {}
    try:
        jdist.create_hybrid_group(mp=2)
        for name, g_out in (("col_gather", True), ("col_cut", False)):
            col = jdist.ColumnParallelLinear(K, F, gather_output=g_out)
            _set(col, L["w_col"], L["b_col"])
            x = _t(L["x"])
            ref[name] = _grads(col(x), L["cot_col"], x, col)
        for name, par in (("row_par", True), ("row_rep", False)):
            row = jdist.RowParallelLinear(F, K, input_is_parallel=par)
            _set(row, L["w_row"], L["b_row"])
            x = _t(L["x_row"])
            ref[name] = _grads(row(x), L["cot_row"], x, row)
        emb = jdist.VocabParallelEmbedding(V, K)
        _set(emb, L["w_emb"])
        y = emb(paddle.to_tensor(L["ids"]))
        (y * _t(L["cot_emb"], False)).sum().backward()
        ref["emb"] = {"y": y.numpy(), "dw": emb.weight.grad.numpy()}
        lg = _t(L["logits"])
        loss = jdist.ParallelCrossEntropy()(lg, paddle.to_tensor(L["labels"]))
        ref["ce"] = _grads(loss.reshape([-1]), L["cot_ce"], lg)
        csp = jsp.ColumnSequenceParallelLinear(K, F)
        _set(csp, L["w_col"], L["b_col"])
        x = _t(L["x"])
        ref["col_sp"] = _grads(csp(x), L["cot_col"], x, csp)
        rsp = jsp.RowSequenceParallelLinear(F, K)
        _set(rsp, L["w_row"], L["b_row"])
        x = _t(L["x_row"])
        ref["row_sp"] = _grads(rsp(x), L["cot_row"], x, rsp)
        x = _t(L["x"])
        ref["scatter"] = _grads(jsp.scatter(x), L["cot_x"], x)
        x = _t(L["x"])
        ref["all_gather"] = _grads(jsp.all_gather(x), L["cot_x"], x)
        mesh = JaxMesh(np.arange(2), ["mp"])
        prods = (("ag_matmul", joverlap.ag_matmul, L["x"], L["w_col"],
                  L["cot_col"]),
                 ("matmul_rs", joverlap.matmul_rs, L["x_row"], L["w_row"],
                  L["cot_row"]),
                 ("matmul_ar", joverlap.matmul_ar, L["x_row"], L["w_row"],
                  L["cot_row"]))
        for name, fn, x, w, cot in prods:
            y, vjp = jax.vjp(lambda a, b, fn=fn: fn(a, b, mesh, "mp"),
                             jnp.asarray(x), jnp.asarray(w))
            dx, dw = vjp(jnp.asarray(cot))
            ref[name] = {"y": np.asarray(y), "dx": np.asarray(dx),
                         "dw": np.asarray(dw)}
        for name, fn in (("ring_all_gather", lambda a: joverlap.
                          ring_all_gather(a, mesh, "mp", dim=2)),
                         ("shard_seq", lambda a: joverlap.shard_seq(
                             a, mesh, "mp", dim=1))):
            y, vjp = jax.vjp(fn, jnp.asarray(L["x"]))
            ref[name] = {"y": np.asarray(y),
                         "dx": np.asarray(vjp(jnp.asarray(L["cot_x"]))[0])}
        jtopology._hcg = None
        jdist.create_hybrid_group(sep=2)
        qkv = [_t(L[k]) for k in ("q", "k", "v")]
        y = jsp.ulysses_attention(*qkv)
        (y * _t(L["cot_att"], False)).sum().backward()
        ref["ulysses"] = {"y": y.numpy(),
                          **{f"d{k}": t.grad.numpy()
                             for k, t in zip("qkv", qkv)}}
        return ref
    finally:
        jflags.set_flags({"collective_matmul": old})
        jtopology._hcg = None
        set_mesh(None)
        JC.destroy_process_group()


def _check(got, ref, name):
    keys = sorted(ref)
    for k in keys:
        np.testing.assert_allclose(
            got[f"{name}.{k}"].reshape(ref[k].shape), ref[k], rtol=0,
            atol=1e-6, err_msg=f"{name}.{k}")
    return keys


@pytest.mark.parametrize("cm", [True, False], ids=["ring", "monolithic"])
@pytest.mark.parametrize("name", LAYERS + PRODUCTS)
def test_layer_matches_jax(runs, name, cm):
    got = W.load(runs, f"layers_cm{int(cm)}")
    keys = _check(got, jax_layers()[name], name)
    assert "y" in keys and len(keys) >= 2


@pytest.mark.parametrize("name", PRODUCTS + ("col_sp", "row_sp",
                                             "all_gather", "row_par"))
def test_ring_matches_monolithic(runs, name):
    ring, mono = W.load(runs, "layers_cm1"), W.load(runs, "layers_cm0")
    keys = [k for k in ring if k.startswith(name + ".")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ring[k], mono[k], rtol=0, atol=1e-6,
                                   err_msg=k)
