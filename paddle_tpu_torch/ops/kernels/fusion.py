"""The decode fusion pass (``paddle_tpu/ops/pallas/fusion.py``, decode half).

The llama decoder block is a DECLARATIVE op list; a pattern matcher
rewrites adjacent ops into fused kernels:

  norm_matmul          rms_norm whose output feeds only matmuls folds into
                       each consumer (kernel K2, fused_norm_matmul.py)
  rope_append_attend   rope -> KV-append -> paged attention collapse into
                       one kernel (K3, fused_rope_attend.py)

A matmul left unfused (o_proj, down_proj) is ``x @ w`` for a dense weight
and the weight-only kernel K4 (quant_matmul.py) for a ``QuantizedWeight``.

``flags.fused_decode`` gates the pass and ``flags.fused_decode_fusions``
selects patterns; with a pattern off the executor runs the unfused chain.
With ``rope_append_attend`` off, the attend seams run rope and the cache
write as plain PyTorch ops (the JAX package computes them outside any
Pallas kernel too) and attention through its kernel: K10
(paged_attention.py) for decode rows, K11 (ragged_paged_attention.py) for
a ragged wave. With ``norm_matmul`` off, a flag-resolved plan raises on
CUDA tensors, since its norm -> matmul would bypass K2; the plain
reference reaches that chain on the card only by passing ``enabled=()``
explicitly.
"""

from __future__ import annotations

import functools
from collections import namedtuple

import torch

from ...framework import flags

OpNode = namedtuple("OpNode", ["kind", "out", "src", "w"])


def _op(kind, out=None, src=(), w=None):
    src = (src,) if isinstance(src, str) else tuple(src)
    return OpNode(kind, out, src, w)


# The llama decoder block as data: each node reads named values from the
# running environment and writes one. `attend` is the caller-provided
# attention seam (rope/append/attention live behind it — see ATTEND_CHAIN).
LAYER_CHAIN = (
    _op("rms_norm", "x", "hidden", "input_layernorm.weight"),
    _op("matmul", "q", "x", "self_attn.q_proj.weight"),
    _op("matmul", "k", "x", "self_attn.k_proj.weight"),
    _op("matmul", "v", "x", "self_attn.v_proj.weight"),
    _op("attend", "attn", ("q", "k", "v")),
    _op("matmul", "o", "attn", "self_attn.o_proj.weight"),
    _op("add", "hidden", ("hidden", "o")),
    _op("rms_norm", "x2", "hidden", "post_attention_layernorm.weight"),
    _op("matmul", "gate", "x2", "mlp.gate_proj.weight"),
    _op("matmul", "up", "x2", "mlp.up_proj.weight"),
    _op("silu_mul", "h", ("gate", "up")),
    _op("matmul", "down", "h", "mlp.down_proj.weight"),
    _op("add", "hidden", ("hidden", "down")),
)

# The decode attention tail behind the `attend` seam.
ATTEND_CHAIN = (_op("rope"), _op("kv_append"), _op("paged_attention"))

# Final norm + (untied) LM head — the same norm_matmul pattern.
HEAD_CHAIN = (
    _op("rms_norm", "x", "hidden", "model.norm.weight"),
    _op("matmul", "logits", "x", "lm_head.weight"),
)

FUSIONS = ("norm_matmul", "rope_append_attend")


def enabled_fusions() -> tuple:
    """The fusion set active now (flag-resolved)."""
    if not flags.get_flag("fused_decode"):
        return ()
    raw = str(flags.get_flag("fused_decode_fusions"))
    names = {s.strip() for s in raw.split(",") if s.strip()}
    return tuple(f for f in FUSIONS if f in names)


def _consumers(chain, idx):
    """Indices of nodes reading chain[idx].out, up to its redefinition."""
    name = chain[idx].out
    uses = []
    for j in range(idx + 1, len(chain)):
        if name in chain[j].src:
            uses.append(j)
        if chain[j].out == name:
            break
    return uses


@functools.lru_cache(maxsize=None)
def fuse_chain(chain: tuple, enabled: tuple) -> tuple:
    """Pattern-match adjacent ops and swap in fused nodes. Pure function
    of (chain, enabled) — cached, so plans are built once per flag set."""
    ops = list(chain)
    if "norm_matmul" in enabled:
        out = []
        folded = {}  # norm out name -> norm node
        for i, node in enumerate(ops):
            if node.kind == "rms_norm":
                uses = _consumers(ops, i)
                if uses and all(ops[j].kind == "matmul" for j in uses):
                    folded[node.out] = node
                    continue  # norm disappears into its consumers
            if (node.kind == "matmul" and len(node.src) == 1
                    and node.src[0] in folded):
                norm = folded[node.src[0]]
                out.append(OpNode("norm_matmul", node.out, norm.src,
                                  (norm.w, node.w)))
                continue
            out.append(node)
        ops = out
    if "rope_append_attend" in enabled:
        kinds = [n.kind for n in ops]
        for i in range(len(ops) - 2):
            if kinds[i:i + 3] == ["rope", "kv_append", "paged_attention"]:
                ops[i:i + 3] = [_op("rope_append_attend")]
                break
    return tuple(ops)


def layer_plan(enabled=None) -> tuple:
    return fuse_chain(LAYER_CHAIN,
                      enabled_fusions() if enabled is None else enabled)


def attend_plan(enabled=None) -> tuple:
    return fuse_chain(ATTEND_CHAIN,
                      enabled_fusions() if enabled is None else enabled)


def head_plan(enabled=None) -> tuple:
    return fuse_chain(HEAD_CHAIN,
                      enabled_fusions() if enabled is None else enabled)


def kernel_launches_per_token(num_layers: int, tied: bool = False,
                              fused=None) -> int:
    """Static dispatch count for one decode token, derived from the op
    plans (layer plan with the attend seam expanded, plus the LM-head plan
    and the embedding gather). fused: None = current flags; True/False =
    force all/none."""
    if fused is None:
        enabled = enabled_fusions()
    else:
        enabled = FUSIONS if fused else ()
    lp = layer_plan(enabled)
    ap = attend_plan(enabled)
    per_layer = sum(0 if n.kind == "attend" else 1 for n in lp) + len(ap)
    head = len(HEAD_CHAIN) if tied else len(head_plan(enabled))
    return num_layers * per_layer + head + 1  # +1: embedding gather


def planned_kernel_launches(num_layers: int, tied: bool = False,
                            enabled=None, quantized: bool = False) -> dict:
    """Kernel launches per decode token by node kind, from the same plans
    ``kernel_launches_per_token`` counts: ``{"norm_matmul": n,
    "rope_append_attend": n, "paged_attention": n}`` (``paged_attention``
    is the unfused attend tail's attention). ``enabled`` overrides the
    flag-resolved fusion set. The prefill runs the same layer and head
    plans, with flash attention in place of the attend chain; a ragged
    wave runs them with the ragged forms of the attend kernels (K3 ragged
    for ``rope_append_attend``, K11 for ``paged_attention``).
    ``quantized`` (weight-only params) adds ``"quant_matmul"``: every
    matmul left unfused runs the weight-only matmul kernel."""
    lp, ap = layer_plan(enabled), attend_plan(enabled)
    hp = () if tied else head_plan(enabled)
    kinds = ("norm_matmul", "rope_append_attend", "paged_attention")
    out = {kind: num_layers * (sum(n.kind == kind for n in lp)
                               + sum(n.kind == kind for n in ap))
           + sum(n.kind == kind for n in hp)
           for kind in kinds + ("matmul",)}
    n_matmul = out.pop("matmul")
    if quantized:
        out["quant_matmul"] = n_matmul
    return out


# ---------------------------------------------------------------------------
# Executors — interpret a (fused) plan over a named-value environment.
# ---------------------------------------------------------------------------


def _run_plan(plan, prms, env, eps, pfx="", attend=None, plain=False):
    """THE plan interpreter. ``pfx`` scopes weight names (per-layer vs
    top-level); ``plain`` runs quantized matmuls through their plain
    version."""
    from ...models.llama import _pure_rms, _wmm
    from .fused_norm_matmul import fused_norm_matmul_pure

    for node in plan:
        if node.kind == "rms_norm":
            env[node.out] = _pure_rms(env[node.src[0]], prms[pfx + node.w],
                                      eps)
        elif node.kind == "matmul":
            env[node.out] = _wmm(env[node.src[0]], prms[pfx + node.w],
                                 plain=plain)
        elif node.kind == "norm_matmul":
            nw, mw = node.w
            env[node.out] = fused_norm_matmul_pure(
                env[node.src[0]], prms[pfx + nw], eps, prms[pfx + mw])
        elif node.kind == "attend":
            env[node.out] = attend(*[env[s] for s in node.src])
        elif node.kind == "add":
            env[node.out] = env[node.src[0]] + env[node.src[1]]
        elif node.kind == "silu_mul":
            env[node.out] = (torch.nn.functional.silu(env[node.src[0]])
                             * env[node.src[1]])
        else:  # pragma: no cover - matcher only emits the kinds above
            raise ValueError(f"unknown op kind {node.kind!r}")
    return env


def _checked_plan(plan, hidden, enabled):
    """The plan to run. On CUDA tensors a flag-resolved plan must fold
    every rms_norm into K2: an unfused norm -> matmul there would run
    plain torch ops in place of the kernel. Only an explicit ``enabled``
    (the plain reference, ``prompt_logits_pure(plain=True)``) runs the
    op-by-op chain on the card."""
    if (enabled is None and hidden.is_cuda
            and any(n.kind == "rms_norm" for n in plan)):
        raise NotImplementedError(
            "the unfused rms_norm -> matmul chain does not run on CUDA "
            "tensors; enable the norm_matmul fusion (flags fused_decode, "
            "fused_decode_fusions)")
    return plan


def run_decoder_layer(prms, i, hidden, eps, attend, enabled=None,
                      plain=False):
    """Execute the (fused) layer plan for decoder block ``i``. ``attend``
    maps flat q/k/v projections to the flat attention output."""
    plan = _checked_plan(layer_plan(enabled), hidden, enabled)
    env = _run_plan(plan, prms, {"hidden": hidden}, eps,
                    pfx=f"model.layers.{i}.", attend=attend, plain=plain)
    return env["hidden"]


def run_lm_head(prms, hidden, eps, enabled=None, plain=False):
    """Execute the (fused) final-norm + untied-LM-head plan."""
    plan = _checked_plan(head_plan(enabled), hidden, enabled)
    return _run_plan(plan, prms, {"hidden": hidden}, eps,
                     plain=plain)["logits"]


def _fused_attend() -> bool:
    return any(n.kind == "rope_append_attend" for n in attend_plan())


def decode_attend(q, k, v, cos, sin, cache, layer, active=None):
    """The decode-row attention tail (solo paged step, the batcher's
    segment steps), routed by the attend plan: K3 when the pattern is
    enabled, the op-by-op chain (attention in K10 on CUDA tensors)
    otherwise. ``active`` (B,) bool, None for every slot: an inactive slot
    writes nothing and returns zeros. Returns (out, cache)."""
    from . import fused_rope_attend as fra

    if _fused_attend():
        return fra.fused_rope_append_attend_decode(q, k, v, cos, sin, cache,
                                                   layer, active)
    return fra.decode_reference(q, k, v, cos, sin, cache, layer, active)


def ragged_attend(q, k, v, cos, sin, cache, layer, row_slot, row_pos,
                  valid, page_lens, q_start, q_lens, fresh_lens):
    """The ragged-wave attention tail (the batcher's admission step),
    routed by the attend plan: K3's ragged form when the pattern is
    enabled, the op-by-op chain (attention in K11 on CUDA tensors)
    otherwise. Returns (out, cache)."""
    from . import fused_rope_attend as fra

    if _fused_attend():
        return fra.fused_rope_append_attend(
            q, k, v, cos, sin, cache, layer, row_slot, row_pos, valid,
            page_lens, q_start, q_lens, fresh_lens)
    return fra.ragged_reference(q, k, v, cos, sin, cache, layer, row_slot,
                                row_pos, valid, page_lens, q_start, q_lens,
                                fresh_lens)
