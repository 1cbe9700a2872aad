"""The fusion pass (``paddle_tpu/ops/pallas/fusion.py``): decode and train.

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

The training half (``TRAIN_CHAIN``, ``fuse_train_chain``) runs the same
block with a rope (K12) + flash-attention attend seam: ``norm_matmul``
folds each norm into ALL its consumers as one ``norm_multi_matmul`` node
(K2 per consumer forward, one VJP), ``attn_epilogue`` folds (attend,
o-proj, residual add) into one node whose o-proj and add follow the
attention output, and ``optimizer_update`` collapses the AdamW8bit chain
into one sweep (K8). ``train_kernel_launches_per_step`` derives every
kernel's launches per train step from the same plans. MoE blocks run the
attention half alone (``TRAIN_ATTN_CHAIN``) and route their MLP through
the grouped matmul; ``moe_train_kernel_launches_per_step`` counts their
step (K13, and K14 under the ``moe_grouped_bwd`` family).
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


# ---------------------------------------------------------------------------
# Training half
# ---------------------------------------------------------------------------

#: the training block is the decode block's op list; only the attend
#: seam's contents differ (rope + flash attention, ``models/llama.py``)
TRAIN_CHAIN = LAYER_CHAIN
#: the attention half alone (through the post-attention residual add):
#: MoE decoder blocks run this plan and keep their routed MLP wiring
TRAIN_ATTN_CHAIN = LAYER_CHAIN[:7]

#: the unfused AdamW8bit update as data; optimizer_update makes it one node
OPT_CHAIN = (
    _op("dequant_m"), _op("dequant_v"), _op("moment_update_m"),
    _op("moment_update_v"), _op("bias_correction"), _op("weight_decay"),
    _op("param_update"), _op("requant_m"), _op("requant_v"),
)

TRAIN_FUSIONS = ("norm_matmul", "attn_epilogue", "optimizer_update",
                 "moe_grouped_bwd")


def enabled_train_fusions() -> tuple:
    """The train fusion families active now (flag-resolved)."""
    if not flags.get_flag("fused_train"):
        return ()
    raw = str(flags.get_flag("fused_train_fusions"))
    names = {s.strip() for s in raw.split(",") if s.strip()}
    return tuple(f for f in TRAIN_FUSIONS if f in names)


def train_fusion_on(name: str) -> bool:
    """Is one train fusion family active?"""
    return name in enabled_train_fusions()


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


@functools.lru_cache(maxsize=None)
def fuse_train_chain(chain: tuple, enabled: tuple) -> tuple:
    """The training matcher: ``norm_matmul`` folds each norm into ONE
    ``norm_multi_matmul`` node over all its (adjacent) matmul consumers, so
    the norm weight gets one gradient; ``attn_epilogue`` folds (attend,
    o-proj matmul, residual add) into one ``attend_epilogue`` node."""
    ops = list(chain)
    if "norm_matmul" in enabled:
        out, i = [], 0
        while i < len(ops):
            node = ops[i]
            if node.kind == "rms_norm":
                uses = _consumers(ops, i)
                if uses and all(ops[j].kind == "matmul" for j in uses):
                    if uses != list(range(i + 1, i + 1 + len(uses))):
                        raise ValueError("norm consumers not adjacent")
                    out.append(OpNode(
                        "norm_multi_matmul", tuple(ops[j].out for j in uses),
                        node.src, (node.w, tuple(ops[j].w for j in uses))))
                    i += 1 + len(uses)
                    continue
            out.append(node)
            i += 1
        ops = out
    if "attn_epilogue" in enabled:
        for i in range(len(ops) - 2):
            a, m, r = ops[i], ops[i + 1], ops[i + 2]
            if (a.kind == "attend" and m.kind == "matmul"
                    and m.src == (a.out,) and r.kind == "add"
                    and set(r.src) == {r.out, m.out}):
                ops[i:i + 3] = [OpNode("attend_epilogue", r.out,
                                       a.src + (r.out,), m.w)]
                break
    return tuple(ops)


def train_layer_plan(enabled=None, attn_only: bool = False) -> tuple:
    """The (fused) training plan of one decoder block, or of its attention
    half alone (``attn_only``, the MoE block's share)."""
    return fuse_train_chain(
        TRAIN_ATTN_CHAIN if attn_only else TRAIN_CHAIN,
        enabled_train_fusions() if enabled is None else enabled)


def train_head_plan(enabled=None) -> tuple:
    """Final norm + untied LM head for the TRAIN forward (a
    single-consumer group under ``norm_matmul``)."""
    enabled = enabled_train_fusions() if enabled is None else enabled
    return fuse_train_chain(
        HEAD_CHAIN, ("norm_matmul",) if "norm_matmul" in enabled else ())


def train_opt_plan(enabled=None) -> tuple:
    """The optimizer update's plan: one fused node, or the unfused list."""
    enabled = enabled_train_fusions() if enabled is None else enabled
    if "optimizer_update" in enabled:
        return (_op("fused_adamw8bit"),)
    return OPT_CHAIN


def _bwd_kernel_counts(n: int, attn_shape) -> dict:
    """``n`` attention backwards by counter: K9 where the flash backward's
    dispatch (``flash_attention.bwd_uses_fused``) picks it at
    ``attn_shape`` = (batch, seq, heads, head_dim), else K5. Under
    ``flash_bwd_impl="fused"`` the shape decides, so it must be given."""
    from . import flash_attention

    fused = False
    if flags.get_flag("flash_bwd_impl") == "fused":
        if attn_shape is None:
            raise ValueError("flash_bwd_impl='fused': the launch plan needs "
                             "attn_shape=(batch, seq, heads, head_dim)")
        b, s, h, d = attn_shape
        fused = flash_attention.bwd_uses_fused(b, s, s, h, d)
    return {"flash_attention_bwd": 0 if fused else n,
            "flash_attention_bwd_fused": n if fused else 0}


def rope_launches_per_step(n_attend: int, runs: int = 1) -> int:
    """K12 launches of ``n_attend`` training attend seams
    (``models/llama._train_attend``): q and k each roped in every forward
    run (``runs``: 2 where per-block recompute re-runs the block, whose
    rope the kept (out, lse) of ``flash_save_residuals`` do not skip) and
    once in backward."""
    return n_attend * 2 * (runs + 1)


def train_kernel_launches_per_step(num_layers: int, n_params: int, *,
                            recompute: bool, granularity: str = "full",
                            fused_head_loss: bool, tied: bool = False,
                            optimizer: str = "adamw8bit",
                            enabled=None, attn_shape=None) -> dict:
    """Kernel launches of one train step (forward, backward, update) by
    counter name, from the train plans: K2 per consumer of each
    ``norm_multi_matmul`` node, K1 per attend node, each again when
    per-block recompute re-runs the block in backward (K1 not, under
    ``core_attn`` with ``flash_save_residuals``: the first forward's
    (out, lse) are kept), K5 or K9 once per attend node (K9 where the
    backward's dispatch picks it at ``attn_shape``); K12 on q and k of
    each attend node, forward (again under recompute) and backward
    (``rope_launches_per_step``); the final norm in K6/K7
    (one K7 count is one call: its row kernel and its dw sum kernel)
    when the head runs in the chunked loss (``fused_head_loss``), else in
    K2 through the head plan; one K8 per parameter tensor (``n_params``)
    for AdamW8bit with ``optimizer_update``. With no family enabled
    (``fused_train`` off) the blocks run the unfused plan: every norm in
    K6/K7. ``enabled`` overrides the flag-resolved families."""
    enabled = enabled_train_fusions() if enabled is None else enabled
    lp = fuse_train_chain(TRAIN_CHAIN, enabled)
    k2 = sum(len(n.w[1]) for n in lp if n.kind == "norm_multi_matmul")
    k1 = sum(n.kind in ("attend", "attend_epilogue") for n in lp)
    keep = (granularity == "core_attn"
            and bool(flags.get_flag("flash_save_residuals")))
    runs = 2 if recompute else 1
    out = {"flash_attention": num_layers * k1 * (1 if keep else runs),
           **_bwd_kernel_counts(num_layers * k1, attn_shape),
           "fused_rope": rope_launches_per_step(num_layers * k1, runs),
           "fused_norm_matmul": num_layers * k2 * runs,
           "rms_norm_fwd": 0, "rms_norm_bwd": 0,
           "adamw8bit": (n_params if optimizer == "adamw8bit"
                         and "optimizer_update" in enabled else 0)}
    if not enabled:
        # fused_train off: the unfused plan, every norm node in K6 (again
        # under recompute) and K7
        n_norms = sum(n.kind == "rms_norm" for n in lp)
        out["rms_norm_fwd"] = num_layers * n_norms * runs
        out["rms_norm_bwd"] = num_layers * n_norms
    if fused_head_loss or tied or not enabled:
        out["rms_norm_fwd"] += 1
        out["rms_norm_bwd"] += 1
    else:
        out["fused_norm_matmul"] += sum(
            len(n.w[1]) for n in train_head_plan(enabled)
            if n.kind == "norm_multi_matmul")
    return out


def moe_train_kernel_launches_per_step(num_layers: int, n_params: int, *,
                                       enabled=None, attn_shape=None,
                                       quantized_experts: bool = False
                                       ) -> dict:
    """Kernel launches of one MoE train step (``models/moe.py``, no
    per-block recompute, as in the JAX package) by counter name: the
    attention half's plan as ``train_kernel_launches_per_step`` counts it
    (K2 per ``norm_multi_matmul`` consumer, K1 and K5 or K9 per attend
    node, K9 where the backward's dispatch picks it at ``attn_shape``, its
    norm in K6/K7 when unfused, K12 on q and k forward and backward), the
    post-attention norm and the final
    norm in K6/K7, three K13 forward and three K13 dX a layer (gate, up,
    down), three K14 dW under ``moe_grouped_bwd`` (on the card the step
    raises with the family off), one K8 per parameter tensor
    (``n_params``) for AdamW8bit under ``optimizer_update``. With
    ``quantized_experts`` (``MoEForCausalLM.quantize_experts``) the three
    forwards a layer are K13's int8/int4 form (``grouped_matmul_quant``),
    the three dX still K13's transposed form, and no K14: codes take no
    dW."""
    if quantized_experts:
        plan = moe_train_kernel_launches_per_step(
            num_layers, n_params, enabled=enabled, attn_shape=attn_shape)
        plan.update(grouped_matmul=num_layers * 3,
                    grouped_matmul_quant=num_layers * 3, segment_dw=0)
        return plan
    enabled = enabled_train_fusions() if enabled is None else enabled
    lp = train_layer_plan(enabled, attn_only=True)
    k1 = sum(n.kind in ("attend", "attend_epilogue") for n in lp)
    norms = 1 + sum(n.kind == "rms_norm" for n in lp)
    return {"flash_attention": num_layers * k1,
            **_bwd_kernel_counts(num_layers * k1, attn_shape),
            "fused_rope": rope_launches_per_step(num_layers * k1),
            "fused_norm_matmul": num_layers * sum(
                len(n.w[1]) for n in lp if n.kind == "norm_multi_matmul"),
            "rms_norm_fwd": num_layers * norms + 1,
            "rms_norm_bwd": num_layers * norms + 1,
            "grouped_matmul": num_layers * 6,
            "segment_dw": (num_layers * 3 if "moe_grouped_bwd" in enabled
                           else 0),
            "adamw8bit": n_params if "optimizer_update" in enabled else 0}


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


def _run_plan(plan, prms, env, eps, pfx="", attend=None, plain=False,
              train=False):
    """THE plan interpreter. ``pfx`` scopes weight names (per-layer vs
    top-level); ``plain`` runs quantized matmuls, and on a train plan the
    norms, through their plain versions; ``train`` runs each unfused
    rms_norm as ``fused_rms_norm`` (K6 forward, K7 backward)."""
    from ...models.llama import _pure_rms, _wmm
    from .fused_norm_matmul import fused_norm_matmul_pure
    from .fused_norm_rope import fused_rms_norm

    for node in plan:
        if node.kind == "rms_norm":
            norm = (functools.partial(fused_rms_norm, plain=plain) if train
                    else _pure_rms)
            env[node.out] = norm(env[node.src[0]], prms[pfx + node.w], eps)
        elif node.kind == "matmul":
            env[node.out] = _wmm(env[node.src[0]], prms[pfx + node.w],
                                 plain=plain)
        elif node.kind == "norm_matmul":
            nw, mw = node.w
            env[node.out] = fused_norm_matmul_pure(
                env[node.src[0]], prms[pfx + nw], eps, prms[pfx + mw])
        elif node.kind == "norm_multi_matmul":
            from .fused_norm_matmul import fused_norm_multi_matmul_pure

            nw, mws = node.w
            outs = fused_norm_multi_matmul_pure(
                env[node.src[0]], prms[pfx + nw], eps,
                tuple(prms[pfx + w] for w in mws))
            env.update(zip(node.out, outs))
        elif node.kind == "attend":
            env[node.out] = attend(*[env[s] for s in node.src])
        elif node.kind == "attend_epilogue":
            # the folded (attend, o-proj matmul, residual add): the o-proj
            # and the add follow the attention output in the attend seam
            env[node.out] = attend(
                env[node.src[0]], env[node.src[1]], env[node.src[2]],
                residual=env[node.src[3]], o_w=prms[pfx + node.w])
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
            "fused_decode_fusions; for training fused_train, "
            "fused_train_fusions)")
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


def run_train_decoder_layer(prms, hidden, eps, attend, enabled=None,
                            plain=False, attn_only=False):
    """Execute the (fused) TRAIN plan for one decoder block over its own
    params (layer-local names). ``attend`` maps flat q/k/v to the flat
    attention output (rope + flash attention); under ``attn_epilogue`` it
    also takes ``residual=`` and ``o_w=``. ``attn_only`` runs the attention
    half (the MoE block's share) and returns the post-attention residual
    stream. On CUDA tensors a flag-resolved plan with an unfused norm
    raises; an explicit ``enabled=()`` runs the unfused plan (norms in
    K6/K7, or their plain versions with ``plain``)."""
    plan = _checked_plan(train_layer_plan(enabled, attn_only), hidden,
                         enabled)
    return _run_plan(plan, prms, {"hidden": hidden}, eps, attend=attend,
                     plain=plain, train=True)["hidden"]


def run_train_lm_head(prms, hidden, eps, enabled=None, plain=False):
    """Execute the (fused) final-norm + untied-LM-head TRAIN plan."""
    plan = _checked_plan(train_head_plan(enabled), hidden, enabled)
    return _run_plan(plan, prms, {"hidden": hidden}, eps, plain=plain,
                     train=True)["logits"]


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
                  valid, page_lens, q_start, q_lens, fresh_lens,
                  fresh_pool_read=None):
    """The ragged-wave attention tail (the batcher's waves, the solo spec
    verify step), routed by the attend plan: K3's ragged form when the
    pattern is enabled, the op-by-op chain (attention in K11 on CUDA
    tensors) otherwise. ``fresh_pool_read`` (B,) bool marks speculative
    verify segments, whose fresh K/V are read as the pool holds them; None
    is the plain wave. Returns (out, cache)."""
    from . import fused_rope_attend as fra

    if _fused_attend():
        return fra.fused_rope_append_attend(
            q, k, v, cos, sin, cache, layer, row_slot, row_pos, valid,
            page_lens, q_start, q_lens, fresh_lens,
            fresh_pool_read=fresh_pool_read)
    return fra.ragged_reference(q, k, v, cos, sin, cache, layer, row_slot,
                                row_pos, valid, page_lens, q_start, q_lens,
                                fresh_lens, fresh_pool_read)
