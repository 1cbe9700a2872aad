"""Mixture-of-Experts model family (``paddle_tpu/models/moe.py``): training.

A Llama decoder block whose MLP is top-k routed SwiGLU experts with
stacked (E, ...) weights (``MoEMLP``), and the causal LM around it
(``MoEForCausalLM``, whose forward returns ``(logits, aux)``: the summed
load-balancing loss travels with the activations). Two routing lowerings
behind ``flags.moe_dropless``, as in the JAX package:

- **dropless** (on, the default): top-k selection -> stable sort of the
  token copies by expert id -> grouped SwiGLU through
  ``ops/kernels/grouped_matmul.grouped_matmul`` (K13 forward and dX, K14
  dW on CUDA tensors) -> each token's k copies weighted and summed back in
  copy order (through the inverse permutation: deterministic for any k);
- **dense** (off): the GShard (tokens, experts, capacity) dispatch as plain
  einsums, with capacity padding and overflow drops.

The attention half of each block runs the train fusion plan
(``fusion.TRAIN_ATTN_CHAIN`` through ``llama._train_fused_block``); the
post-attention norm and the final norm are ``fused_rms_norm`` (K6/K7).
Nothing in the route reads a count back to the host. Parameter names and
shapes are the JAX package's (``layers.0.mlp.w_gate`` (E, h, m),
``layers.0.mlp.gate.weight`` (h, E), ``embed_tokens.weight``, ...), so
``models/bridge.py`` carries a JAX model across. As in the JAX package,
``config.recompute`` and ``fused_head_loss`` are not read here.

``quantize_experts`` (the JAX package's) stores each layer's stacked
expert weights as weight-only int8/int4 codes and scales
(``grouped_matmul.quantize_grouped_weight``, per expert); the fp expert
parameters stay, unused, as in the JAX package, and the router gate and
shared experts stay fp. The dropless route then runs K13's int8/int4
form forward and dX through the dequantized stack (codes and scales take
no gradient); the dense route expands the codes with
``grouped_matmul._expand_expert_weight`` first.

Fault site ``moe.dispatch`` (``reliability/faults.py``) fires at each
layer's routing, as in the JAX package: a clean error, never a hang.

Not ported: expert parallelism (``apply_moe_expert_parallel``, the ep
ring route); it raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..framework import flags
from ..framework.dtype import to_torch_dtype
from ..framework.place import resolve_device
from ..framework.random import make_generator
from ..nn import Embedding, Layer, RMSNorm
from ..nn.common import INIT_STD
from ..reliability import faults
from .llama import LlamaAttention, LlamaConfig, _proj, _train_fused_block

_NOT_PORTED_EP = ("expert parallelism (the ep ring route over NCCL) is not "
                  "ported yet (ROADMAP Queue 1 item 10)")
#: quantize_experts' algorithms and the weight types they store
_EXPERT_QUANT = {"weight_only_int8": "int8", "weight_only_int4": "int4"}
#: the stacked expert weights a layer quantizes
EXPERT_STACKS = ("w_gate", "w_up", "w_down")


@dataclass
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    # DeepSeekMoE-style shared expert that always runs
    num_shared_experts: int = 0

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    rope_theta=10000.0, num_experts=4, top_k=2)
        base.update(kw)
        return MoEConfig(**base)


def _aux_loss(probs):
    """GShard/Switch load-balance loss from the (G, S, E) softmax probs:
    ``E * mean_g sum_e(f_e * P_e)``, with f_e the TOP-1 assignment share
    (Mixtral counts all top-k choices; this is the JAX package's formula);
    1 when perfectly balanced. Both routing lowerings call it."""
    e = probs.shape[-1]
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=1)                                        # (G, E)
    ce = F.one_hot(top1, e).to(torch.float32).mean(dim=1)
    return (me * ce).sum(dim=-1).mean() * e


def _top_k_gating(logits, k: int, capacity: int):
    """GShard top-k gating: (dispatch, combine, aux) for (G, S, E) logits;
    dispatch and combine are (G, S, E, C) f32. k rounds of argmax (first
    index among equal values), each filling its expert's capacity slots
    in token order; a token past capacity is dropped."""
    g, s, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    aux = _aux_loss(probs)
    dev = logits.device
    dispatch = torch.zeros((g, s, e, capacity), device=dev)
    combine = torch.zeros((g, s, e, capacity), device=dev)
    remaining = probs
    fill = torch.zeros((g, e), dtype=torch.int64, device=dev)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                     # (G, S)
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e)                                # (G, S, E)
        pos = torch.cumsum(onehot, dim=1) - 1 + fill[:, None, :]
        fill = fill + onehot.sum(dim=1)
        pos_tok = (pos * onehot).sum(dim=-1)                      # (G, S)
        keep = (pos_tok < capacity).to(torch.float32)
        cap_oh = F.one_hot(torch.clamp(pos_tok, 0, capacity - 1),
                           capacity).to(torch.float32)            # (G, S, C)
        slot = (onehot.to(torch.float32)[..., None] * cap_oh[:, :, None, :]
                * keep[..., None, None])
        dispatch = dispatch + slot
        combine = combine + slot * gate[..., None, None]
        remaining = remaining * (1.0 - onehot.to(torch.float32))
    denom = combine.sum(dim=(2, 3), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    return dispatch, combine, aux


def _topk_select(probs, k: int):
    """The dense path's top-k rule without the capacity tensors: k rounds
    of argmax over the remaining probs (the same tie-breaking). Returns
    expert ids (G, S, k) int32 and the raw gate probs (G, S, k) f32."""
    e = probs.shape[-1]
    ids, gates = [], []
    remaining = probs
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        ids.append(idx)
        gates.append(remaining.gather(-1, idx[..., None])[..., 0])
        remaining = remaining * (1.0 - F.one_hot(idx, e).to(torch.float32))
    return (torch.stack(ids, dim=-1).to(torch.int32),
            torch.stack(gates, dim=-1))


def dense_dropped_token_rate(logits, k: int, capacity: int):
    """Fraction of the G*S*k routed token copies the dense GShard dispatch
    DROPS at this capacity (0-d f32); the dropless path drops none."""
    g, s, _ = logits.shape
    dispatch, _, _ = _top_k_gating(torch.as_tensor(logits), k, capacity)
    return 1.0 - dispatch.sum() / (g * s * k)


# ---------------------------------------------------------------------------
# Routing lowerings
# ---------------------------------------------------------------------------


def _dense_route(x_a, logits_a, wg, wu, wd, k, capacity):
    """The GShard dense-einsum dispatch (the flag-off lowering)."""
    dispatch, combine, aux = _top_k_gating(logits_a, k, capacity)
    xin = torch.einsum("gsec,gsm->egcm", dispatch,
                       x_a.float()).to(x_a.dtype)
    hgate = torch.einsum("egcm,emf->egcf", xin, wg)
    hup = torch.einsum("egcm,emf->egcf", xin, wu)
    hact = F.silu(hgate) * hup
    out = torch.einsum("egcf,efm->egcm", hact, wd)
    y = torch.einsum("gsec,egcm->gsm", combine, out.float()).to(x_a.dtype)
    return y, aux


def _grouped_swiglu(xs, offsets, wg, wu, wd, weight_dtype="fp",
                    group_size=-1, scales=None, plain=False):
    """SwiGLU over expert-sorted rows, all three projections through the
    grouped matmul (K13/K14 on CUDA tensors, or a raise; ``plain``: the
    plain versions on any device)."""
    from ..ops.kernels.grouped_matmul import grouped_matmul

    sg, su, sd = scales if scales is not None else (None, None, None)
    hg = grouped_matmul(xs, offsets, wg, sg, weight_dtype, group_size, plain)
    hu = grouped_matmul(xs, offsets, wu, su, weight_dtype, group_size, plain)
    hact = F.silu(hg) * hu
    return grouped_matmul(hact, offsets, wd, sd, weight_dtype, group_size,
                          plain)


def _dropless_routing(logits_a, k):
    """The dropless route's routing, all on the logits' device: (aux,
    combine weights (T, k) f32 renormalized over the k choices, order (the
    stable sort of the token-major copies by expert id), group offsets
    (E + 1,) int32)."""
    e = logits_a.shape[-1]
    probs = torch.softmax(logits_a.float(), dim=-1)
    aux = _aux_loss(probs)
    ids, gates = _topk_select(probs, k)                           # (G,S,k)
    wcomb = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    eid = ids.reshape(-1).long()                                  # token-major
    sorted_eid, order = torch.sort(eid, stable=True)
    # offsets[e] = the copies routed below expert e (bincount + cumsum of
    # the JAX package; torch.bincount reads its size back to the host)
    offsets = torch.searchsorted(sorted_eid,
                                 torch.arange(e + 1, device=eid.device))
    return aux, wcomb.reshape(-1, k), order, offsets.to(torch.int32)


def _dispatch(x2, order, k):
    """The expert-sorted copies x2[order // k] of (T, h) rows, built as a
    token-major repeat then a permutation, so the backward sums each
    token's k copy gradients in copy order."""
    return x2.repeat_interleave(k, dim=0)[order]


def _combine(ys, order, wcomb, dtype):
    """y[t] = sum_j wcomb[t, j] * ys[copy j of t] in f32, in copy order j =
    0..k-1, cast to ``dtype``: the JAX package's scatter-add of the
    weighted copies, through the inverse permutation."""
    t, k = wcomb.shape
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    ys_tok = ys[inv].reshape(t, k, ys.shape[-1])
    y = ys_tok[:, 0].float() * wcomb[:, :1]
    for j in range(1, k):
        y = y + ys_tok[:, j].float() * wcomb[:, j:j + 1]
    return y.to(dtype)


def _dropless_route(x_a, logits_a, wg, wu, wd, k, weight_dtype="fp",
                    group_size=-1, scales=None, plain=False):
    """Sort-based dropless routing: every routed copy is computed. top-k
    select -> stable sort of the G*S*k copies by expert id (one contiguous
    row block per expert) -> grouped SwiGLU -> combine by weight."""
    g, s, h = x_a.shape
    aux, wcomb, order, offsets = _dropless_routing(logits_a, k)
    xs = _dispatch(x_a.reshape(g * s, h), order, k)
    ys = _grouped_swiglu(xs, offsets, wg, wu, wd, weight_dtype, group_size,
                         scales, plain)
    return _combine(ys, order, wcomb, x_a.dtype).reshape(g, s, h), aux


def apply_moe_expert_parallel(model, mesh, ep_axis="ep", mp_axis="mp",
                              fsdp_axis=None):
    """Not ported yet: the expert-parallel route (the ep ring bodies)."""
    raise NotImplementedError(_NOT_PORTED_EP)


# ---------------------------------------------------------------------------
# Modules (the JAX package's names and shapes)
# ---------------------------------------------------------------------------


class MoEMLP(Layer):
    """Top-k routed SwiGLU experts with stacked (E, h, m) / (E, m, h)
    weights and an (h, E) router; ``forward`` returns ``(y, aux)``."""

    def __init__(self, config: MoEConfig, *, dtype, device, gen):
        super().__init__()
        self.config = config
        h, m, e = (config.hidden_size, config.intermediate_size,
                   config.num_experts)
        kw = dict(dtype=dtype, device=device, generator=gen, std=INIT_STD)
        self.gate = _proj(h, e, dtype, device, gen)
        self.w_gate = self.create_parameter((e, h, m), **kw)
        self.w_up = self.create_parameter((e, h, m), **kw)
        self.w_down = self.create_parameter((e, m, h), **kw)
        if config.num_shared_experts:
            sm = m * config.num_shared_experts
            self.shared_gate_proj = _proj(h, sm, dtype, device, gen)
            self.shared_up_proj = _proj(h, sm, dtype, device, gen)
            self.shared_down_proj = _proj(sm, h, dtype, device, gen)
        self._expert_quant = None     # set by quantize_experts()

    def capacity(self, seq_len: int) -> int:
        """The dense dispatch's per-expert capacity at this sequence length
        (the dropless path has none)."""
        cfg = self.config
        return max(1, int(cfg.capacity_factor * seq_len * cfg.top_k
                          / cfg.num_experts))

    def quantize_experts(self, algo: str = "weight_only_int8",
                         group_size: int = -1):
        """Store the stacked expert weights as weight-only quantized codes
        and scales (THE shared absmax rule, per expert) in
        ``_expert_quant``: ``weight_dtype``, ``group_size`` and a (codes,
        scales) pair for each of ``w_gate``, ``w_up`` and ``w_down``, on
        the weights' device. Both routes consume them; the router gate
        and any shared experts stay fp."""
        from ..ops.kernels.grouped_matmul import quantize_grouped_weight

        wd = _EXPERT_QUANT.get(algo)
        if wd is None:
            raise ValueError(f"unsupported expert quant algo {algo!r}")
        with torch.no_grad():
            self._expert_quant = {
                "weight_dtype": wd, "group_size": int(group_size),
                **{name: quantize_grouped_weight(getattr(self, name), algo,
                                                 group_size)
                   for name in EXPERT_STACKS}}
        return self

    def _expert_weights(self, dtype):
        """The dense route's (w_gate, w_up, w_down): the parameters, or
        with quantized experts their codes expanded into ``dtype``."""
        eq = self._expert_quant
        if eq is None:
            return self.w_gate, self.w_up, self.w_down
        from ..ops.kernels.grouped_matmul import _expand_expert_weight

        h, m = self.config.hidden_size, self.config.intermediate_size
        return tuple(_expand_expert_weight(*eq[name], eq["weight_dtype"],
                                           eq["group_size"], k, dtype)
                     for name, k in zip(EXPERT_STACKS, (h, h, m)))

    def forward(self, x, router_probe=None, *, plain=False):
        """``router_probe``: a list this layer's router logits are appended
        to. ``plain``: the grouped matmuls' plain versions (the on-card
        reference)."""
        cfg = self.config
        eq = self._expert_quant
        logits = x @ self.gate.weight                             # (B, S, E)
        if router_probe is not None:
            router_probe.append(logits.detach())
        path = "dropless" if flags.get_flag("moe_dropless") else "dense"
        # the routing seam's fault site: a clean error, never a hang
        if eq is None:
            faults.maybe_fail("moe.dispatch", path=path)
        else:
            faults.maybe_fail("moe.dispatch", quant=eq["weight_dtype"],
                              path=path)
        if path == "dropless":
            if eq is None:
                y, aux = _dropless_route(x, logits, self.w_gate, self.w_up,
                                         self.w_down, cfg.top_k, plain=plain)
            else:
                y, aux = _dropless_route(
                    x, logits, *(eq[n][0] for n in EXPERT_STACKS), cfg.top_k,
                    weight_dtype=eq["weight_dtype"],
                    group_size=eq["group_size"],
                    scales=tuple(eq[n][1] for n in EXPERT_STACKS),
                    plain=plain)
        else:
            y, aux = _dense_route(x, logits, *self._expert_weights(x.dtype),
                                  cfg.top_k, self.capacity(x.shape[1]))
        if cfg.num_shared_experts:
            y = y + (F.silu(x @ self.shared_gate_proj.weight)
                     * (x @ self.shared_up_proj.weight)
                     ) @ self.shared_down_proj.weight
        return y, aux


class MoEDecoderLayer(Layer):
    def __init__(self, config: MoEConfig, *, dtype, device, gen):
        super().__init__()
        eps = config.rms_norm_eps
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype=dtype,
                                       device=device)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                dtype=dtype, device=device)
        self.mlp = MoEMLP(config, **kw)

    def forward(self, hidden, attn_mask=None, router_probe=None, *,
                plain=False):
        """The attention half through the train plan (K2 folds, K1 and K5
        or K9, the o-proj and residual as the attention's epilogue) under
        ``attn_mask``, then the routed MLP on the post-attention norm
        (K6/K7)."""
        h = _train_fused_block(self, hidden, attn_mask, plain=plain,
                               attn_only=True)
        y, aux = self.mlp(self.post_attention_layernorm(h, plain=plain),
                          router_probe=router_probe, plain=plain)
        return h + y, aux


class MoEForCausalLM(Layer):
    """Llama-architecture causal LM with MoE FFNs and the aux balancing
    loss. Runs on ``cuda`` unless ``device="cpu"``; weights are drawn from
    ``seed`` (N(0, 0.02²), unit norm weights) in ``config.dtype``. Built
    in eval mode; ``train()`` turns on gradients."""

    def __init__(self, config: MoEConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        gen = make_generator(seed, self.device)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      dtype=dtype, device=self.device,
                                      generator=gen)
        self.layers = nn.ModuleList(
            [MoEDecoderLayer(config, dtype=dtype, device=self.device, gen=gen)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            dtype=dtype, device=self.device)
        self.lm_head = _proj(config.hidden_size, config.vocab_size, dtype,
                             self.device, gen)
        self.eval()

    def forward(self, input_ids, attn_mask=None, router_probe=None, *,
                plain=False):
        """(logits (B, S, V), the summed aux loss). ``attn_mask``: a mask
        for every block's attention (as ``LlamaForCausalLM``'s). ``plain``:
        every kernel's plain version and the unfused plans (the on-card
        reference)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=self.device)
        hidden = self.embed_tokens(ids)
        aux_total = None
        for layer in self.layers:
            hidden, aux = layer(hidden, attn_mask, router_probe=router_probe,
                                plain=plain)
            aux_total = aux if aux_total is None else aux_total + aux
        return self.norm(hidden, plain=plain) @ self.lm_head.weight, aux_total

    def quantize_experts(self, algo: str = "weight_only_int8",
                         group_size: int = -1):
        """Quantize every layer's stacked expert weights
        (``MoEMLP.quantize_experts``); the dense trunk stays fp."""
        for layer in self.layers:
            layer.mlp.quantize_experts(algo, group_size)
        return self

    @staticmethod
    def flops_per_token(config: MoEConfig, seq_len: int) -> float:
        """6N + attention accounting over ACTIVE params per token: top_k
        expert SwiGLUs, the router and any shared experts (the JAX
        package's)."""
        h, L = config.hidden_size, config.num_hidden_layers
        m = config.intermediate_size
        kv = config.num_key_value_heads * config.head_dim
        k_active = min(config.top_k, config.num_experts)
        ffn = 3 * h * m * (k_active + config.num_shared_experts)
        n_active = (config.vocab_size * h
                    * (1 if config.tie_word_embeddings else 2)
                    + L * (h * h + 2 * h * kv + h * h
                           + h * config.num_experts + ffn))
        attn = 12 * L * h * seq_len / 2  # causal: half the S^2 term
        return 6.0 * n_active + attn

    def loss(self, outputs, labels, *, count_group=None):
        """Next-token cross-entropy of the logits plus
        ``moe_aux_loss_coef`` times the aux loss (``count_group``: the
        data-parallel group whose valid targets the mean counts,
        ``ops/loss_ops.py``)."""
        from ..ops.loss_ops import cross_entropy

        logits, aux = (outputs if isinstance(outputs, (tuple, list))
                       else (outputs, None))
        labels = torch.as_tensor(labels, device=logits.device).long()
        b, s, v = logits.shape
        lm = cross_entropy(logits[:, :-1, :].reshape(b * (s - 1), v),
                           labels[:, 1:].reshape(b * (s - 1)),
                           count_group=count_group)
        if aux is not None:
            return lm + aux * self.config.moe_aux_loss_coef
        return lm
