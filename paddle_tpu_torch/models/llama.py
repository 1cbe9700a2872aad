"""Llama serving in PyTorch (``paddle_tpu/models/llama.py``, serving half).

The slice ported here is ``generate_paged``: a bucketed prompt
prefill (rope in K12, causal flash attention in K1) that fills a paged KV
cache, then one decode step per new token whose per-layer attention tail
is the fused rope -> append -> attend kernel (K3); every rms_norm folds
into the matmuls that follow it (K2). Each token is the argmax of its
logits, or with ``temperature > 0`` a draw after the JAX package's
temperature / top-k / top-p filter (``_sample_from_logits``: the filter
in plain ops, the JAX package has no kernel for it; the draw Gumbel-max
from a seeded generator). With ``spec_decode=True``
speculative verify steps replace the decode steps: one ragged wave a step
over every row's current token and its drafts (K3's ragged form with
``fresh_pool_read``).
With ``params=quantize_for_inference(model)``
every matmul weight is weight-only int8/int4: K2 dequantizes it in its
tiles and the two matmuls no norm precedes (o_proj, down_proj) run the
weight-only matmul kernel (K4); ``cache_dtype="int8"`` stores the paged
cache as int8 codes with per-cell scales. Weights keep the JAX package's
parameter names and its (in, out) layout, so ``models/bridge.py`` copies a
JAX model's parameters without transposing.

PyTorch runs eagerly: the JAX package's jitted prefill and ``lax.scan``
decode loop become a plain function and a Python loop, and the page pools
are updated in place. The continuous-batching server over the same decoder
blocks is ``inference/continuous_batching.py``.

Training: ``model.train()`` turns gradients on and ``forward`` into the
training forward. Each decoder block runs the fusion pass's TRAIN plan
(``_train_fused_block``: K2 per norm consumer, rope (K12) + flash
attention with its K5 backward, o-proj + residual as the attention's
epilogue), under per-block recompute (``torch.utils.checkpoint``) when
``config.recompute``;
with ``fused_head_loss`` the forward returns the final-normed hidden states
(the norm in K6/K7) and ``loss`` runs the chunked ``linear_cross_entropy``.
``jit.TrainStep`` drives forward, loss, backward and the optimizer.
``forward(ids, attn_mask)`` takes a key-padding mask (bool or additive,
(B, S) or (B, 1, 1, S)) into every block's attention, where it rides the
flash kernels as a key bias, in training and in eval alike.
``forward(ids, plain=True)`` runs every kernel's plain version and the
unfused plans (the on-card reference).

Tensor and sequence parallelism (``apply_llama_tensor_parallel``, one
process a rank): each rank keeps its shards of the reference's cut
points (``llama_sharding_plan``: q/k/v/gate/up on columns, o/down on
rows, the embedding and the LM head on the vocab). As the JAX package
turns the train fusions off under a TP context, each block runs the
unfused TRAIN plan (norms in K6/K7, rope in K12, attention in K1 and
K5/K9 on its local heads, ``torch.matmul`` on the local shards) with the
block's collectives (``_TPBlock``: a column-cut input's all-reduce
backward, the row-cut o/down products through ``distributed/overlap.py``);
the head runs vocab-parallel (``ops/loss_ops.py``'s ``vocab_group``). With
``sequence_parallel`` the residual stream lives sequence-cut between the
blocks: ``shard_seq`` after the embedding, a gather at each block's
entry and before the head, ``matmul_rs`` at each block's exit; the norm
weights then get their block's share of the gradient, all-reduced by
``register_sequence_parallel_allreduce_hooks``. Serving a TP model is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..framework.contract import refuse_unported
from ..framework.dtype import to_torch_dtype
from ..framework.place import resolve_device
from ..framework.random import make_generator
from ..nn import Embedding, Layer, Linear, RMSNorm


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    # attention through the flash kernels (the only path ported)
    use_flash_attention: bool = True
    # per-block activation recomputation in training; "full" keeps only the
    # block input, "core_attn" also the attention's (out, lse) when
    # flags.flash_save_residuals is on
    recompute: bool = False
    recompute_granularity: str = "full"
    # training forward returns final hidden states and loss() runs the
    # chunked linear_cross_entropy (the (B, S, V) logits never exist)
    fused_head_loss: bool = False
    loss_chunk_size: int = 2048
    # ring attention over a mesh axis: not ported
    context_parallel: bool = False
    cp_axis: str = "sp"
    dtype: str = "float32"

    def __post_init__(self):
        if self.recompute_granularity not in ("full", "core_attn"):
            raise ValueError(
                f"recompute_granularity must be 'full' or 'core_attn', got "
                f"{self.recompute_granularity!r}")
        if self.context_parallel:
            raise NotImplementedError(
                "context parallelism (ring attention) is not ported")
        refuse_unported("LlamaConfig",
                        use_flash_attention=(self.use_flash_attention, True))

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rope_theta=500000.0), **kw})

    @staticmethod
    def tiny(**kw):
        """Test-scale config."""
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0), **kw})


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def _rope_tables(seq_len: int, head_dim: int, theta: float,
                 dtype=torch.float32, device=None):
    """cos/sin tables (S, D)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)           # (S, D)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k: (B, S, H, D); cos/sin: (S, D)."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    q2 = q * cos + _rotate_half(q) * sin
    k2 = k * cos + _rotate_half(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


def apply_rotary_rows(q, k, cos, sin):
    """Rope over a flat row batch: q (T, H, D), k (T, Hk, D), cos/sin (T, D)
    at each row's own position. f32 rotate-half, cast back to the input
    dtype — the serving decode rope (K3 reproduces it)."""
    cq, sq = cos[:, None, :], sin[:, None, :]
    q32, k32 = q.float(), k.float()
    q2 = q32 * cq + _rotate_half(q32) * sq
    k2 = k32 * cq + _rotate_half(k32) * sq
    return q2.to(q.dtype), k2.to(k.dtype)


def _pure_rms(x, w, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _wmm(x, w, plain=False):
    """x @ w where w is a dense (K, N) weight or a weight-only
    ``QuantizedWeight`` (K4 on CUDA tensors). ``plain`` takes the quantized
    matmul's plain version on any device (the on-card reference)."""
    from ..ops.kernels.quant_matmul import (QuantizedWeight,
                                            quant_matmul_qw,
                                            quant_matmul_reference)

    if isinstance(w, QuantizedWeight):
        if plain:
            return quant_matmul_reference(x, w.codes, w.scales,
                                          w.weight_dtype, w.group_size)
        return quant_matmul_qw(x, w)
    return x @ w


def _pure_decoder_layer(prms, i, hidden, eps, attend, lora=None, *,
                        enabled=None, plain=False):
    """One decoder block through the fusion pass (ops/kernels/fusion.py);
    ``attend`` maps the flat q/k/v projections to the flat attention
    output. ``lora`` is a wave's adapter routing (``fusion._run_plan``'s
    ``lora_delta`` nodes), None for the base model. ``enabled`` overrides
    the flag-resolved fusion set; ``plain`` runs quantized matmuls (and
    the LoRA delta) through their plain versions."""
    from ..ops.kernels import fusion

    return fusion.run_decoder_layer(prms, i, hidden, eps, attend,
                                    enabled=enabled, plain=plain, lora=lora)


def _pure_lm_head_logits(prms, hidden, eps, tied, enabled=None,
                         plain=False):
    """Final norm + head on (..., hidden) states — raw logits."""
    if tied:
        hidden = _pure_rms(hidden, prms["model.norm.weight"], eps)
        return hidden @ prms["model.embed_tokens.weight"].T
    from ..ops.kernels import fusion

    return fusion.run_lm_head(prms, hidden, eps, enabled=enabled,
                              plain=plain)


def _greedy(logits):
    """Greedy pick (first index among equal maxima) as int32 token ids."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _logits_ok(logits):
    """Per-row poison detector: True where a row's logits are all finite
    (the serving engine's isolation check; no host sync)."""
    return torch.isfinite(logits).all(dim=-1)


def _filter_logits(logits, temperature, top_k=None, top_p=None):
    """The deterministic half of the JAX package's ``_sample_from_logits``
    on (..., V) logits: f32 logits over ``max(temperature, 1e-6)`` (a
    0-dim f32 tensor: a true division, on the card too), then the top-k
    filter (every logit >= the k-th largest stays), then the nucleus cut
    (a stable descending sort, softmax, cumsum; a column stays while the
    mass before it is below ``top_p``, the top-1 column always). Dropped
    entries become -1e30. The two constants are filled on the device: a
    tensor made from a Python number is copied from the host, and that
    copy waits for the device."""
    dev = logits.device
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32,
                   device=dev)
    logits = logits.float() / t
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and top_p < 1.0:
        # ties keep their index order, as jnp.argsort(-x) orders them
        srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        keep = torch.zeros_like(keep).scatter(-1, idx, keep)
        logits = torch.where(keep, logits, neg)
    return logits


def _gumbel_argmax(filtered, generator):
    """The categorical draw over filtered logits as Gumbel-max:
    argmax(filtered + g), g = -log(-log(u)), u uniform from ``generator``
    clamped to [tiny, 1) so that g is finite. No host sync; a row whose
    filter kept one column returns it."""
    u = torch.rand(filtered.shape, generator=generator, dtype=torch.float32,
                   device=filtered.device)
    u = u.clamp_(torch.finfo(torch.float32).tiny, 1.0 - 2.0 ** -24)
    return torch.argmax(filtered - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


def _sample_from_logits(logits, generator, temperature, top_k=None,
                        top_p=None):
    """Temperature / top-k / nucleus sampling on (B, V) logits: the JAX
    package's filter (``_filter_logits``), then one draw from
    ``generator`` (``_gumbel_argmax``). ``top_p <= 0`` keeps only the
    first maximum, the greedy token; ``top_k=1`` every entry equal to the
    maximum (the greedy token unless the maximum is tied)."""
    return _gumbel_argmax(_filter_logits(logits, temperature, top_k, top_p),
                          generator)


def _pick(logits, sampling, generator):
    """The next tokens of (B, V) logits: greedy for ``sampling`` None,
    else one draw from ``generator``."""
    if sampling is None:
        return _greedy(logits)
    return _sample_from_logits(logits, generator, *sampling)


def _normalize_sampling(temperature, top_k, top_p):
    """The (temperature, top_k, top_p) config, or None for greedy."""
    if not temperature or float(temperature) <= 0.0:
        return None
    return (float(temperature), top_k, top_p)


def _pow2_bucket(n: int, cap: int, floor: int = 1) -> int:
    """Smallest ``floor * 2**k`` covering n, capped at ``cap``."""
    from ..jit.bucketing import bucket_for, default_buckets

    return bucket_for(min(n, cap), default_buckets(cap, floor))


def prompt_logits_pure(prms, ids, cfg, tied=False, *, plain=False,
                       attn_mask=None, lora=None):
    """Full-prompt logits (B, S, V): embed -> decoder blocks with causal
    flash attention -> LM head, for a params dict of dense tensors or
    ``QuantizedWeight`` entries. ``attn_mask``: an optional mask for the
    attention (``flash_attention_pure``'s). ``plain=True`` runs every
    kernel's plain version instead (no fusion, plain attention, plain
    dequant-matmuls) — the on-card reference the kernel path is held
    against. ``lora``: an adapter routing over the flattened (B * S) rows
    (``fusion._run_plan``'s), its delta added to every adapted
    projection."""
    from ..ops.kernels.flash_attention import (_reference_attention,
                                               flash_attention_pure)
    from ..ops.kernels.fused_norm_rope import fused_rope

    attention = _reference_attention if plain else flash_attention_pure
    enabled = () if plain else None
    embed = prms["model.embed_tokens.weight"]
    ids = torch.as_tensor(ids, device=embed.device).long()
    b, s = ids.shape
    nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    hidden = embed[ids]
    cos, sin = _rope_tables(s, hd, cfg.rope_theta, device=hidden.device)
    for i in range(cfg.num_hidden_layers):
        def attend(q, k, v):
            q = fused_rope(q.reshape(b, s, nh, hd), cos, sin, plain=plain)
            k = fused_rope(k.reshape(b, s, hk, hd), cos, sin, plain=plain)
            v = v.reshape(b, s, hk, hd)
            if attn_mask is None:
                out = attention(q, k, v, causal=True)
            else:
                out = flash_attention_pure(q, k, v, causal=True,
                                           attn_mask=attn_mask, plain=plain)
            return out.reshape(b, s, nh * hd)

        hidden = _pure_decoder_layer(prms, i, hidden, cfg.rms_norm_eps,
                                     attend, lora, enabled=enabled,
                                     plain=plain)
    return _pure_lm_head_logits(prms, hidden, cfg.rms_norm_eps, tied,
                                enabled=enabled, plain=plain)


def quantize_for_inference(params, algo="weight_only_int8", group_size=-1):
    """A flat params dict (or a model) in the weight-only serving format:
    every 2-D matmul weight becomes a ``QuantizedWeight`` (int8 / packed
    int4 codes with per-channel or group-wise scales), quantized from f32
    on the weight's own device; embeddings (a gather) and 1-D norm weights
    stay as they are. The dict drops into ``generate_paged(params=...)``.

    algo: "weight_only_int8" | "weight_only_int4"; group_size: -1
    (per output channel) | 64 | 128."""
    from ..ops.extra_vision import _weight_quantize_pure
    from ..ops.kernels.quant_matmul import QuantizedWeight

    if hasattr(params, "param_dict"):
        params = params.param_dict()
    wd = "int4" if algo == "weight_only_int4" else "int8"
    out = {}
    for name, p in params.items():
        if p.dim() == 2 and "embed_tokens" not in name:
            codes, scales = _weight_quantize_pure(p.float(), algo=algo,
                                                  group_size=group_size)
            out[name] = QuantizedWeight(codes, scales, wd, group_size,
                                        p.shape)
        else:
            out[name] = p
    return out


# ---------------------------------------------------------------------------
# Modules (parameter containers with the JAX package's names)
# ---------------------------------------------------------------------------
def _train_attend(cfg, q, k, v, plain, stash, residual=None, o_w=None,
                  attn_mask=None, heads=None):
    """The training attend seam: rope (K12 forward and backward: f32
    rotate-half, cast back) feeding causal flash attention with a gradient
    (K1 forward, K5 or K9 backward) under ``attn_mask``, on flat (B, S, ·)
    projections; with ``o_w`` the o-proj matmul and the residual add
    follow as the attention's epilogue (a ``QuantizedWeight`` o_w through
    ``_wmm``: K4 under the weight-only rule, as the JAX package's
    epilogue). ``heads``: this rank's (q, kv) head counts under tensor
    parallelism, else the config's."""
    from ..ops.kernels.flash_attention import flash_attention_train
    from ..ops.kernels.fused_norm_rope import fused_rope

    b, s = q.shape[:2]
    nh, hk = heads or (cfg.num_attention_heads, cfg.num_key_value_heads)
    hd = cfg.head_dim
    cos, sin = _rope_tables(s, hd, cfg.rope_theta, device=q.device)
    q2 = fused_rope(q.reshape(b, s, nh, hd), cos, sin, plain=plain)
    k2 = fused_rope(k.reshape(b, s, hk, hd), cos, sin, plain=plain)
    out = flash_attention_train(q2, k2, v.reshape(b, s, hk, hd),
                                causal=True, plain=plain, stash=stash,
                                attn_mask=attn_mask)
    out = out.reshape(b, s, nh * hd)
    if o_w is None:
        return out
    return residual + _wmm(out, o_w, plain=plain)


def _train_fused_block(layer, hidden, attn_mask=None, plain=False,
                       stash=None, attn_only=False):
    """Training forward of one decoder block through the TRAIN plan
    (``fusion.run_train_decoder_layer``) over the block's own parameters,
    its attention under ``attn_mask``.
    With no train family on (``fused_train`` off) it runs the unfused plan,
    every norm in K6/K7; ``plain`` runs the unfused plan with every
    kernel's plain version — the on-card reference. ``attn_only`` runs the
    attention half and returns the post-attention residual stream (the MoE
    decoder block's share; its routed MLP keeps its own dispatch)."""
    from ..ops.kernels import fusion

    cfg = layer.self_attn.config

    def attend(q, k, v, residual=None, o_w=None):
        return _train_attend(cfg, q, k, v, plain, stash, residual, o_w,
                             attn_mask)

    unfused = plain or not fusion.enabled_train_fusions()
    return fusion.run_train_decoder_layer(
        dict(layer.named_parameters()), hidden, cfg.rms_norm_eps, attend,
        enabled=() if unfused else None, plain=plain, attn_only=attn_only)


def _train_head_fusion_active(model) -> bool:
    """Fold the final norm into the untied LM head on the TRAIN forward?
    Needs the norm_matmul family and an untied head that runs in forward
    (``fused_head_loss`` defers the head to the chunked loss)."""
    from ..ops.kernels import fusion

    return (model.training and fusion.train_fusion_on("norm_matmul")
            and model.lm_head is not None
            and not model.config.fused_head_loss)


def _train_fused_head(model, hidden):
    """Final norm + LM head through the TRAIN head plan (K2)."""
    from ..ops.kernels import fusion

    prms = {"model.norm.weight": model.model.norm.weight,
            "lm_head.weight": model.lm_head.weight}
    return fusion.run_train_lm_head(prms, hidden, model.config.rms_norm_eps)


def _proj(n_in, n_out, dtype, device, gen):
    """A projection: bias-free, as the JAX package's."""
    return Linear(n_in, n_out, bias_attr=False, dtype=dtype, device=device,
                  generator=gen)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, *, dtype, device, gen):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        nh, hk = config.num_attention_heads, config.num_key_value_heads
        self.q_proj = _proj(h, nh * hd, dtype, device, gen)
        self.k_proj = _proj(h, hk * hd, dtype, device, gen)
        self.v_proj = _proj(h, hk * hd, dtype, device, gen)
        self.o_proj = _proj(nh * hd, h, dtype, device, gen)


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, *, dtype, device, gen):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _proj(h, m, dtype, device, gen)
        self.up_proj = _proj(h, m, dtype, device, gen)
        self.down_proj = _proj(m, h, dtype, device, gen)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, *, dtype, device, gen):
        super().__init__()
        eps = config.rms_norm_eps
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, dtype=dtype,
                                       device=device)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                dtype=dtype, device=device)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, hidden, attn_mask=None, *, plain=False, stash=None):
        """Training forward through the TRAIN plan (the tensor-parallel
        block under ``apply_llama_tensor_parallel``)."""
        if _tp_ctx(self.self_attn) is not None:
            return _tp_block(self, hidden, attn_mask, plain, stash)
        return _train_fused_block(self, hidden, attn_mask, plain, stash)


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, *, dtype, device, gen):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      dtype=dtype, device=device,
                                      generator=gen)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, dtype=dtype, device=device, gen=gen)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            dtype=dtype, device=device)

    def forward(self, input_ids, attn_mask=None, final_norm=True, *,
                plain=False):
        """Training forward to the final hidden states (normed unless
        ``final_norm=False``, the head fusion's entry), every block's
        attention under ``attn_mask``. Under ``config.recompute`` each
        block's activations are recomputed in backward (the mask rides the
        recompute as an input); ``core_attn`` with
        ``flags.flash_save_residuals`` keeps the attention's (out, lse) so
        the recompute skips K1."""
        from ..distributed.recompute import recompute
        from ..framework import flags

        cfg = self.config
        ctx = _tp_ctx(self)
        if ctx is None:
            hidden = self.embed_tokens(input_ids)
        else:
            from ..distributed import overlap
            from ..distributed.mp_layers import vocab_parallel_lookup

            hidden = vocab_parallel_lookup(input_ids,
                                           self.embed_tokens.weight,
                                           ctx["group"])
            if ctx["sp"]:
                # the residual stream lives sequence-cut between blocks
                hidden = overlap.shard_seq(hidden, ctx["mesh"], ctx["axis"],
                                           dim=1)
        keep = (cfg.recompute_granularity == "core_attn"
                and bool(flags.get_flag("flash_save_residuals")))
        for layer in self.layers:
            if cfg.recompute and self.training:
                hidden = recompute(layer, hidden, attn_mask, plain=plain,
                                   stash=[] if keep else None)
            else:
                hidden = layer(hidden, attn_mask, plain=plain)
        return self.norm(hidden, plain=plain) if final_norm else hidden


class LlamaForCausalLM(Layer):
    """Llama with an LM head. Runs on ``cuda`` unless ``device="cpu"``;
    weights are drawn from ``seed`` (N(0, 0.02²) matmul and embedding
    weights, unit norm weights) in ``config.dtype``. Built in eval mode
    (serving); ``train()`` turns on gradients and the training forward."""

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        gen = make_generator(seed, self.device)
        self.model = LlamaModel(config, dtype=dtype, device=self.device,
                                gen=gen)
        self.lm_head = (None if config.tie_word_embeddings else
                        _proj(config.hidden_size, config.vocab_size, dtype,
                              self.device, gen))
        self.eval()

    def forward(self, input_ids, attn_mask=None, *, plain=False):
        """Eval: prompt logits (B, S, V), under inference mode. Training:
        logits with a gradient, or the final hidden states (B, S, H) under
        ``fused_head_loss`` (``loss`` then projects them chunk by chunk).
        ``attn_mask``: a mask for every block's attention (a key-padding
        mask (B, S) or (B, 1, 1, S), bool or additive, rides the flash
        kernels as a key bias). ``plain``: every kernel's plain version and
        the unfused plans."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=self.device)
        ctx = _tp_ctx(self)
        if not self.training:
            _refuse_tp_serving(ctx)
            with torch.inference_mode():
                return prompt_logits_pure(self.param_dict(), ids,
                                          self.config,
                                          tied=self.lm_head is None,
                                          plain=plain, attn_mask=attn_mask)
        fuse_head = (not plain and ctx is None
                     and _train_head_fusion_active(self))
        hidden = self.model(ids.long(), attn_mask, final_norm=not fuse_head,
                            plain=plain)
        if ctx is not None:
            hidden = _tp_head_input(ctx, hidden)
        if self.config.fused_head_loss:
            return hidden
        if fuse_head:
            return _train_fused_head(self, hidden)
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.T
        return hidden @ self.lm_head.weight

    def loss(self, out, labels, *, count_group=None):
        """Next-token loss of the forward output: (B, S, V) logits, or the
        (B, S, H) final hidden states under ``fused_head_loss`` in training
        (projected inside the chunked ``linear_cross_entropy``).
        ``count_group``: the data-parallel group whose valid targets the
        mean counts (``ops/loss_ops.py``; ``jit.TrainStep`` passes it).
        Under tensor parallelism ``out`` holds this rank's vocab slice of
        the logits (or the head is its vocab slice) and the loss runs
        vocab-parallel over the model-parallel group."""
        from ..ops.loss_ops import cross_entropy, linear_cross_entropy

        ctx = _tp_ctx(self)
        vocab = ctx["group"] if ctx is not None else None
        labels = torch.as_tensor(labels, device=out.device).long()
        b, s, v = out.shape
        if self.config.fused_head_loss and self.training:
            tied = self.lm_head is None
            w = (self.model.embed_tokens.weight if tied
                 else self.lm_head.weight)
            return linear_cross_entropy(
                out[:, :-1, :], w, labels[:, 1:], transpose_weight=tied,
                chunk_size=self.config.loss_chunk_size,
                count_group=count_group, vocab_group=vocab)
        return cross_entropy(out[:, :-1, :].reshape(b * (s - 1), v),
                             labels[:, 1:].reshape(b * (s - 1)),
                             count_group=count_group, vocab_group=vocab)

    @staticmethod
    def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
        """Standard 6N + attention accounting (the JAX package's)."""
        h, L = config.hidden_size, config.num_hidden_layers
        kv = config.num_key_value_heads * config.head_dim
        n_params = (config.vocab_size * h
                    * (1 if config.tie_word_embeddings else 2)
                    + L * (h * h + 2 * h * kv + h * h
                           + 3 * h * config.intermediate_size))
        attn = 12 * L * h * seq_len / 2  # causal: half the S^2 term
        return 6.0 * n_params + attn

    def generate_paged(self, input_ids, max_new_tokens: int = 16,
                       page_size: int = 16, temperature: float = 0.0,
                       top_k=None, top_p=None, seed: int = 0, params=None,
                       cache_dtype=None, spec_decode: bool = False,
                       spec_k=None, draft=None, *,
                       return_logits: bool = False):
        """Decode over a paged KV cache. ``input_ids`` (B, S0)
        → (B, S0 + max_new_tokens) int32 on the model's device; with
        ``return_logits`` also the (B, max_new_tokens, V) f32 logits each
        new token was picked from.

        ``temperature`` 0 (the default) decodes greedily; above 0 each
        token is drawn from its logits after the JAX package's temperature,
        ``top_k`` and ``top_p`` filter (``_sample_from_logits``), from one
        generator on the model's device seeded by ``seed`` and drawn once
        a step (the prefill's first token included): the same seed gives
        the same tokens, ``top_p <= 0`` the greedy ones (``top_k=1`` too
        where no maximum is tied).

        ``params`` overrides the model's own parameters (e.g. the
        ``quantize_for_inference`` dict); ``cache_dtype="int8"`` (or
        ``torch.int8``) stores the cache as int8 codes with per-cell
        scales.

        The prompt pads to a power-of-two bucket W (capped at the page-
        padded capacity), one prefill fills the cache and picks the first
        token, then each decode step appends one token per sequence.

        ``spec_decode``: after the prefill, speculative verify steps
        (``_spec_decode_loop``, the batcher's parity oracle) replace the
        decode steps: ``spec_k`` drafts a row (default the ``spec_k``
        flag) from ``draft`` (a ``DraftProposer``, default ``NGramDraft``);
        the tokens equal the plain decode's. Greedy only (sampling raises
        ``ValueError``), and not with ``return_logits``."""
        _refuse_tp_serving(_tp_ctx(self))
        sampling = _normalize_sampling(temperature, top_k, top_p)
        if spec_decode and sampling is not None:
            raise ValueError(
                "spec_decode requires greedy decoding (temperature=0): "
                "the acceptance rule compares drafts against the target "
                "argmax — sampled verification is a future extension "
                "(docs/SERVING.md 'Speculative decoding')")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if spec_decode and return_logits:
            raise ValueError("spec_decode does not return logits")
        if cache_dtype is not None and cache_dtype not in ("int8",
                                                           torch.int8):
            raise ValueError(f"cache_dtype must be None or 'int8', "
                             f"got {cache_dtype!r}")
        cfg = self.config
        prms = self.param_dict() if params is None else params
        ids = torch.as_tensor(input_ids, device=self.device).long()
        b, s0 = ids.shape
        cap = s0 + max_new_tokens
        cap_pad = -(-cap // page_size) * page_size
        w = _pow2_bucket(s0, cap_pad)
        cos_full, sin_full = _rope_tables(cap_pad, cfg.head_dim,
                                          cfg.rope_theta, device=self.device)
        gen = (None if sampling is None
               else make_generator(seed, self.device))
        with torch.inference_mode():
            prefill = self._build_paged_prefill(
                b, w, cap_pad, page_size,
                cache_dtype=None if cache_dtype is None else torch.int8)
            step = self._build_paged_step(b)
            ids_pad = torch.nn.functional.pad(ids, (0, w - s0))
            lengths = torch.full((b,), s0, dtype=torch.int32,
                                 device=self.device)
            logits, cache = prefill(prms, ids_pad, lengths, cos_full,
                                    sin_full)
            if spec_decode:
                toks = self._spec_decode_loop(
                    prms, ids, _greedy(logits), cache, cos_full, sin_full,
                    max_new_tokens, spec_k=spec_k, draft=draft)
                return torch.cat([ids.to(torch.int32), toks], 1)
            kept = [logits.float()] if return_logits else None
            toks = [_pick(logits, sampling, gen)]
            for _ in range(max_new_tokens - 1):
                logits, cache = step(prms, toks[-1], cache, cos_full,
                                     sin_full)
                if return_logits:
                    kept.append(logits.float())
                toks.append(_pick(logits, sampling, gen))
            out = torch.cat([ids.to(torch.int32), torch.stack(toks, 1)], 1)
            return (out, torch.stack(kept, 1)) if return_logits else out

    def _build_paged_prefill(self, b, w, cap, page_size, cache_dtype=None):
        """Prompt prefill at bucket width ``w``: ids (B, w) zero-padded,
        lengths (B,) the true prompt lengths → (last-position logits (B, V),
        paged cache filled through each length). Padded positions write K/V past
        each length that the causal mask and ``seq_lens`` keep unread.
        ``cache_dtype`` None keeps the activations' dtype; ``torch.int8``
        makes the quantized cache."""
        from ..ops.kernels.flash_attention import flash_attention_pure
        from ..ops.kernels.fused_norm_rope import fused_rope
        from .kv_cache import create_paged_cache, prefill_paged_cache

        cfg = self.config
        tied = self.lm_head is None
        n_layers = cfg.num_hidden_layers
        hd, hk = cfg.head_dim, cfg.num_key_value_heads
        nh = cfg.num_attention_heads

        def prefill(prms, ids, lengths, cos_full, sin_full):
            hidden = prms["model.embed_tokens.weight"][ids]  # (B, w, h)
            cos, sin = cos_full[:w], sin_full[:w]
            cache = create_paged_cache(n_layers, b, cap, hk, hd,
                                       page_size=page_size,
                                       dtype=cache_dtype or hidden.dtype,
                                       device=hidden.device)
            for i in range(n_layers):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    q = fused_rope(q.reshape(b, w, nh, hd), cos, sin)
                    k = fused_rope(k.reshape(b, w, hk, hd), cos, sin)
                    v = v.reshape(b, w, hk, hd)
                    out = flash_attention_pure(q, k, v, causal=True)
                    cache = prefill_paged_cache(cache, i, k, v, lengths)
                    return out.reshape(b, w, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden,
                                             cfg.rms_norm_eps, attend)
            idx = torch.clamp(lengths.long() - 1, min=0)
            h_last = hidden[torch.arange(b, device=hidden.device), idx]
            return (_pure_lm_head_logits(prms, h_last, cfg.rms_norm_eps,
                                         tied), cache)

        return prefill

    def _spec_decode_loop(self, prms, ids, first, cache, cos_full, sin_full,
                          max_new_tokens, spec_k=None, draft=None):
        """The solo speculative loop (the batcher's parity oracle): each
        step drafts up to K tokens a row from its own prompt and generated
        history, verifies every row's (1 + k_eff)-row segment in ONE ragged
        wave (``_build_spec_verify_step``), keeps the longest matching
        prefix plus the bonus token (``speculative.greedy_accept``), rewinds
        seq_lens to it (``kv_cache.advance_by``) and reads the result back:
        one host sync a step. Returns the (B, max_new_tokens) int32 tokens,
        the prefill's ``first`` included."""
        import numpy as np

        from ..framework import flags
        from ..inference.speculative import NGramDraft

        b = ids.shape[0]
        K = int(flags.get_flag("spec_k") if spec_k is None else spec_k)
        if K < 1:
            raise ValueError(f"spec_k must be >= 1, got {K}")
        if draft is None:
            draft = NGramDraft()
        K1 = K + 1
        step = self._build_spec_verify_step(b, K)
        dev = ids.device
        first_np = first.cpu().numpy()
        ids_np = ids.cpu().numpy()
        histories = [list(map(int, ids_np[i])) + [int(first_np[i])]
                     for i in range(b)]
        emitted = [[int(first_np[i])] for i in range(b)]
        remaining = np.full((b,), max_new_tokens - 1, np.int32)
        t_wave = -(-(b * K1) // 8) * 8
        while int(remaining.max()) > 0:
            drafts = np.full((b, K), -1, np.int32)
            k_eff = np.zeros((b,), np.int32)
            wave = np.zeros((t_wave,), np.int32)
            for i in range(b):
                if remaining[i] <= 0:
                    continue
                # drafting past remaining - 1 is useless (n_acc drafts + 1
                # bonus <= remaining), and the cap keeps every provisional
                # write inside the page capacity
                cap_k = min(K, int(remaining[i]) - 1)
                dr = np.asarray(draft.propose(
                    np.asarray(histories[i], np.int32), cap_k),
                    np.int32).reshape(-1)[:max(cap_k, 0)]
                k_eff[i] = len(dr)
                drafts[i, :len(dr)] = dr
                wave[i * K1] = histories[i][-1]
                wave[i * K1 + 1:i * K1 + 1 + len(dr)] = dr
            cand, emit, n_emit, cache = step(
                prms, *(torch.as_tensor(x, device=dev) for x in (
                    wave, drafts, k_eff, remaining)), cache, cos_full,
                sin_full)
            # the step's one readback
            flat = torch.cat([cand.reshape(-1), emit.reshape(-1).to(
                torch.int32), n_emit]).cpu().numpy()
            cand_np = flat[:b * K1].reshape(b, K1)
            emit_np = flat[b * K1:2 * b * K1].reshape(b, K1)
            ne_np = flat[2 * b * K1:]
            for i in range(b):
                for j in range(K1):
                    if emit_np[i, j]:
                        histories[i].append(int(cand_np[i, j]))
                        emitted[i].append(int(cand_np[i, j]))
                remaining[i] -= int(ne_np[i])
        return torch.as_tensor(np.asarray(emitted, np.int32), device=dev)

    def _build_spec_verify_step(self, b, K):
        """The speculative verify step over (1 + K)-row segments. Wave row
        i * (K + 1) + j holds sequence i's row j: its current token at j =
        0, draft j at j >= 1; rows at or past q_len[i] = 1 + k_eff[i] (0
        once its budget is spent) are wave padding and write nothing; the
        wave is T = ceil(B (K + 1) / 8) * 8 rows. Every segment reads its
        old context from the pages and its own rows through the fresh
        source, marked ``fresh_pool_read`` so that the verify math reads
        them as the plain decode step reads them back from the pool.
        Returns step(prms, wave_ids, drafts, k_eff, remaining, cache,
        cos_full, sin_full) -> (cand (B, K+1), emit (B, K+1) bool, n_emit
        (B,), cache)."""
        from ..inference.speculative import greedy_accept, segment_row_index
        from ..ops.kernels import fusion
        from .kv_cache import advance_by

        cfg = self.config
        tied = self.lm_head is None
        n_layers = cfg.num_hidden_layers
        hd, hk = cfg.head_dim, cfg.num_key_value_heads
        nh = cfg.num_attention_heads
        K1 = K + 1
        T = -(-(b * K1) // 8) * 8

        def step(prms, wave_ids, drafts, k_eff, remaining, cache, cos_full,
                 sin_full):
            dev, i32 = wave_ids.device, torch.int32
            q_len = torch.where(remaining > 0, 1 + k_eff, 0).to(i32)
            q_start = torch.arange(b, dtype=i32, device=dev) * K1
            pad = T - b * K1
            row_slot = torch.cat([
                torch.arange(b, dtype=i32, device=dev).repeat_interleave(K1),
                torch.full((pad,), -1, dtype=i32, device=dev)])
            row_off = torch.cat([
                torch.arange(K1, dtype=i32, device=dev).repeat(b),
                torch.zeros((pad,), dtype=i32, device=dev)])
            slot_c = torch.clamp(row_slot, 0, b - 1).long()
            valid = (row_slot >= 0) & (row_off < q_len[slot_c])
            pos = (cache.seq_lens[slot_c] + row_off).to(i32)
            pos_c = torch.clamp(pos.long(), max=cos_full.shape[0] - 1)
            cos, sin = cos_full[pos_c], sin_full[pos_c]
            hidden = prms["model.embed_tokens.weight"][wave_ids.long()]
            gate = q_len > 0
            page_lens = torch.where(gate, cache.seq_lens, 0).to(i32)
            for i in range(n_layers):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    out, cache = fusion.ragged_attend(
                        q.reshape(T, nh, hd), k.reshape(T, hk, hd),
                        v.reshape(T, hk, hd), cos, sin, cache, i, row_slot,
                        pos, valid, page_lens, q_start, q_len, q_len,
                        fresh_pool_read=gate)
                    return out.reshape(T, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden,
                                             cfg.rms_norm_eps, attend)
            idx = segment_row_index(q_start, q_len, K1, T)        # (B, K1)
            logits = _pure_lm_head_logits(prms, hidden[idx.reshape(-1)],
                                          cfg.rms_norm_eps, tied)
            cand = _greedy(logits).reshape(b, K1)
            # no finite-logits barrier: the plain solo decode emits the
            # argmax of whatever its logits are, so the oracle does too
            emit, n_emit = greedy_accept(cand, drafts, k_eff, remaining,
                                         gate=gate)
            # rejected cells stay as stale bytes past seq_lens
            return cand, emit, n_emit, advance_by(cache, n_emit)

        return step

    def _build_paged_step(self, b):
        """The per-token decode step: token (B,) → (next-token logits
        (B, V), cache). The per-layer rope→append→attention tail routes through
        the fusion seam (``fusion.decode_attend``)."""
        from ..ops.kernels import fusion
        from .kv_cache import advance

        cfg = self.config
        tied = self.lm_head is None
        n_layers = cfg.num_hidden_layers
        hd, hk = cfg.head_dim, cfg.num_key_value_heads
        nh = cfg.num_attention_heads

        def step(prms, token, cache, cos_full, sin_full):
            pos = cache.seq_lens.long()
            hidden = prms["model.embed_tokens.weight"][token.long()]
            cos, sin = cos_full[pos], sin_full[pos]               # (B, D)
            for i in range(n_layers):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    out, cache = fusion.decode_attend(
                        q.reshape(b, nh, hd), k.reshape(b, hk, hd),
                        v.reshape(b, hk, hd), cos, sin, cache, i)
                    return out.reshape(b, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden,
                                             cfg.rms_norm_eps, attend)
            cache = advance(cache)
            return (_pure_lm_head_logits(prms, hidden, cfg.rms_norm_eps,
                                         tied), cache)

        return step



# ---------------------------------------------------------------------------
# Tensor and sequence parallelism (one process a rank)
# ---------------------------------------------------------------------------
#: the row-cut projections (their input's last dim is cut over mp)
_ROW_CUT = ("self_attn.o_proj.weight", "mlp.down_proj.weight")


def _tp_ctx(layer):
    """The tensor-parallel context planted by
    ``apply_llama_tensor_parallel`` ({"mesh", "axis", "sp", "seq_axis",
    "n", "group"}), or None."""
    return getattr(layer, "_tp_overlap", None)


def _refuse_tp_serving(ctx):
    if ctx is not None:
        raise NotImplementedError(
            "serving a tensor-parallel model (eval forward, generate_paged) "
            "is not ported; the TP path is the training forward")


class _TPBlock:
    """One decoder block's collectives (``fusion._run_plan``'s ``tp``):
    each norm's output enters the column-cut projections (SP: the
    sequence blocks gathered, reduce-scatter backward; TP: identity,
    all-reduce backward); the row-cut o/down products leave the block
    through ``overlap.matmul_rs`` (SP) or ``overlap.matmul_ar`` (TP); the
    column-cut ones are local matmuls."""

    def __init__(self, ctx, plain):
        self.ctx, self.plain = ctx, plain

    def enter(self, x):
        from ..distributed import overlap
        from ..distributed.mp_layers import copy_to_model_parallel

        c = self.ctx
        if c["sp"]:
            return overlap.ring_all_gather(x, c["mesh"], c["axis"], dim=1)
        return copy_to_model_parallel(x, c["group"])

    def matmul(self, name, x, w):
        from ..distributed import overlap

        c = self.ctx
        if name not in _ROW_CUT:
            return _wmm(x, w, plain=self.plain)
        if c["sp"]:
            return overlap.matmul_rs(x, w, c["mesh"], c["axis"])
        return overlap.matmul_ar(x, w, c["mesh"], c["axis"])


def _tp_block(layer, hidden, attn_mask=None, plain=False, stash=None):
    """Training forward of one tensor-parallel decoder block: the unfused
    TRAIN plan (``enabled=()``: the JAX package turns the train fusions off
    under a TP context) on this rank's heads and shards, with the block's
    collectives (``_TPBlock``)."""
    from ..ops.kernels import fusion

    cfg = layer.self_attn.config
    ctx = _tp_ctx(layer.self_attn)
    heads = (cfg.num_attention_heads // ctx["n"],
             cfg.num_key_value_heads // ctx["n"])

    def attend(q, k, v, residual=None, o_w=None):
        return _train_attend(cfg, q, k, v, plain, stash, residual, o_w,
                             attn_mask, heads=heads)

    return fusion.run_train_decoder_layer(
        dict(layer.named_parameters()), hidden, cfg.rms_norm_eps, attend,
        enabled=(), plain=plain, tp=_TPBlock(ctx, plain))


def _tp_head_input(ctx, hidden):
    """The final hidden states into the vocab-cut head: SP gathers the
    sequence blocks (reduce-scatter backward), TP is the column-cut
    input's identity with an all-reduce backward."""
    from ..distributed import overlap
    from ..distributed.mp_layers import copy_to_model_parallel

    if ctx["sp"]:
        return overlap.ring_all_gather(hidden, ctx["mesh"], ctx["axis"],
                                       dim=1)
    return copy_to_model_parallel(hidden, ctx["group"])


def llama_sharding_plan(model: LlamaForCausalLM, mesh, mp_axis="mp",
                        dp_axis="dp", fsdp_axis=None):
    """{parameter name: PartitionSpec}: the reference's Megatron cut points
    over ``mesh`` (q/k/v/gate/up on the out dim, o/down on the in dim, the
    embedding on the vocab rows, the LM head (H, V) on the vocab columns,
    norms replicated)."""
    from ..distributed.placement import PartitionSpec as P

    mp = mp_axis if mp_axis in mesh.dim_names else None
    fsdp = fsdp_axis if (fsdp_axis and fsdp_axis in mesh.dim_names) else None
    plan = {}
    for name, p in model.named_parameters():
        spec = P()
        if any(k in name for k in ("q_proj", "k_proj", "v_proj",
                                   "gate_proj", "up_proj")):
            spec = P(fsdp, mp)
        elif "o_proj" in name or "down_proj" in name:
            spec = P(mp, fsdp)
        elif "embed_tokens" in name:
            spec = P(mp, fsdp)
        elif "lm_head" in name:
            spec = P(fsdp, mp)
        plan[name] = spec
    return plan


def _check_tp_widths(cfg, n):
    if cfg.num_key_value_heads < n:
        raise NotImplementedError(
            f"tensor parallelism: an mp degree of {n} above the "
            f"{cfg.num_key_value_heads} key/value heads (the reference "
            f"reshards the kv heads there) is not ported")
    for what, size in (("num_attention_heads", cfg.num_attention_heads),
                       ("num_key_value_heads", cfg.num_key_value_heads),
                       ("intermediate_size", cfg.intermediate_size),
                       ("vocab_size", cfg.vocab_size)):
        if size % n:
            raise ValueError(f"tensor parallelism: {what} ({size}) does "
                             f"not divide over {n} model-parallel ranks")


def apply_llama_tensor_parallel(model: LlamaForCausalLM, mesh, mp_axis="mp",
                                fsdp_axis=None, sequence_parallel=False):
    """Cut ``model``'s parameters to this rank's shards under
    ``llama_sharding_plan`` (the rank's coordinate on ``mesh``'s
    ``mp_axis``), mark them ``mp_cut`` and plant the TP context on
    the model and its blocks: the training forward then runs the
    tensor-parallel blocks and the vocab-parallel head (module docstring).
    ``sequence_parallel`` keeps the residual stream sequence-cut between
    blocks and registers the norm weights' all-reduce hooks. The mp degree
    must divide the heads, the kv heads, ``intermediate_size`` and the
    vocab; ``fsdp_axis`` is not ported. Returns the plan."""
    from ..distributed import overlap
    from ..distributed.sequence_parallel import (
        mark_as_sequence_parallel_parameter,
        register_sequence_parallel_allreduce_hooks)

    if fsdp_axis is not None and fsdp_axis in mesh.dim_names:
        raise NotImplementedError("apply_llama_tensor_parallel: fsdp_axis "
                                  "is not ported")
    plan = llama_sharding_plan(model, mesh, mp_axis=mp_axis,
                               fsdp_axis=fsdp_axis)
    if mp_axis not in mesh.dim_names:
        return plan
    n = mesh.get_dim_size(mp_axis)
    _check_tp_widths(model.config, n)
    group = overlap._group(mesh, mp_axis) if n > 1 else None
    rank = group.rank if group is not None else 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = tuple(plan[name])
            if n > 1 and mp_axis in spec:
                dim = spec.index(mp_axis)
                size = p.shape[dim] // n
                p.data = p.data.narrow(dim, rank * size, size).contiguous()
                p.mp_cut = True
    ctx = {"mesh": mesh, "axis": mp_axis, "sp": bool(sequence_parallel),
           "seq_axis": None, "n": n, "group": group}
    model._tp_overlap = ctx
    model.model._tp_overlap = ctx
    for layer in model.model.layers:
        layer.self_attn._tp_overlap = ctx
        layer.mlp._tp_overlap = ctx
    if sequence_parallel:
        for name, p in model.named_parameters():
            if "layernorm" in name or name == "model.norm.weight":
                mark_as_sequence_parallel_parameter(p)
        register_sequence_parallel_allreduce_hooks(model)
    return plan
