"""Flash attention forward (``paddle_tpu/ops/pallas/flash_attention.py``).

Kernel K1 (``csrc/flash_attention.cu``) replaces the TPU forward
``_pallas_fwd``: causal (with offset Sk - Sq), GQA, no mask, D = 128, bf16,
writing the output and the per-row log-sum-exp (kept for the training
slice). Layout is the JAX package's (batch, seq, heads, head_dim).

On CPU tensors ``flash_attention_fwd`` runs its plain version; on CUDA
tensors it launches K1 or raises. The backward kernels are a later slice.
"""

from __future__ import annotations

import math

import torch

from . import _build

_NEG_INF = -1e30

#: K1 launches since the last reset (incremented only where it launches)
launches = 0


def _reference_attention(q, k, v, causal=False, scale=None):
    """(B, S, H, D) plain attention — the JAX package's reference lowering:
    f32 logits, softmax, probabilities cast to q's dtype before P.V."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if hk != h:  # GQA: repeat KV heads for the plain path
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """K1's plain version: (out (B,Sq,H,D), lse (B,H,Sq) f32)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(h // hk, dim=2) if hk != h else k
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    return _reference_attention(q, k, v, causal, scale), lse


def fwd_tolerance(q, k, v, ref, causal=False, scale=None):
    """Per-element bound on |K1 out - plain out|, from the inputs. Both
    round each probability to bf16 before P.V (K1 before normalizing, as
    the TPU does; the plain version after), 2^-9 relative each, so before
    the output rounding they differ by at most 2^-8 * (P @ |V|); with a
    factor 2 of room that is 2^-7 * (P @ |V|). Each output is then rounded
    to bf16 once in both: one ulp, at most 2^-7 * |out| -> 1e-2 * |ref|.
    The bound is tight where a row's weight sits on few keys (the first
    causal rows) and small where it spreads (the late rows)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(h // hk, dim=2).float()
    vr = v.repeat_interleave(h // hk, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    spread = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(dim=-1),
                          vr.abs())
    return 2.0 ** -7 * spread + 1e-2 * ref.float().abs() + 1e-4


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(out, lse) — K1 on CUDA tensors, the plain version on CPU tensors."""
    global launches
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if d != 128:
        raise ValueError(f"flash_attention_fwd kernel needs head_dim 128, "
                         f"got {d}")
    _build.check_cuda("q", q, torch.bfloat16)
    _build.check_cuda("k", k, torch.bfloat16, (b, sk, hk, d))
    _build.check_cuda("v", v, torch.bfloat16, (b, sk, hk, d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _build.launch("pt_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk, h,
                  hk, int(bool(causal)), float(scale), _build.stream_of(q))
    launches += 1
    return out, lse


def flash_attention_pure(q, k, v, causal=False, scale=None):
    """Attention output only — the serving path's entry."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
