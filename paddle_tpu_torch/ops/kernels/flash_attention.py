"""Flash attention (``paddle_tpu/ops/pallas/flash_attention.py``).

Kernel K1 (``csrc/flash_attention.cu``) replaces the TPU forward
``_pallas_fwd``: causal (with offset Sk - Sq), GQA, no mask, D = 128, bf16,
writing the output and the per-row log-sum-exp. Kernel K5
(``csrc/flash_attention_bwd.cu``) replaces the split backward
``_pallas_bwd`` (``_dq_kernel`` and ``_dkv_kernel``): dQ, and dK/dV summed
over each KV head's query group. Layout is the JAX package's (batch, seq,
heads, head_dim).

On CPU tensors ``flash_attention_fwd`` and ``flash_attention_bwd`` run their
plain versions; on CUDA tensors they launch K1 / K5 or raise.
``flash_attention_train`` is the ``autograd.Function`` the training path
calls (the ``_flash_core`` custom VJP of the JAX package): K1 forward
saving (out, lse), K5 backward.
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
    _build.check_no_grad("flash_attention_fwd", q, k, v)
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


# ---------------------------------------------------------------------------
# Backward (K5) and the training entry
# ---------------------------------------------------------------------------

#: K5 calls since the last reset (each launches the dq and the dkv kernel)
bwd_launches = 0


def _delta(out, do):
    """Delta = rowsum(dO * O) in f32, (B, H, Sq) — computed outside the
    kernels, as ``_pallas_bwd`` does."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=False,
                                  scale=None):
    """K5's plain version: (dq, dk, dv) with the TPU kernels' casts — p in
    f32, cast to dO's dtype before dV += p^T dO; ds = p * (dP - delta) cast
    to Q's/K's dtype before the dK and dQ products; dK/dV summed over the
    query group in f32; one cast of each gradient at the end."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = p * (dp - _delta(out, do)[..., None])
    ds_lo = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, kr.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, q.float()) * scale
    dk = dk.reshape(b, sk, hk, g, d).sum(dim=3)
    dv = dv.reshape(b, sk, hk, g, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_tolerance(q, k, v, do, ref_dq, ref_dk, ref_dv, causal=False,
                  scale=None):
    """Per-element bounds on |K5 - plain| for (dq, dk, dv), from the
    inputs. The two versions round the same bf16 values (p before the dV
    product, ds before the dK/dQ products) but compute p, dP and the f32
    sums in different orders, so a rounded value may land one bf16 ulp
    (2^-8 relative) apart: each gradient may differ by 2^-7 (with room 2)
    times the sum of the magnitudes it adds up, |p| @ |dO| for dV and
    |ds| @ |K| (|Q|) * scale for dQ (dK), plus one bf16 ulp of the output
    (1e-2 * |ref|)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = s.softmax(dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ads = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
    tq = torch.einsum("bhqk,bkhd->bqhd", ads, kr.abs()) * scale
    tk = torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()) * scale
    tv = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    tk = tk.reshape(b, sk, hk, g, d).sum(dim=3)
    tv = tv.reshape(b, sk, hk, g, d).sum(dim=3)
    return tuple(2.0 ** -7 * t + 1e-2 * r.float().abs() + 1e-4
                 for t, r in ((tq, ref_dq), (tk, ref_dk), (tv, ref_dv)))


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """(dq, dk, dv) — K5 on CUDA tensors, the plain version on CPU
    tensors."""
    global bwd_launches
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             scale)
    from ...framework import flags

    if flags.get_flag("flash_bwd_impl") != "split":
        raise NotImplementedError(
            f"flash_bwd_impl={flags.get_flag('flash_bwd_impl')!r}: only the "
            f"split backward (K5) is ported")
    if d != 128:
        raise ValueError(f"flash_attention_bwd kernel needs head_dim 128, "
                         f"got {d}")
    _build.check_no_grad("flash_attention_bwd", q, k, v, out, do)
    _build.check_cuda("q", q, torch.bfloat16)
    _build.check_cuda("k", k, torch.bfloat16, (b, sk, hk, d))
    _build.check_cuda("v", v, torch.bfloat16, (b, sk, hk, d))
    _build.check_cuda("out", out, torch.bfloat16, (b, sq, h, d))
    _build.check_cuda("do", do, torch.bfloat16, (b, sq, h, d))
    _build.check_cuda("lse", lse, torch.float32, (b, h, sq))
    delta = _delta(out, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _build.launch("pt_flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, sq, sk, h, hk, int(bool(causal)),
                  float(scale), _build.stream_of(q))
    bwd_launches += 1
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, plain, stash):
        if stash:                 # the saved residuals of the first forward
            out, lse = stash
        elif plain:
            out, lse = flash_attention_fwd_reference(q, k, v, causal, scale)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal, scale)
        if stash is not None and not stash:
            stash.extend((out, lse))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_reference if ctx.plain
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), ctx.causal,
                         ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, causal=True, scale=None, plain=False,
                          stash=None):
    """Attention output with a gradient: K1 forward saving (out, lse), K5
    backward (plain versions on CPU tensors, or with ``plain=True``, the
    on-card reference). ``stash``: a list that keeps (out, lse) of the first
    call, so a recompute of the same block reuses them instead of running
    K1 again (``recompute_granularity="core_attn"`` with
    ``flash_save_residuals``)."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    return _FlashCore.apply(q, k, v, causal, scale, plain, stash)
