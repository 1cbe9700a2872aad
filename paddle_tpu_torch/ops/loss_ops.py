"""Losses (``paddle_tpu/ops/loss_ops.py``): ``cross_entropy`` over logits and
the chunked ``linear_cross_entropy`` that never holds the (N, vocab) logits.

``linear_cross_entropy`` is an ``autograd.Function``: the forward walks
token chunks, each chunk's logits tile computed in f32 (``_mm_f32``),
reduced to logsumexp - label logit and dropped; the backward recomputes
each tile and forms its gradient, so peak memory is one chunk's tile
(4096 x 128256 f32, ~2 GiB, at the Llama-3-8B train step), as the JAX
package's scan under ``jax.checkpoint`` does. All of it is plain PyTorch:
the JAX package computes it in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import functools

import torch


def cross_entropy(logits, label, ignore_index=-100, reduction="mean"):
    """Softmax cross-entropy of (N, C) logits against (N,) int labels;
    labels equal to ``ignore_index`` count for nothing ("mean" averages
    over the others)."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(-1, safe[:, None])[:, 0]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss


@functools.lru_cache(maxsize=None)
def _has_mm_out_dtype() -> bool:
    """Does this torch's ``torch.mm`` take ``out_dtype`` (a bf16 product
    with an f32 result) on CUDA tensors?"""
    a = torch.zeros((1, 1), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def _mm_f32(a, b):
    """a @ b as an f32 tile: bf16 operands with an f32 result on CUDA where
    torch has ``mm(out_dtype=)``, else f32 operands (the JAX package's
    ``preferred_element_type=f32``)."""
    if a.dtype == torch.bfloat16 and a.is_cuda and _has_mm_out_dtype():
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(hc, weight, transpose):
    return _mm_f32(hc, weight.T if transpose else weight)


class _LinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, lbl, transpose, ignore_index, chunk, mean):
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        for c0 in range(0, h.shape[0], chunk):
            logits = _chunk_logits(h[c0:c0 + chunk], weight, transpose)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, safe[c0:c0 + chunk, None])[:, 0]
            tok = torch.where(valid[c0:c0 + chunk], lse - picked,
                              torch.zeros_like(lse))
            total = total + tok.sum()
            del logits
        count = valid.sum().to(torch.float32).clamp(min=1.0)
        ctx.save_for_backward(h, weight, lbl)
        ctx.transpose, ctx.ignore_index = transpose, ignore_index
        ctx.chunk, ctx.mean = chunk, mean
        return total / count if mean else total

    @staticmethod
    def backward(ctx, g):
        h, weight, lbl = ctx.saved_tensors
        valid = lbl != ctx.ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        scale = g.float()
        if ctx.mean:
            scale = scale / valid.sum().to(torch.float32).clamp(min=1.0)
        dh = torch.empty_like(h)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        rows = torch.arange(min(ctx.chunk, h.shape[0]), device=h.device)
        for c0 in range(0, h.shape[0], ctx.chunk):
            hc = h[c0:c0 + ctx.chunk]
            n = hc.shape[0]
            dl = _chunk_logits(hc, weight, ctx.transpose)
            dl = torch.softmax(dl, dim=-1)
            dl[rows[:n], safe[c0:c0 + n]] -= 1.0
            dl *= (valid[c0:c0 + n].to(torch.float32) * scale)[:, None]
            dl = dl.to(h.dtype)
            if ctx.transpose:              # weight (V, H)
                dh[c0:c0 + n] = dl @ weight
                dw += _mm_f32(dl.T, hc)
            else:                          # weight (H, V)
                dh[c0:c0 + n] = dl @ weight.T
                dw += _mm_f32(hc.T, dl)
            del dl
        return dh, dw.to(weight.dtype), None, None, None, None, None


def linear_cross_entropy(hidden, weight, label, transpose_weight=False,
                         ignore_index=-100, chunk_size=2048,
                         reduction="mean"):
    """Cross-entropy of ``hidden @ weight`` against ``label`` without the
    (N, vocab) logits: ``chunk_size`` tokens at a time, each chunk's f32
    logits recomputed in backward. weight (H, V), or (V, H) with
    ``transpose_weight`` (tied embeddings). Reductions "mean" and "sum"."""
    if reduction not in ("mean", "sum"):
        raise ValueError(
            f"linear_cross_entropy supports reduction='mean'/'sum', got "
            f"{reduction!r}; use cross_entropy for per-token losses")
    h = hidden.reshape(-1, hidden.shape[-1])
    lbl = label.reshape(-1).long()
    chunk = max(1, min(int(chunk_size), h.shape[0]))
    return _LinearCrossEntropy.apply(h, weight, lbl, transpose_weight,
                                     ignore_index, chunk,
                                     reduction == "mean")
