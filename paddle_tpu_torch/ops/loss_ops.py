"""Losses (``paddle_tpu/ops/loss_ops.py``): ``cross_entropy`` over logits and
the chunked ``linear_cross_entropy`` that never holds the (N, vocab) logits.

``linear_cross_entropy`` is an ``autograd.Function``: the forward walks
token chunks, each chunk's logits tile computed in f32 (``_mm_f32``),
reduced to logsumexp - label logit and dropped; the backward recomputes
each tile and forms its gradient, so peak memory is one chunk's tile
(4096 x 128256 f32, ~2 GiB, at the Llama-3-8B train step), as the JAX
package's scan under ``jax.checkpoint`` does. All of it is plain PyTorch:
the JAX package computes it in XLA, with no Pallas kernel.

Data parallelism: the JAX package's "mean" divides by the valid targets of
the whole (global) batch, one program over every device. Given
``count_group=`` (a ``distributed.Group``; ``jit.TrainStep`` passes its
data-parallel group to its loss function, and the models' ``loss`` pass it
on), a "mean" here divides the local sum by the group's total of valid
targets and multiplies by the group's size; the reducer's mean over the
ranks then gives the global loss and its gradient, also where ranks hold
different numbers of valid targets (padded batches). The total is one
blocking all-reduce of the count, so every rank of the group makes the same
such calls in the same order.

Tensor parallelism: given ``vocab_group=`` (the model-parallel group),
``cross_entropy`` takes this rank's vocab slice of the logits (..., V / n)
and ``linear_cross_entropy`` this rank's vocab slice of the head (rank r
owns classes [r V / n, (r + 1) V / n)); labels stay global. Each token's
log-sum-exp is formed in f32 from the slices' max (all-reduced MAX), sum
of exponentials and target logit (one all-reduced SUM of both), chunk by
chunk; the backward needs no collective (softmax minus the target, on
this rank's slice; the sum of the input's gradient over the ranks is the
caller's column-cut conjugate). Every rank of the group sees the same
tokens, so a "mean" counts them over ``count_group`` (the data-parallel
group) only. On a group of one rank both are their plain forms.
"""

from __future__ import annotations

import functools

import torch

from ..framework.contract import refuse_unported

def _mean_divisor(count, group):
    """(divisor, factor) of a "mean" over ``count`` local valid targets:
    ``group``'s total and its size, else (count, None)."""
    if group is None:
        return count, None
    from ..distributed.collective import all_reduce

    return all_reduce(count.clone(), group=group), float(group.nranks)


def _vocab_stats(logits, safe, group):
    """(lse, target logit) of f32 vocab-slice ``logits`` (n, V / r) for
    global labels ``safe``, each over the whole vocab of ``group``."""
    from ..distributed import overlap
    from ..distributed.collective import ReduceOp, all_reduce

    lo = group.rank * logits.shape[-1]
    m = all_reduce(logits.max(dim=-1).values, ReduceOp.MAX, group=group)
    local = safe - lo
    mine = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(1, torch.where(mine, local, torch.zeros_like(
        local))[:, None])[:, 0]
    both = torch.stack([torch.exp(logits - m[:, None]).sum(dim=-1),
                        torch.where(mine, picked, torch.zeros_like(picked))])
    both = overlap._all_reduce(both, group)
    return m + torch.log(both[0]), both[1]


def _vocab_grad(logits, lse, safe, valid, scale, group):
    """d(lse - target) of the f32 vocab slice, times ``scale`` a row."""
    lo = group.rank * logits.shape[-1]
    dl = torch.exp(logits - lse[:, None])
    local = safe - lo
    mine = (local >= 0) & (local < logits.shape[-1]) & valid
    rows = torch.nonzero(mine)[:, 0]
    dl[rows, local[rows]] -= 1.0
    return dl * (valid.to(torch.float32) * scale)[:, None]


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross entropy of (n, V / r) vocab-slice logits."""

    @staticmethod
    def forward(ctx, logits, lbl, ignore_index, group):
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        lse, picked = _vocab_stats(logits.float(), safe, group)
        ctx.save_for_backward(logits, lse, safe, valid)
        ctx.group = group
        loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, lse, safe, valid = ctx.saved_tensors
        dl = _vocab_grad(logits.float(), lse, safe, valid, g.float(),
                         ctx.group)
        return dl.to(logits.dtype), None, None, None


def _tp_group(group):
    """The vocab group when it spans more than one rank, else None."""
    return group if group is not None and group.nranks > 1 else None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, *,
                  count_group=None, vocab_group=None):
    """Softmax cross-entropy of (N, C) logits against (N,) int labels;
    labels equal to ``ignore_index`` count for nothing ("mean" averages
    over the others; over every rank of ``count_group``, see the module
    docstring). ``vocab_group``: ``input`` is this rank's vocab slice
    (module docstring). Class weights, soft labels, another class axis,
    probabilities for logits and label smoothing are not ported."""
    refuse_unported("cross_entropy", weight=(weight, None),
                    soft_label=(soft_label, False), axis=(axis, -1),
                    use_softmax=(use_softmax, True),
                    label_smoothing=(label_smoothing, 0.0))
    valid = label != ignore_index
    vocab_group = _tp_group(vocab_group)
    if vocab_group is not None:
        loss = _VocabParallelCE.apply(input, label.long(), ignore_index,
                                      vocab_group)
    else:
        logp = torch.log_softmax(input, dim=-1)
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        loss = -logp.gather(-1, safe[:, None])[:, 0]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        count, factor = _mean_divisor(valid.sum(), count_group)
        out = loss.sum() / count.clamp(min=1).to(loss.dtype)
        return out if factor is None else out * factor
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
    def forward(ctx, h, weight, lbl, transpose, ignore_index, chunk, mean,
                count_group, vocab_group):
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        lses = []
        for c0 in range(0, h.shape[0], chunk):
            logits = _chunk_logits(h[c0:c0 + chunk], weight, transpose)
            if vocab_group is None:
                lse = torch.logsumexp(logits, dim=-1)
                picked = logits.gather(1, safe[c0:c0 + chunk, None])[:, 0]
            else:
                lse, picked = _vocab_stats(logits, safe[c0:c0 + chunk],
                                           vocab_group)
                lses.append(lse)
            tok = torch.where(valid[c0:c0 + chunk], lse - picked,
                              torch.zeros_like(lse))
            total = total + tok.sum()
            del logits
        ctx.vocab_group = vocab_group
        ctx.lse = torch.cat(lses) if lses else None
        count, factor = (_mean_divisor(valid.sum(), count_group) if mean
                         else (None, None))
        ctx.save_for_backward(h, weight, lbl)
        ctx.transpose, ctx.ignore_index = transpose, ignore_index
        ctx.chunk, ctx.mean = chunk, mean
        if not mean:
            return total
        ctx.count = count.to(torch.float32).clamp(min=1.0)
        ctx.factor = factor
        out = total / ctx.count
        return out if factor is None else out * factor

    @staticmethod
    def backward(ctx, g):
        h, weight, lbl = ctx.saved_tensors
        valid = lbl != ctx.ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        scale = g.float()
        if ctx.mean:
            scale = scale / ctx.count
            if ctx.factor is not None:
                scale = scale * ctx.factor
        dh = torch.empty_like(h)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        rows = torch.arange(min(ctx.chunk, h.shape[0]), device=h.device)
        for c0 in range(0, h.shape[0], ctx.chunk):
            hc = h[c0:c0 + ctx.chunk]
            n = hc.shape[0]
            dl = _chunk_logits(hc, weight, ctx.transpose)
            if ctx.vocab_group is None:
                dl = torch.softmax(dl, dim=-1)
                dl[rows[:n], safe[c0:c0 + n]] -= 1.0
                dl *= (valid[c0:c0 + n].to(torch.float32) * scale)[:, None]
            else:
                dl = _vocab_grad(dl, ctx.lse[c0:c0 + n], safe[c0:c0 + n],
                                 valid[c0:c0 + n], scale, ctx.vocab_group)
            dl = dl.to(h.dtype)
            if ctx.transpose:              # weight (V, H)
                dh[c0:c0 + n] = dl @ weight
                dw += _mm_f32(dl.T, hc)
            else:                          # weight (H, V)
                dh[c0:c0 + n] = dl @ weight.T
                dw += _mm_f32(hc.T, dl)
            del dl
        return (dh, dw.to(weight.dtype), None, None, None, None, None, None,
                None)


def linear_cross_entropy(hidden, weight, label, bias=None,
                         transpose_weight=False, ignore_index=-100,
                         chunk_size=2048, reduction="mean", *,
                         count_group=None, vocab_group=None):
    """Cross-entropy of ``hidden @ weight`` against ``label`` without the
    (N, vocab) logits: ``chunk_size`` tokens at a time, each chunk's f32
    logits recomputed in backward. weight (H, V), or (V, H) with
    ``transpose_weight`` (tied embeddings). Reductions "mean" (over every
    rank of ``count_group``, see the module docstring) and "sum".
    ``vocab_group``: ``weight`` is this rank's vocab slice (module
    docstring). A bias is not ported."""
    refuse_unported("linear_cross_entropy", bias=(bias, None))
    if reduction not in ("mean", "sum"):
        raise ValueError(
            f"linear_cross_entropy supports reduction='mean'/'sum', got "
            f"{reduction!r}; use cross_entropy for per-token losses")
    h = hidden.reshape(-1, hidden.shape[-1])
    lbl = label.reshape(-1).long()
    chunk = max(1, min(int(chunk_size), h.shape[0]))
    return _LinearCrossEntropy.apply(h, weight, lbl, transpose_weight,
                                     ignore_index, chunk,
                                     reduction == "mean", count_group,
                                     _tp_group(vocab_group))
