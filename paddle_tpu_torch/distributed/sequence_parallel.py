"""Sequence parallelism (``paddle_tpu/distributed/sequence_parallel.py``),
one process a rank.

1. **Megatron-SP** over the model-parallel group: outside the tensor-
   parallel block each rank holds its sequence block of the activations.
   ``scatter`` keeps this rank's block (backward: the all-gather of the
   blocks' cotangents) and ``all_gather`` gathers the blocks (backward:
   the reduce-scatter, since behind a column-cut consumer each rank's
   cotangent is its share); each is the other's transpose.
   ``ColumnSequenceParallelLinear`` enters a block by ``overlap.ag_matmul``
   and ``RowSequenceParallelLinear`` leaves it by ``overlap.matmul_rs``
   (rings with ``flags.collective_matmul`` on, monolithic collectives
   otherwise).

2. **Ulysses** over the sep group: ``ulysses_attention`` takes (B, S/sep,
   H, D) q/k/v, an all-to-all turns them into (B, S, H/sep, D), flash
   attention (K1 forward, K5/K9 backward on CUDA tensors) runs on the head
   slice, and a second all-to-all turns the output back; each all-to-all's
   backward is the other.

``register_sequence_parallel_allreduce_hooks`` is a no-op in the reference
(GSPMD sums the gradients of replicated parameters). Here a parameter
that runs on a sequence block (a norm weight, a bias added after a
reduce-scatter: ``mark_as_sequence_parallel_parameter``) gets only its
block's share of the gradient, so the hooks all-reduce it over the
model-parallel group once it is final.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..framework.contract import refuse_unported
from ..nn.layer import Layer
from . import overlap
from .collective import _check
from .mesh import get_mesh
from .mp_layers import _param, mp_degree, mp_group_of, split_size
from .topology import get_hybrid_communicate_group


def _sp_mesh(mesh, axis):
    if mesh is not None:
        return mesh, axis
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        # the caller's axis where the hybrid mesh has it, else the TP axis
        # (Megatron-SP shards the sequence over the mp group)
        return hcg.mesh, axis if axis in hcg.mesh.dim_names else "mp"
    return get_mesh(), axis


def _seq_dim(x):
    return 1 if x.dim() >= 3 else 0


def scatter(x, mesh=None, axis: str = "mp"):
    """ScatterOp: this rank's block of the sequence dim (dim 1 of (B, S,
    H), dim 0 of 2-D)."""
    mesh, axis = _sp_mesh(mesh, axis)
    return overlap.shard_seq(x, mesh, axis, dim=_seq_dim(x))


def all_gather(x, mesh=None, axis: str = "mp"):
    """AllGatherOp: the sequence blocks gathered (the ring with the
    overlap flag on, one all-gather otherwise); backward reduce-scatters."""
    mesh, axis = _sp_mesh(mesh, axis)
    return overlap.ring_all_gather(x, mesh, axis, dim=_seq_dim(x))


def mark_as_sequence_parallel_parameter(p):
    p.sequence_parallel = True


class ColumnSequenceParallelLinear(Layer):
    """Input arrives sequence-cut and is gathered into the column-cut
    matmul (``overlap.ag_matmul``); W [in, out] cut on out over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mesh=None, mp_axis="mp",
                 name=None, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        refuse_unported("ColumnSequenceParallelLinear",
                        weight_attr=(weight_attr, None))
        self.mesh, self.mp_axis = _sp_mesh(mesh, mp_axis)
        n = mp_degree(self.mesh, self.mp_axis)
        self.gather_output = gather_output
        local = split_size(out_features, n, "out_features")
        self.weight = _param(self, (in_features, local), dtype, device,
                             generator)
        self.weight.mp_cut = n > 1
        self.bias = (_param(self, (local,), dtype, device, None, bias=True)
                     if has_bias else None)
        if self.bias is not None:
            self.bias.mp_cut = n > 1

    def forward(self, x):
        out = overlap.ag_matmul(x, self.weight, self.mesh, self.mp_axis)
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output and mp_degree(self.mesh, self.mp_axis) > 1:
            out = overlap.ring_all_gather(out, self.mesh, self.mp_axis,
                                          dim=out.dim() - 1,
                                          partial_grad=False)
        return out


class RowSequenceParallelLinear(Layer):
    """The row-cut matmul whose output leaves sequence-cut
    (``overlap.matmul_rs``: RowParallelLinear's all-reduce and the scatter
    as one reduce-scatter). Its bias is added on the sequence block, so it
    is marked for the sequence-parallel all-reduce."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mesh=None,
                 mp_axis="mp", name=None, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        refuse_unported("RowSequenceParallelLinear",
                        weight_attr=(weight_attr, None),
                        input_is_parallel=(input_is_parallel, True))
        self.mesh, self.mp_axis = _sp_mesh(mesh, mp_axis)
        n = mp_degree(self.mesh, self.mp_axis)
        self.weight = _param(self, (split_size(in_features, n,
                                               "in_features"), out_features),
                             dtype, device, generator)
        self.weight.mp_cut = n > 1
        self.bias = (_param(self, (out_features,), dtype, device, None,
                            bias=True) if has_bias else None)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = overlap.matmul_rs(x, self.weight, self.mesh, self.mp_axis)
        if self.bias is not None:
            out = out + self.bias
        return out


# ---------------------------------------------------------------------------
# Ulysses / SEP: the all-to-all around attention
# ---------------------------------------------------------------------------
def _a2a(x, g, split, cat):
    """Split ``x`` into the group's n chunks along ``split``; chunk j goes
    to rank j; the chunks received (rank order) are concatenated along
    ``cat``."""
    n = g.nranks
    parts = torch.stack(torch.chunk(x, n, dim=split), 0).contiguous()
    out = torch.empty_like(parts)
    _check("all_to_all", g, parts)
    dist.all_to_all_single(out, parts, group=g.process_group)
    return torch.cat(out.unbind(0), dim=cat)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _a2a(x, g, split=2, cat=1)

    @staticmethod
    def backward(ctx, dy):
        return _a2a(dy, ctx.g, split=1, cat=2), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _a2a(x, g, split=1, cat=2)

    @staticmethod
    def backward(ctx, dy):
        return _a2a(dy, ctx.g, split=2, cat=1), None


def ulysses_attention(q, k, v, mesh=None, sep_axis: str = "sep",
                      causal: bool = True, *, plain: bool = False):
    """DeepSpeed-Ulysses over the sep group: q (B, S/sep, H, D), k and v
    (B, S/sep, Hk, D) -> this rank's (B, S/sep, H, D) attention output of
    the whole sequence. The sep degree must divide H and Hk. ``plain``:
    the flash kernels' plain versions (the on-card reference)."""
    from ..ops.kernels.flash_attention import flash_attention_train

    mesh, sep_axis = _sp_mesh(mesh, sep_axis)
    n = mp_degree(mesh, sep_axis) if mesh is not None and \
        sep_axis in mesh.dim_names else 1
    if n == 1:
        return flash_attention_train(q, k, v, causal=causal, plain=plain)
    split_size(q.shape[2], n, "the attention heads")
    split_size(k.shape[2], n, "the key/value heads")
    g = mp_group_of(mesh, sep_axis)
    qh, kh, vh = (_SeqToHeads.apply(t, g) for t in (q, k, v))
    out = flash_attention_train(qh, kh, vh, causal=causal, plain=plain)
    return _HeadsToSeq.apply(out, g)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """All-reduce, over the model-parallel group, the gradient of every
    parameter marked ``sequence_parallel`` once it is final in a backward
    (``register_post_accumulate_grad_hook``): each rank's is the share of
    its sequence block. A parameter that takes no gradient yet (a model
    before ``train()``) gets its hook all the same. Returns ``model``.
    ``accumulation_steps`` > 1 and ``fuse`` are not ported."""
    refuse_unported("register_sequence_parallel_allreduce_hooks",
                    accumulation_steps=(accumulation_steps, 1),
                    fuse=(fuse, False))
    ctx = getattr(model, "_tp_overlap", None)
    if ctx is not None:
        mesh, axis = ctx["mesh"], ctx["axis"]
    else:
        mesh, axis = _sp_mesh(None, "mp")
    g = mp_group_of(mesh, axis)
    if g is None:
        return model

    def hook(p):
        overlap._all_reduce(p.grad, g)

    handles = getattr(model, "_sp_hooks", [])
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False):
            frozen = not p.requires_grad    # a hook needs requires_grad
            p.requires_grad_(True)
            handles.append(p.register_post_accumulate_grad_hook(hook))
            p.requires_grad_(not frozen)
    model._sp_hooks = handles
    return model
