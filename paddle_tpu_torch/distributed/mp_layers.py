"""Tensor-parallel (Megatron MP) layers (``paddle_tpu/distributed/
mp_layers.py``), one process a rank.

Each layer holds this rank's shard of its weight, cut over the
model-parallel group (the mesh's ``mp_axis``; by default the hybrid
group's ``mp``), and runs Megatron's conjugate pair of collectives
explicitly, where GSPMD infers them in the reference:

  * a column-cut layer's input: identity forward, all-reduce backward
    (``copy_to_model_parallel``), since every rank's shard of the output
    sends back only its share of the input's gradient;
  * a row-cut layer's output: all-reduce forward, identity backward, as
    ``overlap.matmul_ar`` (the ring pair with ``flags.collective_matmul``
    on, one all-reduce otherwise);
  * ``gather_output``: the column shards gathered on the last dim, each
    rank keeping its slice of the (replicated) cotangent;
  * the vocab embedding looks up the ids of its own row range, zeroes the
    rest and all-reduces (identity backward: each rank's rows get their
    own tokens' gradients);
  * ``ParallelCrossEntropy`` takes this rank's vocab slice of the logits
    (``ops/loss_ops.cross_entropy`` with ``vocab_group=``).

On a group of one rank every layer is its plain counterpart. Weights keep
the JAX package's (in, out) layout; ``weight_attr`` and ``fuse_matmul_bias``
are not ported (they raise when set).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..framework.contract import refuse_unported
from ..nn.common import INIT_STD
from ..nn.layer import Layer
from . import overlap
from .mesh import ProcessMesh, get_mesh
from .topology import get_hybrid_communicate_group


def _mp_mesh(mesh: Optional[ProcessMesh], axis: str, mp_group=None):
    """(mesh, axis) of the model-parallel group: ``mp_group``'s, the
    given mesh's, the hybrid group's ``mp``, or the default mesh's."""
    if mp_group is not None:
        if getattr(mp_group, "axis_name", None) is None:
            raise NotImplementedError(
                "mp_group: a group made by new_group (no mesh axis) is not "
                "ported; pass a hybrid or mesh-axis group")
        return mp_group.mesh, mp_group.axis_name
    if mesh is not None:
        return mesh, axis
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.mesh, "mp"
    m = get_mesh()
    if m is not None:
        return m, axis if axis in m.dim_names else m.dim_names[-1]
    return None, axis


def mp_degree(mesh, axis) -> int:
    """The model-parallel group's size (1 with no mesh)."""
    return overlap._axis_size(mesh, axis) if mesh is not None else 1


def mp_group_of(mesh, axis):
    """The model-parallel ``Group`` of this rank, or None at degree 1."""
    return overlap._group(mesh, axis) if mp_degree(mesh, axis) > 1 else None


def split_size(total: int, n: int, what: str) -> int:
    """``total`` / ``n``; raises naming ``what`` where it does not divide."""
    if total % n:
        raise ValueError(f"tensor parallelism: {what} ({total}) does not "
                         f"divide over {n} model-parallel ranks")
    return total // n


class _CopyToMP(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, dy):
        return overlap._all_reduce(dy.clone(), ctx.g), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, g):
        return overlap._all_reduce(x.clone(), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_model_parallel(x, group):
    """A column-cut consumer's input: identity, all-reduce backward (x
    itself on a group of one rank or none)."""
    if group is None or group.nranks == 1:
        return x
    return _CopyToMP.apply(x, group)


def reduce_from_model_parallel(x, group):
    """The sum over the group, identity backward."""
    if group is None or group.nranks == 1:
        return x
    return _ReduceFromMP.apply(x, group)


def vocab_parallel_lookup(ids, weight, group):
    """Rows of the vocab-cut table ``weight`` (V/n, H) for global ``ids``:
    this rank's rows where the id is in its range, zeros elsewhere, summed
    over ``group``."""
    if group is None or group.nranks == 1:
        return weight[ids]
    lo = group.rank * weight.shape[0]
    local = ids - lo
    mine = (local >= 0) & (local < weight.shape[0])
    out = weight[torch.where(mine, local, torch.zeros_like(local))]
    out = out * mine.unsqueeze(-1).to(out.dtype)
    return reduce_from_model_parallel(out, group)


def _param(layer, shape, dtype, device, generator, bias=False):
    return layer.create_parameter(shape, dtype=dtype, device=device,
                                  is_bias=bias, generator=generator,
                                  std=None if bias else INIT_STD)


class ColumnParallelLinear(Layer):
    """W [in, out] cut on out over mp: this rank holds (in, out / n) and
    its bias slice; ``gather_output`` gathers the output's columns."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, mesh=None, mp_axis="mp", *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        refuse_unported("ColumnParallelLinear",
                        weight_attr=(weight_attr, None),
                        fuse_matmul_bias=(fuse_matmul_bias, False))
        self.mesh, self.mp_axis = _mp_mesh(mesh, mp_axis, mp_group)
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
        g = mp_group_of(self.mesh, self.mp_axis)
        out = copy_to_model_parallel(x, g) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output and g is not None:
            out = overlap.ring_all_gather(out, self.mesh, self.mp_axis,
                                          dim=out.dim() - 1,
                                          partial_grad=False)
        return out


class RowParallelLinear(Layer):
    """W [in, out] cut on in over mp: this rank holds (in / n, out); the
    output is all-reduced (``overlap.matmul_ar``), the bias added once
    after it. ``input_is_parallel=False`` takes a replicated input and
    keeps this rank's slice of its last dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, mesh=None,
                 mp_axis="mp", *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        refuse_unported("RowParallelLinear",
                        weight_attr=(weight_attr, None),
                        fuse_matmul_bias=(fuse_matmul_bias, False))
        self.mesh, self.mp_axis = _mp_mesh(mesh, mp_axis, mp_group)
        n = mp_degree(self.mesh, self.mp_axis)
        self.input_is_parallel = input_is_parallel
        self.weight = _param(self, (split_size(in_features, n,
                                               "in_features"), out_features),
                             dtype, device, generator)
        self.weight.mp_cut = n > 1
        self.bias = (_param(self, (out_features,), dtype, device, None,
                            bias=True) if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = overlap.shard_seq(x, self.mesh, self.mp_axis,
                                  dim=x.dim() - 1)
        out = overlap.matmul_ar(x, self.weight, self.mesh, self.mp_axis)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(Layer):
    """The table cut on the vocab: this rank holds rows [r V / n, (r + 1)
    V / n)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, mesh=None, mp_axis="mp", *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        refuse_unported("VocabParallelEmbedding",
                        weight_attr=(weight_attr, None))
        self.mesh, self.mp_axis = _mp_mesh(mesh, mp_axis, mp_group)
        n = mp_degree(self.mesh, self.mp_axis)
        self.weight = _param(self, (split_size(num_embeddings, n,
                                               "num_embeddings"),
                                    embedding_dim), dtype, device, generator)
        self.weight.mp_cut = n > 1

    def forward(self, x):
        return vocab_parallel_lookup(x, self.weight,
                                     mp_group_of(self.mesh, self.mp_axis))


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy of vocab-cut logits (..., V / n) against
    global labels: the max, the sum of exponentials and the target's logit
    all-reduced over mp, in f32 (``loss_ops.cross_entropy``'s
    ``vocab_group``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100,
                 mesh=None, mp_axis="mp"):
        super().__init__()
        self.mesh, self.mp_axis = _mp_mesh(mesh, mp_axis, mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        from ..ops.loss_ops import cross_entropy

        shape = label.shape
        loss = cross_entropy(input.reshape(-1, input.shape[-1]),
                             label.reshape(-1), reduction="none",
                             ignore_index=self.ignore_index,
                             vocab_group=mp_group_of(self.mesh,
                                                     self.mp_axis))
        return loss.reshape(shape)
