"""Decomposed collectives (``paddle_tpu/distributed/overlap.py``): the
collective products of tensor and sequence parallelism, one process a rank.

The JAX package writes each product as a ``shard_map`` program whose ring
of ``ppermute`` hops XLA schedules under the partial matmuls. The port runs
one process a rank, so every product here is a ``torch.autograd.Function``
over this rank's shards, and every collective that GSPMD infers in the
reference is explicit:

- ``ag_matmul``        all-gather (sequence dim) -> matmul with a
                       column-cut weight; backward: dx by ``matmul_rs``,
                       dw with the x chunks circulating.
- ``matmul_rs``        matmul with a row-cut weight -> reduce-scatter
                       (sequence dim); backward: dx by ``ag_matmul``, dw
                       with the dy chunks circulating.
- ``matmul_ar``        row-parallel matmul with a replicated output: the
                       reduce-scatter ring, then the all-gather ring;
                       backward local (dx = dy w^T, dw = x^T dy).
- ``ring_all_gather``  all-gather along any dim; backward a reduce-scatter
                       (``partial_grad``: each rank's cotangent is its
                       share of the sum, as behind a column-cut consumer)
                       or the local slice (a replicated consumer).
- ``shard_seq``        this rank's slice of a replicated tensor; backward
                       the all-gather of the slices' cotangents.
- ``zero_prefetch``    ZeRO stage 3: the asynchronous all-gather of the
                       next decoder layer's shards (``sharding.py`` waits
                       for it where the layer's forward would gather).

With ``flags.collective_matmul`` on, a group of more than one rank and
shapes that divide, a product is a ring of N - 1 hops: each hop's
``batch_isend_irecv`` is in flight while the chunk in hand goes through
its partial matmul. Otherwise it is one monolithic collective
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``),
the reference's own rule; on a group of one rank every product is its
local matmul and nothing is communicated. gloo carries no point-to-point
transfer of CUDA tensors (``collective._GLOO_CUDA_REFUSED``), so a ring on
such a group raises; it never falls back to the monolithic form.

The reference's parameters are kept: ``mesh`` and ``axis`` name the group
(the mesh's ``axis`` over this rank's coordinate); ``batch_axis`` is
accepted and unused, since the data-parallel sum of a weight gradient is
the ``GradReducer``'s here. ``ragged_all_to_all`` and the stacked rings of
``communication.stream`` wait for expert parallelism and that module.
Fault site: ``overlap.ring_step`` at every hop.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..framework import flags as _flags
from ..reliability import faults
from .collective import Group, _check

_groups: dict = {}


def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    from .mesh import get_mesh

    return get_mesh()


def _axis_size(mesh, axis) -> int:
    mesh = _mesh_of(mesh)
    if mesh is None or axis is None or axis not in mesh.dim_names:
        return 1
    return mesh.get_dim_size(axis)


def _group(mesh, axis) -> Group:
    """This rank's group along ``mesh``'s ``axis`` (made once)."""
    mesh = _mesh_of(mesh)
    key = (id(mesh), axis)
    hit = _groups.get(key)
    if hit is None or hit[0] is not mesh:   # (the mesh is held: no id reuse)
        from .topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if hcg is not None and hcg.mesh is mesh and axis in hcg._groups:
            hit = (mesh, hcg._groups[axis])
        else:
            hit = (mesh, Group(mesh, axis))
        _groups[key] = hit
    return hit[1]


def enabled(mesh=None, axis: Optional[str] = None) -> bool:
    """Decomposed collectives are on: the flag is set AND the axis is a
    real ring (more than one rank)."""
    if not _flags.get_flag("collective_matmul"):
        return False
    return _axis_size(mesh, axis) > 1


# ---------------------------------------------------------------------------
# Monolithic collectives along a dim, and the ring hop
# ---------------------------------------------------------------------------
def _gather_dim(x, g, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    flat = torch.empty((g.nranks,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)
    _check("all_gather", g, x)
    dist.all_gather_into_tensor(flat.view(-1), x.view(-1),
                                group=g.process_group)
    return torch.cat(flat.unbind(0), dim=dim)


def _scatter_dim(y, g, dim):
    """The sum over ranks of ``y``, this rank's block along ``dim``."""
    n = g.nranks
    parts = torch.stack(torch.chunk(y, n, dim=dim), 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=y.dtype, device=y.device)
    _check("reduce_scatter", g, parts)
    dist.reduce_scatter_tensor(out.view(-1), parts.view(-1),
                               group=g.process_group)
    return out


def _all_reduce(y, g):
    y = y.contiguous()
    _check("all_reduce", g, y)
    dist.all_reduce(y, group=g.process_group)
    return y


def _slice_dim(x, g, dim):
    loc = x.shape[dim] // g.nranks
    return x.narrow(dim, g.rank * loc, loc).contiguous()


class _Hop:
    """One ring hop in flight: ``t`` to the neighbour ``to`` places on
    (-1: the left), the right-hand neighbour's tensor into ``recv``."""

    def __init__(self, t, g, to, op, step):
        faults.maybe_fail("overlap.ring_step", op=op, step=step)
        n, r = g.nranks, g.rank
        t = t.contiguous()
        _check("batch_isend_irecv", g, t)
        self.recv = torch.empty_like(t)
        pg = g.process_group
        self._works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, g.ranks[(r + to) % n], group=pg),
            dist.P2POp(dist.irecv, self.recv, g.ranks[(r - to) % n],
                       group=pg)])
        self._sent = t

    def wait(self):
        for w in self._works:
            w.wait()
        return self.recv


# ---------------------------------------------------------------------------
# Ring bodies (no autograd). Each issues the next hop before the partial
# matmul of the chunk in hand, so the transfer runs under the compute.
# ---------------------------------------------------------------------------
def _ring_ag_matmul(x, w, g, op="ag_matmul"):
    """x (..., S/n, K) circulating leftwards, w (K, F): the (..., S, F)
    product of the gathered x, each block written at its source's
    offset."""
    n, r = g.nranks, g.rank
    s_loc = x.shape[-2]
    out = torch.empty(x.shape[:-2] + (s_loc * n, w.shape[-1]),
                      dtype=torch.result_type(x, w), device=x.device)
    chunk = x
    for t in range(n):
        hop = _Hop(chunk, g, -1, op, t) if t + 1 < n else None
        src = (r + t) % n
        out[..., src * s_loc:(src + 1) * s_loc, :] = torch.matmul(chunk, w)
        if hop is not None:
            chunk = hop.wait()
    return out


def _ring_matmul_rs(x, w, g, op="matmul_rs"):
    """x (..., S, K), w (K, H): the accumulator of one sequence block
    moves rightwards and every rank adds its partial product; rank r ends
    with block r summed over the ranks, (..., S/n, H)."""
    n, r = g.nranks, g.rank
    s_loc = x.shape[-2] // n

    def part(j):
        return torch.matmul(x[..., j * s_loc:(j + 1) * s_loc, :], w)

    acc = part((r + n - 1) % n)
    for t in range(1, n):
        hop = _Hop(acc, g, +1, op, t)
        nxt = part((r + n - 1 - t) % n)
        acc = hop.wait() + nxt
    return acc


def _ring_gather(x, g, dim, op="all_gather"):
    """``x`` gathered along ``dim`` by N - 1 hops."""
    n, r = g.nranks, g.rank
    loc = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = loc * n
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    cur = x
    for t in range(n):
        hop = _Hop(cur, g, -1, op, t) if t + 1 < n else None
        src = (r + t) % n
        out.narrow(dim, src * loc, loc).copy_(cur)
        if hop is not None:
            cur = hop.wait()
    return out


def _ring_scatter(y, g, dim, op="reduce_scatter"):
    """The sum over ranks of ``y``, this rank's block along ``dim``, by the
    circulating-accumulator ring."""
    n, r = g.nranks, g.rank
    loc = y.shape[dim] // n

    def block(j):
        return y.narrow(dim, j * loc, loc)

    acc = block((r + n - 1) % n).contiguous()
    for t in range(1, n):
        hop = _Hop(acc, g, +1, op, t)
        acc = hop.wait() + block((r + n - 1 - t) % n)
    return acc


def _ring_dw(circ, other, g, circ_is_x):
    """dw of a ring product with ``circ`` (the sequence chunks, (..., S/n,
    ·)) circulating leftwards against the full-sequence ``other``: sum_j
    x_j^T dy_j over the sequence blocks j, in f32."""
    n, r = g.nranks, g.rank
    s_loc = circ.shape[-2]
    dw = None
    chunk = circ
    for t in range(n):
        hop = _Hop(chunk, g, -1, "dw_ring", t) if t + 1 < n else None
        src = (r + t) % n
        blk = other[..., src * s_loc:(src + 1) * s_loc, :]
        xs, dys = (chunk, blk) if circ_is_x else (blk, chunk)
        part = torch.matmul(xs.reshape(-1, xs.shape[-1]).T.float(),
                            dys.reshape(-1, dys.shape[-1]).float())
        dw = part if dw is None else dw + part
        if hop is not None:
            chunk = hop.wait()
    return dw


def _local_dw(x, dy):
    return torch.matmul(x.reshape(-1, x.shape[-1]).T,
                        dy.reshape(-1, dy.shape[-1]))


# ---------------------------------------------------------------------------
# The autograd products
# ---------------------------------------------------------------------------
class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, ring):
        ctx.save_for_backward(x, w)
        ctx.g, ctx.ring = g, ring
        if ring:
            return _ring_ag_matmul(x, w, g)
        return torch.matmul(_gather_dim(x, g, x.dim() - 2), w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = ctx.g
        if ctx.ring:
            dx = _ring_matmul_rs(dy, w.T, g, op="ag_matmul_bwd")
            dw = _ring_dw(x, dy, g, circ_is_x=True).to(w.dtype)
        else:
            dx = _scatter_dim(torch.matmul(dy, w.T), g, dy.dim() - 2)
            dw = _local_dw(_gather_dim(x, g, x.dim() - 2), dy)
        return dx.to(x.dtype), dw, None, None


class _MatmulRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, ring):
        ctx.save_for_backward(x, w)
        ctx.g, ctx.ring = g, ring
        if ring:
            return _ring_matmul_rs(x, w, g)
        return _scatter_dim(torch.matmul(x, w), g, x.dim() - 2)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = ctx.g
        if ctx.ring:
            dx = _ring_ag_matmul(dy, w.T, g, op="matmul_rs_bwd")
            dw = _ring_dw(dy, x, g, circ_is_x=False).to(w.dtype)
        else:
            dy_full = _gather_dim(dy, g, dy.dim() - 2)
            dx = torch.matmul(dy_full, w.T)
            dw = _local_dw(x, dy_full)
        return dx.to(x.dtype), dw, None, None


class _MatmulAr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, ring):
        ctx.save_for_backward(x, w)
        if ring:
            chunk = _ring_matmul_rs(x, w, g, op="matmul_ar")
            return _ring_gather(chunk, g, chunk.dim() - 2, op="matmul_ar")
        return _all_reduce(torch.matmul(x, w), g)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return (torch.matmul(dy, w.T).to(x.dtype),
                _local_dw(x, dy).to(w.dtype), None, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim, ring, partial_grad):
        ctx.g, ctx.dim, ctx.ring, ctx.partial = g, dim, ring, partial_grad
        if ring:
            return _ring_gather(x, g, dim)
        return _gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        g, dim = ctx.g, ctx.dim
        if not ctx.partial:
            return _slice_dim(dy, g, dim), None, None, None, None
        if ctx.ring:
            return _ring_scatter(dy, g, dim), None, None, None, None
        return _scatter_dim(dy, g, dim), None, None, None, None


class _ShardSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _slice_dim(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather_dim(dy, ctx.g, ctx.dim), None, None


def ag_matmul(x, w, mesh, axis: str, batch_axis: str = "dp"):
    """``all_gather_seq(x) @ w`` for this rank's sequence chunk x (..., S/n,
    K) and its column shard w (K, F/n): (..., S, F/n). Backward: dx by the
    transposed ring (``matmul_rs`` of dy and w^T), dw with the x chunks
    circulating."""
    n = _axis_size(mesh, axis)
    if n == 1:
        return torch.matmul(x, w)
    return _AgMatmul.apply(x, w, _group(mesh, axis), enabled(mesh, axis))


def matmul_rs(x, w, mesh, axis: str, batch_axis: str = "dp"):
    """``reduce_scatter_seq(x @ w)`` for x (..., S, K/n) cut on its last
    dim and the row shard w (K/n, H): this rank's sequence block (..., S/n,
    H) of the sum. Backward: dx by ``ag_matmul`` of dy and w^T, dw with
    the dy chunks circulating."""
    n = _axis_size(mesh, axis)
    if n == 1:
        return torch.matmul(x, w)
    if x.shape[-2] % n:
        raise ValueError(f"matmul_rs: the sequence dim {x.shape[-2]} does "
                         f"not divide over {n} ranks")
    return _MatmulRs.apply(x, w, _group(mesh, axis), enabled(mesh, axis))


def matmul_ar(x, w, mesh, axis: str, batch_axis: str = "dp",
              seq_axis: Optional[str] = None):
    """``all_reduce(x @ w)`` for x (..., S, K/n) and the row shard w (K/n,
    H): the ring pair (reduce-scatter, then all-gather) where the sequence
    divides, else one all-reduce. Backward local. ``seq_axis`` (context
    parallelism) is not ported."""
    if seq_axis is not None:
        raise NotImplementedError("matmul_ar: seq_axis (context "
                                  "parallelism) is not ported")
    n = _axis_size(mesh, axis)
    if n == 1:
        return torch.matmul(x, w)
    ring = enabled(mesh, axis) and x.shape[-2] % n == 0
    return _MatmulAr.apply(x, w, _group(mesh, axis), ring)


def ring_all_gather(x, mesh, axis: str, dim: int = 1,
                    batch_axis: str = "dp", *, partial_grad: bool = True):
    """``x`` cut on ``dim`` over ``axis`` -> the whole tensor on every rank
    (the ring, or one all-gather). Backward: with ``partial_grad`` each
    rank's cotangent is its share (the consumer is column-cut), so the
    cotangents are reduce-scattered; else the consumer is replicated and
    each rank keeps its slice."""
    n = _axis_size(mesh, axis)
    dim = dim % x.dim()
    if n == 1:
        return x
    return _Gather.apply(x, _group(mesh, axis), dim, enabled(mesh, axis),
                         partial_grad)


def shard_seq(x, mesh, axis: str, dim: int = 1, batch_axis: str = "dp"):
    """This rank's block of a replicated ``x`` along ``dim`` (the SP
    residual stream's placement); backward all-gathers the blocks'
    cotangents."""
    n = _axis_size(mesh, axis)
    dim = dim % x.dim()
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"shard_seq: dim {dim} of size {x.shape[dim]} "
                         f"does not divide over {n} ranks")
    return _ShardSeq.apply(x, _group(mesh, axis), dim)


# ---------------------------------------------------------------------------
# ZeRO-3 parameter prefetch
# ---------------------------------------------------------------------------
def _group_key(name: str) -> str:
    """Layer grouping key: the name prefix up to (and including) its first
    numeric component ('model.layers.3.mlp.w' -> 'model.layers.3')."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return ".".join(parts[:-1]) or name


def _layer_groups(names):
    groups, order = {}, []
    for n in names:
        k = _group_key(n)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(n)
    return [groups[k] for k in order]


def zero_prefetch(params, plan) -> dict:
    """Stage-3 prefetch: start the asynchronous all-gather of every
    sharded parameter in ``params`` (names, or a {name: shard} dict: one
    decoder layer's) and leave it in flight in ``plan``; the layer's
    forward then waits for it where it would have gathered
    (``ShardingPlan._gather_padded``). Returns {name: the padded full
    buffer being filled}. No-op (returns {}) with the ``zero_prefetch`` or
    ``collective_matmul`` flag off, below stage 3, or on one rank."""
    if not (_flags.get_flag("zero_prefetch")
            and _flags.get_flag("collective_matmul")):
        return {}
    if plan is None or plan.stage < 3 or plan.group is None \
            or plan.group.nranks < 2:
        return {}
    out = {}
    for name in params:
        if name in plan._padded and name not in plan._prefetched:
            out[name] = plan._start_gather(name)
    plan.prefetches += len(out)
    return out


# ---------------------------------------------------------------------------
# Tensor-level entry points (the reference's ``t_*``: its eager tape
# wrappers; the port's tensors carry autograd themselves)
# ---------------------------------------------------------------------------
def t_ag_matmul(x, w, mesh, axis, batch_axis="dp"):
    return ag_matmul(x, w, mesh, axis, batch_axis)


def t_matmul_rs(x, w, mesh, axis, batch_axis="dp"):
    return matmul_rs(x, w, mesh, axis, batch_axis)


def t_matmul_ar(x, w, mesh, axis, batch_axis="dp", seq_axis=None):
    return matmul_ar(x, w, mesh, axis, batch_axis, seq_axis)


def t_ring_all_gather(x, mesh, axis, dim=1, batch_axis="dp", *,
                      partial_grad=True):
    return ring_all_gather(x, mesh, axis, dim, batch_axis,
                           partial_grad=partial_grad)


def t_shard_seq(x, mesh, axis, dim=1, batch_axis="dp"):
    return shard_seq(x, mesh, axis, dim, batch_axis)
