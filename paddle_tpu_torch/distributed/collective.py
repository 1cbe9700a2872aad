"""Collectives (``paddle_tpu/distributed/collective.py``) over
``torch.distributed``, one process a rank.

The JAX package is single-controller: a collective there takes a
"local-shard view" whose leading axis enumerates the group's ranks. The
port runs one process a rank, so row r of that view is rank r's own
tensor here, and every function below acts on the calling rank's tensor
(``distributed/__init__.py`` states the whole mapping). The parameters are
the reference's; ``src`` / ``dst`` / ``peer`` are ranks within ``group``.

Two definitions differ from the reference on purpose:

  * ``ReduceOp.PROD`` is the true product. The reference computes
    ``exp(psum(log(|x| + 1e-30)))``, which drops the sign.
  * ``reduce`` leaves the reduction on ``dst`` alone; the reference's
    fills every row (it is its ``all_reduce``).

No fallback: the backend is the process group's, chosen explicitly by
``env.init_parallel_env`` (NCCL for CUDA tensors, gloo for CPU tensors,
anything else by name). NCCL refuses a CPU tensor here, and gloo on CUDA
tensors raises for the point-to-point calls it cannot carry
(``_GLOO_CUDA_REFUSED``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import ProcessMesh, get_mesh


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}

#: what gloo cannot carry on CUDA tensors: its point-to-point path hands
#: the device pointer to the socket (torch 2.11 on an H100 aborts the
#: process: "writev ... Bad address"); every collective here stages them
_GLOO_CUDA_REFUSED = frozenset({"send", "recv", "isend", "irecv",
                                "batch_isend_irecv"})


class Group:
    """A communication group: one mesh axis (``mesh``, ``axis_name``), or
    the ranks of ``new_group`` (port-only ``pg`` and ``ranks``)."""

    def __init__(self, mesh: ProcessMesh, axis_name: str, gid: int = 0, *,
                 pg=None, ranks=None):
        self.mesh = mesh
        self.axis_name = axis_name
        self.id = gid
        self._pg, self._ranks = pg, ranks
        self._sizes = {}

    @property
    def process_group(self):
        if self._pg is None:
            self._pg = self.mesh.process_group(self.axis_name)
        return self._pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's rank in the group (-1 outside it)."""
        me = dist.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    @property
    def ranks(self):
        """The group's global ranks, in group order."""
        if self._ranks is None:
            me = dist.get_rank()
            self._ranks = next(r for r in self.mesh.axis_ranks(
                self.axis_name) if me in r)
        return list(self._ranks)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def size_like(self, t):
        """The group's size as a 0-d tensor of ``t``'s dtype on its device,
        made once: a mean divides by it (CUDA would multiply by a Python
        number's reciprocal, an ulp off the IEEE quotient)."""
        key = (t.device, t.dtype)
        if key not in self._sizes:
            self._sizes[key] = torch.full((), float(self.nranks),
                                          dtype=t.dtype, device=t.device)
        return self._sizes[key]

    def __repr__(self):
        return f"Group(axis={self.axis_name}, nranks={self.nranks})"


_default_group: Optional[Group] = None
_group_registry: dict = {}


def _get_group(group: Optional[Group]) -> Group:
    global _default_group
    if group is not None:
        return group
    if _default_group is None:
        if not dist.is_initialized():
            raise RuntimeError("call init_parallel_env() first")
        mesh = get_mesh()
        if mesh is None:
            from .mesh import init_mesh

            mesh = init_mesh()
        _default_group = Group(mesh, mesh.dim_names[0])
    return _default_group


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (default: every rank). Every rank must call
    it, in the same order; ``backend`` defaults to the world's."""
    from datetime import timedelta

    ranks = list(range(dist.get_world_size())) if ranks is None else \
        [int(r) for r in ranks]
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    pg = dist.new_group(ranks, backend=backend, **kw)
    gid = len(_group_registry) + 1
    g = Group(get_mesh(), None, gid=gid, pg=pg, ranks=ranks)
    _group_registry[gid] = g
    return g


def _check(name, group, *tensors):
    """Raise on a backend / device pairing that cannot run ``name``."""
    backend = dist.get_backend(group.process_group)
    for t in tensors:
        if t is None:
            continue
        if backend == "nccl" and not t.is_cuda:
            raise ValueError(f"{name}: the NCCL group takes CUDA tensors, "
                             f"got one on {t.device}")
        if backend == "gloo" and t.is_cuda and name in _GLOO_CUDA_REFUSED:
            raise NotImplementedError(
                f"{name}: gloo does not carry point-to-point transfers of "
                f"CUDA tensors; run it on a NCCL group")


def _done(work, sync_op, result):
    if sync_op:
        if work is not None:
            work.wait()
        return result
    return P2PTask(result, work=work)


def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    """Reduce ``tensor`` over the group, in place on every rank. ``AVG`` is
    the sum divided by the group's size."""
    g = _get_group(group)
    _check("all_reduce", g, tensor)
    if op not in _TORCH_OP:
        raise ValueError(op)
    work = dist.all_reduce(tensor, op=_TORCH_OP[op], group=g.process_group,
                           async_op=True)
    if op == ReduceOp.AVG:
        work.wait()
        tensor.div_(g.size_like(tensor))
        work = None
    return _done(work, sync_op, tensor)


def all_gather(tensor_list: Optional[List], tensor,
               group: Optional[Group] = None, sync_op=True):
    """Every rank's ``tensor``: appended to ``tensor_list`` in rank order,
    or returned stacked as (nranks, ...) when ``tensor_list`` is None."""
    g = _get_group(group)
    _check("all_gather", g, tensor)
    tensor = tensor.contiguous()
    flat = torch.empty(g.nranks * tensor.numel(), dtype=tensor.dtype,
                       device=tensor.device)
    dist.all_gather_into_tensor(flat, tensor.reshape(-1),
                                group=g.process_group)
    out = flat.view((g.nranks,) + tuple(tensor.shape))
    if tensor_list is not None:
        tensor_list.extend(out.unbind(0))
        return tensor_list
    return out


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op=True):
    """This rank's payload, (nranks, chunk...) or a list of nranks chunks,
    row j for rank j; ``tensor`` (chunk...) receives the reduction of
    every rank's row for this rank (a new tensor when it is None)."""
    g = _get_group(group)
    inp = tensor_or_tensor_list
    if isinstance(inp, (list, tuple)):
        inp = torch.stack(list(inp), 0)
    _check("reduce_scatter", g, inp, tensor)
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.AVG):
        raise ValueError(op)
    out = tensor if tensor is not None else torch.empty(
        tuple(inp.shape[1:]), dtype=inp.dtype, device=inp.device)
    dist.reduce_scatter_tensor(out.view(-1), inp.contiguous().view(-1),
                               op=_TORCH_OP[op], group=g.process_group)
    if op == ReduceOp.AVG:
        out.div_(g.size_like(out))
    return out


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op=True):
    """Rank ``src``'s tensor onto every rank, in place."""
    g = _get_group(group)
    _check("broadcast", g, tensor)
    work = dist.broadcast(tensor, g.ranks[src], group=g.process_group,
                          async_op=True)
    return _done(work, sync_op, tensor)


def all_to_all(out_tensor_list, in_tensor_list, group: Optional[Group] = None,
               sync_op=True):
    """Row j of this rank's payload goes to rank j; row i of the result
    came from rank i. Appended to ``out_tensor_list``, or returned stacked
    when it is not a list."""
    g = _get_group(group)
    inp = (list(in_tensor_list) if isinstance(in_tensor_list, (list, tuple))
           else list(in_tensor_list.unbind(0)))
    _check("all_to_all", g, *inp)
    # one exchange of the stacked payload (gloo has no list form)
    stacked = torch.stack(inp, 0)
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=g.process_group)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(out.unbind(0))
        return out_tensor_list
    return out


alltoall = all_to_all


def scatter(tensor, tensor_list=None, src=0, group: Optional[Group] = None,
            sync_op=True):
    """Rank ``src``'s ``tensor_list[r]`` into rank r's ``tensor``."""
    g = _get_group(group)
    _check("scatter", g, tensor)
    mine = g.rank == src
    parts = [t.contiguous() for t in tensor_list] if mine else None
    dist.scatter(tensor, parts, src=g.ranks[src], group=g.process_group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction over the group lands in rank ``dst``'s ``tensor``."""
    g = _get_group(group)
    _check("reduce", g, tensor)
    if op not in _TORCH_OP:
        raise ValueError(op)
    work = dist.reduce(tensor, g.ranks[dst], op=_TORCH_OP[op],
                       group=g.process_group, async_op=True)
    work.wait()
    if op == ReduceOp.AVG and g.rank == dst:
        tensor.div_(g.size_like(tensor))
    return tensor


def barrier(group=None):
    g = _get_group(group)
    _check("barrier", g)
    if dist.get_backend(g.process_group) == "nccl":
        dist.barrier(group=g.process_group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=g.process_group)


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else 0


def is_initialized() -> bool:
    return dist.is_initialized()


def destroy_process_group(group=None):
    global _default_group
    if group is None:
        _default_group = None
        _group_registry.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
    else:
        dist.destroy_process_group(group.process_group)


# ---------------------------------------------------------------------------
# Point-to-point: real sends and receives between two ranks (the reference
# pairs a send with a recv inside one program).
# ---------------------------------------------------------------------------
class P2PTask:
    """An asynchronous operation's handle: ``wait()`` returns its result."""

    def __init__(self, result=None, *, work=None):
        self.result = result
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self.result

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _peer(group, rank):
    g = _get_group(group)
    return g, g.ranks[rank]


def send(tensor, dst=0, group=None, sync_op=True):
    g, peer = _peer(group, dst)
    _check("send", g, tensor)
    dist.send(tensor.contiguous(), peer, group=g.process_group)


def recv(tensor, src=0, group=None, sync_op=True):
    g, peer = _peer(group, src)
    _check("recv", g, tensor)
    dist.recv(tensor, peer, group=g.process_group)
    return tensor


def isend(tensor, dst=0, group=None):
    g, peer = _peer(group, dst)
    _check("isend", g, tensor)
    return P2PTask(None, work=dist.isend(tensor, peer, group=g.process_group))


def irecv(tensor, src=0, group=None):
    g, peer = _peer(group, src)
    _check("irecv", g, tensor)
    return P2PTask(tensor, work=dist.irecv(tensor, peer,
                                          group=g.process_group))


class P2POp:
    """One half of a transfer (``isend`` or ``irecv``) with its peer."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp op must be isend/irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Issue every transfer of the list together; one completed task an
    op, in list order (a receive's task returns its tensor)."""
    ops = []
    for o in p2p_op_list:
        g, peer = _peer(o.group, o.peer)
        _check("batch_isend_irecv", g, o.tensor)
        fn = dist.isend if o.op in (isend, send) else dist.irecv
        ops.append(dist.P2POp(fn, o.tensor, peer, group=g.process_group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [P2PTask(o.tensor if o.op in (irecv, recv) else None)
            for o in p2p_op_list]
