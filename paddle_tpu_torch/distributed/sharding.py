"""ZeRO (group-sharded) stages 1, 2 and 3 (``paddle_tpu/distributed/
sharding.py``), one process a rank.

``zero_sharding_plan`` returns the reference's name -> ``PartitionSpec``
maps (the largest dimension the axis divides, as the JAX package picks
it). The port shards differently inside: a parameter's flat storage is cut
on 2048-element block boundaries, the quantization block of K8
(``Q8_BLOCK``). Of a parameter's nb = ceil(n / 2048) blocks, rank r owns
[r * per, (r + 1) * per) clipped to nb, per = ceil(nb / nranks): its shard
is the flat range [lo, hi) of those blocks, empty where a small parameter
has no block left for it (a rank with an empty shard skips the
parameter). Every quantization block lies on one rank, so a sharded
``AdamW8bit`` step is bitwise the unsharded one on the same gradients. For
the collectives each rank's shard is padded to ``seg`` = per * 2048
elements: the padded segments in rank order are the flat parameter
followed by zeros.

  * Stage 1 (``os``): the gradients are all-reduced by the
    ``GradReducer``; each rank updates the optimizer state and the
    parameter over its shard only, then the parameters are all-gathered
    (each lives in a padded buffer, so the gather lands in place).
  * Stage 2 (``os_g``): each bucket is reduce-scattered into the owners'
    shards (``scatter_buffer`` / ``unpack_shards``); no rank keeps a full
    gradient after its bucket's flush. The shards wait in ``plan.grads``.
  * Stage 3 (``p_g_os``): a parameter's data is its shard (a 1-D tensor).
    Every child of an ``nn.ModuleList`` (a decoder layer) is a unit: its
    forward all-gathers the unit's parameters (``_Gather``, whose backward
    reduce-scatters the gradient into the shard's ``.grad``), runs with
    them swapped in and lets them go after it. The tensors its backward
    needs are saved as keys (``saved_tensors_hooks``) and gathered again
    when backward first reads them; under the port's ``recompute`` the
    unit's forward runs again in backward, gather included, so no hook is
    needed there. The other parameters (embedding, final norm, LM head)
    are gathered once a step by ``begin_step`` and held until ``end_step``.
    Under ``jit.TrainStep`` (``prefetch``) a unit's first forward of a step
    also starts the asynchronous all-gather of the next unit's shards
    (``overlap.zero_prefetch``, with the ``zero_prefetch`` and
    ``collective_matmul`` flags on), so the next unit's forward waits for
    a gather already in flight; the bytes gathered are the same.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..framework.contract import refuse_unported
from ..nn.layer import Layer
from ..ops.kernels.fused_optimizer_update import Q8_BLOCK
from .collective import Group
from .mesh import ProcessMesh, get_mesh
from .placement import PartitionSpec

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def _shard_spec_for(shape, axis: str, axis_size: int) -> PartitionSpec:
    """Pick the largest dim divisible by the axis size; replicate scalars and
    indivisible shapes (matching the reference's per-param rank assignment
    falling back to replication for small tensors)."""
    if not shape:
        return PartitionSpec()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec = [None] * len(shape)
            spec[i] = axis
            return PartitionSpec(*spec)
    return PartitionSpec()


def zero_sharding_plan(model: Layer, mesh: ProcessMesh, stage: int,
                       axis: str = "dp") -> Dict[str, Dict[str, PartitionSpec]]:
    """Build {'params': .., 'grads': .., 'opt': ..} name->PartitionSpec maps."""
    axis_size = mesh.get_dim_size(axis)
    param_specs, grad_specs, opt_specs = {}, {}, {}
    for name, p in model.named_parameters():
        sharded = _shard_spec_for(tuple(p.shape), axis, axis_size)
        opt_specs[name] = sharded
        grad_specs[name] = sharded if stage >= 2 else PartitionSpec()
        param_specs[name] = sharded if stage >= 3 else PartitionSpec()
    return {"params": param_specs, "grads": grad_specs, "opt": opt_specs,
            "axis": axis, "stage": stage}


def block_shard(numel: int, nranks: int, rank: int):
    """(lo, hi, seg): rank ``rank``'s flat range of a ``numel``-element
    parameter cut on ``Q8_BLOCK`` boundaries, and the padded segment
    length every rank's shard takes in a collective."""
    nb = -(-int(numel) // Q8_BLOCK)
    per = -(-nb // nranks)
    b0 = min(rank * per, nb)
    b1 = min(b0 + per, nb)
    n = int(numel)
    return min(b0 * Q8_BLOCK, n), min(b1 * Q8_BLOCK, n), per * Q8_BLOCK


class _Layout:
    def __init__(self, shape, numel, lo, hi, seg):
        self.shape, self.numel = tuple(shape), int(numel)
        self.lo, self.hi, self.seg = lo, hi, seg


class _Gather(torch.autograd.Function):
    """A stage-3 parameter's full value from the shards; its backward
    reduce-scatters the gradient into the shard."""

    @staticmethod
    def forward(ctx, shard, plan, name):
        ctx.plan, ctx.name = plan, name
        return plan._gather_padded(name)[:plan.layouts[name].numel].view(
            plan.layouts[name].shape)

    @staticmethod
    def backward(ctx, g):
        plan, name = ctx.plan, ctx.name
        plan._saved.pop(name, None)
        return plan._scatter_grad(name, g), None, None


class ShardingPlan:
    """The ZeRO plan of one model: the reference's specs, and the port's
    block-aligned shards over ``group`` (see the module docstring)."""

    def __init__(self, mesh: ProcessMesh, specs: dict, *, group=None,
                 named_params=()):
        self.mesh = mesh
        self.specs = specs
        self.stage = int(specs.get("stage", 1))
        self.group = group
        self.params = dict(named_params)
        self.grads = {}
        w, r = (group.nranks, group.rank) if group is not None else (1, 0)
        self.layouts = {n: _Layout(p.shape, p.numel(),
                                   *block_shard(p.numel(), w, r))
                        for n, p in self.params.items()}
        self._padded = {}
        self._saved = {}
        self._alias = {}
        self._root = []
        self._swapped = []
        self._units = []            # each unit's parameter names, in order
        self._first_done = set()    # units whose first forward ran
        self._prefetched = {}       # name -> (work, buffer) in flight
        self.prefetch = False
        self.prefetches = 0         # gathers started ahead of their unit

    # ---- shards
    def shard_range(self, name):
        """(lo, hi): this rank's flat range of ``name``."""
        lay = self.layouts[name]
        return lay.lo, lay.hi

    def param_shard(self, name, p):
        """This rank's shard of ``p`` as a flat contiguous view of its data
        (stage 3: the data itself)."""
        if self.stage >= 3:
            return p.data
        lay = self.layouts[name]
        return p.data.view(-1)[lay.lo:lay.hi]

    def grad_shard(self, name, g):
        """This rank's shard of a gradient: sliced from a full one (stage
        1), as it is otherwise."""
        if self.stage >= 2:
            return g
        lay = self.layouts[name]
        return g.reshape(-1)[lay.lo:lay.hi]

    def scatter_buffer(self, names, grads):
        """(the flat (nranks x S) input, the (S,) output) of a stage-2
        reduce-scatter over ``names``' gradients: row r holds each
        gradient's padded segment r, in order."""
        w = self.group.nranks
        segs = [self.layouts[n].seg for n in names]
        buf = torch.zeros((w, sum(segs)), dtype=grads[0].dtype,
                          device=grads[0].device)
        off = 0
        for g, seg in zip(grads, segs):
            flat = g.reshape(-1)
            for r in range(w):
                part = flat[r * seg:(r + 1) * seg]
                buf[r, off:off + part.numel()] = part
            off += seg
        return buf.view(-1), torch.empty(sum(segs), dtype=buf.dtype,
                                         device=buf.device)

    def unpack_shards(self, names, out):
        """{name: shard gradient} from a stage-2 reduce-scatter's output;
        kept in ``grads`` for the optimizer."""
        got, off = {}, 0
        for n in names:
            lay = self.layouts[n]
            got[n] = out[off:off + lay.hi - lay.lo]
            off += lay.seg
        self.grads.update(got)
        return got

    def _padded_storage(self, name, p):
        """Move ``p``'s data into a padded buffer (stage 1/2: all of it, the
        gather's output; stage 3: the shard's segment) and point it there."""
        lay = self.layouts[name]
        w = self.group.nranks
        with torch.no_grad():
            if self.stage >= 3:
                buf = torch.zeros(lay.seg, dtype=p.dtype, device=p.device)
                buf[:lay.hi - lay.lo] = p.data.reshape(-1)[lay.lo:lay.hi]
                p.data = buf[:lay.hi - lay.lo]
            else:
                buf = torch.zeros(w * lay.seg, dtype=p.dtype,
                                  device=p.device)
                buf[:lay.numel] = p.data.reshape(-1)
                p.data = buf[:lay.numel].view(lay.shape)
        self._padded[name] = buf

    def gather_params(self):
        """Stages 1 and 2: every rank's updated shards onto every rank, in
        place (one all-gather a parameter, all in flight at once)."""
        pg, r = self.group.process_group, self.group.rank
        works = []
        for name, buf in self._padded.items():
            seg = self.layouts[name].seg
            mine = buf[r * seg:(r + 1) * seg].clone()
            works.append((dist.all_gather_into_tensor(
                buf, mine, group=pg, async_op=True), mine))
        for work, _ in works:
            work.wait()

    def _start_gather(self, name):
        """Stage 3: start the asynchronous gather of ``name``'s padded
        segments; ``_gather_padded`` waits for it."""
        seg_buf = self._padded[name]
        out = torch.empty(self.group.nranks * seg_buf.numel(),
                          dtype=seg_buf.dtype, device=seg_buf.device)
        work = dist.all_gather_into_tensor(out, seg_buf, async_op=True,
                                           group=self.group.process_group)
        self._prefetched[name] = (work, out)
        return out

    def _gather_padded(self, name):
        """Stage 3: a new (nranks x seg,) buffer of ``name``'s padded
        segments, i.e. the flat parameter then zeros (the prefetched one
        where a gather is in flight)."""
        if name not in self._prefetched:
            self._start_gather(name)
        work, out = self._prefetched.pop(name)
        work.wait()
        return out

    def _drain_prefetch(self):
        """Wait for and drop every gather still in flight."""
        for work, _ in self._prefetched.values():
            work.wait()
        self._prefetched.clear()

    def _scatter_grad(self, name, g):
        """Stage 3: the group's mean of the full gradient ``g``, this rank's
        shard of it."""
        lay = self.layouts[name]
        w = self.group.nranks
        flat = torch.zeros(w * lay.seg, dtype=g.dtype, device=g.device)
        flat[:lay.numel] = g.reshape(-1)
        out = torch.empty(lay.seg, dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, flat, group=self.group.process_group)
        out.div_(self.group.size_like(out))
        return out[:lay.hi - lay.lo]

    def full_param(self, name):
        """``name``'s full value (a new tensor) on every rank."""
        p = self.params[name]
        if self.stage < 3:
            return p.detach().clone()
        lay = self.layouts[name]
        return self._gather_padded(name)[:lay.numel].view(lay.shape).clone()

    # ---- stage 3: gather on use
    def _install_stage3(self, model):
        owner = {}
        for mod in model.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                owner[id(p)] = (mod, leaf)
        name_of = {id(p): n for n, p in self.params.items()}
        in_unit = set()
        for mod in model.modules():
            if isinstance(mod, nn.ModuleList):
                for unit in mod:
                    names = [name_of[id(p)] for p in unit.parameters()]
                    in_unit.update(names)
                    unit.forward = _unit_forward(
                        self, unit.forward,
                        [(owner[id(self.params[n])], n) for n in names],
                        len(self._units))
                    self._units.append(names)
        self._root = [(owner[id(p)], n) for n, p in self.params.items()
                      if n not in in_unit]
        for name, p in self.params.items():
            self._padded_storage(name, p)

    def begin_step(self):
        """Stage 3: gather the parameters outside every unit for this
        step's forward and backward (``jit.TrainStep`` calls it around
        both; a no-op at the other stages)."""
        if self.stage >= 3 and not self._swapped:
            self._first_done.clear()
            self._swapped = _swap(self, self._root)

    def end_step(self):
        """Put the root's shard parameters back after backward."""
        self._drain_prefetch()
        if self._swapped:
            _restore(self._swapped)
            self._swapped = []

    # ---- saved-tensor hooks of a unit's forward
    def _pack(self, t):
        if t.numel():
            name = self._alias.get(t.untyped_storage().data_ptr())
            if name is not None:
                return (name, t.size(), t.stride(), t.storage_offset())
        return t

    def _unpack(self, x):
        if not isinstance(x, tuple):
            return x
        name, size, stride, offset = x
        full = self._saved.get(name)
        if full is None:
            full = self._saved[name] = self._gather_padded(name)
        return full.as_strided(size, stride, offset)


def _swap(plan, entries):
    """Gather each (module, leaf)'s parameter and put the full tensor in
    its place; returns what ``_restore`` puts back."""
    out = []
    for (mod, leaf), name in entries:
        p = mod._parameters[leaf]
        mod._parameters[leaf] = _Gather.apply(p, plan, name)
        out.append((mod, leaf, p, name))
    return out


def _restore(swapped):
    for mod, leaf, p, _ in swapped:
        mod._parameters[leaf] = p


def _unit_forward(plan, forward, entries, index):
    """Unit ``index``'s forward with its parameters gathered and swapped in
    (see the module docstring); its first forward of a step prefetches
    the next unit's (``plan.prefetch``)."""
    from . import overlap
    from .recompute import recomputing

    def run(*args, **kwargs):
        swapped = _swap(plan, entries)
        if plan.prefetch and index not in plan._first_done:
            plan._first_done.add(index)
            if index + 1 < len(plan._units):
                overlap.zero_prefetch(plan._units[index + 1], plan)
        try:
            if recomputing():
                return forward(*args, **kwargs)
            for mod, leaf, _, name in swapped:
                t = mod._parameters[leaf]
                if t.numel():
                    plan._alias[t.untyped_storage().data_ptr()] = name
            try:
                with torch.autograd.graph.saved_tensors_hooks(
                        plan._pack, plan._unpack):
                    return forward(*args, **kwargs)
            finally:
                plan._alias.clear()
        finally:
            _restore(swapped)

    return run


def group_sharded_parallel(model: Layer, optimizer=None, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False,
                           mesh: Optional[ProcessMesh] = None,
                           axis: str = "dp"):
    """ZeRO ``level`` ("os", "os_g", "p_g_os") over ``group`` (default: the
    mesh's ``axis``, else its first). Broadcasts rank 0's parameters,
    attaches the plan (``model._zero_plan``, ``optimizer._zero_plan``) and,
    for stages 1 and 2, a ``GradReducer`` (``buffer_max_size`` bytes a
    bucket); stage 3 shards the parameters now. Returns (model, optimizer,
    scaler). Offload is not ported."""
    from .data_parallel import GradReducer, broadcast_parameters

    refuse_unported("group_sharded_parallel", offload=(offload, False))
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {list(_LEVELS)}, got {level}")
    stage = _LEVELS[level]
    mesh = mesh or get_mesh()
    if mesh is None:
        from .mesh import init_mesh

        mesh = init_mesh(None, [axis])
    if axis not in mesh.dim_names:
        axis = mesh.dim_names[0]
    g = group if group is not None else Group(mesh, axis)
    named = list(model.named_parameters())
    broadcast_parameters(named, g)
    specs = zero_sharding_plan(model, mesh, stage, axis)
    plan = ShardingPlan(mesh, specs, group=g, named_params=named)
    if stage >= 3:
        plan._install_stage3(model)
    else:
        for name, p in named:
            plan._padded_storage(name, p)
        bucket_mb = (float(buffer_max_size) / 2 ** 20
                     if buffer_max_size else 25.0)
        model._grad_reducer = GradReducer(bucket_mb=bucket_mb).attach(
            named, g, plan if stage == 2 else None)
    model._zero_plan = plan
    if optimizer is not None:   # through HybridParallelOptimizer's wrap
        getattr(optimizer, "_inner", optimizer)._zero_plan = plan
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Gather the full weights: rank 0 writes ``output + ".pdparams"``;
    with ``optimizer``, every rank writes its shard of the state (with its
    ranges) to ``output + ".rank<r>.pdopt"``."""
    plan = getattr(model, "_zero_plan", None)
    rank = plan.group.rank if plan is not None else 0
    state = {n: (plan.full_param(n) if plan is not None else p.detach())
             .cpu() for n, p in model.named_parameters()}
    if rank == 0:
        torch.save(state, output + ".pdparams")
    if optimizer is not None:
        torch.save({k: (v.cpu() if torch.is_tensor(v) else v)
                    for k, v in optimizer.state_dict().items()},
                   output + f".rank{rank}.pdopt")
