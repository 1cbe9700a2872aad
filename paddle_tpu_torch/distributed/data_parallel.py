"""Data parallelism (``paddle_tpu/distributed/data_parallel.py``): the
bucketed gradient reducer and the ``DataParallel`` wrapper.

Each rank runs the whole model on its local batch; ``GradReducer`` averages
the gradients over the group. Its buckets are the reference's
(``partition``: reverse parameter order, a small first bucket, then the
target size). A bucket flushes as one asynchronous collective of its flat
buffer as soon as its last gradient is final: the
``register_post_accumulate_grad_hook`` of every parameter fires once a
backward, after every use of the parameter has been summed into ``.grad``
(a tied embedding's two uses included), and a hook that fires again in
the same step raises. Buckets flush in bucket order on every rank, so the
ranks issue the same collectives in the same order; a bucket that backward
never completes (an unused parameter, whose gradient counts as zeros) is
flushed by ``finish``, which ``jit.TrainStep`` calls after backward and
which waits for every flush before the optimizer reads a gradient. The
collective is queued on the stream of the hook that issued it, after the
gradient's producer. A bucket waits only for its parameters that require
a gradient when the step starts: a frozen one takes none, and is neither
reduced nor updated.

A flush is an all-reduce (data parallel and ZeRO stage 1), or, under ZeRO
stage 2, a reduce-scatter into each rank's block-aligned shards
(``sharding.ShardingPlan``): the full gradients are dropped as they are
copied into the bucket, and ``finish`` returns the shards. Either way the
sum is divided by the group's size.

The loss a rank computes is scaled so that this mean is the JAX package's
gradient of one program's loss over the global batch: ``TrainStep`` passes
the group to its loss function as ``count_group=``, and a "mean" reduction
of the port's losses given it divides by the group's total of valid
targets and multiplies by the group's size (``ops/loss_ops.py``); a plain
mean over equal local batches needs nothing.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist

from ..nn.layer import Layer
from ..reliability import faults
from .collective import Group, _get_group
from .mesh import ProcessMesh, get_mesh


class _Bucket:
    def __init__(self, params):
        self.params = params              # [(name, param)]
        self.live = params                # those that require a gradient
        self.ready = set()
        self.flushed = False


class GradReducer:
    """Size-targeted gradient buckets flushed during backward (see the
    module docstring). ``attach`` binds it to a model's parameters and a
    group; ``flushes`` counts the collectives it has issued."""

    def __init__(self, bucket_mb: float = 25.0, first_bucket_mb: float = 1.0):
        self.bucket_bytes = max(int(float(bucket_mb) * 2 ** 20), 1)
        self.first_bucket_bytes = max(
            int(float(first_bucket_mb) * 2 ** 20), 1)
        self.group = None
        self.plan = None
        self.flushes = 0
        self._buckets = []
        self._of = {}
        self._hooks = {}
        self._pending = []
        self._next = 0
        self._suppressed = False

    def partition(self, sized):
        """[(name, nbytes)] -> [[name]]: greedy fill to the byte target.
        The first bucket uses the smaller first-bucket target (reference
        `last_comm_buffer_size`: the last layers' grads — first to finish
        backward — flush early so comm starts ASAP)."""
        buckets, cur, cur_b = [], [], 0
        target = self.first_bucket_bytes
        for name, b in sized:
            if cur and cur_b + b > target:
                buckets.append(cur)
                cur, cur_b = [], 0
                target = self.bucket_bytes
            cur.append(name)
            cur_b += b
        if cur:
            buckets.append(cur)
        return buckets

    # ---- binding
    def attach(self, named_params, group: Group, plan=None):
        """Bucket ``named_params`` (model order) over ``group``; ``plan``
        (given at ZeRO stage 2 only) turns each flush into a reduce-scatter
        into its shards."""
        named = list(named_params)
        by_name = dict(named)
        sized = [(n, p.numel() * p.element_size()) for n, p in named[::-1]]
        self.group, self.plan = group, plan
        self._buckets = [_Bucket([(n, by_name[n]) for n in names])
                         for names in self.partition(sized)]
        for b in self._buckets:
            dtypes = {p.dtype for _, p in b.params}
            if len(dtypes) > 1:
                raise ValueError(f"a gradient bucket mixes dtypes {dtypes}")
        self._of = {id(p): b for b in self._buckets for _, p in b.params}
        return self

    def prepare(self):
        """Start a step: each bucket's live parameters (those that require
        a gradient now: a frozen one takes none, and is neither waited for
        nor reduced nor given a gradient; a bucket with none is done), a
        hook on each, no bucket ready, nothing in flight."""
        # the hooks reach the reducer through a weak reference: a
        # parameter -> hook -> reducer -> parameter cycle would keep a
        # dropped model's memory until the garbage collector runs
        me = weakref.ref(self)

        def hook(p):
            red = me()
            if red is not None:
                red._on_grad(p)

        for b in self._buckets:
            b.live = [(n, p) for n, p in b.params if p.requires_grad]
            b.ready.clear()
            b.flushed = not b.live
            for _, p in b.live:
                if id(p) not in self._hooks:
                    self._hooks[id(p)] = \
                        p.register_post_accumulate_grad_hook(hook)
        self._pending, self._next = [], 0

    @property
    def suppressing(self) -> bool:
        """Inside ``suppressed`` (``no_sync``)."""
        return self._suppressed

    @contextlib.contextmanager
    def suppressed(self):
        """No flush while inside (``no_sync``, gradient merge): neither
        from backward's hooks nor from ``finish``."""
        old, self._suppressed = self._suppressed, True
        try:
            yield
        finally:
            self._suppressed = old

    # ---- flushing
    def _on_grad(self, p):
        if self._suppressed or not self._buckets:
            return
        b = self._of[id(p)]
        if b.flushed or id(p) in b.ready:
            raise RuntimeError(
                "a gradient was accumulated again after it was final for "
                "this step (a reentrant backward?); the bucket would flush "
                "early")
        b.ready.add(id(p))
        while self._next < len(self._buckets):
            nxt = self._buckets[self._next]
            if not nxt.flushed:
                if len(nxt.ready) < len(nxt.live):
                    break
                self._flush(nxt)
            self._next += 1

    def _flush(self, b, grads=None):
        """Queue bucket ``b``'s collective over its live gradients
        (``grads``: {name: tensor}, else each ``.grad``; a missing one
        counts as zeros)."""
        faults.maybe_fail("reducer.bucket_flush",
                          bucket=self._buckets.index(b), size=len(b.live))
        gs = []
        for name, p in b.live:
            g = p.grad if grads is None else grads.get(name)
            gs.append(torch.zeros_like(p) if g is None else g)
        pg = self.group.process_group
        if self.plan is not None:
            buf, out = self.plan.scatter_buffer([n for n, _ in b.live], gs)
            work = dist.reduce_scatter_tensor(out, buf, group=pg,
                                              async_op=True)
        else:
            out = torch.cat([g.reshape(-1) for g in gs])
            work = dist.all_reduce(out, group=pg, async_op=True)
        if grads is None:   # copied: stage 2 keeps the shards, the others
            for _, p in b.live:     # point .grad into the bucket (finish)
                p.grad = None
        self._pending.append((b.live, out, work))
        b.flushed = True
        self.flushes += 1

    def _wait(self, set_grads):
        out = {}
        for live, buf, work in self._pending:
            work.wait()
            buf.div_(self.group.size_like(buf))
            if self.plan is not None:
                out.update(self.plan.unpack_shards(
                    [name for name, _ in live], buf))
                continue
            off = 0
            for name, p in live:
                g = buf[off:off + p.numel()].view(p.shape)
                off += p.numel()
                out[name] = g
                if set_grads:
                    p.grad = g
        self._pending = []
        return out

    def finish(self) -> dict:
        """After backward: flush what is left in bucket order, wait for
        every flush, and return {name: averaged gradient} (the shards under
        stage 2; under data parallel and stage 1 each ``.grad`` is also set
        to its averaged gradient). Inside ``suppressed`` it flushes
        nothing: the local gradients stay, and it returns {}."""
        if self._suppressed:
            return self._wait(set_grads=True)
        for b in self._buckets:
            if not b.flushed:
                self._flush(b)
        return self._wait(set_grads=True)

    def reduce_grads(self, grads: dict) -> dict:
        """Average a {name: gradient} set (the merged gradients of a
        gradient-merge step): one flush a bucket, in bucket order."""
        for b in self._buckets:
            if not b.flushed:
                self._flush(b, grads)
        return self._wait(set_grads=False)


def broadcast_parameters(named_params, group: Group, src: int = 0):
    """Rank ``src``'s parameters onto every rank of ``group``."""
    with torch.no_grad():
        for _, p in named_params:
            dist.broadcast(p.data, group.ranks[src],
                           group=group.process_group)


class DataParallel(Layer):
    """Wraps ``layers`` for data parallelism: rank 0's parameters are
    broadcast at wrap time, ``forward`` runs the local batch, and the
    ``GradReducer`` (buckets of ``comm_buffer_size`` MB, the first of
    ``last_comm_buffer_size``) averages the gradients under
    ``jit.TrainStep``. ``group`` or ``mesh``'s ``dp_axis`` (default: the
    default mesh's first axis) is the data-parallel group."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh: ProcessMesh = None, dp_axis="dp"):
        super().__init__()
        self._layers = layers
        self._mesh = mesh or get_mesh()
        self._dp_axis = dp_axis if self._mesh and dp_axis in \
            self._mesh.dim_names else (self._mesh.dim_names[0]
                                       if self._mesh else None)
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self._group = group if group is not None else (
            Group(self._mesh, self._dp_axis) if self._mesh is not None
            else _get_group(None))
        named = list(layers.named_parameters())
        broadcast_parameters(named, self._group)
        self._grad_reducer = GradReducer(
            bucket_mb=comm_buffer_size,
            first_bucket_mb=last_comm_buffer_size).attach(named, self._group)
        layers._grad_reducer = self._grad_reducer

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward inside accumulates local gradients with no flush (and
        the reducer's ``finish`` flushes nothing); ``jit.TrainStep``
        refuses to run inside, since it reduces every step."""
        with self._grad_reducer.suppressed():
            yield

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def parameters(self, include_sublayers=True, *, recurse=None):
        """The wrapped layers' parameters, under their own names
        (``recurse``: ``nn.Module``'s spelling of ``include_sublayers``)."""
        return self._layers.parameters(
            include_sublayers if recurse is None else recurse)

    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        return self._layers.named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def scale_loss(self, loss):
        return loss
