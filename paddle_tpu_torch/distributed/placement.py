"""Placement types (``paddle_tpu/distributed/placement.py``): ``Shard``,
``Replicate``, ``Partial``, and the port's own ``PartitionSpec``.

The JAX package's ``PartitionSpec`` is ``jax.sharding.PartitionSpec``; the
port's is a plain tuple of per-dimension entries (``None``, an axis name or
a tuple of names), so ``zero_sharding_plan`` returns the same specs without
JAX. ``placements_to_spec`` / ``spec_to_placements`` are the reference's
conversions over a ``mesh.ProcessMesh``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class PartitionSpec(tuple):
    """Per-tensor-dimension mesh axes: ``PartitionSpec(None, "dp")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return (isinstance(other, Partial)
                and other.reduce_type == self.reduce_type)

    def __hash__(self):
        return hash(("Partial", self.reduce_type))


def placements_to_spec(mesh, placements: Sequence[Placement], ndim: int
                       ) -> PartitionSpec:
    """placements[i] describes mesh dim i (paddle convention). Build a
    PartitionSpec over tensor dims."""
    entries: List[Optional[list]] = [None] * ndim
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            if entries[p.dim] is None:
                entries[p.dim] = []
            entries[p.dim].append(mesh.dim_names[mesh_dim])
    spec = []
    for e in entries:
        if e is None:
            spec.append(None)
        elif len(e) == 1:
            spec.append(e[0])
        else:
            spec.append(tuple(e))
    return PartitionSpec(*spec)


def spec_to_placements(mesh, spec: PartitionSpec, ndim: int
                       ) -> List[Placement]:
    placements: List[Placement] = [Replicate() for _ in mesh.dim_names]
    for tdim, entry in enumerate(tuple(spec)
                                 + (None,) * (ndim - len(tuple(spec)))):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for n in names:
            placements[mesh.dim_names.index(n)] = Shard(tdim)
    return placements
