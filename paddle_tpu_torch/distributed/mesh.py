"""ProcessMesh (``paddle_tpu/distributed/mesh.py``): ranks laid out on
named axes.

The mesh logic is the JAX package's, over numpy alone. Its ids are global
ranks of the default process group (one process a rank). The JAX package's
``jax_mesh()`` has no counterpart; in its place ``process_group(dim_name)``
builds, once, the ``torch.distributed`` groups of one axis (every rank
creates every group of the axis, as ``new_group`` requires) and returns
the one this rank belongs to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class ProcessMesh:
    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh if process_ids is None else process_ids)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self._process_ids = arr
        self._shape = list(arr.shape)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._groups = {}

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._process_ids.reshape(-1).tolist()

    @property
    def size(self):
        return int(self._process_ids.size)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def get_mesh_with_dim(self, name, index=None):
        axis = self._dim_names.index(name)
        if index is None:
            order = [axis] + [i for i in range(self.ndim) if i != axis]
            ids = np.transpose(self._process_ids, order)
            names = [name] + [n for n in self._dim_names if n != name]
            return ProcessMesh(ids, names)
        ids = np.take(self._process_ids, index, axis=axis)
        names = [n for n in self._dim_names if n != name]
        return ProcessMesh(ids, names or None)

    def axis_ranks(self, dim_name) -> List[List[int]]:
        """The rank lists along ``dim_name``, one for every position on the
        other axes, in row-major order of those positions."""
        axis = self._dim_names.index(dim_name)
        moved = np.moveaxis(self._process_ids, axis, -1)
        return [list(map(int, row))
                for row in moved.reshape(-1, self._shape[axis])]

    def process_group(self, dim_name):
        """The ``torch.distributed`` group of this rank along ``dim_name``
        (the default group where the axis spans the whole world in rank
        order). Every rank must call it for the same axes in the same
        order: each call creates every group of the axis once."""
        import torch.distributed as dist

        if dim_name not in self._groups:
            lists = self.axis_ranks(dim_name)
            me = dist.get_rank()
            if lists == [list(range(dist.get_world_size()))]:
                self._groups[dim_name] = (dist.group.WORLD, lists[0])
            else:
                mine = None
                for ranks in lists:
                    pg = dist.new_group(ranks)
                    if me in ranks:
                        mine = (pg, ranks)
                if mine is None:
                    raise ValueError(f"rank {me} is not in {self}")
                self._groups[dim_name] = mine
        return self._groups[dim_name][0]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._dim_names == other._dim_names
                and np.array_equal(self._process_ids, other._process_ids))

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")


_global_mesh: Optional[ProcessMesh] = None


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def init_mesh(shape=None, dim_names=None) -> ProcessMesh:
    """Create (and set as default) a mesh over the world's ranks."""
    global _global_mesh
    if shape is None:
        shape = [_world_size()]
        dim_names = dim_names or ["x"]
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    _global_mesh = ProcessMesh(ids, dim_names)
    return _global_mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def set_mesh(mesh: ProcessMesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh

