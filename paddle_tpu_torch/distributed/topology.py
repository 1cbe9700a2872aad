"""Hybrid topology (``paddle_tpu/distributed/topology.py``) over the dims
[data, pipe, sharding, sep, model], one process a rank.

``CommunicateTopology`` is the reference's (rank <-> coordinate, the rank
lists of each axis). ``HybridCommunicateGroup`` lays the world's ranks on
the mesh (dp, pp, sharding, sep, mp) and gives this rank its coordinate
and the ``collective.Group`` of each axis. The data, sharding, sep and
model degrees are ported (the mp axis is the fastest: ranks 2k and 2k + 1
share an mp group at mp 2); a pipe degree above 1 raises (the pipeline
schedules are a later slice of the port).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np

from .collective import Group, get_rank
from .mesh import ProcessMesh, set_mesh

_HYBRID_AXES = ["data", "pipe", "sharding", "sep", "model"]
_SHORT = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
          "model": "mp"}
_LATER = {"pipe": "the pipeline schedules"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = hybrid_group_names or list(_HYBRID_AXES)
        self._dims = dims or [1] * len(self._parallel_names)
        self.coordinate = list(itertools.product(
            *[range(d) for d in self._dims]))
        self._world_size = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self.coordinate.index(coord)

    def get_coord(self, rank):
        return self.coordinate[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self.coordinate) if c[axis] == index]

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        others = [self._parallel_names[i]
                  for i in range(len(self._parallel_names)) if i != axis]
        other_dims = [self.get_dim(n) for n in others]
        comm = []
        for combo in itertools.product(*[range(d) for d in other_dims]):
            ranks = []
            for i in range(self.get_dim(axis_name)):
                kw = dict(zip(others, combo))
                kw[axis_name] = i
                ranks.append(self.get_rank(**kw))
            comm.append(ranks)
        return comm


class HybridCommunicateGroup:
    """The mesh (dp, pp, sharding, sep, mp) over the world's ranks, this
    rank's coordinate on it, and a ``Group`` an axis."""

    def __init__(self, topology: CommunicateTopology):
        import torch.distributed as dist

        self._topo = topology
        for axis in _LATER:
            if topology.get_dim(axis) > 1:
                raise NotImplementedError(
                    f"a {axis} degree of {topology.get_dim(axis)}: "
                    f"{_LATER[axis]} is not ported yet (data, sharding, sep "
                    f"and model degrees are)")
        self.nranks = topology.world_size()
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.nranks != world:
            raise ValueError(f"the degrees cover {self.nranks} ranks, the "
                             f"world has {world}")
        self.global_rank = get_rank()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")
        dims = [self._dp_degree, self._pp_degree, self._sharding_degree,
                self._sep_degree, self._mp_degree]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        self.mesh = ProcessMesh(ids, ["dp", "pp", "sharding", "sep", "mp"])
        set_mesh(self.mesh)
        self._groups: Dict[str, Group] = {
            short: Group(self.mesh, short, gid=i)
            for i, short in enumerate(["dp", "pp", "sharding", "sep", "mp"])}
        if world > 1:
            for short in ("dp", "pp", "sharding", "sep", "mp"):
                self.mesh.process_group(short)   # every rank, same order

    # --- degrees ---
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # --- ranks: this process's coordinate ---
    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    def get_data_parallel_rank(self):
        return self._coord()[0]

    def get_pipe_parallel_rank(self):
        return self._coord()[1]

    def get_sharding_parallel_rank(self):
        return self._coord()[2]

    def get_sep_parallel_rank(self):
        return self._coord()[3]

    def get_model_parallel_rank(self):
        return self._coord()[4]

    def get_stage_id(self):
        return self.get_pipe_parallel_rank()

    # --- groups ---
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_check_parallel_group(self, sharding=False):
        return self._groups["mp"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_sep_parallel_group_src_rank(self):
        return self._groups["sep"].ranks[0]

    def get_parallel_mode(self):
        if self._mp_degree > 1 or self._pp_degree > 1 or self._sep_degree > 1:
            return "hybrid"
        if self._sharding_degree > 1:
            return "sharding"
        if self._dp_degree > 1:
            return "data"
        return "single"

    def topology(self):
        return self._topo

    def is_first_stage(self):
        return self.get_pipe_parallel_rank() == 0

    def is_last_stage(self):
        return self.get_pipe_parallel_rank() == self._pp_degree - 1


_hcg: Optional[HybridCommunicateGroup] = None


def create_hybrid_group(dp=1, pp=1, sharding=1, sep=1, mp=1
                        ) -> HybridCommunicateGroup:
    global _hcg
    topo = CommunicateTopology(list(_HYBRID_AXES), [dp, pp, sharding, sep, mp])
    _hcg = HybridCommunicateGroup(topo)
    return _hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
