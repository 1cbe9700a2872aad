"""fleet (``paddle_tpu/distributed/fleet/__init__.py``): the collective
front end, one process a rank.

``fleet.init(strategy=...)`` starts the process group
(``env.init_parallel_env``; port-only ``device``, ``backend``, ``store``
pass through) and the hybrid group of ``strategy.hybrid_configs``;
``distributed_model`` wraps the model by parallel mode: data ->
``DataParallel`` (``sharding_configs["comm_buffer_size_MB"]`` a bucket),
sharding -> ``group_sharded_parallel`` at ``sharding_configs["stage"]``
(1 ``os``, 2 ``os_g``, 3 ``p_g_os``) over the sharding group; hybrid (an mp
or sep degree above 1) -> ``TensorParallel`` (the model holds its shards
already: ``models.llama.apply_llama_tensor_parallel`` or ``mp_layers``),
with a dp reducer where the dp degree is above 1;
``distributed_optimizer`` wraps the optimizer in a
``HybridParallelOptimizer`` and gives it the model's ZeRO plan. The
parameter-server role makers and the data generators are not ported.
"""

from __future__ import annotations

from typing import Optional

from ...nn.layer import Layer
from ..data_parallel import DataParallel
from ..env import init_parallel_env
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        create_hybrid_group, get_hybrid_communicate_group)

_STAGE_LEVEL = {1: "os", 2: "os_g", 3: "p_g_os"}


class DistributedStrategy:
    """The reference's strategy fields this slice reads: ``hybrid_configs``
    (degrees) and ``sharding_configs`` (bucket MB, ZeRO stage)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {"comm_buffer_size_MB": 25, "stage": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False


class _Fleet:
    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False
        self._plan = None

    def init(self, role_maker=None, is_collective=True, strategy=None, *,
             device=None, backend=None, store=None):
        from ...framework.contract import refuse_unported

        refuse_unported("fleet.init", role_maker=(role_maker, None),
                        is_collective=(is_collective, True))
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=device, backend=backend, store=store)
        hc = self._strategy.hybrid_configs
        self._hcg = create_hybrid_group(
            dp=hc.get("dp_degree", 1), pp=hc.get("pp_degree", 1),
            sharding=hc.get("sharding_degree", 1),
            sep=hc.get("sep_degree", 1), mp=hc.get("mp_degree", 1))
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg or get_hybrid_communicate_group()

    @property
    def worker_index(self):
        from ..env import get_rank

        return get_rank()

    @property
    def worker_num(self):
        from ..env import get_world_size

        return get_world_size()

    def is_first_worker(self):
        return self.worker_index == 0

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    def distributed_model(self, model: Layer):
        """Wrap by parallel mode (reference fleet/model.py:139-170)."""
        hcg = self.get_hybrid_communicate_group()
        if hcg is None:
            return model
        mode = hcg.get_parallel_mode()
        cfg = (self._strategy.sharding_configs
               if self._strategy is not None else {})
        if mode == "hybrid":
            from ..tensor_parallel import TensorParallel

            if hcg.get_sharding_parallel_world_size() > 1:
                raise NotImplementedError(
                    "a sharding degree beside tensor parallelism is not "
                    "ported")
            return TensorParallel(model, hcg, self._strategy)
        if mode == "data":
            return DataParallel(
                model, group=hcg.get_data_parallel_group(),
                comm_buffer_size=cfg.get("comm_buffer_size_MB", 25))
        if mode == "sharding":
            from ..sharding import group_sharded_parallel

            if hcg.get_data_parallel_world_size() > 1:
                raise NotImplementedError(
                    "data parallelism across sharding groups (dp_degree "
                    "and sharding_degree both above 1) is not ported")
            model, _, _ = group_sharded_parallel(
                model, None, _STAGE_LEVEL[int(cfg.get("stage", 1))],
                group=hcg.get_sharding_parallel_group(),
                buffer_max_size=cfg.get("comm_buffer_size_MB", 25) * 2 ** 20,
                mesh=hcg.mesh, axis="sharding")
            self._plan = model._zero_plan
            return model
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .hybrid_optimizer import HybridParallelOptimizer

        hcg = self.get_hybrid_communicate_group()
        if hcg is None or hcg.get_parallel_mode() == "single":
            return optimizer
        if self._plan is not None:
            optimizer._zero_plan = self._plan
        return HybridParallelOptimizer(optimizer, hcg,
                                       strategy or self._strategy)


fleet = _Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
Fleet = _Fleet

__all__ = ["CommunicateTopology", "DistributedStrategy", "Fleet", "fleet",
           "init", "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group"]
