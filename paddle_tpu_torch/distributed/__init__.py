"""paddle_tpu_torch.distributed — data parallelism and ZeRO over
``torch.distributed``, one process a rank.

The JAX package (``paddle_tpu/distributed``) is single-controller: one
program drives N devices, and a collective takes a "local-shard view"
whose leading axis enumerates the ranks. PyTorch has no single controller
over N GPUs, so the port runs one process a rank, as upstream Paddle does
(``python/paddle/distributed/parallel.py``), started by
``python -m paddle_tpu_torch.distributed.launch``. Every parity test and
the chip check read the two through one mapping:

  * collectives: row r of the reference's local-shard view is rank r's
    tensor in the port;
  * batches: the reference's global batch is the concatenation of the
    ranks' local batches, in rank order;
  * results: the reference's parameters after a step equal every port
    rank's parameters, gathered where they are sharded (ZeRO stage 3).

Ported here: ``env`` (``init_parallel_env``), ``mesh``, ``placement``,
``collective``, ``data_parallel`` (``GradReducer``, ``DataParallel``),
``sharding`` (ZeRO stages 1-3), ``topology``, ``fleet`` (dp, sharding,
sep and mp degrees), ``launch`` (one node), tensor and sequence
parallelism (``overlap``, ``mp_layers``, ``tensor_parallel``,
``sequence_parallel``), beside ``store``, ``gossip`` and ``recompute``.
Under tensor parallelism rank r holds its shard of each cut parameter:
the reference's parameter is the ranks' shards concatenated along the cut
dim in mp-rank order. The DTensor surface (``api.py``), sharded
checkpoints, pipeline / expert / context parallelism and elastic runs are
later slices.
"""

from . import fleet  # noqa: F401
from .collective import (  # noqa: F401
    Group, P2POp, P2PTask, ReduceOp, all_gather, all_reduce, all_to_all,
    alltoall, barrier, batch_isend_irecv, broadcast, destroy_process_group,
    irecv, is_initialized, isend, new_group, recv, reduce, reduce_scatter,
    scatter, send)
from .data_parallel import DataParallel  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env  # noqa: F401
from .mesh import ProcessMesh, get_mesh, init_mesh, set_mesh  # noqa: F401
from .placement import Partial, Placement, Replicate, Shard  # noqa: F401
from .recompute import recompute  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model, zero_sharding_plan)
from .tensor_parallel import TensorParallel  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, create_hybrid_group,
    get_hybrid_communicate_group)
