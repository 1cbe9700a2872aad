"""Environment bootstrap (``paddle_tpu/distributed/env.py``): one process a
rank.

``init_parallel_env`` reads what the launcher (``distributed/launch``, as
the reference's ``launch/main.py``) sets: ``PADDLE_TRAINER_ID`` (the rank),
``PADDLE_TRAINERS_NUM`` (the world size), ``PADDLE_MASTER`` (host:port of
rank 0's store), ``PADDLE_LOCAL_RANK`` and ``FLAGS_selected_gpus`` (the
card of this rank). It serves (rank 0) or joins the port's
``store.TCPStore`` there, starts the default ``torch.distributed`` process
group on it and builds the default mesh over the world.

The device is ``cuda:<FLAGS_selected_gpus>`` (else ``cuda:<local rank>``)
unless the caller asks for the CPU (``device="cpu"``). The backend is
explicit: NCCL for a CUDA device, gloo for the CPU; any other pairing
(gloo with CUDA tensors, e.g. two ranks on one card) is asked for by
``backend=``. Nothing is retried on another backend or device.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


class ParallelEnv:
    @property
    def rank(self):
        return (dist.get_rank() if dist.is_initialized()
                else int(os.environ.get("PADDLE_TRAINER_ID", "0")))

    @property
    def world_size(self):
        return (dist.get_world_size() if dist.is_initialized()
                else int(os.environ.get("PADDLE_TRAINERS_NUM", "1")))

    @property
    def device_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", self.local_rank))

    @property
    def dev_id(self):
        return self.device_id

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))

    @property
    def nranks(self):
        return self.world_size

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


#: the store this process serves or joins, alive as long as its group
_state = {"store": None}


def init_parallel_env(*, backend=None, device=None, store=None,
                      timeout: float = 300.0):
    """Start the default process group from the launcher's environment
    (rank 0, world 1 without one) and the default mesh over the world.
    ``device``: ``"cpu"``, or None for this rank's card. ``backend``: None
    for the device's own (NCCL / gloo). ``store``: a ``torch.distributed``
    store to use instead of serving or joining ``PADDLE_MASTER``'s."""
    from .mesh import get_mesh, init_mesh
    from .store import TCPStore

    env = ParallelEnv()
    if dist.is_initialized():
        return env
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU over gloo")
        dev = torch.device("cuda", env.device_id)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
        if dev.type != "cpu":
            raise ValueError(f"device must be None or 'cpu', got {device!r}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if store is None:
        master = os.environ.get("PADDLE_MASTER")
        if master:
            host, _, port = master.rpartition(":")
            ts = TCPStore(host, int(port), is_master=rank == 0,
                          world_size=world, timeout=timeout)
            _state["store"] = ts
            store = ts._conn
        elif world == 1:
            store = dist.HashStore()
        else:
            raise RuntimeError("PADDLE_TRAINERS_NUM > 1 needs PADDLE_MASTER "
                               "(set by the launcher) or a store")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout), **kw)
    if get_mesh() is None or get_mesh().size != world:
        init_mesh()
    return env


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size
