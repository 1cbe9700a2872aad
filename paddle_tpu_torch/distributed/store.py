"""Rendezvous key-value stores (``paddle_tpu/distributed/store.py``).

Two implementations share one contract (``_StoreOps`` holds the derived
ops — ticketed lists, barrier — over the set/get/try_get/add/wait
primitives):

  * :class:`TCPStore` — the cross-host store, built on
    ``torch.distributed.TCPStore`` (the JAX package builds its own native
    one; the port needs no library of its own);
  * :class:`MemoryStore` — an in-process stand-in with the same surface
    (dict + condition variable, no sockets), so single-process consumers
    — the serving-fleet registry (``inference/fleet.py``), tests — run the
    same registration/lease code a multi-host deployment runs on the
    TCPStore.

Both plant the ``store.set`` / ``store.get`` / ``store.add`` /
``store.wait`` fault sites (``reliability/faults.py``); the TCPStore adds
``store.connect`` and runs connect, get and wait under bounded retry.
"""

from __future__ import annotations

import threading
import time
from datetime import timedelta
from typing import Optional

from ..reliability import faults
from ..reliability.retry import RetryError, RetryPolicy


class _StoreOps:
    """Derived store operations over the set/get/try_get/add/wait
    primitives — shared verbatim by TCPStore and MemoryStore so the
    lost-update-free idioms (ticketed lists, generation barriers) can
    never diverge between the cross-host and in-process stores."""

    world_size: int = 1

    # -- append-only ticketed lists ---------------------------------------
    def ticket_append(self, key: str, value) -> int:
        """Lost-update-free list append: take a ticket from the atomic
        counter at ``{key}/n``, then write the value under
        ``{key}/{ticket}``. Returns the 1-based ticket. Two concurrent
        appends can never drop each other's entry — serving-fleet replica
        registration (``inference/fleet.py``) rides this."""
        ticket = int(self.add(f"{key}/n", 1))
        self.set(f"{key}/{ticket}", value)
        return ticket

    def ticket_list(self, key: str) -> list:
        """Read the append-only list at ``key`` (see ticket_append) as a
        list of bytes values in ticket order. A ticket whose value is not
        yet written (its writer is between ``add`` and ``set``) is
        skipped; it appears on the next read."""
        n = int(self.add(f"{key}/n", 0))
        out = []
        for i in range(1, n + 1):
            v = self.try_get(f"{key}/{i}")
            if v is not None:
                out.append(v)
        return out

    # -- sync --------------------------------------------------------------
    def barrier(self, name: str = "barrier") -> None:
        """All world_size participants block until everyone arrives."""
        n = self.add(f"__{name}__count", 1)
        gen = (n - 1) // self.world_size
        target = (gen + 1) * self.world_size
        if n == target:
            self.set(f"__{name}__release_{gen}", b"1")
        self.wait(f"__{name}__release_{gen}")


class MemoryStore(_StoreOps):
    """In-process TCPStore stand-in: the same kv/counter/wait surface
    backed by a dict and a condition variable — no sockets.

    Single-process fleets (``inference/fleet.py``'s in-process replicas)
    and tests use this, so registration/lease/gossip code is written ONCE
    against the store contract and runs unchanged on the TCPStore in a
    multi-host deployment. The same ``store.*`` fault sites are planted so
    chaos drills exercise the in-process store identically."""

    def __init__(self, world_size: int = 1, timeout: float = 60.0):
        self.world_size = world_size
        self.timeout = timeout
        self._kv: dict = {}
        self._cv = threading.Condition()

    @staticmethod
    def _enc(value) -> bytes:
        return value.encode() if isinstance(value, str) else bytes(value)

    def set(self, key: str, value) -> None:
        faults.maybe_fail("store.set", key=key)
        with self._cv:
            self._kv[key] = self._enc(value)
            self._cv.notify_all()

    def get(self, key: str) -> bytes:
        faults.maybe_fail("store.get", key=key)
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._kv,
                                     timeout=self.timeout):
                raise TimeoutError(f"MemoryStore.get({key!r}) timed out")
            return self._kv[key]

    def try_get(self, key: str):
        """Non-blocking get: value bytes, or None when absent."""
        with self._cv:
            return self._kv.get(key)

    def add(self, key: str, delta: int = 1) -> int:
        faults.maybe_fail("store.add", key=key)
        with self._cv:
            val = int(self._kv.get(key, b"0") or b"0") + delta
            self._kv[key] = str(val).encode()
            self._cv.notify_all()
            return val

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        if isinstance(keys, str):
            keys = [keys]
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        for k in keys:
            faults.maybe_fail("store.wait", key=k)
            with self._cv:
                if not self._cv.wait_for(
                        lambda: k in self._kv,
                        timeout=max(0.0, deadline - time.monotonic())):
                    raise TimeoutError(f"MemoryStore.wait({k!r}) timed out")


class TCPStore(_StoreOps):
    """The cross-host store on ``torch.distributed.TCPStore``, with the
    JAX package's surface: ``set``, ``get`` (blocking), ``try_get`` (None
    when absent), ``add``, ``wait`` with a timeout in seconds, and the
    ticketed lists and barrier of ``_StoreOps``.

    ``is_master=True`` serves the store (``port=0`` picks a free port,
    read back from ``.port``) and connects to it. Non-blocking ops share
    the client connection under a lock; the blocking ones (``get``,
    ``wait``) open a connection of their own, so they cannot wedge
    concurrent users. Connect, get and wait retry under ``retry_policy``
    (default: bounded by ``timeout``); ``add`` is never retried, since a
    retry after a lost acknowledgement would count twice. Exhaustion
    surfaces as ``TimeoutError``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 900.0, retry_policy=None):
        self.world_size = world_size
        self.timeout = timeout
        self.host, self.port = host, port
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=max(2, int(timeout / 0.2)),
                        base_delay_s=0.2, max_delay_s=1.0, multiplier=1.0,
                        jitter=0.0, deadline_s=timeout, name="store")
        if is_master:
            import torch.distributed as dist

            # the master serves the store and is a client of it
            try:
                self._conn = dist.TCPStore(
                    host, port, None, True,
                    timeout=timedelta(seconds=timeout),
                    wait_for_workers=False)
            except Exception as e:
                raise OSError(f"TCPStore: cannot serve on port {port}: "
                              f"{e}") from e
            self.port = int(self._conn.port)
        else:
            self._conn = self._retry_call(self._connect_once)
        self._conn_lock = threading.Lock()

    def _retry_call(self, fn, *args):
        """Run under the store's policy; exhaustion surfaces as
        TimeoutError, never a bare RetryError."""
        try:
            return self._retry.call(fn, *args)
        except RetryError as e:
            raise TimeoutError(str(e)) from e.__cause__

    def _connect_once(self, timeout: Optional[float] = None):
        import torch.distributed as dist

        faults.maybe_fail("store.connect", host=self.host, port=self.port)
        try:
            return dist.TCPStore(
                self.host, self.port, None, False,
                timeout=timedelta(seconds=self.timeout if timeout is None
                                  else timeout))
        except dist.DistError as e:
            raise TimeoutError(
                f"TCPStore: cannot reach {self.host}:{self.port}: "
                f"{e}") from e

    # -- kv ------------------------------------------------------------------
    def set(self, key: str, value) -> None:
        faults.maybe_fail("store.set", key=key)
        if isinstance(value, str):
            value = value.encode()
        with self._conn_lock:
            self._conn.set(key, bytes(value))

    def get(self, key: str) -> bytes:
        import torch.distributed as dist

        def _get_once():
            faults.maybe_fail("store.get", key=key)
            conn = self._connect_once()
            try:
                return bytes(conn.get(key))
            except dist.DistError as e:
                raise TimeoutError(
                    f"TCPStore.get({key!r}) timed out: {e}") from e

        return self._retry_call(_get_once)

    def try_get(self, key: str):
        """Non-blocking get: value bytes, or None when absent."""
        with self._conn_lock:
            if not self._conn.check([key]):
                return None
            return bytes(self._conn.get(key))

    def add(self, key: str, delta: int = 1) -> int:
        faults.maybe_fail("store.add", key=key)
        with self._conn_lock:
            return int(self._conn.add(key, int(delta)))

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        import torch.distributed as dist

        if isinstance(keys, str):
            keys = [keys]
        wait_s = self.timeout if timeout is None else timeout

        def _gate_and_connect(k):
            faults.maybe_fail("store.wait", key=k)
            return self._connect_once()

        deadline = time.monotonic() + wait_s
        for k in keys:
            # the gate and the connection retry; the wait itself does
            # not: a key that never came within ``timeout`` is the answer
            conn = self._retry_call(_gate_and_connect, k)
            left = max(0.001, deadline - time.monotonic())
            try:
                conn.wait([k], timedelta(seconds=left))
            except dist.DistError as e:
                raise TimeoutError(
                    f"TCPStore.wait({k!r}) timed out: {e}") from e
