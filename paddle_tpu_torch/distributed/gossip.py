"""Lease-board gossip: per-member heartbeat leases with piggybacked state
(the port's own copy of ``paddle_tpu/distributed/gossip.py``).

Liveness is a per-member key the member overwrites on a timer, and every
reader compares the writer's wall-clock stamp against its own — no shared
read-modify-write, so members can never drop each other's state. The
board runs over any store with the TCPStore surface
(``distributed/store.py``: ``TCPStore`` cross-host, ``MemoryStore``
in-process), and the lease VALUE is a JSON payload, so each beat also
gossips a small state digest — queue depth, active slots, drain state,
the radix-tree page-hash digest — and readers get liveness and routing
state from one key read (``inference/fleet.py``).

Clock contract: freshness compares the writer's wall clock (``"t"`` in the
payload) against the reader's, so cross-host skew eats into the TTL — keep
hosts NTP-synced and the TTL above the fleet's worst skew. In-process
(MemoryStore) the clocks are one clock and the contract is exact.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence


class LeaseBoard:
    """Per-member heartbeat leases under `{prefix}/{member}` on a store.

    `beat` stamps and overwrites the member's lease; `read`/`read_all`
    return decoded payloads (with `age_s` derived at read time);
    `alive` filters members whose lease is fresher than `ttl`. A lease
    that never existed, fails to decode, or has stopped refreshing
    simply drops out — there is nothing to clean up, which is what makes
    SIGKILL indistinguishable from a network partition to every reader."""

    def __init__(self, store, prefix: str, ttl: float):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.store = store
        self.prefix = prefix
        self.ttl = ttl

    def _key(self, member: str) -> str:
        return f"{self.prefix}/{member}"

    def beat(self, member: str, **payload) -> None:
        """Refresh `member`'s lease, gossiping `payload` with it. One
        store write; the stamp is taken here so a delayed write shortens
        the lease rather than extending it."""
        payload = dict(payload, t=time.time())
        self.store.set(self._key(member), json.dumps(payload))

    def read(self, member: str, now: Optional[float] = None
             ) -> Optional[dict]:
        """Decoded lease payload with `age_s` added, or None (absent or
        undecodable — an undecodable lease counts as dead, not as an
        error: a torn write must read like a missed beat)."""
        raw = self.store.try_get(self._key(member))
        if raw is None:
            return None
        try:
            lease = json.loads(raw.decode())
            lease["age_s"] = (time.time() if now is None else now) \
                - float(lease["t"])
        except Exception:
            return None
        return lease

    def read_all(self, members: Sequence[str]) -> Dict[str, dict]:
        now = time.time()
        out = {}
        for m in members:
            lease = self.read(m, now=now)
            if lease is not None:
                out[m] = lease
        return out

    def fresh(self, lease: Optional[dict]) -> bool:
        return lease is not None and lease["age_s"] <= self.ttl

    def alive(self, members: Sequence[str]) -> List[str]:
        return [m for m, lease in self.read_all(members).items()
                if self.fresh(lease)]
