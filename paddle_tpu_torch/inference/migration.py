"""KVMigrator — the transport seam for live KV migration
(``paddle_tpu/inference/migration.py``).

Disaggregated serving moves a LIVE sequence between replicas: the source
engine parks the stream and ``export_parked`` serializes its host-tier page
blocks — K and V codes plus, on an int8 cache, the scale blocks, the
``clone_pages`` unit — together with the request's streamed-token record.
This module is the wire between that export and the destination's
``import_parked``. Two transports, one contract (the blob that arrives is
byte-identical to the blob that left):

  * ``handoff`` — in-process fleets over a MemoryStore share an address
    space, so the blob passes through by reference: zero copies.
  * ``chunked`` — the distributed shape: page blocks serialize to
    ``(dtype name, shape, raw bytes)`` and stream in chunks of
    ``kv_migration_chunk_pages`` pages, so peak wire buffering is bounded
    by the chunk. The bytes are the tensor's own
    (``t.contiguous().view(torch.uint8)``) and come back through
    ``torch.frombuffer(...).view(dtype)``, so bf16 pages round-trip with
    no numpy dtype extension.

Blocks are CPU tensors (the host arena's copies). Fault site
``kv.migrate`` (``reliability/faults.py``) fires per transfer (handoff) or
per chunk (chunked): a transport loss fails ONLY that request's migration
— the source still owns the parked stream and resumes it locally.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..framework import flags
from ..reliability import faults


def _dtype(name: str) -> torch.dtype:
    """A wire dtype name ("bfloat16", "int8", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown wire dtype {name!r}")
    return dt


def _encode_block(blk: dict) -> dict:
    """One page block -> wire form: {name: (dtype name, shape, bytes)}."""
    wire = {}
    for name, t in blk.items():
        t = t.detach().to("cpu").contiguous()
        wire[name] = (str(t.dtype).replace("torch.", ""), tuple(t.shape),
                      t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return wire


def _decode_block(wire: dict) -> dict:
    """Wire form -> page block, copied out of the frame buffer."""
    out = {}
    for name, (dtype, shape, raw) in wire.items():
        buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        out[name] = buf.view(_dtype(dtype)).reshape(shape).clone()
    return out


class KVMigrator:
    """Streams one migration blob from source to destination.

    Stateless per transfer (safe to share across requests); ``stats``
    aggregates. ``transfer`` either returns a blob the destination may
    import, or raises — the router then cancels the migration and the
    sequence decodes on at the source."""

    def __init__(self, mode: str = "handoff",
                 chunk_pages: Optional[int] = None):
        if mode not in ("handoff", "chunked"):
            raise ValueError(
                f"mode must be 'handoff' or 'chunked', got {mode!r}")
        self.mode = mode
        self.chunk_pages = int(
            flags.get_flag("kv_migration_chunk_pages")
            if chunk_pages is None else chunk_pages)
        if self.chunk_pages < 1:
            raise ValueError(f"chunk_pages must be >= 1, "
                             f"got {self.chunk_pages}")
        self.stats = {"transfers": 0, "chunks": 0, "bytes_moved": 0,
                      "transfer_faults": 0}

    def transfer(self, blob: dict, rid: Optional[int] = None) -> dict:
        """Move one exported migration blob across the seam. Handoff
        passes it by reference; chunked round-trips every page block
        through raw bytes chunk by chunk. A fault at ``kv.migrate`` fires
        before its chunk moves, and a faulted transfer delivers
        nothing."""
        pages: List[dict] = blob["pages"]
        try:
            if self.mode == "handoff":
                faults.maybe_fail("kv.migrate", rid=rid,
                                  pages=len(pages), chunk=0)
                self.stats["transfers"] += 1
                self.stats["bytes_moved"] += int(blob.get("nbytes", 0))
                return blob
            out: List[dict] = []
            for lo in range(0, max(len(pages), 1), self.chunk_pages):
                chunk = pages[lo:lo + self.chunk_pages]
                faults.maybe_fail("kv.migrate", rid=rid,
                                  chunk=lo // self.chunk_pages,
                                  pages=len(chunk))
                wire = [_encode_block(b) for b in chunk]
                self.stats["chunks"] += 1
                self.stats["bytes_moved"] += sum(
                    len(raw) for b in wire for _, _, raw in b.values())
                out.extend(_decode_block(w) for w in wire)
            self.stats["transfers"] += 1
            return {**blob, "pages": out}
        except Exception:
            self.stats["transfer_faults"] += 1
            raise
