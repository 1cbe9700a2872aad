"""Radix-tree prefix cache over the paged KV pool — the port's own copy of
``paddle_tpu/inference/prefix_cache.py`` (host Python over hashlib; the
port imports nothing of the JAX package).

A radix tree keyed by PAGE-GRANULAR token chunks: each node owns one full
page of prompt tokens, a path from the root spells a prefix, and the
pages along it hold that prefix's K/V. ``ContinuousBatcher`` drives it:

  * admission: ``match_tiered(prompt)`` walks the longest page-chunk path;
    the matched HBM pages attach to the new slot by reference and only the
    unmatched suffix enters the ragged wave;
  * copy-on-write: a full-prompt match recomputes the last prompt token
    inside the last attached page, so the engine clones that page first
    (``kv_cache.clone_pages``: codes and int8 scale cells in one move);
  * retirement: a slot's full prompt pages are ``insert``ed (the tree
    takes one reference each) and the slot releases its own;
  * pressure: ``evict(n)`` removes leaf-LRU nodes, and with a host tier
    attached DEMOTES them instead (the page's bytes move to a
    ``HostPageArena`` slot through the ``offload`` the engine binds, the
    node stays, host-resident); ``match_tiered`` returns the host suffix,
    which the engine promotes back. Only host-tier pressure
    (``free_host_slots``) forgets a prefix.

A node's tier order along any path is hbm* host*, so ``match()`` (the
single-tier view) is the path cut at its first host node. A shared page's
bytes equal what the admitted request's own prefill would have written, so
greedy tokens are the same with the cache on or off. Fault sites
(``reliability/faults.py``), as in the JAX package's copy:
``prefix.match`` (the engine fails the request being admitted),
``prefix.evict`` (a clean FaultError out of admission) and
``prefix.offload`` (a demotion degrades to a discard).
"""

from __future__ import annotations

import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from ..reliability import faults


def page_hash_chain(tokens: Sequence[int], page_size: int) -> List[str]:
    """Cumulative page-hash chain of a token sequence: element j is a
    stable digest of pages 0..j (each page = `page_size` tokens; the
    trailing partial page is excluded — only FULL pages are shareable,
    matching the radix tree's node granularity).

    Chaining means element j identifies the whole PREFIX, not page j in
    isolation, so two replicas agree on an entry iff they hold the same
    prefix. blake2b, not Python hash(): digests must be stable across
    processes and interpreter runs."""
    out: List[str] = []
    h = hashlib.blake2b(digest_size=8)
    for j in range(len(tokens) // page_size):
        chunk = tokens[j * page_size:(j + 1) * page_size]
        h.update(b"\x00".join(str(int(t)).encode() for t in chunk))
        out.append(h.copy().hexdigest())
    return out


class _Node:
    """One full page of prompt tokens. `chunk` is the page's token tuple
    (the child key in the parent — dict hashing over the tuple is the
    "token-chunk hash"), `page` the physical page id holding its K/V —
    an HBM pool page when `tier == "hbm"`, a host arena slot when
    `tier == "host"` (a demoted node; its bytes live in the
    HostPageArena until promoted back or discarded)."""

    __slots__ = ("chunk", "page", "children", "parent", "last_used",
                 "tier")

    def __init__(self, chunk: Optional[tuple], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_used = 0
        self.tier = "hbm"


class PrefixCache:
    """Radix index: page-granular token chunks -> refcounted physical
    pages. Pure host metadata — the device pool is only touched by the
    engine (attach/clone/write), never by this class. The byte MOVES of
    the tiered extension (offload on demotion) go through the `offload`
    callable the engine binds; the tree only moves references."""

    def __init__(self, page_size: int, allocator, host_pager=None,
                 offload=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.allocator = allocator
        # host tier: host_pager is
        # a PageAllocator over the HostPageArena's slots;
        # offload(device_pages, host_slots) copies the pages' bytes
        # into the slots in ONE blocking batch (kv_cache.
        # HostPageArena.store — eviction batches its victims so the
        # pipeline syncs once per evict call, not once per page). Both
        # None = the single-tier pre-tiering behavior, bit-identical.
        self.host_pager = host_pager
        self._offload = offload
        self._root = _Node(None, -1, None)
        self._tick = 0
        self.stats = {"matches": 0, "match_tokens": 0, "inserts": 0,
                      "nodes_created": 0, "evictions": 0,
                      "pages_freed_by_eviction": 0,
                      # tiered-KV counters (all 0 without a host tier)
                      "demotions": 0, "promotions": 0,
                      "insert_upgrades": 0, "host_discards": 0,
                      "offload_faults": 0}

    # ------------------------------------------------------------ queries

    @property
    def n_nodes(self) -> int:
        n, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def pages(self) -> List[int]:
        """HBM pool pages currently referenced by the tree (the
        single-tier view — host-resident nodes reference arena slots,
        see host_pages())."""
        return [n.page for n in self._nodes() if n.tier == "hbm"]

    def host_pages(self) -> List[int]:
        """Host arena slots currently referenced by demoted nodes."""
        return [n.page for n in self._nodes() if n.tier == "host"]

    def _nodes(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(child)
                stack.append(child)
        return out

    def digest(self, top_k: int = 32) -> List[str]:
        """Top-k page-hash digest of the tree: the cumulative prefix hash
        (page_hash_chain element) of the `top_k` most-recently-used nodes,
        hottest first. Each entry identifies a full PREFIX path, so
        digest membership is exactly "this tree can serve this many
        prompt pages from cache" — in EITHER tier: a demoted
        (host-resident) node still counts, since it is promoted without
        recompute."""
        if top_k <= 0:
            return []
        entries: List[Tuple[int, str]] = []     # (last_used, prefix hash)
        h0 = hashlib.blake2b(digest_size=8)
        stack = [(self._root, h0)]
        while stack:
            node, h = stack.pop()
            for child in node.children.values():
                ch = h.copy()
                ch.update(b"\x00".join(str(int(t)).encode()
                                       for t in child.chunk))
                entries.append((child.last_used, ch.hexdigest()))
                stack.append((child, ch))
        entries.sort(key=lambda e: -e[0])
        return [d for _, d in entries[:top_k]]

    # --------------------------------------------------------------- ops

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest HBM-RESIDENT page-granular prefix of `tokens`:
        (matched token count, physical pages along the path). Touches
        every node on the path for LRU. The caller owns refcounting —
        attach with `allocator.retain(pages)` while this slot uses them.
        The single-tier view: the path truncates at the first
        host-resident node (tier order along a path is hbm* host*, so
        that truncation is the whole HBM prefix); tier-aware callers use
        match_tiered and promote the host suffix."""
        i, path = self.match_tiered(tokens)
        pages: List[int] = []
        for node in path:
            if node.tier != "hbm":
                break
            pages.append(node.page)
        return len(pages) * self.page_size, pages

    def match_tiered(self, tokens: Sequence[int]
                     ) -> Tuple[int, List[_Node]]:
        """Longest page-granular prefix of `tokens` in the tree across
        BOTH tiers: (matched token count, nodes along the path — an HBM
        prefix then a host-resident suffix). The engine attaches the HBM
        nodes' pages by reference and promotes the host suffix
        (allocate HBM pages, async-prefetch the bytes, `promote` each
        node) before any wave reads them. Fault site ``prefix.match``:
        the engine fails only the request being admitted."""
        faults.maybe_fail("prefix.match", tokens=len(tokens))
        self._tick += 1
        p = self.page_size
        node, path, i = self._root, [], 0
        while i + p <= len(tokens):
            child = node.children.get(tuple(int(t)
                                            for t in tokens[i:i + p]))
            if child is None:
                break
            child.last_used = self._tick
            path.append(child)
            node = child
            i += p
        if path:
            self.stats["matches"] += 1
            self.stats["match_tokens"] += i
        return i, path

    def promote(self, node: _Node, hbm_page: int) -> None:
        """Move a host-resident node back to the HBM tier: the tree
        takes over the caller's freshly-allocated reference on
        `hbm_page` (whose bytes the caller has already scheduled —
        HostPageArena.load orders the transfer before any reader by
        data flow) and releases the tree's host-slot reference. The
        caller still holds its own hold on the host slot during the
        transfer, so the bytes cannot be reused mid-flight."""
        if node.tier != "host":
            raise ValueError("promote of a node already in HBM")
        old = node.page
        node.page = int(hbm_page)
        node.tier = "hbm"
        self.host_pager.release([old])
        self.stats["promotions"] += 1

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a prefilled prompt's FULL pages: pages[j] holds the
        K/V of tokens[j*page:(j+1)*page]. Existing nodes are kept (first
        writer wins — the duplicate page stays private to its slot and is
        simply never shared); each NEW node takes one allocator reference
        on its page, which is what retains the prefix after the writing
        slot retires. Returns the number of nodes created."""
        p = self.page_size
        if len(tokens) < len(pages) * p:
            raise ValueError(
                f"insert of {len(pages)} pages needs {len(pages) * p} "
                f"tokens, got {len(tokens)} (only FULL pages are "
                f"shareable — a partial page is still append-target)")
        self._tick += 1
        node, created = self._root, 0
        for j, page in enumerate(pages):
            chunk = tuple(int(t) for t in tokens[j * p:(j + 1) * p])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(page), node)
                node.children[chunk] = child
                self.allocator.retain([int(page)])
                created += 1
            elif child.tier == "host":
                # upgrade-in-place: the writer just recomputed this
                # page's exact bytes in HBM (the determinism contract),
                # so re-point the demoted node at the fresh page and
                # free its host slot — a hot prefix comes back to the
                # HBM tier without paying the prefetch DMA
                self.allocator.retain([int(page)])
                self.host_pager.release([child.page])
                child.page = int(page)
                child.tier = "hbm"
                self.stats["insert_upgrades"] += 1
            child.last_used = self._tick
            node = child
        self.stats["inserts"] += 1
        self.stats["nodes_created"] += created
        return created

    def evict(self, n_pages: int) -> int:
        """Leaf-LRU eviction until `n_pages` HBM pages actually FREED
        (hit refcount 0) or no HBM leaf remains; returns the freed
        count. With a host tier attached, a victim whose page WOULD free
        (the tree holds the only reference) is DEMOTED instead of
        discarded — bytes move to a host arena slot, the HBM page frees
        all the same, and the node stays in the tree host-resident.
        Removing a leaf whose page other slots still reference frees
        nothing immediately — the reference moves off the tree and the
        page returns to the pool when its last slot releases it — but the
        node is still removed, so a stale suffix cannot pin tree growth.

        Fault site ``prefix.evict``: eviction runs under pool pressure
        inside admission, so a fault surfaces as a clean FaultError out of
        the engine."""
        faults.maybe_fail("prefix.evict", need=n_pages)
        return self._evict_until(n_pages)

    def reclaim(self, n_pages: int) -> int:
        """The unified arena's `kv` demotion hook (models/arena.py):
        the same leaf-LRU demote-or-discard loop as :meth:`evict`, without
        the ``prefix.evict`` site (the arena's steal loop plants its own
        ``arena.steal`` / ``arena.demote``)."""
        return self._evict_until(n_pages)

    def evict_all(self) -> int:
        """Drop every node, BOTH tiers (full-pressure reset); returns
        HBM pages freed. A direct teardown, not the leaf-LRU loop: a
        host-resident child pins its HBM ancestors out of that loop's
        leaf set, and a total reset must not leave such chains alive."""
        freed = 0
        for node in self._nodes():
            self.stats["evictions"] += 1
            if node.tier == "host":
                self.host_pager.release([node.page])
                self.stats["host_discards"] += 1
            else:
                n_f = len(self.allocator.release([node.page]))
                self.stats["pages_freed_by_eviction"] += n_f
                freed += n_f
            node.parent = None
            node.children = {}
        self._root.children = {}
        return freed

    def free_host_slots(self, n_slots) -> int:
        """Host-TIER pressure: discard coldest host-resident leaves
        until `n_slots` arena slots freed or none remain — the only
        path that actually forgets a prefix under tiering. Slots an
        engine holds mid-promotion (refcount > 1) are skipped: they are
        about to leave the host tier anyway."""
        if self.host_pager is None or n_slots <= 0:
            return 0
        heap: list = []
        tick = 0
        for node in self._nodes():
            if (node.tier == "host" and not node.children
                    and int(self.host_pager.refcount[node.page]) == 1):
                heapq.heappush(heap, (node.last_used, tick, node))
                tick += 1
        freed = 0
        while freed < n_slots and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            freed += len(self._remove(victim))
            self.stats["host_discards"] += 1
            if (parent is not self._root and not parent.children
                    and parent.tier == "host"
                    and int(self.host_pager.refcount[parent.page]) == 1):
                heapq.heappush(heap, (parent.last_used, tick, parent))
                tick += 1
        return freed

    def drop_host_nodes(self) -> int:
        """Remove every host-resident node, releasing its arena slot —
        the engine's run-end reconciliation: the tree dies with the run
        but the host pager persists across runs (parked sequences keep
        their slots), so tree-held slots must not leak."""
        if self.host_pager is None:
            return 0
        dropped = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for chunk, child in list(node.children.items()):
                if child.tier == "host":
                    # the whole subtree is host-resident (hbm* host*
                    # path order): detach and release every slot
                    del node.children[chunk]
                    sub = [child]
                    while sub:
                        n = sub.pop()
                        sub.extend(n.children.values())
                        n.children = {}
                        n.parent = None
                        self.host_pager.release([n.page])
                        dropped += 1
                else:
                    stack.append(child)
        return dropped

    # ----------------------------------------------------------- helpers

    def _evict_until(self, n_pages) -> int:
        """LRU loop over HBM-FRONTIER nodes — HBM-resident with no
        HBM children (a plain leaf, or an interior node whose subtree
        already demoted: host may parent host, so demoting it keeps the
        path order legal). ONE tree walk heapifies the frontier; a
        parent whose last HBM child leaves the tier joins the heap —
        O(n log n) per call, not a full rescan per freed page. Without
        this frontier rule a demoted child would pin its whole HBM
        ancestor chain out of eviction's reach and the pool would
        effectively shrink. (Host-resident nodes never join: removing
        one frees no HBM page — they belong to free_host_slots.)"""
        if n_pages <= 0:
            return 0
        heap: list = []     # (last_used, tiebreak, node)
        tick = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.tier != "hbm":
                    continue
                if any(c.tier == "hbm"
                       for c in child.children.values()):
                    stack.append(child)
                else:
                    heapq.heappush(heap, (child.last_used, tick, child))
                    tick += 1
        freed = 0
        # demotions COMMIT metadata immediately (HBM page freed, node
        # re-tiered) but the byte copies are BATCHED into one offload
        # call before returning: a per-page blocking readback would
        # sync the decode pipeline once per victim — one call amortizes
        # the wait across the whole eviction. Safe because nothing can
        # dispatch a write between the decision and the batch copy (the
        # caller only reuses freed pages after evict() returns). A
        # later victim's host-pressure discard may recycle an earlier
        # PENDING slot (its node discarded, slot re-reserved): the
        # batch then carries duplicate destinations, which numpy fancy
        # assignment resolves in order — the LIVE (later) entry wins.
        pending_src: List[int] = []
        pending_dst: List[int] = []
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            slot = self._demote_begin(victim)
            if slot is not None:
                pending_src.append(int(victim.page))
                pending_dst.append(slot)
                self.allocator.release([victim.page])
                victim.page = slot
                victim.tier = "host"
                self.stats["evictions"] += 1
                self.stats["demotions"] += 1
                self.stats["pages_freed_by_eviction"] += 1
                freed += 1
            elif not victim.children:
                freed += len(self._remove(victim))
            else:
                # page shared with a live slot (not movable) AND host
                # children hang below (not removable without orphaning
                # them): stays pinned until its holders release
                continue
            if (parent is not self._root and parent.tier == "hbm"
                    and not any(c.tier == "hbm"
                                for c in parent.children.values())):
                heapq.heappush(heap, (parent.last_used, tick, parent))
                tick += 1
        if pending_src:
            self._offload(pending_src, pending_dst)
        return freed

    def _demote_begin(self, node: _Node) -> Optional[int]:
        """Decide whether `node` (an HBM frontier node) can demote and
        reserve its host slot; the byte copy happens in the caller's
        batch. None = discard path. Preconditions: a tier is attached,
        and the tree holds the ONLY reference (a page some slot still
        reads cannot move — its node just drops off the tree, old
        behavior). Host-arena pressure discards coldest host leaves
        first; if the arena still has no slot (everything held), or the
        fault site ``prefix.offload`` fires, demotion degrades to the
        pre-tiering discard — never a crashed admission."""
        if (self.host_pager is None or self._offload is None
                or int(self.allocator.refcount[node.page]) != 1):
            return None
        slot = self.host_pager.alloc(1)
        if slot is None:
            self.free_host_slots(1)
            slot = self.host_pager.alloc(1)
            if slot is None:
                return None
        try:
            faults.maybe_fail("prefix.offload", page=int(node.page))
        except Exception:
            self.host_pager.release(slot)
            self.stats["offload_faults"] += 1
            return None
        return int(slot[0])

    def _remove(self, node: _Node) -> List[int]:
        del node.parent.children[node.chunk]
        node.parent = None
        self.stats["evictions"] += 1
        if node.tier == "host":
            return self.host_pager.release([node.page])
        freed = self.allocator.release([node.page])
        self.stats["pages_freed_by_eviction"] += len(freed)
        return freed
