"""Mixed waves on the edges of the ragged walk (``csrc/ragged_walk.cuh``).

Shared by ``tests/test_torch_ragged_walks.py`` (CPU: the walk's model
against the JAX package's kernels) and ``tests/test_torch_cuda_kernels.py``
(the card: the kernels against their plain versions), so both hold the same
waves. Imports nothing of JAX or torch.

A wave is a list of slots, each (old length, rows, fresh keys): rows 1 and
fresh 0 is a decode row (a walk item: it reads its own new cell back, so
its page_lens is old + 1); rows 0 an idle slot; anything else a chunk (tile
items) on old length of page context. ``layout`` lays a wave out as
``ContinuousBatcher._build_ragged_step`` does.
"""

from __future__ import annotations


def edge_waves(g, page):
    """name -> slots. ``chunks``: chunk lengths on the tile edges (R - 1,
    R, R + 1 rows for tiles of R = 64 / g rows), a first chunk (no page
    context) and later ones, a one-row chunk (rows 1, fresh 1: a tile, not
    a walk), a decode row, an idle slot. ``walks``: decode rows that read
    1 cell (their own only), a page, a page + 1, and walks of 5, 7 and 10
    pages (the last page full, or holding 2 cells) that clusters of 2, 4
    and 8 split in ranges of unequal size; an idle slot and a chunk.
    ``long``: the batcher's second chunk of a 512-token prompt (256 rows
    on 256 cells of context: every tile walks 256 cells, then up to 256
    fresh keys) beside decode rows and an idle slot."""
    r = 64 // g
    return {
        "long": [(256, 256, 256), (96, 1, 0), (7 * page - 1, 1, 0),
                 (0, 0, 0)],
        "chunks": [(0, r - 1, r - 1), (2 * page + 3, r, r),
                   (page, r + 1, r + 1), (5, 1, 1), (3 * page - 1, 1, 0),
                   (0, 0, 0)],
        "walks": [(0, 1, 0), (page - 1, 1, 0), (page, 1, 0),
                  (4 * page, 1, 0), (7 * page - 1, 1, 0),
                  (9 * page + 1, 1, 0), (0, 0, 0), (page + 2, 5, 5)],
    }


def layout(slots, t=None):
    """The wave's rows: slot b's decode row is row b, the chunks' rows
    follow the B decode rows in slot order, and T is rounded up to a
    multiple of 8 (or ``t``); every other row belongs to no segment.
    Returns a dict of int lists: ``seq`` (old lengths), ``row_slot``
    (-1: no segment), ``row_pos``, ``page_lens``, ``q_start``, ``q_lens``,
    ``fresh_lens``, and ``t``, ``cap`` (the smallest multiple of 16 and 32
    that holds every slot's cells)."""
    b = len(slots)
    need = b + sum(q for _, q, f in slots if not (q == 1 and f == 0))
    t = t if t is not None else -(-need // 8) * 8
    assert t >= need, (t, need)
    row_slot, row_pos = [-1] * t, [0] * t
    out = {k: [] for k in ("seq", "page_lens", "q_start", "q_lens",
                           "fresh_lens")}
    row = b
    for i, (old, q, f) in enumerate(slots):
        start, plen = 0, 0
        if q == 1 and f == 0:
            start, plen = i, old + 1
            row_slot[i], row_pos[i] = i, old
        elif q:
            start, plen = row, old
            row_slot[row:row + q] = [i] * q
            row_pos[row:row + q] = range(old, old + q)
            row += q
        for k, v in (("seq", old), ("page_lens", plen), ("q_start", start),
                     ("q_lens", q), ("fresh_lens", f)):
            out[k].append(v)
    top = max(old + q for old, q, _ in slots) + 1
    out.update(row_slot=row_slot, row_pos=row_pos, t=t,
               cap=-(-top // 32) * 32)
    return out
