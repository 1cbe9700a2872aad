"""Fused rope + KV-append + paged attention
(``paddle_tpu/ops/pallas/fused_rope_attend.py``).

Kernel K3 (``csrc/rope_append_attend.cu``) replaces the TPU kernel
``_pallas_fused`` in both of its entry forms. The TPU kernel returns the
pools as aliased outputs; K3 writes the new cells into the pool tensors in
place and returns the same cache state.

  fused_rope_append_attend         the ragged wave (the continuous
                                   batcher's admission step): rope the
                                   T rows, write every segment row's K/V
                                   at (its slot, its position), attend as
                                   ragged_paged_attention does
  fused_rope_append_attend_decode  one token per slot (solo
                                   generate_paged; the batcher's segment
                                   steps with an ``active`` mask: an
                                   inactive slot writes nothing and
                                   returns zeros)

The ragged form runs K11's body (``csrc/ragged_walk.cuh``: decode rows'
page walks split across a thread-block cluster, chunk rows in tiles on
the tensor cores, ``ragged_paged_attention.ragged_plan``), each segment
row's cell written by the CTA that holds the row. The decode form runs
K10's page walk (``csrc/paged_walk.cuh``: each
(kv head, slot) walk split in whole pages across a thread-block cluster,
``paged_attention.walk_plan``), the CTA whose pages hold the new cell
writing it. On an int8 cache it quantizes the rotated k row and the raw v
row on write (``kv_cache._quantize_cells``' rule), dequantizes every page
cell as code * scale, and reads its own new cell back as code * scale;
so does the ragged form, whose chunk rows read their own chunk through the
fresh full-precision keys (page % 4 == 0 on an int8 cache, both forms),
except in the slots that ``fresh_pool_read`` (B,) bool marks (speculative
verify segments): their fresh rows are read as the pool holds them, on an
int8 cache each quantized in shared memory as the cell writer quantizes it
and read as code * scale; on a bf16 cache the rotated k is already the
bf16 value the pool holds (``apply_rotary_rows`` casts back, as
``rotate8`` does), so the flag changes no bit there.
A q, k or v that requires grad raises with grad enabled (the launch is
invisible to autograd).

The plain versions are the unfused chains, ``ragged_reference`` and
``decode_reference``: rope, the plain cache writers, then
``ragged_paged_attention_pure`` / ``paged_attention_pure`` (K11 / K10 on
CUDA tensors, their plain versions with ``plain=True``). On CPU tensors the
entries run those chains; on CUDA tensors they launch K3 or raise.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .paged_attention import check_scale_pools

#: K3 launches since the last reset, decode form (incremented only where
#: it launches)
launches = 0
#: K3 launches since the last reset, ragged form
ragged_launches = 0


def ragged_reference(q, k, v, cos, sin, cache, layer, row_slot, row_pos,
                     valid, page_lens, q_start, q_lens, fresh_lens,
                     fresh_pool_read=None, plain=False):
    """rope -> ragged append -> ragged paged attention, the unfused chain.
    Writes the cache's pools in place; returns (out (T, H, D), cache).
    ``fresh_pool_read`` (B,) bool: those slots' fresh K/V through the pool
    representation (``ragged_paged_attention.fresh_through_pool``: f32
    carriers, codes * scale on an int8 cache, the pool-dtype cast on a
    float one); None is the plain wave. ``plain`` takes the attention's
    plain version (on ``fresh_through_pool``'s fresh K/V) on any device."""
    from ...models.kv_cache import append_tokens_ragged, layer_scales
    from ...models.llama import apply_rotary_rows
    from . import ragged_paged_attention as rpa

    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    cache = append_tokens_ragged(cache, layer, k2, v, row_slot, row_pos,
                                 valid)
    ks, vs = layer_scales(cache, layer)
    args = (q2, cache.k_pages[layer], cache.v_pages[layer],
            cache.block_tables, page_lens, q_start, q_lens, fresh_lens)
    if not plain:
        return rpa.ragged_paged_attention_pure(
            *args, k2, v, k_scales=ks, v_scales=vs,
            fresh_pool_read=fresh_pool_read), cache
    k2, v = rpa.fresh_through_pool(k2, v, fresh_pool_read, q_start, q_lens,
                                   cache.quantized, cache.k_pages.dtype)
    return rpa.ragged_paged_attention_reference(
        *args, k2, v, k_scales=ks, v_scales=vs), cache


def decode_reference(q, k, v, cos, sin, cache, layer, active=None,
                     plain=False):
    """rope -> append_token(_masked) -> paged attention, the unfused chain.
    ``active=None`` is the all-slots form; an inactive slot writes nothing
    and attends over length 0 (zeros). Writes the pools in place; returns
    (out (B, H, D), cache). ``plain`` takes the attention's plain version
    on any device."""
    from ...models.kv_cache import (append_token, append_token_masked,
                                    layer_scales)
    from ...models.llama import apply_rotary_rows
    from . import paged_attention as pa

    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    if active is None:
        cache = append_token(cache, layer, k2, v)
        lens = cache.seq_lens + 1
    else:
        cache = append_token_masked(cache, layer, k2, v, active)
        lens = torch.where(active, cache.seq_lens + 1,
                           torch.zeros_like(cache.seq_lens))
    ks, vs = layer_scales(cache, layer)
    attention = (pa.paged_attention_reference if plain
                 else pa.paged_attention_pure)
    out = attention(q2, cache.k_pages[layer], cache.v_pages[layer],
                    cache.block_tables, lens, k_scales=ks, v_scales=vs)
    return out, cache


def _check_cache(cache, b, layer):
    n_layers = cache.k_pages.shape[0]
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range [0, {n_layers})")
    pool_dtype = torch.int8 if cache.quantized else torch.bfloat16
    _build.check_cuda("k_pages", cache.k_pages, pool_dtype)
    _build.check_cuda("v_pages", cache.v_pages, pool_dtype,
                      cache.k_pages.shape)
    _build.check_cuda("block_tables", cache.block_tables, torch.int32,
                      (b, cache.block_tables.shape[1]))
    if cache.quantized:
        check_scale_pools(cache.k_pages, cache.k_scales, cache.v_scales)


def fused_rope_append_attend(q, k, v, cos, sin, cache, layer, row_slot,
                             row_pos, valid, page_lens, q_start, q_lens,
                             fresh_lens, fresh_pool_read=None):
    """Ragged-wave form: q (T, H, D), k/v (T, Hk, D) UNROTATED
    projections, cos/sin (T, D) f32 at each row's position ``row_pos``.
    Returns (out (T, H, D), cache) with every segment row's cell written;
    ``seq_lens`` is not advanced. Rows of a segment must be valid rows
    (the batcher's waves are); ``valid`` is read by the plain chain only.
    ``fresh_pool_read`` (B,) bool or None: the slots whose fresh rows are
    read as the pool holds them (speculative verify segments)."""
    global ragged_launches
    if not q.is_cuda:
        return ragged_reference(q, k, v, cos, sin, cache, layer, row_slot,
                                row_pos, valid, page_lens, q_start, q_lens,
                                fresh_lens, fresh_pool_read)
    from .ragged_paged_attention import check_wave_shapes, flag_pointer

    t, h, d = q.shape
    _, hk, p_total, page, _ = cache.k_pages.shape
    b, pps = cache.block_tables.shape
    check_wave_shapes(q, hk)
    _check_cache(cache, b, layer)
    bf, i32 = torch.bfloat16, torch.int32
    _build.check_cuda("q", q, bf)
    _build.check_cuda("k", k, bf, (t, hk, d))
    _build.check_cuda("v", v, bf, (t, hk, d))
    _build.check_cuda("cos", cos, torch.float32, (t, d))
    _build.check_cuda("sin", sin, torch.float32, (t, d))
    _build.check_cuda("row_pos", row_pos, i32, (t,))
    for name, x in (("page_lens", page_lens), ("q_start", q_start),
                    ("q_lens", q_lens), ("fresh_lens", fresh_lens)):
        _build.check_cuda(name, x, i32, (b,))
    fpr = flag_pointer(fresh_pool_read, b)
    _build.check_no_grad("rope_append_attend", q, k, v)
    out = torch.empty_like(q)            # K3 writes every row
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr())
    tail = (cache.block_tables.data_ptr(), row_pos.data_ptr(),
            page_lens.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
            fresh_lens.data_ptr(), fpr, out.data_ptr(), t, b, h, hk, p_total,
            page, pps, int(layer), 1.0 / math.sqrt(d), _build.stream_of(q))
    if cache.quantized:
        _build.launch("pt_rope_append_attend_ragged_int8", *head,
                      cache.k_scales.data_ptr(), cache.v_scales.data_ptr(),
                      *tail)
    else:
        _build.launch("pt_rope_append_attend_ragged", *head, *tail)
    ragged_launches += 1
    return out, cache


def fused_rope_append_attend_decode(q, k, v, cos, sin, cache, layer,
                                    active=None):
    """q (B, H, D), k/v (B, Hk, D) UNROTATED projections, cos/sin (B, D)
    f32 at each slot's position ``cache.seq_lens``. ``active`` (B,) bool,
    None for all slots: an inactive slot writes nothing and returns zeros.
    Returns (out (B, H, D), cache) with the new cells written; ``seq_lens``
    is not advanced."""
    global launches
    if not q.is_cuda:
        return decode_reference(q, k, v, cos, sin, cache, layer, active)
    b, h, d = q.shape
    _, hk, p_total, page, _ = cache.k_pages.shape
    pps = cache.block_tables.shape[1]
    if d != 128 or h % hk or h // hk > 8:
        raise ValueError(f"rope_append_attend kernel needs head_dim 128 and "
                         f"at most 8 query heads per kv head, got q "
                         f"{tuple(q.shape)} with {hk} kv heads")
    _check_cache(cache, b, layer)
    bf = torch.bfloat16
    _build.check_cuda("q", q, bf)
    _build.check_cuda("k", k, bf, (b, hk, d))
    _build.check_cuda("v", v, bf, (b, hk, d))
    _build.check_cuda("cos", cos, torch.float32, (b, d))
    _build.check_cuda("sin", sin, torch.float32, (b, d))
    _build.check_cuda("seq_lens", cache.seq_lens, torch.int32, (b,))
    act = 0
    if active is not None:
        _build.check_cuda("active", active, torch.bool, (b,))
        act = active.data_ptr()
    _build.check_no_grad("rope_append_attend", q, k, v)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), cache.k_pages.data_ptr(),
            cache.v_pages.data_ptr())
    tail = (cache.block_tables.data_ptr(), cache.seq_lens.data_ptr(), act,
            out.data_ptr(), b, h, hk, p_total, page, pps, int(layer),
            1.0 / math.sqrt(d), _build.stream_of(q))
    if cache.quantized:
        _build.launch("pt_rope_append_attend_decode_int8", *args,
                      cache.k_scales.data_ptr(), cache.v_scales.data_ptr(),
                      *tail)
    else:
        _build.launch("pt_rope_append_attend_decode", *args, *tail)
    launches += 1
    return out, cache
