"""Fused rope + KV-append + paged attention, decode form
(``paddle_tpu/ops/pallas/fused_rope_attend.py``).

Kernel K3 (``csrc/rope_append_attend.cu``) replaces the TPU kernel
``_pallas_fused`` as ``fused_rope_append_attend_decode`` drives it: one
token per slot, every slot active. The TPU kernel returns the pools as
aliased outputs; K3 writes the new cell into the pool tensors in place and
returns the same cache state. On an int8 cache K3 quantizes the rotated k
row and the raw v row on write (``kv_cache._quantize_cells``' rule), stores
codes and scales in place, dequantizes every page cell as code * scale,
and reads its own new cell back as code * scale. The ragged
(ContinuousBatcher) form is a later slice.

On CPU tensors the entry runs the unfused chain (``decode_reference``);
on CUDA tensors it launches K3 or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

#: K3 launches since the last reset (incremented only where it launches)
launches = 0


def decode_reference(q, k, v, cos, sin, cache, layer):
    """rope -> append_token -> paged attention, the unfused chain. Writes
    the cache's pools in place; returns (out (B, H, D), cache)."""
    from ...models.kv_cache import append_token, layer_scales
    from ...models.llama import apply_rotary_rows
    from .paged_attention import paged_attention_reference

    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    cache = append_token(cache, layer, k2, v)
    ks, vs = layer_scales(cache, layer)
    out = paged_attention_reference(q2, cache.k_pages[layer],
                                    cache.v_pages[layer],
                                    cache.block_tables, cache.seq_lens + 1,
                                    k_scales=ks, v_scales=vs)
    return out, cache


def fused_rope_append_attend_decode(q, k, v, cos, sin, cache, layer):
    """q (B, H, D), k/v (B, Hk, D) UNROTATED projections, cos/sin (B, D)
    f32 at each slot's position ``cache.seq_lens``. Returns (out (B, H, D),
    cache) with the new cell written; ``seq_lens`` is not advanced."""
    global launches
    if not q.is_cuda:
        return decode_reference(q, k, v, cos, sin, cache, layer)
    b, h, d = q.shape
    n_layers, hk, p_total, page, _ = cache.k_pages.shape
    pps = cache.block_tables.shape[1]
    if d != 128 or h % hk or h // hk > 8:
        raise ValueError(f"rope_append_attend kernel needs head_dim 128 and "
                         f"at most 8 query heads per kv head, got q "
                         f"{tuple(q.shape)} with {hk} kv heads")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range [0, {n_layers})")
    bf = torch.bfloat16
    _build.check_cuda("q", q, bf)
    _build.check_cuda("k", k, bf, (b, hk, d))
    _build.check_cuda("v", v, bf, (b, hk, d))
    _build.check_cuda("cos", cos, torch.float32, (b, d))
    _build.check_cuda("sin", sin, torch.float32, (b, d))
    pool_dtype = torch.int8 if cache.quantized else bf
    _build.check_cuda("k_pages", cache.k_pages, pool_dtype)
    _build.check_cuda("v_pages", cache.v_pages, pool_dtype,
                      cache.k_pages.shape)
    _build.check_cuda("block_tables", cache.block_tables, torch.int32,
                      (b, pps))
    _build.check_cuda("seq_lens", cache.seq_lens, torch.int32, (b,))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), cache.k_pages.data_ptr(),
            cache.v_pages.data_ptr())
    tail = (cache.block_tables.data_ptr(), cache.seq_lens.data_ptr(),
            out.data_ptr(), b, h, hk, p_total, page, pps, int(layer),
            1.0 / math.sqrt(d), _build.stream_of(q))
    if cache.quantized:
        s_shape = cache.k_pages.shape[:-1] + (1,)
        _build.check_cuda("k_scales", cache.k_scales, torch.float32, s_shape)
        _build.check_cuda("v_scales", cache.v_scales, torch.float32, s_shape)
        _build.launch("pt_rope_append_attend_decode_int8", *args,
                      cache.k_scales.data_ptr(), cache.v_scales.data_ptr(),
                      *tail)
    else:
        _build.launch("pt_rope_append_attend_decode", *args, *tail)
    launches += 1
    return out, cache
