"""Flash attention (``paddle_tpu/ops/pallas/flash_attention.py``).

Kernel K1 (``csrc/flash_attention.cu``) replaces the TPU forward
``_pallas_fwd``: causal (with offset Sk - Sq), GQA, an optional (B, Sk) f32
key bias, D = 128, bf16, writing the output and the per-row log-sum-exp;
it runs its 128-row query tiles longest walk first and skips the key
tiles a bias masks whole (``_fwd_walks`` models the order).
Kernel K5 (``csrc/flash_attention_bwd.cu``) replaces the split backward
``_pallas_bwd`` (``_dq_kernel`` and ``_dkv_kernel``): dQ, and dK/dV summed
over each KV head's query group. Kernel K9
(``csrc/flash_attention_bwd_fused.cu``) replaces the one-pass backward
``_pallas_bwd_fused``: each live tile once, its bf16 dS tiles kept for a
second kernel that forms dQ from them. K5 and K9 skip the key tiles a key
bias masks whole (``_key_tile_live``) and run their blocks longest walk
first (``_dkv_walks``, ``_dq_walks`` model the order). Layout is the JAX
package's (batch, seq, heads, head_dim).

A mask reaches the kernels as the additive key bias of
``_key_bias_from_mask`` (a key-padding mask: bool -> 0 / -1e30); a general
mask (anything not broadcastable to (B, 1, 1, Sk)) is routed by its shape
to the plain attention, as the JAX package routes it to
``_reference_attention``, and counted in ``plain_mask_routes``.

On CPU tensors ``flash_attention_fwd``, ``flash_attention_bwd`` and
``flash_attention_bwd_fused`` run their plain versions; on CUDA tensors
they launch K1 / K5 / K9 or raise. ``flash_attention_train`` is the
``autograd.Function`` the training path calls (the ``_flash_core`` custom
VJP of the JAX package): K1 forward saving (out, lse), then K9 where the
JAX package's ``_bwd_prologue`` takes ``_pallas_bwd_fused``
(``bwd_uses_fused``) and K5 elsewhere.
"""

from __future__ import annotations

import math

import torch

from . import _build

_NEG_INF = -1e30
_LANE = 128
#: the JAX package's cap on the fused backward's dQ partials (bytes)
_FUSED_PARTIALS_CAP = 512 * 1024 * 1024
#: rows of the kernels' key tiles, and of K5's and K9's query tiles
#: (csrc/flash_bwd_tiles.cuh BT)
_TILE = 64
#: rows of K1's query tiles (csrc/flash_attention.cu BQ)
_FWD_TILE = 128

#: K1 launches since the last reset (incremented only where it launches)
launches = 0
#: general masks routed to the plain attention (not a kernel launch)
plain_mask_routes = 0


def _key_bias_from_mask(attn_mask, b, sk):
    """(bias, ok): a key-level mask (bool or float, shaped (B, Sk), (1, Sk),
    (Sk,) or (B|1, 1, 1, Sk)) as an additive (B, Sk) f32 bias, contiguous;
    bool becomes 0 where True and -1e30 where False. (None, True) without a
    mask; (None, False) for a general mask, which the caller routes to the
    plain attention."""
    if attn_mask is None:
        return None, True
    m = attn_mask
    if (m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1
            and m.shape[0] in (1, b) and m.shape[3] == sk):
        m = m[:, 0, 0, :]
    elif m.dim() == 2 and m.shape[0] in (1, b) and m.shape[1] == sk:
        pass
    elif m.dim() == 1 and m.shape[0] == sk:
        m = m[None, :]
    else:
        return None, False
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, _NEG_INF)
    return m.float().expand(b, sk).contiguous(), True


def _bias_arg(bias):
    """A kernel's pointer to an optional tensor (the key bias, its tile
    liveness): null for None."""
    return 0 if bias is None else bias.data_ptr()


def _logits(q, k, causal, scale, bias):
    """(B, H, Sq, Sk) f32 logits as the kernels form them: Q.K^T * scale,
    plus the key bias, then the causal mask (-1e30)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(h // hk, dim=2) if hk != h else k
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    return logits


def _reference_attention(q, k, v, causal=False, scale=None, attn_mask=None,
                         bias=None):
    """(B, S, H, D) plain attention — the JAX package's reference lowering:
    f32 logits, softmax, probabilities cast to q's dtype before P.V.
    ``bias``: a (B, Sk) key bias added before the causal mask, as the
    kernels add it; ``attn_mask``: a general mask applied after it as the
    JAX package's ``_reference_attention`` does (bool: -1e30 where False;
    float: added)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if hk != h:  # GQA: repeat KV heads for the plain path
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, _NEG_INF)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None,
                                  bias=None):
    """K1's plain version: (out (B,Sq,H,D), lse (B,H,Sq) f32)."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    lse = torch.logsumexp(_logits(q, k, causal, scale, bias), dim=-1)
    return _reference_attention(q, k, v, causal, scale, bias=bias), lse


def fwd_tolerance(q, k, v, ref, causal=False, scale=None, bias=None):
    """Per-element bound on |K1 out - plain out|, from the inputs. Both
    round each probability to bf16 before P.V (K1 before normalizing, as
    the TPU does; the plain version after), 2^-9 relative each, so before
    the output rounding they differ by at most 2^-8 * (P @ |V|); with a
    factor 2 of room that is 2^-7 * (P @ |V|). Each output is then rounded
    to bf16 once in both: one ulp, at most 2^-7 * |out| -> 1e-2 * |ref|.
    The bound is tight where a row's weight sits on few keys (the first
    causal rows) and small where it spreads (the late rows)."""
    h, hk = q.shape[2], k.shape[2]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    vr = v.repeat_interleave(h // hk, dim=2).float()
    spread = torch.einsum("bhqk,bkhd->bqhd",
                          _logits(q, k, causal, scale, bias).softmax(dim=-1),
                          vr.abs())
    return 2.0 ** -7 * spread + 1e-2 * ref.float().abs() + 1e-4


def _dead_rows(lse):
    """(B, H, Sq) True where a query sees no key (lse = -1e30)."""
    return lse <= _NEG_INF / 2


def _may_have_dead_rows(sq, sk, causal, bias):
    """Whether some query can see no key: under a key bias, or before the
    first key when Sq > Sk under the causal mask."""
    return bias is not None or (causal and sq > sk)


def _fill_dead_rows(out, v, lse):
    """K1 writes zeros for a query that sees no key; give such rows the
    JAX package's reference lowering's answer instead, a softmax over equal
    logits: the mean of V over all keys."""
    g = out.shape[2] // v.shape[2]
    mean_v = v.float().mean(dim=1).repeat_interleave(g, dim=1)
    dead = _dead_rows(lse).transpose(1, 2).contiguous()[..., None]
    return torch.where(dead, mean_v[:, None].to(out.dtype), out)


def _add_dead_rows_dv(dv, do, lse):
    """K5 and K9 give a query that sees no key no term; add its share of
    the reference lowering's gradient: P = 1/Sk (in dO's dtype, as the
    kernels cast P) on every key for dV, summed over each KV group."""
    b, sk, hk, d = dv.shape
    h = do.shape[2]
    dead = _dead_rows(lse).transpose(1, 2).contiguous()[..., None]
    p = torch.tensor(1.0 / sk).to(do.dtype).item()
    extra = torch.where(dead, do, 0).sum(dim=1, dtype=torch.float32)
    extra = extra.reshape(b, hk, h // hk, d).sum(2)
    return (dv.float() + p * extra[:, None]).to(dv.dtype)


def _check_attention(name, q, k, v, bias):
    """Shapes (B, Sq, H, D) / (B, Sk, Hk, D) / bias (B, Sk) f32, bf16,
    contiguous, D = 128, no grad: what K1, K5 and K9 take."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if d != 128:
        raise ValueError(f"{name} kernel needs head_dim 128, got {d}")
    _build.check_no_grad(name, q, k, v)
    _build.check_cuda("q", q, torch.bfloat16)
    _build.check_cuda("k", k, torch.bfloat16, (b, sk, hk, d))
    _build.check_cuda("v", v, torch.bfloat16, (b, sk, hk, d))
    if bias is not None:
        _build.check_cuda("bias", bias, torch.float32, (b, sk))


def flash_attention_fwd(q, k, v, causal=False, scale=None, bias=None):
    """(out, lse) — K1 on CUDA tensors, the plain version on CPU tensors.
    ``bias``: an optional (B, Sk) f32 key bias (``_key_bias_from_mask``)."""
    global launches
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, causal, scale, bias)
    _check_attention("flash_attention_fwd", q, k, v, bias)
    live = _key_tile_live(bias, sk)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _build.launch("pt_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), _bias_arg(bias), _bias_arg(live),
                  out.data_ptr(), lse.data_ptr(), b, sq, sk, h, hk,
                  int(bool(causal)), float(scale), _build.stream_of(q))
    launches += 1
    if _may_have_dead_rows(sq, sk, causal, bias):
        out = _fill_dead_rows(out, v, lse)
    return out, lse


def flash_attention_pure(q, k, v, causal=False, scale=None, attn_mask=None,
                         plain=False):
    """Attention output only — the serving and eval entry. A key-level
    ``attn_mask`` rides K1 as a key bias; a general one goes to the plain
    attention (``plain_mask_routes``). ``plain``: K1's plain version on any
    device (the on-card reference)."""
    global plain_mask_routes
    bias, key_level = _key_bias_from_mask(attn_mask, q.shape[0], k.shape[1])
    if not key_level:
        plain_mask_routes += 1
        return _reference_attention(q, k, v, causal, scale,
                                    attn_mask=attn_mask)
    fwd = flash_attention_fwd_reference if plain else flash_attention_fwd
    return fwd(q, k, v, causal, scale, bias)[0]


# ---------------------------------------------------------------------------
# Backward (K5, K9), the dispatch between them, and the training entry
# ---------------------------------------------------------------------------

#: K5 calls since the last reset (each launches the dq and the dkv kernel)
bwd_launches = 0
#: K9 calls since the last reset (each launches the one-pass kernel and
#: the dQ partials' sum)
bwd_fused_launches = 0


def _delta(out, do):
    """Delta = rowsum(dO * O) in f32, (B, H, Sq) — computed outside the
    kernels, as ``_pallas_bwd`` does (the plain version)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_delta(out, do):
    """``_delta`` on the card: the first launch of K5 and of K9
    (``flash_delta_kernel``), one pass over dO and O."""
    b, sq, h, _ = out.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    _build.launch("pt_flash_bwd_delta", out.data_ptr(), do.data_ptr(),
                  delta.data_ptr(), b, sq, h, _build.stream_of(out))
    return delta


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=False,
                                  scale=None, bias=None):
    """The plain version of K5 and of K9 (the two compute the same
    function): (dq, dk, dv) with the TPU kernels' casts — p in f32, cast to
    dO's dtype before dV += p^T dO; ds = p * (dP - delta) cast to Q's/K's
    dtype before the dK and dQ products; dK/dV summed over the query group
    in f32; one cast of each gradient at the end. The mask gets no
    gradient.

    A query that sees no key (lse = -1e30: a left-pad query under a
    key-padding mask) gets the JAX package's reference lowering's gradient,
    a softmax over equal logits: p = 1/Sk on every key for dV, and no dQ
    or dK (its logits are constants there). The kernels give the same
    (``_add_dead_rows_dv``); the TPU kernels give such rows p = exp(0) = 1
    on their live tiles, which agrees only where dO is 0 on them."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    dead = _dead_rows(lse)[..., None]
    p = torch.exp(_logits(q, k, causal, scale, bias) - lse[..., None])
    p = torch.where(dead, 1.0 / sk, p)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = (p * (dp - _delta(out, do)[..., None])).masked_fill(dead, 0.0)
    ds_lo = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, kr.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, q.float()) * scale
    dk = dk.reshape(b, sk, hk, g, d).sum(dim=3)
    dv = dv.reshape(b, sk, hk, g, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: K9's plain version: the backward's one function (module attribute, so a
#: test can count the plain calls of each route)
flash_attention_bwd_fused_reference = flash_attention_bwd_reference


def bwd_tolerance(q, k, v, do, ref_dq, ref_dk, ref_dv, causal=False,
                  scale=None, bias=None):
    """Per-element bounds on |K5 or K9 - plain| for (dq, dk, dv), from the
    inputs. The versions round the same bf16 values (p before the dV
    product, ds before the dK/dQ products) but compute p, dP and the f32
    sums in different orders, so a rounded value may land one bf16 ulp
    (2^-8 relative) apart: each gradient may differ by 2^-7 (with room 2)
    times the sum of the magnitudes it adds up, |p| @ |dO| for dV and
    |ds| @ |K| (|Q|) * scale for dQ (dK), plus one bf16 ulp of the output
    (1e-2 * |ref|)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    p = _logits(q, k, causal, scale, bias).softmax(dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ads = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
    tq = torch.einsum("bhqk,bkhd->bqhd", ads, kr.abs()) * scale
    tk = torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()) * scale
    tv = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    tk = tk.reshape(b, sk, hk, g, d).sum(dim=3)
    tv = tv.reshape(b, sk, hk, g, d).sum(dim=3)
    return tuple(2.0 ** -7 * t + 1e-2 * r.float().abs() + 1e-4
                 for t, r in ((tq, ref_dq), (tk, ref_dk), (tv, ref_dv)))


def _key_tile_live(bias, sk):
    """(B, ceil(Sk / 64)) int32 on the bias's device: 0 where the bias
    masks every key of the 64-key tile (each <= -1e30; keys past Sk count
    as masked), which K5 and K9 skip; None without a bias (every tile is
    live). Device ops only: no host sync."""
    if bias is None:
        return None
    nk = -(-sk // _TILE)
    padded = torch.nn.functional.pad(bias, (0, nk * _TILE - sk),
                                     value=_NEG_INF)
    live = ~(padded <= _NEG_INF)          # NaN counts as live
    return live.view(bias.shape[0], nk, _TILE).any(-1).to(torch.int32)


def _check_bwd(name, q, k, v, out, lse, do, bias):
    b, sq, h, d = q.shape
    _check_attention(name, q, k, v, bias)
    _build.check_no_grad(name, out, do)
    _build.check_cuda("out", out, torch.bfloat16, (b, sq, h, d))
    _build.check_cuda("do", do, torch.bfloat16, (b, sq, h, d))
    _build.check_cuda("lse", lse, torch.float32, (b, h, sq))


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        bias=None):
    """(dq, dk, dv) — K5 on CUDA tensors, the plain version on CPU
    tensors."""
    global bwd_launches
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             scale, bias)
    _check_bwd("flash_attention_bwd", q, k, v, out, lse, do, bias)
    delta = _bwd_delta(out, do)
    live = _key_tile_live(bias, sk)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _build.launch("pt_flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), _bias_arg(bias), _bias_arg(live),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                  hk, int(bool(causal)), float(scale), _build.stream_of(q))
    bwd_launches += 1
    if _may_have_dead_rows(sq, sk, causal, bias):
        dv = _add_dead_rows_dv(dv, do, lse)
    return dq, dk, dv


def _live_key_tiles(qt, sq, sk, causal):
    """Key tiles query tile ``qt`` reads (csrc/flash_bwd_tiles.cuh)."""
    nk = -(-sk // _TILE)
    if not causal:
        return nk
    last = min(qt * _TILE + _TILE - 1, sq - 1) + (sk - sq)
    return 0 if last < 0 else min(nk, last // _TILE + 1)


def _fwd_key_tiles(qt, sq, sk, causal):
    """Key tiles K1's 128-row query tile ``qt`` reads
    (csrc/flash_attention.cu ``key_tiles``)."""
    nk = -(-sk // _TILE)
    if not causal:
        return nk
    last = min(qt * _FWD_TILE + _FWD_TILE - 1, sq - 1) + (sk - sq)
    return 0 if last < 0 else min(nk, last // _TILE + 1)


def _fwd_walks(b, sq, sk, h, causal, tile_live=None):
    """K1, block by block in launch order (grid (B*H, 128-row query
    tiles), x fastest: query tiles descending, so under the causal mask
    the longest walks go first): (b, h, qt, key tiles in walk order). A
    key tile ``tile_live`` marks dead is neither loaded nor multiplied."""
    nq = -(-sq // _FWD_TILE)
    blocks = []
    for y in range(nq):
        qt = nq - 1 - y
        for bh in range(b * h):
            bi, hi = divmod(bh, h)
            blocks.append((bi, hi, qt, [
                kt for kt in range(_fwd_key_tiles(qt, sq, sk, causal))
                if _is_live(tile_live, bi, kt)]))
    return blocks


def _first_query_tile(kt, sq, sk, causal):
    """The first query tile that sees key tile ``kt`` (flash_bwd_tiles.cuh)."""
    return max(kt * _TILE - (sk - sq), 0) // _TILE if causal else 0


def fused_partial_pairs(sq, sk, causal):
    """The live (query tile, key tile) pairs of one (batch, head): the bf16
    dS tiles (64 x 64) K9 writes and its dQ product reads."""
    return sum(_live_key_tiles(qt, sq, sk, causal)
               for qt in range(-(-sq // _TILE)))


def _pair_slot(qt, kt, sq, sk, causal):
    """Where K9 keeps the dS tile of pair (qt, kt) among its (b, h)'s
    ``fused_partial_pairs``: the pairs in query-tile order
    (flash_attention_bwd_fused.cu ``pair_base(qt) + kt``)."""
    return sum(_live_key_tiles(t, sq, sk, causal) for t in range(qt)) + kt


def _is_live(tile_live, b, kt):
    return tile_live is None or bool(tile_live[b][kt])


def _dkv_walks(b, sq, sk, h, hk, causal, tile_live=None):
    """K5's dkv kernel and K9's one-pass kernel, block by block in launch
    order (grid (B*Hk, key tiles), x fastest: key tiles ascending, so under
    the causal mask the longest walks go first): (b, hk, kt, walk), the
    walk being the (query head, query tile) pairs in the block's order. A
    key tile ``tile_live`` marks dead walks nothing."""
    nq, nk, g = -(-sq // _TILE), -(-sk // _TILE), h // hk
    blocks = []
    for kt in range(nk):
        qt0 = _first_query_tile(kt, sq, sk, causal)
        for bhk in range(b * hk):
            bi, j = divmod(bhk, hk)
            walk = [(j * g + hh, qt) for hh in range(g)
                    for qt in range(qt0, nq)] \
                if _is_live(tile_live, bi, kt) else []
            blocks.append((bi, j, kt, walk))
    return blocks


def _dq_walks(b, sq, sk, h, causal, tile_live=None):
    """K5's dq kernel and K9's dQ product, block by block in launch order
    (grid (B*H, query tiles), x fastest: query tiles descending, the
    longest walks first): (b, h, qt, key tiles in summation order)."""
    nq = -(-sq // _TILE)
    blocks = []
    for y in range(nq):
        qt = nq - 1 - y
        for bh in range(b * h):
            bi, hi = divmod(bh, h)
            blocks.append((bi, hi, qt, [
                kt for kt in range(_live_key_tiles(qt, sq, sk, causal))
                if _is_live(tile_live, bi, kt)]))
    return blocks


def flash_attention_bwd_fused(q, k, v, out, lse, do, causal=False,
                              scale=None, bias=None):
    """(dq, dk, dv) — K9 on CUDA tensors, the plain version on CPU
    tensors. The dS tiles (B*H, live pairs, 64, 64) bf16 are scratch
    allocated here and freed on return (0.52 GiB at B=4, S=2048, H=32,
    causal)."""
    global bwd_fused_launches
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if not q.is_cuda:
        return flash_attention_bwd_fused_reference(q, k, v, out, lse, do,
                                                   causal, scale, bias)
    _check_bwd("flash_attention_bwd_fused", q, k, v, out, lse, do, bias)
    delta = _bwd_delta(out, do)
    live = _key_tile_live(bias, sk)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    n_pairs = fused_partial_pairs(sq, sk, causal)
    parts = torch.empty((b * h, n_pairs, _TILE, _TILE), dtype=q.dtype,
                        device=q.device)
    _build.launch("pt_flash_attention_bwd_fused", q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _bias_arg(bias),
                  _bias_arg(live), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), parts.data_ptr(), n_pairs, b, sq, sk, h, hk,
                  int(bool(causal)), float(scale), _build.stream_of(q))
    bwd_fused_launches += 1
    if _may_have_dead_rows(sq, sk, causal, bias):
        dv = _add_dead_rows_dv(dv, do, lse)
    return dq, dk, dv


def _block_sizes(sq, sk, d=128):
    """The JAX package's block heuristic (``_block_sizes``): the biggest
    of 1024 / 512 / 256 that divides the sequence (capped by head_dim),
    else 128."""
    cap = 1024 if d <= 128 else 512 if d <= 256 else 256

    def pick(s):
        for blk in (1024, 512, 256):
            if blk <= cap and s % blk == 0:
                return blk
        return _LANE
    return pick(sq), pick(sk)


def _ceil_to(n, m):
    return -(-n // m) * m


def bwd_uses_fused(b, sq, sk, h, d) -> bool:
    """The JAX package's backward choice (``_bwd_prologue``): the one-pass
    kernel iff ``flags.flash_bwd_impl == "fused"`` and its dQ partials,
    nk x (B*H) x Sq x D f32 on the dims padded to its blocks, fit 512 MiB.
    The port takes K9 exactly there and K5 elsewhere."""
    from ...framework import flags

    if flags.get_flag("flash_bwd_impl") != "fused":
        return False
    bq, bk = _block_sizes(sq, sk, d)
    nk = _ceil_to(sk, bk) // bk
    return nk * b * h * _ceil_to(sq, bq) * _ceil_to(d, _LANE) * 4 \
        <= _FUSED_PARTIALS_CAP


def _mask_key(attn_mask):
    """What identifies a mask for the recompute stash (no device read)."""
    if attn_mask is None:
        return None
    return (attn_mask.data_ptr(), tuple(attn_mask.shape), attn_mask.dtype)


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, plain, stash, mask_key):
        if stash:                 # the saved residuals of the first forward
            out, lse, key = stash
            if key != mask_key:
                raise RuntimeError("flash attention recompute: the stashed "
                                   "(out, lse) belong to another mask")
        elif plain:
            out, lse = flash_attention_fwd_reference(q, k, v, causal, scale,
                                                     bias)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal, scale, bias)
        if stash is not None and not stash:
            stash.extend((out, lse, mask_key))
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        b, sq, h, d = q.shape
        fused = bwd_uses_fused(b, sq, k.shape[1], h, d)
        if ctx.plain:
            bwd = (flash_attention_bwd_fused_reference if fused
                   else flash_attention_bwd_reference)
        else:
            bwd = flash_attention_bwd_fused if fused else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), ctx.causal,
                         ctx.scale, bias)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_train(q, k, v, causal=True, scale=None, plain=False,
                          stash=None, attn_mask=None):
    """Attention output with a gradient: K1 forward saving (out, lse), then
    K9 or K5 backward as ``bwd_uses_fused`` picks (plain versions on CPU
    tensors, or with ``plain=True``, the on-card reference). A key-level
    ``attn_mask`` rides the kernels as a key bias and gets no gradient; a
    general one goes to the plain attention under autograd
    (``plain_mask_routes``). ``stash``: a list that keeps (out, lse) of the
    first call, so a recompute of the same block reuses them instead of
    running K1 again (``recompute_granularity="core_attn"`` with
    ``flash_save_residuals``); it refuses a recompute under another mask."""
    global plain_mask_routes
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    bias, key_level = _key_bias_from_mask(attn_mask, q.shape[0], k.shape[1])
    if not key_level:
        plain_mask_routes += 1
        return _reference_attention(q, k, v, causal, scale,
                                    attn_mask=attn_mask)
    return _FlashCore.apply(q, k, v, bias, causal, scale, plain, stash,
                            _mask_key(attn_mask))
