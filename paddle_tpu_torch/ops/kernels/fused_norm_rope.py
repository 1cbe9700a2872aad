"""RMSNorm and rope (``paddle_tpu/ops/pallas/fused_norm_rope.py``).

Kernel K6 (``csrc/rms_norm.cu``, ``pt_rms_norm_fwd``) replaces the TPU's
``_pallas_rms_fwd``: out = bf16((x * rstd) * w), rounded once, saving rstd.
Kernel K7 (``pt_rms_norm_bwd``) replaces ``_pallas_rms_bwd``:
dx = rstd * (g*w - xhat * mean(g*w*xhat)) and dw = sum_rows(g * xhat), in
two launches of one entry point (booked together as K7, one count a
call): ``rms_bwd_kernel`` on min(N, SMs) CTAs, each a run of rows whose x
and g stream into a ring of shared-memory row slots (a warp reduces a
row with shuffles and writes its dx; every thread keeps its columns' dw
partial), then ``rms_dw_sum_kernel``, which sums the CTAs' partials in a
fixed order (``bwd_plan`` models the split). Bound: bytes (one read of x
and g, one write of out or dx).

``fused_rms_norm`` is the ``autograd.Function`` over the two: on CUDA
tensors the wrappers launch their kernel or raise, on CPU tensors they run
the plain versions below, which follow the kernels' numerics (one rounding
of the output, as ``_rms_fwd_kernel``; the JAX package's ``_jnp_rms`` rounds
twice in bf16 — in f32 the two agree).

Kernel K12 (``csrc/rope.cu``, ``pt_rope``) replaces ``_pallas_rope``: the
rotate-half rope x * cos + concat(-x2, x1) * sin in f32 over (B, S, H, D)
rows with (S, D) tables, cast back to x's dtype. ``fused_rope`` is its
``autograd.Function`` (the JAX package's ``_rope_core`` custom VJP): the
backward is K12's transposed instance, the rope with sin' =
-swap_halves(sin) (``_rope_bwd``) read from sin itself, one launch.
``rope_plan`` gives its split into CTAs. The training attend seam, the
solo prefill and the prompt-logits forward (``models/llama.py``) rope q
and k through it; its bits equal those of the f32 rotate-half chain
(``apply_rotary_pos_emb`` on f32 copies, cast back). Bound: bytes.
"""

from __future__ import annotations

import torch

from . import _build

#: K6 and K7 launches since the last reset (incremented only where each
#: launches)
fwd_launches = 0
bwd_launches = 0
#: K12 launches since the last reset, forward and backward
rope_launches = 0

#: the kernels hold a row in registers: H <= 256 threads * 8 * 4 vectors
_MAX_H = 8192
#: the H100's SMs: K7's grid is min(N, SMs) CTAs
H100_SMS = 132
#: K7's ring of row slots (``bwd_slots`` in ``csrc/rms_norm.cu``): each
#: slot holds a row of x and of g (4H bytes), ~128 KB in all, 2 to 16
_SLOT_BUDGET, _MAX_SLOTS = 128 << 10, 16
#: K12: rows a thread holds in flight, and the most threads a CTA
#: (``ROWS`` and ``THREADS`` in ``csrc/rope.cu``)
ROPE_ROWS, ROPE_THREADS = 4, 256


def bwd_plan(n, h, sms=H100_SMS):
    """K7's split of N rows of width H: (grid, slots, [(first row, rows)]
    of each CTA). The grid is min(N, SMs); CTA b takes rows
    N b / grid .. N (b + 1) / grid (floor), contiguous and in order, and
    writes one dw partial row; ``slots`` rows of x and g are in flight
    in its shared memory."""
    grid = min(n, sms)
    slots = min(max(_SLOT_BUDGET // (4 * h), 2), _MAX_SLOTS)
    runs = [(n * b // grid, n * (b + 1) // grid - n * b // grid)
            for b in range(grid)]
    return grid, slots, runs


def rms_norm_fwd_reference(x2, w, eps):
    """K6's plain version: (out (N, H) in x's dtype, rstd (N,) f32)."""
    x32 = x2.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (x32 * rstd * w.float()).to(x2.dtype)
    return out, rstd[:, 0]


def rms_norm_bwd_reference(x2, w, rstd, g2):
    """K7's plain version: (dx (N, H) in x's dtype, dw (H,) f32)."""
    x32, g32, w32 = x2.float(), g2.float(), w.float()
    xhat = x32 * rstd[:, None]
    gw = g32 * w32
    m = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[:, None] * (gw - xhat * m)).to(x2.dtype)
    return dx, (g32 * xhat).sum(dim=0)


def tolerances(x2, w, g2, ref_out, ref_dx, ref_dw):
    """Per-element bounds on |K6/K7 - plain| for (out, rstd, dx, dw), from
    the inputs. The versions sum in different orders and K6 takes rstd
    from ``rsqrtf`` (2 ulp), so rstd may differ by ~1e-6 relative; out and
    dx are then rounded to bf16 once each (one ulp, <= 1e-2 * |ref|). dx
    subtracts two terms that may cancel: its f32 difference is bounded by
    1e-5 * rstd * (|g*w| + |xhat| * mean|g*w*xhat|); dw (f32, summed over
    rows) by 1e-5 * sum_rows |g * xhat|."""
    x32, g32, w32 = x2.float(), g2.float(), w.float()
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True))
    xhat, gw = (x32 * rstd).abs(), (g32 * w32).abs()
    big = (gw * xhat).mean(dim=-1, keepdim=True)
    t_out = 1e-2 * ref_out.float().abs() + 1e-6
    t_dx = (1e-2 * ref_dx.float().abs() + 1e-5 * rstd * (gw + xhat * big)
            + 1e-6)
    t_dw = 1e-5 * (g32.abs() * xhat).sum(dim=0) + 1e-6
    return t_out, t_dx, t_dw


def _check_shapes(name, x2, w):
    n, h = x2.shape
    if h % 8 or h > _MAX_H:
        raise ValueError(f"{name} kernel needs H % 8 == 0 and H <= {_MAX_H}, "
                         f"got {h}")
    _build.check_cuda("x", x2, torch.bfloat16)
    _build.check_cuda("w", w, torch.bfloat16, (h,))
    return n, h


def rms_norm_fwd(x2, w, eps):
    """(out, rstd) for x2 (N, H) — K6 on CUDA tensors, the plain version on
    CPU tensors."""
    if not x2.is_cuda:
        return rms_norm_fwd_reference(x2, w, eps)
    _build.check_no_grad("rms_norm_fwd", x2, w)
    n, h = _check_shapes("rms_norm_fwd", x2, w)
    out = torch.empty_like(x2)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    _build.launch("pt_rms_norm_fwd", x2.data_ptr(), w.data_ptr(),
                  out.data_ptr(), rstd.data_ptr(), n, h, float(eps),
                  _build.stream_of(x2))
    _build.count(globals(), "fwd_launches")
    return out, rstd


def rms_norm_bwd(x2, w, rstd, g2):
    """(dx, dw f32) — K7 on CUDA tensors (its CTAs' dw partials summed by
    its second kernel), the plain version on CPU tensors."""
    if not x2.is_cuda:
        return rms_norm_bwd_reference(x2, w, rstd, g2)
    _build.check_no_grad("rms_norm_bwd", x2, w, g2)
    n, h = _check_shapes("rms_norm_bwd", x2, w)
    _build.check_cuda("rstd", rstd, torch.float32, (n,))
    _build.check_cuda("g", g2, torch.bfloat16, (n, h))
    dx = torch.empty_like(x2)
    if not n:
        return dx, torch.zeros((h,), dtype=torch.float32, device=x2.device)
    dw = torch.empty((h,), dtype=torch.float32, device=x2.device)
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    grid = bwd_plan(n, h, sms)[0]
    parts = torch.empty((grid, h), dtype=torch.float32, device=x2.device)
    _build.launch("pt_rms_norm_bwd", x2.data_ptr(), w.data_ptr(),
                  rstd.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                  parts.data_ptr(), dw.data_ptr(), n, h, grid,
                  _build.stream_of(x2))
    _build.count(globals(), "bwd_launches")
    return dx, dw


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon, plain):
        h = x.shape[-1]
        x2 = x.reshape(-1, h)
        fwd = rms_norm_fwd_reference if plain else rms_norm_fwd
        out, rstd = fwd(x2, weight, epsilon)
        ctx.save_for_backward(x2, weight, rstd)
        ctx.plain = plain
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, weight, rstd = ctx.saved_tensors
        bwd = rms_norm_bwd_reference if ctx.plain else rms_norm_bwd
        dx, dw = bwd(x2, weight, rstd, g.reshape(x2.shape).contiguous())
        return dx.reshape(g.shape), dw.to(weight.dtype), None, None


def fused_rms_norm(x, weight, epsilon=1e-6, plain=False):
    """rms_norm(x, w) over the last dim with a gradient: K6 forward saving
    rstd, K7 backward (plain versions on CPU tensors, or with ``plain``:
    the on-card reference)."""
    return _FusedRMSNorm.apply(x, weight, epsilon, plain)


# ---------------------------------------------------------------------------
# Rope (K12)
# ---------------------------------------------------------------------------


def rope_reference(x, cos, sin):
    """K12's plain version: x (B, S, H, D) with (S, D) tables ->
    x * cos + concat(-x2, x1) * sin in f32, cast back to x's dtype (the
    JAX package's ``_jnp_rope``, each op rounded once)."""
    half = x.shape[-1] // 2
    x32 = x.float()
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos[None, :, None, :].float()
            + rot * sin[None, :, None, :].float()).to(x.dtype)


def rope_plan(b, s, h, d, itemsize):
    """K12's split of x (B, S, H, D) with ``itemsize``-byte elements:
    (vec, tpr, rpt, chunks, ppc, items). A thread takes ``vec`` columns of
    a row's first half and the matching ones of its second: 16 bytes
    (8 bf16, 4 f32) where D/2 % vec == 0 (the vector instance), else 1
    (the scalar instance). A CTA is tpr threads a row (one a column group,
    at most ROPE_THREADS; more groups loop) x rpt row threads x ppc
    positions. The B x H rows of a position share its tables; a thread
    takes ROPE_ROWS of them at once, so rpt covers a position's rows in
    ROPE_ROWS passes where the CTA allows, and ppc fills the rest of the
    CTA with further positions. An item is ppc positions x a chunk of
    rpt x ROPE_ROWS rows (``chunks`` a position); the grid walks the
    items."""
    half = d // 2
    vec = 16 // itemsize
    if half % vec:
        vec = 1
    tpr = min(half // vec, ROPE_THREADS)
    rows = b * h
    rpt = max(1, min(-(-rows // ROPE_ROWS), ROPE_THREADS // tpr))
    ppc = max(1, min(ROPE_THREADS // (tpr * rpt), s))
    chunks = -(-rows // (rpt * ROPE_ROWS))
    return vec, tpr, rpt, chunks, ppc, -(-s // ppc) * chunks


def rope_bwd_table(sin):
    """sin' = -swap_halves(sin): the rope with it is the rope's VJP
    (``_rope_bwd``), for any table."""
    half = sin.shape[-1] // 2
    return -torch.cat([sin[..., half:], sin[..., :half]], dim=-1)


def rope_fwd(x, cos, sin, transpose=False):
    """The rope of x (B, S, H, D) with (S, D) f32 tables, or with
    ``transpose`` its VJP (the rope with ``rope_bwd_table(sin)``) — K12 on
    CUDA tensors (the transposed instance reads sin swapped and negated:
    one launch), the plain version on CPU tensors."""
    if not x.is_cuda:
        return rope_reference(x, cos, rope_bwd_table(sin) if transpose
                              else sin)
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected bfloat16 or float32, got {x.dtype}")
    _build.check_no_grad("rope", x, cos, sin)
    _build.check_cuda("x", x, x.dtype)
    _build.check_cuda("cos", cos, torch.float32, (s, d))
    _build.check_cuda("sin", sin, torch.float32, (s, d))
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.launch("pt_rope", x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                  out.data_ptr(), b, s, h, d,
                  int(x.dtype == torch.bfloat16), int(transpose),
                  *rope_plan(b, s, h, d, x.element_size()), sms,
                  _build.stream_of(x))
    _build.count(globals(), "rope_launches")
    return out


class _FusedRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin, plain):
        ctx.save_for_backward(cos, sin)
        ctx.plain = plain
        return (rope_reference if plain else rope_fwd)(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        if ctx.plain:
            dx = rope_reference(g, cos, rope_bwd_table(sin))
        else:
            dx = rope_fwd(g.contiguous(), cos, sin, transpose=True)
        return dx, None, None, None


def fused_rope(x, cos, sin, plain=False):
    """Rotary position embedding of x (B, S, H, D) with (S, D) tables, with
    a gradient for x: K12 forward and its transposed instance backward
    (plain versions on CPU tensors, or with ``plain``: the on-card
    reference). The tables get no gradient, as in the JAX package."""
    return _FusedRope.apply(x, cos, sin, plain)
