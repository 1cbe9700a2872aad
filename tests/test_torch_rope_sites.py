"""K12 (rope) where the port computes it, on CPU: bits and launch plans.

The training attend seam (``llama._train_attend``), the solo prefill
(``generate_paged``) and the prompt-logits forward (``prompt_logits_pure``)
rope q and k through ``fused_norm_rope.fused_rope`` (K12 on the card).
The reference is ``apply_rotary_pos_emb`` on f32 copies, cast back:
``_chain`` below. Both compute every product and the sum as separately
rounded f32 ops with one cast at the end, and the chain's autograd
backward equals the rope with ``rope_bwd_table(sin)`` (negation is exact,
IEEE addition commutes; the chain's slice backward adds +0.0 where K12
adds a product, which can change only the sign of an exact zero, and
``torch.equal`` does not see that sign). So on the same inputs:

  * ``fused_rope`` / ``rope_fwd`` and the chain agree bit for bit, forward
    and the autograd gradient of q and k, at a small GQA shape, bf16 and
    f32, with the model's tables and with random ones; ``rope_fwd(...,
    transpose=True)`` is that gradient;
  * the seam's output and its q/k/v gradients, the prompt logits, and the
    prefill's tokens and logits equal those of a run with the chain in
    ``fused_rope``'s place;
  * ``fused_rope`` agrees with the JAX package's ``apply_rotary_pos_emb``
    (the reference's rope in these sites) within 3e-6 in f32 (XLA may
    contract the products into a fused multiply-add);
  * ``rope_plan`` takes the vector instance exactly where D/2 is a
    multiple of 16 bytes of elements, and its items cover every element
    of x once (a Python model of the kernel's index math);
  * the launch plans count K12 (``fusion.rope_launches_per_step``): by
    hand, with and without recompute, and a CPU train step calls K12's
    plain version as often as the plan says K12 launches; a prefill ropes
    q and k once a layer and a decode step not at all.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import llama as jllama

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
from paddle_tpu_torch.ops.kernels import fusion

DTYPES = (torch.float32, torch.bfloat16)
#: a GQA seam: B, S, q heads, kv heads, head_dim
GQA = (2, 12, 4, 2, 16)


def _chain(q, k, cos, sin):
    """The f32 rotate-half chain: f32 copies, cast back."""
    q2, k2 = tllama.apply_rotary_pos_emb(q.float(), k.float(), cos, sin)
    return q2.to(q.dtype), k2.to(k.dtype)


def _chain_rope(x, cos, sin, plain=False):
    """``_chain`` of one tensor, in ``fused_rope``'s signature."""
    return _chain(x, x, cos, sin)[0]


def _inputs(dtype, seed, random_tables):
    b, s, h, hk, d = GQA
    rng = np.random.default_rng(seed)
    q, gq = (torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
             .to(dtype) for _ in range(2))
    k, gk = (torch.from_numpy(rng.standard_normal((b, s, hk, d), np.float32))
             .to(dtype) for _ in range(2))
    if random_tables:
        emb = torch.from_numpy(rng.standard_normal((s, d), np.float32))
        cos, sin = emb.cos(), emb.sin()
    else:
        cos, sin = tllama._rope_tables(s, d, 10000.0)
    return q, k, gq, gk, cos, sin


def _grads(fn, q, k, gq, gk):
    qq, kk = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
    q2, k2 = fn(qq, kk)
    torch.autograd.backward((q2, k2), (gq, gk))
    return q2.detach(), k2.detach(), qq.grad, kk.grad


@pytest.mark.parametrize("random_tables", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_rope_equals_the_chain_bitwise(dtype, random_tables):
    q, k, gq, gk, cos, sin = _inputs(dtype, 3, random_tables)
    got = _grads(lambda a, b: (k67.fused_rope(a, cos, sin),
                               k67.fused_rope(b, cos, sin)), q, k, gq, gk)
    plain = _grads(lambda a, b: (k67.fused_rope(a, cos, sin, plain=True),
                                 k67.fused_rope(b, cos, sin, plain=True)),
                   q, k, gq, gk)
    want = _grads(lambda a, b: _chain(a, b, cos, sin), q, k, gq, gk)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == dtype and torch.equal(g, w) and torch.equal(p, w)
    assert torch.equal(k67.rope_fwd(q, cos, sin), want[0])
    assert torch.equal(k67.rope_fwd(gq, cos, sin, transpose=True), want[2])
    assert torch.equal(k67.rope_fwd(gk, cos, sin, transpose=True), want[3])
    assert k67.rope_launches == 0


def test_fused_rope_matches_jax():
    q, k, _, _, cos, sin = _inputs(torch.float32, 5, False)
    jq, jk = jllama.apply_rotary_pos_emb(
        *(jnp.asarray(a.numpy()) for a in (q, k, cos, sin)))
    for x, j in ((q, jq), (k, jk)):
        np.testing.assert_allclose(k67.fused_rope(x, cos, sin).numpy(),
                                   np.asarray(j), rtol=0, atol=3e-6)


# (B, S, H, D, itemsize) -> (vec, tpr, rpt, chunks, ppc, items), by hand
PLANS = {
    (4, 2048, 32, 128, 2): (8, 8, 32, 1, 1, 2048),   # train q, bf16
    (4, 2048, 8, 128, 2): (8, 8, 8, 1, 4, 512),      # train k, bf16
    (4, 2048, 32, 128, 4): (4, 16, 16, 2, 1, 4096),  # f32
    (4, 2048, 8, 128, 4): (4, 16, 8, 1, 2, 1024),
    (8, 128, 32, 128, 2): (8, 8, 32, 2, 1, 256),     # prefill q: 256 rows
    (2, 37, 3, 128, 2): (8, 8, 2, 1, 16, 3),         # the card tests' shapes
    (4, 64, 8, 128, 4): (4, 16, 8, 1, 2, 32),
    (1, 5, 2, 6, 4): (1, 3, 1, 1, 5, 1),             # scalar: D/2 = 3
    (1, 9, 1, 250, 2): (1, 125, 1, 1, 2, 5),         # scalar: D/2 = 125
    (2, 7, 3, 16, 2): (8, 1, 2, 1, 7, 1),            # D/2 = 8: vector
    (2, 7, 3, 14, 2): (1, 7, 2, 1, 7, 1),            # D/2 = 7: scalar
    (2, 7, 3, 8, 4): (4, 1, 2, 1, 7, 1),             # D/2 = 4: vector
    (2, 7, 3, 12, 4): (1, 6, 2, 1, 7, 1),            # D/2 = 6: scalar
    (64, 1, 32, 128, 2): (8, 8, 32, 16, 1, 16),      # one position
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_rope_plan(shape):
    assert k67.rope_plan(*shape) == PLANS[shape]


def _covered(b, s, h, d, itemsize):
    """How often the kernel's threads write each element of (B, S, H, D):
    ``rope_kernel``'s index math in Python over every item and thread."""
    vec, tpr, rpt, chunks, ppc, items = k67.rope_plan(b, s, h, d, itemsize)
    half, rows, n = d // 2, b * h, k67.ROPE_ROWS
    hits = np.zeros((b, s, h, d), np.int32)
    for it in range(items):
        pg, ch = divmod(it, chunks)
        for slot in range(ppc):
            pos = pg * ppc + slot
            if pos >= s:
                continue
            for rt in range(rpt):
                j0 = ch * rpt * n + rt
                j_end = min(rows, ch * rpt * n + rpt * n)
                for j in (j0 + u * rpt for u in range(n)):
                    if j >= j_end:
                        continue
                    bi, hi = divmod(j, h)
                    for cg in range(tpr):
                        for c in range(cg * vec, half, tpr * vec):
                            hits[bi, pos, hi, c:c + vec] += 1
                            hits[bi, pos, hi, half + c:half + c + vec] += 1
    return hits


@pytest.mark.parametrize("shape", [(2, 7, 3, 16, 2), (2, 7, 3, 14, 2),
                                   (2, 37, 3, 128, 2), (1, 9, 1, 250, 2),
                                   (64, 1, 32, 128, 2), (3, 5, 2, 8, 4),
                                   (1, 2, 1, 4112, 2), (1, 2, 2, 1026, 2)])
def test_rope_items_cover_every_element_once(shape):
    assert (_covered(*shape) == 1).all()


def _chain_train_attend(cfg, q, k, v):
    """The seam with ``_chain``, then the same flash attention."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_train)

    b, s = q.shape[:2]
    nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    cos, sin = tllama._rope_tables(s, hd, cfg.rope_theta)
    q2, k2 = _chain(q.reshape(b, s, nh, hd), k.reshape(b, s, hk, hd), cos,
                    sin)
    return flash_attention_train(q2, k2, v.reshape(b, s, hk, hd),
                                 causal=True).reshape(b, s, nh * hd)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_attend_equals_the_chain_seam_bitwise(dtype):
    cfg = LlamaConfig.tiny()
    b, s, nh, hk, hd = 2, 12, 4, 2, cfg.head_dim
    rng = np.random.default_rng(7)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dtype)

    q, k, v = rnd(b, s, nh * hd), rnd(b, s, hk * hd), rnd(b, s, hk * hd)
    g = rnd(b, s, nh * hd)
    runs = []
    for seam in (lambda *a: tllama._train_attend(cfg, *a, False, None),
                 lambda *a: _chain_train_attend(cfg, *a)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = seam(*leaves)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        assert got.dtype == dtype and torch.equal(got, want)


def _ids(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_prompt_logits_and_prefill_equal_the_chain(monkeypatch):
    tiny_model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    cfg = tiny_model.config
    ids = _ids(cfg, 2, 11, 1)

    def run():
        logits = tiny_model(ids)
        toks, gen = tiny_model.generate_paged(ids, max_new_tokens=5,
                                              page_size=8,
                                              return_logits=True)
        return logits, toks, gen

    got = run()
    monkeypatch.setattr(k67, "fused_rope", _chain_rope)
    want = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_prefill_ropes_q_and_k_once_a_layer(monkeypatch):
    tiny_model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    calls = []
    orig = k67.rope_reference
    monkeypatch.setattr(k67, "rope_reference", lambda *a: (
        calls.append(a[0].shape), orig(*a))[1])
    cfg = tiny_model.config
    tiny_model.generate_paged(_ids(cfg, 2, 9, 2), max_new_tokens=4,
                              page_size=8)
    w = 16                 # the prompt's bucket: the smallest power of 2
    assert calls == [(2, w, cfg.num_attention_heads, cfg.head_dim),
                     (2, w, cfg.num_key_value_heads, cfg.head_dim)
                     ] * cfg.num_hidden_layers


def test_rope_launch_plans_by_hand():
    assert fusion.rope_launches_per_step(8, 2) == 48
    assert fusion.rope_launches_per_step(8) == 32
    on = dict(enabled=fusion.TRAIN_FUSIONS, fused_head_loss=True)
    for recompute, granularity, want in ((True, "core_attn", 48),
                                         (True, "full", 48),
                                         (False, "full", 32)):
        plan = fusion.train_kernel_launches_per_step(
            8, 75, recompute=recompute, granularity=granularity, **on)
        assert plan["fused_rope"] == want
    unfused = fusion.train_kernel_launches_per_step(
        8, 75, recompute=True, enabled=(), fused_head_loss=True)
    assert unfused["fused_rope"] == 48
    assert fusion.moe_train_kernel_launches_per_step(
        3, 33, enabled=fusion.TRAIN_FUSIONS)["fused_rope"] == 12
    assert fusion.moe_train_kernel_launches_per_step(
        1, 0, quantized_experts=True)["fused_rope"] == 4


@pytest.mark.parametrize("recompute", (False, True))
def test_train_step_ropes_as_the_plan_says(recompute, monkeypatch):
    calls = [0]
    orig = k67.rope_reference

    def counted(*a):
        calls[0] += 1
        return orig(*a)

    monkeypatch.setattr(k67, "rope_reference", counted)
    cfg = LlamaConfig.tiny(recompute=recompute,
                           recompute_granularity="core_attn")
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    step = TrainStep(model, lambda o, lb: model.loss(o, lb),
                     topt.AdamW(learning_rate=1e-3,
                                parameters=model.parameters()))
    ids = torch.tensor(_ids(cfg, 2, 10, 4)).long()
    step(ids, ids)
    plan = fusion.train_kernel_launches_per_step(
        cfg.num_hidden_layers, sum(1 for _ in model.parameters()),
        recompute=recompute, granularity="core_attn",
        fused_head_loss=cfg.fused_head_loss, optimizer="adamw")
    assert calls[0] == plan["fused_rope"] == (
        cfg.num_hidden_layers * (6 if recompute else 4))
