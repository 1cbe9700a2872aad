"""Kernel wrappers — counterparts of ``paddle_tpu/ops/pallas/`` by file name.

Each module holding a kernel keeps a plain PyTorch version beside it and a
plain-integer launch counter that only its launch site increments (under
``_build.count``'s lock: serving threads launch at once)
(``fused_rope_attend`` keeps one per entry form; ``flash_attention`` one
for K1, K5 and K9 each; ``fused_norm_rope`` one per RMSNorm direction and
one for K12, both directions; ``grouped_matmul`` one for K13's bf16
forward and dX forms, one for its int8/int4 forms and one for K14). ``ROUTE_COUNTERS`` count routes that are not kernel
launches: a general attention mask sent to the plain attention.
"""

from . import (flash_attention, fused_norm_matmul, fused_norm_rope,
               fused_optimizer_update, fused_rope_attend, grouped_matmul,
               paged_attention, quant_matmul, ragged_paged_attention)

#: (count name, module, counter attribute) of every kernel's launch site
KERNEL_COUNTERS = (
    ("flash_attention", flash_attention, "launches"),
    ("fused_norm_matmul", fused_norm_matmul, "launches"),
    ("fused_rope_attend", fused_rope_attend, "launches"),
    ("fused_rope_attend_ragged", fused_rope_attend, "ragged_launches"),
    ("paged_attention", paged_attention, "launches"),
    ("ragged_paged_attention", ragged_paged_attention, "launches"),
    ("quant_matmul", quant_matmul, "launches"),
    ("flash_attention_bwd", flash_attention, "bwd_launches"),
    ("flash_attention_bwd_fused", flash_attention, "bwd_fused_launches"),
    ("rms_norm_fwd", fused_norm_rope, "fwd_launches"),
    ("rms_norm_bwd", fused_norm_rope, "bwd_launches"),
    ("adamw8bit", fused_optimizer_update, "launches"),
    ("grouped_matmul", grouped_matmul, "launches"),
    ("grouped_matmul_quant", grouped_matmul, "quant_launches"),
    ("segment_dw", grouped_matmul, "dw_launches"),
    ("fused_rope", fused_norm_rope, "rope_launches"),
)

#: (count name, module, counter attribute) of every plain route
ROUTE_COUNTERS = (
    ("plain_attention_route", flash_attention, "plain_mask_routes"),
)


def reset_launch_counts() -> None:
    """Set every kernel's and every route's count to 0."""
    for _, mod, attr in KERNEL_COUNTERS + ROUTE_COUNTERS:
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    """``{count name: launches}`` since the last reset."""
    return {name: getattr(mod, attr) for name, mod, attr in KERNEL_COUNTERS}


def route_counts() -> dict:
    """``{route name: calls}`` since the last reset."""
    return {name: getattr(mod, attr) for name, mod, attr in ROUTE_COUNTERS}
