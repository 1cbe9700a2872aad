"""Kernel wrappers — counterparts of ``paddle_tpu/ops/pallas/`` by file name.

Each module holding a kernel keeps a plain PyTorch version beside it and a
plain-integer launch counter that only its launch site increments
(``fused_rope_attend`` keeps one per entry form; ``flash_attention`` and
``fused_norm_rope`` one per direction; ``grouped_matmul`` one for K13, both
forms, and one for K14).
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
    ("rms_norm_fwd", fused_norm_rope, "fwd_launches"),
    ("rms_norm_bwd", fused_norm_rope, "bwd_launches"),
    ("adamw8bit", fused_optimizer_update, "launches"),
    ("grouped_matmul", grouped_matmul, "launches"),
    ("segment_dw", grouped_matmul, "dw_launches"),
)


def reset_launch_counts() -> None:
    for _, mod, attr in KERNEL_COUNTERS:
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    """``{count name: launches}`` since the last reset."""
    return {name: getattr(mod, attr) for name, mod, attr in KERNEL_COUNTERS}
