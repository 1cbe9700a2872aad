"""Kernel wrappers — counterparts of ``paddle_tpu/ops/pallas/`` by file name.

Each module holding a kernel keeps a plain PyTorch version beside it and a
plain-integer ``launches`` counter that only its launch site increments.
"""

from . import (flash_attention, fused_norm_matmul, fused_rope_attend,
               quant_matmul)

#: the modules whose wrappers launch a kernel
KERNEL_MODULES = (flash_attention, fused_norm_matmul, fused_rope_attend,
                  quant_matmul)


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts() -> dict:
    """``{module short name: launches}`` since the last reset."""
    return {mod.__name__.rsplit(".", 1)[1]: mod.launches
            for mod in KERNEL_MODULES}
