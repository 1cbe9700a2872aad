"""Runtime flags — the port's own copy of ``paddle_tpu/framework/flags.py``.

Same surface: every flag is overridable through a ``FLAGS_<name>``
environment variable and through :func:`set_flags`. Only the flags this
package reads are registered.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "default", "value", "help", "type")

    def __init__(self, name: str, default: Any, help_str: str):
        self.name = name
        self.default = default
        self.help = help_str
        self.type = type(default)
        env = os.environ.get("FLAGS_" + name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, text: str) -> Any:
        if self.type is bool:
            return text.lower() in ("1", "true", "yes", "on")
        if self.type is int:
            return int(text)
        if self.type is float:
            return float(text)
        return text


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    with _lock:
        if name not in _registry:
            _registry[name] = _Flag(name, default, help_str)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"Unknown flag: {name}")
    return key


def get_flag(name: str) -> Any:
    return _registry[_key(name)].value


def set_flags(flags: Dict[str, Any]) -> None:
    for n, v in flags.items():
        f = _registry[_key(n)]
        f.value = (f._parse(v) if isinstance(v, str) and f.type is not str
                   else f.type(v))


define_flag("fused_decode", True,
            "Decode-step op chains route through the fusion pass "
            "(ops/kernels/fusion.py): rms_norm folds into the following "
            "matmul and rope+KV-append+paged-attention collapse into one "
            "kernel. Off = the unfused op-by-op chain.")
define_flag("fused_decode_fusions", "norm_matmul,rope_append_attend",
            "Comma-separated subset of the fusion pass's patterns to "
            "enable (under fused_decode): 'norm_matmul' and/or "
            "'rope_append_attend'.")
define_flag("ragged_batching", True,
            "ContinuousBatcher admission uses token-budget scheduling: one "
            "ragged dispatch per step mixes up to prefill_chunk new prompt "
            "tokens with every active decode slot (no bucket padding, no "
            "separate prefill phase). Off = the power-of-two bucketed "
            "prefill pipeline (not ported yet: the batcher raises).")
define_flag("prefix_caching", True,
            "ContinuousBatcher admission shares already-computed prompt "
            "pages through a radix-tree prefix index (not ported yet: a "
            "batcher that resolves it on raises; pass prefix_caching=False).")
define_flag("spec_decode", False,
            "Self-speculative decoding in the ContinuousBatcher (ragged "
            "path, greedy only): each wave verifies every decoding slot's "
            "current token plus up to spec_k drafted tokens "
            "(inference/speculative.py) and keeps the longest matching "
            "prefix plus a bonus token; tokens equal spec-off decoding.")
define_flag("spec_k", 4,
            "Draft tokens proposed per slot per speculative step (the "
            "verify segment is spec_k + 1 rows).")
define_flag("lora_serving", False,
            "Batched multi-LoRA serving in the ContinuousBatcher (ragged "
            "path only; not ported yet: a batcher that resolves it on "
            "raises).")
define_flag("kv_host_tier", True,
            "Second KV page arena in host RAM behind the prefix cache; "
            "active only with prefix_caching (not ported yet).")
define_flag("unified_arena", True,
            "One typed HBM page economy across KV pages and adapter "
            "slots; active only with prefix_caching (not ported yet).")
define_flag("fused_train", True,
            "Training forward/backward/update routes through the fusion "
            "pass's training twin (ops/kernels/fusion.py TRAIN_CHAIN): "
            "rms_norm folds into the following matmuls (K2 per consumer, "
            "one gradient for the norm weight), the o-proj + residual add "
            "ride the attention output as epilogue ops, and the AdamW8bit "
            "update runs as one sweep (K8). Off = the unfused train plan "
            "(norms through K6/K7).")
define_flag("fused_train_fusions",
            "norm_matmul,attn_epilogue,optimizer_update,moe_grouped_bwd",
            "Comma-separated subset of the train fusion pass's families to "
            "enable (under fused_train): 'norm_matmul', 'attn_epilogue', "
            "'optimizer_update' and/or 'moe_grouped_bwd' (the MoE "
            "backward's per-expert dW through the segment-dW kernel K14, "
            "its cast riding as an epilogue op).")
define_flag("flash_bwd_impl", "split",
            "Flash-attention backward: 'split' = the dq + dkv kernels (K5); "
            "'fused' = the one-pass kernel (K9) wherever the JAX package "
            "takes its fused backward (its dQ partials within 512 MiB, "
            "flash_attention.bwd_uses_fused), K5 elsewhere.")
define_flag("flash_save_residuals", False,
            "core_attn recompute keeps the attention's (out, lse) from the "
            "first forward, so the recompute in backward skips the K1 "
            "re-run. Off (the JAX package's default) = the recompute runs "
            "the flash forward again.")
define_flag("grouped_matmul_kernel", True,
            "Grouped (segmented) matmul over expert-sorted token rows runs "
            "the grouped kernel (ops/kernels/grouped_matmul.py, K13): one "
            "grid walks per-expert contiguous row blocks described by a "
            "group_offsets vector, group boundaries handled in-kernel (no "
            "per-expert padding). Off = the plain per-expert slices, on "
            "CPU tensors only: a CUDA tensor raises.")
define_flag("moe_dropless", True,
            "MoE routing uses the sort-based dropless fast path: top-k "
            "gating -> argsort by expert id -> grouped SwiGLU through the "
            "grouped matmul -> combine by weight. Every routed token is "
            "computed (dropped_token_rate == 0 by construction); FLOPs "
            "scale with tokens actually routed. Off = the GShard "
            "dense-einsum dispatch with capacity padding and overflow "
            "drops.")
