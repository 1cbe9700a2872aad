"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``framework/``, ``nn/``, ``jit/``, ``models/``,
``ops/kernels/`` beside ``ops/pallas/``) so each counterpart is easy to
find. It imports ``torch`` and numpy only — never ``jax`` and never
``paddle_tpu``.

It serves Llama greedy paged decoding
(``models.llama.LlamaForCausalLM.generate_paged``) on one NVIDIA H100, in
bf16 or with weight-only int8/int4 weights and an int8 KV cache
(``quantize_for_inference``, ``cache_dtype="int8"``), and through the
continuous batcher (``inference.ContinuousBatcher``); it trains Llama
and the dropless mixture-of-experts family (``models.moe``) with
``jit.TrainStep`` and ``optimizer.AdamW`` / ``AdamW8bit``. Its
hand-written CUDA kernels live under ``csrc/``:

  flash_attention_fwd / _bwd  causal GQA attention, forward and backward
  norm_matmul                 rms_norm folded into every following matmul
                              (dense, int8 or int4 weights)
  rope_append_attend          per-layer decode / ragged attention tail
  paged_attention, ragged_paged_attention   decode and ragged attention
  quant_matmul                weight-only int8/int4 matmul
  rms_norm_fwd / _bwd         RMSNorm forward and backward (training)
  adamw8bit                   the one-sweep AdamW8bit update
  grouped_matmul, segment_dw  the MoE experts' grouped matmul (forward and
                              dX) and per-expert dW

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
