"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``framework/``, ``nn/``, ``jit/``, ``models/``,
``ops/kernels/`` beside ``ops/pallas/``) so each counterpart is easy to
find. It imports ``torch`` and numpy only — never ``jax`` and never
``paddle_tpu``.

The first slice is Llama greedy paged serving
(``models.llama.LlamaForCausalLM.generate_paged``) on one NVIDIA H100,
with three hand-written CUDA kernels under ``csrc/``:

  flash_attention_fwd         prefill causal GQA attention
  norm_matmul                 rms_norm folded into every following matmul
  rope_append_attend_decode   per-layer decode attention tail

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
