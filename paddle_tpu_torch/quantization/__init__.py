"""Quantization rules (``paddle_tpu/quantization/``): only what the
weight-only serving path needs, the group-wise absmax scale rule."""
