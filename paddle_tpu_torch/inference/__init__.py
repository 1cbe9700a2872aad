"""Serving engines (``paddle_tpu/inference/``): the continuous batcher."""

from .continuous_batching import Backpressure, ContinuousBatcher, GenRequest

__all__ = ["Backpressure", "ContinuousBatcher", "GenRequest"]
