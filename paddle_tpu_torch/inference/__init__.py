"""Serving engines (``paddle_tpu/inference/``): the continuous batcher, and
the elastic fleet's load generator and autoscaler (``inference.loadgen``,
``inference.autoscaler``)."""

from . import autoscaler, loadgen
from .continuous_batching import Backpressure, ContinuousBatcher, GenRequest

__all__ = ["Backpressure", "ContinuousBatcher", "GenRequest", "autoscaler",
           "loadgen"]
