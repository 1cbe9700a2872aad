from .common import Embedding, Linear
from .layer import Layer
from .norm import RMSNorm

__all__ = ["Embedding", "Layer", "Linear", "RMSNorm"]
