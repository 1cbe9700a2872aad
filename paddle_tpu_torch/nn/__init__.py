from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .common import Embedding, Linear
from .layer import Layer
from .norm import RMSNorm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "Layer", "Linear", "RMSNorm", "clip_grad_norm_"]
