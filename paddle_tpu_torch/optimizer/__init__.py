from . import lr
from .lr import LRScheduler
from .optimizer import Optimizer
from .optimizers import AdamW, AdamW8bit

__all__ = ["AdamW", "AdamW8bit", "LRScheduler", "Optimizer", "lr"]
