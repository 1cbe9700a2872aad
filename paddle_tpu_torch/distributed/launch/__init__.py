"""One node's launcher: ``python -m paddle_tpu_torch.distributed.launch``."""
