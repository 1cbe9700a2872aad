"""``Layer``: the JAX package's module base, as an ``nn.Module``.

Parameters are created on an explicit device in an explicit dtype and
initialized from an explicit ``torch.Generator`` (``framework/random.py``);
the serving path reads them as a flat ``{name: tensor}`` dict, the shape
the JAX package's pure-array builders take.

Parameters take no gradient until ``train()``: ``layer.train()`` turns
training mode and ``requires_grad`` on for every parameter, ``eval()``
turns both off again (the serving entries read detached tensors either
way).
"""

from __future__ import annotations

import torch
from torch import nn


class Layer(nn.Module):
    def create_parameter(self, shape, dtype, device, generator=None,
                         std=None, fill=None) -> nn.Parameter:
        """A new inference parameter: ``fill`` sets every element, else it
        is drawn from N(0, std²) with ``generator``."""
        data = torch.empty(tuple(shape), dtype=dtype, device=device)
        if fill is not None:
            data.fill_(fill)
        else:
            data.normal_(0.0, std, generator=generator)
        return nn.Parameter(data, requires_grad=False)

    def train(self, mode: bool = True):
        """Training mode on (``mode``) or off, with the parameters' gradients
        on or off to match."""
        super().train(mode)
        for p in self.parameters(recurse=False):
            p.requires_grad_(mode)
        return self

    def param_dict(self) -> dict:
        """``{name: tensor}`` over every parameter (JAX-package names)."""
        return {n: p.detach() for n, p in self.named_parameters()}
