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

from ..framework.contract import refuse_unported


class Layer(nn.Module):
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None, std=None, fill=None):
        """A new inference parameter, or None when ``attr`` is False (the
        JAX package's rule): ``fill`` sets every element (0 for a bias by
        default), else it is drawn from N(0, std²) with ``generator``.
        ``dtype`` defaults to f32. Parameter attributes and initializer
        objects are not ported."""
        if attr is False:
            return None
        refuse_unported("Layer.create_parameter", attr=(attr, None),
                        default_initializer=(default_initializer, None))
        if is_bias and fill is None and std is None:
            fill = 0.0
        data = torch.empty(tuple(shape), dtype=dtype or torch.float32,
                           device=device)
        if fill is not None:
            data.fill_(fill)
        else:
            data.normal_(0.0, std, generator=generator)
        return nn.Parameter(data, requires_grad=False)

    def train(self, *, mode: bool = True):
        """Training mode on (``mode``) or off, with the parameters' gradients
        on or off to match, over every sublayer."""
        for m in self.modules():
            m.training = mode
            for p in m.parameters(recurse=False):
                p.requires_grad_(mode)
        return self

    def eval(self):
        return self.train(mode=False)

    def param_dict(self) -> dict:
        """``{name: tensor}`` over every parameter (JAX-package names)."""
        return {n: p.detach() for n, p in self.named_parameters()}
