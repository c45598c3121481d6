"""Weight initialisation from an explicit ``torch.Generator``.

The reference's registry (models/networks.py:40-61; JAX ``ops/init.py``):
``normal`` N(0, gain²), ``xavier`` N(0, gain²·2/(fan_in+fan_out)),
``kaiming`` N(0, 2/fan_in), ``orthogonal`` with scale ``gain``; biases zero.
Values are drawn on the CPU from the caller's generator and then copied into
the parameter, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _fans(shape) -> tuple:
    """torch's fan rule: dim 1 is fan-in, dim 0 fan-out, × receptive field."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def init_tensor(t: torch.Tensor, init_type: str, gain: float,
                generator: torch.Generator) -> None:
    shape = tuple(t.shape)
    if init_type == "orthogonal":
        rows, cols = shape[0], math.prod(shape[1:])
        a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                        dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        w = gain * q.reshape(shape)
    else:
        fan_in, fan_out = _fans(shape)
        if init_type == "normal":
            std = gain
        elif init_type == "xavier":
            std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        elif init_type == "kaiming":
            std = math.sqrt(2.0 / fan_in)
        else:
            raise NotImplementedError(
                f"initialization method [{init_type}] is not implemented")
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    with torch.no_grad():
        t.copy_(w)


def init_weights(net: nn.Module, init_type: str = "normal", gain: float = 0.02,
                 generator: torch.Generator = None) -> nn.Module:
    """Initialise every conv of ``net`` in module order; zero the biases."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            init_tensor(m.weight, init_type, gain, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net
