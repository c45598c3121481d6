"""Layers of the port's generators (NCHW), counterparts of the JAX package's
``ops/layers.py``.

Convolutions are ``nn.Conv2d`` / ``nn.ConvTranspose2d``: the JAX package
leaves them to XLA outside any Pallas kernel, and cuDNN takes their place
here. The TPU layout tricks of the JAX module (``conv3x3_reflect``,
``_conv_transpose_s2_phases``) have no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .kernels.instance_norm import instance_norm


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NCHW reflection padding (= ``nn.ReflectionPad2d``)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False, track_running_stats=False), eps 1e-5: the
    InstanceNorm kernel. (The JAX module's affine option has no caller.)"""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


def Norm(kind: str) -> nn.Module:
    """Norm-layer factory: 'instance' | 'none' (the reference's strings)."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization layer [{kind}] is not found")


def norm_uses_bias(kind: str) -> bool:
    """The reference's conv-bias rule: a conv before a norm has a bias
    unless the norm is BatchNorm (reference models/networks.py:152-155)."""
    return kind != "batch"
