"""ResnetGenerator (the CycleGAN generator) in PyTorch, NCHW.

The counterpart of ``ResnetBlock``, ``ResnetGenerator`` and ``define_G`` in
the JAX package's ``models/networks.py``. Modules sit in one
``nn.Sequential`` exactly as the reference builds them
(reference models/networks.py:145-236), so ``state_dict()`` keys are the
reference's: ``model.1`` (conv_in), ``model.4``/``model.7`` (down),
``model.{10+i}.conv_block.{1, 5|6}`` (block convs; 6 with dropout),
``model.{10+n}``/``model.{13+n}`` (ConvTranspose up), ``model.{17+n}``
(conv_out). A reference ``.pth`` loads with ``load_state_dict``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.init import init_weights
from ..ops.layers import Norm


class ResnetBlock(nn.Module):
    """reflect-pad→conv3×3→norm→relu→[dropout]→reflect-pad→conv3×3→norm, + x."""

    def __init__(self, dim: int, norm: str = "instance",
                 use_dropout: bool = False):
        super().__init__()
        layers = [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), Norm(norm),
                  nn.ReLU(True)]
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), Norm(norm)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """7×7 entry, 2 stride-2 downs, ``n_blocks`` residual blocks, 2
    transposed-conv ups, 7×7 exit, tanh."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "instance",
                 use_dropout: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
                  Norm(norm), nn.ReLU(True)]
        for i in range(2):
            mult = 2 ** i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1),
                       Norm(norm), nn.ReLU(True)]
        layers += [ResnetBlock(ngf * 4, norm, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3,
                                          stride=2, padding=1,
                                          output_padding=1),
                       Norm(norm), nn.ReLU(True)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self) -> Dict[str, nn.Module]:
        """Every conv by the JAX package's param name (``conv_in``,
        ``down0_conv``, ``block3.conv2``, ``up1_conv``, ``conv_out`` …)."""
        outer = [m for m in self.model
                 if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
        blocks = [m for m in self.model if isinstance(m, ResnetBlock)]
        sites = OrderedDict(conv_in=outer[0], down0_conv=outer[1],
                            down1_conv=outer[2])
        for i, b in enumerate(blocks):
            convs = [m for m in b.conv_block if isinstance(m, nn.Conv2d)]
            sites[f"block{i}.conv1"], sites[f"block{i}.conv2"] = convs
        sites.update(up0_conv=outer[3], up1_conv=outer[4], conv_out=outer[5])
        return sites


_RESNET_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6,
                  "resnet_3blocks": 3, "3blocks": 3}


def define_G(input_nc: int, output_nc: int, ngf: int, net_g: str,
             norm: str = "instance", use_dropout: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> ResnetGenerator:
    """Build and initialise a generator from the reference's CLI string.
    ``generator`` seeds the init (default: seed 0)."""
    if net_g not in _RESNET_BLOCKS:
        raise NotImplementedError(f"Generator model name [{net_g}] is not recognized")
    net = ResnetGenerator(input_nc, output_nc, ngf, _RESNET_BLOCKS[net_g],
                          norm=norm, use_dropout=use_dropout)
    return init_weights(net, init_type, init_gain, generator)
