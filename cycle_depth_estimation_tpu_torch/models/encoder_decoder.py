"""SegCycle's U-Net encoder/decoder pair in PyTorch, NCHW (the JAX
package's ``models/encoder_decoder.py``, reference
models/encoder_decoder.py:120-209).

``UNetEncoder``: reflect-pad 3, 7×7 conv, norm, act and avg-pool
(``conv1``), three avg-pooled EncoderBlocks (``conv2``, ``conv3``,
``conv4`` → center_in) and 7 − layers InceptionBlocks (``center``);
returns [conv1, conv2, conv3, center_in, center_out]. ``UNetDecoder``: a
DecoderUpBlock on the center (``deconv_center``), then three DecoderUpBlocks
over weighted skips (weight · {1, 0.5, 0.1}) with side outputs; returns
[center_in, output4, output3, output2, output1]. Both default to BatchNorm
and one shared PReLU, whatever ``--norm`` says, as the JAX SegCycle builds
them. The module names are the JAX tree's (``site_convs``/``site_norms``);
the reference's own names for these two nets are not checked here (no
reference ``.pth``, no JAX importer).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import torch
from torch import nn

from ..ops.init import init_weights
from ..ops.layers import Conv2d, Norm, norm_uses_bias
from .seg_network import (DecoderUpBlock, EncoderBlock, InceptionBlock,
                          UNetHead, _avg2, _block_sites,
                          make_activation)


class UNetEncoder(nn.Module):
    def __init__(self, input_nc: int = 3, ngf: int = 64, layers: int = 4,
                 norm: str = "batch", activation: str = "PReLU",
                 drop_rate: float = 0.0):
        super().__init__()
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        self.conv1 = nn.Sequential(
            nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, bias=bias),
            Norm(norm, ngf), act)
        self.conv2 = EncoderBlock(ngf, ngf * 2, ngf * 2, norm, act, bias)
        self.conv3 = EncoderBlock(ngf * 2, ngf * 4, ngf * 4, norm, act, bias)
        self.conv4 = EncoderBlock(ngf * 4, ngf * 8, ngf * 8, norm, act, bias)
        width = 7 - layers
        self.center = nn.Sequential(
            *(InceptionBlock(ngf * 8, ngf * 8, norm, act, width, drop_rate,
                             bias) for _ in range(width)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        conv1 = _avg2(self.conv1(x))
        conv2 = _avg2(self.conv2(conv1))
        conv3 = _avg2(self.conv3(conv2))
        center_in = _avg2(self.conv4(conv3))
        return [conv1, conv2, conv3, center_in, self.center(center_in)]

    def _sites(self):
        convs, norms = _block_sites(
            [("conv2", self.conv2), ("conv3", self.conv3),
             ("conv4", self.conv4),
             *((f"center{i}", b) for i, b in enumerate(self.center))])
        return (OrderedDict([("conv1", self.conv1[1]), *convs.items()]),
                OrderedDict([("norm1", self.conv1[2]), *norms.items()]))

    def site_convs(self):
        return self._sites()[0]

    def site_norms(self):
        return self._sites()[1]


class UNetDecoder(nn.Module):
    def __init__(self, output_nc: int, ngf: int = 64, weight: float = 0.1,
                 norm: str = "batch", activation: str = "PReLU"):
        super().__init__()
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        self.deconv_center = DecoderUpBlock(ngf * 8, ngf * 8, ngf * 4, norm,
                                            act, bias)
        # the three up stages and side outputs are T2Net's head
        self.head = UNetHead(output_nc, ngf, norm, act, weight, bias)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        conv1, conv2, conv3, center_in, center_out = feats
        center_out = self.deconv_center(center_out)
        return [center_in, *self.head.outputs(
            [conv1, conv2, conv3, center_in, center_out])]

    def _sites(self):
        convs, norms = _block_sites([("deconv_center", self.deconv_center)])
        c, n = self.head.sites()
        convs.update(c)
        norms.update(n)
        return convs, norms

    def site_convs(self):
        return self._sites()[0]

    def site_norms(self):
        return self._sites()[1]


def define_encoder(input_nc: int = 3, ngf: int = 64,
                   generator: Optional[torch.Generator] = None) -> UNetEncoder:
    """A SegCycle encoder at the JAX defaults (BatchNorm, PReLU, layers 4,
    xavier init with gain 0.02)."""
    return init_weights(UNetEncoder(input_nc, ngf), "xavier", 0.02, generator)


def define_decoder(output_nc: int, ngf: int = 64,
                   generator: Optional[torch.Generator] = None) -> UNetDecoder:
    """A SegCycle decoder at the JAX defaults."""
    return init_weights(UNetDecoder(output_nc, ngf), "xavier", 0.02, generator)
