"""T2Net's task networks and their blocks in PyTorch, NCHW: the JAX
package's ``models/seg_network.py`` (reference models/seg_network.py).
T2Net (``--model seg``) and SegCycle build ``UNetGenerator``; no registered
model builds ``ResGenerator``, ``PreUNet16`` or the discriminators, which
``define_task_G``, ``define_task_D`` and ``define_feature_D`` make.

- ``make_activation`` and one PReLU α per network: the reference builds ONE
  ``nn.PReLU()`` and hands that module to every block, so one α is shared
  network-wide and its state-dict key appears under every block that holds
  it (``conv1.3.weight``, ``conv2.model.2.weight``, ``….nonlinearity.
  weight`` …), all one tensor;
- ``GaussianNoise``: (randn − 0.5)/10 added in train mode;
- ``InceptionBlock`` (width dilated 3×3 branches ``layer{i}.1``, a 3×3 fuse
  ``branch1x1.1``, ``norm1``, ``norm2``, residual), ``EncoderBlock``
  (``model.{0,1,3,4}``), ``DecoderUpBlock`` (``model.{1,2,4,5}``:
  reflect-pad 3×3 conv, norm, ConvTranspose k3 s2 p1 op1 with a bias,
  norm), ``OutputBlock`` (``model.1``, then tanh on the logits, as the
  reference and the JAX package do), ``DownBlock`` (``model.{0,1}``, then a
  2×2 max pool) and ``ShuffleUpBlock`` (``model.{0,3,4}``: a 3×3 expand to
  ``r²``·C, pixel shuffle, act, 3×3 conv, norm, act): the reference's
  Sequential packing;
- ``UNetTrunk``, ``UNetHead`` and ``UNetGenerator`` (both heads' parameters
  exist; ``domain`` picks the one that runs);
- ``ResGenerator`` (``encoder.*``, ``decoder.*``; returns [feature,
  output]), ``VGG16Features`` (``conv1``–``conv4``, torchvision's VGG16
  stacks renumbered as the reference packs them) and ``PreUNet16``
  (a VGG16Features with the inception center and side outputs; a seeded
  init, no pretrained download; only ``layers=4`` is shape-consistent, as
  in the reference and the JAX package);
- ``Discriminator`` (``model.*``), ``MultiscaleDiscriminator``
  (``scale{i}``, each on the 3×3/2 average-pooled input of the last) and
  ``FeatureDiscriminator`` (``model.{0,2,…}``: an MLP over the NCHW-flattened
  features, torch's ``view`` order); each ``Discriminator`` owns its PReLU α,
  as the JAX module's scales do (the reference shares one across scales);
- ``define_task_G``, ``define_task_D``, ``define_feature_D``;
- ``cross_entropy_loss`` and ``seg_accuracy``.

The outer names of ``UNetGenerator`` (``trunk.*``, ``head_syn.*``,
``head_real.*``) follow the JAX package's module tree: its domain-split
heads have no reference ``.pth`` to check them against, and the JAX package
has no importer for this net. Each module's ``site_convs``/``site_norms``
maps the JAX param names to the port's modules (``utils/weights.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import init_tensor, init_weights
from ..parallel.collectives import global_mean
from ..ops.layers import (Conv2d, ConvTranspose2d, InstanceNorm, Norm,
                          PReLU, norm_uses_bias, resize_bilinear)


def make_activation(kind: str) -> nn.Module:
    """The reference's ``get_nonlinearity_layer``: one module, to be shared
    by every block of a network."""
    if kind == "ReLU":
        return nn.ReLU()
    if kind == "SELU":
        return nn.SELU()
    if kind == "LeakyReLU":
        return nn.LeakyReLU(0.1)
    if kind == "PReLU":
        return PReLU()
    raise NotImplementedError(f"activation layer [{kind}] is not found")


class GaussianNoise(nn.Module):
    """(randn − 0.5)/10 added in train mode, drawn in fp32 from torch's
    global generator; the identity in eval mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        noise = (torch.randn(x.shape, device=x.device) - 0.5) / 10.0
        return x + noise.to(x.dtype)


def _sites(pairs) -> "OrderedDict[str, nn.Module]":
    return OrderedDict(pairs)


def _nested(prefix: str, block) -> Dict[str, nn.Module]:
    return {f"{prefix}.{k}": v for k, v in block.items()}


class InceptionBlock(nn.Module):
    """``width`` branches of reflect-pad(d) and a 3×3 conv of dilation
    d = 2i + 1, concatenated, norm1, act, a reflect-padded 3×3 fuse, norm2,
    [dropout], act of the sum with x."""

    def __init__(self, input_nc: int, output_nc: int, norm: str, act: nn.Module,
                 width: int = 1, drop_rate: float = 0.0, use_bias: bool = False):
        super().__init__()
        self.width = width
        for i in range(width):
            d = 2 * i + 1
            setattr(self, f"layer{i}", nn.Sequential(
                nn.ReflectionPad2d(d),
                Conv2d(input_nc, output_nc, 3, dilation=d, bias=use_bias)))
        self.norm1 = Norm(norm, output_nc * width)
        self.norm2 = Norm(norm, output_nc)
        self.nonlinearity = act
        self.branch1x1 = nn.Sequential(
            nn.ReflectionPad2d(1),
            Conv2d(output_nc * width, output_nc, 3, bias=use_bias))
        self.drop = nn.Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([getattr(self, f"layer{i}")(x)
                         for i in range(self.width)], 1)
        out = self.nonlinearity(self.norm1(out))
        out = self.drop(self.norm2(self.branch1x1(out)))
        return self.nonlinearity(out + x)

    def site_convs(self):
        return _sites([*((f"branch{i}", getattr(self, f"layer{i}")[1])
                         for i in range(self.width)),
                       ("fuse1x1", self.branch1x1[1])])

    def convs_before_norm(self):
        """Every conv: the branches feed norm1, the fuse norm2."""
        if isinstance(self.norm1, nn.Identity):
            return []
        return list(self.site_convs().values())

    def site_norms(self):
        return _sites([("norm1", self.norm1), ("norm2", self.norm2)])


class EncoderBlock(nn.Module):
    """conv3×3 p1 → norm → act → conv3×3 p1 → norm → act."""

    def __init__(self, input_nc: int, middle_nc: int, output_nc: int,
                 norm: str, act: nn.Module, use_bias: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(input_nc, middle_nc, 3, padding=1, bias=use_bias),
            Norm(norm, middle_nc), act,
            Conv2d(middle_nc, output_nc, 3, padding=1, bias=use_bias),
            Norm(norm, output_nc), act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        return _sites([("conv1", self.model[0]), ("conv2", self.model[3])])

    def site_norms(self):
        return _sites([("norm1", self.model[1]), ("norm2", self.model[4])])


class DecoderUpBlock(nn.Module):
    """reflect-pad 1 → conv3×3 → norm → act → ConvTranspose(k3, s2, p1, op1,
    bias) → norm → act: twice the height and width."""

    def __init__(self, input_nc: int, middle_nc: int, output_nc: int,
                 norm: str, act: nn.Module, use_bias: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReflectionPad2d(1),
            Conv2d(input_nc, middle_nc, 3, bias=use_bias),
            Norm(norm, middle_nc), act,
            ConvTranspose2d(middle_nc, output_nc, 3, stride=2, padding=1,
                            output_padding=1),
            Norm(norm, output_nc), act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        return _sites([("conv", self.model[1]), ("up", self.model[4])])

    def site_norms(self):
        return _sites([("norm1", self.model[2]), ("norm2", self.model[5])])


class OutputBlock(nn.Module):
    """reflect-pad k//2 → conv k×k → tanh."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 use_bias: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReflectionPad2d(kernel_size // 2),
            Conv2d(input_nc, output_nc, kernel_size, bias=use_bias),
            nn.Tanh())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        return _sites([("conv", self.model[1])])


class DownBlock(nn.Module):
    """conv3×3 p1 → norm → act → 2×2 max pool."""

    def __init__(self, input_nc: int, output_nc: int, norm: str,
                 act: nn.Module, use_bias: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(input_nc, output_nc, 3, padding=1, bias=use_bias),
            Norm(norm, output_nc), act, nn.MaxPool2d(2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        return _sites([("conv", self.model[0])])

    def site_norms(self):
        return _sites([("norm", self.model[1])])


class ShuffleUpBlock(nn.Module):
    """conv3×3 p1 to ``up_scale``²·C → pixel shuffle → act → conv3×3 p1 →
    norm → act: ``up_scale`` times the height and width."""

    def __init__(self, input_nc: int, up_scale: int, output_nc: int,
                 norm: str, act: nn.Module, use_bias: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(input_nc, input_nc * up_scale ** 2, 3, padding=1,
                   bias=use_bias),
            nn.PixelShuffle(up_scale), act,
            Conv2d(input_nc, output_nc, 3, padding=1, bias=use_bias),
            Norm(norm, output_nc), act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        return _sites([("expand", self.model[0]), ("conv", self.model[3])])

    def site_norms(self):
        return _sites([("norm", self.model[4])])


def _up2(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2, mode="nearest")


def _avg2(t: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(t, 2, 2)


def _block_sites(pairs):
    """JAX param name → module over the named blocks' own sites."""
    convs, norms = OrderedDict(), OrderedDict()
    for name, block in pairs:
        convs.update(_nested(name, block.site_convs()))
        norms.update(_nested(name, getattr(block, "site_norms", dict)()))
    return convs, norms


class UNetTrunk(nn.Module):
    """The shared encoder and inception center: reflect-pad 3, 7×7 conv,
    norm, act, avg-pool (conv1); three EncoderBlocks, each avg-pooled
    (conv2, conv3, center_in); 7 − layers InceptionBlocks of width
    7 − layers; a DecoderUpBlock (center_out); [noise]. Returns the five
    features (conv1, conv2, conv3, center_in, center_out)."""

    def __init__(self, input_nc: int, ngf: int, layers: int, norm: str,
                 act: nn.Module, drop_rate: float = 0.0,
                 add_noise: bool = False, use_bias: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, bias=use_bias),
            Norm(norm, ngf), act)
        self.conv2 = EncoderBlock(ngf, ngf * 2, ngf * 2, norm, act, use_bias)
        self.conv3 = EncoderBlock(ngf * 2, ngf * 4, ngf * 4, norm, act,
                                  use_bias)
        self.conv4 = EncoderBlock(ngf * 4, ngf * 8, ngf * 8, norm, act,
                                  use_bias)
        width = 7 - layers
        self.center = nn.Sequential(
            *(InceptionBlock(ngf * 8, ngf * 8, norm, act, width, drop_rate,
                             use_bias) for _ in range(width)),
            DecoderUpBlock(ngf * 8, ngf * 8, ngf * 4, norm, act, use_bias))
        self.noise = GaussianNoise() if add_noise else nn.Identity()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        conv1 = _avg2(self.conv1(x))
        conv2 = _avg2(self.conv2(conv1))
        conv3 = _avg2(self.conv3(conv2))
        center_in = _avg2(self.conv4(conv3))
        center_out = self.noise(self.center(center_in))
        return [conv1, conv2, conv3, center_in, center_out]

    def sites(self):
        n = len(self.center) - 1
        convs, norms = _block_sites(
            [("conv2", self.conv2), ("conv3", self.conv3),
             ("conv4", self.conv4),
             *((f"center{i}", self.center[i]) for i in range(n)),
             ("center_up", self.center[n])])
        convs = OrderedDict([("conv1", self.conv1[1]), *convs.items()])
        norms = OrderedDict([("norm1", self.conv1[2]), *norms.items()])
        return convs, norms


class UNetHead(nn.Module):
    """One domain head: multi-scale outputs over weighted skips,
    ``output1`` at the input's size (the head's result)."""

    def __init__(self, output_nc: int, ngf: int, norm: str, act: nn.Module,
                 weight: float = 0.1, use_bias: bool = False):
        super().__init__()
        self.weight = weight
        self.deconv4 = DecoderUpBlock(ngf * 8, ngf * 8, ngf * 2, norm, act,
                                      use_bias)
        self.deconv3 = DecoderUpBlock(ngf * 4 + output_nc, ngf * 4, ngf, norm,
                                      act, use_bias)
        self.deconv2 = DecoderUpBlock(ngf * 2 + output_nc, ngf * 2, ngf // 2,
                                      norm, act, use_bias)
        self.output4 = OutputBlock(ngf * 8, output_nc, 3, use_bias)
        self.output3 = OutputBlock(ngf * 4 + output_nc, output_nc, 3, use_bias)
        self.output2 = OutputBlock(ngf * 2 + output_nc, output_nc, 3, use_bias)
        self.output1 = OutputBlock(ngf // 2 + output_nc, output_nc, 7, use_bias)

    def outputs(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """[output4, output3, output2, output1]."""
        conv1, conv2, conv3, _, center_out = feats
        w = self.weight
        cat4 = torch.cat([center_out, conv3 * w], 1)
        deconv4, output4 = self.deconv4(cat4), self.output4(cat4)
        cat3 = torch.cat([deconv4, conv2 * w * 0.5, _up2(output4)], 1)
        deconv3, output3 = self.deconv3(cat3), self.output3(cat3)
        cat2 = torch.cat([deconv3, conv1 * w * 0.1, _up2(output3)], 1)
        deconv2, output2 = self.deconv2(cat2), self.output2(cat2)
        cat1 = torch.cat([deconv2, _up2(output2)], 1)
        return [output4, output3, output2, self.output1(cat1)]

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        return self.outputs(feats)[-1]

    def sites(self):
        return _block_sites([(n, getattr(self, n)) for n in (
            "deconv4", "output4", "deconv3", "output3", "deconv2", "output2",
            "output1")])


class UNetGenerator(nn.Module):
    """T2Net's task net with domain-split heads: a shared ``trunk`` and the
    heads ``head_syn`` (``nc_syn`` classes) and ``head_real`` (``nc_real``).
    ``forward(x, domain)`` → [center_in (the features), the head's
    output1]; ``domain`` is 'syn' or 'real'."""

    def __init__(self, input_nc: int = 3, ngf: int = 64, layers: int = 4,
                 norm: str = "batch", activation: str = "PReLU",
                 drop_rate: float = 0.0, add_noise: bool = False,
                 weight: float = 0.1, nc_syn: int = 22, nc_real: int = 28):
        super().__init__()
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        self.trunk = UNetTrunk(input_nc, ngf, layers, norm, act, drop_rate,
                               add_noise, bias)
        self.head_syn = UNetHead(nc_syn, ngf, norm, act, weight, bias)
        self.head_real = UNetHead(nc_real, ngf, norm, act, weight, bias)

    def forward(self, x: torch.Tensor, domain: str = "syn"
                ) -> List[torch.Tensor]:
        feats = self.trunk(x)
        head = self.head_syn if domain == "syn" else self.head_real
        return [feats[3], head(feats)]

    def _sites(self):
        convs, norms = OrderedDict(), OrderedDict()
        for name, mod in (("trunk", self.trunk), ("head_syn", self.head_syn),
                          ("head_real", self.head_real)):
            c, n = mod.sites()
            convs.update(_nested(name, c))
            norms.update(_nested(name, n))
        return convs, norms

    def site_convs(self):
        return self._sites()[0]

    def site_norms(self):
        return self._sites()[1]


class ResGenerator(nn.Module):
    """reflect-pad 3, 7×7 conv, norm, act (``conv_in``); two EncoderBlocks
    to 2·ngf, each avg-pooled; ``n_blocks`` − 2 InceptionBlocks of width 1
    (the feature); [noise]; two DecoderUpBlocks back to ngf; reflect-pad 3,
    7×7 conv with a bias, tanh. Returns [feature, output]."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 6, norm: str = "batch",
                 activation: str = "PReLU", drop_rate: float = 0.0,
                 add_noise: bool = False):
        super().__init__()
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        encoder = [nn.ReflectionPad2d(3),
                   Conv2d(input_nc, ngf, 7, bias=bias), Norm(norm, ngf), act]
        mult = 1
        for i in range(2):
            prev, mult = mult, min(2 ** (i + 1), 2)
            encoder += [EncoderBlock(ngf * prev, ngf * mult, ngf * mult, norm,
                                     act, bias), nn.AvgPool2d(2, 2)]
        encoder += [InceptionBlock(ngf * mult, ngf * mult, norm, act, 1,
                                   drop_rate, bias)
                    for _ in range(n_blocks - 2)]
        decoder = [GaussianNoise()] if add_noise else []
        for i in range(2):
            prev, mult = mult, min(2 ** (2 - i - 1), 2)
            decoder.append(DecoderUpBlock(ngf * prev, ngf * prev, ngf * mult,
                                          norm, act, bias))
        decoder += [nn.ReflectionPad2d(3), Conv2d(ngf, output_nc, 7),
                    nn.Tanh()]
        self.encoder = nn.Sequential(*encoder)
        self.decoder = nn.Sequential(*decoder)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feature = self.encoder(x)
        return [feature, self.decoder(feature)]

    def _sites(self):
        enc = [m for m in self.encoder if isinstance(m, EncoderBlock)]
        blocks = [m for m in self.encoder if isinstance(m, InceptionBlock)]
        decs = [m for m in self.decoder if isinstance(m, DecoderUpBlock)]
        convs, norms = _block_sites([
            *((f"enc{i}", b) for i, b in enumerate(enc)),
            *((f"block{i}", b) for i, b in enumerate(blocks)),
            *((f"dec{i}", b) for i, b in enumerate(decs))])
        convs = OrderedDict([("conv_in", self.encoder[1]), *convs.items(),
                             ("conv_out", self.decoder[-2])])
        norms = OrderedDict([("norm_in", self.encoder[2]), *norms.items()])
        return convs, norms

    def site_convs(self):
        return self._sites()[0]

    def site_norms(self):
        return self._sites()[1]


VGG16_STAGES = (("conv1", (64, 64)), ("conv2", (128, 128)),
                ("conv3", (256, 256, 256)), ("conv4", (512, 512, 512)))


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features`` conv stacks as the reference
    packs them: ``conv1``–``conv4``, each [3×3 conv with a bias, ReLU]×n
    (``conv1.0``, ``conv1.2`` …). Returns the four stages, each 2×2
    max-pooled after its stack (64 at 1/2, 128 at 1/4, 256 at 1/8, 512 at
    1/16)."""

    def __init__(self, input_nc: int = 3):
        super().__init__()
        c_in = input_nc
        for stage, chans in VGG16_STAGES:
            layers = []
            for c in chans:
                layers += [Conv2d(c_in, c, 3, padding=1), nn.ReLU()]
                c_in = c
            setattr(self, stage, nn.Sequential(*layers))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for stage, _ in VGG16_STAGES:
            x = F.max_pool2d(getattr(self, stage)(x), 2, 2)
            outs.append(x)
        return outs

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.features(x)

    def site_convs(self):
        """``conv{s}_{j}``: the conv at index j of stack s (the JAX names)."""
        return _sites((f"{stage}_{j}", m)
                      for stage, _ in VGG16_STAGES
                      for j, m in enumerate(getattr(self, stage))
                      if isinstance(m, nn.Conv2d))


def _up2_bilinear(t: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(t, (t.shape[2] * 2, t.shape[3] * 2),
                           align_corners=True)


class PreUNet16(VGG16Features):
    """The VGG16-encoder U-Net task net: the VGG16 stages, 7 − layers
    InceptionBlocks of width 7 − layers and a DecoderUpBlock (``center``),
    then DecoderUpBlocks ``deconv4``–``deconv2`` over skips scaled 0.1,
    0.05, 0.01 and side outputs ``output4``–``output2`` (bilinear ×2 with
    aligned corners into the next level), ``deconv1`` the 7×7 full-size
    output. Returns [center_in, output4, output3, output2, output1].

    The reference concatenates mismatched sizes for ``layers > 4`` and
    raises there; only ``layers=4`` is built, as in the JAX package. The
    center's residual needs ngf·8 = 512 (ngf 64), the VGG width."""

    def __init__(self, output_nc: int = 3, ngf: int = 64, layers: int = 4,
                 norm: str = "batch", activation: str = "PReLU",
                 drop_rate: float = 0.0, input_nc: int = 3):
        if layers != 4:
            raise NotImplementedError(
                "reference _PreUNet16 is only shape-consistent at layers=4")
        super().__init__(input_nc)
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        width = 7 - layers
        self.center = nn.Sequential(
            *(InceptionBlock(512, ngf * 8, norm, act, width, drop_rate, bias)
              for _ in range(width)),
            DecoderUpBlock(ngf * 8, ngf * 8, ngf * 4, norm, act, bias))
        c4, c3, c2 = ngf * 4 + 256, ngf * 2 + 128 + output_nc, \
            ngf + 64 + output_nc
        self.deconv4 = DecoderUpBlock(c4, ngf * 8, ngf * 2, norm, act, bias)
        self.deconv3 = DecoderUpBlock(c3, ngf * 4, ngf, norm, act, bias)
        self.deconv2 = DecoderUpBlock(c2, ngf * 2, ngf // 2, norm, act, bias)
        self.deconv1 = OutputBlock(ngf // 2 + output_nc, output_nc, 7, bias)
        self.output4 = OutputBlock(c4, output_nc, 3, bias)
        self.output3 = OutputBlock(c3, output_nc, 3, bias)
        self.output2 = OutputBlock(c2, output_nc, 3, bias)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c1, c2, c3, center_in = self.features(x)
        h = self.center(center_in)
        cat4 = torch.cat([h, c3 * 0.1], 1)
        deconv4, output4 = self.deconv4(cat4), self.output4(cat4)
        cat3 = torch.cat([deconv4, c2 * 0.05, _up2_bilinear(output4)], 1)
        deconv3, output3 = self.deconv3(cat3), self.output3(cat3)
        cat2 = torch.cat([deconv3, c1 * 0.01, _up2_bilinear(output3)], 1)
        deconv2, output2 = self.deconv2(cat2), self.output2(cat2)
        output1 = self.deconv1(torch.cat([deconv2, _up2_bilinear(output2)],
                                         1))
        return [center_in, output4, output3, output2, output1]

    def _sites(self):
        n = len(self.center) - 1
        convs, norms = _block_sites([
            *((f"center{i}", self.center[i]) for i in range(n)),
            ("center_up", self.center[n]),
            *((k, getattr(self, k)) for k in (
                "deconv4", "output4", "deconv3", "output3", "deconv2",
                "output2", "deconv1"))])
        vgg = _nested("vgg", super().site_convs())
        return OrderedDict([*vgg.items(), *convs.items()]), norms

    def site_convs(self):
        return self._sites()[0]

    def site_norms(self):
        return self._sites()[1]


class Discriminator(nn.Module):
    """PatchGAN with its own activation: a stride-2 4×4 conv and act,
    ``n_layers`` − 1 stride-2 conv→norm→act, a stride-1 conv→norm→act to
    ndf·min(2^n_layers, 8), a one-channel stride-1 4×4 conv (with a bias);
    all padding 1."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", activation: str = "PReLU"):
        super().__init__()
        act = make_activation(activation)
        bias = norm_uses_bias(norm)
        layers = [Conv2d(input_nc, ndf, 4, 2, 1, bias=bias), act]
        mult = 1
        for i in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** i, 8)
            stride = 2 if i < n_layers else 1
            layers += [Conv2d(ndf * prev, ndf * mult, 4, stride, 1, bias=bias),
                       Norm(norm, ndf * mult), act]
        layers.append(Conv2d(ndf * mult, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self):
        convs = [m for m in self.model if isinstance(m, nn.Conv2d)]
        names = [f"conv{i}" for i in range(len(convs) - 1)] + ["conv_out"]
        return _sites(zip(names, convs))

    def site_norms(self):
        norms = [m for m in self.model
                 if isinstance(m, (nn.BatchNorm2d, InstanceNorm))]
        return _sites((f"norm{i + 1}", m) for i, m in enumerate(norms))

    def site_prelus(self):
        return _sites((("prelu_alpha", m) for m in self.model
                       if isinstance(m, PReLU)))


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` Discriminators (``scale{i}``), scale i on the input
    average-pooled (3×3, stride 2, padding 1, padding not counted) i times.
    Returns the list of patch maps."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 num_d: int = 1, norm: str = "batch",
                 activation: str = "PReLU"):
        super().__init__()
        self.num_d = num_d
        self.downsample = nn.AvgPool2d(3, 2, padding=1,
                                       count_include_pad=False)
        for i in range(num_d):
            setattr(self, f"scale{i}", Discriminator(input_nc, ndf, n_layers,
                                                     norm, activation))

    def _scales(self):
        return [(f"scale{i}", getattr(self, f"scale{i}"))
                for i in range(self.num_d)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, (_, d) in enumerate(self._scales()):
            outs.append(d(x))
            if i != self.num_d - 1:
                x = self.downsample(x)
        return outs

    def site_convs(self):
        return _block_sites(self._scales())[0]

    def site_norms(self):
        return _block_sites(self._scales())[1]

    def site_prelus(self):
        out = OrderedDict()
        for name, d in self._scales():
            out.update(_nested(name, d.site_prelus()))
        return out


class FeatureDiscriminator(nn.Module):
    """An MLP over the NCHW-flattened ``input_nc`` × ``feature_hw``
    features (torch's ``view(-1, C·H·W)`` order): ``n_layers`` Linear→act
    of width ``input_nc``, then a Linear to one logit. Returns [logit]."""

    def __init__(self, input_nc: int = 512, n_layers: int = 2,
                 activation: str = "PReLU", feature_hw=(12, 40)):
        super().__init__()
        act = make_activation(activation)
        h, w = feature_hw
        layers = [nn.Linear(input_nc * h * w, input_nc), act]
        for _ in range(1, n_layers):
            layers += [nn.Linear(input_nc, input_nc), act]
        layers.append(nn.Linear(input_nc, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [self.model(x.reshape(x.shape[0], -1))]

    def site_convs(self):
        return OrderedDict()

    def site_denses(self):
        """``fc{i}`` and ``fc_out``: the JAX ``nn.Dense`` names."""
        fcs = [m for m in self.model if isinstance(m, nn.Linear)]
        names = [f"fc{i}" for i in range(len(fcs) - 1)] + ["fc_out"]
        return _sites(zip(names, fcs))


def define_task_G(input_nc: int = 3, ngf: int = 64, layers: int = 4,
                  norm: str = "batch", activation: str = "PReLU",
                  model_type: str = "UNet", init_type: str = "xavier",
                  drop_rate: float = 0.0, add_noise: bool = False,
                  weight: float = 0.1, output_nc: int = 3,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build and initialise a task net (the JAX ``define_task_G``; its
    initializer's gain is 0.02): 'UNet', 'ResNet' (``layers`` is its
    ``n_blocks``) or 'PreUNet16'."""
    if model_type == "ResNet":
        net = ResGenerator(input_nc, output_nc, ngf, layers, norm, activation,
                           drop_rate, add_noise)
    elif model_type == "UNet":
        net = UNetGenerator(input_nc, ngf, layers, norm, activation,
                            drop_rate, add_noise, weight)
    elif model_type == "PreUNet16":
        net = PreUNet16(output_nc, ngf, layers, norm, activation, drop_rate,
                        input_nc)
    else:
        raise NotImplementedError(
            f"model type [{model_type}] is not implemented")
    return init_weights(net, init_type, 0.02, generator)


def define_task_D(input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                  num_d: int = 1, norm: str = "batch",
                  activation: str = "PReLU", init_type: str = "xavier",
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """The JAX ``define_task_D``: a seeded ``MultiscaleDiscriminator``."""
    return init_weights(MultiscaleDiscriminator(input_nc, ndf, n_layers,
                                                num_d, norm, activation),
                        init_type, 0.02, generator)


def define_feature_D(input_nc: int = 512, n_layers: int = 2,
                     norm: str = "batch", activation: str = "PReLU",
                     init_type: str = "xavier", feature_hw=(12, 40),
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """The JAX ``define_feature_D``: a seeded ``FeatureDiscriminator``
    (``norm`` is accepted and unused, as there) over ``feature_hw``
    features, (12, 40) at 192×640."""
    net = FeatureDiscriminator(input_nc, n_layers, activation, feature_hw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in net.site_denses().values():
        init_tensor(m.weight, init_type, 0.02, generator)
        nn.init.zeros_(m.bias)
    return net


# ---------------------------------------------------------------------------
# losses shared by the task models
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over the valid pixels, in fp32: ``logits`` NCHW (C classes),
    ``labels`` NHW integers. A label outside [0, C) is ignored like
    ``ignore_index`` (``F.cross_entropy`` would assert on the device there).
    ``weights``: a per-class weight vector; the mean is then Σ w[y]·ℓ over
    Σ w[y] on the valid pixels (torch's rule). Under data parallelism both
    sums are over the global batch (``global_mean``)."""
    num_classes = logits.shape[1]
    logp = F.log_softmax(logits.float(), dim=1)
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = logp.gather(1, safe[:, None]).squeeze(1)
    if weights is None:
        v = valid.float()
        return -global_mean((ll * v).sum(), v.sum(), 1)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=logits.device)[safe] * valid
    return -global_mean((ll * w).sum(), w.sum(), 1e-8)


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Share of the pixels other than ``ignore_index`` whose argmax class
    is their label (over the global batch under data parallelism)."""
    valid = labels != ignore_index
    pred = logits.argmax(1)
    return global_mean(((pred == labels) & valid).sum().float(),
                       valid.sum().float(), 1)
