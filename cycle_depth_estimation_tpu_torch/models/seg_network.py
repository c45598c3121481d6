"""T2Net's task network and its blocks in PyTorch, NCHW: the parts of the
JAX package's ``models/seg_network.py`` that T2Net (``--model seg``) and
SegCycle use (reference models/seg_network.py).

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
  norm) and ``OutputBlock`` (``model.1``, then tanh on the logits, as the
  reference and the JAX package do): the reference's Sequential packing;
- ``UNetTrunk``, ``UNetHead`` and ``UNetGenerator`` (both heads' parameters
  exist; ``domain`` picks the one that runs); ``define_task_G``;
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

from ..ops.init import init_weights
from ..ops.layers import (Conv2d, ConvTranspose2d, Norm, PReLU,
                          norm_uses_bias)


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


def define_task_G(input_nc: int = 3, ngf: int = 64, layers: int = 4,
                  norm: str = "batch", activation: str = "PReLU",
                  model_type: str = "UNet", init_type: str = "xavier",
                  drop_rate: float = 0.0, add_noise: bool = False,
                  weight: float = 0.1,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build and initialise a task net (the JAX ``define_task_G``; its
    initializer's gain is 0.02). ``model_type`` 'UNet' only here."""
    if model_type in ("ResNet", "PreUNet16"):
        raise NotImplementedError(
            f"task net [{model_type}] is not ported yet: it comes with the "
            "slice of the unused seg_network parts (ROADMAP A4b)")
    if model_type != "UNet":
        raise NotImplementedError(f"model type [{model_type}] is not implemented")
    net = UNetGenerator(input_nc, ngf, layers, norm, activation, drop_rate,
                        add_noise, weight)
    return init_weights(net, init_type, 0.02, generator)


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
    Σ w[y] on the valid pixels (torch's rule)."""
    num_classes = logits.shape[1]
    logp = F.log_softmax(logits.float(), dim=1)
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = logp.gather(1, safe[:, None]).squeeze(1)
    if weights is None:
        v = valid.float()
        return -(ll * v).sum() / v.sum().clamp_min(1)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=logits.device)[safe] * valid
    return -(ll * w).sum() / w.sum().clamp_min(1e-8)


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Share of the pixels other than ``ignore_index`` whose argmax class
    is their label."""
    valid = labels != ignore_index
    pred = logits.argmax(1)
    return ((pred == labels) & valid).sum().float() / valid.sum().clamp_min(1)
