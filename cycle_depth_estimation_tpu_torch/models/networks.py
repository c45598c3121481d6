"""The CycleGAN and pix2pix networks, losses and LR schedules in PyTorch,
NCHW.

The counterparts of ``ResnetBlock``, ``ResnetGenerator``, ``UnetGenerator``,
``define_G``, ``NLayerDiscriminator``, ``PixelDiscriminator``, ``define_D``,
``gan_loss``, ``l1_loss``, ``mse_loss`` and ``lr_schedule`` in the JAX
package's ``models/networks.py``. Modules sit in ``nn.Sequential``s exactly
as the reference builds them (reference models/networks.py:145-386), so
``state_dict()`` keys are the reference's and a reference ``.pth`` loads
with ``load_state_dict``:

- ResnetGenerator: ``model.1`` (conv_in), ``model.4``/``model.7`` (down),
  ``model.{10+i}.conv_block.{1, 5|6}`` (block convs; 6 with dropout),
  ``model.{10+n}``/``model.{13+n}`` (ConvTranspose up), ``model.{17+n}``
  (conv_out). With ``up_mode='resize_conv'`` (no reference counterpart: the
  JAX package's fast-serving variant) each up stage is [nearest ×2, 3×3
  conv, norm, ReLU]: ``model.{11+n}``/``model.{15+n}``, conv_out
  ``model.{19+n}``;
- UnetGenerator: the reference's recursive ``UnetSkipConnectionBlock``s,
  ``model.model.{0|1}`` the outermost down conv … ``model.model.1.model.3.``
  one level in (layout in the JAX package's ``import_unet_generator``);
- NLayerDiscriminator: ``model.0`` (conv0), then ``model.{2+3(n-1)}`` for
  conv1 … conv{n_layers}, then conv_out three further on (``model.11`` at
  3 layers); with BatchNorm, ``model.{3+3(n-1)}`` for norm{n};
- PixelDiscriminator: ``net.0``, ``net.2``, ``net.5`` (``net.3`` the norm).

Conv biases follow the reference's rule: none on a conv that a BatchNorm
follows (``norm_uses_bias``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import init_weights
from ..parallel.collectives import spatial_mean
from ..ops.layers import (Conv2d, ConvTranspose2d, InstanceNorm, Norm,
                          norm_uses_bias)


class ResnetBlock(nn.Module):
    """reflect-pad→conv3×3→norm→relu→[dropout]→reflect-pad→conv3×3→norm, + x."""

    def __init__(self, dim: int, norm: str = "instance",
                 use_dropout: bool = False):
        super().__init__()
        bias = norm_uses_bias(norm)
        layers = [nn.ReflectionPad2d(1), Conv2d(dim, dim, 3, bias=bias),
                  Norm(norm, dim), nn.ReLU(True)]
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += [nn.ReflectionPad2d(1), Conv2d(dim, dim, 3, bias=bias),
                   Norm(norm, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """7×7 entry, 2 stride-2 downs, ``n_blocks`` residual blocks, 2 ups, 7×7
    exit, tanh. ``up_mode`` 'convtranspose' is the reference's up stage
    (ConvTranspose2d k3 s2); 'resize_conv' is nearest ×2 then a zero-padded
    3×3 conv, the JAX package's variant for all-int8 serving (not
    interchangeable with ConvTranspose weights: train with it)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "instance",
                 use_dropout: bool = False, up_mode: str = "convtranspose"):
        super().__init__()
        if up_mode not in ("convtranspose", "resize_conv"):
            raise ValueError(f"unknown up_mode [{up_mode}]; expected "
                             "'convtranspose' | 'resize_conv'")
        self.n_blocks = n_blocks
        self.up_mode = up_mode
        bias = norm_uses_bias(norm)
        layers = [nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, bias=bias),
                  Norm(norm, ngf), nn.ReLU(True)]
        for i in range(2):
            mult = 2 ** i
            layers += [Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1, bias=bias),
                       Norm(norm, ngf * mult * 2), nn.ReLU(True)]
        layers += [ResnetBlock(ngf * 4, norm, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            if up_mode == "resize_conv":
                layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                           Conv2d(ngf * mult, ngf * mult // 2, 3,
                                     padding=1, bias=bias)]
            else:
                layers.append(ConvTranspose2d(
                    ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                    output_padding=1, bias=bias))
            layers += [Norm(norm, ngf * mult // 2), nn.ReLU(True)]
        layers += [nn.ReflectionPad2d(3), Conv2d(ngf, output_nc, 7),
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


class UnetSkipConnectionBlock(nn.Module):
    """One level of the reference's recursive U-Net (reference
    models/networks.py:262-316). ``model`` is

    - outermost: [down conv, submodule, ReLU, up conv (with bias), tanh];
    - innermost: [LeakyReLU, down conv, ReLU, up conv, up norm];
    - otherwise: [LeakyReLU, down conv, down norm, submodule, ReLU, up conv,
      up norm (, Dropout 0.5)].

    All convs are 4×4 stride 2 padding 1. A level other than the outermost
    returns ``cat([x, model(x)])`` on channels. Its LeakyReLU works in place,
    as the reference's does, so the skip half of the concatenation is
    LeakyReLU(x); the ReLU that every consumer of the concatenation applies
    first makes that equal to the JAX package's ReLU(x), forward and
    backward.
    """

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        bias = norm_uses_bias(norm)
        input_nc = outer_nc if input_nc is None else input_nc
        down = Conv2d(input_nc, inner_nc, 4, 2, 1, bias=bias)
        if outermost:
            layers = [down, submodule, nn.ReLU(True),
                      ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2, True), down, nn.ReLU(True),
                      ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1,
                                         bias=bias),
                      Norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2, True), down, Norm(norm, inner_nc),
                      submodule, nn.ReLU(True),
                      ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1,
                                         bias=bias),
                      Norm(norm, outer_nc)]
            if use_dropout:
                layers.append(nn.Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """U-Net with ``num_downs`` halvings (unet_128: 7, unet_256: 8): level
    channels ngf, 2ngf, 4ngf, then 8ngf; dropout on the 8ngf levels other
    than the innermost (levels 4 … num_downs − 2, counted from the outside)
    when ``use_dropout``."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        self.num_downs = num_downs
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True,
                                        norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            norm=norm, use_dropout=use_dropout)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2,
                                            submodule=block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             submodule=block, outermost=True,
                                             norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def _levels(self):
        block = self.model
        for _ in range(self.num_downs):
            yield block
            block = next((m for m in block.model
                          if isinstance(m, UnetSkipConnectionBlock)), None)

    def site_convs(self) -> Dict[str, nn.Module]:
        """Every conv by the JAX package's param name (``down{lvl}_conv``,
        ``up{lvl}_conv``; level 0 is the outermost)."""
        sites = OrderedDict()
        for lvl, block in enumerate(self._levels()):
            sites[f"down{lvl}_conv"] = next(
                m for m in block.model if isinstance(m, nn.Conv2d))
            sites[f"up{lvl}_conv"] = next(
                m for m in block.model if isinstance(m, nn.ConvTranspose2d))
        return sites

    def site_norms(self) -> Dict[str, nn.Module]:
        """Every BatchNorm by the JAX package's name (``down{lvl}_norm``,
        ``up{lvl}_norm``)."""
        sites = OrderedDict()
        for lvl, block in enumerate(self._levels()):
            mods = list(block.model)
            for i, m in enumerate(mods):
                if isinstance(m, nn.BatchNorm2d):
                    side = "up" if isinstance(mods[i - 1],
                                              nn.ConvTranspose2d) else "down"
                    sites[f"{side}{lvl}_norm"] = m
        return sites


_RESNET_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6,
                  "resnet_3blocks": 3, "3blocks": 3}
_UNET_DOWNS = {"unet_128": 7, "unet_256": 8}


def define_G(input_nc: int, output_nc: int, ngf: int, net_g: str,
             norm: str = "instance", use_dropout: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build and initialise a generator from the reference's CLI string
    (``resnet_{9,6,3}blocks``, ``3blocks``, ``unet_128``, ``unet_256``).
    ``generator`` seeds the init (default: seed 0)."""
    if net_g in _RESNET_BLOCKS:
        net = ResnetGenerator(input_nc, output_nc, ngf, _RESNET_BLOCKS[net_g],
                              norm=norm, use_dropout=use_dropout)
    elif net_g in _UNET_DOWNS:
        net = UnetGenerator(input_nc, output_nc, _UNET_DOWNS[net_g], ngf,
                            norm=norm, use_dropout=use_dropout)
    else:
        raise NotImplementedError(f"Generator model name [{net_g}] is not recognized")
    return init_weights(net, init_type, init_gain, generator)


class NLayerDiscriminator(nn.Module):
    """70×70 PatchGAN: a stride-2 4×4 conv and LeakyReLU(0.2), ``n_layers - 1``
    stride-2 conv→norm→LeakyReLU, one stride-1 conv→norm→LeakyReLU, a
    one-channel stride-1 4×4 conv; all padding 1."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        self.n_layers = n_layers
        use_bias = norm_uses_bias(norm)
        layers = [Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2, True)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [Conv2d(ndf * prev, ndf * mult, 4, stride, 1,
                                 bias=use_bias),
                       Norm(norm, ndf * mult), nn.LeakyReLU(0.2, True)]
        layers.append(Conv2d(ndf * mult, 1, 4, 1, 1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def site_convs(self) -> Dict[str, nn.Module]:
        """Every conv by the JAX package's param name (``conv0`` …
        ``conv{n_layers}``, ``conv_out``)."""
        convs = [m for m in self.model if isinstance(m, nn.Conv2d)]
        names = [f"conv{i}" for i in range(self.n_layers + 1)] + ["conv_out"]
        return OrderedDict(zip(names, convs))

    def site_norms(self) -> Dict[str, nn.Module]:
        """The BatchNorms by the JAX package's name (``norm1`` …
        ``norm{n_layers}``)."""
        norms = [m for m in self.model if isinstance(m, nn.BatchNorm2d)]
        return OrderedDict((f"norm{i + 1}", m) for i, m in enumerate(norms))


class PixelDiscriminator(nn.Module):
    """1×1 per-pixel discriminator (PixelGAN)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64,
                 norm: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        use_bias = norm_uses_bias(norm)
        layers = [Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2, True),
                  Conv2d(ndf, ndf * 2, 1, bias=use_bias), Norm(norm, ndf * 2),
                  nn.LeakyReLU(0.2, True),
                  Conv2d(ndf * 2, 1, 1, bias=use_bias)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    def site_convs(self) -> Dict[str, nn.Module]:
        convs = [m for m in self.net if isinstance(m, nn.Conv2d)]
        return OrderedDict(zip(("conv0", "conv1", "conv2"), convs))

    def site_norms(self) -> Dict[str, nn.Module]:
        return OrderedDict((("norm1", m) for m in self.net
                            if isinstance(m, nn.BatchNorm2d)))


def define_D(input_nc: int, ndf: int, net_d: str, n_layers_d: int = 3,
             norm: str = "instance", use_sigmoid: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build and initialise a discriminator from the reference's CLI string
    (``basic`` = 3-layer PatchGAN, ``n_layers``, ``pixel``)."""
    if net_d == "basic":
        net = NLayerDiscriminator(input_nc, ndf, 3, norm, use_sigmoid)
    elif net_d == "n_layers":
        net = NLayerDiscriminator(input_nc, ndf, n_layers_d, norm, use_sigmoid)
    elif net_d == "pixel":
        net = PixelDiscriminator(input_nc, ndf, norm, use_sigmoid)
    else:
        raise NotImplementedError(
            f"Discriminator model name [{net_d}] is not recognized")
    return init_weights(net, init_type, init_gain, generator)


def biases_before_norm(net: nn.Module) -> set:
    """State-dict names of the conv biases that a norm follows (an
    InstanceNorm, or a BatchNorm in train mode). The norm removes any
    per-channel constant, so their gradient is zero up to rounding, and
    Adam's first step moves each by up to ±lr in a direction that rounding
    picks: two correct implementations differ there by up to 2·lr per step.
    A block whose convs reach their norm outside one Sequential lists them
    in ``convs_before_norm()``."""
    names = set()
    paths = {m: p for p, m in net.named_modules()}
    for prefix, seq in net.named_modules():
        for conv in getattr(seq, "convs_before_norm", list)():
            if conv.bias is not None:
                names.add(f"{paths[conv]}.bias")
        if not isinstance(seq, nn.Sequential):
            continue
        mods = list(seq)
        for i, (m, nxt) in enumerate(zip(mods, mods[1:])):
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and \
                    m.bias is not None and \
                    isinstance(nxt, (InstanceNorm, nn.BatchNorm2d)):
                names.add(f"{prefix}.{i}.bias")
    return names


# ---------------------------------------------------------------------------
# losses: fp32 means, as the JAX package takes them
# ---------------------------------------------------------------------------


# Each loss is the mean of its elementwise terms (``collectives.spatial_mean``):
# under ``--parallel sp`` over the whole planes the model group holds.
def gan_loss(pred: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """``lsgan``: MSE of the raw D output against 1/0. ``vanilla``: BCE on
    logits (build D with use_sigmoid=False)."""
    pred = pred.float()
    target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
    if mode == "lsgan":
        loss = F.mse_loss(pred, target, reduction="none")
    elif mode == "vanilla":
        loss = F.binary_cross_entropy_with_logits(pred, target,
                                                  reduction="none")
    else:
        raise NotImplementedError(f"gan mode [{mode}] not implemented")
    return spatial_mean(loss)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return spatial_mean((a.float() - b.float()).abs())


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return spatial_mean(F.mse_loss(a.float(), b.float(), reduction="none"))


def lr_schedule(policy: str, base_lr: float, *, epoch: int, niter: int = 5,
                niter_decay: int = 5, lr_decay_iters: int = 15) -> float:
    """The LR for an epoch under the reference's policies. ``lambda`` is the
    reference's hard-coded lr·(1 − max(0, epoch − 10)/30), which ignores
    niter and niter_decay (reference models/networks.py:26-28); ``plateau``
    keeps base_lr here: its state lives in ``BaseModel.update_learning_rate``.
    """
    if policy == "lambda":
        return base_lr * (1.0 - max(0, epoch - 10) / 30.0)
    if policy == "step":
        return base_lr * (0.1 ** (epoch // lr_decay_iters))
    if policy == "cosine":
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max(1, niter)))
    if policy == "plateau":
        return base_lr
    raise NotImplementedError(
        f"learning rate policy [{policy}] is not implemented")
