"""RefineNet-LW, the ``new_model`` track (the JAX package's
``models/refinenet.py``, reference new_model/my_rf_lw.py and
new_model/utils/layer_factory.py), NCHW, with the reference's state-dict
names (those ``import_resnetlw`` and ``import_segd`` read):

- ``ResNetLW``: a ResNet ``Bottleneck`` trunk (``conv1``, ``bn1``,
  ``layer1``–``layer4``) with two per-domain adapters after each layer,
  ``ins_layer{1-4}_{r,s}``: a 1×1 conv and the InstanceNorm kernel
  (affine=False). Both sets always exist; ``forward(x, domain)`` takes
  ``_r`` for 'real' and ``_s`` otherwise. Then the top-down fusion (``PSPBlock``
  and ``ATBlock`` stages, bilinear upsampling with aligned corners to each
  skip's size) and ``DepthBlockR6`` (``dep``). It returns (the four tanh
  band depths, the fused tanh depth, both at 1/2, and the features x4 512
  at 1/16, x3 256 at 1/8, x2 256 and x1 256 at 1/4);
- ``Segd``: ``up_scale`` ``DeconvBlock``s halving the channels, then a 1×1
  conv to ``n_cls`` + 1 logits (the extra class is 'fake'). The JAX head
  infers its input width; here it is ``in_c``;
- ``CRPBlock``, ``DCGANDiscriminator`` (no registered model builds them;
  their names are the JAX module's, since neither has a reference
  importer) and ``seg_gan_loss``.

Each net's ``jax_sites`` names its parts as the JAX module's variable
tree does, which ``utils/weights.rf_lw_state_dicts_from_jax`` reads. All
BatchNorms are ``ops/layers.BatchNorm`` (flax's running-variance update).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import init_weights
from ..ops.layers import (BatchNorm, Conv2d, ConvTranspose2d, InstanceNorm,
                          max_pool, resize_bilinear)
from .s2d_networks import DeconvBlock, Sites, _ReferenceNet
from .seg_network import cross_entropy_loss


class _Group(Sites):
    """A name level of the JAX variable tree that is no module here."""

    def __init__(self, sites: Dict[str, nn.Module]):
        self._sites = sites

    def jax_sites(self):
        return self._sites


def _conv1x1(i: int, o: int, bias: bool = False) -> Conv2d:
    return Conv2d(i, o, 1, bias=bias)


class ConvBnRelu6(nn.Sequential, Sites):
    """convbnrelu (layer_factory.py:21-29): conv (pad k//2, no bias), BN,
    ReLU6."""

    def __init__(self, i: int, o: int, k: int = 1):
        super().__init__(Conv2d(i, o, k, padding=k // 2, bias=False),
                         BatchNorm(o), nn.ReLU6())

    def jax_sites(self):
        return {"conv": self[0], "bn": self[1]}


class Bottleneck(nn.Module, Sites):
    """ResNet bottleneck (my_rf_lw.py:94-130); ``downsample`` is (1×1 conv,
    BN) where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)) if downsample else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + r)

    def jax_sites(self):
        sites = {n: getattr(self, n) for n in ("conv1", "bn1", "conv2", "bn2",
                                               "conv3", "bn3")}
        if self.downsample is not None:
            sites.update(down_conv=self.downsample[0],
                         down_bn=self.downsample[1])
        return sites


class ResLayer(nn.Sequential, Sites):
    def __init__(self, inplanes: int, planes: int, blocks: int,
                 stride: int = 1):
        need_down = stride != 1 or inplanes != planes * 4
        super().__init__(
            Bottleneck(inplanes, planes, stride, need_down),
            *(Bottleneck(planes * 4, planes) for _ in range(1, blocks)))

    def jax_sites(self):
        return {f"block{i}": b for i, b in enumerate(self)}


class InsAdapter(nn.Sequential, Sites):
    """Per-domain adapter (my_rf_lw.py:312-321): 1×1 conv without bias, then
    InstanceNorm (affine=False), the InstanceNorm kernel on the card."""

    def __init__(self, planes: int):
        super().__init__(_conv1x1(planes, planes), InstanceNorm())

    def jax_sites(self):
        return {"conv": self[0]}


class PSPBlock(nn.Module, Sites):
    """Four dilated 3×3 conv-BN-ReLU6 branches (d = 1, 3, 5, 7) to
    ``out_planes``/4 each, concatenated, plus a 1×1 conv (with bias)-BN-ReLU6
    residual (layer_factory.py:54-80). Keys ``{1-4}_pspconv``, ``conv``."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        for i in range(4):
            d = 2 * i + 1
            self.add_module(f"{i + 1}_pspconv", nn.Sequential(
                Conv2d(in_planes, out_planes // 4, 3, padding=d, dilation=d,
                       bias=False),
                BatchNorm(out_planes // 4), nn.ReLU6()))
        self.conv = nn.Sequential(_conv1x1(in_planes, out_planes, bias=True),
                                  BatchNorm(out_planes), nn.ReLU6())

    def _branch(self, i: int) -> nn.Sequential:
        return getattr(self, f"{i + 1}_pspconv")

    def forward(self, x):
        return (torch.cat([self._branch(i)(x) for i in range(4)], 1)
                + self.conv(x))

    def jax_sites(self):
        sites = {}
        for i in range(4):
            b = self._branch(i)
            sites.update({f"psp{i}_conv": b[0], f"psp{i}_bn": b[1]})
        return {**sites, "res_conv": self.conv[0], "res_bn": self.conv[1]}


class ATBlock(nn.Module, Sites):
    """Concat-attention fusion (layer_factory.py:83-113): the pair
    concatenated (2·``c`` channels), scaled by a channel gate (3×3 stride-2
    conv, BN, LeakyReLU(0.02), global mean, sigmoid), projected to
    ``out_c`` by a 1×1 conv."""

    def __init__(self, c: int, out_c: int):
        super().__init__()
        self.attention_bs2 = nn.Sequential(
            Conv2d(2 * c, 2 * c, 3, 2, 1), BatchNorm(2 * c),
            nn.LeakyReLU(0.02), nn.AdaptiveAvgPool2d(1))
        self.conv = _conv1x1(2 * c, out_c)

    def forward(self, s_feature, d_feature):
        x = torch.cat([s_feature, d_feature], 1)
        return self.conv(torch.sigmoid(self.attention_bs2(x)) * x)

    def jax_sites(self):
        a = self.attention_bs2
        return {"at_conv": a[0], "at_bn": a[1], "proj": self.conv}


class CRPBlock(nn.Module, Sites):
    """Chained residual pooling (layer_factory.py:31-51): ``n_stages`` times
    a 3×3 stride-1 max pool and a 1×1 conv, each stage added to ``x``."""

    def __init__(self, in_planes: int, out_planes: int, n_stages: int = 4):
        super().__init__()
        self.stages = nn.ModuleList(
            _conv1x1(in_planes if i == 0 else out_planes, out_planes)
            for i in range(n_stages))

    def forward(self, x):
        top = x
        for conv in self.stages:
            top = conv(max_pool(top, 3, 1, padding=1))
            x = top + x
        return x

    def jax_sites(self):
        return {f"stage{i}": c for i, c in enumerate(self.stages)}


class DepthBlockR6(_ReferenceNet):
    """depth_block, ReLU6 variant (my_rf_lw.py:169-224): four ×2 deconv
    branches, each with a tanh depth head and a channel-attention gate
    (``a·f + f``); the gated branches fused into one tanh depth map."""

    def __init__(self, in_c: int = 256):
        super().__init__()
        c, h = in_c, in_c // 2
        self.upconv = nn.ModuleList(nn.Sequential(
            ConvTranspose2d(c, h, 4, 2, 1), nn.LeakyReLU(0.02), BatchNorm(h),
            Conv2d(h, h, 1), nn.ReLU6(), BatchNorm(h)) for _ in range(4))
        self.depth_out = nn.ModuleList(nn.Sequential(
            Conv2d(h, 1, 3, padding=1), nn.Tanh()) for _ in range(4))
        self.attention_bs = nn.ModuleList(nn.Sequential(
            Conv2d(c, h, 3, 2, 1), nn.ReLU6(), BatchNorm(h),
            nn.AdaptiveAvgPool2d(1)) for _ in range(4))
        self.conv = nn.Sequential(Conv2d(4 * h, h, 3, padding=1),
                                  nn.LeakyReLU(0.02), BatchNorm(h))
        self.depconv = nn.Sequential(Conv2d(h, 1, 3, padding=1), nn.Tanh())

    def forward(self, x):
        deps, outs = [], []
        for up, head, att in zip(self.upconv, self.depth_out,
                                 self.attention_bs):
            f = up(x)
            deps.append(head(f))
            outs.append(torch.sigmoid(att(x)) * f + f)
        return deps, self.depconv(self.conv(torch.cat(outs, 1)))

    def jax_sites(self):
        sites = {}
        for i in range(4):
            u, a = self.upconv[i], self.attention_bs[i]
            sites.update({f"up{i}_deconv": u[0], f"up{i}_norm0": u[2],
                          f"up{i}_conv": u[3], f"up{i}_norm1": u[5],
                          f"depth_out{i}": self.depth_out[i][0],
                          f"at{i}_conv": a[0], f"at{i}_norm": a[2]})
        return {**sites, "fuse_conv": self.conv[0],
                "fuse_norm": self.conv[2], "dep_conv": self.depconv[0]}


# (JAX site, reference key) of the fusion's 1×1 convs
_DIMRED = (("g1_dimred", "mflow_conv_g1_b3_joint_varout_dimred"),
           ("g2_dimred", "mflow_conv_g2_b3_joint_varout_dimred"),
           ("g3_dimred", "mflow_conv_g3_b3_joint_varout_dimred"),
           ("adapt2", "adapt_stage2_b2_joint_varout_dimred"),
           ("adapt3", "adapt_stage3_b2_joint_varout_dimred"),
           ("adapt4", "adapt_stage4_b2_joint_varout_dimred"))
PLANES = (64, 128, 256, 512)


class ResNetLW(_ReferenceNet):
    """ResNetLW (my_rf_lw.py:226-457). ``layers`` is the blocks per trunk
    layer: (3, 4, 23, 3) is ResNet-101, (3, 4, 6, 3) ResNet-50."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for i, (planes, stride) in enumerate(zip(PLANES, (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}",
                            ResLayer(inplanes, planes, layers[i], stride))
            inplanes = planes * 4
            for sfx in ("s", "r"):
                self.add_module(f"ins_layer{i + 1}_{sfx}", InsAdapter(inplanes))
        self.p_ims1d2_outl1_dimred_ = ConvBnRelu6(2048, 1024)
        self.psp4 = nn.Sequential(PSPBlock(1024, 1024))
        self.mflow_conv_g1_b3_joint_varout_dimred = _conv1x1(1024, 512)
        self.p_ims1d2_outl2_dimred_ = ConvBnRelu6(1024, 512)
        self.adapt_stage2_b2_joint_varout_dimred = _conv1x1(512, 512)
        self.CAT3 = ATBlock(512, 512)
        self.psp3 = nn.Sequential(PSPBlock(512, 512))
        self.mflow_conv_g2_b3_joint_varout_dimred = _conv1x1(512, 256)
        self.p_ims1d2_outl3_dimred_ = ConvBnRelu6(512, 256)
        self.adapt_stage3_b2_joint_varout_dimred = _conv1x1(256, 256)
        self.CAT2 = ATBlock(256, 256)
        self.psp2 = nn.Sequential(PSPBlock(256, 256))
        self.mflow_conv_g3_b3_joint_varout_dimred = _conv1x1(256, 256)
        self.p_ims1d2_outl4_dimred_ = ConvBnRelu6(256, 256)
        self.adapt_stage4_b2_joint_varout_dimred = _conv1x1(256, 256)
        self.CAT1 = ATBlock(256, 256)
        self.psp1 = nn.Sequential(PSPBlock(256, 256))
        self.dep = DepthBlockR6(256)

    def trunk(self, x, domain: str = "real"):
        """The four adapted trunk features l1–l4."""
        sfx = "r" if domain == "real" else "s"
        h = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        feats = []
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            h = getattr(self, f"ins_layer{i + 1}_{sfx}")(h)
            feats.append(h)
        return feats

    def forward(self, x, domain: str = "real"):
        l1, l2, l3, l4 = self.trunk(x, domain)

        def up_to(t, ref):
            return resize_bilinear(t, ref.shape[2:], align_corners=True)

        x4 = F.relu(self.p_ims1d2_outl1_dimred_(l4))
        x4 = up_to(self.mflow_conv_g1_b3_joint_varout_dimred(self.psp4(x4)),
                   l3)
        x3 = self.adapt_stage2_b2_joint_varout_dimred(
            self.p_ims1d2_outl2_dimred_(l3))
        x3 = self.psp3(self.CAT3(x3, x4))
        x3 = up_to(self.mflow_conv_g2_b3_joint_varout_dimred(x3), l2)
        x2 = self.adapt_stage3_b2_joint_varout_dimred(
            self.p_ims1d2_outl3_dimred_(l2))
        x2 = self.psp2(self.CAT2(x2, x3))
        x2 = up_to(self.mflow_conv_g3_b3_joint_varout_dimred(x2), l1)
        x1 = self.adapt_stage4_b2_joint_varout_dimred(
            self.p_ims1d2_outl4_dimred_(l1))
        x1 = self.psp1(self.CAT1(x1, x2))
        outs, pred_d = self.dep(x1)
        return outs, pred_d, (x4, x3, x2, x1)

    def jax_sites(self):
        sites = {"conv1": self.conv1, "bn1": self.bn1}
        for i in range(1, 5):
            sites[f"layer{i}"] = getattr(self, f"layer{i}")
            for sfx in ("s", "r"):
                sites[f"ins_layer{i}_{sfx}"] = getattr(self,
                                                       f"ins_layer{i}_{sfx}")
        for k in range(1, 5):
            sites[f"outl{k}_dimred"] = getattr(self, f"p_ims1d2_outl{k}_dimred_")
            sites[f"psp{k}"] = getattr(self, f"psp{k}")[0]
        sites.update({mine: getattr(self, ref) for mine, ref in _DIMRED})
        sites.update(cat3=self.CAT3, cat2=self.CAT2, cat1=self.CAT1,
                     dep=self.dep)
        return sites


def rf_lw101() -> ResNetLW:
    """The ResNet-101 working point (my_rf_lw.py:519-521)."""
    return ResNetLW((3, 4, 23, 3))


class Segd(_ReferenceNet):
    """segd head (my_rf_lw.py:493-516): ``Up`` holds ``up_scale``
    ``DeconvBlock``s, ``in_c`` halved by each, and the 1×1 conv to
    ``n_cls`` + 1 logits. A reference ``.pth`` may hold ``Up.{i}.bn`` entries
    its forward never uses; ``load_state_dict`` drops them."""

    def __init__(self, in_c: int, n_cls: int = 28, up_scale: int = 1):
        super().__init__()
        blocks, c = [], in_c
        for _ in range(up_scale):
            blocks.append(DeconvBlock(c, c // 2))
            c //= 2
        self.Up = nn.ModuleList(blocks + [Conv2d(c, n_cls + 1, 1)])
        self.up_scale = up_scale
        self.unused_prefixes = tuple(f"Up.{i}.bn." for i in range(up_scale))

    def forward(self, x):
        for m in self.Up:
            x = m(x)
        return x

    def jax_sites(self):
        return {**{f"up{i}": self.Up[i] for i in range(self.up_scale)},
                "head": self.Up[self.up_scale]}


class DCGANDiscriminator(_ReferenceNet):
    """DCGAN_D with SELU (my_rf_lw.py:134-167): 4×4 stride-2 convs without
    bias from ``d_h_size`` channels, doubling ``n_middle`` times, a 4×4
    valid conv to one channel, sigmoid, flattened."""

    def __init__(self, input_nc: int, d_h_size: int = 64, n_middle: int = 5):
        super().__init__()
        self.start = Conv2d(input_nc, d_h_size, 4, 2, 1, bias=False)
        mids, c = [], d_h_size
        for _ in range(n_middle):
            mids.append(Conv2d(c, c * 2, 4, 2, 1, bias=False))
            c *= 2
        self.mid = nn.ModuleList(mids)
        self.end = Conv2d(c, 1, 4, 1, 0, bias=False)

    def forward(self, x):
        h = F.selu(self.start(x))
        for conv in self.mid:
            h = F.selu(conv(h))
        return torch.sigmoid(self.end(h)).reshape(-1)

    def jax_sites(self):
        return {"start": self.start,
                **{f"mid{i}": c for i, c in enumerate(self.mid)},
                "end": self.end}


def seg_gan_loss(logits: torch.Tensor, labels: torch.Tensor,
                 target_is_real: bool, n_cls: int = 28) -> torch.Tensor:
    """The heads as discriminators (my_rf_lw.py:523-537): CE to the labels
    when 'real', to the extra class ``n_cls`` (inside the ``n_cls`` + 1
    logits) everywhere when 'fake'; 255 ignored."""
    if not target_is_real:
        labels = torch.full_like(labels, n_cls)
    return cross_entropy_loss(logits, labels, 255)


# the four heads of rf_lw: (feature index, input width, up_scale); rf_lw7
# keeps seg2_0
HEADS = OrderedDict(seg8=(0, 512, 3), seg4=(1, 256, 2), seg2=(2, 256, 1),
                    seg2_0=(3, 256, 1))
N_CLS = 28


def rf_lw_nets(cfg) -> Dict[str, nn.Module]:
    """The nets of ``cfg.model`` (``rf_lw``: G and the four heads;
    ``rf_lw7``: G, ``seg2_0`` and the never-stepped ``depth`` block),
    uninitialised; ``cfg.resnet_layers`` None is each model's trunk."""
    if cfg.model == "rf_lw7":
        nets = {"G": ResNetLW(tuple(cfg.resnet_layers or (3, 4, 6, 3))),
                "seg2_0": Segd(256, N_CLS, 1), "depth": DepthBlockR6(256)}
    else:
        nets = {"G": ResNetLW(tuple(cfg.resnet_layers or (3, 4, 23, 3)))}
        nets.update((k, Segd(c, N_CLS, up)) for k, (_, c, up) in HEADS.items())
    return nets


def define_rf_lw_nets(cfg, generator: torch.Generator = None
                      ) -> Dict[str, nn.Module]:
    """``rf_lw_nets`` initialised as the JAX nets are, from ``generator``:
    kaiming convs in G but its depth block, N(0, 0.02²) there, in the heads
    and in rf_lw7's ``depth``; zero biases, BatchNorm (1, 0)."""
    nets = rf_lw_nets(cfg)
    for name, net in nets.items():
        if name == "G":
            init_weights(net, "kaiming", 0.0, generator)
            init_weights(net.dep, "normal", 0.02, generator)
        else:
            init_weights(net, "normal", 0.02, generator)
    return nets
