"""The nets of S2D, the ``new_multi`` generation (the JAX package's
``models/s2d_networks.py``, reference new_multi/networks5_ds.py), NCHW, with
the reference's state-dict names:

- ``DenseLayer``/``DenseBlock``: torchvision's DenseNet layer (BN, ReLU,
  1×1 to 4·k, BN, ReLU, 3×3 to k, concatenated onto the input);
- ``G1`` (``features.{conv0,norm0,denseblock1}``, then ``model``: reflect
  pad, entry conv, BN, ReLU and the ``DualResnetBlock``s at ``model.{4+i}``,
  each ``x + conv0_block(x) + conv1_block(x)``);
- ``GeneralNet`` (G_2): the DenseNet trunk whose transitions are
  ``PspTrans`` (``PSP.{i}.trans``), the 4-branch dilated PSP head (``psp``),
  and two modes: ``'R'`` from an image, ``'S'`` from G_1's features past the
  stem. It returns the head's output and each dense block's output,
  detached, as the reference does;
- ``RDep`` (R_D): three ``GSide`` attention fusions (``AT.{k}``), then
  ``SegBlock`` (``seg_d``, 28 classes) and ``DepthBlock`` (``dep``: four
  tanh band heads with channel-attention gates, and the fused depth);
- ``SDiscriminator`` (FD1–FD3): a BatchNorm PatchGAN in one flat ``model``
  whose first and last activations are one PReLU module, appended twice,
  so its α has two keys and is one parameter;
- ``DeconvBlock`` (LeakyReLU(0.02), then a 4×4 stride-2 transposed conv,
  optionally BatchNorm), the block of RefineNet-LW's ``segd`` heads;
- ``get_masks``, ``bce_dep_loss`` and ``bce_dep_loss_truncated``;
- the base my_seg_depth generation. ``S2D_base`` (networks2.py): ``G1``
  with ``block_type='resnet'``, ``GeneralNet2`` (standard ``Transition``s,
  five skip features), the skip decoders ``SEG2``/``DEP2``,
  ``CLASS_WEIGHTS_28`` and ``DropDiscriminator`` (live Dropout2d, its
  keep-masks passed in, optionally conditioned on the label map).
  ``S2D_alt`` (networks.py): the ``GBase`` encoders, ``FeatureNet``, the
  skip decoders ``SEGAlt``/``DEPAlt``; and ``PSPModule``. ``GeneralNet``,
  ``GeneralNet2`` and ``FeatureNet`` share one ``PspHead``;
- the two-trunk generations (two ``GeneralNet2``, shared skip-free
  decoders, a 1×1 critic). ``S2D_df`` (deeperfeatures/networks2.py):
  ``SEGDF``, ``DEPDF`` (a growth-36 dense prefix) and ``Dis2SegDF``.
  ``S2D_nd`` (new_depseg/networks2.py): ``SEG`` and ``DEP`` (``ordimat``
  coordinate channels), ``DiscriminatorSeg`` and, with ``--nd_4dis``, two
  256-channel ``Dis2SegDF``; ``bce_gan_loss``, ``real_dep_loss`` and the
  WGAN-GP ``calc_gradient_penalty``;
- the semantic_trans generation (trymulti/semantic_trans/networks5_ds.py):
  the refiner ``RDepST`` (``GSideST``, ``DepthBlockST``, ``SegBlockST``),
  the critics ``StarDiscriminator`` (DIS, Dis_80/160/320) and
  ``Discriminator2Seg``, and, which no model builds,
  ``FeatureDiscriminatorS`` and ``gram_matrix``/``style_loss``.

flax infers each layer's input width; here the widths come from the nets
they follow (``feature_channels``, G_1's 64, ``mid_nc``, SEGDF's
``feature_nc``, the ST blocks' ``out_c``).

All BatchNorms are ``ops/layers.BatchNorm`` (flax's running-variance
update). Each net's ``jax_sites`` names its parts as the JAX module's
variable tree does, which ``utils/weights.s2d_state_dicts_from_jax`` reads.
A reference ``.pth`` loads as it is: ``load_state_dict`` drops the
DataParallel ``module.`` prefix, ``RDep`` and ``RDepST`` the
``up0``/``dep_out``/``norm`` entries their forwards never use and the
decoders with ``DeconvBlock``s
(``SEG2``, ``DEP2``, ``SEG``, ``DEP``, ``SEGDF``, ``DEPDF``) their unused
``bn``, as the JAX importers do.

The JAX package's ``CDE_DENSE_CHUNKED`` dense blocks compute the same
function with the same variables in another memory layout for the TPU;
the port has the plain form only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import init_weights
from ..ops.layers import (BatchNorm, Conv2d, ConvTranspose2d, PReLU,
                          avg_pool, resize_bilinear, resize_nearest)
from .networks import ResnetBlock

LEAK = 0.02


def leaky(x: torch.Tensor, slope: float = LEAK) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _leaky() -> nn.Module:
    return nn.LeakyReLU(LEAK)


class Sites:
    """``jax_sites()`` maps the JAX module's names to this net's parts: a
    conv, a BatchNorm, a PReLU, or a ``Sites`` part with names of its own."""

    def jax_sites(self) -> Dict[str, nn.Module]:
        raise NotImplementedError

    def _flat(self, prefix=""):
        for name, m in self.jax_sites().items():
            if isinstance(m, Sites):
                yield from m._flat(f"{prefix}{name}.")
            else:
                yield prefix + name, m

    def _of(self, kinds):
        return {k: m for k, m in self._flat() if isinstance(m, kinds)}

    def site_convs(self):
        return self._of((nn.Conv2d, nn.ConvTranspose2d))

    def site_norms(self):
        return self._of(nn.BatchNorm2d)

    def site_prelus(self):
        return self._of(PReLU)


class _ReferenceNet(nn.Module, Sites):
    unused_prefixes: Tuple[str, ...] = ()

    def load_state_dict(self, state_dict, *args, **kw):
        """Load a port or reference state dict: ``module.`` prefixes are
        dropped, and so are the entries of ``unused_prefixes``."""
        sd = {(k[7:] if k.startswith("module.") else k): v
              for k, v in state_dict.items()}
        sd = {k: v for k, v in sd.items()
              if not k.startswith(self.unused_prefixes)}
        return super().load_state_dict(sd, *args, **kw)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------


class DenseLayer(nn.Sequential, Sites):
    def __init__(self, num_input: int, growth_rate: int):
        mid = 4 * growth_rate
        super().__init__(OrderedDict([
            ("norm1", BatchNorm(num_input)), ("relu1", nn.ReLU()),
            ("conv1", Conv2d(num_input, mid, 1, bias=False)),
            ("norm2", BatchNorm(mid)), ("relu2", nn.ReLU()),
            ("conv2", Conv2d(mid, growth_rate, 3, padding=1, bias=False))]))

    def forward(self, x):
        return torch.cat([x, super().forward(x)], 1)

    def jax_sites(self):
        return {n: getattr(self, n) for n in ("norm1", "conv1", "norm2",
                                              "conv2")}


class DenseBlock(nn.Sequential, Sites):
    def __init__(self, num_layers: int, num_input: int, growth_rate: int):
        super().__init__(OrderedDict(
            (f"denselayer{i + 1}",
             DenseLayer(num_input + i * growth_rate, growth_rate))
            for i in range(num_layers)))

    def jax_sites(self):
        return dict(self.named_children())


def _stem():
    """conv0 7×7 stride 2 to 64 channels, norm0, relu0."""
    return [("conv0", Conv2d(3, 64, 7, 2, 3, bias=False)),
            ("norm0", BatchNorm(64)), ("relu0", nn.ReLU())]


class DualResnetBlock(nn.Module, Sites):
    """x + (1×1 conv, dilation 2, BN) + (reflect pad, 3×3 conv, BN, ReLU)
    (networks5_ds.py:290-338); no dropout, as S2D builds it."""

    def __init__(self, dim: int):
        super().__init__()
        # index 0: the reference's ReflectionPad2d(0)
        self.conv0_block = nn.Sequential(
            nn.Identity(), Conv2d(dim, dim, 1, dilation=2, bias=False),
            BatchNorm(dim))
        self.conv1_block = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3, bias=False),
            BatchNorm(dim), nn.ReLU())

    def forward(self, x):
        return x + self.conv0_block(x) + self.conv1_block(x)

    def jax_sites(self):
        return {"conv0": self.conv0_block[1], "norm0": self.conv0_block[2],
                "conv1": self.conv1_block[1], "norm1": self.conv1_block[2]}


class G1(_ReferenceNet):
    """G_1 (networks5_ds.py:26-66): stem, one 6-layer dense block (growth
    32), a 3×3 entry conv to 64 channels and ``n_blocks`` residual blocks;
    64 channels at half the input size. ``block_type`` 'dual' is S2D's
    ``DualResnetBlock``; 'resnet' the base generation's two-conv
    ``networks.ResnetBlock`` with BatchNorm (my_seg_depth/networks2.py:
    285-329; keys ``model.{4+i}.conv_block.{1,2,5,6}``)."""

    def __init__(self, n_blocks: int = 3, block_type: str = "dual"):
        super().__init__()
        if block_type not in ("dual", "resnet"):
            raise ValueError(f"unknown block_type [{block_type}]")
        self.block_type = block_type
        block = (DualResnetBlock if block_type == "dual"
                 else lambda d: ResnetBlock(d, norm="batch"))
        self.features = nn.Sequential(OrderedDict(_stem() + [
            ("denseblock1", DenseBlock(6, 64, 32))]))
        self.model = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(64 + 6 * 32, 64, 3, bias=False),
            BatchNorm(64), nn.ReLU(), *(block(64) for _ in range(n_blocks)))

    def forward(self, x):
        return self.model(self.features(x))

    def jax_sites(self):
        f, m = self.features, self.model
        sites = {"conv0": f.conv0, "norm0": f.norm0,
                 "denseblock1": f.denseblock1, "entry_conv": m[1],
                 "entry_norm": m[2]}
        for i, b in enumerate(m[4:]):
            if self.block_type == "dual":
                sites[f"block{i}"] = b
            else:
                c = b.conv_block
                sites.update({f"block{i}.conv1": c[1], f"block{i}.norm1": c[2],
                              f"block{i}.conv2": c[5],
                              f"block{i}.norm2": c[6]})
        return sites


class PspTrans(nn.Module, Sites):
    """_pspTrans (networks5_ds.py:344-361): BN, ReLU, a 1×1 and a 3×3 conv
    to a quarter of the channels each, concatenated, then avgpool 2."""

    def __init__(self, num_input: int):
        super().__init__()
        nout = num_input // 4
        self.trans = nn.ModuleList([
            BatchNorm(num_input), nn.ReLU(),
            Conv2d(num_input, nout, 1, bias=False),
            Conv2d(num_input, nout, 3, padding=1, bias=False)])

    def forward(self, x):
        h = self.trans[1](self.trans[0](x))
        return avg_pool(torch.cat([self.trans[2](h), self.trans[3](h)], 1), 2)

    def jax_sites(self):
        return {"norm": self.trans[0], "conv1x1": self.trans[2],
                "conv3x3": self.trans[3]}


class PspHead(nn.ModuleList, Sites):
    """The 4-branch dilated PSP head of ``GeneralNet``, ``GeneralNet2`` and
    ``FeatureNet`` (the JAX ``psp_head``, networks5_ds.py:394-409): BN,
    ReLU, four ``mid_nc``/4-channel branches (1×1, 1×1, a 2×2 at dilation 2
    padded by 1 — the reference's quirk, which keeps the size — and a 3×3
    at dilation 2), concatenated, BN. Keys ``psp.{0..6}``, the JAX names
    flat in the owner's (``psp_norm_in``, ``psp_b0``…, ``psp_norm_out``)."""

    def __init__(self, num_input: int, mid_nc: int):
        q = mid_nc // 4
        super().__init__([
            BatchNorm(num_input), nn.ReLU(),
            Conv2d(num_input, q, 1, bias=False),
            Conv2d(num_input, q, 1, bias=False),
            Conv2d(num_input, q, 2, padding=1, dilation=2, bias=False),
            Conv2d(num_input, q, 3, padding=2, dilation=2, bias=False),
            BatchNorm(mid_nc)])

    def forward(self, x):
        h = self[1](self[0](x))
        return self[6](torch.cat([self[k](h) for k in range(2, 6)], 1))

    def jax_sites(self):
        return {"psp_norm_in": self[0],
                **{f"psp_b{j}": self[j + 2] for j in range(4)},
                "psp_norm_out": self[6]}


class GeneralNet(_ReferenceNet):
    """General_net, G_2 (networks5_ds.py:366-477). ``forward(x, mode)``
    returns (the PSP head's ``mid_nc`` channels at 1/16 of the image, the
    four dense blocks' outputs detached)."""

    def __init__(self, mid_nc: int = 1024, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 32, 32)):
        super().__init__()
        layers, psp, channels = _stem(), [], []
        nf = 64
        for i, n in enumerate(block_config):
            layers.append((f"denseblock{i + 1}",
                           DenseBlock(n, nf, growth_rate)))
            nf += n * growth_rate
            channels.append(nf)
            if i != len(block_config) - 1:
                psp.append(PspTrans(nf))
                nf = 2 * (nf // 4)
        self.features = nn.Sequential(OrderedDict(layers))
        self.PSP = nn.ModuleList(psp)
        self.psp = PspHead(nf, mid_nc)
        self.mid_nc = mid_nc
        self.feature_channels = tuple(channels)

    def forward(self, x, mode: str = "R"):
        f = self.features
        h = f.relu0(f.norm0(f.conv0(x))) if mode == "R" else x
        feats = []
        for i in range(len(self.feature_channels)):
            h = getattr(f, f"denseblock{i + 1}")(h)
            feats.append(h.detach())
            if i < len(self.PSP):
                h = self.PSP[i](h)
        return self.psp(h), feats

    def jax_sites(self):
        f = self.features
        return {"conv0": f.conv0, "norm0": f.norm0,
                **{f"denseblock{i + 1}": getattr(f, f"denseblock{i + 1}")
                   for i in range(len(self.feature_channels))},
                **{f"psptrans{i}": t for i, t in enumerate(self.PSP)},
                **self.psp.jax_sites()}


# ---------------------------------------------------------------------------
# R_dep refiner
# ---------------------------------------------------------------------------


class GSide(nn.Module, Sites):
    """G_side (networks5_ds.py:623-651): a channel attention from the deep
    feature gates the projected skip feature; the sum is compressed to half
    the channels and upsampled ×2 (bilinear, corners aligned)."""

    def __init__(self, df_c: int, s_c: int):
        super().__init__()
        c = df_c
        self.attention_bs = nn.Sequential(
            Conv2d(c, c, 3, 2, 1), BatchNorm(c), _leaky(),
            nn.AdaptiveAvgPool2d(1), nn.Sigmoid())
        self.side_conv = nn.Sequential(
            Conv2d(s_c, c, 3, 1, 1), _leaky(), BatchNorm(c),
            Conv2d(c, c, 1), _leaky(), BatchNorm(c))
        self.conv = nn.Sequential(
            Conv2d(c, c // 2, 3, 1, 1), _leaky(), BatchNorm(c // 2),
            Conv2d(c // 2, c // 2, 1), _leaky(), BatchNorm(c // 2))

    def forward(self, s_feature, d_feature):
        h = self.conv(d_feature + self.attention_bs(d_feature)
                      * self.side_conv(s_feature))
        return resize_bilinear(h, (h.shape[2] * 2, h.shape[3] * 2),
                               align_corners=True)

    def jax_sites(self):
        a, s, c = self.attention_bs, self.side_conv, self.conv
        return {"at_conv": a[0], "at_norm": a[1], "side_conv0": s[0],
                "side_norm0": s[2], "side_conv1": s[3], "side_norm1": s[5],
                "out_conv0": c[0], "out_norm0": c[2], "out_conv1": c[3],
                "out_norm1": c[5]}


class DepthBlock(nn.Module, Sites):
    """depth_block (networks5_ds.py:655-706): four ×2 deconv branches, each
    with a tanh depth head and a channel-attention gate; the gated branches
    fused into one depth map (BatchNorm, no tanh)."""

    def __init__(self, in_c: int = 128):
        super().__init__()
        c, h = in_c, in_c // 2
        self.upconv = nn.ModuleList(nn.Sequential(
            ConvTranspose2d(c, h, 4, 2, 1), _leaky(), BatchNorm(h),
            Conv2d(h, h, 3, 1, 1), _leaky(), BatchNorm(h)) for _ in range(4))
        self.depth_out = nn.ModuleList(nn.Sequential(
            Conv2d(h, 1, 3, 1, 1), nn.Tanh()) for _ in range(4))
        self.attention_bs = nn.ModuleList(nn.Sequential(
            Conv2d(c, h, 3, 2, 1), _leaky(), BatchNorm(h),
            Conv2d(h, h, 3, 2, 1), _leaky(), nn.AdaptiveAvgPool2d(1),
            nn.Sigmoid()) for _ in range(4))
        self.conv = nn.Sequential(
            Conv2d(4 * h, c, 3, 1, 1), _leaky(), BatchNorm(c),
            Conv2d(c, h, 3, 1, 1), _leaky(), BatchNorm(h))
        self.depconv = nn.Sequential(Conv2d(h, 1, 3, 1, 1), BatchNorm(1))

    def forward(self, x):
        dep_o, out_f = [], []
        for up, head, att in zip(self.upconv, self.depth_out,
                                 self.attention_bs):
            f = up(x)
            dep_o.append(head(f))
            out_f.append(att(x) * f + f)
        return dep_o, self.depconv(self.conv(torch.cat(out_f, 1)))

    def jax_sites(self):
        sites = {}
        for i in range(4):
            u, a = self.upconv[i], self.attention_bs[i]
            sites.update({f"up{i}_deconv": u[0], f"up{i}_norm0": u[2],
                          f"up{i}_conv": u[3], f"up{i}_norm1": u[5],
                          f"depth_out{i}": self.depth_out[i][0],
                          f"at{i}_conv0": a[0], f"at{i}_norm": a[2],
                          f"at{i}_conv1": a[3]})
        return {**sites, "fuse_conv0": self.conv[0],
                "fuse_norm0": self.conv[2], "fuse_conv1": self.conv[3],
                "fuse_norm1": self.conv[5], "dep_conv": self.depconv[0],
                "dep_norm": self.depconv[1]}


class SegBlock(nn.Module, Sites):
    """seg_block (networks5_ds.py:708-728): 3×3 conv, leaky ReLU, BN, 1×1
    to the classes, bilinear ×2, BN, leaky ReLU."""

    def __init__(self, in_c: int = 128, out_c: int = 28):
        super().__init__()
        self.deconv = nn.Sequential(
            Conv2d(in_c, in_c, 3, 1, 1), _leaky(), BatchNorm(in_c),
            Conv2d(in_c, out_c, 1))
        self.bn = BatchNorm(out_c)

    def forward(self, x):
        h = self.deconv(x)
        h = resize_bilinear(h, (h.shape[2] * 2, h.shape[3] * 2),
                            align_corners=True)
        return leaky(self.bn(h))

    def jax_sites(self):
        return {"conv0": self.deconv[0], "norm0": self.deconv[2],
                "conv1": self.deconv[3], "norm1": self.bn}


class RDep(_ReferenceNet):
    """R_dep (networks5_ds.py:733-821): ``forward(s_features, d_feature)``
    on G_2's outputs returns ((out0, out1, out2), seg, (dep_4, dep_o)).
    ``base_c`` is G_2's ``mid_nc``; ``feature_nc`` the channels of G_2's
    four skip features."""

    unused_prefixes = ("up0.", "dep_out.", "norm.")

    def __init__(self, base_c: int = 1024,
                 feature_nc: Sequence[int] = (256, 512, 1280, 1664)):
        super().__init__()
        c = base_c
        self.AT = nn.ModuleList([GSide(c, feature_nc[3]),
                                 GSide(c // 2, feature_nc[2]),
                                 GSide(c // 4, feature_nc[1])])
        self.seg_d = SegBlock(c // 8, 28)
        self.dep = DepthBlock(c // 8)

    def forward(self, s_features, d_feature):
        out0 = self.AT[0](s_features[3], d_feature)
        out1 = self.AT[1](s_features[2], out0)
        out2 = self.AT[2](s_features[1], out1)
        return (out0, out1, out2), self.seg_d(out2), self.dep(out2)

    def jax_sites(self):
        return {**{f"gs{k}": g for k, g in enumerate(self.AT)},
                "seg_d": self.seg_d, "dep": self.dep}


# ---------------------------------------------------------------------------
# the semantic_trans generation's refiner (semantic_trans/networks5_ds.py:
# 496-695)
# ---------------------------------------------------------------------------


class GSideST(nn.Module, Sites):
    """G_side of the semantic_trans generation (networks5_ds.py:496-521): a
    channel attention from the deep feature (conv s2, BN, LeakyReLU, global
    mean, sigmoid) gates the projected skip feature (conv, LeakyReLU, BN);
    that and the deep feature concatenated, then conv, LeakyReLU, BN back to
    ``df_c``, at the deep feature's size. ``s_c``: the skip feature's
    channels; ``d_c``: the deep feature's (default ``df_c``)."""

    def __init__(self, df_c: int, s_c: int, d_c: int = None):
        super().__init__()
        c, d_c = df_c, d_c or df_c
        self.attention_bs = nn.Sequential(
            Conv2d(d_c, c, 3, 2, 1), BatchNorm(c), _leaky(),
            nn.AdaptiveAvgPool2d(1), nn.Sigmoid())
        self.side_conv = nn.Sequential(Conv2d(s_c, c, 3, 1, 1), _leaky(),
                                       BatchNorm(c))
        self.conv = nn.Sequential(Conv2d(d_c + c, c, 3, 1, 1), _leaky(),
                                  BatchNorm(c))

    def forward(self, s_feature, d_feature):
        gated = self.attention_bs(d_feature) * self.side_conv(s_feature)
        return self.conv(torch.cat([d_feature, gated], 1))

    def jax_sites(self):
        a, s, c = self.attention_bs, self.side_conv, self.conv
        return {"at_conv": a[0], "at_norm": a[1], "side_conv": s[0],
                "side_norm": s[2], "out_conv": c[0], "out_norm": c[2]}


class DepthBlockST(nn.Module, Sites):
    """depth_block of the semantic_trans generation (networks5_ds.py:
    523-577): four ×2 branches (deconv, LeakyReLU, BN), each with a tanh
    depth head and an attention gate (conv s2, LeakyReLU, BN, global mean,
    sigmoid: ``a·f + f``); the gated branches fused (conv, LeakyReLU, BN) to
    ``in_c``/2 channels F, then an edge head (``s_econv``: conv, BN,
    sigmoid) and a depth head (``depconv``: conv, BN). Returns (F, the four
    band depths, concat(edge, depth))."""

    def __init__(self, in_c: int):
        super().__init__()
        c, h = in_c, in_c // 2
        self.upconv = nn.ModuleList(nn.Sequential(
            ConvTranspose2d(c, h, 4, 2, 1), _leaky(), BatchNorm(h))
            for _ in range(4))
        self.depth_out = nn.ModuleList(nn.Sequential(
            Conv2d(h, 1, 3, 1, 1), nn.Tanh()) for _ in range(4))
        self.attention_bs = nn.ModuleList(nn.Sequential(
            Conv2d(c, h, 3, 2, 1), _leaky(), BatchNorm(h),
            nn.AdaptiveAvgPool2d(1), nn.Sigmoid()) for _ in range(4))
        self.conv = nn.Sequential(Conv2d(4 * h, h, 3, 1, 1), _leaky(),
                                  BatchNorm(h))
        self.s_econv = nn.Sequential(Conv2d(h, 1, 3, 1, 1), BatchNorm(1),
                                     nn.Sigmoid())
        self.depconv = nn.Sequential(Conv2d(h, 1, 3, 1, 1), BatchNorm(1))
        self.out_c = h

    def forward(self, x):
        dep_o, out_f = [], []
        for up, head, att in zip(self.upconv, self.depth_out,
                                 self.attention_bs):
            f = up(x)
            dep_o.append(head(f))
            out_f.append(att(x) * f + f)
        feat = self.conv(torch.cat(out_f, 1))
        return feat, dep_o, torch.cat([self.s_econv(feat),
                                       self.depconv(feat)], 1)

    def jax_sites(self):
        sites = {}
        for i in range(4):
            u, a = self.upconv[i], self.attention_bs[i]
            sites.update({f"up{i}_deconv": u[0], f"up{i}_norm": u[2],
                          f"depth_out{i}": self.depth_out[i][0],
                          f"at{i}_conv": a[0], f"at{i}_norm": a[2]})
        return {**sites, "fuse_conv": self.conv[0],
                "fuse_norm": self.conv[2], "se_conv": self.s_econv[0],
                "se_norm": self.s_econv[1], "dep_conv": self.depconv[0],
                "dep_norm": self.depconv[1]}


class SegBlockST(nn.Module, Sites):
    """seg_block of the semantic_trans generation (networks5_ds.py:
    579-598): LeakyReLU, a ×2 deconv to ``out_c``, BN; and a 1×1 28-class
    head ``result`` with a LeakyReLU. Returns (the features, the logits)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_c, out_c, 4, 2, 1)
        self.bn = BatchNorm(out_c)
        self.result = Conv2d(out_c, 28, 1)
        self.out_c = out_c

    def forward(self, x):
        h = self.bn(self.deconv(leaky(x)))
        return h, leaky(self.result(h))

    def jax_sites(self):
        return {"deconv": self.deconv, "bn": self.bn, "result": self.result}


class RDepST(_ReferenceNet):
    """R_dep of the semantic_trans generation (networks5_ds.py:601-695), a
    four-level top-down refiner at the fixed widths 1024, 512, 256 and 128.
    Level k: ``AT.k`` (``GSideST``) fuses G_2's skip feature 3 − k into the
    running deep feature (level 0: G_2's ``d_nc``-channel PSP output; then
    the depth features), ``Dep.k`` (``DepthBlockST``) takes it ×2, and
    ``Seg.k`` (``SegBlockST``) chains the seg features, concatenated with
    the depth features from level 1 on. ``forward(s_features, d_feature)``
    returns (seds, segs, deps) at the input image's size: the (edge, depth)
    pairs and the band depths of levels 1–3 (bilinear, corners aligned),
    the logits of levels 1–3 (nearest). Level 0's logits, bands and pair
    are computed and dropped, as in the reference (its BatchNorms move);
    its unused ``up0``/``dep_out``/``norm`` entries are dropped on load.
    ``feature_nc``: G_2's four skip widths."""

    unused_prefixes = ("up0.", "dep_out.", "norm.")
    WIDTHS = (1024, 512, 256, 128)

    def __init__(self, d_nc: int = 1024,
                 feature_nc: Sequence[int] = (256, 512, 1280, 1664)):
        super().__init__()
        at, seg, dep = [], [], []
        deep = d_nc
        seg_in = self.WIDTHS[0]
        for k, c in enumerate(self.WIDTHS):
            at.append(GSideST(c, feature_nc[3 - k], deep))
            dep.append(DepthBlockST(c))
            seg.append(SegBlockST(seg_in, c // 2))
            deep = dep[-1].out_c
            seg_in = seg[-1].out_c + deep
        self.AT, self.Seg, self.Dep = (nn.ModuleList(m) for m in (at, seg,
                                                                  dep))

    @staticmethod
    def _up(x, k, nearest=False):
        if k == 1:
            return x
        size = (x.shape[2] * k, x.shape[3] * k)
        return (resize_nearest(x, size) if nearest
                else resize_bilinear(x, size, align_corners=True))

    def forward(self, s_features, d_feature):
        deep, seg_f, outs = d_feature, None, []
        for k in range(4):
            h = self.AT[k](s_features[3 - k], deep)
            seg_in = h if seg_f is None else torch.cat([seg_f, deep], 1)
            seg_f, logits = self.Seg[k](seg_in)
            deep, bands, sed = self.Dep[k](h)
            outs.append((logits, bands, sed))
        ups = (4, 2, 1)
        seds = tuple(self._up(s, k) for (_, _, s), k in zip(outs[1:], ups))
        segs = tuple(self._up(g, k, nearest=True)
                     for (g, _, _), k in zip(outs[1:], ups))
        deps = tuple(torch.cat([self._up(d, k) for d in b], 1)
                     for (_, b, _), k in zip(outs[1:], ups))
        return seds, segs, deps

    def jax_sites(self):
        return {**{f"gs{k}": m for k, m in enumerate(self.AT)},
                **{f"seg{k}": m for k, m in enumerate(self.Seg)},
                **{f"dep{k}": m for k, m in enumerate(self.Dep)}}


# ---------------------------------------------------------------------------
# discriminator
# ---------------------------------------------------------------------------


class SDiscriminator(_ReferenceNet):
    """_Discriminator (networks5_ds.py:527-566): a BatchNorm PatchGAN whose
    first and last activations are one PReLU, each middle layer's its own."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        shared = PReLU()
        layers = [Conv2d(input_nc, ndf, 4, 2, 1, bias=False), shared]
        nf = 1
        for i in range(1, n_layers):
            prev, nf = nf, min(2 ** i, 8)
            layers += [Conv2d(ndf * prev, ndf * nf, 4, 2, 1, bias=False),
                       BatchNorm(ndf * nf), PReLU()]
        prev, nf = nf, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * prev, ndf * nf, 4, 1, 1, bias=False),
                   BatchNorm(ndf * nf), shared,
                   Conv2d(ndf * nf, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)
        self.n_layers = n_layers

    def forward(self, x):
        return self.model(x)

    def jax_sites(self):
        m, n = self.model, self.n_layers
        sites = {"conv0": m[0], "prelu_alpha": m[1]}
        for i in range(1, n):
            base = 2 + 3 * (i - 1)
            sites.update({f"conv{i}": m[base], f"norm{i}": m[base + 1],
                          f"prelu_mid{i}": m[base + 2]})
        base = 2 + 3 * (n - 1)
        return {**sites, f"conv{n}": m[base], f"norm{n}": m[base + 1],
                "conv_out": m[base + 3]}


class FeatureDiscriminatorS(nn.Module):
    """_FeatureDiscriminator with an explicit size (networks5_ds.py:
    569-599): over the NCHW-flattened ``input_nc`` × ``size`` input, a
    ``Linear`` to ``input_nc`` and a PReLU (``fc0``, ``prelu0``), then
    ``n_layers`` − 1 more such pairs, then ``fc_out`` to one output. No
    model builds it and no importer reads it: its names are the JAX
    module's."""

    def __init__(self, input_nc: int = 512, n_layers: int = 2,
                 size: Tuple[int, int] = (40, 12)):
        super().__init__()
        n_in = input_nc * size[0] * size[1]
        for i in range(n_layers):
            setattr(self, f"fc{i}", nn.Linear(n_in if i == 0 else input_nc,
                                               input_nc))
            setattr(self, f"prelu{i}", PReLU())
        self.fc_out = nn.Linear(input_nc, 1)
        self.n_layers = n_layers

    def forward(self, x):
        h = x.flatten(1)
        for i in range(self.n_layers):
            h = getattr(self, f"prelu{i}")(getattr(self, f"fc{i}")(h))
        return self.fc_out(h)


class StarDiscriminator(_ReferenceNet):
    """Discriminator (networks5_ds.py:264-288), norm-free: a 3×3 stride-2
    conv from ``input_nc`` to ``conv_dim`` channels, then ``repeat_num`` −
    1 × [4×4 stride-2 conv doubling the width], each followed by
    LeakyReLU(0.01) (convs at ``main.{2i}``); a bias-free 1×1 head
    ``conv1``, LeakyReLU(0.01), the channel dim squeezed. The
    semantic_trans generation's DIS (repeat 5 over the 2-channel (depth,
    label) pair) and Dis_80/Dis_160/Dis_320 (repeat 3, 4, 4 over a depth
    map). JAX names ``conv{i}``, ``head``."""

    def __init__(self, input_nc: int, conv_dim: int = 32, repeat_num: int = 6):
        super().__init__()
        layers = [Conv2d(input_nc, conv_dim, 3, 2, 1), nn.LeakyReLU(0.01)]
        dim = conv_dim
        for _ in range(1, repeat_num):
            layers += [Conv2d(dim, 2 * dim, 4, 2, 1), nn.LeakyReLU(0.01)]
            dim *= 2
        self.main = nn.Sequential(*layers)
        self.conv1 = Conv2d(dim, 1, 1, bias=False)

    def forward(self, x):
        return F.leaky_relu(self.conv1(self.main(x)), 0.01)[:, 0]

    def jax_sites(self):
        return {**{f"conv{i}": self.main[2 * i]
                   for i in range(len(self.main) // 2)},
                "head": self.conv1}


class Discriminator2Seg(_ReferenceNet):
    """Discriminator2_seg (networks5_ds.py:842-864): ``repeat_num`` × [1×1
    conv halving the width from ``conv_dim``, LeakyReLU(0.01), then
    BatchNorm] (``main.{3i}``, ``main.{3i+2}``) over ``input_nc``
    channels, a bias-free 3×3 stride-2 head ``conv1``, sigmoid, the channel
    dim squeezed. JAX names ``conv{i}``, ``norm{i}``, ``head``."""

    def __init__(self, input_nc: int, conv_dim: int = 1024,
                 repeat_num: int = 3):
        super().__init__()
        layers, cur, dim = [], input_nc, conv_dim
        for _ in range(repeat_num):
            dim //= 2
            layers += [Conv2d(cur, dim, 1), nn.LeakyReLU(0.01), BatchNorm(dim)]
            cur = dim
        self.main = nn.Sequential(*layers)
        self.conv1 = Conv2d(cur, 1, 3, 2, 1, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv1(self.main(x)))[:, 0]

    def jax_sites(self):
        n = len(self.main) // 3
        return {**{f"conv{i}": self.main[3 * i] for i in range(n)},
                **{f"norm{i}": self.main[3 * i + 2] for i in range(n)},
                "head": self.conv1}


class DeconvBlock(nn.Module, Sites):
    """DeconvBlock (networks5_ds.py:68-87): LeakyReLU(``negative_slope``),
    then ConvTranspose2d(k4, s2, p1) with a bias, then BatchNorm with
    ``batch_norm``. Keys ``deconv`` and ``bn``."""

    def __init__(self, input_nc: int, output_nc: int, batch_norm: bool = False,
                 negative_slope: float = LEAK):
        super().__init__()
        self.negative_slope = negative_slope
        self.deconv = ConvTranspose2d(input_nc, output_nc, 4, 2, 1)
        self.bn = BatchNorm(output_nc) if batch_norm else None

    def forward(self, x):
        h = self.deconv(F.leaky_relu(x, self.negative_slope))
        return h if self.bn is None else self.bn(h)

    def jax_sites(self):
        return ({"deconv": self.deconv} if self.bn is None
                else {"deconv": self.deconv, "bn": self.bn})


def ordimat(x: torch.Tensor) -> torch.Tensor:
    """The coordinate channels of ``x`` (networks5_ds.py:824-838): (row
    index, column index) as two channels of x's size, device and dtype."""
    n, _, h, w = x.shape
    rows = torch.arange(h, device=x.device, dtype=torch.float32)
    cols = torch.arange(w, device=x.device, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(rows, cols, indexing="ij"))
    return grid.to(x.dtype).expand(n, 2, h, w)


class _Ladder(_ReferenceNet):
    """The skip-free decoders of the lineage's legacy generations: four
    ``DeconvBlock``s (``Up.0..3``) to 512, 256, 128 and 64 channels, each ×2,
    then a 1×1 head ``Up.4``; with ``coords`` two ``ordimat`` channels go in
    front of each DeconvBlock. A reference ``.pth`` also holds each
    DeconvBlock's unused ``bn``; ``load_state_dict`` drops it. JAX names:
    ``up{i}``, ``head``."""

    unused_prefixes = tuple(f"Up.{i}.bn." for i in range(4))
    WIDTHS = (512, 256, 128, 64)

    def __init__(self, input_nc: int, out_c: int, negative_slope: float,
                 coords: bool = False):
        super().__init__()
        ins = (input_nc, *self.WIDTHS[:-1])
        self.coords = coords
        self.Up = nn.ModuleList(
            [DeconvBlock(a + 2 * coords, b, negative_slope=negative_slope)
             for a, b in zip(ins, self.WIDTHS)]
            + [Conv2d(self.WIDTHS[-1], out_c, 1)])

    def decode(self, x):
        """The head's output and each DeconvBlock's."""
        outs, h = [], x
        for up in self.Up[:4]:
            h = up(torch.cat([h, ordimat(h)], 1) if self.coords else h)
            outs.append(h)
        return self.Up[4](h), outs

    def jax_sites(self):
        return {**{f"up{i}": self.Up[i] for i in range(4)},
                "head": self.Up[4]}


class _SegLadder(_Ladder):
    """A ``_Ladder`` to ``n_cls`` channels, then BN (``activation_seg.0``)
    and LeakyReLU(0.01)."""

    def __init__(self, n_cls: int, input_nc: int, negative_slope: float):
        super().__init__(input_nc, n_cls, negative_slope)
        self.activation_seg = nn.Sequential(BatchNorm(n_cls),
                                            nn.LeakyReLU(0.01))

    def jax_sites(self):
        return {**super().jax_sites(), "act_norm": self.activation_seg[0]}


class SEG(_SegLadder):
    """SEG (networks5_ds.py:866-890): the ladder over ``input_nc`` channels
    (G's ``mid_nc``) to ``n_cls`` classes. ``forward`` returns (seg, its
    input). ``negative_slope``: the DeconvBlocks' LeakyReLU, 0.02 in
    networks5_ds, 0 (ReLU) in the new_depseg generation (S2D_nd)."""

    def __init__(self, n_cls: int, input_nc: int,
                 negative_slope: float = LEAK):
        super().__init__(n_cls, input_nc, negative_slope)

    def forward(self, x):
        return self.activation_seg(self.decode(x)[0]), x


class DEP(_Ladder):
    """DEP (networks5_ds.py:892-921): the ladder over ``input_nc`` channels
    with two ``ordimat`` channels in front of each DeconvBlock, to one
    channel; tanh with ``tanh_head`` (the new_depseg generation applies
    it)."""

    def __init__(self, input_nc: int, tanh_head: bool = False,
                 negative_slope: float = LEAK):
        super().__init__(input_nc, 1, negative_slope, coords=True)
        self.tanh_head = tanh_head

    def forward(self, x):
        h = self.decode(x)[0]
        return torch.tanh(h) if self.tanh_head else h


# ---------------------------------------------------------------------------
# the base my_seg_depth generation: S2D_base (networks2.py) and S2D_alt
# (networks.py)
# ---------------------------------------------------------------------------


class Transition(nn.Sequential, Sites):
    """torchvision's _Transition (networks5_ds.py:148-155): BN, ReLU, a 1×1
    conv to ``num_output`` channels, avgpool 2."""

    def __init__(self, num_input: int, num_output: int):
        super().__init__(OrderedDict([
            ("norm", BatchNorm(num_input)), ("relu", nn.ReLU()),
            ("conv", Conv2d(num_input, num_output, 1, bias=False)),
            ("pool", nn.AvgPool2d(2, 2))]))

    def jax_sites(self):
        return {"norm": self.norm, "conv": self.conv}


class _DenseTrunk(_ReferenceNet):
    """``features.denseblock{i}`` with a halving ``features.transition{i}``
    between blocks, then the PSP head (``psp``); ``feature_channels`` are
    the dense blocks' output widths."""

    def _build(self, layers, num_input, growth_rate, block_config, mid_nc):
        nf, channels = num_input, []
        for i, n in enumerate(block_config):
            layers.append((f"denseblock{i + 1}",
                           DenseBlock(n, nf, growth_rate)))
            nf += n * growth_rate
            channels.append(nf)
            if i != len(block_config) - 1:
                layers.append((f"transition{i + 1}", Transition(nf, nf // 2)))
                nf //= 2
        self.features = nn.Sequential(OrderedDict(layers))
        self.psp = PspHead(nf, mid_nc)
        self.mid_nc = mid_nc
        self.n_blocks = len(block_config)
        return tuple(channels)

    def _trunk(self, h):
        """Each dense block's output, and the PSP head's output."""
        feats = []
        for i in range(self.n_blocks):
            h = getattr(self.features, f"denseblock{i + 1}")(h)
            feats.append(h)
            if i < self.n_blocks - 1:
                h = getattr(self.features, f"transition{i + 1}")(h)
        return feats, self.psp(h)

    def _trunk_sites(self):
        f = self.features
        return {**{n: getattr(f, n) for i in range(self.n_blocks)
                   for n in (f"denseblock{i + 1}", f"transition{i + 1}")
                   if hasattr(f, n)},
                **self.psp.jax_sites()}


class GeneralNet2(_DenseTrunk):
    """General_net of the base generation (my_seg_depth/networks2.py:
    395-481): the DenseNet trunk with standard transitions, then the PSP
    head. ``forward(x, mode)`` returns (five skip features, the head's
    ``mid_nc`` channels at 1/16): the stem's post-ReLU output at 1/2 and
    the four dense blocks' outputs (64, 256, 512, 1280 and 1664 channels at
    (6, 12, 32, 32); ``feature_channels``), none detached. Mode 'R' runs the
    stem on an image; mode 'S' takes G_1's 64 channels through ``norm0`` and
    ReLU only, ``conv0`` kept and unused."""

    def __init__(self, mid_nc: int = 1024, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 32, 32)):
        super().__init__()
        self.feature_channels = (64, *self._build(
            _stem(), 64, growth_rate, block_config, mid_nc))

    def forward(self, x, mode: str = "R"):
        f = self.features
        h = f.relu0(f.norm0(f.conv0(x) if mode == "R" else x))
        feats, out = self._trunk(h)
        return [h, *feats], out

    def jax_sites(self):
        f = self.features
        return {"conv0": f.conv0, "norm0": f.norm0, **self._trunk_sites()}


class FeatureNet(_DenseTrunk):
    """Feature_net (my_seg_depth/networks.py:226-288): a stemless DenseNet
    (growth 48, blocks (6, 8, 8)) over ``input_nc`` feature channels, then
    the PSP head. Returns (the three dense blocks' outputs, the head's
    ``mid_nc`` channels)."""

    def __init__(self, input_nc: int = 128, mid_nc: int = 1024,
                 growth_rate: int = 48,
                 block_config: Sequence[int] = (6, 8, 8)):
        super().__init__()
        self.feature_channels = self._build([], input_nc, growth_rate,
                                            block_config, mid_nc)

    def forward(self, x):
        return self._trunk(x)

    def jax_sites(self):
        return self._trunk_sites()


class _SkipDecoder(_ReferenceNet):
    """The base generation's SEG/DEP body (networks2.py:489-566): adapters
    ``trans_0`` (ConvTranspose k2 s2 to 64) and ``trans_1..4`` (1×1 to 128,
    256, 512, 1024) over GeneralNet2's five features (``feature_nc``), then
    ``Up.0..3`` — ``DeconvBlock``s with a ReLU (slope 0), each taking the
    running map and the next skip — and the 1×1 head ``Up.4`` over the last
    map and ``trans_0``'s, at full resolution. A reference ``.pth`` also
    holds each DeconvBlock's unused ``bn``; ``load_state_dict`` drops it.
    JAX names: ``dec.trans_*``, ``dec.up{i}``, ``dec.head``."""

    unused_prefixes = tuple(f"Up.{i}.bn." for i in range(4))

    def __init__(self, out_c: int, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (64, 256, 512, 1280, 1664)):
        super().__init__()
        self.trans_0 = ConvTranspose2d(feature_nc[0], 64, 2, 2)
        widths = (128, 256, 512, 1024)
        for i, c in enumerate(widths):
            setattr(self, f"trans_{i + 1}", Conv2d(feature_nc[i + 1], c, 1))
        ins = (mid_nc, 512, 256, 256)
        outs = (512, 256, 256, 256)
        self.Up = nn.ModuleList(
            [DeconvBlock(a + s, b, negative_slope=0.0)
             for a, s, b in zip(ins, widths[::-1], outs)]
            + [Conv2d(outs[-1] + 64, out_c, 1)])

    def decode(self, features, x):
        f = [getattr(self, f"trans_{i}")(features[i]) for i in range(5)]
        h = x
        for i in range(4):
            h = self.Up[i](torch.cat([h, f[4 - i]], 1))
        return self.Up[4](torch.cat([h, f[0]], 1))

    def jax_sites(self):
        return {**{f"dec.trans_{i}": getattr(self, f"trans_{i}")
                   for i in range(5)},
                **{f"dec.up{i}": self.Up[i] for i in range(4)},
                "dec.head": self.Up[4]}


class SEG2(_SkipDecoder):
    """SEG of the base generation (networks2.py:489-531): the skip decoder,
    then BN (``activation_seg.0``) and LeakyReLU(0.01)."""

    def __init__(self, n_cls: int = 28, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (64, 256, 512, 1280, 1664)):
        super().__init__(n_cls, mid_nc, feature_nc)
        self.activation_seg = nn.Sequential(BatchNorm(n_cls),
                                            nn.LeakyReLU(0.01))

    def forward(self, features, x):
        return self.activation_seg(self.decode(features, x))

    def jax_sites(self):
        return {**super().jax_sites(), "act_norm": self.activation_seg[0]}


class DEP2(_SkipDecoder):
    """DEP of the base generation (networks2.py:534-566): the skip decoder
    to one channel, tanh."""

    def __init__(self, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (64, 256, 512, 1280, 1664)):
        super().__init__(1, mid_nc, feature_nc)

    def forward(self, features, x):
        return torch.tanh(self.decode(features, x))


# the 28-class CE weights of S2D_base (my_seg_depth/model2.py:175-204)
CLASS_WEIGHTS_28 = (
    1.4, 0.8, 1.2, 1.4, 1.3, 0.8, 1.3, 1.4, 1.4, 1.4, 1.4, 1.4, 1.4, 1.5,
    1.5, 1.2, 1.3, 1.1, 2.0, 2.0, 1.1, 1.8, 1.8, 1.8, 1.8, 1.8, 1.8, 1.8,
)


class DropDiscriminator(_ReferenceNet):
    """The base generation's feature Discriminator (networks2.py:331-353):
    ``repeat_num − 1`` × [conv 4×4 stride 2 doubling the width, LeakyReLU
    0.01, Dropout2d 0.2] (``main.{3i}``), then the bias-free 1×1 head
    ``conv1``; the output's channel dim squeezed. ``input_nc`` is what comes
    in (G_1's features); the doubling starts from ``conv_dim``. With
    ``sege`` (the dis_seg generation, dis_seg/networks2.py:331-354) the
    label map, nearest-resized to half its size, goes in front of the
    input, and the doubling starts from ``conv_dim + 1``.

    ``forward(x, sege=None, masks=None)``: in train mode ``masks`` are the
    keep-masks of the dropout layers, (N, C) booleans each (``widths``);
    kept channels are scaled by 1/0.8 as the JAX ``nn.Dropout`` does.
    Without them the ``Dropout2d`` modules draw from torch's generator."""

    KEEP = 0.8

    def __init__(self, input_nc: int = 64, conv_dim: int = 64,
                 repeat_num: int = 4, dis_seg: bool = False):
        super().__init__()
        cur, dim = input_nc + dis_seg, conv_dim + dis_seg
        layers, widths = [], []
        for _ in range(1, repeat_num):
            dim *= 2
            layers += [Conv2d(cur, dim, 4, 2, 1), nn.LeakyReLU(0.01),
                       nn.Dropout2d(1 - self.KEEP)]
            widths.append(dim)
            cur = dim
        self.main = nn.Sequential(*layers)
        self.conv1 = Conv2d(cur, 1, 1, bias=False)
        self.widths = tuple(widths)

    def draw_masks(self, n: int, generator: torch.Generator):
        """One set of keep-masks for a batch of ``n``, on the CPU."""
        return [torch.rand(n, c, generator=generator) < self.KEEP
                for c in self.widths]

    def forward(self, x, sege=None, masks=None):
        if sege is not None:
            h, w = sege.shape[2:]
            x = torch.cat([resize_nearest(sege, (h // 2, w // 2)), x], 1)
        h = x
        for i in range(len(self.widths)):
            conv, act, drop = self.main[3 * i:3 * i + 3]
            h = act(conv(h))
            if masks is None:
                h = drop(h)
            elif self.training:
                keep = masks[i].to(h.device)[:, :, None, None]
                h = torch.where(keep, h / self.KEEP, torch.zeros_like(h))
        return self.conv1(h)[:, 0]

    def jax_sites(self):
        return {**{f"conv{i + 1}": self.main[3 * i]
                   for i in range(len(self.widths))},
                "head": self.conv1}


class PSPModule(nn.Module, Sites):
    """PSPModule (my_seg_depth/networks.py:12-30): for each size s of
    ``sizes`` an adaptive average pool to s×s (``nn.AdaptiveAvgPool2d``:
    bin i of an axis covers [⌊i·L/s⌋, ⌈(i+1)·L/s⌉), the JAX
    ``adaptive_avg_pool``'s non-uniform bins) and a bias-free 1×1 conv
    (``stages.{i}.1``), resized back bilinearly (half-pixel centres);
    those and the input concatenated, a 1×1 ``bottleneck`` with a bias,
    ReLU."""

    def __init__(self, features: int, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(nn.Sequential(
            nn.AdaptiveAvgPool2d((s, s)), Conv2d(features, features, 1,
                                                 bias=False))
            for s in sizes)
        self.bottleneck = Conv2d(features * (len(sizes) + 1), out_features, 1)

    def forward(self, x):
        size = x.shape[2:]
        priors = [resize_bilinear(stage(x), size, align_corners=False)
                  for stage in self.stages]
        return F.relu(self.bottleneck(torch.cat([*priors, x], 1)))

    def jax_sites(self):
        return {**{f"stage{i}_conv": s[1] for i, s in enumerate(self.stages)},
                "bottleneck": self.bottleneck}


class GBase(_ReferenceNet):
    """G_1 of S2D_alt (my_seg_depth/networks.py:83-127): a CycleGAN encoder
    with BatchNorm — reflect pad 3, 7×7 conv, two stride-2 downs,
    ``n_blocks`` two-conv ``ResnetBlock``s (``model.{10+i}``), reflect pad
    3, a 7×7 head to ``out_nc`` channels with a bias (``model.{11+n}``),
    tanh; 1/4 of the input size. Convs before a BatchNorm have no bias."""

    def __init__(self, input_nc: int = 3, ngf: int = 64, n_blocks: int = 3,
                 out_nc: int = 128):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, bias=False),
                  BatchNorm(ngf), nn.ReLU()]
        for i in range(2):
            c = ngf * 2 ** i
            layers += [Conv2d(c, 2 * c, 3, 2, 1, bias=False), BatchNorm(2 * c),
                       nn.ReLU()]
        layers += [ResnetBlock(4 * ngf, norm="batch") for _ in range(n_blocks)]
        layers += [nn.ReflectionPad2d(3), Conv2d(4 * ngf, out_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)
        self.n_blocks = n_blocks

    def forward(self, x):
        return self.model(x)

    def jax_sites(self):
        m = self.model
        sites = {"stem_conv": m[1], "stem_norm": m[2], "down0_conv": m[4],
                 "down0_norm": m[5], "down1_conv": m[7], "down1_norm": m[8],
                 "head": m[11 + self.n_blocks]}
        for i in range(self.n_blocks):
            c = m[10 + i].conv_block
            sites.update({f"block{i}_conv0": c[1], f"block{i}_norm0": c[2],
                          f"block{i}_conv1": c[5], f"block{i}_norm1": c[6]})
        return sites


class _SkipDecoderAlt(_ReferenceNet):
    """The SEG/DEP body of S2D_alt (my_seg_depth/networks.py:289-351):
    1×1 adapters ``trans.{i}`` (to 256, 256, 128) over FeatureNet's three
    features, deepest first, each concatenated onto the running map before
    a ConvTranspose k2 s2 ``Up.{i}`` (to 512, 256, 256), then ``Up.3`` to
    ``out_c`` at full resolution. JAX names: ``dec.trans_{i}``,
    ``dec.up_{i}``."""

    TRANS = (256, 256, 128)
    UP = (512, 256, 256)

    def __init__(self, out_c: int, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (416, 592, 680)):
        super().__init__()
        self.trans = nn.ModuleList(
            Conv2d(feature_nc[2 - i], c, 1) for i, c in enumerate(self.TRANS))
        ins = (mid_nc, *self.UP[:2])
        self.Up = nn.ModuleList(
            [ConvTranspose2d(a + t, b, 2, 2)
             for a, t, b in zip(ins, self.TRANS, self.UP)]
            + [ConvTranspose2d(self.UP[-1], out_c, 2, 2)])

    def decode(self, features, x):
        h = x
        for i in range(3):
            h = self.Up[i](torch.cat([h, self.trans[i](features[2 - i])], 1))
        return self.Up[3](h)

    def jax_sites(self):
        return {**{f"dec.trans_{i}": t for i, t in enumerate(self.trans)},
                **{f"dec.up_{i}": u for i, u in enumerate(self.Up)}}


class SEGAlt(_SkipDecoderAlt):
    """SEG of S2D_alt (networks.py:289-319): the skip decoder to ``n_cls``
    channels, tanh — the reference trains its CE on these."""

    def __init__(self, n_cls: int = 28, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (416, 592, 680)):
        super().__init__(n_cls, mid_nc, feature_nc)

    def forward(self, features, x):
        return torch.tanh(self.decode(features, x))


class DEPAlt(_SkipDecoderAlt):
    """DEP of S2D_alt (networks.py:321-351): the skip decoder to one
    channel, LeakyReLU(0.01)."""

    def __init__(self, mid_nc: int = 1024,
                 feature_nc: Sequence[int] = (416, 592, 680)):
        super().__init__(1, mid_nc, feature_nc)

    def forward(self, features, x):
        return F.leaky_relu(self.decode(features, x), 0.01)


# ---------------------------------------------------------------------------
# the two-trunk generations: S2D_df (deeperfeatures/networks2.py) and S2D_nd
# (new_depseg/networks2.py)
# ---------------------------------------------------------------------------


class SEGDF(_SegLadder):
    """SEG of the deeperfeatures generation (networks2.py:532-560): the
    ReLU ladder over ``input_nc`` channels (G's ``mid_nc``). ``forward``
    returns (seg, ``Up.0``'s output after a ReLU): the reference stores
    ``Up.0``'s output and ``Up.1``'s in-place ReLU rewrites it, so what it
    returns, and DEPDF and Dis0_en read, is post-ReLU. ``feature_nc`` is
    those features' width."""

    feature_nc = _Ladder.WIDTHS[0]

    def __init__(self, n_cls: int, input_nc: int):
        super().__init__(n_cls, input_nc, 0.0)

    def forward(self, x):
        h, outs = self.decode(x)
        return self.activation_seg(h), F.relu(outs[0])


class DEPDF(_Ladder):
    """DEP of the deeperfeatures generation (networks2.py:563-610): over
    ``input_nc`` channels (SEGDF's ``feature_nc``) a growth-36 DenseBlock of
    8 layers (``features.0``), a halving ``Transition`` (``features.1``) and
    a DenseBlock of 18 (``features.2``), 1048 channels at half the input
    size from 512; then the ReLU ladder with ``ordimat`` channels to one
    channel, tanh. JAX names ``block0``, ``trans0``, ``block1``."""

    GROWTH = 36

    def __init__(self, input_nc: int):
        k = self.GROWTH
        n0 = input_nc + 8 * k
        n1 = n0 // 2 + 18 * k
        super().__init__(n1, 1, 0.0, coords=True)
        self.features = nn.Sequential(DenseBlock(8, input_nc, k),
                                      Transition(n0, n0 // 2),
                                      DenseBlock(18, n0 // 2, k))

    def forward(self, x):
        return torch.tanh(self.decode(self.features(x))[0])

    def jax_sites(self):
        f = self.features
        return {"block0": f[0], "trans0": f[1], "block1": f[2],
                **super().jax_sites()}


class _HalvingCritic(_ReferenceNet):
    """The norm-free 1×1 critics of these generations: ``repeat_num`` ×
    [1×1 conv halving the width from ``conv_dim``, LeakyReLU(0.01)]
    (``main.{2i}``) over ``input_nc`` channels, then the bias-free 1×1 head
    ``conv1`` to ``head_ch``. JAX names ``conv{i}``, ``head``."""

    def __init__(self, input_nc: int, conv_dim: int, repeat_num: int,
                 head_ch: int):
        super().__init__()
        layers, cur, dim = [], input_nc, conv_dim
        for _ in range(repeat_num):
            dim //= 2
            layers += [Conv2d(cur, dim, 1), nn.LeakyReLU(0.01)]
            cur = dim
        self.main = nn.Sequential(*layers)
        self.conv1 = Conv2d(cur, head_ch, 1, bias=False)

    def jax_sites(self):
        return {**{f"conv{i}": self.main[2 * i]
                   for i in range(len(self.main) // 2)},
                "head": self.conv1}


class Dis2SegDF(_HalvingCritic):
    """Discriminator2_seg of the deeperfeatures generation
    (networks2.py:499-531), a sigmoid on the head; with one head channel
    the channel dim is squeezed. S2D_df: ``conv_dim`` 512 over SEGDF's 512
    features. The new_depseg copy (networks2.py:496-527, ``--nd_4dis``'s
    twin critics): ``conv_dim`` 256 over a 256-channel slice, 28 head
    channels."""

    def __init__(self, input_nc: int, conv_dim: int = 512,
                 repeat_num: int = 3, head_ch: int = 1):
        super().__init__(input_nc, conv_dim, repeat_num, head_ch)

    def forward(self, x):
        h = torch.sigmoid(self.conv1(self.main(x)))
        return h[:, 0] if h.shape[1] == 1 else h


class DiscriminatorSeg(_HalvingCritic):
    """Discriminator_seg (new_depseg/networks2.py:462-494): the critic at
    ``conv_dim`` 1024 over G's ``mid_nc`` channels, 28 head channels, then
    LeakyReLU(0.01)."""

    def __init__(self, input_nc: int, conv_dim: int = 1024,
                 repeat_num: int = 3, n_cls: int = 28):
        super().__init__(input_nc, conv_dim, repeat_num, n_cls)

    def forward(self, x):
        return F.leaky_relu(self.conv1(self.main(x)), 0.01)


ND_SLICE = 256  # the psp channels each of --nd_4dis's twin critics reads


def _trunks(cfg):
    blocks = tuple(cfg.dense_block_config or (6, 12, 32, 32))
    return {"G_1": GeneralNet2(block_config=blocks),
            "G_2": GeneralNet2(block_config=blocks)}


def s2d_df_nets(cfg) -> Dict[str, nn.Module]:
    """The five S2D_df nets at ``cfg``'s ``dense_block_config``,
    uninitialised: two GeneralNet2 trunks, SEGDF over their ``mid_nc``, and
    DEPDF and Dis0_en over SEGDF's features."""
    nets = _trunks(cfg)
    seg = SEGDF(28, nets["G_1"].mid_nc)
    return {**nets, "Dis0_en": Dis2SegDF(seg.feature_nc, 512),
            "Seg_de": seg, "Dep_de": DEPDF(seg.feature_nc)}


def s2d_nd_nets(cfg) -> Dict[str, nn.Module]:
    """The S2D_nd nets at ``cfg``'s ``dense_block_config``, uninitialised:
    two GeneralNet2 trunks, the ReLU SEG and the tanh DEP over their
    ``mid_nc``, and Dis_en (``DiscriminatorSeg``) or, with ``nd_4dis``,
    the twin critics Dis0_en and Dis1_en over 256-channel slices."""
    nets = _trunks(cfg)
    mid = nets["G_1"].mid_nc
    if cfg.nd_4dis:
        for k in ("Dis0_en", "Dis1_en"):
            nets[k] = Dis2SegDF(ND_SLICE, ND_SLICE, 3, 28)
    else:
        nets["Dis_en"] = DiscriminatorSeg(mid, 1024)
    return {**nets, "Seg_de": SEG(28, mid, 0.0),
            "Dep_de": DEP(mid, tanh_head=True, negative_slope=0.0)}


def s2d_base_nets(cfg) -> Dict[str, nn.Module]:
    """The five S2D_base nets at ``cfg``'s widths (``g1_blocks``,
    ``dense_block_config``, ``ndf``, ``d_repeat_num``, ``dis_seg``; the
    trunk's growth and head stay the reference's 32 and 1024, as in the JAX
    model), uninitialised. The discriminator takes G_1's 64 channels."""
    g2 = GeneralNet2(block_config=tuple(cfg.dense_block_config
                                        or (6, 12, 32, 32)))
    return {"G_1": G1(n_blocks=cfg.g1_blocks, block_type="resnet"),
            "G_2": g2,
            "Dis_en": DropDiscriminator(64, cfg.ndf, cfg.d_repeat_num,
                                        cfg.dis_seg),
            "Seg_de": SEG2(28, feature_nc=g2.feature_channels),
            "Dep_de": DEP2(feature_nc=g2.feature_channels)}


def s2d_alt_nets(cfg) -> Dict[str, nn.Module]:
    """The six S2D_alt nets (fixed widths; ``net_g`` '3blocks' or
    '6blocks' sets the encoders' residual blocks, anything else 3, as in
    the JAX model), uninitialised."""
    n_blocks = {"3blocks": 3, "6blocks": 6}.get(cfg.net_g, 3)
    feature = FeatureNet(128)
    return {"G_1": GBase(n_blocks=n_blocks), "G_2": GBase(n_blocks=n_blocks),
            "Dis_en": DropDiscriminator(128, 128),
            "Feature": feature,
            "Seg_de": SEGAlt(28, feature_nc=feature.feature_channels),
            "Dep_de": DEPAlt(feature_nc=feature.feature_channels)}


def _init_nets(nets, kaiming_nets, generator):
    """Kaiming convs in ``kaiming_nets`` (their ``ResnetBlock``s N(0,
    0.02²), as the JAX ``ResnetBlock``'s default), N(0, 0.02²) elsewhere;
    zero biases."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for name, net in nets.items():
        if name in kaiming_nets:
            init_weights(net, "kaiming", 0.0, generator)
            for m in net.modules():
                if isinstance(m, ResnetBlock):
                    init_weights(m, "normal", 0.02, generator)
        else:
            init_weights(net, "normal", 0.02, generator)
    return nets


def define_s2d_base_nets(cfg, generator: torch.Generator = None
                         ) -> Dict[str, nn.Module]:
    """``s2d_base_nets`` initialised as the JAX nets are: G_1 and G_2
    kaiming, the rest N(0, 0.02²)."""
    return _init_nets(s2d_base_nets(cfg), ("G_1", "G_2"), generator)


def define_s2d_alt_nets(cfg, generator: torch.Generator = None
                        ) -> Dict[str, nn.Module]:
    """``s2d_alt_nets`` initialised as the JAX nets are: Feature kaiming,
    the rest N(0, 0.02²)."""
    return _init_nets(s2d_alt_nets(cfg), ("Feature",), generator)


def define_s2d_df_nets(cfg, generator: torch.Generator = None
                       ) -> Dict[str, nn.Module]:
    """``s2d_df_nets`` initialised as the JAX nets are: G_1, G_2 and
    Dep_de's dense prefix kaiming, the rest N(0, 0.02²)."""
    nets = _init_nets(s2d_df_nets(cfg), ("G_1", "G_2"), generator)
    init_weights(nets["Dep_de"].features, "kaiming", 0.0, generator)
    return nets


def define_s2d_nd_nets(cfg, generator: torch.Generator = None
                       ) -> Dict[str, nn.Module]:
    """``s2d_nd_nets`` initialised as the JAX nets are: G_1 and G_2
    kaiming, the rest N(0, 0.02²)."""
    return _init_nets(s2d_nd_nets(cfg), ("G_1", "G_2"), generator)


def s2d_nets(cfg) -> Dict[str, nn.Module]:
    """The six S2D nets at ``cfg``'s widths (``g1_blocks``,
    ``dense_block_config``, ``dense_growth_rate``, ``s2d_mid_nc``; None is
    the reference's), uninitialised."""
    mid = cfg.s2d_mid_nc or 1024
    g2 = GeneralNet(mid, growth_rate=cfg.dense_growth_rate or 32,
                    block_config=tuple(cfg.dense_block_config
                                       or (6, 12, 32, 32)))
    return {"G_1": G1(n_blocks=cfg.g1_blocks), "G_2": g2,
            "R_D": RDep(mid, g2.feature_channels),
            "FD1": SDiscriminator(mid // 2), "FD2": SDiscriminator(mid // 4),
            "FD3": SDiscriminator(mid // 8)}


def define_s2d_nets(cfg, generator: torch.Generator = None
                    ) -> Dict[str, nn.Module]:
    """``s2d_nets`` initialised as the JAX nets are, from ``generator``:
    kaiming convs in G_1 and G_2, N(0, 0.02²) in R_D and the FDs; zero
    biases, BatchNorm (1, 0), PReLU α 0.25."""
    nets = s2d_nets(cfg)
    for name, net in nets.items():
        if name in ("G_1", "G_2"):
            init_weights(net, "kaiming", 0.0, generator)
        else:
            init_weights(net, "normal", 0.02, generator)
    return nets


def star_critics() -> Dict[str, nn.Module]:
    """The semantic_trans generation's four ``StarDiscriminator``s,
    uninitialised: DIS over the (depth, label) pair, repeat 5; Dis_80,
    Dis_160 and Dis_320 over a depth map, repeat 3, 4 and 4."""
    return {"DIS": StarDiscriminator(2, repeat_num=5),
            **{k: StarDiscriminator(1, repeat_num=r)
               for k, r in (("Dis_80", 3), ("Dis_160", 4), ("Dis_320", 4))}}


def semantic_trans_nets(cfg) -> Dict[str, nn.Module]:
    """The ten semantic_trans nets, uninitialised: ``s2d_nets`` and
    ``star_critics``."""
    return {**s2d_nets(cfg), **star_critics()}


def define_semantic_trans_nets(cfg, generator: torch.Generator = None
                               ) -> Dict[str, nn.Module]:
    """``semantic_trans_nets`` initialised as the JAX nets are: the S2D
    nets as ``define_s2d_nets`` draws them, then the critics N(0,
    0.02²)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return {**define_s2d_nets(cfg, generator),
            **_init_nets(star_critics(), (), generator)}


def semantic_trans_full_nets(cfg) -> Dict[str, nn.Module]:
    """The ten semantic_trans_full nets at ``cfg``'s ``g1_blocks`` and
    ``dense_block_config`` (G_2's growth and ``mid_nc`` the JAX defaults,
    32 and 1024), uninitialised: G_1, G_2 (``GeneralNet``), Seg_de and
    Dep_de (``SEG``/``DEP`` at slope 0.02, no tanh) over G_2's ``mid_nc``,
    R_D (``RDepST`` over G_2's outputs), Dis0_en (``Discriminator2Seg``
    over Seg_de's input) and ``star_critics``."""
    g2 = GeneralNet(block_config=tuple(cfg.dense_block_config
                                       or (6, 12, 32, 32)))
    mid = g2.mid_nc
    return {"G_1": G1(n_blocks=cfg.g1_blocks), "G_2": g2,
            "Seg_de": SEG(28, mid), "Dep_de": DEP(mid),
            "R_D": RDepST(mid, g2.feature_channels),
            "Dis0_en": Discriminator2Seg(mid), **star_critics()}


def define_semantic_trans_full_nets(cfg, generator: torch.Generator = None
                                    ) -> Dict[str, nn.Module]:
    """``semantic_trans_full_nets`` initialised as the JAX nets are: G_1
    and G_2 kaiming, the rest N(0, 0.02²)."""
    return _init_nets(semantic_trans_full_nets(cfg), ("G_1", "G_2"),
                      generator)


# ---------------------------------------------------------------------------
# losses (networks5_ds.py:947-982)
# ---------------------------------------------------------------------------


def get_masks(target: torch.Tensor):
    """(target == 1, target == −1) in the target's dtype."""
    return (target == 1.0).to(target.dtype), (target == -1.0).to(target.dtype)


def bce_dep_loss(pred: torch.Tensor, target: torch.Tensor,
                 o_m: torch.Tensor, z_m: torch.Tensor) -> torch.Tensor:
    """BCEDepLoss (networks5_ds.py:947-956): BCE on the masked ±1 sites,
    each mapped to [0, 1], plus 50 × L1, in fp32. A 1-channel ``pred``
    broadcasts against the 4-channel target and masks, as in the reference.
    ``F.binary_cross_entropy`` is ATen's: logs clamped at −100, and a
    backward with its denominator clamped at 1e-12, finite where a bf16
    tanh saturates to exactly ±1."""
    pred, target = pred.float(), target.float()
    p = (pred + 1) / 2
    t = (target + 1) / 2
    return (F.binary_cross_entropy(p * o_m, t * o_m)
            + F.binary_cross_entropy(p * z_m, t * z_m)
            + 50.0 * (pred - target).abs().mean())


def bce_dep_loss_truncated(pred: torch.Tensor, target: torch.Tensor,
                           o_m: torch.Tensor, z_m: torch.Tensor
                           ) -> torch.Tensor:
    """The BCEDepLoss that RefineNet-LW trains with (the semantic_trans copy,
    networks5_ds.py:849-852): the BCE of the ``o_m`` sites alone, on
    ``F.binary_cross_entropy`` as in ``bce_dep_loss``. ``z_m`` is taken and
    not read, as in the JAX function."""
    del z_m
    pred, target = pred.float(), target.float()
    return F.binary_cross_entropy((pred + 1) / 2 * o_m, (target + 1) / 2 * o_m)


def _at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bce_gan_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """The GANLoss of the my_seg_depth generations: BCE against a 1 or 0
    target on the critic's output (new_depseg/networks2.py:626-650), in
    fp32 (float64 stays float64), the output clamped to [1e-7, 1 − 1e-7]
    as the JAX ``bce_gan_loss`` does (BCE is NaN past [0, 1], where a
    LeakyReLU head goes). ``F.binary_cross_entropy`` is the JAX formula
    inside that range, with ATen's clamped backward."""
    p = _at_least_fp32(pred).clamp(1e-7, 1.0 - 1e-7)
    return F.binary_cross_entropy(p, torch.full_like(p, float(target_is_real)))


def real_dep_loss(seg_p: torch.Tensor, seg_l: torch.Tensor,
                  dep_p: torch.Tensor, dep_l: torch.Tensor) -> torch.Tensor:
    """model3's pseudo-label depth term (deeperfeatures/model3.py:472-483):
    L1 between the real depth prediction and the *synthetic* depth label
    where the real seg prediction's argmax (the first maximum) equals the
    *synthetic* label map, per sample: cross-domain as the reference wrote
    it. Everything is detached: the term only reports. NCHW ``seg_p``,
    NHW ``seg_l``, N1HW ``dep_p`` and ``dep_l``; fp32."""
    mask = (seg_p.detach().float().argmax(1) == seg_l).float()
    dep_p = dep_p.detach().float()[:, 0]
    return (mask * dep_p - mask * dep_l.float()[:, 0]).abs().mean()


def calc_gradient_penalty(d, x_real: torch.Tensor, x_fake: torch.Tensor,
                          alpha: torch.Tensor, lambda_: float = 10.0
                          ) -> torch.Tensor:
    """The WGAN-GP penalty of the reference (semantic_trans/model5.py:
    354-382) with its quirks: only sample 0 is interpolated, by ``alpha``,
    the rest of the batch stays ``x_real``; the gradient's norm is taken
    over the channel axis alone, per pixel, with 1e-12 inside the square
    root. λ·mean((‖∂Σd(x̂)/∂x̂‖ − 1)²) in fp32 (float64 stays
    float64), differentiable in ``d``'s
    parameters (``create_graph``). The JAX function draws ``alpha`` from a
    key; the caller passes it here."""
    interp = _at_least_fp32(x_real.detach()).clone()
    interp[0] = (alpha * interp[0]
                 + (1.0 - alpha) * _at_least_fp32(x_fake[0].detach()))
    interp.requires_grad_(True)
    (g,) = torch.autograd.grad(_at_least_fp32(d(interp)).sum(), interp,
                               create_graph=True)
    gnorm = torch.sqrt((g * g).sum(1) + 1e-12)
    return lambda_ * ((gnorm - 1.0) ** 2).mean()


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """GramMatrix (networks5_ds.py:794-805): the NCHW input as N·C rows of
    H·W features F, in fp32; F·Fᵀ / (N·C·H·W). No model calls it (the
    reference's style terms are commented out)."""
    n, c, h, w = x.shape
    f = x.reshape(n * c, h * w).float()
    return f @ f.T / (n * c * h * w)


def style_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """StyleLoss (networks5_ds.py:807-817): the MSE of the Gram matrices."""
    return F.mse_loss(gram_matrix(x), gram_matrix(target))
