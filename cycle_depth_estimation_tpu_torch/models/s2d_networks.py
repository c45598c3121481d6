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
- ``get_masks``, ``bce_dep_loss`` and ``bce_dep_loss_truncated``.

All BatchNorms are ``ops/layers.BatchNorm`` (flax's running-variance
update). Each net's ``jax_sites`` names its parts as the JAX module's
variable tree does, which ``utils/weights.s2d_state_dicts_from_jax`` reads.
A reference ``.pth`` loads as it is: ``load_state_dict`` drops the
DataParallel ``module.`` prefix, and ``RDep`` the ``up0``/``dep_out``/``norm``
entries its forward never uses, as the JAX importers do.

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
                          avg_pool, resize_bilinear)

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
    32), a 3×3 entry conv to 64 channels and ``n_blocks`` dual residual
    blocks; 64 channels at half the input size."""

    def __init__(self, n_blocks: int = 3):
        super().__init__()
        self.features = nn.Sequential(OrderedDict(_stem() + [
            ("denseblock1", DenseBlock(6, 64, 32))]))
        self.model = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(64 + 6 * 32, 64, 3, bias=False),
            BatchNorm(64), nn.ReLU(),
            *(DualResnetBlock(64) for _ in range(n_blocks)))

    def forward(self, x):
        return self.model(self.features(x))

    def jax_sites(self):
        f, m = self.features, self.model
        return {"conv0": f.conv0, "norm0": f.norm0,
                "denseblock1": f.denseblock1, "entry_conv": m[1],
                "entry_norm": m[2],
                **{f"block{i}": b for i, b in enumerate(m[4:])}}


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
        q = mid_nc // 4
        self.psp = nn.ModuleList([
            BatchNorm(nf), nn.ReLU(), Conv2d(nf, q, 1, bias=False),
            Conv2d(nf, q, 1, bias=False),
            Conv2d(nf, q, 2, padding=1, dilation=2, bias=False),
            Conv2d(nf, q, 3, padding=2, dilation=2, bias=False),
            BatchNorm(mid_nc)])
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
        p = self.psp
        h = p[1](p[0](h))
        return p[6](torch.cat([p[k](h) for k in range(2, 6)], 1)), feats

    def jax_sites(self):
        f = self.features
        return {"conv0": f.conv0, "norm0": f.norm0,
                **{f"denseblock{i + 1}": getattr(f, f"denseblock{i + 1}")
                   for i in range(len(self.feature_channels))},
                **{f"psptrans{i}": t for i, t in enumerate(self.PSP)},
                "psp_norm_in": self.psp[0],
                **{f"psp_b{j}": self.psp[j + 2] for j in range(4)},
                "psp_norm_out": self.psp[6]}


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
