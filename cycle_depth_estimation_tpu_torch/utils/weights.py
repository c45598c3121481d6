"""Weights across the boundary: JAX param trees → port state dicts, and
reference ``.pth`` files.

``resnet_generator_state_dict_from_jax``,
``unet_generator_state_dict_from_jax`` and
``nlayer_discriminator_state_dict_from_jax`` are the inverses of the JAX
package's ``utils/torch_import.import_resnet_generator``,
``import_unet_generator`` and ``import_nlayer_discriminator`` (the last
takes instance norm only; the port's converter takes BatchNorm too):

- Conv: HWIO → OIHW, ``transpose(3, 2, 0, 1)`` (the up convs of a
  ``resize_conv`` generator are regular convs);
- ConvTranspose: the JAX kernel is the equivalent regular conv in HWIO,
  ``k = transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))`` of the torch
  ``(in, out, kH, kW)`` weight; undone by flipping ``k`` spatially and
  transposing back (``hwio_from_conv_transpose_weight`` goes forward);
- BatchNorm: flax ``params[site]['norm']`` ``scale``/``bias`` → ``weight``/
  ``bias``, ``batch_stats[site]['norm']`` ``mean``/``var`` →
  ``running_mean``/``running_var``. flax keeps no batch count, so
  ``num_batches_tracked`` is left out, as in a pre-0.4.1 reference ``.pth``;
- PReLU: the network's one ``prelu_alpha`` → every state-dict key of the
  shared module (``….weight`` under each block that holds it); a net with
  ``site_prelus`` (S2D's ``SDiscriminator``, T2Net's
  ``MultiscaleDiscriminator``: ``scale{i}.prelu_alpha``) names each α;
- Linear (a net's ``site_denses``, T2Net's ``FeatureDiscriminator``): the
  flax ``Dense`` kernel is (in, out), the torch weight (out, in).

``s2d_state_dicts_from_jax`` is the inverse of ``import_g1``,
``import_general_net``, ``import_rdep`` and ``import_sdiscriminator``;
``s2d_base_state_dicts_from_jax`` of ``import_g1_base``,
``import_general_net2``, ``import_seg2``, ``import_dep2`` and
``import_drop_discriminator``; ``s2d_alt_state_dicts_from_jax`` of
``import_gbase``, ``import_drop_discriminator``, ``import_feature_net`` and
``import_skip_decoder_alt`` (``PSPModule`` has no importer: it is held
against the JAX module's outputs); ``s2d_df_state_dicts_from_jax`` of
``import_general_net2``, ``import_seg_df``, ``import_dep_df`` and
``import_dis2seg_df``; ``s2d_nd_state_dicts_from_jax`` of
``import_general_net2``, ``import_seg_decoder``, ``import_dep_decoder``
and ``import_dis2seg_df`` (which reads ``DiscriminatorSeg`` and the twin
critics too); ``semantic_trans_state_dicts_from_jax`` of S2D's importers
and ``import_star_discriminator``; ``semantic_trans_full_state_dicts_from_jax``
of ``import_g1``, ``import_general_net``, ``import_seg_decoder``,
``import_dep_decoder``, ``import_rdep_st``, ``import_discriminator2_seg``
and ``import_star_discriminator`` (``FeatureDiscriminatorS`` has no
importer: it is held against the JAX module in its test);
``rf_lw_state_dicts_from_jax`` of ``import_resnetlw`` and ``import_segd``
(rf_lw7's ``depth`` block has no importer: it is held against the JAX
module's outputs).

The seg nets (T2Net's ``UNetGenerator``, SegCycle's ``UNetEncoder`` and
``UNetDecoder``, and ``ResGenerator``, ``Discriminator``,
``MultiscaleDiscriminator`` and ``FeatureDiscriminator``) have no JAX
importer and no reference ``.pth`` here: their converters are held against
the JAX modules' outputs, and the outer names of their state dicts against
nothing (``models/seg_network.py``). ``PreUNet16`` is also held through
the JAX package's ``import_preunet16``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from torch import nn

from ..models.encoder_decoder import UNetDecoder, UNetEncoder
from ..models.networks import (_RESNET_BLOCKS, _UNET_DOWNS,
                               NLayerDiscriminator, PixelDiscriminator,
                               ResnetGenerator, UnetGenerator)
from ..models.refinenet import rf_lw_nets
from ..models.s2d_networks import (s2d_alt_nets, s2d_base_nets,
                                    s2d_df_nets, s2d_nd_nets, s2d_nets,
                                    semantic_trans_full_nets,
                                    semantic_trans_nets)
from ..models.seg_network import UNetGenerator
from ..ops.layers import PReLU


def conv_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def hwio_from_conv_weight(w: torch.Tensor) -> np.ndarray:
    """OIHW torch conv weight → HWIO numpy (the JAX/int8 layout)."""
    return np.ascontiguousarray(
        w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))


def hwio_from_conv_transpose_weight(w: torch.Tensor) -> np.ndarray:
    """(in, out, kH, kW) torch ConvTranspose weight → the equivalent regular
    conv's HWIO kernel (the JAX ``ConvTranspose`` param and the JAX
    package's ``convert_convT_weight``)."""
    w = w.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _lookup(tree: Mapping[str, Any], site: str):
    for part in site.split("."):
        tree = tree[part]
    return tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _state_dict_from_jax(shell: nn.Module, params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] = None
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Fill the state-dict keys of ``shell`` (any width: only its module
    names are read) from JAX params, by ``shell.site_convs()``, and from
    ``params`` and ``batch_stats`` by ``shell.site_norms()`` where it has
    BatchNorms."""
    names = {module: name for name, module in shell.named_modules()}
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for site, module in shell.site_convs().items():
        entry = _lookup(params, site)
        convert = (conv_transpose_weight_from_hwio
                   if isinstance(module, nn.ConvTranspose2d)
                   else conv_weight_from_hwio)
        prefix = names[module]
        sd[f"{prefix}.weight"] = torch.tensor(
            convert(np.asarray(entry["kernel"], np.float32)))
        if "bias" in entry:
            sd[f"{prefix}.bias"] = _t(entry["bias"])
    norms = getattr(shell, "site_norms", dict)()
    for site, module in norms.items():
        if not isinstance(module, nn.BatchNorm2d):
            continue  # InstanceNorm(affine=False): nothing to carry
        prefix = names[module]
        p, s = _lookup(params, site)["norm"], _lookup(batch_stats, site)["norm"]
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _t(p["scale"]), _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
    for site, module in getattr(shell, "site_denses", dict)().items():
        entry, prefix = _lookup(params, site), names[module]
        sd[f"{prefix}.weight"] = torch.tensor(
            np.ascontiguousarray(np.asarray(entry["kernel"], np.float32).T))
        sd[f"{prefix}.bias"] = _t(entry["bias"])
    alphas = {m: site for site, m in
              getattr(shell, "site_prelus", dict)().items()}
    for name, module in shell.named_modules(remove_duplicate=False):
        if isinstance(module, PReLU):
            sd[f"{name}.weight"] = _t(_lookup(params, alphas.get(
                module, "prelu_alpha")))
    return sd


def resnet_generator_state_dict_from_jax(params: Mapping[str, Any],
                                         n_blocks: int, use_dropout: bool,
                                         up_mode: str = "convtranspose",
                                         ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``ResnetGenerator`` params (numpy leaves; instance norm) → the
    port's state dict (reference key names)."""
    return _state_dict_from_jax(
        ResnetGenerator(ngf=1, n_blocks=n_blocks, use_dropout=use_dropout,
                        up_mode=up_mode),
        params)


def unet_generator_state_dict_from_jax(variables: Mapping[str, Any],
                                       num_downs: int, norm: str = "batch",
                                       use_dropout: bool = False,
                                       ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``UnetGenerator`` variables (``params`` and, with BatchNorm,
    ``batch_stats``; numpy leaves) → the port's state dict."""
    return _state_dict_from_jax(
        UnetGenerator(ngf=1, num_downs=num_downs, norm=norm,
                      use_dropout=use_dropout),
        variables["params"], variables.get("batch_stats"))


def nlayer_discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                             n_layers: int = 3,
                                             norm: str = "instance",
                                             batch_stats: Mapping[str, Any] = None,
                                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``NLayerDiscriminator`` params (and ``batch_stats`` with
    BatchNorm) → the port's state dict."""
    return _state_dict_from_jax(
        NLayerDiscriminator(ndf=1, n_layers=n_layers, norm=norm), params,
        batch_stats)


def pixel_discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                            norm: str = "instance",
                                            batch_stats: Mapping[str, Any] = None,
                                            ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``PixelDiscriminator`` params → the port's state dict."""
    return _state_dict_from_jax(PixelDiscriminator(ndf=1, norm=norm), params,
                                batch_stats)


def _discriminator_state_dict_from_jax(params, batch_stats, cfg):
    if cfg.net_d == "pixel":
        return pixel_discriminator_state_dict_from_jax(params, cfg.norm,
                                                       batch_stats)
    n_layers = 3 if cfg.net_d == "basic" else cfg.n_layers_d
    return nlayer_discriminator_state_dict_from_jax(params, n_layers, cfg.norm,
                                                    batch_stats)


def cycle_gan_state_dicts_from_jax(params: Mapping[str, Any], cfg
                                   ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """A JAX CycleGAN ``ModelState.params`` (``G_A``, ``G_B``, ``D_A``,
    ``D_B``; numpy leaves) → the four port state dicts, for ``cfg``'s
    ``net_g``, ``no_dropout``, ``net_d`` and ``n_layers_d``."""
    out = {}
    for name in ("G_A", "G_B"):
        out[name] = resnet_generator_state_dict_from_jax(
            params[name], _RESNET_BLOCKS[cfg.net_g], not cfg.no_dropout)
    for name in ("D_A", "D_B"):
        out[name] = _discriminator_state_dict_from_jax(params[name], None, cfg)
    return out


def pix2pix_state_dicts_from_jax(params: Mapping[str, Any],
                                 batch_stats: Mapping[str, Any], cfg
                                 ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """A JAX pix2pix ``ModelState`` (``params`` and ``batch_stats`` of ``G``
    and ``D``; numpy leaves) → the port's two state dicts, for ``cfg``'s
    ``net_g``, ``norm``, ``no_dropout``, ``net_d`` and ``n_layers_d``."""
    if cfg.net_g in _UNET_DOWNS:
        g = unet_generator_state_dict_from_jax(
            {"params": params["G"], "batch_stats": batch_stats.get("G")},
            _UNET_DOWNS[cfg.net_g], cfg.norm, not cfg.no_dropout)
    else:
        g = resnet_generator_state_dict_from_jax(
            params["G"], _RESNET_BLOCKS[cfg.net_g], not cfg.no_dropout)
    return {"G": g, "D": _discriminator_state_dict_from_jax(
        params["D"], batch_stats.get("D"), cfg)}


def jax_variables_from_net(net: nn.Module) -> Tuple[dict, dict]:
    """The other way: a port net's parameters and BatchNorm statistics as
    the JAX module's ``params`` and ``batch_stats`` trees (numpy leaves,
    HWIO kernels), by ``site_convs``/``site_norms`` (and ``site_denses``:
    (in, out) kernels); the PReLU αs by ``site_prelus``, else the shared
    one as ``prelu_alpha``."""
    params: dict = {}
    stats: dict = {}

    def put(tree, site, value):
        *path, last = site.split(".")
        for part in path:
            tree = tree.setdefault(part, {})
        tree[last] = value

    def arr(t):  # a copy: the net's later in-place updates stay its own
        return t.detach().float().cpu().numpy().copy()

    for site, m in net.site_convs().items():
        kernel = (hwio_from_conv_transpose_weight(m.weight)
                  if isinstance(m, nn.ConvTranspose2d)
                  else hwio_from_conv_weight(m.weight))
        put(params, site, {"kernel": kernel} if m.bias is None else
            {"kernel": kernel, "bias": arr(m.bias)})
    for site, m in getattr(net, "site_norms", dict)().items():
        if isinstance(m, nn.BatchNorm2d):
            put(params, site, {"norm": {"scale": arr(m.weight),
                                        "bias": arr(m.bias)}})
            put(stats, site, {"norm": {"mean": arr(m.running_mean),
                                       "var": arr(m.running_var)}})
    for site, m in getattr(net, "site_denses", dict)().items():
        put(params, site, {"kernel": arr(m.weight).T.copy(),
                           "bias": arr(m.bias)})
    prelus = getattr(net, "site_prelus", dict)()
    for site, m in prelus.items():
        put(params, site, arr(m.weight))
    if prelus:
        return params, stats
    for m in net.modules():
        if isinstance(m, PReLU):
            params["prelu_alpha"] = arr(m.weight)
    return params, stats


def _variables(v: Mapping[str, Any]):
    return v["params"], v.get("batch_stats") or {}


def unet_task_state_dict_from_jax(variables: Mapping[str, Any],
                                  layers: int = 4, norm: str = "batch",
                                  activation: str = "PReLU",
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """JAX T2Net ``UNetGenerator`` variables (``params``, and
    ``batch_stats`` with BatchNorm; numpy leaves) → the port's state
    dict."""
    return _state_dict_from_jax(
        UNetGenerator(ngf=2, layers=layers, norm=norm, activation=activation),
        *_variables(variables))


def unet_encoder_state_dict_from_jax(variables: Mapping[str, Any]
                                     ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``UNetEncoder`` variables (BatchNorm, PReLU) → the port's."""
    return _state_dict_from_jax(UNetEncoder(ngf=2), *_variables(variables))


def unet_decoder_state_dict_from_jax(variables: Mapping[str, Any],
                                     output_nc: int
                                     ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``UNetDecoder`` variables (BatchNorm, PReLU) → the port's."""
    return _state_dict_from_jax(UNetDecoder(output_nc, ngf=2),
                                *_variables(variables))


def seg_cycle_state_dicts_from_jax(params: Mapping[str, Any],
                                   batch_stats: Mapping[str, Any], cfg,
                                   nc_a: int = 22, nc_b: int = 28
                                   ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """A JAX SegCycle ``ModelState`` (``params`` and ``batch_stats`` of the
    eight nets; numpy leaves) → the port's eight state dicts, for ``cfg``'s
    ``net_g``, ``no_dropout``, ``norm``, ``net_d`` and ``n_layers_d``."""
    out = {}
    for name in ("G_A", "G_B"):
        out[name] = resnet_generator_state_dict_from_jax(
            params[name], _RESNET_BLOCKS[cfg.net_g], not cfg.no_dropout)
    for name in ("D_A", "D_B"):
        out[name] = _discriminator_state_dict_from_jax(
            params[name], batch_stats.get(name), cfg)
    for name in ("encoderA", "encoderB"):
        out[name] = unet_encoder_state_dict_from_jax(
            {"params": params[name], "batch_stats": batch_stats[name]})
    for name, nc in (("decoderA", nc_a), ("decoderB", nc_b)):
        out[name] = unet_decoder_state_dict_from_jax(
            {"params": params[name], "batch_stats": batch_stats[name]}, nc)
    return out


def seg_state_dicts_from_jax(params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any], cfg
                             ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """A JAX T2Net ``ModelState`` (``s2t`` and ``img2task``; numpy leaves)
    → the port's two state dicts, for ``cfg``'s ``net_g``, ``no_dropout``
    and ``norm``."""
    return {
        "s2t": resnet_generator_state_dict_from_jax(
            params["s2t"], _RESNET_BLOCKS[cfg.net_g], not cfg.no_dropout),
        "img2task": unet_task_state_dict_from_jax(
            {"params": params["img2task"],
             "batch_stats": batch_stats.get("img2task")}, norm=cfg.norm)}


def _nets_state_dicts_from_jax(build, variables, cfg):
    with torch.device("meta"):
        shells = build(cfg)
    return {k: _state_dict_from_jax(shells[k], *_variables(v))
            for k, v in variables.items()}


def s2d_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                             ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX S2D nets' variables, ``{net: {"params", "batch_stats"}}`` for
    any of ``G_1``, ``G_2``, ``R_D`` and ``FD1``–``FD3`` (numpy leaves) →
    the port's state dicts of those nets (reference names), at ``cfg``'s
    widths."""
    return _nets_state_dicts_from_jax(s2d_nets, variables, cfg)


def s2d_base_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                                  ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX S2D_base nets' variables (any of ``G_1``, ``G_2``,
    ``Dis_en``, ``Seg_de``, ``Dep_de``; numpy leaves) → the port's state
    dicts, at ``cfg``'s ``g1_blocks``, ``dense_block_config`` and
    ``d_repeat_num``."""
    return _nets_state_dicts_from_jax(s2d_base_nets, variables, cfg)


def s2d_alt_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                                 ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX S2D_alt nets' variables (any of ``G_1``, ``G_2``, ``Dis_en``,
    ``Feature``, ``Seg_de``, ``Dep_de``; numpy leaves) → the port's state
    dicts, at ``cfg``'s ``net_g``."""
    return _nets_state_dicts_from_jax(s2d_alt_nets, variables, cfg)


def s2d_df_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                                ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX S2D_df nets' variables (any of ``G_1``, ``G_2``,
    ``Dis0_en``, ``Seg_de``, ``Dep_de``; numpy leaves) → the port's state
    dicts, at ``cfg``'s ``dense_block_config``."""
    return _nets_state_dicts_from_jax(s2d_df_nets, variables, cfg)


def s2d_nd_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                                ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX S2D_nd nets' variables (any of ``cfg``'s ``model_names``:
    ``G_1``, ``G_2``, ``Seg_de``, ``Dep_de`` and ``Dis_en``, or with
    ``nd_4dis`` ``Dis0_en`` and ``Dis1_en``; numpy leaves) → the port's
    state dicts, at ``cfg``'s ``dense_block_config``."""
    return _nets_state_dicts_from_jax(s2d_nd_nets, variables, cfg)


def semantic_trans_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                                        ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX semantic_trans nets' variables (any of the S2D nets and
    ``DIS``, ``Dis_80``, ``Dis_160``, ``Dis_320``; numpy leaves) → the
    port's state dicts, at ``cfg``'s S2D widths."""
    return _nets_state_dicts_from_jax(semantic_trans_nets, variables, cfg)


def semantic_trans_full_state_dicts_from_jax(variables: Mapping[str, Any],
                                             cfg
                                             ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX semantic_trans_full nets' variables (any of ``G_1``,
    ``G_2``, ``Seg_de``, ``Dep_de``, ``R_D``, ``Dis0_en`` and the four
    critics; numpy leaves) → the port's state dicts, at ``cfg``'s
    ``g1_blocks`` and ``dense_block_config``."""
    return _nets_state_dicts_from_jax(semantic_trans_full_nets, variables,
                                      cfg)


def rf_lw_state_dicts_from_jax(variables: Mapping[str, Any], cfg
                               ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """The JAX RefineNet-LW nets' variables, ``{net: {"params",
    "batch_stats"}}`` for any of ``cfg.model``'s ``model_names`` (rf_lw: G,
    seg8, seg4, seg2, seg2_0; rf_lw7: G, seg2_0, depth; numpy leaves) → the
    port's state dicts of those nets, at ``cfg.resnet_layers``. Both adapter
    sets of G must be in its params (the JAX ``init`` makes both)."""
    return _nets_state_dicts_from_jax(rf_lw_nets, variables, cfg)


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
