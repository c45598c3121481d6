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
  ``num_batches_tracked`` is left out, as in a pre-0.4.1 reference ``.pth``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from torch import nn

from ..models.networks import (_RESNET_BLOCKS, _UNET_DOWNS,
                               NLayerDiscriminator, PixelDiscriminator,
                               ResnetGenerator, UnetGenerator)


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
        prefix = names[module]
        p, s = _lookup(params, site)["norm"], _lookup(batch_stats, site)["norm"]
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _t(p["scale"]), _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
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


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
