"""Weights across the boundary: JAX param trees → port state dicts, and
reference ``.pth`` files.

``resnet_generator_state_dict_from_jax`` and
``nlayer_discriminator_state_dict_from_jax`` are the inverses of the JAX
package's ``utils/torch_import.import_resnet_generator`` and
``import_nlayer_discriminator``:

- Conv: HWIO → OIHW, ``transpose(3, 2, 0, 1)``;
- ConvTranspose: the JAX kernel is the equivalent regular conv in HWIO,
  ``k = transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))`` of the torch
  ``(in, out, kH, kW)`` weight; undone by flipping ``k`` spatially and
  transposing back.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from torch import nn

from ..models.networks import (_RESNET_BLOCKS, NLayerDiscriminator,
                               PixelDiscriminator, ResnetGenerator)


def conv_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def hwio_from_conv_weight(w: torch.Tensor) -> np.ndarray:
    """OIHW torch conv weight → HWIO numpy (the JAX/int8 layout)."""
    return np.ascontiguousarray(
        w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))


def _state_dict_from_jax(shell: nn.Module, params: Mapping[str, Any]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Fill the state-dict keys of ``shell`` (any width: only its module
    names are read) from JAX params, by ``shell.site_convs()``."""
    names = {module: name for name, module in shell.named_modules()}
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for site, module in shell.site_convs().items():
        entry = params
        for part in site.split("."):
            entry = entry[part]
        convert = (conv_transpose_weight_from_hwio
                   if isinstance(module, nn.ConvTranspose2d)
                   else conv_weight_from_hwio)
        prefix = names[module]
        sd[f"{prefix}.weight"] = torch.tensor(
            convert(np.asarray(entry["kernel"], np.float32)))
        if "bias" in entry:
            sd[f"{prefix}.bias"] = torch.tensor(
                np.asarray(entry["bias"], np.float32))
    return sd


def resnet_generator_state_dict_from_jax(params: Mapping[str, Any],
                                         n_blocks: int, use_dropout: bool,
                                         ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``ResnetGenerator`` params (numpy leaves) → the port's state dict
    (reference key names)."""
    return _state_dict_from_jax(
        ResnetGenerator(ngf=1, n_blocks=n_blocks, use_dropout=use_dropout),
        params)


def nlayer_discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                             n_layers: int = 3,
                                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``NLayerDiscriminator`` params → the port's state dict."""
    return _state_dict_from_jax(NLayerDiscriminator(ndf=1, n_layers=n_layers),
                                params)


def pixel_discriminator_state_dict_from_jax(params: Mapping[str, Any]
                                            ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``PixelDiscriminator`` params → the port's state dict."""
    return _state_dict_from_jax(PixelDiscriminator(ndf=1), params)


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
        if cfg.net_d == "pixel":
            out[name] = pixel_discriminator_state_dict_from_jax(params[name])
        else:
            n_layers = 3 if cfg.net_d == "basic" else cfg.n_layers_d
            out[name] = nlayer_discriminator_state_dict_from_jax(
                params[name], n_layers)
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
