"""Weights across the boundary: JAX param trees → port state dicts, and
reference ``.pth`` files.

``resnet_generator_state_dict_from_jax`` is the inverse of the JAX package's
``utils/torch_import.import_resnet_generator``:

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

from ..models.networks import ResnetGenerator


def conv_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_weight_from_hwio(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def hwio_from_conv_weight(w: torch.Tensor) -> np.ndarray:
    """OIHW torch conv weight → HWIO numpy (the JAX/int8 layout)."""
    return np.ascontiguousarray(
        w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))


def resnet_generator_state_dict_from_jax(params: Mapping[str, Any],
                                         n_blocks: int, use_dropout: bool,
                                         ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``ResnetGenerator`` params (numpy leaves) → the port's state dict
    (reference key names)."""
    shell = ResnetGenerator(ngf=1, n_blocks=n_blocks, use_dropout=use_dropout)
    names = {module: name for name, module in shell.named_modules()}
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for site, module in shell.site_convs().items():
        entry = params
        for part in site.split("."):
            entry = entry[part]
        convert = (conv_transpose_weight_from_hwio
                   if isinstance(module, torch.nn.ConvTranspose2d)
                   else conv_weight_from_hwio)
        prefix = names[module]
        sd[f"{prefix}.weight"] = torch.from_numpy(
            convert(np.asarray(entry["kernel"], np.float32)))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.array(entry["bias"], np.float32))
    return sd


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
