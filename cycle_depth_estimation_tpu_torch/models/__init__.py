"""Model registry: ``--model <name>`` → model class (the JAX package's
``models/__init__.py``). The port registers ``test`` (serving),
``cycle_gan``, ``pix2pix``, ``seg_cycle`` (SegCycle), ``seg`` (T2Net),
``S2D``, ``S2D_base``, ``S2D_alt``, ``S2D_df``, ``S2D_nd``,
``semantic_trans``, ``semantic_trans_full``, ``rf_lw`` and ``rf_lw7``
(training)."""

from __future__ import annotations

from typing import Callable, Dict

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        _MODEL_REGISTRY[name] = cls
        return cls

    return deco


def create_model(cfg, device=None):
    """Build the model ``cfg.model`` on ``device`` (default ``cfg.device``)."""
    from . import (cycle_gan, pix2pix, rf_lw, s2d,  # noqa: F401
                   s2d_alt, s2d_base, s2d_df, s2d_nd,  # (register)
                   semantic_trans, semantic_trans_full, seg_cycle,
                   seg_model, test_model)

    if cfg.model not in _MODEL_REGISTRY:
        raise KeyError(f"model [{cfg.model}] not registered; available: "
                       f"{sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[cfg.model](
        cfg, device=cfg.device if device is None else device)
