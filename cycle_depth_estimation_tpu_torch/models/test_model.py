"""TestModel: generator-only inference, ``real_A → fake_B`` (the JAX
package's ``models/test_model.py``, reference models/test_model.py:6-46).

The net is named ``"G" + model_suffix``: its checkpoint is
``<checkpoints_dir>/<name>/<epoch>_net_G<suffix>.pth``, so a ``cycle_gan``
run's ``latest_net_G_A.pth`` is served with ``--model_suffix _A``."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from . import register_model
from ..config import Config
from ..device import resolve_device
from .networks import define_G


@register_model("test")
class TestModel:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = cfg.compute_dtype()
        self.model_names = ("G" + cfg.model_suffix,)
        net = define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.net_g,
                       norm=cfg.norm, use_dropout=not cfg.no_dropout,
                       init_type=cfg.init_type, init_gain=cfg.init_gain,
                       generator=torch.Generator().manual_seed(cfg.seed))
        self.net_G = net.to(self.device, self.dtype).eval()

    def load_reference_generator(self, pth_path: str) -> None:
        """Load a reference ``<epoch>_net_G<suffix>.pth`` ResnetGenerator."""
        from ..utils.weights import load_pth

        sd = load_pth(pth_path)
        self.net_G.load_state_dict({k: v.to(self.dtype) for k, v in sd.items()})

    def _path(self, epoch) -> str:
        return os.path.join(self.cfg.expr_dir(),
                            f"{epoch}_net_{self.model_names[0]}.pth")

    def has_checkpoint(self, epoch) -> bool:
        return os.path.isfile(self._path(epoch))

    def load_nets(self, state, epoch):
        """Load the run's ``<epoch>_net_G<suffix>.pth`` (``state`` is
        unused: the net is the model's own)."""
        self.load_reference_generator(self._path(epoch))
        return state

    def eval_step(self, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """``batch['A']``: NCHW images in [-1, 1]. Returns (metrics, visuals)."""
        real_a = batch["A"].to(self.device)
        with torch.no_grad():
            fake_b = self.net_G(real_a.to(self.dtype))
        return {}, {"real_A": real_a, "fake_B": fake_b}
