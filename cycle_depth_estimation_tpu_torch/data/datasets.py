"""SingleDataset: the inference-only A-side folder (the JAX package's
``data/datasets.py``, reference data/single_dataset.py:7-42). Samples are
dicts with a CHW float32 tensor ``A`` in [-1, 1] and its path ``A_paths``."""

from __future__ import annotations

from typing import Dict

import torch

from . import register_dataset
from .image_folder import make_dataset
from .transforms import apply_transform, load_rgb


@register_dataset("single")
class SingleDataset:
    def __init__(self, cfg, phase: str):
        self.cfg = cfg
        self.a_paths = sorted(make_dataset(cfg.dataroot))

    def __len__(self):
        return len(self.a_paths)

    def __getitem__(self, index: int) -> Dict[str, object]:
        cfg = self.cfg
        a_path = self.a_paths[index]
        gray = (cfg.output_nc if cfg.direction == "BtoA" else cfg.input_nc) == 1
        a = apply_transform(load_rgb(a_path), cfg, grayscale=gray)
        return {"A": torch.from_numpy(a.transpose(2, 0, 1).copy()),
                "A_paths": a_path}
