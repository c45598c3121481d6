"""CycleGAN datasets (the JAX package's ``data/datasets.py``, reference
data/unaligned_dataset.py:8-61 and data/single_dataset.py:7-42).

Samples are dicts of CHW float32 tensors in [-1, 1] and their paths.
Randomness (the B-side pairing, crops, flips) is drawn from a numpy
``Generator`` seeded per (seed, epoch, index), as in the JAX package, so a
sample is the same whatever order the loader asks for it in, and the same
as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from . import register_dataset
from .image_folder import make_dataset
from .transforms import apply_transform, load_rgb


def _chw(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))


class _Base:
    def __init__(self, cfg):
        self.cfg = cfg
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + self.epoch) * 1_000_003 + index)

    def _load(self, path: str, rng, grayscale: bool) -> torch.Tensor:
        return _chw(apply_transform(load_rgb(path), self.cfg, rng,
                                    grayscale=grayscale))

    def _gray(self):
        cfg = self.cfg
        if cfg.direction == "BtoA":
            return cfg.output_nc == 1, cfg.input_nc == 1
        return cfg.input_nc == 1, cfg.output_nc == 1


@register_dataset("unaligned")
class UnalignedDataset(_Base):
    """``<phase>A`` / ``<phase>B`` folders; the B image is drawn at random
    per index unless ``serial_batches``."""

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        self.a_paths = sorted(make_dataset(os.path.join(cfg.dataroot, phase + "A")))
        self.b_paths = sorted(make_dataset(os.path.join(cfg.dataroot, phase + "B")))
        self.a_size = len(self.a_paths)
        self.b_size = len(self.b_paths)

    def __len__(self):
        return max(self.a_size, self.b_size)

    def __getitem__(self, index: int) -> Dict[str, object]:
        cfg = self.cfg
        rng = self._rng(index) if cfg.is_train else None
        a_path = self.a_paths[index % self.a_size]
        if cfg.serial_batches:
            b_index = index % self.b_size
        else:
            b_index = int(self._rng(index ^ 0x5EED).integers(0, self.b_size))
        b_path = self.b_paths[b_index]
        gray_a, gray_b = self._gray()
        a = self._load(a_path, rng, gray_a)
        b = self._load(b_path, rng, gray_b)
        return {"A": a, "B": b, "img_source": a, "img_target": b,
                "A_paths": a_path, "B_paths": b_path}


@register_dataset("single")
class SingleDataset(_Base):
    """The inference-only A-side folder."""

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        self.a_paths = sorted(make_dataset(cfg.dataroot))

    def __len__(self):
        return len(self.a_paths)

    def __getitem__(self, index: int) -> Dict[str, object]:
        a_path = self.a_paths[index]
        gray_a, _ = self._gray()
        rng = self._rng(index) if self.cfg.is_train else None
        return {"A": self._load(a_path, rng, gray_a), "A_paths": a_path}
