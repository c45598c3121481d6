"""Datasets: unaligned, aligned and single (the JAX package's
``data/datasets.py``, reference data/unaligned_dataset.py:8-61,
data/aligned_dataset.py:10-69 and data/single_dataset.py:7-42).

Samples are dicts of CHW float32 tensors in [-1, 1] and their paths; with
``device_aug``, CHW uint8 tensors at ``load_size`` that
``device_transforms`` finishes on the device. Randomness (the B-side
pairing, crops, flips) is drawn from a numpy ``Generator`` seeded per
(seed, epoch, index), as in the JAX package, so a sample is the same
whatever order the loader asks for it in, and the same as the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from . import register_dataset
from .image_folder import make_dataset
from .transforms import (apply_resize_only, apply_transform, load_rgb,
                         normalize, resize, rgb_to_gray, to_array)


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
        img = load_rgb(path)
        if self.cfg.device_aug:
            return _chw(apply_resize_only(img, self.cfg))
        return _chw(apply_transform(img, self.cfg, rng, grayscale=grayscale))

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
        if cfg.device_aug:  # the aliases come back after the device step
            return {"A": a, "B": b, "A_paths": a_path, "B_paths": b_path}
        return {"A": a, "B": b, "img_source": a, "img_target": b,
                "A_paths": a_path, "B_paths": b_path}


@register_dataset("aligned")
class AlignedDataset(_Base):
    """``<dataroot>/<phase>/`` holds A and B side by side in one image:
    split in half, both halves resized to ``load_size``, one crop offset for
    both, drawn from [0, load_size − fine_size − 1] (the reference's
    inclusive ``randint`` high; at eval too), one flip for both (train,
    unless ``no_flip``). ``direction`` BtoA makes A the grayscale side
    where ``output_nc`` is 1."""

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        if cfg.resize_or_crop != "resize_and_crop":
            raise ValueError("the aligned dataset takes resize_or_crop="
                             f"resize_and_crop only (got {cfg.resize_or_crop})")
        self.ab_paths = sorted(make_dataset(os.path.join(cfg.dataroot, phase)))

    def __len__(self):
        return len(self.ab_paths)

    def __getitem__(self, index: int) -> Dict[str, object]:
        cfg = self.cfg
        rng = self._rng(index)
        ab_path = self.ab_paths[index]
        ab = load_rgb(ab_path)
        w, h = ab.size
        halves = [resize(ab.crop(box), (cfg.load_size, cfg.load_size))
                  for box in ((0, 0, w // 2, h), (w // 2, 0, w, h))]
        if cfg.device_aug:  # joint crop and flip on the device
            a, b = (_chw(np.asarray(x, np.uint8)) for x in halves)
            return {"A": a, "B": b, "A_paths": ab_path, "B_paths": ab_path}
        a, b = (to_array(x) for x in halves)
        span = max(0, cfg.load_size - cfg.fine_size - 1)
        top = int(rng.integers(0, span + 1)) if span > 0 else 0
        left = int(rng.integers(0, span + 1)) if span > 0 else 0
        a = normalize(a[top:top + cfg.fine_size, left:left + cfg.fine_size])
        b = normalize(b[top:top + cfg.fine_size, left:left + cfg.fine_size])
        if cfg.is_train and not cfg.no_flip and rng.random() < 0.5:
            a, b = a[:, ::-1], b[:, ::-1]
        gray_a, gray_b = self._gray()
        a = _chw(np.ascontiguousarray(rgb_to_gray(a) if gray_a else a,
                                      np.float32))
        b = _chw(np.ascontiguousarray(rgb_to_gray(b) if gray_b else b,
                                      np.float32))
        return {"A": a, "B": b, "img_source": a, "img_target": b,
                "A_paths": ab_path, "B_paths": ab_path}


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
