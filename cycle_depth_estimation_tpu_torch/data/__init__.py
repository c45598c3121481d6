"""Data layer: dataset registry and a serial loader (the JAX package's
``data/__init__.py`` and ``data/loader.py``). Batches hold NCHW float32
tensors and lists of paths. The JAX package's thread and process pools are
not ported yet."""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import numpy as np
import torch

_DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        _DATASET_REGISTRY[name] = cls
        return cls

    return deco


def create_dataset(cfg, phase: str = None):
    from . import datasets  # noqa: F401  (registers the datasets)

    if cfg.dataset_mode not in _DATASET_REGISTRY:
        raise KeyError(f"dataset [{cfg.dataset_mode}] not registered; "
                       f"available: {sorted(_DATASET_REGISTRY)}")
    return _DATASET_REGISTRY[cfg.dataset_mode](cfg, phase=phase or cfg.phase)


class DataLoader:
    """Batches of a dataset, read serially in the calling thread. With
    ``shuffle`` the order is a permutation seeded by (seed, epoch), the JAX
    package's; ``drop_last`` drops a final partial batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 max_dataset_size: int = 2 ** 31, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_dataset_size = max_dataset_size
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = min(len(self.dataset), self.max_dataset_size)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def indices(self) -> np.ndarray:
        idx = np.arange(min(len(self.dataset), self.max_dataset_size))
        if self.shuffle:
            np.random.default_rng(self.seed * 7919 + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, object]]:
        idx = self.indices()
        for i in range(len(self)):
            b = idx[i * self.batch_size:(i + 1) * self.batch_size]
            samples = [self.dataset[int(j)] for j in b]
            yield {k: (torch.stack([s[k] for s in samples])
                       if isinstance(samples[0][k], torch.Tensor)
                       else [s[k] for s in samples])
                   for k in samples[0]}


def create_dataloader(cfg, phase: str = None, shuffle: bool = None):
    """The reference ``CreateDataLoader(opt)``: shuffled unless
    ``serial_batches`` (or ``shuffle`` says otherwise); with batch_size > 1
    the final partial batch is dropped, as in the JAX package."""
    if shuffle is None:
        shuffle = not cfg.serial_batches
    return DataLoader(create_dataset(cfg, phase), batch_size=cfg.batch_size,
                      shuffle=shuffle, max_dataset_size=cfg.max_dataset_size,
                      seed=cfg.seed, drop_last=cfg.batch_size > 1)
