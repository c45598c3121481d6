"""Data layer of the serving path: dataset registry and a serial loader
(the JAX package's ``data/__init__.py``). Batches hold NCHW float32 tensors
and lists of paths."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

_DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        _DATASET_REGISTRY[name] = cls
        return cls

    return deco


def create_dataset(cfg, phase: str = None):
    from . import datasets  # noqa: F401  (registers 'single')

    if cfg.dataset_mode not in _DATASET_REGISTRY:
        raise KeyError(f"dataset [{cfg.dataset_mode}] not registered; "
                       f"available: {sorted(_DATASET_REGISTRY)}")
    return _DATASET_REGISTRY[cfg.dataset_mode](cfg, phase=phase or cfg.phase)


class DataLoader:
    """Batches of a dataset in its own order. With batch_size > 1 the final
    partial batch is dropped, as in the JAX package."""

    def __init__(self, dataset, batch_size: int = 1,
                 max_dataset_size: int = 2 ** 31):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_dataset_size = max_dataset_size

    def _batches(self) -> List[np.ndarray]:
        idx = np.arange(min(len(self.dataset), self.max_dataset_size))
        out = [idx[i:i + self.batch_size]
               for i in range(0, len(idx), self.batch_size)]
        if self.batch_size > 1 and out and len(out[-1]) < self.batch_size:
            out.pop()
        return out

    def __len__(self):
        return len(self._batches())

    def __iter__(self) -> Iterator[Dict[str, object]]:
        for b in self._batches():
            samples = [self.dataset[int(i)] for i in b]
            yield {k: (torch.stack([s[k] for s in samples])
                       if isinstance(samples[0][k], torch.Tensor)
                       else [s[k] for s in samples])
                   for k in samples[0]}


def create_dataloader(cfg, phase: str = None):
    """The reference ``CreateDataLoader(opt)`` for the serving path, which
    reads in serial order."""
    return DataLoader(create_dataset(cfg, phase), batch_size=cfg.batch_size,
                      max_dataset_size=cfg.max_dataset_size)
