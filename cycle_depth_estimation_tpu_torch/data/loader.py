"""Batch loaders and the copy to the device (the JAX package's
``data/loader.py``).

- ``DataLoader``: batches of a dataset in a seeded order; samples are read
  serially in the calling thread (``num_workers`` 0) or by a pool of
  ``num_workers`` threads (PIL and numpy release the interpreter lock for
  decoding and resizing), two batches in flight.
- ``ProcessDataLoader``: the same with ``num_workers`` processes, for
  transforms whose Python glue would serialize threads. Workers fork from a
  ``forkserver`` process (started fresh, so it holds none of the parent's
  CUDA state or threads), which imports the data modules once for every
  pool of the program; each worker gets the dataset once and returns
  samples as numpy arrays. The workers end with ``close``; the forkserver
  and Python's resource tracker end only when the program exits.
- ``prefetch_to_device``: keeps ``depth`` batches ahead in flight to the
  device: each tensor is copied into pinned host memory and then to the
  card without blocking the host.

All three give the serial loader's batches in its order: a batch's samples
are the same indices, and every sample's randomness is seeded by (seed,
epoch, index), not by which worker reads it.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import multiprocessing as mp
from typing import Any, Dict, Iterator, List

import numpy as np
import torch


def _stack_batch(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: (torch.stack([s[k] for s in samples])
                if isinstance(samples[0][k], torch.Tensor)
                else [s[k] for s in samples])
            for k in samples[0]}


class DataLoader:
    """Iterable over batches; with ``shuffle`` the order is a permutation
    seeded by (seed, epoch), the JAX package's; ``drop_last`` drops a final
    partial batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 0, max_dataset_size: int = 2 ** 31,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
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

    def _batches(self) -> List[np.ndarray]:
        idx = self.indices()
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _pipelined(self, submit, result=cf.Future.result
                   ) -> Iterator[Dict[str, Any]]:
        """Batches from ``submit(index) -> Future``, two batches in flight;
        ``result(future)`` is the sample."""
        pending = collections.deque()
        batches = iter(self._batches())
        for b in batches:
            pending.append([submit(int(i)) for i in b])
            if len(pending) == 2:
                break
        while pending:
            futs = pending.popleft()
            b = next(batches, None)
            if b is not None:
                pending.append([submit(int(i)) for i in b])
            yield _stack_batch([result(f) for f in futs])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers <= 0:
            for b in self._batches():
                yield _stack_batch([self.dataset[int(i)] for i in b])
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            yield from self._pipelined(
                lambda i: pool.submit(self.dataset.__getitem__, i))

    def close(self):
        pass


_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(index: int, epoch: int) -> Dict[str, Any]:
    if hasattr(_WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(epoch)
    sample = _WORKER_DATASET[index]
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in sample.items()}


def _from_worker(fut: cf.Future) -> Dict[str, Any]:
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in fut.result().items()}


class ProcessDataLoader(DataLoader):
    """``DataLoader`` over ``num_workers`` (≥ 1) processes. The pool starts
    at the first batch and lives until ``close``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.num_workers = max(1, self.num_workers)
        self._pool = None

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._pool is None:
            ctx = mp.get_context("forkserver")
            # read when the server starts, with the program's first pool
            ctx.set_forkserver_preload(
                ["__main__", __name__, type(self.dataset).__module__])
            self._pool = cf.ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_worker_init, initargs=(self.dataset,))
        epoch = self.epoch
        yield from self._pipelined(
            lambda i: self._pool.submit(_worker_get, i, epoch), _from_worker)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def prefetch_to_device(iterator, device, depth: int = 2,
                       spatial: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield ``iterator``'s batches with every tensor on ``device``, the
    copies of the next ``depth`` batches already issued. To a CUDA device a
    tensor goes through pinned host memory and a non-blocking copy; other
    leaves (paths) pass through. Under data parallelism only this rank's
    rows are moved (``parallel.mesh.host_shard_batch``), and under
    ``--parallel sp`` only its rows of their height unless ``spatial`` is
    False (``--device_aug`` crops the whole height first)."""
    from ..parallel.mesh import host_shard_batch

    def put(batch):
        return host_shard_batch(batch, device, spatial=spatial)

    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == depth:
            break
    while queue:
        batch = next(it, None)
        if batch is not None:
            queue.append(put(batch))
        yield queue.popleft()
