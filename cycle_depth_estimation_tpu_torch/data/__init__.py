"""Data layer: dataset registry and loader factory (the JAX package's
``data/__init__.py``). Batches hold NCHW float32 tensors (uint8 at
``load_size`` with ``device_aug``, finished by ``device_transforms``), NHW
int64 label maps (``synthia``, ``try``) and lists of paths. Loaders are in
``loader.py``."""

from __future__ import annotations

from typing import Callable, Dict

from .loader import DataLoader, ProcessDataLoader

_DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        _DATASET_REGISTRY[name] = cls
        return cls

    return deco


# the datasets whose samples ``device_transforms`` can finish on the device
# (uint8 at load_size); the domain loaders preprocess on the host
DEVICE_AUG_MODES = ("unaligned", "aligned", "single")


def create_dataset(cfg, phase: str = None):
    from . import datasets, domain_datasets  # noqa: F401  (register them)

    if cfg.device_aug and cfg.dataset_mode not in DEVICE_AUG_MODES:
        raise ValueError(
            f"--device_aug supports dataset_mode {DEVICE_AUG_MODES}, not "
            f"[{cfg.dataset_mode}] — that loader ships preprocessed float "
            f"batches which the device augmenter would re-normalize")
    if cfg.dataset_mode not in _DATASET_REGISTRY:
        raise KeyError(f"dataset [{cfg.dataset_mode}] not registered; "
                       f"available: {sorted(_DATASET_REGISTRY)}")
    return _DATASET_REGISTRY[cfg.dataset_mode](cfg, phase=phase or cfg.phase)


def image_height(cfg) -> int:
    """The height of the images the loader of ``cfg`` yields: its
    dataset's ``size`` where it has one (``synthia`` makes 192 of the
    default ``fine_size`` 256), else ``fine_size``."""
    from . import datasets, domain_datasets  # noqa: F401  (register them)

    cls = _DATASET_REGISTRY.get(cfg.dataset_mode)
    if not isinstance(getattr(cls, "size", None), property):
        return cfg.fine_size
    shell = cls.__new__(cls)  # no files read: size reads cfg alone
    shell.cfg = cfg
    return shell.size[1]


def create_dataloader(cfg, phase: str = None, shuffle: bool = None):
    """The reference ``CreateDataLoader(opt)``: shuffled unless
    ``serial_batches`` (or ``shuffle`` says otherwise); with batch_size > 1
    the final partial batch is dropped, as in the JAX package. Samples are
    read by ``worker_procs`` processes if that is > 0, else by
    ``num_threads`` threads."""
    if shuffle is None:
        shuffle = not cfg.serial_batches
    procs = cfg.worker_procs > 0
    return (ProcessDataLoader if procs else DataLoader)(
        create_dataset(cfg, phase), batch_size=cfg.batch_size,
        shuffle=shuffle,
        num_workers=cfg.worker_procs if procs else cfg.num_threads,
        max_dataset_size=cfg.max_dataset_size, seed=cfg.seed,
        drop_last=cfg.batch_size > 1)
