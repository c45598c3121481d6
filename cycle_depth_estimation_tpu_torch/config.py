"""Config for the port's serving path: the subset of the JAX package's
``Config`` that the test CLI reads, with the same field names, defaults and
two-phase parse (base flags, then per-model defaults for flags the user did
not set). ``device`` is new: the port runs on ``cuda`` unless told ``cpu``;
``pth_path`` is the flag the JAX CLI parses by hand.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

# reference flag name → dataclass field
_FLAG_ALIASES = {
    "loadSize": "load_size",
    "fineSize": "fine_size",
    "batchSize": "batch_size",
    "netG": "net_g",
}


@dataclass
class Config:
    dataroot: str = "./datasets"
    batch_size: int = 8
    load_size: int = 286
    fine_size: int = 256
    display_winsize: int = 256
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    net_g: str = "resnet_9blocks"
    name: str = "experiment_name"
    dataset_mode: str = "unaligned"
    model: str = "cycle_gan"
    direction: str = "AtoB"
    epoch: str = "latest"
    norm: str = "instance"
    no_dropout: bool = False
    max_dataset_size: int = 2 ** 31
    resize_or_crop: str = "resize_and_crop"
    init_type: str = "normal"
    init_gain: float = 0.02
    is_train: bool = True
    phase: str = "train"
    results_dir: str = "./results/"
    aspect_ratio: float = 1.0
    num_test: int = 50
    dtype: str = "float32"          # compute dtype: float32 | bfloat16
    seed: int = 0
    device: str = "cuda"            # 'cuda' | 'cpu'
    pth_path: str = ""              # reference generator .pth; "" = random init

    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# per-model default overrides (the JAX package's MODEL_DEFAULTS, serving part)
MODEL_DEFAULTS = {
    "test": dict(no_dropout=True, dataset_mode="single", is_train=False),
}


def apply_model_defaults(cfg: Config, explicit: Optional[set] = None) -> Config:
    """Apply per-model default overrides to fields the user didn't set."""
    overrides = MODEL_DEFAULTS.get(cfg.model, {})
    explicit = explicit or set()
    kw = {k: v for k, v in overrides.items() if k not in explicit}
    return cfg.replace(**kw) if kw else cfg


def parse_args(argv: Optional[List[str]] = None, is_train: bool = True) -> Config:
    """CLI → Config, with the reference's two-phase model-defaults pass."""
    import argparse

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    base = Config(is_train=is_train)
    for f in dataclasses.fields(Config):
        aliases = ["--" + ref for ref, fld in _FLAG_ALIASES.items()
                   if fld == f.name]
        default = getattr(base, f.name)
        if isinstance(default, bool):
            parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                action="store_true", default=None)
        else:
            parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                type=type(default), default=None)
    ns = parser.parse_args(argv)
    explicit = {k for k, v in vars(ns).items() if v is not None}
    cfg = base.replace(**{k: v for k, v in vars(ns).items() if v is not None})
    if not is_train and "phase" not in explicit:
        cfg = cfg.replace(phase="test")
    if not is_train and "model" not in explicit:
        cfg = cfg.replace(model="test")
    return apply_model_defaults(cfg, explicit)


def print_options(cfg: Config) -> str:
    """Format the option table, marking values that differ from the default."""
    default = Config()
    lines = ["----------------- Options ---------------"]
    for f in sorted(dataclasses.fields(Config), key=lambda f: f.name):
        v = getattr(cfg, f.name)
        comment = ""
        if v != getattr(default, f.name):
            comment = f"\t[default: {getattr(default, f.name)}]"
        lines.append(f"{f.name:>25}: {str(v):<30}{comment}")
    lines.append("----------------- End -------------------")
    return "\n".join(lines)
