"""Config of the port: the subset of the JAX package's ``Config`` that the
test CLI, the CycleGAN, pix2pix, SegCycle, T2Net (``seg``), S2D,
``S2D_base``, ``S2D_alt``, ``S2D_df``, ``S2D_nd``, ``semantic_trans``,
``semantic_trans_full`` and RefineNet-LW (``rf_lw``, ``rf_lw7``) models, the data layer and the train CLI read, with
the same field names, defaults, reference flag aliases (``--loadSize``,
``--netD``, ``--lambda_A`` …) and two-phase parse (base flags, then
per-model defaults for flags the user did not set). ``device`` is new: the
port runs on ``cuda`` unless told ``cpu``; ``pth_path`` is the flag the JAX
CLI parses by hand. ``tpu_precision`` keeps the JAX name so that a JAX
command line runs unchanged: ``highest`` turns off cuDNN's and matmul's TF32
(``device.set_precision``). The parallel flags (``mesh_shape``,
``mesh_axes``, ``parallel``, ``zero``, ``coordinator_address``,
``num_processes``, ``process_index``) and ``prefetch_depth`` are the JAX
ones. Flags of slices not ported yet are absent, so argparse rejects them.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import List, Optional, get_args, get_origin, get_type_hints

import torch

# reference flag name → dataclass field
_FLAG_ALIASES = {
    "loadSize": "load_size",
    "fineSize": "fine_size",
    "batchSize": "batch_size",
    "netG": "net_g",
    "netD": "net_d",
    "n_layers_D": "n_layers_d",
    "lambda_A": "lambda_a",
    "lambda_B": "lambda_b",
    "lambda_L1": "lambda_l1",
    "lr_D": "lr_d",
}

# fields that take one of a few values
_CHOICES = {"tpu_precision": ("default", "highest")}


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
    ndf: int = 64
    net_d: str = "basic"
    net_g: str = "resnet_9blocks"
    n_layers_d: int = 3
    name: str = "experiment_name"
    dataset_mode: str = "unaligned"
    model: str = "cycle_gan"
    direction: str = "AtoB"
    epoch: str = "latest"
    num_threads: int = 4            # loader threads
    checkpoints_dir: str = "./checkpoints"
    norm: str = "instance"
    serial_batches: bool = False
    no_dropout: bool = False
    max_dataset_size: int = 2 ** 31
    resize_or_crop: str = "resize_and_crop"
    no_flip: bool = False
    # the host decodes and resizes only (uint8); crop, flip and normalize
    # run on the device (data/device_transforms.py); resize_and_crop only
    device_aug: bool = False
    init_type: str = "normal"
    init_gain: float = 0.02
    # domain-pair dataset paths (``synthia``): a folder or a .txt list each
    img_source_file_train: str = ""
    img_target_file_train: str = ""
    lab_source_file_train: str = ""
    lab_target_file_train: str = ""
    depth_source_file_train: str = ""
    img_source_file_test: str = ""
    img_target_file_test: str = ""
    lab_source_file_test: str = ""
    lab_target_file_test: str = ""
    depth_source_file_test: str = ""
    # train options (reference options/train_options.py)
    is_train: bool = True
    display_freq: int = 400
    print_freq: int = 100
    save_latest_freq: int = 5000
    save_epoch_freq: int = 5
    continue_train: bool = False
    epoch_count: int = 1
    phase: str = "train"
    niter: int = 5
    niter_decay: int = 5
    beta1: float = 0.5
    lr: float = 2e-4
    adam_eps: float = 1e-8          # S2D's Adam eps (1e-3 damps the first
                                    # step's sign(g)·lr in parity checks)
    lr_d: float = 8e-5              # S2D_alt's Dis_en Adam (--lr_D)
    no_lsgan: bool = False
    pool_size: int = 50
    lr_policy: str = "lambda"
    lr_decay_iters: int = 15
    # CycleGAN (reference models/cycle_gan_model.py:12-22)
    lambda_a: float = 10.0          # --lambda_A
    lambda_b: float = 10.0          # --lambda_B
    lambda_identity: float = 0.5
    d_steps_per_g: int = 4          # the reference steps D 4× per G step
                                    # (cycle_gan_model.py:151-160)
    lambda_l1: float = 100.0        # pix2pix --lambda_L1
    worker_procs: int = 0           # > 0: loader processes instead of threads
    # S2D (new_multi): G_1's residual blocks and G_2's DenseNet trunk; None
    # is the reference's DenseNet-169 width
    g1_blocks: int = 3
    dense_block_config: Optional[List[int]] = None  # None: (6, 12, 32, 32)
    dense_growth_rate: Optional[int] = None         # None: 32
    s2d_mid_nc: Optional[int] = None                # None: 1024
    # S2D_base's feature discriminator: conditioned on the seg label map
    # (the dis_seg generation), and its depth (G2Blocks trains 3)
    dis_seg: bool = False
    d_repeat_num: int = 4
    # S2D_df: the Seg phase's adversarial weight, the dilated generation's
    # 5× adversarial term in G_1's phase, and the D phase's real-branch
    # weight (--df_adv_w 5 --df_g1_adv: dilated; --df_d_real_w 0.2:
    # trymulti)
    df_adv_w: float = 2.0
    df_g1_adv: bool = False
    df_d_real_w: float = 1.0
    # S2D_nd: new_depseg's model3 "4dis" variant, twin 256-channel critics
    # with Adam and no gradient penalty in place of the SGD+GP Dis_en
    nd_4dis: bool = False
    # RefineNet-LW: the ResNet trunk's blocks per layer; None is rf_lw's
    # (3, 4, 23, 3) and rf_lw7's (3, 4, 6, 3)
    resnet_layers: Optional[List[int]] = None
    # the adapter set rf_lw's synthetic branch takes: None keeps the
    # reference drivers' 'real'; 'syn' the per-domain split
    syn_domain: Optional[str] = None
    # in-loop KITTI validation (reference new_multi/train5.py:85-115): every
    # eval_freq images, with kitti_gt_dir set, the test split's refined
    # depths are written and scored and a line appended to records_file
    eval_freq: int = 1000
    kitti_gt_dir: str = ""
    records_file: str = "records.txt"
    # test options
    results_dir: str = "./results/"
    aspect_ratio: float = 1.0
    num_test: int = 50
    dtype: str = "float32"          # compute dtype: float32 | bfloat16
    remat: bool = False             # cycle_gan: recompute the generator
                                    # forwards in backward (checkpoint);
                                    # S2D: the G_2 and R_D applications
    seed: int = 0
    device: str = "cuda"            # 'cuda' | 'cpu'
    pth_path: str = ""              # reference generator .pth; "" = random init
    model_suffix: str = ""          # test model: serve <epoch>_net_G<suffix>
    int8: bool = False              # test CLI: serve the generator int8 (PTQ)
    tpu_precision: str = "default"  # 'default' | 'highest' (TF32 off)
    # parallelism (``parallel/``; the JAX flags): the mesh over the ranks
    # (default: every rank on 'data'; a two-element shape: data model)
    mesh_shape: Optional[List[int]] = None
    mesh_axes: Optional[List[str]] = None
    parallel: str = "dp"   # dp | tp (Megatron trunk, cycle_gan); sp and
                           # pp are not in the port yet (ROADMAP A1b)
    zero: str = "off"      # off | opt (Adam moments split over 'data') |
                           # fsdp (parameters too)
    prefetch_depth: int = 2         # batches in flight to the device
    # a world of processes without torchrun: every process gets the same
    # address ('host:port') and its own index
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_index: int = 0

    def expr_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# per-model default overrides (the JAX package's MODEL_DEFAULTS, ported part)
MODEL_DEFAULTS = {
    "cycle_gan": dict(no_dropout=True),
    "pix2pix": dict(pool_size=0, no_lsgan=True, norm="batch",
                    dataset_mode="aligned", net_g="unet_256"),
    "test": dict(no_dropout=True, dataset_mode="single", is_train=False),
    "seg": dict(no_dropout=True, dataset_mode="synthia"),
    "seg_cycle": dict(no_dropout=True, dataset_mode="synthia"),
    "S2D": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "semantic_trans": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "semantic_trans_full": dict(dataset_mode="try", batch_size=1,
                                fine_size=192),
    "rf_lw": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "rf_lw7": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "S2D_base": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "S2D_df": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "S2D_nd": dict(dataset_mode="try", batch_size=1, fine_size=192),
    "S2D_alt": dict(dataset_mode="try", batch_size=1, fine_size=192,
                    net_g="3blocks"),
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
    hints = get_type_hints(Config)
    for f in dataclasses.fields(Config):
        aliases = ["--" + ref for ref, fld in _FLAG_ALIASES.items()
                   if fld == f.name]
        default = getattr(base, f.name)
        if isinstance(default, bool):
            parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                action="store_true", default=None)
        elif default is None:  # Optional[int] or Optional[List[int]]
            (inner,) = (a for a in get_args(hints[f.name]) if a is not type(None))
            if get_origin(inner) is list:
                parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                    type=get_args(inner)[0], nargs="*",
                                    default=None)
            else:
                parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                    type=inner, default=None)
        else:
            parser.add_argument("--" + f.name, *aliases, dest=f.name,
                                type=type(default), default=None,
                                choices=_CHOICES.get(f.name))
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
