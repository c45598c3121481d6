"""Training CLI of the port (the root ``train.py`` of the JAX package,
reference train.py:10-81)::

    python -m cycle_depth_estimation_tpu_torch.train --model cycle_gan \\
        --dataroot <dir with trainA/ trainB/ [testA/ testB/]> \\
        [--niter N --niter_decay M --batch_size B] [--continue_train] \\
        [--device cuda|cpu]
    python -m cycle_depth_estimation_tpu_torch.train --model pix2pix \\
        --dataroot <dir with train/ [test/] of side-by-side AB images> \\
        [--direction BtoA] [--num_threads N | --worker_procs N] \\
        [--device_aug]
    python -m cycle_depth_estimation_tpu_torch.train --model seg_cycle \\
        --img_source_file_train <dir or .txt> --img_target_file_train … \\
        --lab_source_file_train … --lab_target_file_train … \\
        --depth_source_file_train … [--*_file_test …]
    python -m cycle_depth_estimation_tpu_torch.train --model seg …  (T2Net)
    python -m cycle_depth_estimation_tpu_torch.train --model S2D \
        --img_source_file_train … --img_target_file_train … \
        --lab_source_file_train … --lab_target_file_train … \
        --depth_source_file_train … [--dense_block_config 6 12 32 32 \
        --dense_growth_rate 32 --s2d_mid_nc 1024 --g1_blocks 3]
    python -m cycle_depth_estimation_tpu_torch.train --model S2D_base …
        (the same files) [--dense_block_config 6 12 32 32 --g1_blocks 3 \
        --ndf 64 --d_repeat_num 4 --dis_seg]
    python -m cycle_depth_estimation_tpu_torch.train --model S2D_alt …
        (the same files) [--netG 3blocks|6blocks --lr_D 8e-5]
    python -m cycle_depth_estimation_tpu_torch.train --model rf_lw …
        (or rf_lw7; the same files) [--resnet_layers 3 4 23 3] \
        [--syn_domain syn] [--kitti_gt_dir <dir> --eval_freq N \
        --*_file_test …]

``seg_cycle`` and ``seg`` read the ``synthia`` dataset (their default):
SYNTHIA images, labels and depth against Cityscapes images and labels,
192×640 at the default ``fine_size``. ``S2D``, ``S2D_base``, ``S2D_alt``,
``rf_lw`` and ``rf_lw7`` read
``try``: vKITTI images, labels and 16-bit depth against KITTI images and
labels, 192×576, batch 1. With ``--kitti_gt_dir``, every ``eval_freq``
images the test split's refined depths go to ``<run>/pred/`` (the
``save_kitti`` tool), are scored against that directory's ground truth and
``{"epoch", "iters", <metric>…}`` is appended to ``<run>/<records_file>``;
a failure there is printed ("[kitti eval] skipped") and training goes on.
``--dtype bfloat16`` trains every model in bf16 with fp32 parameters;
``--remat`` recomputes the generator forwards in backward (``cycle_gan``)
or the G_2 and R_D applications (``S2D``). ``--tpu_precision highest``
turns off TF32 in cuDNN's convs and cuBLAS's matmuls (torch's default lets
cuDNN take TF32).

Epochs ``epoch_count … niter + niter_decay``: a train step per batch, with
losses printed and logged every ``print_freq`` images, visuals saved every
``display_freq`` and the ``latest`` checkpoint every ``save_latest_freq``;
after each epoch an eval over at most 50 batches of ``testA/testB`` where
those exist (their mean loss is the ``plateau`` LR policy's metric), the
checkpoints every ``save_epoch_freq`` epochs, the HTML page, and the LR
step. ``--continue_train`` resumes from the ``--epoch`` checkpoint.
Checkpoints, logs and the page go to ``<checkpoints_dir>/<name>/``.
Batches reach the device through ``prefetch_to_device`` (pinned memory,
``prefetch_depth`` batches ahead); with ``--device_aug`` the crop, flip and
normalize run there. Dropout draws from torch's generator, seeded with
``seed + 1``.

Several processes train one model as the JAX CLI does over a mesh, one rank
each, started by torchrun (``torchrun --nproc_per_node N -m
cycle_depth_estimation_tpu_torch.train …``) or with the JAX flags
``--coordinator_address host:port --num_processes N --process_index i`` in
each process. ``--batch_size`` is the global batch: each rank loads it and
takes its rows (``parallel.mesh.host_shard_batch``), and the step's
gradients, BatchNorm statistics, pool queries, masked means and losses are
global (``parallel/``). ``--mesh_shape D M`` puts the ranks on ``data`` ×
``model``; ``place_state`` lays the state out: ``--zero opt|fsdp`` splits
Adam's moments (and the parameters) over ``data``, ``--parallel tp`` the
CycleGAN generators' trunk channels over ``model``, ``--parallel sp`` the
images' height over ``model`` (``parallel/spatial.py``: cycle_gan with a
resnet generator, a basic or n_layers discriminator and InstanceNorm).
Pipelines are a library call (``parallel/pipeline.py``
``gpipe_apply``), not a CLI mode. The backend is NCCL when
every rank has its own card, gloo otherwise (printed first). Rank 0 alone
prints, logs, writes visuals and the page, and writes the checkpoints,
which hold whole tensors.
"""

from __future__ import annotations

import json
import os
import time


def main(argv=None):
    import torch

    from .config import parse_args, print_options
    from .data import create_dataloader
    from .data.device_transforms import wrap_for_config
    from .data.loader import prefetch_to_device
    from .device import resolve_device, set_precision
    from .models import create_model
    from .parallel import collectives, mesh as pmesh
    from .parallel.zero import memory_report, state_trees
    from .utils.visualizer import Visualizer

    cfg = parse_args(argv, is_train=True)
    world = pmesh.launch_env(cfg)
    if world is None:
        device = resolve_device(cfg.device)
        pmesh.mesh_layout(cfg.mesh_shape, cfg.mesh_axes, 1)
        groups = collectives.Groups()
    else:
        device = pmesh.init_distributed(**world, device=cfg.device)
        groups = pmesh.mesh_groups(pmesh.make_mesh(
            cfg.mesh_shape, cfg.mesh_axes, device.type),
            spatial=cfg.parallel == "sp")
    check_layout(cfg, groups, distributed=world is not None)
    collectives.activate(groups)
    writer = collectives.is_writer()
    set_precision(cfg.tpu_precision)
    torch.manual_seed(cfg.seed + 1)

    def to_device(loader, aug_cfg, seed):
        # under --parallel sp a rank crops its data rows at the whole
        # height, then keeps its rows of it
        batches = prefetch_to_device(loader, device, depth=cfg.prefetch_depth,
                                     spatial=not cfg.device_aug)
        if cfg.device_aug:
            batches = map(pmesh.spatial_rows, wrap_for_config(
                batches, aug_cfg, torch.Generator(device).manual_seed(seed)))
        return batches

    message = print_options(cfg)
    if writer:
        print(message)
        os.makedirs(cfg.expr_dir(), exist_ok=True)
        with open(os.path.join(cfg.expr_dir(), "opt.txt"), "wt") as fh:
            fh.write(message + "\n")

    loader_train = create_dataloader(cfg, phase="train")
    try:
        loader_test = create_dataloader(cfg.replace(is_train=False),
                                        phase="test", shuffle=False)
    except (FileNotFoundError, KeyError):
        loader_test = None
    if writer:
        print(f"#training batches = {len(loader_train)}")

    model = create_model(cfg.replace(device=str(device)))
    state = model.init_state()
    if cfg.continue_train:
        state = model.load_networks(state, cfg.epoch)
    if cfg.zero != "off" and writer:
        print("[zero] memory_report "
              + json.dumps(memory_report(state_trees(state), groups.data_size,
                                         shard_params=cfg.zero == "fsdp")))
    state = place_state(cfg, state, groups, distributed=world is not None)
    visualizer = Visualizer(cfg) if writer else None

    try:
        return _train(cfg, model, state, loader_train, loader_test,
                      visualizer, to_device)
    finally:
        for loader in (loader_train, loader_test):
            if loader is not None:
                loader.close()
        if world is not None:
            collectives.activate(collectives.Groups())
            torch.distributed.destroy_process_group()


def place_state(cfg, state, groups, distributed: bool = True):
    """Lay the state out by the parallel flags (the JAX CLI's
    ``_place_state``):

    - default / ``--parallel dp``: every rank holds everything; the step
      averages the gradients over ``data``;
    - ``--zero opt|fsdp``: Adam's moments (and for fsdp the parameters)
      split over ``data`` (``parallel/zero.py``);
    - ``--parallel tp``: Megatron's column/row split of the cycle_gan
      resnet trunks and their Adam moments over ``model``
      (``parallel/tensor.py``); with ``--zero`` the rest takes ZeRO's
      layout;
    - ``--parallel sp``: the state stays replicated, the four nets run on
      this rank's rows of the images (``parallel/spatial.py``), the
      batch's height is split at the host→device boundary; with
      ``--zero`` ZeRO's layout over ``data``.
    """
    from .parallel.spatial import spatial_state
    from .parallel.tensor import shard_state_tp
    from .parallel.zero import zero_state

    check_layout(cfg, groups, distributed)
    if cfg.zero != "off":
        state = zero_state(state, groups, shard_params=cfg.zero == "fsdp",
                           skip=("G",) if cfg.parallel == "tp" else ())
    if cfg.parallel == "tp":
        state = shard_state_tp(state, groups.model, groups.model_size,
                               groups.model_rank)
    if cfg.parallel == "sp":
        state = spatial_state(state, groups.model)
    return state


def check_layout(cfg, groups, distributed: bool) -> None:
    """Refuse, with the JAX CLI's messages, what ``place_state`` cannot
    lay out."""
    if cfg.parallel not in ("dp", "sp", "tp"):
        raise SystemExit(
            f"--parallel {cfg.parallel!r} is not a train-CLI mode (dp|sp|tp);"
            " pipeline parallelism is a library feature —"
            " parallel/pipeline.py gpipe_apply")
    if cfg.parallel == "sp" and (
            cfg.model != "cycle_gan" or "resnet" not in cfg.net_g
            or cfg.net_d not in ("basic", "n_layers")
            or cfg.norm != "instance"):
        raise SystemExit(
            "--parallel sp is wired for cycle_gan with a resnet generator, a"
            " basic or n_layers discriminator and --norm instance (got"
            f" model={cfg.model!r}, net_g={cfg.net_g!r},"
            f" net_d={cfg.net_d!r}, norm={cfg.norm!r}); sp for the other"
            " models is ROADMAP A1c")
    if cfg.parallel in ("sp", "tp") and groups.model is None:
        raise SystemExit(
            f"--parallel {cfg.parallel} needs a 'model' mesh axis: pass"
            " --mesh_shape D M (axes default to data model)")
    if cfg.parallel == "sp" and cfg.fine_size % groups.model_size != 0:
        raise SystemExit(
            f"--parallel sp: --fine_size {cfg.fine_size} is not divisible by"
            f" the model axis ({groups.model_size}); every rank holds"
            " fine_size/M rows of each image")
    if cfg.zero != "off":
        if cfg.zero not in ("opt", "fsdp"):
            raise SystemExit(f"--zero {cfg.zero!r}: expected off|opt|fsdp")
        if not distributed:
            raise SystemExit(
                f"--zero {cfg.zero} needs a process group: launch with"
                " torchrun, or --coordinator_address host:port"
                " --num_processes N --process_index i (N may be 1)")
    if cfg.parallel == "tp":
        if cfg.model != "cycle_gan" or "resnet" not in cfg.net_g:
            raise SystemExit(
                "--parallel tp is wired for the cycle_gan resnet generators"
                f" (got model={cfg.model!r}, net_g={cfg.net_g!r}); other"
                " models run dp/sp, or use parallel/tensor.py directly")
        if (4 * cfg.ngf) % groups.model_size != 0:
            raise SystemExit(
                f"--parallel tp: trunk width 4*ngf={4 * cfg.ngf} must divide"
                f" by the model axis ({groups.model_size})")


def _train(cfg, model, state, loader_train, loader_test, visualizer,
           to_device):
    import numpy as np

    from .parallel import collectives
    from .parallel.zero import gather_params

    total_steps = 0
    eval_metric = None  # the plateau LR policy's metric
    for epoch in range(cfg.epoch_count, cfg.niter + cfg.niter_decay + 1):
        epoch_start = time.time()
        loader_train.set_epoch(epoch)
        iter_start = time.time()
        for batch in to_device(loader_train, cfg,
                               (cfg.seed + 2) * 1_000_003 + epoch):
            t_data = time.time() - iter_start
            state, losses = model.train_step(state, batch)
            total_steps += cfg.batch_size

            if visualizer and total_steps % cfg.print_freq < cfg.batch_size:
                losses_host = {k: float(v) for k, v in losses.items()}
                t_step = time.time() - iter_start - t_data
                visualizer.print_current_losses(epoch, total_steps, losses_host,
                                                t_step, t_data)
                visualizer.log_scalars(epoch, total_steps, losses_host)

            if total_steps % cfg.display_freq < cfg.batch_size:
                _, visuals = model.eval_step(state, batch)
                if visualizer:
                    visualizer.display_current_results(visuals, epoch)

            if total_steps % cfg.save_latest_freq < cfg.batch_size:
                if visualizer:
                    print(f"saving the latest model (epoch {epoch}, "
                          f"total_steps {total_steps})")
                model.save_networks(state, "latest")

            if (cfg.kitti_gt_dir and loader_test is not None
                    and total_steps % cfg.eval_freq < cfg.batch_size):
                gather_params(state)
                if visualizer:  # rank 0 alone, without collectives
                    prev = collectives.activate(collectives.Groups())
                    try:
                        kitti_validate(cfg, model, state, epoch, total_steps)
                    finally:
                        collectives.activate(prev)
            iter_start = time.time()

        if loader_test is not None:
            eval_losses = []
            for i, batch in enumerate(to_device(
                    loader_test, cfg.replace(is_train=False), cfg.seed + 3)):
                if i >= 50:
                    break
                m, _ = model.eval_step(state, batch)
                eval_losses.append({k: float(v) for k, v in m.items()})
            if eval_losses:
                avg = {k: float(np.mean([e[k] for e in eval_losses]))
                       for k in eval_losses[0]}
                if visualizer:
                    print(f"[eval epoch {epoch}] "
                          + " ".join(f"{k}: {v:.3f}" for k, v in avg.items()))
                    visualizer.log_scalars(
                        epoch, total_steps,
                        {f"eval_{k}": v for k, v in avg.items()})
                eval_metric = float(np.mean(list(avg.values())))

        if epoch % cfg.save_epoch_freq == 0:
            if visualizer:
                print(f"saving the model at the end of epoch {epoch}")
            model.save_networks(state, "latest")
            model.save_networks(state, epoch)

        if visualizer:
            print(f"End of epoch {epoch} / {cfg.niter + cfg.niter_decay} \t "
                  f"Time Taken: {time.time() - epoch_start:.0f} sec")
            visualizer.save_html(epoch)
        state = model.update_learning_rate(state, epoch, metric=eval_metric)
    return state


def kitti_validate(cfg, model, state, epoch: int, total_steps: int):
    """Write the test split's refined depths, score them against
    ``cfg.kitti_gt_dir`` and append the records line (reference
    new_multi/train5.py:85-115). Returns the metrics, or None when that
    failed (the reason is printed; training goes on, as in the JAX CLI)."""
    import json
    import traceback

    from .tools.save_kitti import save_depth_maps
    from .utils.metrics import eval_depth_dirs

    pred_dir = os.path.join(cfg.expr_dir(), "pred")
    try:
        save_depth_maps(cfg, pred_dir, max_items=cfg.num_test, model=model,
                        state=state)
        metrics = eval_depth_dirs(cfg.kitti_gt_dir, pred_dir)
    except Exception as exc:  # a broken val split must not end training
        print(f"[kitti eval] skipped: {exc}")
        traceback.print_exc()
        return None
    line = json.dumps({"epoch": epoch, "iters": total_steps, **metrics})
    print("[kitti eval]", line)
    with open(os.path.join(cfg.expr_dir(), cfg.records_file), "a") as fh:
        fh.write(line + "\n")
    return metrics


if __name__ == "__main__":
    main()
