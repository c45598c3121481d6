#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cycle_depth_estimation_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. InstanceNorm kernel (Triton) against its plain torch version at the
   generator's three plane shapes, fp32 and bf16, with kernel, plain,
   ``F.instance_norm`` and byte-bound times.
1b. InstanceNorm backward kernel (Triton) against its plain version at the
   six plane shapes of a CycleGAN train step (three of G, three of D, the
   31² one masked), fp32 and bf16, with kernel, plain, library (autograd's
   backward of ``F.instance_norm``) and byte-bound times.
2. int8 epilogue kernel (CUDA C++) against its plain version at every site
   variant of ``fused_int8_apply``, with the plan each site takes, its time
   beside its bound and beside the generic (earlier) kernel's; then ragged
   and 'edge' shapes, correctness only; then (phase 2b) the int8 conv
   against its exact fp64 reference. Phases 1 and 2 report device time per
   call: calls
   replayed from a CUDA graph over inputs that exceed the L2 cache; the
   eager back-to-back time, which includes the host's launch, is printed
   beside the kernel's.
3. Main path, fp32: ResnetGenerator ngf 64, 9 blocks, batch 8, 256², seeded
   init. Kernel path against the plain path; 23 InstanceNorm launches per
   forward.
4. Main path, bf16 (the JAX package's ``__graft_entry__.entry()`` shape).
5. The serving CLI (``cycle_depth_estimation_tpu_torch.test``) on 4 PNGs.
6. Fused int8: ``calibrate`` → ``fused_int8_variables`` →
   ``fused_int8_apply``; 23 epilogue launches per forward, the kernel held
   against the plain version at each site on the path's own inputs, and
   the output against the plain path and against fp32.
6b. The same in the all-int8 up modes ``int8_dilated`` and ``int8_phases``
   (the ConvTranspose generator) and ``resize_conv_int8`` (a seeded
   ``ResnetGenerator(up_mode='resize_conv')``, held against its own fp32
   forward): 23 epilogue launches per forward each, img/s each.
7. Where one bf16 and one fused int8 forward spend device time
   (``torch.profiler``), and the device's idle share.
8. CycleGAN training at full width (two 9-block generators, ngf 64, two
   3-layer PatchGANs, ndf 64), batch 8, 256², fp32, seeded init and batch:
   one step through the kernels against one through the plain versions
   (losses, parameters under Adam's sign rule), 192 forward and 192
   backward InstanceNorm launches per step, pool count, steps/s, img/s,
   peak memory, and one profiled step (idle share, top kernels, the
   InstanceNorm kernels' time per step beside their bounds).
9. The train CLI (``python -m cycle_depth_estimation_tpu_torch.train``, in
   a process of its own) on 4 PNGs a folder at 64², full widths:
   checkpoints, logs, HTML page; then a resume through its ``main`` here.
10. The UNet-256 with ``--norm instance`` (ngf 64, batch 8, 256²), forward
   and backward: both InstanceNorm kernels at its 13 planes (128² down to
   2²) held against their plain versions on the path's own inputs, and
   the 1² plane (variance 0) on its own.
11. pix2pix training at full width (the JAX defaults: unet_256 ngf 64 with
   BatchNorm and dropout, a 3-layer PatchGAN ndf 64 on the 6-channel pair,
   vanilla GAN, λ_L1 100, no pool), batch 8, 256², fp32, seeded: finite
   losses, BatchNorm statistics moved, G_L1 falling over steps on a fixed
   batch, steps/s, img/s, peak memory and one profiled step.
12. The pix2pix train CLI in a process of its own (``--num_threads 2``) on
   4 aligned PNGs (``unet_128`` at 128²; phase 11 runs the full-width
   step), started before phase 9 and run beside it; then its resume with
   ``--worker_procs 2 --device_aug`` (crop, flip and normalize on the
   card), again in a process of its own, beside phase 10; after phase 11,
   the test CLI with ``--model pix2pix`` on the checkpoint.

13. bf16 training at full width: one seeded CycleGAN step (batch 8, 256²,
   9 blocks, ngf 64) and one pix2pix step (unet_256) in bf16 against the
   fp32 step from the same init (losses within 5e-2 relative); both
   InstanceNorm kernels launched on bf16 at their counts (CycleGAN; the
   pix2pix nets use BatchNorm); img/s and peak memory beside fp32.
14. ``--remat``: the fp32 CycleGAN step with and without it from one seed,
   cuDNN deterministic: losses, parameters and generator gradients agree;
   peak memory of each; 330 forward and 192 backward InstanceNorm
   launches a step with it.
15. SegCycle at full width (the JAX defaults: two 9-block generators ngf
   64, two 3-layer PatchGANs ndf 64, the BatchNorm U-Net encoder/decoder
   pairs ngf 64, 22/28 classes), batch 8, 192×640, fp32 with TF32 off:
   every InstanceNorm call of a step, forward and backward, held against
   the plain version on its own inputs (planes 192×640 down to 23×79); one
   step through the kernels against one through the plain versions, by
   phase 8's yardstick; 156 + 156 launches; steps/s, img/s, peak memory, a
   profiled step; then one bf16 step.
16. T2Net (``--model seg``) at full width (192×640, batch 8, the 9-block
   translator at ngf 64, ``--norm instance``): every InstanceNorm call held
   against the plain version, the task net's 1536-channel 12×40 planes
   among them; 65 + 42 launches; the frozen translator; img/s. Beside
   phases 15 and 16: the train CLI ``--model seg_cycle --dataset_mode
   synthia`` on synthesized SYNTHIA-like PNGs (RGB, 8-bit labels, 16-bit
   depth, listed in .txt files) at ngf 16, in a process of its own, then
   its resume: checkpoints of the 8 nets and colorized label visuals.

17. S2D (``--model S2D``, new_multi) at the JAX package's full width
   (DenseNet-169 G_2 with growth 32, blocks (6, 12, 32, 32), mid_nc 1024;
   G_1 with 3 dual blocks; R_D; FD1–FD3), 192×576, fp32 with TF32 off. 17b:
   the first step at batch 1 on the card and on the CPU from one init and
   batch (oneDNN off), at adam_eps 1e-3: the losses within 1e-3 relative,
   and each phase again on the card from the CPU's input, its losses
   within 1e-3 and the net it updates by the three checks of the JAX
   tests' ``_assert_params_close``; each net's share of sign-flipped
   first updates over the whole step reported. Beside it, the S2D train
   CLI on vKITTI-sized (1242×375) PNGs in a process of its own, then its
   resume beside 17c/17d: bf16 and ``--remat`` first steps against fp32
   at batch 8 (losses within 5e-2, resp. 1e-6; with --remat every
   BatchNorm moved once; the peak memory of each). 17a: the step timed
   at batch 1 and 8 (ms, img/s, peak memory). S2D runs no
   InstanceNorm or epilogue kernel: the phase fails if either count moved.

Every CLI process runs in a session of its own: it fails the phase if a
process of that session (a loader worker, the forkserver, Python's resource
tracker) still runs 10 s after the CLI ended. The script fails, too, if a
process it started still runs when it is about to print its result.

Launch counts are zeroed just before phase 3 and read after phase 7 (the
serving path), before and after phase 22 (generic PTQ), before phase 8
and after phase 9 (the training path),
before phase 10 and after phase 12 (the pix2pix path), and before and
after each of phases 13 to 16 (bf16 training, remat, SegCycle, T2Net),
17, 19, 20 and 21 (S2D and the base, two-trunk and semantic_trans
generations, where they must stay 0) and 18b (rf_lw).
18. RefineNet-LW (``--model rf_lw``) at the JAX package's full width
   (ResNetLW-101, four segd heads, 28 + 1 classes), 192×576. 18a (run
   right after phase 1b, with the other kernel checks): both InstanceNorm
   kernels at the four adapter planes (256×48×144 down to 2048×6×18),
   fp32 and bf16, batch 1 and 8, with kernel, plain, library and bound
   times. 18b: at batch 1 and 8, fp32 with TF32 off, one step
   through the kernels (every InstanceNorm call held against its plain
   version) against the plain versions and F.instance_norm, by phase 8's
   yardstick, 8 + 8 launches a step, the unused ``_s`` adapters unmoved;
   an rf_lw7 step and a bf16 step (losses within 5e-2 of fp32); the step
   timed at batch 1 and 8. 18c, beside 18b's checks: the
   train CLI ``--model rf_lw --kitti_gt_dir … --eval_freq 1`` on a
   synthetic try tree for 2 steps (a records line each step, with every
   KITTI metric), then ``save_kitti`` from its ``latest`` checkpoint and
   for a small random S2D, and ``eval_kitti`` on the rf_lw maps, each in a
   process of its own.
19. The base my_seg_depth generation, ``--model S2D_base`` and ``--model
   S2D_alt``, at the JAX package's full width (S2D_base: G_1 with 3 resnet
   blocks, the DenseNet-169 GeneralNet2, SEG2/DEP2, the dropout
   discriminator at ndf 64; S2D_alt: two 3-block GBase encoders,
   FeatureNet, SEGAlt/DEPAlt, the 128-channel discriminator), 192×576, fp32
   with TF32 off. 19a: each model's first batch-1 step on the card against
   the CPU's (oneDNN off) from one seed with the same dropout masks: the
   losses within 1e-3 relative, then each phase again on the card from the
   CPU's input, its losses within 1e-3 and the nets it updates by the three
   checks; the whole step's sign-flipped first updates reported. 19b: a
   bf16 first step against fp32 (losses within 5e-2). 19c: the step timed
   at batch 1 and 8 (or, where 8 does not fit, the largest of 4 and 2).
   Neither model has an InstanceNorm: the kernel counts must not move in
   phase 19. (The train CLIs of phases 19–21 run in the CPU tests.)
20. The two-trunk generation, ``--model S2D_df``, ``--model S2D_nd`` and
   ``--model S2D_nd --nd_4dis``, at the JAX package's full width (two
   DenseNet-169 GeneralNet2 trunks; S2D_df: SEGDF, DEPDF and the 512-channel
   Dis2SegDF; S2D_nd: SEG, DEP and the 1024-channel DiscriminatorSeg with
   the WGAN-GP penalty and SGD, or the two 256-channel twin critics),
   192×576, fp32 with TF32 off, by phase 19's steps: 20a card against CPU
   with the same penalty alphas (drawn on the CPU from the seed and the
   step); S2D_nd's critic is piecewise linear and its BCE ill-conditioned
   near its clamp, so the phases that differentiate it (D1, G_2, D2) and
   its whole step are held with the BCE's slope and the D
   phases' critic inputs taken from the CPU (``CriticPins``), the trunks'
   features and the critic's outputs held apart, and reported unpinned
   beside the card's float64 phase and step; 20b bf16 against fp32, each
   loss as the step first computes it and as it ends (S2D_nd's second D
   phase from the fp32 step's input to it); 20c timed. No InstanceNorm or
   epilogue launch may happen in phase 20.
21. The semantic_trans generation, ``--model semantic_trans`` (S2D's nets
   with the truncated band criterion, the four StarDiscriminator critics,
   the WGAN-GP penalty on DIS and the clipped Adam of Dis_160/Dis_320)
   and ``--model semantic_trans_full`` (G_1, a DenseNet-169 GeneralNet,
   SEG/DEP, the RDepST refiner, Discriminator2Seg and the four critics),
   at the JAX package's full width, 192×576, fp32 with TF32 off, by phase
   19's steps: 21a card against CPU with the same penalty alpha and Adam's
   eps raised to 1e-3 on both sides, the clipped nets' gradient norms and
   how many of DIS's LeakyReLU inputs the card puts on the other side of 0
   reported; semantic_trans_full's G_1 phase, whose heads' backward fp32
   puts 1e-2 from float64 on the card and the CPU alike, held with the
   gradient at G_1's output taken from the CPU (``GradPins``) and reported
   unpinned beside the card's float64 phase, and its phase-D losses, which
   read the earlier updates, reported over the whole step and held from
   the CPU's input to phase D; 21b bf16 against fp32 (semantic_trans_full's
   phase D from the fp32 step's input with the features Dis0_en reads
   taken from the fp32 step, and reported without them); 21c timed at
   batch 1 and 8. No InstanceNorm or epilogue launch may happen in phase
   21.
22. Generic PTQ (``models/ptq.py``) at the JAX package's working points,
   run after phase 7 with its own launch counts (the path ``ptq``), TF32
   off: the main path's generator (9 blocks, ngf 64, batch 8, 256²)
   calibrated on 4 structured images and served int8 at its 22 conv sites
   (23 InstanceNorm launches a forward), cosine against its fp32 output ≥
   0.99, ms and img/s beside phases 3, 4 and 6, and the ConvTranspose
   opt-in (24 sites) likewise; rf_lw's ResNetLW-101 at 192×576, batch 1,
   calibrated on 'real' and served in 'real' and 'syn' (pred cosine ≥
   0.99); the S2D chain G_1 → G_2 (DenseNet-169) → R_D at 192×576, batch
   1 (depth and seg cosine ≥ 0.98, seg argmax agreement > 0.9). 22a: every
   int8 conv of those forwards on its own int8 inputs ``torch.equal`` to
   the fp64 conv (the dilated PSP convs, the small pooled planes). 22b:
   the test CLI in process, ``--model test --model_suffix _A --int8`` on
   the generator saved as ``latest_net_G_A.pth``: the gallery and "22 conv
   sites". 22c: ResGenerator and PreUNet16 at T2Net's 192×640 (ngf 64),
   the MultiscaleDiscriminator (2 scales) and the FeatureDiscriminator
   (512×12×40), the card's forward against the CPU's within 1e-4 of the
   largest output.
23. Data, ZeRO and tensor parallelism (``parallel/``), last. 23a: the
   train CLI on phase 8's CycleGAN (two 9-block generators, ngf 64, 256²,
   batch 8, fp32, TF32 off), two steps, run plain twice and then with
   ``--parallel dp`` in a world of one over NCCL (``--coordinator_address``):
   its saved state ``torch.equal`` to the plain run's, or, where the two
   plain runs differ (cuDNN's backward), within twice that; both second
   steps' times. 23b: one spawn of two ranks sharing the card over gloo
   runs the same CycleGAN at global batch 8 (4 rows a rank) under ``dp``,
   ``--zero opt``, ``--zero fsdp`` and ``--mesh_shape 1 2 --parallel tp``
   (both ranks all 8 rows, the trunk's planes (8, 128, 64, 64)), each
   against the single-process step on the card from the same seed, TF32
   off and Adam's eps 1e-3 on both sides: synced generator gradients
   within 1e-5 of the largest (where two one-process runs differ past
   that, within 3× their L2 distance), losses within 1e-4, parameters by
   the three pooled checks, the ranks' parameters equal, 192 + 192
   InstanceNorm launches a rank a step, each rank's ``memory_report`` and
   the bytes it holds; and S2D at batch 2 (a row a rank), 192×576, under
   ``dp``, each phase from the one-process state and input before it (as
   17b holds the card against the CPU): its losses within 1e-3, every net
   by the three checks at its own lr. No scaling
   figure: two ranks on one card measure none.


The last three lines
are a JSON object with every kernel's numbers, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --sweep-epilogue [TABLE]

builds the kernels and times every legal plan of the epilogue's cluster
kernel (channel tile, cluster size, threads, staged rows) at every site, each
checked against the plain version first. That is how ``plan_epilogue``'s
rules were chosen. It prints the best plans of each site, appends every
timing to the file TABLE if one is named, and prints no result line.

    python3 chip_smoke.py --bench-loaders

times the pix2pix train CLI's loaders at full size (``bench_loaders``): how
long a step waits for its batch with the serial loader, threads, processes
and ``--device_aug``. It prints no result line either.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 * 2 ** 20
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
IN_FLOPS_PER_ELEM = 5         # sum, sum of squares, subtract, multiply
IN_BWD_FLOPS_PER_ELEM = 10    # x̂, two sums, then x̂ again and dx
EP_FLOPS_PER_ELEM = 9         # IN + relu/residual + scale, round, clip
BATCH, SIZE, NGF, N_BLOCKS = 8, 256, 64, 9
NDF = 64
CLI_SIZE = 128                # the CLIs' pix2pix runs: unet_128 at 128²

# InstanceNorm planes of one generator forward: (N, C, H, W) → calls
IN_SHAPES = {(BATCH, NGF, SIZE, SIZE): 2,
             (BATCH, 2 * NGF, SIZE // 2, SIZE // 2): 2,
             (BATCH, 4 * NGF, SIZE // 4, SIZE // 4): 2 * N_BLOCKS + 1}

# InstanceNorm planes of one CycleGAN train step (forward and backward
# alike): 6 generator passes and 18 discriminator passes (2 in the G loss,
# 4 D steps × 2 nets × real and fake), 3 norms each
G_PASSES, D_PASSES = 6, 2 + 4 * 2 * 2
TRAIN_IN_SHAPES = {
    **{shape: G_PASSES * calls for shape, calls in IN_SHAPES.items()},
    (BATCH, 2 * NDF, SIZE // 4, SIZE // 4): D_PASSES,
    (BATCH, 4 * NDF, SIZE // 8, SIZE // 8): D_PASSES,
    (BATCH, 8 * NDF, SIZE // 8 - 1, SIZE // 8 - 1): D_PASSES,
}
TRAIN_PER_STEP = sum(TRAIN_IN_SHAPES.values())
TRAIN_STEPS_TIMED = 3
# --remat runs the six generator forwards again in backward
REMAT_PER_STEP = TRAIN_PER_STEP + G_PASSES * sum(IN_SHAPES.values())

# SegCycle at the synthia size (192×640): the six generator passes, 2 D
# passes in the G loss and 4 in its one D update (2 nets × real and fake)
SEG_H, SEG_W = 192, 640
SEG_G_SHAPES = {(BATCH, NGF, SEG_H, SEG_W): 2,
                (BATCH, 2 * NGF, SEG_H // 2, SEG_W // 2): 2,
                (BATCH, 4 * NGF, SEG_H // 4, SEG_W // 4): 2 * N_BLOCKS + 1}
SEG_D_PASSES = 2 + 2 * 2
SEG_IN_SHAPES = {
    **{shape: G_PASSES * calls for shape, calls in SEG_G_SHAPES.items()},
    (BATCH, 2 * NDF, SEG_H // 4, SEG_W // 4): SEG_D_PASSES,
    (BATCH, 4 * NDF, SEG_H // 8, SEG_W // 8): SEG_D_PASSES,
    (BATCH, 8 * NDF, SEG_H // 8 - 1, SEG_W // 8 - 1): SEG_D_PASSES,
}
SEG_PER_STEP = sum(SEG_IN_SHAPES.values())
# T2Net with --norm instance: the frozen translator's 23 forward norms, and
# 21 norms of the task net (trunk 15, head 6) in each of its 2 forwards
T2NET_FWD, T2NET_BWD = sum(SEG_G_SHAPES.values()) + 2 * 21, 2 * 21

# fused_int8_apply epilogue sites: name → (NHWC shape, input dtype,
# quantize?, kwargs, calls per forward)
_S1, _S2, _S4 = ((BATCH, SIZE // d, SIZE // d, NGF * d) for d in (1, 2, 4))
EP_SITES = {
    "conv_in": (_S1, "int32", True, dict(relu=True), 1),
    "down0": (_S2, "int32", True, dict(relu=True), 1),
    "down1": (_S4, "int32", True, dict(relu=True, keep_float=True, pad=1), 1),
    "block_conv1": (_S4, "int32", True, dict(relu=True, pad=1), N_BLOCKS),
    "block_conv2": (_S4, "int32", True, dict(residual=True, pad=1),
                    N_BLOCKS - 1),
    "last_block_float": (_S4, "int32", False, dict(residual=True), 1),
    "up0_float": (_S2, "bf16", False, dict(relu=True), 1),
    "up1_pad3": (_S1, "bf16", True, dict(relu=True, pad=3), 1),
}
# the three sites that the all-int8 up modes add: the last block, up0 and up1
# requantize from int32 (the other 20 are bf16 mode's)
EP_UP_SITES = {
    "last_block_q": (_S4, "int32", True, dict(residual=True), 1),
    "up0_q": (_S2, "int32", True, dict(relu=True), 1),
    "up1_q_pad3": (_S1, "int32", True, dict(relu=True, pad=3), 1),
}
# calls per forward of each site in the all-int8 up modes
EP_UP_CALLS = {**{k: v[-1] for k, v in EP_SITES.items()
                  if k in ("conv_in", "down0", "down1", "block_conv1",
                           "block_conv2")},
               **{k: v[-1] for k, v in EP_UP_SITES.items()}}
# ms per call of the epilogue kernel before its redesign (one block per
# (sample, 8 channels), scalar access, two reads of y; PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700.00 W). The same kernel is still the generic
# variant, and phase 2 times it again beside the new one.
EP_EARLIER_MS = {"conv_in": 0.307, "down0": 0.098, "down1": 0.095,
                 "block_conv1": 0.051, "block_conv2": 0.111,
                 "last_block_float": 0.065, "up0_float": 0.088,
                 "up1_pad3": 0.296}
INT8_EARLIER_IPS = 481.9  # fused int8 img/s then: same section, card, limit
# Shapes off the main path, correctness only: ragged channel tiles, a C the
# vector path cannot take, a split with an odd cluster, 'edge' padding
EP_RAGGED = {
    "c24_h10_pad3": ((2, 10, 10, 24), "int32", True, dict(relu=True, pad=3)),
    "c6_h10_pad3": ((2, 10, 10, 6), "int32", True,
                    dict(residual=True, pad=3)),
    "c24_edge_pad3": ((2, 10, 12, 24), "bf16", True,
                      dict(relu=True, pad=3, pad_mode="edge",
                           keep_float=True)),
    "c40_h67_edge_pad2": ((3, 67, 33, 40), "int32", True,
                          dict(residual=True, pad=2, pad_mode="edge")),
    "c72_h50_pad3": ((3, 50, 41, 72), "bf16", True,
                     dict(relu=True, pad=3, keep_float=True)),
    "c6_float_only": ((2, 9, 7, 6), "bf16", False, dict(relu=True)),
}
# InstanceNorm sites of one generator forward, and epilogue sites of one
# fused int8 forward: both 23 at 9 blocks
PER_FORWARD = sum(IN_SHAPES.values())
assert PER_FORWARD == sum(site[-1] for site in EP_SITES.values())
assert PER_FORWARD == sum(EP_UP_CALLS.values())
UP_MODES = ("int8_dilated", "int8_phases", "resize_conv_int8")
# Cosine of the fused int8 output with its fp32 generator: 0.99, except in
# 'resize_conv_int8', whose arithmetic reaches less on the seeded weights:
# on this generator, calibration and first image the JAX function gives
# 0.98784 and the port's plain path 0.98797 (``python
# tests/test_torch_port_int8_up_modes.py``, on the CPU).
FP32_COSINE_FLOOR = {"resize_conv_int8": 0.985}


_T0 = time.perf_counter()


def log(msg):
    """``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def ms_per_call(fn, iters=20, warmup=3):
    """Host view: ``iters`` eager calls back to back between CUDA events.
    Where a call's device work is shorter than its launch on the host, this
    measures the launch."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_call(fn, inputs, iters=24):
    """Device time of ``fn(*args)``: ``iters`` calls, cycling over
    ``inputs``, captured in a CUDA graph and replayed between CUDA events,
    so no host launch time is in it. ``inputs`` holds enough copies that
    the calls do not find their operands in the 50 MB L2 cache."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_past_l2(*tensors):
    """Enough clones of ``tensors`` to hold twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    n = max(2, -(-2 * L2_BYTES // nbytes))
    return [tuple(None if t is None else t.clone() for t in tensors)
            for _ in range(n)]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(t):
    """One bf16 ulp of each element, taken at no less than 2⁻⁸: where x − mean
    (or IN + residual) cancels to near 0, the fp32 rounding of the statistics
    (~1e-7 absolute) is larger than the ulp of the tiny result."""
    mag = t.float().abs().clamp_min(2.0 ** -8)
    return (mag.log2().floor() - 7).exp2()


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@contextmanager
def counted(fn, expect, what):
    """Assert that ``fn.launches`` rises by exactly ``expect`` inside."""
    before = fn.launches
    yield
    got = fn.launches - before
    if got != expect:
        raise AssertionError(f"{what}: {got} launches, expected {expect}")


ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CLI = "cycle_depth_estimation_tpu_torch.train"


def running(field, value):
    """Running processes (zombies left out) whose ``/proc/<pid>/stat``
    ``field`` ("ppid" or "session") is ``value``, as "pid command" lines."""
    index = {"ppid": 1, "session": 3}[field]
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # ended meanwhile
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z" and int(fields[index]) == value:
            found.append(f"{pid} {cmd[:160]}")
    return found


def start_cli(module, args, threads=2):
    """``python -m <module> <args>`` in a session of its own (so every
    process it starts can be found), its output to a temporary file, with
    ``threads`` intra-op threads (the CLIs run beside this process's CPU
    work; None: torch's default)."""
    out = tempfile.TemporaryFile("w+")
    env = dict(os.environ)
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            stdout=out, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=env)
    return {"proc": proc, "out": out, "t": time.perf_counter()}


def end_cli(run, what, timeout=600, grace=10.0):
    """Wait for ``start_cli``'s process; return its output and seconds.
    Raises if it failed, outlasted ``timeout``, or left a process of its
    session running ``grace`` seconds after it ended (those are killed)."""
    proc = run["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    seconds = time.perf_counter() - run["t"]
    deadline = time.perf_counter() + grace
    while running("session", proc.pid) and time.perf_counter() < deadline:
        time.sleep(0.1)
    left = running("session", proc.pid)
    if left:
        os.killpg(proc.pid, signal.SIGKILL)
    run["out"].seek(0)
    text = run["out"].read()
    run["out"].close()
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{text[-6000:]}")
    if left:
        raise AssertionError(f"{what} left processes running {grace} s after "
                             f"it ended: {left}")
    return text, seconds


def check_no_children():
    """Raise if a process this script started still runs (it is killed)."""
    left = running("ppid", os.getpid())
    for line in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(int(line.split()[0]), signal.SIGKILL)
    if left:
        raise AssertionError(f"processes left running: {left}")


def phase_build():
    from cycle_depth_estimation_tpu_torch.ops.kernels import build

    t = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    paths = build.build(names)
    log(f"phase 0 ok: built {names} in {time.perf_counter() - t:.1f} s "
        f"-> {[str(p.name) for p in paths.values()]}")


def phase_instance_norm(gen, shapes=None, tag="1", per="forward",
                        total_dtype="bfloat16"):
    """The forward kernel against its plain version at ``shapes`` {plane:
    calls} (default the generator's), fp32 and bf16, with kernel, plain,
    library and bound times; returns the sums over the calls of one
    ``per`` in ``total_dtype``, and the largest error."""
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, plain_instance_norm)

    shapes = IN_SHAPES if shapes is None else shapes
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, calls in shapes.items():
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1
                 ).to(dtype)
            want = plain_instance_norm(x)
            got = instance_norm(x)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = float(err.max()) <= 1e-4
            else:
                ok = bool((err <= 2 * bf16_ulp(want)).all())
            max_err = max(max_err, float(err.max()))
            if not ok:
                raise AssertionError(f"instance_norm {shape} {dtype}: max abs "
                                     f"err {float(err.max())}")
            xs = copies_past_l2(x)
            t_k = device_ms_per_call(instance_norm, xs)
            t_p = device_ms_per_call(plain_instance_norm, xs)
            t_l = device_ms_per_call(lambda v: F.instance_norm(v, eps=1e-5), xs)
            t_e = ms_per_call(lambda: instance_norm(x))
            nbytes = 2 * x.numel() * x.element_size()
            t_b, _ = bound(nbytes, IN_FLOPS_PER_ELEM * x.numel())
            log(f"phase {tag}: instance_norm {tuple(shape)} "
                f"{str(dtype)[6:]}: max_abs_err {float(err.max()):.3g} "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms F.instance_norm "
                f"{t_l:.4f} ms bound {t_b:.4f} ms; eager back-to-back "
                f"{t_e:.4f} ms (x{calls} per {per})")
            if str(dtype)[6:] == total_dtype:  # the headline dtype
                totals["ms"] += calls * t_k
                totals["plain_ms"] += calls * t_p
                totals["library_ms"] += calls * t_l
                totals["bytes"] += calls * nbytes
                totals["flops"] += calls * IN_FLOPS_PER_ELEM * x.numel()
            del x, xs, want, got
    log(f"phase {tag} ok: instance_norm per {total_dtype} {per} "
        f"{totals['ms']:.4f} ms (plain {totals['plain_ms']:.4f}, "
        f"F.instance_norm {totals['library_ms']:.4f})")
    return totals, max_err


def profiled_device_ms(fn, inputs, iters=12):
    """Device time per call of ``fn(*args)`` as ``torch.profiler`` sums it
    over the kernels ``iters`` eager calls launch: for a call that cannot be
    captured in a CUDA graph. Gaps between kernels are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    # CPU and CUDA, as profile_step: a CUDA-only session that follows
    # CPU+CUDA ones in one process recorded no device time on the H100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy <= 0:
        raise AssertionError("profiler recorded no device time")
    return busy / 1e3 / iters


def phase_instance_norm_backward(gen, shapes=None, tag="1b",
                                 per="CycleGAN step"):
    """The backward kernel against its plain version at ``shapes`` {plane:
    calls} (default a CycleGAN step's), fp32 and bf16, with kernel, plain,
    library and bound times; returns the sums over the calls of one fp32
    ``per``, and the largest error."""
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_backward, plain_instance_norm_backward,
        plain_instance_norm_stats)

    shapes = TRAIN_IN_SHAPES if shapes is None else shapes
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, calls in shapes.items():
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1
                 ).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            stats = plain_instance_norm_stats(x)
            want = plain_instance_norm_backward(x, dy, stats=stats)
            with counted(instance_norm_backward, 1, f"in_bwd {shape}"):
                got = instance_norm_backward(x, dy, stats=stats)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if got.dtype != dtype:
                raise AssertionError(f"in_bwd {shape}: dx is {got.dtype}")
            if dtype == torch.float32:
                ok = float(err.max()) <= 1e-4
            else:
                ok = bool((err <= 2 * bf16_ulp(want)).all())
            max_err = max(max_err, float(err.max()))
            if not ok:
                raise AssertionError(f"in_bwd {shape} {dtype}: max abs err "
                                     f"{float(err.max())}")
            ins = copies_past_l2(x, dy, *stats)
            t_k = device_ms_per_call(
                lambda a, g, m, r: instance_norm_backward(a, g, stats=(m, r)),
                ins)
            t_p = device_ms_per_call(
                lambda a, g, m, r: plain_instance_norm_backward(
                    a, g, stats=(m, r)), ins)
            lib_ins = []
            for a, g, _, _ in ins:
                a = a.detach().requires_grad_(True)
                lib_ins.append((F.instance_norm(a, eps=1e-5), a, g))
            t_l = profiled_device_ms(
                lambda y, a, g: torch.autograd.grad(y, a, g, retain_graph=True),
                lib_ins)
            nbytes = 3 * x.numel() * x.element_size() + 2 * 4 * stats[0].numel()
            flops = IN_BWD_FLOPS_PER_ELEM * x.numel()
            t_b, _ = bound(nbytes, flops)
            if t_k < t_b:
                raise AssertionError(f"in_bwd {shape}: {t_k} ms is under its "
                                     f"bound of {t_b} ms: wrong count or timer")
            log(f"phase {tag}: instance_norm_bwd {tuple(shape)} "
                f"{str(dtype)[6:]}: max_abs_err {float(err.max()):.3g} kernel "
                f"{t_k:.4f} ms plain {t_p:.4f} ms autograd F.instance_norm "
                f"backward {t_l:.4f} ms bound {t_b:.4f} ms "
                f"({t_k / t_b:.2f}x) (x{calls} per {per})")
            if dtype == torch.float32:  # the train step's dtype
                totals["ms"] += calls * t_k
                totals["plain_ms"] += calls * t_p
                totals["library_ms"] += calls * t_l
                totals["bytes"] += calls * nbytes
                totals["flops"] += calls * flops
            del x, dy, stats, want, got, ins, lib_ins
    log(f"phase {tag} ok: instance_norm_bwd per fp32 {per} "
        f"({sum(shapes.values())} calls) {totals['ms']:.4f} ms (plain "
        f"{totals['plain_ms']:.4f}, autograd {totals['library_ms']:.4f})")
    return totals, max_err


def _site_inputs(gen, shape, in_dtype, kw):
    import torch

    if in_dtype == "int32":
        y = torch.randint(-20000, 20000, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
    else:
        y = (torch.randn(shape, generator=gen, device="cuda") * 3
             ).to(torch.bfloat16)
    kw = dict(kw)
    residual = None
    if kw.pop("residual", False):
        residual = torch.randn(shape, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
    return y, residual, kw


def compare_epilogue(what, kernel_out, plain_out):
    """int8: differences of at most 1 on at most 0.1% of the elements (a
    different summation order moves values that lie on a .5 boundary);
    bf16: at most 2 ulps. Returns (max abs err, int8 mismatch share)."""
    (qk, zk), (qp, zp) = kernel_out, plain_out
    frac, err = 0.0, 0.0
    if qp is not None:
        d = (qk.int() - qp.int()).abs()
        frac = float((d > 0).float().mean())
        err = float(d.max())
        if err > 1 or frac > 1e-3:
            raise AssertionError(f"epilogue {what}: int8 max diff {err}, "
                                 f"share {frac}")
    if zp is not None:
        dz = (zk.float() - zp.float()).abs()
        if not bool((dz <= 2 * bf16_ulp(zp)).all()):
            raise AssertionError(f"epilogue {what}: bf16 max abs err "
                                 f"{float(dz.max())}")
        err = max(err, float(dz.max()))
    return err, frac


def _plan_of(y, res, quantize, kw):
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        plan_epilogue)

    return plan_epilogue(y.shape, y.element_size(), pad=kw.get("pad", 0),
                         pad_mode=kw.get("pad_mode", "reflect"),
                         quantize=quantize, residual=res is not None)


def _describe(kw, quantize):
    desc = ",".join(k if v is True else f"{k}={v}" for k, v in kw.items())
    return desc + ("" if quantize else ",float-only")


def phase_epilogue(gen):
    import torch

    from cycle_depth_estimation_tpu_torch.ops.kernels import int8_epilogue as ep

    totals = dict(ms=0.0, plain_ms=0.0, generic_ms=0.0, bytes=0, flops=0)
    up_totals = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    max_err = 0.0
    generic = ep.plan_epilogue((1, 1, 1, 1), 4)  # C = 1: the generic kernel
    ep.fused_in_epilogue.variant_launches.clear()
    for name, (shape, in_dtype, quantize, kw, calls) in {
            **EP_SITES, **EP_UP_SITES}.items():
        desc = _describe(kw, quantize)
        y, res, kw = _site_inputs(gen, shape, in_dtype, kw)
        inv = 25.0 if quantize else None
        plan = _plan_of(y, res, quantize, kw)
        if plan.variant == "generic" or plan.blocks(shape[0], shape[3]) < ep.SM_COUNT:
            raise AssertionError(f"epilogue {name}: main-path site takes {plan}")
        fits = ep.active_clusters(shape, y.element_size(), plan,
                                  pad=kw.get("pad", 0) if quantize else 0)
        if fits < 1:
            raise AssertionError(f"epilogue {name}: the card cannot place one "
                                 f"cluster of {plan}")
        with counted(ep.fused_in_epilogue, 1, f"epilogue {name}"):
            out_k = ep.fused_in_epilogue(y, inv, res, **kw)
        out_p = ep.plain_epilogue(y, inv, res, **kw)
        torch.cuda.synchronize()
        err, frac = compare_epilogue(name, out_k, out_p)
        max_err = max(max_err, err)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (y, res, *out_k) if t is not None)

        ins = copies_past_l2(y, res)
        t_k = device_ms_per_call(
            lambda a, r: ep.fused_in_epilogue(a, inv, r, **kw), ins)
        t_g = device_ms_per_call(
            lambda a, r: ep.launch(a, inv, r, plan=generic, **kw), ins)
        t_p = device_ms_per_call(
            lambda a, r: ep.plain_epilogue(a, inv, r, **kw), ins)
        t_e = ms_per_call(lambda: ep.fused_in_epilogue(y, inv, res, **kw))
        flops = EP_FLOPS_PER_ELEM * y.numel()
        t_b, _ = bound(nbytes, flops)
        if t_k < t_b:
            raise AssertionError(f"epilogue {name}: {t_k} ms is under its "
                                 f"bound of {t_b} ms: wrong count or timer")
        earlier = (f" (earlier run {EP_EARLIER_MS[name]:.3f} ms)"
                   if name in EP_EARLIER_MS else "")
        per = (f"x{calls} per bf16-mode forward" if name in EP_SITES else "")
        if name in EP_UP_CALLS:
            per += (", " if per else "") + \
                f"x{EP_UP_CALLS[name]} per int8-up-mode forward"
        log(f"phase 2: int8_epilogue {name} {tuple(shape)} {in_dtype} {desc}: "
            f"{plan.variant} ct {plan.channel_tile} cluster {plan.cluster} "
            f"threads {plan.threads} staged {plan.staged_rows}/{plan.rows} "
            f"rows smem {plan.shared_bytes} B, "
            f"{plan.blocks(shape[0], shape[3])} blocks, {fits} clusters "
            f"resident; max_abs_err {err:.3g} int8 mismatch share {frac:.2e} "
            f"kernel {t_k:.4f} ms bound {t_b:.4f} ms ({t_k / t_b:.2f}x) "
            f"generic kernel {t_g:.4f} ms{earlier} plain {t_p:.4f} ms; "
            f"eager back-to-back {t_e:.4f} ms ({per})")
        if name in EP_SITES:
            totals["ms"] += calls * t_k
            totals["plain_ms"] += calls * t_p
            totals["generic_ms"] += calls * t_g
            totals["bytes"] += calls * nbytes
            totals["flops"] += calls * flops
        n_up = EP_UP_CALLS.get(name, 0)
        up_totals["ms"] += n_up * t_k
        up_totals["plain_ms"] += n_up * t_p
        up_totals["bytes"] += n_up * nbytes
        up_totals["flops"] += n_up * flops
        del y, res, ins, out_k, out_p

    for name, (shape, in_dtype, quantize, kw) in EP_RAGGED.items():
        desc = _describe(kw, quantize)
        y, res, kw = _site_inputs(gen, shape, in_dtype, kw)
        inv = 25.0 if quantize else None
        plan = _plan_of(y, res, quantize, kw)
        with counted(ep.fused_in_epilogue, 1, f"epilogue {name}"):
            out_k = ep.fused_in_epilogue(y, inv, res, **kw)
        torch.cuda.synchronize()
        err, frac = compare_epilogue(name, out_k,
                                     ep.plain_epilogue(y, inv, res, **kw))
        max_err = max(max_err, err)
        log(f"phase 2: int8_epilogue ragged {name} {tuple(shape)} {in_dtype} "
            f"{desc}: {plan.variant} ct {plan.channel_tile} cluster "
            f"{plan.cluster}; max_abs_err {err:.3g} int8 mismatch share "
            f"{frac:.2e}")
    by_variant = dict(ep.fused_in_epilogue.variant_launches)
    if not by_variant.get("generic"):
        raise AssertionError("no ragged case took the generic kernel")
    sum_earlier = sum(EP_EARLIER_MS[k] * v[-1] for k, v in EP_SITES.items())
    up_bound, _ = bound(up_totals["bytes"], up_totals["flops"])
    log(f"phase 2 ok: int8_epilogue per int8 forward {totals['ms']:.4f} ms; "
        f"generic (earlier) kernel now {totals['generic_ms']:.4f} ms, earlier "
        f"run {sum_earlier:.3f} ms; per int8-up-mode forward "
        f"{up_totals['ms']:.4f} ms (plain {up_totals['plain_ms']:.4f} ms, "
        f"bound {up_bound:.4f} ms); launches by variant {by_variant}")
    totals["up_mode_ms"] = up_totals["ms"]
    totals["up_mode_bound_ms"] = up_bound
    return totals, max_err


def sweep_epilogue(gen, table=None):
    """Time every legal plan of the cluster kernel at every site; append
    all timings to the file ``table`` if given."""
    import itertools

    import torch

    from cycle_depth_estimation_tpu_torch.ops.kernels import int8_epilogue as ep

    for name, (shape, in_dtype, quantize, kw, calls) in {
            **EP_SITES, **EP_UP_SITES}.items():
        y, res, kw = _site_inputs(gen, shape, in_dtype, kw)
        inv = 25.0 if quantize else None
        pad = kw.get("pad", 0) if quantize else 0
        out_p = ep.plain_epilogue(y, inv, res, **kw)
        ins = copies_past_l2(y, res)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (y, res, *out_p) if t is not None)
        t_b, _ = bound(nbytes, EP_FLOPS_PER_ELEM * y.numel())
        chosen = _plan_of(y, res, quantize, kw)
        rows = []
        plans = set()
        for ct, cluster, threads, per_sm in itertools.product(
                (8, 16, 32, 64), ep.legal_clusters(shape[1], pad, "reflect"),
                (256, 512, 1024), (0, 1, 2, 3, 4, 6, 8)):
            if ct <= shape[3] and cluster in (1, 2, 4, 8):
                plans.add(ep.make_plan(shape, y.element_size(), ct, cluster,
                                       threads, per_sm))
        for plan in sorted(plans):

            def run(a, r, plan=plan):
                return ep.launch(a, inv, r, plan=plan, **kw)

            out_k = run(y, res)
            torch.cuda.synchronize()
            compare_epilogue(f"{name} {plan}", out_k, out_p)
            rows.append((device_ms_per_call(run, ins), plan))
        rows.sort(key=lambda r: r[0])
        t_chosen = [t for t, p in rows if p == chosen]
        log(f"sweep {name} {tuple(shape)} {in_dtype} x{calls}: bound "
            f"{t_b:.4f} ms; plan_epilogue picks {chosen} = "
            f"{t_chosen[0] if t_chosen else float('nan'):.4f} ms; "
            f"{len(rows)} plans")
        if table is not None:
            with open(table, "a") as f:
                for t, p in rows:
                    f.write(f"{name} {t:.4f} {t / t_b:.2f} "
                            f"{' '.join(map(str, p))}\n")
        for t, p in rows[:16] + rows[-2:]:
            log(f"sweep   {t:.4f} ms ({t / t_b:.2f}x) {p.variant} ct "
                f"{p.channel_tile} cluster {p.cluster} threads {p.threads} "
                f"staged {p.staged_rows}/{p.rows} rows smem {p.shared_bytes}")
        best = {}
        for t, p in rows:
            best.setdefault((p.variant, p.cluster), (t, p))
        for (variant, cluster), (t, p) in sorted(best.items()):
            log(f"sweep   best {variant} cluster {cluster}: {t:.4f} ms ct "
                f"{p.channel_tile} threads {p.threads}")
        del y, res, ins, out_p


def phase_int8_conv(gen):
    import torch

    from cycle_depth_estimation_tpu_torch.ops.int8_conv import (
        conv2d_int8, plain_conv2d_int8)

    # (input H, Cin, k, Cout, stride, padding) at batch 1: conv_in, down0,
    # a block conv, conv_out — the K and N padding cases included
    for h, cin, k, cout, stride, pad in ((SIZE + 6, 3, 7, NGF, 1, 0),
                                         (SIZE, NGF, 3, 2 * NGF, 2, 1),
                                         (SIZE // 4 + 2, 4 * NGF, 3, 4 * NGF, 1, 0),
                                         (SIZE + 6, NGF, 7, 3, 1, 0)):
        x = torch.randint(-127, 128, (1, h, h, cin), generator=gen,
                          device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen,
                          device="cuda", dtype=torch.int8)
        got = conv2d_int8(x, w, stride, pad)
        want = plain_conv2d_int8(x, w, stride, pad)
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {k}x{k} cin {cin} cout {cout} "
                                 "differs from the fp64 reference")
    log("phase 2b ok: int8 conv (im2col + int8 GEMM) exact against fp64 conv")


def phase_generator(x):
    import torch

    from cycle_depth_estimation_tpu_torch.models.networks import define_G
    from cycle_depth_estimation_tpu_torch.ops import layers
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, plain_instance_norm)

    g = define_G(3, 3, NGF, f"resnet_{N_BLOCKS}blocks",
                 generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        with counted(instance_norm, PER_FORWARD, "fp32 forward"):
            y_k = g(x)
        with mock.patch.object(layers, "instance_norm", plain_instance_norm):
            with counted(instance_norm, 0, "plain fp32 forward"):
                y_p = g(x)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        if not (err <= 1e-3 and torch.isfinite(y_k).all()):
            raise AssertionError(f"fp32 generator: kernel vs plain {err}")
        iters = 5
        with counted(instance_norm, (iters + 3) * PER_FORWARD, "fp32 timing"):
            t = ms_per_call(lambda: g(x), iters=iters)
    ips = BATCH / t * 1e3
    log(f"phase 3 ok: fp32 generator bs{BATCH} {SIZE}^2 kernel vs plain max "
        f"abs {err:.3g}; {t:.2f} ms/forward = {ips:.1f} img/s; "
        f"{PER_FORWARD} instance_norm launches per forward")
    return g, y_k, ips


def phase_bf16(g, x):
    import torch

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm)

    g16 = copy.deepcopy(g).to(torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    with torch.no_grad():
        with counted(instance_norm, PER_FORWARD, "bf16 forward"):
            y = g16(x16)
        torch.cuda.synchronize()
        if y.dtype != torch.bfloat16 or not torch.isfinite(y.float()).all():
            raise AssertionError("bf16 generator output is not finite bf16")
        iters = 10
        with counted(instance_norm, (iters + 3) * PER_FORWARD, "bf16 timing"):
            t = ms_per_call(lambda: g16(x16), iters=iters)
    ips = BATCH / t * 1e3
    log(f"phase 4 ok: bf16 generator bs{BATCH} {SIZE}^2 finite; {t:.2f} "
        f"ms/forward = {ips:.1f} img/s")
    return ips, lambda: g16(x16)


def phase_cli():
    import numpy as np
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.test import main as test_main

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        rng = np.random.RandomState(0)
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
                            ).save(os.path.join(data, f"im{i}.png"))
        web_dir = test_main(["--dataroot", data, "--netG", f"resnet_{N_BLOCKS}blocks",
                             "--results_dir", os.path.join(tmp, "results"),
                             "--name", "smoke", "--device", "cuda"])
        images = sorted(os.listdir(os.path.join(web_dir, "images")))
        if not os.path.exists(os.path.join(web_dir, "index.html")) or \
                len(images) != 8:
            raise AssertionError(f"CLI gallery incomplete: {images}")
    log(f"phase 5 ok: test CLI wrote index.html and {len(images)} images")


def phase_fused_int8(g, x, y_fp32, up_mode="bf16", tag="6"):
    """``calibrate`` (on 4 structured images other than ``x``) →
    ``fused_int8_variables`` → ``fused_int8_apply`` in ``up_mode`` on the
    generator ``g`` (its fp32 output ``y_fp32``)."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import quantization as q
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        fused_in_epilogue, plain_epilogue)

    calib = torch.from_numpy(q.synthetic_calibration_batch(2, 4, SIZE))
    static = q.calibrate(q.Int8ResnetGenerator(N_BLOCKS, up_mode=g.up_mode),
                         q.int8_generator_variables(g), calib)
    fused = q.fused_int8_variables(static)

    def forward():
        return q.fused_int8_apply(fused, x, n_blocks=N_BLOCKS, up_mode=up_mode)

    plain_inputs, site_errs, drift = [], [], []

    def recorded(y, inv, residual=None, **kw):
        plain_inputs.append(y.float())
        return plain_epilogue(y, inv, residual, **kw)

    def checked(y, inv, residual=None, **kw):
        """The kernel, held against the plain version on the inputs the
        kernel path gives each of the 23 sites."""
        out = fused_in_epilogue(y, inv, residual, **kw)
        site_errs.append(compare_epilogue(f"site {len(site_errs)}", out,
                                          plain_epilogue(y, inv, residual, **kw)))
        ref = plain_inputs[len(drift)]
        drift.append(float((y.float() - ref).norm() / ref.norm()))
        return out

    with mock.patch.object(q, "fused_in_epilogue", recorded):
        with counted(fused_in_epilogue, 0, f"plain {up_mode} int8 forward"):
            y_p = forward()
    fused_in_epilogue.variant_launches.clear()
    with counted(fused_in_epilogue, PER_FORWARD, f"{up_mode} int8 forward"):
        with mock.patch.object(q, "fused_in_epilogue", checked):
            y_k = forward()
    torch.cuda.synchronize()
    by_variant = dict(fused_in_epilogue.variant_launches)
    if by_variant.get("generic") or sum(by_variant.values()) != PER_FORWARD:
        raise AssertionError(f"{up_mode} int8 forward: epilogue launches by "
                             f"variant {by_variant}: not all {PER_FORWARD} "
                             "took the cluster kernel")
    del plain_inputs
    if len(site_errs) != PER_FORWARD:
        raise AssertionError(f"{len(site_errs)} epilogue sites checked")
    # End to end the two paths drift apart: a 1-LSB flip at one site moves
    # the next conv's output, which flips more values at the next site. The
    # relative difference of each site's input between the two paths is
    # printed below; hence 0.99 end to end, the same bar as against fp32,
    # while the strict check is the per-site one.
    cos_plain = cosine(y_k, y_p)
    cos_fp32 = cosine(y_k, y_fp32)
    cos_plain_fp32 = cosine(y_p, y_fp32)
    bar = FP32_COSINE_FLOOR.get(up_mode, 0.99)
    if not (cos_plain >= 0.99 and cos_fp32 >= bar):
        raise AssertionError(f"{up_mode} int8: cosine vs plain {cos_plain}, "
                             f"vs fp32 {cos_fp32} (plain path vs fp32 "
                             f"{cos_plain_fp32}, bar {bar})")
    log(f"phase {tag}: {up_mode}: per-site kernel vs plain on the path's own "
        f"inputs: max abs err {max(e for e, _ in site_errs):.3g}, worst int8 "
        f"mismatch share {max(f for _, f in site_errs):.2e} over "
        f"{len(site_errs)} sites")
    log(f"phase {tag}: {up_mode}: relative difference of each site's input, "
        "kernel path vs plain path: " + " ".join(f"{d:.2e}" for d in drift))
    iters = 10
    with counted(fused_in_epilogue, (iters + 3) * PER_FORWARD, "int8 timing"):
        t = ms_per_call(forward, iters=iters)
    ips = BATCH / t * 1e3
    earlier = (f" (before the epilogue's redesign: {INT8_EARLIER_IPS} img/s)"
               if up_mode == "bf16" else "")
    log(f"phase {tag} ok: fused int8 up_mode {up_mode} bs{BATCH} {SIZE}^2 "
        f"end-to-end cosine vs plain path {cos_plain:.6f}, vs its fp32 "
        f"{g.up_mode} generator {cos_fp32:.6f} (plain path "
        f"{cos_plain_fp32:.6f}, bar {bar:.4f}); {t:.2f} ms/forward = "
        f"{ips:.1f} img/s{earlier}; {PER_FORWARD} epilogue launches per "
        f"forward, by variant {by_variant}")
    return ips, forward


def phase_up_modes(g, x, y_fp32):
    """Phase 6 in each all-int8 up mode; 'resize_conv_int8' on a seeded
    resize_conv generator against its own fp32 forward."""
    import torch

    from cycle_depth_estimation_tpu_torch.models.networks import (
        ResnetGenerator)
    from cycle_depth_estimation_tpu_torch.ops.init import init_weights

    rc = init_weights(ResnetGenerator(3, 3, NGF, N_BLOCKS,
                                      up_mode="resize_conv"),
                      generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        y_rc = rc(x)
    ips, fwds = {}, {}
    for mode in UP_MODES:
        gen, ref = (rc, y_rc) if mode == "resize_conv_int8" else (g, y_fp32)
        ips[mode], fwds[mode] = phase_fused_int8(gen, x, ref, mode, "6b")
    log("phase 6b ok: img/s " + ", ".join(f"{m} {v:.1f}"
                                          for m, v in ips.items()))
    return ips, fwds


def phase_profile(forwards):
    """Where one forward's device time goes: busy time by kernel and the
    device's idle share of the forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, fn in forwards.items():
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        if busy <= 0:
            raise AssertionError(f"profile of {name}: no device time recorded")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        log(f"phase 7: {name}: wall {wall:.2f} ms (profiled), device busy "
            f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
        for e in top:
            log(f"phase 7:   {e.self_device_time_total / 1e3 / busy:6.1%} "
                f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
                f"{e.key[:90]}")
    log("phase 7 ok")


def train_config(**kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    return apply_model_defaults(Config(
        model="cycle_gan", batch_size=BATCH, fine_size=SIZE, ngf=NGF, ndf=NDF,
        net_g=f"resnet_{N_BLOCKS}blocks", device="cuda", **kw))


def compare_params(before, kernel_nets, plain_nets, cfg, d_steps=None):
    """Parameters after one step through the kernels against one through
    the plain versions, and the generators' gradients of that step (both
    paths start from the same parameters there). Adam's first step moves a
    parameter by lr·g/(|g| + eps), about sign(g)·lr: where |g| is not far
    above eps = 1e-8, or the two paths' g differ in sign, the rounding
    differences of the two paths move it by up to 2·lr per step. The conv
    biases that an InstanceNorm follows have zero gradient up to rounding
    (``biases_before_norm``) and are counted apart. Raises if any parameter
    is further apart than 2·lr per step or did not move; returns counts."""
    import torch

    from cycle_depth_estimation_tpu_torch.models.networks import (
        biases_before_norm)

    out = dict(total=0, past=0, flipped=0, noise_total=0, noise_past=0,
               worst_within=0.0, max_g_past=0.0, g_rel=0.0, g_rel_by={})
    d_steps = cfg.d_steps_per_g if d_steps is None else d_steps
    for name, net in kernel_nets.items():
        steps = d_steps if name.startswith("D") else 1
        limit = 2 * cfg.lr * steps + 1e-5
        noise = biases_before_norm(net)
        plain = dict(plain_nets[name].named_parameters())
        for key, param in net.named_parameters():
            got, ref = param.detach(), plain[key].detach()
            p0 = before[name][key]
            diff = (got - ref).abs()
            if float(diff.max()) > limit:
                raise AssertionError(f"train step {name}.{key}: kernel vs "
                                     f"plain {float(diff.max())} > {limit}")
            if not bool((got != p0).any()):
                raise AssertionError(f"train step: {name}.{key} did not move")
            past = diff > 1e-5
            if key in noise:
                out["noise_past"] += int(past.sum())
                out["noise_total"] += diff.numel()
                continue
            flip = past & ((got - p0).sign() != (ref - p0).sign())
            out["total"] += diff.numel()
            out["past"] += int(past.sum())
            out["flipped"] += int(flip.sum())
            out["worst_within"] = max(out["worst_within"],
                                      float(torch.where(past, 0, diff).max()))
            if not name.startswith("D"):  # the generator side
                g_k, g_p = param.grad, plain[key].grad
                rel = float((g_k - g_p).norm() / g_p.norm())
                out["g_rel_by"][f"{name}.{key}"] = rel
                out["g_rel"] = max(out["g_rel"], rel)
                if bool(past.any()):
                    out["max_g_past"] = max(out["max_g_past"],
                                            float(g_p[past].abs().max()))
    return out


def plain_instance_norm_fn():
    """``layers.instance_norm`` through the plain versions, forward and
    backward (no kernel launch)."""
    import torch

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        plain_instance_norm, plain_instance_norm_backward)

    class PlainInstanceNorm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, eps):
            ctx.save_for_backward(x)
            ctx.eps = eps
            return plain_instance_norm(x, eps)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensors
            return plain_instance_norm_backward(x, dy, ctx.eps), None

    return lambda x, eps=1e-5: PlainInstanceNorm.apply(x, eps)


def phase_train_step():
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.models import quantization as q
    from cycle_depth_estimation_tpu_torch.ops import layers
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    cfg = train_config()
    model = create_model(cfg)
    batch = {"img_source": torch.from_numpy(
                 q.synthetic_calibration_batch(4, BATCH, SIZE)).cuda(),
             "img_target": torch.from_numpy(
                 q.synthetic_calibration_batch(5, BATCH, SIZE)).cuda()}

    # One step from the same seeded init through the kernels, through the
    # plain versions (twice), and through F.instance_norm (autograd's
    # backward), cuDNN deterministic. The library path measures how far a
    # third correct implementation lands from the plain one, the yardstick
    # for the kernel path's distance; the second plain run measures what is
    # left that no InstanceNorm causes.
    torch.backends.cudnn.deterministic = True
    before = {k: {n: v.clone() for n, v in net.state_dict().items()}
              for k, net in model.init_state().nets.items()}
    plain_in = plain_instance_norm_fn()
    runs = {}
    for path, patch, expect in (
            ("kernel", None, TRAIN_PER_STEP),
            ("plain", plain_in, 0),
            ("library", lambda x, eps=1e-5: F.instance_norm(x, eps=eps), 0),
            ("plain again", plain_in, 0)):
        st = model.init_state()
        with (mock.patch.object(layers, "instance_norm", patch) if patch
              else contextlib.nullcontext()), \
                counted(instance_norm, expect, f"{path} step forward"), \
                counted(instance_norm_backward, expect, f"{path} step backward"):
            st, m = model.train_step(st, batch)
        runs[path] = (st, {k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    state, m_k = runs["kernel"]
    if not all(math.isfinite(v) for st, m in runs.values() for v in m.values()):
        raise AssertionError(f"train step losses not finite: {runs}")
    counts = {k: p.count for k, p in state.pools.items()}
    if set(counts.values()) != {4 * BATCH}:
        raise AssertionError(f"pool counts {counts}, expected {4 * BATCH}")
    cmp, rel = {}, {}
    for path, other in (("kernel", "plain"), ("library", "plain"),
                        ("plain again", "plain"), ("kernel", "library")):
        c = compare_params(before, runs[path][0].nets, runs[other][0].nets,
                           cfg)
        m_o = runs[other][1]
        r = {k: abs(v - m_o[k]) / abs(m_o[k]) for k, v in runs[path][1].items()}
        if other == "plain":
            cmp[path], rel[path] = c, r
        log(f"phase 8: {path} vs {other} step: relative loss diffs "
            + " ".join(f"{k} {v:.1e}" for k, v in r.items())
            + f"; generator gradients: max relative L2 diff "
            f"{c['g_rel']:.2e}; {c['total']} parameters outside the "
            f"pre-norm biases: {c['past']} ({c['past'] / c['total']:.2e}) "
            f"past 1e-5 (all within 2·lr per step; largest generator |g| "
            f"among them {c['max_g_past']:.2e}), of which {c['flipped']} "
            f"({c['flipped'] / c['total']:.2e}) with the update's sign "
            f"flipped; the rest within {c['worst_within']:.2e}; pre-norm "
            f"biases (zero gradient up to rounding): {c['noise_past']} of "
            f"{c['noise_total']} past 1e-5")
    worst_g = sorted(cmp["kernel"]["g_rel_by"].items(), key=lambda kv: -kv[1])
    log("phase 8: largest generator gradient diffs, kernel (library) vs "
        "plain: " + ", ".join(f"{k} {v:.2e} ({cmp['library']['g_rel_by'][k]:.2e})"
                              for k, v in worst_g[:4]))
    log(f"phase 8: losses {m_k}; {TRAIN_PER_STEP} forward and "
        f"{TRAIN_PER_STEP} backward InstanceNorm launches per step; pool "
        f"counts {counts}")
    del runs, st, before

    # steady-state steps, strict fp32 (TF32 off) then cuDNN's TF32 (the
    # torch default the CLI runs with)
    rates = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        model.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counted(instance_norm, TRAIN_STEPS_TIMED * TRAIN_PER_STEP,
                     "timed steps"):
            t = time.perf_counter()
            for _ in range(TRAIN_STEPS_TIMED):
                state, _ = model.train_step(state, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) / TRAIN_STEPS_TIMED
        rates[tf32] = (dt, torch.cuda.max_memory_allocated())
    torch.backends.cudnn.allow_tf32 = False
    (dt, peak), (dt32, _) = rates[False], rates[True]
    log(f"phase 8: train step bs{BATCH} {SIZE}^2 fp32 (TF32 off): "
        f"{dt * 1e3:.1f} ms/step = {1 / dt:.3f} steps/s = {BATCH / dt:.1f} "
        f"img/s; peak memory {peak / 2 ** 30:.2f} GiB; with cuDNN TF32: "
        f"{dt32 * 1e3:.1f} ms/step = {BATCH / dt32:.1f} img/s")

    profile_step("phase 8", model, state, batch, TRAIN_IN_SHAPES)
    # Checked last, so that a failing run still prints every number above.
    # Limits: 1e-4 relative on each loss and on the generator gradients, and
    # on the share of sign-flipped updates; or, where the library path lands
    # further than that from the plain one, no further than twice its
    # distance.
    k, lib = cmp["kernel"], cmp["library"]
    flips = {p: c["flipped"] / c["total"] for p, c in cmp.items()}
    over = [name for name in rel["kernel"]
            if rel["kernel"][name] > max(1e-4, 2 * rel["library"][name])]
    if over or k["g_rel"] > max(1e-4, 2 * lib["g_rel"]) or \
            flips["kernel"] > max(1e-4, 2 * flips["library"]):
        raise AssertionError(
            f"train step, kernel vs plain: losses {over} past their limit; "
            f"gradients {k['g_rel']} (library {lib['g_rel']}); sign-flipped "
            f"share {flips['kernel']} (library {flips['library']})")
    log("phase 8 ok")
    return BATCH / dt


def phase_train_cli():
    """``python -m cycle_depth_estimation_tpu_torch.train`` for one epoch in
    a process of its own, then a resume through the same ``main`` here."""
    import numpy as np
    import torch
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.train import main as train_main

    size = 64
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(1)
        for phase in ("trainA", "trainB", "testA", "testB"):
            os.makedirs(os.path.join(tmp, phase))
            for i in range(4):
                Image.fromarray(rng.randint(0, 256, (80, 80, 3), np.uint8)
                                ).save(os.path.join(tmp, phase, f"im{i}.png"))
        args = ["--dataroot", tmp, "--checkpoints_dir",
                os.path.join(tmp, "ck"), "--name", "smoke", "--model",
                "cycle_gan", "--ngf", str(NGF), "--ndf", str(NDF),
                "--load_size", str(size + 8), "--fine_size",
                str(size), "--batch_size", "2", "--niter", "1",
                "--niter_decay", "0", "--save_epoch_freq", "1",
                "--print_freq", "2", "--display_freq", "4",
                "--device", "cuda"]
        _, t_cli = end_cli(start_cli(TRAIN_CLI, args), "train CLI")
        expr = os.path.join(tmp, "ck", "smoke")
        want = [f"1_net_{n}.pth" for n in ("D_A", "D_B", "G_A", "G_B")]
        want += ["1_train_state.pth", "loss_log.txt", "scalars.jsonl",
                 os.path.join("web", "index.html")]
        missing = [f for f in want if not os.path.exists(os.path.join(expr, f))]
        if missing:
            raise AssertionError(f"train CLI did not write {missing}")
        with open(os.path.join(expr, "loss_log.txt")) as f:
            lines = [ln for ln in f if ln.startswith("(epoch: 1")]
        step = torch.load(os.path.join(expr, "1_train_state.pth"),
                          map_location="cpu", weights_only=True)["step"]
        resumed = train_main(args + ["--continue_train", "--epoch_count", "2",
                                     "--niter", "2"])
        if not (step == 2 and resumed.step == 4 and len(lines) == 2
                and os.path.exists(os.path.join(expr, "2_net_G_A.pth"))):
            raise AssertionError(f"train CLI: steps {step}, {resumed.step}, "
                                 f"loss lines {len(lines)}")
    log(f"phase 9 ok: python -m cycle_depth_estimation_tpu_torch.train at ngf "
        f"{NGF} ndf {NDF} {size}^2 batch 2 ({t_cli:.1f} s, beside phase 12's "
        "CLI) wrote the four "
        "nets, the train state, loss_log.txt, scalars.jsonl and "
        "web/index.html; resumed from them for epoch 2")


def phase_unet_instance_norm(gen):
    """The UNet-256 with InstanceNorm: forward and backward at full width,
    each InstanceNorm call's output and input gradient held against the
    plain versions on the inputs the path gave it; then the 1² plane."""
    import torch

    from cycle_depth_estimation_tpu_torch.models.networks import define_G
    from cycle_depth_estimation_tpu_torch.ops.kernels import (
        instance_norm as kin)

    g = define_G(3, 3, NGF, "unet_256", norm="instance",
                 generator=torch.Generator().manual_seed(1)).cuda().train()
    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=gen, device="cuda")
    w = torch.randn(BATCH, 3, SIZE, SIZE, generator=gen, device="cuda")
    report = {}
    n_in = 2 * (8 - 2) + 1  # down norms of levels 1-6, up norms of 1-7
    with checked_instance_norm(report), \
            counted(kin.instance_norm, n_in, "UNet forward"), \
            counted(kin.instance_norm_backward, n_in, "UNet backward"):
        (g(x) * w).sum().backward()
    torch.cuda.synchronize()
    log_report("phase 10", report)
    sides = sorted({shape[2] for _, shape, _ in report}, reverse=True)
    if len(sides) != 7:  # 128² down to 2²
        raise AssertionError(f"UNet planes {sorted(report)}")
    # a plane of one element: variance 0, output 0, gradient 0 (not a UNet
    # plane at 256²: its innermost level has no norm)
    one = torch.randn(BATCH, 8 * NGF, 1, 1, generator=gen, device="cuda")
    n0, b0 = kin.instance_norm.launches, kin.instance_norm_backward.launches
    y1 = kin.instance_norm(one)
    stats1 = kin.plain_instance_norm_stats(one)
    dx1 = kin.instance_norm_backward(one, torch.ones_like(one), stats=stats1)
    torch.cuda.synchronize()
    kin.instance_norm.launches, kin.instance_norm_backward.launches = n0, b0
    if bool(y1.abs().max() > 0) or bool(dx1.abs().max() > 0):
        raise AssertionError("instance_norm of a 1x1 plane is not 0")
    log(f"phase 10 ok: UNet-256 --norm instance bs{BATCH} {SIZE}^2 forward "
        f"and backward: {n_in} in_fwd and {n_in} in_bwd launches over planes "
        f"{sides[0]}^2 .. {sides[-1]}^2, each held against the plain version "
        f"on its own inputs; the 1^2 plane gives 0")
    del g


def pix2pix_config(**kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    return apply_model_defaults(Config(
        model="pix2pix", batch_size=BATCH, fine_size=SIZE, ngf=NGF, ndf=NDF,
        device="cuda", **kw))


def phase_pix2pix_step():
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.models import quantization as q

    cfg = pix2pix_config()
    if (cfg.net_g, cfg.norm, cfg.no_dropout, cfg.no_lsgan, cfg.pool_size,
            cfg.lambda_l1) != ("unet_256", "batch", False, True, 0, 100.0):
        raise AssertionError(f"pix2pix defaults: {cfg}")
    model = create_model(cfg)
    torch.manual_seed(0)
    state = model.init_state()
    batch = {"A": torch.from_numpy(
                 q.synthetic_calibration_batch(6, BATCH, SIZE)).cuda(),
             "B": torch.from_numpy(
                 q.synthetic_calibration_batch(7, BATCH, SIZE)).cuda()}
    stats0 = {k: {n: b.clone() for n, b in net.named_buffers()}
              for k, net in state.nets.items()}
    l1 = []
    for i in range(5):
        state, m = model.train_step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"pix2pix step {i}: losses {m}")
        l1.append(m["G_L1"])
        if i == 0:
            first = m
            moved = {k: sum(not torch.equal(b, stats0[k][n])
                            for n, b in net.named_buffers()
                            if "running" in n)
                     for k, net in state.nets.items()}
            counts = {k: int(net.state_dict()[next(
                n for n in net.state_dict() if n.endswith("tracked"))])
                for k, net in state.nets.items()}
            want = {k: 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                               for mod in net.modules())
                    for k, net in state.nets.items()}
            if moved != want or counts != {"G": 1, "D": 3}:
                raise AssertionError(f"pix2pix BatchNorm statistics: moved "
                                     f"{moved} of {want}, counts {counts}")
    if not l1[-1] < l1[0]:
        raise AssertionError(f"pix2pix G_L1 on a fixed batch: {l1}")
    log(f"phase 11: pix2pix first step losses {first}; BatchNorm running "
        f"statistics moved {moved} (batch counts {counts}); G_L1 over 5 "
        f"steps on one batch: " + " ".join(f"{v:.4f}" for v in l1))

    rates = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        model.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            state, _ = model.train_step(state, batch)
        torch.cuda.synchronize()
        rates[tf32] = ((time.perf_counter() - t) / TRAIN_STEPS_TIMED,
                       torch.cuda.max_memory_allocated())
    torch.backends.cudnn.allow_tf32 = False
    (dt, peak), (dt32, _) = rates[False], rates[True]
    log(f"phase 11: pix2pix train step bs{BATCH} {SIZE}^2 fp32 (TF32 off): "
        f"{dt * 1e3:.1f} ms/step = {1 / dt:.3f} steps/s = {BATCH / dt:.1f} "
        f"img/s; peak memory {peak / 2 ** 30:.2f} GiB; with cuDNN TF32: "
        f"{dt32 * 1e3:.1f} ms/step = {BATCH / dt32:.1f} img/s")
    profile_step("phase 11", model, state, batch)
    log("phase 11 ok")
    return BATCH / dt


def start_pix2pix_cli():
    """Phase 12's first part: 4 aligned PNGs and ``python -m
    cycle_depth_estimation_tpu_torch.train --model pix2pix`` started in a
    process of its own (``run["cli"]``). It runs beside phase 9, which
    times nothing; the caller ends it before the next phase."""
    import numpy as np
    from PIL import Image

    size = CLI_SIZE
    run = {"dir": tempfile.TemporaryDirectory(), "size": size,
           "net": ["--netG", f"unet_{size}", "--load_size", str(size + 8),
                   "--fine_size", str(size)]}
    tmp = run["dir"].name
    rng = np.random.RandomState(2)
    for phase in ("train", "test"):
        os.makedirs(os.path.join(tmp, phase))
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (size, 2 * size, 3), np.uint8)
                            ).save(os.path.join(tmp, phase, f"ab{i}.png"))
    run["args"] = ["--dataroot", tmp, "--checkpoints_dir",
                   os.path.join(tmp, "ck"), "--name", "p2p", "--model",
                   "pix2pix", "--ngf", str(NGF), "--ndf", str(NDF),
                   *run["net"], "--batch_size", "2", "--niter", "1",
                   "--niter_decay", "0", "--save_epoch_freq", "1",
                   "--print_freq", "2", "--display_freq", "4", "--device",
                   "cuda"]
    run["cli"] = start_cli(TRAIN_CLI, run["args"] + ["--num_threads", "2"])
    return run


def start_pix2pix_resume(run):
    """Phase 12's second part, once the first has ended: the resume for
    epoch 2 over two loader processes with the augmentation on the card,
    again as ``python -m`` in a process of its own (``run["resume"]``), so
    that the loader's worker processes, its forkserver and Python's
    resource tracker end with it and ``end_cli`` can see that they did."""
    expr = os.path.join(run["dir"].name, "ck", "p2p")
    want = ["1_net_G.pth", "1_net_D.pth", "1_train_state.pth",
            "loss_log.txt", os.path.join("web", "index.html")]
    missing = [f for f in want if not os.path.exists(os.path.join(expr, f))]
    if missing:
        raise AssertionError(f"pix2pix train CLI did not write {missing}")
    run["resume"] = start_cli(
        TRAIN_CLI, run["args"] + ["--continue_train", "--epoch_count", "2",
                                  "--niter", "2", "--worker_procs", "2",
                                  "--device_aug"])


def phase_pix2pix_cli(run):
    """Phase 12 after both parts have ended: what the resume wrote, and the
    test CLI on its checkpoint."""
    import torch

    from cycle_depth_estimation_tpu_torch.test import main as test_main

    tmp, size = run["dir"].name, run["size"]
    expr = os.path.join(tmp, "ck", "p2p")
    step = torch.load(os.path.join(expr, "2_train_state.pth"),
                      map_location="cpu", weights_only=True)["step"]
    with open(os.path.join(expr, "loss_log.txt")) as f:
        lines = [ln for ln in f if ln.startswith("(epoch: 2")]
    if step != 4 or not lines:
        raise AssertionError(f"pix2pix resume: step {step}, {len(lines)} "
                             "epoch-2 loss lines")
    web_dir = test_main(["--dataroot", tmp, "--model", "pix2pix",
                         "--ngf", str(NGF), "--ndf", str(NDF), *run["net"],
                         "--checkpoints_dir", os.path.join(tmp, "ck"),
                         "--name", "p2p",
                         "--results_dir", os.path.join(tmp, "results"),
                         "--device", "cuda"])
    images = sorted(os.listdir(os.path.join(web_dir, "images")))
    if len(images) != 12:
        raise AssertionError(f"pix2pix test CLI gallery: {images}")
    run["dir"].cleanup()
    log(f"phase 12 ok: python -m cycle_depth_estimation_tpu_torch.train "
        f"--model pix2pix (unet_{size}, {size}^2 from {size}x{2 * size} AB "
        f"PNGs, batch 2, --num_threads 2) wrote nets, train state, log and "
        f"page ({run['seconds']:.1f} s, beside phase 9); python -m ... "
        f"--continue_train resumed for epoch 2 with --worker_procs 2 "
        f"--device_aug ({run['resume_seconds']:.1f} s, beside phase 10) and "
        f"left no process running; the test CLI --model pix2pix wrote "
        f"{len(images)} images from the checkpoint")


@contextmanager
def checked_instance_norm(report):
    """Hold every InstanceNorm kernel call inside, forward and backward,
    against its plain version on the inputs the path gave it, as it
    happens; ``report[(kind, shape, dtype)]`` gets [calls, largest error]
    (forward: abs; backward: abs over the call's largest plain |dx|, taken
    up to a power of two). Raises past the limits: fp32 1e-4, bf16 2 ulps
    of the plain result, on those scales. A train step's dx is ~1e-6, so
    an absolute limit would hold nothing there; a power of two scales a
    bf16 value and its ulp exactly."""
    import torch

    from cycle_depth_estimation_tpu_torch.ops import layers
    from cycle_depth_estimation_tpu_torch.ops.kernels import (
        instance_norm as kin)

    real_bwd = kin._InstanceNormFn.backward

    def check(kind, shape, got, want, scale=1.0):
        dtype = got.dtype
        got, want = got.detach().float() / scale, want.detach().float() / scale
        err = (got - want).abs()
        if dtype == torch.bfloat16:
            ok = bool((err <= 2 * bf16_ulp(want)).all())
        else:
            ok = float(err.max()) <= 1e-4
        key = (kind, tuple(shape), str(dtype)[6:])
        calls, worst = report.get(key, (0, 0.0))
        report[key] = (calls + 1, max(worst, float(err.max())))
        if not ok:
            raise AssertionError(f"{kind} {tuple(shape)} {dtype}: kernel vs "
                                 f"plain max err {float(err.max())} (scale "
                                 f"{scale})")

    def fwd(v, eps=1e-5):
        y = kin.instance_norm(v, eps)
        check("in_fwd", v.shape, y, kin.plain_instance_norm(v, eps))
        return y

    def bwd(ctx, dy):
        dx, *rest = real_bwd(ctx, dy)
        x, *stats = ctx.saved_tensors
        want = kin.plain_instance_norm_backward(x, dy, ctx.eps,
                                                tuple(stats) or None)
        top = float(want.float().abs().max())
        check("in_bwd", x.shape, dx, want,
              2.0 ** math.ceil(math.log2(top)) if top > 0 else 1.0)
        return (dx, *rest)

    with mock.patch.object(layers, "instance_norm", fwd), \
            mock.patch.object(kin._InstanceNormFn, "backward",
                              staticmethod(bwd)):
        yield report


def log_report(tag, report):
    for (kind, shape, dt), (calls, worst) in sorted(report.items()):
        log(f"{tag}:   {kind} {shape} {dt}: {calls} calls, kernel vs plain "
            f"max err {worst:.3g}")


def timed_steps(model, state, batch, n=TRAIN_STEPS_TIMED):
    """One warm-up step, then ``n`` timed: (state, s/step, peak bytes)."""
    import torch

    state, _ = model.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(n):
        state, _ = model.train_step(state, batch)
    torch.cuda.synchronize()
    return (state, (time.perf_counter() - t) / n,
            torch.cuda.max_memory_allocated())


def profile_step(tag, model, state, batch, shapes=None):
    """One profiled step: idle share, the top kernels, and, given
    ``shapes`` {plane: calls}, the InstanceNorm kernels' ms beside their
    bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        raise AssertionError(f"profile of the {tag} step: no device time")
    log(f"{tag}: profiled step: wall {wall:.1f} ms, device busy {busy:.1f} "
        f"ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"{tag}:   {e.self_device_time_total / 1e3 / busy:6.1%} "
            f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    if not shapes:
        return
    elems = sum(c * math.prod(sh) for sh, c in shapes.items())
    stats = 2 * 4 * sum(c * sh[0] * sh[1] for sh, c in shapes.items())
    for kname, nbytes, flops in (
            ("in_fwd", 2 * 4 * elems + stats, IN_FLOPS_PER_ELEM * elems),
            ("in_bwd", 3 * 4 * elems + stats, IN_BWD_FLOPS_PER_ELEM * elems)):
        ms = sum(e.self_device_time_total for e in kernels
                 if kname in e.key) / 1e3
        calls = sum(e.count for e in kernels if kname in e.key)
        t_b, _ = bound(nbytes, flops)
        log(f"{tag}:   {kname}: {ms:.3f} ms in {calls} calls per step "
            f"({ms / busy:.1%} of busy), bound {t_b:.3f} ms "
            f"({ms / t_b:.2f}x)")


def rel_loss_diffs(m, ref):
    return {k: abs(v - ref[k]) / max(abs(ref[k]), 1e-12) for k, v in m.items()}


BF16_LOSS_REL = 5e-2  # a bf16 step's losses against the fp32 step's


def phase_bf16_training():
    """Phase 13: one seeded bf16 step of CycleGAN and of pix2pix at full
    width against the fp32 step from the same init, each InstanceNorm call
    of both first steps held against its plain version on the step's own
    inputs; the InstanceNorm kernels on bf16 at their counts and planes;
    img/s and peak memory beside fp32."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.models import quantization as q
    from cycle_depth_estimation_tpu_torch.ops.kernels import (
        instance_norm as kin)

    img = lambda seed: torch.from_numpy(  # noqa: E731
        q.synthetic_calibration_batch(seed, BATCH, SIZE)).cuda()
    models = (("cycle_gan", train_config, TRAIN_PER_STEP,
               {"img_source": img(4), "img_target": img(5)}),
              ("pix2pix", pix2pix_config, 0, {"A": img(6), "B": img(7)}))
    report = {}
    summary = {}
    for name, config, n_in, batch in models:
        runs = {}
        for dtype in ("float32", "bfloat16"):
            model = create_model(config(dtype=dtype))
            torch.manual_seed(0)
            state = model.init_state()
            with checked_instance_norm(report), \
                    counted(kin.instance_norm, n_in, f"{name} {dtype} step"), \
                    counted(kin.instance_norm_backward, n_in,
                            f"{name} {dtype} step backward"):
                state, m = model.train_step(state, batch)
            m = {k: float(v) for k, v in m.items()}
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{name} {dtype} step losses: {m}")
            state, dt, peak = timed_steps(model, state, batch)
            runs[dtype] = (m, dt, peak)
            del model, state
            torch.cuda.empty_cache()
        (m32, dt32, pk32), (m16, dt16, pk16) = runs["float32"], runs["bfloat16"]
        rel = rel_loss_diffs(m16, m32)
        log(f"phase 13: {name} bs{BATCH} {SIZE}^2: first-step losses bf16 "
            f"{m16}; relative to fp32: "
            + " ".join(f"{k} {v:.1e}" for k, v in rel.items()))
        log(f"phase 13: {name}: bf16 {dt16 * 1e3:.1f} ms/step = "
            f"{BATCH / dt16:.1f} img/s, peak {pk16 / 2 ** 30:.2f} GiB; fp32 "
            f"(TF32 off) {dt32 * 1e3:.1f} ms/step = {BATCH / dt32:.1f} img/s, "
            f"peak {pk32 / 2 ** 30:.2f} GiB")
        over = {k: v for k, v in rel.items() if v > BF16_LOSS_REL}
        if over:
            raise AssertionError(f"{name} bf16 vs fp32 losses past "
                                 f"{BF16_LOSS_REL}: {over}")
        summary[name] = BATCH / dt16
    want = {(kind, shape, dt) for kind in ("in_fwd", "in_bwd")
            for shape in TRAIN_IN_SHAPES for dt in ("float32", "bfloat16")}
    if set(report) != want:
        raise AssertionError(f"InstanceNorm calls of the steps: "
                             f"{sorted(report)}")
    log_report("phase 13", report)
    log(f"phase 13 ok: bf16 training: CycleGAN {TRAIN_PER_STEP} in_fwd and "
        f"in_bwd launches on bf16 a step, pix2pix (BatchNorm) none; img/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in summary.items()))
    return summary


def phase_remat():
    """Phase 14: the fp32 CycleGAN step with and without --remat from one
    seed, cuDNN deterministic: losses and parameters; peak memory, the
    launch counts, and the step time of each."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.models import quantization as q
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    batch = {"img_source": torch.from_numpy(
                 q.synthetic_calibration_batch(4, BATCH, SIZE)).cuda(),
             "img_target": torch.from_numpy(
                 q.synthetic_calibration_batch(5, BATCH, SIZE)).cuda()}
    torch.backends.cudnn.deterministic = True
    runs, before = {}, None
    for remat in (False, True):
        cfg = train_config(remat=remat)
        model = create_model(cfg)
        torch.manual_seed(0)
        state = model.init_state()
        if before is None:
            before = {k: {n: v.clone() for n, v in net.state_dict().items()}
                      for k, net in state.nets.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counted(instance_norm,
                     REMAT_PER_STEP if remat else TRAIN_PER_STEP,
                     f"remat={remat} step"), \
                counted(instance_norm_backward, TRAIN_PER_STEP,
                        f"remat={remat} step backward"):
            state, m = model.train_step(state, batch)
        torch.cuda.synchronize()
        runs[remat] = (model, state, {k: float(v) for k, v in m.items()},
                       torch.cuda.max_memory_allocated())
    torch.backends.cudnn.deterministic = False
    (_, s0, m0, pk0), (_, s1, m1, pk1) = runs[False], runs[True]
    c = compare_params(before, s1.nets, s0.nets, cfg)
    same = all(torch.equal(a, s0.nets[k].state_dict()[n])
               for k, net in s1.nets.items()
               for n, a in net.state_dict().items())
    rel = rel_loss_diffs(m1, m0)
    log(f"phase 14: --remat vs plain step: relative loss diffs "
        + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
        + f"; parameters {'bitwise equal' if same else 'not bitwise equal'}"
        f", {c['past']} of {c['total']} past 1e-5, {c['flipped']} "
        f"sign-flipped; generator gradients max relative L2 diff "
        f"{c['g_rel']:.2e}")
    times = {}
    for remat in (False, True):
        model, state = runs[remat][:2]
        times[remat] = timed_steps(model, state, batch, 2)[1:]
    del runs, s0, s1, before
    torch.cuda.empty_cache()
    log(f"phase 14: peak memory of the first step: plain {pk0 / 2 ** 30:.2f} "
        f"GiB, --remat {pk1 / 2 ** 30:.2f} GiB; steady step (TF32 off) plain "
        f"{times[False][0] * 1e3:.1f} ms (peak {times[False][1] / 2 ** 30:.2f}"
        f" GiB), --remat {times[True][0] * 1e3:.1f} ms (peak "
        f"{times[True][1] / 2 ** 30:.2f} GiB); in_fwd launches a step "
        f"{TRAIN_PER_STEP} -> {REMAT_PER_STEP}, in_bwd {TRAIN_PER_STEP}")
    # the recompute runs the same kernels on the same inputs: the two steps
    # agree to rounding of the gradient sums' order (backward adds a
    # generator's three applications in another order), held to 1e-6
    # relative in the losses, 1e-5 in the generator gradients, 1e-4 of the
    # parameters sign-flipped. With cuDNN deterministic the gradients are
    # 5.11e-6 apart in every run on the H100, the same to three digits
    if max(rel.values()) > 1e-6 or c["g_rel"] > 1e-5 or \
            c["flipped"] > 1e-4 * c["total"]:
        raise AssertionError(f"--remat step differs: losses {rel}, "
                             f"gradients {c['g_rel']}, flips {c['flipped']}")
    log("phase 14 ok")


def seg_config(**kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    return apply_model_defaults(Config(
        model="seg_cycle", batch_size=BATCH, ngf=NGF, ndf=NDF,
        net_g=f"resnet_{N_BLOCKS}blocks", device="cuda", **kw))


def domain_batch(gen):
    """A seeded batch at the synthia size: images in [-1, 1], SYNTHIA (22)
    and Cityscapes (28) train ids with a block of 255 each."""
    import torch

    def img():
        return torch.rand(BATCH, 3, SEG_H, SEG_W, generator=gen,
                          device="cuda") * 2 - 1

    def lab(n):
        t = torch.randint(0, n, (BATCH, SEG_H, SEG_W), generator=gen,
                          device="cuda")
        t[:, :16, :32] = 255
        return t

    return {"img_source": img(), "img_target": img(),
            "lab_source": lab(22), "lab_target": lab(28)}


def phase_seg_cycle(gen, cli):
    """Phase 15: SegCycle at full width (the JAX defaults), batch 8,
    192×640, fp32 with TF32 off: both InstanceNorm kernels against their
    plain versions on the step's own inputs at every plane; one step
    through the kernels against one through the plain versions and one
    through F.instance_norm; launches, steps/s, img/s, peak memory, a
    profiled step; then one bf16 step. ``cli`` (the SegCycle train CLI)
    runs beside the untimed first part and is ended before the timing."""
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops import layers
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    cfg = seg_config()
    if (cfg.dataset_mode, cfg.norm, cfg.no_dropout, cfg.net_d) != (
            "synthia", "instance", True, "basic"):
        raise AssertionError(f"seg_cycle defaults: {cfg}")
    model = create_model(cfg)
    batch = domain_batch(gen)
    report = {}
    torch.backends.cudnn.deterministic = True
    st = model.init_state()
    before = {k: {n: v.clone() for n, v in net.state_dict().items()}
              for k, net in st.nets.items()}
    with checked_instance_norm(report), \
            counted(instance_norm, SEG_PER_STEP, "SegCycle step"), \
            counted(instance_norm_backward, SEG_PER_STEP,
                    "SegCycle step backward"):
        st, m = model.train_step(st, batch)
    runs = {"kernel": (st, {k: float(v) for k, v in m.items()})}
    planes = {shape for (_, shape, _) in report}
    if planes != set(SEG_IN_SHAPES):
        raise AssertionError(f"SegCycle planes {sorted(planes)}")
    log_report("phase 15", report)
    for path, patch in (("plain", plain_instance_norm_fn()),
                        ("library", lambda x, eps=1e-5: F.instance_norm(
                            x, eps=eps))):
        st = model.init_state()
        with mock.patch.object(layers, "instance_norm", patch), \
                counted(instance_norm, 0, f"{path} step"):
            st, m = model.train_step(st, batch)
        runs[path] = (st, {k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    m_k = runs["kernel"][1]
    if not all(math.isfinite(v) for _, m in runs.values() for v in m.values()):
        raise AssertionError(f"SegCycle losses not finite: {runs}")
    cmp, rel = {}, {}
    for path in ("kernel", "library"):
        c = compare_params(before, runs[path][0].nets, runs["plain"][0].nets,
                           cfg, d_steps=1)
        cmp[path], rel[path] = c, rel_loss_diffs(runs[path][1],
                                                 runs["plain"][1])
        log(f"phase 15: {path} vs plain step: relative loss diffs "
            + " ".join(f"{k} {v:.1e}" for k, v in rel[path].items())
            + f"; generator-side gradients max relative L2 diff "
            f"{c['g_rel']:.2e}; {c['flipped']} of {c['total']} parameters "
            f"({c['flipped'] / c['total']:.2e}) sign-flipped")
    log(f"phase 15: losses {m_k}; {SEG_PER_STEP} in_fwd and {SEG_PER_STEP} "
        f"in_bwd launches a step")
    del runs, st, before
    torch.cuda.empty_cache()
    cli["seconds"] = end_cli(cli.pop("cli"), "SegCycle train CLI")[1]

    torch.manual_seed(0)
    state = model.init_state()
    state, dt, peak = timed_steps(model, state, batch)
    log(f"phase 15: SegCycle train step bs{BATCH} {SEG_H}x{SEG_W} fp32 (TF32 "
        f"off): {dt * 1e3:.1f} ms/step = {1 / dt:.3f} steps/s = "
        f"{BATCH / dt:.1f} img/s; peak memory {peak / 2 ** 30:.2f} GiB")
    profile_step("phase 15", model, state, batch, SEG_IN_SHAPES)
    del model, state
    torch.cuda.empty_cache()
    model16 = create_model(seg_config(dtype="bfloat16"))
    state16 = model16.init_state()
    report16 = {}
    with checked_instance_norm(report16):
        state16, m16 = model16.train_step(state16, batch)
    m16 = {k: float(v) for k, v in m16.items()}
    if not all(math.isfinite(v) for v in m16.values()):
        raise AssertionError(f"SegCycle bf16 losses: {m16}")
    if report16.keys() != {(k, sh, "bfloat16") for k, sh, _ in report}:
        raise AssertionError(f"SegCycle bf16 planes {sorted(report16)}")
    log_report("phase 15 bf16", report16)
    _, dt16, peak16 = timed_steps(model16, state16, batch, 2)
    del model16, state16
    torch.cuda.empty_cache()
    log(f"phase 15: SegCycle bf16: first-step losses {m16}; "
        f"{dt16 * 1e3:.1f} ms/step = {BATCH / dt16:.1f} img/s, peak "
        f"{peak16 / 2 ** 30:.2f} GiB")
    # the yardstick of phase 8: 1e-4, or twice the library path's distance
    k, lib = cmp["kernel"], cmp["library"]
    flips = {p: c["flipped"] / c["total"] for p, c in cmp.items()}
    over = [n for n in rel["kernel"]
            if rel["kernel"][n] > max(1e-4, 2 * rel["library"][n])]
    if over or k["g_rel"] > max(1e-4, 2 * lib["g_rel"]) or \
            flips["kernel"] > max(1e-4, 2 * flips["library"]):
        raise AssertionError(
            f"SegCycle step, kernel vs plain: losses {over} past their "
            f"limit; gradients {k['g_rel']} (library {lib['g_rel']}); "
            f"sign-flipped share {flips['kernel']} (library "
            f"{flips['library']})")
    log("phase 15 ok")
    return BATCH / dt, BATCH / dt16


def write_domain_files(root, n=4, size=(200, 60), seed=8):
    """SYNTHIA-like files: RGB PNGs, 8-bit label PNGs (SYNTHIA ids 0-22,
    Cityscapes ids 0-33) and 16-bit depth PNGs, listed in .txt files.
    Returns the train CLI's ``--*_file_train`` arguments."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = size
    args = []
    for name, kind in (("img_source", "rgb"), ("lab_source", 23),
                       ("depth_source", "depth"), ("img_target", "rgb"),
                       ("lab_target", 34)):
        os.makedirs(os.path.join(root, name))
        paths = []
        for i in range(n):
            if kind == "rgb":
                arr = rng.randint(0, 256, (h, w, 3), np.uint8)
            elif kind == "depth":
                arr = rng.randint(0, 12000, (h, w)).astype(np.uint16)
            else:
                arr = rng.randint(0, kind, (h, w)).astype(np.uint8)
            paths.append(os.path.join(root, name, f"{i}.png"))
            Image.fromarray(arr).save(paths[-1])
        listing = os.path.join(root, f"{name}.txt")
        with open(listing, "w") as f:
            f.write("\n".join(paths) + "\n")
        args += [f"--{name}_file_train", listing]
    return args


SEG_NETS = ("G_A", "G_B", "D_A", "D_B", "encoderA", "encoderB", "decoderA",
            "decoderB")


def start_seg_cycle_cli():
    """Phase 16's CLI: ``python -m ...train --model seg_cycle`` on
    synthesized SYNTHIA-like files at a small width, in a process of its
    own (``run["cli"]``); the caller ends it."""
    run = {"dir": tempfile.TemporaryDirectory()}
    tmp = run["dir"].name
    run["args"] = [
        "--model", "seg_cycle", "--dataset_mode", "synthia",
        *write_domain_files(tmp), "--checkpoints_dir",
        os.path.join(tmp, "ck"), "--name", "sc", "--ngf", "16", "--ndf",
        "16", "--netG", "resnet_3blocks", "--fine_size", "96",
        "--batch_size", "2", "--pool_size", "2", "--niter", "1",
        "--niter_decay", "0", "--save_epoch_freq", "1", "--print_freq", "2",
        "--display_freq", "2", "--num_threads", "2", "--device", "cuda"]
    run["cli"] = start_cli(TRAIN_CLI, run["args"])
    return run


def start_seg_cycle_resume(run):
    """After the first run: what it wrote, then its resume for epoch 2 in a
    process of its own (``run["resume"]``)."""
    import numpy as np
    from PIL import Image

    expr = os.path.join(run["dir"].name, "ck", "sc")
    want = [f"1_net_{n}.pth" for n in SEG_NETS] + [
        "1_train_state.pth", "loss_log.txt", os.path.join("web", "index.html")]
    missing = [f for f in want if not os.path.exists(os.path.join(expr, f))]
    if missing:
        raise AssertionError(f"SegCycle train CLI did not write {missing}")
    colours = {}
    for name in ("lab_A", "lab_B", "segAreal", "segBfake"):
        im = np.asarray(Image.open(os.path.join(
            expr, "web", "images", f"epoch001_{name}.png")))
        colours[name] = len(np.unique(im.reshape(-1, 3), axis=0))
        if im.shape != (96, 320, 3):
            raise AssertionError(f"label visual {name}: {im.shape}")
    if min(colours[k] for k in ("lab_A", "lab_B")) < 10:
        raise AssertionError(f"label visuals not colorized: {colours}")
    run["colours"] = colours
    run["resume"] = start_cli(
        TRAIN_CLI, run["args"] + ["--continue_train", "--epoch_count", "2",
                                  "--niter", "2"])


def phase_t2net(gen, cli):
    """Phase 16: one T2Net step at full width (192×640, batch 8, the
    9-block translator at ngf 64, --norm instance) with both InstanceNorm
    kernels held against their plain versions at every plane, the task
    net's 1536-channel 12×40 ones among them; the frozen translator; img/s;
    then the SegCycle CLI's resume, which ran beside the checks."""
    import torch

    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)
    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    cfg = apply_model_defaults(Config(
        model="seg", batch_size=BATCH, ngf=NGF,
        net_g=f"resnet_{N_BLOCKS}blocks", device="cuda"))
    if (cfg.norm, cfg.dataset_mode) != ("instance", "synthia"):
        raise AssertionError(f"seg defaults: {cfg}")
    model = create_model(cfg)
    torch.manual_seed(0)
    state = model.init_state()
    s2t0 = {k: v.clone() for k, v in state.nets["s2t"].state_dict().items()}
    batch = domain_batch(gen)
    report = {}
    with checked_instance_norm(report), \
            counted(instance_norm, T2NET_FWD, "T2Net step"), \
            counted(instance_norm_backward, T2NET_BWD, "T2Net step backward"):
        state, m = model.train_step(state, batch)
    m = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"T2Net losses: {m}")
    wide = (BATCH, 24 * NGF, SEG_H // 16, SEG_W // 16)
    got = (report.get(("in_fwd", wide, "float32"), (0,))[0],
           report.get(("in_bwd", wide, "float32"), (0,))[0])
    if got != (6, 6):
        raise AssertionError(f"T2Net {wide} planes: {got} calls, want 6, 6")
    if not all(torch.equal(v, s2t0[k])
               for k, v in state.nets["s2t"].state_dict().items()):
        raise AssertionError("T2Net: the frozen translator moved")
    log_report("phase 16", report)
    log(f"phase 16: T2Net first-step metrics {m}; {T2NET_FWD} in_fwd and "
        f"{T2NET_BWD} in_bwd launches a step")
    cli["resume_seconds"] = end_cli(cli.pop("resume"),
                                    "SegCycle train CLI resume")[1]
    expr = os.path.join(cli["dir"].name, "ck", "sc")
    step = torch.load(os.path.join(expr, "2_train_state.pth"),
                      map_location="cpu", weights_only=True)["step"]
    if step != 4 or not os.path.exists(os.path.join(expr,
                                                    "2_net_decoderB.pth")):
        raise AssertionError(f"SegCycle resume: step {step}")
    cli["dir"].cleanup()
    state, dt, peak = timed_steps(model, state, batch)
    log(f"phase 16: T2Net train step bs{BATCH} {SEG_H}x{SEG_W} fp32 (TF32 "
        f"off): {dt * 1e3:.1f} ms/step = {BATCH / dt:.1f} img/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log(f"phase 16 ok: python -m cycle_depth_estimation_tpu_torch.train "
        f"--model seg_cycle --dataset_mode synthia (ngf 16, 96x320 from "
        f"SYNTHIA-like PNGs, batch 2) wrote the {len(SEG_NETS)} nets, the "
        f"train state and colorized label visuals ({cli['colours']} colours) "
        f"in {cli['seconds']:.1f} s, beside phase 15; its resume ran epoch 2 "
        f"({cli['resume_seconds']:.1f} s, beside phase 16's checks) and left "
        f"no process running")
    del model, state
    torch.cuda.empty_cache()
    return BATCH / dt

# S2D at the ``try`` loader's size and the JAX package's full width
# (DenseNet growth 32, blocks (6, 12, 32, 32), mid_nc 1024, g1_blocks 3)
S2D_H, S2D_W = 192, 576
S2D_WIDTHS = {}               # config overrides; empty: the full width
S2D_BATCHES = (1, 8)
S2D_NETS = ("G_1", "G_2", "R_D", "FD1", "FD2", "FD3")
S2D_LR_DIVISOR = {"G_1": 5, "G_2": 3, "R_D": 2, "FD1": 4, "FD2": 4, "FD3": 4}
S2D_CPU_LOSS_REL = 1e-3       # the card's first step against the CPU's


def s2d_config(**kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    return apply_model_defaults(Config(**{"model": "S2D", "device": "cuda",
                                          **S2D_WIDTHS, **kw}))


def s2d_batch(n, seed=11, size=None):
    """A seeded ``try`` batch on the CPU at ``size`` (H, W; default S2D's):
    images in [-1, 1], 28-class labels with a band of sky (class 17) in the
    synthetic ones, depth in [-1, 1], ±1 bands and 0/1 label-edge maps (1
    on a tenth of the pixels; drawn last, so the rest is what it was
    without them)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h, w = size or (S2D_H, S2D_W)
    seg = torch.randint(0, 28, (n, h, w), generator=g)
    seg[:, :h // 5] = 17
    return {"img_syn": torch.rand(n, 3, h, w, generator=g) * 2 - 1,
            "img_real": torch.rand(n, 3, h, w, generator=g) * 2 - 1,
            "seg_l_syn": seg,
            "seg_l_real": torch.randint(0, 28, (n, h, w), generator=g),
            "dep_l_syn": torch.rand(n, 1, h, w, generator=g) * 2 - 1,
            "depth_l_s": torch.randn(n, 4, h, w, generator=g).sign(),
            **{f"seg_e_{d}": (torch.rand(n, 1, h, w, generator=g) > 0.9)
               .float() for d in ("syn", "real")}}


def on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def s2d_params_close(got, want, net_lr):
    """The three checks of the JAX tests' ``_assert_params_close`` on one
    net's parameters ({key: CPU tensor} each): every leaf's max difference
    ≤ 3·lr; over the net, the share past lr ≤ 3e-3 and the share past 1e-5
    ≤ 8 % (as ``tests/test_torch_port_s2d_step.py`` applies them). Returns
    (ok, numbers)."""
    import torch

    worst, past_lr, past_1e5, n = 0.0, 0, 0, 0
    for key, a in got.items():
        d = (a.double() - want[key].double()).abs()
        worst = max(worst, float(d.max()) / net_lr)
        past_lr += int((d > net_lr).sum())
        past_1e5 += int((d > 1e-5).sum())
        n += d.numel()
    nums = {"max_over_lr": worst, "share_past_lr": past_lr / n,
            "share_past_1e-5": past_1e5 / n}
    return (worst <= 3.0 and nums["share_past_lr"] <= 3e-3
            and nums["share_past_1e-5"] <= 0.08), nums


S2D_UPDATES = {"g2": ("G_2",), "g1": ("G_1",), "rd_real": ("R_D",),
               "rd_syn": ("R_D",), "fd": ("FD1", "FD2", "FD3")}


def s2d_params(state):
    return {k: {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
            for k, net in state.nets.items()}


def copied(v, device):
    """``v``'s tensors (in dicts, lists and tuples) copied to ``device``;
    anything else as it is."""
    import torch

    if torch.is_tensor(v):
        return v.detach().to(device, copy=True)
    if isinstance(v, dict):
        return {k: copied(x, device) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [copied(x, device) for x in v]
    return v


def s2d_snapshot(state, ctx, device="cpu"):
    """The nets' and optimizers' state dicts and the step context (carried
    tensors, metrics), copied to ``device``."""
    return ({k: copy.deepcopy(n.state_dict()) for k, n in state.nets.items()},
            {k: copy.deepcopy(o.state_dict())
             for k, o in state.optimizers.items()}, copied(ctx, device))


def s2d_flip_shares(p0, a, b, names=S2D_NETS):
    """Per net: the share of parameters whose first update has another sign
    in ``a`` than in ``b`` (both from ``p0``)."""
    out = {}
    for name in names:
        n = sum(v.numel() for v in p0[name].values())
        out[name] = sum(int((a[name][k] - v).sign().ne(
            (b[name][k] - v).sign()).sum()) for k, v in p0[name].items()) / n
    return out


def phase_s2d_card_vs_cpu():
    """Phase 17b: the first full-width S2D step (batch 1) on the card and on
    the CPU (oneDNN off) from one init and batch, at adam_eps 1e-3: the
    whole step's losses within 1e-3 relative, each net's share of first
    updates whose sign differs reported; then each phase again on the card
    from the CPU's state and carried tensors before it: its losses within
    1e-3 and the parameters of the net it updates by the three checks.
    (Over the whole step the parameters are reported, not held: from one
    state, fp32 puts the G_1 gradient of the g1 phase 2.5 % (card) and 1.9
    % (CPU) from a float64 one in L2, and G_2's rounding before it moves
    that further.)"""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    batch = s2d_batch(1)
    threads = torch.get_num_threads()
    eps = 1e-3
    t = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        cpu_model = create_model(s2d_config(device="cpu", adam_eps=eps))
        cpu_state = cpu_model.init_state()
        p0 = s2d_params(cpu_state)
        ctx = cpu_model._ctx(batch)
        snaps = []
        for _, phase in cpu_model.PHASES:
            snaps.append(s2d_snapshot(cpu_state, ctx))
            phase(cpu_model, cpu_state, ctx)
        snaps.append(s2d_snapshot(cpu_state, ctx))
    m_cpu = {k: float(v) for k, v in ctx["metrics"].items()}
    cpu_after = s2d_params(cpu_state)
    del cpu_model, cpu_state, ctx
    cpu_s = time.perf_counter() - t
    model = create_model(s2d_config(adam_eps=eps))
    state = model.init_state()
    state, m = model.train_step(state, on(batch, "cuda"))
    m_card = {k: float(v) for k, v in m.items()}
    card_after = s2d_params(state)
    flips = s2d_flip_shares(p0, card_after, cpu_after)
    rel = rel_loss_diffs(m_card, m_cpu)
    log(f"phase 17b: adam_eps {eps:g}: whole step, card vs CPU ({threads}"
        f" threads, {cpu_s:.1f} s) first-step losses, relative: "
        + " ".join(f"{k} {v:.1e}" for k, v in rel.items()))
    if not all(math.isfinite(v) for v in (*m_card.values(),
                                          *m_cpu.values())):
        raise AssertionError(f"S2D losses: card {m_card}, CPU {m_cpu}")
    losses = [k for k in m_card if not k.startswith("acc")]
    bad = {k: rel[k] for k in losses if rel[k] > S2D_CPU_LOSS_REL}
    for name in S2D_NETS:
        nums = s2d_params_close(card_after[name], cpu_after[name],
                                model.cfg.lr / S2D_LR_DIVISOR[name])[1]
        log(f"phase 17b:   whole step {name}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in nums.items())
            + f"; sign-flipped updates {flips[name]:.2e}")
    for i, (pname, phase) in enumerate(model.PHASES):
        (nets, opts, pre), (nets_after, _, post) = snaps[i], snaps[i + 1]
        for k, net in state.nets.items():
            net.load_state_dict(nets[k])
            state.optimizers[k].load_state_dict(opts[k])
        cctx = s2d_snapshot(state, pre, "cuda")[2]
        phase(model, state, cctx)
        got = {k: float(v) for k, v in cctx["metrics"].items()
               if k not in pre["metrics"]}
        prel = rel_loss_diffs(got, {k: float(post["metrics"][k])
                                    for k in got})
        bad.update({f"{pname}:{k}": v for k, v in prel.items()
                    if not k.startswith("acc") and v > S2D_CPU_LOSS_REL})
        after = s2d_params(state)
        for name in S2D_UPDATES[pname]:
            ok, nums = s2d_params_close(
                after[name], {n: nets_after[name][n] for n in after[name]},
                model.cfg.lr / S2D_LR_DIVISOR[name])
            log(f"phase 17b:   phase {pname} from the CPU's input, "
                f"{name}: losses " + " ".join(
                    f"{k} {v:.1e}" for k, v in prel.items()) + "; "
                + ", ".join(f"{k} {v:.3g}" for k, v in nums.items()))
            if not ok:
                bad[f"{pname}:{name}"] = nums
    del model, state
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"S2D card vs CPU at adam_eps 1e-3: {bad}")
    return flips


def phase_s2d_compare(batch):
    """Phases 17c and 17d at batch 8, from one init, cuDNN deterministic:
    the fp32 step with and without --remat (losses within 1e-6 relative,
    every BatchNorm's batch count equal — each moved once — and the running
    statistics within 1e-4 relative plus 1e-5; the peak memory of each),
    and the bf16 step against the fp32 one (losses within 5e-2, all
    finite)."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    torch.backends.cudnn.deterministic = True
    runs = {}
    for tag, kw in (("plain", {}), ("remat", {"remat": True}),
                    ("bf16", {"dtype": "bfloat16"})):
        model = create_model(s2d_config(**kw))
        state = model.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = model.train_step(state, batch)
        torch.cuda.synchronize()
        stats = {f"{k}.{n}": b.detach().cpu().clone()
                 for k, net in state.nets.items()
                 for n, b in net.named_buffers()}
        runs[tag] = ({k: float(v) for k, v in m.items()}, stats,
                     torch.cuda.max_memory_allocated())
        del model, state
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (m0, st0, pk0), (m1, st1, pk1), (m16, _, pk16) = (
        runs["plain"], runs["remat"], runs["bf16"])
    rel_remat, rel_bf16 = rel_loss_diffs(m1, m0), rel_loss_diffs(m16, m0)
    # the batch counts say how often each BatchNorm moved: equal, or the
    # recompute moved one again; the statistics themselves follow the
    # parameters, which the recompute's gradient sums round otherwise
    counts_equal = all(torch.equal(st1[k], v) for k, v in st0.items()
                       if k.endswith("num_batches_tracked"))
    stats_diff = max(float((st1[k].double() - v.double()).abs().max())
                     for k, v in st0.items())
    stats_close = all(torch.allclose(st1[k], v, rtol=1e-4, atol=1e-5)
                      for k, v in st0.items())
    log(f"phase 17d: --remat vs plain, bs{batch['img_syn'].shape[0]}: "
        "relative loss diffs " + " ".join(f"{k} {v:.1e}"
                                          for k, v in rel_remat.items())
        + f"; BatchNorm batch counts {'equal' if counts_equal else 'DIFFER'}"
        f", running statistics max diff {stats_diff:.2e}; first-step peak "
        f"memory plain {pk0 / 2 ** 30:.2f} GiB, --remat {pk1 / 2 ** 30:.2f} "
        f"GiB")
    log(f"phase 17c: bf16 vs fp32: first-step losses bf16 {m16}; relative: "
        + " ".join(f"{k} {v:.1e}" for k, v in rel_bf16.items())
        + f"; peak {pk16 / 2 ** 30:.2f} GiB")
    if max(rel_remat.values()) > 1e-6 or not (counts_equal and stats_close):
        raise AssertionError(f"S2D --remat step differs: losses {rel_remat},"
                             f" statistics {stats_diff}")
    if not all(math.isfinite(v) for v in m16.values()) or \
            max(rel_bf16.values()) > BF16_LOSS_REL:
        raise AssertionError(f"S2D bf16 vs fp32: {m16} against {m0}")
    return {"peak_plain": pk0, "peak_remat": pk1, "peak_bf16": pk16}


def write_try_files(root, n=4, size=(1242, 375), seed=12, names=None):
    """vKITTI/KITTI-sized files: RGB PNGs, 8-bit label PNGs (vKITTI ids
    0–22, Cityscapes ids 0–33, in 16-pixel blocks) and 16-bit depth PNGs,
    listed in .txt files, named ``names[i]`` (default ``{i:06d}.png``).
    Returns the train CLI's file arguments."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = size
    args = []
    for name, kind in (("img_source", "rgb"), ("img_target", "rgb"),
                       ("lab_source", 23), ("lab_target", 34),
                       ("depth_source", "depth")):
        os.makedirs(os.path.join(root, name))
        paths = []
        for i in range(n):
            if kind == "rgb":
                arr = rng.randint(0, 256, (h, w, 3), np.uint8)
            elif kind == "depth":
                arr = rng.randint(0, 12000, (h, w)).astype(np.uint16)
            else:
                arr = np.kron(rng.randint(0, kind, (h // 16 + 1, w // 16 + 1)),
                              np.ones((16, 16)))[:h, :w].astype(np.uint8)
            paths.append(os.path.join(
                root, name, names[i] if names else f"{i:06d}.png"))
            Image.fromarray(arr).save(paths[-1])
        listing = os.path.join(root, f"{name}.txt")
        with open(listing, "w") as f:
            f.write("\n".join(paths) + "\n")
        args += [f"--{name}_file_train", listing]
    return args


def start_s2d_cli():
    """Phase 17e's first run: ``python -m ...train --model S2D`` at full
    width on vKITTI-sized files (4 steps, batch 1, 192×576), in a process
    of its own (``run["cli"]``); the caller ends it."""
    run = {"dir": tempfile.TemporaryDirectory()}
    tmp = run["dir"].name
    run["args"] = [
        "--model", "S2D", *write_try_files(tmp), "--checkpoints_dir",
        os.path.join(tmp, "ck"), "--name", "s2d", "--niter", "1",
        "--niter_decay", "0", "--save_epoch_freq", "1", "--print_freq", "2",
        "--display_freq", "2", "--num_threads", "2", "--device", "cuda",
        *(f for k, v in S2D_WIDTHS.items() for f in (
            f"--{k}", *map(str, v if isinstance(v, list) else [v])))]
    run["cli"] = start_cli(TRAIN_CLI, run["args"])
    return run


def start_s2d_resume(run):
    """What the first run wrote, then its resume for epoch 2 (2 steps) in a
    process of its own (``run["resume"]``)."""
    expr = os.path.join(run["dir"].name, "ck", "s2d")
    want = [f"1_net_{n}.pth" for n in S2D_NETS] + [
        "1_train_state.pth", "loss_log.txt", os.path.join("web", "index.html"),
        os.path.join("web", "images", "epoch001_syn_seg_pre.png")]
    missing = [f for f in want if not os.path.exists(os.path.join(expr, f))]
    if missing:
        raise AssertionError(f"S2D train CLI did not write {missing}")
    run["resume"] = start_cli(
        TRAIN_CLI, run["args"] + ["--continue_train", "--epoch_count", "2",
                                  "--niter", "2", "--max_dataset_size", "2"])


def end_s2d_resume(run):
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    run["resume_seconds"] = end_cli(run.pop("resume"),
                                    "S2D train CLI resume")[1]
    expr = os.path.join(run["dir"].name, "ck", "s2d")
    st = torch.load(os.path.join(expr, "2_train_state.pth"),
                    map_location="cpu", weights_only=True)
    if st["step"] != 6:
        raise AssertionError(f"S2D resume: step {st['step']}, want 6")
    model = create_model(s2d_config(device="cpu"))
    model.cfg = model.cfg.replace(checkpoints_dir=os.path.join(
        run["dir"].name, "ck"), name="s2d")
    model.load_networks(model.init_state(), 2)  # the six nets load back
    run["dir"].cleanup()


def phase_s2d():
    """Phase 17: S2D at full width (the JAX defaults: DenseNet-169 G_2,
    mid_nc 1024, 3 dual blocks in G_1), 192×576, fp32 with TF32 off. 17b
    card vs CPU at batch 1, with the S2D train CLI on vKITTI-sized files
    beside it; 17c/17d bf16 and --remat against fp32 at batch 8, beside
    the CLI's resume; 17a the step timed at batch 1 and 8.
    S2D runs no InstanceNorm or epilogue kernel: their counts must not
    move."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        fused_in_epilogue)

    counters = (instance_norm, instance_norm_backward, fused_in_epilogue)
    for k in counters:
        k.launches = 0
    cfg = s2d_config()
    if (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) != ("try", 1, 192):
        raise AssertionError(f"S2D defaults: {cfg}")
    cli = start_s2d_cli()
    try:
        flips = phase_s2d_card_vs_cpu()
    finally:
        cli["seconds"] = end_cli(cli.pop("cli"), "S2D train CLI")[1]
    start_s2d_resume(cli)
    try:
        b8 = on(s2d_batch(S2D_BATCHES[-1], seed=13), "cuda")
        peaks = phase_s2d_compare(b8)
    finally:
        if "resume" in cli:
            end_s2d_resume(cli)
    out = {"flips": flips, **peaks}
    for n in S2D_BATCHES:
        batch = b8 if n == S2D_BATCHES[-1] else on(s2d_batch(n), "cuda")
        model = create_model(s2d_config())
        state = model.init_state()
        state, dt, peak = timed_steps(model, state, batch)
        log(f"phase 17a: S2D train step bs{n} {S2D_H}x{S2D_W} fp32 (TF32 "
            f"off): {dt * 1e3:.1f} ms/step = {n / dt:.2f} img/s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB")
        out[f"bs{n}"] = {"ms": dt * 1e3, "img_s": n / dt, "peak": peak}
        del model, state, batch
        torch.cuda.empty_cache()
    moved = {k.__name__: k.launches for k in counters if k.launches}
    if moved:
        raise AssertionError(f"S2D launched InstanceNorm or epilogue "
                             f"kernels: {moved}")
    log(f"phase 17 ok: no InstanceNorm or epilogue launch; python -m "
        f"cycle_depth_estimation_tpu_torch.train --model S2D (full width, "
        f"vKITTI-sized PNGs, 4 steps) {cli['seconds']:.1f} s, its resume "
        f"(2 steps) {cli['resume_seconds']:.1f} s; the six nets load back")
    return out


# RefineNet-LW (rf_lw) at the try size: the four adapter planes (C, H, W)
# of one G application, 1/4 down to 1/32 of RF_FINE × 3·RF_FINE; G runs
# twice a train step (real, then synthetic), so each kernel launches
# RF_PER_STEP times a step
RF_FINE = 192
RF_H, RF_W = RF_FINE, 3 * RF_FINE
RF_PLANES = tuple((64 * 4 * 2 ** i, RF_H // (4 * 2 ** i), RF_W // (4 * 2 ** i))
                  for i in range(4))
RF_G_APPLIES = 2
RF_PER_STEP = RF_G_APPLIES * len(RF_PLANES)
RF_WIDTHS = {}               # config overrides; empty: the full width
RF_BATCHES = (1, 8)
RF_NETS = ("G", "seg8", "seg4", "seg2", "seg2_0")
RF_CLI_SIZE = (1242, 375)    # the synthetic try tree's images (w, h)
KITTI_GT_SIZE = (1216, 352)  # depth_selection ground truth (w, h)


def rf_shapes(n):
    """{(n, C, H, W): calls per train step} of the adapters."""
    return {(n, *plane): RF_G_APPLIES for plane in RF_PLANES}


def rf_config(**kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    return apply_model_defaults(Config(**{
        "model": "rf_lw", "device": "cuda", "fine_size": RF_FINE,
        **RF_WIDTHS, **kw}))


def rf_flags():
    return [f for k, v in RF_WIDTHS.items() for f in (
        f"--{k}", *map(str, v if isinstance(v, list) else [v]))]


def rf_params(state):
    return {k: {n: p.detach().clone() for n, p in net.named_parameters()}
            for k, net in state.nets.items()}


def rf_flip_share(p0, a, b):
    """The share of parameters whose first update has another sign in ``a``
    than in ``b`` (both from ``p0``), over every net."""
    flipped = total = 0
    for name, params in p0.items():
        for k, v in params.items():
            flipped += int((a[name][k] - v).sign().ne(
                (b[name][k] - v).sign()).sum())
            total += v.numel()
    return flipped / total


def rf_losses(m):
    """The losses of a metrics dict (the accuracies left out: one argmax
    tie moves them by a pixel's share)."""
    return {k: v for k, v in m.items() if not k.startswith("acc")}


def rf_lw_step_flops(n, **kw):
    """The FLOPs of one train step of ``rf_config(batch_size=n, **kw)``'s
    model by phase, counted by ``torch.utils.flop_counter`` on the meta
    device (the plain InstanceNorm in place of the kernel; no device
    needed), and its parameter count."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops import layers

    model = create_model(rf_config(batch_size=n, device="cpu", **kw))
    model.device = torch.device("meta")
    with torch.device("meta"):
        state = model.init_state()
        batch = {k: torch.empty_like(v) for k, v in s2d_batch(
            n, size=(RF_H, RF_W)).items()}
    counter, by_phase = FlopCounterMode(display=False), {}
    with counter, mock.patch.object(layers, "instance_norm",
                                    plain_instance_norm_fn()):
        ctx = model._ctx(batch)
        for name, phase in model.PHASES:
            before = counter.get_total_flops()
            phase(model, state, ctx)
            by_phase[name] = counter.get_total_flops() - before
    params = sum(p.numel() for net in state.nets.values()
                 for p in net.parameters())
    return by_phase, params


def phase_rf_lw_kernels(gen):
    """Phase 18a: both InstanceNorm kernels against their plain versions at
    the four adapter planes, fp32 and bf16, batch 1 and 8, with kernel,
    plain, library and bound times (the helpers of phases 1 and 1b).
    Returns {batch: (forward totals, backward totals)} per fp32 train step
    and the largest errors."""
    out, errs = {}, [0.0, 0.0]
    for n in RF_BATCHES:
        f, f_err = phase_instance_norm(gen, rf_shapes(n), f"18a bs{n}",
                                       "rf_lw step", "float32")
        b, b_err = phase_instance_norm_backward(gen, rf_shapes(n),
                                                f"18a bs{n}", "rf_lw step")
        out[n] = (f, b)
        errs = [max(errs[0], f_err), max(errs[1], b_err)]
    return out, errs


def rf_compare(n, batch):
    """One rf_lw step at batch ``n`` from one init through the kernels
    (every InstanceNorm call held against its plain version as it happens),
    the plain versions and ``F.instance_norm``, cuDNN deterministic.
    Raises past phase 8's yardstick (losses 1e-4 relative, sign-flipped
    first updates 1e-4 of the parameters, or twice the library path's
    distance); returns the kernel step's metrics."""
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops import layers
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    model = create_model(rf_config(batch_size=n))
    torch.backends.cudnn.deterministic = True
    p0 = rf_params(model.init_state())
    runs, report = {}, {}
    for path, patch in (("kernel", None), ("plain", plain_instance_norm_fn()),
                        ("library", lambda x, eps=1e-5: F.instance_norm(
                            x, eps=eps))):
        expect = RF_PER_STEP if patch is None else 0
        st = model.init_state()
        with (mock.patch.object(layers, "instance_norm", patch) if patch
              else checked_instance_norm(report)), \
                counted(instance_norm, expect, f"rf_lw {path} step"), \
                counted(instance_norm_backward, expect,
                        f"rf_lw {path} step backward"):
            st, m = model.train_step(st, batch)
        g = dict(st.nets["G"].named_parameters())
        moved = [k for k, v in p0["G"].items()
                 if k.split(".")[0].endswith("_s") and not torch.equal(v, g[k])]
        if moved:  # the synthetic branch takes the _r adapters
            raise AssertionError(f"rf_lw moved the unused _s adapters: "
                                 f"{moved}")
        runs[path] = (rf_params(st), {k: float(v) for k, v in m.items()})
        del st
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    want = {(kind, shape, "float32") for kind in ("in_fwd", "in_bwd")
            for shape in rf_shapes(n)}
    if set(report) != want or any(c != RF_G_APPLIES
                                  for c, _ in report.values()):
        raise AssertionError(f"rf_lw bs{n} InstanceNorm calls {report}")
    log_report(f"phase 18b bs{n}", report)
    m_k, m_p, m_l = (runs[p][1] for p in ("kernel", "plain", "library"))
    if not all(math.isfinite(v) for _, m in runs.values() for v in m.values()):
        raise AssertionError(f"rf_lw losses not finite: {runs}")
    rel_k = rel_loss_diffs(rf_losses(m_k), rf_losses(m_p))
    rel_l = rel_loss_diffs(rf_losses(m_l), rf_losses(m_p))
    flip_k = rf_flip_share(p0, runs["kernel"][0], runs["plain"][0])
    flip_l = rf_flip_share(p0, runs["library"][0], runs["plain"][0])
    log(f"phase 18b bs{n}: kernel step losses {m_k}; vs plain: relative "
        "loss diffs " + " ".join(f"{k} {v:.1e}" for k, v in rel_k.items())
        + f", accuracies {m_k['acc_syn']:.6f}/{m_p['acc_syn']:.6f} "
        f"{m_k['acc_real']:.6f}/{m_p['acc_real']:.6f}, sign-flipped first "
        f"updates {flip_k:.2e}; F.instance_norm vs plain: "
        + " ".join(f"{k} {v:.1e}" for k, v in rel_l.items())
        + f", sign-flipped {flip_l:.2e}; {RF_PER_STEP} in_fwd and "
        f"{RF_PER_STEP} in_bwd launches")
    over = [k for k in rel_k if rel_k[k] > max(1e-4, 2 * rel_l[k])]
    if over or flip_k > max(1e-4, 2 * flip_l):
        raise AssertionError(f"rf_lw bs{n}, kernel vs plain: losses {over} "
                             f"past their limit ({rel_k}, library {rel_l}); "
                             f"sign-flipped {flip_k} (library {flip_l})")
    return m_k


def phase_rf_lw_variants(batch, m32):
    """One rf_lw7 step (ResNetLW-50, one head) and one bf16 rf_lw step at
    batch 1, each InstanceNorm call checked; the bf16 losses within
    BF16_LOSS_REL of the fp32 step's ``m32`` from the same init."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)

    out = {}
    for tag, kw in (("rf_lw7", {"model": "rf_lw7"}),
                    ("bf16", {"dtype": "bfloat16"})):
        model = create_model(rf_config(**kw))
        st = model.init_state()
        depth0 = (None if tag != "rf_lw7" else
                  {k: v.clone() for k, v in st.nets["depth"].state_dict().items()})
        report = {}
        torch.cuda.reset_peak_memory_stats()
        with checked_instance_norm(report), \
                counted(instance_norm, RF_PER_STEP, f"{tag} step"), \
                counted(instance_norm_backward, RF_PER_STEP,
                        f"{tag} step backward"):
            st, m = model.train_step(st, batch)
        torch.cuda.synchronize()
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag} losses {m}")
        dt = "bfloat16" if tag == "bf16" else "float32"
        if {(k, sh, d) for k, sh, d in report} != {
                (kind, shape, dt) for kind in ("in_fwd", "in_bwd")
                for shape in rf_shapes(1)}:
            raise AssertionError(f"{tag} InstanceNorm calls {sorted(report)}")
        log_report(f"phase 18b {tag}", report)
        if depth0 is not None and any(
                not torch.equal(v, depth0[k])
                for k, v in st.nets["depth"].state_dict().items()):
            raise AssertionError("rf_lw7 stepped its depth block")
        out[tag] = (m, torch.cuda.max_memory_allocated())
        del model, st
        torch.cuda.empty_cache()
    rel = rel_loss_diffs(rf_losses(out["bf16"][0]), rf_losses(m32))
    log(f"phase 18b: rf_lw7 bs1 first-step losses {out['rf_lw7'][0]}; bf16 "
        f"rf_lw bs1: {out['bf16'][0]}, relative to fp32 "
        + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
        + f"; peak {out['bf16'][1] / 2 ** 30:.2f} GiB")
    if max(rel.values()) > BF16_LOSS_REL:
        raise AssertionError(f"rf_lw bf16 vs fp32: {rel}")


def write_kitti_tree(root, n=2):
    """A ``try`` tree of ``n`` vKITTI-sized samples whose KITTI names give
    distinct ``f_name`` slices, and a ground-truth directory of uint16
    meters×256 PNGs named by them (0 = no measurement). Returns (train
    args, test args, ground-truth dir, prediction names)."""
    import numpy as np
    from PIL import Image

    names = [f"2011_09_26_drive_{i:04d}_sync_image_{i:010d}_image_02.png"
             for i in range(n)]
    train = write_try_files(os.path.join(root, "data"), n, RF_CLI_SIZE, 14,
                            names)
    test = [a.replace("_file_train", "_file_test") for a in train]
    gt = os.path.join(root, "gt")
    os.makedirs(gt)
    rng = np.random.RandomState(15)
    w, h = KITTI_GT_SIZE
    preds = []
    for name in names:
        d = (rng.rand(h, w) * 60 * 256).astype(np.uint16)
        d[rng.rand(h, w) < 0.8] = 0  # sparse, as the LiDAR ground truth
        preds.append(name[-56:-29] + ".png")
        Image.fromarray(d).save(os.path.join(gt, preds[-1]))
    return train, test, gt, preds


def start_rf_lw_cli():
    """Phase 18c's train CLI: ``--model rf_lw`` at full width on a
    synthetic try tree (2 steps, batch 1, 192×576) with ``--kitti_gt_dir
    --eval_freq 1``, in a process of its own (``run["cli"]``)."""
    run = {"dir": tempfile.TemporaryDirectory()}
    tmp = run["dir"].name
    train, test, gt, preds = write_kitti_tree(tmp)
    run.update(test=test, gt=gt, preds=preds, ck=os.path.join(tmp, "ck"))
    run["cli"] = start_cli(TRAIN_CLI, [
        "--model", "rf_lw", *train, *test, "--checkpoints_dir", run["ck"],
        "--name", "rf", "--niter", "1", "--niter_decay", "0",
        "--save_epoch_freq", "1", "--print_freq", "1", "--display_freq", "2",
        "--num_threads", "2", "--device", "cuda", "--fine_size", str(RF_FINE),
        "--kitti_gt_dir", gt, "--eval_freq", "1", *rf_flags()])
    return run


def end_rf_lw_cli(run):
    """End the train CLI, check its records lines (one a step, each with
    every KITTI metric) and visuals, then ``save_kitti`` from its
    ``latest`` checkpoint (rf_lw) and from a random init (S2D, small
    widths) side by side, and ``eval_kitti`` on the rf_lw maps; each CLI a
    process of its own."""
    import numpy as np
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.utils.metrics import (
        DEPTH_METRIC_NAMES)

    text, secs = end_cli(run.pop("cli"), "rf_lw train CLI")
    expr = os.path.join(run["ck"], "rf")
    with open(os.path.join(expr, "records.txt")) as f:
        records = [json.loads(line) for line in f]
    if [r["iters"] for r in records] != [1, 2] or any(
            not all(math.isfinite(r[k]) for k in DEPTH_METRIC_NAMES)
            for r in records) or "[kitti eval] skipped" in text:
        raise AssertionError(f"rf_lw train CLI records {records}:\n"
                             f"{text[-3000:]}")
    for f in ("latest_net_G.pth", "latest_net_seg2_0.pth",
              os.path.join("web", "images", "epoch001_real_dep_pre.png")):
        if not os.path.exists(os.path.join(expr, f)):
            raise AssertionError(f"rf_lw train CLI did not write {f}")
    tool = "cycle_depth_estimation_tpu_torch.tools."
    out_rf, out_s2d = (os.path.join(run["dir"].name, d)
                       for d in ("pred_rf", "pred_s2d"))
    common = [*run["test"], "--checkpoints_dir", run["ck"], "--device",
              "cuda", "--fine_size", str(RF_FINE)]
    runs = {"rf_lw": start_cli(tool + "save_kitti", [
                "--model", "rf_lw", "--name", "rf", "--epoch", "latest",
                "--out_dir", out_rf, *common, *rf_flags()]),
            "S2D": start_cli(tool + "save_kitti", [
                "--model", "S2D", "--name", "s2d", "--out_dir", out_s2d,
                *common, "--dense_block_config", "2", "2", "2", "2",
                "--dense_growth_rate", "8", "--s2d_mid_nc", "64",
                "--g1_blocks", "1"])}
    secs_save = {k: end_cli(r, f"save_kitti --model {k}")[1]
                 for k, r in runs.items()}
    for model, out in (("rf_lw", out_rf), ("S2D", out_s2d)):
        got = sorted(os.listdir(out))
        if got != sorted(run["preds"]):
            raise AssertionError(f"save_kitti {model} wrote {got}, want "
                                 f"{sorted(run['preds'])}")
        for f in got:
            a = np.asarray(Image.open(os.path.join(out, f)))
            if a.shape != (RF_H, RF_W) or a.dtype != np.uint8:
                raise AssertionError(f"save_kitti {model} {f}: {a.shape} "
                                     f"{a.dtype}")
    # the in-loop validation after the last step ran the nets `latest` holds
    lsb = max(int(np.abs(np.asarray(Image.open(os.path.join(out_rf, f)),
                                    np.int64)
                         - np.asarray(Image.open(os.path.join(expr, "pred",
                                                              f)))).max())
              for f in run["preds"])
    if lsb > 1:
        raise AssertionError(f"save_kitti rf_lw vs the in-loop maps: {lsb}")
    records_file = os.path.join(run["dir"].name, "records.txt")
    text_eval, secs_eval = end_cli(start_cli(tool + "eval_kitti", [
        "--gt_dir", run["gt"], "--pred_dir", out_rf, "--records",
        records_file]), "eval_kitti")
    lines = text_eval.strip().splitlines()
    header = [h.strip() for h in lines[-2].split(",")]
    values = [float(v) for v in lines[-1].split(",")]
    with open(records_file) as f:
        rec = [json.loads(line) for line in f]
    if header != list(DEPTH_METRIC_NAMES) or len(rec) != 1 or any(
            abs(rec[0][k] - v) > 1e-4 for k, v in zip(header, values)):
        raise AssertionError(f"eval_kitti printed {lines[-2:]}, records "
                             f"{rec}")
    log(f"phase 18c ok: train CLI --model rf_lw (2 steps, in-loop KITTI "
        f"validation each step) {secs:.1f} s, records {records[-1]}; "
        f"save_kitti rf_lw {secs_save['rf_lw']:.1f} s (maps within {lsb} of "
        f"the in-loop ones), S2D {secs_save['S2D']:.1f} s; eval_kitti "
        f"{secs_eval:.1f} s: {dict(zip(header, values))}")
    run["dir"].cleanup()


def phase_rf_lw(cli):
    """Phase 18b: rf_lw at full width (ResNetLW-101, four heads, 28 + 1
    classes), 192×576, fp32 with TF32 off: at batch 1 and 8 one step
    through the kernels against the plain versions and F.instance_norm
    (``rf_compare``), 8 + 8 launches a step; rf_lw7 and bf16 steps; then
    the step timed at batch 1 and 8 (ms, img/s, peak memory). ``cli``
    (phase 18c's train CLI) runs beside the untimed
    checks and is ended, with the KITTI tools after it, before the
    timing."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    cfg = rf_config()
    if (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) != ("try", 1, 192) \
            and not RF_WIDTHS:
        raise AssertionError(f"rf_lw defaults: {cfg}")
    batches = {n: on(s2d_batch(n, seed=16 + n, size=(RF_H, RF_W)), "cuda")
               for n in RF_BATCHES}
    try:
        m32 = {n: rf_compare(n, batches[n]) for n in RF_BATCHES}
        phase_rf_lw_variants(batches[1], m32[1])
    finally:
        if "cli" in cli:
            end_rf_lw_cli(cli)
    out = {}
    for n in RF_BATCHES:
        model = create_model(rf_config(batch_size=n))
        state = model.init_state()
        state, dt, peak = timed_steps(model, state, batches[n])
        flops, params = rf_lw_step_flops(n)
        total = sum(flops.values())
        log(f"phase 18b: rf_lw train step bs{n} {RF_H}x{RF_W} fp32 (TF32 "
            f"off): {dt * 1e3:.1f} ms/step = {n / dt:.2f} img/s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB; {total / 1e12:.3f} TFLOP a step ("
            + ", ".join(f"{k} {v / 1e9:.1f} GFLOP" for k, v in flops.items())
            + f"; {params / 1e6:.1f} M parameters) = "
            f"{total / dt / 1e12:.1f} TFLOP/s")
        out[f"bs{n}"] = {"ms": dt * 1e3, "img_s": n / dt, "peak": peak}
        del model, state
        torch.cuda.empty_cache()
    log("phase 18 ok")
    return out


# The base my_seg_depth generation (S2D_base, S2D_alt; phase 19), the
# two-trunk one (S2D_df, S2D_nd and S2D_nd --nd_4dis; phase 20) and the
# semantic_trans one (semantic_trans, semantic_trans_full; phase 21) at the
# try size: the nets each phase of a step updates, and how many Dis_en
# forwards draw dropout masks in a step
BASE_MODELS = ("S2D_base", "S2D_alt")
TWO_TRUNK = ("S2D_df", "S2D_nd", "S2D_nd_4dis")
ST_MODELS = ("semantic_trans", "semantic_trans_full")
BASE_TAG = {**dict.fromkeys(BASE_MODELS, "19"),
            **dict.fromkeys(TWO_TRUNK, "20"), **dict.fromkeys(ST_MODELS, "21")}
BASE_CASES = {"S2D_nd_4dis": {"model": "S2D_nd", "nd_4dis": True}}
BASE_H, BASE_W = S2D_H, S2D_W
BASE_WIDTHS = {k: {} for k in BASE_TAG}  # overrides; empty: full width
BASE_BATCHES = (1, 8)
BASE_FALLBACK_BATCHES = (4, 2)  # timed in turn where batch 8 does not fit
BASE_BF16_BATCH = 2
BASE_UPDATES = {
    "S2D_base": {"real": (), "G": ("G_1", "G_2"), "frozen": (),
                 "Seg": ("Seg_de",), "Dep": ("Dep_de",), "D": ("Dis_en",)},
    "S2D_alt": {"G": ("G_1", "G_2"), "Feature": ("Feature",),
                "Seg": ("Seg_de",), "Dep": ("Dep_de",), "D": ("Dis_en",)},
    "S2D_df": {"G_1": ("G_1",), "G_2": ("G_2",), "Seg": ("Seg_de",),
               "Dep": ("Dep_de",), "D": ("Dis0_en",)},
    "S2D_nd": {"D1": ("Dis_en",), "G_1": ("G_1",), "G_2": ("G_2",),
               "Seg": ("Seg_de",), "Dep": ("Dep_de",), "D2": ("Dis_en",)},
    "S2D_nd_4dis": {"D1": ("Dis0_en", "Dis1_en"), "G_1": ("G_1",),
                    "G_2": ("G_2",), "Seg": ("Seg_de",), "Dep": ("Dep_de",),
                    "D2": ("Dis0_en", "Dis1_en")},
    "semantic_trans": {**S2D_UPDATES, "post": ("DIS", "Dis_160", "Dis_320")},
    "semantic_trans_full": {"G_1": ("G_1",), "G_2": ("G_2",),
                            "Seg": ("Seg_de",), "Dep": ("Dep_de",),
                            "R_D_real": ("R_D",), "R_D_syn": ("R_D",),
                            "D": ("Dis0_en", "DIS", "Dis_160", "Dis_320")}}
BASE_DRAWS = {"S2D_base": 3, "S2D_alt": 4}
BASE_CHECK_EPS = 1e-3  # 19a's Adam eps on both sides (the models' is 1e-8)
# S2D_nd's critic (model2's DiscriminatorSeg) is piecewise linear (a
# LeakyReLU after each 1×1 conv and after the head), and its BCE clamps the
# outputs to [1e-7, 1 − 1e-7] with the slope −1/p toward 1: the update of a
# phase that differentiates that BCE jumps where rounding puts one of the
# critic's pre-activations on the other side of 0 or an output on the other
# side of the clamp, and an output near the clamp carries its rounding into
# the gradient at 1/p times its size. The card's fp32 trunk features lie
# far enough from the CPU's to do both. 20a holds such a phase in parts
# (``CriticPins``): the trunks' features and the critic's outputs within
# ``PIN_OUT_REL`` of the largest, the losses within 1e-3, and the update by
# the plain checks with the BCE's slope, and the features a D phase feeds
# its critic (``BASE_FED``), taken from the CPU. Unpinned, the update is
# reported with the sign and clamp flips and the CPU's and the card's
# distances from the card's float64 phase. The whole step is held pinned
# (slopes only) on its losses.
BASE_PINNED = {"S2D_nd": ("D1", "G_2", "D2")}
BASE_FED = {"S2D_nd": ("D1", "D2")}
TRUNKS = ("G_1", "G_2")
PIN_OUT_REL = 1e-4  # the critic's outputs, card vs CPU, of the largest
# The unpinned whole step's losses that read the first D phase's update
# (S2D_nd's G_2 phase and its second D phase): 20a reports them beside the
# CPU's and the card's distances from the card's float64 step (the pinned
# step holds them); 20b holds the second D
# phase from the fp32 step's input to it and reports its losses' end
# values (G_2's losses are computed once and held).
BASE_REPORTED = {"S2D_nd": ("G_2", "G2_dis", "D_syn", "D_real", "gp"),
                 # semantic_trans_full's phase D reads G_1, G_2 and Seg_de
                 # after their updates (Dis0_en's D_real, D_syn) and R_D's
                 # depth after R_D's (DIS's DEP_syn: its outputs on the
                 # synthetic pair are near 0 and the loss ~1e-8, 1e-3 apart
                 # CPU against CPU with oneDNN on and off); 21a holds them
                 # from the CPU's input to phase D
                 "semantic_trans_full": ("D_real", "D_syn", "DEP_syn")}
# The phase of a semantic_trans model whose DIS (LeakyReLU all the way, its
# penalty a double backward through it in semantic_trans) reads R_D's
# depth: 21a records the signs of DIS's LeakyReLU inputs in that phase on
# the CPU and reports how many the card's run of it from the CPU's input
# puts on the other side of 0.
BASE_SIGNS = {"semantic_trans": ("post", "DIS"),
              "semantic_trans_full": ("D", "DIS")}
# semantic_trans_full's G_1 phase reaches G_1 through G_2, SEG and
# Dis0_en, whose fp32 backward is ill-conditioned on both sides: the
# card's own gradient at G_1's output lies 4.1e-2 of the largest from the
# CPU's, its update puts 3.5e-3 of G_1 past lr from the CPU's, and the
# card's float64 phase is 2.1e-3 past lr from the CPU's update and 3.7e-3
# from the card's; from the CPU's gradient at G_1's output the card's
# update is 1.6e-6 past lr (measured on one H100). 21a holds that
# phase with the gradient at the output of the net named here taken from
# the CPU (``GradPins``), and reports it unpinned beside the card's
# float64 phase.
BASE_GRAD_PINS = {"semantic_trans_full": {"G_1": "G_1"}}
# In bf16 the same heads (Dis0_en: 1×1 convs, each LeakyReLU then
# BatchNorm) turn the rounding of G_1's and G_2's fresh bf16 forwards in
# semantic_trans_full's phase D into 5.4e-2 of D_syn (measured on one
# H100): 21b holds that phase from the fp32 step's input with the features
# Seg_de hands Dis0_en there taken from the fp32 step (``CriticPins``'
# feature feed), and reports it without them.
BASE_BF16_FED = {"semantic_trans_full": ("Seg_de",)}


def base_case(name):
    """The config fields of case ``name`` (a model, or a model and flags)
    with its width overrides."""
    return {**BASE_CASES.get(name, {"model": name}), **BASE_WIDTHS[name]}


def base_config(name, **kw):
    from cycle_depth_estimation_tpu_torch.config import (Config,
                                                         apply_model_defaults)

    over = {**base_case(name), **kw}
    return apply_model_defaults(Config(**{"device": "cuda", **over}),
                                set(over))


class MaskFeed:
    """Dis_en's keep-masks of one step, drawn once: each call returns the
    next set on ``device``; ``at(i, device)`` is a feed from the i-th."""

    def __init__(self, masks, start=0, device="cpu"):
        self.masks, self.i, self.device = masks, start, device

    def __call__(self):
        self.i += 1
        return [m.to(self.device) for m in self.masks[self.i - 1]]

    def at(self, i, device):
        return MaskFeed(self.masks, i, device)


class CriticPins:
    """S2D_nd's BCE (``s2d_nd.bce_gan_loss``), the trunks' features a D
    phase feeds its critic and the signs of the critic's LeakyReLU inputs,
    recorded and replayed. ``record(key, trunks, critic)``: under ``key``
    (a phase), each BCE call keeps the critic's output (on the CPU) and the
    BCE's gradient in it, each forward of a net of ``trunks`` its features
    and each LeakyReLU module of ``critic`` the signs of its input.
    ``replay(keys, trunks, critic, pin)``: the same calls in turn; with
    ``pin``, each BCE call's gradient in the critic's output is the
    recorded one (its value the replaying side's own) and each forward of
    a net of ``trunks`` gives the recorded features. ``seen`` then holds
    the largest distance of the critic's outputs from the recorded ones,
    relative to the largest, of the trunks' own features likewise, and
    how many outputs the BCE's clamp and how many pre-activations the
    LeakyReLUs take on the other side."""

    def __init__(self):
        self.calls, self.seen = {}, {}

    @contextmanager
    def _installed(self, fn, hooks):
        from cycle_depth_estimation_tpu_torch.models import s2d_nd

        bce = s2d_nd.bce_gan_loss
        s2d_nd.bce_gan_loss = lambda pred, real: fn(bce, pred, real)
        handles = [m.register_forward_hook(h) for m, h in hooks]
        try:
            yield
        finally:
            s2d_nd.bce_gan_loss = bce
            for h in handles:
                h.remove()

    @staticmethod
    def _relus(critic):
        import torch

        return [m for m in critic.modules()
                if isinstance(m, torch.nn.LeakyReLU)]

    def record(self, key, trunks=(), critic=None):
        import torch

        rec = self.calls.setdefault(key, {"bce": [], "feats": [],
                                          "signs": []})

        def fn(bce, pred, real):
            ref = pred.detach().float().cpu().requires_grad_(True)
            (g,) = torch.autograd.grad(bce(ref, real), ref)
            rec["bce"].append((ref.detach(), real, g))
            return bce(pred, real)

        hooks = [(t, lambda m, a, out: rec["feats"].append(
            out[1].detach().float().cpu())) for t in trunks]
        hooks += [(r, lambda m, a, out: rec["signs"].append(
            (a[0] > 0).cpu())) for r in (self._relus(critic) if critic
                                         else ())]
        return self._installed(fn, hooks)

    @contextmanager
    def replay(self, keys, trunks=(), critic=None, pin=True):
        bce_feed = [c for k in keys for c in self.calls[k]["bce"]]
        feats = [f for k in keys for f in self.calls[k]["feats"]
                 ] if trunks else []
        signs = [s for k in keys for s in self.calls[k]["signs"]
                 ] if critic is not None else []
        seen = self.seen = {"outputs": 0.0, "feats": None, "clamp": 0,
                            "relu": None if critic is None else 0}

        def fn(bce, pred, real):
            ref, want, g = bce_feed.pop(0)
            if want != real or ref.shape != pred.shape:
                raise AssertionError(f"BCE call: {tuple(pred.shape)}, {real}")
            seen["outputs"] = max(seen["outputs"], out_distance(pred, ref))
            seen["clamp"] += int(clamped(pred.detach().float().cpu()).ne(
                clamped(ref)).sum())
            if not pin:
                return bce(pred, real)
            return (bce(pred.detach(), real)
                    + (g.to(pred.device) * (pred - pred.detach())).sum())

        def feed(m, a, out):
            ref = feats.pop(0)
            seen["feats"] = max(seen["feats"] or 0.0, out_distance(out[1],
                                                                   ref))
            return (out[0], ref.to(out[1].device, out[1].dtype)) if pin \
                else None

        def sign(m, a, out):
            seen["relu"] += int((a[0] > 0).cpu().ne(signs.pop(0)).sum())

        hooks = [(t, feed) for t in trunks]
        hooks += [(r, sign) for r in (self._relus(critic) if critic
                                      else ())]
        with self._installed(fn, hooks):
            yield
        if bce_feed or feats or signs:
            raise AssertionError(f"{len(bce_feed)} recorded BCE calls, "
                                 f"{len(feats)} features and {len(signs)} "
                                 "sign maps left")


class GradPins:
    """The gradient that reaches a net's output in a phase, recorded on
    the CPU under a key (``record(key, net)``) and replayed on the card
    (``replay(key, net, pin)``): with ``pin`` the card's backward goes on
    from the recorded gradient. ``seen["grad"]``: the largest distance of
    the card's own gradient there from the recorded one, over the
    largest."""

    def __init__(self):
        self.grads, self.seen = {}, None

    @staticmethod
    @contextmanager
    def _hooked(net, on_grad):
        def forward(module, args, out):
            if out.requires_grad:
                out.register_hook(on_grad)

        handle = net.register_forward_hook(forward)
        try:
            yield
        finally:
            handle.remove()

    def record(self, key, net):
        rec = self.grads.setdefault(key, [])
        return self._hooked(net, lambda g: rec.append(g.detach().float()
                                                      .cpu()))

    @contextmanager
    def replay(self, key, net, pin):
        feed = list(self.grads[key])
        seen = self.seen = {"grad": 0.0}

        def on_grad(g):
            ref = feed.pop(0)
            seen["grad"] = max(seen["grad"], out_distance(g, ref))
            return ref.to(g.device, g.dtype) if pin else None

        with self._hooked(net, on_grad):
            yield
        if feed:
            raise AssertionError(f"{len(feed)} recorded gradients left")


def clamped(p):
    """Where the BCE's clamp stops an output."""
    return (p < 1e-7) | (p > 1.0 - 1e-7)


def out_distance(pred, ref):
    """The largest distance of ``pred`` from ``ref`` over ``ref``'s largest
    magnitude."""
    return float((pred.detach().double().cpu() - ref.double()).abs().max()
                 / ref.abs().max())


def pins_said(seen):
    """What a ``CriticPins`` replay saw, in words."""
    return (f"the critic's outputs {seen['outputs']:.1e} of the largest "
            f"from the CPU's, {seen['clamp']} on the other side of the "
            "clamp" + ("" if seen["relu"] is None else
                       f", {seen['relu']} of its LeakyReLUs' inputs on the "
                       "other side of 0") + (
                "" if seen["feats"] is None else
                f", the trunks' own features {seen['feats']:.1e}"))


def base_snapshot(state, ctx):
    """``s2d_snapshot`` on the CPU with the mask feed left out, and the
    feed's position (None without one)."""
    feed = ctx.get("masks")
    return (*s2d_snapshot(state, {k: v for k, v in ctx.items()
                                  if k != "masks"}),
            None if feed is None else feed.i)


def with_eps(state, eps):
    """Adam's eps set to ``eps``; an optimizer without one (SGD) as it
    is."""
    for opt in state.optimizers.values():
        for group in opt.param_groups:
            if "eps" in group:
                group["eps"] = eps
    return state


def as_float64(ctx):
    """A step context with its floating tensors in float64."""
    import torch

    return {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in ctx.items()}


def float64_phase(model, state64, nets, opts, pre, phase):
    """``phase`` in float64 on the card from a snapshot (``nets``,
    ``opts``, carried ``pre``): ``state64`` is ``float64_state``'s. Returns
    the parameters after it on the CPU."""
    for k, net in state64.nets.items():
        net.load_state_dict(nets[k])
        state64.optimizers[k].load_state_dict(opts[k])
    phase(model, state64, as_float64(copied(pre, "cuda")))
    return s2d_params(state64)


def float64_state(model):
    """The model's init in float64 on the card, in train mode, Adam's eps
    at ``BASE_CHECK_EPS``."""
    state = model.init_state()
    for net in state.nets.values():
        net.double().train()
    state.optimizers = {k: model._optimizer(k, state.nets[k].parameters())
                        for k in model.model_names}
    return with_eps(state, BASE_CHECK_EPS)


def float64_step(model, batch, pins=None):
    """The model's first step in float64 on the card from its seed (CE and
    L1 stay fp32 reductions), Adam's eps at ``BASE_CHECK_EPS``, its BCE
    calls recorded in ``pins`` (a ``CriticPins``) under "step": (its
    losses, the float64 state)."""
    state = float64_state(model)
    ctx = as_float64(model._ctx(state=state, batch=on(batch, "cuda")))
    with (pins.record("step") if pins else contextlib.nullcontext()):
        for _, phase in model.PHASES:
            phase(model, state, ctx)
    return {k: float(ctx["metrics"][k]) for k in model.loss_names}, state


def base_params_close(got, want, before, lr, sgd):
    """One net's parameters after a phase, ``got`` against ``want``: an
    Adam net by the three checks of ``s2d_params_close``, the SGD critic
    within 1e-3 of ``want``'s largest update from ``before``. Returns (ok,
    numbers)."""
    if not sgd:
        return s2d_params_close(got, want, lr)
    upd = max(float((want[k].double() - before[k].double()).abs().max())
              for k in want)
    err = max(float((got[k].double() - want[k].double()).abs().max())
              for k in want)
    return err <= 1e-3 * upd, {"max_over_update": err / upd}


@contextmanager
def recorded_clips(norms):
    """Each gradient norm the train steps' ``clip_grad_global_norm_`` sees,
    appended to ``norms``."""
    from cycle_depth_estimation_tpu_torch.models import base_model

    clip = base_model.clip_grad_global_norm_

    def recorded(params, max_norm):
        norm = clip(params, max_norm)
        norms.append(float(norm))
        return norm

    with mock.patch.object(base_model, "clip_grad_global_norm_", recorded):
        yield


def base_first_step(name):
    """19a's (20a's, 21a's) whole first step of ``name`` at the model's
    seed and batch seed 17, batch 1, Adam's eps at ``BASE_CHECK_EPS``, on the
    CPU (oneDNN off, each phase snapshotted before it runs and, for a
    ``BASE_PINNED`` model, its BCE calls recorded) and on the card; for a
    pinned model also in float64 and pinned on the card. Losses within 1e-3
    relative but ``BASE_REPORTED``'s unpinned ones; the parameters
    reported. Returns what the phase checks read, and the failures."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    tag = f"phase {BASE_TAG[name]}a {name}"
    is_pinned = name in BASE_PINNED
    pins = CriticPins() if is_pinned or name in BASE_SIGNS else None
    grads = GradPins()
    clip_norms = {"CPU": [], "card": []}
    batch = s2d_batch(1, seed=17, size=(BASE_H, BASE_W))
    t = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        cpu_model = create_model(base_config(name, device="cpu"))
        cpu_state = with_eps(cpu_model.init_state(), BASE_CHECK_EPS)
        p0 = s2d_params(cpu_state)
        ctx = cpu_model._ctx(state=cpu_state, batch=batch)
        feed = None
        if "masks" in ctx:
            draw = ctx["masks"]
            feed = MaskFeed([draw() for _ in range(BASE_DRAWS[name])])
            ctx["masks"] = feed
        for net in cpu_state.nets.values():
            net.train()
        snaps = []
        for pname, phase in cpu_model.PHASES:
            snaps.append(base_snapshot(cpu_state, ctx))
            if is_pinned:
                rec = pins.record(pname, [cpu_state.nets[k] for k in TRUNKS],
                                  cpu_state.nets["Dis_en"])
            elif BASE_SIGNS.get(name, ("",))[0] == pname:
                rec = pins.record(pname, (),
                                  cpu_state.nets[BASE_SIGNS[name][1]])
            else:
                rec = contextlib.nullcontext()
            grad_net = BASE_GRAD_PINS.get(name, {}).get(pname)
            with rec, recorded_clips(clip_norms["CPU"]), (
                    grads.record(pname, cpu_state.nets[grad_net]) if grad_net
                    else contextlib.nullcontext()):
                phase(cpu_model, cpu_state, ctx)
        snaps.append(base_snapshot(cpu_state, ctx))
    if feed is not None and feed.i != BASE_DRAWS[name]:
        raise AssertionError(f"{name}: {feed.i} Dis_en forwards drew masks")
    m_cpu = {k: float(v) for k, v in ctx["metrics"].items()}
    cpu_after = s2d_params(cpu_state)
    del cpu_model, cpu_state, ctx
    cpu_s = time.perf_counter() - t
    model = create_model(base_config(name))
    state = with_eps(model.init_state(), BASE_CHECK_EPS)
    card_pins = CriticPins()
    with (card_pins.record("step") if is_pinned
          else contextlib.nullcontext()), \
            recorded_clips(clip_norms["card"]):
        state, m = model.train_step(state, on(batch, "cuda"))
    m_card = {k: float(v) for k, v in m.items()}
    card_after = s2d_params(state)
    rel = rel_loss_diffs(m_card, {k: m_cpu[k] for k in m_card})
    log(f"{tag}: adam_eps {BASE_CHECK_EPS:g}: whole step, card vs CPU "
        f"({cpu_s:.1f} s) first-step losses, relative: "
        + " ".join(f"{k} {v:.1e}" for k, v in rel.items()))
    if clip_norms["CPU"]:
        log(f"{tag}:   the clipped nets' gradient norms before the clip "
            f"({', '.join(model.clip_norms)}): " + "; ".join(
                f"{who} " + ", ".join(f"{v:.4g}" for v in norms)
                for who, norms in clip_norms.items()))
    if not all(math.isfinite(v) for v in (*m_card.values(),
                                          *m_cpu.values())):
        raise AssertionError(f"{name} losses: card {m_card}, CPU {m_cpu}")
    reported = BASE_REPORTED.get(name, ())
    bad = {k: v for k, v in rel.items()
           if not k.startswith("acc") and v > S2D_CPU_LOSS_REL
           and k not in reported}
    lrs = {k: o.param_groups[0]["lr"] for k, o in state.optimizers.items()}
    sgd = {k for k, o in state.optimizers.items()
           if isinstance(o, torch.optim.SGD)}

    def distances(after):
        return {net: base_params_close(after[net], cpu_after[net], p0[net],
                                       lrs[net], net in sgd)[1]
                for net in model.model_names}

    flips64 = None
    state64 = float64_state(model) if name in BASE_GRAD_PINS else None
    if is_pinned:
        pins64 = CriticPins()
        m64, state64 = float64_step(model, batch, pins64)
        flips64 = s2d_flip_shares(p0, card_after, s2d_params(state64),
                                  model.model_names)
        cpu_calls = [c for p, _ in model.PHASES for c in pins.calls[p]["bce"]]
        for who, ms, calls in (("card fp32", m_card,
                                card_pins.calls["step"]["bce"]),
                               ("CPU fp32", m_cpu, cpu_calls)):
            log(f"{tag}:   whole step, {who} vs card float64, relative: "
                + " ".join(f"{k} {v:.1e}" for k, v in rel_loss_diffs(
                    {k: ms[k] for k in m64}, m64).items())
                + "; the critic's outputs, call by call, of the largest: "
                + " ".join(f"{out_distance(c[0], c64[0]):.1e}" for c, c64 in
                           zip(calls, pins64.calls["step"]["bce"])))
        pinned = with_eps(model.init_state(), BASE_CHECK_EPS)
        with pins.replay([p for p, _ in model.PHASES]):
            pinned, pm = model.train_step(pinned, on(batch, "cuda"))
        prel = rel_loss_diffs({k: float(v) for k, v in pm.items()},
                              {k: m_cpu[k] for k in pm})
        log(f"{tag}:   whole step pinned ({pins_said(pins.seen)}), card "
            "vs CPU, relative: "
            + " ".join(f"{k} {v:.1e}" for k, v in prel.items()))
        bad.update({f"pinned:{k}": v for k, v in prel.items()
                    if not k.startswith("acc") and v > S2D_CPU_LOSS_REL})
        for net, nums in distances(s2d_params(pinned)).items():
            log(f"{tag}:   whole step pinned {net}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in nums.items()))
        del pinned
    flips = s2d_flip_shares(p0, card_after, cpu_after, model.model_names)
    out = {}
    for net, nums in distances(card_after).items():
        out[net] = {**nums, "flips": flips[net]}
        log(f"{tag}:   whole step {net}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in nums.items())
            + f"; sign-flipped updates {flips[net]:.2e}" + (
                "" if flips64 is None else
                f" (card fp32 vs float64 {flips64[net]:.2e})"))
    return dict(model=model, state=state, state64=state64, snaps=snaps,
                feed=feed, pins=pins, grads=grads, lrs=lrs, out=out, bad=bad)


def phase_base_card_vs_cpu(name):
    """Phase 19a (20a, 21a) for ``name``: the first batch-1 step on the card
    and on the CPU (oneDNN off) from one seed, with the same Dis_en masks and
    penalty alphas (drawn on the CPU from the seed and the step) and
    Adam's eps raised to 1e-3 on both sides, as phase 17b does (at the
    models' 1e-8 the first update is lr·sign(g), and rounding-sized
    gradients flip: 0.42 % of G_2's in the G phase of S2D_base alone): the
    whole step's losses within 1e-3 relative (``base_first_step``); then
    each phase again on the card from the CPU's
    state, carried tensors and masks before it: its losses within 1e-3 and
    the nets it updates by ``base_params_close``; a ``BASE_PINNED`` or
    ``BASE_GRAD_PINS`` phase pinned, as the comments there say. Over the
    whole step the parameter distances and sign-flipped first updates are
    reported, not held: a later phase reads an earlier one's updated
    weights."""
    import torch

    tag = f"phase {BASE_TAG[name]}a {name}"
    first = base_first_step(name)
    bad = first["bad"]
    model, state, state64, snaps, feed, pins, grads, lrs = (
        first[k] for k in ("model", "state", "state64", "snaps", "feed",
                           "pins", "grads", "lrs"))
    sgd = {k for k, o in state.optimizers.items()
           if isinstance(o, torch.optim.SGD)}

    def on_card(phase, pname, pre, at, nets, opts, pin=None):
        """``phase`` on the card from a snapshot; for a pinned phase
        replayed against the CPU's record, ``pin`` or not."""
        for k, net in state.nets.items():
            net.load_state_dict(nets[k])
            state.optimizers[k].load_state_dict(opts[k])
        cctx = copied(pre, "cuda")
        if at is not None:
            cctx["masks"] = feed.at(at, "cuda")
        signs = BASE_SIGNS.get(name, ("",))[0] == pname
        grad_net = BASE_GRAD_PINS.get(name, {}).get(pname)
        seen = None
        if grad_net is not None:
            with grads.replay(pname, state.nets[grad_net], pin):
                phase(model, state, cctx)
            seen = grads.seen
        elif pin is None and not signs:
            phase(model, state, cctx)
        else:
            fed = [state.nets[k] for k in TRUNKS
                   if pname in BASE_FED.get(name, ())]
            critic = BASE_SIGNS[name][1] if signs else "Dis_en"
            with pins.replay((pname,), fed, state.nets[critic], bool(pin)):
                phase(model, state, cctx)
            seen = pins.seen
        got = {k: float(v) for k, v in cctx["metrics"].items()
               if k not in pre["metrics"] or float(v) != float(
                   pre["metrics"][k])}
        return got, s2d_params(state), seen

    for i, (pname, phase) in enumerate(model.PHASES):
        (nets, opts, pre, at), (nets_after, _, post, _) = (snaps[i],
                                                          snaps[i + 1])
        grad_net = BASE_GRAD_PINS.get(name, {}).get(pname)
        pinned = pname in BASE_PINNED.get(name, ()) or grad_net is not None
        runs = {"": on_card(phase, pname, pre, at, nets, opts,
                            False if pinned else None)}
        if pinned:
            runs["pinned "] = on_card(phase, pname, pre, at, nets, opts, True)
            own = float64_phase(model, state64, nets, opts, pre, phase)
        for kind, (got, after, seen) in runs.items():
            prel = rel_loss_diffs(got, {k: float(post["metrics"][k])
                                        for k in got})
            bad.update({f"{kind}{pname}:{k}": v for k, v in prel.items()
                        if not k.startswith("acc") and v > S2D_CPU_LOSS_REL})
            for net in BASE_UPDATES[name][pname]:
                want = {n: nets_after[net][n] for n in after[net]}
                before = {n: nets[net][n].cpu() for n in after[net]}
                ok, nums = base_params_close(after[net], want, before,
                                             lrs[net], net in sgd)
                held = kind or not pinned
                extra = ""
                if grad_net is not None:
                    extra = (f"; the gradient at {grad_net}'s output "
                             f"{seen['grad']:.1e} of the largest from the "
                             "CPU's")
                elif pinned:
                    extra = f"; {pins_said(seen)}"
                elif seen is not None:
                    extra = (f"; {seen['relu']} of {BASE_SIGNS[name][1]}'s "
                             "LeakyReLU inputs on the other side of 0 from "
                             "the CPU's")
                if kind and grad_net is None:
                    ok = ok and max(seen["outputs"], seen["feats"] or 0.0
                                    ) <= PIN_OUT_REL
                elif pinned:
                    extra += "; reported: float64 (CPU " + ", ".join(
                        f"{k} {v:.3g}" for k, v in base_params_close(
                            want, own[net], before, lrs[net],
                            net in sgd)[1].items()) + "; card " + ", ".join(
                        f"{k} {v:.3g}" for k, v in base_params_close(
                            after[net], own[net], before, lrs[net],
                            net in sgd)[1].items()) + ")"
                log(f"{tag}:   phase {pname} {kind}from the CPU's input, "
                    f"{net}: losses " + " ".join(
                        f"{k} {v:.1e}" for k, v in prel.items()) + "; "
                    + ", ".join(f"{k} {v:.3g}" for k, v in nums.items())
                    + extra)
                if held and not ok:
                    bad[f"{kind}{pname}:{net}"] = nums
    out = first["out"]
    del model, state, state64, first
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{name} card vs CPU: {bad}")
    return out


def phase_base_bf16(name):
    """Phase 19b (20b, 21b) for ``name``: the first bf16 step against the
    fp32 one from one seed and batch (``BASE_BF16_BATCH``), all losses
    finite and within 5e-2 relative, both as the step first computes each
    (the D losses of S2D_nd's first D phase, from the init) and as it
    ends; the end value of a ``BASE_REPORTED`` loss (and its only value,
    where the last phase first computes it) is reported, and the last
    phase is held from the fp32 step's input to it instead: for a model
    of ``BASE_BF16_FED`` with the features its nets there give the critic
    taken from the fp32 step, and reported without them."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    batch = on(s2d_batch(BASE_BF16_BATCH, seed=19, size=(BASE_H, BASE_W)),
               "cuda")
    reported = BASE_REPORTED.get(name, ())
    fed = BASE_BF16_FED.get(name, ())
    pins = CriticPins()
    runs, snap, fresh = {}, None, set()
    for dtype in ("float32", "bfloat16"):
        model = create_model(base_config(name, dtype=dtype))
        state = model.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for net in state.nets.values():
            net.train()
        ctx, first = model._ctx(state=state, batch=batch), {}
        for i, (_, phase) in enumerate(model.PHASES):
            last = (reported and dtype == "float32"
                    and i == len(model.PHASES) - 1)
            if last:
                snap = s2d_snapshot(state, ctx, "cuda")
            with (pins.record("last", [state.nets[k] for k in fed])
                  if last and fed else contextlib.nullcontext()):
                phase(model, state, ctx)
            for k, v in ctx["metrics"].items():
                first.setdefault(k, float(v))
        torch.cuda.synchronize()
        runs[dtype] = (first, {k: float(v) for k, v in
                               ctx["metrics"].items()},
                       torch.cuda.max_memory_allocated())
        if snap is not None and dtype == "bfloat16":
            before = {k: float(v) for k, v in snap[2]["metrics"].items()}
            fresh = {k for k in reported if k not in before}
            for kind in ("unfed", "last") if fed else ("last",):
                for k, net in state.nets.items():
                    net.load_state_dict(snap[0][k])
                    state.optimizers[k].load_state_dict(snap[1][k])
                cctx = copied(snap[2], "cuda")
                feeding = kind == "last" and fed
                with (pins.replay(["last"], [state.nets[k] for k in fed])
                      if feeding else contextlib.nullcontext()):
                    model.PHASES[-1][1](model, state, cctx)
                runs[kind] = {k: float(v) for k, v in cctx["metrics"].items()
                              if k in reported and float(v) != before.get(k)}
        del model, state, ctx
        torch.cuda.empty_cache()
    (f32, m32, pk32), (f16, m16, pk16) = runs["float32"], runs["bfloat16"]
    rel = {k: v for k, v in rel_loss_diffs(f16, f32).items()
           if not k.startswith("acc")}
    last = {k: v for k, v in rel_loss_diffs(m16, m32).items()
            if k in rel and m32[k] != f32[k]}  # rewritten by a later phase
    from_fp32 = rel_loss_diffs(runs.get("last", {}), m32)
    unfed = rel_loss_diffs(runs.get("unfed", {}), m32)
    held = [*(v for k, v in rel.items() if k not in fresh),
            *from_fp32.values(),
            *(v for k, v in last.items() if k not in reported)]
    where = (f" (the features {', '.join(fed)} give the critic from the "
             f"fp32 step, bf16's {pins.seen['feats']:.1e} of the largest "
             "from them)" if fed else "")
    log(f"phase {BASE_TAG[name]}b {name}: bf16 vs fp32, bs{BASE_BF16_BATCH}: "
        "first-step losses relative: " + " ".join(
            f"{k} {v:.1e}" + (" (reported)" if k in fresh else "")
            for k, v in rel.items())
        + "".join(f"; the step's last {k} {v:.1e}" + (
            " (reported)" if k in reported else "")
            for k, v in last.items())
        + (f"; from the fp32 step's input to the last phase{where}: "
           + " ".join(f"{k} {v:.1e}" for k, v in from_fp32.items())
           if from_fp32 else "")
        + (f"; so without the fp32 features (reported): "
           + " ".join(f"{k} {v:.1e}" for k, v in unfed.items())
           if unfed else "")
        + f"; peak fp32 {pk32 / 2 ** 30:.2f} GiB, bf16 {pk16 / 2 ** 30:.2f}"
        " GiB")
    if not all(math.isfinite(v) for v in (*f16.values(), *m16.values(),
                                          *runs.get("last", {}).values())) \
            or max(held) > BF16_LOSS_REL:
        raise AssertionError(f"{name} bf16 vs fp32: {m16} against {m32}; "
                             f"from fp32's input {from_fp32}")
    return {"rel": rel, "last": last, "from_fp32": from_fp32,
            "unfed": unfed, "peak_fp32": pk32, "peak_bf16": pk16}


def phase_base_timed(name):
    """Phase 19c (20c, 21c) for ``name``: the fp32 step timed (one warm-up,
    three timed) at each of ``BASE_BATCHES``; where the last batch does not
    fit in the card's memory, the largest of ``BASE_FALLBACK_BATCHES`` that
    does, said so."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import create_model

    out = {}
    for n in BASE_BATCHES:
        tries = (n,) if n == BASE_BATCHES[0] else (n, *BASE_FALLBACK_BATCHES)
        for k in tries:
            model = create_model(base_config(name))
            state = model.init_state()
            batch = on(s2d_batch(k, seed=23, size=(BASE_H, BASE_W)), "cuda")
            try:
                state, dt, peak = timed_steps(model, state, batch)
            except torch.cuda.OutOfMemoryError:
                del model, state, batch
                torch.cuda.empty_cache()
                log(f"phase {BASE_TAG[name]}c {name}: batch {k} does not "
                    "fit")
                continue
            flops = sum(base_step_flops(name, k)[0].values())
            log(f"phase {BASE_TAG[name]}c {name}: train step bs{k} "
                f"{BASE_H}x{BASE_W} fp32 "
                f"(TF32 off): {dt * 1e3:.1f} ms/step = {k / dt:.2f} img/s, "
                f"{flops / dt / 1e12:.1f} TFLOP/s; peak memory "
                f"{peak / 2 ** 30:.2f} GiB")
            out[f"bs{k}"] = {"ms": dt * 1e3, "img_s": k / dt, "peak": peak}
            del model, state, batch
            torch.cuda.empty_cache()
            break
        else:
            raise AssertionError(f"{name}: no batch of {tries} fits")
    return out


class GlobalOnly(contextlib.nullcontext):
    """A stand-in for ``FlopCounterMode``'s module tracker: every count
    goes to the global total."""

    parents = {"Global"}


def base_step_flops(name, n):
    """The FLOPs of one train step of ``name`` at batch ``n`` by phase,
    counted by ``torch.utils.flop_counter`` on the meta device (no device
    needed), and its parameter count. The counter runs without its module
    tracker, whose backward hooks refuse the gradient penalty's
    ``autograd.grad``; only the total is read. The tracker is the private
    ``mod_tracker`` attribute, replaced as torch 2.11 and 2.13 name it; a
    torch without it fails here."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from cycle_depth_estimation_tpu_torch.models import create_model

    model = create_model(base_config(name, batch_size=n, device="cpu"))
    model.device = torch.device("meta")
    with torch.device("meta"):
        state = model.init_state()
        batch = {k: torch.empty_like(v) for k, v in s2d_batch(
            n, size=(BASE_H, BASE_W)).items()}
    counter, by_phase = FlopCounterMode(display=False), {}
    if not hasattr(counter, "mod_tracker"):
        raise AssertionError(f"torch {torch.__version__}: FlopCounterMode "
                             "has no mod_tracker to replace")
    counter.mod_tracker = GlobalOnly()
    with counter:
        ctx = model._ctx(state=state, batch=batch)
        for pname, phase in model.PHASES:
            before = counter.get_total_flops()
            phase(model, state, ctx)
            by_phase[pname] = counter.get_total_flops() - before
    params = sum(p.numel() for net in state.nets.values()
                 for p in net.parameters())
    return by_phase, params


def phase_base_generation(names, tag):
    """Phase 19 (20, 21): 19a, 19b and 19c for each case of ``names``. None
    of these models has an InstanceNorm: the kernel counts must not move.
    (Their train CLIs run in the CPU tests, ``test_torch_port_train_cli``;
    the card runs S2D's in phase 17.)"""
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        fused_in_epilogue)

    counters = (instance_norm, instance_norm_backward, fused_in_epilogue)
    for k in counters:
        k.launches = 0
    for name in names:
        cfg = base_config(name)
        if (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) != ("try", 1,
                                                                 BASE_H):
            raise AssertionError(f"{name} defaults: {cfg}")
    out = {}
    for name in names:
        out[name] = {"card_vs_cpu": phase_base_card_vs_cpu(name)}
    for name in names:
        out[name]["bf16"] = phase_base_bf16(name)
        out[name].update(phase_base_timed(name))
    moved = {k.__name__: k.launches for k in counters if k.launches}
    if moved:
        raise AssertionError(f"{', '.join(names)} launched InstanceNorm or "
                             f"epilogue kernels: {moved}")
    log(f"phase {tag} ok: no InstanceNorm or epilogue launch")
    return out


# Phase 22: generic PTQ (models/ptq.py) at the JAX package's working points
PTQ_SITES = 3 + 2 * N_BLOCKS + 1  # conv_in, 2 downs, the blocks, conv_out
PTQ_FP32_COSINE = 0.99            # JAX tests/test_ptq.py:71-106
PTQ_S2D_COSINE, PTQ_S2D_AGREE = 0.98, 0.9  # tests/test_ptq.py:113-150
RF_ADAPTERS = len(RF_PLANES)      # InstanceNorm launches a ResNetLW forward
TASK_H, TASK_W = SEG_H, SEG_W     # T2Net's 192×640
TASK_CPU_REL = 1e-4               # 22c: card against CPU, of the largest


def synthetic_image(seed, n, h, w):
    """``synthetic_calibration_batch`` at the larger side, cropped to h×w,
    on the card."""
    import torch

    from cycle_depth_estimation_tpu_torch.models.quantization import (
        synthetic_calibration_batch)

    full = synthetic_calibration_batch(seed, n, max(h, w))
    return torch.from_numpy(full[:, :, :h, :w].copy()).cuda()


@contextmanager
def ptq_site_checks(report):
    """Phase 22a: every int8 conv that generic PTQ runs inside, held against
    the exact fp64 conv on the same int8 inputs (``torch.equal``); the
    geometries seen are tallied in ``report``."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import ptq
    from cycle_depth_estimation_tpu_torch.ops import int8_conv

    real = int8_conv.conv2d_int8

    def checked(x, kernel, stride=1, padding=0, dilation=1, groups=1):
        got = real(x, kernel, stride, padding, dilation, groups)
        want = int8_conv.plain_conv2d_int8(x, kernel, stride, padding,
                                           dilation, groups)
        kh, kw, cin, cout = kernel.shape
        what = (f"{kh}x{kw} cin {cin * groups} cout {cout} stride {stride} "
                f"padding {padding} dilation {dilation} groups {groups} on "
                f"{tuple(x.shape)}")
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {what} differs from the fp64 "
                                 "conv")
        rows = got.shape[0] * got.shape[1] * got.shape[2]
        report["sites"] += 1
        report["dilated"] += int(max(int8_conv._pair(dilation)) > 1)
        report["grouped"] += int(groups > 1)
        report["rows_padded"] += int(rows < int8_conv._INT_MM_MIN_ROWS)
        report["shapes"].add(what)
        return got

    with mock.patch.object(ptq, "conv2d_int8", checked), \
            mock.patch.object(int8_conv, "conv2d_int8", checked):
        yield


def phase_ptq_generator(g, x, y_fp32, earlier_ms, report):
    """Phase 22, the main path's generator: calibrated on 4 structured
    images other than ``x``, 22 sites, served int8 (each site checked,
    22a), cosine against fp32, ms and img/s beside phases 3, 4 and 6; then
    the ConvTranspose opt-in likewise."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import ptq
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm)

    calib = synthetic_image(2, 4, SIZE, SIZE)
    out = {}
    for mode, pred, n_sites in (
            ("convs", ptq.default_predicate, PTQ_SITES),
            ("convs and ConvTranspose", lambda k, m: isinstance(m, ptq.CONVS),
             PTQ_SITES + 2)):
        with counted(instance_norm, PER_FORWARD, f"ptq calibration, {mode}"):
            sites = ptq.calibrate_model(g, calib, predicate=pred)
        if len(sites) != n_sites:
            raise AssertionError(f"ptq {mode}: {len(sites)} sites, want "
                                 f"{n_sites}: {list(sites)}")
        with counted(instance_norm, PER_FORWARD, f"ptq forward, {mode}"), \
                ptq_site_checks(report):
            y = ptq.int8_apply(g, sites, x)
        torch.cuda.synchronize()
        cos = cosine(y, y_fp32)
        if not (torch.isfinite(y).all() and cos >= PTQ_FP32_COSINE):
            raise AssertionError(f"ptq {mode}: cosine vs fp32 {cos}")
        iters = 5
        with counted(instance_norm, (iters + 3) * PER_FORWARD,
                     f"ptq timing, {mode}"):
            t = ms_per_call(lambda: ptq.int8_apply(g, sites, x), iters=iters)
        out[mode] = {"sites": n_sites, "cosine": cos, "ms": t,
                     "img_s": BATCH / t * 1e3}
        log(f"phase 22: generic PTQ ({mode}) bs{BATCH} {SIZE}^2: {n_sites} "
            f"sites, cosine vs fp32 {cos:.6f}; {t:.2f} ms/forward = "
            f"{BATCH / t * 1e3:.1f} img/s (" + ", ".join(
                f"{k} {v:.2f} ms = {BATCH / v * 1e3:.1f} img/s"
                for k, v in earlier_ms.items()) + ")")
    return out


def phase_ptq_rf_lw(report):
    """Phase 22, rf_lw's ResNetLW-101 at 192×576, batch 1: calibrated on
    'real', served in both domains ('syn' runs its own adapters in float);
    pred cosine against fp32 in each."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import ptq
    from cycle_depth_estimation_tpu_torch.models.refinenet import (
        define_rf_lw_nets)
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm)

    net = define_rf_lw_nets(rf_config(), torch.Generator().manual_seed(0)
                            )["G"].cuda().eval()
    calib, x = (synthetic_image(s, 1, RF_H, RF_W) for s in (5, 6))
    with counted(instance_norm, RF_ADAPTERS, "rf_lw ptq calibration"):
        sites = ptq.calibrate_model(net, calib, "real")
    out = {"sites": len(sites)}
    for domain in ("real", "syn"):
        with torch.no_grad(), counted(instance_norm, 2 * RF_ADAPTERS,
                                      f"rf_lw {domain} forwards"):
            _, pred_fp, _ = net(x, domain)
            with ptq_site_checks(report):
                _, pred_q, _ = ptq.int8_apply(net, sites, x, domain)
        cos = cosine(pred_q, pred_fp)
        if not (torch.isfinite(pred_q).all() and cos >= PTQ_FP32_COSINE):
            raise AssertionError(f"rf_lw ptq {domain}: pred cosine {cos}")
        out[domain] = cos
    iters = 5
    with counted(instance_norm, 2 * (iters + 3) * RF_ADAPTERS,
                 "rf_lw ptq timing"):
        t_q = ms_per_call(lambda: ptq.int8_apply(net, sites, x, "real"),
                          iters=iters)
        with torch.no_grad():
            t_fp = ms_per_call(lambda: net(x, "real"), iters=iters)
    out.update(ms=t_q, fp32_ms=t_fp)
    log(f"phase 22: generic PTQ rf_lw ResNetLW-101 bs1 {RF_H}x{RF_W}: "
        f"{len(sites)} sites; pred cosine vs fp32 real {out['real']:.6f}, "
        f"syn {out['syn']:.6f}; {t_q:.2f} ms/forward int8, {t_fp:.2f} fp32")
    return out


def phase_ptq_s2d(report):
    """Phase 22, the S2D chain G_1 → G_2 (DenseNet-169) → R_D at 192×576,
    batch 1: each net calibrated on its fp32 input from one image, the
    chain served int8 on another; depth and seg cosine against fp32 and
    the seg argmax agreement."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import ptq
    from cycle_depth_estimation_tpu_torch.models.s2d_networks import (
        define_s2d_nets)

    nets = define_s2d_nets(s2d_config(), torch.Generator().manual_seed(0))
    g1, g2, rd = (nets[k].cuda().eval() for k in ("G_1", "G_2", "R_D"))
    calib, x = (synthetic_image(s, 1, S2D_H, S2D_W) for s in (7, 8))
    with torch.no_grad():
        y_c = g1(calib)
        psp_c, feats_c = g2(y_c, "S")
        y = g1(x)
        psp, feats = g2(y, "S")
        _, seg_fp, (_, dep_fp) = rd(feats, psp)
    sites = [ptq.calibrate_model(g1, calib), ptq.calibrate_model(g2, y_c, "S"),
             ptq.calibrate_model(rd, feats_c, psp_c)]
    with ptq_site_checks(report):
        y_q = ptq.int8_apply(g1, sites[0], x)
        psp_q, feats_q = ptq.int8_apply(g2, sites[1], y_q, "S")
        _, seg_q, (_, dep_q) = ptq.int8_apply(rd, sites[2], feats_q, psp_q)
    out = {"sites": [len(s) for s in sites], "depth": cosine(dep_q, dep_fp),
           "seg": cosine(seg_q, seg_fp),
           "agree": float((seg_q.argmax(1) == seg_fp.argmax(1)).double()
                          .mean())}
    if not (out["depth"] >= PTQ_S2D_COSINE and out["seg"] >= PTQ_S2D_COSINE
            and out["agree"] > PTQ_S2D_AGREE):
        raise AssertionError(f"S2D chain ptq: {out}")
    log(f"phase 22: generic PTQ S2D chain bs1 {S2D_H}x{S2D_W}: sites "
        f"{out['sites']}; depth cosine {out['depth']:.6f}, seg cosine "
        f"{out['seg']:.6f}, seg argmax agreement {out['agree']:.4f}")
    return out


def phase_ptq_cli(g):
    """Phase 22b: the test CLI in process, ``--model test --model_suffix
    _A --int8 --device cuda`` on the generator saved as a run's
    ``latest_net_G_A.pth``: the gallery and the site count."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm)
    from cycle_depth_estimation_tpu_torch.test import main as test_main

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        os.makedirs(os.path.join(tmp, "ck", "smoke"))
        rng = np.random.RandomState(1)
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
                            ).save(os.path.join(data, f"im{i}.png"))
        torch.save({k: v.cpu() for k, v in g.state_dict().items()},
                   os.path.join(tmp, "ck", "smoke", "latest_net_G_A.pth"))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), \
                counted(instance_norm, 5 * PER_FORWARD, "test CLI --int8"):
            web_dir = test_main([
                "--dataroot", data, "--checkpoints_dir",
                os.path.join(tmp, "ck"), "--name", "smoke", "--model", "test",
                "--model_suffix", "_A", "--int8", "--netG",
                f"resnet_{N_BLOCKS}blocks", "--ngf", str(NGF), "--fine_size",
                str(SIZE), "--results_dir",
                os.path.join(tmp, "results"), "--device", "cuda"])
        text = printed.getvalue()
        images = sorted(os.listdir(os.path.join(web_dir, "images")))
        said = f"int8 serving: {PTQ_SITES} conv sites quantized"
        if said not in text or "no checkpoint" in text or len(images) != 8:
            raise AssertionError(f"test CLI --int8: {images}\n{text[-2000:]}")
    log(f"phase 22b ok: python -m cycle_depth_estimation_tpu_torch.test "
        f"--model test --model_suffix _A --int8 --device cuda served "
        f"latest_net_G_A.pth: '{said}', {len(images)} images")


def phase_task_nets():
    """Phase 22c: ResGenerator and PreUNet16 at 192×640, ngf 64, batch 1,
    the MultiscaleDiscriminator (ndf 64, 2 scales) on the image and the
    FeatureDiscriminator (512×12×40) on PreUNet16's center features, each
    the card's forward against the CPU's with the same weights. The
    weights are xavier at gain 1 (the factories' 0.02 shrinks the outputs
    toward fp32's subnormals, 1e-31 at the FeatureDiscriminator)."""
    import torch

    from cycle_depth_estimation_tpu_torch.models import seg_network as sn
    from cycle_depth_estimation_tpu_torch.ops.init import (init_tensor,
                                                           init_weights)

    gen = torch.Generator().manual_seed(0)
    nets = {"ResGenerator": sn.define_task_G(model_type="ResNet",
                                             generator=gen),
            "PreUNet16": sn.define_task_G(model_type="PreUNet16",
                                          generator=gen),
            "MultiscaleDiscriminator": sn.define_task_D(num_d=2,
                                                        generator=gen),
            "FeatureDiscriminator": sn.define_feature_D(
                feature_hw=(TASK_H // 16, TASK_W // 16), generator=gen)}
    for net in nets.values():
        init_weights(net, "xavier", 1.0, gen)
        for m in net.modules():
            if isinstance(m, torch.nn.Linear):
                init_tensor(m.weight, "xavier", 1.0, gen)
    x = synthetic_image(9, 1, TASK_H, TASK_W).cpu()
    errs = {}
    with torch.no_grad():
        for name, net in nets.items():
            net.eval()
            inp = x if name != "FeatureDiscriminator" else center
            want = net(inp)
            if name == "PreUNet16":
                center = want[0]
            got = copy.deepcopy(net).cuda()(inp.cuda())
            want = want if isinstance(want, list) else [want]
            got = got if isinstance(got, list) else [got]
            top = max(float(w.abs().max()) for w in want)
            err = max(float((g_.cpu() - w).abs().max())
                      for g_, w in zip(got, want))
            shapes = [tuple(w.shape) for w in want]
            if not (err <= TASK_CPU_REL * top and all(
                    torch.isfinite(g_).all() for g_ in got)):
                raise AssertionError(f"{name}: card vs CPU {err} of {top}")
            errs[name] = err / top
            log(f"phase 22c: {name} {shapes}: card vs CPU max abs "
                f"{err:.3g} ({err / top:.2e} of the largest)")
    return errs


def phase_ptq(g, x, y_fp32, earlier_ms):
    """Phases 22–22c; returns what the summary reports."""
    import torch

    report = {"sites": 0, "dilated": 0, "grouped": 0, "rows_padded": 0,
              "shapes": set()}
    out = {"generator": phase_ptq_generator(g, x, y_fp32, earlier_ms,
                                            report)}
    torch.cuda.empty_cache()
    out["rf_lw"] = phase_ptq_rf_lw(report)
    torch.cuda.empty_cache()
    out["s2d"] = phase_ptq_s2d(report)
    torch.cuda.empty_cache()
    log(f"phase 22a ok: {report['sites']} int8 convs on the PTQ paths' own "
        f"inputs torch.equal to the fp64 conv ({report['dilated']} dilated, "
        f"{report['grouped']} grouped, {report['rows_padded']} with 16 GEMM "
        f"rows or fewer; {len(report['shapes'])} geometries)")
    phase_ptq_cli(g)
    out["task_nets"] = phase_task_nets()
    log("phase 22 ok")
    return out


# Phase 23: data, ZeRO and tensor parallelism (parallel/)
PAR_LAYOUTS = {"dp": {}, "zero opt": {"zero": "opt"},
               "zero fsdp": {"zero": "fsdp"},
               "tp": {"mesh_shape": [1, 2], "parallel": "tp"}}
PAR_RANKS = 2           # sharing the one card over gloo
PAR_EPS = 1e-3          # 23b's Adam eps on both sides (the models' is 1e-8)
PAR_GRAD_REL = 1e-5     # synced gradients, of the largest
PAR_GRAD_RUNS = 4.0     # the rest together: × two one-process runs' L2
PAR_LOSS_REL = 1e-4
PAR_S2D_LOSS_REL = 1e-3  # S2D's later phases read the earlier updates
PAR_S2D = {"model": "S2D", "batch_size": 2}
PAR_WIDTHS = {}         # config overrides of 23b's CycleGAN; empty: full


def cycle_cli_args(tmp, name, *extra):
    """The train CLI at phase 8's working point (two 9-block generators, ngf
    64, batch 8, 256², fp32, TF32 off) on ``tmp``'s PNGs, one epoch of two
    steps, each step's losses printed."""
    return ["--dataroot", tmp, "--checkpoints_dir", os.path.join(tmp, "ck"),
            "--name", name, "--model", "cycle_gan", "--ngf", str(NGF),
            "--ndf", str(NDF), "--netG", f"resnet_{N_BLOCKS}blocks",
            "--batch_size", str(BATCH), "--load_size", str(SIZE),
            "--fine_size", str(SIZE), "--niter", "1", "--niter_decay", "0",
            "--save_epoch_freq", "1", "--print_freq", str(BATCH),
            "--display_freq", "100000", "--save_latest_freq", "100000",
            "--tpu_precision", "highest", "--num_threads", "2", "--device",
            "cuda", *extra]


def saved_tensors(expr):
    """Every tensor a train CLI run saved for epoch 1 (nets, optimizer
    states, pools), by a path of keys."""
    import torch

    out = {}

    def walk(prefix, v):
        if torch.is_tensor(v):
            out[prefix] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)

    for f in sorted(os.listdir(expr)):
        if f.startswith("1_") and f.endswith(".pth"):
            walk(f, torch.load(os.path.join(expr, f), map_location="cpu",
                               weights_only=True))
    return out


def max_apart(a, b):
    if a.keys() != b.keys():
        raise AssertionError(f"saved different tensors: {a.keys() ^ b.keys()}")
    return max(float((a[k].double() - b[k].double()).abs().max())
               if a[k].numel() else 0.0 for k in a)


def step_times(text):
    """The ``time:`` of each step a CLI printed, in s."""
    return [float(ln.split("time: ")[1].split(",")[0])
            for ln in text.splitlines() if ln.startswith("(epoch: ")]


def par_cli_run(run, name):
    """``end_cli`` of one of 23a's CLI runs: its output, seconds, each
    step's time and every tensor it saved."""
    text, seconds = end_cli(run, f"train CLI ({name})")
    times = step_times(text)
    if len(times) != 2:
        raise AssertionError(f"{name}: {len(times)} steps:\n{text}")
    return {"text": text, "s": seconds, "times": times,
            "saved": saved_tensors(os.path.join(run["tmp"], "ck", name))}


def phase_parallel():
    """Phase 23. 23a: the train CLI under ``--parallel dp`` in a world of
    one over NCCL (``--coordinator_address``) against the plain CLI run
    twice: its state after two steps ``torch.equal`` to the plain run's,
    or, where the two plain runs differ (cuDNN's backward), within twice
    that. The first plain run and the dp run are timed alone; the second
    plain run, the yardstick, runs beside 23b. Then 23b."""
    import numpy as np
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.parallel.dryrun import free_port

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(23)
        for phase in ("trainA", "trainB"):
            os.makedirs(os.path.join(tmp, phase))
            for i in range(2 * BATCH):  # two steps
                Image.fromarray(rng.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
                                ).save(os.path.join(tmp, phase, f"im{i}.png"))

        def start(name, *extra):
            run = start_cli(TRAIN_CLI, cycle_cli_args(tmp, name, *extra))
            run["tmp"] = tmp
            return run

        runs = {"plain1": par_cli_run(start("plain1"), "plain1"),
                "dp": par_cli_run(start(
                    "dp", "--parallel", "dp", "--coordinator_address",
                    f"localhost:{free_port()}", "--num_processes", "1",
                    "--process_index", "0"), "dp")}
        plain2 = start("plain2")
        try:
            ranks = phase_parallel_ranks()
        finally:
            runs["plain2"] = par_cli_run(plain2, "plain2")
    if "backend nccl" not in runs["dp"]["text"]:
        raise AssertionError("the world of one did not take NCCL:\n"
                             + runs["dp"]["text"][:2000])
    plain = max_apart(runs["plain1"]["saved"], runs["plain2"]["saved"])
    dp = min(max_apart(runs["dp"]["saved"], runs[p]["saved"])
             for p in ("plain1", "plain2"))
    bar = 2 * plain
    if dp > bar:
        raise AssertionError(f"23a: --parallel dp state {dp:.3e} from the "
                             f"plain run's; the plain runs differ by "
                             f"{plain:.3e}")
    log(f"phase 23a ok: train CLI, CycleGAN {N_BLOCKS} blocks ngf {NGF} "
        f"{SIZE}^2 batch {BATCH} fp32 TF32 off, 2 steps: --parallel dp in a "
        f"world of one over NCCL {'torch.equal to' if dp == 0 else 'within '}"
        f"{'' if dp == 0 else f'{dp:.3e} of'} the plain run's state "
        f"({len(runs['dp']['saved'])} tensors; the two plain runs differ by "
        f"{plain:.3e}, bar {'equal' if plain == 0 else f'{bar:.3e}'}); "
        f"second step {runs['plain1']['times'][1] * 1e3:.1f} ms plain, "
        f"{runs['dp']['times'][1] * 1e3:.1f} ms --parallel dp (each alone "
        "on the card); CLI "
        + ", ".join(f"{k} {v['s']:.1f} s" for k, v in runs.items())
        + " (plain2 beside 23b)")
    log(f"phase 23: {time.perf_counter() - t:.1f} s")
    return runs, ranks


def phase_parallel_ranks():
    """Phase 23b: two ranks sharing the card over gloo, one spawn for every
    case: the CycleGAN step of phase 8's width at global batch 8 (4 rows a
    rank) under ``dp``, ``--zero opt``, ``--zero fsdp`` and ``--mesh_shape
    1 2 --parallel tp`` (both ranks all 8 rows), each against the
    single-process step on the card from the same seed, TF32 off and
    Adam's eps at 1e-3 on both sides: each synced generator gradient
    within 1e-5 of the largest, and those that are not (cuDNN's fp32
    weight gradients, summed over 256² planes, vary run to run by up to
    ~2e-3 of the largest), taken together, within four times the L2
    distance of two runs of the one process on them (one small tensor's
    two runs are too few samples to be a yardstick alone; a gradient left
    unsynced makes the ranks' parameters differ, and one summed where it
    is averaged is off by its own size); losses within 1e-4, parameters
    by the three pooled checks, the ranks' parameters equal, 192 + 192
    InstanceNorm launches a rank a step; and S2D at batch 2 (a row a
    rank), 192×576, under ``dp``, each phase held from the one-process
    state and input before it (``dryrun.phase_by_phase``, as phase 17b
    holds the card against the CPU): its losses within 1e-3 and every
    net's parameters by the three checks at its own lr."""
    import torch

    from cycle_depth_estimation_tpu_torch.parallel import dryrun

    t = time.perf_counter()
    cyc = {"model": "cycle_gan", "batch_size": BATCH, "fine_size": SIZE,
           "ngf": NGF, "ndf": NDF, "net_g": f"resnet_{N_BLOCKS}blocks",
           "tpu_precision": "highest", **PAR_WIDTHS}
    gen = torch.Generator().manual_seed(23)
    batch = {k: torch.rand(BATCH, 3, SIZE, SIZE, generator=gen) * 2 - 1
             for k in ("img_source", "img_target")}
    s2d = {**PAR_S2D, **S2D_WIDTHS, "adam_eps": PAR_EPS,
           "tpu_precision": "highest"}
    s2d_b = s2d_batch(PAR_S2D["batch_size"], seed=23, size=(S2D_H, S2D_W))
    cases = {name: (dryrun.model_step,
                    (cyc, batch, layout, None, PAR_EPS, 1, True))
             for name, layout in PAR_LAYOUTS.items()}
    cases["S2D dp"] = (dryrun.phase_by_phase, (s2d, s2d_b))
    one, again = (dryrun.model_step(cyc, batch, {}, None, PAR_EPS, 1, True)
                  for _ in range(2))
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t
    ranks = dryrun.spawn(dryrun.run_cases, PAR_RANKS, (cases,),
                         device="cuda", timeout=900, threads=2)
    t_ranks = time.perf_counter() - t - t_one

    g1 = one["grads"]
    big = max(float(g.abs().max()) for g in g1.values())
    # the one process's own run-to-run distance, in L2, per tensor
    own = {k: float((g1[k].double() - again["grads"][k].double()).norm())
           for k in g1}
    lines, misses = [], []
    for case in PAR_LAYOUTS:
        worst = {"loss": 0.0, "past_lr": 0.0, "grad": (0.0, "")}
        for r in ranks:
            got, tag = r[case], f"23b {case} rank {r[case]['rank']}"
            per = TRAIN_PER_STEP
            if got["launches"] != [(per, per)]:
                misses.append(f"{tag}: InstanceNorm launches "
                              f"{got['launches']}, want {per} + {per}")
            loss = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-2)
                       for k, v in one["metrics"].items())
            if loss > PAR_LOSS_REL:
                misses.append(f"{tag}: losses {loss:.2e} apart")
            worst["loss"] = max(worst["loss"], loss)
            past = []  # the tensors past 1e-5 of the largest, held together
            for k, g in g1.items():
                d = float((got["grads"][k] - g).abs().max())
                worst["grad"] = max(worst["grad"], (d / big, k))
                if d > PAR_GRAD_REL * big:
                    past.append(k)
            if past:
                l2 = math.sqrt(sum(float(
                    (got["grads"][k].double() - g1[k].double()).norm()) ** 2
                    for k in past))
                runs_l2 = math.sqrt(sum(own[k] ** 2 for k in past))
                worst["by_runs"] = max(worst.get("by_runs", (0.0, 0)),
                                       (l2 / max(runs_l2, 1e-30), len(past)))
                if l2 > PAR_GRAD_RUNS * runs_l2:
                    misses.append(f"{tag}: the {len(past)} synced gradients "
                                  f"past 1e-5 of the largest are {l2:.3e} "
                                  f"apart in L2; two one-process runs "
                                  f"{runs_l2:.3e}")
            for name, sd in one["params"].items():
                stats = dryrun.params_apart(got["params"][name], sd, 2e-4)
                if not stats["ok"]:
                    misses.append(f"{tag} {name} parameters apart: {stats}")
                worst["past_lr"] = max(worst["past_lr"], stats["past_lr"])
        a, b = (r[case]["params"] for r in ranks)
        unequal = [f"{n}.{k}" for n, sd in a.items() for k, v in sd.items()
                   if not torch.equal(v, b[n][k])]
        if unequal:
            misses.append(f"23b {case}: the ranks' {unequal[:3]} differ")
        mem = "; ".join(
            f"rank {r[case]['rank']} holds "
            + ", ".join(f"{k} {v / 2 ** 20:.1f}"
                        for k, v in r[case]["resident_bytes"].items())
            + f" MiB (allocated {r[case]['allocated_bytes'] / 2 ** 30:.2f} "
            "GiB)" for r in ranks)
        rep = ranks[0][case]["memory_report"]
        lines.append(
            f"{case}: losses {worst['loss']:.2e} apart, gradients "
            f"{worst['grad'][0]:.2e} of the largest ({worst['grad'][1]}"
            + (f"; the {worst['by_runs'][1]} tensors past 1e-5 "
               f"{worst['by_runs'][0]:.2f}× the two one-process runs' L2 "
               "distance" if "by_runs" in worst else "")
            + f"), past lr {worst['past_lr']:.2e}; launches "
            f"{ranks[0][case]['launches'][0]} a rank a step; memory_report "
            f"replicated {rep['replicated_total_mib']} MiB, zero "
            f"{rep['zero_total_mib']} MiB a rank ({rep['mesh_axis']}); {mem}")
    s2d_lines = []
    for r in ranks:
        for ph in r["S2D dp"]:
            tag = f"23b S2D dp rank {ranks.index(r)} phase {ph['phase']}"
            bad = {k: v for k, v in ph["losses"].items()
                   if not k.startswith("acc") and v > PAR_S2D_LOSS_REL}
            if bad:
                misses.append(f"{tag}: losses apart {bad}")
            for name, st in ph["nets"].items():
                if not st["ok"]:
                    misses.append(f"{tag} {name}: {st}")
            if r is ranks[0]:
                s2d_lines.append(
                    f"{ph['phase']} losses ≤ "
                    f"{max(ph['losses'].values(), default=0.0):.1e}, "
                    + ", ".join(f"{k} {v['max_over_lr']:.2g} lr"
                                for k, v in ph["nets"].items()
                                if v["max_over_lr"] > 0))
    runs = max((float((g1[k] - again["grads"][k]).abs().max()) / big, k)
               for k in g1)
    log(f"phase 23b: {PAR_RANKS} ranks sharing the card over gloo, "
        f"CycleGAN {N_BLOCKS} blocks ngf {NGF} {SIZE}^2 global batch {BATCH} "
        f"and S2D {S2D_H}x{S2D_W} batch {PAR_S2D['batch_size']}, each against "
        f"one process, run twice ({t_one:.1f} s), ranks {t_ranks:.1f} s; the "
        f"two one-process runs' gradients ≤ {runs[0]:.2e} of the largest "
        f"apart ({runs[1]}); " + " | ".join(lines)
        + " | S2D dp, phase by phase from one process: "
        + "; ".join(s2d_lines))
    if misses:
        raise AssertionError("23b: " + "; ".join(misses))
    counted = [r[c]["launches"] for r in ranks for c in PAR_LAYOUTS]
    return {"fwd": sum(f for ls in counted for f, _ in ls),
            "bwd": sum(b for ls in counted for _, b in ls)}


LOADERS = {  # name: the train CLI's loader flags
    "serial": ["--num_threads", "0"],
    "4 threads (the default)": ["--num_threads", "4"],
    "4 processes": ["--worker_procs", "4"],
    "serial, --device_aug": ["--num_threads", "0", "--device_aug"],
    "4 threads, --device_aug": ["--num_threads", "4", "--device_aug"],
}


def bench_loaders(n_images=96):
    """The pix2pix train CLI at the JAX defaults (unet_256, batch 8,
    load_size 286, fine_size 256) on ``n_images`` aligned 256×512 JPEGs
    (the facades layout), once per loader of ``LOADERS``, two epochs each,
    as ``python -m`` in a process of its own. From the CLI's per-step lines
    (``--print_freq`` one batch): the wait for the first batch of epoch 1
    (pool start included), and in epoch 2 the mean wait for a batch
    (``data:``) and the mean step (``time:``)."""
    import re

    import numpy as np
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.models.quantization import (
        synthetic_calibration_batch)

    line = re.compile(r"\(epoch: (\d+), iters: \d+, time: ([\d.]+), "
                      r"data: ([\d.]+)\)")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "train"))
        img = synthetic_calibration_batch(5, n_images, SIZE)
        img = ((img.transpose(0, 2, 3, 1) + 1) * 127.5).round().astype(np.uint8)
        for i in range(n_images):
            Image.fromarray(np.concatenate([img[i], img[(i + 1) % n_images]],
                                           axis=1)).save(
                os.path.join(tmp, "train", f"{i:03d}.jpg"), quality=95)
        results = {}
        for name, flags in LOADERS.items():
            out, wall = end_cli(start_cli(TRAIN_CLI, [
                "--dataroot", tmp, "--model", "pix2pix", "--checkpoints_dir",
                os.path.join(tmp, "ck"), "--name", "bench", "--batch_size",
                str(BATCH), "--niter", "2", "--niter_decay", "0",
                "--print_freq", str(BATCH), "--display_freq", "1000000000",
                "--save_latest_freq", "1000000000", "--save_epoch_freq",
                "1000", "--device", "cuda", *flags], threads=None),
                f"loader {name}")
            steps = [(int(e), float(ts), float(td))
                     for e, ts, td in line.findall(out)]
            e2 = [(ts, td) for e, ts, td in steps if e == 2]
            if len(steps) != 2 * (n_images // BATCH) or not e2:
                raise AssertionError(f"{name}: {len(steps)} step lines")
            r = {"first_batch_s": steps[0][2],
                 "data_s_per_step": float(np.mean([td for _, td in e2])),
                 "step_s": float(np.mean([ts for ts, _ in e2])),
                 "wall_s": wall}
            r["img_per_s"] = BATCH / (r["data_s_per_step"] + r["step_s"])
            results[name] = r
            log(f"loaders: {name}: first batch {r['first_batch_s']:.3f} s; "
                f"epoch 2: data {r['data_s_per_step'] * 1e3:.1f} ms/step, "
                f"step {r['step_s'] * 1e3:.1f} ms, so {r['img_per_s']:.1f} "
                f"img/s; call {wall:.1f} s")
    log("loaders: " + json.dumps(results))


def main() -> int:
    import torch

    sweep = sys.argv[1:2] == ["--sweep-epilogue"] and len(sys.argv) <= 3
    loaders = sys.argv[1:] == ["--bench-loaders"]
    if sys.argv[1:] and not (sweep or loaders):
        print("usage: chip_smoke.py [--sweep-epilogue [TABLE] | "
              "--bench-loaders]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cycle_depth_estimation_tpu_torch.models import quantization
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, instance_norm_backward)
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        fused_in_epilogue)

    import triton

    t0 = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} triton {triton.__version__} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    if loaders:
        bench_loaders()
        check_no_children()
        return 0
    phase_build()
    if sweep:
        sweep_epilogue(gen, *sys.argv[2:])
        check_no_children()
        return 0
    in_tot, in_err = phase_instance_norm(gen)
    bwd_tot, bwd_err = phase_instance_norm_backward(gen)
    rf_kernels, rf_errs = phase_rf_lw_kernels(gen)
    ep_tot, ep_err = phase_epilogue(gen)
    phase_int8_conv(gen)

    x = torch.from_numpy(
        quantization.synthetic_calibration_batch(3, BATCH, SIZE)).cuda()
    instance_norm.launches = 0
    fused_in_epilogue.launches = 0
    g, y_fp32, ips_fp32 = phase_generator(x)
    ips_bf16, fwd_bf16 = phase_bf16(g, x)
    phase_cli()
    ips_int8, fwd_int8 = phase_fused_int8(g, x, y_fp32)
    ips_up, fwd_up = phase_up_modes(g, x, y_fp32)
    phase_profile({"bf16 generator": fwd_bf16, "fused int8": fwd_int8,
                   "fused int8, int8_phases ups": fwd_up["int8_phases"]})
    serving = {"instance_norm": instance_norm.launches,
               "int8_epilogue": fused_in_epilogue.launches}
    del fwd_bf16, fwd_int8, fwd_up
    torch.cuda.empty_cache()

    instance_norm.launches = 0
    fused_in_epilogue.launches = 0
    t_ptq = time.perf_counter()
    ptq_out = phase_ptq(g, x, y_fp32, {
        f"phase {k}": BATCH / v * 1e3 for k, v in (
            ("3 fp32", ips_fp32), ("4 bf16", ips_bf16),
            ("6 fused int8", ips_int8))})
    ptq_path = {"instance_norm": instance_norm.launches}
    if fused_in_epilogue.launches:
        raise AssertionError("generic PTQ launched the epilogue kernel")
    log(f"phase 22: {time.perf_counter() - t_ptq:.1f} s")
    del g, y_fp32
    torch.cuda.empty_cache()

    instance_norm.launches = 0
    instance_norm_backward.launches = 0
    fused_in_epilogue.launches = 0
    ips_train = phase_train_step()
    p2p_cli = start_pix2pix_cli()
    try:
        phase_train_cli()
    finally:
        p2p_cli["seconds"] = end_cli(p2p_cli.pop("cli"),
                                     "pix2pix train CLI")[1]
    training = {"instance_norm": instance_norm.launches,
                "instance_norm_bwd": instance_norm_backward.launches}
    torch.cuda.empty_cache()

    instance_norm.launches = 0
    instance_norm_backward.launches = 0
    fused_in_epilogue.launches = 0
    start_pix2pix_resume(p2p_cli)  # beside phase 10, which times nothing
    try:
        phase_unet_instance_norm(gen)
    finally:
        p2p_cli["resume_seconds"] = end_cli(p2p_cli.pop("resume"),
                                            "pix2pix train CLI resume")[1]
    ips_p2p = phase_pix2pix_step()
    phase_pix2pix_cli(p2p_cli)
    pix2pix = {"instance_norm": instance_norm.launches,
               "instance_norm_bwd": instance_norm_backward.launches}
    torch.cuda.empty_cache()

    def counts_of(run):
        instance_norm.launches = 0
        instance_norm_backward.launches = 0
        fused_in_epilogue.launches = 0
        out = run()
        return out, {"instance_norm": instance_norm.launches,
                     "instance_norm_bwd": instance_norm_backward.launches}

    ips_bf16_train, bf16_train = counts_of(phase_bf16_training)
    _, remat = counts_of(phase_remat)
    seg_cli = start_seg_cycle_cli()  # beside phase 15's checks
    try:
        (ips_seg, ips_seg16), seg_cycle = counts_of(
            lambda: phase_seg_cycle(gen, seg_cli))
    finally:
        if "cli" in seg_cli:
            end_cli(seg_cli.pop("cli"), "SegCycle train CLI")
    start_seg_cycle_resume(seg_cli)  # beside phase 16's checks
    try:
        ips_t2net, t2net = counts_of(lambda: phase_t2net(gen, seg_cli))
    finally:
        if "resume" in seg_cli:
            end_cli(seg_cli.pop("resume"), "SegCycle train CLI resume")
    s2d = phase_s2d()
    base = phase_base_generation(BASE_MODELS, "19")
    two_trunk = phase_base_generation(TWO_TRUNK, "20")
    st = phase_base_generation(ST_MODELS, "21")
    rf_cli = start_rf_lw_cli()  # beside phase 18b's checks
    try:
        rf, rf_lw = counts_of(lambda: phase_rf_lw(rf_cli))
    finally:
        if "cli" in rf_cli:
            end_cli(rf_cli.pop("cli"), "rf_lw train CLI")
    (_, par_ranks), parallel = counts_of(phase_parallel)
    parallel = {"instance_norm": parallel["instance_norm"] + par_ranks["fwd"],
                "instance_norm_bwd": (parallel["instance_norm_bwd"]
                                      + par_ranks["bwd"])}
    later = {"bf16_and_fp32_training": bf16_train,
             "remat_and_plain": remat,
             "seg_cycle": seg_cycle, "t2net": t2net, "rf_lw": rf_lw,
             "parallel": parallel}
    for path, counts in (("serving", serving), ("training", training),
                         ("pix2pix", pix2pix), ("ptq", ptq_path),
                         *later.items()):
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")

    in_bound, in_by = bound(in_tot["bytes"], in_tot["flops"])
    bwd_bound, bwd_by = bound(bwd_tot["bytes"], bwd_tot["flops"])
    ep_bound, ep_by = bound(ep_tot["bytes"], ep_tot["flops"])
    in_source = "cycle_depth_estimation_tpu_torch/ops/kernels/instance_norm.py"

    def rf_step_times(i):  # the kernel's sums over a fp32 rf_lw step
        out = {}
        for n, totals in rf_kernels.items():
            t = totals[i]
            out[f"bs{n}"] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                             "library_ms": t["library_ms"],
                             "bound_ms": bound(t["bytes"], t["flops"])[0]}
        return out

    kernels = [
        {"name": "instance_norm", "route": "triton", "source": in_source,
         "replaces": "cycle_depth_estimation_tpu/ops/pallas/instance_norm.py:55",
         "launches": (serving["instance_norm"] + training["instance_norm"]
                      + pix2pix["instance_norm"] + ptq_path["instance_norm"]
                      + sum(c["instance_norm"] for c in later.values())),
         "launches_by_path": {"serving": serving["instance_norm"],
                              "training": training["instance_norm"],
                              "pix2pix": pix2pix["instance_norm"],
                              "ptq": ptq_path["instance_norm"],
                              **{p: c["instance_norm"]
                                 for p, c in later.items()}},
         "max_abs_err": max(in_err, rf_errs[0]),
         "ms": in_tot["ms"], "plain_ms": in_tot["plain_ms"],
         "bound_ms": in_bound, "bound_by": in_by,
         "library_ms": in_tot["library_ms"],
         "rf_lw_step": rf_step_times(0)},
        {"name": "instance_norm_bwd", "route": "triton", "source": in_source,
         "replaces": "cycle_depth_estimation_tpu/ops/pallas/instance_norm.py:105",
         "launches": (training["instance_norm_bwd"]
                      + pix2pix["instance_norm_bwd"]
                      + sum(c["instance_norm_bwd"] for c in later.values())),
         "launches_by_path": {"training": training["instance_norm_bwd"],
                              "pix2pix": pix2pix["instance_norm_bwd"],
                              **{p: c["instance_norm_bwd"]
                                 for p, c in later.items()}},
         "max_abs_err": max(bwd_err, rf_errs[1]),
         "ms": bwd_tot["ms"], "plain_ms": bwd_tot["plain_ms"],
         "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": bwd_tot["library_ms"],
         "rf_lw_step": rf_step_times(1)},
        {"name": "int8_epilogue", "route": "cuda",
         "source": "cycle_depth_estimation_tpu_torch/csrc/int8_epilogue.cu",
         "replaces": "cycle_depth_estimation_tpu/ops/pallas/int8_epilogue.py:137",
         "launches": serving["int8_epilogue"], "max_abs_err": ep_err,
         "ms": ep_tot["ms"], "plain_ms": ep_tot["plain_ms"],
         "bound_ms": ep_bound, "bound_by": ep_by, "library_ms": None,
         "generic_variant_ms": ep_tot["generic_ms"],
         "int8_up_mode_forward_ms": ep_tot["up_mode_ms"],
         "int8_up_mode_forward_bound_ms": ep_tot["up_mode_bound_ms"]},
    ]
    log(f"generator img/s: fp32 {ips_fp32:.1f}, bf16 {ips_bf16:.1f}, fused "
        f"int8 {ips_int8:.1f}, "
        + ", ".join(f"{m} {v:.1f}" for m, v in ips_up.items())
        + ", generic PTQ int8 " + ", ".join(
            f"({m}) {v['img_s']:.1f}"
            for m, v in ptq_out["generator"].items())
        + f"; CycleGAN training fp32 {ips_train:.1f} img/s, pix2pix "
        f"training fp32 {ips_p2p:.1f} img/s (bs{BATCH}, {SIZE}^2), bf16 "
        + ", ".join(f"{k} {v:.1f}" for k, v in ips_bf16_train.items())
        + f" img/s; SegCycle fp32 {ips_seg:.1f}, bf16 {ips_seg16:.1f} img/s "
        f"and T2Net fp32 {ips_t2net:.1f} img/s (bs{BATCH}, {SEG_H}x{SEG_W}); "
        "S2D fp32 " + ", ".join(f"bs{n} {s2d[f'bs{n}']['img_s']:.2f}"
                                for n in S2D_BATCHES)
        + f" img/s ({S2D_H}x{S2D_W}); rf_lw fp32 "
        + ", ".join(f"bs{n} {rf[f'bs{n}']['img_s']:.2f}" for n in RF_BATCHES)
        + f" img/s ({RF_H}x{RF_W}); "
        + "; ".join(f"{m} fp32 " + ", ".join(
            f"{k} {v['img_s']:.2f}" for k, v in runs[m].items()
            if k.startswith("bs"))
            for runs in (base, two_trunk, st) for m in runs)
        + f" img/s ({BASE_H}x{BASE_W}); "
        "kernel "
        "ms are sums over the calls of one forward (23: instance_norm in "
        "bf16, int8_epilogue in bf16 up mode) or of one fp32 CycleGAN train "
        f"step ({TRAIN_PER_STEP}: instance_norm_bwd); total "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    check_no_children()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
