#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cycle_depth_estimation_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. InstanceNorm kernel (Triton) against its plain torch version at the
   generator's three plane shapes, fp32 and bf16, with kernel, plain,
   ``F.instance_norm`` and byte-bound times.
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
7. Where one bf16 and one fused int8 forward spend device time
   (``torch.profiler``), and the device's idle share.

Launch counts are zeroed just before phase 3 and read after phase 7: that
run is the main path. The last three lines are a JSON object with every
kernel's numbers, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --sweep-epilogue [TABLE]

builds the kernels and times every legal plan of the epilogue's cluster
kernel (channel tile, cluster size, threads, staged rows) at every site, each
checked against the plain version first. That is how ``plan_epilogue``'s
rules were chosen. It prints the best plans of each site, appends every
timing to the file TABLE if one is named, and prints no result line.
"""

from __future__ import annotations

import copy
import json
import os
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
EP_FLOPS_PER_ELEM = 9         # IN + relu/residual + scale, round, clip
BATCH, SIZE, NGF, N_BLOCKS = 8, 256, 64, 9

# InstanceNorm planes of one generator forward: (N, C, H, W) → calls
IN_SHAPES = {(BATCH, NGF, SIZE, SIZE): 2,
             (BATCH, 2 * NGF, SIZE // 2, SIZE // 2): 2,
             (BATCH, 4 * NGF, SIZE // 4, SIZE // 4): 2 * N_BLOCKS + 1}

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


def log(msg):
    print(msg, flush=True)


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


def phase_build():
    from cycle_depth_estimation_tpu_torch.ops.kernels import build

    t = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    paths = build.build(names)
    log(f"phase 0 ok: built {names} in {time.perf_counter() - t:.1f} s "
        f"-> {[str(p.name) for p in paths.values()]}")


def phase_instance_norm(gen):
    import torch
    import torch.nn.functional as F

    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm, plain_instance_norm)

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, calls in IN_SHAPES.items():
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
            log(f"phase 1: instance_norm {tuple(shape)} {str(dtype)[6:]}: "
                f"max_abs_err {float(err.max()):.3g} kernel {t_k:.4f} ms "
                f"plain {t_p:.4f} ms F.instance_norm {t_l:.4f} ms "
                f"bound {t_b:.4f} ms; eager back-to-back {t_e:.4f} ms "
                f"(x{calls} per forward)")
            if dtype == torch.bfloat16:  # the entry() dtype is the headline
                totals["ms"] += calls * t_k
                totals["plain_ms"] += calls * t_p
                totals["library_ms"] += calls * t_l
                totals["bytes"] += calls * nbytes
                totals["flops"] += calls * IN_FLOPS_PER_ELEM * x.numel()
            del x, xs, want, got
    log(f"phase 1 ok: instance_norm per bf16 forward {totals['ms']:.4f} ms")
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
    max_err = 0.0
    generic = ep.plan_epilogue((1, 1, 1, 1), 4)  # C = 1: the generic kernel
    ep.fused_in_epilogue.variant_launches.clear()
    for name, (shape, in_dtype, quantize, kw, calls) in EP_SITES.items():
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
        log(f"phase 2: int8_epilogue {name} {tuple(shape)} {in_dtype} {desc}: "
            f"{plan.variant} ct {plan.channel_tile} cluster {plan.cluster} "
            f"threads {plan.threads} staged {plan.staged_rows}/{plan.rows} "
            f"rows smem {plan.shared_bytes} B, "
            f"{plan.blocks(shape[0], shape[3])} blocks, {fits} clusters "
            f"resident; max_abs_err {err:.3g} int8 mismatch share {frac:.2e} "
            f"kernel {t_k:.4f} ms bound {t_b:.4f} ms ({t_k / t_b:.2f}x) "
            f"generic kernel {t_g:.4f} ms (earlier run "
            f"{EP_EARLIER_MS[name]:.3f} ms) plain {t_p:.4f} ms; eager "
            f"back-to-back {t_e:.4f} ms (x{calls} per forward)")
        totals["ms"] += calls * t_k
        totals["plain_ms"] += calls * t_p
        totals["generic_ms"] += calls * t_g
        totals["bytes"] += calls * nbytes
        totals["flops"] += calls * flops
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
    log(f"phase 2 ok: int8_epilogue per int8 forward {totals['ms']:.4f} ms; "
        f"generic (earlier) kernel now {totals['generic_ms']:.4f} ms, earlier "
        f"run {sum_earlier:.3f} ms; launches by variant {by_variant}")
    return totals, max_err


def sweep_epilogue(gen, table=None):
    """Time every legal plan of the cluster kernel at every site; append
    all timings to the file ``table`` if given."""
    import itertools

    import torch

    from cycle_depth_estimation_tpu_torch.ops.kernels import int8_epilogue as ep

    for name, (shape, in_dtype, quantize, kw, calls) in EP_SITES.items():
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


def phase_fused_int8(g, x, y_fp32):
    import torch

    from cycle_depth_estimation_tpu_torch.models import quantization as q
    from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
        fused_in_epilogue, plain_epilogue)

    calib = torch.from_numpy(q.synthetic_calibration_batch(2, 4, SIZE))
    static = q.calibrate(q.Int8ResnetGenerator(N_BLOCKS),
                         q.int8_generator_variables(g), calib)
    fused = q.fused_int8_variables(static)
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
        with counted(fused_in_epilogue, 0, "plain fused int8 forward"):
            y_p = q.fused_int8_apply(fused, x, n_blocks=N_BLOCKS)
    fused_in_epilogue.variant_launches.clear()
    with counted(fused_in_epilogue, PER_FORWARD, "fused int8 forward"):
        with mock.patch.object(q, "fused_in_epilogue", checked):
            y_k = q.fused_int8_apply(fused, x, n_blocks=N_BLOCKS)
    torch.cuda.synchronize()
    by_variant = dict(fused_in_epilogue.variant_launches)
    if by_variant.get("generic") or sum(by_variant.values()) != PER_FORWARD:
        raise AssertionError(f"fused int8 forward: epilogue launches by "
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
    if not (cos_plain >= 0.99 and cos_fp32 >= 0.99):
        raise AssertionError(f"fused int8: cosine vs plain {cos_plain}, "
                             f"vs fp32 {cos_fp32}")
    log(f"phase 6: per-site kernel vs plain on the path's own inputs: max "
        f"abs err {max(e for e, _ in site_errs):.3g}, worst int8 mismatch "
        f"share {max(f for _, f in site_errs):.2e} over {len(site_errs)} sites")
    log("phase 6: relative difference of each site's input, kernel path vs "
        "plain path: " + " ".join(f"{d:.2e}" for d in drift))
    iters = 10
    with counted(fused_in_epilogue, (iters + 3) * PER_FORWARD, "int8 timing"):
        t = ms_per_call(lambda: q.fused_int8_apply(fused, x, n_blocks=N_BLOCKS),
                        iters=iters)
    ips = BATCH / t * 1e3
    log(f"phase 6 ok: fused int8 bs{BATCH} {SIZE}^2 end-to-end cosine vs plain path "
        f"{cos_plain:.6f}, vs fp32 generator {cos_fp32:.6f}; {t:.2f} "
        f"ms/forward = {ips:.1f} img/s (before the epilogue's redesign: "
        f"{INT8_EARLIER_IPS} img/s); {PER_FORWARD} epilogue launches per "
        f"forward, by variant {by_variant}")
    return ips, lambda: q.fused_int8_apply(fused, x, n_blocks=N_BLOCKS)


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


def main() -> int:
    import torch

    sweep = sys.argv[1:2] == ["--sweep-epilogue"] and len(sys.argv) <= 3
    if sys.argv[1:] and not sweep:
        print("usage: chip_smoke.py [--sweep-epilogue [TABLE]]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cycle_depth_estimation_tpu_torch.models import quantization
    from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
        instance_norm)
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

    phase_build()
    if sweep:
        sweep_epilogue(gen, *sys.argv[2:])
        return 0
    in_tot, in_err = phase_instance_norm(gen)
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
    phase_profile({"bf16 generator": fwd_bf16, "fused int8": fwd_int8})
    launches = {"instance_norm": instance_norm.launches,
                "int8_epilogue": fused_in_epilogue.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    in_bound, in_by = bound(in_tot["bytes"], in_tot["flops"])
    ep_bound, ep_by = bound(ep_tot["bytes"], ep_tot["flops"])
    kernels = [
        {"name": "instance_norm", "route": "triton",
         "source": "cycle_depth_estimation_tpu_torch/ops/kernels/instance_norm.py",
         "replaces": "cycle_depth_estimation_tpu/ops/pallas/instance_norm.py:55",
         "launches": launches["instance_norm"], "max_abs_err": in_err,
         "ms": in_tot["ms"], "plain_ms": in_tot["plain_ms"],
         "bound_ms": in_bound, "bound_by": in_by,
         "library_ms": in_tot["library_ms"]},
        {"name": "int8_epilogue", "route": "cuda",
         "source": "cycle_depth_estimation_tpu_torch/csrc/int8_epilogue.cu",
         "replaces": "cycle_depth_estimation_tpu/ops/pallas/int8_epilogue.py:137",
         "launches": launches["int8_epilogue"], "max_abs_err": ep_err,
         "ms": ep_tot["ms"], "plain_ms": ep_tot["plain_ms"],
         "bound_ms": ep_bound, "bound_by": ep_by, "library_ms": None,
         "generic_variant_ms": ep_tot["generic_ms"]},
    ]
    log(f"generator img/s: fp32 {ips_fp32:.1f}, bf16 {ips_bf16:.1f}, fused "
        f"int8 {ips_int8:.1f} (bs{BATCH}, {SIZE}^2); per-forward kernel ms "
        "are sums over the 23 calls of one forward (bf16 for instance_norm); "
        f"total {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
