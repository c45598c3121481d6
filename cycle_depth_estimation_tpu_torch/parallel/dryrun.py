"""Every layout of ``parallel/`` on spawned ranks, held against one process
(the port's counterpart of the JAX ``__graft_entry__.dryrun_multichip``)::

    python -m cycle_depth_estimation_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` spawns ``n`` gloo ranks on the CPU and runs, each
stage printing a stamped line:

1. the CycleGAN step under ``dp``, against the single-process step on the
   global batch;
2. dp×tp: the generator's forward and gradients with its trunk split over
   ``model``, against the unsharded net;
3. the S2D four-phase step under ``dp`` at the reduced config (dense
   blocks 2,2,2,2, growth 16, mid 256, 192², ``adam_eps`` 1e-3; below 192²
   the FD critics' outputs are empty and their means NaN);
4. dp×sp (N ≥ 4): the generator (ngf 8, 2 blocks) forward on a (N/4, 4)
   mesh, the height split over ``model``, against the unsharded forward
   (atol 2e-5, rtol 1e-4, the JAX stage's);
5. pp (N ≥ 4): 8 residual blocks as a 4-stage GPipe (``gpipe_apply``, 4
   microbatches), forward and gradients against the sequential trunk;
6. dp×pp (N ≥ 4): the same on a (N/4, 4) ``('data', 'stage')`` mesh;
7. the CycleGAN step (ngf 4, 32²) under dp×sp on a (N/2, 2) mesh
   against one process: the synced generator gradients within 1e-5 of
   the largest, the losses and the pooled parameter checks;
8. the pix2pix step (unet_128 at 128², BatchNorm, dropout; its innermost
   plane has one row, so one rank of a pair holds none of it) and the
   SegCycle step (96², the cross-entropies over the whole label maps)
   under dp×sp on a (N/2, 2) mesh against one process: the losses within
   1e-4, the pooled parameter checks, and pix2pix's first gradients
   within 1e-5 of the largest.

``spawn`` starts the ranks (a Python process a rank, each in a session of
its own, a free localhost port, one timeout for the world; every process
of the ranks' sessions is killed on the way out). A rank's work:
``model_step`` builds, lays out, steps and gathers as the train CLI does;
``phase_by_phase`` holds a phased model's step (S2D's, S2D_base's,
S2D_alt's) phase by phase from one process's input, under dp or
``--parallel sp``; ``run_cases`` runs several in one world.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

S2D_REDUCED = dict(model="S2D", dense_block_config=[2, 2, 2, 2],
                   dense_growth_rate=16, s2d_mid_nc=256, fine_size=192,
                   adam_eps=1e-3, g1_blocks=1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(argv) -> None:
    """A spawned rank: ``argv`` is the call file, rank, world size, port,
    device, threads and the result file."""
    import importlib

    from . import collectives, mesh

    call, rank, n, port, device, threads, out_path = argv
    module, name, args = torch.load(call, weights_only=False)
    fn = getattr(importlib.import_module(module), name)
    torch.set_num_threads(int(threads))
    mesh.init_distributed(f"tcp://localhost:{port}", int(rank), int(n),
                          int(rank), int(n), device)
    try:
        torch.save(fn(*args), out_path)
    finally:
        collectives.activate(collectives.Groups())
        torch.distributed.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), device: str = "cpu",
          timeout: float = 300.0, threads: int = 1) -> List[Any]:
    """Run ``fn(*args)`` (a module-level function) on ``n`` ranks of a new
    world, each a Python process of its own session (gloo on the CPU or on
    a shared card); returns each rank's result. Raises if a rank fails or
    the world outlives ``timeout`` seconds, after killing every process
    of the ranks' sessions."""
    import signal
    import subprocess
    import sys

    if fn.__module__ == "__main__":
        raise ValueError(f"spawn needs a function a rank can import; "
                         f"{fn.__qualname__} is in __main__")
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in sys.path if p)}
    code = ("import sys; from cycle_depth_estimation_tpu_torch.parallel."
            "dryrun import _rank_main; _rank_main(sys.argv[1:])")
    with tempfile.TemporaryDirectory() as tmp:
        call = os.path.join(tmp, "call.pt")
        torch.save((fn.__module__, fn.__qualname__, tuple(args)), call)
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(n)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, call, str(r), str(n), str(port),
             device, str(threads), paths[r]], env=env, stdout=logs[r],
            stderr=subprocess.STDOUT, start_new_session=True)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            # until every rank ends, or one fails (the others would wait
            # for it in a collective), or the time is up
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or None not in codes:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {n} ranks outlived "
                                       f"{timeout} s")
                time.sleep(0.05)
            if failed:
                logs[failed[0]].seek(0)
                raise RuntimeError(
                    f"ranks {failed} of {n} failed; rank {failed[0]}:\n"
                    + logs[failed[0]].read()[-4000:])
            for f in logs:
                f.seek(0)
                sys.stdout.write(f.read())
            return [torch.load(q, weights_only=False) for q in paths]
        finally:
            for p in procs:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
            for f in logs:
                f.close()


# ---- a rank's work -------------------------------------------------------
def rank_device() -> str:
    """This rank's device: the card ``init_distributed`` set, where the
    rank runs on CUDA, else the CPU."""
    return ("cuda" if torch.cuda.is_available()
            and torch.cuda.is_initialized() else "cpu")


def layout_groups(layout: Dict[str, Any]):
    """The active groups for ``layout`` ({mesh_shape, mesh_axes}) when a
    process group exists, else the single-process ones."""
    from . import collectives, mesh

    if not torch.distributed.is_initialized():
        return collectives.Groups()
    m = mesh.make_mesh(layout.get("mesh_shape"), layout.get("mesh_axes"),
                       "cuda" if torch.cuda.is_initialized() else "cpu")
    return mesh.mesh_groups(m, spatial=layout.get("parallel") == "sp")


def _whole_grads(state, names) -> Dict[str, torch.Tensor]:
    """The synced gradient of every parameter of the nets ``names``, whole
    (ZeRO slices and tensor-parallel splits gathered)."""
    from .collectives import all_gather_cat
    from .tensor import gathered
    from .zero import ZeroOptimizer

    by_param = {}
    for opt in state.optimizers.values():
        if isinstance(opt, ZeroOptimizer):
            for p, s, d in zip(opt.params, opt.shards, opt.dims):
                if s.grad is not None:
                    by_param[id(p)] = (s.grad if d is None else
                                       all_gather_cat(s.grad, opt.group, d))
    out = {}
    for name in names:
        for k, p in state.nets[name].named_parameters():
            g = by_param.get(id(p))
            if g is None:
                g = gathered(p.grad, p)
            out[f"{name}.{k}"] = g.detach().cpu()
    return out


def _g_phase_grads(model, state, batch) -> Dict[str, torch.Tensor]:
    """CycleGAN's generator gradient after the sync (D frozen), whole; the
    parameters are left as they were."""
    from ..models.base_model import optimizer_params
    from . import collectives
    from .zero import ZeroOptimizer

    nets = state.nets
    real_A, real_B = model._inputs(batch)
    for net in nets.values():
        net.train()
    d_params = [p for k in ("D_A", "D_B") for p in nets[k].parameters()]
    for p in d_params:
        p.requires_grad_(False)
    loss, _ = model._g_losses(nets, real_A, real_B)
    opt = state.optimizers["G"]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in d_params:
        p.requires_grad_(True)
    collectives.sync_replicas(optimizer_params(opt))
    if isinstance(opt, ZeroOptimizer):
        opt.reduce_grads()
    else:
        collectives.sync_grads(optimizer_params(opt))
    grads = _whole_grads(state, ("G_A", "G_B"))
    opt.zero_grad(set_to_none=True)
    if isinstance(opt, ZeroOptimizer):
        for s in opt.shards:
            s.grad = None
    return grads


def model_step(cfg_kw: Dict[str, Any], batch: Dict[str, torch.Tensor],
               layout: Optional[Dict[str, Any]] = None,
               init_sd: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
               adam_eps: Optional[float] = None, steps: int = 1,
               g_grads: bool = False, first_grads: bool = False
               ) -> Dict[str, Any]:
    """One rank's (or one process's) train steps on the global ``batch``:
    the model of ``cfg_kw`` from its seed (or ``init_sd``), Adam's eps set
    to ``adam_eps`` where given, laid out by ``layout`` (``mesh_shape``,
    ``mesh_axes``, ``parallel``, ``zero``) and with its ``tpu_precision``
    as the train CLI does, then ``steps`` train steps on this rank's rows. Returns the metrics of the
    last step, the whole state dicts after it, the InstanceNorm launches of
    each step, the memory report of the state before its layout and the
    bytes this rank holds after the steps, the split InstanceNorm entries'
    launches of each step (``--parallel sp``) and the steps' seconds; with
    ``g_grads`` (CycleGAN) the generator gradient of the first step after
    the sync; with ``first_grads`` (any model) the synced gradients that
    the first optimizer step of the first train step reads."""
    from ..config import Config, apply_model_defaults
    from ..device import set_precision
    from ..models import create_model
    from ..models.networks import biases_before_norm
    from ..ops.kernels import instance_norm as kin
    from ..ops.kernels.instance_norm import (instance_norm,
                                             instance_norm_backward)
    from ..train import place_state
    from . import collectives
    from .mesh import shard_batch
    from .tensor import gathered_state_dict
    from .zero import gather_params, memory_report, resident_bytes, \
        state_trees

    layout = dict(layout or {})
    device = rank_device()
    kw = {"device": device, **cfg_kw,
          **{k: v for k, v in layout.items()
             if k in ("mesh_shape", "mesh_axes", "parallel", "zero")}}
    cfg = apply_model_defaults(Config(**kw), set(kw))
    set_precision(cfg.tpu_precision)
    torch.manual_seed(cfg.seed + 1)  # the train CLI's dropout seed
    groups = layout_groups(layout)
    prev = collectives.activate(groups)
    try:
        model = create_model(cfg)
        state = model.init_state()
        if init_sd:
            for name, sd in init_sd.items():
                state.nets[name].load_state_dict(sd)
        if adam_eps is not None:
            for opt in state.optimizers.values():
                for g in opt.param_groups:
                    g["eps"] = adam_eps
        report = memory_report(state_trees(state), groups.data_size,
                               shard_params=cfg.zero == "fsdp")
        state = place_state(cfg, state, groups,
                            distributed=torch.distributed.is_initialized())
        local = {k: v.to(device) for k, v in shard_batch(batch).items()}
        out = {"rank": (torch.distributed.get_rank()
                        if torch.distributed.is_initialized() else 0),
               "memory_report": report}
        if g_grads:
            out["grads"] = _g_phase_grads(model, state, local)
        hooks = []
        if first_grads:
            hooks = _record_first_step(state, out.setdefault(
                "first_grads", {}))
            out["before_norm"] = sorted(
                f"{n}.{k}" for n, net in state.nets.items()
                for k in biases_before_norm(net))
        launches, split = [], []
        split_fns = (kin.in_stats, kin.in_apply, kin.in_bwd_stats,
                     kin.in_bwd_apply)
        t0 = time.perf_counter()
        for _ in range(steps):
            f0, b0 = instance_norm.launches, instance_norm_backward.launches
            s0 = [f.launches for f in split_fns]
            state, metrics = model.train_step(state, local)
            launches.append((instance_norm.launches - f0,
                             instance_norm_backward.launches - b0))
            split.append(tuple(f.launches - n for f, n in zip(split_fns,
                                                              s0)))
        if device == "cuda":
            torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        out["split_launches"] = split
        out["resident_bytes"] = resident_bytes(state)
        out["allocated_bytes"] = (torch.cuda.memory_allocated()
                                  if device == "cuda" else 0)
        out["launches"] = launches
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        gather_params(state)
        out["params"] = {n: {k: v.detach().cpu() for k, v in
                             gathered_state_dict(net).items()}
                         for n, net in state.nets.items()}
        return out
    finally:
        collectives.activate(prev)


def _record_first_step(state, record: Dict[str, torch.Tensor]):
    """Fill ``record`` with the gradients of the first optimizer step
    that any of ``state``'s optimizers takes (synced: the step reads
    them), by ``net.param`` name; returns the hooks' handles."""
    names = {id(p): f"{n}.{k}" for n, net in state.nets.items()
             for k, p in net.named_parameters()}

    def hook(opt, args, kwargs):
        if record:
            return
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    record[names[id(p)]] = p.grad.detach().cpu().clone()

    return [opt.register_step_pre_hook(hook)
            for opt in state.optimizers.values()]


def run_cases(cases: Dict[str, Sequence]) -> Dict[str, Any]:
    """``fn(*args)`` for each case ``(fn, args)`` of ``cases``, in order
    (one world runs them all); each case's seconds printed."""
    out = {}
    for k, (fn, args) in cases.items():
        t = time.perf_counter()
        out[k] = fn(*args)
        print(f"[case] {k}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


# ---- comparisons -------------------------------------------------------------
def params_apart(got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor], lr: float
                 ) -> Dict[str, float]:
    """How far one net's parameters are apart, by the three checks of the
    JAX tests' ``_assert_params_close``: the largest difference over lr,
    and the shares of elements past lr and past 1e-5; ``ok`` when they are
    ≤ 3, 3e-3 and 8 %."""
    worst = past_lr = past_small = total = 0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        past_lr += int((d > lr).sum())
        past_small += int((d > 1e-5).sum())
        total += d.numel()
    stats = {"max_over_lr": worst / lr, "past_lr": past_lr / max(total, 1),
             "past_1e-5": past_small / max(total, 1)}
    stats["ok"] = (stats["max_over_lr"] <= 3 and stats["past_lr"] <= 3e-3
                   and stats["past_1e-5"] <= 0.08)
    return stats


def pooled_params_close(got: Dict[str, torch.Tensor],
                        want: Dict[str, torch.Tensor], lr: float,
                        tag: str = "") -> Dict[str, float]:
    """``params_apart``, raising where a check misses."""
    stats = params_apart(got, want, lr)
    if not stats["ok"]:
        raise AssertionError(f"{tag} parameters apart: {stats}")
    return stats


def _copy(v):
    """``v`` with every tensor (in dicts, lists, tuples) cloned."""
    if torch.is_tensor(v):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_copy(x) for x in v)
    return v


def _rows(v, n: int):
    """``v`` with every tensor whose first dimension is the global batch
    ``n`` cut to this rank's rows."""
    from .collectives import local_rows

    if torch.is_tensor(v):
        return local_rows(v) if v.dim() and v.shape[0] == n else v
    if isinstance(v, dict):
        return {k: _rows(x, n) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_rows(x, n) for x in v)
    return v


def _plane_rows(v, size: int, index: int):
    """``v`` with every tensor of rank ≥ 3 cut to rank ``index``'s rows of
    its height (the dimension before the last: NCHW maps, NHW label maps)
    over ``size`` ranks, as ``--parallel sp`` holds them."""
    from .mesh import row_range

    if torch.is_tensor(v):
        if v.dim() < 3:
            return v
        a, b = row_range(v.shape[-2], size, index)
        return v.narrow(v.dim() - 2, a, b - a)
    if isinstance(v, dict):
        return {k: _plane_rows(x, size, index) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plane_rows(x, size, index) for x in v)
    return v


def phase_by_phase(cfg_kw: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   layout: Optional[Dict[str, Any]] = None,
                   adam_eps: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """A phased model's step (S2D's ``PHASES``, S2D_base's, S2D_alt's) on
    this rank, each phase held from one process's input: before each
    phase the state and the step context are copied; the phase runs in one
    process on the global batch (no collective), then again from the copy
    under ``layout`` (default: every rank on ``data``) on this rank's rows
    of the batch, and under ``--parallel sp`` of each map's height, with
    the nets running on rows; Dis_en's keep-masks of the split run are
    those the one process drew. The step goes on from the one-process
    state. Adam's eps is set to ``adam_eps`` where given. Returns, per
    phase, each new loss's distance relative to the one-process value,
    ``params_apart`` of every net (each at its optimizer's lr), the
    seconds of the one-process and the split run (``one_s``,
    ``split_s``), and the InstanceNorm launches of the split run (fused
    forward and backward, then the four split entries)."""
    from ..config import Config, apply_model_defaults
    from ..device import set_precision
    from ..models import create_model
    from ..models.s2d_base import PhasedModel
    from ..ops.kernels import instance_norm as kin
    from . import collectives
    from .spatial import spatial_state

    counted = (kin.instance_norm, kin.instance_norm_backward, kin.in_stats,
               kin.in_apply, kin.in_bwd_stats, kin.in_bwd_apply)

    def clock():
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    layout = dict(layout or {})
    device = rank_device()
    kw = {"device": device, **cfg_kw}
    cfg = apply_model_defaults(Config(**kw), set(kw))
    set_precision(cfg.tpu_precision)
    groups, single = layout_groups(layout), collectives.Groups()
    prev = collectives.activate(single)
    try:
        model = create_model(cfg)
        state = model.init_state()
        if adam_eps is not None:
            for opt in state.optimizers.values():
                for g in opt.param_groups:
                    g["eps"] = adam_eps
        if groups.spatial:
            spatial_state(state, groups.model)
        for net in state.nets.values():
            net.train()
        n = next(iter(batch.values())).shape[0]
        b = {k: v.to(device) for k, v in batch.items()}
        ctx = (model._ctx(state, b) if isinstance(model, PhasedModel)
               else model._ctx(b, state))
        drawn, masks = [], ctx.get("masks")
        if callable(masks):  # record the one process's draws
            ctx["masks"] = lambda: drawn.append(masks()) or drawn[-1]

        def snapshot():
            return ({k: _copy(net.state_dict())
                     for k, net in state.nets.items()},
                    {k: _copy(o.state_dict())
                     for k, o in state.optimizers.items()})

        def restore(snap):
            nets, opts = snap
            for k, net in state.nets.items():
                net.load_state_dict(nets[k])
                state.optimizers[k].load_state_dict(_copy(opts[k]))

        out = []
        for name, phase in model.PHASES:
            pre, pre_ctx, k0 = snapshot(), _copy(ctx), len(drawn)
            t = clock()
            phase(model, state, ctx)
            one_s = clock() - t
            new = [k for k in ctx["metrics"] if k not in pre_ctx["metrics"]]
            want = {k: {p: v.detach().clone()
                        for p, v in net.named_parameters()}
                    for k, net in state.nets.items()}
            post = snapshot()
            restore(pre)
            collectives.activate(groups)  # ``_rows`` reads the data group
            dctx = _rows(pre_ctx, n)
            if groups.spatial:
                dctx = _plane_rows(dctx, groups.model_size, groups.model_rank)
            replay = iter(drawn[k0:])
            dctx["masks"] = lambda: [collectives.local_rows(m)
                                     for m in next(replay)]
            n0, t = [f.launches for f in counted], clock()
            phase(model, state, dctx)
            split_s = clock() - t
            launches = [f.launches - k for f, k in zip(counted, n0)]
            got = collectives.mean_over_data(
                {k: torch.as_tensor(dctx["metrics"][k]).detach().float()
                 for k in new})
            collectives.activate(single)
            losses = {k: abs(float(got[k]) - float(ctx["metrics"][k]))
                      / max(abs(float(ctx["metrics"][k])), 1e-2) for k in new}
            nets = {k: params_apart(
                {p: v.detach() for p, v in net.named_parameters()}, want[k],
                state.optimizers[k].param_groups[0]["lr"])
                for k, net in state.nets.items() if k in state.optimizers}
            out.append({"phase": name, "losses": losses, "nets": nets,
                        "one_s": one_s, "split_s": split_s,
                        "launches": launches})
            restore(post)
        return out
    finally:
        collectives.activate(prev)


def stamp(msg: str) -> None:
    print(f"[dryrun {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def tp_case(cfg_kw, x, layout):
    """The generator's forward and its gradients under ``layout`` (a
    ``model`` axis splits the trunk), on this rank's rows, whole."""
    from ..models.networks import define_G
    from . import collectives
    from .mesh import shard_batch
    from .tensor import gathered_state_dict, shard_params_tp

    groups = layout_groups(layout)
    prev = collectives.activate(groups)
    try:
        gen = torch.Generator().manual_seed(0)
        net = define_G(3, 3, cfg_kw["ngf"], cfg_kw["net_g"], norm="instance",
                       use_dropout=False, init_type="normal", init_gain=0.02,
                       generator=gen)
        if groups.model is not None:
            shard_params_tp(net, groups.model, groups.model_size,
                            groups.model_rank)
        xs = shard_batch({"x": x})["x"]
        y = net(xs)
        # the global mean of y², as the JAX test's loss
        loss = collectives.global_mean((y.float() ** 2).sum(),
                                       torch.tensor(float(y.numel()),
                                                    device=y.device))
        loss.backward()
        collectives.sync_replicas(net.parameters())
        collectives.sync_grads(net.parameters())
        from .tensor import gathered
        grads = {k: gathered(p.grad, p).cpu()
                 for k, p in net.named_parameters()}
        full = collectives.gather_rows(y.detach())
        return {"y": full.cpu(), "grads": grads,
                "params": {k: v.cpu()
                           for k, v in gathered_state_dict(net).items()}}
    finally:
        collectives.activate(prev)


def sp_forward_case(x: torch.Tensor, layout: Dict[str, Any], ngf: int,
                    n_blocks: int, sd: Optional[Dict[str, torch.Tensor]]
                    = None, grads: bool = False) -> Dict[str, Any]:
    """A ``ResnetGenerator`` (from seed 0, or ``sd``) on this rank's block
    of ``x`` on the ``make_2d_mesh`` of ``layout['mesh_shape']``
    (``shard_spatial``: the height over ``model``), TF32 off, on this
    rank's device: its
    output gathered whole, and with ``grads`` the input's and the
    parameters' gradients of the global mean of y², synced."""
    from ..device import set_precision
    from ..models.networks import ResnetGenerator
    from ..ops.init import init_weights
    from . import collectives
    from .mesh import mesh_groups
    from .spatial import make_2d_mesh, shard_spatial, spatial

    set_precision("highest")
    x = x.to(rank_device())
    shape = layout.get("mesh_shape")
    if shape and torch.distributed.is_initialized():
        mesh = make_2d_mesh(*shape, device_type=x.device.type)
        groups = mesh_groups(mesh, spatial=True)
        xs = shard_spatial(mesh, x)
    else:
        groups, xs = collectives.Groups(), x
    prev = collectives.activate(groups)
    try:
        net = init_weights(ResnetGenerator(3, 3, ngf, n_blocks), "normal",
                           0.02, torch.Generator().manual_seed(0))
        if sd is not None:
            net.load_state_dict(sd)
        net.to(x.device)
        if groups.model is not None:
            spatial(net, groups.model)
        xs = xs.clone().requires_grad_(grads)
        y = net(xs)
        out = {"y": collectives.gather_rows(
            collectives.gather_spatial(y.detach())).cpu()}
        if grads:
            collectives.spatial_mean(y.float() ** 2).backward()
            collectives.sync_replicas(net.parameters())
            collectives.sync_grads(net.parameters())
            # a rank's loss is its data rows' mean: its rows' gradient is
            # data_size times the global mean's (sync_grads averages the
            # parameters' so)
            out["dx"] = collectives.gather_rows(collectives.gather_spatial(
                xs.grad)).cpu() / groups.data_size
            out["grads"] = {k: p.grad.cpu()
                            for k, p in net.named_parameters()}
        return out
    finally:
        collectives.activate(prev)


def trunk_blocks(n: int, dim: int, seed: int = 0, sds=None):
    """``n`` residual blocks of width ``dim``, each from ``seed + i`` (or
    the state dicts ``sds``)."""
    from ..models.networks import ResnetBlock
    from ..ops.init import init_weights

    blocks = []
    for i in range(n):
        b = init_weights(ResnetBlock(dim), "normal", 0.02,
                         torch.Generator().manual_seed(seed + i))
        if sds is not None:
            b.load_state_dict(sds[i])
        blocks.append(b)
    return blocks


def pipeline_case(x: torch.Tensor, n_blocks: int, layout: Dict[str, Any],
                  n_microbatches: int, data_axis: Optional[str] = None,
                  sds=None, dtype=None, grads: bool = True
                  ) -> Dict[str, Any]:
    """``n_blocks`` residual blocks (``trunk_blocks``) as a GPipe over the
    ``stage`` axis of ``layout`` (``gpipe_apply``), TF32 off, on this
    rank's device: the output, and with
    ``grads`` the gradients of Σ y² for x and every block's parameters
    (each rank's part summed over ``stage`` and ``data``), and the
    InstanceNorm launches of this rank."""
    from ..device import set_precision
    from ..ops.kernels.instance_norm import (instance_norm,
                                             instance_norm_backward)
    from ..ops.layers import set_compute_dtype
    from . import collectives
    from .pipeline import gpipe_apply, stack_stage_params

    set_precision("highest")
    x = x.to(rank_device())
    groups = layout_groups(layout)
    blocks = [set_compute_dtype(b.to(x.device), dtype) for b in
              trunk_blocks(n_blocks, x.shape[1], sds=sds)]
    shell = blocks[0]
    xx = x.clone().requires_grad_(grads)
    f0, b0 = instance_norm.launches, instance_norm_backward.launches
    y = gpipe_apply(
        lambda p, h: torch.func.functional_call(shell, p, (h,)),
        stack_stage_params(blocks, groups.stage_size), xx, groups,
        n_microbatches, data_axis)
    out = {"y": y.detach().cpu(), "launches": [
        instance_norm.launches - f0, 0]}
    if grads:
        (y.float() ** 2).sum().backward()
        out["launches"][1] = instance_norm_backward.launches - b0
        out["dx"] = xx.grad.cpu()
        gs = []
        for b in blocks:
            g = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for k, p in b.named_parameters()}
            for v in g.values():
                for grp in (groups.stage, groups.data):
                    if grp is not None:
                        collectives.all_reduce_(v, grp)
            gs.append({k: v.cpu() for k, v in g.items()})
        out["grads"] = gs
    return out


def sequential_trunk(x: torch.Tensor, n_blocks: int, sds=None, dtype=None
                     ) -> Dict[str, Any]:
    """``pipeline_case``'s trunk applied block after block in one
    process (on ``x``'s device): the output and the gradients of Σ y²."""
    from ..ops.layers import set_compute_dtype

    blocks = [set_compute_dtype(b.to(x.device), dtype) for b in
              trunk_blocks(n_blocks, x.shape[1], sds=sds)]
    xx = x.clone().requires_grad_(True)
    y = xx
    for b in blocks:
        y = b(y)
    (y.float() ** 2).sum().backward()
    return {"y": y.detach().cpu(), "dx": xx.grad.cpu(),
            "grads": [{k: p.grad.cpu() for k, p in b.named_parameters()}
                      for b in blocks]}


def grads_apart(got: Dict[str, torch.Tensor],
                want: Dict[str, torch.Tensor]):
    """The largest difference of two gradient sets over the largest
    gradient, and the tensor where it is."""
    big = max(float(g.abs().max()) for g in want.values())
    return max((float((got[k] - g).abs().max()) / big, k)
               for k, g in want.items())


def s2d_batch_of(n: int, h: int, w: int, seed: int = 11):
    """A seeded ``try`` batch: images in [-1, 1], 28-class labels with a
    band of sky (class 17), depth in [-1, 1] and ±1 bands."""
    g = torch.Generator().manual_seed(seed)
    seg = torch.randint(0, 28, (n, h, w), generator=g)
    seg[:, :h // 5] = 17
    return {"img_syn": torch.rand(n, 3, h, w, generator=g) * 2 - 1,
            "img_real": torch.rand(n, 3, h, w, generator=g) * 2 - 1,
            "seg_l_syn": seg,
            "seg_l_real": torch.randint(0, 28, (n, h, w), generator=g),
            "dep_l_syn": torch.rand(n, 1, h, w, generator=g) * 2 - 1,
            "depth_l_s": torch.randn(n, 4, h, w, generator=g).sign()}


def domain_batch_of(n: int, h: int, w: int, seed: int = 3):
    """A seeded ``synthia`` batch: images in [-1, 1], 22-class source
    and 28-class target label maps, each with a patch of 255 (ignored)."""
    g = torch.Generator().manual_seed(seed)
    out = {k: torch.rand(n, 3, h, w, generator=g) * 2 - 1
           for k in ("img_source", "img_target")}
    out["lab_source"] = torch.randint(0, 22, (n, h, w), generator=g)
    out["lab_target"] = torch.randint(0, 28, (n, h, w), generator=g)
    out["lab_source"][0, :h // 8, :w // 8] = 255
    out["lab_target"][-1, -h // 8:] = 255
    return out


def sp_steps_apart(one: Dict[str, Any], ranks: List[Dict[str, Any]],
                   tag: str, grads: bool = True) -> Dict[str, float]:
    """``model_step`` results with ``first_grads`` of ranks against one
    process: raises unless the first optimizer step's gradients are within
    1e-5 of the largest (where ``grads``; but for the conv biases that a
    norm follows, whose gradient is zero up to rounding), every loss
    within 1e-4 (relative, over at least 1e-2) and every net by the pooled
    checks at 2e-4; returns the worst gradient and loss figures."""
    want = {k: g for k, g in one["first_grads"].items()
            if k not in one["before_norm"]}
    err_g = max(grads_apart(r["first_grads"], want)[0]
                for r in ranks) if grads else 0.0
    loss = max(abs(r["metrics"][k] - v) / max(abs(v), 1e-2) for r in ranks
               for k, v in one["metrics"].items())
    if err_g > 1e-5 or loss > 1e-4:
        raise AssertionError(f"{tag}: gradients {err_g:.2e} of the largest, "
                             f"losses {loss:.2e} apart")
    for name, sd in one["params"].items():
        for r in ranks:
            pooled_params_close(r["params"][name], sd, 2e-4,
                                f"{tag} {name} rank {r['rank']}")
    return {"grads": err_g, "losses": loss}


SP_PIX2PIX = dict(model="pix2pix", net_g="unet_128", fine_size=128, ngf=4,
                  ndf=4)
SP_SEG_CYCLE = dict(model="seg_cycle", net_g="resnet_3blocks", fine_size=96,
                    ngf=4, ndf=4, pool_size=2)


def dryrun_multichip(n: int = 2, timeout: float = 600.0) -> Dict[str, Any]:
    """The stages on ``n`` spawned CPU ranks (4–6 need n ≥ 4 and a
    multiple of 4, 7 and 8 an even n); raises on a miss and returns each
    stage's figures. The one-process runs take one thread, as each rank
    does: the CPU's multi-threaded reductions move a BatchNorm step's
    gradients in their last bits, past 1e-5 of the largest at SegCycle's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _dryrun_stages(n, timeout)
    finally:
        torch.set_num_threads(threads)


def _dryrun_stages(n: int, timeout: float) -> Dict[str, Any]:
    out = {}
    gen = torch.Generator().manual_seed(0)
    cyc = dict(model="cycle_gan", ngf=8, ndf=8, net_g="resnet_3blocks",
               fine_size=32, batch_size=2 * n, pool_size=4 * n,
               d_steps_per_g=2)
    batch = {k: torch.rand(2 * n, 3, 32, 32, generator=gen) * 2 - 1
             for k in ("img_source", "img_target")}
    one = model_step(cyc, batch, adam_eps=1e-2)
    ranks = spawn(model_step, n, (cyc, batch, {}, None, 1e-2),
                  timeout=timeout)
    for name, want in one["params"].items():
        for r in ranks:
            pooled_params_close(r["params"][name], want, 2e-4,
                                f"cycle_gan dp {name} rank {r['rank']}")
    out["cycle_gan_dp"] = {k: abs(ranks[0]["metrics"][k] - v)
                           for k, v in one["metrics"].items()}
    stamp(f"stage 1: CycleGAN dp step on {n} ranks == one process "
          f"(losses apart ≤ {max(out['cycle_gan_dp'].values()):.2e})")

    tp = dict(ngf=8, net_g="resnet_3blocks")
    x = torch.rand(2 * n, 3, 32, 32, generator=gen)
    ref = tp_case(tp, x, {})
    shape = [n // 2, 2] if n % 2 == 0 else [1, n]
    got = spawn(tp_case, n, (tp, x, {"mesh_shape": shape}),
                timeout=timeout)[0]
    err_y = float((got["y"] - ref["y"]).abs().max())
    err_g = max(float((got["grads"][k] - g).abs().max())
                for k, g in ref["grads"].items())
    if err_y > 2e-5 or err_g > 2e-5:
        raise AssertionError(f"dp×tp apart: y {err_y:.2e}, grads "
                             f"{err_g:.2e}")
    out["dp_tp"] = {"y": err_y, "grads": err_g}
    stamp(f"stage 2: dp×tp mesh {shape} forward and gradients == unsharded "
          f"(y {err_y:.2e}, grads {err_g:.2e})")

    s2d = {**S2D_REDUCED, "batch_size": n}
    b = s2d_batch_of(n, 192, 192)
    one = model_step(s2d, b)
    ranks = spawn(model_step, n, (s2d, b), timeout=timeout)
    for name, want in one["params"].items():
        for r in ranks:
            pooled_params_close(r["params"][name], want, 2e-4,
                                f"S2D dp {name} rank {r['rank']}")
    out["s2d_dp"] = {k: abs(ranks[0]["metrics"][k] - v)
                     for k, v in one["metrics"].items()
                     if v == v}
    stamp(f"stage 3: S2D 4-phase dp step on {n} ranks == one process "
          f"(losses apart ≤ {max(out['s2d_dp'].values()):.2e})")

    if n >= 4 and n % 4 == 0:
        x = torch.rand(n // 4, 3, 64, 64, generator=gen)
        ref = sp_forward_case(x, {}, 8, 2)
        shape = [n // 4, 4]
        got = spawn(sp_forward_case, n, (x, {"mesh_shape": shape}, 8, 2),
                    timeout=timeout)
        err = max(float((r["y"] - ref["y"]).abs().max()) for r in got)
        for r in got:
            torch.testing.assert_close(r["y"], ref["y"], atol=2e-5,
                                       rtol=1e-4)
        out["dp_sp"] = err
        stamp(f"stage 4: dp×sp mesh {shape} generator forward, the height "
              f"split over 'model' == unsharded (y {err:.2e})")

        xb = torch.rand(4, 8, 8, 8, generator=gen)
        ref = sequential_trunk(xb, 8)
        for stage, layout, m, axis in (
                ("5: pp", {"mesh_shape": [n], "mesh_axes": ["stage"]}, 4,
                 None),
                ("6: dp×pp", {"mesh_shape": [n // 4, 4],
                              "mesh_axes": ["data", "stage"]}, 2, "data")):
            if n != 4 and axis is None:
                layout = {"mesh_shape": [n // 4, 4],
                          "mesh_axes": ["data", "stage"]}
            got = spawn(pipeline_case, n, (xb, 8, layout, m, axis),
                        timeout=timeout)
            err_y = max(float((r["y"] - ref["y"]).abs().max()) for r in got)
            err_g = max(max(grads_apart(g, w)[0] for g, w in
                            zip(r["grads"], ref["grads"])) for r in got)
            for r in got:
                torch.testing.assert_close(r["y"], ref["y"], atol=2e-5,
                                           rtol=1e-4)
            if err_g > 1e-5:
                raise AssertionError(f"stage {stage} gradients {err_g:.2e} "
                                     "of the largest apart")
            out[stage.split()[1]] = {"y": err_y, "grads": err_g}
            stamp(f"stage {stage} GPipe of 8 blocks on 4 stages, {m} "
                  f"microbatches == sequential (y {err_y:.2e}, grads "
                  f"{err_g:.2e} of the largest)")

    if n % 2 == 0:
        layout = {"mesh_shape": [n // 2, 2], "parallel": "sp"}
        # the CPU test's width: at ngf 8 the forward's rounding flips a
        # few ReLU masks on some inputs, moving single gradients past 1e-5
        cyc = dict(model="cycle_gan", ngf=4, ndf=4, net_g="resnet_3blocks",
                   fine_size=32, batch_size=n // 2 * 2, pool_size=n * 2,
                   d_steps_per_g=2)
        batch = {k: torch.rand(n // 2 * 2, 3, 32, 32, generator=gen) * 2 - 1
                 for k in ("img_source", "img_target")}
        one = model_step(cyc, batch, {}, None, 1e-2, 1, True)
        ranks = spawn(model_step, n, (cyc, batch, layout, None, 1e-2, 1,
                                      True), timeout=timeout)
        err_g = max(grads_apart(r["grads"], one["grads"])[0] for r in ranks)
        if err_g > 1e-5:
            raise AssertionError(f"dp×sp CycleGAN gradients {err_g:.2e} of "
                                 "the largest apart")
        for name, want in one["params"].items():
            for r in ranks:
                pooled_params_close(r["params"][name], want, 2e-4,
                                    f"cycle_gan dp×sp {name} rank "
                                    f"{r['rank']}")
        loss = max(abs(r["metrics"][k] - v) for r in ranks
                   for k, v in one["metrics"].items())
        if loss > 1e-4:
            raise AssertionError(f"dp×sp CycleGAN losses {loss:.2e} apart")
        out["cycle_gan_dp_sp"] = {"grads": err_g, "losses": loss}
        stamp(f"stage 7: CycleGAN dp×sp step on mesh {layout['mesh_shape']}"
              f" == one process (gradients {err_g:.2e} of the largest, "
              f"losses {loss:.2e})")

        b = n // 2 * 2
        for name, cfg, batch in (
                ("pix2pix", {**SP_PIX2PIX, "batch_size": b},
                 {k: torch.rand(b, 3, 128, 128, generator=gen) * 2 - 1
                  for k in ("A", "B")}),
                ("seg_cycle", {**SP_SEG_CYCLE, "batch_size": b},
                 domain_batch_of(b, 96, 96))):
            one = model_step(cfg, batch, {}, None, 1e-2, first_grads=True)
            ranks = spawn(model_step, n, (cfg, batch, layout, None, 1e-2, 1,
                                          False, True), timeout=timeout)
            # SegCycle's first gradients move by 6.8e-5 of the largest at
            # batch 4 under dp alone (--mesh_shape 4 1: BatchNorm's global
            # sums against torch's fused op), so its losses and parameters
            # hold it here; the CPU tests hold its sp gradients at batch 2
            out[f"{name}_dp_sp"] = sp_steps_apart(
                one, ranks, f"{name} dp×sp", grads=name == "pix2pix")
            fig = out[f"{name}_dp_sp"]
            stamp(f"stage 8: {name} dp×sp step on mesh "
                  f"{layout['mesh_shape']} == one process ("
                  + (f"gradients {fig['grads']:.2e} of the largest, "
                     if name == "pix2pix" else "")
                  + f"losses {fig['losses']:.2e}, parameters pooled)")
    return out


if __name__ == "__main__":
    import sys

    # the ranks import the stages' functions by the package's name
    from cycle_depth_estimation_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
