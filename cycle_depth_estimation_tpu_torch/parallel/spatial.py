"""Spatial sharding: the image height split over the ``model`` mesh axis
(the JAX package's ``parallel/spatial.py``, ``--parallel sp``).

The JAX package shards H of an NHWC tensor over ``model`` and lets XLA's
SPMD partitioner insert the conv halo exchanges and the InstanceNorm's
whole-plane reductions. One process is one rank here, so both are written
out:

- the split: rank m of M holds rows ``[m·H//M, (m+1)·H//M)`` of every
  plane (``mesh.row_range``); a net's input must split evenly (H divides by
  M), its layers' planes may not (the PatchGAN's 31- and 30-row planes);
- a conv of kernel k, stride s and padding p owns the output rows of that
  rule on its own plane, ``[o0, o1)``, and needs the input rows
  ``[o0·s − p, (o1−1)·s − p + k)``, clipped to the plane: ``halo`` fetches
  those it lacks from the ranks that own them (one message a pair, all at
  once, so a shard thinner than the halo takes rows from several ranks),
  and its backward sends each fetched row's gradient back to be added to
  the owner's. The padding (reflect or zeros) is applied at the plane's
  top and bottom only, by the ranks that hold them; W stays whole on
  every rank and is padded as before;
- a transposed conv owns its output rows by the same rule and fetches the
  input rows that reach them;
- ``InstanceNorm`` runs the kernels' split entries with the ``model``
  group and the whole plane's count (``ops.kernels.instance_norm``);
- elementwise layers run on the rows as they are.

``spatial(net, group)`` makes a ``ResnetGenerator`` (ConvTranspose ups)
or an ``NLayerDiscriminator`` run so, in place: the net keeps its modules,
names and parameters (``state_dict()`` and the importers do not change),
and its forward walks its layers with the global height beside the local
rows. Each rank's parameter gradients are then its rows' part: the train
step sums them over ``model`` (``collectives.sync_replicas``).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import make_mesh, row_range

Rows = Tuple[int, int]


def make_2d_mesh(data: int, model: int, device_type: str = "cpu"):
    """A ``('data', 'model')`` mesh over the world's ranks."""
    return make_mesh([data, model], ("data", "model"), device_type)


def spatial_sharding(mesh, batch_axis: str = "data",
                     spatial_axis: str = "model"):
    """The DTensor placements of an NCHW batch: N over ``batch_axis``
    (where the mesh has it), H over ``spatial_axis``; the JAX error for a
    mesh without that axis."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    if spatial_axis not in names:
        raise ValueError(
            f"mesh {names} has no '{spatial_axis}' axis to shard H "
            f"over — build it with make_2d_mesh(data, model)")
    return tuple(Shard(0) if n == batch_axis else
                 Shard(2) if n == spatial_axis else Replicate()
                 for n in names)


def shard_spatial(mesh, x: torch.Tensor, batch_axis: str = "data",
                  spatial_axis: str = "model") -> torch.Tensor:
    """This rank's block of the global NCHW ``x`` under
    ``spatial_sharding``: its rows of the batch, then of the height."""
    from .mesh import rows_of

    spatial_sharding(mesh, batch_axis, spatial_axis)  # the JAX error
    names = tuple(mesh.mesh_dim_names)
    if batch_axis in names:
        x = x[rows_of(x.shape[0], mesh.size(names.index(batch_axis)),
                      mesh.get_local_rank(batch_axis))]
    a, b = row_range(x.shape[2], mesh.size(names.index(spatial_axis)),
                     mesh.get_local_rank(spatial_axis))
    return x[:, :, a:b]


# ---- the halo exchange -----------------------------------------------------
def _overlap(a: Rows, b: Rows) -> Rows:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (lo, lo)


def _p2p(sends: Dict[int, torch.Tensor], recvs: Dict[int, tuple],
         group, like: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Send ``sends[q]`` to group rank q and receive a tensor of shape
    ``recvs[q]`` from each q, all posted at once; on gloo a CUDA tensor
    crosses pinned host memory (gloo's rule, as for its collectives)."""
    if not sends and not recvs:
        return {}
    staged = like.is_cuda and dist.get_backend(group) == "gloo"
    dev = torch.device("cpu") if staged else like.device
    ops, bufs, keep = [], {}, []
    for q, t in sorted(sends.items()):
        h = t.detach().contiguous()
        if staged:
            h = h.to("cpu", copy=True).pin_memory()
        keep.append(h)
        ops.append(dist.P2POp(dist.isend, h, dist.get_global_rank(group, q),
                              group))
    for q, shape in sorted(recvs.items()):
        bufs[q] = torch.empty(shape, dtype=like.dtype, device=dev,
                              pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, bufs[q],
                              dist.get_global_rank(group, q), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {q: b.to(like.device, non_blocking=False) for q, b in bufs.items()}


class _Halo(torch.autograd.Function):
    """Rows ``need[r]`` of the plane of height ``h`` whose rows
    ``row_range`` spreads over ``group``; forward fetches, backward
    returns each fetched row's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, h, need, group):
        m, r = dist.get_world_size(group), dist.get_rank(group)
        own = [row_range(h, m, q) for q in range(m)]
        ctx.need, ctx.group, ctx.own = need, group, own
        a = own[r][0]
        sends = {q: x[:, :, s - a:e - a] for q in range(m) if q != r
                 for s, e in [_overlap(own[r], need[q])] if e > s}
        recvs = {q: x.shape[:2] + (e - s,) + x.shape[3:]
                 for q in range(m) if q != r
                 for s, e in [_overlap(own[q], need[r])] if e > s}
        got = _p2p(sends, recvs, group, x)
        parts = []
        for q in range(m):
            s, e = _overlap(own[q], need[r])
            if e > s:
                parts.append(x[:, :, s - a:e - a] if q == r else got[q])
        return torch.cat(parts, 2) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, g):
        need, own, group = ctx.need, ctx.own, ctx.group
        m, r = len(own), dist.get_rank(group)
        a, b = own[r]
        g = g.contiguous()
        lo = need[r][0]
        sends = {q: g[:, :, s - lo:e - lo] for q in range(m) if q != r
                 for s, e in [_overlap(own[q], need[r])] if e > s}
        recvs = {q: g.shape[:2] + (e - s,) + g.shape[3:]
                 for q in range(m) if q != r
                 for s, e in [_overlap(own[r], need[q])] if e > s}
        got = _p2p(sends, recvs, group, g)
        dx = g.new_zeros(g.shape[:2] + (b - a,) + g.shape[3:])
        s, e = _overlap(own[r], need[r])
        if e > s:
            dx[:, :, s - a:e - a] += g[:, :, s - lo:e - lo]
        for q, t in got.items():
            s, e = _overlap(own[r], need[q])
            dx[:, :, s - a:e - a] += t
        return dx, None, None, None


def halo(x: torch.Tensor, h: int, need: Sequence[Rows], group
         ) -> torch.Tensor:
    """Rows ``need[r]`` (clipped to ``[0, h)``) of the plane this rank holds
    rows ``row_range(h, M, r)`` of, with every rank's ``need`` given alike
    (each rank sends what the others need of its rows)."""
    return _Halo.apply(x, h, [tuple(n) for n in need], group)


# ---- the ops -----------------------------------------------------------------
def _check_rows(what: str, h_out: int, m: int) -> None:
    if h_out < m:
        raise ValueError(f"--parallel sp: {what} gives a plane of {h_out} "
                         f"rows, fewer than the {m} ranks of 'model'; use "
                         "larger images or a smaller model axis")


def _conv_weights(conv: nn.Module, x: torch.Tensor):
    dt = getattr(conv, "compute_dtype", None)
    w, b = conv.weight, conv.bias
    if dt is None:
        return x, w, b
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d, h: int, group,
                pad: int, mode: str = "zeros") -> Tuple[torch.Tensor, int]:
    """``conv`` over a plane of height ``h`` split over ``group``, padded by
    ``pad`` (``'reflect'`` or ``'zeros'``; the conv itself unpadded, or
    padded by ``pad`` with zeros); returns this rank's output rows and the
    output's height."""
    k, s = conv.kernel_size[0], conv.stride[0]
    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out = (h + 2 * pad - k) // s + 1
    _check_rows(f"a {k}×{k} stride-{s} conv on {h} rows", h_out, m)

    def rows(q):
        o0, o1 = row_range(h_out, m, q)
        return o0 * s - pad, (o1 - 1) * s - pad + k

    want = [rows(q) for q in range(m)]
    need = [(max(lo, 0), min(hi, h)) for lo, hi in want]
    xb = halo(x, h, need, group)
    lo, hi = want[r]
    pw = pad if mode == "reflect" else conv.padding[1]
    xb = F.pad(xb, (pw, pw, max(0, -lo), max(0, hi - h)),
               mode="reflect" if mode == "reflect" else "constant")
    xb, w, b = _conv_weights(conv, xb)
    return F.conv2d(xb, w, b, conv.stride, 0, conv.dilation,
                    conv.groups), h_out


def conv_transpose2d_rows(x: torch.Tensor, conv: nn.ConvTranspose2d,
                          h: int, group) -> Tuple[torch.Tensor, int]:
    """``conv`` (a ``ConvTranspose2d``) over a plane of height ``h`` split
    over ``group``: this rank's output rows by the rule, from the input
    rows that reach them; returns them and the output's height."""
    k, s = conv.kernel_size[0], conv.stride[0]
    p, op = conv.padding[0], conv.output_padding[0]
    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out = (h - 1) * s - 2 * p + k + op
    _check_rows(f"a {k}×{k} stride-{s} transposed conv on {h} rows",
                h_out, m)

    def rows(q):  # input i reaches outputs i·s − p … i·s − p + k − 1
        o0, o1 = row_range(h_out, m, q)
        return (max(0, -((k - 1 - o0 - p) // s)),
                min(h, (o1 - 1 + p) // s + 1))

    need = [rows(q) for q in range(m)]
    xb = halo(x, h, need, group)
    o0, o1 = row_range(h_out, m, r)
    i0 = need[r][0]
    xb, w, b = _conv_weights(conv, xb)
    y = F.conv_transpose2d(xb, w, None, conv.stride,
                           (0, conv.padding[1]),
                           (0, conv.output_padding[1]), conv.groups,
                           conv.dilation)
    u0, u1 = o0 - i0 * s + p, o1 - i0 * s + p
    if u1 > y.shape[2]:  # rows the output padding adds below every input
        y = F.pad(y, (0, 0, 0, u1 - y.shape[2]))
    y = y[:, :, u0:u1]
    return (y if b is None else y + b.view(1, -1, 1, 1)), h_out


def _run(layers: Sequence[nn.Module], x: torch.Tensor, h: int, group
         ) -> Tuple[torch.Tensor, int]:
    """Apply ``layers`` in order to this rank's rows ``x`` of a plane of
    height ``h``; returns the rows out and their plane's height."""
    from ..models.networks import ResnetBlock
    from ..ops.kernels.instance_norm import instance_norm
    from ..ops.layers import InstanceNorm

    layers = list(layers)
    i = 0
    while i < len(layers):
        mod = layers[i]
        if isinstance(mod, nn.ReflectionPad2d):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            pads = set(mod.padding)
            if len(pads) != 1 or not isinstance(nxt, nn.Conv2d) or \
                    nxt.padding != (0, 0):
                raise NotImplementedError(
                    "--parallel sp: a ReflectionPad2d must pad equally and "
                    "feed an unpadded conv")
            x, h = conv2d_rows(x, nxt, h, group, pads.pop(), "reflect")
            i += 2
            continue
        if isinstance(mod, nn.Conv2d):
            x, h = conv2d_rows(x, mod, h, group, mod.padding[0])
        elif isinstance(mod, nn.ConvTranspose2d):
            x, h = conv_transpose2d_rows(x, mod, h, group)
        elif isinstance(mod, InstanceNorm):
            x = instance_norm(x, mod.eps, group, h * x.shape[3])
        elif isinstance(mod, ResnetBlock):
            x = x + _run(mod.conv_block, x, h, group)[0]
        elif isinstance(mod, (nn.ReLU, nn.LeakyReLU, nn.Tanh, nn.Sigmoid,
                              nn.Dropout, nn.Identity)):
            x = mod(x)
        else:
            raise NotImplementedError(
                f"--parallel sp has no row split for {type(mod).__name__} "
                "(ROADMAP A1c)")
        i += 1
    return x, h


class _SpatialNet:
    """The forward of a net whose input rows lie on the ranks of
    ``sp_group`` (see the module's docstring)."""
    sp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.sp_group
        if g is None or dist.get_world_size(g) == 1:
            return super().forward(x)
        return _run(self.model, x, x.shape[2] * dist.get_world_size(g), g)[0]


@functools.lru_cache(maxsize=None)
def _spatial_class(cls):
    return type(f"Spatial{cls.__name__}", (_SpatialNet, cls), {})


def spatial(net: nn.Module, group) -> nn.Module:
    """Make ``net`` (a ``ResnetGenerator`` with ConvTranspose ups, or an
    ``NLayerDiscriminator``) run on rows split over ``group``, in place;
    returns it. Its parameters, names and state dict do not change."""
    from ..models.networks import NLayerDiscriminator, ResnetGenerator

    ok = (isinstance(net, NLayerDiscriminator) or
          (isinstance(net, ResnetGenerator)
           and net.up_mode == "convtranspose"))
    if not ok:
        raise NotImplementedError(
            f"--parallel sp has no row split for {type(net).__name__} "
            "(ROADMAP A1c)")
    base = type(net)
    if not issubclass(base, _SpatialNet):
        net.__class__ = _spatial_class(base)
    net.sp_group = group
    return net


def spatial_state(state, group):
    """Lay ``state`` out for ``--parallel sp``: every net runs on rows
    split over ``group``."""
    for net in state.nets.values():
        spatial(net, group)
    return state
