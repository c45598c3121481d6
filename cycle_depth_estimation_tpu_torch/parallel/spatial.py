"""Spatial sharding: the image height split over the ``model`` mesh axis
(the JAX package's ``parallel/spatial.py``, ``--parallel sp``).

The JAX package shards H of an NHWC tensor over ``model`` and lets XLA's
SPMD partitioner insert the halo exchanges and the norms' whole-plane
reductions. One process is one rank here, so both are written out:

- the split: rank m of M holds rows ``[m·H//M, (m+1)·H//M)`` of every
  plane (``mesh.row_range``); a net's input must split evenly (H divides by
  M), its layers' planes may not (the PatchGAN's 31- and 30-row planes),
  and a plane may have fewer rows than ranks (unet_256's innermost plane
  has one row): a rank that holds none of a layer's output rows still
  runs the layer on zero rows padded to one window and keeps none of it,
  so its backward reaches every exchange and all-reduce behind it;
- a windowed op of kernel k, stride s and padding p (a conv of dilation
  d spans k = d·(k − 1) + 1 rows; the 2×2 pools are k 2, s 2, p 0) owns
  the output rows of that rule on its own plane, ``[o0, o1)``, and needs
  the input rows ``[o0·s − p, (o1−1)·s − p + k)``, clipped to the
  plane: ``halo`` fetches those it lacks from the ranks that own them
  (one message a pair, all at once, so a shard thinner than the halo
  takes rows from several ranks), and its backward sends each fetched row's
  gradient back to be added to the owner's. The padding (reflect or
  zeros) is applied at the plane's top and bottom only, by the ranks that
  hold them; W stays whole on every rank and is padded as before;
- a transposed conv owns its output rows by the same rule and fetches the
  input rows that reach them; a nearest ×2 upsample reads input row
  ⌊o/2⌋ for output row o, a bilinear ×2 with corners aligned rows
  ⌊o·(h−1)/(2h−1)⌋ and the next, a nearest resize row ⌊o·h/h_out⌋ (the
  positions and weights of the global h); a global mean over the plane
  (``nn.AdaptiveAvgPool2d(1)``) sums each rank's rows and all-reduces the
  sums forward and backward, and every rank holds the pooled map;
- ``InstanceNorm`` runs the kernels' split entries with the ``model``
  group and the whole plane's count (``ops.kernels.instance_norm``);
  ``BatchNorm`` in train mode takes its statistics over ``data`` ×
  ``model`` with the global count (``ops.layers.BatchNorm``);
- ``Dropout`` (and T2Net's ``GaussianNoise``) draws the mask of the
  global batch's whole planes on every rank, in the one process's order
  of draws, and keeps this rank's block: one i.i.d. mask over the planes,
  the one process's;
- elementwise layers run on the rows as they are, and so do channel
  concatenations of parts that hold the same rows of one plane (the
  U-Net's skips, the Inception branches, the T2Net heads' inputs);
- each row op is one autograd node on every rank (``_local``), so the
  ranks' backwards meet their exchanges and all-reduces in one order.

``spatial(net, group)`` makes a net run so, in place: the CycleGAN and
pix2pix nets (``ResnetGenerator`` in both up modes, ``UnetGenerator``,
``NLayerDiscriminator``, ``PixelDiscriminator``), T2Net's task net
(``UNetGenerator``), SegCycle's ``UNetEncoder``/``UNetDecoder``, and the
nets of S2D, S2D_base and S2D_alt (``parallel/spatial_s2d.py``). A net
keeps its modules, names and parameters (``state_dict()`` and the
importers do not change); its forward walks its layers with each plane's
global height beside the local rows: ``_run`` walks a ``Sequential``,
``_layer`` one module (the blocks of these nets among them), and the nets
whose forwards are Python code over several features (the T2Net trunk
and heads, the encoder and decoder) have row forwards of their own here
that mirror theirs. Each rank's parameter gradients are then its rows'
part: the train step sums them over ``model``
(``collectives.sync_replicas``). Where the active groups are not spatial
(rank 0's in-loop KITTI validation), a net runs whole planes.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
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
        if not parts:  # this rank's layer has no output rows
            return x.new_zeros(x.shape[:2] + (0,) + x.shape[3:])
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
def _windows(h: int, h_out: int, m: int, k: int, s: int, p: int):
    """For each rank q, the input rows ``[o0·s − p, (o1−1)·s − p + k)``
    that its output rows ``row_range(h_out, m, q)`` read (None where it
    holds none), and the same clipped to the plane's ``h`` rows."""
    want = []
    for q in range(m):
        o0, o1 = row_range(h_out, m, q)
        want.append((o0 * s - p, (o1 - 1) * s - p + k) if o1 > o0 else None)
    need = [(0, 0) if w is None else (max(w[0], 0), min(w[1], h))
            for w in want]
    return want, need


class _Local(torch.autograd.Function):
    """``fn(*inputs)`` as one autograd node: the local work of a row op
    (padding, the conv or pool, the cut to this rank's rows), whatever
    its path on this rank, recorded inside and differentiated there. The
    local graph keeps what it saves itself, outside any checkpoint's
    saved-tensor hooks (``--remat``: the checkpoint's recompute runs the
    op again, and its exchanges; only this node's own graph is not
    recomputed)."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                _keep, _keep):
            ins = [t.detach().requires_grad_() if torch.is_tensor(t)
                   and t.requires_grad else t for t in inputs]
            out = fn(*ins)
        ctx.ins, ctx.out = ins, out
        return out.detach().contiguous()

    @staticmethod
    def backward(ctx, g):
        ins, out = ctx.ins, ctx.out
        ctx.ins = ctx.out = None
        want = [t for t in ins if torch.is_tensor(t) and t.requires_grad]
        grads = iter(torch.autograd.grad(out, want, g, allow_unused=True)
                     if want and out.requires_grad else [None] * len(want))
        return (None, *(next(grads) if torch.is_tensor(t) and t.requires_grad
                        else None for t in ins))


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _local(fn: Callable, *inputs) -> torch.Tensor:
    """``fn(*inputs)``, one autograd node where a gradient is wanted.

    Ranks take different paths through a row op (a padding only at the
    plane's edges, zero rows where a rank holds none), and autograd would
    record different nodes for them; its engine runs the independent
    branches of a graph (the six generator passes of a CycleGAN step, a
    net's two heads) in the order of the nodes' creation, so the ranks'
    backward would meet their exchanges and all-reduces in different
    orders, and gloo would pair messages of equal size from different
    exchanges. With each op one node, every rank's graph is the same."""
    if not torch.is_grad_enabled() or not any(
            torch.is_tensor(t) and t.requires_grad for t in inputs):
        return fn(*inputs)
    return _Local.apply(fn, *inputs)


def _cast(mod: nn.Module, x, w, b):
    dt = getattr(mod, "compute_dtype", None)
    if dt is None:
        return x, w, b
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d, h: int, group,
                pad: int, mode: str = "zeros") -> Tuple[torch.Tensor, int]:
    """``conv`` over a plane of height ``h`` split over ``group``, padded by
    ``pad`` (``'reflect'`` or ``'zeros'``; the conv itself unpadded, or
    padded by ``pad`` with zeros); returns this rank's output rows and the
    output's height."""
    k = conv.dilation[0] * (conv.kernel_size[0] - 1) + 1
    s = conv.stride[0]
    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out = (h + 2 * pad - k) // s + 1
    want, need = _windows(h, h_out, m, k, s, pad)
    xb = halo(x, h, need, group)
    pw = pad if mode == "reflect" else conv.padding[1]
    if want[r] is None:  # no output row here: k zero rows, cut to none
        pads, how = (pw, pw, 0, k), "constant"
    else:
        lo, hi = want[r]
        pads = (pw, pw, max(0, -lo), max(0, hi - h))
        how = "reflect" if mode == "reflect" else "constant"

    def op(t, w, b):
        t, w, b = _cast(conv, F.pad(t, pads, mode=how), w, b)
        y = F.conv2d(t, w, b, conv.stride, 0, conv.dilation, conv.groups)
        return y if want[r] else y[:, :, :0]

    return _local(op, xb, conv.weight, conv.bias), h_out


def conv_transpose2d_rows(x: torch.Tensor, conv: nn.ConvTranspose2d,
                          h: int, group) -> Tuple[torch.Tensor, int]:
    """``conv`` (a ``ConvTranspose2d``) over a plane of height ``h`` split
    over ``group``: this rank's output rows by the rule, from the input
    rows that reach them; returns them and the output's height."""
    k, s = conv.kernel_size[0], conv.stride[0]
    p, op_pad = conv.padding[0], conv.output_padding[0]
    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out = (h - 1) * s - 2 * p + k + op_pad

    def rows(q):  # input i reaches outputs i·s − p … i·s − p + k − 1
        o0, o1 = row_range(h_out, m, q)
        if o1 == o0:
            return 0, 0
        return (max(0, -((k - 1 - o0 - p) // s)),
                min(h, (o1 - 1 + p) // s + 1))

    need = [rows(q) for q in range(m)]
    xb = halo(x, h, need, group)
    o0, o1 = row_range(h_out, m, r)
    u0 = o0 - need[r][0] * s + p

    def op(t, w, b):
        if o1 == o0:  # no output row here: one zero row, cut to none
            t = F.pad(t, (0, 0, 0, 1))
        t, w, b = _cast(conv, t, w, b)
        y = F.conv_transpose2d(t, w, None, conv.stride,
                               (0, conv.padding[1]),
                               (0, conv.output_padding[1]), conv.groups,
                               conv.dilation)
        if o1 == o0:
            return y[:, :, :0]
        # the rows the output padding adds below every input
        y = F.pad(y, (0, 0, 0, max(0, u0 + o1 - o0 - y.shape[2])))
        y = y[:, :, u0:u0 + o1 - o0]
        return y if b is None else y + b.view(1, -1, 1, 1)

    return _local(op, xb, conv.weight, conv.bias), h_out


def pool2d_rows(x: torch.Tensor, h: int, group, pool=F.avg_pool2d,
                k: int = 2, s: int = 2) -> Tuple[torch.Tensor, int]:
    """``pool(x, k, s)`` (``F.avg_pool2d`` or ``F.max_pool2d``, unpadded)
    over a plane of height ``h`` split over ``group``: a window that
    straddles two ranks takes its rows from both."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out = (h - k) // s + 1
    want, need = _windows(h, h_out, m, k, s, 0)
    xb = halo(x, h, need, group)

    def op(t):
        if want[r] is None:  # no output row here: k zero rows, cut to none
            return pool(F.pad(t, (0, 0, 0, k)), k, s)[:, :, :0]
        return pool(t, k, s)

    return _local(op, xb), h_out


def upsample2_rows(x: torch.Tensor, h: int, group
                   ) -> Tuple[torch.Tensor, int]:
    """Nearest ×2 over a plane of height ``h`` split over ``group``:
    output row o reads input row ⌊o/2⌋, fetched where another rank owns
    it (the plane's rows need not split evenly)."""
    m, r = dist.get_world_size(group), dist.get_rank(group)

    def rows(q):
        o0, o1 = row_range(2 * h, m, q)
        return (o0 // 2, (o1 - 1) // 2 + 1) if o1 > o0 else (0, 0)

    need = [rows(q) for q in range(m)]
    xb = halo(x, h, need, group)
    o0, o1 = row_range(2 * h, m, r)
    u0 = o0 - 2 * need[r][0]

    def op(t):
        if o1 == o0:  # no output row here: one zero row, cut to none
            t = F.pad(t, (0, 0, 0, 1))
        return F.interpolate(t, scale_factor=2, mode="nearest")[
            :, :, u0:u0 + o1 - o0]

    return _local(op, xb), 2 * h


def _align_corners(n_in: int, n_out: int):
    """torch's bilinear source positions with corners aligned, in its
    float32 arithmetic: for each output index o, ``i0 = ⌊o·s⌋`` with ``s =
    (n_in − 1)/(n_out − 1)``, ``i1 = min(i0 + 1, n_in − 1)`` and the
    weight ``λ = o·s − i0`` of ``i1``."""
    s = (np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1
         else np.float32(0))
    src = s * np.arange(n_out, dtype=np.float32)
    i0 = src.astype(np.int64)
    return i0, np.minimum(i0 + 1, n_in - 1), src - i0.astype(np.float32)


def _lerp(t: torch.Tensor, dim: int, i0, i1, lam) -> torch.Tensor:
    """``t`` at the positions (i0, i1, λ) along ``dim``: t[i0]·(1 − λ) +
    t[i1]·λ."""
    shape = [1] * t.dim()
    shape[dim] = len(lam)
    w = torch.from_numpy(lam).to(t.device, t.dtype).view(shape)
    a = t.index_select(dim, torch.from_numpy(i0).to(t.device))
    b = t.index_select(dim, torch.from_numpy(i1).to(t.device))
    return a * (1 - w) + b * w


def bilinear2_rows(x: torch.Tensor, h: int, group
                   ) -> Tuple[torch.Tensor, int]:
    """Bilinear ×2 with corners aligned (``resize_bilinear(…,
    align_corners=True)``) over a plane of height ``h`` split over
    ``group``: output row o of 2h reads input rows ⌊o·(h−1)/(2h−1)⌋ and the
    one after it, the positions and weights taken from the global ``h``;
    the two can lie on two ranks, and a rank may hold output rows and
    none of their input. W is whole and resized as in one process."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    i0, i1, lam = _align_corners(h, 2 * h)

    def rows(q):
        o0, o1 = row_range(2 * h, m, q)
        return (int(i0[o0]), int(i1[o1 - 1]) + 1) if o1 > o0 else (0, 0)

    need = [rows(q) for q in range(m)]
    xb = halo(x, h, need, group)
    o0, o1 = row_range(2 * h, m, r)
    lo = need[r][0]

    def op(t):
        y = _lerp(t, 2, i0[o0:o1] - lo, i1[o0:o1] - lo, lam[o0:o1])
        return _lerp(y, 3, *_align_corners(t.shape[3], 2 * t.shape[3]))

    return _local(op, xb), 2 * h


def nearest_rows(x: torch.Tensor, h: int, size: Tuple[int, int], group
                 ) -> Tuple[torch.Tensor, int]:
    """``resize_nearest(x, size)`` over a plane of height ``h`` split over
    ``group``: output row o of ``size[0]`` reads input row ⌊o·h/size[0]⌋
    (the index torch's op takes), fetched where another rank owns it (the
    neighbouring rank's, where the rows split unevenly)."""
    from ..ops.layers import resize_nearest

    m, r = dist.get_world_size(group), dist.get_rank(group)
    h_out, w_out = size

    def index(n_in, n_out):  # the source index of each output index
        ramp = torch.arange(n_in, dtype=torch.float32).view(1, 1, n_in, 1)
        return resize_nearest(ramp, (n_out, 1)).view(-1).long().numpy()

    src = index(h, h_out)

    def rows(q):
        o0, o1 = row_range(h_out, m, q)
        return (int(src[o0]), int(src[o1 - 1]) + 1) if o1 > o0 else (0, 0)

    need = [rows(q) for q in range(m)]
    xb = halo(x, h, need, group)
    o0, o1 = row_range(h_out, m, r)

    def op(t):
        cols = torch.from_numpy(index(t.shape[3], w_out)).to(t.device)
        ii = torch.from_numpy(src[o0:o1] - need[r][0]).to(t.device)
        return t.index_select(2, ii).index_select(3, cols)

    return _local(op, xb), h_out


def global_mean_rows(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d(1)`` over a plane of height ``h`` split over
    ``group``: each rank's sum over its rows and W, summed over the group
    (``collectives.all_reduce``: the sum forward and backward, for every
    rank's rows read the one (N, C, 1, 1) map and each sends back its own
    gradient to it), over the whole plane's count. Every rank holds the
    map whole."""
    from .collectives import all_reduce

    s = all_reduce(x.sum((2, 3), keepdim=True), group)
    return s / (h * x.shape[3])


def plane_heights(tensors: Sequence[torch.Tensor], group) -> List[int]:
    """The heights of the planes whose rows ``tensors`` hold (NCHW, or
    NHW), their rows summed over ``group`` in one message: a net's input
    that is another net's output need not split evenly."""
    from .collectives import all_reduce_

    rows = torch.tensor([t.shape[-2] for t in tensors],
                        device=tensors[0].device)
    return all_reduce_(rows, group).tolist()


def plane_draw_rows(x: torch.Tensor, h: int, group, draw: Callable
                    ) -> torch.Tensor:
    """This rank's block of ``draw(shape)``, drawn at the global batch's
    whole planes (``x``'s shape with the ``data`` group's rows and ``h``
    rows a plane) on every rank alike: the one process's draw from the
    same generator state."""
    from .collectives import active
    from .mesh import rows_of

    g = active()
    m, r = dist.get_world_size(group), dist.get_rank(group)
    a, b = row_range(h, m, r)
    n = x.shape[0] * g.data_size
    full = draw((n,) + x.shape[1:2] + (h,) + x.shape[3:])
    return full[rows_of(n, g.data_size, g.data_rank), :, a:b]


def _same_plane(*parts) -> int:
    """The common height of ``parts`` ((rows, h) pairs) that one channel
    concatenation joins."""
    hs = {h for _, h in parts}
    if len(hs) != 1:
        raise ValueError(f"--parallel sp: a concatenation of planes of "
                         f"{sorted(hs)} rows")
    return hs.pop()


def _cat(*parts) -> Tuple[torch.Tensor, int]:
    h = _same_plane(*parts)
    return torch.cat([t for t, _ in parts], 1), h


def _is_2x2(mod) -> bool:
    def two(v):
        return v in (2, (2, 2))

    return (two(mod.kernel_size) and two(mod.stride or mod.kernel_size)
            and mod.padding in (0, (0, 0)) and not mod.ceil_mode
            and getattr(mod, "dilation", 1) in (1, (1, 1)))


def _layer(mod: nn.Module, x: torch.Tensor, h: int, group
           ) -> Tuple[torch.Tensor, int]:
    """One module of these nets on this rank's rows ``x`` of a plane of
    height ``h``; returns the rows out and their plane's height."""
    from ..models.networks import ResnetBlock, UnetSkipConnectionBlock
    from ..models.seg_network import (DecoderUpBlock, EncoderBlock,
                                      GaussianNoise, InceptionBlock,
                                      OutputBlock)
    from ..ops.kernels.instance_norm import instance_norm
    from ..ops.layers import BatchNorm, InstanceNorm, PReLU

    for cls, rows in _block_forwards().items():  # before nn.Sequential
        if isinstance(mod, cls):
            return rows(mod, x, h, group)
    if isinstance(mod, nn.Conv2d):
        return conv2d_rows(x, mod, h, group, mod.padding[0])
    if isinstance(mod, nn.ConvTranspose2d):
        return conv_transpose2d_rows(x, mod, h, group)
    if isinstance(mod, InstanceNorm):
        return instance_norm(x, mod.eps, group, h * x.shape[3]), h
    if isinstance(mod, BatchNorm):
        return mod(x, h), h
    if isinstance(mod, nn.Dropout):
        if not mod.training or mod.p == 0:
            return x, h
        keep = plane_draw_rows(x, h, group, lambda shape: F.dropout(
            x.new_ones(shape), mod.p, True))
        return x * keep, h
    if isinstance(mod, GaussianNoise):
        if not mod.training:
            return x, h
        noise = plane_draw_rows(x, h, group, lambda shape: (
            torch.randn(shape, device=x.device) - 0.5) / 10.0)
        return x + noise.to(x.dtype), h
    if isinstance(mod, nn.Upsample) and mod.mode == "nearest" and \
            mod.size is None and float(mod.scale_factor) == 2.0:
        return upsample2_rows(x, h, group)
    if isinstance(mod, (nn.AvgPool2d, nn.MaxPool2d)) and _is_2x2(mod):
        pool = F.avg_pool2d if isinstance(mod, nn.AvgPool2d) else \
            F.max_pool2d
        return pool2d_rows(x, h, group, pool)
    if isinstance(mod, ResnetBlock):
        return x + _run(mod.conv_block, x, h, group)[0], h
    if isinstance(mod, UnetSkipConnectionBlock):
        # the first layer of an inner level is an in-place LeakyReLU: the
        # skip half is LeakyReLU(x), as in the one process
        y, h_y = _run(mod.model, x, h, group)
        return (y, h_y) if mod.outermost else _cat((x, h), (y, h_y))
    if isinstance(mod, InceptionBlock):
        out, _ = _cat(*(_run(getattr(mod, f"layer{i}"), x, h, group)
                        for i in range(mod.width)))
        out = mod.nonlinearity(_layer(mod.norm1, out, h, group)[0])
        out = _run(mod.branch1x1, out, h, group)[0]
        out = _layer(mod.drop, _layer(mod.norm2, out, h, group)[0], h,
                     group)[0]
        return mod.nonlinearity(out + x), h
    if isinstance(mod, (EncoderBlock, DecoderUpBlock, OutputBlock)):
        return _run(mod.model, x, h, group)
    if isinstance(mod, nn.Sequential):
        return _run(mod, x, h, group)
    if isinstance(mod, (nn.ReLU, nn.LeakyReLU, nn.Tanh, nn.Sigmoid, nn.SELU,
                        PReLU, nn.Identity)):
        return mod(x), h
    raise NotImplementedError(
        f"--parallel sp has no row split for {type(mod).__name__} "
        "(ROADMAP A1c)")


def _run(layers: Sequence[nn.Module], x: torch.Tensor, h: int, group
         ) -> Tuple[torch.Tensor, int]:
    """Apply ``layers`` in order to this rank's rows ``x`` of a plane of
    height ``h``; returns the rows out and their plane's height."""
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
        x, h = _layer(mod, x, h, group)
        i += 1
    return x, h


# ---- the nets' row forwards ---------------------------------------------
def _trunk_rows(net, x, h, group) -> List[Tuple[torch.Tensor, int]]:
    """``UNetTrunk.forward`` (and ``UNetEncoder.forward``, the same minus
    the center's up block and noise) on rows: the five features with
    their heights."""
    feats = []
    for block in (net.conv1, net.conv2, net.conv3, net.conv4):
        x, h = pool2d_rows(*_layer(block, x, h, group), group)
        feats.append((x, h))
    y, h = _layer(net.center, x, h, group)
    noise = getattr(net, "noise", None)
    feats.append(_layer(noise, y, h, group) if noise is not None
                 else (y, h))
    return feats


def _head_rows(head, feats, group) -> List[torch.Tensor]:
    """``UNetHead.outputs`` on rows: [output4, output3, output2, output1]."""
    (conv1, h1), (conv2, h2), (conv3, h3), _, center_out = feats
    w = head.weight

    def both(cat, deconv, output):
        return _layer(deconv, *cat, group), _layer(output, *cat, group)

    cat4 = _cat(center_out, (conv3 * w, h3))
    deconv4, output4 = both(cat4, head.deconv4, head.output4)
    cat3 = _cat(deconv4, (conv2 * w * 0.5, h2),
                upsample2_rows(*output4, group))
    deconv3, output3 = both(cat3, head.deconv3, head.output3)
    cat2 = _cat(deconv3, (conv1 * w * 0.1, h1),
                upsample2_rows(*output3, group))
    deconv2, output2 = both(cat2, head.deconv2, head.output2)
    cat1 = _cat(deconv2, upsample2_rows(*output2, group))
    output1 = _layer(head.output1, *cat1, group)
    return [t for t, _ in (output4, output3, output2, output1)]


def _input_rows(x: torch.Tensor, group) -> int:
    """A net input's height: its rows split evenly over ``group``."""
    return x.shape[2] * dist.get_world_size(group)


def _sequential_net(attr: str):
    def forward(net, group, x):
        return _run(getattr(net, attr), x, _input_rows(x, group), group)[0]
    return forward


def _unet_forward(net, group, x):
    return _layer(net.model, x, _input_rows(x, group), group)[0]


def _task_net_forward(net, group, x, domain: str = "syn"):
    feats = _trunk_rows(net.trunk, x, _input_rows(x, group), group)
    head = net.head_syn if domain == "syn" else net.head_real
    return [feats[3][0], _head_rows(head, feats, group)[-1]]


def _encoder_forward(net, group, x):
    return [t for t, _ in _trunk_rows(net, x, _input_rows(x, group), group)]


def _decoder_forward(net, group, feats):
    feats = list(zip(feats, plane_heights(feats, group)))
    center_out = _layer(net.deconv_center, *feats[4], group)
    return [feats[3][0], *_head_rows(net.head, [*feats[:4], center_out],
                                     group)]


@functools.lru_cache(maxsize=None)
def _row_forwards():
    from ..models.encoder_decoder import UNetDecoder, UNetEncoder
    from ..models.networks import (NLayerDiscriminator, PixelDiscriminator,
                                   ResnetGenerator, UnetGenerator)
    from ..models.seg_network import UNetGenerator

    from .spatial_s2d import net_forwards

    return {ResnetGenerator: _sequential_net("model"),
            NLayerDiscriminator: _sequential_net("model"),
            PixelDiscriminator: _sequential_net("net"),
            UnetGenerator: _unet_forward,
            UNetGenerator: _task_net_forward,
            UNetEncoder: _encoder_forward,
            UNetDecoder: _decoder_forward,
            **net_forwards()}


@functools.lru_cache(maxsize=None)
def _block_forwards():
    """The row forwards of the blocks ``_layer`` meets inside the S2D
    nets (``parallel/spatial_s2d.py``), by module class."""
    from .spatial_s2d import block_forwards

    return block_forwards()


class _SpatialNet:
    """The forward of a net whose input rows lie on the ranks of
    ``sp_group`` (see the module's docstring)."""
    sp_group = None

    def forward(self, *args, **kw):
        from .collectives import active

        g = self.sp_group
        # one rank alone (the in-loop KITTI validation) runs whole planes
        if g is None or not active().spatial or dist.get_world_size(g) == 1:
            return super().forward(*args, **kw)
        return _row_forwards()[self.sp_base](self, g, *args, **kw)


@functools.lru_cache(maxsize=None)
def _spatial_class(cls):
    return type(f"Spatial{cls.__name__}", (_SpatialNet, cls),
                {"sp_base": cls})


def spatial(net: nn.Module, group) -> nn.Module:
    """Make ``net`` (one of the nets of the module's docstring) run on rows
    split over ``group``, in place; returns it. Its parameters, names and
    state dict do not change."""
    base = getattr(net, "sp_base", type(net))
    if base not in _row_forwards():
        raise NotImplementedError(
            f"--parallel sp has no row split for {base.__name__} "
            "(ROADMAP A1c)")
    net.__class__ = _spatial_class(base)
    net.sp_group = group
    return net


def spatial_state(state, group):
    """Lay ``state`` out for ``--parallel sp``: every net runs on rows
    split over ``group``."""
    for net in state.nets.values():
        spatial(net, group)
    return state
