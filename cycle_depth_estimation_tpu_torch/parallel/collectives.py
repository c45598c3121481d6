"""The collectives of the port's data and tensor parallelism: what XLA's
SPMD partitioner inserts for the JAX package, written out for one process
per rank.

The JAX package runs one program over a mesh, so ``--batch_size`` is the
global batch and every reduction over it is global. Here each rank runs the
step on its rows, and these helpers rebuild that equality:

- ``sync_grads``: the gradient all-reduce of a net over the ``data`` group,
  averaged, in flat buckets; a gradient that is ``None`` becomes a zero
  tensor first, on every rank alike (so Adam counts the step as optax does);
  ``sync_replicas`` averages over ``model`` the gradients of the parameters
  that tensor parallelism leaves whole, so their replicas stay equal;
- ``all_reduce`` and ``all_gather``, differentiable; Megatron's *f*
  (``copy_to_model``: identity forward, all-reduce backward) and *g*
  (``reduce_from_model``: all-reduce forward, identity backward);
- ``global_mean(num, den)``: a masked mean over the global batch
  (and under ``--parallel sp`` the whole planes);
- ``global_rows`` / ``local_rows``: draw at the global batch's shape, keep
  this rank's rows; ``mean_over_data``: the metrics a step returns.

Under ``--parallel sp`` (``Groups.spatial``) the ``model`` group splits
each image's height instead of channels: ``spatial_mean`` is an
elementwise loss's mean over the whole plane (its sum and count summed
over ``model``, the sum's gradient passed through as Megatron's *g* does,
because every ``model`` rank computes the same loss from it), and
``sync_replicas`` sums each parameter's gradient over ``model`` (each rank
holds its rows' part) before ``sync_grads`` averages it over ``data``.
``all_gather_uneven`` gathers shards of differing sizes (the rows of a
plane that does not divide by the group).

Each rank makes the same collectives in the same order. ``activate`` names
this process's ``data`` and ``model`` groups (the train CLI does, once);
while none is active every helper is the single-process computation, with
no collective.

Backends: NCCL when every rank has its own card, gloo for CPU ranks and
for ranks that share one card (``mesh.choose_backend``). On gloo, every
collective on a CUDA tensor is staged through pinned host memory, and a
reduce-scatter is an all-reduce followed by this rank's slice: that is the
rule for the gloo backend, whatever the tensor, not a fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20


@dataclass
class Groups:
    """This rank's place on the mesh: its ``data`` and ``model`` groups
    (None: no process group, no collective), their sizes and this rank's
    index in each."""
    data: Optional[dist.ProcessGroup] = None
    data_size: int = 1
    data_rank: int = 0
    model: Optional[dist.ProcessGroup] = None
    model_size: int = 1
    model_rank: int = 0
    stage: Optional[dist.ProcessGroup] = None
    stage_size: int = 1
    stage_rank: int = 0
    spatial: bool = False  # ``model`` splits the image height (sp)


_ACTIVE = Groups()


def activate(groups: Groups) -> Groups:
    """Make ``groups`` this process's groups; returns the previous ones."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, groups
    return prev


def active() -> Groups:
    return _ACTIVE


def data_size() -> int:
    return _ACTIVE.data_size


def data_rank() -> int:
    return _ACTIVE.data_rank


def is_writer() -> bool:
    """True on the rank that prints, logs and saves: global rank 0, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---- the raw collectives, with gloo's staging --------------------------
def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, or a pinned host copy of it where the group's backend
    is gloo and ``t`` lies on a CUDA device."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().to("cpu", copy=True).pin_memory()
    return t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    h = _staged(t, group)
    dist.all_reduce(h, group=group)
    if h is not t:
        t.copy_(h, non_blocking=False)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    h = _staged(t.contiguous(), group)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    return torch.cat(parts, dim).to(t.device)


def all_gather_uneven(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order,
    where their sizes along ``dim`` may differ (no gradient)."""
    n = dist.get_world_size(group)
    sizes = torch.tensor([t.shape[dim]], dtype=torch.int64)
    sizes = all_gather_cat(sizes.to(t.device), group).tolist()
    big = max(sizes)
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, big - t.shape[dim]]
    full = all_gather_cat(torch.nn.functional.pad(t.detach(), pad), group,
                          dim)
    return torch.cat([full.narrow(dim, r * big, sizes[r]) for r in range(n)],
                     dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``t`` over ``group``
    (``t.shape[dim]`` divides by the group's size)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = t.shape[dim] // n
    if dist.get_backend(group) == "gloo":
        return all_reduce_(t.detach().clone(), group).narrow(dim, r * k, k)
    chunks = [c.contiguous() for c in t.detach().split(k, dim)]
    out = torch.empty_like(chunks[r])
    dist.reduce_scatter(out, chunks, group=group)
    return out


# ---- differentiable -----------------------------------------------------
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``x`` over ``group``; its gradient is the Σ of the ranks'
    gradients (each rank's loss reads the sum)."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the gradient of this
    rank's part is its slice of the ranks' summed gradients."""
    return x if group is None else _AllGather.apply(x, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce backward (before a
    column-sharded layer)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: all-reduce forward, identity backward (after a
    row-sharded layer's partial sums)."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---- the data axis --------------------------------------------------------
def global_mean(num: torch.Tensor, den: torch.Tensor,
                min_den: float = 0.0) -> torch.Tensor:
    """Σ num / max(Σ den, ``min_den``) over the ``data`` group, for a mean
    over a mask whose count differs by rank, and under ``--parallel sp``
    over ``model`` too (each rank holds some rows of the planes; the
    sum's gradient passed through there, as in ``spatial_mean``). Every
    rank gets the global value; with the gradient average of
    ``sync_grads`` the gradient is the global mean's."""
    g = _ACTIVE
    if g.spatial and g.model is not None and g.model_size > 1:
        both = reduce_from_model(torch.stack([num, den.detach().to(
            num.dtype)]), g.model)
        num, den = both[0], both[1]
    group = g.data
    if group is None:
        return num / den.clamp_min(min_den)
    den = all_reduce_(den.detach().clone(), group)
    return all_reduce(num, group) / den.clamp_min(min_den)


def global_rows(n: int) -> int:
    """The global batch of a rank's ``n`` rows."""
    return n * _ACTIVE.data_size


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (its index on ``data``)."""
    k = t.shape[0] // _ACTIVE.data_size
    return t[_ACTIVE.data_rank * k:(_ACTIVE.data_rank + 1) * k]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch of every rank's rows ``t`` (no gradient)."""
    group = _ACTIVE.data
    return t if group is None else all_gather_cat(t.detach(), group)


def mean_over_data(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over ``data``: the mean of equal-size
    rows' means is the global mean, and a value already global stays."""
    group = _ACTIVE.data
    if group is None or not metrics:
        return metrics
    flat = all_reduce_(torch.stack(list(metrics.values())), group)
    flat /= _ACTIVE.data_size
    return dict(zip(metrics, flat.unbind()))


def _average(grads: List[torch.Tensor], group, size: int) -> None:
    """Average ``grads`` over ``group`` in place (the sum divided by
    ``size``; 1 for the sum), in flat buckets of up to ``BUCKET_BYTES``
    per dtype and device."""
    buckets: Dict[tuple, List[List[torch.Tensor]]] = {}
    for g in grads:
        runs = buckets.setdefault((g.dtype, g.device), [[]])
        if runs[-1] and (sum(x.numel() for x in runs[-1]) + g.numel()) \
                * g.element_size() > BUCKET_BYTES:
            runs.append([])
        runs[-1].append(g)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([g.reshape(-1) for g in run])
            all_reduce_(flat, group)
            if size != 1:
                flat /= size
            for g, v in zip(run, flat.split([g.numel() for g in run])):
                g.copy_(v.view_as(g))


def sync_replicas(params: Iterable[torch.Tensor]) -> None:
    """Over ``model``, the ``.grad`` of the parameters of ``params`` that
    are not split over it: under tensor parallelism averaged (the ranks of
    one ``data`` index compute them alike, up to cuDNN's order of
    summation, and the average keeps their replicas equal); under spatial
    parallelism summed (each rank's is its rows' part). A ``None``
    gradient becomes zeros first."""
    if _ACTIVE.model is None or _ACTIVE.model_size == 1:
        return
    whole = [p for p in params if getattr(p, "tp_dim", None) is None]
    for p in whole:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _average([p.grad for p in whole], _ACTIVE.model,
             1 if _ACTIVE.spatial else _ACTIVE.model_size)


def spatial_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of the elementwise loss ``t``: over this rank's rows, or,
    under ``--parallel sp``, over the whole planes, the sum and the count
    summed over ``model`` (the sum's gradient passed through: every
    ``model`` rank computes the same loss from it)."""
    g = _ACTIVE
    if not g.spatial or g.model is None or g.model_size == 1:
        return t.mean()
    num = t.sum()
    both = reduce_from_model(
        torch.stack([num, num.new_tensor(float(t.numel()))]), g.model)
    return both[0] / both[1]


def gather_spatial(t: torch.Tensor, dim: Optional[int] = None
                   ) -> torch.Tensor:
    """Under ``--parallel sp``, the whole height of this rank's rows ``t``
    (gathered over ``model``, no gradient; the height is the dimension
    before the last unless ``dim`` says otherwise: NCHW images, NHW label
    maps); else ``t``."""
    g = _ACTIVE
    if not g.spatial or g.model is None or g.model_size == 1:
        return t
    return all_gather_uneven(t, g.model, t.dim() - 2 if dim is None else dim)


def sync_grads(params: Iterable[torch.Tensor]) -> None:
    """Average the ``.grad`` of ``params`` over ``data``, in flat buckets
    of up to ``BUCKET_BYTES`` per dtype; a ``None`` gradient becomes
    zeros first."""
    group = _ACTIVE.data
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _average([p.grad for p in params], group, _ACTIVE.data_size)
