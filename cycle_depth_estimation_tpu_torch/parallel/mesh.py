"""Process groups, the mesh and the batch split (the JAX package's
``parallel/mesh.py``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``; here
one process is one rank, and ``make_mesh`` lays the ranks of the world out
as a ``torch.distributed.DeviceMesh``: with no shape every rank goes on
``data``; a two-element shape gets ``('data', 'model')``. Rank r sits at
``data`` index r // M and ``model`` index r % M of a (D, M) mesh.

``init_distributed`` starts the process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) or from the
JAX flags ``--coordinator_address``, ``--num_processes`` and
``--process_index`` (a ``tcp://`` init). A rank takes ``cuda:LOCAL_RANK``
unless the caller asks for the CPU; the backend is NCCL when every rank of
the host has its own card, gloo for CPU ranks and for ranks that share one
card (NCCL refuses two ranks on one device): ``choose_backend`` decides
from the configuration, never from a failed attempt.

``host_shard_batch`` gives a rank its rows of the global batch, in rank
order of ``data``: ranks on one ``data`` index and different ``model``
indices get the same rows. Under ``--parallel sp`` (the active groups'
``spatial``) it then cuts the height of every tensor of rank ≥ 3 (NCHW
images, NHW label maps: the dimension before the last) over ``model``:
rank m takes rows ``[m·H//M, (m+1)·H//M)`` (``row_range``), the JAX
package's split of H over the ``model`` axis.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from . import collectives
from .collectives import Groups


def choose_backend(device: torch.device, ranks_per_host: int) -> str:
    """``nccl`` when the ranks are on CUDA and each of the host's
    ``ranks_per_host`` ranks has a card of its own; else ``gloo``."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:LOCAL_RANK`` (modulo the cards present, where ranks share
    them), or the CPU when ``device`` says so."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def launch_env(cfg) -> Optional[Dict[str, object]]:
    """The world this process belongs to, from torchrun's environment or
    the JAX flags (``coordinator_address`` 'host:port' or
    'tcp://host:port'); None for a single process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        world = int(env["WORLD_SIZE"])
        return dict(init_method="env://", rank=int(env["RANK"]),
                    world_size=world,
                    local_rank=int(env.get("LOCAL_RANK", 0)),
                    ranks_per_host=int(env.get("LOCAL_WORLD_SIZE", world)))
    if cfg.coordinator_address:
        addr = cfg.coordinator_address
        if not addr.startswith("tcp://"):
            addr = "tcp://" + addr
        return dict(init_method=addr, rank=cfg.process_index,
                    world_size=cfg.num_processes,
                    local_rank=int(env.get("LOCAL_RANK", cfg.process_index)),
                    ranks_per_host=int(env.get("LOCAL_WORLD_SIZE",
                                               cfg.num_processes)))
    return None


def init_distributed(init_method: str, rank: int, world_size: int,
                     local_rank: int, ranks_per_host: int,
                     device: str = "cuda") -> torch.device:
    """Join the process group, with the backend ``choose_backend`` names
    (printed first); returns this rank's device."""
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev, ranks_per_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    why = ("every rank has its own card" if backend == "nccl" else
           "CPU ranks" if dev.type == "cpu" else
           f"{ranks_per_host} ranks share {torch.cuda.device_count()} card(s)")
    print(f"[rank {rank}/{world_size}] backend {backend} ({why}), device "
          f"{dev}", flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              device_type: str = "cpu"):
    """A ``DeviceMesh`` over the world's ranks. Default: every rank on one
    ``data`` axis; a two-element shape gets ``('data', 'model')``. A shape
    that does not match its axis names, or that needs more ranks than the
    world has, raises the JAX package's ``ValueError``; so does one that
    uses fewer: a rank is a process, and one left out would run nothing."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape, axis_names = mesh_layout(shape, axis_names, world)
    return DeviceMesh(device_type, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def mesh_layout(shape, axis_names, world: int):
    """The checks and defaults of ``make_mesh``, without a process group:
    returns (shape, axis names)."""
    if shape is None:
        shape = [world] + [1] * (len(axis_names or ("data",)) - 1)
    if axis_names is None:
        axis_names = ("data", "model", "stage")[:len(shape)]
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{len(shape)} axis names, got {tuple(axis_names)}")
    need = 1
    for s in shape:
        need *= int(s)
    if need > world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {need} devices, "
            f"have {world}")
    if need < world:
        raise ValueError(f"mesh shape {tuple(shape)} uses {need} of "
                         f"{world} ranks; every rank must be on the mesh")
    return list(shape), tuple(axis_names)


def mesh_groups(mesh, spatial: bool = False) -> Groups:
    """This rank's ``data``, ``model`` and ``stage`` groups on ``mesh`` (an
    axis the mesh lacks has this rank alone, and no group); ``spatial``:
    ``model`` splits the image height (``--parallel sp``)."""
    names = mesh.mesh_dim_names
    kw = {"spatial": spatial}
    for axis in ("data", "model", "stage"):
        if axis in names:
            kw[axis] = mesh.get_group(axis)
            kw[f"{axis}_size"] = mesh.size(names.index(axis))
            kw[f"{axis}_rank"] = mesh.get_local_rank(axis)
    return Groups(**kw)


def batch_sharding(mesh, axis: str = "data"):
    """The DTensor placements of a batch on ``mesh``: dim 0 split over
    ``axis``, replicated over the other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh):
    """The DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def rows_of(n: int, size: int, index: int) -> slice:
    """Rank ``index``'s rows of a global batch of ``n`` over ``size``
    ranks; a batch that does not divide raises the JAX loader's error."""
    if n % size != 0:
        raise ValueError(
            f"global batch {n} is not divisible by process_count "
            f"{size}; set --batch_size to a multiple of the process "
            f"count (drop_last already removes partial batches)")
    k = n // size
    return slice(index * k, (index + 1) * k)


def row_range(n: int, size: int, index: int):
    """Rank ``index``'s rows ``(start, stop)`` of ``n`` rows split over
    ``size`` ranks: ``[index·n//size, (index+1)·n//size)``; the sizes
    differ by at most one where ``n`` does not divide."""
    return index * n // size, (index + 1) * n // size


def spatial_rows(batch: Dict[str, object], size: Optional[int] = None,
                 index: Optional[int] = None) -> Dict[str, object]:
    """This rank's rows of the height of every tensor of rank ≥ 3 of
    ``batch`` (``row_range``); by default over the active ``model`` group
    under ``--parallel sp``, else the batch as it is."""
    g = collectives.active()
    if size is None:
        if not g.spatial:
            return batch
        size, index = g.model_size, g.model_rank
    if size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 3:
            h = v.dim() - 2
            a, b = row_range(v.shape[h], size, index)
            v = v.narrow(h, a, b - a)
        out[k] = v
    return out


def shard_batch(batch: Dict[str, object], size: Optional[int] = None,
                index: Optional[int] = None,
                spatial: bool = True) -> Dict[str, object]:
    """This rank's rows of every tensor (and list) of a global batch; by
    default of the active ``data`` group, and then, under ``--parallel sp``
    and unless ``spatial`` is False, its rows of their height
    (``spatial_rows``)."""
    g = collectives.active()
    size = g.data_size if size is None else size
    index = g.data_rank if index is None else index
    out = batch
    if size != 1:
        out = {}
        for k, v in batch.items():
            if isinstance(v, (torch.Tensor, list)):
                v = v[rows_of(len(v), size, index)]
            out[k] = v
    return spatial_rows(out) if spatial else out


def host_shard_batch(batch: Dict[str, object], device,
                     size: Optional[int] = None,
                     index: Optional[int] = None,
                     spatial: bool = True) -> Dict[str, object]:
    """``shard_batch`` of a host batch, its tensors copied to ``device``
    (through pinned memory to a CUDA device): the host→device boundary,
    one transfer of the rank's rows a step."""
    device = torch.device(device)
    pin = device.type == "cuda"
    return {k: (v.pin_memory() if pin else v).to(device, non_blocking=pin)
            if isinstance(v, torch.Tensor) else v
            for k, v in shard_batch(batch, size, index, spatial).items()}
