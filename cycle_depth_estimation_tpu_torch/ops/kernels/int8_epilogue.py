"""Fused InstanceNorm epilogue of the int8 serving path.

Replaces the TPU kernel ``cycle_depth_estimation_tpu/ops/pallas/
int8_epilogue.py`` (``fused_in_epilogue``). InstanceNorm is invariant to a
per-channel positive affine map, so it runs straight on the raw int32 conv
accumulator: IN → [+residual | ReLU] → ×inv_scale → round half to even →
clip ±127 → int8, reflect- or edge-padded by ``pad`` for the next conv, with
an optional bf16 copy of the float value.

The kernel is CUDA C++ (``csrc/int8_epilogue.cu``, built by ``build.py`` and
called through ``ctypes``); its note on the bound and the design is there.
``plan_epilogue`` picks, from the shapes alone, the kernel's variant and its
launch geometry (channel tile, thread-block cluster, threads, dynamic shared
memory). ``plain_epilogue`` is the same arithmetic in torch: a CPU tensor
takes it, a CUDA tensor launches the kernel or raises.

Layout is NHWC, as the im2col int8 conv produces it and as the JAX function
takes it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

_PAD_MODES = ("reflect", "edge")


def pad_nhwc(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Spatial reflect/edge pad of an NHWC tensor of any dtype (``jnp.pad``
    semantics: 'reflect' does not repeat the edge)."""
    if pad == 0:
        return x
    if mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got {mode!r}")

    def index(size):
        i = torch.arange(-pad, size + pad, device=x.device)
        if mode == "edge":
            return i.clamp(0, size - 1)
        i = i.abs()
        return torch.where(i >= size, 2 * (size - 1) - i, i)

    return x.index_select(1, index(x.shape[1])).index_select(2, index(x.shape[2]))


def plain_epilogue(y: torch.Tensor, inv_scale: Optional[float],
                   residual: Optional[torch.Tensor] = None, *, relu: bool = False,
                   keep_float: bool = False, pad: int = 0,
                   pad_mode: str = "reflect", eps: float = 1e-5
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The kernel's arithmetic in plain torch (``_epilogue_math`` + ``_pad_sp``)."""
    xf = y.float()
    hw = xf.shape[1] * xf.shape[2]
    s1 = xf.sum(dim=(1, 2), keepdim=True)
    s2 = (xf * xf).sum(dim=(1, 2), keepdim=True)
    mean = s1 / hw
    var = s2 / hw - mean * mean
    z = (xf - mean) * torch.rsqrt(var + eps)
    if residual is not None:
        z = z + residual.float()
    elif relu:
        z = torch.clamp_min(z, 0.0)
    float_out = keep_float or residual is not None or inv_scale is None
    zf = z.to(torch.bfloat16) if float_out else None
    if inv_scale is None:
        return None, zf
    q = torch.clamp(torch.round(z * inv_scale), -127.0, 127.0).to(torch.int8)
    return pad_nhwc(q, pad, pad_mode), zf


def _check(y, residual, relu, pad, pad_mode):
    if y.dim() != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(y.shape)}")
    if y.dtype not in (torch.int32, torch.bfloat16):
        raise TypeError(f"y must be int32 or bf16, not {y.dtype}")
    if residual is not None:
        if relu:
            raise ValueError("relu and residual are mutually exclusive")
        if residual.shape != y.shape or residual.dtype != torch.bfloat16:
            raise ValueError("residual must be bf16 with the shape of y")
        if residual.device != y.device:
            raise ValueError("residual and y are on different devices")
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got {pad_mode!r}")
    if not 0 <= pad < min(y.shape[1], y.shape[2]):
        raise ValueError(f"pad {pad} must be ≥ 0 and smaller than H and W")


MAX_SHARED_BYTES = 232448   # 227 KB: the most one block may take on sm_90
MAX_CLUSTER = 8             # the portable cluster size
SM_COUNT = 132              # blocks a launch should at least have (H100 SXM)
SM_SHARED_BYTES = 233472    # 228 KB of shared memory on one SM
BLOCK_RESERVED_BYTES = 1024  # of them, what the system takes per block


class EpiloguePlan(NamedTuple):
    """How one call launches the kernel.

    ``variant`` names what the numbers amount to: 'staged' (the cluster
    kernel with all of a block's rows of y kept in shared memory: one read of
    y), 'part_staged' (some rows kept, the others read twice), 'two_read'
    (none kept) or 'generic' (the scalar kernel for shapes the vector path
    cannot take; the other fields then describe its fixed geometry).
    """
    variant: str
    channel_tile: int     # channels per block
    cluster: int          # blocks that share one (sample, channel tile)
    threads: int          # threads per block
    shared_bytes: int     # dynamic shared memory per block
    rows: int             # rows of the plane per block
    staged_rows: int      # of them, rows kept in shared memory

    def blocks(self, n: int, c: int) -> int:
        return n * -(-c // self.channel_tile) * self.cluster


def _scratch_bytes(threads: int, channel_tile: int) -> int:
    """Reduction scratch at the head of the kernel's shared memory: per-warp
    partial sums, the block's sums and the channels' mean and 1/std."""
    return (threads // 32 + 2) * 2 * channel_tile * 4


def legal_clusters(h: int, pad: int, pad_mode: str):
    """Cluster sizes, largest first, that may split a plane of ``h`` rows:
    every block has a row, and the first and the last block own the source
    rows of the padded border (``pad + 1`` rows under 'reflect')."""
    need = pad + 1 if pad > 0 and pad_mode == "reflect" else 1
    out = []
    for s in range(MAX_CLUSTER, 1, -1):
        rows = -(-h // s)
        if min(rows, h - (s - 1) * rows) >= need:
            out.append(s)
    return out + [1]


def make_plan(shape, itemsize: int, channel_tile: int, cluster: int,
              threads: int, blocks_per_sm: int = 1) -> EpiloguePlan:
    """The cluster kernel's plan for this geometry: as many of a block's rows
    staged as shared memory holds when ``blocks_per_sm`` blocks share an SM
    (0 stages none), with the shared memory that takes."""
    _, h, w, _ = shape
    rows = -(-h // cluster)
    scratch = _scratch_bytes(threads, channel_tile)
    staged = 0
    if blocks_per_sm > 0:
        room = min(MAX_SHARED_BYTES, SM_SHARED_BYTES // blocks_per_sm
                   - BLOCK_RESERVED_BYTES) - scratch
        staged = max(0, min(rows, room // (w * channel_tile * itemsize)))
    variant = ("staged" if staged == rows else
               "part_staged" if staged else "two_read")
    return EpiloguePlan(variant, channel_tile, cluster, threads,
                        scratch + staged * w * channel_tile * itemsize, rows,
                        staged)


def plan_epilogue(shape, itemsize: int, *, pad: int = 0,
                  pad_mode: str = "reflect", quantize: bool = True,
                  residual: bool = False, aligned: bool = True
                  ) -> EpiloguePlan:
    """Pick variant and launch geometry for an NHWC ``shape`` of y with
    ``itemsize`` bytes per element (4: int32, 2: bf16).

    The cluster kernel needs C a multiple of 4, 16-byte aligned tensors
    (``aligned``), a padded plane of fewer than 2³¹ elements (its offsets
    are 32-bit) and at most 65,535 samples (a grid dimension); anything else
    takes the generic kernel. A plane is split over the largest legal
    cluster (``legal_clusters``). The channel tile is the widest of 32, 16,
    8 that still gives ``SM_COUNT`` blocks, else the one that gives most
    blocks. Threads and staged rows follow what the plan sweep of
    ``chip_smoke.py --sweep-epilogue`` measured on an H100:

    * a block whose rows fit a third of an SM's shared memory stages them
      all, three blocks to an SM, with 256 threads (512 where the residual
      is read as well: more loads to keep in flight);
    * a block whose rows fit one SM's shared memory stages them all, with
      1024 threads;
    * a larger block stages the rows that fit half an SM's shared memory
      and leaves the other half to L1, through which the other rows stream
      twice, with 1024 threads.
    """
    n, h, w, c = shape
    if not quantize:
        pad = 0
    if (c % 4 != 0 or not aligned or n > 65535
            or (h + 2 * pad) * (w + 2 * pad) * c >= 2 ** 31):
        return EpiloguePlan("generic", 8, 1, 1024, 0, h, 0)
    cluster = legal_clusters(h, pad, pad_mode)[0]
    tiles = [ct for ct in (32, 16, 8) if ct <= max(c, 8)]
    blocks = {ct: n * -(-c // ct) * cluster for ct in tiles}
    enough = [ct for ct in tiles if blocks[ct] >= SM_COUNT]
    ct = enough[0] if enough else max(tiles, key=lambda t: (blocks[t], t))
    plan = make_plan(shape, itemsize, ct, cluster, 512 if residual else 256, 3)
    if plan.variant != "staged":
        plan = make_plan(shape, itemsize, ct, cluster, 1024, 1)
    if plan.variant != "staged":
        plan = make_plan(shape, itemsize, ct, cluster, 1024, 2)
    return plan


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("int8_epilogue")
    fn = lib.int8_epilogue
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.int8_epilogue_active_clusters.argtypes = [ctypes.c_int] * 12
    lib.int8_epilogue_active_clusters.restype = ctypes.c_int
    return lib


def active_clusters(shape, itemsize: int, plan: EpiloguePlan, *, pad: int = 0,
                    pad_mode: str = "reflect") -> int:
    """How many clusters of ``plan`` the current CUDA device holds at once
    (``cudaOccupancyMaxActiveClusters``); 0 if it cannot place one."""
    n, h, w, c = shape
    got = _library().int8_epilogue_active_clusters(
        int(itemsize == 2), h, w, c, n, pad, int(pad_mode == "edge"),
        plan.channel_tile, plan.cluster, plan.threads, plan.shared_bytes,
        plan.staged_rows)
    if got < 0:
        raise RuntimeError(f"int8_epilogue occupancy query: CUDA error {-got}")
    return got


def launch(y: torch.Tensor, inv_scale: Optional[float],
           residual: Optional[torch.Tensor] = None, *, relu: bool = False,
           keep_float: bool = False, pad: int = 0, pad_mode: str = "reflect",
           eps: float = 1e-5, plan: Optional[EpiloguePlan] = None):
    """Launch the kernel on CUDA tensors that ``fused_in_epilogue`` has
    checked, with ``plan`` or, if None, the plan ``plan_epilogue`` picks
    (measurements pass their own)."""
    if y.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, not {y.device}")
    if not y.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("int8 epilogue kernel needs NHWC-contiguous tensors")
    n, h, w, c = y.shape
    q = None
    if inv_scale is not None:
        q = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.int8,
                        device=y.device)
    z = None
    if keep_float or residual is not None or inv_scale is None:
        z = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    if plan is None:
        aligned = all(t is None or t.data_ptr() % 16 == 0
                      for t in (y, residual, q, z))
        plan = plan_epilogue(y.shape, y.element_size(), pad=pad,
                             pad_mode=pad_mode, quantize=q is not None,
                             residual=residual is not None, aligned=aligned)
    fn = _library().int8_epilogue
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y.data_ptr(), int(y.dtype == torch.bfloat16),
                 None if residual is None else residual.data_ptr(),
                 None if q is None else q.data_ptr(),
                 None if z is None else z.data_ptr(),
                 n, h, w, c, 0.0 if inv_scale is None else float(inv_scale),
                 int(relu), pad, int(pad_mode == "edge"), float(eps),
                 int(plan.variant != "generic"), plan.channel_tile,
                 plan.cluster, plan.threads, plan.shared_bytes,
                 plan.staged_rows, stream)
    if err != 0:
        raise RuntimeError(f"int8_epilogue kernel launch failed: CUDA error "
                           f"{err} with {plan}")
    fused_in_epilogue.launches += 1
    fused_in_epilogue.variant_launches[plan.variant] += 1
    return q, z


def fused_in_epilogue(y: torch.Tensor, inv_scale: Optional[float],
                      residual: Optional[torch.Tensor] = None, *,
                      relu: bool = False, keep_float: bool = False, pad: int = 0,
                      pad_mode: str = "reflect", eps: float = 1e-5
                      ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """InstanceNorm(+ReLU | +residual) → requantize, fused.

    Args:
      y: raw int32 conv output (or bf16), NHWC.
      inv_scale: ``1 / act_scale`` of the consumer conv site as an fp32
        value, or None for a float-only epilogue (returns ``(None, z)``).
      residual: bf16 residual stream added after IN (excludes ``relu``);
        implies ``keep_float``.
      keep_float: also return the bf16 pre-quantize activation.
      pad: spatial padding baked into the int8 output.

    Returns:
      ``(q_int8_padded | None, z_bf16 | None)``.
    """
    _check(y, residual, relu, pad, pad_mode)
    if y.device.type == "cpu":
        return plain_epilogue(y, inv_scale, residual, relu=relu,
                              keep_float=keep_float, pad=pad,
                              pad_mode=pad_mode, eps=eps)
    if y.device.type != "cuda":
        raise ValueError(f"fused_in_epilogue: unsupported device {y.device}")
    return launch(y, inv_scale, residual, relu=relu, keep_float=keep_float,
                  pad=pad, pad_mode=pad_mode, eps=eps)


#: kernel launches since the caller last set this to 0
fused_in_epilogue.launches = 0
#: the same by ``EpiloguePlan.variant``; the caller clears it
fused_in_epilogue.variant_launches = collections.Counter()
