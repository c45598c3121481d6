"""Fused InstanceNorm epilogue of the int8 serving path.

Replaces the TPU kernel ``cycle_depth_estimation_tpu/ops/pallas/
int8_epilogue.py`` (``fused_in_epilogue``). InstanceNorm is invariant to a
per-channel positive affine map, so it runs straight on the raw int32 conv
accumulator: IN → [+residual | ReLU] → ×inv_scale → round half to even →
clip ±127 → int8, reflect- or edge-padded by ``pad`` for the next conv, with
an optional bf16 copy of the float value.

The kernel is CUDA C++ (``csrc/int8_epilogue.cu``, built by ``build.py`` and
called through ``ctypes``); its note on the bound and the design is there.
``plain_epilogue`` is the same arithmetic in torch: a CPU tensor takes it,
a CUDA tensor launches the kernel or raises.

Layout is NHWC, as the im2col int8 conv produces it and as the JAX function
takes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("int8_epilogue")
    fn = lib.int8_epilogue
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(y, inv_scale, residual, relu, keep_float, pad, pad_mode, eps):
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
    fn = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(y.data_ptr(), int(y.dtype == torch.bfloat16),
             None if residual is None else residual.data_ptr(),
             None if q is None else q.data_ptr(),
             None if z is None else z.data_ptr(),
             n, h, w, c, 0.0 if inv_scale is None else float(inv_scale),
             int(relu), pad, int(pad_mode == "edge"), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"int8_epilogue kernel launch failed: CUDA error {err}")
    fused_in_epilogue.launches += 1
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
    return _launch(y, inv_scale, residual, relu, keep_float, pad, pad_mode, eps)


#: kernel launches since the caller last set this to 0
fused_in_epilogue.launches = 0
