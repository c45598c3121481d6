"""Generic post-training int8 quantization for any net of the port (the JAX
package's ``models/ptq.py``).

``models/quantization.py`` is the hand-fused ResnetGenerator path. This
module is the breadth mechanism: it serves any net built from
``nn.Conv2d`` / ``nn.ConvTranspose2d`` int8 without touching its code, by
swapping each selected conv's ``forward`` inside a context manager
(``int8_interceptor``, the counterpart of flax's ``nn.intercept_methods``).
The net itself is never changed for good.

Scheme (as ``models/quantization.py``):

- weights: per-output-channel symmetric int8 (``quantize_conv_params``);
- activations: per-tensor symmetric int8, static scales from a calibration
  batch (abs-max × margin / 127);
- the conv runs as ``ops/int8_conv.py`` (im2col + cuBLAS int8 GEMM on the
  card, an exact fp64 conv on the CPU); the dequantize multiply and the bias
  stay fp32, then the result takes the conv's ``compute_dtype``, else the
  input's dtype.

Arithmetic order is the JAX module's, so that the first site's scales and
int32 accumulators are bit-equal to JAX's: ``act_scale`` is
``np.float32(max(amax·margin/127, 1e-12))`` computed in double; the input is
quantized by dividing by it, rounded half to even and clipped to ±127; the
output is ``y.float() * (act_scale * scale) + bias``.

Sites are keyed by the net's ``site_convs()`` names with ``/`` for ``.``:
the JAX param names, hence the flax module paths that the JAX ``_key``
reads. A net without ``site_convs`` is keyed by its module names. Each site
is ``{kernel_q (int8 HWIO), scale, act_scale (0-d)[, bias]}``, plain
tensors on the net's device, passed in as arguments; nothing is cached in
the net. Calibration and serving run with the net in ``eval()`` (BatchNorm
on its running statistics, never updated) and restore its mode after.
Only convs that run during calibration become sites (a RefineNet-LW
calibrated on 'real' serves its 'syn' adapters in float, as in JAX).

``default_predicate`` copies the JAX default: every ``nn.Conv2d``, no
``nn.ConvTranspose2d``. The JAX package keeps transposed convs float for a
TPU measurement (its lhs-dilated int8 form was 2× slower there); that
reason does not carry over to the GPU, where ``chip_smoke.py`` phase 22
times the opt-in (``predicate=lambda k, m: isinstance(m, CONVS)``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.int8_conv import conv2d_int8, conv_transpose2d_int8
from ..utils.weights import (hwio_from_conv_transpose_weight,
                             hwio_from_conv_weight)
from .quantization import quantize_conv_params

PathKey = str
SiteDict = Dict[PathKey, Dict[str, torch.Tensor]]
CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def default_predicate(path: PathKey, module: nn.Module) -> bool:
    """Quantize every ``nn.Conv2d``; keep ``nn.ConvTranspose2d`` float."""
    return isinstance(module, nn.Conv2d)


def conv_sites(net: nn.Module) -> Dict[nn.Module, PathKey]:
    """Every conv of ``net`` and its site key (the JAX module path)."""
    if hasattr(net, "site_convs"):
        named = net.site_convs().items()
    else:
        named = net.named_modules()
    return {m: name.replace(".", "/") for name, m in named
            if isinstance(m, CONVS)}


@contextmanager
def _forwards(replace: Dict[nn.Module, Callable]):
    """Swap each module's ``forward`` for ``replace[module]`` (given the
    original ``forward``) inside the block; restored on exit."""
    saved = {m: m.__dict__.get("forward") for m in replace}
    try:
        for m, make in replace.items():
            m.forward = make(m.forward)
        yield
    finally:
        for m, fwd in saved.items():
            if fwd is None:
                del m.forward
            else:
                m.forward = fwd


@contextmanager
def _serving(net: nn.Module):
    """``net`` in eval mode without autograd; its modes restored after."""
    modes = {m: m.training for m in net.modules()}
    net.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for m, mode in modes.items():
            m.training = mode


def _hwio(m: nn.Module) -> np.ndarray:
    if isinstance(m, nn.ConvTranspose2d):
        return hwio_from_conv_transpose_weight(m.weight)
    return hwio_from_conv_weight(m.weight)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def calibrate_model(net: nn.Module, *args: Any,
                    predicate: Callable[[PathKey, nn.Module], bool]
                    = default_predicate,
                    margin: float = 1.0, **kwargs: Any) -> SiteDict:
    """Run ``net(*args, **kwargs)`` in eval mode, recording every selected
    conv site's quantized weights and observed input abs-max.

    Returns ``{key: {kernel_q, scale, act_scale[, bias]}}`` in the order the
    sites ran, tensors on the device of ``net``'s parameters.
    """
    sites: SiteDict = {}
    keys = {m: k for m, k in conv_sites(net).items() if predicate(k, m)}

    def recorder(m):
        key = keys[m]

        def make(forward):
            def record(x):
                amax = float(x.detach().float().abs().max())
                entry = {"kernel": _hwio(m)}
                if m.bias is not None:
                    entry["bias"] = m.bias.detach().float().cpu().numpy()
                entry = quantize_conv_params(entry)
                entry["act_scale"] = np.float32(
                    max(amax * margin / 127.0, 1e-12))
                if key in sites:  # a shared module applied twice: widen
                    entry["act_scale"] = np.float32(max(
                        entry["act_scale"], float(sites[key]["act_scale"])))
                dev = m.weight.device
                sites[key] = {k: torch.as_tensor(v).to(dev)
                              for k, v in entry.items()}
                return forward(x)
            return record
        return make

    with _serving(net), _forwards({m: recorder(m) for m in keys}):
        net(*args, **kwargs)
    return sites


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """NCHW float → NHWC int8: divide by the scale, round half to even,
    clip to ±127."""
    xq = torch.clamp(torch.round(x.float() / act_scale), -127, 127)
    return xq.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _dequantize(y: torch.Tensor, q: Dict[str, torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    """int32 NHWC → NCHW ``out_dtype``: y·(act_scale·scale) + bias in fp32."""
    out = y.float() * (q["act_scale"] * q["scale"])
    if "bias" in q:
        out = out + q["bias"]
    return out.to(out_dtype).permute(0, 3, 1, 2).contiguous()


def _out_dtype(m: nn.Module, x: torch.Tensor) -> torch.dtype:
    return getattr(m, "compute_dtype", None) or x.dtype


def _int8_conv(m: nn.Conv2d, x: torch.Tensor,
               q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``m``'s conv on int8 (JAX ``_int8_conv``). The port's nets pad
    explicitly (``nn.ReflectionPad2d``) or with zeros in the conv."""
    if isinstance(m.padding, str) or m.padding_mode != "zeros":
        raise NotImplementedError(
            f"int8 conv with padding {m.padding!r}, mode {m.padding_mode}")
    y = conv2d_int8(_quantize(x, q["act_scale"]), q["kernel_q"], m.stride,
                    m.padding, m.dilation, m.groups)
    return _dequantize(y, q, _out_dtype(m, x))


def _int8_conv_transpose(m: nn.ConvTranspose2d, x: torch.Tensor,
                         q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``m``'s transposed conv on int8, lhs-dilated (JAX
    ``_int8_conv_transpose``)."""
    if m.groups != 1 or tuple(m.dilation) != (1, 1):
        raise NotImplementedError("int8 transposed conv with groups or "
                                  "dilation")
    y = conv_transpose2d_int8(_quantize(x, q["act_scale"]), q["kernel_q"],
                              m.stride, m.padding, m.output_padding)
    return _dequantize(y, q, _out_dtype(m, x))


def int8_interceptor(net: nn.Module, sites: SiteDict):
    """Context manager: inside it, each conv of ``net`` with an entry in
    ``sites`` runs its int8 form; every ``forward`` is restored on exit."""

    def int8_form(m, q):
        conv = (_int8_conv_transpose if isinstance(m, nn.ConvTranspose2d)
                else _int8_conv)
        return lambda forward: (lambda x: conv(m, x, q))

    return _forwards({m: int8_form(m, sites[k])
                      for m, k in conv_sites(net).items() if k in sites})


def int8_apply(net: nn.Module, sites: SiteDict, *args: Any, **kwargs: Any
               ) -> Any:
    """``net(*args, **kwargs)`` in eval mode with the calibrated conv sites
    served int8. ``sites`` is an argument: perturbing it moves the output."""
    with _serving(net), int8_interceptor(net, sites):
        return net(*args, **kwargs)


def quantize_for_serving(
    net: nn.Module,
    calib_args: Tuple[Any, ...],
    *,
    predicate: Callable[[PathKey, nn.Module], bool] = default_predicate,
    margin: float = 1.0,
    calib_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[SiteDict, Callable[..., Any]]:
    """One-call PTQ: calibrate on ``calib_args`` and return ``(sites,
    serve)``, where ``serve(sites, *args, **kw)`` is the int8 forward (the
    net still supplies the norms and the convs left float).

    >>> sites, serve = quantize_for_serving(g, (calib_x,))
    >>> y = serve(sites, x)
    """
    sites = calibrate_model(net, *calib_args, predicate=predicate,
                            margin=margin, **(calib_kwargs or {}))

    def serve(sites_: SiteDict, *args: Any, **kw: Any) -> Any:
        return int8_apply(net, sites_, *args, **kw)

    return sites, serve
