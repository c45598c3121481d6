"""Int8 serving path of the ResnetGenerator, in PyTorch.

The counterpart of the JAX package's ``models/quantization.py``:

- weights: per-output-channel symmetric int8 (scale = max|w|/127);
- activations: per-tensor symmetric int8 with static scales baked by
  ``calibrate`` (abs-max over a calibration batch through the dynamic-scale
  v1 generator, ``Int8ResnetGenerator``);
- ``fused_int8_apply``: the serving forward. InstanceNorm is invariant to a
  per-channel positive affine map, so every conv→IN site skips the
  dequantize: the int8 conv's raw int32 output goes straight into the fused
  epilogue kernel (IN → ReLU | +residual → requantize → pad). ``up_mode``
  picks the up stages: 'bf16' (the JAX default) runs the two ConvTranspose
  stages in bf16; 'int8_dilated' and 'int8_phases' (the JAX package's
  lhs-dilated int8 conv and its exact split into four dense int8 convs and
  an interleave: the same integers, so both run the split, the faster of
  the two on the GPU) and 'resize_conv_int8' (an int8 nearest ×2, then a
  dense int8 3×3 conv; for a ``ResnetGenerator(up_mode='resize_conv')``)
  quantize them too, so the last block, up0 and up1 requantize in the
  epilogue kernel. Only conv_out dequantizes.

Variables are nested dicts keyed like the JAX param tree (``conv_in``,
``down0_conv``, ``block{i}.conv1``, ``up0_conv``, ``conv_out``): int8 HWIO
``kernel_q``, fp32 ``scale`` and ``bias`` tensors, and ``act_scale`` as a
Python float holding an fp32 value. The up stages keep their fp params
under ``params``: the torch ``weight`` and ``bias``, and ``kernel``, the
equivalent regular conv's HWIO kernel (the JAX param), which
``fused_int8_variables`` quantizes.

Model inputs and outputs are NCHW; the int8 trunk runs NHWC inside.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.int8_conv import conv2d_int8
from ..ops.kernels.instance_norm import instance_norm
from ..ops.kernels.int8_epilogue import fused_in_epilogue, pad_nhwc
from ..ops.layers import conv_transpose_s2_phases, reflect_pad
from ..utils.weights import (hwio_from_conv_transpose_weight,
                             hwio_from_conv_weight)
from .networks import ResnetGenerator


def synthetic_calibration_batch(seed: int, n: int, size: int) -> np.ndarray:
    """Structured calibration images in [-1, 1], NCHW float32.

    Smooth low-frequency content (oriented sinusoids, ramps, soft blobs)
    with a little sensor-like noise: closer to the activation statistics of
    real photos than uniform noise. The same numbers as the JAX package's
    function, which returns them NHWC.
    """
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, 3, size, size), np.float32)
    for i in range(n):
        for c in range(3):
            img = rng.uniform(-0.3, 0.3) * np.ones((size, size), np.float32)
            img += rng.uniform(-0.5, 0.5) * xx + rng.uniform(-0.5, 0.5) * yy
            for _ in range(4):  # oriented low-freq sinusoids
                f = rng.uniform(1.0, 8.0)
                th = rng.uniform(0, np.pi)
                ph = rng.uniform(0, 2 * np.pi)
                a = rng.uniform(0.1, 0.4)
                img += a * np.sin(2 * np.pi * f
                                  * (xx * np.cos(th) + yy * np.sin(th)) + ph)
            for _ in range(3):  # soft blobs
                cx, cy = rng.uniform(0, 1, 2)
                s = rng.uniform(0.05, 0.3)
                img += rng.uniform(-0.6, 0.6) * np.exp(
                    -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
            img += rng.normal(0, 0.02, img.shape)
            out[i, c] = img
    return np.clip(out, -1.0, 1.0)


def quantize_conv_params(entry: Dict[str, Any]) -> Dict[str, Any]:
    """fp HWIO conv params (numpy) → int8 kernel + per-out-channel scales."""
    w = np.asarray(entry["kernel"], np.float32)
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, 1e-12)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    out = {"kernel_q": wq, "scale": s.astype(np.float32)}
    if "bias" in entry:
        out["bias"] = np.asarray(entry["bias"], np.float32)
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'block0.conv1': v} → {'block0': {'conv1': v}}."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        if "." in name:
            outer, inner = name.split(".")
            out.setdefault(outer, {})[inner] = v
        else:
            out[name] = v
    return out


def quantize_resnet_generator(generator: ResnetGenerator) -> Dict[str, Any]:
    """Quantize every non-transposed conv of a generator (numpy leaves)."""
    flat = {}
    for site, conv in generator.site_convs().items():
        if site.startswith("up"):
            continue  # transposed convs stay bf16
        flat[site] = quantize_conv_params({
            "kernel": hwio_from_conv_weight(conv.weight),
            "bias": conv.bias.detach().float().cpu().numpy()})
    return _nest(flat)


def int8_generator_variables(generator: ResnetGenerator,
                             device=None) -> Dict[str, Any]:
    """Variables for ``Int8ResnetGenerator`` (dynamic-scale mode)."""
    dev = resolve_device(device)
    sites = generator.site_convs()
    hwio = (hwio_from_conv_weight if generator.up_mode == "resize_conv"
            else hwio_from_conv_transpose_weight)
    ups = {k: {"weight": sites[k].weight.detach().float(),
               "bias": sites[k].bias.detach().float(),
               "kernel": hwio(sites[k].weight)}
           for k in ("up0_conv", "up1_conv")}
    return {"params": _tree_to(ups, dev),
            "qparams": _tree_to(quantize_resnet_generator(generator), dev)}


def _up_bf16(h: torch.Tensor, p: Dict[str, torch.Tensor],
             up_mode: str = "convtranspose") -> torch.Tensor:
    """One up stage in bf16 on NCHW, bias not added: ConvTranspose2d(k3,
    s2, p1, op1), or for 'resize_conv' nearest ×2 and a zero-padded 3×3
    conv."""
    w = p["weight"].to(torch.bfloat16)
    if up_mode == "resize_conv":
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.conv2d(h, w, None, padding=1)
    return F.conv_transpose2d(h, w, None, stride=2, padding=1,
                              output_padding=1)


class Int8ResnetGenerator:
    """ResnetGenerator with int8 entry/down/block convs (v1).

    Call with variables from ``int8_generator_variables``. A site without a
    static ``act_scale`` quantizes with its observed abs-max and records it
    in ``observed`` (the calibration mode). ``up_mode`` is the generator's
    ('convtranspose' | 'resize_conv'); its up stages run in bf16.
    """

    def __init__(self, n_blocks: int = 9, up_mode: str = "convtranspose"):
        if up_mode not in ("convtranspose", "resize_conv"):
            raise ValueError(f"unknown up_mode [{up_mode}]")
        self.n_blocks = n_blocks
        self.up_mode = up_mode

    @staticmethod
    def _site(x, q, name, observed, stride=1, padding=0):
        xf = x.float()
        if "act_scale" in q:
            s_x = q["act_scale"]
        else:
            amax = xf.abs().max()
            observed[name] = amax
            s_x = torch.clamp_min(amax / 127.0, 1e-12)
        xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
        y = conv2d_int8(xq.permute(0, 2, 3, 1).contiguous(), q["kernel_q"],
                        stride, padding)
        out = y.float() * (s_x * q["scale"]) + q["bias"]
        return out.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()

    def __call__(self, variables: Dict[str, Any], x: torch.Tensor,
                 observed: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        observed = {} if observed is None else observed
        q = variables["qparams"]
        site = self._site
        h = site(reflect_pad(x.to(torch.bfloat16), 3), q["conv_in"],
                 "site_conv_in", observed)
        h = torch.relu(instance_norm(h))
        for i in range(2):
            h = site(h, q[f"down{i}_conv"], f"site_down{i}", observed, 2, 1)
            h = torch.relu(instance_norm(h))
        for i in range(self.n_blocks):
            b = q[f"block{i}"]
            r = site(reflect_pad(h, 1), b["conv1"], f"site_block{i}_conv1",
                     observed)
            r = torch.relu(instance_norm(r))
            r = site(reflect_pad(r, 1), b["conv2"], f"site_block{i}_conv2",
                     observed)
            h = h + instance_norm(r)
        for i in range(2):
            # the fused serving path quantizes here too (up-site scales)
            observed[f"up{i}_amax"] = h.float().abs().max()
            p = variables["params"][f"up{i}_conv"]
            h = (_up_bf16(h, p, self.up_mode).float()
                 + p["bias"][:, None, None]).to(torch.bfloat16)
            h = torch.relu(instance_norm(h))
        h = site(reflect_pad(h, 3), q["conv_out"], "site_conv_out", observed)
        return torch.tanh(h)


def calibrate(model: Int8ResnetGenerator, variables: Dict[str, Any],
              calib_x: torch.Tensor, margin: float = 1.0,
              device=None) -> Dict[str, Any]:
    """Bake static activation scales from a calibration batch (NCHW).

    Runs the dynamic-scale model once, reads each site's abs-max and writes
    ``act_scale = margin·amax/127`` into the qparams.
    """
    dev = resolve_device(device)
    variables = _tree_to(variables, dev)
    observed: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        model(variables, torch.as_tensor(calib_x).to(dev), observed)
    if "site_conv_in" not in observed:
        raise ValueError(
            "variables appear to be already calibrated (static act scales); "
            "re-calibrate from int8_generator_variables(generator) output")

    def scale(name):
        amax = float(observed[name])
        return float(np.float32(max(amax * margin / 127.0, 1e-12)))

    q = {k: (dict(v) if isinstance(v, dict) else v)
         for k, v in variables["qparams"].items()}
    q["conv_in"]["act_scale"] = scale("site_conv_in")
    q["conv_out"]["act_scale"] = scale("site_conv_out")
    for i in range(2):
        q[f"down{i}_conv"]["act_scale"] = scale(f"site_down{i}")
        q[f"up{i}_conv"] = {"act_scale": scale(f"up{i}_amax")}
    for i in range(model.n_blocks):
        b = {k: dict(v) for k, v in q[f"block{i}"].items()}
        b["conv1"]["act_scale"] = scale(f"site_block{i}_conv1")
        b["conv2"]["act_scale"] = scale(f"site_block{i}_conv2")
        q[f"block{i}"] = b
    return {"params": variables["params"], "qparams": q}


def fused_int8_variables(static_vars: Dict[str, Any]) -> Dict[str, Any]:
    """Calibrated variables → fused-path variables (every site int8).

    Every site needs a static ``act_scale``: the fused path quantizes at the
    producer, so consumer-side dynamic scales are impossible by
    construction. The up kernels are quantized per output channel of their
    equivalent regular conv's HWIO kernel, the JAX param, so the int8 values
    and scales are the JAX package's; the fp up params stay for the bf16 up
    mode.
    """
    q = dict(static_vars["qparams"])
    sites = [q.get(k, {}) for k in ("conv_in", "conv_out", "down0_conv",
                                     "down1_conv", "up0_conv", "up1_conv")]
    sites += [s for k, b in q.items() if k.startswith("block") for s in b.values()]
    if any("act_scale" not in s for s in sites):
        raise ValueError("fused_int8_variables needs calibrated variables "
                         "(run calibrate first)")
    for i in range(2):
        p = static_vars["params"][f"up{i}_conv"]
        upq = quantize_conv_params(
            {"kernel": torch.as_tensor(p["kernel"]).cpu()})
        q[f"up{i}_conv"] = {**_tree_to(upq, p["weight"].device),
                            "act_scale": q[f"up{i}_conv"]["act_scale"]}
    return {"qparams": q, "params": static_vars["params"]}


def _inv(site: Dict[str, Any]) -> float:
    """fp32 ``1 / act_scale``, as the JAX path computes it."""
    return float(np.float32(1.0) / np.float32(site["act_scale"]))


UP_MODES = ("bf16", "int8_dilated", "int8_phases", "resize_conv_int8")


def _up_int8(a: torch.Tensor, kernel_q: torch.Tensor,
             up_mode: str) -> torch.Tensor:
    """One int8 up stage on NHWC int8 → int32 ('int8_dilated' and
    'int8_phases' alike: the phase split)."""
    if up_mode == "resize_conv_int8":
        n, h, w, c = a.shape
        up = a[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
        return conv2d_int8(up.reshape(n, 2 * h, 2 * w, c), kernel_q, 1, 1)
    return conv_transpose_s2_phases(a, kernel_q)


def fused_int8_apply(variables: Dict[str, Any], x: torch.Tensor, *,
                     n_blocks: int = 9, up_mode: str = "bf16",
                     device=None) -> torch.Tensor:
    """Int8 ResnetGenerator forward with fused epilogues; NCHW in, NCHW bf16
    out. Every IN site (23 for 9 blocks) is one epilogue kernel launch.
    ``up_mode`` ∈ ``UP_MODES`` (module docstring); 'resize_conv_int8' needs
    the variables of a ``resize_conv`` generator."""
    if up_mode not in UP_MODES:
        raise ValueError(f"unknown up_mode [{up_mode}]; expected 'bf16' | "
                         "'int8_dilated' | 'int8_phases' | 'resize_conv_int8'")
    dev = resolve_device(device)
    variables = _tree_to(variables, dev)
    q = variables["qparams"]

    def ep(y, s_next, **kw):
        return fused_in_epilogue(y, _inv(s_next), **kw)

    with torch.no_grad():
        xf = x.to(dev).permute(0, 2, 3, 1).float() * _inv(q["conv_in"])
        xq = torch.clamp(torch.round(xf), -127, 127).to(torch.int8)
        y = conv2d_int8(pad_nhwc(xq.contiguous(), 3), q["conv_in"]["kernel_q"])
        a, _ = ep(y, q["down0_conv"], relu=True)
        y = conv2d_int8(a, q["down0_conv"]["kernel_q"], 2, 1)
        a, _ = ep(y, q["down1_conv"], relu=True)
        y = conv2d_int8(a, q["down1_conv"]["kernel_q"], 2, 1)
        a, h = ep(y, q["block0"]["conv1"], relu=True, keep_float=True, pad=1)
        for i in range(n_blocks):
            b = q[f"block{i}"]
            r = conv2d_int8(a, b["conv1"]["kernel_q"])
            a2, _ = ep(r, b["conv2"], relu=True, pad=1)
            r = conv2d_int8(a2, b["conv2"]["kernel_q"])
            if i < n_blocks - 1:
                a, h = ep(r, q[f"block{i + 1}"]["conv1"], residual=h, pad=1)
            elif up_mode == "bf16":
                _, h = fused_in_epilogue(r, None, residual=h)
            else:  # up0 is int8: requantize to its scale
                a, h = ep(r, q["up0_conv"], residual=h)

        for i in range(2):
            if up_mode == "bf16":
                p = variables["params"][f"up{i}_conv"]
                y = _up_bf16(h.permute(0, 3, 1, 2), p)
                y = (y + p["bias"].to(torch.bfloat16)[:, None, None])
                y = y.permute(0, 2, 3, 1).contiguous()
            else:  # IN follows: the bias drops out, as the dequantize does
                y = _up_int8(a, q[f"up{i}_conv"]["kernel_q"], up_mode)
            if i == 0 and up_mode == "bf16":  # up1 is bf16 too
                _, h = fused_in_epilogue(y, None, relu=True)
            elif i == 0:
                a, _ = ep(y, q["up1_conv"], relu=True)
            else:  # conv_out is int8: quantize and bake its reflect-pad 3
                a, _ = ep(y, q["conv_out"], relu=True, pad=3)
        y = conv2d_int8(a, q["conv_out"]["kernel_q"])
        co = q["conv_out"]
        out = y.float() * (co["act_scale"] * co["scale"]) + co["bias"]
        out = torch.tanh(out).to(torch.bfloat16)
        return out.permute(0, 3, 1, 2).contiguous()
