"""Image augmentation on the device (the image part of the JAX package's
``data/device_transforms.py``).

With ``device_aug`` the host decodes and resizes only and ships uint8 at
``load_size`` (a quarter of the float32 bytes); the crop, flip,
ToTensor/Normalize(0.5) and grayscale run here, batched, on the batch's
device. The arithmetic is the host pipeline's (``transforms.py``), in the
same order, so forced crops and flips give the host's numbers exactly. Crop
offsets and flips are drawn from an explicit ``torch.Generator`` on the
batch's device: one seed gives one sequence, though not the JAX package's
(``jax.random``) draws. Under data parallelism a rank draws for the global
batch and keeps its rows, so every row gets the draw it gets in one
process.

The label and depth part — ``remap_labels``, ``label_edges`` and
``depth_bands`` — is ``data/preprocess.py``'s arithmetic on (N)HW tensors of
the batch's device, batched, with the channel first where the host
functions put it last.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..parallel.collectives import global_rows, local_rows

_LUMA = (0.299, 0.587, 0.114)
UNALIGNED_GROUPS = (("A",), ("B",))
ALIGNED_GROUPS = (("A", "B"),)   # one draw for the AB pair
_ALIASES = {"img_source": "A", "img_target": "B"}


def crop_flip_normalize(x: torch.Tensor, tops: torch.Tensor,
                        lefts: torch.Tensor, flips: torch.Tensor,
                        fine_size: int, *, grayscale: bool = False,
                        dtype=torch.float32) -> torch.Tensor:
    """NCHW uint8 ``x`` (or float in [0, 255]) → the ``fine_size`` crop at
    (``tops``, ``lefts``), flipped along W where ``flips``, scaled to
    [-1, 1]; ITU-R 601 luma to one channel with ``grayscale``."""
    n, c = x.shape[:2]
    span = torch.arange(fine_size, device=x.device)
    rows = tops.long()[:, None] + span
    cols = lefts.long()[:, None] + span
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    y = x[torch.arange(n, device=x.device)[:, None, None, None],
          torch.arange(c, device=x.device)[None, :, None, None],
          rows[:, None, :, None], cols[:, None, None, :]]
    y = (y.to(dtype) / 255.0 - 0.5) / 0.5
    if grayscale:
        y = (y[:, 0:1] * _LUMA[0] + y[:, 1:2] * _LUMA[1]
             + y[:, 2:3] * _LUMA[2])
    return y


def draw_augment_params(generator: torch.Generator, n: int,
                        in_hw: Tuple[int, int], fine_size: int, *,
                        train: bool = True, no_flip: bool = False,
                        aligned: bool = False):
    """Per-sample crop offsets and flips on the generator's device.

    Unaligned and single — train: offsets uniform over [0, size − fine] and
    Bernoulli(0.5) flips; eval: the center crop, no flip. Aligned: offsets
    over [0, size − fine − 1] (the reference's inclusive ``randint`` high),
    at eval too; flips in train only.
    """
    h, w = in_hw
    dev = generator.device
    if aligned or train:
        extra = 0 if aligned else 1
        tops = torch.randint(0, max(1, h - fine_size + extra), (n,),
                             generator=generator, device=dev)
        lefts = torch.randint(0, max(1, w - fine_size + extra), (n,),
                              generator=generator, device=dev)
    else:
        tops = torch.full((n,), max(0, (h - fine_size) // 2), device=dev)
        lefts = torch.full((n,), max(0, (w - fine_size) // 2), device=dev)
        return tops, lefts, torch.zeros((n,), dtype=torch.bool, device=dev)
    flips = torch.rand((n,), generator=generator, device=dev) < 0.5
    return tops, lefts, flips & (train and not no_flip)


def _augment_batch(batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   fine_size: int, train: bool, no_flip: bool,
                   groups: Sequence[Tuple[str, ...]],
                   aligned_flags: Sequence[bool],
                   grayscale_keys: Sequence[str], dtype
                   ) -> Dict[str, torch.Tensor]:
    out = dict(batch)
    for group, aligned in zip(groups, aligned_flags):
        keys = [k for k in group if k in batch]
        if not keys:
            continue
        n, _, h, w = batch[keys[0]].shape
        tops, lefts, flips = (local_rows(t) for t in draw_augment_params(
            generator, global_rows(n), (h, w), fine_size, train=train,
            no_flip=no_flip, aligned=aligned))
        for k in keys:
            out[k] = crop_flip_normalize(batch[k], tops, lefts, flips,
                                         fine_size,
                                         grayscale=k in grayscale_keys,
                                         dtype=dtype)
    return out


def device_augment_batches(iterator, cfg, generator: torch.Generator, *,
                           groups: Sequence[Tuple[str, ...]] = UNALIGNED_GROUPS,
                           aligned_flags: Sequence[bool] = None,
                           grayscale_keys: Sequence[str] = (),
                           dtype=torch.float32) -> Iterator[Dict[str, object]]:
    """Augment the uint8 batches of ``iterator`` (datasets built with
    ``device_aug``, tensors already on the generator's device). Tensors not
    named in ``groups`` and the paths pass through; the reference's alias
    keys (img_source = A, img_target = B) are put back."""
    if aligned_flags is None:
        aligned_flags = (False,) * len(groups)
    named = {k for g in groups for k in g}
    for batch in iterator:
        images = {k: v for k, v in batch.items()
                  if k in named and getattr(v, "ndim", 0) == 4}
        aug = _augment_batch(images, generator, cfg.fine_size,
                             bool(cfg.is_train), bool(cfg.no_flip), groups,
                             aligned_flags, grayscale_keys, dtype)
        out = {**batch, **aug}
        for alias, base in _ALIASES.items():
            if base in out and alias not in out:
                out[alias] = out[base]
        yield out


def wrap_for_config(iterator, cfg, generator: torch.Generator):
    """``device_augment_batches`` with the groups and grayscale sides of
    ``cfg`` (its ``dataset_mode``, ``direction``, ``input_nc`` and
    ``output_nc``, as the datasets pick them)."""
    aligned = cfg.dataset_mode == "aligned"
    if cfg.direction == "BtoA":
        gray_a, gray_b = cfg.output_nc == 1, cfg.input_nc == 1
    else:
        gray_a, gray_b = cfg.input_nc == 1, cfg.output_nc == 1
    gkeys = (("A",) if gray_a else ()) + (("B",) if gray_b else ())
    return device_augment_batches(
        iterator, cfg, generator,
        groups=ALIGNED_GROUPS if aligned else UNALIGNED_GROUPS,
        aligned_flags=(True,) if aligned else (False, False),
        grayscale_keys=gkeys)


def remap_labels(labels: torch.Tensor, lut) -> torch.Tensor:
    """The label remap as one gather through a composed LUT
    (``preprocess.compose_lut``; host: ``remap_sequential``), int64."""
    lut = torch.as_tensor(np.asarray(lut), dtype=torch.int64,
                          device=labels.device)
    return lut[labels.long()]


def label_edges(labels: torch.Tensor, suppress_class: int = 21
                ) -> torch.Tensor:
    """4-neighbour label-difference edges of an (N)HW integer label map,
    float32 {0, 1} (host: ``preprocess.label_edges``). A pixel of
    ``suppress_class`` draws no edge; the zero padding makes a nonzero
    border label an edge."""
    lab = labels.long()
    sky = lab == suppress_class
    h, w = lab.shape[-2:]
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1))
    edge = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        # s[y, x] = lab[y − dy, x − dx], 0 outside
        s = pad[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
        edge |= lab != torch.where(sky, torch.full_like(s, suppress_class), s)
    return edge.float()


def _renorm(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
            ) -> torch.Tensor:
    return 2.0 * (x - lo) / torch.clamp(hi - lo, min=1e-6) - 1.0


def depth_bands(depth: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(full, bands)`` of (N)HW 16-bit depth values, per image (host:
    ``preprocess.depth_bands``): ``full`` (N)1HW, ``bands`` (N)4HW, float32;
    train mode renormalizes each band by its own (min, max), band 5 offset
    by the normalized band 4's minimum; eval mode by the max alone."""
    d = depth.float()
    dims = (-2, -1)

    def lo(t):
        return t.amin(dim=dims, keepdim=True)

    def hi(t):
        return t.amax(dim=dims, keepdim=True)

    d0 = torch.clamp(d, max=8000.0)
    d2 = torch.where(d < 5000.0, torch.full_like(d, 5000.0), d0)
    d2 = _renorm(d2, lo(d2), hi(d2))
    d3 = torch.clamp(d, 3000.0, 6000.0)
    d3 = _renorm(d3, lo(d3), hi(d3))
    d4 = torch.clamp(d, 1000.0, 4000.0)
    d4n = _renorm(d4, lo(d4), hi(d4))
    d5 = torch.clamp(d, max=2000.0)
    if train:
        d5n = (2.0 * (d5 - lo(d4n)) / torch.clamp(hi(d5) - lo(d5), min=1e-6)
               - 1.0)
        full = _renorm(d0, lo(d0), hi(d0))
    else:
        d5n = 2.0 * d5 / torch.clamp(hi(d5), min=1e-6) - 1.0
        full = 2.0 * d0 / torch.clamp(hi(d0), min=1e-6) - 1.0
    return full.unsqueeze(-3), torch.stack([d2, d3, d4n, d5n], dim=-3)
