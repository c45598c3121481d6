"""The port's pix2pix data path against the JAX package, on the CPU: the
aligned dataset (bit-identical items on the same PNGs, seed and epoch), the
threaded and process loaders against the serial one, ``prefetch_to_device``,
and the device transforms against the host pipeline with forced crops and
flips (as ``tests/test_device_transforms.py`` holds the JAX ones)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.data import device_transforms as jdt
from cycle_depth_estimation_tpu.data.datasets import (
    AlignedDataset as JaxAlignedDataset,
)
from cycle_depth_estimation_tpu_torch.config import Config
from cycle_depth_estimation_tpu_torch.data import create_dataloader
from cycle_depth_estimation_tpu_torch.data import device_transforms as dt
from cycle_depth_estimation_tpu_torch.data import transforms as ht
from cycle_depth_estimation_tpu_torch.data.datasets import AlignedDataset
from cycle_depth_estimation_tpu_torch.data.loader import (
    DataLoader,
    ProcessDataLoader,
    prefetch_to_device,
)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aligned")
    rng = np.random.RandomState(0)
    for phase, n in (("train", 5), ("test", 2)):
        os.makedirs(root / phase)
        for i in range(n):
            Image.fromarray(rng.randint(0, 256, (40, 88, 3), np.uint8)).save(
                root / phase / f"ab_{i:02d}.png")
    return root


_CASES = {
    "train": dict(),
    "no_flip": dict(no_flip=True),
    "eval": dict(is_train=False),
    "BtoA_gray_A": dict(direction="BtoA", output_nc=1),
    "AtoB_gray_B": dict(output_nc=1),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_aligned_dataset_is_bit_identical_to_jax(root, case):
    kw = dict(dataroot=str(root), seed=3, load_size=36, fine_size=32,
              dataset_mode="aligned", **_CASES[case])
    jds = JaxAlignedDataset(JaxConfig(**kw), phase="train")
    pds = AlignedDataset(Config(**kw), phase="train")
    assert len(pds) == len(jds) == 5
    for epoch in (1, 2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            want, got = jds[i], pds[i]
            assert got["A_paths"] == got["B_paths"] == want["A_paths"]
            for k in ("A", "B", "img_source", "img_target"):
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy().transpose(1, 2, 0),
                                              want[k], err_msg=f"{k} {i}")


def test_aligned_dataset_device_aug_ships_uint8_halves(root):
    kw = dict(dataroot=str(root), load_size=36, fine_size=32,
              dataset_mode="aligned", device_aug=True)
    want = JaxAlignedDataset(JaxConfig(**kw), phase="train")[1]
    got = AlignedDataset(Config(**kw), phase="train")[1]
    assert set(got) == {"A", "B", "A_paths", "B_paths"}
    for k in ("A", "B"):
        assert got[k].dtype == torch.uint8 and got[k].shape == (3, 36, 36)
        np.testing.assert_array_equal(got[k].numpy().transpose(1, 2, 0),
                                      want[k])
    with pytest.raises(ValueError):
        AlignedDataset(Config(**{**kw, "resize_or_crop": "crop"}), "train")


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _batches(loader, epochs=(1, 2)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], torch.Tensor):
                assert torch.equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_threaded_and_process_loaders_give_the_serial_batches(root):
    cfg = Config(dataroot=str(root), seed=5, load_size=36, fine_size=32,
                 dataset_mode="aligned", batch_size=2)
    ds = AlignedDataset(cfg, "train")
    kw = dict(batch_size=2, shuffle=True, seed=5, drop_last=True)
    serial = _batches(DataLoader(ds, num_workers=0, **kw))
    assert len(serial) == 4
    _assert_same(_batches(DataLoader(ds, num_workers=2, **kw)), serial)
    procs = ProcessDataLoader(ds, num_workers=2, **kw)
    try:
        _assert_same(_batches(procs), serial)
    finally:
        procs.close()
    # the factory's choice
    assert type(create_dataloader(cfg)) is DataLoader
    assert create_dataloader(cfg).num_workers == cfg.num_threads == 4
    loader = create_dataloader(cfg.replace(worker_procs=2))
    assert type(loader) is ProcessDataLoader and loader.num_workers == 2
    loader.close()


def test_prefetch_to_device_keeps_order_and_leaves():
    batches = [{"A": torch.full((1, 2), float(i)), "A_paths": [f"p{i}"]}
               for i in range(5)]
    seen = []

    def source():
        for b in batches:
            seen.append(b["A_paths"][0])
            yield b

    it = prefetch_to_device(source(), "cpu", depth=2)
    first = next(it)
    assert seen == ["p0", "p1", "p2"]  # two batches ahead of the consumer
    got = [first] + list(it)
    _assert_same(got, batches)


# ---------------------------------------------------------------------------
# device transforms (here on CPU tensors) against the host pipeline
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(11)


def test_crop_flip_normalize_matches_host():
    x = RNG.randint(0, 256, (4, 20, 24, 3)).astype(np.uint8)
    tops, lefts = np.array([0, 3, 5, 2]), np.array([1, 0, 7, 4])
    flips = np.array([False, True, True, False])
    y = dt.crop_flip_normalize(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(tops), torch.from_numpy(lefts),
                               torch.from_numpy(flips), 13)
    want = jdt.crop_flip_normalize(jnp.asarray(x), jnp.asarray(tops),
                                   jnp.asarray(lefts), jnp.asarray(flips), 13)
    for i in range(4):
        ref = ht.to_array(Image.fromarray(x[i]))
        ref = ref[tops[i]:tops[i] + 13, lefts[i]:lefts[i] + 13]
        if flips[i]:
            ref = ref[:, ::-1]
        ref = ht.normalize(ref)
        np.testing.assert_array_equal(y[i].numpy().transpose(1, 2, 0), ref)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-5)


def test_crop_flip_normalize_grayscale_matches_host():
    x = RNG.randint(0, 256, (2, 10, 10, 3)).astype(np.uint8)
    z = torch.zeros(2, dtype=torch.long)
    y = dt.crop_flip_normalize(torch.from_numpy(x).permute(0, 3, 1, 2), z, z,
                               torch.zeros(2, dtype=torch.bool), 10,
                               grayscale=True)
    assert y.shape == (2, 1, 10, 10)
    for i in range(2):
        ref = ht.rgb_to_gray(ht.normalize(x[i].astype(np.float32) / 255.0))
        np.testing.assert_array_equal(y[i].numpy().transpose(1, 2, 0), ref)


@pytest.mark.parametrize("mode", ["aligned", "train", "eval"])
def test_draw_augment_params_ranges(mode):
    gen = torch.Generator().manual_seed(0)
    tops, lefts, flips = dt.draw_augment_params(
        gen, 4000, (36, 40), 32, train=mode != "eval",
        aligned=mode == "aligned")
    if mode == "eval":  # the center crop, no flip
        assert set(tops.tolist()) == {2} and set(lefts.tolist()) == {4}
        assert not flips.any()
        return
    hi = (3, 7) if mode == "aligned" else (4, 8)  # inclusive highs
    assert set(tops.tolist()) == set(range(hi[0] + 1))
    assert set(lefts.tolist()) == set(range(hi[1] + 1))
    assert 0.45 < flips.float().mean() < 0.55
    _, _, none = dt.draw_augment_params(gen, 64, (36, 40), 32, no_flip=True,
                                        aligned=mode == "aligned")
    assert not none.any()
    # aligned pairs crop at random at eval too, and never flip there
    t, _, f = dt.draw_augment_params(gen, 500, (36, 40), 32, train=False,
                                     aligned=True)
    assert len(set(t.tolist())) > 1 and not f.any()


def test_device_aug_aligned_batches_match_the_host_path(root):
    """The uint8 halves, cropped and flipped on the device with the offsets
    and flips the host path draws, are the host path's samples exactly;
    ``wrap_for_config`` gives A and B one crop and flip, and the aliases."""
    kw = dict(dataroot=str(root), seed=2, load_size=36, fine_size=32,
              dataset_mode="aligned", batch_size=5)
    host = AlignedDataset(Config(**kw), "train")
    dev = AlignedDataset(Config(**kw, device_aug=True), "train")
    for ds in (host, dev):
        ds.set_epoch(1)
    batch = next(iter(DataLoader(dev, batch_size=5, shuffle=False)))
    tops, lefts, flips = [], [], []
    for i in range(5):
        rng = host._rng(i)
        tops.append(int(rng.integers(0, 4)))
        lefts.append(int(rng.integers(0, 4)))
        flips.append(bool(rng.random() < 0.5))
    args = (torch.tensor(tops), torch.tensor(lefts), torch.tensor(flips), 32)
    for k in ("A", "B"):
        got = dt.crop_flip_normalize(batch[k], *args)
        want = torch.stack([host[i][k] for i in range(5)])
        assert torch.equal(got, want), k

    out = next(dt.wrap_for_config(iter([batch]), Config(**kw),
                                  torch.Generator().manual_seed(0)))
    assert out["A"].shape == (5, 3, 32, 32) and out["A"].dtype == torch.float32
    assert out["img_source"] is out["A"] and out["img_target"] is out["B"]
    assert out["A_paths"] == batch["A_paths"]
    # one draw for the pair: B's crop and flip are A's
    a = (batch["A"].float() / 255.0 - 0.5) / 0.5
    b = (batch["B"].float() / 255.0 - 0.5) / 0.5
    for i in range(5):
        pos = [(t, l, f) for t in range(4) for l in range(4) for f in (0, 1)
               if torch.equal(out["A"][i], (a[i, :, t:t + 32, l:l + 32].flip(2)
                                            if f else a[i, :, t:t + 32, l:l + 32]))]
        assert pos, i
        t, l, f = pos[0]
        crop = b[i, :, t:t + 32, l:l + 32]
        assert torch.equal(out["B"][i], crop.flip(2) if f else crop)
