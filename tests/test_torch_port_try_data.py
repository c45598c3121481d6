"""The port's ``try`` dataset (vKITTI→KITTI, S2D's loader) and its
preprocessing against the JAX package, on the CPU: ``TryDataset`` in the
train and test branches on a small folder written here (RGB PNGs, 8-bit
label PNGs, 16-bit depth PNGs), key by key at the same index and epoch;
``label_edges``, ``depth_bands`` in both modes, the ``try`` label table and
``_resize_linear``; and the ``--device_aug`` guard of ``create_dataset``.
Floats within 1e-6; everything else equal.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.data import create_dataset as jax_create_dataset
from cycle_depth_estimation_tpu.data import preprocess as jpre
from cycle_depth_estimation_tpu.data.domain_datasets import (
    TryDataset as JaxTryDataset,
)
from cycle_depth_estimation_tpu.utils.metrics import (
    _resize_linear as jax_resize_linear,
)
from cycle_depth_estimation_tpu_torch.config import Config, parse_args
from cycle_depth_estimation_tpu_torch.data import create_dataset
from cycle_depth_estimation_tpu_torch.data import preprocess as ppre
from cycle_depth_estimation_tpu_torch.data.domain_datasets import TryDataset
from cycle_depth_estimation_tpu_torch.utils.metrics import _resize_linear

KINDS = {"img_source": "rgb", "img_target": "rgb", "lab_source": 23,
         "lab_target": 34, "depth_source": "depth"}


def write_try_files(root, n=3, size=(101, 37), seed=4):
    """vKITTI/KITTI-like files, ``n`` of each kind (labels: vKITTI ids
    0–22, Cityscapes ids 0–33; depth 0–12000), listed in .txt files under
    ``root``; returns {kind: list path}. KITTI file names are long enough
    for the test branch's ``f_name``/``l_name`` slices."""
    rng = np.random.RandomState(seed)
    w, h = size
    lists = {}
    for kind, what in KINDS.items():
        os.makedirs(os.path.join(root, kind))
        paths = []
        for i in range(n):
            if what == "rgb":
                arr = rng.randint(0, 256, (h, w, 3), np.uint8)
            elif what == "depth":
                arr = rng.randint(0, 12000, (h, w)).astype(np.uint16)
            else:  # blocky labels, so that edges and interiors both occur
                arr = np.kron(rng.randint(0, what, (h // 4 + 1, w // 4 + 1)),
                              np.ones((4, 4)))[:h, :w].astype(np.uint8)
            name = f"2011_09_26_drive_{i:04d}_sync_image_{i:010d}_image_02.png"
            paths.append(os.path.join(root, kind, name))
            Image.fromarray(arr).save(paths[-1])
        lists[kind] = os.path.join(root, f"{kind}.txt")
        with open(lists[kind], "w") as f:
            f.write("\n".join(paths) + "\n")
    return lists


@pytest.fixture(scope="module")
def try_files(tmp_path_factory):
    return write_try_files(str(tmp_path_factory.mktemp("try")))


def _paths(lists):
    return {f"{k}_file_{p}": v for k, v in lists.items()
            for p in ("train", "test")}


def _assert_sample_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
            continue
        w = np.asarray(w)
        g = g.numpy()
        if w.ndim == 3:  # HWC → CHW
            w = w.transpose(2, 0, 1)
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == np.int64, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == np.float32, k
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_try_dataset_matches_jax(try_files, phase):
    paths = _paths(try_files)
    kw = dict(model="S2D", dataset_mode="try", fine_size=24, seed=3)
    ours = TryDataset(Config(**kw, **paths), phase)
    theirs = JaxTryDataset(JaxConfig(**kw, **paths), phase)
    assert ours.size == theirs.size == (72, 24)
    assert len(ours) == len(theirs) == 3
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            _assert_sample_equal(got, want)
    assert got["img_syn"].shape == (3, 24, 72)
    assert got["depth_l_s"].shape == (4, 24, 72)


@pytest.mark.parametrize("fine_size,size", [(192, (576, 192)),
                                            (256, (576, 192)),
                                            (96, (288, 96))])
def test_try_size_keeps_three_to_one(fine_size, size):
    """(w, h) = (3·fine_size, fine_size); 256, the generic default, reads
    as 192, as in the JAX package."""
    ds = TryDataset.__new__(TryDataset)
    ds.cfg = Config(fine_size=fine_size)
    theirs = JaxTryDataset.__new__(JaxTryDataset)
    theirs.cfg = JaxConfig(fine_size=fine_size)
    assert ds.size == theirs.size == size


def test_label_tables_and_edges_match_jax():
    assert ppre.REAL_ID_TO_TRAINID_0 == jpre.REAL_ID_TO_TRAINID_0
    rng = np.random.RandomState(0)
    for labels in (np.kron(rng.randint(0, 28, (6, 9)), np.ones((5, 5))),
                   rng.randint(18, 24, (17, 23)).astype(np.float32)):
        got = ppre.label_edges(labels)
        want = jpre.label_edges(labels)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ppre.label_edges(np.full((4, 5), 21)).sum() == 0  # sky: no edge


@pytest.mark.parametrize("train", [True, False])
def test_depth_bands_match_jax(train):
    rng = np.random.RandomState(1)
    for depth in (rng.randint(0, 12000, (23, 31)).astype(np.uint16),
                  np.full((5, 6), 4200, np.uint16)):  # constant: span clamped
        got, want = (ppre.depth_bands(depth, train=train),
                     jpre.depth_bands(depth, train=train))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert ppre._safe_span(3.0, 3.0) == jpre._safe_span(3.0, 3.0) == 1e-6


@pytest.mark.parametrize("size", [(72, 24), (9, 5), (130, 41)])
def test_resize_linear_matches_jax(size):
    """The cv2 INTER_LINEAR resize of the edge maps (the JAX function uses
    cv2 where it is installed, else the same 2×2 gather as the port)."""
    m = (np.random.RandomState(2).rand(37, 101) > 0.7).astype(np.float32)
    got = _resize_linear(m, size)
    want = jax_resize_linear(m, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("model,mode", [("seg_cycle", "synthia"),
                                        ("S2D", "try")])
def test_device_aug_is_refused_for_domain_loaders(model, mode):
    """``--device_aug`` finishes uint8 batches on the device; the domain
    loaders ship preprocessed float batches, so ``create_dataset`` refuses
    the flag with them, with the JAX package's error."""
    with pytest.raises(ValueError) as theirs:
        jax_create_dataset(JaxConfig(model=model, dataset_mode=mode,
                                     device_aug=True))
    cfg = parse_args(["--model", model, "--device_aug"])
    assert cfg.dataset_mode == mode
    with pytest.raises(ValueError) as ours:
        create_dataset(cfg)
    assert str(ours.value) == str(theirs.value)
    assert "device_aug" in str(ours.value)

