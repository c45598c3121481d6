"""The port's KITTI depth path against the JAX package, on the CPU: every
function of ``utils/metrics.py`` (to 1e-12, or exactly), the ``kitti``
loader on a small folder of PNGs (arrays identical), the label and depth
device transforms (against JAX's and the port's own ``data/preprocess.py``),
``depth2im`` and ``scale_pyramid``; the ``save_kitti`` tool against the JAX
repository's ``tools/save_kitti.save_depth_maps`` for a tiny S2D and a tiny
rf_lw with the same weights (the same file names, pixels within 1 LSB);
``eval_kitti``'s printed lines and records line against the JAX tool's;
and the train CLI's in-loop validation, which appends a records line a
validation.

The JAX metrics use cv2 where it is installed and a cv2-free fallback
otherwise; the port has the fallback's arithmetic. The tests compare with
the fallback (cv2 hidden from the JAX module) everywhere, and with cv2 where
the two agree exactly: gray maps read and resized to their own size.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.data import create_dataset as jax_create_dataset
from cycle_depth_estimation_tpu.data import device_transforms as jdt
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models.base_model import (
    ModelState as JaxModelState,
)
from cycle_depth_estimation_tpu.utils import images as jimages
from cycle_depth_estimation_tpu.utils import metrics as jm
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.data import create_dataset
from cycle_depth_estimation_tpu_torch.data import device_transforms as pdt
from cycle_depth_estimation_tpu_torch.data import preprocess as ppre
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.tools import eval_kitti, save_kitti
from cycle_depth_estimation_tpu_torch.train import kitti_validate
from cycle_depth_estimation_tpu_torch.utils import images as pimages
from cycle_depth_estimation_tpu_torch.utils import metrics as pm
from tests.test_torch_port_rf_lw_step import jax_variables
from tests.test_torch_port_s2d_step import SMALL as S2D_SMALL
from tests.test_torch_port_s2d_step import _jax_variables as s2d_jax_variables
from tests.test_torch_port_try_data import write_try_files

RNG = np.random.RandomState(41)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_cv2(monkeypatch):
    """The JAX metrics without cv2: their fallback, the port's arithmetic."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _save16(path, arr):
    im = Image.new("I;16", (arr.shape[1], arr.shape[0]))
    im.putdata([int(v) for v in arr.ravel()])
    im.save(path)


def write_gt(root, names, size=(150, 50), seed=3):
    """KITTI-like ground truth: uint16 meters×256 PNGs, 70 % unmeasured."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    w, h = size
    for name in names:
        d = (rng.rand(h, w) * 60 * 256).astype(np.uint16)
        d[rng.rand(h, w) < 0.7] = 0
        _save16(os.path.join(root, name), d)
    return root


# ---------------------------------------------------------------------------
# utils/metrics.py
# ---------------------------------------------------------------------------


def test_compute_errors_and_eval_depth_pair_match_jax():
    gt = RNG.uniform(1.5, 49, 500)
    pred = RNG.uniform(0, 80, 500)
    np.testing.assert_allclose(pm.compute_errors(gt, pred),
                               jm.compute_errors(gt, pred), rtol=1e-12)
    # a constant prediction: the span counts as 1e-6
    np.testing.assert_allclose(pm.compute_errors(gt, np.full(500, 3.0)),
                               jm.compute_errors(gt, np.full(500, 3.0)),
                               rtol=1e-12)
    g8 = RNG.randint(0, 70, (20, 30)).astype(np.uint8)
    p8 = RNG.randint(0, 256, (20, 30)).astype(np.uint8)
    got, want = pm.eval_depth_pair(g8, p8), jm.eval_depth_pair(g8, p8)
    assert list(got) == list(want) == list(pm.DEPTH_METRIC_NAMES)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-12)
    assert pm.eval_depth_pair(np.zeros_like(g8), p8) is None
    assert pm.DEPTH_METRIC_NAMES == jm.DEPTH_METRIC_NAMES


def test_imread_gray8_matches_jax(tmp_path, monkeypatch):
    d16 = (RNG.rand(12, 16) * 50 * 256).astype(np.uint16)
    g8 = RNG.randint(0, 256, (12, 16)).astype(np.uint8)
    rgb = RNG.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    paths = {k: str(tmp_path / f"{k}.png") for k in ("d16", "g8", "rgb")}
    _save16(paths["d16"], d16)
    Image.fromarray(g8).save(paths["g8"])
    Image.fromarray(rgb).save(paths["rgb"])
    got = {k: pm.imread_gray8(p) for k, p in paths.items()}
    np.testing.assert_array_equal(got["d16"], (d16 >> 8).astype(np.uint8))
    for k in ("d16", "g8"):  # with cv2 where this JAX has it: the same
        np.testing.assert_array_equal(got[k], jm.imread_gray8(paths[k]))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for k, p in paths.items():
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], jm.imread_gray8(p), err_msg=k)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [(40, 13), (7, 5), (23, 11)])
def test_resize_linear_matches_jax(no_cv2, dtype, size):
    img = (RNG.rand(11, 23) * 255).astype(dtype)
    got = pm._resize_linear(img, size)
    want = jm._resize_linear(img, size)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_resize_linear_within_one_of_cv2():
    """cv2's fixed-point 8-bit INTER_LINEAR (the JAX function's where cv2
    is installed) rounds some pixels 1 the other way; never further."""
    img = RNG.randint(0, 256, (37, 53)).astype(np.uint8)
    for size in ((80, 60), (20, 15), (53, 37)):
        got = pm._resize_linear(img, size).astype(int)
        want = jm._resize_linear(img, size).astype(int)
        assert np.abs(got - want).max() <= 1, size


def _depth_dirs(tmp_path, pred_size):
    names = [f"{i:010d}.png" for i in range(3)]
    gt = write_gt(str(tmp_path / "gt"), names)
    pred = tmp_path / "pred"
    pred.mkdir()
    for name in names[:2] + ["extra.png"]:  # one gt file lacks a prediction
        w, h = pred_size
        Image.fromarray(RNG.randint(0, 256, (h, w)).astype(np.uint8)).save(
            pred / name)
    return gt, str(pred)


@pytest.mark.parametrize("pred_size", [(150, 50), (96, 32)])
def test_eval_depth_dirs_matches_jax(tmp_path, monkeypatch, pred_size):
    gt, pred = _depth_dirs(tmp_path, pred_size)
    got = pm.eval_depth_dirs(gt, pred)
    if pred_size == (150, 50):  # no resize: cv2 and the fallback agree
        want = jm.eval_depth_dirs(gt, pred)
        np.testing.assert_allclose([got[k] for k in want],
                                   list(want.values()), rtol=1e-12)
    monkeypatch.setitem(sys.modules, "cv2", None)
    want = jm.eval_depth_dirs(gt, pred)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="no overlapping"):
        pm.eval_depth_dirs(gt, str(tmp_path))


def test_segmentation_metrics_match_jax():
    label = RNG.randint(0, 12, (2, 30, 40))
    label[0, :5] = 255
    label[1, :3] = 14  # outside the classes: masked
    pred = RNG.randint(-1, 12, (2, 30, 40))
    assert pm.pixel_accuracy(pred, label) == jm.pixel_accuracy(pred, label)
    assert pm.pixel_accuracy(pred, np.full_like(label, 255)) == 0.0
    cm = pm.confusion_matrix(pred, label, 12)
    np.testing.assert_array_equal(cm, jm.confusion_matrix(pred, label, 12))
    assert cm.sum() == np.sum((label < 12) & (pred >= 0))
    np.testing.assert_allclose(pm.miou_from_confusion(cm),
                               jm.miou_from_confusion(cm), rtol=1e-12)
    np.testing.assert_allclose(pm.miou(pred, label, 12),
                               jm.miou(pred, label, 12), rtol=1e-12)
    assert pm.miou_from_confusion(np.zeros((3, 3), np.int64)) == 0.0


# ---------------------------------------------------------------------------
# the kitti loader, the device transforms, images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fine_size", [256, 64])
@pytest.mark.parametrize("phase,is_train", [("train", True), ("test", True),
                                            ("train", False)])
def test_kitti_loader_matches_jax(tmp_path, fine_size, phase, is_train):
    lists = write_try_files(str(tmp_path), n=3, size=(90, 40))
    paths = {f"{k}_file_{p}": v for k, v in lists.items()
             for p in ("train", "test")}
    kw = dict(dataset_mode="kitti", fine_size=fine_size, is_train=is_train,
              seed=3, **paths)
    port = create_dataset(Config(**kw), phase)
    jax_ds = jax_create_dataset(JaxConfig(**kw), phase)
    assert len(port) == len(jax_ds) == 3
    w = int(round(fine_size if fine_size != 256 else 192) * 640 / 192)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(3):
            got, want = port[i], jax_ds[i]
            assert set(got) == set(want), (set(got), set(want))
            for k, v in want.items():
                if isinstance(v, str):
                    assert got[k] == v, k
                    continue
                g = got[k].numpy()
                assert g.dtype == v.dtype == np.float32, k
                np.testing.assert_array_equal(g, v.transpose(2, 0, 1),
                                              err_msg=k)
            assert got["img_source"].shape[1:] == (
                fine_size if fine_size != 256 else 192, w)
    assert ("lab_source" in port[0]) == (phase == "train" and is_train)


def test_label_and_depth_device_transforms_match_jax_and_host():
    lab = np.kron(RNG.randint(0, 34, (2, 5, 7)), np.ones((1, 4, 4)))
    lab = lab.astype(np.int64)
    lab[0, :6] = 21  # sky: no edges inside it
    lut = ppre.compose_lut(ppre.REAL_ID_TO_TRAINID_0)
    remapped = pdt.remap_labels(torch.from_numpy(lab), lut)
    np.testing.assert_array_equal(
        remapped.numpy(), np.asarray(jdt.remap_labels(jnp.asarray(lab), lut)))
    edges = pdt.label_edges(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(
        edges, np.asarray(jdt.label_edges(jnp.asarray(lab))))
    depth = RNG.randint(0, 12000, (2, 9, 13))
    for i in range(2):
        np.testing.assert_array_equal(
            remapped[i].numpy(), ppre.remap_sequential(lab[i], ppre.REAL_ID_TO_TRAINID_0))
        np.testing.assert_array_equal(edges[i], ppre.label_edges(lab[i]))
    for train in (True, False):
        full, bands = pdt.depth_bands(torch.from_numpy(depth), train)
        jfull, jbands = jdt.depth_bands(jnp.asarray(depth), train)
        assert full.shape == (2, 1, 9, 13) and bands.shape == (2, 4, 9, 13)
        np.testing.assert_allclose(full.numpy(),
                                   np.asarray(jfull).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bands.numpy(),
                                   np.asarray(jbands).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6)
        for i in range(2):
            hf, hb = ppre.depth_bands(depth[i].astype(np.uint16), train)
            np.testing.assert_allclose(full[i].numpy(), hf.transpose(2, 0, 1),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(bands[i].numpy(),
                                       hb.transpose(2, 0, 1), rtol=1e-6,
                                       atol=1e-6)


def test_depth2im_and_scale_pyramid_match_jax():
    d = np.tanh(RNG.randn(2, 1, 9, 12)).astype(np.float32)
    np.testing.assert_array_equal(pimages.depth2im(torch.from_numpy(d)),
                                  jimages.depth2im(d.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(pimages.depth2im(np.zeros((5, 6))),
                                  jimages.depth2im(np.zeros((5, 6))))
    x = RNG.randn(2, 3, 16, 24).astype(np.float32)
    got = pimages.scale_pyramid(torch.from_numpy(x), 3)
    want = jimages.scale_pyramid(jnp.asarray(x.transpose(0, 2, 3, 1)), 3)
    assert [tuple(g.shape) for g in got] == [(2, 3, 16, 24), (2, 3, 8, 12),
                                            (2, 3, 4, 6)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# save_kitti, eval_kitti, the in-loop validation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two try samples with KITTI names and their ground truth."""
    root = tmp_path_factory.mktemp("kitti")
    lists = write_try_files(str(root / "data"), n=2, size=(120, 50))
    test = {f"{k}_file_test": v for k, v in lists.items()}
    train = {f"{k}_file_train": v for k, v in lists.items()}
    names = [f"2011_09_26_drive_{i:04d}_sync_.png" for i in range(2)]
    return dict(root=root, test=test, train=train, names=names,
                gt=write_gt(str(root / "gt"), names, size=(120, 40)))


def _jax_state(params_and_stats):
    return JaxModelState(
        params={k: jax.tree.map(jnp.asarray, v["params"])
                for k, v in params_and_stats.items()},
        batch_stats={k: jax.tree.map(jnp.asarray, v.get("batch_stats") or {})
                     for k, v in params_and_stats.items()},
        opt_states={}, pools={}, step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("model", ["S2D", "rf_lw"])
def test_save_kitti_matches_jax(tree, tmp_path, model):
    from tools.save_kitti import save_depth_maps as jax_save_depth_maps

    kw = (dict(S2D_SMALL, adam_eps=1e-8) if model == "S2D" else
          dict(model="rf_lw", batch_size=1, resnet_layers=[1, 1, 1, 1],
               fine_size=64))
    cfg = apply_model_defaults(Config(device="cpu", **kw, **tree["test"]))
    pmodel = create_model(cfg)
    state = pmodel.init_state()
    if model == "S2D":
        sds = {k: {n: v.detach().numpy().copy()
                   for n, v in net.state_dict().items()}
               for k, net in state.nets.items()}
        variables = s2d_jax_variables(sds)
    else:
        variables = jax_variables(state.nets)
    n = save_kitti.save_depth_maps(cfg, str(tmp_path / "port"), model=pmodel,
                                   state=state)
    jcfg = jax_apply_model_defaults(JaxConfig(**kw, **tree["test"]))
    jn = jax_save_depth_maps(jcfg, str(tmp_path / "jax"),
                             model=jax_create_model(jcfg),
                             state=_jax_state(variables))
    assert n == jn == 2
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == tree["names"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int64)
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int64)
        assert got.shape == want.shape == (cfg.fine_size, 3 * cfg.fine_size)
        assert np.abs(got - want).max() <= 1, name


def test_save_kitti_cli_reads_the_checkpoint(tree, tmp_path, capsys):
    """``main`` loads the ``--epoch`` checkpoint, and warns without one."""
    args = ["--model", "rf_lw", "--device", "cpu", "--resnet_layers", "1", "1",
            "1", "1", "--fine_size", "64", "--checkpoints_dir",
            str(tmp_path), "--name", "rf", "--num_test", "1",
            *(a for kv in tree["test"].items() for a in ("--" + kv[0], kv[1]))]
    assert save_kitti.main(args + ["--out_dir", str(tmp_path / "a")]) == 1
    assert "no checkpoint found" in capsys.readouterr().out
    cfg = apply_model_defaults(Config(
        device="cpu", model="rf_lw", resnet_layers=[1, 1, 1, 1],
        checkpoints_dir=str(tmp_path), name="rf", seed=9))
    model = create_model(cfg)
    model.save_networks(model.init_state(), "latest")
    assert save_kitti.main(args + ["--out_dir", str(tmp_path / "b")]) == 1
    assert "no checkpoint found" not in capsys.readouterr().out
    (name,) = os.listdir(tmp_path / "a")
    assert os.listdir(tmp_path / "b") == [name]
    a, b = (np.asarray(Image.open(tmp_path / d / name)) for d in ("a", "b"))
    assert a.shape == b.shape and not np.array_equal(a, b)  # other weights


def test_eval_kitti_matches_jax(tree, tmp_path, monkeypatch, capsys):
    from tools.eval_kitti import main as jax_eval_main

    pred = tmp_path / "pred"
    pred.mkdir()
    for name in tree["names"]:
        Image.fromarray(RNG.randint(0, 256, (40, 120)).astype(np.uint8)).save(
            pred / name)
    rec_port, rec_jax = tmp_path / "port.txt", tmp_path / "jax.txt"
    eval_kitti.main(["--gt_dir", tree["gt"], "--pred_dir", str(pred),
                     "--records", str(rec_port)])
    out_port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["eval_kitti.py", "--gt_dir", tree["gt"],
                                      "--pred_dir", str(pred), "--records",
                                      str(rec_jax)])
    jax_eval_main()
    out_jax = capsys.readouterr().out
    assert out_port == out_jax
    assert out_port.splitlines()[0].split(",")[0].strip() == "abs_rel"
    got, want = (json.loads(p.read_text()) for p in (rec_port, rec_jax))
    assert set(got) == set(want) == {"t", *pm.DEPTH_METRIC_NAMES}
    for k in pm.DEPTH_METRIC_NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_train_cli_kitti_validation_writes_records(tree, tmp_path, capsys):
    """The train CLI with ``--kitti_gt_dir --eval_freq 1``: a records line
    after each step, with every metric, from the maps in ``<run>/pred/``;
    a broken ground-truth directory is reported and training goes on."""
    from cycle_depth_estimation_tpu_torch.train import main

    args = ["--model", "rf_lw", "--device", "cpu", "--resnet_layers", "1", "1",
            "1", "1", "--fine_size", "64", "--checkpoints_dir",
            str(tmp_path / "ck"), "--name", "rf", "--niter", "1",
            "--niter_decay", "0", "--num_threads", "0", "--kitti_gt_dir",
            tree["gt"], "--eval_freq", "1",
            *(a for kv in {**tree["train"], **tree["test"]}.items()
              for a in ("--" + kv[0], kv[1]))]
    state = main(args)
    assert state.step == 2
    expr = tmp_path / "ck" / "rf"
    records = [json.loads(line) for line in
               (expr / "records.txt").read_text().splitlines()]
    assert [(r["epoch"], r["iters"]) for r in records] == [(1, 1), (1, 2)]
    assert all(set(pm.DEPTH_METRIC_NAMES) <= set(r) for r in records)
    assert sorted(os.listdir(expr / "pred")) == tree["names"]
    last = pm.eval_depth_dirs(tree["gt"], str(expr / "pred"))
    assert all(records[-1][k] == v for k, v in last.items())
    capsys.readouterr()
    cfg = apply_model_defaults(Config(
        device="cpu", model="rf_lw", resnet_layers=[1, 1, 1, 1], fine_size=64,
        checkpoints_dir=str(tmp_path / "ck"), name="rf",
        kitti_gt_dir=str(tmp_path / "absent"), **tree["test"]))
    assert kitti_validate(cfg, create_model(cfg), state, 1, 3) is None
    assert "[kitti eval] skipped" in capsys.readouterr().out
    assert len((expr / "records.txt").read_text().splitlines()) == 2
