"""The port's SYNTHIA↔Cityscapes data path against the JAX package, on the
CPU: the label remap tables, ``SynthiaDataset`` on synthesized files (train
and test phase, folders and ``.txt`` lists), ``label2im`` and the
visualizer's label branch; then the train CLI with ``--model seg_cycle``
and ``--model seg`` on those files: checkpoints, a resume, label visuals.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.data import preprocess as jpre
from cycle_depth_estimation_tpu.data.domain_datasets import (
    SynthiaDataset as JaxSynthiaDataset,
)
from cycle_depth_estimation_tpu.utils.images import label2im as jax_label2im
from cycle_depth_estimation_tpu_torch.config import Config
from cycle_depth_estimation_tpu_torch.data import create_dataloader
from cycle_depth_estimation_tpu_torch.data import preprocess as ppre
from cycle_depth_estimation_tpu_torch.data.domain_datasets import SynthiaDataset
from cycle_depth_estimation_tpu_torch.data.image_folder import make_dataset_txt
from cycle_depth_estimation_tpu_torch.train import main as train_main
from cycle_depth_estimation_tpu_torch.utils.images import label2im
from cycle_depth_estimation_tpu_torch.utils.visualizer import Visualizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs: the Tier-1 run
    puts six test processes on the machine's cores, and torch's threads
    spinning against each other there cost more than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("table", ["SYN_ID_TO_TRAINID",
                                   "REAL_ID_TO_TRAINID_255"])
def test_remap_tables_match_jax(table):
    ours, theirs = getattr(ppre, table), getattr(jpre, table)
    assert ours == theirs
    np.testing.assert_array_equal(ppre.compose_lut(ours),
                                  jpre.compose_lut(theirs))
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 40, (7, 9)).astype(np.uint8)
    np.testing.assert_array_equal(ppre.remap_sequential(labels, ours),
                                  jpre.remap_sequential(labels, theirs))
    # outside [0, 256): the rules one by one
    wide = rng.randint(-2, 300, (7, 9)).astype(np.int32)
    got = ppre.remap_sequential(wide, ours)
    np.testing.assert_array_equal(got, jpre.remap_sequential(wide, theirs))
    assert got.dtype == np.int32


def test_clip_depth_matches_jax():
    d = np.random.RandomState(1).randint(0, 20000, (5, 6)).astype(np.uint16)
    np.testing.assert_array_equal(ppre.clip_depth_8000(d),
                                  jpre.clip_depth_8000(d))


# ---------------------------------------------------------------------------
# synthesized SYNTHIA-like files
# ---------------------------------------------------------------------------


def write_domain_files(root, n_src=3, n_tgt=2, size=(150, 48), seed=3):
    """RGB PNGs, 8-bit label PNGs (SYNTHIA ids 0–22, Cityscapes ids 0–33)
    and 16-bit depth PNGs at ``size`` (w, h); the source images and the
    target labels listed in ``.txt`` files, the rest as folders. Returns
    the ``*_file_train`` options."""
    rng = np.random.RandomState(seed)
    w, h = size
    opts = {}
    for name, n, kind in (("img_source", n_src, "rgb"),
                          ("lab_source", n_src, "syn"),
                          ("depth_source", n_src, "depth"),
                          ("img_target", n_tgt, "rgb"),
                          ("lab_target", n_tgt, "real")):
        folder = os.path.join(root, name)
        os.makedirs(folder)
        paths = []
        for i in range(n):
            if kind == "rgb":
                arr = rng.randint(0, 256, (h, w, 3), np.uint8)
            elif kind == "depth":
                arr = rng.randint(0, 12000, (h, w)).astype(np.uint16)
            else:
                arr = rng.randint(0, 23 if kind == "syn" else 34, (h, w)
                                  ).astype(np.uint8)
            path = os.path.join(folder, f"{i:03d}.png")
            Image.fromarray(arr).save(path)
            paths.append(path)
        if name in ("img_source", "lab_target"):
            listing = os.path.join(root, f"{name}.txt")
            with open(listing, "w") as fh:
                fh.write("\n".join(paths + [os.path.join(root, "gone.png")])
                         + "\n\n")
            opts[f"{name}_file_train"] = listing
        else:
            opts[f"{name}_file_train"] = folder
    return opts


@pytest.fixture(scope="module")
def domain_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthia"))
    return root, write_domain_files(root)


def test_make_dataset_txt_keeps_existing_paths(domain_files):
    root, opts = domain_files
    paths = make_dataset_txt(opts["img_source_file_train"])
    assert len(paths) == 3 and all(os.path.isfile(p) for p in paths)
    assert len(make_dataset_txt(opts["img_source_file_train"],
                                check_exists=False)) == 4


@pytest.mark.parametrize("phase,fine_size,epoch", [("train", 96, 0),
                                                   ("train", 256, 3),
                                                   ("test", 96, 1)])
def test_synthia_dataset_matches_jax(domain_files, phase, fine_size, epoch):
    _, opts = domain_files
    if phase == "test":
        opts = {k.replace("_train", "_test"): v for k, v in opts.items()}
    kw = dict(dataset_mode="synthia", fine_size=fine_size, seed=5, **opts)
    ours = SynthiaDataset(Config(**kw), phase)
    theirs = JaxSynthiaDataset(JaxConfig(**kw), phase)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert len(ours) == len(theirs) == 3
    hw = (192, 640) if fine_size == 256 else (96, 320)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        for k in ("img_source", "img_target"):
            assert a[k].shape == (3, *hw) and a[k].dtype == torch.float32
            np.testing.assert_array_equal(a[k].numpy().transpose(1, 2, 0), b[k])
        for k in ("lab_source", "lab_target"):
            assert a[k].shape == hw and a[k].dtype == torch.int64
            np.testing.assert_array_equal(a[k].numpy(), b[k])
        np.testing.assert_array_equal(a["depth_source"].numpy()[0],
                                      b["depth_source"][..., 0])
        assert a["img_source_paths"] == b["img_source_paths"]
        assert a["img_target_paths"] == b["img_target_paths"]
    labels = np.concatenate([ours[i]["lab_source"].numpy().ravel()
                             for i in range(3)])
    assert labels.max() == 255 and labels[labels != 255].max() <= 21


def test_synthia_loader_batches(domain_files):
    _, opts = domain_files
    cfg = Config(dataset_mode="synthia", fine_size=96, batch_size=2,
                 num_threads=0, **opts)
    loader = create_dataloader(cfg, phase="train")
    batches = list(loader)
    loader.close()
    assert len(batches) == 1  # 3 samples, batch 2, the last dropped
    b = batches[0]
    assert b["img_source"].shape == (2, 3, 96, 320)
    assert b["lab_target"].shape == (2, 96, 320)
    assert b["depth_source"].shape == (2, 1, 96, 320)
    assert len(b["img_source_paths"]) == 2


# ---------------------------------------------------------------------------
# label visuals
# ---------------------------------------------------------------------------


def test_label2im_matches_jax():
    rng = np.random.RandomState(6)
    labels = rng.randint(0, 30, (2, 5, 7))
    labels[0, 0, :3] = 255
    labels[0, 1, 0] = 300
    want = jax_label2im(labels)
    for got in (label2im(torch.from_numpy(labels)),
                label2im(torch.from_numpy(labels[:, None])),
                label2im(labels[0])):
        np.testing.assert_array_equal(got, want)
    assert (want[0, 0] == 0).all() and want.dtype == np.uint8


def test_visualizer_colorizes_label_visuals(tmp_path):
    cfg = Config(checkpoints_dir=str(tmp_path), name="vis")
    vis = Visualizer(cfg)
    labels = torch.randint(0, 22, (1, 6, 8))
    vis.display_current_results({"lab_A": labels, "segAreal": labels,
                                 "real_A": torch.zeros(1, 3, 6, 8)}, 1)
    img = tmp_path / "vis" / "web" / "images"
    for name in ("lab_A", "segAreal"):
        got = np.asarray(Image.open(img / f"epoch001_{name}.png"))
        np.testing.assert_array_equal(got, label2im(labels))
    assert (np.asarray(Image.open(img / "epoch001_real_A.png")) == 127).all()


# ---------------------------------------------------------------------------
# the train CLI on the synthesized files
# ---------------------------------------------------------------------------

_SMALL = ["--device", "cpu", "--ngf", "8", "--ndf", "8", "--netG",
          "resnet_3blocks", "--fine_size", "96", "--batch_size", "2",
          "--num_threads", "0", "--niter", "1", "--niter_decay", "0",
          "--save_epoch_freq", "1", "--print_freq", "2", "--display_freq",
          "2"]


def _options(opts):
    return [a for k, v in opts.items() for a in (f"--{k}", v)]


def test_seg_cycle_train_cli_saves_resumes_and_writes_label_visuals(
        domain_files, tmp_path):
    _, opts = domain_files
    common = ["--model", "seg_cycle", "--pool_size", "2", "--checkpoints_dir",
              str(tmp_path), "--name", "sc", *_options(opts), *_SMALL]
    state = train_main(common)
    assert state.step == 1
    expr = tmp_path / "sc"
    nets = ("G_A", "G_B", "D_A", "D_B", "encoderA", "encoderB", "decoderA",
            "decoderB")
    for n in nets:
        assert (expr / f"1_net_{n}.pth").is_file(), n
    assert (expr / "1_train_state.pth").is_file()
    images = expr / "web" / "images"
    for name in ("lab_A", "segAreal", "segBfake", "real_A"):
        im = np.asarray(Image.open(images / f"epoch001_{name}.png"))
        assert im.shape == (96, 320, 3), name
    lab = np.asarray(Image.open(images / "epoch001_lab_B.png"))
    assert len(np.unique(lab.reshape(-1, 3), axis=0)) > 3  # colorized
    assert "segAreal" in (expr / "loss_log.txt").read_text()

    saved = torch.load(expr / "1_net_encoderA.pth")
    resumed = train_main(common + ["--continue_train", "--epoch", "1",
                                   "--epoch_count", "2", "--niter", "2"])
    assert resumed.step == 2
    assert (expr / "2_net_decoderB.pth").is_file()
    assert resumed.pools["fake_A"].count == 2
    after = resumed.nets["encoderA"].state_dict()
    assert all(not torch.equal(after[k], v) for k, v in saved.items()
               if k.endswith("conv1.1.weight"))


def test_seg_train_cli_trains_the_task_net_only(domain_files, tmp_path):
    _, opts = domain_files
    common = ["--model", "seg", "--checkpoints_dir", str(tmp_path), "--name",
              "t2", *_options(opts), *_SMALL]
    state = train_main(common)
    expr = tmp_path / "t2"
    assert sorted(p.name for p in expr.glob("1_*")) == [
        "1_net_img2task.pth", "1_train_state.pth"]
    assert (expr / "web" / "images" / "epoch001_lab_s_pre.png").is_file()
    resumed = train_main(common + ["--continue_train", "--epoch", "1",
                                   "--epoch_count", "2", "--niter", "2"])
    assert resumed.step == 2 and state.step == 1
    for k, v in resumed.nets["s2t"].state_dict().items():
        assert torch.equal(v, state.nets["s2t"].state_dict()[k]), k
