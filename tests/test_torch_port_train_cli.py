"""The port's training data path and train CLI against the JAX package, on
the CPU: the unaligned dataset's items and the loader's order (bit-identical
to the JAX ones on the same PNGs, seed and epoch), the train CLI's outputs
and resume, its default device, and the flags it leaves out."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.data.datasets import (
    UnalignedDataset as JaxUnalignedDataset,
)
from cycle_depth_estimation_tpu.data.loader import DataLoader as JaxDataLoader
from cycle_depth_estimation_tpu_torch.config import Config, parse_args
from cycle_depth_estimation_tpu_torch.data import DataLoader, create_dataloader
from cycle_depth_estimation_tpu_torch.data.datasets import UnalignedDataset
from cycle_depth_estimation_tpu_torch.train import main as train_main


def _write_pngs(folder, n, size, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3), np.uint8)
                        ).save(os.path.join(folder, f"img_{i:03d}.png"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("unaligned")
    for i, (phase, n) in enumerate((("trainA", 5), ("trainB", 3),
                                    ("testA", 2), ("testB", 2))):
        _write_pngs(root / phase, n, (44, 38), seed=i)
    return root


_CASES = {
    "resize_and_crop": dict(resize_or_crop="resize_and_crop", load_size=36,
                            fine_size=32),
    "crop_serial": dict(resize_or_crop="crop", fine_size=24,
                        serial_batches=True),
    "scale_width_and_crop_no_flip": dict(resize_or_crop="scale_width_and_crop",
                                         load_size=40, fine_size=28,
                                         no_flip=True),
    "eval": dict(resize_or_crop="resize_and_crop", load_size=36,
                 fine_size=32, is_train=False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_unaligned_dataset_is_bit_identical_to_jax(root, case):
    kw = dict(dataroot=str(root), seed=3, **_CASES[case])
    jds = JaxUnalignedDataset(JaxConfig(**kw), phase="train")
    pds = UnalignedDataset(Config(**kw), phase="train")
    assert len(pds) == len(jds) == 5
    for epoch in (1, 2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            want, got = jds[i], pds[i]
            assert got["A_paths"] == want["A_paths"]
            assert got["B_paths"] == want["B_paths"]
            for k in ("A", "B", "img_source", "img_target"):
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy().transpose(1, 2, 0),
                                              want[k], err_msg=f"{k} {i}")


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_is_bit_identical_to_jax(root, drop_last):
    kw = dict(dataroot=str(root), seed=5, load_size=36, fine_size=32)
    jl = JaxDataLoader(JaxUnalignedDataset(JaxConfig(**kw), "train"),
                       batch_size=2, shuffle=True, num_workers=1, seed=5,
                       drop_last=drop_last)
    pl = DataLoader(UnalignedDataset(Config(**kw), "train"), batch_size=2,
                    shuffle=True, seed=5, drop_last=drop_last)
    orders = set()
    for epoch in (1, 2, 3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pl) == len(jl) == len(pb) == len(jb) == (2 if drop_last
                                                           else 3)
        for want, got in zip(jb, pb):
            assert got["A_paths"] == want["A_paths"]
            assert got["B_paths"] == want["B_paths"]
            np.testing.assert_array_equal(got["A"].numpy().transpose(0, 2, 3, 1),
                                          want["A"])
            np.testing.assert_array_equal(got["B"].numpy().transpose(0, 2, 3, 1),
                                          want["B"])
        orders.add(tuple(p for b in pb for p in b["A_paths"]))
    assert len(orders) > 1  # shuffled anew each epoch


def test_create_dataloader_shuffles_unless_serial(root):
    cfg = Config(dataroot=str(root), load_size=36, fine_size=32, batch_size=2)
    assert create_dataloader(cfg).shuffle
    serial = create_dataloader(cfg.replace(serial_batches=True))
    assert not serial.shuffle and serial.drop_last
    assert list(serial.indices()) == list(range(5))


_TINY = ["--ngf", "4", "--ndf", "4", "--netG", "resnet_3blocks",
         "--load_size", "36", "--fine_size", "32", "--batch_size", "2",
         "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "1",
         "--print_freq", "2", "--display_freq", "4"]


def test_train_cli_writes_checkpoints_logs_page_and_resumes(root, tmp_path):
    common = ["--dataroot", str(root), "--checkpoints_dir", str(tmp_path),
              "--name", "tiny", "--device", "cpu", *_TINY]
    state = train_main(common)
    expr = tmp_path / "tiny"
    assert state.step == 2  # 5 A images, batch 2, last partial batch dropped
    for epoch in ("1", "latest"):
        for net in ("G_A", "G_B", "D_A", "D_B"):
            assert (expr / f"{epoch}_net_{net}.pth").is_file()
        assert (expr / f"{epoch}_train_state.pth").is_file()
    log = (expr / "loss_log.txt").read_text()
    assert "(epoch: 1, iters: 2," in log and "cycle_A:" in log
    scalars = [json.loads(line) for line in
               (expr / "scalars.jsonl").read_text().splitlines()]
    assert [r["iters"] for r in scalars if "D_A" in r] == [2, 4]
    assert any("eval_cycle_A" in r for r in scalars)  # testA/testB eval
    html = (expr / "web" / "index.html").read_text()
    assert "epoch001_fake_B.png" in html and "epoch [1]" in html
    assert (expr / "opt.txt").is_file()

    saved = torch.load(expr / "latest_net_G_A.pth")
    resumed = train_main(common + ["--niter", "2", "--epoch_count", "2",
                                   "--continue_train"])
    assert resumed.step == 4
    assert (expr / "2_net_D_B.pth").is_file()
    after = resumed.nets["G_A"].state_dict()
    assert all(not torch.equal(after[k], v) for k, v in saved.items()
               if k.endswith("weight"))


def test_train_cli_defaults_to_cuda_and_never_falls_back(root, tmp_path,
                                                         monkeypatch):
    assert Config().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--dataroot", str(root), "--checkpoints_dir",
                    str(tmp_path), *_TINY])
    assert not (tmp_path / "experiment_name").exists()


@pytest.mark.parametrize("flag", ["--remat", "--parallel", "--int8",
                                  "--prefetch_depth", "--mesh_shape", "--zero",
                                  "--kitti_gt_dir", "--adam_eps", "--eval_freq",
                                  "--records_file"])
def test_flags_of_later_slices_are_rejected(flag):
    if flag == "--remat":  # ported since: a flag of cycle_gan
        assert parse_args([flag]).remat and not parse_args([]).remat
        return
    if flag == "--adam_eps":  # ported since: a flag of S2D
        assert parse_args([flag, "1e-3"]).adam_eps == 1e-3
        assert parse_args([]).adam_eps == 1e-8
        return
    if flag == "--int8":  # ported since: the test CLI's generic PTQ
        assert parse_args([flag]).int8 and not parse_args([]).int8
        return
    if flag in ("--parallel", "--prefetch_depth", "--mesh_shape", "--zero"):
        # ported since: parallel/ and the train CLI's prefetch depth
        field = flag[2:]
        default = getattr(Config(), field)
        assert default == getattr(JaxConfig(), field)
        assert getattr(parse_args([]), field) == default
        want = [1] if flag == "--mesh_shape" else type(default)("1")
        assert getattr(parse_args([flag, "1"]), field) == want
        return
    if flag in ("--kitti_gt_dir", "--eval_freq", "--records_file"):
        # ported since: the in-loop KITTI validation
        field = flag[2:]
        default = getattr(Config(), field)
        assert getattr(parse_args([flag, "7"]), field) == type(default)("7")
        assert getattr(parse_args([]), field) == default
        return
    with pytest.raises(SystemExit):
        parse_args([flag, "1"])


def test_config_defaults_match_jax():
    """Every field both packages' ``Config`` have takes one default, and so
    does each model's default override of such a field."""
    import dataclasses

    from cycle_depth_estimation_tpu.config import MODEL_DEFAULTS as JAX_MD
    from cycle_depth_estimation_tpu_torch.config import MODEL_DEFAULTS

    port, jax_cfg = Config(), JaxConfig()
    shared = ({f.name for f in dataclasses.fields(Config)}
              & {f.name for f in dataclasses.fields(JaxConfig)})
    assert {"mesh_shape", "mesh_axes", "parallel", "zero", "prefetch_depth",
            "coordinator_address", "num_processes",
            "process_index"} <= shared
    for name in sorted(shared):
        assert getattr(port, name) == getattr(jax_cfg, name), name
    assert set(MODEL_DEFAULTS) == set(JAX_MD)
    for model, over in MODEL_DEFAULTS.items():
        for k in shared & (set(over) | set(JAX_MD[model])):
            assert over.get(k) == JAX_MD[model].get(k), (model, k)


def test_reference_flag_aliases():
    cfg = parse_args(["--lambda_A", "3", "--lambda_B", "4", "--netD", "pixel",
                      "--n_layers_D", "5", "--niter", "2"])
    assert (cfg.lambda_a, cfg.lambda_b, cfg.net_d, cfg.n_layers_d,
            cfg.niter) == (3.0, 4.0, "pixel", 5, 2)
    assert cfg.no_dropout  # cycle_gan's model default
    assert parse_args(["--model", "cycle_gan", "--no_dropout"]).no_dropout


@pytest.mark.parametrize("model,nets", [
    ("S2D_base", {"G_1": "G1", "G_2": "GeneralNet2",
                  "Dis_en": "DropDiscriminator", "Seg_de": "SEG2",
                  "Dep_de": "DEP2"}),
    ("S2D_alt", {"G_1": "GBase", "G_2": "GBase", "Dis_en": "DropDiscriminator",
                 "Feature": "FeatureNet", "Seg_de": "SEGAlt",
                 "Dep_de": "DEPAlt"})])
def test_s2d_base_generation_models_build_their_nets(model, nets):
    from cycle_depth_estimation_tpu_torch.models import create_model

    cfg = parse_args(["--model", model, "--device", "cpu",
                      "--dense_block_config", "1", "1", "1", "1",
                      "--g1_blocks", "1", "--ndf", "8"])
    assert (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) == ("try", 1, 192)
    m = create_model(cfg)
    state = m.init_state()
    assert tuple(state.nets) == m.model_names == tuple(nets)
    assert {k: type(v).__name__ for k, v in state.nets.items()} == nets
    lrs = {k: o.param_groups[0]["lr"] for k, o in state.optimizers.items()}
    assert lrs == {k: (8e-5 if (k, model) == ("Dis_en", "S2D_alt") else 2e-4)
                   for k in nets}
    assert all(o.param_groups[0]["eps"] == 1e-8
               for o in state.optimizers.values())
    if model == "S2D_base":
        assert state.nets["G_1"].block_type == "resnet"
        assert state.nets["Dis_en"].main[0].in_channels == 64


def test_s2d_base_generation_flags_parse():
    cfg = parse_args(["--model", "S2D_base", "--lr_D", "1e-4", "--dis_seg",
                      "--d_repeat_num", "3"])
    assert (cfg.lr_d, cfg.dis_seg, cfg.d_repeat_num) == (1e-4, True, 3)
    cfg = parse_args(["--model", "S2D_alt", "--lr_d", "3e-5"])
    assert (cfg.lr_d, cfg.dis_seg, cfg.d_repeat_num, cfg.net_g) == (
        3e-5, False, 4, "3blocks")
    assert parse_args(["--model", "S2D_alt", "--netG", "6blocks"]).net_g == \
        "6blocks"


def _train_and_resume(extra, tmp_path, logged=("acc_real", "dep_syn"),
                      visual="syn_dep_pre"):
    """Two steps on tiny ``try`` files at 64×192 (``extra`` goes last and
    may override the size and widths), a save, then a resume with
    ``--continue_train`` for one more step; the nets load back. The loss
    log holds ``logged``, and the page the image of ``visual``. Returns
    the model the checkpoints were read with and the names of the epoch-2
    net files; the checkpoints (about 1 GB with Adam's state, 2 GB with
    RDepST's) are deleted."""
    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.utils.weights import load_pth
    from tests.test_torch_port_try_data import write_try_files

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lists = write_try_files(str(tmp_path / "data"), n=2)
        args = ["--device", "cpu", "--fine_size", "64",
                "--dense_block_config", "1", "1", "1", "1",
                "--checkpoints_dir", str(tmp_path / "ck"),
                "--name", "run", "--niter", "1", "--niter_decay", "0",
                "--save_epoch_freq", "1", "--print_freq", "1",
                "--display_freq", "2", "--num_threads", "0", *extra]
        for kind, path in lists.items():
            args += [f"--{kind}_file_train", path]
        state = train_main(args)
        assert state.step == 2
        expr = tmp_path / "ck" / "run"
        log = (expr / "loss_log.txt").read_text()
        assert all(k in log for k in logged)
        assert (expr / "web" / "images" / f"epoch001_{visual}.png").is_file()
        state = train_main(args + ["--continue_train", "--epoch_count", "2",
                                   "--niter", "2", "--max_dataset_size", "1"])
        assert state.step == 3
        cfg = parse_args(args)
        m = create_model(cfg)
        loaded = m.load_networks(m.init_state(), 2)
        assert loaded.step == 3
        for name in m.model_names:
            sd = load_pth(os.path.join(expr, f"2_net_{name}.pth"))
            for key, t in state.nets[name].state_dict().items():
                torch.testing.assert_close(t, sd[key], rtol=0, atol=0)
                torch.testing.assert_close(
                    loaded.nets[name].state_dict()[key], t, rtol=0, atol=0)
        return m, {p.name for p in expr.glob("2_net_*.pth")}
    finally:
        torch.set_num_threads(n)
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)


@pytest.mark.parametrize("model", ["S2D_base", "S2D_alt"])
def test_s2d_base_generation_train_cli_trains_and_resumes(model, tmp_path):
    """Two steps on tiny ``try`` files at 64×192, a save, then a resume
    with ``--continue_train`` for one more step; the nets load back."""
    _train_and_resume(["--model", model, "--g1_blocks", "1", "--ndf", "8"],
                      tmp_path)


TWO_TRUNK = {
    "S2D_df": {"G_1": "GeneralNet2", "G_2": "GeneralNet2",
               "Dis0_en": "Dis2SegDF", "Seg_de": "SEGDF", "Dep_de": "DEPDF"},
    "S2D_nd": {"G_1": "GeneralNet2", "G_2": "GeneralNet2",
               "Dis_en": "DiscriminatorSeg", "Seg_de": "SEG", "Dep_de": "DEP"},
    "S2D_nd --nd_4dis": {"G_1": "GeneralNet2", "G_2": "GeneralNet2",
                         "Dis0_en": "Dis2SegDF", "Dis1_en": "Dis2SegDF",
                         "Seg_de": "SEG", "Dep_de": "DEP"}}


@pytest.mark.parametrize("case", list(TWO_TRUNK))
def test_two_trunk_models_build_their_nets(case):
    from cycle_depth_estimation_tpu_torch.models import create_model

    cfg = parse_args(["--model", *case.split(), "--device", "cpu",
                      "--dense_block_config", "1", "1", "1", "1"])
    assert (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) == ("try", 1, 192)
    m = create_model(cfg)
    state = m.init_state()
    assert tuple(state.nets) == m.model_names == tuple(TWO_TRUNK[case])
    assert {k: type(v).__name__ for k, v in state.nets.items()} == \
        TWO_TRUNK[case]
    lrs = {k: o.param_groups[0]["lr"] for k, o in state.optimizers.items()}
    sgd = {k for k, o in state.optimizers.items()
           if isinstance(o, torch.optim.SGD)}
    if case == "S2D_df":
        assert lrs == {"G_1": 2e-4 / 3, "G_2": 2e-4 / 3, "Dis0_en": 4e-5,
                       "Seg_de": 1e-4, "Dep_de": 1e-4}
    else:
        assert lrs == {k: (2e-4 if k in ("Dis0_en", "Dis1_en") else
                           2e-4 / 3 if k == "Dis_en" else 1e-4)
                       for k in TWO_TRUNK[case]}
    assert sgd == ({"Dis_en"} if case == "S2D_nd" else set())


def test_two_trunk_flags_parse():
    cfg = parse_args(["--model", "S2D_df", "--df_adv_w", "5", "--df_g1_adv",
                      "--df_d_real_w", "0.2"])
    assert (cfg.df_adv_w, cfg.df_g1_adv, cfg.df_d_real_w) == (5.0, True, 0.2)
    cfg = parse_args(["--model", "S2D_nd"])
    assert (cfg.df_adv_w, cfg.df_g1_adv, cfg.df_d_real_w, cfg.nd_4dis) == (
        2.0, False, 1.0, False)
    assert parse_args(["--model", "S2D_nd", "--nd_4dis"]).nd_4dis


@pytest.mark.parametrize("case", list(TWO_TRUNK))
def test_two_trunk_train_cli_trains_and_resumes(case, tmp_path):
    """As the base generation's: two steps, a resume for a third; the
    checkpoints are the model's ``model_names``."""
    m, files = _train_and_resume(["--model", *case.split()], tmp_path)
    assert m.model_names == tuple(TWO_TRUNK[case])
    assert files == {f"2_net_{k}.pth" for k in TWO_TRUNK[case]}


ST_NETS = {
    "semantic_trans": {"G_1": "G1", "G_2": "GeneralNet", "R_D": "RDep",
                       "FD1": "SDiscriminator", "FD2": "SDiscriminator",
                       "FD3": "SDiscriminator", "DIS": "StarDiscriminator",
                       "Dis_80": "StarDiscriminator",
                       "Dis_160": "StarDiscriminator",
                       "Dis_320": "StarDiscriminator"},
    "semantic_trans_full": {"G_1": "G1", "G_2": "GeneralNet", "Seg_de": "SEG",
                            "Dep_de": "DEP", "R_D": "RDepST",
                            "Dis0_en": "Discriminator2Seg",
                            "DIS": "StarDiscriminator",
                            "Dis_80": "StarDiscriminator",
                            "Dis_160": "StarDiscriminator",
                            "Dis_320": "StarDiscriminator"}}
# semantic_trans keeps S2D's FD nets, whose outputs are empty below 192
# pixels a side: its CLI runs at S2D's smallest widths at 192×576
ST_ARGS = {"semantic_trans": ["--fine_size", "192", "--dense_block_config",
                              "2", "2", "2", "2", "--g1_blocks", "1",
                              "--s2d_mid_nc", "64", "--dense_growth_rate",
                              "8"],
           "semantic_trans_full": ["--g1_blocks", "1"]}


@pytest.mark.parametrize("model", list(ST_NETS))
def test_semantic_trans_models_build_their_nets(model):
    from cycle_depth_estimation_tpu_torch.models import create_model

    cfg = parse_args(["--model", model, "--device", "cpu", "--adam_eps",
                      "1e-3", *ST_ARGS[model]])
    assert (cfg.dataset_mode, cfg.batch_size) == ("try", 1)
    assert parse_args(["--model", model]).fine_size == 192
    m = create_model(cfg)
    state = m.init_state()
    assert tuple(state.nets) == m.model_names == tuple(ST_NETS[model])
    assert {k: type(v).__name__ for k, v in state.nets.items()} == \
        ST_NETS[model]
    adam = {k: (o.param_groups[0]["lr"], o.param_groups[0]["eps"])
            for k, o in state.optimizers.items()}
    critics = ("DIS", "Dis_80", "Dis_160", "Dis_320")
    if model == "semantic_trans":  # S2D's nets at --adam_eps
        div = {"G_1": 5, "G_2": 3, "R_D": 2, "FD1": 4, "FD2": 4, "FD3": 4}
        assert adam == {k: (2e-4 / 4, 1e-8) if k in critics
                        else (2e-4 / div[k], 1e-3) for k in ST_NETS[model]}
    else:  # eps 1e-8 whatever --adam_eps says, as the JAX model
        assert adam == {k: (2e-4 / (4 if k in critics else 2), 1e-8)
                        for k in ST_NETS[model]}
    assert m.clip_norms == {"Dis_160": 1.0, "Dis_320": 1.0}


@pytest.mark.parametrize("model", list(ST_NETS))
def test_semantic_trans_train_cli_trains_and_resumes(model, tmp_path):
    """As the base generation's: two steps, a resume for a third; the
    checkpoints are the model's ``model_names``, the never-stepped Dis_80
    among them."""
    logged, visual = {"semantic_trans": (("gp", "d160", "dep_band"),
                                         "syn_dep_ref"),
                      "semantic_trans_full": (("d160_syn", "dep_syn"),
                                              "syn_dep_pre")}[model]
    m, files = _train_and_resume(["--model", model, *ST_ARGS[model]],
                                 tmp_path, logged, visual)
    assert m.model_names == tuple(ST_NETS[model])
    assert files == {f"2_net_{k}.pth" for k in ST_NETS[model]}


# ---------------------------------------------------------------------------
# the test CLI: --int8, --model_suffix, --tpu_precision
# ---------------------------------------------------------------------------


def test_test_cli_int8_calibrates_and_writes_the_gallery(root, tmp_path,
                                                         capsys):
    from cycle_depth_estimation_tpu_torch.test import main as test_main

    args = ["--dataroot", str(root / "testA"), "--netG", "resnet_3blocks",
            "--ngf", "4", "--fine_size", "32", "--device", "cpu",
            "--results_dir", str(tmp_path / "results")]
    web_dir = test_main(args + ["--int8", "--name", "int8"])
    out = capsys.readouterr().out
    # conv_in, 2 downs, 3 blocks × 2, conv_out; the ups stay float
    assert "int8 serving: 10 conv sites quantized" in out
    images = sorted(os.listdir(os.path.join(web_dir, "images")))
    assert images == ["img_000_fake_B.png", "img_000_real_A.png",
                      "img_001_fake_B.png", "img_001_real_A.png"]
    fp32_dir = test_main(args + ["--name", "fp32"])
    assert "conv sites quantized" not in capsys.readouterr().out
    int8_img = np.asarray(Image.open(os.path.join(
        web_dir, "images", "img_000_fake_B.png")), np.float64)
    fp32_img = np.asarray(Image.open(os.path.join(
        fp32_dir, "images", "img_000_fake_B.png")), np.float64)
    assert 0 < np.abs(int8_img - fp32_img).mean() < 8


def test_test_cli_int8_needs_a_generator():
    from cycle_depth_estimation_tpu_torch.test import _served_net

    class NoGenerator:
        cfg = Config(model="seg")

    with pytest.raises(SystemExit, match="no generator net_G"):
        _served_net(NoGenerator(), None)


def test_test_cli_serves_a_cycle_gan_run_by_model_suffix(root, tmp_path,
                                                         capsys):
    """``--model test --model_suffix _A`` loads a port cycle_gan run's
    ``latest_net_G_A.pth`` by name (JAX ``TestModel``: net ``"G" +
    model_suffix``), and serves it, int8 too."""
    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.test import main as test_main

    train_main(["--dataroot", str(root), "--checkpoints_dir", str(tmp_path),
                "--name", "tiny", "--device", "cpu", *_TINY])
    capsys.readouterr()
    serve = ["--dataroot", str(root / "testA"), "--checkpoints_dir",
             str(tmp_path), "--name", "tiny", "--netG", "resnet_3blocks",
             "--ngf", "4", "--fine_size", "32", "--device", "cpu",
             "--results_dir", str(tmp_path / "results")]
    for suffix in ("_A", "_B"):
        cfg = parse_args(serve + ["--model_suffix", suffix], is_train=False)
        model = create_model(cfg)
        assert model.model_names == ("G" + suffix,)
        assert model.has_checkpoint("latest")
        model.load_nets(None, "latest")
        saved = torch.load(tmp_path / "tiny" / f"latest_net_G{suffix}.pth")
        for k, v in model.net_G.state_dict().items():
            assert torch.equal(v, saved[k]), k
    web_dir = test_main(serve + ["--model", "test", "--model_suffix", "_A",
                                 "--int8"])
    out = capsys.readouterr().out
    assert "no checkpoint" not in out and "10 conv sites" in out
    assert len(os.listdir(os.path.join(web_dir, "images"))) == 4
    test_main(serve + ["--model_suffix", "_C"])
    assert "no checkpoint given" in capsys.readouterr().out


def test_tpu_precision_highest_turns_tf32_off(root, tmp_path, monkeypatch):
    from cycle_depth_estimation_tpu_torch.device import set_precision
    from cycle_depth_estimation_tpu_torch.test import main as test_main

    for field in ("int8", "model_suffix", "tpu_precision"):
        assert getattr(Config(), field) == getattr(JaxConfig(), field)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    set_precision("default")
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    test_main(["--dataroot", str(root / "testA"), "--netG", "resnet_3blocks",
               "--ngf", "4", "--fine_size", "32", "--device", "cpu",
               "--num_test", "1", "--tpu_precision", "highest",
               "--results_dir", str(tmp_path / "results")])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        set_precision("high")
    with pytest.raises(SystemExit):
        parse_args(["--tpu_precision", "high"])
