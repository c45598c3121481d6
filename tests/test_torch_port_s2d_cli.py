"""The port's S2D train CLI on the CPU (``python -m
cycle_depth_estimation_tpu_torch.train --model S2D``, through ``main``) on a
small ``try`` folder at 192×576, the smallest widths: two steps and a save,
then a resume with ``--continue_train`` for one more step; the six nets'
``.pth`` files and the train state load back into the model, and the
visuals are written (label maps colourised)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from cycle_depth_estimation_tpu_torch.config import parse_args
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.train import main
from cycle_depth_estimation_tpu_torch.utils.weights import load_pth
from tests.test_torch_port_try_data import write_try_files

NETS = ("G_1", "G_2", "R_D", "FD1", "FD2", "FD3")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_s2d_train_cli_trains_saves_and_resumes(tmp_path):
    lists = write_try_files(str(tmp_path / "data"), n=2)
    args = ["--model", "S2D", "--device", "cpu",
            "--dense_block_config", "2", "2", "2", "2", "--g1_blocks", "1",
            "--s2d_mid_nc", "64", "--dense_growth_rate", "8",
            "--checkpoints_dir", str(tmp_path / "ck"), "--name", "s2d",
            "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "1",
            "--print_freq", "1", "--display_freq", "2", "--num_threads", "0"]
    for kind, path in lists.items():
        args += [f"--{kind}_file_train", path]
    for kind in ("img_source", "img_target", "lab_source", "depth_source"):
        args += [f"--{kind}_file_test", lists[kind]]
    state = main(args)
    assert state.step == 2
    expr = tmp_path / "ck" / "s2d"
    for name in NETS:
        assert (expr / f"1_net_{name}.pth").is_file(), name
    cfg = parse_args(args)
    assert (cfg.dataset_mode, cfg.batch_size, cfg.fine_size) == ("try", 1, 192)

    seg = np.asarray(Image.open(expr / "web" / "images"
                                / "epoch001_syn_seg_l.png"))
    dep = np.asarray(Image.open(expr / "web" / "images"
                                / "epoch001_syn_dep_l.png"))
    assert seg.shape == dep.shape == (192, 576, 3)
    assert len(np.unique(seg.reshape(-1, 3), axis=0)) > 3
    log = (expr / "loss_log.txt").read_text()
    assert "dep_band" in log and "FD" in log
    # the eval over the test branch (no real labels there)
    scalars = (expr / "scalars.jsonl").read_text()
    assert "eval_dep_ref" in scalars and "eval_seg_real" not in scalars

    state = main(args + ["--continue_train", "--epoch_count", "2",
                         "--niter", "2", "--max_dataset_size", "1"])
    assert state.step == 3
    model = create_model(cfg)
    loaded = model.load_networks(model.init_state(), 2)
    assert loaded.step == 3
    for name in NETS:
        sd = load_pth(os.path.join(expr, f"2_net_{name}.pth"))
        for key, t in loaded.nets[name].state_dict().items():
            torch.testing.assert_close(t, sd[key], rtol=0, atol=0)
        for key, t in state.nets[name].state_dict().items():
            torch.testing.assert_close(t, sd[key], rtol=0, atol=0)
    for name, opt in loaded.optimizers.items():
        assert all(int(s["step"]) == (2 if name == "R_D" else 1) * 3
                   for s in opt.state.values()), name
