"""The port's multi-process training on the CPU (its counterpart of
``tests/test_multihost.py``): the train CLI in two local processes joined
by ``--coordinator_address/--num_processes/--process_index`` against the
same CLI in one process, and the pix2pix (BatchNorm) and S2D steps on two
spawned gloo ranks against one process, at the dryrun's reduced S2D
config. Every process has a timeout."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models.networks import biases_before_norm
from cycle_depth_estimation_tpu_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--device", "cpu", "--ngf", "8", "--ndf", "8", "--netG",
       "resnet_3blocks", "--fine_size", "32", "--load_size", "36",
       "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "1",
       "--batch_size", "4", "--pool_size", "8", "--d_steps_per_g", "2",
       "--num_threads", "0", "--display_freq", "4", "--print_freq", "4"]
# runs the CLI's main and prints a digest of the state every rank holds
DRIVER = ("import sys, torch; from cycle_depth_estimation_tpu_torch.train "
          "import main; s = main(sys.argv[1:]); print('DIGEST', repr(sum("
          "float(p.double().abs().sum()) for n in sorted(s.nets) "
          "for p in s.nets[n].parameters())))")


def _digest_runs(tmp_path, name, extra, n):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH",
                                                                "")])}
    port = dryrun.free_port()
    procs = []
    for i in range(n):
        world = ([] if n == 1 else
                 ["--coordinator_address", f"localhost:{port}",
                  "--num_processes", str(n), "--process_index", str(i)])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DRIVER, "--dataroot",
             str(tmp_path / "data"),
             "--checkpoints_dir", str(tmp_path / name), *CLI, *extra, *world],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [next(ln for ln in out.splitlines() if ln.startswith("DIGEST"))
            .split()[1] for out in outs], outs


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    for i, phase in enumerate(("trainA", "trainB")):
        os.makedirs(tmp / "data" / phase)
        rng = np.random.RandomState(i)
        for j in range(4):
            Image.fromarray(rng.randint(0, 256, (36, 36, 3), np.uint8)).save(
                tmp / "data" / phase / f"img_{j}.png")
    one, _ = _digest_runs(tmp, "one", [], 1)
    two, outs = _digest_runs(tmp, "two", [], 2)
    return tmp, one, two, outs


def _load(run):
    return {n: torch.load(run / "experiment_name" / f"latest_net_{n}.pth")
            for n in ("G_A", "G_B", "D_A", "D_B")}


def test_two_process_cli_ranks_hold_one_state(cli_runs):
    _, _, two, outs = cli_runs
    assert two[0] == two[1], two
    # the backend line comes first; rank 0 alone prints the losses
    assert "backend gloo (CPU ranks)" in outs[0]
    assert "D_A:" in outs[0] and "D_A:" not in outs[1]


def test_two_process_cli_equals_one_process(cli_runs):
    tmp, one, two, _ = cli_runs
    cfg = apply_model_defaults(Config(device="cpu", ngf=8, ndf=8,
                                      net_g="resnet_3blocks"))
    nets = create_model(cfg).init_state().nets
    a, b = _load(tmp / "one"), _load(tmp / "two")
    flipped = total = 0
    for name, sd in a.items():
        noise = biases_before_norm(nets[name])
        bound = 2 * cfg.lr * (1 if name.startswith("G") else 2) + 1e-5
        for k, v in sd.items():
            d = (b[name][k].double() - v.double()).abs()
            assert float(d.max()) <= bound, (name, k)
            if k not in noise:
                flipped += int((d > 1e-5).sum())
                total += d.numel()
    assert flipped <= 1e-3 * total, (flipped, total)
    assert float(two[0]) == pytest.approx(float(one[0]), rel=1e-5)


def test_zero_checkpoints_load_without_zero_and_the_reverse(cli_runs):
    tmp = cli_runs[0]
    _digest_runs(tmp, "zero", ["--zero", "fsdp"], 2)
    st = torch.load(tmp / "zero" / "experiment_name" / "1_train_state.pth")
    params = [p for n in ("G_A", "G_B") for p in
              torch.load(tmp / "zero" / "experiment_name"
                         / f"1_net_{n}.pth").values()]
    moments = st["optimizers"]["G"]["state"]
    assert [m["exp_avg"].shape for m in moments.values()] == \
        [p.shape for p in params]  # whole tensors, in the reference's order
    resume = ["--continue_train", "--epoch_count", "2", "--niter", "2"]
    _digest_runs(tmp, "zero", resume, 1)
    shutil.copytree(tmp / "one", tmp / "one_to_zero")
    _digest_runs(tmp, "one_to_zero", ["--zero", "opt", *resume], 2)
    for run in ("zero", "one_to_zero"):
        st = torch.load(tmp / run / "experiment_name" / "2_train_state.pth")
        assert st["step"] == 2, run


def test_dp_refuses_what_the_port_lacks(tmp_path):
    from cycle_depth_estimation_tpu_torch.train import main

    for extra, says in ((["--parallel", "sp"], "ROADMAP A1b"),
                        (["--parallel", "pp"], "not a train-CLI mode"),
                        (["--parallel", "tp"], "needs a 'model' mesh axis"),
                        (["--zero", "opt"], "needs a process group"),
                        (["--mesh_shape", "2"], "needs 2 devices, have 1")):
        with pytest.raises((SystemExit, ValueError), match=says):
            main(["--dataroot", str(tmp_path), "--checkpoints_dir",
                  str(tmp_path), *CLI, *extra])


P2P = dict(model="pix2pix", net_g="unet_128", fine_size=128, ngf=4, ndf=4,
           no_dropout=True, batch_size=4)


def _pix2pix_batch():
    g = torch.Generator().manual_seed(5)
    return {k: torch.rand(4, 3, 128, 128, generator=g) * 2 - 1
            for k in ("A", "B")}


def _cases():
    s2d = {**dryrun.S2D_REDUCED, "batch_size": 2}
    return {"pix2pix": (dryrun.model_step,
                        (P2P, _pix2pix_batch(), {}, None, 1e-2)),
            "s2d": (dryrun.model_step, (s2d, dryrun.s2d_batch_of(2, 192, 192)))}


@pytest.fixture(scope="module")
def steps():
    two = dryrun.spawn(dryrun.run_cases, 2, (_cases(),), timeout=240)
    return two, dryrun.run_cases(_cases())


@pytest.mark.parametrize("case", ["pix2pix", "s2d"])
def test_two_rank_step_equals_one_process(steps, case):
    two, one = steps
    want = one[case]
    for r in two:
        for name, sd in want["params"].items():
            dryrun.pooled_params_close(r[case]["params"][name], sd, 2e-4,
                                       f"{case} {name}")
            for k, v in sd.items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(
                        r[case]["params"][name][k].numpy(), v.numpy(),
                        atol=1e-5, rtol=1e-4, err_msg=f"{name} {k}")
        for k, v in want["metrics"].items():
            assert r[case]["metrics"][k] == pytest.approx(v, rel=1e-4,
                                                          abs=1e-6), k
    for name, sd in two[0][case]["params"].items():
        for k, v in sd.items():
            assert torch.equal(v, two[1][case]["params"][name][k]), (name, k)
