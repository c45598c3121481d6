"""One RefineNet-LW (``rf_lw``) train step of the port against the JAX
package's, on the CPU: ResNetLW (1, 1, 1, 1) (the widths stay full: 2048
channels at layer 4) and the four heads at 64×96, batch 1, from the same
weights and batch; then ``eval_step`` from JAX's updated state, the
``--syn_domain`` switch, and the train CLI for two steps.

Weights cross from the port to JAX through the JAX importers
(``import_resnetlw``, ``import_segd``) and back through
``rf_lw_state_dicts_from_jax``; the JAX optimizer states are
``opts[k].init``. The JAX step runs once (jitted) for the file. Limits:
every metric within 1e-4 relative; each net's parameters by the three
checks of ``tests/test_s2d.py::_assert_params_close``, pooled per net
(``tests/test_torch_port_s2d_step.py``): Adam's first step at eps 1e-8 is
sign(g)·lr, and the 2048-channel adapter normalizes 2×3 planes here, so a
gradient that is rounding alone flips ~1e-3 of G's updates in JAX's own
fp32 step as in the port's; every running statistic within 1e-5 relative
plus 1e-5 (a running mean behind an adapter is ~1e-7, rounding alone),
every batch count 2 (G runs on the real image, then the synthetic one).
oneDNN is off while this file runs, as in the S2D step file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models.base_model import (
    ModelState as JaxModelState,
)
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models.refinenet import HEADS
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net, load_pth, rf_lw_state_dicts_from_jax)
from tests.test_torch_port_s2d_step import _assert_params_close, _params
from tests.test_torch_port_try_data import write_try_files

LAYERS = [1, 1, 1, 1]
H, W = 64, 96
LR = 2e-4


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def small(model, **kw):
    return dict(model=model, batch_size=1, resnet_layers=LAYERS, **kw)


def port_cfg(model, **kw):
    return apply_model_defaults(Config(device="cpu", **small(model, **kw)))


def batch(seed=0):
    rng = np.random.RandomState(seed)
    seg_syn = rng.randint(0, 28, (1, H, W))
    seg_syn[:, :12] = 17  # a band of sky
    return {
        "img_syn": rng.randn(1, H, W, 3).astype(np.float32),
        "img_real": rng.randn(1, H, W, 3).astype(np.float32),
        "seg_l_syn": seg_syn.astype(np.int32),
        "seg_l_real": rng.randint(0, 28, (1, H, W)).astype(np.int32),
        "dep_l_syn": (rng.rand(1, H, W, 1) * 2 - 1).astype(np.float32),
        "depth_l_s": np.sign(rng.randn(1, H, W, 4)).astype(np.float32),
    }


def torch_batch(b):
    return {k: (torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
                if v.ndim == 4 else torch.from_numpy(v.astype(np.int64)))
            for k, v in b.items()}


def jax_variables(nets):
    """Port nets → the JAX nets' variables: G and the heads by the JAX
    importers, rf_lw7's ``depth`` block (no importer) by
    ``jax_variables_from_net``."""
    out = {}
    for k, net in nets.items():
        sd = {n: v.detach().numpy().copy() for n, v in net.state_dict().items()}
        if k == "G":
            out[k] = ti.import_resnetlw(sd, layers=tuple(LAYERS))
        elif k in HEADS:
            out[k] = ti.import_segd(sd, HEADS[k][2])
        else:
            params, stats = jax_variables_from_net(net)
            out[k] = {"params": params, "batch_stats": stats}
    return out


def run_jax_step(model, dtype="float32", seed=0):
    """The port's init and the JAX step (and eval step after it) on it."""
    state = create_model(port_cfg(model)).init_state()
    v0 = jax_variables(state.nets)
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(
        **small(model, dtype=dtype))))
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v.get("batch_stats") or {})
             for k, v in v0.items()}
    js = JaxModelState(params=params, batch_stats=stats,
                       opt_states={k: jm.opts[k].init(params[k])
                                   for k in params},
                       pools={}, step=jnp.zeros((), jnp.int32))
    b = batch(seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    js1, jmetrics = jm.train_step(js, jb, jax.random.key(1))
    out = dict(batch=b, metrics={k: float(v) for k, v in jmetrics.items()},
               sds=jax_state_dicts(js1, model), params0=v0)
    if dtype == "float32":
        jme, jvis = jm.eval_step(js1, jb)
        out.update(eval_metrics={k: float(v) for k, v in jme.items()},
                   visuals={k: np.asarray(v) for k, v in jvis.items()})
    return out


def jax_state_dicts(js, model):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return rf_lw_state_dicts_from_jax(
        {k: {"params": np_tree(js.params[k]),
             "batch_stats": np_tree(js.batch_stats[k])} for k in js.params},
        port_cfg(model))


def net_lr(model, name):
    return LR / create_model(port_cfg(model)).LR_DIVISOR[name]


def assert_step_matches(model, run, metrics_rel=1e-4):
    """The port's step from the same init and batch against ``run``."""
    pm = create_model(port_cfg(model))
    state = pm.init_state()
    state, m = pm.train_step(state, torch_batch(run["batch"]))
    assert state.step == 1
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(run["metrics"]) == set(pm.loss_names)
    for k, want in run["metrics"].items():
        assert np.isfinite(m[k]), k
        np.testing.assert_allclose(m[k], want, rtol=metrics_rel, err_msg=k)
    for k, net in state.nets.items():
        want = run["sds"][k]
        sd = net.state_dict()
        _assert_params_close(_params(sd), _params(want), net_lr(model, k), k)
        for key, t in sd.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), want[key].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k}.{key}")
            elif key.endswith("num_batches_tracked"):
                assert int(t) == (2 if k == "G" else 0), (k, key, int(t))
    return state


@pytest.fixture(scope="module")
def run():
    return run_jax_step("rf_lw")


def test_rf_lw_step_matches_jax(run):
    state = assert_step_matches("rf_lw", run)
    # the synthetic branch took the _r adapters: _s is as initialised
    p0 = {k: v for k, v in run["params0"]["G"]["params"].items()
          if k.endswith("_s")}
    assert len(p0) == 4
    g = state.nets["G"].state_dict()
    for name, entry in p0.items():
        np.testing.assert_array_equal(
            g[f"{name}.0.weight"].numpy(),
            entry["conv"]["kernel"].transpose(3, 2, 0, 1), err_msg=name)


def assert_eval_matches(model, run):
    """``eval_step`` on JAX's updated state against JAX's: metrics within
    1e-4 relative (the accuracies within 2 pixels' share: an argmax tie may
    fall either way), the depth maps within 1e-4 of their scale, the label
    maps on all but 0.1 % of the pixels, images and labels equal."""
    pm = create_model(port_cfg(model))
    state = pm.init_state()
    for k, net in state.nets.items():
        net.load_state_dict(run["sds"][k])
    m, vis = pm.eval_step(state, torch_batch(run["batch"]))
    assert set(m) == set(run["eval_metrics"])
    for k, want in run["eval_metrics"].items():
        if k.startswith("acc"):
            assert abs(float(m[k]) - want) <= 2 / (H * W), k
        else:
            np.testing.assert_allclose(float(m[k]), want, rtol=1e-4,
                                       err_msg=k)
    assert set(vis) == set(run["visuals"]) == set(pm.visual_names)
    for k, want in run["visuals"].items():
        got = vis[k].numpy()
        if want.ndim == 4:
            want = want.transpose(0, 3, 1, 2)
        assert got.shape == want.shape, k
        if "seg_pre" in k:
            assert np.mean(got != want) <= 1e-3, k
        elif "dep_pre" in k:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_rf_lw_eval_step_matches_jax(run):
    assert_eval_matches("rf_lw", run)


def test_syn_domain_switch():
    """``--syn_domain syn`` routes the synthetic branch through the ``_s``
    adapters, which then move; any other value is refused as in JAX."""
    pm = create_model(port_cfg("rf_lw", syn_domain="syn"))
    state = pm.init_state()
    before = {k: v.clone() for k, v in state.nets["G"].state_dict().items()}
    state, _ = pm.train_step(state, torch_batch(batch(1)))
    after = state.nets["G"].state_dict()
    for i in range(1, 5):
        for sfx in ("s", "r"):
            key = f"ins_layer{i}_{sfx}.0.weight"
            assert not torch.equal(after[key], before[key]), key
    with pytest.raises(ValueError, match="must be 'real' or 'syn'"):
        create_model(port_cfg("rf_lw", syn_domain="other"))
    with pytest.raises(ValueError, match="must be 'real' or 'syn'"):
        jax_create_model(JaxConfig(**small("rf_lw", syn_domain="other")))


def test_rf_lw_train_cli_two_steps(tmp_path):
    """``python -m cycle_depth_estimation_tpu_torch.train --model rf_lw``
    (through ``main``) on a small ``try`` folder at 64×192: two steps, the
    five nets saved with their reference keys and loaded back, the losses
    logged and the depth visuals written."""
    from PIL import Image

    from cycle_depth_estimation_tpu_torch.train import main

    lists = write_try_files(str(tmp_path / "data"), n=2)
    args = ["--model", "rf_lw", "--device", "cpu", "--resnet_layers",
            *map(str, LAYERS), "--fine_size", "64", "--checkpoints_dir",
            str(tmp_path / "ck"), "--name", "rf", "--niter", "1",
            "--niter_decay", "0", "--save_epoch_freq", "1", "--print_freq",
            "1", "--display_freq", "2", "--num_threads", "0"]
    for kind, path in lists.items():
        args += [f"--{kind}_file_train", path]
    state = main(args)
    assert state.step == 2
    expr = tmp_path / "ck" / "rf"
    model = create_model(port_cfg("rf_lw").replace(
        checkpoints_dir=str(tmp_path / "ck"), name="rf"))
    loaded = model.load_networks(model.init_state(), 1)
    for name in model.model_names:
        sd = load_pth(str(expr / f"1_net_{name}.pth"))
        for key, t in state.nets[name].state_dict().items():
            torch.testing.assert_close(sd[key], t, rtol=0, atol=0)
            torch.testing.assert_close(loaded.nets[name].state_dict()[key], t,
                                       rtol=0, atol=0)
    log = (expr / "loss_log.txt").read_text()
    assert all(k in log for k in model.loss_names)
    dep = np.asarray(Image.open(expr / "web" / "images"
                                / "epoch001_syn_dep_pre.png"))
    assert dep.shape == (64, 192, 3) and dep.max() == 255 and dep.min() == 0
