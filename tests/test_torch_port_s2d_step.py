"""One S2D train step of the port against the JAX package's, on the CPU: the
four-phase round-robin at 192×192 (the FD nets need 192 pixels a side), at
the smallest widths (DenseNet growth 8, blocks (2, 2, 2, 2), ``mid_nc`` 64,
``g1_blocks`` 1), batch 1, ``adam_eps`` 1e-3.

Weights cross from the port to JAX through the JAX importers
(``import_g1``, ``import_general_net``, ``import_rdep``,
``import_sdiscriminator``) and back through ``s2d_state_dicts_from_jax``;
the JAX optimizer states are ``opts[k].init``. The JAX step runs once, through
``train_step_phased``, with each phase's output recorded.

Two comparisons:

- the port's whole step from the same init and batch: every metric within
  1e-4 relative, and each net's parameters by the three checks of
  ``tests/test_s2d.py::_assert_params_close`` (``_assert_params_close``
  here says how they are applied). The phases run in sequence, so a wrong
  update or order in one phase moves the losses of the phases after it;
- each phase alone, started from the JAX state and carried tensors that
  phase received: its metrics (1e-4 relative), every running statistic
  (1e-5 absolute and relative) and the parameters it updates, by the same
  three checks; the other nets' parameters unchanged.
  Started from JAX's input, a phase differs from JAX's by its own rounding
  only. Over the whole step, rounding differences grow from phase to phase
  through Adam's first step (lr·g/(|g| + eps)) and BatchNorms over 2×2
  planes at batch 1: the FD statistics end up to 7e-5 apart and single
  elements of the 4-element R_D leaves past 1e-5 — and JAX's own fp32 step
  is as far from a float64 one.

oneDNN is off while this file runs: its fp32 convolutions put the port's
step about twice as far from a float64 step as torch's own do (G_1: 1.45 lr
against 0.34 lr at most), which the sequential losses show.
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
from cycle_depth_estimation_tpu_torch.utils.weights import (
    s2d_state_dicts_from_jax,
)

SMALL = dict(model="S2D", batch_size=1, dense_block_config=[2, 2, 2, 2],
             g1_blocks=1, dense_growth_rate=8, s2d_mid_nc=64, adam_eps=1e-3)
H = W = 192
NET_LR = {"G_1": 2e-4 / 5, "G_2": 2e-4 / 3, "R_D": 2e-4 / 2,
          "FD1": 2e-4 / 4, "FD2": 2e-4 / 4, "FD3": 2e-4 / 4}
# the net each phase updates, its metrics and the tensors it carries on
PHASES = {
    "g2": ("G_2", ("G2", "seg_syn", "seg_real", "acc_syn", "acc_real"),
           ("syn_psp", "syn_feats", "real_psp", "real_feats")),
    "g1": ("G_1", ("G1",), ()),
    "rd_real": ("R_D", ("R_D_real",), ("real_feats_d",)),
    "rd_syn": ("R_D", ("R_D_syn", "dep_ref", "dep_l1", "dep_band"),
               ("syn_feats_d",)),
    "fd": (("FD1", "FD2", "FD3"), ("FD",), ()),
}


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    """One intra-op thread (six test processes share the machine) and
    torch's own convolutions (see the module docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def _cfg():
    return apply_model_defaults(Config(device="cpu", **SMALL))


def _numpy_sds(nets):
    return {k: {n: v.detach().numpy().copy()
                for n, v in net.state_dict().items()}
            for k, net in nets.items()}


def _jax_variables(sds):
    """Port state dicts → the JAX nets' variables, by the JAX importers."""
    return {"G_1": ti.import_g1(sds["G_1"], n_blocks=SMALL["g1_blocks"]),
            "G_2": ti.import_general_net(
                sds["G_2"], block_config=tuple(SMALL["dense_block_config"])),
            "R_D": ti.import_rdep(sds["R_D"]),
            **{k: ti.import_sdiscriminator(sds[k])
               for k in ("FD1", "FD2", "FD3")}}


def _batch():
    rng = np.random.RandomState(0)
    seg_syn = rng.randint(0, 28, (1, H, W))
    seg_syn[:, :40] = 17  # a band of sky
    return {
        "img_syn": rng.randn(1, H, W, 3).astype(np.float32),
        "img_real": rng.randn(1, H, W, 3).astype(np.float32),
        "seg_l_syn": seg_syn.astype(np.int32),
        "seg_l_real": rng.randint(0, 28, (1, H, W)).astype(np.int32),
        "dep_l_syn": (rng.rand(1, H, W, 1) * 2 - 1).astype(np.float32),
        "depth_l_s": np.sign(rng.randn(1, H, W, 4)).astype(np.float32),
    }


def _torch_batch(b):
    return {k: (torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
                if v.ndim == 4 else torch.from_numpy(v.astype(np.int64)))
            for k, v in b.items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _sds_of(params, stats):
    """JAX params/stats of the six nets → the port's six state dicts."""
    return s2d_state_dicts_from_jax(
        {k: {"params": _np_tree(params[k]), "batch_stats": _np_tree(stats[k])}
         for k in params}, _cfg())


@pytest.fixture(scope="module")
def run():
    """The port's init, the batch, and the JAX step on them, each phase's
    output context recorded."""
    v0 = _jax_variables(_numpy_sds(create_model(_cfg()).init_state().nets))
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v["batch_stats"])
             for k, v in v0.items()}
    jstate = JaxModelState(
        params=params, batch_stats=stats,
        opt_states={k: jm.opts[k].init(params[k]) for k in params},
        pools={}, step=jnp.zeros((), jnp.int32))
    b = _batch()
    out, seen = {}, []

    def recorded(name, fn):
        def f(ctx):
            out[name] = fn(ctx)
            return out[name]
        return f

    jm._phase_jits = {n: recorded(n, jax.jit(fn)) for n, fn in jm._phases()}
    jstate1, jmetrics = jm.train_step_phased(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(1),
        progress=seen.append)
    assert seen == ["g2", "g1", "rd_real", "rd_syn", "fd", "post"]
    ctx0 = jm._ctx_init(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.key(1))
    return dict(batch=b, jax_metrics={k: float(v) for k, v in
                                                 jmetrics.items()},
                jax_state=jstate1, ctx0=ctx0, phases=out)


def test_s2d_step_matches_jax(run):
    """The port's whole step: metrics, and parameters by the three checks.
    (The running statistics are held phase by phase below: over the whole
    step, the FDs' end up to 7e-5 apart, downstream of R_D's rounding.)"""
    model = create_model(_cfg())
    state = model.init_state()
    seen = []
    state, m = model.train_step_phased(state, _torch_batch(run["batch"]),
                                       progress=seen.append)
    assert seen == list(PHASES)
    assert state.step == 1
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(run["jax_metrics"]) == set(model.loss_names)
    for k, want in run["jax_metrics"].items():
        assert np.isfinite(m[k]), k
        np.testing.assert_allclose(m[k], want, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(m["dep_ref"], m["dep_l1"] + m["dep_band"],
                               rtol=1e-6)
    want = _sds_of(run["jax_state"].params, run["jax_state"].batch_stats)
    for k, net in state.nets.items():
        _assert_params_close(_params(net.state_dict()), _params(want[k]),
                             NET_LR[k], k)


def _assert_params_close(got, want, net_lr, what):
    """The three checks of ``tests/test_s2d.py::_assert_params_close`` on
    the parameters of one net ({key: array} each): every leaf's max
    difference ≤ 3·lr, and over the net, the share past lr ≤ 3e-3 and the
    share past 1e-5 ≤ 8 %. The shares are taken over the net, not per leaf:
    a bias of 4 to 32 elements has elements whose fp32 gradient is rounding
    alone (a BatchNorm or a 2×2-plane BatchNorm downstream), and one such
    element past lr is a 3–25 % share of its leaf in JAX's own step as in
    the port's."""
    diffs = []
    for key, a in got.items():
        d = np.abs(a.astype(np.float64) - want[key].astype(np.float64))
        assert d.max() <= 3.0 * net_lr, (what, key, d.max())
        diffs.append(d.ravel())
    d = np.concatenate(diffs)
    assert np.mean(d > net_lr) <= 3e-3, (what, float(np.mean(d > net_lr)))
    assert np.mean(d > 1e-5) <= 0.08, (what, float(np.mean(d > 1e-5)))


def _params(sd):
    return {k: v.detach().numpy() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _load_adam(opt, net, name, opt_state, stats):
    """JAX's Adam state of net ``name`` (optax ``ScaleByAdamState``: count,
    mu, nu) into ``opt``, parameter by parameter."""
    adam = opt_state.inner_state[0]
    count = int(adam.count)
    if count == 0:
        return
    mu, nu = (s2d_state_dicts_from_jax(
        {name: {"params": _np_tree(t), "batch_stats": _np_tree(stats)}},
        _cfg())[name] for t in (adam.mu, adam.nu))
    for key, p in net.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[key].clone(),
                        "exp_avg_sq": nu[key].clone()}


def _assert_close(got, want, what):
    """A carried tensor: max abs error ≤ 1e-4 of max |want|, plus 1e-5."""
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, (what, err)


@pytest.mark.parametrize("phase", list(PHASES))
def test_s2d_phase_matches_jax(run, phase):
    """One phase from JAX's input state and carried tensors: its metrics,
    every running statistic, the parameters of the net it updates (the
    others unchanged) and the tensors it carries on."""
    names = list(PHASES)
    pre = run["ctx0"] if phase == "g2" else run["phases"][
        names[names.index(phase) - 1]]
    post = run["phases"][phase]
    updated, metrics, carried = PHASES[phase]
    updated = (updated,) if isinstance(updated, str) else updated
    model = create_model(_cfg())
    state = model.init_state()
    sd_pre = _sds_of(pre["params"], pre["stats"])
    for k, sd in sd_pre.items():
        state.nets[k].load_state_dict(sd)
    for k in updated:
        _load_adam(state.optimizers[k], state.nets[k], k,
                   pre["opt_states"][k], pre["stats"][k])
    ctx = model._ctx(_torch_batch(run["batch"]))
    for key in ("syn_psp", "real_psp"):
        if key in pre:
            ctx[key] = _nchw(pre[key])
    for key in ("syn_feats", "real_feats", "real_feats_d", "syn_feats_d"):
        if key in pre:
            ctx[key] = [_nchw(f) for f in pre[key]]

    dict(model.PHASES)[phase](model, state, ctx)

    for key in metrics:
        np.testing.assert_allclose(float(ctx["metrics"][key]),
                                   float(post["metrics"][key]), rtol=1e-4,
                                   err_msg=key)
    sd_post = _sds_of(post["params"], post["stats"])
    for k, net in state.nets.items():
        sd = net.state_dict()
        for key, t in sd.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), sd_post[k][key].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k}.{key}")
        want = _params(sd_post[k] if k in updated else sd_pre[k])
        if k in updated:
            _assert_params_close(_params(sd), want, NET_LR[k], k)
        else:
            for key, a in _params(sd).items():
                np.testing.assert_array_equal(a, want[key], err_msg=key)
    for key in carried:
        got, want = ctx[key], post[key]
        if isinstance(want, (list, tuple)):
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_close(g, w, f"{key}[{i}]")
        else:
            _assert_close(got, want, key)
