"""One semantic_trans train step of the port against the JAX package's, on
the CPU: S2D's four phases with the truncated band criterion and the
critics' term in ``rd_real``, then ``post`` (DIS with the WGAN-GP penalty,
Dis_160 and Dis_320 with the clipped Adam), at 192×192 (S2D's FD nets need
192 pixels a side) and S2D's smallest widths (DenseNet growth 8, blocks
(2, 2, 2, 2), ``mid_nc`` 64, ``g1_blocks`` 1), batch 1, ``adam_eps`` 1e-3
for the S2D nets; the four critics at eps 1e-8, as both models build them.

Weights cross from the port to JAX through the JAX importers (S2D's and
``import_star_discriminator``) and back through
``semantic_trans_state_dicts_from_jax``. The JAX step runs once, through
``train_step_phased`` at key 1, each phase's output recorded; the
penalty's alpha is the uniform that key draws, passed to the port's step
(``model.gp_alpha``).

- The port's whole step from the same init and batch: every metric within
  1e-4 relative, and each net's parameters by the three checks of
  ``tests/test_torch_port_s2d_step.py::_assert_params_close``, pooled over
  the net; Dis_80 unchanged on both sides.
- ``rd_real``, ``rd_syn`` and ``post`` alone, each from the JAX state and
  carried tensors that phase received: its metrics (1e-4 relative), every
  running statistic (1e-5 absolute and relative) and the parameters of
  the nets it updates by the three checks; the other nets unchanged.
- The clipped step's wiring: Dis_160's and Dis_320's first Adam moment is
  (1 − β1) times the gradient clipped by optax's rule, DIS's the plain one.

oneDNN is off in this file, as in the S2D step test.
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
from cycle_depth_estimation_tpu_torch.models.semantic_trans import CRITICS
from cycle_depth_estimation_tpu_torch.utils.weights import (
    semantic_trans_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_step import (
    NET_LR as S2D_NET_LR, _assert_close, _assert_params_close, _batch,
    _jax_variables as _s2d_jax_variables, _load_adam, _nchw, _np_tree,
    _numpy_sds, _params, _torch_batch,
)

SMALL = dict(model="semantic_trans", batch_size=1,
             dense_block_config=[2, 2, 2, 2], g1_blocks=1, dense_growth_rate=8,
             s2d_mid_nc=64, adam_eps=1e-3)
REPEATS = {"DIS": 5, "Dis_80": 3, "Dis_160": 4, "Dis_320": 4}
NET_LR = {**S2D_NET_LR, **dict.fromkeys(CRITICS, 2e-4 / 4)}
# the nets each phase held alone updates, its metrics, the tensors it
# carries on
PHASES = {"rd_real": (("R_D",), ("R_D_real",), ("real_feats_d",)),
          "rd_syn": (("R_D",), ("R_D_syn", "dep_ref", "dep_l1", "dep_band"),
                     ("syn_feats_d",)),
          "post": (("DIS", "Dis_160", "Dis_320"),
                   ("DEP_DIS", "gp", "d160", "d320"), ())}


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def _cfg():
    return apply_model_defaults(Config(device="cpu", **SMALL))


def _jax_variables(sds):
    return {**_s2d_jax_variables(sds),
            **{k: ti.import_star_discriminator(sds[k], r)
               for k, r in REPEATS.items()}}


def _sds_of(params, stats):
    return semantic_trans_state_dicts_from_jax(
        {k: {"params": _np_tree(params[k]),
             "batch_stats": _np_tree(stats.get(k, {}))} for k in params},
        _cfg())


def _model(alpha):
    model = create_model(_cfg())
    model.gp_alpha = lambda state: torch.tensor(alpha)
    return model


@pytest.fixture(scope="module")
def run():
    """The port's init, the batch, and the JAX step on them, each phase's
    output context recorded."""
    v0 = _jax_variables(_numpy_sds(create_model(_cfg()).init_state().nets))
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v.get("batch_stats", {}))
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
    key = jax.random.key(1)
    jstate1, jmetrics = jm.train_step_phased(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, key,
        progress=seen.append)
    assert seen == ["g2", "g1", "rd_real", "rd_syn", "fd", "post"]
    return dict(batch=b, jax_metrics={k: float(v) for k, v in
                                      jmetrics.items()},
                jax_state=jstate1, jax_state0=jstate, phases=out,
                alpha=float(jax.random.uniform(key, (), jnp.float32)))


def test_semantic_trans_step_matches_jax(run):
    """The port's whole step: its phases, every metric (the penalty at
    JAX's alpha among them), each net's parameters by the three checks,
    Dis_80 unchanged on both sides, and each net's Adam: the S2D nets at
    ``adam_eps``, the critics at lr/4 and eps 1e-8."""
    model = _model(run["alpha"])
    state = model.init_state()
    for k, opt in state.optimizers.items():
        group = opt.param_groups[0]
        assert (group["lr"], group["eps"]) == (
            NET_LR[k], 1e-8 if k in CRITICS else 1e-3), k
    d80 = {k: v.clone() for k, v in state.nets["Dis_80"].state_dict().items()}
    seen = []
    state, m = model.train_step_phased(state, _torch_batch(run["batch"]),
                                       progress=seen.append)
    assert seen == ["g2", "g1", "rd_real", "rd_syn", "fd", "post"]
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(run["jax_metrics"]) == set(model.loss_names)
    for k, want in run["jax_metrics"].items():
        assert np.isfinite(m[k]), k
        np.testing.assert_allclose(m[k], want, rtol=1e-4, err_msg=k)
    want = _sds_of(run["jax_state"].params, run["jax_state"].batch_stats)
    for k, net in state.nets.items():
        _assert_params_close(_params(net.state_dict()), _params(want[k]),
                             NET_LR[k], k)
    for key, v in state.nets["Dis_80"].state_dict().items():
        assert torch.equal(v, d80[key]), key
    assert not state.optimizers["Dis_80"].state
    for a, b in zip(jax.tree.leaves(run["jax_state"].params["Dis_80"]),
                    jax.tree.leaves(run["jax_state0"].params["Dis_80"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("phase", list(PHASES))
def test_semantic_trans_phase_matches_jax(run, phase):
    """One phase from JAX's input state and carried tensors: its metrics,
    every running statistic, the parameters of the nets it updates (the
    others unchanged) and the tensors it carries on."""
    names = list(run["phases"])
    pre = run["phases"][names[names.index(phase) - 1]]
    post = run["phases"][phase]
    updated, metrics, carried = PHASES[phase]
    model = _model(run["alpha"])
    state = model.init_state()
    sd_pre = _sds_of(pre["params"], pre["stats"])
    for k, sd in sd_pre.items():
        state.nets[k].load_state_dict(sd)
    for k in updated:
        if k == "R_D":  # the critics take their first step in ``post``
            _load_adam(state.optimizers[k], state.nets[k], k,
                       pre["opt_states"][k], pre["stats"][k])
    ctx = model._ctx(_torch_batch(run["batch"]), state)
    for key in ("syn_psp", "real_psp", "real_dep_ref"):
        if key in pre:
            ctx[key] = _nchw(pre[key])
    for key in ("syn_feats", "real_feats", "real_dep_4", "syn_dep_4"):
        if key in pre:
            ctx[key] = [_nchw(f) for f in pre[key]]
    if "syn_dep_o" in pre:
        ctx["syn_dep_ref"] = _nchw(pre["syn_dep_o"])

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
        if k in updated:
            _assert_params_close(_params(sd), _params(sd_post[k]), NET_LR[k],
                                 k)
        else:
            for key, a in _params(sd).items():
                np.testing.assert_array_equal(a, _params(sd_pre[k])[key],
                                              err_msg=key)
    for key in carried:
        for i, (g, w) in enumerate(zip(ctx[key], post[key])):
            _assert_close(g, w, f"{key}[{i}]")


@pytest.mark.parametrize("name", ["DIS", "Dis_160", "Dis_320"])
def test_critic_step_clips_as_optax(name):
    """``_step`` on a loss whose gradient has a global norm of 100: Adam's
    first moment after it is (1 − β1)·g / 100 for Dis_160 and Dis_320
    (optax's clip at 1.0 before their Adam) and (1 − β1)·g for DIS."""
    model = create_model(_cfg())
    state = model.init_state()
    net = state.nets[name]
    x = torch.randn(1, 2 if name == "DIS" else 1, 48, 48,
                    generator=torch.Generator().manual_seed(3))
    out = net(x).mean()
    params = list(net.parameters())

    def global_norm(grads):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))

    loss = out * (100.0 / global_norm(torch.autograd.grad(
        out, params, retain_graph=True)))
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    torch.testing.assert_close(global_norm(grads), torch.tensor(100.0))
    model._step(state, name, loss)
    scale = 1.0 if name == "DIS" else 1.0 / 100.0
    opt = state.optimizers[name]
    for p, g in zip(params, grads):
        torch.testing.assert_close(opt.state[p]["exp_avg"],
                                   (1 - model.cfg.beta1) * g * scale,
                                   rtol=1e-5, atol=0)


def test_gp_alpha_is_seeded():
    """One alpha a step in [0, 1), drawn from ``seed`` and the step."""
    model = create_model(_cfg())
    state = model.init_state()
    a = model.gp_alpha(state)
    assert a.shape == () and 0 <= float(a) < 1
    assert torch.equal(a, model.gp_alpha(state))
    state.step = 1
    assert not torch.equal(a, model.gp_alpha(state))
    assert not torch.equal(a, create_model(
        apply_model_defaults(Config(device="cpu", seed=1, **SMALL)))
        .gp_alpha(model.init_state()))
