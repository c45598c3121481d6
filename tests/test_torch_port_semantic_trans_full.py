"""One semantic_trans_full train step of the port against the JAX
package's, on the CPU, and its eval step: the seven phases (G_1, G_2, Seg,
Dep, R_D real, R_D syn, the critics) at 64×96 with ``dense_block_config``
(1, 1, 1, 1), as the JAX package's own test runs it, batch 1; R_D
(``RDepST``) and the critics at their fixed full widths.

Weights cross from the port to JAX through the JAX importers
(``import_g1``, ``import_general_net``, ``import_seg_decoder``,
``import_dep_decoder``, ``import_rdep_st``, ``import_discriminator2_seg``,
``import_star_discriminator``) and back through
``semantic_trans_full_state_dicts_from_jax``. The JAX step runs once
(``train_step``, key 1). Adam at eps 1e-8 for every net, as both models
build them.

- The whole step: the metrics of phases 1–6 within 1e-4 relative (the
  edge BCE's 4/2/1 weights counted twice among them), the BatchNorm
  forwards of each net (G_1 ×3, G_2 ×5 with its stem ×2, Seg_de ×7, R_D
  ×2, Dis0_en ×5), Dis_80 unchanged, and by the three checks of
  ``tests/test_torch_port_s2d_step.py::_assert_params_close``, pooled over
  the net, G_1, Seg_de, Dep_de, DIS, Dis_160 and Dis_320. A phase that
  reads an earlier phase's update inherits its flips (the first Adam step
  at eps 1e-8 is lr·sign(g), and g is rounding in places): over the whole
  step G_2 (after G_1's update) puts 0.5 % of its parameters past lr, and
  phase 7's losses (after G_1's, G_2's and Seg_de's updates, and R_D's
  first) move by up to 9e-4.
- The later phases from JAX's input: the step with JAX's updated weights of
  G_1, G_2, Seg_de and Dep_de loaded after their phases, and JAX's R_D and
  its Adam state after R_D's first phase (the JAX step returns them), the
  port's running statistics kept; each of those nets held by the three
  checks before it is replaced; then every metric (phase 7's
  real-target ``d160_syn``/``d320_syn`` reports among them), every running
  statistic, and by the three checks R_D after its second phase, Dis0_en,
  DIS, Dis_160 and Dis_320.
- The phases' quirks on the port alone: the edge BCE's weights (4, 2, 1,
  counted twice in ``R_D_real``; 1, 1, 1 in ``R_D_syn``), and the Seg
  phase's Dis0_en term, whose value is in the loss and which carries no
  gradient.

Limits (fp32), as in ``tests/test_torch_port_s2d_base.py``: metrics within
1e-4 relative, running statistics within 1e-5 relative plus 1e-5. oneDNN
is off in the step tests.
"""

import copy

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
from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import semantic_trans_full as stf
from cycle_depth_estimation_tpu_torch.utils.weights import (
    semantic_trans_full_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    H, W, LR, assert_metrics_close, assert_out_close, assert_stats_close,
    jax_apply, nhwc, np_tree, numpy_sd, try_batch,
)
from tests.test_torch_port_s2d_df import jax_sds, jax_state
from tests.test_torch_port_s2d_step import _assert_params_close, _params

SMALL = dict(model="semantic_trans_full", batch_size=1,
             dense_block_config=[1, 1, 1, 1])
BLOCKS = tuple(SMALL["dense_block_config"])
IMPORT = {"G_1": lambda sd: ti.import_g1(sd, n_blocks=3),
          "G_2": lambda sd: ti.import_general_net(sd, block_config=BLOCKS),
          "Seg_de": ti.import_seg_decoder, "Dep_de": ti.import_dep_decoder,
          "R_D": ti.import_rdep_st, "Dis0_en": ti.import_discriminator2_seg,
          **{k: (lambda sd, r=r: ti.import_star_discriminator(sd, r))
             for k, r in (("DIS", 5), ("Dis_80", 3), ("Dis_160", 4),
                          ("Dis_320", 4))}}
CRITICS = ("DIS", "Dis_80", "Dis_160", "Dis_320")
NET_LR = {k: LR / (4 if k in CRITICS else 2) for k in IMPORT}
# after which phase each net is last updated, or (R_D) first
LAST = {"G_1": "G_1", "G_2": "G_2", "Seg_de": "Seg", "Dep_de": "Dep",
        "R_D": "R_D_real"}
# the metrics of the phases before ``D``, whose Dis0_en phase reads G_1,
# G_2 and Seg_de after their first Adam steps, and whose DIS reads R_D's
# depth after its first
EARLY = ("G1", "G2", "seg_real", "dep_syn", "R_D_real", "R_D_syn", "dep_ref",
         "acc_syn", "acc_real")
# the nets held over the whole step: their updates read no earlier update
# that flips one of theirs
HELD = ("G_1", "Seg_de", "Dep_de", "DIS", "Dis_160", "Dis_320")


def _cfg():
    return apply_model_defaults(Config(device="cpu", **SMALL))


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    """One intra-op thread (six test processes share the machine) and
    torch's own convolutions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def edge_batch(seed):
    """``try_batch`` at 64×96 with the two edge maps (1 on a tenth of the
    pixels), numpy NHWC for JAX and NCHW torch for the port."""
    jb, tb = try_batch(seed)
    rng = np.random.RandomState(100 + seed)
    for d in ("syn", "real"):
        e = (rng.rand(1, H, W, 1) > 0.9).astype(np.float32)
        jb[f"seg_e_{d}"] = jnp.asarray(e)
        tb[f"seg_e_{d}"] = torch.from_numpy(e.transpose(0, 3, 1, 2).copy())
    return jb, tb


@pytest.fixture(scope="module")
def run():
    """The port's init and a batch, the JAX state on them and its step."""
    model = create_model(_cfg())
    sds = {k: numpy_sd(n) for k, n in model.init_state().nets.items()}
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    jstate = jax_state(jm, sds, {k: k for k in IMPORT}, IMPORT)
    del sds
    jb, tb = edge_batch(0)

    def step(state, batch, key):
        """The JAX step, with R_D's parameters and Adam state after its
        first update (the ``R_D_real`` phase) returned too."""
        first, opt_step = {}, jm._opt_step

        def recorded(name, loss_fn, params, opt_states):
            out = opt_step(name, loss_fn, params, opt_states)
            if name == "R_D" and not first:
                first.update(params=params[name], opt=opt_states[name])
            return out

        jm._opt_step = recorded
        try:
            return (*jm._step_train(state, batch, key), first)
        finally:
            del jm._opt_step

    jstate1, jmetrics, rd1 = jax.jit(step)(jstate, jb, jax.random.key(1))
    want = jax_sds(jstate1, semantic_trans_full_state_dicts_from_jax, _cfg())
    del jstate1
    return dict(batch=tb, jbatch=jb, metrics=jmetrics, want=want, jm=jm,
                jstate=jstate, rd1=rd1)


def _rd_sd(params, stats):
    """JAX R_D variables → the port's R_D state dict."""
    return semantic_trans_full_state_dicts_from_jax(
        {"R_D": {"params": np_tree(params), "batch_stats": np_tree(stats)}},
        _cfg())["R_D"]


def _load_adam(opt, net, opt_state, stats):
    """JAX's Adam state of R_D (optax ``ScaleByAdamState``: count, mu, nu)
    into ``opt``, parameter by parameter."""
    adam = opt_state.inner_state[0]
    mu, nu = (_rd_sd(t, stats) for t in (adam.mu, adam.nu))
    for key, p in net.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": mu[key].clone(),
                        "exp_avg_sq": nu[key].clone()}


def _counts(state):
    return {k: sorted({int(b.num_batches_tracked) for b in net.modules()
                       if isinstance(b, torch.nn.BatchNorm2d)})
            for k, net in state.nets.items()}


def test_semantic_trans_full_step_matches_jax(run):
    model = create_model(_cfg())
    state = model.init_state()
    for k, opt in state.optimizers.items():
        group = opt.param_groups[0]
        assert (group["lr"], group["eps"]) == (NET_LR[k], 1e-8), k
    d80 = copy.deepcopy(state.nets["Dis_80"].state_dict())
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["G_1", "G_2", "Seg", "Dep", "R_D_real", "R_D_syn", "D"]
    assert state.step == 1
    assert_metrics_close({k: m[k] for k in EARLY},
                         {k: run["metrics"][k] for k in EARLY}, EARLY)
    assert _counts(state) == {"G_1": [3], "G_2": [2, 5], "Seg_de": [7],
                              "Dep_de": [], "R_D": [2], "Dis0_en": [5],
                              **{k: [] for k in CRITICS}}
    for k, v in state.nets["Dis_80"].state_dict().items():
        assert torch.equal(v, d80[k]), k
    assert not state.optimizers["Dis_80"].state
    for k in HELD:
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(run["want"][k]), NET_LR[k], k)


def test_semantic_trans_full_later_phases_match_jax(run):
    """Each net's JAX update loaded after its last phase (statistics the
    port's own): the later phases start from JAX's input."""
    model = create_model(_cfg())
    state = model.init_state()
    want = run["want"]
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    stats0 = run["jstate"].batch_stats["R_D"]
    rd1 = _rd_sd(run["rd1"]["params"], stats0)
    for name, phase in model.PHASES:
        phase(model, state, ctx)
        for k in (k for k, p in LAST.items() if p == name):
            net = state.nets[k]
            _assert_params_close(
                _params(net.state_dict()),
                _params(rd1 if k == "R_D" else want[k]), NET_LR[k], k)
            if k == "R_D":
                net.load_state_dict({**rd1, **dict(net.named_buffers())})
                _load_adam(state.optimizers[k], net, run["rd1"]["opt"],
                           stats0)
            else:
                net.load_state_dict({**want[k], **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        assert_stats_close(net.state_dict(), want[k], k)
    for k in ("R_D", "Dis0_en", "DIS", "Dis_160", "Dis_320"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(want[k]), NET_LR[k], k)


def test_semantic_trans_full_eval_step_matches_jax(run):
    """Eval mode from the port's init: every metric, the depth maps (the
    decoder's and R_D's) and the label maps."""
    want_m, want_v = run["jm"].eval_step(run["jstate"], run["jbatch"])
    model = create_model(_cfg())
    m, visuals = model.eval_step(model.init_state(), run["batch"])
    assert_metrics_close(m, want_m, want_m.keys())
    assert set(visuals) == set(want_v) == set(model.visual_names)
    for k in ("syn_dep_pre", "real_dep_pre", "syn_dep_ref", "real_dep_ref"):
        assert_out_close(visuals[k], want_v[k], k)
    for k in ("syn_seg_pre", "real_seg_pre"):
        np.testing.assert_array_equal(visuals[k].numpy(),
                                      np.asarray(want_v[k]))


def _up_to(model, state, ctx, last):
    for name, phase in model.PHASES:
        if name == last:
            return phase
        phase(model, state, ctx)


@pytest.mark.parametrize("phase,weights", [("R_D_real", 2 * 124.0),
                                           ("R_D_syn", 111.0)])
def test_edge_weights(monkeypatch, phase, weights):
    """The R_D phases' edge BCE of the three scales replaced by 1, 10 and
    100 (with a zero gradient), then by 0: the losses differ by 2 · (4·1 +
    2·10 + 100) in ``R_D_real`` (``se = se + se + bce``, then ``se`` counted
    twice) and by 1 + 10 + 100 in ``R_D_syn``."""
    model = create_model(_cfg())
    state = model.init_state()
    ctx = model._ctx(state, edge_batch(1)[1])
    for net in state.nets.values():
        net.train()
    run_phase = _up_to(model, state, ctx, phase)
    before = ({k: copy.deepcopy(n.state_dict()) for k, n in
               state.nets.items()},
              {k: copy.deepcopy(o.state_dict()) for k, o in
               state.optimizers.items()})
    got = []
    for values in ((1.0, 10.0, 100.0), (0.0, 0.0, 0.0)):
        for k, n in state.nets.items():
            n.load_state_dict(before[0][k])
            state.optimizers[k].load_state_dict(before[1][k])
        it = iter(values)
        monkeypatch.setattr(stf, "_bce",
                            lambda p, t: p.sum() * 0.0 + next(it))
        run_phase(model, state, ctx)
        got.append(float(ctx["metrics"][phase]))
    np.testing.assert_allclose(got[0] - got[1], weights, rtol=1e-6)


def test_seg_phase_adversarial_term_has_no_gradient(monkeypatch):
    """The Seg phase steps on CE(real) + LSGAN(Dis0_en(syn features),
    real): that term's value, recomputed by the JAX Discriminator2Seg in
    train mode on the same features and weights, is in the loss, and the
    loss reaches no parameter of Dis0_en (it was computed detached), so
    Seg_de's update is CE(real)'s."""
    model = create_model(_cfg())
    state = model.init_state()
    ctx = model._ctx(state, edge_batch(2)[1])
    for net in state.nets.values():
        net.train()
    run_phase = _up_to(model, state, ctx, "Seg")
    d0 = state.nets["Dis0_en"]
    variables = IMPORT["Dis0_en"](numpy_sd(d0))
    adv = float(np.mean((np.asarray(jax_apply(
        jsn.Discriminator2Seg(), variables, nhwc(ctx["syn_f1"]),
        train=True)[0]) - 1.0) ** 2))
    seen, step = [], model._step
    monkeypatch.setattr(model, "_step", lambda st, names, loss: (
        seen.append((float(loss), torch.autograd.grad(
            loss, list(d0.parameters()), allow_unused=True,
            retain_graph=True))), step(st, names, loss)))
    run_phase(model, state, ctx)
    ((loss, grads),) = seen
    np.testing.assert_allclose(loss - float(ctx["metrics"]["seg_real"]), adv,
                               rtol=1e-5)
    assert all(g is None for g in grads)
