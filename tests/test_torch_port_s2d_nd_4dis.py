"""S2D_nd ``--nd_4dis`` (new_depseg's model3 "4dis") of the port against
the JAX package, on the CPU: the twin critics and one train step.

The twins are ``Dis2SegDF`` at ``conv_dim`` 256 with 28 sigmoid channels,
each over a 256-channel slice of the trunks' features (Dis0_en [0, 256),
Dis1_en [256, 512)), Adam at lr, no gradient penalty, the targets of
model2 undone (syn → fake, real → real) and G_2's term BCE(twins(real) →
fake) as model3 writes it; Dep_de's real forward moves into the G_2 phase,
whose reported loss adds 3 × ``real_dep_loss``.

The step (64×96, ``dense_block_config`` (2, 2, 2, 2)): the port's init
through the importers into the JAX model and the JAX step run once
(``train_step``, key 1). Limits and helpers as in
``tests/test_torch_port_s2d_nd.py``; the twins' BCE is on sigmoid outputs
near 0.5, well conditioned, so every Adam net, the twins among them, is
held by the three pooled checks. oneDNN is off in the step tests.
"""

import numpy as np
import pytest
import torch

import jax

from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    s2d_nd_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    LR, assert_metrics_close, assert_out_close, assert_stats_close, nchw,
    numpy_sd, randomize,
)
from tests.test_torch_port_s2d_df import jax_critic
from tests.test_torch_port_s2d_nd import (
    IMPORT, PSP, _cfg, d_phase_vs_jax, port_model, run_step,
)
from tests.test_torch_port_s2d_step import _assert_params_close, _params

OPT_OF = {"G_1": "G_1", "G_2": "G_2", "Seg": "Seg_de", "Dep": "Dep_de",
          "D0": "Dis0_en", "D1": "Dis1_en"}
NET_LR = {"G_1": LR / 2, "G_2": LR / 2, "Seg_de": LR / 2, "Dep_de": LR / 2,
          "Dis0_en": LR, "Dis1_en": LR}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cfg4():
    return _cfg(nd_4dis=True)


def test_twin_critic_matches_jax():
    """A twin on its 256-channel slice of the features: the 28-channel
    sigmoid map (not squeezed), through ``import_dis2seg_df`` both ways."""
    net = randomize(psn.s2d_nd_nets(_cfg4())["Dis1_en"], 3)
    assert net.main[0].in_channels == psn.ND_SLICE == 256
    x = np.random.RandomState(7).randn(*PSP)[..., 256:512].astype(np.float32)
    v = IMPORT["Dis1_en"](numpy_sd(net))
    assert_out_close(net(nchw(x)), jax_critic(
        jsn.Dis2SegDF(conv_dim=256, repeat_num=3, head_ch=28), v, x), "twin")
    params, _ = jax_variables_from_net(net)
    for a, b in zip(jax.tree.leaves(v["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    back = s2d_nd_state_dicts_from_jax({"Dis1_en": v}, _cfg4())["Dis1_en"]
    for k, t in net.state_dict().items():
        torch.testing.assert_close(back[k], t, rtol=0, atol=0)


def test_4dis_names_and_optimizers():
    model = create_model(_cfg4())
    state = model.init_state()
    assert model.model_names == tuple(state.nets) == (
        "G_1", "G_2", "Dis0_en", "Dis1_en", "Seg_de", "Dep_de")
    assert "gp" not in model.loss_names and "dep_real" in model.loss_names
    lrs = {k: o.param_groups[0]["lr"] for k, o in state.optimizers.items()}
    assert lrs == NET_LR
    assert all(isinstance(o, torch.optim.Adam)
               for o in state.optimizers.values())


@pytest.fixture(scope="module")
def run():
    return run_step(_cfg4(), IMPORT, OPT_OF)


def test_s2d_nd_4dis_step_matches_jax(run, no_onednn):
    """The port's whole step: the metrics of phases D1 to Dep, the
    BatchNorm forwards (G_1 ×3, G_2 ×3, Seg_de ×4), Seg_de's statistics,
    and G_1's, G_2's, Seg_de's and Dep_de's parameters by the three pooled
    checks. The second D phase reads the trunks' and the twins' updated
    weights: it is held below."""
    model = port_model(_cfg4(), run["alphas"])
    state = model.init_state()
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["D1", "G_1", "G_2", "Seg", "Dep", "D2"]
    names = [k for k in model.loss_names if k not in ("D_syn", "D_real")]
    assert_metrics_close({k: m[k] for k in names},
                         {k: run["metrics"][k] for k in names}, names)
    counts = {"G_1": 3, "G_2": 3, "Seg_de": 4}
    for k, net in state.nets.items():
        assert {int(b.num_batches_tracked) for b in net.modules()
                if isinstance(b, torch.nn.BatchNorm2d)} <= {counts.get(k)}, k
    assert_stats_close(state.nets["Seg_de"].state_dict(),
                       run["want"]["Seg_de"], "Seg_de")
    for k in ("G_1", "G_2", "Seg_de", "Dep_de"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(run["want"][k]), NET_LR[k], k)


def test_s2d_nd_4dis_later_phases_match_jax(run, no_onednn):
    """JAX's updated G_1 and G_2 loaded after the G_2 phase (the port's
    statistics kept): every metric and running statistic, and the twins
    after their two Adam steps by the three pooled checks."""
    model = port_model(_cfg4(), run["alphas"])
    state = model.init_state()
    want = run["want"]
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    for name, phase in model.PHASES:
        phase(model, state, ctx)
        if name == "G_2":
            for k in ("G_1", "G_2"):
                net = state.nets[k]
                net.load_state_dict({**want[k], **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        assert_stats_close(net.state_dict(), want[k], k)
    for k in ("Dis0_en", "Dis1_en"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(want[k]), NET_LR[k], k)


def test_s2d_nd_4dis_d_phase_matches_jax(no_onednn):
    """The twins' D phase from the same features on both sides: the summed
    BCE losses within 1e-4 relative and each twin's Adam step by the three
    pooled checks."""
    phase = dict(create_model(_cfg4()).PHASES)["D1"]
    m, losses, got, _, want = d_phase_vs_jax(
        _cfg4(), IMPORT, OPT_OF, phase, 0,
        lambda jm, p, s, o, key: jm._d_phase_4dis(p, s, o, None, None))
    for k, v in zip(("D_syn", "D_real"), losses):
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for k in ("Dis0_en", "Dis1_en"):
        _assert_params_close(got[k], want[k], NET_LR[k], k)
