"""The port's S2D step in bf16 and with ``--remat``, against its own fp32
step from one init, on the CPU at the smallest widths (DenseNet growth 8,
blocks (2, 2, 2, 2), ``mid_nc`` 64, ``g1_blocks`` 1), 192×192, batch 1:

- bf16 (every conv in bf16, parameters and Adam fp32, losses fp32): every
  loss finite and within 5e-2 relative of fp32's;
- ``--remat`` (the G_2 and R_D applications recomputed in backward), both
  at ``adam_eps`` 1e-3: losses within 1e-6 relative, the running
  statistics equal (each BatchNorm moved once per application), the
  parameters by ``tests/test_torch_port_s2d_step.py``'s three checks.
"""

import numpy as np
import pytest
import torch

from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from tests.test_torch_port_s2d_step import NET_LR, _assert_params_close

SMALL = dict(model="S2D", device="cpu", dense_block_config=[2, 2, 2, 2],
             g1_blocks=1, dense_growth_rate=8, s2d_mid_nc=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(h=192, w=192):
    g = torch.Generator().manual_seed(6)
    seg = torch.randint(0, 28, (1, h, w), generator=g)
    seg[:, :40] = 17
    return {"img_syn": torch.rand(1, 3, h, w, generator=g) * 2 - 1,
            "img_real": torch.rand(1, 3, h, w, generator=g) * 2 - 1,
            "seg_l_syn": seg,
            "seg_l_real": torch.randint(0, 28, (1, h, w), generator=g),
            "dep_l_syn": torch.rand(1, 1, h, w, generator=g) * 2 - 1,
            "depth_l_s": torch.randn(1, 4, h, w, generator=g).sign()}


def _step(**kw):
    model = create_model(apply_model_defaults(Config(**SMALL, **kw)))
    state = model.init_state()
    state, m = model.train_step(state, _batch())
    return state, {k: float(v) for k, v in m.items()}


def test_s2d_bf16_step_against_fp32():
    s32, m32 = _step()
    s16, m16 = _step(dtype="bfloat16")
    for k, v in m16.items():
        assert np.isfinite(v), k
        assert abs(v - m32[k]) <= 5e-2 * max(abs(m32[k]), 1e-6), (k, v,
                                                                  m32[k])
    conv = s16.nets["R_D"].seg_d.deconv[0]
    assert conv.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for net in s16.nets.values()
               for p in net.parameters())
    for opt in s16.optimizers.values():
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32


def test_s2d_remat_step_equals_plain():
    plain, m0 = _step(adam_eps=1e-3)
    remat, m1 = _step(adam_eps=1e-3, remat=True)
    for k, v in m0.items():
        assert abs(m1[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, m1[k], v)
    for k, net in plain.nets.items():
        sd, sd1 = net.state_dict(), remat.nets[k].state_dict()
        stats = [n for n in sd if n.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]
        assert stats
        for n in stats:
            torch.testing.assert_close(sd1[n], sd[n], rtol=0, atol=0)
        params = {n: v.numpy() for n, v in sd.items() if n not in stats}
        _assert_params_close({n: sd1[n].numpy() for n in params}, params,
                             NET_LR[k], k)
