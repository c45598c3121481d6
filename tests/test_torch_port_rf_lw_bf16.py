"""One bf16 ``rf_lw7`` train step of the port against the JAX package's
bf16 step, on the CPU, from the same fp32 weights and batch (ResNetLW (1,
1, 1, 1) at 64×96, batch 1; the helpers of
``tests/test_torch_port_rf_lw_step.py``). The losses are held within 3e-2
relative (the limit of the earlier slices' bf16 steps: the two frameworks
round bf16 at other places); parameters and Adam stay fp32. A file of its
own: the JAX bf16 step compiles for about a minute.
"""

import numpy as np
import pytest
import torch

from cycle_depth_estimation_tpu_torch.models import create_model
from tests.test_torch_port_rf_lw_step import (port_cfg, run_jax_step,
                                              torch_batch)


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def test_rf_lw7_bf16_step_matches_jax_bf16():
    run16 = run_jax_step("rf_lw7", dtype="bfloat16", seed=2)
    pm = create_model(port_cfg("rf_lw7", dtype="bfloat16"))
    state = pm.init_state()
    assert all(p.dtype == torch.float32 for net in state.nets.values()
               for p in net.parameters())
    _, m = pm.train_step(state, torch_batch(run16["batch"]))
    for k, want in run16["metrics"].items():
        if k.startswith("acc"):
            continue  # argmax over bf16 logits: ties fall either way
        assert np.isfinite(float(m[k])), k
        np.testing.assert_allclose(float(m[k]), want, rtol=3e-2, err_msg=k)
