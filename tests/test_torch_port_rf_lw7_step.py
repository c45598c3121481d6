"""One RefineNet-LW ``rf_lw7`` train step of the port against the JAX
package's, on the CPU (ResNetLW (1, 1, 1, 1), the ``seg2_0`` head and the
never-stepped ``depth`` block at 64×96, batch 1, from the same weights and
batch), and its ``eval_step`` from JAX's updated state. The helpers and
limits are those of ``tests/test_torch_port_rf_lw_step.py``; the bf16 step
is ``tests/test_torch_port_rf_lw_bf16.py``.
"""

import numpy as np
import pytest
import torch

from cycle_depth_estimation_tpu_torch.models import create_model
from tests.test_torch_port_rf_lw_step import (assert_eval_matches,
                                              assert_step_matches, port_cfg,
                                              run_jax_step)


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return run_jax_step("rf_lw7")


def test_rf_lw7_step_matches_jax(run):
    state = assert_step_matches("rf_lw7", run)
    # depth is built and never stepped, on both sides
    init = create_model(port_cfg("rf_lw7")).init_state().nets["depth"]
    for key, t in state.nets["depth"].state_dict().items():
        assert torch.equal(t, init.state_dict()[key]), key
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(run["sds"]["depth"][key].numpy(),
                                          t.numpy(), err_msg=key)
    assert not state.optimizers["depth"].state


def test_rf_lw7_eval_step_matches_jax(run):
    assert_eval_matches("rf_lw7", run)
