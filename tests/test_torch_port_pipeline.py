"""The port's GPipe (``parallel/pipeline.py``) against the JAX package's,
on the CPU: ``stack_stage_params``'s layout; then, in one world of four
spawned gloo ranks, ``gpipe_apply`` over 4 stages (8 blocks, 4
microbatches) against JAX's output, bf16 blocks over an f32 input, dp×pp
on a (2, 2) mesh against JAX's dp×pp output, and the gradients of Σ y²
for the input and every block against the sequential trunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models.networks import (
    ResnetBlock as JaxResnetBlock,
)
from cycle_depth_estimation_tpu.parallel import make_mesh as jax_make_mesh
from cycle_depth_estimation_tpu.parallel.pipeline import (
    gpipe_apply as jax_gpipe_apply,
    stack_stage_params as jax_stack_stage_params,
)
from cycle_depth_estimation_tpu_torch.parallel import dryrun
from cycle_depth_estimation_tpu_torch.parallel.pipeline import (
    stack_stage_params,
)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    conv_weight_from_hwio,
)


def _block_sd(p):
    """A JAX ``ResnetBlock``'s params → the port block's state dict."""
    out = {}
    for conv, idx in (("conv1", 1), ("conv2", 5)):
        out[f"conv_block.{idx}.weight"] = torch.from_numpy(
            conv_weight_from_hwio(np.asarray(p[conv]["kernel"])))
        out[f"conv_block.{idx}.bias"] = torch.from_numpy(
            np.asarray(p[conv]["bias"]).copy())
    return out


def _jax_trunk(seed_x, key0, L, shape, names, M, data_axis=None,
               dtype=None, B=8):
    """tests/test_parallel.py's GPipe run: its blocks, input and output."""
    dim = 8
    block = JaxResnetBlock(dim) if dtype is None else \
        JaxResnetBlock(dim, dtype=dtype)
    x = jnp.asarray(np.random.RandomState(seed_x).rand(B, 8, 8, dim),
                    jnp.float32)
    blocks = [block.init(jax.random.key(key0 + i), x[:2])["params"]
              for i in range(L)]
    devices = jax.devices()[:int(np.prod(shape))]
    mesh = jax_make_mesh(shape, axis_names=names, devices=devices)
    y = jax_gpipe_apply(lambda p, h: block.apply({"params": p}, h),
                        jax_stack_stage_params(blocks, shape[-1]), x, mesh,
                        n_microbatches=M, data_axis=data_axis)
    return (torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy()),
            [_block_sd(jax.tree.map(np.asarray, p)) for p in blocks],
            np.asarray(y, np.float32), y.dtype)


def test_stack_stage_params_matches_jax_layout():
    rng = np.random.RandomState(0)
    blocks = [{"w": rng.rand(3, 2).astype(np.float32),
               "b": rng.rand(5).astype(np.float32)} for _ in range(8)]
    want = jax_stack_stage_params(blocks, 4)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in blocks], 4)
    for k in ("w", "b"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(AssertionError):
        stack_stage_params(blocks[:6], 4)


@pytest.fixture(scope="module")
def world():
    pp = _jax_trunk(2, 0, 8, [4], ("stage",), 4)
    bf16 = _jax_trunk(5, 20, 4, [2], ("stage",), 2, dtype=jnp.bfloat16,
                      B=4)
    dpp = _jax_trunk(4, 10, 8, [2, 4], ("data", "stage"), 4, "data")
    stage4 = {"mesh_shape": [4], "mesh_axes": ["stage"]}
    cases = {
        "pp": (dryrun.pipeline_case, (pp[0], 8, stage4, 4, None, pp[1])),
        "bf16": (dryrun.pipeline_case, (bf16[0], 4, stage4, 2, None,
                                        bf16[1], torch.bfloat16, False)),
        "dp×pp": (dryrun.pipeline_case, (
            dpp[0], 8, {"mesh_shape": [2, 2],
                        "mesh_axes": ["data", "stage"]}, 4, "data",
            dpp[1])),
    }
    got = dryrun.spawn(dryrun.run_cases, 4, (cases,), timeout=240)
    one = {"pp": dryrun.sequential_trunk(pp[0], 8, pp[1]),
           "dp×pp": dryrun.sequential_trunk(dpp[0], 8, dpp[1])}
    return dict(ranks=got, one=one, jax={"pp": pp, "bf16": bf16,
                                         "dp×pp": dpp})


@pytest.mark.parametrize("case", ["pp", "dp×pp"])
def test_gpipe_matches_jax(world, case):
    want = world["jax"][case][2]
    for r in world["ranks"]:
        np.testing.assert_allclose(
            r[case]["y"].numpy().transpose(0, 2, 3, 1), want, atol=2e-5,
            rtol=1e-4)


def test_gpipe_bf16_blocks_over_f32_input(world):
    _, _, want, dtype = world["jax"]["bf16"]
    for r in world["ranks"]:
        y = r["bf16"]["y"]
        assert str(y.dtype).split(".")[-1] == str(dtype)
        np.testing.assert_allclose(y.float().numpy().transpose(0, 2, 3, 1),
                                   want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ["pp", "dp×pp"])
def test_gpipe_gradients_equal_the_sequential_trunk(world, case):
    want = world["one"][case]
    big = max(float(g.abs().max()) for b in want["grads"] for g in b.values())
    for r in world["ranks"]:
        got = r[case]
        torch.testing.assert_close(got["y"], want["y"], atol=2e-5, rtol=1e-4)
        dx = float((got["dx"] - want["dx"]).abs().max())
        assert dx <= 1e-5 * float(want["dx"].abs().max())
        for i, (gb, wb) in enumerate(zip(got["grads"], want["grads"])):
            for k, g in wb.items():
                assert float((gb[k] - g).abs().max()) <= 1e-5 * big, (i, k)
        # each rank ran its stage's blocks: two InstanceNorms a block a
        # microbatch (none launch a kernel on the CPU)
        assert got["launches"] == [0, 0]
