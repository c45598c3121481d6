"""``--parallel sp`` for the CycleGAN lineage (``parallel/spatial.py``)
against one process and the JAX package, on the CPU, in one world of four
spawned gloo ranks: every row split the U-Nets, the PixelGAN, the
resize_conv generator and the T2Net/SegCycle nets add (nearest upsample,
both 2×2 pools, the k4 s2 transposed conv, the skip and Inception
concatenations, BatchNorm over ``data`` × ``model``, dropout, ranks that
hold no row of a plane) at M = 2 and 4; the masked means and the GAN/L1
means on uneven rows; the cycle_gan (unet_128, pixel D, BatchNorm),
pix2pix, seg_cycle and seg steps against the port's one process; the
U-Net and T2Net forwards against JAX's H-sharded ones; and JAX's
H-sharded SegCycle eval step against the port's sp eval step (JAX's
H-sharded train step takes ~120 s to compile on the CPU; the eval step
~20 s, and the port's sp train step is held against its one process,
whose step ``test_torch_port_seg_cycle.py`` holds against JAX's). The
one-process and JAX runs go on while the ranks work.
"""

import threading

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
from cycle_depth_estimation_tpu.models import networks as jn
from cycle_depth_estimation_tpu.models import seg_network as jsn
from cycle_depth_estimation_tpu.parallel import host_shard_batch as jax_hsb
from cycle_depth_estimation_tpu.parallel import replicated as jax_replicated
from cycle_depth_estimation_tpu.parallel.spatial import (
    make_2d_mesh as jax_make_2d_mesh,
    shard_spatial as jax_shard_spatial,
)
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.data import create_dataset, image_height
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.parallel import dryrun
from cycle_depth_estimation_tpu_torch.parallel.mesh import (row_range,
                                                            spatial_rows)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net)

import torch_port_spatial_ranks as ranks
from test_torch_port_domain_data import write_domain_files
from test_torch_port_seg_cycle import jax_state_of

LAYOUTS = {2: {"mesh_shape": [2, 2]}, 4: {"mesh_shape": [1, 4]}}


def _images(keys, size, seed=5):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(2, 3, size, size, generator=g) * 2 - 1
            for k in keys}


MODELS = {
    "cycle_gan unet_128 pixel batch": (
        dict(model="cycle_gan", net_g="unet_128", net_d="pixel",
             norm="batch", ngf=4, ndf=4, fine_size=128, batch_size=2,
             pool_size=2, d_steps_per_g=2),
        _images(("img_source", "img_target"), 128)),
    "pix2pix unet_128 dropout": (
        {**dryrun.SP_PIX2PIX, "batch_size": 2}, _images(("A", "B"), 128)),
    "seg_cycle": ({**dryrun.SP_SEG_CYCLE, "batch_size": 2},
                  dryrun.domain_batch_of(2, 96, 96)),
    "seg": (dict(model="seg", net_g="resnet_3blocks", ngf=4, fine_size=96,
                 batch_size=2), dryrun.domain_batch_of(2, 96, 96, seed=4)),
}


def _s2t_output():
    """The seg model's translator output on its batch, in one process."""
    cfg_kw, batch = MODELS["seg"]
    cfg = apply_model_defaults(Config(device="cpu", **cfg_kw), set(cfg_kw))
    s2t = create_model(cfg).init_state().nets["s2t"].eval()
    with torch.no_grad():
        return s2t(batch["img_source"])


def _means_inputs():
    g = torch.Generator().manual_seed(13)
    labels = torch.randint(0, 5, (2, 31, 7), generator=g)
    labels[0, :9] = 255       # rank 0's rows at M = 2 mostly ignored
    return (torch.randn(2, 5, 31, 7, generator=g), labels,
            torch.randn(2, 1, 31, 7, generator=g),
            torch.randn(2, 1, 31, 7, generator=g))


def _nhwc(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))


def _jax_forward(kind, x):
    """JAX's forward of ``ranks.build_net(kind)``'s weights on ``x``
    sharded over a (2, 4) mesh, H over 'model' (the U-Net in train mode,
    its BatchNorm statistics over the whole batch)."""
    net = ranks.build_net(kind)
    params, stats = jax_variables_from_net(net)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    mesh = jax_make_2d_mesh(2, 4)
    variables = jax.device_put(jax.tree.map(jnp.asarray, variables),
                               jax_replicated(mesh))
    xs = jax_shard_spatial(mesh, jnp.asarray(_nhwc(x)))
    if kind == "unet":
        module = jn.UnetGenerator(output_nc=3, num_downs=7, ngf=4,
                                  norm="batch")
        y, _ = jax.jit(lambda v, x: module.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, xs)
    else:
        module = jsn.UNetGenerator(ngf=4, norm="instance")
        y = jax.jit(lambda v, x: module.apply(v, x, "real")[-1])(variables,
                                                                   xs)
    return np.asarray(y)


def _jax_seg_cycle_eval():
    """The metrics of JAX's SegCycle eval step, its batch's height over
    'model' of a (1, 2) mesh, from the port's seeded init."""
    cfg_kw, batch = MODELS["seg_cycle"]
    cfg = apply_model_defaults(Config(device="cpu", **cfg_kw), set(cfg_kw))
    state = create_model(cfg).init_state()
    jmodel = jax_create_model(jax_apply_model_defaults(JaxConfig(**cfg_kw),
                                                       set(cfg_kw)))
    jstate = jax_state_of(jmodel, state, {
        "G": ("G_A", "G_B", "encoderA", "encoderB", "decoderA", "decoderB"),
        "D": ("D_A", "D_B")}, {k: (96, 96, 3) for k in ("fake_A", "fake_B")})
    mesh = jax_make_2d_mesh(1, 2, devices=jax.devices()[:2])
    jb = {k: (_nhwc(v) if v.dim() == 4 else v.numpy().astype(np.int32))
          for k, v in batch.items()}
    metrics, _ = jmodel.eval_step(
        jax.device_put(jstate, jax_replicated(mesh)),
        jax_hsb(mesh, jb, spatial_axis="model"))
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def world():
    ops = ranks.net_op_inputs()
    means = _means_inputs()
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(6)
                   ) * 2 - 1
    pin = _s2t_output()
    cases = {}
    for m, layout in LAYOUTS.items():
        for name, (xo, w) in ops.items():
            cases[f"{name} M={m}"] = (ranks.net_op_case, (name, xo, w, layout))
        cases[f"means M={m}"] = (ranks.means_case, (*means, layout))
        for name, (cfg, batch) in MODELS.items():
            cases[f"{name} M={m}"] = (dryrun.model_step, (
                cfg, batch, {**layout, "parallel": "sp"}, None, 1e-2, 1,
                False, True))
        cases[f"seg pinned M={m}"] = (ranks.pinned_seg_step, (
            *MODELS["seg"], {**layout, "parallel": "sp"}, pin))
        cases[f"seg_cycle eval M={m}"] = (ranks.eval_step_case, (
            MODELS["seg_cycle"][0], MODELS["seg_cycle"][1],
            {**layout, "parallel": "sp"}))
    cases["unet forward"] = (ranks.net_forward_case, ("unet", x, LAYOUTS[4]))
    cases["t2net forward"] = (ranks.net_forward_case,
                              ("t2net", x[:, :, :96], LAYOUTS[4], "real"))
    world = {}
    spawned = threading.Thread(target=lambda: world.update(
        ranks=dryrun.spawn(dryrun.run_cases, 4, (cases,), timeout=240)))
    spawned.start()
    threads = torch.get_num_threads()
    # one thread, as each rank has: the one process's multi-threaded
    # weight gradients vary in their last bits from run to run
    torch.set_num_threads(1)
    try:
        one = _one_process(ops, means, x, pin)
    finally:
        torch.set_num_threads(threads)
        spawned.join()
    assert "ranks" in world, "the ranks failed (their log is above)"
    return dict(ranks=world["ranks"], **one)


def _one_process(ops, means, x, pin):
    one = {name: ranks.net_op_reference(name, xo, w)
           for name, (xo, w) in ops.items()}
    one["means"] = ranks.means_case(*means, None)
    for name, (cfg, batch) in MODELS.items():
        one[name] = dryrun.model_step(cfg, batch, {}, None, 1e-2,
                                      first_grads=True)
    one["seg pinned"] = ranks.pinned_seg_step(*MODELS["seg"], {}, pin)
    jax_y = {"unet forward": _jax_forward("unet", x),
             "t2net forward": _jax_forward("t2net", x[:, :, :96])}
    return dict(one=one, jax_y=jax_y, jax_seg_cycle=_jax_seg_cycle_eval())


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(ranks.net_op_modules()))
def test_each_new_split_equals_the_whole_plane(world, name, m):
    want = world["one"][name]
    for r in world["ranks"]:
        got = r[f"{name} M={m}"]
        assert _rel(got["y"], want["y"]) <= 1e-5, "y"
        assert _rel(got["dx"], want["dx"]) <= 1e-5, "dx"
        big = max((float(g.abs().max()) for g in want["grads"].values()),
                  default=0.0)
        for k, g in want["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * big, k
        for k, b in want["buffers"].items():   # BatchNorm's statistics
            torch.testing.assert_close(got["buffers"][k], b, atol=1e-6,
                                       rtol=1e-5, msg=k)


def test_rows_split_unevenly_and_some_ranks_hold_none():
    # the planes the cases above are held on: uneven splits and empty ones
    assert [row_range(15, 2, r) for r in range(2)] == [(0, 7), (7, 15)]
    assert [row_range(2, 4, r) for r in range(4)] == [
        (0, 0), (0, 1), (1, 1), (1, 2)]
    assert [row_range(1, 2, r) for r in range(2)] == [(0, 0), (0, 1)]


@pytest.mark.parametrize("m", [2, 4])
def test_masked_means_and_losses_are_global_on_uneven_rows(world, m):
    want = world["one"]["means"]
    for r in world["ranks"]:
        got = r[f"means M={m}"]
        for k, v in want["values"].items():
            assert got["values"][k] == pytest.approx(v, rel=1e-6), k
        assert _rel(got["dz"], want["dz"]) <= 1e-5
        assert _rel(got["da"], want["da"]) <= 1e-5


# the steps whose first gradients move past 1e-5 of the largest under
# any layout of more than one rank, the height split or not, and why: the
# BatchNorm U-Net and PixelGAN of cycle_gan take their statistics from
# torch's fused op in one process and from the two-pass global sums on
# ranks (9.2e-5, the same under --mesh_shape 2 1, 1 2 and 2 2: measured);
# T2Net's step moves by 3.5e-4 in one process when its frozen
# translator's output moves by the sp forward's rounding (5e-7), so its
# gradients are held with that output pinned (``ranks.pinned_seg_step``)
LOSSES_AND_PARAMETERS_ONLY = ("cycle_gan unet_128 pixel batch", "seg")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("model", [*MODELS, "seg pinned"])
def test_sp_step_equals_one_process(world, model, m):
    got = [r[f"{model} M={m}"] for r in world["ranks"]]
    dryrun.sp_steps_apart(world["one"][model], got, f"{model} M={m}",
                          grads=model not in LOSSES_AND_PARAMETERS_ONLY)
    # the ranks' parameters are equal, the split InstanceNorm entries ran
    # wherever the nets hold an InstanceNorm (on the CPU none launches)
    for name, sd in got[0]["params"].items():
        for k, v in sd.items():
            assert torch.equal(v, got[-1]["params"][name][k]), (name, k)
    assert got[0]["launches"] == [(0, 0)]


@pytest.mark.parametrize("case", ["unet forward", "t2net forward"])
def test_sp_forwards_match_jax_h_sharded(world, case):
    for r in world["ranks"]:
        np.testing.assert_allclose(_nhwc(r[case]), world["jax_y"][case],
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("m", [2, 4])
def test_sp_seg_cycle_eval_step_matches_the_jax_h_sharded_step(world, m):
    want = world["jax_seg_cycle"]
    for r in world["ranks"]:
        got = r[f"seg_cycle eval M={m}"]
        for k, v in want.items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-3), k
        # the visuals' height gathered whole (images and label maps), of
        # this rank's rows of the batch
        n = 2 // got["data_size"]
        assert got["visuals"]["fake_B"].shape == (n, 3, 96, 96)
        assert got["visuals"]["segAreal"].shape == (n, 96, 96)
        i = got["data_rank"] * n
        assert torch.equal(got["visuals"]["lab_A"],
                           MODELS["seg_cycle"][1]["lab_source"][i:i + n])


def test_synthia_batch_rows_and_the_loaders_height(tmp_path):
    opts = write_domain_files(str(tmp_path), size=(160, 48))
    cfg = apply_model_defaults(Config(model="seg_cycle", fine_size=48,
                                      **opts), {"model", "fine_size"})
    assert image_height(cfg) == 48
    assert image_height(cfg.replace(fine_size=256)) == 192  # the default
    assert image_height(Config(model="pix2pix", fine_size=128)) == 128
    ds = create_dataset(cfg, "train")
    items = [ds[i] for i in range(2)]
    batch = {k: torch.stack([torch.as_tensor(np.asarray(it[k]))
                             for it in items])
             for k in items[0] if not isinstance(items[0][k], str)}
    assert batch["img_source"].shape[2:] == (48, 160)
    assert batch["lab_source"].shape[1:] == (48, 160)
    for m in (2, 4):
        for r in range(m):
            a, b = row_range(48, m, r)
            part = spatial_rows(batch, size=m, index=r)
            for k, v in batch.items():
                if v.dim() >= 3:
                    assert torch.equal(part[k], v.narrow(v.dim() - 2, a,
                                                         b - a)), k
                else:
                    assert torch.equal(part[k], v), k


def test_sp_takes_the_loaders_height_for_its_divisibility_check():
    from cycle_depth_estimation_tpu_torch.config import parse_args
    from cycle_depth_estimation_tpu_torch.parallel.collectives import Groups
    from cycle_depth_estimation_tpu_torch.train import check_layout

    cfg = parse_args(["--model", "seg_cycle", "--parallel", "sp",
                      "--device", "cpu"], is_train=True)
    assert (cfg.fine_size, image_height(cfg)) == (256, 192)
    # 192 rows divide by 3 where --fine_size 256 would not
    check_layout(cfg, Groups(model=object(), model_size=3, spatial=True),
                 distributed=True)
    with pytest.raises(SystemExit, match=r"the synthia loader's height 192 "
                       r"\(--fine_size 256\) is not divisible by the model "
                       r"axis \(5\)"):
        check_layout(cfg, Groups(model=object(), model_size=5, spatial=True),
                     distributed=True)
