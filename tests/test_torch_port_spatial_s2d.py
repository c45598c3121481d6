"""``--parallel sp`` for S2D, S2D_base and S2D_alt
(``parallel/spatial_s2d.py``) against one process and the JAX package, on
the CPU, in one world of four spawned gloo ranks:

- every row split the three models add, at M = 2 and 4 against the whole
  plane (forward, the inputs' and parameters' gradients, BatchNorm's
  statistics): the dilated PSP-head convs, bilinear ×2 with corners
  aligned, the attention gates' global mean, the label map's nearest half,
  the dropout discriminator with its keep-masks, and cases of the
  existing ops on these nets' planes (the k2 s2 transposed conv, the 7×7
  s2 stem, the 2×2 pools, the dense, dual-residual, PSP and decoder
  blocks), on planes that split unevenly and leave a rank no row;
- G_2 ('R') then R_D at the JAX sp check's small config, the height over
  four ranks, against JAX's H-sharded forward of the same two nets, in
  eval mode with random BatchNorm statistics. In train mode the two
  frameworks' fp32 forwards of these nets are each ~1e-4 from a float64
  forward (measured: JAX 1.6e-4, the port 8.3e-5 at the refined depth,
  BatchNorm over 2-sample planes amplifying the convs' rounding), which
  the 2e-5 bar cannot separate; train-mode BatchNorm under sp is held
  against the port's one process by the op and step cases;
- each model's sp step held phase by phase against the port's one
  process (``dryrun.phase_by_phase``: each phase from the one-process
  input before it, Adam's eps 1e-3, the same keep-masks): S2D at M = 4,
  S2D ``--remat`` at M = 2 (the recompute runs the exchanges again),
  S2D_base ``--dis_seg`` and S2D_alt at M = 2 (their planes split
  unevenly from the PSP head on), each ``--mesh_shape`` 2 2 where M = 2;
- S2D_base's class-weighted cross-entropy and the accuracy on a 31-row
  plane (uneven at M = 2 and 4), S2D's sp eval step and its gathered
  visuals, and the ``try`` loader's height and rows.

S2D runs at 192² (its FD critics emit empty maps below 192 rows);
S2D_base and S2D_alt, which have no such critic, at 48×64. The one-process
references and the JAX compile run while the ranks work.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.parallel import replicated as jax_replicated
from cycle_depth_estimation_tpu.parallel.spatial import (
    make_2d_mesh as jax_make_2d_mesh,
    shard_spatial as jax_shard_spatial,
)
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.data import image_height
from cycle_depth_estimation_tpu_torch.parallel import dryrun
from cycle_depth_estimation_tpu_torch.parallel.mesh import (row_range,
                                                            spatial_rows)

import torch_port_spatial_ranks as net_ranks
import torch_port_spatial_s2d_ranks as ranks

LAYOUTS = {2: {"mesh_shape": [2, 2]}, 4: {"mesh_shape": [1, 4]}}
# test_torch_port_s2d_step.py's smallest S2D widths
S2D = dict(model="S2D", dense_block_config=[2, 2, 2, 2], g1_blocks=1,
           dense_growth_rate=8, s2d_mid_nc=64, adam_eps=1e-3)
STEPS = {
    "S2D M=4": ({**S2D, "batch_size": 1}, (1, 192, 192), 4),
    "S2D --remat M=2": ({**S2D, "batch_size": 2, "remat": True},
                        (2, 192, 192), 2),
    "S2D_base --dis_seg M=2": (
        dict(model="S2D_base", batch_size=2, ndf=8, g1_blocks=1,
             dense_block_config=[2, 2, 2, 2], dis_seg=True), (2, 48, 64), 2),
    "S2D_alt M=2": (dict(model="S2D_alt", batch_size=2), (2, 48, 64), 2),
}
EVAL = ({**S2D, "batch_size": 2}, dryrun.s2d_batch_of(2, 192, 192, seed=4))
FORWARD_X = np.random.RandomState(3).rand(2, 3, 96, 64).astype(np.float32)


def _nhwc(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))


def _jax_trunk_refiner():
    """JAX's G_2 ('R') and R_D, eval mode, on ``FORWARD_X`` with its
    height over 'model' of a (1, 4) mesh, from the port's weights and
    statistics: R_D's outputs, flat, NHWC."""
    g2, rd = ranks.build_trunk_and_refiner()
    sd = {k: {n: v.detach().numpy().copy() for n, v in
              net.state_dict().items()} for k, net in (("g2", g2),
                                                       ("rd", rd))}
    cfg = ranks.SMALL_NETS
    variables = {"g2": ti.import_general_net(
        sd["g2"], block_config=cfg["block_config"]),
        "rd": ti.import_rdep(sd["rd"])}
    trunk = jsn.GeneralNet(mid_nc=cfg["mid_nc"],
                           growth_rate=cfg["growth_rate"],
                           block_config=cfg["block_config"])
    refiner = jsn.RDep(base_c=cfg["mid_nc"])

    def forward(v, x):
        psp, feats = trunk.apply(v["g2"], x, "R", train=False)
        return jax.tree.leaves(refiner.apply(v["rd"], feats, psp,
                                             train=False))

    mesh = jax_make_2d_mesh(1, 4, devices=jax.devices()[:4])
    variables = jax.device_put(jax.tree.map(jnp.asarray, variables),
                               jax_replicated(mesh))
    x = jax_shard_spatial(mesh, jnp.asarray(FORWARD_X.transpose(0, 2, 3, 1)))
    return [np.asarray(y) for y in jax.jit(forward)(variables, x)]


@pytest.fixture(scope="module")
def world():
    ops = ranks.op_inputs()
    cases = {}
    for m, layout in LAYOUTS.items():
        for name, (xs, w, *masks) in ops.items():
            cases[f"{name} M={m}"] = (ranks.op_case,
                                      (name, xs, w, layout, *masks))
    means = ranks.weighted_means_inputs()
    for m, layout in LAYOUTS.items():
        cases[f"weighted means M={m}"] = (ranks.weighted_means_case,
                                          (*means, layout))
    cases["trunk refiner"] = (ranks.trunk_refiner_case,
                              (torch.from_numpy(FORWARD_X), LAYOUTS[4]))
    for name, (cfg, shape, m) in STEPS.items():
        cases[name] = (dryrun.phase_by_phase, (
            cfg, dryrun.s2d_batch_of(*shape),
            {**LAYOUTS[m], "parallel": "sp"}, 1e-3))
    cases["S2D eval M=2"] = (net_ranks.eval_step_case,
                             (*EVAL, {**LAYOUTS[2], "parallel": "sp"}))
    world = {}
    spawned = threading.Thread(target=lambda: world.update(
        ranks=dryrun.spawn(dryrun.run_cases, 4, (cases,), timeout=300)))
    spawned.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: ranks.op_reference(name, xs, w, *masks)
               for name, (xs, w, *masks) in ops.items()}
        one["S2D eval"] = net_ranks.eval_step_case(*EVAL, {})
        one["weighted means"] = ranks.weighted_means_case(*means, None)
        jax_y = _jax_trunk_refiner()
    finally:
        torch.set_num_threads(threads)
        spawned.join()
    assert "ranks" in world, "the ranks failed (their log is above)"
    return dict(ranks=world["ranks"], one=one, jax_y=jax_y)


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", [*ranks.op_modules(), ranks.DROP_CASE])
def test_each_s2d_row_op_equals_the_whole_plane(world, name, m):
    want = world["one"][name]
    for r in world["ranks"]:
        got = r[f"{name} M={m}"]
        assert _rel(got["y"], want["y"]) <= 1e-5, "y"
        for i, (g, d) in enumerate(zip(got["dx"], want["dx"])):
            assert _rel(g, d) <= 1e-5, f"dx{i}"
        big = max((float(g.abs().max()) for g in want["grads"].values()),
                  default=0.0)
        for k, g in want["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * big, k
        for k, b in want["buffers"].items():   # BatchNorm's statistics
            torch.testing.assert_close(got["buffers"][k], b, atol=1e-6,
                                       rtol=1e-5, msg=k)


@pytest.mark.parametrize("m", [2, 4])
def test_class_weighted_ce_and_accuracy_are_global_on_uneven_rows(world, m):
    want = world["one"]["weighted means"]
    for r in world["ranks"]:
        got = r[f"weighted means M={m}"]
        for k, v in want["values"].items():
            assert got["values"][k] == pytest.approx(v, rel=1e-6), k
        assert _rel(got["dz"], want["dz"]) <= 1e-5


def test_the_op_planes_split_unevenly_and_leave_ranks_none():
    # 7 rows: (3, 4) and (1, 2, 2, 2); 15: (7, 8); 3 at M = 4: a rank
    # without a row; bilinear ×2 of 3 rows: rank 0 holds output rows and
    # none of their input
    assert [row_range(7, 4, r) for r in range(4)] == [
        (0, 1), (1, 3), (3, 5), (5, 7)]
    assert [row_range(15, 2, r) for r in range(2)] == [(0, 7), (7, 15)]
    assert row_range(3, 4, 0) == (0, 0) and row_range(6, 4, 0) == (0, 1)


def test_sp_g2_rd_forward_matches_jax_h_sharded(world):
    want = world["jax_y"]
    for r in world["ranks"]:
        got = r["trunk refiner"]
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            np.testing.assert_allclose(_nhwc(g), w, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", list(STEPS))
def test_sp_step_phase_by_phase_equals_one_process(world, case):
    phases = {}
    for r in world["ranks"]:
        for ph in r[case]:
            phases[ph["phase"]] = ph
            bad = {k: v for k, v in ph["losses"].items() if v > 1e-4}
            assert not bad, (ph["phase"], bad)
            for net, st in ph["nets"].items():
                assert st["ok"], (ph["phase"], net, st)
    want = {"S2D": ["g2", "g1", "rd_real", "rd_syn", "fd"],
            "S2D_base": ["real", "G", "frozen", "Seg", "Dep", "D"],
            "S2D_alt": ["G", "Feature", "Seg", "Dep", "D"]}[case.split()[0]]
    assert list(phases) == want
    # each phase updated its nets: the split run moved them
    assert all(ph["nets"] for ph in phases.values())


def test_sp_s2d_eval_step_gathers_whole_visuals(world):
    want = world["one"]["S2D eval"]
    for r in world["ranks"]:
        got = r["S2D eval M=2"]
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-4), k
        n = 2 // got["data_size"]
        i = got["data_rank"] * n
        assert got["visuals"]["syn_dep_ref"].shape == (n, 1, 192, 192)
        assert got["visuals"]["real_seg_pre"].shape == (n, 192, 192)
        torch.testing.assert_close(got["visuals"]["syn_dep_ref"],
                                   want["visuals"]["syn_dep_ref"][i:i + n],
                                   atol=1e-5, rtol=1e-4)
        assert torch.equal(got["visuals"]["syn_seg_l"],
                           EVAL[1]["seg_l_syn"][i:i + n])


def test_try_batch_rows_and_the_loaders_height():
    from cycle_depth_estimation_tpu_torch.config import parse_args
    from cycle_depth_estimation_tpu_torch.parallel.collectives import Groups
    from cycle_depth_estimation_tpu_torch.train import check_layout

    cfg = apply_model_defaults(Config(model="S2D"), {"model"})
    assert (cfg.dataset_mode, image_height(cfg)) == ("try", 192)
    batch = dryrun.s2d_batch_of(2, 48, 30)
    for m in (2, 4):
        for r in range(m):
            a, b = row_range(48, m, r)
            part = spatial_rows(batch, size=m, index=r)
            for k in ("img_syn", "seg_l_syn", "dep_l_syn", "depth_l_s"):
                v = batch[k]
                assert torch.equal(part[k], v.narrow(v.dim() - 2, a, b - a))
    cfg = parse_args(["--model", "S2D", "--parallel", "sp", "--device",
                      "cpu", "--fine_size", "256"], is_train=True)
    assert image_height(cfg) == 192
    check_layout(cfg, Groups(model=object(), model_size=3, spatial=True),
                 distributed=True)
    with pytest.raises(SystemExit, match=r"the try loader's height 192 "
                       r"\(--fine_size 256\) is not divisible by the model "
                       r"axis \(5\)"):
        check_layout(cfg, Groups(model=object(), model_size=5, spatial=True),
                     distributed=True)


def test_a_row_split_net_runs_whole_planes_outside_sp():
    """Rank 0's in-loop KITTI validation runs the nets alone, with no
    spatial groups active: a net laid out for sp then runs whole planes."""
    from cycle_depth_estimation_tpu_torch.models.s2d_networks import G1
    from cycle_depth_estimation_tpu_torch.parallel.spatial import spatial

    torch.manual_seed(0)
    net = G1(n_blocks=1).eval()
    x = torch.rand(1, 3, 32, 32)
    with torch.no_grad():
        want = net(x)
        spatial(net, object())   # a group no collective is made on
        assert type(net).__name__ == "SpatialG1"
        assert torch.equal(net(x), want)
