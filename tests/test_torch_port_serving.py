"""The port's serving path against the JAX package, on the CPU: int8
calibration and the fused int8 generator, the test CLI, the default device,
and the rule that the port imports nothing of JAX."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models import quantization as jq
from cycle_depth_estimation_tpu.models.networks import (
    ResnetGenerator as JaxResnetGenerator,
)
from cycle_depth_estimation_tpu_torch import resolve_device
from cycle_depth_estimation_tpu_torch.models import quantization as pq
from cycle_depth_estimation_tpu_torch.models.networks import ResnetGenerator
from cycle_depth_estimation_tpu_torch.utils.weights import (
    resnet_generator_state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
N_BLOCKS = 2


def _cos(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def calibrated():
    """One JAX generator, its port twin, and both sides calibrated on the
    same structured batch."""
    calib = jq.synthetic_calibration_batch(1, 2, 32)
    jg = JaxResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS)
    variables = jg.init(jax.random.key(0), jnp.asarray(calib))
    params = jax.tree.map(np.asarray, variables["params"])
    g = ResnetGenerator(3, 3, ngf=8, n_blocks=N_BLOCKS).eval()
    g.load_state_dict(resnet_generator_state_dict_from_jax(params, N_BLOCKS,
                                                           False))
    jax_static = jq.calibrate(
        jq.Int8ResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS),
        jq.int8_generator_variables(variables["params"]), jnp.asarray(calib))
    port_static = pq.calibrate(
        pq.Int8ResnetGenerator(N_BLOCKS),
        pq.int8_generator_variables(g, device="cpu"),
        torch.from_numpy(pq.synthetic_calibration_batch(1, 2, 32)),
        device="cpu")
    return dict(calib=calib, g=g, jax_static=jax_static,
                port_static=port_static)


def _sites(q):
    out = {k: q[k] for k in ("conv_in", "down0_conv", "down1_conv",
                             "up0_conv", "up1_conv", "conv_out")}
    for i in range(N_BLOCKS):
        for c in ("conv1", "conv2"):
            out[f"block{i}.{c}"] = q[f"block{i}"][c]
    return out


def test_synthetic_calibration_batch_matches_jax():
    np.testing.assert_array_equal(
        pq.synthetic_calibration_batch(3, 2, 32),
        jq.synthetic_calibration_batch(3, 2, 32).transpose(0, 3, 1, 2))


def test_quantized_weights_match_jax_exactly(calibrated):
    jsites = _sites(calibrated["jax_static"]["qparams"])
    psites = _sites(calibrated["port_static"]["qparams"])
    for name, js in jsites.items():
        if name.startswith("up"):
            continue
        for key in ("kernel_q", "scale", "bias"):
            np.testing.assert_array_equal(psites[name][key].numpy(),
                                          np.asarray(js[key]), err_msg=name)


def test_calibrated_act_scales_match_jax(calibrated):
    jsites = _sites(calibrated["jax_static"]["qparams"])
    psites = _sites(calibrated["port_static"]["qparams"])
    for name, js in jsites.items():
        want = float(js["act_scale"])
        assert abs(psites[name]["act_scale"] - want) <= 1e-5 * want, name


def test_fused_int8_matches_jax_and_tracks_fp32(calibrated):
    x = calibrated["calib"]
    want = jq.fused_int8_apply(jq.fused_int8_variables(calibrated["jax_static"]),
                               jnp.asarray(x), n_blocks=N_BLOCKS)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = pq.fused_int8_apply(pq.fused_int8_variables(calibrated["port_static"]),
                              xt, n_blocks=N_BLOCKS, device="cpu")
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert _cos(_nhwc(got), want) >= 0.9999
    with torch.no_grad():
        y_fp = calibrated["g"](xt)
    assert _cos(got.float(), y_fp) > 0.999


def test_calibration_state_is_checked(calibrated):
    dynamic = pq.int8_generator_variables(calibrated["g"], device="cpu")
    with pytest.raises(ValueError):
        pq.fused_int8_variables(dynamic)
    with pytest.raises(ValueError):
        pq.calibrate(pq.Int8ResnetGenerator(N_BLOCKS),
                     calibrated["port_static"],
                     torch.zeros(1, 3, 32, 32), device="cpu")


def _write_pngs(folder, n, size=32):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
            os.path.join(folder, f"img{i}.png"))


def test_test_cli_writes_gallery(tmp_path):
    from cycle_depth_estimation_tpu_torch.models.networks import define_G
    from cycle_depth_estimation_tpu_torch.test import main

    data = tmp_path / "data"
    _write_pngs(data, 3)
    pth = tmp_path / "latest_net_G.pth"
    torch.save(define_G(3, 3, 8, "resnet_3blocks",
                        generator=torch.Generator().manual_seed(5)).state_dict(),
               pth)
    web_dir = main(["--dataroot", str(data), "--netG", "resnet_3blocks",
                    "--ngf", "8", "--fineSize", "32", "--device", "cpu",
                    "--num_test", "2", "--pth_path", str(pth),
                    "--results_dir", str(tmp_path / "results")])
    html = Path(web_dir, "index.html").read_text()
    images = sorted(os.listdir(Path(web_dir, "images")))
    assert images == ["img0_fake_B.png", "img0_real_A.png",
                      "img1_fake_B.png", "img1_real_A.png"]
    assert "img1_fake_B.png" in html and "img2" not in html


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    g = ResnetGenerator(3, 3, ngf=4, n_blocks=1)
    with pytest.raises(RuntimeError):
        pq.int8_generator_variables(g)


# the JAX stack, the JAX package, and the JAX repository's ``tools/`` (the
# port keeps its own copies of the tools it needs)
_FORBIDDEN = ("jax", "flax", "optax", "orbax", "cycle_depth_estimation_tpu",
              "tools")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "cycle_depth_estimation_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    port = REPO / "cycle_depth_estimation_tpu_torch"
    for new in ("models/refinenet.py", "models/rf_lw.py", "tools/__init__.py",
                "tools/save_kitti.py", "tools/eval_kitti.py",
                "utils/metrics.py", "models/s2d_base.py", "models/s2d_alt.py",
                "models/s2d_df.py", "models/s2d_nd.py",
                "models/semantic_trans.py", "models/semantic_trans_full.py",
                "models/ptq.py", "parallel/spatial.py",
                "parallel/pipeline.py"):
        assert port / new in files, new
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in _FORBIDDEN, f"{path.name} imports {mod}"
