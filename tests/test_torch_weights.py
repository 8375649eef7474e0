"""flax → torch weight carry-over, and the port's independence from the
JAX package."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from de6d_tpu_torch import weights
from de6d_tpu_torch.models.model_utils.layers import ConvTranspose
from torch_fixtures import build_pair, flatten_variables

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conv_transpose_flip(stride):
    """flax ConvTranspose (kernel == stride) equals the torch layer with
    the flipped, transposed kernel; stride 1 alone would hide a missing
    flip. Tolerance: fp32 sums over 16 input channels."""
    rng = np.random.RandomState(stride)
    cin, cout = 16, 8
    x = rng.randn(2, 5, 7, cin).astype(np.float32)  # NHWC
    mod = fnn.ConvTranspose(cout, (stride, stride), strides=(stride, stride),
                            use_bias=False)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))

    layer = ConvTranspose(cin, cout, stride)
    weights.load_into(layer, flatten_variables(variables))
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 5 * stride, 7 * stride, cout)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_flat():
    jmodel, tmodel, *_ = build_pair(
        str(ROOT / "configs/kitti_models/pointpillar_tiny.yaml")
    )
    pts = jnp.zeros((1, 256, 4), jnp.float32)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {"points": pts}
    )
    return flatten_variables(init), tmodel


@pytest.mark.parametrize("fault", ["none", "extra_key", "missing_key",
                                   "bad_shape"])
def test_flax_to_torch_checks_every_key(tiny_flat, fault):
    flat, tmodel = tiny_flat
    flat = dict(flat)
    if fault == "extra_key":
        flat["params/dense_head/unused/kernel"] = np.zeros(3, np.float32)
    elif fault == "missing_key":
        del flat["batch_stats/vfe/PFNLayer_0/bn/var"]
    elif fault == "bad_shape":
        k = "params/dense_head/conv_cls/bias"
        flat[k] = np.zeros(flat[k].shape[0] + 1, np.float32)
    if fault == "none":
        sd = weights.flax_to_torch(flat, tmodel)
        assert set(sd) == set(tmodel.state_dict())
        w = flat["params/backbone_2d/ConvBlock_0/Conv_0/kernel"]
        np.testing.assert_array_equal(
            sd["backbone_2d.ConvBlock_0.Conv_0.weight"].numpy(),
            w.transpose(3, 2, 0, 1),
        )
    else:
        with pytest.raises(ValueError):
            weights.flax_to_torch(flat, tmodel)


def test_bench_assets_load_into_full_model():
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from torch_fixtures import spec_kwargs

    cfg = cfg_from_yaml_file(ROOT / "configs/kitti_models/pointpillar.yaml")
    model = build_network(cfg.MODEL, 3, DatasetSpec(**spec_kwargs(cfg)),
                          device="cpu")
    flat = weights.load_flax_npz(ROOT / "bench_assets/pointpillar_params.npz")
    assert len(flat) == 106
    sd = weights.flax_to_torch(flat, model)
    assert len(sd) == 106
    model.load_state_dict(sd, strict=True)


def test_det6d_bench_assets_load_into_full_model():
    """Every one of the 225 flax arrays (``sa_modules_<i>`` list members
    included) lands in the port's Det6D, every shape checked."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )

    cfg = cfg_from_yaml_file(ROOT / "configs/kitti_models/det6d_car.yaml")
    model = build_network(cfg.MODEL, 1, DatasetSpec(
        class_names=tuple(cfg.CLASS_NAMES), point_feature_dim=4,
        point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)),
        device="cpu")
    flat = weights.load_flax_npz(ROOT / "bench_assets/det6d_car_params.npz")
    assert len(flat) == 225
    sd = weights.flax_to_torch(flat, model)
    assert len(sd) == 225 == len(model.state_dict())
    np.testing.assert_array_equal(
        sd["backbone_3d.sa_modules.1.Dense_0.weight"].numpy(),
        flat["params/backbone_3d/sa_modules_1/Dense_0/kernel"].T)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("yaml,arrays,probe", [
    ("3dssd_car", 211, "backbone_3d/sa_modules_2/SharedMLP_3/Dense_0"),
    ("3dssd_sasa_car", 225, "backbone_3d/sa_modules_1/Dense_0"),
    ("IA-SSD", 185, "backbone_3d/sa_modules_4/Dense_1"),
])
def test_seeded_weights_cover_the_point_detectors(yaml, arrays, probe):
    """``seeded_flax`` names every array of 3DSSD, 3DSSD-SASA and IA-SSD
    in the flax layout (list members ``sa_modules_<i>``, the vote layer's
    ``Dense_i`` / ``BatchNorm_i``), ``flax_to_torch`` consumes every key
    and checks every shape, and a Dense kernel lands transposed."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )

    cfg = cfg_from_yaml_file(ROOT / f"configs/kitti_models/{yaml}.yaml")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), DatasetSpec(
        class_names=tuple(cfg.CLASS_NAMES), point_feature_dim=4,
        point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)),
        device="cpu")
    flat = weights.seeded_flax(model, 3)
    assert len(flat) == arrays == len(model.state_dict())
    sd = weights.flax_to_torch(flat, model)
    name = probe.replace("sa_modules_", "sa_modules.").replace("/", ".")
    np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(),
                                  flat[f"params/{probe}/kernel"].T)
    model.load_state_dict(sd, strict=True)
    extra = dict(flat)
    extra["params/backbone_3d/sa_modules_9/Dense_0/kernel"] = np.zeros(
        (2, 2), np.float32)
    with pytest.raises(ValueError):
        weights.flax_to_torch(extra, model)


@pytest.mark.parametrize("name,path", [
    ("backbone_3d.sa_modules.0.SharedMLP_4.Dense_0",
     "backbone_3d/sa_modules_0/SharedMLP_4/Dense_0"),
    ("sa_modules.12", "sa_modules_12"),
    ("backbone_2d.ConvBlock_0.Conv_0", "backbone_2d/ConvBlock_0/Conv_0"),
])
def test_flax_path_names_list_members(name, path):
    assert weights.flax_path(name) == path


def test_build_network_defaults_to_cuda():
    from de6d_tpu_torch import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        assert resolve_device("cpu").type == "cpu"


def test_port_imports_nothing_of_jax():
    """Every module of the port, the host pipeline, the KITTI eval, the
    eval loop and both CLIs by name, and chip_smoke.py, import without
    pulling in jax, flax, optax or de6d_tpu."""
    code = """
import importlib, pkgutil, sys
import de6d_tpu_torch
for name in ("de6d_tpu_torch.datasets",
             "de6d_tpu_torch.datasets.eval.kitti_eval",
             "de6d_tpu_torch.train.eval_utils",
             "de6d_tpu_torch.tools.train", "de6d_tpu_torch.tools.test"):
    importlib.import_module(name)
for m in pkgutil.walk_packages(de6d_tpu_torch.__path__, "de6d_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(k for k in sys.modules if k.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "de6d_tpu"))
print("BAD", bad)
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
