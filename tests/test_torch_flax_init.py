"""The port's layers initialise as flax's do (``models/model_utils/
layers.py``: ``lecun_normal`` kernels, zero biases, BatchNorm scale one and
bias zero; ``AnchorHeadSingle``'s focal prior on ``conv_cls.bias`` and
``normal(0.001)`` on ``conv_box``), held leaf by leaf against JAX's
``model.init`` for the tiny and the full PointPillars.

The bits cannot match: jax's PRNG (threefry) is not torch's, so a kernel
is held by its distribution. Shapes must be equal; constants (every bias,
the prior, BatchNorm's scale, bias and statistics) bit-equal; each
kernel's sample standard deviation within 5 standard errors of the
target (1 / sqrt(fan_in) for ``lecun_normal``, 0.001 for ``conv_box``),
for the port and for JAX alike, the error of a sample deviation over n
entries being ``sigma * sqrt((kurtosis - 1) / (4 n))`` (kurtosis 2.36 for
a normal truncated at 2 standard deviations, 3 for a normal); a
``lecun_normal`` kernel's entries within its truncation at 2 / 0.8796
target deviations. The full model keeps its widths (channels, layers) on
a 64 x 64 cell grid: no parameter's shape depends on the grid.

The first step from a fresh init: the tiny model's focal classification
loss, averaged over 6 fresh inits of each package, agrees within 25 %
(over seeds 0-7 it spread over 0.79-1.21 for JAX and 0.73-0.91 for the
port on this batch: the logits start near the prior, -4.595, in both);
without the prior it is over 100 times larger (645 against ~0.9).
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

TINY = str(ROOT / "configs/kitti_models/pointpillar_tiny.yaml")
FULL = str(ROOT / "configs/kitti_models/pointpillar.yaml")
N_SE = 5.0
TRUNC_STD = 0.87962566103423978
PRIOR = float(np.float32(-np.log((1 - 0.01) / 0.01)))
SEEDS = 6
LOSS_REL = 0.25


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg_path, small_grid):
    """(jax flat init, port state dict in torch layout, port fresh
    state dict, flax fan-in per torch kernel name)."""
    import jax
    import jax.numpy as jnp

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu.models import build_network as jax_build
    from de6d_tpu.models.detectors.detector3d_template import (
        DatasetSpec as JaxSpec,
    )
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from torch_fixtures import flatten_variables, random_points, spec_kwargs

    jcfg, tcfg = jax_cfg(cfg_path), cfg_from_yaml_file(cfg_path)
    kw = spec_kwargs(tcfg)
    if small_grid:
        kw["point_cloud_range"] = (0.0, -5.12, -3.0, 10.24, 5.12, 1.0)
        kw["max_voxels"] = 2000
    nc = len(tcfg.CLASS_NAMES)
    jmodel = jax_build(copy.deepcopy(dict(jcfg.MODEL)), num_class=nc,
                       dataset=JaxSpec(**kw))
    spec = DatasetSpec(**kw)
    pts, mask = random_points(0, spec, 1, 2048, 2000)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    flat = flatten_variables(variables)
    tmodel = build_network(copy.deepcopy(tcfg.MODEL), nc, spec,
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    ref = weights.flax_to_torch(flat, tmodel)
    fan_in = {}
    for name, m in tmodel.named_modules():
        if getattr(m, "FLAX_KIND", None) in ("Dense", "Conv",
                                             "ConvTranspose"):
            w = m.weight
            fan_in[f"{name}.weight"] = (
                w.shape[1] if m.FLAX_KIND == "Dense"
                else w.shape[0] * w.shape[2] * w.shape[3]
                if m.FLAX_KIND == "ConvTranspose"
                else w.shape[1] * w.shape[2] * w.shape[3])
    return ref, tmodel.state_dict(), fan_in


def _kurtosis_truncated():
    from scipy.stats import truncnorm

    return 3.0 + float(truncnorm(-2, 2).stats(moments="k"))


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_fresh_init_matches_flax(which):
    ref, got, fan_in = _pair(TINY if which == "tiny" else FULL,
                             small_grid=which == "full")
    assert sorted(got) == sorted(ref)
    k_trunc = _kurtosis_truncated()
    n_kernels = 0
    for k, w in ref.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        w = w.double().numpy()
        g = g.double().numpy()
        if k in fan_in:
            n = w.size
            if k == "dense_head.conv_box.weight":
                sigma, kurt, bound = 0.001, 3.0, None
            else:
                sigma, kurt = fan_in[k] ** -0.5, k_trunc
                bound = 2 * sigma / TRUNC_STD
            se = sigma * np.sqrt((kurt - 1) / (4 * n))
            for who, x in (("port", g), ("jax", w)):
                assert abs(x.std() - sigma) <= N_SE * se, (
                    who, k, x.std(), sigma, se)
                assert abs(x.mean()) <= N_SE * sigma / np.sqrt(n), (who, k)
                if bound is not None:
                    assert np.abs(x).max() <= bound * (1 + 1e-6), (who, k)
            n_kernels += 1
        else:  # biases, BatchNorm: constants, bit-equal
            assert np.array_equal(g, w), k
    assert n_kernels == len(fan_in) and n_kernels >= 8
    prior = got["dense_head.conv_cls.bias"].numpy()
    assert np.all(prior == np.float32(PRIOR))


def test_generator_draws_reproducibly():
    """Same seed, same parameters; another seed, other kernels and the
    same constants."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from torch_fixtures import spec_kwargs

    cfg = cfg_from_yaml_file(TINY)

    def draw(seed):
        m = build_network(copy.deepcopy(cfg.MODEL), 1,
                          DatasetSpec(**spec_kwargs(cfg)), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        return m.state_dict()

    a, b, c = draw(666), draw(666), draw(667)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        if k.endswith("conv_0.weight") or "Conv_0.weight" in k:
            assert not torch.equal(a[k], c[k]), k
        if k.endswith(("bias", "running_mean", "running_var")):
            assert torch.equal(a[k], c[k]), k


def test_first_step_focal_loss_from_fresh_init():
    """The tiny model's classification loss at the first step from
    fresh inits of each package (seeds 0-5 each), on the same batch."""
    import jax
    import jax.numpy as jnp

    from de6d_tpu_torch.models import build_network
    from test_torch_pointpillar_train import tiny_batch
    from torch_fixtures import build_pair

    jmodel, tmodel, mc, nc, spec = build_pair(TINY)
    batch = tiny_batch(spec)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))

    @jax.jit
    def jax_loss(v, b):
        out, _ = jmodel.apply(v, dict(b), train=True,
                              mutable=["batch_stats"])
        return jmodel.get_training_loss(out)[1]["rpn_loss_cls"]

    want = np.array([float(jax_loss(init(jax.random.PRNGKey(s), jb), jb))
                     for s in range(SEEDS)])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for s in range(SEEDS):
        model = build_network(copy.deepcopy(mc), nc, tmodel.spec,
                              device="cpu",
                              generator=torch.Generator().manual_seed(s))
        model.train()
        with torch.no_grad():
            got.append(float(model.get_training_loss(model(dict(tb)))[1][
                "rpn_loss_cls"]))
    got = np.array(got)
    assert abs(got.mean() / want.mean() - 1) < LOSS_REL, (got, want)
    with torch.no_grad():
        model.dense_head.conv_cls.bias.zero_()
        no_prior = float(model.get_training_loss(model(dict(tb)))[1][
            "rpn_loss_cls"])
    assert no_prior / want.mean() > 100
