"""BEV canvas scatter and its gradient: the port's plain versions against
the JAX Pallas kernel (``scatter_canvas(interpret=True)``) and its custom
VJP. The canvas and its gradient are pure copies, so every comparison is
exact (bf16 and fp32). The CUDA kernels are held against the plain
versions in ``test_torch_cuda_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops.pallas.canvas import scatter_canvas as jax_scatter_canvas
from de6d_tpu_torch.ops.kernels import canvas
from torch_fixtures import canvas_inputs


CASES = {
    # (ny, nx, V, valid counts per sample)
    "partial": (64, 48, 256, (200, 37)),
    "empty": (20, 48, 64, (0, 0)),
    "full": (16, 16, 256, (256, 256)),  # every cell owns a pillar
    "tail_tile": (20, 48, 64, (64, 10)),  # G not a multiple of the tile
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_canvas_equals_pallas_interpret(case, dtype):
    ny, nx, v, n_valid = CASES[case]
    feats, lins = canvas_inputs(np.random.RandomState(0), 2, v, ny * nx,
                                n_valid)
    ref = np.asarray(jax_scatter_canvas(
        jnp.asarray(feats, jnp.dtype(dtype)), jnp.asarray(lins), ny, nx,
        256, True,
    ).astype(jnp.float32))
    got = canvas.scatter_canvas(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(lins), ny, nx,
    )
    assert got.shape == (2, ny, nx, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
def test_plain_canvas_grad_equals_jax_vjp(case, dtype, layout):
    """``scatter_canvas_grad_plain`` against ``jax.vjp`` of the Pallas
    canvas (interpret mode): the cotangent's row at each valid slot's
    cell, 0 at the invalid suffix; also for a non-contiguous cotangent,
    the NHWC view of an NCHW tensor, as a convolution may hand it back."""
    ny, nx, v, n_valid = CASES[case]
    rng = np.random.RandomState(1)
    feats, lins = canvas_inputs(rng, 2, v, ny * nx, n_valid)
    ct = rng.standard_normal((2, ny, nx, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda f: jax_scatter_canvas(
        f, jnp.asarray(lins), ny, nx, 256, True), jnp.asarray(feats, jdt))
    want = np.asarray(vjp(jnp.asarray(ct, jdt))[0].astype(jnp.float32))
    t_ct = torch.from_numpy(ct).to(getattr(torch, dtype))
    if layout == "nchw_view":
        t_ct = t_ct.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not t_ct.is_contiguous()
    got = canvas.scatter_canvas_grad(t_ct, torch.from_numpy(lins))
    assert got.shape == (2, v, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pointpillar_scatter_matches_jax_module():
    from de6d_tpu.models.backbones_2d.map_to_bev import (
        PointPillarScatter as JaxScatter,
    )
    from de6d_tpu_torch.models.backbones_2d.map_to_bev import (
        PointPillarScatter,
    )

    rng = np.random.RandomState(3)
    nx, ny, v, c = 48, 40, 128, 64
    feats = rng.randn(2, v, c).astype(np.float32)
    coords = np.full((2, v, 3), -1, np.int32)
    for b in range(2):
        lin = np.sort(rng.choice(ny * nx, 90, replace=False))
        coords[b, :90, 0] = 0
        coords[b, :90, 1] = lin // nx
        coords[b, :90, 2] = lin % nx
    jmod = JaxScatter(model_cfg={"NUM_BEV_FEATURES": c}, grid_size=(nx, ny, 1))
    ref = jmod.apply({}, {"pillar_features": jnp.asarray(feats),
                          "voxel_coords": jnp.asarray(coords)})
    tmod = PointPillarScatter({"NUM_BEV_FEATURES": c}, (nx, ny, 1))
    got = tmod({"pillar_features": torch.from_numpy(feats),
                "voxel_coords": torch.from_numpy(coords)})
    np.testing.assert_array_equal(got["spatial_features"].numpy(),
                                  np.asarray(ref["spatial_features"]))
