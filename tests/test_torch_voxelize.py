"""Device voxelization and the fused pillar VFE: the PyTorch port
against the JAX package on the same points.

Voxelize outputs are integer and must match bit for bit. The segmented
sums run the same Hillis-Steele passes in the same order as the JAX
function, so the per-pillar centroid sums are expected to match exactly
too (fp32, no tolerance). PillarVFE features go through a Dense layer
whose sums run in another order (tolerance 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import voxelize as jvox
from de6d_tpu_torch.ops import voxelize as tvox
from torch_fixtures import random_points

KEYS = ("voxel_coords", "voxel_num_points", "num_voxels", "point_voxel_idx",
        "order", "sorted_slot", "sorted_rank", "voxel_starts")


class _Spec:
    def __init__(self, pc):
        self.point_cloud_range = pc


TINY = ((0.0, -25.6, -3.0, 51.2, 25.6, 1.0), (0.4, 0.4, 4.0), 2000, 16)
KITTI = ((0.0, -39.68, -3.0, 69.12, 39.68, 1.0), (0.16, 0.16, 4.0), 16000, 32)
# more voxels than slots: the largest keys must be the ones dropped
OVERFLOW = ((0.0, -39.68, -3.0, 69.12, 39.68, 1.0), (0.16, 0.16, 4.0), 700, 4)


def _both(grid, n, seed):
    pc, vs, v, p = grid
    pts, mask = random_points(seed, _Spec(pc), 2, n, n - 150)
    # a few points outside the range and a few masked in-range ones
    pts[0, :5, 0] = pc[3] + 1.0
    mask[1, 10:20] = False
    ref = jax.jit(jax.vmap(
        lambda a, m: jvox.voxelize(a, m, pc, vs, v, p)
    ))(jnp.asarray(pts), jnp.asarray(mask))
    got = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                        pc, vs, v, p)
    return {k: np.array(ref[k]) for k in ref}, {
        k: got[k].numpy() for k in got
    }, pts


@pytest.mark.parametrize("grid,n", [(TINY, 4096), (KITTI, 4096),
                                    (OVERFLOW, 4096)],
                         ids=["tiny", "kitti", "overflow"])
def test_voxelize_bit_exact(grid, n):
    ref, got, _ = _both(grid, n, seed=3)
    if grid is OVERFLOW:
        assert (ref["num_voxels"] == grid[2]).all(), "needs an overflow"
    for k in KEYS:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


SECOND = ((0.0, -40.0, -3.0, 70.4, 40.0, 1.0), (0.05, 0.05, 0.1), 16000, 5)


@pytest.mark.parametrize("grid,x", [(SECOND, 14.099999), (KITTI, 1.5999999)],
                         ids=["second_0.05m", "pointpillars_0.16m"])
def test_voxel_coords_at_a_cell_boundary(grid, x):
    """A point whose x divided by the voxel size floors one cell lower
    than x times the fp32 reciprocal: the jitted JAX model multiplies, and
    the port must land it in the same cell (SECOND's keys part in every
    stage otherwise)."""
    pc, vs, v, p = grid
    pts, mask = random_points(6, _Spec(pc), 2, 512, 400)
    pts[:, :3, 0] = np.float32(x)
    pts[:, :3, 1:3] = 0.0
    x32, vs32 = np.float32(x), np.float32(vs[0])
    assert np.floor(x32 / vs32) != np.floor(x32 * (np.float32(1) / vs32))
    ref = jax.jit(jax.vmap(
        lambda a, m: jvox.voxelize(a, m, pc, vs, v, p)
    ))(jnp.asarray(pts), jnp.asarray(mask))
    got = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                        pc, vs, v, p)
    ijk, _, _ = tvox.compute_voxel_coords(torch.from_numpy(pts[:, :3]), pc,
                                          vs)
    assert (ijk[:, :3, 0] == int(np.floor(x32 * (np.float32(1) / vs32)))).all()
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("grid", [TINY, KITTI], ids=["tiny", "kitti"])
def test_sorted_segment_reductions_exact(grid):
    ref, got, pts = _both(grid, 4096, seed=4)
    cap = grid[3]
    order = ref["order"]
    xyz = np.take_along_axis(pts[..., :3], order[..., None], axis=1)
    xyz = np.where((ref["sorted_slot"] >= 0)[..., None], xyz, 0.0)
    args = (ref["sorted_slot"], ref["voxel_starts"], ref["voxel_num_points"])
    for name in ("sorted_segment_sum", "sorted_segment_max"):
        jfn = getattr(jvox, name)
        r = jax.vmap(lambda x, i, s, c: jfn(x, i, s, c, window=cap))(
            jnp.asarray(xyz), *(jnp.asarray(a) for a in args)
        )
        g = getattr(tvox, name)(
            torch.from_numpy(xyz), *(torch.from_numpy(a) for a in args),
            window=cap,
        )
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_pillar_vfe_matches_jax():
    from de6d_tpu.models.backbones_3d.vfe.pillar_vfe import (
        PillarVFE as JaxVFE,
    )
    from de6d_tpu_torch.models.backbones_3d.vfe.pillar_vfe import PillarVFE
    from de6d_tpu_torch.weights import load_into
    from torch_fixtures import flatten_variables, perturb, unflatten

    pc, vs, v, p = KITTI
    cfg = {"NUM_FILTERS": [64], "USE_NORM": True, "WITH_DISTANCE": False,
           "USE_ABSLOTE_XYZ": True}
    ref, got, pts = _both(KITTI, 4096, seed=5)
    bd = {k: ref[k] for k in KEYS}
    bd["points"] = pts
    jmod = JaxVFE(model_cfg=cfg, num_point_features=4, voxel_size=vs,
                  point_cloud_range=pc)
    jbd = {k: jnp.asarray(x) for k, x in bd.items()}
    init = jmod.init(jax.random.PRNGKey(0), dict(jbd), train=False)
    flat = perturb(flatten_variables(init), seed=2)
    jvars = unflatten(flat)
    jfeat = np.asarray(jmod.apply(jvars, dict(jbd), train=False)[
        "pillar_features"])

    tmod = PillarVFE(cfg, 4, vs, pc).eval()
    # the flax module is the root here, so its keys carry no "vfe/" prefix
    load_into(tmod, flat)
    tbd = {k: torch.from_numpy(x) for k, x in bd.items()}
    with torch.no_grad():
        tfeat = tmod(tbd)["pillar_features"].numpy()
    np.testing.assert_allclose(tfeat, jfeat, rtol=1e-5, atol=1e-5)
