"""Farthest-point sampling: the port's plain version (``ops/kernels/
fps.py:fps_plain``) and its sampling entry points (``ops/sampling.py``)
against the JAX package's jnp loop and its Pallas kernel in interpret
mode, on the same inputs. Picks are indices: exact equality."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import sampling as jax_sampling
from de6d_tpu.ops.pallas.fps import fps_pallas
from de6d_tpu_torch.ops import sampling
from de6d_tpu_torch.ops.kernels import fps as fps_kernels

ROOT = Path(__file__).resolve().parents[1]

# the cases of tests/test_sampling.py: ragged valid, npoint not a
# multiple of 128, valid < npoint (picks repeat)
CASES = [(2, 300, 96, None), (1, 128, 128, None), (3, 257, 60, 40),
         (2, 512, 200, 512)]


def _inputs(case, seed):
    b, n, _, nvalid = case
    rng = np.random.RandomState(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32) * 10
    valid = np.ones((b, n), bool)
    if nvalid is not None:
        valid[:, nvalid:] = False
    w = rng.random_sample((b, n)).astype(np.float32)
    return xyz, valid, w


def _jax(xyz, valid, npoint, w=None):
    if w is None:
        ref = jax_sampling._farthest_point_sample_jnp(
            jnp.asarray(xyz), npoint, jnp.asarray(valid))
        pal = fps_pallas(jnp.asarray(xyz), jnp.asarray(valid), npoint,
                         interpret=True)
    else:
        ref = jax_sampling._weighted_farthest_point_sample_jnp(
            jnp.asarray(xyz), jnp.asarray(w), npoint, jnp.asarray(valid))
        pal = fps_pallas(jnp.asarray(xyz), jnp.asarray(valid), npoint,
                         weights=jnp.asarray(w), weighted=True,
                         interpret=True)
    return np.asarray(ref), np.asarray(pal)


@pytest.mark.parametrize("weighted", [False, True], ids=["d-fps", "s-fps"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_fps_plain_equals_jax(case, weighted):
    xyz, valid, w = _inputs(case, seed=case[1])
    npoint = case[2]
    ref, pal = _jax(xyz, valid, npoint, w if weighted else None)
    np.testing.assert_array_equal(ref, pal)
    tw = torch.from_numpy(w) if weighted else None
    got = fps_kernels.fps_plain(torch.from_numpy(xyz),
                                torch.from_numpy(valid), npoint, tw)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if weighted:
        via = sampling.weighted_farthest_point_sample(
            torch.from_numpy(xyz), tw, npoint, torch.from_numpy(valid))
    else:
        via = sampling.farthest_point_sample(
            torch.from_numpy(xyz), npoint, torch.from_numpy(valid))
    np.testing.assert_array_equal(via.numpy(), ref)


@pytest.mark.parametrize("weighted", [False, True], ids=["d-fps", "s-fps"])
def test_fps_plain_equals_jax_on_a_real_scan(weighted):
    """16384-point Det6D scan (≈2.2k valid, zero padding masked), 16384 →
    768 picks; s-fps with random weights."""
    pts = np.load(ROOT / "bench_assets/det6d_car_scans.npz")["points"][:1]
    valid = ~np.all(pts == 0, axis=-1)
    xyz = np.ascontiguousarray(pts[..., :3])
    w = np.random.RandomState(3).random_sample(valid.shape).astype(
        np.float32)
    npoint = 768
    if weighted:
        ref = jax_sampling._weighted_farthest_point_sample_jnp(
            jnp.asarray(xyz), jnp.asarray(w), npoint, jnp.asarray(valid))
    else:
        ref = jax_sampling._farthest_point_sample_jnp(
            jnp.asarray(xyz), npoint, jnp.asarray(valid))
    got = fps_kernels.fps_plain(torch.from_numpy(xyz), torch.from_numpy(valid),
                                npoint,
                                torch.from_numpy(w) if weighted else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fps_seeds_and_repeats():
    """d-fps seeds at 0 even when point 0 is invalid; s-fps at the first
    argmax of the valid weights; with no valid point every pick is 0."""
    xyz = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    valid = torch.tensor([[False, True, True, False], [False] * 4])
    w = torch.tensor([[9.0, 0.5, 0.5, 9.0], [1.0, 2.0, 2.0, 0.0]])
    d = fps_kernels.fps(xyz, valid, 5)
    s = fps_kernels.fps(xyz, valid, 5, weights=w)
    assert d.tolist() == [[0, 2, 1, 1, 1], [0, 0, 0, 0, 0]]
    assert s.tolist() == [[1, 2, 1, 1, 1], [0, 0, 0, 0, 0]]


def test_fps_wrapper_rejects_bad_input():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError):
        fps_kernels.fps(xyz, torch.ones(1, 7, dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        fps_kernels.fps(xyz, torch.ones(1, 8, dtype=torch.bool), 4,
                        weights=torch.ones(1, 7))
    with pytest.raises(ValueError):
        fps_kernels.fps(xyz.to("meta"), torch.ones(1, 8, dtype=torch.bool,
                                                    device="meta"), 4)
