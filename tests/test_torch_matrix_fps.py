"""f-fps: the port's plain version (``ops/kernels/matrix_fps.py:
matrix_fps_plain``), its distance matrix and its top-k sampler
(``ops/sampling.py``) against the JAX package's jnp loop and its Pallas
kernel in interpret mode, on the same inputs.

Picks on the same matrix are indices: exact equality. The matrix itself
is ``max(|a|² + |b|² − 2a·b, 0)`` per term, and the two packages sum the
norms and the cross term in another order; both are held to
``chip_smoke.matrix_tolerance`` of the float64 value, a few fp32 ulps of
the summands ``|a|² + |b|²`` (not of the difference, which cancels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import matrix_tolerance
from de6d_tpu.ops import sampling as jax_sampling
from de6d_tpu.ops.pallas.fps import matrix_fps_pallas
from de6d_tpu_torch.ops import sampling
from de6d_tpu_torch.ops.kernels import matrix_fps as mk

# (B, N, npoint, valid count or None): ragged valid, npoint not a
# multiple of 128, N not a multiple of 32, valid < npoint (picks repeat)
CASES = [(2, 200, 64, None), (1, 256, 90, 150), (3, 257, 60, 40),
         (2, 130, 128, 130), (1, 1, 3, None)]


def _inputs(case, seed, channels=8):
    b, n, _, nvalid = case
    rng = np.random.RandomState(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32) * 5
    feats = rng.standard_normal((b, n, channels)).astype(np.float32)
    valid = np.ones((b, n), bool)
    if nvalid is not None:
        valid[:, nvalid:] = False
    return xyz, feats, valid


def _jax_picks(dm, valid, npoint):
    ref = jax_sampling._matrix_farthest_point_sample_jnp(
        jnp.asarray(dm), npoint, jnp.asarray(valid))
    pal = matrix_fps_pallas(jnp.asarray(dm), jnp.asarray(valid), npoint,
                            interpret=True)
    return np.asarray(ref), np.asarray(pal)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_matrix_fps_plain_equals_jax(case):
    """The same matrix (the JAX package's) through the jnp loop, the
    Pallas kernel in interpret mode, the port's plain version and its
    sampling entry point: bit-equal picks."""
    xyz, feats, valid = _inputs(case, seed=case[1])
    npoint = case[2]
    dm = np.asarray(jax_sampling.calc_dist_matrix_for_sampling(
        jnp.asarray(xyz), jnp.asarray(feats)))
    ref, pal = _jax_picks(dm, valid, npoint)
    np.testing.assert_array_equal(ref, pal)
    got = mk.matrix_fps_plain(torch.from_numpy(dm), torch.from_numpy(valid),
                              npoint)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    via = sampling.matrix_farthest_point_sample(
        torch.from_numpy(dm), npoint, torch.from_numpy(valid))
    np.testing.assert_array_equal(via.numpy(), ref)
    assert (ref[:, 0] == 0).all()  # seeded at index 0


def test_matrix_fps_exact_ties_keep_the_lowest_index():
    """A matrix of small integers: every step has many equal maxima."""
    rng = np.random.RandomState(5)
    b, n, npoint = 3, 96, 40
    dm = rng.randint(0, 4, (b, n, n)).astype(np.float32)
    dm = np.maximum(dm, dm.transpose(0, 2, 1))
    dm[:, np.arange(n), np.arange(n)] = 0.0
    valid = np.ones((b, n), bool)
    valid[1, 50:] = False
    valid[2, ::3] = False  # index 0 invalid: still the seed
    ref, pal = _jax_picks(dm, valid, npoint)
    np.testing.assert_array_equal(ref, pal)
    got = mk.matrix_fps(torch.from_numpy(dm), torch.from_numpy(valid),
                        npoint).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[2, 1:] % 3 != 0).all() and got[2, 0] == 0


def test_matrix_fps_without_a_mask_and_with_no_valid_point():
    dm = torch.tensor([[[0.0, 1.0, 4.0], [1.0, 0.0, 2.0], [4.0, 2.0, 0.0]]])
    assert sampling.matrix_farthest_point_sample(dm, 3).tolist() == [[0, 2, 1]]
    none = torch.zeros(1, 3, dtype=torch.bool)
    assert mk.matrix_fps(dm, none, 4).tolist() == [[0, 0, 0, 0]]


def test_bytes_moved_counts_each_picked_row_once():
    picks = torch.tensor([[0, 5, 7, 9], [0, 3, 3, 3]], dtype=torch.int32)
    # rows read: the first npoint - 1 picks, distinct: 3 + 2
    assert mk.bytes_moved(picks, 10) == 5 * 10 * 4 + 2 * 10 + 2 * 4 * 4


def test_matrix_fps_wrapper_rejects_bad_input():
    dm = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError):
        mk.matrix_fps(dm, torch.ones(1, 7, dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        mk.matrix_fps(torch.zeros(1, 8, 7), torch.ones(1, 8,
                                                       dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        mk.matrix_fps(dm.to("meta"),
                      torch.ones(1, 8, dtype=torch.bool, device="meta"), 4)


def _exact_matrix(xyz, feats, gamma):
    def sq(a):
        a = a.astype(np.float64)
        d = ((a[:, :, None] - a[:, None]) ** 2).sum(-1)
        n = (a * a).sum(-1)
        return d, n[:, :, None] + n[:, None]

    d, scale = sq(xyz)
    if feats is not None:
        df, sf = sq(feats)
        d, scale = d + gamma * df, scale + gamma * sf
    return d, scale


@pytest.mark.parametrize("channels,gamma,kitti", [
    (8, 1.0, False), (64, 1.0, True), (128, 0.5, True), (None, 1.0, True),
], ids=["c8", "c64_kitti", "c128_gamma_kitti", "xyz_only_kitti"])
def test_dist_matrix_within_tolerance_of_jax_and_float64(channels, gamma,
                                                         kitti):
    """Both packages' matrices lie within ``matrix_tolerance`` of the
    float64 matrix, so within twice that of each other; at KITTI
    coordinates (|a|² up to ~6000 m²) the xyz term cancels by 3 to 4
    digits."""
    rng = np.random.RandomState(channels or 3)
    b, n = 2, 300
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32) * 5
    if kitti:
        xyz = (xyz * 0.3 + np.array([60.0, -35.0, -1.0], np.float32)).astype(
            np.float32)
    feats = None
    if channels:  # post-ReLU features: non-negative, a common offset
        feats = np.abs(rng.standard_normal((b, n, channels))).astype(
            np.float32)
    ref = np.asarray(jax_sampling.calc_dist_matrix_for_sampling(
        jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
        gamma))
    got = sampling.calc_dist_matrix_for_sampling(
        torch.from_numpy(xyz),
        None if feats is None else torch.from_numpy(feats), gamma).numpy()
    exact, scale = _exact_matrix(xyz, feats, gamma)
    tol = matrix_tolerance(scale)
    assert got.dtype == np.float32 and got.shape == (b, n, n)
    assert (np.abs(ref - exact) <= tol).all(), \
        float((np.abs(ref - exact) / tol).max())
    assert (np.abs(got - exact) <= tol).all(), \
        float((np.abs(got - exact) / tol).max())
    assert (got >= 0).all() and (np.diagonal(got, axis1=1, axis2=2)
                                 <= np.diagonal(tol, axis1=1, axis2=2)).all()


def test_dist_matrix_is_fp32_whatever_the_input_dtype():
    rng = np.random.RandomState(2)
    xyz = torch.from_numpy(rng.standard_normal((1, 40, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(
        np.float32)).to(torch.bfloat16)
    got = sampling.calc_dist_matrix_for_sampling(xyz, feats)
    want = sampling.calc_dist_matrix_for_sampling(xyz, feats.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("npoint", [1, 7, 64])
def test_top_k_by_score_equals_jax_with_ties(npoint):
    """Scores drawn from 5 values (many exact ties): the lower index
    comes first, invalid points last."""
    rng = np.random.RandomState(npoint)
    scores = rng.randint(0, 5, (3, 64)).astype(np.float32) / 4
    valid = rng.random_sample((3, 64)) < 0.8
    valid[2, :] = np.arange(64) < 5  # fewer valid points than npoint
    ref = np.asarray(jax_sampling.sample_top_k_by_score(
        jnp.asarray(scores), npoint, jnp.asarray(valid)))
    got = sampling.sample_top_k_by_score(
        torch.from_numpy(scores), npoint, torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    none = sampling.sample_top_k_by_score(torch.from_numpy(scores), npoint)
    np.testing.assert_array_equal(none.numpy(), np.asarray(
        jax_sampling.sample_top_k_by_score(jnp.asarray(scores), npoint)))


def _tied_matrix(rng, b, n, straddle=(255, 256, 511, 512, 1023, 1024)):
    """Small integers (many exact ties in every 256-column slice) with
    the seed row's maximum planted on both sides of the slice boundaries
    that clusters of 16, 8 and 4 CTAs cut at N ~ 4096: the first pick
    must be the lowest of them."""
    dm = rng.integers(0, 4, (b, n, n), dtype=np.uint8).astype(np.float32)
    cols = [c for c in straddle if c < n]
    dm[:, 0, cols] = 9.0
    dm[:, cols, 0] = 9.0
    dm[:, np.arange(n), np.arange(n)] = 0.0
    return dm, (cols[0] if cols else None)


@pytest.mark.parametrize("n,npoint", [(4095, 64), (4100, 48)])
@pytest.mark.parametrize("ties", [False, True], ids=["xyz", "ties"])
def test_matrix_fps_plain_equals_pallas_at_cluster_shapes(n, npoint, ties):
    """N just below and above a multiple of every cluster's slice: the
    port's plain loop against the JAX jnp loop and the Pallas kernel in
    interpret mode, with a ragged mask and (``ties``) exact maxima that
    straddle the slice boundaries."""
    rng = np.random.default_rng(n)
    b = 2
    if ties:
        dm, first = _tied_matrix(rng, b, n)
    else:
        xyz = (rng.standard_normal((b, n, 3)) * 20).astype(np.float32)
        dm = np.array(jax_sampling.calc_dist_matrix_for_sampling(
            jnp.asarray(xyz)))
        first = None
    valid = np.ones((b, n), bool)
    valid[1, n // 3:] = False
    ref, pal = _jax_picks(dm, valid, npoint)
    np.testing.assert_array_equal(ref, pal)
    got = mk.matrix_fps_plain(torch.from_numpy(dm), torch.from_numpy(valid),
                              npoint)
    np.testing.assert_array_equal(got.numpy(), ref)
    if first is not None:
        assert (ref[:, 1] == first).all()


def test_matrix_fps_plain_equals_jax_at_n16384():
    """The largest N the kernel takes, against the JAX jnp loop (the
    Pallas kernel pads the batch to 8 samples: 8.6 GB at this N, too
    large for a CPU test), with planted ties across slice boundaries."""
    rng = np.random.default_rng(16384)
    dm, first = _tied_matrix(rng, 1, 16384,
                             straddle=(1023, 1024, 2047, 2048, 8191, 8192))
    valid = np.ones((1, 16384), bool)
    valid[0, 12000:] = False
    npoint = 12
    ref = np.asarray(jax_sampling._matrix_farthest_point_sample_jnp(
        jnp.asarray(dm), npoint, jnp.asarray(valid)))
    got = mk.matrix_fps_plain(torch.from_numpy(dm), torch.from_numpy(valid),
                              npoint)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, 1] == first


def test_matrix_fps_cluster_entry_refuses_cpu_tensors():
    """The forced-variant entry is for the card only: a CPU tensor is
    refused, and the cluster sizes are those the kernel takes."""
    assert mk.CLUSTER_SIZES == (1, 2, 4, 8, 16)
    with pytest.raises(ValueError):
        mk.matrix_fps_cluster(torch.zeros(1, 8, 8),
                              torch.ones(1, 8, dtype=torch.bool), 4,
                              cluster=2)
