"""The port's sparse-conv ops (``de6d_tpu_torch/ops/sparse.py`` and the
plain versions of the ``lookup`` and ``sparse_conv`` kernels) against the
JAX package's ``de6d_tpu/ops/sparse.py``, and against the Pallas kernels
``lookup_pallas`` and ``subm_conv_slab`` run in interpret mode, on the
CPU. Inputs come from numpy seeds; tables hold at most 2048 sites.

Keys, tables, hits and the indices of hits are integers and must be
identical. Convolution outputs are fp32 sums of up to 27 · Cin products
taken in another order than XLA's: atol 1e-5 + rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import sparse as jsp
from de6d_tpu.ops.pallas.lookup import lookup_pallas
from de6d_tpu.ops.pallas.sparse_gather import subm_conv_slab
from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import lookup as lookup_kernels
from de6d_tpu_torch.ops.kernels import sparse_conv as conv_kernels

INVALID = sparse.INVALID
ATOL = RTOL = 1e-5
GRID = (9, 40, 36)  # zyx, 12,960 cells


def test_invalid_sentinel_is_the_jax_one():
    assert INVALID == int(jsp.INVALID) == 2**31 - 1


def sparse_batch(seed, grid, v, counts, cin, clustered=True):
    """(feats (B, V, Cin), keys (B, V)) sorted, INVALID tail, zero rows
    there. Clustered sites (a ball of cells around a few centres) give
    every offset some hits."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    keys = np.full((len(counts), v), INVALID, np.int32)
    feats = np.zeros((len(counts), v, cin), np.float32)
    for b, n in enumerate(counts):
        if clustered:
            cells = set()
            while len(cells) < n:
                c = rng.randint(0, (nz, ny, nx))
                for _ in range(40):
                    p = np.clip(c + rng.randint(-2, 3, 3), 0,
                                np.array(grid) - 1)
                    cells.add(int((p[0] * ny + p[1]) * nx + p[2]))
            cells = np.array(sorted(cells), np.int64)
            lin = np.sort(rng.choice(cells, n, replace=False))
        else:
            lin = np.sort(rng.choice(nz * ny * nx, n, replace=False))
        keys[b, :n] = lin
        feats[b, :n] = rng.randn(n, cin)
    return feats, keys


def jax_vmap(fn, *args):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jax.vmap(fn)(*(jnp.asarray(a) for a in args)))]


# ---------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------

def lookup_case(seed, v, q):
    rng = np.random.RandomState(seed)
    grid_max = 41 * 1600 * 1408
    tables, queries = [], []
    for _ in range(2):
        u = np.unique(rng.randint(0, grid_max, v).astype(np.int32))
        table = np.full((v,), INVALID, np.int32)
        table[: len(u)] = u
        present = u[rng.randint(0, len(u), q // 2)]
        absent = rng.randint(0, grid_max, q - q // 2 - 8).astype(np.int32)
        qs = np.concatenate([present, absent, np.full(8, INVALID, np.int32)])
        rng.shuffle(qs)
        tables.append(table)
        queries.append(qs)
    return np.stack(tables), np.stack(queries)


def edge_case(name):
    """The edge cases of tests/test_lookup_pallas.py and a few more."""
    if name == "edges":
        table = np.full((256,), INVALID, np.int32)
        table[:5] = [0, 1, 128, 129, 500000]
        queries = np.array([0, 1, 2, 127, 128, 129, 130, 499999, 500000,
                            500001, INVALID, 0], np.int32)
    elif name == "empty_table":
        table = np.full((128,), INVALID, np.int32)
        queries = np.array([0, 5, INVALID], np.int32)
    elif name == "all_invalid_queries":
        table = np.arange(0, 600, 3, dtype=np.int32)
        queries = np.full((300,), INVALID, np.int32)
    elif name == "outside_the_keys":  # below the first, above the last
        table = np.arange(1000, 2000, 7, dtype=np.int32)
        queries = np.array([0, 999, 1000, 1993, 1994, 2**30, INVALID - 1],
                           np.int32)
    else:  # a full table, no INVALID tail
        table = np.arange(5, 5 + 3 * 512, 3, dtype=np.int32)
        queries = np.arange(0, 1600, dtype=np.int32)
    return table[None].repeat(2, 0), queries[None].repeat(2, 0)


def check_lookup_against_jax(tables, queries):
    idx, hit = sparse.lookup(torch.from_numpy(tables),
                             torch.from_numpy(queries))
    idx, hit = idx.numpy(), hit.numpy()
    assert idx.dtype == np.int32 and hit.dtype == bool
    v = tables.shape[1]
    assert ((idx >= 0) & (idx < v)).all()
    for b in range(tables.shape[0]):
        t, q = jnp.asarray(tables[b]), jnp.asarray(queries[b])
        for ref_idx, ref_hit in (jsp.lookup(t, q),
                                 lookup_pallas(t, q, interpret=True)):
            ref_hit = np.asarray(ref_hit)
            np.testing.assert_array_equal(hit[b], ref_hit)
            np.testing.assert_array_equal(idx[b][ref_hit],
                                          np.asarray(ref_idx)[ref_hit])
        np.testing.assert_array_equal(tables[b][idx[b][hit[b]]],
                                      queries[b][hit[b]])
    return hit


@pytest.mark.parametrize("v,q", [(2048, 4096), (700, 2048), (1, 64)])
def test_lookup_equals_jax_and_pallas(v, q):
    hit = check_lookup_against_jax(*lookup_case(v, v, q))
    assert hit.any() and not hit.all()


@pytest.mark.parametrize("case", ["edges", "empty_table",
                                  "all_invalid_queries", "outside_the_keys",
                                  "full_table"])
def test_lookup_edge_cases_equal_jax_and_pallas(case):
    tables, queries = edge_case(case)
    hit = check_lookup_against_jax(tables, queries)
    if case in ("empty_table", "all_invalid_queries"):
        assert not hit.any()


def test_lookup_without_a_table_and_bad_input():
    idx, hit = lookup_kernels.lookup(torch.zeros((2, 0), dtype=torch.int32),
                                     torch.ones((2, 5), dtype=torch.int32))
    assert idx.shape == (2, 5) and not hit.any()
    with pytest.raises(TypeError):
        lookup_kernels.lookup(torch.zeros((1, 4), dtype=torch.int64),
                              torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        lookup_kernels.lookup(torch.zeros((2, 4), dtype=torch.int32),
                              torch.zeros((3, 4), dtype=torch.int32))


# ---------------------------------------------------------------------
# tables and active-output discovery
# ---------------------------------------------------------------------

@pytest.mark.parametrize("v,counts", [(2048, (1500, 700)), (512, (512, 3))])
def test_subm_neighbor_table_equals_jax(v, counts):
    _, keys = sparse_batch(v, GRID, v, counts, 1)
    idx, hit = sparse.subm_neighbor_table(torch.from_numpy(keys), GRID)
    ref_idx, ref_hit = jax_vmap(lambda k: jsp.subm_neighbor_table(k, GRID),
                                keys)
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    np.testing.assert_array_equal(idx.numpy()[ref_hit], ref_idx[ref_hit])
    assert hit.numpy()[:, :, 13].sum() == sum(counts)  # the centre tap
    assert 3 * sum(counts) < hit.numpy().sum()  # some real neighbours


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
])
@pytest.mark.parametrize("max_out", [4000, 300])
def test_downsample_and_strided_table_equal_jax(kernel, stride, padding,
                                                max_out):
    _, keys = sparse_batch(1, GRID, 2048, (1500, 200), 1)
    out_keys, out_grid = sparse.downsample_coords(
        torch.from_numpy(keys), GRID, stride, padding, max_out, kernel)
    ref_keys = jax_vmap(lambda k: jsp.downsample_coords(
        k, GRID, stride, padding, max_out, kernel)[0], keys)[0]
    _, ref_grid = jsp.downsample_coords(jnp.asarray(keys[0]), GRID, stride,
                                        padding, max_out, kernel)
    assert out_grid == tuple(ref_grid)
    np.testing.assert_array_equal(out_keys.numpy(), ref_keys)
    n_out = (ref_keys != INVALID).sum(-1)
    assert n_out[1] > 0 and (n_out[0] == max_out) == (max_out == 300)
    idx, hit = sparse.strided_neighbor_table(
        torch.from_numpy(keys), out_keys, GRID, out_grid, kernel, stride,
        padding)
    ref_idx, ref_hit = jax_vmap(lambda k, o: jsp.strided_neighbor_table(
        k, o, GRID, out_grid, kernel, stride, padding), keys, ref_keys)
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    np.testing.assert_array_equal(idx.numpy()[ref_hit], ref_idx[ref_hit])


@pytest.mark.parametrize("size", [50, 4000, 20000])
def test_unique_keys_equals_jax(size):
    rng = np.random.RandomState(size)
    keys = rng.randint(0, 3000, (2, 8000)).astype(np.int32)
    keys[0, ::3] = INVALID
    keys[1] = INVALID  # nothing valid
    got = sparse.unique_keys(torch.from_numpy(keys), size).numpy()
    ref = jax_vmap(lambda k: jsp.unique_keys(k, size), keys)[0]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got[0][got[0] != INVALID], np.unique(keys[0][keys[0] != INVALID])[
            :size])


def test_keys_coords_sort_and_to_dense_equal_jax():
    grid = (4, 6, 5)
    feats, keys = sparse_batch(3, grid, 64, (60, 17), 3, clustered=False)
    rng = np.random.RandomState(3)
    perm = rng.permutation(64)
    feats, keys = feats[:, perm], keys[:, perm]  # unsorted, as voxelized
    coords = sparse.keys_to_coords(torch.from_numpy(keys), grid)
    ref = jax_vmap(lambda k: jsp.keys_to_coords(k, grid), keys)[0]
    np.testing.assert_array_equal(coords.numpy(), ref)
    back = sparse.coords_to_keys(coords, grid, coords[..., 0] >= 0)
    np.testing.assert_array_equal(back.numpy(), keys)
    f_s, k_s = sparse.sort_sparse(torch.from_numpy(feats),
                                  torch.from_numpy(keys))
    rf, rk = jax_vmap(jsp.sort_sparse, feats, keys)
    np.testing.assert_array_equal(k_s.numpy(), rk)
    np.testing.assert_array_equal(f_s.numpy(), rf)
    dense = sparse.to_dense(f_s, k_s, grid).numpy()
    ref_dense = jax_vmap(lambda f, k: jsp.to_dense(f, k, grid), rf, rk)[0]
    assert dense.shape == (2, *grid, 3)
    np.testing.assert_array_equal(dense, ref_dense)


# ---------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------

def conv_case(cin, cout, v=1024, counts=(1000, 300), k3=27, seed=0):
    feats, keys = sparse_batch(seed, GRID, v, counts, cin)
    rng = np.random.RandomState(seed + 1)
    w = (rng.randn(k3, cin, cout) / np.sqrt(k3 * cin)).astype(np.float32)
    return feats, keys, w


def check_slab(got, feats, idx, hit, w, valid):
    """``got`` against the Pallas slab kernel in interpret mode, on the
    samples whose rows that kernel certifies (its ``ok``: every tile's
    neighbour rows fit one slab); it must certify at least one."""
    slab, ok = subm_conv_slab(jnp.asarray(feats), jnp.asarray(idx.numpy()),
                              jnp.asarray(hit.numpy()), jnp.asarray(w),
                              jnp.asarray(valid.numpy()), interpret=True)
    ok = np.asarray(ok)
    assert ok.any(), "the slab kernel certified no sample"
    np.testing.assert_allclose(got[ok], np.asarray(slab)[ok], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 64), (4, 16), (48, 32)])
def test_subm_conv_equals_jax(cin, cout):
    feats, keys, w = conv_case(cin, cout)
    tk = torch.from_numpy(keys)
    idx, hit = sparse.subm_neighbor_table(tk, GRID)
    valid = tk != INVALID
    got = sparse.subm_conv_table(torch.from_numpy(feats), idx, hit,
                                 torch.from_numpy(w), valid).numpy()
    ref = jax_vmap(lambda f, k: jsp.subm_conv_table(
        f, *jsp.subm_neighbor_table(k, GRID), jnp.asarray(w),
        k != jsp.INVALID), feats, keys)[0]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert (got[~valid.numpy()] == 0).all() and np.abs(got).max() > 0.1
    if 128 % cin == 0 and cin != 4:
        check_slab(got, feats, idx, hit, w, valid)


@pytest.mark.parametrize("cin,cout,kernel,stride,padding", [
    (16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (32, 32, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    (32, 16, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
])
def test_strided_conv_equals_jax(cin, cout, kernel, stride, padding):
    k3 = kernel[0] * kernel[1] * kernel[2]
    feats, keys, w = conv_case(cin, cout, k3=k3, seed=2)
    tk = torch.from_numpy(keys)
    out_keys, out_grid = sparse.downsample_coords(tk, GRID, stride, padding,
                                                  600, kernel)
    got = sparse.strided_conv(torch.from_numpy(feats), tk, GRID,
                              torch.from_numpy(w), kernel, stride, padding,
                              out_keys, out_grid).numpy()
    ok_np = out_keys.numpy()
    ref = jax_vmap(lambda f, k, o: jsp.strided_conv(
        f, k, GRID, jnp.asarray(w), kernel, stride, padding, o, out_grid),
        feats, keys, ok_np)[0]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.abs(got).max() > 0.1
    idx, hit = sparse.strided_neighbor_table(tk, out_keys, GRID, out_grid,
                                             kernel, stride, padding)
    check_slab(got, feats, idx, hit, w, out_keys != INVALID)


def test_sparse_conv_plain_in_bf16_and_bad_input():
    """bf16 features and weights: the product sums in fp32 and rounds
    once, so the result is within one bf16 ulp (2^-7 relative) of the
    fp32 result on the same bf16 inputs."""
    feats, keys, w = conv_case(16, 32, v=512, counts=(400, 100))
    tk = torch.from_numpy(keys)
    idx, hit = sparse.subm_neighbor_table(tk, GRID)
    f16 = torch.from_numpy(feats).bfloat16()
    w16 = torch.from_numpy(w).bfloat16()
    got = conv_kernels.sparse_conv(f16, idx, hit, w16, tk != INVALID)
    ref = conv_kernels.sparse_conv(f16.float(), idx, hit, w16.float(),
                                   tk != INVALID)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               rtol=2**-7, atol=1e-6)
    with pytest.raises(TypeError):
        conv_kernels.sparse_conv(f16, idx, hit, torch.from_numpy(w),
                                 tk != INVALID)
    with pytest.raises(ValueError):
        conv_kernels.sparse_conv(f16, idx[:, :5], hit, w16, tk != INVALID)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_work_counts_what_the_hits_need(dtype):
    """The bound's bytes: ``hit`` of every (q, k) of a valid row, ``idx``
    only where it hits, each referenced feature row once, weights,
    ``valid`` and the whole output once; operations 2·Cin·Cout per hit."""
    b, v, q, k, cin, cout = 2, 6, 4, 3, 5, 7
    f = torch.zeros(b, v, cin, dtype=dtype)
    w = torch.zeros(k, cin, cout, dtype=dtype)
    idx = torch.zeros(b, q, k, dtype=torch.int32)
    hit = torch.zeros(b, q, k, dtype=torch.bool)
    valid = torch.tensor([[True, True, False, False], [True] * 4])
    # sample 0: row 0 hits rows 1 and 4, row 1 hits row 4 again; the hit
    # of invalid row 2 is not needed. Sample 1: one hit, of row 4.
    idx[0, 0, :2] = torch.tensor([1, 4])
    hit[0, 0, :2] = True
    idx[0, 1, 2], hit[0, 1, 2] = 4, True
    idx[0, 2, 0], hit[0, 2, 0] = 5, True
    idx[1, 3, 1], hit[1, 3, 1] = 4, True
    s = f.element_size()
    nbytes, ops = conv_kernels.work(f, idx, hit, w, valid)
    assert ops == 2 * 4 * cin * cout
    assert nbytes == (6 * k + 4 * 4 + 3 * cin * s + k * cin * cout * s
                      + b * q + b * q * cout * s)
