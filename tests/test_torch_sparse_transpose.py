"""The sparse conv's data-gradient tables on the CPU, at their edges.

A submanifold layer's data gradient runs on the forward's own table
through the mirrored offsets (``sparse_conv.Submanifold``); a strided
layer's on the transposed table that ``lookup.transposed_table`` builds
from its geometry (``sparse_conv.Strided``). Both are held here against
the scatter of the forward table (``sparse_conv_transpose_plain``, the
independent reference) and the plain data gradient, at the edges the
tiny SECOND's stage tables (``tests/test_torch_second_train.py``) do not
reach: a sample with no sites, INVALID rows after and among the sites,
outputs dropped by the stage cap, the (3, 1, 1) / (2, 1, 1) z-layers, a
1-offset kernel and a single site; and the guard that refuses a table
without the submanifold symmetry. Tables and indices are exact; the data
gradients are sums in another order than the plain version's (1e-5).
"""

import numpy as np
import pytest
import torch

from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import lookup
from de6d_tpu_torch.ops.kernels import sparse_conv as sc
from torch_fixtures import sparse_site_keys

GRID = (9, 14, 12)
INVALID = sparse.INVALID

# name: (kernel, stride, padding, sites a sample, output cap)
STRIDED = {
    "empty_sample": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (300, 0, 150), 300),
    "invalid_tail": ((3, 3, 3), (2, 2, 2), (0, 1, 1), (299, 120, 7), 300),
    "capped": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (300, 200, 90), 40),
    "z_layer": ((3, 1, 1), (2, 1, 1), (0, 0, 0), (300, 160, 1), 300),
    "z_layer_2": ((2, 1, 1), (2, 1, 1), (0, 0, 0), (300, 160, 1), 300),
    "one_output": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (300, 1, 2), 1),
}


def strided_case(name, seed=0):
    """(keys, out_keys, out_grid, forward idx, hit, valid, geometry)."""
    kernel, stride, padding, counts, cap = STRIDED[name]
    keys = torch.from_numpy(sparse_site_keys(np.random.RandomState(seed),
                                             GRID, 300, counts))
    out_keys, out_grid = sparse.downsample_coords(keys, GRID, stride,
                                                  padding, cap, kernel)
    idx, hit = sparse.strided_neighbor_table(keys, out_keys, GRID, out_grid,
                                             kernel, stride, padding)
    geometry = sc.Strided(keys, out_keys, GRID, out_grid, kernel, stride,
                          padding)
    return keys, out_keys, out_grid, idx, hit, out_keys != INVALID, geometry


@pytest.mark.parametrize("name", sorted(STRIDED))
def test_transposed_table_at_the_edges(name):
    """The transposed table from the geometry equals the scatter of the
    forward table exactly; a sample without sites has no hit, and with
    the cap some sites feed no output (their data gradient is zero)."""
    keys, out_keys, _, idx, hit, valid, geometry = strided_case(name)
    v = keys.shape[1]
    got = lookup.transposed_table(*geometry)
    want = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tidx, thit, tvalid = got
    assert not bool(thit[keys == INVALID].any())
    sites = keys != INVALID
    if name == "empty_sample":
        assert not bool(thit[1].any()) and bool(tvalid[0].any())
    assert not bool((tvalid & ~sites).any())
    if name in ("capped", "one_output"):
        assert bool(valid.all())  # every sample's outputs reach the cap
        assert bool((sites & ~tvalid).any())  # outputs the cap dropped
    dy = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (*idx.shape[:2], 3)).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (idx.shape[2], 4, 3)).astype(np.float32))
    t_idx, t_hit, rows, w_t, mirror = sc.dgrad_operands(w, idx, hit, valid,
                                                        v, geometry)
    assert not mirror
    np.testing.assert_allclose(
        sc.sparse_conv_plain(dy, t_idx, t_hit, w_t, rows).numpy(),
        sc.sparse_conv_dgrad_plain(dy, idx, hit, w, valid, v).numpy(),
        atol=1e-5, rtol=1e-5)


def test_transposed_table_skips_invalid_asking_rows():
    """INVALID rows among the asking sites (any order) get no hit, idx 0;
    the other rows are what they are without them."""
    keys, out_keys, out_grid, *_, geometry = strided_case("invalid_tail")
    masked = keys.clone()
    drop = torch.zeros_like(keys, dtype=torch.bool)
    drop[:, 3::5] = True
    masked[drop] = INVALID
    got = lookup.transposed_table(*geometry._replace(keys_sorted=masked))
    want = lookup.transposed_table(*geometry)
    for a, b in zip(got, want):
        assert torch.equal(a[~drop], b[~drop])
        assert not bool(a[drop].any())
    assert bool(want[1][drop].any())


def test_transposed_keys_invert_the_neighbour_keys():
    """Output site o's neighbour at offset k is input p exactly when p's
    transposed key at offset k is o: the two key generators are inverse
    on every (site, offset) of the grid, z-layer and padded cases
    alike."""
    for name in ("invalid_tail", "z_layer", "z_layer_2"):
        keys, out_keys, out_grid, *_, geometry = strided_case(name, seed=3)
        kernel, stride, padding = geometry[4:]
        fwd = lookup.neighbor_keys_plain(out_keys, GRID, out_grid, kernel,
                                         stride, padding, centered=False)
        inv = lookup.transposed_keys_plain(keys, GRID, out_grid, kernel,
                                           stride, padding)
        for b in range(keys.shape[0]):
            sites, outs = set(keys[b].tolist()), out_keys[b].tolist()
            pairs_f = {(int(n), outs[qi], k)
                       for (qi, k), n in np.ndenumerate(fwd[b].numpy())
                       if n != INVALID and n in sites
                       and outs[qi] != INVALID}
            pairs_i = {(int(keys[b, pi]), int(o), k)
                       for (pi, k), o in np.ndenumerate(inv[b].numpy())
                       if o != INVALID and o in set(outs)}
            assert pairs_f == pairs_i and (pairs_f or b > 0)


def subm_case(kernel, counts, v=300, seed=4):
    keys = torch.from_numpy(sparse_site_keys(np.random.RandomState(seed),
                                             GRID, v, counts))
    idx, hit = sparse.subm_neighbor_table(keys, GRID, kernel)
    return keys, idx, hit, keys != INVALID


@pytest.mark.parametrize("case", ["k1", "v1", "empty_sample", "k_311"])
def test_mirrored_dgrad_at_the_edges(case):
    """A 1-offset kernel, a single site, a sample with no sites and an
    odd non-cubic kernel: the mirrored table is the scattered transpose,
    so the data gradient on it is bit-equal to the forward on the
    scattered one and within 1e-5 of the plain data gradient."""
    kernel, counts, v = {"k1": ((1, 1, 1), (300, 40), 300),
                         "v1": ((3, 3, 3), (1, 1), 1),
                         "empty_sample": ((3, 3, 3), (0, 250, 300), 300),
                         "k_311": ((3, 1, 1), (300, 100), 300)}[case]
    keys, idx, hit, valid = subm_case(kernel, counts, v)
    k = idx.shape[2]
    rng = np.random.RandomState(k)
    w = torch.from_numpy(rng.standard_normal((k, 4, 5)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((len(counts), v, 5)).astype(
        np.float32))
    transpose = sc.Submanifold()
    out = sparse.subm_conv_table(torch.zeros(len(counts), v, 4), idx, hit,
                                 w, valid)
    assert out.shape == (len(counts), v, 5)
    t_idx, t_hit, rows, w_t, mirror = sc.dgrad_operands(w, idx, hit, valid,
                                                        v, transpose)
    assert mirror
    scattered = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
    assert torch.equal(scattered[1], hit.flip(-1))
    assert torch.equal(scattered[2], valid)
    got = sc.sparse_conv_plain(dy, idx.flip(-1), hit.flip(-1), w_t, rows)
    assert torch.equal(got, sc.sparse_conv_plain(dy, *scattered[:2], w_t,
                                                 scattered[2]))
    np.testing.assert_allclose(
        got.numpy(), sc.sparse_conv_dgrad_plain(dy, idx, hit, w, valid,
                                                v).numpy(),
        atol=1e-5, rtol=1e-5)
    if case == "empty_sample":
        assert not bool(got[0].any())


@pytest.mark.parametrize("case", ["even_kernel", "more_rows", "not_square",
                                  "partial_ask", "valid_subset"])
def test_submanifold_guard_refuses_a_table_without_the_symmetry(case):
    """``subm_conv_table`` (``Submanifold``) raises on a table of an even
    number of offsets (no centre: offset K-1-k does not mirror offset k),
    on a table that is not square (more or fewer rows than sites), on a
    table whose rows did not all ask (``subm_neighbor_table(valid=...)``)
    and on valid rows that are not the asking ones: their transposes are
    not the mirrored table."""
    keys, idx, hit, valid = subm_case((3, 3, 3), (300, 200))
    feats, w = torch.zeros(2, 300, 4), torch.zeros(27, 4, 5)
    if case == "even_kernel":  # the first 18 offsets: a (2, 3, 3) kernel
        w = torch.zeros(18, 4, 5)
        idx, hit = idx[..., :18], hit[..., :18]
    elif case == "more_rows":  # sites in the first 200 of 300 rows
        keys, idx, hit, valid = subm_case((3, 3, 3), (200, 150))
        feats = feats[:, :200]
    elif case == "not_square":
        idx, hit, valid = idx[:, :200], hit[:, :200], valid[:, :200]
    elif case == "partial_ask":
        ask = valid.clone()
        ask[:, ::3] = False
        idx, hit = sparse.subm_neighbor_table(keys, GRID, valid=ask)
    else:
        valid = valid.clone()
        valid[:, 1::4] = False
    with pytest.raises(ValueError, match="submanifold table"):
        sparse.subm_conv_table(feats, idx, hit, w, valid)
    # the forward alone needs no transpose
    sc.sparse_conv(feats, idx, hit, w, valid)


def test_mirror_fault_check_waits_for_the_kernels(monkeypatch):
    """Without the kernel library loaded (no card launch has run) there is
    no fault word, and the check that the trainer runs after each sync
    does nothing: it neither builds nor loads the kernels."""
    from de6d_tpu_torch.ops.kernels import build
    monkeypatch.setattr(build, "_lib", None)
    assert sc.raise_mirror_fault() is None
    assert not build.loaded()
