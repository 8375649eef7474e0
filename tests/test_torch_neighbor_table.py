"""The port's neighbour tables (``ops/kernels/lookup.py:neighbor_table``
and its plain version, reached through ``ops/sparse.py``) against the
JAX package's ``de6d_tpu/ops/sparse.py:subm_neighbor_table`` and
``strided_neighbor_table`` on the CPU, at SECOND's four stage grids and
its strided layers, the (3, 1, 1) z-conv, sites on every face, edge and
corner of the grid (neighbours outside it), INVALID tails and a sample
without sites. Keys come from numpy seeds, 768 sites at most a sample.

Tables are integers and must be identical: ``hit`` everywhere, ``idx``
where ``hit`` (the JAX contract leaves a miss's index free), and ``idx``
everywhere equal to ``searchsorted`` of the neighbour keys that the JAX
functions generate, clipped to V - 1: the index the CUDA kernel writes on
a miss, out-of-grid and INVALID rows included. One case also runs the
lookup through ``lookup_pallas`` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import sparse as jsp
from de6d_tpu.ops.pallas.lookup import lookup_pallas
from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import lookup as lk
from torch_fixtures import sparse_site_keys

INVALID = lk.INVALID
# SECOND's stage grids (zyx) and the strided layer out of each stage
STAGES = ((41, 1600, 1408), (21, 800, 704), (11, 400, 352), (5, 200, 176))
DOWN = (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
        ((3, 1, 1), (2, 1, 1), (0, 0, 0)))


def jax_neighbor_keys(keys, grid, ask, ask_grid, kernel, stride, padding,
                      centered):
    """The neighbour keys that the JAX functions look up, (B, Q, K), from
    the JAX package's own key arithmetic."""
    def one(a):
        coords = jsp.keys_to_coords(a, ask_grid)
        if centered:
            offs = jsp._kernel_offsets(kernel)
        else:
            offs = jnp.stack([m.ravel() for m in jnp.meshgrid(
                *(jnp.arange(k) for k in kernel), indexing="ij")], -1)
        base = coords * jnp.asarray(stride) - jnp.asarray(padding)
        nbr = base[:, None, :] + offs[None]
        valid = jnp.repeat(a != jsp.INVALID, offs.shape[0])
        return jsp.coords_to_keys(nbr.reshape(-1, 3), grid, valid).reshape(
            a.shape[0], -1)
    return np.asarray(jax.vmap(one)(jnp.asarray(ask)))


def searchsorted_idx(keys, nbr_keys):
    """min(lower_bound, V - 1) per sample: the index on a miss."""
    v = keys.shape[1]
    return np.stack([np.minimum(np.searchsorted(t, q.reshape(-1)), v - 1)
                     .reshape(q.shape) for t, q in zip(keys, nbr_keys)])


def check(keys, idx, hit, ref_idx, ref_hit, nbr_keys):
    idx, hit = idx.numpy(), hit.numpy()
    assert idx.dtype == np.int32 and hit.dtype == bool
    np.testing.assert_array_equal(hit, ref_hit)
    np.testing.assert_array_equal(idx[hit], ref_idx[hit])
    np.testing.assert_array_equal(idx, searchsorted_idx(keys, nbr_keys))
    assert hit.any() and not hit.all()
    assert (nbr_keys == INVALID).any(), "test needs out-of-grid neighbours"


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("counts", [(700, 0), (768, 300)],
                         ids=["tail_and_empty", "full_and_tail"])
def test_subm_table_equals_jax(stage, counts):
    grid = STAGES[stage]
    keys = sparse_site_keys(np.random.RandomState(stage), grid, 768, counts)
    idx, hit = sparse.subm_neighbor_table(torch.from_numpy(keys), grid)
    ref_idx, ref_hit = (np.asarray(a) for a in jax.vmap(
        lambda k: jsp.subm_neighbor_table(k, grid))(jnp.asarray(keys)))
    nbr = jax_neighbor_keys(keys, grid, keys, grid, (3, 3, 3), (1, 1, 1),
                            (0, 0, 0), True)
    check(keys, idx, hit, ref_idx, ref_hit, nbr)
    for b, n in enumerate(counts):
        assert not hit[b, n:].any()
        assert hit[b, :n, 13].all()  # the centre tap


@pytest.mark.parametrize("stage", range(4))
def test_strided_table_equals_jax(stage):
    grid = STAGES[stage]
    kernel, stride, padding = DOWN[stage]
    keys = sparse_site_keys(np.random.RandomState(10 + stage), grid, 768,
                            (768, 500, 0))
    out_keys = np.array(jax.vmap(lambda k: jsp.downsample_coords(
        k, grid, stride, padding, 600, kernel)[0])(jnp.asarray(keys)))
    _, out_grid = jsp.downsample_coords(jnp.asarray(keys[0]), grid, stride,
                                        padding, 600, kernel)
    assert (out_keys[2] == INVALID).all()
    idx, hit = sparse.strided_neighbor_table(
        torch.from_numpy(keys), torch.from_numpy(out_keys), grid, out_grid,
        kernel, stride, padding)
    ref_idx, ref_hit = (np.asarray(a) for a in jax.vmap(
        lambda k, o: jsp.strided_neighbor_table(
            k, o, grid, out_grid, kernel, stride, padding))(
        jnp.asarray(keys), jnp.asarray(out_keys)))
    nbr = jax_neighbor_keys(keys, grid, out_keys, out_grid, kernel, stride,
                            padding, False)
    check(keys, idx, hit, ref_idx, ref_hit, nbr)
    # every active output has an input in its receptive field
    valid_out = out_keys != INVALID
    assert (hit.numpy().any(-1) == valid_out).all()


def test_subm_table_with_a_valid_mask_equals_jax():
    grid = STAGES[1]
    keys = sparse_site_keys(np.random.RandomState(7), grid, 512, (500, 400))
    valid = (keys != INVALID) & (np.random.RandomState(8).rand(*keys.shape)
                                 < 0.7)
    idx, hit = sparse.subm_neighbor_table(torch.from_numpy(keys), grid,
                                          valid=torch.from_numpy(valid))
    ref_idx, ref_hit = (np.asarray(a) for a in jax.vmap(
        lambda k, m: jsp.subm_neighbor_table(k, grid, valid=m))(
        jnp.asarray(keys), jnp.asarray(valid)))
    ask = np.where(valid, keys, INVALID)
    nbr = jax_neighbor_keys(keys, grid, ask, grid, (3, 3, 3), (1, 1, 1),
                            (0, 0, 0), True)
    check(keys, idx, hit, ref_idx, ref_hit, nbr)
    assert not hit.numpy()[~valid].any()


def test_subm_table_through_the_pallas_lookup():
    """The JAX neighbour keys looked up by ``lookup_pallas`` in interpret
    mode (V <= 16384) against the port's table."""
    grid = STAGES[2]
    keys = sparse_site_keys(np.random.RandomState(3), grid, 384, (380, 100))
    idx, hit = lk.neighbor_table(torch.from_numpy(keys),
                                 torch.from_numpy(keys), grid, grid,
                                 (3, 3, 3))
    nbr = jax_neighbor_keys(keys, grid, keys, grid, (3, 3, 3), (1, 1, 1),
                            (0, 0, 0), True)
    for b in range(2):
        ref_idx, ref_hit = (np.asarray(a) for a in lookup_pallas(
            jnp.asarray(keys[b]), jnp.asarray(nbr[b].reshape(-1)),
            interpret=True))
        h = hit.numpy()[b].reshape(-1)
        np.testing.assert_array_equal(h, ref_hit)
        np.testing.assert_array_equal(idx.numpy()[b].reshape(-1)[h],
                                      ref_idx[h])


@pytest.mark.parametrize("kernel,stride,padding,centered", [
    ((3, 3, 3), (1, 1, 1), (0, 0, 0), True),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), False),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), False),
    ((1, 1, 5), (1, 1, 1), (0, 0, 0), True),
])
def test_wrapper_equals_the_composed_plain_path(kernel, stride, padding,
                                                centered):
    """``neighbor_table`` on the CPU is its plain version, which is the
    composed path it replaces on the card: coords, offsets, keys,
    ``lookup``."""
    grid = (8, 30, 36)
    keys = torch.from_numpy(sparse_site_keys(np.random.RandomState(1), grid,
                                             300, (300, 120, 0)))
    ask = keys if centered else torch.from_numpy(sparse_site_keys(
        np.random.RandomState(2), tuple((g + 1) // 2 for g in grid), 200,
        (150, 200, 40)))
    ask_grid = grid if centered else tuple((g + 1) // 2 for g in grid)
    idx, hit = lk.neighbor_table(keys, ask, grid, ask_grid, kernel, stride,
                                 padding, centered)
    nbr_keys = lk.neighbor_keys_plain(ask, grid, ask_grid, kernel, stride,
                                      padding, centered)
    ridx, rhit = lk.lookup(keys, nbr_keys.reshape(3, -1))
    k = kernel[0] * kernel[1] * kernel[2]
    assert idx.shape == hit.shape == (3, ask.shape[1], k)
    assert torch.equal(idx.reshape(3, -1), ridx)
    assert torch.equal(hit.reshape(3, -1), rhit)
    assert hit.any() and not hit[2].any()


def test_neighbor_bytes_reads_a_submanifold_table_once():
    """The bound counts the table once where it is also the asking keys,
    and a separate asking tensor (a strided layer's outputs, a masked
    copy) once beside it."""
    keys = torch.zeros((2, 100), dtype=torch.int32)
    out_keys = torch.zeros((2, 40), dtype=torch.int32)
    assert lk.neighbor_bytes(keys, keys, 27) == 2 * 100 * (4 + 27 * 5)
    assert lk.neighbor_bytes(keys, keys.clone(), 27) == (
        2 * 100 * 4 + 2 * 100 * (4 + 27 * 5))
    assert lk.neighbor_bytes(keys, out_keys, 3) == (
        2 * 100 * 4 + 2 * 40 * (4 + 3 * 5))
