"""The sparse convolution's launch plan and tile statistics, on the CPU.

``sparse_conv.plan`` mirrors the variant rule of ``csrc/sparse_conv.cu``
(held equal to the library's own on the card in
``tests/test_torch_cuda_kernels.py``); here it must give every SECOND
layer and the edge shapes a variant whose shared memory fits a block, with
the weights resident wherever two such blocks still share an SM. ``sparse_conv.tile_stats`` counts
what the bf16 kernel's 128-row tiles see on the tables that the plain
``subm_neighbor_table`` / ``strided_neighbor_table`` build from the
stored SECOND fixture's stage keys; it must equal a direct numpy count.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import sparse_conv as sc

FIXTURE = (Path(__file__).resolve().parents[1]
           / "de6d_tpu_torch/testdata/second_jax_ref.npz")
# SECOND's stage grids (z, y, x): the input grid, then each strided layer's
GRIDS = [(41, 1600, 1408), (21, 800, 704), (11, 400, 352), (5, 200, 176),
         (2, 200, 176)]
# each strided layer into stage s + 1: kernel, stride, padding
DOWNS = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))]
# (Cin, Cout, K) of SECOND's 12 layers, and edge shapes
SECOND_LAYERS = [(4, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27),
                 (32, 64, 27), (64, 64, 27), (64, 128, 3)]
EDGES = [(1, 1, 27), (1, 128, 27), (3, 40, 27), (48, 40, 27), (64, 128, 27),
         (160, 24, 7), (512, 128, 125), (64, 64, 1), (8, 8, 33)]
# the fp32 kernel's edge widths: Cin 1, 4, 48, 65 by Cout 1, 40, 128 by
# K 1, 3, 5, 27
FP32_EDGES = [(cin, cout, k) for cin in (1, 4, 48, 65)
              for cout in (1, 40, 128) for k in (1, 3, 5, 27)]


def _resident_bytes(cin, cout, k):
    """Weights, a 2-stage ring of 128 gathered rows and the table (padded
    source rows, live masks, the offset list)."""
    cin_pad = -(-cin // 16) * 16
    kc = min(64, cin_pad)
    cout8 = -(-cout // 8) * 8
    kb = min(k, 32)
    table = (kb * 129 + 97) * 4 + kb * 128  # + hit counts and hit rows
    return k * cin_pad * (cout8 + 8) * 2 + 2 * 128 * (kc + 8) * 2 + table


@pytest.mark.parametrize("cin,cout,k", SECOND_LAYERS + EDGES,
                         ids=lambda v: str(v))
def test_plan_fits_a_block_and_keeps_weights_resident_where_they_fit(
        cin, cout, k):
    p = sc.plan(cin, cout, k)
    assert p is not None and p.smem_bytes <= sc.SMEM_LIMIT
    resident = _resident_bytes(cin, cout, k)
    # resident where the padded weights are at most 32 KB and cost no
    # block an SM: as many blocks as the registers allow (4 up to Cout 32,
    # 3 up to 64, 2 up to 128) still fit
    blocks = 4 if cout <= 32 else 3 if cout <= 64 else 2
    weights = k * (-(-cin // 16) * 16) * (-(-cout // 8) * 8 + 8) * 2
    fits = (blocks * (resident + 1024) <= 228 * 1024
            and weights <= 32 * 1024)
    assert p.variant == ("resident" if fits else "streamed")
    assert sc.blocks_per_sm(cout) == blocks
    assert p.stages == sc.STAGES
    streamed = sc.plan(cin, cout, k, variant="streamed")
    assert streamed is not None and streamed.smem_bytes <= sc.SMEM_LIMIT
    forced = sc.plan(cin, cout, k, variant="resident")
    assert (forced is None) == (resident > sc.SMEM_LIMIT)
    assert forced is None or forced.smem_bytes == resident
    assert sc.plan(cin, cout, k, variant="simt") is None  # bf16
    assert sc.plan(cin, cout, k, torch.float32).variant == "simt"
    assert sc.plan(cin, cout, k, torch.float32, variant="resident") is None


def _fp32_bytes(cin, cout, k):
    """(resident, streamed, weights) bytes of the fp32 kernel: rows of Cin
    padded to 8 in 32-channel chunks (+4 floats a gathered row), weight
    rows of 8·NT floats, the same table as bf16 and a 32-float zero row."""
    cin_pad = -(-cin // 8) * 8
    kc = min(32, cin_pad)
    nt = -(-cout // 8)
    nt = 2 if nt <= 2 else 4 if nt <= 4 else 8 if nt <= 8 else 16
    kb = min(k, 32)
    table = (kb * 129 + 97) * 4 + kb * 128 + 128
    a_stage = 128 * (kc + 4) * 4
    weights = k * cin_pad * 8 * nt * 4
    return (weights + 2 * a_stage + table,
            2 * (a_stage + kc * 8 * nt * 4) + table, weights)


@pytest.mark.parametrize("cin,cout,k", SECOND_LAYERS + EDGES + FP32_EDGES,
                         ids=lambda v: str(v))
def test_fp32_plan_fits_a_block_and_an_sm(cin, cout, k):
    """The fp32 kernel ("simt", the only fp32 variant) takes every shape:
    its shared memory fits a block and two blocks share an SM; the
    weights stay resident exactly where they take at most 32 KB and cost
    no block of those its registers allow (3 an SM up to Cout 32, then
    2), as bf16's do."""
    p = sc.plan(cin, cout, k, torch.float32)
    resident, streamed, weights = _fp32_bytes(cin, cout, k)
    blocks = 3 if cout <= 32 else 2
    assert sc.blocks_per_sm(cout, torch.float32) == blocks
    fits = blocks * (resident + 1024) <= 228 * 1024 and weights <= 32 * 1024
    assert p == sc.Plan("simt", sc.STAGES, resident if fits else streamed,
                        fits)
    assert p.smem_bytes <= sc.SMEM_LIMIT
    assert 2 * (p.smem_bytes + 1024) <= 228 * 1024  # two blocks an SM
    assert sc.plan(cin, cout, k, torch.float32, variant="simt") == p
    for name in ("resident", "streamed"):
        assert sc.plan(cin, cout, k, torch.float32, variant=name) is None


def test_second_fp32_keeps_only_stage_1_weights_resident():
    """In fp32, as in bf16, stage 1's layers (4 -> 16 and 16 -> 16: 13.8 and
    27.6 KB of weights, Cin padded to 8) keep their weights resident;
    16 -> 32's 55 KB are over the limit."""
    assert [s for s in SECOND_LAYERS
            if sc.plan(*s, torch.float32).resident] == [(4, 16, 27),
                                                         (16, 16, 27)]


@pytest.mark.parametrize("cin,cout,k", SECOND_LAYERS + EDGES + FP32_EDGES,
                         ids=lambda v: str(v))
def test_wgrad_plan_takes_the_least_padded_tile(cin, cout, k):
    """The weight gradient's channel tile pads Cin x Cout least (the larger
    tile on a tie); its shared memory lets the blocks its registers allow
    share an SM, in both dtypes; a slice is a whole number of 128-row
    chunks and the slices cover the rows without an empty one."""
    p = sc.wgrad_plan(cin, cout)
    areas = {(ci, co): -(-cin // ci) * ci * -(-cout // co) * co
             for ci, co in sc.WGRAD_TILES}
    least = min(areas.values())
    assert (p.ci, p.co) == max(t for t, a in areas.items() if a == least)
    for dtype in (torch.float32, torch.bfloat16):
        q = sc.wgrad_plan(cin, cout, dtype)
        assert q.blocks_per_sm * (q.smem_bytes + 1024) <= 228 * 1024
    rows = 4 * 16000
    slices, per = sc.wgrad_slices(rows, k, cin, cout, 132)
    assert per % sc.WGRAD_ROWS == 0
    assert (slices - 1) * per < rows <= slices * per


def test_second_wgrad_tiles():
    """SECOND's layers take one tile each up to 32 -> 64, 64 -> 64 two and
    the z-conv (64 -> 128) four."""
    tiles = {s[:2]: sc.wgrad_plan(*s[:2])[:2] for s in SECOND_LAYERS}
    assert tiles == {(4, 16): (16, 16), (16, 16): (16, 16),
                     (16, 32): (16, 32), (32, 32): (32, 32),
                     (32, 64): (32, 64), (64, 64): (32, 64),
                     (64, 128): (32, 64)}
    assert [sc.wgrad_blocks(*s) for s in SECOND_LAYERS] == [
        4, 4, 4, 4, 4, 8, 4]


def test_second_keeps_only_stage_1_weights_resident():
    """Stage 1's layers (27 x 16 x 16 weights, 20.7 KB padded) keep their
    weights resident; the others stream them (larger weights, or a block
    lost an SM)."""
    variants = {s: sc.plan(*s).variant for s in SECOND_LAYERS}
    assert [s for s, v in variants.items() if v == "resident"] == [
        (4, 16, 27), (16, 16, 27)]


def _fixture_tables():
    """The 8 tables of one SECOND forward on the fixture's 2 scans: each
    stage's submanifold table, then the strided one into the next stage
    (rows: that stage's sites)."""
    d = np.load(FIXTURE)
    keys = [torch.from_numpy(d[f"keys_{s}"]) for s in range(1, 6)]
    tables = {}
    for s in range(4):
        idx, hit = sparse.subm_neighbor_table(keys[s], GRIDS[s])
        tables[f"subm_s{s + 1}"] = (idx, hit, keys[s] != sparse.INVALID)
        kernel, stride, pad = DOWNS[s]
        idx, hit = sparse.strided_neighbor_table(
            keys[s], keys[s + 1], GRIDS[s], GRIDS[s + 1], kernel, stride, pad)
        tables[f"down_s{s + 2}"] = (idx, hit, keys[s + 1] != sparse.INVALID)
    return tables


def _direct_count(idx, hit, valid, tile_rows):
    """The same statistics by walking the tiles and groups in numpy."""
    live = (hit & valid[..., None]).numpy()
    vnp = valid.numpy()
    b, q, k = live.shape
    out = dict(hits=0, valid_rows=int(vnp.sum()), live_groups=0, steps=0,
               dense_rows=0)
    for s in range(b):
        for t0 in range(0, q, tile_rows):
            tile = live[s, t0:t0 + tile_rows]
            out["hits"] += int(tile.sum())
            out["steps"] += int(tile.any(axis=0).sum())
            if vnp[s, t0:t0 + tile_rows].any():
                out["dense_rows"] += tile_rows * k
            for g0 in range(0, tile.shape[0], 16):
                out["live_groups"] += int(tile[g0:g0 + 16].any(axis=0).sum())
    out["mma_rows"] = 16 * out["live_groups"]
    out["dead_rows"] = out["mma_rows"] - out["hits"]
    return out


@pytest.fixture(scope="module")
def fixture_tables():
    return _fixture_tables()


@pytest.mark.parametrize("layer", ["subm_s1", "down_s2", "subm_s2",
                                   "down_s3", "subm_s3", "down_s4",
                                   "subm_s4", "down_s5"])
def test_tile_stats_equal_a_direct_count_on_second_tables(fixture_tables,
                                                          layer):
    idx, hit, valid = fixture_tables[layer]
    got = sc.tile_stats(idx, hit, valid)
    assert got == _direct_count(idx, hit, valid, sc.TILE_ROWS)
    # a live group runs 16 rows for at least one hit; a dense tile at
    # least as many as the live groups
    assert got["hits"] <= got["mma_rows"] <= got["dense_rows"]
    assert got["steps"] <= got["dense_rows"] // sc.TILE_ROWS


def test_tile_stats_by_hand():
    """Two 32-row tiles (tile_rows=32) of one sample, 3 offsets: hits at
    rows 0 and 1 (offset 0, group 0), row 20 (offset 2, group 1), row 40
    (offset 0, tile 2, group 2) and row 50, which is not valid."""
    hit = torch.zeros(1, 64, 3, dtype=torch.bool)
    for r, k in ((0, 0), (1, 0), (20, 2), (40, 0), (50, 1)):
        hit[0, r, k] = True
    valid = torch.arange(64)[None] < 48
    idx = torch.zeros(1, 64, 3, dtype=torch.int32)
    got = sc.tile_stats(idx, hit, valid, tile_rows=32)
    assert got == {"hits": 4, "valid_rows": 48, "live_groups": 3,
                   "mma_rows": 48, "dead_rows": 44, "steps": 3,
                   "dense_rows": 2 * 32 * 3}


@pytest.mark.parametrize("layer", ["subm_s1", "down_s2", "subm_s2",
                                   "down_s3", "subm_s3", "down_s4",
                                   "subm_s4", "down_s5"])
@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 64)])
def test_wgrad_partition_counts_every_live_pair_once(fixture_tables, layer,
                                                     cin, cout):
    """The weight gradient's blocks (slices of the rows x groups of 8
    offsets, one a warp) together see every live (row, offset) pair of the
    SECOND fixture's tables exactly once: per offset, the warps' counts
    add up to a direct count of that offset's live rows, on an H100's 132
    SMs and on a card of 16."""
    idx, hit, valid = fixture_tables[layer]
    b, q, k = idx.shape
    live = (hit & valid[..., None]).numpy()
    for sms in (132, 16):
        got = sc.wgrad_partition(idx, hit, valid, cin, cout, sms)
        slices, per = sc.wgrad_slices(b * q, k, cin, cout, sms)
        assert got.shape == (slices, -(-k // 8), 8)
        per_offset = got.sum(0).reshape(-1)
        assert per_offset[:k].tolist() == live.sum((0, 1)).tolist()
        assert int(per_offset[k:].sum()) == 0
        assert int(got.sum()) == _direct_count(idx, hit, valid,
                                               sc.TILE_ROWS)["hits"]
        # slice s holds exactly the live pairs of its rows
        flat = live.reshape(b * q, k)
        for s in (0, slices // 2, slices - 1):
            rows = flat[s * per:(s + 1) * per]
            assert got[s].reshape(-1)[:k].tolist() == rows.sum(0).tolist()
