"""SECOND training: the PyTorch port against the JAX package on the CPU.

Module by module: ``MaskedBatchNorm`` in train mode; the sparse conv's
backward (its autograd, the plain data and weight gradients, and the
transposed table on which the card computes the data gradient) against
``jax.grad`` of ``subm_conv_table`` / ``strided_conv`` at SECOND's
kernel / stride / padding triples; the table transposes on
the tiny scene's real stage tables and at the edges; whole train steps of
the tiny SECOND (``tests/test_sparse_conv.py``'s widths) with
``VoxelBackBone8x`` and ``VoxelResBackBone8x``; a JAX train state resuming
in the port; the weights both ways; checkpoints; the host pipeline with
``second.yaml``'s ``DATA_CONFIG`` against the JAX loader; ``tools/train.py``
and ``tools/test.py`` on a tiny SECOND config.

Tolerances, each with its reason:
- labels, site keys and the transposed tables are exact (integers);
- the backward in fp32: 1e-5 (absolute and relative; sums in another
  order);
- ``MaskedBatchNorm``: 1e-5 in fp32 (sums in another order); bf16 outputs
  one bf16 rounding of fp32 values (2^-7 relative);
- the train steps in fp32: the PointPillars train parity's (loss terms
  and the gradient norm 1e-4 relative, every gradient 1e-4 of its leaf's
  largest entry, statistics 1e-5, 3 steps' losses 1e-4, parameters after
  them 1e-5 of the leaf's largest entry but for entries whose gradient
  sits at the summation noise).

The full-width references for the card (``write_train_fixture``,
``write_eval_fixture``) are held on the CPU in the slow tier, with the
float64 measurement behind ``chip_smoke.SECOND_TRAIN_TOL``.
"""

import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.config import Config as JaxConfig
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d import spconv_backbone as jax_spconv
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.ops import sparse as jsp
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.spconv_backbone import (
    MaskedBatchNorm,
)
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import sparse_conv as sc
from test_torch_second import TINY_SPEC, scene, tiny_second_cfg
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
SECOND_CFG = ROOT / "configs/kitti_models/second.yaml"
SECOND_PARAMS = ROOT / "bench_assets/second_params.npz"
KITTI = ROOT / "data/kitti"
TRAIN_FIXTURE = ROOT / "de6d_tpu_torch/testdata/second_train_jax_ref.npz"
EVAL_FIXTURE = ROOT / "de6d_tpu_torch/testdata/second_eval_jax_ref.npz"
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# MaskedBatchNorm in train mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", ["partial", "empty"])
def test_masked_batchnorm_train_equals_flax(dtype, masked):
    """The batch's statistics over the masked rows of every sample (the
    two-pass variance, ``cnt`` clipped at 1: an empty mask gives mean 0,
    var 0), the running statistics moved with momentum 0.99, the output
    zero outside the mask, in the input's dtype; then eval mode on the
    moved statistics."""
    rng = np.random.RandomState(3)
    c = 8
    x = (rng.standard_normal((2, 50, c)) * 3 + 1).astype(np.float32)
    mask = (rng.random_sample((2, 50)) < 0.6 if masked == "partial"
            else np.zeros((2, 50), bool))
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    jx = jnp.asarray(x, getattr(jnp, dtype))
    mod = jax_spconv.MaskedBatchNorm()
    want, mutated = mod.apply(variables, jx, jnp.asarray(mask), True,
                              mutable=["batch_stats"])
    want_eval = mod.apply({"params": variables["params"],
                           "batch_stats": mutated["batch_stats"]}, jx,
                          jnp.asarray(mask), False)

    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(T(variables["params"]["scale"]))
        bn.bias.copy_(T(variables["params"]["bias"]))
        bn.running_mean.copy_(T(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(T(variables["batch_stats"]["var"]))
    tx = T(x).to(getattr(torch, dtype))
    bn.train()
    got = bn(tx, T(mask))
    bn.eval()
    got_eval = bn(tx, T(mask))
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, w in ((got, want), (got_eval, want_eval)):
        np.testing.assert_allclose(g.float().detach().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, name).numpy(),
            np.asarray(mutated["batch_stats"][key]), rtol=1e-6, atol=1e-6,
            err_msg=name)


# ---------------------------------------------------------------------
# the sparse conv's backward against jax.grad
# ---------------------------------------------------------------------

# SECOND's layers: (kernel, stride, padding); no stride: submanifold
LAYERS = {
    "subm": ((3, 3, 3), None, None),
    "down": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "down_s4": ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    "down_z": ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}
GRID = (7, 12, 10)


def conv_case(layer, seed=0):
    """Sites of GRID (a full and a partial sample, a site on every face),
    features that are non-zero on the empty rows too, weights and a
    cotangent that is non-zero on the invalid output rows too."""
    from torch_fixtures import sparse_site_keys

    kernel, stride, padding = LAYERS[layer]
    rng = np.random.RandomState(seed)
    keys = sparse_site_keys(rng, GRID, 140, (140, 90))
    k3 = int(np.prod(kernel))
    cin, cout = 6, 5
    feats = rng.standard_normal((2, 140, cin)).astype(np.float32)
    w = (rng.standard_normal((k3, cin, cout)) * 0.2).astype(np.float32)
    out_keys = out_grid = None
    q = 140
    if stride is not None:
        out_keys, out_grid = sparse.downsample_coords(
            T(keys), GRID, stride, padding, 100, kernel)
        out_keys = out_keys.numpy()
        q = 100
    ct = rng.standard_normal((2, q, cout)).astype(np.float32)
    return keys, feats, w, ct, out_keys, out_grid


def jax_conv_grads(layer, keys, feats, w, ct, out_keys, out_grid):
    kernel, stride, padding = LAYERS[layer]

    def loss(f, wt):
        outs = []
        for b in range(keys.shape[0]):
            k = jnp.asarray(keys[b])
            if stride is None:
                ti, th = jsp.subm_neighbor_table(k, GRID, kernel)
                outs.append(jsp.subm_conv_table(f[b], ti, th, wt,
                                                k != jsp.INVALID))
            else:
                outs.append(jsp.strided_conv(
                    f[b], k, GRID, wt, kernel, stride, padding,
                    jnp.asarray(out_keys[b]), out_grid))
        return jnp.sum(jnp.stack(outs) * ct)

    gf, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                            jnp.asarray(w))
    return np.asarray(gf), np.asarray(gw)


def port_table(layer, keys, out_keys, out_grid):
    """(idx, hit, output valid) of the port's layer."""
    kernel, stride, padding = LAYERS[layer]
    k = T(keys)
    if stride is None:
        idx, hit = sparse.subm_neighbor_table(k, GRID, kernel)
        return idx, hit, k != sparse.INVALID
    ok = T(out_keys)
    idx, hit = sparse.strided_neighbor_table(k, ok, GRID, out_grid, kernel,
                                             stride, padding)
    return idx, hit, ok != sparse.INVALID


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_backward_equals_jax_grad(layer):
    """Feature and weight gradients of the port's conv against
    ``jax.grad`` of the JAX package's, three ways: autograd through
    ``ops.sparse`` (``subm_conv_table`` / ``strided_conv``), the plain
    data and weight gradients, and the forward on the table and weights
    of ``dgrad_operands`` (the arithmetic the card runs)."""
    keys, feats, w, ct, out_keys, out_grid = conv_case(layer)
    want_f, want_w = jax_conv_grads(layer, keys, feats, w, ct, out_keys,
                                    out_grid)
    kernel, stride, padding = LAYERS[layer]
    f = T(feats).requires_grad_(True)
    wt = T(w).requires_grad_(True)
    k = T(keys)
    with torch.enable_grad():
        if stride is None:
            out = sparse.subm_conv_table(
                f, *sparse.subm_neighbor_table(k, GRID, kernel), wt,
                k != sparse.INVALID)
        else:
            out = sparse.strided_conv(f, k, GRID, wt, kernel, stride,
                                      padding, T(out_keys), out_grid)
        assert out.grad_fn is not None
        (out * T(ct)).sum().backward()
    idx, hit, valid = port_table(layer, keys, out_keys, out_grid)
    v = keys.shape[1]
    t_idx, t_hit, rows, w_t = sc.dgrad_operands(T(w), idx, hit, valid, v)
    dgrads = {
        "autograd": f.grad,
        "plain": sc.sparse_conv_dgrad_plain(T(ct), idx, hit, T(w), valid, v),
        "operands": sc.sparse_conv_plain(T(ct), t_idx, t_hit, w_t, rows),
        "dispatch": sc.sparse_conv_dgrad(T(ct), idx, hit, T(w), valid, v),
    }
    wgrads = {"autograd": wt.grad,
              "plain": sc.sparse_conv_wgrad_plain(T(feats), T(ct), idx, hit,
                                                  valid)}
    assert float(np.abs(want_f).max()) > 0 and float(np.abs(want_w).max()) > 0
    for how, g in dgrads.items():
        np.testing.assert_allclose(g.numpy(), want_f, atol=1e-5, rtol=1e-5,
                                   err_msg=how)
    for how, g in wgrads.items():
        np.testing.assert_allclose(g.numpy(), want_w, atol=1e-5, rtol=1e-5,
                                   err_msg=how)


def test_backward_in_bf16_rounds_once():
    """bf16 features and weights: the gradients are the fp32 ones rounded
    once to bf16 (the CUDA kernels' contract)."""
    keys, feats, w, ct, *_ = conv_case("subm", seed=2)
    idx, hit, valid = port_table("subm", keys, None, None)
    f16, w16, ct16 = (T(a).bfloat16() for a in (feats, w, ct))
    for got, ref in (
            (sc.sparse_conv_wgrad_plain(f16, ct16, idx, hit, valid),
             sc.sparse_conv_wgrad_plain(f16.float(), ct16.float(), idx, hit,
                                        valid)),
            (sc.sparse_conv_dgrad_plain(ct16, idx, hit, w16, valid, 140),
             sc.sparse_conv_dgrad_plain(ct16.float(), idx, hit, w16.float(),
                                        valid, 140))):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, ref.bfloat16())


# ---------------------------------------------------------------------
# the transposed tables
# ---------------------------------------------------------------------

def tiny_batch(seed=0):
    """``test_torch_second.scene`` (a ground patch and four car-sized
    clusters) with three Car boxes (one of the second sample's slots
    empty)."""
    pts, mask = scene(seed)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, :3] = [[4.0, 0.5, -0.95, 3.9, 1.6, 1.56, 0.0, 1],
                 [8.0, 3.0, -0.95, 3.9, 1.6, 1.56, 1.57, 1],
                 [10.5, -4.0, -0.95, 3.9, 1.6, 1.56, 0.3, 1]]
    gt[1, 2] = 0
    return {"points": pts, "points_mask": mask, "gt_boxes": gt}


def tiny_model(backbone="VoxelBackBone8x"):
    cfg = tiny_second_cfg(backbone)
    return build_network(Config(copy.deepcopy(cfg)), 1,
                         DatasetSpec(**TINY_SPEC), device="cpu")


@pytest.fixture(scope="module")
def stage_tables():
    """The tiny SECOND's 8 neighbour tables on the tiny scene, in call
    order (each stage's submanifold table, then the strided layer into
    the next stage), with their sites."""
    from chip_smoke import SECOND_LOOKUPS, recorded_sparse_calls

    model = tiny_model()
    weights.load_into(model, weights.seeded_flax(model, 11))
    batch = tiny_batch()
    with torch.no_grad(), recorded_sparse_calls() as calls:
        model({k: T(v) for k, v in batch.items()})
    tables = {}
    for name, (args, kwargs) in zip(SECOND_LOOKUPS, calls["neighbor_table"]):
        table, ask = args[0], args[1]
        idx, hit = sparse.neighbor_table(*args, **kwargs)
        tables[name] = (idx, hit, ask != sparse.INVALID, table.shape[1])
    assert len(tables) == 8
    return tables


@pytest.mark.parametrize("stage", ["subm_s1", "subm_s2", "subm_s3",
                                   "subm_s4"])
def test_mirrored_table_is_the_scattered_transpose(stage_tables, stage):
    """On a stage's submanifold table offset K-1-k is the negation of
    offset k, so the table through the mirrored offsets equals its
    scattered transpose: ``thit == hit.flip(-1)`` and ``tidx ==
    idx.flip(-1)`` wherever it hits."""
    idx, hit, valid, v = stage_tables[stage]
    assert int(hit.sum()) > int(valid.sum())  # neighbours beside the centre
    tidx, thit, tvalid = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
    assert torch.equal(thit, hit.flip(-1))
    assert torch.equal(tidx, torch.where(thit, idx.flip(-1), 0))
    assert torch.equal(tvalid, valid)


@pytest.mark.parametrize("stage", ["down_s2", "down_s3", "down_s4",
                                   "down_z"])
def test_strided_transpose_is_injective_and_complete(stage_tables, stage):
    """A strided table's transpose: every live pair (q, k) is found at
    ``tidx[b, idx[b,q,k], k] == q`` (for one offset the outputs reference
    distinct inputs), and nothing else hits."""
    idx, hit, valid, v = stage_tables[stage]
    tidx, thit, tvalid = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
    live = hit & valid[..., None]
    assert int(live.sum()) > 0
    assert int(thit.sum()) == int(live.sum())
    b, q, k = idx.shape
    at = (torch.arange(b)[:, None, None] * v + idx.long()) * k + torch.arange(
        k)
    assert bool(thit.reshape(-1)[at[live]].all())
    qs = torch.arange(q, dtype=torch.int32)[None, :, None].expand(b, q, k)
    assert torch.equal(tidx.reshape(-1)[at[live]], qs[live])
    assert torch.equal(tvalid, thit.any(-1))


@pytest.mark.parametrize("stage", ["subm_s1", "down_s2", "subm_s3",
                                   "down_z"])
def test_work_transpose_counts_what_the_transpose_touches(stage_tables,
                                                          stage):
    """The transpose's bytes: ``valid`` once, ``hit`` of the valid rows,
    ``idx`` of the live pairs alone (one per hit the transpose writes),
    and its three outputs once; fewer than the dense table's bytes
    wherever a valid row misses an offset."""
    idx, hit, valid, v = stage_tables[stage]
    tidx, thit, tvalid = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
    b, q, k = idx.shape
    read = valid.numel() + int(valid.sum()) * k + 4 * int(thit.sum())
    written = 4 * tidx.numel() + thit.numel() + tvalid.numel()
    got = sc.work_transpose(idx, hit, valid, v)
    assert got == read + written
    assert got < b * q * k * 5 + b * q + written


@pytest.mark.parametrize("edge", ["no_hit", "all_invalid", "one_site",
                                  "collision"])
def test_transpose_edges(edge):
    """A table without a hit and one whose rows are all invalid transpose
    to nothing; one site is its own neighbour at the centre; two live
    pairs of one offset on one input row (no convolution's table) raise."""
    rng = np.random.RandomState(1)
    idx = T(rng.randint(0, 10, (2, 6, 27)).astype(np.int32))
    hit = T(rng.random_sample((2, 6, 27)) < 0.3)
    valid = torch.ones((2, 6), dtype=torch.bool)
    if edge == "no_hit":
        hit = torch.zeros_like(hit)
    elif edge == "all_invalid":
        valid = torch.zeros_like(valid)
    elif edge == "one_site":
        idx = torch.zeros((2, 1, 27), dtype=torch.int32)
        hit = torch.zeros((2, 1, 27), dtype=torch.bool)
        hit[:, :, 13] = True
        valid = torch.ones((2, 1), dtype=torch.bool)
        tidx, thit, tvalid = sc.sparse_conv_transpose_plain(idx, hit, valid,
                                                            1)
        assert torch.equal(thit, hit.flip(-1)) and bool(tvalid.all())
        assert int(tidx.abs().sum()) == 0
        return
    else:
        idx = torch.zeros((1, 2, 27), dtype=torch.int32)
        hit = torch.zeros((1, 2, 27), dtype=torch.bool)
        hit[0, :, 5] = True
        with pytest.raises(ValueError, match="one input row"):
            sc.sparse_conv_transpose_plain(idx, hit, torch.ones(
                (1, 2), dtype=torch.bool), 10)
        return
    tidx, thit, tvalid = sc.sparse_conv_transpose_plain(idx, hit, valid, 10)
    assert not bool(thit.any()) and not bool(tvalid.any())
    assert int(tidx.abs().sum()) == 0
    dg = sc.sparse_conv_dgrad_plain(torch.ones(2, 6, 3), idx, hit,
                                    torch.ones(27, 4, 3), valid, 10)
    assert dg.shape == (2, 10, 4) and not bool(dg.any())


# ---------------------------------------------------------------------
# a whole train step of the tiny SECOND
# ---------------------------------------------------------------------

def tiny_pair(backbone):
    cfg = tiny_second_cfg(backbone)
    # the dense assigner, which labels as the windowed one does
    cfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = False
    jmodel = jax_build(JaxConfig(copy.deepcopy(cfg)), num_class=1,
                       dataset=JaxSpec(**TINY_SPEC))
    return jmodel, tiny_model(backbone)


def second_opt_cfg():
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    opt = dict(jax_cfg(str(SECOND_CFG)).OPTIMIZATION)
    opt["NUM_EPOCHS"] = 20
    return opt


def tiny_run(backbone, steps):
    """The JAX package's and the port's train step, then ``steps``
    ``adam_onecycle`` steps, from the same perturbed variables on the
    tiny batch."""
    import test_torch_pointpillar_train as ppt

    jmodel, tmodel = tiny_pair(backbone)
    batch = tiny_batch()
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=11)
    flat["params/dense_head/conv_cls/bias"][:] = -np.log((1 - 0.01) / 0.01)
    opt_cfg = second_opt_cfg()
    ref = ppt.jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg,
                                  steps=steps)
    got = ppt.port_train_run(tmodel, flat, batch, opt_cfg, steps=steps)
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg, "jmodel": jmodel,
            "steps": steps}


@pytest.fixture(scope="module")
def tiny_train():
    """VoxelBackBone8x (SECOND's), 3 steps."""
    return tiny_run("VoxelBackBone8x", 3)


@pytest.fixture(scope="module")
def tiny_res_train():
    """VoxelResBackBone8x (residual blocks: the gradient of a sum of two
    branches through the convs), 1 step."""
    return tiny_run("VoxelResBackBone8x", 1)


BOTH = pytest.mark.parametrize("run", ["tiny_train", "tiny_res_train"])


@BOTH
def test_train_step_targets(run, request):
    """Labels (exact) and regression targets (1e-6) of the train-mode
    forward's head, against the JAX step's."""
    tiny_train = request.getfixturevalue(run)
    from de6d_tpu_torch.models.dense_heads.axis_aligned_assigner import (
        assign_targets,
    )

    ref, head = tiny_train["ref"], tiny_train["tmodel"].dense_head
    got = assign_targets(head.anchors, head.anchor_group, head.matched_thr,
                         head.unmatched_thr,
                         T(tiny_train["batch"]["gt_boxes"]), head.box_coder)
    assert (ref["labels"] > 0).sum() > 0
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                  ref["labels"])
    np.testing.assert_allclose(got["box_reg_targets"].numpy(),
                               ref["reg_targets"], rtol=1e-6, atol=1e-6)


@BOTH
def test_train_step_losses_and_grad_norm(run, request):
    tiny_train = request.getfixturevalue(run)
    ref, got = tiny_train["ref"]["metrics"], tiny_train["got"]["metrics"]
    assert set(got) == set(ref) == {"loss", "rpn_loss_cls", "rpn_loss_loc",
                                    "rpn_loss_dir", "rpn_loss", "grad_norm"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def leaf_close(got, ref, rel, what):
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |d| {err} > {rel} * {scale}"


def params_close(got, want, lr_sum):
    """Parameters after Adam steps: within 1e-5 of each leaf's largest
    |entry|, but for at most 0.5 % of a leaf whose gradient sits at the
    summation noise (Adam divides by each entry's own root-mean-square
    gradient, so such an entry moves by up to its learning rate either
    way), by no more than the learning rates summed."""
    for name, p in want.items():
        ref = p.numpy()
        err = np.abs(got[name].detach().numpy() - ref)
        parted = err > 1e-5 * np.abs(ref).max()
        assert parted.mean() <= 0.005, (name, parted.mean())
        assert err.max() <= lr_sum, (name, err.max(), lr_sum)


@BOTH
def test_train_step_gradients(run, request):
    """Every parameter's gradient, the 12 sparse-conv kernels among them
    (through the port's backward), against ``jax.grad``."""
    tiny_train = request.getfixturevalue(run)
    want = weights.flax_params_to_torch(tiny_train["ref"]["grads"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        leaf_close(got[name].numpy(), g.numpy(), 1e-4, name)
    n_sparse = sum(n.startswith("backbone_3d.") and g.dim() == 3
                   for n, g in want.items())
    backbone = type(tiny_train["tmodel"].backbone_3d).__name__
    assert n_sparse == {"VoxelBackBone8x": 12, "VoxelResBackBone8x": 19}[
        backbone]


@BOTH
def test_train_step_batch_stats(run, request):
    """The running statistics after the step, every ``MaskedBatchNorm_0``
    of the sparse layers among them."""
    tiny_train = request.getfixturevalue(run)
    want = weights.flax_to_torch(
        {**tiny_train["flat"], **tiny_train["ref"]["batch_stats"]},
        tiny_train["tmodel"])
    got = tiny_train["got"]["buffers"]
    masked = [n for n in got if "MaskedBatchNorm_0" in n]
    assert len(masked) >= 24
    for name, b in got.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@BOTH
def test_train_step_losses_along_the_steps(run, request):
    tiny_train = request.getfixturevalue(run)
    np.testing.assert_allclose(tiny_train["got"]["losses"],
                               tiny_train["ref"]["losses"], rtol=1e-4)
    assert len(tiny_train["got"]["losses"]) == tiny_train["steps"]


def lr_sum(tiny_train, steps):
    from de6d_tpu_torch.train.optimization import (
        build_optimizer_and_schedule,
    )

    _, sched = build_optimizer_and_schedule(tiny_train["opt_cfg"],
                                            tiny_train["tmodel"], 1)
    return sum(sched(k) for k in range(steps))


@BOTH
def test_train_step_params_after_the_steps(run, request):
    """Parameters after the steps (:func:`params_close`)."""
    tiny_train = request.getfixturevalue(run)
    want = weights.flax_params_to_torch(tiny_train["ref"]["params_after"],
                                        tiny_train["tmodel"])
    params_close(tiny_train["got"]["params_after"], want,
                 lr_sum(tiny_train, tiny_train["steps"]))


def test_jax_train_state_resumes_in_the_port(tiny_train):
    """``weights.flax_train_state_to_torch`` carries the JAX state after
    the steps (params, the sparse layers' ``MaskedBatchNorm`` statistics
    among the batch_stats, Adam's mu / nu and count) into a fresh port
    model and optimizer; one more step on both agrees, and
    ``weights.torch_to_flax`` carries the port's state back."""
    from flax.traverse_util import flatten_dict

    from de6d_tpu.train.optimization import build_optimizer_and_schedule
    from de6d_tpu.train.train_state import make_train_step as jax_make_step
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule as port_opt, create_train_state,
        make_train_step,
    )

    jstate = tiny_train["ref"]["state"]
    adam = jstate.opt_state[1].inner_state[0]  # clip, then the chain

    def flat(tree, prefix):
        return {"/".join((prefix,) + k): np.asarray(v, np.float32)
                for k, v in flatten_dict(tree).items()}

    tmodel = copy.deepcopy(tiny_train["tmodel"])
    params = flat(jstate.params, "params")
    stats = flat(jstate.batch_stats, "batch_stats")
    sd, named = weights.flax_train_state_to_torch(
        tmodel, params, stats, flat(adam.mu, "params"),
        flat(adam.nu, "params"), int(adam.count))
    tmodel.load_state_dict(sd)
    back = weights.torch_to_flax(tmodel)
    assert sorted(back) == sorted({**params, **stats})
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    opt, _ = port_opt(tiny_train["opt_cfg"], tmodel, 1)
    opt.load_named_state(named)
    assert opt.count == tiny_train["steps"]
    state = create_train_state(tmodel, opt, step=tiny_train["steps"])
    batch = {k: T(v) for k, v in tiny_train["batch"].items()}
    make_train_step(tmodel, opt)(state, batch)

    optimizer, _ = build_optimizer_and_schedule(
        tiny_train["opt_cfg"], jstate.params, steps_per_epoch=1)
    jb = {k: jnp.asarray(v) for k, v in tiny_train["batch"].items()}
    jstate, _ = jax_make_step(tiny_train["jmodel"], optimizer)(jstate, jb)
    want = weights.flax_params_to_torch(flat(jstate.params, "params"), tmodel)
    params_close(dict(tmodel.named_parameters()), want,
                 lr_sum(tiny_train, tiny_train["steps"] + 1))


def test_train_model_and_checkpoint(tiny_train):
    """``train_model`` over 2 epochs of the tiny batch: finite losses that
    fall, and a checkpoint that restores a fresh SECOND to the trained
    parameters and ``MaskedBatchNorm`` statistics."""
    import tempfile

    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state,
    )
    from de6d_tpu_torch.train.checkpoint import restore_checkpoint
    from de6d_tpu_torch.train.train_loop import train_model

    class Loader:
        def __init__(self, batch):
            self.batch = batch

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            yield self.batch

    backbone = type(tiny_train["tmodel"].backbone_3d).__name__
    tmodel = tiny_model(backbone)
    weights.load_into(tmodel, tiny_train["flat"])
    opt, _ = build_optimizer_and_schedule(tiny_train["opt_cfg"], tmodel, 1)
    state = create_train_state(tmodel, opt)
    batch = {k: T(v) for k, v in tiny_train["batch"].items()}
    log = []
    with tempfile.TemporaryDirectory() as tmp:
        state = train_model(tmodel, opt, state, Loader(batch),
                            tiny_train["opt_cfg"], total_epochs=2,
                            ckpt_dir=Path(tmp), step_log=log)
        losses = [float(x[2]) for x in log]
        assert state.step == 2 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        fresh = tiny_model(backbone)
        opt2, _ = build_optimizer_and_schedule(tiny_train["opt_cfg"], fresh,
                                               1)
        restored, meta = restore_checkpoint(
            Path(tmp) / "checkpoint_epoch_2", create_train_state(fresh,
                                                                 opt2))
    assert restored.step == 2 and int(meta["epoch"]) == 2
    trained = dict(tmodel.state_dict())
    stats = [k for k in trained if "MaskedBatchNorm_0.running" in k]
    assert len(stats) >= 24
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_second_weights_go_both_ways():
    """The trained SECOND's 136 flax arrays (the 12 sparse layers'
    ``MaskedBatchNorm_0`` statistics among them) into the port and back,
    bit for bit."""
    from chip_smoke import build_model

    model = build_model("float32", "cpu", SECOND_CFG, SECOND_PARAMS)[0]
    flat = weights.load_flax_npz(SECOND_PARAMS)
    back = weights.torch_to_flax(model)
    assert len(flat) == 136 and sorted(back) == sorted(flat)
    assert sum(k.endswith("MaskedBatchNorm_0/mean") for k in back) == 12
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    params = weights.torch_to_flax(model, params_only=True)
    assert sorted(params) == sorted(k for k in flat if k.startswith("params"))


# ---------------------------------------------------------------------
# the host pipeline with second.yaml's DATA_CONFIG
# ---------------------------------------------------------------------

def _cfgs(path=SECOND_CFG):
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu_torch.config import cfg_from_yaml_file

    cwd = os.getcwd()
    os.chdir(ROOT)  # _BASE_CONFIG_ resolves from the repository root
    try:
        return jax_cfg(str(path)), cfg_from_yaml_file(str(path))
    finally:
        os.chdir(cwd)


def jax_loader(training, batch_size):
    """The JAX package's loader on ``data/kitti`` with ``second.yaml``'s
    ``DATA_CONFIG``, one worker (reproducible), seed 0."""
    from de6d_tpu.datasets import build_dataloader as jax_build_loader

    jcfg, _ = _cfgs()
    return jax_build_loader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size,
                            root_path=str(KITTI), training=training, seed=0,
                            workers=1)


@pytest.mark.parametrize("training", [True, False])
def test_loader_equals_jax_loader(training):
    """The first 2 batches of train epoch 0 at batch 4 (range [0, -40, -3,
    70.4, 40, 1], gt sampling, flips, rotation, scaling, 16384 points a
    frame) and of the val split at batch 8, bit for bit; the port's
    device voxel spec is 0.05 x 0.05 x 0.1 m, 5 points a voxel, 16000
    voxels."""
    from de6d_tpu_torch.datasets import build_dataloader
    from test_torch_kitti_pipeline import _epoch, assert_batches_equal

    _, tcfg = _cfgs()
    bs = 4 if training else 8
    _, jl = jax_loader(training, bs)
    ds, tl = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, bs,
                              root_path=str(KITTI), training=training,
                              seed=0, workers=2)
    want = _epoch(jl, 0, 2)
    got = _epoch(tl, 0, 2)
    tl.close()
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert_batches_equal(g, w, f"batch {i}")
        assert g["points"].shape == (bs, 16384, 4)
    spec = ds.spec
    assert tuple(spec.voxel_size) == (0.05, 0.05, 0.1)
    assert (spec.max_points_per_voxel, spec.max_voxels) == (5, 16000)
    np.testing.assert_array_equal(
        np.float32(spec.point_cloud_range),
        np.float32([0.0, -40.0, -3.0, 70.4, 40.0, 1.0]))


# ---------------------------------------------------------------------
# the CLIs on a cut of data/kitti
# ---------------------------------------------------------------------

def tiny_second_yaml(path):
    """``second.yaml`` with the tiny SECOND's widths (sparse filters [8, 8,
    16, 16, 16], BEV [32, 64], 4000 voxels a frame), written to
    ``path``; the data config is ``second.yaml``'s, resolved."""
    import yaml

    _, tcfg = _cfgs()

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    cfg = {k: plain(tcfg[k]) for k in ("CLASS_NAMES", "DATA_CONFIG", "MODEL",
                                       "OPTIMIZATION")}
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "transform_points_to_voxels":
            proc["MAX_NUMBER_OF_VOXELS"] = {"train": 4000, "test": 4000}
    cfg["MODEL"]["BACKBONE_3D"].update(NUM_FILTERS=[8, 8, 16, 16, 16],
                                       OUT_CHANNELS=16)
    cfg["MODEL"]["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 32
    cfg["MODEL"]["BACKBONE_2D"].update(
        LAYER_NUMS=[1, 1], NUM_FILTERS=[32, 64], NUM_UPSAMPLE_FILTERS=[32, 32])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained_cli(tmp_path_factory):
    from de6d_tpu_torch.tools import train
    from torch_fixtures import kitti_subtree

    tree = kitti_subtree(tmp_path_factory.mktemp("kitti"), 8, 4).resolve()
    work = tmp_path_factory.mktemp("work")
    cfg = tiny_second_yaml(work / "configs/kitti_models/second_tiny.yaml")
    args = ["--cfg_file", str(cfg), "--device", "cpu", "--workers", "2",
            "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    cwd = os.getcwd()
    os.chdir(work)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        run, ret = train.main(args + ["--epochs", "1", "--fix_random_seed",
                                      "--extra_tag", "a"] + data)
    finally:
        os.chdir(cwd)
    run.cudnn_tf32 = torch.backends.cudnn.allow_tf32
    return work, args, data, run, ret


def test_train_cli_trains_second(trained_cli):
    """One epoch of the tiny SECOND through ``tools/train.py``: 4 steps of
    batch 2, finite losses, a checkpoint, the post-training KITTI eval;
    cuDNN's TF32 turned off (second.yaml states fp32)."""
    work, _, _, run, ret = trained_cli
    assert run.cudnn_tf32 is False
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert run.cfg.EXP_GROUP_PATH == "kitti_models"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 4 and len(run.step_log) == 4
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    assert "Car_3d/moderate_R40" in ret


def test_test_cli_evaluates_the_second_checkpoint(trained_cli):
    from de6d_tpu_torch.tools import test

    work, args, data, run, ret = trained_cli
    ckpt = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
            / "a/ckpt/checkpoint_epoch_1")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        got = test.main(args + ["--ckpt", str(ckpt), "--extra_tag", "a",
                                "--allow-zero-recall", "--save_to_file"]
                        + data)
    finally:
        os.chdir(cwd)
    out = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
           / "a/eval/single")
    assert (out / "result.pkl").is_file()
    assert len(list((out / "final_result/data").glob("*.txt"))) == 4
    assert got["recall_counts"] == ret["recall_counts"]


# ---------------------------------------------------------------------
# full-width references for the card (which has no JAX)
# ---------------------------------------------------------------------

def jax_stage_keys(jmodel, variables, batch, caps):
    """Each stage's site keys of the JAX model's train-mode forward (the
    last from ``downsample_coords`` of x_conv4, as the (3, 1, 1) layer
    finds them)."""
    @jax.jit
    def keys_of(v, b):
        out, _ = jmodel.apply(v, dict(b), train=True,
                              mutable=["batch_stats"])
        ms = out["multi_scale_3d_features"]
        keys = [ms[f"x_conv{s}"][1] for s in range(1, 5)]
        keys.append(jax.vmap(lambda k: jsp.downsample_coords(
            k, ms["x_conv4"][2], (2, 1, 1), (0, 0, 0), caps[3],
            (3, 1, 1))[0])(keys[3]))
        return keys

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return [np.asarray(k).astype(np.int32) for k in keys_of(variables, jb)]


def train_fixture_content():
    """The JAX loader's first batch of 4 on ``data/kitti``'s train split
    (``second.yaml``, one worker, seed 0) and the JAX step in fp32 from the
    trained weights (dense assigner) on it: stage keys, labels, targets,
    loss terms, gradient norm, gradients, statistics, 3 steps' losses and
    the parameters after them, per parameter in the port's layout."""
    import test_torch_pointpillar_train as ppt

    _, jl = jax_loader(True, 4)
    jl.set_epoch(0)
    raw = next(iter(jl))
    batch = {k: np.asarray(raw[k]) for k in ("points", "points_mask",
                                             "gt_boxes")}
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jmodel, tmodel = ppt.build_pair_train(str(SECOND_CFG))
    finally:
        os.chdir(cwd)
    flat = weights.load_flax_npz(SECOND_PARAMS)
    variables = unflatten(flat)
    ref = ppt.jax_train_reference(jmodel, variables, batch,
                                  second_opt_cfg() | {"NUM_EPOCHS": 80})
    out = dict(batch)
    v = batch["points"].shape[1]
    vox = 16000
    for s, k in enumerate(jax_stage_keys(jmodel, variables, batch,
                                         [vox, vox, vox // 2, vox // 4])):
        out[f"keys_{s + 1}"] = k
    labels = ref["labels"].reshape(-1)
    nz = np.flatnonzero(labels)
    out["labels_idx"] = nz.astype(np.int64)
    out["labels_val"] = labels[nz].astype(np.int32)
    fg = np.flatnonzero(labels > 0)
    out["fg_idx"] = fg.astype(np.int64)
    out["reg_targets_fg"] = ref["reg_targets"].reshape(-1, 7)[fg]
    for k, val in ref["metrics"].items():
        out[f"metric/{k}"] = np.float32(val)
    out["losses"] = np.asarray(ref["losses"], np.float32)
    ppt.store_leaves(out, "grad", weights.flax_params_to_torch(ref["grads"],
                                                               tmodel))
    stats = weights.flax_to_torch({**flat, **ref["batch_stats"]}, tmodel)
    for name, t in stats.items():
        if "running" in name:
            out[f"stats/{name}"] = t.numpy()
    ppt.store_leaves(out, "params3", weights.flax_params_to_torch(
        ref["params_after"], tmodel))
    assert v == 16384
    return out


def write_train_fixture():
    """Rewrite ``testdata/second_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import
    test_torch_second_train as t; t.write_train_fixture()"``."""
    np.savez_compressed(TRAIN_FIXTURE, **train_fixture_content())


def eval_fixture_content():
    """JAX ``eval_one_epoch`` in fp32, the trained weights, the 100 val
    frames of ``data/kitti`` at batch 8 with ``second.yaml``."""
    from test_torch_eval import eval_reference, jax_eval

    _, tcfg = _cfgs()
    flat = weights.load_flax_npz(SECOND_PARAMS)
    ret, annos, counts = jax_eval(SECOND_CFG, KITTI, flat, 8)
    return eval_reference(ret, annos, counts, tcfg.CLASS_NAMES)


def write_eval_fixture():
    """Rewrite ``testdata/second_eval_jax_ref.npz`` (``...
    t.write_eval_fixture()``)."""
    np.savez_compressed(EVAL_FIXTURE, **eval_fixture_content())


def test_train_fixture_holds_what_the_card_reads():
    """The card's parity phase reads these keys."""
    with np.load(TRAIN_FIXTURE) as ref:
        files = set(ref.files)
        assert ref["points"].shape == (4, 16384, 4)
        assert ref["labels_idx"].size > 0 and ref["fg_idx"].size > 0
        assert ref["losses"].shape == (3,)
    assert {"points", "points_mask", "gt_boxes", "keys_5", "metric/loss",
            "metric/grad_norm"} <= files
    assert sum(f.startswith("stats/") and "MaskedBatchNorm_0" in f
               for f in files) == 24


def test_eval_fixture_eval_code_reproduces_jax_ap():
    """The port's KITTI eval on the stored JAX SECOND detections gives the
    stored AP dict exactly (``chip_smoke.check_eval_code``)."""
    import chip_smoke

    assert chip_smoke.check_eval_code(EVAL_FIXTURE, SECOND_CFG,
                                      "eval / second_kitti")["ap_equal"]


@pytest.mark.slow
def test_train_fixture_equals_fresh_jax_run():
    ref = train_fixture_content()
    with np.load(TRAIN_FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_eval_fixture_equals_fresh_jax_run():
    ref = eval_fixture_content()
    with np.load(EVAL_FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu():
    """The card's parity phase (``chip_smoke.check_second_train_parity``,
    its tolerances in ``chip_smoke.SECOND_TRAIN_TOL``), here on the
    CPU."""
    from chip_smoke import check_second_train_parity

    report = check_second_train_parity("cpu", measure_f64=False)
    assert report["positives"] > 0


@pytest.mark.slow
def test_full_width_eval_matches_fixture_on_cpu():
    """The card's fp32 eval gate (``chip_smoke.check_eval_parity`` with
    the SECOND fixture), here on the CPU."""
    import chip_smoke
    from test_torch_eval import port_eval

    flat = weights.load_flax_npz(SECOND_PARAMS)
    ret, annos = port_eval(SECOND_CFG, KITTI, flat, 8)
    chip_smoke.check_eval_parity(ret, annos, ref_path=EVAL_FIXTURE,
                                 cfg_path=SECOND_CFG,
                                 tag="eval / second_kitti")


@pytest.mark.slow
def test_full_width_gradients_against_float64(capsys):
    """Where ``chip_smoke.SECOND_TRAIN_F64`` comes from: the fixture's
    step evaluated by the port in float64 (every layer; the anchors and
    the assigner's thresholds stay fp32) against the JAX fp32 gradients
    (over the fixture's stored entries) and the port's fp32 ones: the
    largest distance relative to each leaf's largest |entry|, and the
    loss terms' and the gradient norm's relative distances. Prints them;
    both must lie within ``SECOND_TRAIN_F64``."""
    import chip_smoke

    ref = dict(np.load(TRAIN_FIXTURE))
    batch = chip_smoke.second_train_batch("cpu")
    _, g32, m32 = chip_smoke.second_gradients(chip_smoke.build_model(
        "float32", "cpu", SECOND_CFG, SECOND_PARAMS)[0], batch)
    _, g64, m64 = chip_smoke.second_gradients(
        chip_smoke.second_model_f64("cpu"), batch)
    port = chip_smoke.f64_distances(g32, m32, g64, m64)
    jax_grad = 0.0
    for name, t in g64.items():
        if f"grad/{name}" in ref:
            idx, jg = np.arange(t.size), ref[f"grad/{name}"]
        else:
            jg = ref[f"grad_sample/{name}"]
            idx = np.linspace(0, t.size - 1, jg.size).astype(np.int64)
        jax_grad = max(jax_grad, float(np.abs(jg - t[idx]).max()
                                       / np.abs(t).max()))
    jax_loss = max(abs(float(ref[f"metric/{k}"]) / v - 1)
                   for k, v in m64.items() if v != 0)
    norm64 = np.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
    jax_norm = abs(float(ref["metric/grad_norm"]) / norm64 - 1)
    with capsys.disabled():
        print(f"\nSECOND full-width step vs float64: port fp32 {port}; "
              f"JAX fp32 grad {jax_grad:.3g}, loss {jax_loss:.3g}, "
              f"grad_norm {jax_norm:.3g}")
    bound = chip_smoke.SECOND_TRAIN_F64
    for k, v in port.items():
        assert v <= bound[k], k
    assert jax_grad <= bound["grad"] and jax_loss <= bound["loss"]
    assert jax_norm <= bound["grad_norm"]
