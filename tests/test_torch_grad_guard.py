"""The kernel wrappers never cut autograd: the gradients of the two
kernels whose JAX counterparts are differentiable (the canvas scatter's
custom VJP, the sparse conv's plain XLA, submanifold and strided) must
equal the JAX package's, through a ``grad_fn`` on the wrapper's output.
The card side (the canvas's and the sparse conv's CUDA backward) is in
``tests/test_torch_cuda_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import sparse as jax_sparse
from de6d_tpu.ops.pallas.canvas import scatter_canvas as jax_scatter_canvas
from de6d_tpu_torch.ops import sparse
from de6d_tpu_torch.ops.kernels import canvas, sparse_conv
from torch_fixtures import canvas_inputs, sparse_site_keys


def test_plain_canvas_backward_equals_jax_vjp():
    """d feat = the cotangent's row at each valid slot's cell, 0 at the
    invalid suffix: the JAX custom VJP (``_scatter_canvas_bwd``)."""
    ny, nx, v = 20, 24, 96
    rng = np.random.RandomState(8)
    feats, lins = canvas_inputs(rng, 2, v, ny * nx, (80, 13), c=16)
    ct = rng.standard_normal((2, ny, nx, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax_scatter_canvas(
        f, jnp.asarray(lins), ny, nx, 256, True), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    f = torch.from_numpy(feats).requires_grad_(True)
    with torch.enable_grad():
        out = canvas.scatter_canvas(f, torch.from_numpy(lins), ny, nx)
        out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(f.grad.numpy(), want)


def test_plain_sparse_conv_backward_equals_jax():
    """Gradients of the features and the weights, against ``jax.grad`` of
    ``subm_conv_table`` per sample (fp32; sums in other orders: 1e-5)."""
    rng = np.random.RandomState(9)
    b, v, q, k, cin, cout = 2, 30, 25, 27, 8, 12
    feats = rng.standard_normal((b, v, cin)).astype(np.float32)
    idx = rng.randint(0, v, (b, q, k)).astype(np.int32)
    hit = rng.random_sample((b, q, k)) < 0.4
    weights = (rng.standard_normal((k, cin, cout)) * 0.2).astype(np.float32)
    valid = rng.random_sample((b, q)) < 0.8
    ct = rng.standard_normal((b, q, cout)).astype(np.float32)

    def loss(f, w):
        outs = [jax_sparse.subm_conv_table(f[i], jnp.asarray(idx[i]),
                                           jnp.asarray(hit[i]), w,
                                           jnp.asarray(valid[i]))
                for i in range(b)]
        return jnp.sum(jnp.stack(outs) * ct)

    want_f, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                                    jnp.asarray(weights))
    f = torch.from_numpy(feats).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    with torch.enable_grad():
        out = sparse_conv.sparse_conv(f, torch.from_numpy(idx),
                                      torch.from_numpy(hit), w,
                                      torch.from_numpy(valid))
        assert out.grad_fn is not None
        (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_f),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_w),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)])
def test_plain_strided_conv_backward_equals_jax(padding):
    """Gradients of ``ops.sparse.strided_conv`` (its table's scattered
    transpose carries the data gradient) against ``jax.grad`` of the JAX
    package's per sample, fp32 within 1e-5."""
    grid, stride, kernel = (7, 10, 9), (2, 2, 2), (3, 3, 3)
    rng = np.random.RandomState(10)
    keys = sparse_site_keys(rng, grid, 120, (120, 70))
    out_keys, out_grid = sparse.downsample_coords(
        torch.from_numpy(keys), grid, stride, padding, 80, kernel)
    feats = rng.standard_normal((2, 120, 6)).astype(np.float32)
    weights = (rng.standard_normal((27, 6, 7)) * 0.2).astype(np.float32)
    ct = rng.standard_normal((2, 80, 7)).astype(np.float32)

    def loss(f, w):
        outs = [jax_sparse.strided_conv(
            f[i], jnp.asarray(keys[i]), grid, w, kernel, stride, padding,
            jnp.asarray(out_keys[i].numpy()), out_grid) for i in range(2)]
        return jnp.sum(jnp.stack(outs) * ct)

    want_f, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                                    jnp.asarray(weights))
    f = torch.from_numpy(feats).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    with torch.enable_grad():
        out = sparse.strided_conv(f, torch.from_numpy(keys), grid, w, kernel,
                                  stride, padding, out_keys, out_grid)
        assert out.grad_fn is not None
        (out * torch.from_numpy(ct)).sum().backward()
    assert float(np.abs(np.asarray(want_f)).max()) > 0
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_f),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_w),
                               atol=1e-5, rtol=1e-5)
