"""``jax.random``'s threefry2x32 key splitting and uniform draws in torch,
bit for bit (the port's own copy of what the JAX package's RoI samplers
draw; it imports no JAX).

Why the port needs it: the JAX package's RoI heads draw their fg/bg
sampling noise from ``jax.random.PRNGKey(0)`` whenever no ``sampling``
rng is given (``de6d_tpu/models/roi_heads/pvrcnn_head.py``), and its
train step gives none (``de6d_tpu/train/train_state.py``), so every JAX
step samples its RoIs with the same noise. The port picks the same RoIs
only with the same draws.

The recipe is jax 0.9's with ``jax_threefry_partitionable`` on (its
default):

- threefry2x32: 20 rounds on two 32-bit words, rotations (13, 15, 26, 6)
  and (17, 29, 16, 24) in turn, the key schedule ``(k0, k1, k0 ^ k1 ^
  0x1BD11BDA)`` injected after every 4 rounds with the injection's number
  added to the second word;
- the counters of a shape are its flat iota as a 64-bit number, split
  into (high, low) words;
- ``split(key, n)``: the two output words of counter i are key i;
- ``uniform(key, shape)``: ``bits = out0 ^ out1``, then ``(bits >> 9) |
  0x3F800000`` read as fp32, minus 1.

Keys are (..., 2) int64 tensors holding the two uint32 words (torch has
no full uint32 arithmetic); ``PRNGKey(0)`` is the words (0, 0). Every
function runs on any device.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int = 0, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32): the words
    (0, seed)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher on broadcastable int64 tensors of
    uint32 words: key (k0, k1), counters (x0, x1) → the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _counters(n: int, device):
    """The flat iota 0..n-1 as (high, low) 32-bit words."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _MASK


def _bits(key, n: int):
    """(..., 2) keys → the two (..., n) output words of counters 0..n-1."""
    hi, lo = _counters(n, key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)


def split(key, n: int = 2):
    """``jax.random.split``: (..., 2) keys → (..., n, 2) keys."""
    y0, y1 = _bits(key, n)
    return torch.stack([y0, y1], dim=-1)


def uniform(key, shape):
    """``jax.random.uniform(key, shape)`` in fp32, over [0, 1): (..., 2)
    keys → (..., *shape) draws."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    y0, y1 = _bits(key, math.prod(shape))
    mantissa = ((y0 ^ y1) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    return floats.reshape(*key.shape[:-1], *shape)
