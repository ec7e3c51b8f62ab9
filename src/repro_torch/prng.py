"""JAX's threefry PRNG in PyTorch: the draws of sampled decoding and of
the synthetic data pipeline.

The reference draws with ``jax.random`` (JAX 0.9.0, the spec), whose
default generator is threefry-2x32 with ``jax_threefry_partitionable``
True.  This module rewrites that arithmetic from the installed JAX in
plain PyTorch, so the port draws the reference's own bits:

- ``threefry_2x32`` is ``jax/_src/prng.py::_threefry2x32_lowering``;
- ``threefry_seed`` and ``prng_key`` are ``prng.py::_threefry_seed`` as
  JAX runs it without x64 (a seed becomes the words ``(0, seed mod
  2**32)``);
- ``fold_in`` is ``prng.py::_threefry_fold_in``;
- ``split`` is ``prng.py::_threefry_split_foldlike``: key ``i`` of a
  split is threefry of the counter words ``(0, i)``;
- ``random_bits`` is ``prng.py::_threefry_random_bits_partitionable``
  for 32-bit draws: counter ``v`` is the word pair ``(0, v)`` and the
  bits are the xor of the two output words;
- ``uniform`` is ``jax/_src/random.py::_uniform`` for f32;
- ``randint`` is ``random.py::_randint`` for int32: two 32-bit draws
  under the two keys of a split, combined modulo the span with the
  multiplier ``(2**16 mod span)**2 mod span``;
- ``bernoulli`` is ``random.py::_bernoulli`` in its default "low" mode,
  ``uniform < p``;
- ``normal`` is ``random.py::_normal_real`` for f32: ``sqrt(2) *
  erfinv(u)`` with ``u`` uniform in [nextafter(-1, 0), 1).  The bits and
  ``u`` are the reference's, bitwise.  ``torch.erfinv`` and XLA's
  erf_inv are two approximations: against erfinv in f64, torch's lands
  within 1.5 f32 ulps and XLA's on the CPU within 73 (a relative 4.6e-6,
  near zero), so tests hold a normal draw to the reference's within a
  relative 1e-5.

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words, and a
32-bit word is held in int64 masked to 32 bits, because the CPU build of
torch cannot shift ``uint32``.  Nothing here keeps generator state: a
draw is a pure function of its key.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(torch.finfo(torch.float32).tiny)


def threefry_2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); every argument an int64 tensor or int in
    [0, 2**32), broadcast.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def threefry_seed(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s key words, without x64."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return 0, seed & MASK


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a key tensor [2] int64."""
    return torch.tensor(threefry_seed(seed), dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: keys [..., 2] int64, data [...]
    or an int (cast to uint32 as the reference does) -> keys [..., 2]
    int64."""
    data = (data.to(torch.int64) if isinstance(data, torch.Tensor)
            else int(data)) & MASK
    y0, y1 = threefry_2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key [2] -> keys [num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry_2x32(key[..., 0, None], key[..., 1, None], 0, lo)
    return torch.stack([b0, b1], dim=-1)


def random_bits(keys: torch.Tensor, V: int) -> torch.Tensor:
    """32-bit draws of shape [V] under each key: keys [..., 2] int64 ->
    bits [..., V] int64 in [0, 2**32)."""
    if V >= 2 ** 32:
        raise ValueError("draws of 2**32 or more need the counters' high "
                         "word")
    lo = torch.arange(V, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry_2x32(keys[..., 0, None], keys[..., 1, None], 0, lo)
    return b0 ^ b1


def uniform(bits: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniform in [minval, maxval) from 32-bit draws: the mantissa
    filled from the top 23 bits, exponent of 1.0, minus 1, scaled by
    ``maxval - minval`` (rounded to f32), shifted and held at minval.
    XLA on the CPU contracts the scale and shift into one fma; the
    product of two f32 is exact in f64, so the sum is formed there and
    rounded to f32 once."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = one - 1.0
    # Python floats holding f32 values: no host-to-device copy, so a CUDA
    # graph can capture the draw
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(lo))
    out = (floats.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp_min(out, lo)


def randint(key: torch.Tensor, shape: int, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (shape,), minval, maxval)`` in int32 under
    each key: key [..., 2] -> [..., shape] int64 in [minval, maxval)."""
    keys = split(key)                                    # [..., 2, 2]
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = max(maxval - minval, 1) & MASK
    mult = ((((2 ** 16) % span) ** 2) & MASK) % span   # uint32 wraps
    off = ((hi % span) * mult + lo % span) & MASK
    return minval + off % span


def bernoulli(key: torch.Tensor, p: float, shape: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (shape,))`` (mode "low") under each
    key: key [..., 2] -> bool [..., shape]."""
    return uniform(random_bits(key, shape)) < float(np.float32(p))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 under one key [2] ->
    [*shape] f32 (the elements drawn in row-major order)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(random_bits(key, n), lo, 1.0)
    return (float(np.float32(np.sqrt(2))) * torch.erfinv(u)).reshape(shape)
