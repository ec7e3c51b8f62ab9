"""JAX's threefry stream in PyTorch: the draws of sampled decoding.

The reference samples token ``i`` of request ``uid`` as
``jax.random.categorical(fold_in(fold_in(PRNGKey(seed), uid), i), scaled)``
(``repro/serve/decode_loop.py``), which is ``argmax(scaled + gumbel)``
with gumbel noise made from threefry-2x32 bits.  This module rewrites
that arithmetic from the installed JAX (0.9.0, the spec) in plain PyTorch,
so the port draws the reference's own bits:

- ``threefry_2x32`` is ``jax/_src/prng.py::_threefry2x32_lowering``;
- ``threefry_seed`` is ``prng.py::_threefry_seed`` as JAX runs it without
  x64 (a seed becomes the words ``(0, seed mod 2**32)``);
- ``fold_in`` is ``prng.py::_threefry_fold_in``;
- ``random_bits`` is ``prng.py::_threefry_random_bits_partitionable`` for
  32-bit draws of shape ``[V]`` (``jax_threefry_partitionable`` is True by
  default): counter ``v`` is the word pair ``(0, v)`` and the bits are the
  xor of the two output words;
- ``uniform`` is ``jax/_src/random.py::_uniform`` over
  ``[finfo.tiny, 1)`` and ``gumbel`` is ``random.py::_gumbel`` in its
  default "low" mode, ``-log(-log(u))``.

A 32-bit word is held in an int64 tensor masked to 32 bits, because the
CPU build of torch cannot shift ``uint32``.  Nothing here keeps generator
state: a draw is a pure function of (seed, uid, gen), so a sampled stream
does not depend on the chunk size, the slot or the admission time.  The
card computes the same draw inside ``csrc/sample.cu``; these functions
are its plain version.
"""

from __future__ import annotations

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


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: keys [..., 2] int64, data [...]
    (cast to uint32 as the reference does) -> keys [..., 2] int64."""
    y0, y1 = threefry_2x32(keys[..., 0], keys[..., 1], 0,
                           data.to(torch.int64) & MASK)
    return torch.stack([y0, y1], dim=-1)


def row_keys(seed: int, uids, device="cpu") -> torch.Tensor:
    """Per-request keys [B, 2] int64: ``fold_in(PRNGKey(seed), uid)``."""
    k0, k1 = threefry_seed(seed)
    base = torch.tensor([k0, k1], dtype=torch.int64, device=device)
    uids = torch.as_tensor(uids, dtype=torch.int64, device=device)
    return fold_in(base.expand(uids.shape + (2,)), uids)


def random_bits(keys: torch.Tensor, V: int) -> torch.Tensor:
    """32-bit draws of shape [V] under each key: keys [..., 2] int64 ->
    bits [..., V] int64 in [0, 2**32)."""
    if V >= 2 ** 32:
        raise ValueError("draws of 2**32 or more need the counters' high "
                         "word")
    lo = torch.arange(V, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry_2x32(keys[..., 0, None], keys[..., 1, None], 0, lo)
    return b0 ^ b1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniform in [tiny, 1) from 32-bit draws: the mantissa filled
    from the top 23 bits, exponent of 1.0, minus 1, scaled to
    [tiny, 1) and held at tiny."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = one - 1.0
    # (maxval - minval) rounds to 1.0 in f32 (and in the double here)
    return torch.clamp_min(floats * (1.0 - TINY) + TINY, TINY)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (V,), float32)`` under each key: keys
    [..., 2] -> noise [..., V] f32."""
    return -torch.log(-torch.log(uniform(random_bits(keys, V))))
