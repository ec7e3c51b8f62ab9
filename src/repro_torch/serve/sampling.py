"""JAX's threefry stream in PyTorch: the draws of sampled decoding.

The reference samples token ``i`` of request ``uid`` as
``jax.random.categorical(fold_in(fold_in(PRNGKey(seed), uid), i), scaled)``
(``repro/serve/decode_loop.py``), which is ``argmax(scaled + gumbel)``
with gumbel noise made from threefry-2x32 bits.  The generator itself
(threefry, ``fold_in``, ``random_bits``, ``uniform``) is
:mod:`repro_torch.prng`; this module keys it per request and draws the
noise: ``uniform`` here is ``jax/_src/random.py::_uniform`` over
``[finfo.tiny, 1)`` and ``gumbel`` is ``random.py::_gumbel`` in its
default "low" mode, ``-log(-log(u))``.

Nothing here keeps generator state: a draw is a pure function of (seed,
uid, gen), so a sampled stream does not depend on the chunk size, the
slot or the admission time.  The card computes the same draw inside
``csrc/sample.cu``; these functions are its plain version.
"""

from __future__ import annotations

import torch

from repro_torch import prng
# threefry_2x32 and threefry_seed stay importable from here
from repro_torch.prng import (TINY, fold_in, random_bits,  # noqa: F401
                              threefry_2x32, threefry_seed)


def row_keys(seed: int, uids, device="cpu") -> torch.Tensor:
    """Per-request keys [B, 2] int64: ``fold_in(PRNGKey(seed), uid)``."""
    base = prng.prng_key(seed, device)
    uids = torch.as_tensor(uids, dtype=torch.int64, device=device)
    return fold_in(base.expand(uids.shape + (2,)), uids)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniform in [tiny, 1) from 32-bit draws (the gumbel's range)."""
    return prng.uniform(bits, TINY, 1.0)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (V,), float32)`` under each key: keys
    [..., 2] -> noise [..., V] f32."""
    return -torch.log(-torch.log(uniform(random_bits(keys, V))))
