"""Compression baselines the paper compares against (§4.1, App. C.1), in
PyTorch.

Port of ``repro/core/baselines.py`` over the port's nested-dict trees:

* ``pruned``   - sparsify only; surviving entries keep their magnitudes.
* ``stc``      - Sparse Ternary Compression (Sattler et al. 2019): top-k
                 and ternary with the mean magnitude of the survivors as
                 scale (no tuned alpha).
* ``bitdelta`` - the sign of every entry (density 1.0), scale = mean |tau|
                 (the "No Training" variant of Liu et al. 2024).
* ``dare``     - DARE random dropping with a 1/density rescale of the
                 survivors (Yu et al. 2023 / Deng et al. 2024), its masks
                 drawn on the reference's threefry stream
                 (:mod:`repro_torch.prng`), so the same key drops the same
                 entries in both packages.

All return dense task-vector trees of the original dtype, so they go
through the same evaluation as ComPEFT.  The top-k cut is
``core/compeft.py::_topk_threshold``, the reference's CPU quantile to the
bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.core import packing
from repro_torch.core.compeft import (CompressionConfig, _topk_threshold,
                                      compress, decompress)


def pruned(tau: dict, density: float) -> dict:
    """Top-k magnitude pruning, magnitudes kept (the paper's "Pruned")."""

    def f(t):
        t32 = t.to(torch.float32)
        mag = t32.abs()
        return torch.where(mag >= _topk_threshold(mag, density), t32,
                           0.0).to(t.dtype)

    return tree_util.tree_map(f, tau)


def stc(tau: dict, density: float) -> dict:
    """Sparse Ternary Compression: scale = mean |survivors|."""

    def f(t):
        t32 = t.to(torch.float32)
        mag = t32.abs()
        keep = mag >= _topk_threshold(mag, density)
        n_keep = torch.clamp_min(keep.to(torch.float32).sum(), 1.0)
        scale = torch.where(keep, mag, 0.0).sum() / n_keep
        return (torch.where(keep, torch.sign(t32), 0.0) * scale).to(t.dtype)

    return tree_util.tree_map(f, tau)


def bitdelta(tau: dict) -> dict:
    """The sign of every entry, scale = mean |tau| per tensor."""

    def f(t):
        t32 = t.to(torch.float32)
        return (torch.sign(t32) * t32.abs().mean()).to(t.dtype)

    return tree_util.tree_map(f, tau)


def dare(tau: dict, density: float, key: torch.Tensor) -> dict:
    """DARE: drop entries i.i.d. with probability 1 - density, rescale the
    rest by 1/density.  Leaf ``i`` (in the tree's flatten order) draws its
    mask under key ``i`` of ``split(key, n_leaves)``; ``key`` is a key
    [2] of :mod:`repro_torch.prng`."""
    leaves = tree_util.leaves(tau)
    keys = prng.split(key.to(torch.int64).cpu(), len(leaves))
    out = []
    for t, k in zip(leaves, keys):
        keep = prng.bernoulli(k, density, t.numel()).reshape(t.shape)
        out.append(torch.where(keep.to(t.device),
                               t.to(torch.float32) / density,
                               0.0).to(t.dtype))
    return tree_util.unflatten_like(tau, out)


def compeft_dense(tau: dict, density: float, alpha: float) -> dict:
    """ComPEFT returned as a dense tree (for a like-for-like evaluation)."""
    return decompress(compress(tau, CompressionConfig(density=density,
                                                      alpha=alpha)))


METHODS = ("compeft", "stc", "pruned", "bitdelta", "dare")


def run_method(name: str, tau: dict, density: float, alpha: float = 1.0,
               key: Optional[torch.Tensor] = None) -> dict:
    if name == "compeft":
        return compeft_dense(tau, density, alpha)
    if name == "stc":
        return stc(tau, density)
    if name == "pruned":
        return pruned(tau, density)
    if name == "bitdelta":
        return bitdelta(tau)
    if name == "dare":
        return dare(tau, density, key if key is not None
                    else prng.prng_key(0))
    raise ValueError(f"unknown method {name!r}")


def method_bits(name: str, n: int, density: float) -> float:
    """Storage cost of each method in bits, the paper's accounting: Golomb
    for ternary codes, a bitmask for BitDelta, COO for DARE and Pruned."""
    if name in ("compeft", "stc"):
        return packing.golomb_total_bits(n, density)
    if name == "bitdelta":
        return float(n) + 16.0          # one sign bit per param + scale
    if name == "pruned":
        # positions by Golomb + a 16-bit magnitude per survivor
        return (density * n * (packing.golomb_bits_per_position(density)
                               + 16.0) + 16.0)
    if name == "dare":
        return density * n * 48.0       # COO: 32-bit index + 16-bit value
    raise ValueError(name)
