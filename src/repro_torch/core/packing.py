"""Bitplane form of ternary task vectors (paper §2.2), in PyTorch.

The layout is the JAX package's (``repro/core/packing.py``): two planes
of 32-bit words over the flattened C-order tensor, bit ``i % 32`` of word
``i // 32`` set iff element ``i`` is +1 (resp. -1), plus one f32 scale.
Torch on the CPU cannot shift ``uint32``, so the planes are held as
``int32`` with the same bit patterns; numpy ``uint32`` words convert with
``.view(np.int32)`` and the CUDA kernels read the same memory as
``uint32_t``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

LANE = 32  # bits per plane word


@dataclasses.dataclass
class PackedTernary:
    """Packed bitplanes of one compressed leaf.

    ``pos``/``neg``: int32 ``[ceil(n/32)]`` words over the flattened leaf;
    ``scale``: f32 0-d tensor; ``shape``/``orig_dtype`` describe the leaf.
    """

    pos: torch.Tensor
    neg: torch.Tensor
    scale: torch.Tensor
    shape: tuple[int, ...] = ()
    orig_dtype: Any = torch.bfloat16

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 0

    @property
    def packed_bytes(self) -> int:
        return int(self.pos.numel() + self.neg.numel()) * 4 + 4


def words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensor with the same bits."""
    return (words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
        torch.int32)


def lane_shifts(device) -> torch.Tensor:
    """[0, 1, ..., 31] int32 on ``device`` (bit positions of a word)."""
    return torch.arange(LANE, dtype=torch.int32, device=device)


def lane_weights(device) -> torch.Tensor:
    """[1, 2, 4, ..., 2**31] int64: the value of each bit of a word."""
    return torch.ones(LANE, dtype=torch.int64, device=device) \
        << torch.arange(LANE, dtype=torch.int64, device=device)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a boolean / 0-1 tensor (flattened) into int32 words, LE bits."""
    flat = mask.reshape(-1).to(torch.int64)
    pad = (-flat.numel()) % LANE
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return words_to_int32((flat.view(-1, LANE)
                           * lane_weights(flat.device)).sum(dim=1))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 0/1 tensor of length ``n``."""
    bits = (words.reshape(-1, 1) >> lane_shifts(words.device)) & 1
    return bits.reshape(-1)[:n]


def signs_of(pt: PackedTernary) -> torch.Tensor:
    """int8 {-1, 0, 1} signs of a PackedTernary, in the leaf's shape."""
    n = pt.n_elements
    s = unpack_bits(pt.pos, n) - unpack_bits(pt.neg, n)
    return s.to(torch.int8).reshape(pt.shape)


def decompress_packed(pt: PackedTernary) -> torch.Tensor:
    """Dense reconstruction ``signs * scale`` in the leaf's dtype."""
    return (signs_of(pt).to(torch.float32) * pt.scale).to(pt.orig_dtype)


def stack_packed(experts: list[dict]) -> dict:
    """Stack E experts' {path: PackedTernary} dicts into per-path buffers.

    Returns {path: (pos [E, W], neg [E, W], scales [E], shape)}.  Experts
    missing a path contribute an all-zero plane pair with scale 0 (the
    JAX package's ``stack_packed`` contract, used for the ``BASE`` slot).
    """
    paths: dict[str, tuple] = {}
    device = None
    for ex in experts:
        for path, pt in ex.items():
            paths.setdefault(path, (pt.pos.numel(), tuple(pt.shape)))
            device = pt.pos.device
    stacks = {}
    for path, (n_words, shape) in paths.items():
        pos = torch.zeros((len(experts), n_words), dtype=torch.int32,
                          device=device)
        neg = torch.zeros_like(pos)
        scales = torch.zeros((len(experts),), dtype=torch.float32,
                             device=device)
        for e, ex in enumerate(experts):
            pt = ex.get(path)
            if pt is None:
                continue
            if tuple(pt.shape) != shape:
                raise ValueError(f"{path}: shape {pt.shape} != {shape}")
            pos[e] = pt.pos.reshape(-1)
            neg[e] = pt.neg.reshape(-1)
            scales[e] = pt.scale.to(torch.float32)
        stacks[path] = (pos, neg, scales, shape)
    return stacks


def stacked_bytes(stacks: dict) -> int:
    return sum(int(p.numel() + n.numel()) * 4 + 4 * int(s.numel())
               for p, n, s, _ in stacks.values())


def tree_packed_bytes(packed: dict) -> int:
    return sum(pt.packed_bytes for pt in packed.values())
