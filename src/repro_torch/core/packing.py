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
import math
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.compeft import CompressedTensor, _is_ct

LANE = 32  # bits per plane word


def entropy_bits(d: int, k: float) -> float:
    """Paper §2.2: entropy of a d-dim ternary vector with density k, +16 for
    the scalar."""
    if k <= 0.0:
        return 16.0
    if k >= 1.0:
        return float(d) + 16.0  # signs only: 1 bit each
    h = -((1.0 - k) * math.log2(1.0 - k) + k * math.log2(k / 2.0))
    return h * d + 16.0


def golomb_bits_per_position(k: float) -> float:
    """Paper footnote 2: average Golomb bits per *non-zero* position.

    b* = 1 + floor(log2(log(phi - 1)/log(1 - p)));  phi = golden ratio.
    bbar = b* + 1 / (1 - (1-p)^(2^b*)).
    """
    p = min(max(k, 1e-12), 1 - 1e-12)
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    b_star = 1 + int(math.floor(math.log2(math.log(phi - 1.0)
                                          / math.log(1.0 - p))))
    b_star = max(b_star, 1)
    return b_star + 1.0 / (1.0 - (1.0 - p) ** (2 ** b_star))


def golomb_total_bits(d: int, k: float) -> float:
    """Total Golomb-coded size: positions + 1 sign bit per nnz + 16-bit
    scale."""
    nnz = k * d
    return nnz * (golomb_bits_per_position(k) + 1.0) + 16.0


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


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (SWAR over int64, since torch
    on the CPU can neither shift uint32 nor count bits)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def signs_of(pt: PackedTernary) -> torch.Tensor:
    """int8 {-1, 0, 1} signs of a PackedTernary, in the leaf's shape."""
    n = pt.n_elements
    s = unpack_bits(pt.pos, n) - unpack_bits(pt.neg, n)
    return s.to(torch.int8).reshape(pt.shape)


def pack_ternary(ct: CompressedTensor) -> PackedTernary:
    flat = ct.signs.reshape(-1)
    return PackedTernary(pos=pack_bits(flat == 1), neg=pack_bits(flat == -1),
                         scale=ct.scale, shape=tuple(ct.signs.shape),
                         orig_dtype=ct.orig_dtype)


def unpack_ternary(pt: PackedTernary) -> CompressedTensor:
    return CompressedTensor(signs=signs_of(pt), scale=pt.scale,
                            orig_dtype=pt.orig_dtype)


def _is_pt(x) -> bool:
    return isinstance(x, PackedTernary)


def pack_tree(compressed: Any) -> Any:
    return tree_util.tree_map(pack_ternary, compressed, is_leaf=_is_ct)


def unpack_tree(packed: Any) -> Any:
    return tree_util.tree_map(unpack_ternary, packed, is_leaf=_is_pt)


def signs_np(pt: PackedTernary) -> np.ndarray:
    """Host int8 {-1, 0, 1} signs of a PackedTernary, flat C-order: the
    bridge from the planes to the host codecs.  The int32 words' bytes are
    the reference's little-endian uint32 bytes."""
    n = pt.n_elements
    pos = pt.pos.detach().cpu().numpy().view(np.uint8)
    neg = pt.neg.detach().cpu().numpy().view(np.uint8)
    pb = np.unpackbits(pos, bitorder="little")[:n]
    nb = np.unpackbits(neg, bitorder="little")[:n]
    return pb.astype(np.int8) - nb.astype(np.int8)


def planes_from_signs(signs: np.ndarray, scale: float, shape: tuple,
                      orig_dtype, device="cpu") -> PackedTernary:
    """Host int8 {-1, 0, 1} signs -> PackedTernary on ``device`` (numpy
    packbits, little-endian words, as the reference builds them)."""
    signs = np.asarray(signs).reshape(-1)
    pad = (-signs.size) % LANE
    if pad:
        signs = np.concatenate([signs, np.zeros((pad,), np.int8)])
    pos = np.packbits(signs == 1, bitorder="little").view(np.int32)
    neg = np.packbits(signs == -1, bitorder="little").view(np.int32)
    return PackedTernary(
        pos=torch.from_numpy(pos.copy()).to(device),
        neg=torch.from_numpy(neg.copy()).to(device),
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        shape=tuple(shape), orig_dtype=orig_dtype)


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
