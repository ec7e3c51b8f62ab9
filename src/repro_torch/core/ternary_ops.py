"""Bitwise algebra on packed ternary vectors (paper §2.2 "Efficient
Computation"), in PyTorch.  Port of ``repro/core/ternary_ops.py``.

With two bit masks per vector, dot products and distances reduce to AND /
XOR + POPCNT.  :func:`ternary_dot` is the ``popcount_dot`` kernel over
the flat planes (its plain version on the CPU); the rest are plain
PyTorch, as they are plain jnp in the reference (the popcount is a SWAR
over int64, :func:`repro_torch.core.packing.popcount`).
"""

from __future__ import annotations

import torch

from repro_torch.core.compeft import CompressedTensor
from repro_torch.core.packing import PackedTernary, popcount, unpack_ternary


def _popcount_sum(words: torch.Tensor) -> torch.Tensor:
    return popcount(words).sum().to(torch.int32)


def ternary_dot(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    """<a, b> of the ternary signs (scales excluded), as f32:
    popc(a+ & b+) + popc(a- & b-) - popc(a+ & b-) - popc(a- & b+)."""
    from repro_torch.kernels import ops
    d = ops.kernel("popcount_dot")(a.pos.reshape(-1), a.neg.reshape(-1),
                                   b.pos.reshape(-1), b.neg.reshape(-1))
    return d.to(torch.float32)


def scaled_dot(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    return ternary_dot(a, b) * a.scale * b.scale


def hamming_distance(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    """Positions where the ternary values differ: (a+ ^ b+) | (a- ^ b-)."""
    return _popcount_sum((a.pos ^ b.pos) | (a.neg ^ b.neg))


def nnz(a: PackedTernary) -> torch.Tensor:
    return _popcount_sum(a.pos) + _popcount_sum(a.neg)


def cosine_similarity(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    num = ternary_dot(a, b)
    den = (torch.sqrt(nnz(a).to(torch.float32))
           * torch.sqrt(nnz(b).to(torch.float32)))
    return num / torch.clamp_min(den, 1e-9)


def ternary_add(a: PackedTernary, b: PackedTernary) -> CompressedTensor:
    """a + b in the decompressed ternary domain (values in scale units),
    as int8 signs with a's scale; the caller combines the scales."""
    sa = unpack_ternary(a).signs.to(torch.int16)
    sb = unpack_ternary(b).signs.to(torch.int16)
    return CompressedTensor(signs=(sa + sb).to(torch.int8), scale=a.scale,
                            orig_dtype=a.orig_dtype)


def sign_agreement(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    """Fraction of mutually non-zero positions whose signs agree."""
    both = (a.pos | a.neg) & (b.pos | b.neg)
    agree = (a.pos & b.pos) | (a.neg & b.neg)
    n_both = _popcount_sum(both).to(torch.float32)
    return _popcount_sum(agree).to(torch.float32) / torch.clamp_min(n_both,
                                                                    1.0)


def packed_matvec(p: PackedTernary, x: torch.Tensor) -> torch.Tensor:
    """y = scale * (signs.reshape(shape) @ x), unpacking the planes (the
    reference's oracle form)."""
    w = unpack_ternary(p).signs.to(x.dtype).reshape(p.shape)
    return (w @ x) * p.scale.to(x.dtype)
