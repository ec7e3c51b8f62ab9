"""Host-side Golomb-Rice codec for sparse ternary vectors (paper §2.2).

A numpy copy of ``repro/core/golomb.py`` (which the port cannot import:
it imports ``repro.core.packing``, which imports JAX), kept byte-identical
to it.  Encodes the *gaps* between consecutive non-zero positions with
Golomb-Rice coding (parameter ``b`` chosen per the paper's footnote-2
rule) plus one sign bit per non-zero.  This is the storage and wire
format; the device format is the bitplane pair of
:mod:`repro_torch.core.packing`.

:func:`encode` and :func:`decode` are vectorized: encode scatters the
unary, remainder and sign bits of every codeword at once from the
cumulative codeword offsets; decode finds every codeword's unary
terminator zero-bit by pointer-doubling the "next zero at least b+2 bits
later" map (O(nnz log nnz) numpy gathers, no sequential scan), then
gathers remainders and signs in one shot.  ``encode_ref``/``decode_ref``
keep the bit-at-a-time implementations as the format oracle.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.packing import golomb_bits_per_position


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, bit: int) -> None:
        self._bits.append(bit & 1)

    def write_unary(self, q: int) -> None:
        self._bits.extend([1] * q)
        self._bits.append(0)

    def write_uint(self, v: int, nbits: int) -> None:
        for i in range(nbits):
            self._bits.append((v >> i) & 1)

    def getvalue(self) -> bytes:
        bits = np.array(self._bits, dtype=np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()

    def __len__(self) -> int:  # number of bits
        return len(self._bits)


class BitReader:
    def __init__(self, data: bytes, nbits: int):
        arr = np.frombuffer(data, dtype=np.uint8)
        self._bits = np.unpackbits(arr, bitorder="little")[:nbits]
        self._pos = 0

    def read(self) -> int:
        b = int(self._bits[self._pos])
        self._pos += 1
        return b

    def read_unary(self) -> int:
        q = 0
        while self.read() == 1:
            q += 1
        return q

    def read_uint(self, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            v |= self.read() << i
        return v


def rice_parameter(density: float) -> int:
    """Paper footnote 2: b* = 1 + floor(log2(log(phi-1)/log(1-p)))."""
    p = min(max(density, 1e-12), 1.0 - 1e-12)
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    return max(1, 1 + int(math.floor(math.log2(math.log(phi - 1.0) / math.log(1.0 - p)))))


def _header(n: int, nnz: int, b: int, nbits: int, scale: float) -> bytes:
    return (np.uint64(n).tobytes() + np.uint32(nnz).tobytes()
            + np.uint8(b).tobytes() + np.uint64(nbits).tobytes()
            + np.float32(scale).tobytes())


def _parse_header(data: bytes):
    n = int(np.frombuffer(data[0:8], np.uint64)[0])
    nnz = int(np.frombuffer(data[8:12], np.uint32)[0])
    b = int(np.frombuffer(data[12:13], np.uint8)[0])
    nbits = int(np.frombuffer(data[13:21], np.uint64)[0])
    scale = float(np.frombuffer(data[21:25], np.float32)[0])
    return n, nnz, b, nbits, scale


def encode_ref(signs: np.ndarray, scale: float) -> bytes:
    """Bit-at-a-time reference encoder (format oracle for :func:`encode`)."""
    flat = np.asarray(signs, dtype=np.int8).reshape(-1)
    n = flat.size
    idx = np.nonzero(flat)[0]
    nnz = idx.size
    density = nnz / max(n, 1)
    b = rice_parameter(density if nnz else 0.5)
    m = 1 << b

    w = BitWriter()
    prev = -1
    for i in idx:
        gap = int(i - prev - 1)  # zeros skipped since last nnz
        q, r = divmod(gap, m)
        w.write_unary(q)
        w.write_uint(r, b)
        w.write(1 if flat[i] > 0 else 0)
        prev = int(i)

    return _header(n, nnz, b, len(w), scale) + w.getvalue()


def encode(signs: np.ndarray, scale: float) -> bytes:
    """Encode an int8 {-1,0,1} array + f32 scale into a Golomb-Rice stream.

    Layout: [u64 n][u32 nnz][u8 b][u64 nbits][f32 scale][payload bits...].
    Vectorized: all codewords' unary/remainder/sign bits are scattered in
    one numpy pass (byte-identical to :func:`encode_ref`).
    """
    flat = np.asarray(signs, dtype=np.int8).reshape(-1)
    n = flat.size
    idx = np.nonzero(flat)[0].astype(np.int64)
    nnz = idx.size
    density = nnz / max(n, 1)
    b = rice_parameter(density if nnz else 0.5)
    m = 1 << b
    if nnz == 0:
        return _header(n, 0, b, 0, scale)

    gaps = np.diff(np.concatenate([[-1], idx])) - 1
    q, r = np.divmod(gaps, m)
    lens = q + 1 + b + 1                       # unary + stop + fixed + sign
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    bits = np.zeros(total, np.uint8)
    # unary ones: for codeword k, bits [starts_k, starts_k + q_k)
    run_of = np.repeat(np.arange(nnz), q)
    within = np.arange(int(q.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(q)[:-1]]), q)
    bits[starts[run_of] + within] = 1
    if b:
        rem_pos = (starts + q + 1)[:, None] + np.arange(b)[None, :]
        rem_bits = ((r[:, None] >> np.arange(b)[None, :]) & 1)
        bits[rem_pos.reshape(-1)] = rem_bits.reshape(-1).astype(np.uint8)
    bits[starts + q + 1 + b] = (flat[idx] > 0).astype(np.uint8)
    payload = np.packbits(bits, bitorder="little").tobytes()
    return _header(n, nnz, b, total, scale) + payload


def decode_ref(data: bytes) -> tuple[np.ndarray, float]:
    """Bit-at-a-time reference decoder (oracle for :func:`decode`)."""
    n, nnz, b, nbits, scale = _parse_header(data)
    r = BitReader(data[25:], nbits)

    out = np.zeros((n,), dtype=np.int8)
    pos = -1
    m = 1 << b
    for _ in range(nnz):
        q = r.read_unary()
        rem = r.read_uint(b)
        gap = q * m + rem
        pos = pos + gap + 1
        out[pos] = 1 if r.read() == 1 else -1
    return out, scale


def _iterates(g: np.ndarray, start: int, count: int) -> np.ndarray:
    """[start, g(start), g²(start), ...] via pointer doubling.

    O(count log count) gathers instead of a length-``count`` Python loop:
    with A = the first L iterates and J = g^L, the next L iterates are
    J[A] and J squares to g^(2L).
    """
    out = np.empty(count, np.int64)
    out[0] = start
    filled, jump = 1, g.astype(np.int64)
    while filled < count:
        take = min(filled, count - filled)
        out[filled:filled + take] = jump[out[:take]]
        filled += take
        if filled < count:
            jump = jump[jump]
    return out


def decode(data: bytes) -> tuple[np.ndarray, float]:
    """Inverse of :func:`encode` -> (int8 signs, scale).  Vectorized.

    Every Rice codeword is ``1^q 0 | r (b bits) | sign (1 bit)``, so each
    consumes exactly one *terminator* zero followed by b+1 payload bits.
    The map "z_i -> first zero >= z_i + b + 2" is static, so all nnz
    terminators fall out of pointer doubling; remainders and signs are then
    plain gathers, and positions a cumsum over the decoded gaps.
    """
    n, nnz, b, nbits, scale = _parse_header(data)
    out = np.zeros((n,), dtype=np.int8)
    if nnz == 0:
        return out, scale
    arr = np.frombuffer(data[25:], dtype=np.uint8)
    bits = np.unpackbits(arr, bitorder="little")[:nbits]   # stay uint8:
    m = 1 << b                                  # 1 byte/bit transient, not 8

    z = np.flatnonzero(bits == 0)
    g = np.minimum(np.searchsorted(z, z + b + 2), z.size - 1)
    term = z[_iterates(g, 0, nnz)]             # terminator bit positions
    starts = np.concatenate([[0], term[:-1] + b + 2])
    q = term - starts
    if b:
        rem_bits = bits[term[:, None] + 1 + np.arange(b)[None, :]]
        r = rem_bits.astype(np.int64) @ (1 << np.arange(b, dtype=np.int64))
    else:
        r = np.zeros(nnz, np.int64)
    sign_bits = bits[term + 1 + b]
    pos = np.cumsum(q * m + r + 1) - 1
    out[pos] = np.where(sign_bits == 1, 1, -1).astype(np.int8)
    return out, scale


def decode_tree(blobs: dict) -> dict:
    """Batched store→host decode: all leaves of an expert in one pass.

    blobs: {path: golomb bytes} -> {path: (int8 signs, scale)}.  Each leaf
    decodes through the vectorized :func:`decode`; the per-leaf Python work
    is O(1), not O(bits).
    """
    return {path: decode(blob) for path, blob in blobs.items()}


def encoded_bits(signs: np.ndarray) -> int:
    """Exact bit count of the payload (excl. fixed 25-byte header)."""
    flat = np.asarray(signs).reshape(-1)
    n = flat.size
    idx = np.nonzero(flat)[0]
    if idx.size == 0:
        return 0
    b = rice_parameter(idx.size / n)
    m = 1 << b
    gaps = np.diff(np.concatenate([[-1], idx])) - 1
    qs = gaps // m
    return int(np.sum(qs + 1 + b + 1))


def theoretical_bits_check(n: int, density: float) -> float:
    """Average-case payload bits predicted by the paper's formula."""
    return density * n * (golomb_bits_per_position(density) + 1.0)
