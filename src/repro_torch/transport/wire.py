"""Versioned, self-describing wire format for an
:class:`~repro_torch.expert.Expert`: port of ``repro/transport/wire.py``,
byte for byte the reference's container, so a blob either package writes
decodes in the other.

    +------+---------+--------------+-----------------------+----------+
    | CPFT | version | manifest len | manifest (JSON, utf-8) | payload  |
    | 4 B  |  u8     |   u32 LE     |                       | N bytes  |
    +------+---------+--------------+-----------------------+----------+

The manifest names the representation (``dense`` / ``packed`` /
``golomb``), each leaf's path, shape, dtype, scale and payload span, and
CRC-32s of the whole payload and of each leaf, so a corrupt transfer is
rejected and a partial one can be verified leaf by leaf
(:func:`decode_leaves` / :func:`verify_leaf`).  Payloads per leaf:

* ``GOLOMB`` — a self-contained Golomb-Rice stream
  (:func:`repro_torch.core.golomb.encode`), the default;
* ``PACKED`` — the ``pos`` then ``neg`` plane words, little-endian uint32;
* ``DENSE``  — the bf16 reconstruction ``signs * scale``.

All three decode back to bit-identical planes.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import PackedTernary, planes_from_signs
from repro_torch.device import resolve_device
from repro_torch.expert import (DENSE, GOLOMB, PACKED, Expert, as_expert,
                                dtype_name, torch_dtype)

MAGIC = b"CPFT"
VERSION = 1
WIRE_SUFFIX = ".cpft"
WIRE_FORMAT = "compeft-wire"

_HEADER = struct.Struct("<4sBI")        # magic | version | manifest nbytes
_WIRE_REPS = (DENSE, PACKED, GOLOMB)    # TERNARY has no wire advantage


class TransportError(Exception):
    """Base error for the transport subsystem (backends + wire format)."""


class WireFormatError(TransportError):
    """Blob is not a (supported) ComPEFT wire artifact."""


class ChecksumError(WireFormatError):
    """Payload failed CRC verification — corrupt or truncated transfer."""


def _leaf_payload(pt, rep: str) -> bytes:
    """Encode one PackedTernary leaf for the chosen wire representation."""
    from repro_torch.core import golomb
    from repro_torch.core.packing import signs_np
    if rep == GOLOMB:
        return golomb.encode(signs_np(pt), float(pt.scale))
    if rep == PACKED:
        pos = pt.pos.cpu().numpy().view(np.uint32).astype("<u4")
        neg = pt.neg.cpu().numpy().view(np.uint32).astype("<u4")
        return pos.tobytes() + neg.tobytes()
    if rep == DENSE:
        vals = signs_np(pt).astype(np.float32) * float(pt.scale)
        return torch.from_numpy(vals).to(torch.bfloat16).view(
            torch.int16).numpy().astype("<i2").tobytes()
    raise WireFormatError(f"representation {rep!r} has no wire encoding; "
                          f"choose from {_WIRE_REPS}")


def encode_expert(expert: Any, rep: str = GOLOMB) -> bytes:
    """Serialize an expert (or legacy artifact) into one wire blob.

    ``rep`` picks the payload encoding (see module docstring); the
    manifest records it so :func:`decode_expert` needs no out-of-band
    information.  Bytes-on-wire is ``len(result)``.
    """
    if rep not in _WIRE_REPS:
        raise WireFormatError(f"representation {rep!r} has no wire "
                              f"encoding; choose from {_WIRE_REPS}")
    ex = as_expert(expert)
    packed = ex.packed
    parts: list[bytes] = []
    leaves: list[dict] = []
    offset = 0
    for path, pt in packed.items():
        blob = _leaf_payload(pt, rep)
        leaves.append({"path": path, "shape": list(pt.shape),
                       "dtype": dtype_name(pt.orig_dtype),
                       "scale": float(pt.scale),
                       "offset": offset, "nbytes": len(blob),
                       "crc32": zlib.crc32(blob)})
        parts.append(blob)
        offset += len(blob)
    payload = b"".join(parts)
    manifest = {"format": WIRE_FORMAT, "version": VERSION,
                "name": ex.name, "kind": ex.kind, "rep": rep,
                "density": ex.density, "alpha": ex.alpha, "meta": ex.meta,
                "leaves": leaves, "payload_nbytes": len(payload),
                "crc32": zlib.crc32(payload)}
    mj = json.dumps(manifest).encode("utf-8")
    return _HEADER.pack(MAGIC, VERSION, len(mj)) + mj + payload


def is_wire_blob(data: bytes) -> bool:
    """Cheap sniff: does this look like a ComPEFT wire artifact?"""
    return len(data) >= _HEADER.size and data[:4] == MAGIC


def peek_manifest(data: bytes) -> dict:
    """Parse and validate the header + manifest WITHOUT touching the
    payload (no checksum pass) — for listings and size accounting."""
    if len(data) < _HEADER.size:
        raise WireFormatError("blob shorter than the wire header")
    magic, version, mlen = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise WireFormatError("bad magic: not a ComPEFT wire artifact")
    if version > VERSION:
        raise WireFormatError(
            f"wire format version {version} is newer than supported "
            f"({VERSION}); upgrade the reader")
    if len(data) < _HEADER.size + mlen:
        raise WireFormatError("truncated blob: manifest incomplete")
    try:
        manifest = json.loads(data[_HEADER.size:_HEADER.size + mlen])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"manifest is not valid JSON: {e}") from e
    if manifest.get("format") != WIRE_FORMAT:
        raise WireFormatError(f"unknown manifest format "
                              f"{manifest.get('format')!r}")
    return manifest


def payload_offset(data: bytes) -> int:
    """Absolute byte offset where the payload starts (header + manifest).

    Works on any prefix of the blob that covers the 9-byte header; leaf
    ``offset`` fields are payload-relative, so a ranged read of leaf L
    spans ``[payload_offset(head) + L["offset"], ... + L["nbytes"])``.
    """
    if len(data) < _HEADER.size:
        raise WireFormatError("blob shorter than the wire header")
    magic, _, mlen = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise WireFormatError("bad magic: not a ComPEFT wire artifact")
    return _HEADER.size + mlen


def decode_leaves(manifest: dict,
                  byte_range: Optional[tuple] = None) -> list[dict]:
    """Leaf descriptors driving a (partial) payload fetch.

    Returns the manifest's leaves sorted by payload ``offset``.  With
    ``byte_range=(start, stop)`` (payload-relative, half-open) only the
    leaves intersecting that span are returned — the unit of resumption
    for a fetch that died mid-blob: everything before the range is already
    verified, everything inside it still needs bytes.
    """
    leaves = sorted(manifest["leaves"], key=lambda l: l["offset"])
    if byte_range is None:
        return leaves
    start, stop = byte_range
    return [l for l in leaves
            if l["offset"] < stop and l["offset"] + l["nbytes"] > start]


def supports_resume(manifest: dict) -> bool:
    """True when every leaf carries its own CRC-32 (blobs written by this
    version do).  Older blobs fall back to whole-payload verification —
    a mid-blob failover then refetches the full payload."""
    return all("crc32" in l for l in manifest["leaves"])


def verify_leaf(leaf: dict, raw: bytes) -> None:
    """Verify one leaf's bytes against its manifest entry.

    Raises :class:`ChecksumError` on a length or CRC mismatch — the
    caller treats that like any retryable transfer fault and re-requests
    just this leaf (possibly from a different replica).
    """
    if len(raw) != leaf["nbytes"]:
        raise ChecksumError(
            f"leaf {leaf.get('path')!r} is {len(raw)} bytes, manifest "
            f"promises {leaf['nbytes']} — truncated transfer?")
    crc = leaf.get("crc32")
    if crc is not None and zlib.crc32(raw) != crc:
        raise ChecksumError(f"leaf {leaf.get('path')!r} CRC mismatch — "
                            f"corrupt transfer")


def decode_expert(data: bytes, name: Optional[str] = None,
                  device="cuda") -> Expert:
    """Inverse of :func:`encode_expert` -> :class:`~repro_torch.expert.
    Expert` whose planes land on ``device``.

    Verifies magic, version, payload length and CRC-32 before building
    anything; raises :class:`WireFormatError` / :class:`ChecksumError` on
    a bad blob.  GOLOMB payloads stay encoded on the Expert (decoded on
    first ``as_`` / ``.packed``, like the cold store tier); PACKED and
    DENSE payloads realise planes at once.
    """
    dev = resolve_device(device)
    manifest = peek_manifest(data)
    _, _, mlen = _HEADER.unpack_from(data)
    payload = data[_HEADER.size + mlen:]
    if len(payload) != manifest["payload_nbytes"]:
        raise ChecksumError(
            f"payload is {len(payload)} bytes, manifest promises "
            f"{manifest['payload_nbytes']} — truncated transfer?")
    if zlib.crc32(payload) != manifest["crc32"]:
        raise ChecksumError("payload CRC mismatch — corrupt transfer")

    rep = manifest["rep"]
    ex = Expert(name or manifest["name"], manifest.get("kind", "full"),
                density=manifest.get("density", 0.0),
                alpha=manifest.get("alpha", 1.0),
                meta=manifest.get("meta", {}), device=dev)
    ex._manifest = manifest
    blobs: dict[str, bytes] = {}
    planes: dict[str, Any] = {}
    for leaf in manifest["leaves"]:
        path = leaf["path"]
        shape = tuple(leaf["shape"])
        dtype = torch_dtype(leaf["dtype"])
        ex._leaf_meta[path] = {"shape": shape, "orig_dtype": dtype}
        raw = payload[leaf["offset"]:leaf["offset"] + leaf["nbytes"]]
        if rep == GOLOMB:
            blobs[path] = raw
        elif rep == PACKED:
            words = np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(
                np.int32)
            half = words.size // 2
            planes[path] = PackedTernary(
                pos=torch.from_numpy(words[:half].copy()).to(dev),
                neg=torch.from_numpy(words[half:].copy()).to(dev),
                scale=torch.tensor(leaf["scale"], dtype=torch.float32,
                                   device=dev),
                shape=shape, orig_dtype=dtype)
        elif rep == DENSE:
            # bf16 -> f32 is exact: its 16 bits are the top half of the f32
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            signs = np.sign(bits.view(np.float32)).astype(np.int8)
            planes[path] = planes_from_signs(signs, leaf["scale"], shape,
                                             dtype, dev)
        else:
            raise WireFormatError(f"manifest names unknown representation "
                                  f"{rep!r}")
    if rep == GOLOMB:
        ex._reps[GOLOMB] = blobs
    else:
        ex._reps[PACKED] = tree_util.unflatten_paths(planes)
    return ex


def wire_nbytes(expert: Any, rep: str = GOLOMB) -> int:
    """Bytes-on-wire for one expert in one representation (header incl.)."""
    return len(encode_expert(expert, rep=rep))
