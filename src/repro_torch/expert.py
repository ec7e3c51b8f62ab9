"""ComPEFT expert artifact of the port: one expert, many representations.

Port of ``repro/expert.py``.  An expert exists in four forms and moves
between them along the reference's lattice:

    DENSE ──compress──> TERNARY ──pack──> PACKED ──encode──> GOLOMB
      ^                    |                 |                  |
      └────decompress──────┴─────unpack──────┴──────decode──────┘

* ``DENSE``   — nested dict of f32 task-vector leaves ``tau = theta_ft -
  theta_init``, or the reconstruction ``signs * scale``.
* ``TERNARY`` — nested dict of :class:`~repro_torch.core.compeft.
  CompressedTensor` (int8 signs and one scale).
* ``PACKED``  — nested dict of :class:`~repro_torch.core.packing.
  PackedTernary` bit planes: what the device cache keeps resident and the
  kernels read.
* ``GOLOMB``  — flat ``{path: bytes}`` Golomb-Rice streams (host codec,
  byte-identical to the reference's).

``method="streaming"`` compresses DENSE straight to PACKED (histogram
threshold and the segmented pack kernel); ``method="exact"`` takes the
sort-based quantile per leaf, DENSE -> TERNARY through ``compress`` and
DENSE -> PACKED through the ``pack_ternary_planes`` kernel at the same
thresholds, so ``unpack(PACKED)`` equals TERNARY bitwise.

:meth:`Expert.save` and :meth:`Expert.load` read and write the
reference's files: the npz layout (also the legacy
``checkpoint.export_expert`` one) and the ``.cpft`` wire container of
:mod:`repro_torch.transport.wire`, sniffed by its magic number.  A file
either package writes loads in the other as a bit-identical expert.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.compeft import _is_ct
from repro_torch.core.packing import _is_pt, planes_from_signs
from repro_torch.device import resolve_device

DENSE = "dense"
TERNARY = "ternary"
PACKED = "packed"
GOLOMB = "golomb"
REPRESENTATIONS = (DENSE, TERNARY, PACKED, GOLOMB)

_FORMAT = "compeft-expert-v1"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

__all__ = ["DENSE", "TERNARY", "PACKED", "GOLOMB", "REPRESENTATIONS",
           "Expert", "as_expert", "planes_from_signs", "dtype_name"]


def dtype_name(dtype) -> str:
    """A torch dtype as the reference's manifests name it ("bfloat16")."""
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    """A manifest's dtype name -> the torch dtype."""
    return _DTYPES[name]


class Expert:
    """A named ComPEFT expert with lazily realised representations.

    Construct with :meth:`from_task_vector` / :meth:`from_finetune`,
    :meth:`from_packed` or :meth:`load`.  ``as_(rep)`` returns the expert
    in ``rep``, converting (and caching) along the lattice.  Planes
    decoded from host forms (Golomb streams, wire payloads) are placed on
    ``device``.
    """

    def __init__(self, name: str, kind: str = "full", *,
                 density: float = 0.0, alpha: float = 1.0,
                 per_tensor: bool = True, method: str = "streaming",
                 meta: Optional[dict] = None, device="cpu"):
        self.name = name
        self.kind = kind                   # "lora" | "ia3" | "full"
        self.density = density
        self.alpha = alpha
        self.per_tensor = per_tensor
        self.method = method               # "streaming" | "exact"
        self.meta = dict(meta or {})
        self.device = torch.device(device)
        self._reps: dict[str, Any] = {}
        # per-leaf geometry, needed to rebuild planes from Golomb streams
        self._leaf_meta: dict[str, dict] = {}
        self._manifest: Optional[dict] = None   # raw on-disk manifest

    # ---------------- constructors ----------------

    @classmethod
    def from_task_vector(cls, tau: dict, *, name: str = "expert",
                         kind: str = "full", density: float = 0.05,
                         alpha: float = 1.0, per_tensor: bool = True,
                         method: str = "streaming",
                         meta: Optional[dict] = None) -> "Expert":
        """Wrap a dense task vector; compression happens on first ``as_``,
        on the device its leaves lie on."""
        if method not in ("streaming", "exact"):
            raise ValueError(f"unknown compression method {method!r}")
        leaves = tree_util.leaves(tau)
        ex = cls(name, kind, density=density, alpha=alpha,
                 per_tensor=per_tensor, method=method, meta=meta,
                 device=leaves[0].device if leaves else "cpu")
        ex._reps[DENSE] = tau
        return ex

    @classmethod
    def from_finetune(cls, theta_init: dict, theta_ft: dict,
                      **kw) -> "Expert":
        """tau = theta_ft - theta_init in f32 (paper §2)."""
        tau = tree_util.tree_map(
            lambda a, b: b.to(torch.float32) - a.to(torch.float32),
            theta_init, theta_ft)
        return cls.from_task_vector(tau, **kw)

    @classmethod
    def from_packed(cls, name: str, kind: str, packed: dict, *,
                    density: float = 0.0, alpha: float = 1.0,
                    meta: Optional[dict] = None) -> "Expert":
        """Adopt an existing tree of PackedTernary."""
        leaves = tree_util.leaves(packed, is_leaf=_is_pt)
        ex = cls(name, kind, density=density, alpha=alpha, meta=meta,
                 device=leaves[0].pos.device if leaves else "cpu")
        ex._reps[PACKED] = packed
        return ex

    # ---------------- representation lattice ----------------

    def available(self) -> tuple[str, ...]:
        """Representations already realised (no conversion cost)."""
        return tuple(r for r in REPRESENTATIONS if r in self._reps)

    def as_(self, rep: str):
        """The expert in representation ``rep`` (converted and cached).
        DENSE, TERNARY and PACKED are nested dicts mirroring the source;
        GOLOMB is a flat ``{path: bytes}`` dict."""
        if rep not in REPRESENTATIONS:
            raise ValueError(f"unknown representation {rep!r}; "
                             f"choose from {REPRESENTATIONS}")
        if rep not in self._reps:
            self._reps[rep] = self._realize(rep)
        return self._reps[rep]

    def _realize(self, rep: str):
        from repro_torch.core.compeft import (compress, compress_packed,
                                              compress_packed_exact,
                                              decompress)
        from repro_torch.core.packing import pack_tree, unpack_tree
        have = self._reps
        if rep == PACKED:
            if TERNARY in have:
                return pack_tree(have[TERNARY])
            if DENSE in have:
                if self.method == "exact":
                    return compress_packed_exact(have[DENSE], self._ccfg())
                return compress_packed(have[DENSE], self._ccfg())
            if GOLOMB in have:
                return self._decode_golomb()
            raise ValueError(f"expert {self.name!r} holds no representation")
        if rep == TERNARY:
            if PACKED not in have and DENSE in have and self.method == "exact":
                return compress(have[DENSE], self._ccfg())
            return unpack_tree(self.as_(PACKED))
        if rep == DENSE:
            # lossy inverse: the reconstruction tau_tilde = signs * scale
            return decompress(self.as_(TERNARY))
        return self._encode_golomb()                         # GOLOMB

    def _ccfg(self):
        from repro_torch.core.compeft import CompressionConfig
        if not (0.0 < self.density <= 1.0):
            raise ValueError(
                f"expert {self.name!r} was not given a compression "
                "density; pass density= to compress a dense tau")
        return CompressionConfig(density=self.density, alpha=self.alpha,
                                 per_tensor=self.per_tensor)

    def _encode_golomb(self) -> dict[str, bytes]:
        from repro_torch.core import golomb
        from repro_torch.core.packing import signs_np
        blobs = {}
        for path, pt in self.packed.items():
            blobs[path] = golomb.encode(signs_np(pt), float(pt.scale))
            self._leaf_meta.setdefault(path, {
                "shape": tuple(pt.shape), "orig_dtype": pt.orig_dtype})
        return blobs

    def _decode_golomb(self) -> dict:
        """One host decode per leaf (the vectorized codec), planes placed
        on the expert's device."""
        from repro_torch.core import golomb
        out = {}
        for path, (signs, scale) in golomb.decode_tree(
                self._reps[GOLOMB]).items():
            m = self._leaf_meta[path]
            out[path] = planes_from_signs(signs, scale, m["shape"],
                                          m["orig_dtype"], self.device)
        return tree_util.unflatten_paths(out)

    def drop(self, rep: str) -> None:
        """Forget a cached representation (frees e.g. the dense tau once
        the planes exist); it is rebuilt on the next ``as_`` if it can be."""
        if len(self._reps) > 1:
            self._reps.pop(rep, None)

    # ---------------- serving views ----------------

    def as_path_dict(self, rep: str = PACKED) -> dict[str, Any]:
        """Flat ``{path: leaf}`` view of ``as_(rep)``; paths match the base
        parameter tree's."""
        tree = self.as_(rep)
        if rep == GOLOMB:
            return dict(tree)
        is_leaf = _is_pt if rep == PACKED else _is_ct if rep == TERNARY \
            else None
        return dict(tree_util.flatten_with_paths(tree, is_leaf=is_leaf))

    @property
    def packed(self) -> dict:
        """Flat ``{path: PackedTernary}``: what the serving tiers and the
        merge kernels read."""
        return self.as_path_dict(PACKED)

    def to_dense_tau(self) -> dict:
        """The reconstruction ``tau_tilde = signs * scale`` (always the
        reconstruction, even when the original dense tau is cached)."""
        from repro_torch.core.compeft import decompress
        return decompress(self.as_(TERNARY))

    # ---------------- accounting ----------------

    def nbytes(self, rep: str = PACKED) -> int:
        """Byte size of one representation (default: the packed one)."""
        from repro_torch.core.packing import tree_packed_bytes
        if rep == PACKED:
            return tree_packed_bytes(self.packed)
        tree = self.as_(rep)
        if rep == DENSE:
            return sum(l.numel() * l.element_size()
                       for l in tree_util.leaves(tree))
        if rep == TERNARY:
            return sum(c.signs.numel() + 4
                       for c in tree_util.leaves(tree, is_leaf=_is_ct))
        return sum(len(b) for b in tree.values())            # GOLOMB

    def summary(self) -> dict:
        """Diagnostics: density, bits per representation, and the
        reconstruction error when the dense tau is at hand."""
        from repro_torch.core.compeft import compression_summary
        from repro_torch.core.packing import golomb_total_bits
        tern = self.as_(TERNARY)
        if DENSE in self._reps:
            s = compression_summary(self._reps[DENSE], tern)
        else:
            comps = tree_util.leaves(tern, is_leaf=_is_ct)
            n = sum(int(np.prod(c.shape)) for c in comps)
            nnz = sum(int(c.signs.abs().to(torch.int32).sum())
                      for c in comps)
            s = {"n_params": n, "nnz": nnz, "density": nnz / max(n, 1),
                 "dense_bits": 16 * n, "rel_recon_err": None}
        s["name"] = self.name
        s["kind"] = self.kind
        s["bytes"] = {r: self.nbytes(r) for r in self.available()}
        s["bytes"][PACKED] = self.nbytes(PACKED)
        s.setdefault("golomb_bits",
                     golomb_total_bits(s["n_params"],
                                       max(s["density"], 1e-12)))
        return s

    def __repr__(self) -> str:
        return (f"Expert(name={self.name!r}, kind={self.kind!r}, "
                f"density={self.density}, alpha={self.alpha}, "
                f"reps={list(self.available())})")

    # ---------------- persistence ----------------

    def save(self, path: str) -> dict:
        """Write the Golomb artifact: a ``.cpft`` path writes the wire
        container, any other path the npz layout.  Returns
        ``{dense_bytes, compressed_bytes, ratio}`` (bf16 as the dense
        baseline)."""
        from repro_torch.transport.wire import WIRE_SUFFIX, encode_expert
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if path.endswith(WIRE_SUFFIX):
            blob = encode_expert(self, rep=GOLOMB)
            with open(path, "wb") as f:
                f.write(blob)
            dense = sum(pt.n_elements * 2 for pt in self.packed.values())
            return {"dense_bytes": dense, "compressed_bytes": len(blob),
                    "ratio": dense / max(len(blob), 1)}
        blobs = self.as_(GOLOMB)
        packed = self.packed
        manifest = {"format": _FORMAT, "name": self.name, "kind": self.kind,
                    "density": self.density, "alpha": self.alpha,
                    "meta": self.meta, "leaves": []}
        arrays, dense_bytes = {}, 0
        for i, (p, blob) in enumerate(blobs.items()):
            key = f"e{i}_{_sanitize(p)[:80]}"
            arrays[key] = np.frombuffer(blob, np.uint8)
            pt = packed[p]
            manifest["leaves"].append({
                "path": p, "key": key, "shape": list(pt.shape),
                "dtype": dtype_name(pt.orig_dtype)})
            dense_bytes += pt.n_elements * 2       # bf16 baseline
        np.savez(path, manifest=json.dumps(manifest), **arrays)
        comp_bytes = sum(a.nbytes for a in arrays.values())
        return {"dense_bytes": dense_bytes, "compressed_bytes": comp_bytes,
                "ratio": dense_bytes / max(comp_bytes, 1)}

    @classmethod
    def load(cls, path: str, name: Optional[str] = None,
             device="cuda") -> "Expert":
        """Read an expert file: npz (this format or the legacy
        ``export_expert`` one) or ``.cpft`` (sniffed by its magic).  The
        planes are decoded on first ``as_`` and placed on ``device``."""
        from repro_torch.transport.wire import MAGIC, decode_expert
        dev = resolve_device(device)
        with open(path, "rb") as f:
            head = f.read(4)
        if head == MAGIC:
            with open(path, "rb") as f:
                return decode_expert(f.read(), name=name, device=dev)
        with np.load(path) as data:
            manifest = json.loads(str(data["manifest"]))
            legacy = manifest.get("format") != _FORMAT
            ex = cls(
                name or manifest.get("name")
                or os.path.splitext(os.path.basename(path))[0],
                manifest.get("kind", "full"),
                density=manifest.get("density", 0.0),
                alpha=manifest.get("alpha", 1.0),
                meta=manifest.get("meta", {"legacy_format": True} if legacy
                                  else {}),
                device=dev)
            blobs = {}
            for leaf in manifest["leaves"]:
                blobs[leaf["path"]] = data[leaf["key"]].tobytes()
                ex._leaf_meta[leaf["path"]] = {
                    "shape": tuple(leaf["shape"]),
                    "orig_dtype": torch_dtype(leaf["dtype"])}
        ex._reps[GOLOMB] = blobs
        ex._manifest = manifest
        return ex


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "__", path)


def as_expert(obj: Any, name: str = "expert") -> Expert:
    """An Expert as it is; anything with ``.packed`` wrapped as one."""
    if isinstance(obj, Expert):
        return obj
    if hasattr(obj, "packed"):
        return Expert.from_packed(
            getattr(obj, "name", name), getattr(obj, "kind", "full"),
            obj.packed, density=getattr(obj, "density", 0.0),
            alpha=getattr(obj, "alpha", 1.0),
            meta=dict(getattr(obj, "meta", {}) or {}))
    raise TypeError(f"cannot interpret {type(obj).__name__} as an Expert")
