"""ComPEFT expert artifact of the port: DENSE and PACKED representations.

Port of ``repro/expert.py``, cut to the lattice edge the serving path
uses:

    DENSE ──compress (streaming)──> PACKED ──unpack──> DENSE (tau_tilde)

* ``DENSE``  — nested dict of f32 task-vector leaves ``tau = theta_ft -
  theta_init`` (or the reconstruction ``signs * scale``).
* ``PACKED`` — nested dict of :class:`~repro_torch.core.packing.
  PackedTernary` bitplanes, what the device cache keeps resident and the
  grouped kernel reads.

Compression runs on the device the task vector lies on.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import (PackedTernary, decompress_packed,
                                      tree_packed_bytes)

DENSE = "dense"
PACKED = "packed"
REPRESENTATIONS = (DENSE, PACKED)


def _is_pt(x) -> bool:
    return isinstance(x, PackedTernary)


class Expert:
    """A named ComPEFT expert with lazily realised representations."""

    def __init__(self, name: str, kind: str = "full", *,
                 density: float = 0.0, alpha: float = 1.0,
                 per_tensor: bool = True, method: str = "streaming",
                 meta: Optional[dict] = None):
        self.name = name
        self.kind = kind
        self.density = density
        self.alpha = alpha
        self.per_tensor = per_tensor
        self.method = method
        self.meta = dict(meta or {})
        self._reps: dict[str, Any] = {}

    @classmethod
    def from_task_vector(cls, tau: dict, *, name: str = "expert",
                         kind: str = "full", density: float = 0.05,
                         alpha: float = 1.0, per_tensor: bool = True,
                         method: str = "streaming",
                         meta: Optional[dict] = None) -> "Expert":
        """Wrap a dense task vector; compression happens on first ``as_``."""
        if method != "streaming":
            raise NotImplementedError(
                f"method={method!r}: the sort-based 'exact' path and the "
                "TERNARY representation come with the Expert codecs "
                "(ROADMAP queue 1, item 2)")
        ex = cls(name, kind, density=density, alpha=alpha,
                 per_tensor=per_tensor, method=method, meta=meta)
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
        """Adopt an existing tree of PackedTernary (for instance one
        carried across by :func:`repro_torch.convert.packed_from_jax`)."""
        ex = cls(name, kind, density=density, alpha=alpha, meta=meta)
        ex._reps[PACKED] = packed
        return ex

    def available(self) -> tuple[str, ...]:
        return tuple(r for r in REPRESENTATIONS if r in self._reps)

    def as_(self, rep: str):
        """The expert in representation ``rep`` (converted and cached)."""
        if rep not in REPRESENTATIONS:
            raise ValueError(f"unknown representation {rep!r}; the port "
                             f"holds {REPRESENTATIONS}")
        if rep not in self._reps:
            self._reps[rep] = self._realize(rep)
        return self._reps[rep]

    def _realize(self, rep: str):
        from repro_torch.core.compeft import CompressionConfig, compress_packed
        if rep == PACKED:
            if not (0.0 < self.density <= 1.0):
                raise ValueError(
                    f"expert {self.name!r} was not given a compression "
                    "density; pass density= to compress a dense tau")
            return compress_packed(self._reps[DENSE], CompressionConfig(
                density=self.density, alpha=self.alpha,
                per_tensor=self.per_tensor))
        # DENSE from PACKED: the lossy reconstruction signs * scale
        return tree_util.tree_map(decompress_packed, self.as_(PACKED),
                                  is_leaf=_is_pt)

    def drop(self, rep: str) -> None:
        """Forget a cached representation (frees e.g. the dense tau once
        the planes exist); it is rebuilt on the next ``as_`` if it can be."""
        if len(self._reps) > 1:
            self._reps.pop(rep, None)

    def as_path_dict(self, rep: str = PACKED) -> dict[str, Any]:
        """Flat ``{path: leaf}`` view of ``as_(rep)``; paths match the base
        parameter tree's."""
        is_leaf = _is_pt if rep == PACKED else None
        return dict(tree_util.flatten_with_paths(self.as_(rep),
                                                 is_leaf=is_leaf))

    @property
    def packed(self) -> dict[str, PackedTernary]:
        return self.as_path_dict(PACKED)

    def nbytes(self, rep: str = PACKED) -> int:
        if rep == PACKED:
            return tree_packed_bytes(self.packed)
        return sum(l.numel() * l.element_size()
                   for l in tree_util.leaves(self.as_(rep)))

    def __repr__(self) -> str:
        return (f"Expert(name={self.name!r}, kind={self.kind!r}, "
                f"density={self.density}, alpha={self.alpha}, "
                f"reps={list(self.available())})")
