"""Task vectors over PEFT or full parameter trees: tau = theta_ft -
theta_init (§2 of the paper), plus the legacy expert-artifact container
(port of ``repro/peft/task_vector.py``).

The expert container role belongs to :class:`repro_torch.expert.Expert`
behind the :mod:`repro_torch.api` facade.  ``ExpertArtifact`` /
``compress_expert`` / ``reconstruct_expert`` remain as thin deprecated
shims, as in the reference.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.compeft import decompress
from repro_torch.core.packing import (PackedTernary, tree_packed_bytes,
                                      unpack_tree)
from repro_torch.expert import Expert

PyTree = Any


def task_vector(theta_init: PyTree, theta_ft: PyTree) -> PyTree:
    """tau = theta_ft - theta_init, f32 leaves."""
    return tree_util.tree_map(
        lambda a, b: b.to(torch.float32) - a.to(torch.float32),
        theta_init, theta_ft)


def apply_task_vector(theta_init: PyTree, tau: PyTree,
                      scale: float = 1.0) -> PyTree:
    return tree_util.tree_map(
        lambda w, t: (w.to(torch.float32)
                      + scale * t.to(torch.float32)).to(w.dtype),
        theta_init, tau)


@dataclasses.dataclass
class ExpertArtifact:
    """DEPRECATED packed-expert container (use
    :class:`repro_torch.expert.Expert`).

    ``packed`` is the bitplane tree.  Still accepted by the serving tiers
    (normalized to an Expert on the way in).
    """

    name: str
    kind: str                 # "lora" | "ia3" | "full"
    packed: PyTree            # tree of PackedTernary
    density: float
    alpha: float
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return tree_packed_bytes(dict(tree_util.flatten_with_paths(
            self.packed, is_leaf=lambda x: isinstance(x, PackedTernary))))

    def to_dense_tau(self) -> PyTree:
        return decompress(unpack_tree(self.packed))


def compress_expert(name: str, kind: str, tau: PyTree, density: float,
                    alpha: float, per_tensor: bool = True,
                    method: str = "streaming") -> ExpertArtifact:
    """DEPRECATED: use ``repro_torch.api.compress`` (returns an Expert).

    Compress a task vector into the packed serving artifact, on the
    device its leaves lie on.  ``method='streaming'`` (default) runs the
    histogram-threshold pipeline; ``method='exact'`` the sort-based
    per-leaf path, kept as the numerics oracle.
    """
    warnings.warn("compress_expert is deprecated; use repro_torch.api."
                  "compress (returns repro_torch.expert.Expert)",
                  DeprecationWarning, stacklevel=2)
    ex = Expert.from_task_vector(tau, name=name, kind=kind, density=density,
                                 alpha=alpha, per_tensor=per_tensor,
                                 method=method, meta={"method": method})
    return ExpertArtifact(name=name, kind=kind, packed=ex.as_("packed"),
                          density=density, alpha=alpha,
                          meta={"method": method})


def reconstruct_expert(theta_init: PyTree, artifact,
                       treedef_like: Optional[PyTree] = None) -> PyTree:
    """theta_init + decompressed tau (tree structures must match).

    Accepts both the legacy :class:`ExpertArtifact` and
    :class:`repro_torch.expert.Expert`.
    """
    tau = artifact.to_dense_tau()
    return apply_task_vector(theta_init, tau)
