"""(IA)^3: learned rescaling vectors on K, V and FFN-hidden activations
(port of ``repro/peft/ia3.py``).

Applied as a multiplicative transform on the *output dims* of wk / wv /
wu, which keeps the model code untouched and lets (IA)^3 share the merge
path with LoRA and ComPEFT deltas."""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch import tree as tree_util

PyTree = Any

IA3_TARGETS = r"(wk|wv|wu|Wk|Wv)$"


@dataclasses.dataclass(frozen=True)
class IA3Config:
    targets: str = IA3_TARGETS


def _stacked(ps: str) -> bool:
    return ps.startswith(("blocks", "enc_blocks"))


def init_ia3(params: PyTree, cfg: IA3Config | None = None) -> PyTree:
    """One vector per targeted weight over its output dims, initialised to
    0 (scale = 1 + ell, so init is identity)."""
    cfg = cfg or IA3Config()
    out = {}
    for ps, leaf in tree_util.flatten_with_paths(params):
        name = ps.split("/")[-1]
        if leaf.ndim < 2 or re.search(cfg.targets, name) is None:
            continue
        if not leaf.is_floating_point():
            continue
        # stacked unit weights keep their leading U; scale covers out dims
        if _stacked(ps):
            shape = (leaf.shape[0],) + tuple(leaf.shape[2:])
        else:
            shape = tuple(leaf.shape[1:])
        out[ps] = {"ell": torch.zeros(shape, dtype=torch.float32,
                                      device=leaf.device)}
    return out


def apply_ia3(params: PyTree, ia3_params: PyTree,
              cfg: IA3Config | None = None) -> PyTree:
    out = []
    for ps, leaf in tree_util.flatten_with_paths(params):
        if ps in ia3_params:
            ell = ia3_params[ps]["ell"]
            if ell.ndim == leaf.ndim - 1 and _stacked(ps):
                scale = (1.0 + ell)[:, None]  # broadcast over d_in
            else:
                scale = (1.0 + ell)[None]
            out.append((leaf.to(torch.float32) * scale).to(leaf.dtype))
        else:
            out.append(leaf)
    return tree_util.unflatten_like(params, out)
