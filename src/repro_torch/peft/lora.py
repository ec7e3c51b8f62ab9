"""LoRA: low-rank adapters over arbitrary weight trees (port of
``repro/peft/lora.py``).

Adapters attach by *path pattern* to any >= 2-D float weight in the
model's parameter tree (stacked unit dims are handled transparently: a
weight [U, d_in, d_out] gets A [U, d_in, r], B [U, r, d_out]).
Application is a functional merge ``W_eff = W + (alpha/r) * A @ B``, so
the model code never changes.  A LoRA tree is ``{path: {"a", "b"}}``
with the reference's path strings (``"blocks/block0/attn/wq"``), so a
``kind="lora"`` artifact of either package names the same leaves.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Union

import numpy as np
import torch

from repro_torch import tree as tree_util

PyTree = Any

DEFAULT_TARGETS = r"(wq|wk|wv|wo|wg|wu|Wr|Wk|Wv|Wo|in_proj|out_proj)$"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: str = DEFAULT_TARGETS  # regex on the last path component

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _path_str(path) -> str:
    """A path as the reference spells it: keys joined by ``"/"`` (a path
    string of :func:`repro_torch.tree.flatten_with_paths` is already
    one)."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _is_target(path, leaf, cfg: LoraConfig) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2 or not leaf.is_floating_point():
        return False
    name = _path_str(path).split("/")[-1]
    return re.search(cfg.targets, name) is not None


def _factor_shapes(shape: tuple[int, ...], rank: int, stacked: bool):
    """Factor [(U,) d_in, *out] as A [(U,) d_in, r], B [(U,) r, prod(out)]."""
    lead = shape[:1] if stacked else ()
    core = shape[1:] if stacked else shape
    d_in = core[0]
    d_out = int(np.prod(core[1:]))
    return lead + (d_in, rank), lead + (rank, d_out), core


def init_lora(gen: Union[torch.Generator, int], params: PyTree,
              cfg: LoraConfig,
              stacked_prefixes: tuple[str, ...] = ("blocks", "enc_blocks")
              ) -> PyTree:
    """Create the LoRA tree mirroring targeted weights.  A ~ N(0, 1/r)
    drawn from ``gen`` (a ``torch.Generator`` on the parameters' device,
    or an int seed for one) in leaf order; B = 0, so the initial delta is
    exactly zero.  The draws are not JAX's: tests carry A across."""
    flat = tree_util.flatten_with_paths(params)
    if isinstance(gen, int):
        dev = flat[0][1].device if flat else torch.device("cpu")
        gen = torch.Generator(device=dev).manual_seed(gen)
    out: dict[str, dict] = {}
    for ps, leaf in flat:
        if not _is_target(ps, leaf, cfg):
            continue
        stacked = any(ps.startswith(pref) for pref in stacked_prefixes)
        a_shape, b_shape, _ = _factor_shapes(tuple(leaf.shape), cfg.rank,
                                             stacked)
        a = torch.randn(a_shape, generator=gen, dtype=torch.float32,
                        device=leaf.device) / np.float32(math.sqrt(cfg.rank))
        out[ps] = {"a": a.to(leaf.dtype),
                   "b": torch.zeros(b_shape, dtype=leaf.dtype,
                                    device=leaf.device)}
    return out


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.ndim == 3:  # stacked units
        return torch.einsum("uir,uro->uio", a, b)
    return a @ b


def lora_delta(lora_params: PyTree, base_shapes: dict[str, tuple[int, ...]],
               cfg: LoraConfig) -> dict[str, torch.Tensor]:
    """Materialise dense deltas per targeted path (in the factors'
    dtype)."""
    return {ps: (_product(ab["a"], ab["b"]) * cfg.scaling).reshape(
                base_shapes[ps])
            for ps, ab in lora_params.items()}


def apply_lora(params: PyTree, lora_params: PyTree, cfg: LoraConfig) -> PyTree:
    """W_eff = W + scaling * A@B (in f32, cast back), matched by path.
    Differentiable in the LoRA factors."""
    out = []
    for ps, leaf in tree_util.flatten_with_paths(params):
        if ps in lora_params:
            ab = lora_params[ps]
            d = _product(ab["a"].to(torch.float32), ab["b"].to(torch.float32))
            d = (d * cfg.scaling).reshape(leaf.shape)
            out.append((leaf.to(torch.float32) + d).to(leaf.dtype))
        else:
            out.append(leaf)
    return tree_util.unflatten_like(params, out)


def base_shapes_of(params: PyTree) -> dict[str, tuple[int, ...]]:
    return {ps: tuple(l.shape)
            for ps, l in tree_util.flatten_with_paths(params)}
