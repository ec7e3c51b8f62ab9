"""Gated feed-forward block (PyTorch port of ``repro/models/ffn.py::dense_ffn``)."""

from __future__ import annotations

import torch

from repro_torch.models.attention import _proj
from repro_torch.models.delta import add_delta, delta_proj


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return torch.nn.functional.silu(x)
    if kind == "geglu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


def dense_ffn(x: torch.Tensor, p: dict, cfg, dp=None,
              eid=None) -> torch.Tensor:
    """x [B, T, D].  Gated: out = (act(x @ wg) * (x @ wu)) @ wo, each
    projection plus the row's grouped ternary delta under an overlay."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFNs are served by merge-on-swap "
                                  "(ROADMAP queue 1, item 12)")
    dp = dp or {}
    g_lin = add_delta(_proj(x, p["wg"]), delta_proj(x, dp.get("wg"), eid))
    if cfg.activation in ("swiglu", "geglu"):
        u = add_delta(_proj(x, p["wu"]), delta_proj(x, dp.get("wu"), eid))
        h = _act(g_lin, cfg.activation) * u
    else:
        h = _act(g_lin, cfg.activation)
    return add_delta(_proj(h, p["wo"]), delta_proj(h, dp.get("wo"), eid))
