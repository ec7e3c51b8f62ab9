"""Shared model primitives: norms, softcap, rope, initializers (PyTorch)."""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back.  ``gemma_style`` uses (1 + scale)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    return (y * (1.0 + s if gemma_style else s)).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, f32 [head_dim/2] (computed as the JAX package
    does, in numpy f32)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_ROPE_INV: dict = {}      # (head_dim, theta, device) -> inverse frequencies


def rope_inv(head_dim: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_frequencies` as a tensor on ``device``, made once per
    (head_dim, theta, device): the decode path then does no host-to-device
    copy, which a CUDA stream that is capturing a graph may not run."""
    key = (head_dim, float(theta), torch.device(device))
    inv = _ROPE_INV.get(key)
    if inv is None:
        inv = torch.as_tensor(rope_frequencies(head_dim, theta),
                              device=device)
        _ROPE_INV[key] = inv
    return inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [B, T, H, D]; positions broadcast to [B, T]."""
    d = x.shape[-1]
    inv = rope_inv(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv     # [B, T, D/2]
    sin = torch.sin(ang)[..., None, :]                      # [B, T, 1, D/2]
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(shape: tuple[int, ...], in_dim: int, dtype,
               gen: torch.Generator, device) -> torch.Tensor:
    """Truncated-normal fan-in init (two-sigma cut), from ``gen``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / np.sqrt(in_dim))).to(dtype)


def embed_init(vocab: int, d: int, dtype, gen: torch.Generator,
               device) -> torch.Tensor:
    t = torch.randn((vocab, d), dtype=torch.float32, device=device,
                    generator=gen)
    return (t * 0.02).to(dtype)
