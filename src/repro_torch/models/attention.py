"""Attention for prefill and decode, and the q/k/v/o projections (PyTorch).

Port of the dense-KV and paged-KV parts of ``repro/models/attention.py``.
The JAX package computes attention in plain jnp (no Pallas kernel), so the
port computes it in plain PyTorch with the same masked-softmax arithmetic:
a fully masked query row yields zeros, like the reference's flash
partials.  Layouts are the reference's: q [B, T, Hq, D], k/v [B, S, Hkv,
D]; paged pools [NB, BS, Hkv, D] with block tables [B, MAXB]
(:mod:`repro_torch.serve.paged_kv`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import apply_rope, rms_norm, softcap
from repro_torch.models.delta import add_delta, delta_proj, eff_param

NEG_INF = -2.0e38


def _masked_softmax_av(s, mask, v):
    """s [B, Hkv, G, T, S] scores, mask broadcastable to s, v [B, S, Hkv, D]
    -> o [B, T, Hkv, G, D] f32 (zeros where a row sees no key)."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe) * mask.to(torch.float32)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2, 4)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                    *, causal: bool = True,
                    kv_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over a whole prompt.  Returns [B, T, Hq, D] in q.dtype.

    ``kv_start`` ([B] int32, optional) is each row's first real position:
    keys below it are masked, so left-padded rows ignore their pads, and
    queries inside the pad region produce zeros (callers discard them).
    """
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, T, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.to(torch.float32))
    s = softcap(s * (1.0 / np.sqrt(D)), cfg.attn_softcap)
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if cfg.window is not None and causal:
        mask &= (q_pos - k_pos) < cfg.window
    mask = mask[None, None, None]                           # [1,1,1,T,S]
    if kv_start is not None:
        mask = mask & (k_pos[None] >= kv_start.to(torch.int64)[:, None, None]
                       )[:, None, None]
    o = _masked_softmax_av(s, mask, v)
    return o.reshape(B, T, Hq, D).to(q.dtype)


def cache_write(k_cache, v_cache, pos, k_new, v_new,
                cur: torch.Tensor) -> None:
    """Write one token (k_new/v_new [B, 1, Hkv, D]) at ring slot cur % S.

    ``cur`` is the 0-d int32 position on the cache's device; the slot is
    computed there, so the write reads no host value and a CUDA graph
    replays it at whatever position the cache holds.  Updates the cache
    tensors in place (they are the wave's only copy)."""
    slot = torch.remainder(cur, k_cache.shape[1]).reshape(1).to(torch.int64)
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    pos.index_copy_(0, slot, cur.reshape(1).to(pos.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     cur: torch.Tensor, cfg,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention over the ring cache; returns [B, 1, Hq, D] f32.

    ``pos`` [S] holds each slot's absolute position (-1 empty) and ``cur``
    (0-d, on the device) the query's; ``start`` ([B] int32, optional)
    masks slots below each row's first real token.
    """
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, 1, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k_cache.to(torch.float32))
    s = softcap(s * (1.0 / np.sqrt(D)), cfg.attn_softcap)
    valid = (pos >= 0) & (pos <= cur)
    if cfg.window is not None:
        valid &= pos > (cur - cfg.window)
    valid = valid[None, :]                                   # [1, S]
    if start is not None:
        valid = valid & (pos[None, :] >= start.to(pos.dtype)[:, None])
    mask = valid[:, None, None, None, :]                     # [B,1,1,1,S]
    o = _masked_softmax_av(s, mask, v_cache)
    return o.reshape(B, 1, Hq, D)


def finalize_partial(o: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> torch.Tensor:
    """Normalise flash partials (o [B, Hq, D], m and l [B, Hq])."""
    return o / torch.clamp_min(l[..., None], 1e-30)


# ---------------------------------------------------------------------------
# Paged KV (block-table pools; see repro_torch.serve.paged_kv)
# ---------------------------------------------------------------------------


def paged_cache_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                      tables: torch.Tensor, lens: torch.Tensor,
                      active: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
    """Write one token per row into each row's current block, in place.

    ``k_pool``/``v_pool`` [NB, BS, Hkv, D]; ``tables`` [B, MAXB] (-1
    unallocated); ``lens`` [B] write positions; ``active`` [B] rows still
    generating; ``k_new``/``v_new`` [B, 1, Hkv, D].  Finished rows keep
    stepping with the batch, so their writes go to the trash block, which
    no live table lists; several dead rows may hit one trash slot, which
    is never read."""
    BS = k_pool.shape[1]
    # each row's block, found on the device so that a CUDA graph replays
    # it: tables[b, lens[b] // BS], or the trash block for an inactive row
    # or an unallocated entry
    bidx = torch.clamp(torch.div(lens, BS, rounding_mode="floor"), 0,
                       tables.shape[1] - 1).to(torch.int64)
    blk = torch.gather(tables, 1, bidx[:, None])[:, 0]
    blk = torch.where(active & (blk >= 0), blk, 0).to(torch.int64)
    slot = torch.remainder(lens, BS).to(torch.int64)
    k_pool.index_put_((blk, slot), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((blk, slot), v_new[:, 0].to(v_pool.dtype))


def paged_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, tables: torch.Tensor,
                            lens: torch.Tensor, start: torch.Tensor, cfg):
    """One-token attention over gathered block-table KV.

    ``q`` [B, 1, Hq, D] (rope applied); ``pool[tables[b]]`` lays row b's
    positions out in order, so gathered position s is absolute position
    s and the mask is ``start[b] <= s <= lens[b]``, allocated blocks only,
    and the window.  The reference's order: gather (-1 clamped to block
    0), the score einsum, then the scale and the softcap, the mask, the
    masked max and its safe value, exp, the mask again, the sum, the
    einsum with V.  Returns flash partials (o [B, Hq, D], m [B, Hq],
    l [B, Hq]) in f32."""
    B, _, Hq, D = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    maxb = tables.shape[1]
    S = maxb * BS
    G = Hq // Hkv
    safe = torch.where(tables < 0, 0, tables).to(torch.int64)
    kf = k_pool[safe].reshape(B, S, Hkv, D).to(torch.float32)
    vf = v_pool[safe].reshape(B, S, Hkv, D).to(torch.float32)
    qf = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qf, kf) * (1.0 / np.sqrt(D))
    s = softcap(s, cfg.attn_softcap)
    spos = torch.arange(S, device=q.device)[None, :]
    lens_c = lens.to(torch.int64)[:, None]
    allocated = (tables >= 0)[:, :, None].expand(B, maxb, BS).reshape(B, S)
    valid = ((spos <= lens_c)
             & (spos >= start.to(torch.int64)[:, None]) & allocated)
    if cfg.window is not None:
        valid &= spos > (lens_c - cfg.window)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, K] @ w [K, ...] -> [B, T, ...] in x's dtype."""
    B, T, K = x.shape
    return (x.reshape(B * T, K) @ w.reshape(K, -1)).reshape(
        (B, T) + tuple(w.shape[1:]))


def qkv_project(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                rms_eps: float = 1e-6, dp=None, eid=None):
    """x [B, T, Dm] -> q, k, v with rope (and optional bias / qk-norm).

    ``dp``/``eid`` carry the zero-merge overlay: each projection adds the
    grouped ternary delta of the row's expert."""
    dp = dp or {}
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if dp:
        q = add_delta(q, delta_proj(x, dp.get("wq"), eid))
        k = add_delta(k, delta_proj(x, dp.get("wk"), eid))
        v = add_delta(v, delta_proj(x, dp.get("wv"), eid))
    if cfg.qkv_bias:
        q = q + eff_param(p["bq"], dp.get("bq"), eid)
        k = k + eff_param(p["bk"], dp.get("bk"), eid)
        v = v + eff_param(p["bv"], dp.get("bv"), eid)
    if cfg.qk_norm:
        q = rms_norm(q, eff_param(p["q_norm"], dp.get("q_norm"), eid,
                                  expand=2), rms_eps)
        k = rms_norm(k, eff_param(p["k_norm"], dp.get("k_norm"), eid,
                                  expand=2), rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(attn_out: torch.Tensor, p: dict, dp=None,
                eid=None) -> torch.Tensor:
    """[B, T, Hq, D] @ wo[Hq, D, Dm] -> [B, T, Dm]."""
    B, T, H, D = attn_out.shape
    flat = attn_out.reshape(B, T, H * D)
    out = _proj(flat, p["wo"].reshape(H * D, -1))
    if dp and dp.get("wo") is not None:
        out = add_delta(out, delta_proj(flat, dp["wo"], eid))
    return out
