"""Attention for prefill and decode, and the q/k/v/o projections (PyTorch).

Port of ``repro/models/attention.py``.  The JAX package computes attention
in plain jnp (no Pallas kernel), so the port computes it in plain PyTorch.

Prefill and training take the reference's chunked flash attention
(:func:`flash_attention`): a static schedule of (q-chunk, kv-chunk) tiles,
pruned above the causal diagonal and outside a sliding window
(:func:`_chunk_pairs`), and per q-chunk an online softmax of f32 ``(m, l,
o)`` over its band of kv tiles, in the reference's order.  One call holds
one tile's scores at a time, so its transient memory is O(B Hq cq ck),
never O(T S), and its backward (:class:`_FlashAttention`) walks the same
schedule, recomputing each tile's probabilities from each row's saved
maximum and sum (its log-sum-exp): the counterpart of the reference's
``jax.checkpoint`` of a tile step.  The chunk sizes the model code uses are the module constants
:data:`CHUNK_Q` and :data:`CHUNK_K` (the reference's
``Runtime.attn_chunk_q/k``), read at each call.  A call that fits in one
tile computes what the whole-matrix form computed, bit for bit.

Decode attends one token over the dense ring or the paged pools with the
same masked-softmax arithmetic; a fully masked query row yields zeros,
like the reference's flash partials.  Layouts are the reference's: q [B,
T, Hq, D], k/v [B, S, Hkv, D]; paged pools [NB, BS, Hkv, D] with block
tables [B, MAXB] (:mod:`repro_torch.serve.paged_kv`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import apply_rope, rms_norm, softcap
from repro_torch.models.delta import add_delta, delta_proj, eff_param

NEG_INF = -2.0e38

# the reference's ``Runtime.attn_chunk_q`` and ``attn_chunk_k``: the tile
# of prefill and training attention
CHUNK_Q = 512
CHUNK_K = 512


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


def _chunk_pairs(nq: int, nk: int, causal: bool,
                 window_chunks: Optional[int]) -> list:
    """The reference's static (i, j) tile schedule, i ascending and j
    ascending within i.  For causal self-attention only j <= i tiles are
    emitted; a window also drops the tiles wholly below its band."""
    return [(i, j) for i in range(nq) for j in range(nk)
            if not (causal and j > i)
            and not (window_chunks is not None and i - j > window_chunks)]


class _Tiles:
    """One call's tiling: chunk sizes, padded lengths, the schedule by
    band (each q-chunk's kv chunks in order), and each tile's dead
    positions (None where every position of the tile is visible, which
    the host knows from the static positions alone)."""

    def __init__(self, T, S, cfg, causal, q_offset, kv_valid_len, kv_start,
                 chunk_q, chunk_k, device):
        self.cq, self.ck = min(chunk_q, T), min(chunk_k, S)
        self.nq, self.nk = -(-T // self.cq), -(-S // self.ck)
        self.Tp, self.Sp = self.nq * self.cq, self.nk * self.ck
        self.window = cfg.window if causal else None
        win_chunks = (math.ceil(self.window / self.ck) + 1
                      if self.window is not None else None)
        self.bands: dict = {}
        for i, j in _chunk_pairs(self.nq, self.nk, causal and T == S,
                                 win_chunks):
            self.bands.setdefault(i, []).append(j)
        self.causal, self.q_offset = causal, q_offset
        self.kv_len = S if kv_valid_len is None else kv_valid_len
        self.kv_start = kv_start
        self.device = device
        self._rows: dict = {}       # kv chunk -> its rows' pad positions

    def dead(self, i: int, j: int) -> Optional[torch.Tensor]:
        """Tile (i, j)'s masked positions (True where a query may not see
        a key), broadcastable to its scores [B, Hkv, G, cq, ck], in the
        reference's terms: causal positions offset by ``q_offset``, the
        window and ``kv_len`` ([cq, ck], built only for a tile they cut),
        and each row's ``kv_start`` ([B, 1, 1, 1, ck], built once per kv
        chunk)."""
        q0, k0 = self.q_offset + i * self.cq, j * self.ck
        q1, k1 = q0 + self.cq - 1, k0 + self.ck - 1
        rows = None
        if self.kv_start is not None:
            if j not in self._rows:
                k_pos = torch.arange(k0, k1 + 1, device=self.device)
                self._rows[j] = (k_pos[None] < self.kv_start.to(
                    torch.int64)[:, None])[:, None, None, None]
            rows = self._rows[j]
        if (k1 < self.kv_len and (not self.causal or q0 >= k1)
                and (self.window is None or q1 - k0 < self.window)):
            return rows
        q_pos = torch.arange(q0, q1 + 1, device=self.device)[:, None]
        k_pos = torch.arange(k0, k1 + 1, device=self.device)[None, :]
        dead = k_pos >= self.kv_len
        if self.causal:
            dead = dead | (q_pos < k_pos)
        if self.window is not None:
            dead = dead | ((q_pos - k_pos) >= self.window)
        return dead if rows is None else dead | rows

    def chunked(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, Hkv, G, D] -> [B, nq, Hkv, G, cq, D], zero-padded to
        whole chunks, each chunk contiguous (one copy)."""
        B, T, Hkv, G, D = x.shape
        x = _pad_to(x, self.Tp).view(B, self.nq, self.cq, Hkv, G, D)
        return x.permute(0, 1, 3, 4, 2, 5).contiguous()

    def unchunked(self, x: torch.Tensor, T: int) -> torch.Tensor:
        """The inverse of :meth:`chunked`: [B, T, Hkv * G * D]."""
        B, nq, Hkv, G, cq, D = x.shape
        x = x.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * cq, Hkv * G * D)
        return x[:, :T]


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """f32, as the reference widens each tile; f64 stays f64."""
    return torch.promote_types(q.dtype, torch.float32)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, L, ...] zero-padded along dim 1 to n."""
    if x.shape[1] == n:
        return x
    pad = torch.zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _scores(qi, kj, scale: float, cap):
    """One tile's scores [B, Hkv, G, cq, ck] from qi [B, Hkv, G, cq, D]
    and kj [B, ck, Hkv, D] in their (compute) dtype: the product, the
    scale and the softcap (``common.softcap``'s arithmetic, without its
    round trip through f32, so that f64 stays f64).  Returns (scores,
    tanh of the capped scores or None)."""
    s = torch.einsum("bhgtd,bshd->bhgts", qi, kj) * scale
    if cap is None:
        return s, None
    t = torch.tanh(s / cap)
    return cap * t, t


def _safe(m):
    """The reference's m_safe: 0 for a row that has seen no key yet."""
    return m.masked_fill(m <= NEG_INF / 2, 0.0)


def _flash_forward(qc, kf, vf, tiles: _Tiles, scale: float, cap):
    """The tile loop over qc [B, nq, Hkv, G, cq, D] (:meth:`_Tiles.
    chunked`), kf/vf [B, Sp, Hkv, D] in the compute dtype -> (o [B, nq,
    Hkv, G, cq, D], stats [B, nq, Hkv, G, cq, 2]: each row's final safe
    maximum m and softmax sum l, whose log-sum-exp is m + log l; m = 0
    and l = 0 for a row that sees no key).  Per q-chunk, an online
    softmax over its band in the reference's order; the first tile has
    nothing to rescale."""
    cq, ck = tiles.cq, tiles.ck
    out = torch.empty_like(qc)
    stats = torch.empty(qc.shape[:-1] + (2,), dtype=qc.dtype,
                        device=qc.device)
    for i, band in tiles.bands.items():
        qi = qc[:, i]
        for n, j in enumerate(band):
            ks = slice(j * ck, (j + 1) * ck)
            s, _ = _scores(qi, kf[:, ks], scale, cap)
            dead = tiles.dead(i, j)
            if dead is not None:
                s = s.masked_fill(dead, NEG_INF)
            m_tile = s.amax(dim=-1, keepdim=True)
            m_new = m_tile if n == 0 else torch.maximum(m, m_tile)
            m_safe = _safe(m_new)
            p = torch.exp(s - m_safe)      # dead: exp(-2e38 - m_safe) = 0
            l_tile = p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhgts,bshd->bhgtd", p, vf[:, ks])
            if n == 0:
                l, o = l_tile, pv
            else:
                alpha = torch.exp(m - m_safe).masked_fill_(
                    m <= NEG_INF / 2, 0.0)
                l = alpha * l + l_tile
                o = alpha * o + pv
            m = m_new
        out[:, i] = o / torch.clamp_min(l, 1e-30)
        stats[:, i, ..., :1] = _safe(m)
        stats[:, i, ..., 1:] = l
    return out, stats


def _flash_backward(qc, kf, vf, stats, doc, tiles: _Tiles, scale: float,
                    cap):
    """Gradients (dq [B, nq, Hkv, G, cq, D], dk, dv [B, Sp, Hkv, D]) in
    the compute dtype, walking the forward's schedule band by band (a
    q-chunk's kv tiles in order).  Each tile's probabilities P are
    recomputed as the forward formed them, exp(s - m) / l from the row's
    saved (m, l); a first walk of the band sums each row's P dP and P,
    and ``Delta`` is their quotient, so that the row's ``dS = P (dP -
    Delta)`` sums to zero as its exact value does (Delta = rowsum(dO O)
    matches the recomputed P only to rounding, which lands on every
    score); then the softcap's ``1 - tanh^2`` and the scale.  Every
    gradient accumulates per tile in schedule order (no scatter), so the
    result is deterministic."""
    ck = tiles.ck
    m, l = stats[..., :1], torch.clamp_min(stats[..., 1:], 1e-30)
    dq = torch.zeros_like(qc)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)

    def tile(i, j):
        """(P, dP, tanh of the capped scores or None) of tile (i, j);
        a row without keys gives 0 / 1e-30."""
        ks = slice(j * ck, (j + 1) * ck)
        s, t = _scores(qc[:, i], kf[:, ks], scale, cap)
        dead = tiles.dead(i, j)
        if dead is not None:
            s = s.masked_fill(dead, NEG_INF)
        p = torch.exp(s - m[:, i]) / l[:, i]
        dp = torch.einsum("bhgtd,bshd->bhgts", doc[:, i], vf[:, ks])
        return p, dp, t

    for i, band in tiles.bands.items():
        pdp = psum = 0.0
        for j in band:
            p, dp, _ = tile(i, j)
            pdp = pdp + (p * dp).sum(dim=-1, keepdim=True)
            psum = psum + p.sum(dim=-1, keepdim=True)
        delta = pdp / torch.clamp_min(psum, 1e-30)
        for j in band:
            ks = slice(j * ck, (j + 1) * ck)
            p, dp, t = tile(i, j)
            dv[:, ks] += torch.einsum("bhgts,bhgtd->bshd", p, doc[:, i])
            ds = p * (dp - delta)
            if t is not None:
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq[:, i] += torch.einsum("bhgts,bshd->bhgtd", ds, kf[:, ks])
            dk[:, ks] += torch.einsum("bhgts,bhgtd->bshd", ds, qc[:, i])
    return dq, dk, dv


def _widened(q, k, v, tiles: _Tiles):
    """q as [B, nq, Hkv, G, cq, D] (:meth:`_Tiles.chunked`) and k, v as
    [B, Sp, Hkv, D], in the compute dtype, zero-padded to whole chunks."""
    B, T, Hq, D = q.shape
    ct = _compute_dtype(q)
    qf = q.reshape(B, T, k.shape[2], Hq // k.shape[2], D).to(ct)
    return (tiles.chunked(qf), _pad_to(k.to(ct), tiles.Sp),
            _pad_to(v.to(ct), tiles.Sp))


class _FlashAttention(torch.autograd.Function):
    """Chunked attention with a recomputing backward.  The forward saves
    q, k, v and each row's softmax statistics (m, l) in the compute dtype
    (f32; f64 for f64 inputs), nothing of size T x S."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, cfg, causal, q_offset, kv_valid_len,
                chunk_q, chunk_k):
        B, T, Hq, D = q.shape
        tiles = _Tiles(T, k.shape[1], cfg, causal, q_offset, kv_valid_len,
                       kv_start, chunk_q, chunk_k, q.device)
        scale = 1.0 / np.sqrt(D)
        out, stats = _flash_forward(*_widened(q, k, v, tiles), tiles, scale,
                                    cfg.attn_softcap)
        ctx.save_for_backward(q, k, v, stats)
        ctx.tiles, ctx.scale, ctx.cap = tiles, scale, cfg.attn_softcap
        return tiles.unchunked(out, T).reshape(B, T, Hq, D).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, stats = ctx.saved_tensors
        tiles = ctx.tiles
        B, T, Hq, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        qc, kf, vf = _widened(q, k, v, tiles)
        doc = tiles.chunked(dout.reshape(B, T, Hkv, Hq // Hkv, D).to(
            qc.dtype))
        dq, dk, dv = _flash_backward(qc, kf, vf, stats, doc, tiles,
                                     ctx.scale, ctx.cap)
        return (tiles.unchunked(dq, T).reshape(B, T, Hq, D).to(q.dtype),
                dk[:, :S].to(k.dtype), dv[:, :S].to(v.dtype),
                None, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                    *, causal: bool = True, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None,
                    kv_start: Optional[torch.Tensor] = None,
                    chunk_q: int = 512, chunk_k: int = 512) -> torch.Tensor:
    """Chunked flash attention (the reference's).  q [B, T, Hq, D], k/v
    [B, S, Hkv, D] -> [B, T, Hq, D] in q.dtype, computed in f32.

    T and S are padded to whole chunks of ``min(chunk_q, T)`` and
    ``min(chunk_k, S)``; the padded queries are dropped and keys at or
    past ``kv_valid_len`` (default S) are masked.  Causal tiles above the
    diagonal are skipped when T == S, and with ``cfg.window`` the tiles
    wholly outside the window; query positions start at ``q_offset``.
    ``kv_start`` ([B] int32, optional) is each row's first real position:
    keys below it are masked, so left-padded rows ignore their pads, and
    queries inside the pad region produce zeros (callers discard them).
    """
    return _FlashAttention.apply(q, k, v, kv_start, cfg, causal, q_offset,
                                 kv_valid_len, chunk_q, chunk_k)


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


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor,
                             cur: torch.Tensor, cfg,
                             start: Optional[torch.Tensor] = None):
    """One-token attention over a (possibly sequence-cut) ring slice, as
    flash partials for a cross-shard combine.

    ``q`` [B, 1, Hq, D] (rope applied); ``k_cache``/``v_cache`` [B, S_loc,
    Hkv, D]; ``pos`` [S_loc] absolute positions (-1 empty); ``cur`` the
    query's position (0-d, on the device); ``start`` ([B], optional) masks
    slots below each row's first real token.  The reference's order: the
    score einsum, the scale, the softcap, the mask, the masked max and its
    safe value, exp, the mask again, the sum, the einsum with V.  Returns
    (o [B, Hq, D] unnormalised, m [B, Hq], l [B, Hq]), all f32; a row
    that sees no slot has m = NEG_INF and l = 0."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.to(torch.float32)) \
        * (1.0 / np.sqrt(D))
    s = softcap(s, cfg.attn_softcap)
    valid = (pos >= 0) & (pos <= cur)
    if cfg.window is not None:
        valid &= pos > (cur - cfg.window)
    if start is not None:
        valid = valid[None, :] & (pos[None, :] >= start.to(pos.dtype)[:, None])
        vmask = valid[:, None, None, :]
    else:
        vmask = valid[None, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


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
