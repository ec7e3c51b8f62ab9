"""Decoder-only LM for attention-only patterns, in PyTorch.

Port of ``repro/models/transformer.py`` for these patterns: parameter
init, token embedding, logits, the training forward (autograd through the
prefill's block code), the dense ring-buffer decode cache, prompt
prefill and the one-token decode step.  Parameters are nested dicts with
the reference's paths and layouts; block leaves carry the unit axis in
front, and a Python loop over units takes the place of ``lax.scan``.
The decode cache is updated in place (the wave holds its only copy), where
the reference donates it to a functional update.  As in the reference, a
gemma-named model (``cfg.name``) takes the (1 + scale) RMSNorm with
zero-initialised scales, and a block with ``sandwich_norm`` normalises
the attention and FFN outputs before each residual add.  An MoE block
(mixtral, llama4's alternate layers) runs the reference's GShard FFN
(``models/ffn.py::moe_ffn``); the training forward sums its aux loss over
blocks and units, as the reference's unit scan does.

The serving functions take ``comm`` (a
:class:`~repro_torch.distributed.collectives.ServeComm`) on a serving
mesh.  The embedding and the head are then vocab-parallel along "model"
when the parameters are (the engine holds ``embed`` rows and ``lm_head``
columns cut by :func:`repro_torch.distributed.sharding.shard_params`):
the lookup sums the ranks' masked rows, and the head computes this
rank's vocab slice of the logits for every row, which the token select
gathers.  With a "model" axis the decode step (and a prefill asked for
it) runs only this rank's rows (:class:`~repro_torch.distributed.
collectives.RowLayout`) against a cache of those rows, and gathers the
final hidden rows before the head.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.models.attention import (cache_write, decode_attention,
                                          finalize_partial, flash_attention,
                                          out_project, paged_attention_partial,
                                          paged_cache_write, qkv_project)
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       rms_norm, softcap)
from repro_torch.models.delta import (add_delta, delta_proj,
                                      embed_delta_rows, eff_param,
                                      slice_unit, tied_logits_delta)
from repro_torch.models.ffn import ffn_apply


def _check_attention_only(cfg) -> None:
    if (cfg.enc_n_units or cfg.cross_attn or cfg.frontend is not None
            or any(b.kind != "attn" for b in cfg.pattern)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention-only decoder patterns "
            "(dense or MoE FFNs); recurrent (mamba, rwkv), enc-dec, "
            "cross-attention and frontend families are the rest of ROADMAP "
            "queue 1, item 12")


def _gemma(cfg) -> bool:
    """The reference's rule (``repro/models/transformer.py::_gemma``): a
    gemma-named model takes the (1 + scale) RMSNorm."""
    return cfg.name.startswith("gemma")


def _norm_init(cfg, d: int, dt, dev, units: int = 0) -> torch.Tensor:
    """A norm scale: zeros under the (1 + scale) RMSNorm, else ones."""
    shape = (units, d) if units else (d,)
    fill = torch.zeros if _gemma(cfg) else torch.ones
    return fill(shape, dtype=dt, device=dev)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``.

    The draws differ from the JAX package's threefry init; tests that
    compare the packages carry the JAX weights over with
    :mod:`repro_torch.convert` instead."""
    from repro_torch.device import resolve_device
    _check_attention_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    d, U = cfg.d_model, cfg.n_units
    params: dict = {
        "embed": embed_init(cfg.vocab, d, dt, gen, dev),
        "final_norm": _norm_init(cfg, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab), d, dt, gen, dev)
    blocks = {}
    for i, b in enumerate(cfg.pattern):
        a = b.attn
        attn = {
            "wq": dense_init((U, d, a.n_q, a.head_dim), d, dt, gen, dev),
            "wk": dense_init((U, d, a.n_kv, a.head_dim), d, dt, gen, dev),
            "wv": dense_init((U, d, a.n_kv, a.head_dim), d, dt, gen, dev),
            "wo": dense_init((U, a.n_q, a.head_dim, d), a.n_q * a.head_dim,
                             dt, gen, dev),
        }
        if a.qkv_bias:
            for name, h in (("bq", a.n_q), ("bk", a.n_kv), ("bv", a.n_kv)):
                attn[name] = torch.zeros((U, h, a.head_dim), dtype=dt,
                                         device=dev)
        if a.qk_norm:
            attn["q_norm"] = torch.ones((U, a.head_dim), dtype=dt, device=dev)
            attn["k_norm"] = torch.ones((U, a.head_dim), dtype=dt, device=dev)
        bp = {"pre_norm": _norm_init(cfg, d, dt, dev, U), "attn": attn}
        if b.ffn is not None:
            bp["ffn_norm"] = _norm_init(cfg, d, dt, dev, U)
            bp["ffn"] = _init_ffn(b.ffn, d, U, dt, gen, dev)
        if b.sandwich_norm:
            bp["post_attn_norm"] = torch.zeros((U, d), dtype=dt, device=dev)
            if b.ffn is not None:
                bp["post_ffn_norm"] = torch.zeros((U, d), dtype=dt,
                                                  device=dev)
        blocks[f"block{i}"] = bp
    params["blocks"] = blocks
    return params


def _init_ffn(f, d: int, U: int, dt, gen, dev) -> dict:
    """One block's FFN leaves with the unit axis in front: the gated MLP,
    or an MoE's f32 router, expert stacks [U, E, ...] and the optional
    shared expert (the reference's ``init_ffn``)."""
    if f.moe is None:
        return {"wg": dense_init((U, d, f.d_ff), d, dt, gen, dev),
                "wu": dense_init((U, d, f.d_ff), d, dt, gen, dev),
                "wo": dense_init((U, f.d_ff, d), f.d_ff, dt, gen, dev)}
    mo = f.moe
    E, fe = mo.n_experts, mo.d_ff_expert
    p = {"router": dense_init((U, d, E), d, torch.float32, gen, dev),
         "wg_e": dense_init((U, E, d, fe), d, dt, gen, dev),
         "wu_e": dense_init((U, E, d, fe), d, dt, gen, dev),
         "wo_e": dense_init((U, E, fe, d), fe, dt, gen, dev)}
    if mo.shared_expert_dff:
        fs = mo.shared_expert_dff
        p.update(wg_s=dense_init((U, d, fs), d, dt, gen, dev),
                 wu_s=dense_init((U, d, fs), d, dt, gen, dev),
                 wo_s=dense_init((U, fs, d), fs, dt, gen, dev))
    return p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _unit(tree: dict, u: int) -> dict:
    return tree_util.tree_map(lambda t: t[u], tree)


def _norm(x, bp, name, cfg, dp, eid):
    """The block norm ``name`` with the row's expert delta."""
    return rms_norm(x, eff_param(bp[name], dp.get(name), eid), cfg.rms_eps,
                    _gemma(cfg))


def _apply_ffn(x, bp, b, cfg, dp, eid):
    """x + the block's FFN output -> (x, aux)."""
    if b.ffn is None:
        return x, 0.0
    h = _norm(x, bp, "ffn_norm", cfg, dp, eid)
    out, aux = ffn_apply(h, bp["ffn"], b.ffn, dp=dp.get("ffn"), eid=eid)
    if b.sandwich_norm:
        out = _norm(out, bp, "post_ffn_norm", cfg, dp, eid)
    return x + out, aux


def _attn_residual(x, o, bp, b, cfg, dp, eid):
    """x + the output projection of attention ``o`` (normalised first in
    a sandwich block)."""
    out = out_project(o, bp["attn"], dp=dp.get("attn"), eid=eid)
    if b.sandwich_norm:
        out = _norm(out, bp, "post_attn_norm", cfg, dp, eid)
    return x + out


def _prefill_block(x, bp, b, cfg, positions, dp, eid, kv_start):
    h = _norm(x, bp, "pre_norm", cfg, dp, eid)
    q, k, v = qkv_project(h, bp["attn"], b.attn, positions, cfg.rms_eps,
                          dp=dp.get("attn"), eid=eid)
    o = flash_attention(q, k, v, b.attn, causal=b.attn.causal,
                        kv_start=kv_start)
    x = _attn_residual(x, o, bp, b, cfg, dp, eid)
    x, aux = _apply_ffn(x, bp, b, cfg, dp, eid)
    return x, (k, v), aux


def _decode_block(x, bp, b, cfg, st, cur, dp, eid, start, paged=None):
    """One-token step through one block, its KV written in place.

    ``paged`` (``(tables, lens, active)``) switches to the block-table
    pools: rope positions are per row (``lens``), the write lands in each
    row's current block (the trash block for inactive rows) and attention
    gathers each row's blocks.  Without it the dense ring at the shared
    position ``cur`` is used."""
    h = _norm(x, bp, "pre_norm", cfg, dp, eid)
    if paged is not None:
        tables, lens, active = paged
        positions = lens[:, None]                    # [B, 1] per row
    else:
        positions = cur.reshape(1, 1)
    q, k, v = qkv_project(h, bp["attn"], b.attn, positions, cfg.rms_eps,
                          dp=dp.get("attn"), eid=eid)
    if paged is not None:
        paged_cache_write(st["k"], st["v"], tables, lens, active, k, v)
        o, m, l = paged_attention_partial(q, st["k"], st["v"], tables, lens,
                                          start, b.attn)
        o = finalize_partial(o, m, l)[:, None].to(q.dtype)
    else:
        cache_write(st["k"], st["v"], st["pos"], k, v, cur)
        o = decode_attention(q, st["k"], st["v"], st["pos"], cur, b.attn,
                             start=start).to(q.dtype)
    x = _attn_residual(x, o, bp, b, cfg, dp, eid)
    return _apply_ffn(x, bp, b, cfg, dp, eid)[0]


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg, delta=None, eid=None, comm=None):
    tokens = tokens.to(torch.int64)
    table = params["embed"]
    if comm is not None and table.shape[0] != cfg.vocab:
        x = comm.vocab_embed(table, tokens)
    else:
        x = table[tokens]
    if delta is not None:
        x = add_delta(x, embed_delta_rows(delta.get("embed"), tokens, eid,
                                          cfg.d_model))
    if cfg.embed_scale:
        x = (x.to(torch.float32) * np.sqrt(cfg.d_model)).to(x.dtype)
    return x


def logits_of(params, x, cfg, delta=None, eid=None, comm=None):
    """Logits of the final hidden ``x``; a vocab-sharded head gives this
    rank's vocab slice (its expert delta is computed whole and cut)."""
    delta = delta or {}
    x = rms_norm(x, eff_param(params["final_norm"], delta.get("final_norm"),
                              eid), cfg.rms_eps, _gemma(cfg))
    B, T, d = x.shape
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (x.reshape(B * T, d) @ head).reshape(B, T, -1)
    if cfg.tie_embeddings:
        dl = tied_logits_delta(x, delta.get("embed"), eid, cfg.vocab)
    else:
        dl = delta_proj(x, delta.get("lm_head"), eid)
    if dl is not None and logits.shape[-1] != cfg.vocab:
        lo, hi = comm.vocab_range()
        dl = dl[..., lo:hi]
    return softcap(add_delta(logits, dl), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _units_of(blocks: dict, n_units: int) -> list[dict]:
    """The stacked block tree cut into one tree per unit.  ``unbind``
    gives views whose backward stacks the units' gradients into one
    tensor per leaf (indexing each unit would add a full-size zero
    gradient per unit)."""
    parts = {p: l.unbind(0) for p, l in tree_util.flatten_with_paths(blocks)}
    return [tree_util.unflatten_paths({p: v[u] for p, v in parts.items()})
            for u in range(n_units)]


def _train_unit(x, unit_params, cfg, positions):
    """One unit's blocks -> (x, the unit's aux: 0.0 without an MoE)."""
    aux = 0.0
    for i, b in enumerate(cfg.pattern):
        x, _, a = _prefill_block(x, unit_params[f"block{i}"], b, cfg,
                                 positions, {}, None, None)
        aux = aux + a
    return x, aux


def forward_train(params, tokens, cfg, remat_policy: str = "none"):
    """tokens [B, T] -> (logits [B, T, V], aux_loss): the whole sequence
    through every unit, differentiable by autograd (the reference's
    ``forward_train`` over ``_apply_block_train``).  ``aux`` (f32) sums
    the MoE blocks' load-balancing losses over blocks and units, in the
    reference's order; it is 0 for a dense config.

    ``remat_policy="unit"`` recomputes each unit's activations in the
    backward pass (``torch.utils.checkpoint``), the counterpart of the
    reference's ``jax.checkpoint`` of its unit scan body; ``"none"``
    keeps them."""
    _check_attention_only(cfg)
    if remat_policy not in ("none", "unit"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_params in _units_of(params["blocks"], cfg.n_units):
        if remat_policy == "unit":
            from torch.utils.checkpoint import checkpoint
            x, a = checkpoint(_train_unit, x, unit_params, cfg, positions,
                              use_reentrant=False)
        else:
            x, a = _train_unit(x, unit_params, cfg, positions)
        if torch.is_tensor(a):        # a dense unit's 0.0 adds nothing
            aux = aux + a
    return logits_of(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Decode (serving) path
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, cache_len: int, dtype=None,
                      device="cuda") -> dict:
    """Empty dense ring caches: per block k/v [U, B, S, Hkv, D] and the
    absolute position of each slot, pos [U, S] (-1 empty); ``cur``, the
    position of the next token, is a 0-d int32 tensor on ``device``."""
    dtype = dtype or dtype_of(cfg)
    layers = {}
    for i, b in enumerate(cfg.pattern):
        a, U = b.attn, cfg.n_units
        S = min(cache_len, a.window) if a.window else cache_len
        layers[f"block{i}"] = {
            "k": torch.zeros((U, batch, S, a.n_kv, a.head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((U, batch, S, a.n_kv, a.head_dim), dtype=dtype,
                             device=device),
            "pos": torch.full((U, S), -1, dtype=torch.int32, device=device),
        }
    return {"layers": layers,
            "cur": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params, token, cache, cfg, delta=None, eid=None,
                comm=None):
    """token [B, 1] -> (logits [B, 1, V], cache).

    Dense ring: ``cache["cur"]`` is the position of this token, a 0-d
    int32 tensor on the device (as under the reference's ``jit``), and
    advances by one in place.  Paged (``"tables" in cache``): each row's
    position is ``cache["lens"]``, which advances in place by
    ``cache["active"]``, so finished rows freeze.  The step reads no host
    value, so a CUDA graph can replay it; the cache tensors are written in
    place.  With ``comm`` on a "model" axis the cache holds this rank's
    rows only, and the logits are this rank's vocab slice.
    """
    x = embed_tokens(params, token, cfg, delta=delta, eid=eid, comm=comm)
    x = x.to(dtype_of(cfg))
    lay = comm.rows_for(x.shape[0], x.device) if comm is not None else None
    eid_all = eid
    if lay is not None:
        x = lay.local(x)
        eid = lay.local(eid) if eid is not None else None
    paged = "tables" in cache          # block-table KV (serve/paged_kv.py)
    if paged:
        cur = None
        pg = (cache["tables"], cache["lens"], cache["active"])
    else:
        cur, pg = cache["cur"], None
    start = cache.get("start")
    dblocks = delta.get("blocks") if delta is not None else None
    for u in range(cfg.n_units):
        unit_params = _unit(params["blocks"], u)
        unit_delta = slice_unit(dblocks, u) if dblocks is not None else {}
        for i, b in enumerate(cfg.pattern):
            name = f"block{i}"
            st = {k: t[u] for k, t in cache["layers"][name].items()}
            x = _decode_block(x, unit_params[name], b, cfg, st, cur,
                              unit_delta.get(name) or {}, eid, start,
                              paged=pg)
    if lay is not None:
        x = comm.gather_rows(x, lay)
    logits = logits_of(params, x, cfg, delta=delta, eid=eid_all, comm=comm)
    if paged:
        cache["lens"].add_(cache["active"].to(torch.int32))
    else:
        cur.add_(1)
    return logits, cache


def _ring_fill(full: torch.Tensor, S: int):
    """Place the last min(T, S) tokens of a [B, T, ...] tensor in ring
    slots (slot = pos % S).  Returns ([B, S, ...], pos [S] int32)."""
    T = full.shape[1]
    dev = full.device
    if T >= S:
        shift = (T - S) % S
        cache = torch.roll(full[:, -S:], shifts=shift, dims=1)
        pos = torch.roll(torch.arange(T - S, T, device=dev), shifts=shift)
    else:
        cache = torch.zeros((full.shape[0], S) + tuple(full.shape[2:]),
                            dtype=full.dtype, device=dev)
        cache[:, :T] = full
        pos = torch.cat([torch.arange(T, device=dev),
                         torch.full((S - T,), -1, device=dev)])
    return cache, pos.to(torch.int32)


def prefill(params, tokens, cfg, cache_len: int, delta=None,
            eid=None, start: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, comm=None,
            shard_rows: bool = False):
    """Run the whole prompt; returns (last-token logits [B, 1, V], cache).

    ``start`` ([B] int32, optional) marks each row's first real token:
    left-pad positions before it are masked out of attention, and the mask
    is kept in ``cache["start"]`` for the decode steps.  ``cache`` (from
    :func:`init_decode_cache` at this batch and ``cache_len``, optional)
    is filled in place, every tensor of it rewritten, so a caller that
    keeps its cache at fixed addresses (the engine, for its CUDA graphs)
    gets it back there; without it a fresh cache is made.  ``comm`` (a
    serving mesh) makes the embedding and head vocab-parallel; with
    ``shard_rows`` each rank runs only its rows and ``cache`` holds
    those, else every rank runs every row.
    """
    _check_attention_only(cfg)
    x = embed_tokens(params, tokens, cfg, delta=delta, eid=eid, comm=comm)
    B, T = tokens.shape
    positions = torch.arange(T, device=x.device)[None, :]
    lay = (comm.rows_for(B, x.device)
           if comm is not None and shard_rows else None)
    eid_all = eid
    if lay is not None:
        x = lay.local(x)
        eid = lay.local(eid) if eid is not None else None
        start = lay.local(start, fill=0) if start is not None else None
        B = lay.R
    dblocks = delta.get("blocks") if delta is not None else None
    if cache is None:
        cache = init_decode_cache(cfg, B, cache_len, dtype=dtype_of(cfg),
                                  device=x.device)
    for u in range(cfg.n_units):
        unit_params = _unit(params["blocks"], u)
        unit_delta = slice_unit(dblocks, u) if dblocks is not None else {}
        for i, b in enumerate(cfg.pattern):
            name = f"block{i}"
            x, (k, v), _ = _prefill_block(x, unit_params[name], b, cfg,
                                          positions,
                                          unit_delta.get(name) or {}, eid,
                                          start)
            layer = cache["layers"][name]
            S = layer["k"].shape[2]
            layer["k"][u], layer["pos"][u] = _ring_fill(k, S)
            layer["v"][u] = _ring_fill(v, S)[0]
    cache["cur"].fill_(T)
    if start is None:
        if "start" in cache:
            cache["start"].zero_()       # a kept cache: no row is padded
    elif "start" in cache:
        cache["start"].copy_(start)
    else:
        cache["start"] = start.to(torch.int32)
    x = x[:, -1:]
    if lay is not None:
        x = comm.gather_rows(x, lay)
    return logits_of(params, x, cfg, delta=delta, eid=eid_all,
                     comm=comm), cache
