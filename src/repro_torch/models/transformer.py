"""The LM of the port: decoder-only, enc-dec and frontend families, in
PyTorch.

Port of ``repro/models/transformer.py``: parameter init, token embedding
(with a vision frontend's ``mm_embeds`` projected and prepended), logits,
the training forward (autograd through the prefill's block code), the
encoder of the enc-dec family over stub frames, the dense ring-buffer
decode cache with the recurrent states and the cross-attention KV, prompt
prefill and the one-token decode step.  Parameters are nested dicts with
the reference's paths and layouts; block leaves carry the unit axis in
front, and a Python loop over units takes the place of ``lax.scan``.
The decode cache is updated in place (the wave holds its only copy), where
the reference donates it to a functional update: KV rings, mamba's h and
conv ring, rwkv's S and token shifts, and the cross-KV all keep their
addresses, so a CUDA graph of the decode chunk reads them.  As in the
reference, a gemma-named model (``cfg.name``) takes the (1 + scale)
RMSNorm with zero-initialised scales, and a block with ``sandwich_norm``
normalises the attention and FFN outputs before each residual add.  An
MoE block (mixtral, llama4's alternate layers, jamba's odd blocks) runs
the reference's GShard FFN (``models/ffn.py::moe_ffn``); the training
forward sums its aux loss over blocks and units, as the reference's unit
scan does.  Mamba blocks (:mod:`repro_torch.models.mamba`) and rwkv blocks
(:mod:`repro_torch.models.rwkv`) carry recurrent state through prefill and
decode; a decoder block of an enc-dec model attends the encoder output
after its self-attention (at decode, every source position of the
cross-KV).  Recurrent and cross-attention blocks take no expert delta,
as in the reference: those families have no zero-merge overlay and are
served by merge-on-swap.

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

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import (_proj, cache_write,
                                          decode_attention,
                                          finalize_partial, flash_attention,
                                          out_project, paged_attention_partial,
                                          paged_cache_write, qkv_project)
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       rms_norm, softcap)
from repro_torch.models.delta import (add_delta, delta_proj,
                                      embed_delta_rows, eff_param,
                                      slice_unit, tied_logits_delta)
from repro_torch.models.ffn import ffn_apply

# a recurrent block's decode state, by block kind: mamba's SSM state and
# conv ring, rwkv's wkv state and token shifts
_STATE_NAMES = {"mamba": ("h", "conv"), "rwkv": ("S", "tm", "cm")}


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
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (``device="meta"``: the shapes and dtypes alone).

    The draws differ from the JAX package's threefry init; tests that
    compare the packages carry the JAX weights over with
    :mod:`repro_torch.convert` instead."""
    from repro_torch.device import resolve_device
    if torch.device(device).type == "meta":
        # shapes and dtypes only (the placement rules, the dry run)
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    d = cfg.d_model
    params: dict = {
        "embed": embed_init(cfg.vocab, d, dt, gen, dev),
        "final_norm": _norm_init(cfg, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab), d, dt, gen, dev)
    if cfg.frontend is not None:
        e = cfg.frontend.embed_dim
        params["frontend_proj"] = dense_init((e, d), e, dt, gen, dev)
    params["blocks"] = {f"block{i}": _init_block(cfg, b, cfg.n_units, dt,
                                                 gen, dev)
                        for i, b in enumerate(cfg.pattern)}
    if cfg.enc_n_units:
        params["enc_blocks"] = {
            f"block{i}": _init_block(cfg, b, cfg.enc_n_units, dt, gen, dev)
            for i, b in enumerate(cfg.enc_pattern)}
        params["enc_final_norm"] = torch.ones((d,), dtype=dt, device=dev)
    return params


def _init_block(cfg, b, U: int, dt, gen, dev) -> dict:
    """One pattern block's leaves, the unit axis in front (the reference's
    ``init_block`` under its ``vmap`` over units)."""
    d = cfg.d_model
    bp: dict = {"pre_norm": _norm_init(cfg, d, dt, dev, U)}
    if b.kind == "attn":
        bp["attn"] = _init_attn(b.attn, d, U, dt, gen, dev)
    elif b.kind == "mamba":
        bp["mamba"] = _init_mamba(b.mamba, d, U, dt, gen, dev)
        bp["mamba"]["norm"] = torch.ones((U, d), dtype=dt, device=dev)
    elif b.kind == "rwkv":
        bp["rwkv"] = _init_rwkv(b.rwkv, d, U, dt, gen, dev)
    else:
        raise ValueError(b.kind)
    if b.ffn is not None:
        bp["ffn_norm"] = _norm_init(cfg, d, dt, dev, U)
        if b.kind == "rwkv":
            # the channel mix takes the FFN's place and path
            f = b.ffn.d_ff
            bp["ffn"] = {
                "cm_Wk": dense_init((U, d, f), d, dt, gen, dev),
                "cm_Wv": dense_init((U, f, d), f, dt, gen, dev),
                "cm_Wr": dense_init((U, d, d), d, dt, gen, dev),
                "cm_mu_k": torch.zeros((U, d), dtype=dt, device=dev),
                "cm_mu_r": torch.zeros((U, d), dtype=dt, device=dev)}
        else:
            bp["ffn"] = _init_ffn(b.ffn, d, U, dt, gen, dev)
    if b.sandwich_norm:
        bp["post_attn_norm"] = torch.zeros((U, d), dtype=dt, device=dev)
        if b.ffn is not None:
            bp["post_ffn_norm"] = torch.zeros((U, d), dtype=dt, device=dev)
    if cfg.cross_attn and b.kind == "attn":
        # as in the reference, every attention block of an enc-dec model
        # holds cross leaves; the encoder's go unused
        bp["cross_norm"] = torch.ones((U, d), dtype=dt, device=dev)
        bp["cross"] = _init_attn(dataclasses.replace(
            b.attn, causal=False, qkv_bias=False), d, U, dt, gen, dev)
    return bp


def _init_attn(a, d: int, U: int, dt, gen, dev) -> dict:
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
    return attn


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


def _init_mamba(m, d: int, U: int, dt, gen, dev) -> dict:
    """The reference's ``init_mamba``: S4D-real A, and a dt bias drawn from
    ``np.random.default_rng(0)`` (the same in every unit)."""
    din = m.expand * d
    R = m.dt_rank or -(-d // 16)
    a_init = np.broadcast_to(np.arange(1, m.d_state + 1, dtype=np.float32),
                             (din, m.d_state))
    dts = np.exp(np.random.default_rng(0).uniform(
        np.log(1e-3), np.log(1e-1), din)).astype(np.float32)
    dt_bias = dts + np.log(-np.expm1(-dts))

    def per_unit(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev
                               ).expand((U,) + a.shape).contiguous()

    f32 = torch.float32
    return {
        "in_proj": dense_init((U, d, 2 * din), d, dt, gen, dev),
        "conv_w": dense_init((U, m.d_conv, din), m.d_conv, dt, gen, dev),
        "conv_b": torch.zeros((U, din), dtype=dt, device=dev),
        "x_proj": dense_init((U, din, R + 2 * m.d_state), din, dt, gen, dev),
        "dt_proj": dense_init((U, R, din), R, dt, gen, dev),
        "dt_bias": per_unit(dt_bias.astype(np.float32)),
        "A_log": per_unit(np.log(a_init).astype(np.float32)),
        "D_skip": torch.ones((U, din), dtype=f32, device=dev),
        "out_proj": dense_init((U, din, d), din, dt, gen, dev),
    }


def _init_rwkv(r, d: int, U: int, dt, gen, dev) -> dict:
    """The reference's ``init_rwkv``: f32 decay base, bonus and group-norm
    leaves, token-shift mixes at zero."""
    f32 = torch.float32
    p = {
        "mu_x": torch.zeros((U, d), dtype=dt, device=dev),
        "mix_w1": dense_init((U, d, r.mix_lora), d, dt, gen, dev),
        "mix_w2": dense_init((U, len(rwkv_mod.MIX_CHANNELS), r.mix_lora, d),
                             r.mix_lora, dt, gen, dev),
        "Wr": dense_init((U, d, d), d, dt, gen, dev),
        "Wk": dense_init((U, d, d), d, dt, gen, dev),
        "Wv": dense_init((U, d, d), d, dt, gen, dev),
        "Wg": dense_init((U, d, d), d, dt, gen, dev),
        "Wo": dense_init((U, d, d), d, dt, gen, dev),
        "w0": torch.as_tensor(np.linspace(-6.0, -1.0, d), dtype=f32,
                              device=dev).expand(U, d).contiguous(),
        "decay_w1": dense_init((U, d, r.decay_lora), d, dt, gen, dev),
        "decay_w2": dense_init((U, r.decay_lora, d), r.decay_lora, f32, gen,
                               dev),
        "u": torch.zeros((U, d), dtype=f32, device=dev),
        "ln_x_scale": torch.ones((U, d), dtype=f32, device=dev),
        "ln_x_bias": torch.zeros((U, d), dtype=f32, device=dev),
    }
    for ch in rwkv_mod.MIX_CHANNELS:
        p[f"mu_{ch}"] = torch.zeros((U, d), dtype=dt, device=dev)
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


def _apply_ffn(x, bp, b, cfg, dp, eid, tp=None):
    """x + the block's FFN output -> (x, aux).  ``tp`` (a tensor-parallel
    block's hooks, d_ff cut over "model") enters the FFN and sums its
    output over "model"."""
    if b.ffn is None:
        return x, 0.0
    h = _norm(x, bp, "ffn_norm", cfg, dp, eid)
    if tp is not None:
        h = tp.enter(h)
    out, aux = ffn_apply(h, bp["ffn"], b.ffn, dp=dp.get("ffn"), eid=eid)
    if tp is not None:
        out = tp.reduce(out)
    if b.sandwich_norm:
        out = _norm(out, bp, "post_ffn_norm", cfg, dp, eid)
    return x + out, aux


def _attn_residual(x, o, bp, b, cfg, dp, eid, tp=None):
    """x + the output projection of attention ``o`` (normalised first in
    a sandwich block); ``tp`` sums a head-cut projection over "model"."""
    out = out_project(o, bp["attn"], dp=dp.get("attn"), eid=eid)
    if tp is not None:
        out = tp.reduce(out)
    if b.sandwich_norm:
        out = _norm(out, bp, "post_attn_norm", cfg, dp, eid)
    return x + out


def _cross_kv(enc_out: torch.Tensor, cp: dict):
    """The cross-attention K/V [B, S_src, Hkv, D] of encoder output."""
    return _proj(enc_out, cp["wk"]), _proj(enc_out, cp["wv"])


def _cross_attend(x, bp, b, cfg, ck, cv):
    """x + cross-attention over every source position of (ck, cv): no
    rope, no mask, no expert delta (the reference's cross branch)."""
    hc = rms_norm(x, bp["cross_norm"], cfg.rms_eps)
    qc = _proj(hc, bp["cross"]["wq"])
    oc = flash_attention(qc, ck, cv, b.attn, causal=False)
    return x + out_project(oc, bp["cross"])


def _mamba_block(x, bp, b, cfg, state, chunk: int):
    """-> (x, aux, (h, conv ring))."""
    h = rms_norm(x, bp["pre_norm"], cfg.rms_eps)
    out, new_state = mamba_mod.mamba_forward(h, bp["mamba"], b.mamba,
                                             state=state, chunk=chunk)
    x, aux = _apply_ffn(x + out, bp, b, cfg, {}, None)
    return x, aux, new_state


def _rwkv_block(x, bp, b, cfg, state, chunk: int, impl: str):
    """-> (x, (S, time-mix shift, channel-mix shift))."""
    h = rms_norm(x, bp["pre_norm"], cfg.rms_eps)
    tm_state = (state[0], state[1]) if state is not None else None
    out, (S, tm) = rwkv_mod.rwkv_time_mix(h, bp["rwkv"], b.rwkv,
                                          state=tm_state, chunk=chunk,
                                          impl=impl)
    x = x + out
    h2 = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
    out2, cm = rwkv_mod.rwkv_channel_mix(
        h2, bp["ffn"], state=state[2] if state is not None else None)
    return x + out2, (S, tm, cm)


def _apply_block(x, bp, b, cfg, positions, dp, eid, kv_start,
                 enc_out=None, tp=None):
    """One block over a whole sequence from a zero state (training and
    prefill) -> (x, aux, this block's decode state: (k, v) of an
    attention block, the final recurrent state of a mamba or rwkv
    block).  ``tp`` (:class:`repro_torch.train.within_pod.TensorParallel`)
    runs an attention block's local heads and its FFN's d_ff slice, and
    sums each output over "model"."""
    if b.kind == "mamba":
        return _mamba_block(x, bp, b, cfg, None, mamba_mod.CHUNK)
    if b.kind == "rwkv":
        x, st = _rwkv_block(x, bp, b, cfg, None, rwkv_mod.CHUNK,
                            rwkv_mod.IMPL)
        return x, 0.0, st
    h = _norm(x, bp, "pre_norm", cfg, dp, eid)
    heads = tp if tp is not None and tp.heads_cut(bp["attn"], b.attn) \
        else None
    if heads is not None:
        h = heads.enter(h)
    q, k, v = qkv_project(h, bp["attn"], b.attn, positions, cfg.rms_eps,
                          dp=dp.get("attn"), eid=eid)
    if heads is not None:
        k, v = heads.local_kv(k, v, q.shape[2], b.attn)
    o = flash_attention(q, k, v, b.attn, causal=b.attn.causal,
                        kv_start=kv_start)
    x = _attn_residual(x, o, bp, b, cfg, dp, eid, tp=heads)
    if enc_out is not None and "cross" in bp:
        x = _cross_attend(x, bp, b, cfg, *_cross_kv(enc_out, bp["cross"]))
    x, aux = _apply_ffn(x, bp, b, cfg, dp, eid, tp=tp)
    return x, aux, (k, v)


def _decode_block(x, bp, b, cfg, st, cur, dp, eid, start, paged=None,
                  cross=None, decode_attn=None):
    """One-token step through one block, its state written in place.

    ``st`` holds the block's decode state for this unit (views of the
    cache): a KV ring (or pools), mamba's h and conv ring, or rwkv's S and
    token shifts.  ``paged`` (``(tables, lens, active)``) switches to the
    block-table pools: rope positions are per row (``lens``), the write
    lands in each row's current block (the trash block for inactive rows)
    and attention gathers each row's blocks.  Without it the dense ring at
    the shared position ``cur`` is used, written and attended by
    ``decode_attn`` when given (the sequence-parallel attention of
    :func:`repro_torch.distributed.collectives.make_sp_decode_attn`).
    ``cross`` is this unit's cross (k, v) of an enc-dec decoder."""
    if b.kind in _STATE_NAMES:
        names = _STATE_NAMES[b.kind]
        old = tuple(st[n] for n in names)
        if b.kind == "mamba":
            x, _, new = _mamba_block(x, bp, b, cfg, old, 1)
        else:
            # a single-token step: the exact form (the matmul form gains
            # nothing at chunk 1), as in the reference
            x, new = _rwkv_block(x, bp, b, cfg, old, 1, "einsum")
        for n, t in zip(names, new):
            st[n].copy_(t)
        return x
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
    elif decode_attn is not None:
        o = decode_attn(q, k, v, st, cur, b.attn, start)
    else:
        cache_write(st["k"], st["v"], st["pos"], k, v, cur)
        o = decode_attention(q, st["k"], st["v"], st["pos"], cur, b.attn,
                             start=start).to(q.dtype)
    x = _attn_residual(x, o, bp, b, cfg, dp, eid)
    if cross is not None:
        x = _cross_attend(x, bp, b, cfg, *cross)
    return _apply_ffn(x, bp, b, cfg, dp, eid)[0]


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg, delta=None, eid=None, comm=None,
                 mm_embeds=None, run=None):
    """Token embeddings [B, T, d]; a vision frontend's ``mm_embeds`` [B, n,
    e] are projected by ``frontend_proj`` and prepended ([B, n + T, d]).
    ``run`` (a training mesh's) looks the tokens up in a vocab-cut
    table."""
    tokens = tokens.to(torch.int64)
    table = params["embed"]
    if run is not None:
        x = run.embed(table, tokens)
    elif comm is not None and table.shape[0] != cfg.vocab:
        x = comm.vocab_embed(table, tokens)
    else:
        x = table[tokens]
    if delta is not None:
        x = add_delta(x, embed_delta_rows(delta.get("embed"), tokens, eid,
                                          cfg.d_model))
    if cfg.embed_scale:
        x = (x.to(torch.float32) * np.sqrt(cfg.d_model)).to(x.dtype)
    if cfg.frontend is not None and mm_embeds is not None:
        mm = _proj(mm_embeds.to(x.dtype), params["frontend_proj"])
        x = torch.cat([mm, x], dim=1)
    return x


def logits_of(params, x, cfg, delta=None, eid=None, comm=None, run=None):
    """Logits of the final hidden ``x``; a vocab-sharded head gives this
    rank's vocab slice (its expert delta is computed whole and cut)."""
    delta = delta or {}
    x = rms_norm(x, eff_param(params["final_norm"], delta.get("final_norm"),
                              eid), cfg.rms_eps, _gemma(cfg))
    if run is not None:
        x = run.head_input(x)
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
# Training forward and the encoder
# ---------------------------------------------------------------------------


def _units_of(blocks: dict, n_units: int) -> list[dict]:
    """The stacked block tree cut into one tree per unit.  ``unbind``
    gives views whose backward stacks the units' gradients into one
    tensor per leaf (indexing each unit would add a full-size zero
    gradient per unit)."""
    parts = {p: l.unbind(0) for p, l in tree_util.flatten_with_paths(blocks)}
    return [tree_util.unflatten_paths({p: v[u] for p, v in parts.items()})
            for u in range(n_units)]


def _train_unit(x, unit_params, cfg, pattern, positions, enc_out, run=None,
                stack="blocks"):
    """One unit's blocks -> (x, the unit's aux: 0.0 without an MoE).
    ``run`` (a training mesh's) first gathers the unit's leaves from this
    rank's blocks, and brings its tensor-parallel hooks."""
    tp = None
    if run is not None:
        unit_params = run.unit(stack, unit_params)
        tp = run.tp
    aux = 0.0
    for i, b in enumerate(pattern):
        x, a, _ = _apply_block(x, unit_params[f"block{i}"], b, cfg,
                               positions, {}, None, None, enc_out=enc_out,
                               tp=tp)
        aux = aux + a
    return x, aux


def _run_units(x, blocks, cfg, pattern, n_units: int, remat_policy: str,
               enc_out=None, run=None, stack="blocks"):
    """Every unit of a stack over the whole sequence -> (x, aux f32).
    Under a training mesh's ``run`` that gathers leaves every unit is
    recomputed in the backward pass, so the leaves it gathered are
    dropped after its forward (FSDP)."""
    if remat_policy not in ("none", "unit"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_params in _units_of(blocks, n_units):
        if remat_policy == "unit" or (run is not None and run.gathers):
            from torch.utils.checkpoint import checkpoint
            x, a = checkpoint(_train_unit, x, unit_params, cfg, pattern,
                              positions, enc_out, run, stack,
                              use_reentrant=False)
        else:
            x, a = _train_unit(x, unit_params, cfg, pattern, positions,
                               enc_out, run, stack)
        if torch.is_tensor(a):        # a dense unit's 0.0 adds nothing
            aux = aux + a
    return x, aux


def forward_train(params, tokens, cfg, remat_policy: str = "none",
                  mm_embeds=None, enc_out=None, run=None):
    """tokens [B, T] -> (logits [B, T(+mm), V], aux_loss): the whole
    sequence through every unit, differentiable by autograd (the
    reference's ``forward_train`` over ``_apply_block_train``).  ``aux``
    (f32) sums the MoE blocks' load-balancing losses over blocks and
    units, in the reference's order; it is 0 for a dense config.
    ``mm_embeds`` (a vision frontend's) are prepended; ``enc_out`` (an
    enc-dec model's :func:`encode` output) is attended by every decoder
    block.

    ``remat_policy="unit"`` recomputes each unit's activations in the
    backward pass (``torch.utils.checkpoint``), the counterpart of the
    reference's ``jax.checkpoint`` of its unit scan body; ``"none"``
    keeps them.  Either way the chunked mamba and rwkv scans checkpoint
    each chunk step, as the reference does.

    ``run`` (:class:`repro_torch.train.within_pod.PodRun`) runs the
    forward on this rank's blocks of a training mesh: ``params`` holds
    the top-level leaves as the run gathered them and the stacked block
    leaves as the rank's blocks, gathered unit by unit."""
    x = embed_tokens(params, tokens, cfg, mm_embeds=mm_embeds, run=run)
    x, aux = _run_units(x, params["blocks"], cfg, cfg.pattern, cfg.n_units,
                        remat_policy, enc_out=enc_out, run=run)
    return logits_of(params, x, cfg, run=run), aux


def encode(params, frames, cfg, remat_policy: str = "none", run=None):
    """The encoder of an enc-dec model: stub frames [B, S_src, e] (the
    modality frontend's precomputed embeddings) projected by
    ``frontend_proj``, then every encoder unit (non-causal attention),
    then ``enc_final_norm`` -> [B, S_src, d]."""
    x = _proj(frames.to(dtype_of(cfg)), params["frontend_proj"])
    x, _ = _run_units(x, params["enc_blocks"], cfg, cfg.enc_pattern,
                      cfg.enc_n_units, remat_policy, run=run,
                      stack="enc_blocks")
    return rms_norm(x, params["enc_final_norm"], cfg.rms_eps)


def cross_cache_from_encoder(params, enc_out, cfg) -> dict:
    """Every unit's cross-attention K/V of ``enc_out``: {"k", "v"} [U, B,
    S_src, Hkv, D] in ``enc_out``'s dtype."""
    stacked = params["blocks"]["block0"]["cross"]
    k = torch.einsum("bsd,udhk->ubshk", enc_out, stacked["wk"])
    v = torch.einsum("bsd,udhk->ubshk", enc_out, stacked["wv"])
    return {"k": k.to(enc_out.dtype), "v": v.to(enc_out.dtype)}


# ---------------------------------------------------------------------------
# Decode (serving) path
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, cache_len: int, dtype=None,
                      device="cuda") -> dict:
    """Empty decode state of every block: an attention block's dense ring
    k/v [U, B, S, Hkv, D] and the absolute position of each slot, pos
    [U, S] (-1 empty); a mamba block's h [U, B, Din, S] f32 and conv ring
    [U, B, d_conv - 1, Din]; an rwkv block's S [U, B, H, dh, dh] f32 and
    token shifts tm, cm [U, B, 1, d]; an enc-dec model's cross-KV
    ``cache["cross"]`` [U, B, S_src, Hkv, D] (S_src the frontend's
    ``n_tokens``).  ``cur``, the position of the next token, is a 0-d
    int32 tensor on ``device``."""
    dtype = dtype or dtype_of(cfg)
    U = cfg.n_units
    layers = {}
    for i, b in enumerate(cfg.pattern):
        if b.kind == "attn":
            a = b.attn
            S = min(cache_len, a.window) if a.window else cache_len
            layers[f"block{i}"] = {
                "k": torch.zeros((U, batch, S, a.n_kv, a.head_dim),
                                 dtype=dtype, device=device),
                "v": torch.zeros((U, batch, S, a.n_kv, a.head_dim),
                                 dtype=dtype, device=device),
                "pos": torch.full((U, S), -1, dtype=torch.int32,
                                  device=device)}
        else:
            layers[f"block{i}"] = _init_unit_states(cfg, b, batch, dtype,
                                                    device)
    cache = {"layers": layers,
             "cur": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.cross_attn:
        a = cfg.pattern[0].attn
        S_src = cfg.frontend.n_tokens if cfg.frontend else cache_len
        cache["cross"] = {
            k: torch.zeros((U, batch, S_src, a.n_kv, a.head_dim),
                           dtype=dtype, device=device) for k in ("k", "v")}
    return cache


def _init_unit_states(cfg, b, batch: int, dtype, device) -> dict:
    """A recurrent block's zero decode state with the unit axis in front:
    mamba's h and conv ring, or rwkv's S and token shifts tm, cm."""
    if b.kind == "mamba":
        st = mamba_mod.init_mamba_state(batch, cfg.d_model, b.mamba, dtype,
                                        device)
    else:
        st = rwkv_mod.init_rwkv_state(batch, cfg.d_model, b.rwkv, dtype,
                                      device)
    return {n: t.expand((cfg.n_units,) + t.shape).contiguous()
            for n, t in zip(_STATE_NAMES[b.kind], st)}


def decode_step(params, token, cache, cfg, delta=None, eid=None,
                comm=None, decode_attn=None):
    """token [B, 1] -> (logits [B, 1, V], cache).

    Dense ring: ``cache["cur"]`` is the position of this token, a 0-d
    int32 tensor on the device (as under the reference's ``jit``), and
    advances by one in place.  Paged (``"tables" in cache``): each row's
    position is ``cache["lens"]``, which advances in place by
    ``cache["active"]``, so finished rows freeze.  The step reads no host
    value, so a CUDA graph can replay it; the cache tensors (recurrent
    states included) are written in place, and the cross-KV is read.
    With ``comm`` on a "model" axis the cache holds this rank's rows
    only, and the logits are this rank's vocab slice.  ``decode_attn``
    (the reference's ``Runtime.decode_attn``) takes each attention
    block's dense-ring write and attention: ``decode_attn(q, k, v, st,
    cur, attn_cfg, start) -> o [B, 1, Hq, D]`` in q's dtype, ``st`` the
    unit's {"k", "v", "pos"} views, written in place.
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
    cross = cache.get("cross")
    dblocks = delta.get("blocks") if delta is not None else None
    for u in range(cfg.n_units):
        unit_params = _unit(params["blocks"], u)
        unit_delta = slice_unit(dblocks, u) if dblocks is not None else {}
        for i, b in enumerate(cfg.pattern):
            name = f"block{i}"
            st = {k: t[u] for k, t in cache["layers"][name].items()}
            ck = ((cross["k"][u], cross["v"][u])
                  if cross is not None and b.kind == "attn" else None)
            x = _decode_block(x, unit_params[name], b, cfg, st, cur,
                              unit_delta.get(name) or {}, eid, start,
                              paged=pg, cross=ck, decode_attn=decode_attn)
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
            shard_rows: bool = False, mm_embeds=None, enc_out=None):
    """Run the whole prompt; returns (last-token logits [B, 1, V], cache).

    ``start`` ([B] int32, optional) marks each row's first real token:
    left-pad positions before it are masked out of attention, and the mask
    is kept in ``cache["start"]`` for the decode steps (meaningful for
    pure-attention decoder-only patterns: recurrent blocks take pads into
    their state).  ``mm_embeds`` (a vision frontend's [B, n, e]) are
    prepended, so the cache holds n + T positions; ``enc_out`` (an enc-dec
    model's :func:`encode` output) is attended by every decoder block and
    fills ``cache["cross"]``.  ``cache`` (from :func:`init_decode_cache`
    at this batch and ``cache_len``, optional) is filled in place, every
    tensor of it rewritten, so a caller that keeps its cache at fixed
    addresses (the engine, for its CUDA graphs) gets it back there;
    without it a fresh cache is made.  ``comm`` (a serving mesh) makes the
    embedding and head vocab-parallel; with ``shard_rows`` each rank runs
    only its rows and ``cache`` holds those, else every rank runs every
    row.
    """
    x = embed_tokens(params, tokens, cfg, delta=delta, eid=eid, comm=comm,
                     mm_embeds=mm_embeds)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :]
    lay = (comm.rows_for(B, x.device)
           if comm is not None and shard_rows else None)
    eid_all = eid
    if lay is not None:
        x = lay.local(x)
        eid = lay.local(eid) if eid is not None else None
        start = lay.local(start, fill=0) if start is not None else None
        enc_out = lay.local(enc_out) if enc_out is not None else None
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
            x, _, st = _apply_block(x, unit_params[name], b, cfg, positions,
                                    unit_delta.get(name) or {}, eid, start,
                                    enc_out=enc_out)
            layer = cache["layers"][name]
            if b.kind == "attn":
                S = layer["k"].shape[2]
                layer["k"][u], layer["pos"][u] = _ring_fill(st[0], S)
                layer["v"][u] = _ring_fill(st[1], S)[0]
            else:
                for n, t in zip(_STATE_NAMES[b.kind], st):
                    layer[n][u] = t
    if enc_out is not None:
        for k, t in cross_cache_from_encoder(params, enc_out, cfg).items():
            cache["cross"][k].copy_(t)
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
