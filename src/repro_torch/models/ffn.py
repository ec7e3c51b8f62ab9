"""Feed-forward blocks (PyTorch port of ``repro/models/ffn.py``): the gated
MLP, with the zero-merge overlay's per-row ternary deltas, and the
capacity-based top-k MoE (GShard), which the overlay does not cover (MoE
configs are served by merge-on-swap)."""

from __future__ import annotations

import numpy as np
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
    dp = dp or {}
    g_lin = add_delta(_proj(x, p["wg"]), delta_proj(x, dp.get("wg"), eid))
    if cfg.activation in ("swiglu", "geglu"):
        u = add_delta(_proj(x, p["wu"]), delta_proj(x, dp.get("wu"), eid))
        h = _act(g_lin, cfg.activation) * u
    else:
        h = _act(g_lin, cfg.activation)
    return add_delta(_proj(h, p["wo"]), delta_proj(h, dp.get("wo"), eid))


def _expert_ffn(h_in: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Batched expert MLP.  h_in [G, E, C, D] -> [G, E, C, D]."""
    g = _act(torch.einsum("gecd,edf->gecf", h_in, p["wg_e"]), cfg.activation)
    u = torch.einsum("gecd,edf->gecf", h_in, p["wu_e"])
    return torch.einsum("gecf,efd->gecd", g * u, p["wo_e"])


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[..., n] one-hot of ``idx``; an index outside [0, n) gives a zero
    row.  A comparison, so no host read (``F.one_hot`` checks its range on
    the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k_first(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values in
    descending order, ties taken by the lower index first.  ``k`` passes
    of ``argmax`` (which returns the first maximum), each masking the
    index it took; ``torch.topk`` promises no order among ties."""
    vals, idx, p = [], [], probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        p = p.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def moe_route(x: torch.Tensor, router: torch.Tensor, mo):
    """Routing of the grouped top-k MoE.  x [G, S, D] -> (probs [G, S, E]
    f32, gate values [G, S, K] renormalised, gate indices [G, S, K] int64,
    one-hot [G, S, K, E] int32, each (token, k)'s position in its
    expert's queue [G, S, K] int32, the capacity C).  Every shape follows
    from x's, so a CUDA graph can replay it."""
    G, S, _ = x.shape
    E, K = mo.n_experts, mo.top_k
    C = max(1, int(np.ceil(K * S / E * mo.capacity_factor)))
    logits = (x.reshape(G * S, -1).to(torch.float32) @ router).reshape(
        G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_first(probs, K)                # [G, S, K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    # queue position of each (token, k) within its group's expert queue
    onehot = _one_hot(gate_idx, E, torch.int32)                # [G, S, K, E]
    flat = onehot.reshape(G, S * K, E)
    rank = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(
        G, S, K, E)
    pos_in_expert = (rank * onehot).sum(dim=-1, dtype=torch.int32)
    return probs, gate_vals, gate_idx, onehot, pos_in_expert, C


def moe_ffn(x: torch.Tensor, p: dict, cfg, run=None):
    """Grouped capacity-based top-k MoE (GShard).  x [B, T, D] ->
    (out [B, T, D], aux f32).

    Tokens are grouped in fixed-size groups (S = 4096 or 2048 when T is a
    multiple, else S = T: one group per sequence) and dispatched within
    their group with per-group capacity C = ceil(K * S / E * cap); tokens
    beyond capacity fall back to the residual stream.  The dispatch is
    the reference's dense one-hot tensor [G, S, E, C], so nothing depends
    on the data's shape and no row sees another group.  aux is the Switch
    load-balancing loss E * sum_e f_e * p_e, f_e and p_e means over the
    microbatch's tokens.

    ``run`` (a training mesh's, :class:`repro_torch.train.within_pod.
    PodRun`) holds this rank's rows of the microbatch: f_e counts every
    data rank's tokens (``run.data_total``; the one-hot carries no
    gradient) and p_e sums this rank's probabilities over them, so the
    data ranks' aux terms and their gradients add up to the logical
    ones; a serving rank's ``run`` (``run.serving``) takes no aux (0.0).
    The router, its softmax and top-k and the aux run on every
    model rank alike; under tensor parallelism (``run.tp``) the experts
    are this rank's part, entered with the gate values (their gradients
    are partial) and summed over "model" with the shared expert's d_ff
    slice: a d_ff slice of every expert (experts cut on d_ff), or this
    rank's contiguous block of whole experts (cut on E), dispatched with
    the slots of the routing over every expert.  A leaf holding fewer
    experts than the config outside tensor parallelism raises."""
    mo = cfg.moe
    B, T, D = x.shape
    S = 4096 if T % 4096 == 0 else (2048 if T % 2048 == 0 else T)
    G = (B * T) // S
    x = x.reshape(G, S, D)
    E = mo.n_experts
    probs, gate_vals, _, onehot, pos_in_expert, C = moe_route(
        x, p["router"], mo)
    if run is not None and run.serving:
        aux = 0.0        # a served forward reads no loss: no data sums
    else:
        # load-balancing aux loss (Switch): E * sum_e f_e * p_e
        counts = torch.cat([onehot[:, :, 0, :].to(torch.float32).sum(
            dim=(0, 1)), probs.new_full((1,), G * S)])
        if run is not None:
            counts = run.data_total(counts)
        frac_tokens = counts[:E] / counts[E]
        frac_probs = probs.sum(dim=(0, 1)) / counts[E]
        aux = E * torch.sum(frac_tokens * frac_probs)
    tp = run.tp if run is not None else None
    n_local = p["wg_e"].shape[0]
    if n_local != E and tp is None:
        raise ValueError(f"an MoE leaf holds {n_local} of the config's {E} "
                         "experts: experts cut on E run only as a "
                         "tensor-parallel rank's block")
    lo = tp.rank * n_local if n_local != E else 0
    onehot = onehot[..., lo:lo + n_local]
    if tp is not None:
        x = tp.enter(x)
        gate_vals = tp.enter(gate_vals)
    # a (token, k) beyond its expert's capacity gets no slot: dropped
    slot_oh = _one_hot(torch.where(pos_in_expert < C, pos_in_expert, C), C,
                       torch.float32)                          # [G, S, K, C]
    disp = torch.einsum("gske,gskc->gsec", onehot.to(x.dtype),
                        slot_oh.to(x.dtype))                   # [G, S, E, C]
    comb = torch.einsum("gske,gskc->gsec",
                        onehot.to(torch.float32) * gate_vals[..., None],
                        slot_oh)
    h_in = torch.einsum("gsd,gsec->gecd", x, disp)             # [G, E, C, D]
    h_out = _expert_ffn(h_in, p, cfg)                          # [G, E, C, D]
    out = torch.einsum("gecd,gsec->gsd", h_out.to(torch.float32),
                       comb).to(x.dtype)
    if mo.shared_expert_dff:
        out = out + dense_ffn(x, {"wg": p["wg_s"], "wu": p["wu_s"],
                                  "wo": p["wo_s"]}, cfg)
    if tp is not None:
        out = tp.reduce(out)
    return out.reshape(B, T, D), aux


def ffn_apply(x: torch.Tensor, p: dict, cfg, dp=None, eid=None, run=None):
    """The block's FFN -> (out, aux): the MoE for an MoE config (which no
    overlay covers), else the gated MLP with aux 0.0, a Python float (the
    reference's zero scalar, without a device op on the serving path).
    ``run`` (a training mesh's) brings the MoE's sums over the data ranks
    and, under tensor parallelism, runs this rank's d_ff slice of the
    gated MLP between Megatron's f and g (``run.tp``)."""
    if cfg.moe is not None:
        if dp:
            raise ValueError("the zero-merge overlay does not cover MoE "
                             "FFNs; they are served by merge-on-swap")
        return moe_ffn(x, p, cfg, run=run)
    tp = run.tp if run is not None else None
    if tp is None:
        return dense_ffn(x, p, cfg, dp=dp, eid=eid), 0.0
    return tp.reduce(dense_ffn(tp.enter(x), p, cfg, dp=dp, eid=eid)), 0.0
