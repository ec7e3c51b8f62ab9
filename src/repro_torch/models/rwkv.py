"""RWKV-6 "Finch" block in PyTorch: data-dependent per-channel decay,
matrix-valued per-head state.

Port of ``repro/models/rwkv.py``: the chunked-parallel form for training
and prefill (GLA-style), and the exact recurrence (chunk 1) for decode.
Recurrence per head (state S in R^{dk x dv}):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Chunked form over chunks of length L with ci = inclusive cumsum(log w),
ce = exclusive cumsum:

    inter:  y_t += (r_t * exp(ce_t)) @ S_in
    intra:  y_t += sum_{s<t} [sum_d r_t[d] k_s[d] exp(ce_t[d]-ci_s[d])] v_s
    diag :  y_t += (r_t * u * k_t) 1 . v_t
    state:  S_out = diag(exp(ci_L)) S_in + sum_s (k_s * exp(ci_L - ci_s))^T v_s

Exponents of kept terms are <= 0 and masked terms are clamped before the
exp, so the chunked form cannot overflow.  The chunks run as a Python
loop, the counterpart of the reference's ``lax.scan``; under autograd each
chunk step is checkpointed, as the reference's ``jax.checkpoint`` of its
scan body, so the backward pass keeps only the chunk-boundary states.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MIX_CHANNELS = ("w", "k", "v", "r", "g")
# the reference's ``Runtime.rwkv_chunk`` and ``Runtime.rwkv_impl``
CHUNK = 128
IMPL = "matmul"


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N], in the promoted dtype of the two (as jnp's
    einsum promotes bf16 with f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (the previous token's input).  last [B, 1, D]."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x: torch.Tensor, x_prev: torch.Tensor, p: dict) -> dict:
    """Data-dependent token-shift interpolation: one mixed input per
    channel of :data:`MIX_CHANNELS`."""
    dx = x_prev - x
    xxx = x + dx * p["mu_x"]
    hidden = torch.tanh(_mm(xxx, p["mix_w1"]))          # [B, T, R]
    return {c: x + dx * (p[f"mu_{c}"] + _mm(hidden, p["mix_w2"][i]))
            for i, c in enumerate(MIX_CHANNELS)}


def _decay(x_w: torch.Tensor, p: dict) -> torch.Tensor:
    """log w_t in (-inf, 0): w = exp(-exp(w0 + tanh(x_w @ d1) @ d2)), f32."""
    lw = p["w0"] + _mm(torch.tanh(_mm(x_w, p["decay_w1"])), p["decay_w2"])
    return -torch.exp(lw.to(torch.float32))


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm on [B, T, H, dh], in f32."""
    y32 = y.to(torch.float32)
    mean = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, unbiased=False, keepdim=True)
    return (y32 - mean) * torch.rsqrt(var + eps) * scale + bias


def _chunk_step(S, rcc, kcc, vcc, cii, cee, u, impl: str):
    """One chunk: (S_in, r/k/v/ci/ce [B, L, H, dh]) -> (S_out, y)."""
    L = rcc.shape[1]
    y_inter = torch.einsum("blhd,bhde->blhe", rcc * torch.exp(cee), S)
    if impl == "matmul":
        # A[t, s] = sum_d r_t k_s exp(ce_t - ci_s), factorised into one
        # matmul per head (no [L, L, dh] tensor); exp(-ci) clipped at e^60
        r_fac = rcc * torch.exp(cee)
        k_fac = kcc * torch.exp(torch.clamp_max(-cii, 60.0))
        A = torch.einsum("blhd,bmhd->blmh", r_fac, k_fac)
    else:
        # the exact form: the clamped elementwise decay tensor
        diff = cee[:, :, None] - cii[:, None, :]         # [B, L, L, H, dh]
        A = torch.einsum("blhd,bmhd,blmhd->blmh", rcc, kcc,
                         torch.exp(torch.clamp_max(diff, 0.0)))
    mask = torch.ones((L, L), dtype=torch.bool, device=A.device).tril(-1)
    A = torch.where(mask[None, :, :, None], A, 0.0)
    y_intra = torch.einsum("blmh,bmhe->blhe", A, vcc)
    y_diag = (rcc * u * kcc).sum(-1, keepdim=True) * vcc
    decay_all = torch.exp(cii[:, -1:] - cii)             # [B, L, H, dh]
    S_new = torch.exp(cii[:, -1])[..., None] * S + torch.einsum(
        "blhd,blhe->bhde", kcc * decay_all, vcc)
    return S_new, y_inter + y_intra + y_diag


def rwkv_time_mix(x: torch.Tensor, p: dict, cfg, state=None,
                  chunk: int = CHUNK, impl: str = IMPL):
    """x [B, T, D] -> (out [B, T, D], (S [B, H, dh, dh] f32, last_x
    [B, 1, D])).  ``state`` = (S, last_x) carried from earlier tokens.

    ``impl="matmul"`` (the default) factorises the intra-chunk product
    into a matmul per head; ``impl="einsum"`` builds the exact decay tensor
    [B, L, L, H, dh]."""
    B, T, D = x.shape
    dh = cfg.head_dim
    H = D // dh
    last_x = state[1] if state is not None else None
    S = (state[0] if state is not None else
         torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device))
    mixed = _ddlerp(x, _shift(x, last_x), p)
    r = _mm(mixed["r"], p["Wr"])
    k = _mm(mixed["k"], p["Wk"])
    v = _mm(mixed["v"], p["Wv"])
    g = _mm(mixed["g"], p["Wg"])
    logw = _decay(mixed["w"], p)                        # [B, T, D] (<= 0)

    f32 = torch.float32
    rh, kh, vh = (a.reshape(B, T, H, dh).to(f32) for a in (r, k, v))
    wh = logw.reshape(B, T, H, dh)
    u = p["u"].reshape(H, dh).to(f32)
    pad = (-T) % chunk
    if pad:
        rh, kh, vh, wh = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (rh, kh, vh, wh))
    n = (T + pad) // chunk
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        wc = wh[:, sl]
        ci = torch.cumsum(wc, dim=1)                    # inclusive
        ce = ci - wc                                    # exclusive
        args = (S, rh[:, sl], kh[:, sl], vh[:, sl], ci, ce, u, impl)
        if torch.is_grad_enabled() and n > 1:
            S, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            S, y = _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    y = _group_norm(y, p["ln_x_scale"].reshape(H, dh),
                    p["ln_x_bias"].reshape(H, dh))
    y = y.reshape(B, T, D) * F.silu(g.to(f32))
    out = _mm(y.to(x.dtype), p["Wo"])
    return out, (S, x[:, -1:])


def rwkv_channel_mix(x: torch.Tensor, p: dict,
                     state: Optional[torch.Tensor] = None, tp=None):
    """The RWKV FFN (relu^2 channel mix) -> (out, last_x [B, 1, D]).
    ``tp`` (a training mesh's tensor-parallel hooks) runs this rank's
    d_ff slice of the key path (``cm_Wk``'s columns, ``cm_Wv``'s rows)
    between Megatron's f, on the key path's input alone, and g, before
    the receptance gate; the receptance path runs whole on every rank."""
    dx = _shift(x, state) - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    if tp is not None:
        xk = tp.enter(xk)
    kk = torch.square(torch.relu(_mm(xk, p["cm_Wk"]).to(torch.float32)))
    rr = torch.sigmoid(_mm(xr, p["cm_Wr"]).to(torch.float32))
    vv = _mm(kk.to(x.dtype), p["cm_Wv"])
    if tp is not None:
        vv = tp.reduce(vv)
    return (rr * vv.to(torch.float32)).to(x.dtype), x[:, -1:]


def init_rwkv_state(batch: int, d_model: int, cfg, dtype=torch.bfloat16,
                    device="cuda"):
    """(S [B, H, dh, dh] f32, time-mix shift, channel-mix shift [B, 1, D])."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    dh = cfg.head_dim
    H = d_model // dh
    return (torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=dev),
            torch.zeros((batch, 1, d_model), dtype=dtype, device=dev),
            torch.zeros((batch, 1, d_model), dtype=dtype, device=dev))
