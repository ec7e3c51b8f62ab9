"""Mamba (S6) block of the Jamba hybrid in PyTorch: a chunked selective
scan for training and prefill, an O(1)-state step for decode.

Port of ``repro/models/mamba.py``.  Layout: state h [B, d_inner,
d_state] f32; conv ring [B, d_conv - 1, d_inner].  The time scan runs
over chunks (a Python loop for the reference's ``lax.scan``); inside a
chunk a log-depth (Hillis-Steele) scan takes the place of the reference's
``lax.associative_scan``.  The two combine the same terms in other
orders, so the port matches the reference to f32 rounding, not bitwise.
The discretised tensors dA and dBx ([B, T, d_inner, d_state]) are never
made for the whole sequence: each chunk makes its own [B, chunk, d_inner,
d_state] slice, and under autograd each chunk step is checkpointed, so the
backward pass keeps only the chunk-boundary states.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# the reference's ``Runtime.mamba_chunk``
CHUNK = 64


def _dt_rank(cfg, d_model: int) -> int:
    return cfg.dt_rank or -(-d_model // 16)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x [B, T, C], w [K, C], prefix [B, K-1, C]
    (the previous tokens' inputs; zeros at the sequence start).  The K
    taps are unrolled and accumulated in f32."""
    K, T = w.shape[0], x.shape[1]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)      # [B, T+K-1, C]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + T].to(torch.float32) * w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _scan_in_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps h -> a h + b, with the
    earlier map applied first: (a1, b1) then (a2, b2) is (a1 a2, a2 b1 +
    b2).  Hillis-Steele: log2(L) rounds over the whole chunk."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_new = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        b_new = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]],
                          dim=1)
        a, b = a_new, b_new
        off *= 2
    return a, b


def _ssm_chunk(h, dt_c, x_c, b_c, c_c, A):
    """One chunk of the selective scan -> (h at the chunk's end, y)."""
    a = torch.exp(dt_c[..., None] * A)                  # [B, L, Din, S]
    bx = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
    aa, bb = _scan_in_chunk(a, bx)
    h_all = aa * h[:, None] + bb
    y = torch.einsum("blds,bls->bld", h_all, c_c)
    return h_all[:, -1], y


def _ssm_scan_chunked(dt: torch.Tensor, A: torch.Tensor, B_ssm: torch.Tensor,
                      C: torch.Tensor, x_act: torch.Tensor, h0: torch.Tensor,
                      chunk: int = CHUNK):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t;  y_t = h_t C_t.

    dt, x_act [B, T, Din]; A [Din, S]; B_ssm, C [B, T, S]; h0 [B, Din, S].
    Returns (y [B, T, Din] f32, h at the end)."""
    T = dt.shape[1]
    pad = (-T) % chunk
    if pad:
        dt, x_act, B_ssm, C = (F.pad(t, (0, 0, 0, pad))
                               for t in (dt, x_act, B_ssm, C))
    n = (T + pad) // chunk
    h, ys = h0, []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (h, dt[:, sl], x_act[:, sl], B_ssm[:, sl], C[:, sl], A)
        if torch.is_grad_enabled() and n > 1:
            h, y = checkpoint(_ssm_chunk, *args, use_reentrant=False)
        else:
            h, y = _ssm_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


def mamba_forward(x: torch.Tensor, p: dict, cfg, state=None,
                  chunk: int = CHUNK, tp=None):
    """Whole-sequence forward.  x [B, T, D]; ``state`` = (h [B, Din, S]
    f32, conv ring [B, K-1, Din]) carried from earlier tokens.  Returns
    (out [B, T, D], (h, conv ring)).

    ``tp`` (a training mesh's tensor-parallel hooks) runs this rank's
    d_inner slice (Din the slice's width, read from ``in_proj``, whose
    columns are x_in's and z's slice of the rank): Megatron's f on the
    input, the partial ``x_proj`` products summed over "model" forward
    and backward (what follows feeds the rank's own slice), and g after
    ``out_proj``."""
    B, T, D = x.shape
    f32 = torch.float32
    Din = p["in_proj"].shape[-1] // 2
    h0 = state[0] if state is not None else None
    conv_buf = state[1] if state is not None else None
    if tp is not None:
        x = tp.enter(x)
    x_in, z = (x @ p["in_proj"]).split(Din, dim=-1)
    x_conv = _conv1d_causal(x_in, p["conv_w"], p["conv_b"], conv_buf)
    x_act = F.silu(x_conv.to(f32))
    proj = x_act.to(x.dtype) @ p["x_proj"]
    if tp is not None:     # g, then f: what follows feeds the rank's slice
        proj = tp.enter(tp.reduce(proj))
    R = _dt_rank(cfg, D)
    dt, B_ssm, C_ssm = proj.split([R, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))                  # [Din, S]
    if h0 is None:
        h0 = torch.zeros((B, Din, cfg.d_state), dtype=f32, device=x.device)
    y, h_fin = _ssm_scan_chunked(dt, A, B_ssm.to(f32), C_ssm.to(f32), x_act,
                                 h0, chunk=chunk)
    y = y + x_act * p["D_skip"].to(f32)
    y = y * F.silu(z.to(f32))
    out = y.to(x.dtype) @ p["out_proj"]
    if tp is not None:
        out = tp.reduce(out)
    K = p["conv_w"].shape[0]
    prev = (conv_buf.to(x.dtype) if conv_buf is not None else
            torch.zeros((B, K - 1, Din), dtype=x.dtype, device=x.device))
    tail = torch.cat([prev, x_in], dim=1)[:, -(K - 1):]
    return out, (h_fin, tail)


def mamba_decode_step(x: torch.Tensor, p: dict, cfg, state):
    """One-token step.  x [B, 1, D]; state (h, conv ring)."""
    return mamba_forward(x, p, cfg, state=state, chunk=1)


def init_mamba_state(batch: int, d_model: int, cfg, dtype=torch.bfloat16,
                     device="cuda"):
    """(h [B, Din, S] f32, conv ring [B, d_conv - 1, Din])."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    Din = cfg.expand * d_model
    return (torch.zeros((batch, Din, cfg.d_state), dtype=torch.float32,
                        device=dev),
            torch.zeros((batch, cfg.d_conv - 1, Din), dtype=dtype,
                        device=dev))
