"""Plain float32 reference of the two configurations' language models.

Decoder-only, pre-norm: RMSNorm (eps from the configuration), GQA
attention with rotary embeddings (half-split rotation, theta from the
configuration), optional QKV bias and sliding window, then a SwiGLU MLP
(qwen2.5) or a top-2 mixture of SwiGLU experts (mixtral: softmax over the
router's logits, the two largest renormalised), a final RMSNorm and the
head (the embedding's transpose when tied).  One sequence at a time, no
cache, no batching, no kernels: every position attends to every earlier
one.  ``capacity_factor`` adds GShard's capacity (the program's stated
MoE: within a group of T tokens, a (token, k) pair beyond ``ceil(k * T /
E * c)`` in its expert's queue, in token order, is dropped); None is the
published Mixtral, which drops nothing.  As the program serves a request,
its prompt is one group, led by the ``pad`` left-pad tokens of its
batch (``pad_token_id``), which attend to nothing (their attention output
is zero) but route and take capacity; each token after the prompt is a
group of its own.

``W`` maps the program's parameter paths to float32 tensors (the unit
axis in front for block leaves).  Matrix products run with TF32 off.
Nothing of the program is imported.
"""

from __future__ import annotations

import contextlib
import math

import torch

B = "blocks/block0"


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the block (a float32 product may otherwise run in
    TF32 on the card)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, s, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * s


def rope(x, pos, theta):
    """x [T, H, D] rotated by position: halves (x1, x2) -> (x1 cos - x2
    sin, x2 cos + x1 sin)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = (pos.to(torch.float64)[:, None] * inv).to(torch.float32)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, W, u, cfg, pos, pad=0):
    T = h.shape[0]
    nq, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = (h @ W[f"{B}/attn/wq"][u].reshape(h.shape[1], -1)).reshape(T, nq, hd)
    k = (h @ W[f"{B}/attn/wk"][u].reshape(h.shape[1], -1)).reshape(T, nkv, hd)
    v = (h @ W[f"{B}/attn/wv"][u].reshape(h.shape[1], -1)).reshape(T, nkv, hd)
    if cfg.get("qkv_bias"):
        q = q + W[f"{B}/attn/bq"][u]
        k = k + W[f"{B}/attn/bk"][u]
        v = v + W[f"{B}/attn/bv"][u]
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    rep = nq // nkv
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    qi, ki = pos[:, None], pos[None, :]
    allowed = (ki <= qi) & (ki >= pad) & (qi >= pad)
    win = cfg.get("sliding_window") if cfg.get("use_sliding_window",
                                                 True) else None
    if win:
        allowed &= ki > qi - win
    s = s.masked_fill(~allowed[None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)    # a pad attends nothing
    o = torch.einsum("hqk,khd->qhd", p, v)
    return o.reshape(T, nq * hd) @ W[f"{B}/attn/wo"][u].reshape(nq * hd, -1)


def swiglu(h, wg, wu, wo):
    return (torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wo


def moe(h, W, u, cfg, capacity_factor=None, groups=None):
    """groups: [(start, end)] token spans dispatched apart (one span over
    every token by default)."""
    if groups is not None:
        return torch.cat([moe(h[a:b], W, u, cfg, capacity_factor)
                          for a, b in groups])
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ W[f"{B}/ffn/router"][u], dim=-1)
    gv, gi = torch.topk(probs, K, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    T = h.shape[0]
    keep = torch.ones_like(gv, dtype=torch.bool)
    if capacity_factor is not None:
        C = max(1, math.ceil(K * T / E * capacity_factor))
        onehot = torch.nn.functional.one_hot(gi, E).reshape(T * K, E)
        rank = (torch.cumsum(onehot, 0) - onehot).reshape(T, K, E)
        keep = (rank * onehot.reshape(T, K, E)).sum(-1) < C
    out = torch.zeros_like(h)
    for e in range(E):
        for kk in range(K):
            rows = torch.nonzero((gi[:, kk] == e) & keep[:, kk])[:, 0]
            if rows.numel():
                y = swiglu(h[rows], W[f"{B}/ffn/wg_e"][u, e],
                           W[f"{B}/ffn/wu_e"][u, e], W[f"{B}/ffn/wo_e"][u, e])
                out.index_add_(0, rows, gv[rows, kk, None] * y)
    return out


def forward(cfg: dict, W: dict, tokens: torch.Tensor, capacity_factor=None,
            pad: int = 0, prompt_len=None) -> torch.Tensor:
    """Logits [T, V] (float32) of one sequence of token ids [T], after
    ``pad`` left pads; with ``prompt_len`` the pads and the first
    ``prompt_len`` tokens are one MoE group and each later token one."""
    eps = cfg["rms_norm_eps"]
    tokens = tokens.to(torch.int64)
    if pad:
        tokens = torch.cat([torch.full((pad,), cfg["pad_token_id"],
                                       dtype=torch.int64,
                                       device=tokens.device), tokens])
    T = tokens.numel()
    groups = None
    if prompt_len is not None:
        groups = [(0, pad + prompt_len)] + [(i, i + 1) for i in
                                            range(pad + prompt_len, T)]
    pos = torch.arange(T, device=tokens.device)
    x = W["embed"][tokens]
    with exact_f32():
        for u in range(cfg["num_hidden_layers"]):
            h = rms_norm(x, W[f"{B}/pre_norm"][u], eps)
            x = x + attention(h, W, u, cfg, pos, pad)
            h = rms_norm(x, W[f"{B}/ffn_norm"][u], eps)
            if cfg.get("num_local_experts"):
                x = x + moe(h, W, u, cfg, capacity_factor, groups)
            else:
                x = x + swiglu(h, W[f"{B}/ffn/wg"][u], W[f"{B}/ffn/wu"][u],
                               W[f"{B}/ffn/wo"][u])
        x = rms_norm(x, W["final_norm"], eps)
        head = W["embed"].t() if cfg["tie_word_embeddings"] else W["lm_head"]
        return (x @ head)[pad:]
