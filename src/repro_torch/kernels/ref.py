"""Plain PyTorch oracles of the port's kernels (mirrors ``repro/kernels/ref.py``).

They run on any device, repeat the JAX oracles' arithmetic, and serve as
the plain versions the kernel wrappers take for CPU tensors.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.core.packing import (LANE, lane_shifts, lane_weights,
                                      popcount, words_to_int32)


def _unpack(words: torch.Tensor, n_last: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., W*32] int32 in {0, 1}, cut to n_last."""
    bits = (words.unsqueeze(-1) >> lane_shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n_last]


def dense_of_planes(pos: torch.Tensor, neg: torch.Tensor,
                    n: int) -> torch.Tensor:
    """[..., W] planes -> [..., n] f32 ternary matrix (+0.0 where both
    bits are equal)."""
    return (_unpack(pos, n) - _unpack(neg, n)).to(torch.float32)


def ternary_matmul_ref(x, pos, neg, scale):
    """One expert: scale * (x [M, K] @ T [K, N]) with T from planes
    [K, N/32] packed along n; the product in f32, the scale last, as the
    JAX oracle does."""
    w = dense_of_planes(pos, neg, pos.shape[1] * LANE)       # [K, N]
    return (x.to(torch.float32) @ w) * scale.to(torch.float32)


def ternary_matmul_grouped_ref(x, pos, neg, scales, expert_idx,
                               transpose_rhs: bool = False):
    """Per-row-expert delta: y[m] = scales[e(m)] * (x[m] @ T_{e(m)}).

    pos/neg: [E, K, N/32] ([E, N, ceil(K/32)] when ``transpose_rhs``);
    rows with expert_idx == -1 get a zero delta.  Per-expert masked
    matmuls with the scale applied last, as the JAX oracle does.
    """
    E = pos.shape[0]
    x32 = x.to(torch.float32)
    M, K = x32.shape
    N = pos.shape[1] if transpose_rhs else pos.shape[2] * LANE
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    eid = expert_idx.to(torch.int32)[:, None]
    srow = torch.zeros((M, 1), dtype=torch.float32, device=x.device)
    for e in range(E):
        if transpose_rhs:
            w = dense_of_planes(pos[e], neg[e], K).T        # [K, N]
        else:
            w = dense_of_planes(pos[e], neg[e], N)          # [K, N]
        sel = (eid == e).to(torch.float32)
        acc += (x32 * sel) @ w
        srow += torch.where(eid == e, scales[e].to(torch.float32), 0.0)
    return acc * srow


def unpack_add_ref(base, pos, neg, scale):
    """base [M, N] + scale * (pos - neg) in base's dtype: the sum in f32,
    rounded once.  pos/neg [M, ceil(N/32)]; bits at or beyond N are
    ignored."""
    delta = dense_of_planes(pos, neg, base.shape[1])
    return (base.to(torch.float32) + scale * delta).to(base.dtype)


def unpack_add_many_ref(base, pos, neg, scales):
    """Loop of :func:`unpack_add_ref` over pos/neg [E, M, ceil(N/32)] and
    scales [E]: rounded through base's dtype after every expert, the
    bitwise oracle of the fused multi-expert merge."""
    out = base
    for e in range(pos.shape[0]):
        out = unpack_add_ref(out, pos[e], neg[e], scales[e])
    return out


ROW_CHUNK = 4096    # rows packed per step (bounds the int64 temporaries)
CHUNK_ELEMS = 1 << 24   # elements packed per step by the scalar form


def pack_ternary_planes_segmented_ref(tau: torch.Tensor,
                                      thr_rows: torch.Tensor):
    """tau [R, C] (C % 32 == 0), thr_rows [R] -> (pos, neg) int32
    [R, C/32]; rows are packed in chunks to bound the int64 temporaries."""
    R, C = tau.shape
    weights = lane_weights(tau.device)
    pos = torch.empty((R, C // LANE), dtype=torch.int32, device=tau.device)
    neg = torch.empty_like(pos)
    for r0 in range(0, R, ROW_CHUNK):
        t = tau[r0:r0 + ROW_CHUNK].to(torch.float32)
        keep = t.abs() >= thr_rows[r0:r0 + ROW_CHUNK].to(torch.float32)[:, None]
        rows = t.shape[0]
        for out, m in ((pos, keep & (t > 0)), (neg, keep & (t < 0))):
            lanes = m.reshape(rows, C // LANE, LANE).to(torch.int64)
            out[r0:r0 + rows] = words_to_int32((lanes * weights).sum(-1))
    return pos, neg


def pack_ternary_planes_ref(tau: torch.Tensor, thr: torch.Tensor):
    """tau [M, N] (any N), one threshold -> (pos, neg) int32
    [M, ceil(N/32)], zero bits past N in each row's last word.  Packed in
    blocks of rows and words to bound the int64 temporaries."""
    M, N = tau.shape
    W = -(-N // LANE)
    thr = thr.to(torch.float32).reshape(())
    weights = lane_weights(tau.device)
    pos = torch.empty((M, W), dtype=torch.int32, device=tau.device)
    neg = torch.empty_like(pos)
    rows = max(1, min(M, ROW_CHUNK))
    step = max(1, CHUNK_ELEMS // (rows * LANE))          # words per block
    for r0 in range(0, M, rows):
        for w0 in range(0, W, step):
            w1 = min(W, w0 + step)
            t = tau[r0:r0 + rows, w0 * LANE:min(w1 * LANE, N)].to(
                torch.float32)
            t = F.pad(t, (0, (w1 - w0) * LANE - t.shape[1]))
            keep = t.abs() >= thr
            for out, m in ((pos, keep & (t > 0)), (neg, keep & (t < 0))):
                lanes = m.reshape(t.shape[0], w1 - w0, LANE).to(torch.int64)
                out[r0:r0 + rows, w0:w1] = words_to_int32(
                    (lanes * weights).sum(-1))
    return pos, neg


def popcount_dot_ref(a_pos, a_neg, b_pos, b_neg) -> torch.Tensor:
    """Integer ternary dot of two flat plane pairs:
    popc(a+ & b+) + popc(a- & b-) - popc(a+ & b-) - popc(a- & b+), as a
    0-d int32 tensor (summed in int64, exact)."""
    def pc(x):
        return popcount(x).sum()
    return (pc(a_pos & b_pos) + pc(a_neg & b_neg) - pc(a_pos & b_neg)
            - pc(a_neg & b_pos)).to(torch.int32)
