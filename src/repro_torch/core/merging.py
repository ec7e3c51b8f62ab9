"""Model merging and composition over (compressed) task vectors, in
PyTorch.  Port of ``repro/core/merging.py`` (paper §3.6–3.7):

* Task Arithmetic: theta = theta_init + lam * sum(tau_i);
* TIES-Merging: trim -> elect sign -> disjoint mean;
* LoraHub composition: a weighted sum of LoRA factors with weights found by
  a gradient-free search (the reference's (1+1)-ES with restarts, the same
  numpy generator, so the same seed gives the same search);
* :func:`merge_packed`: Task Arithmetic straight on packed planes;
* :func:`pairwise_similarity_matrix`: expert-expert cosines by popcount
  (the ``popcount_dot`` kernel per pair and leaf).

Trees are nested dicts of tensors (task vectors) or of
:class:`~repro_torch.core.packing.PackedTernary`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import PackedTernary, _is_pt, unpack_ternary


def task_arithmetic(taus: Sequence[dict], lam: float = 1.0) -> dict:
    """theta_delta = lam * sum_i tau_i (f32 sum in order, then the first
    tree's dtype)."""
    def add(*ls):
        acc = ls[0].to(torch.float32)
        for leaf in ls[1:]:
            acc = acc + leaf.to(torch.float32)
        return (lam * acc).to(ls[0].dtype)
    return tree_util.tree_map(add, *taus)


def ties_merge(taus: Sequence[dict], density: float = 0.2,
               lam: float = 1.0) -> dict:
    """TIES: (1) trim each task to its top-k magnitudes (the exact
    quantile of Algorithm 1), (2) elect the sign by summed mass, (3) mean
    over the entries that agree with it."""
    from repro_torch.core.compeft import _topk_threshold

    def merge_leaf(*ls):
        trimmed = []
        for t in ls:
            t32 = t.to(torch.float32)
            thr = _topk_threshold(t32.abs(), density)
            trimmed.append(torch.where(t32.abs() >= thr, t32, 0.0))
        stack = torch.stack(trimmed)                       # [T, ...]
        elected = torch.sign(stack.sum(dim=0))
        agree = (torch.sign(stack) == elected[None]) & (stack != 0.0)
        num = torch.where(agree, stack, 0.0).sum(dim=0)
        den = torch.clamp_min(agree.to(torch.float32).sum(dim=0), 1.0)
        return (lam * num / den).to(ls[0].dtype)

    return tree_util.tree_map(merge_leaf, *taus)


def merge_experts(experts: Sequence[Any], method: str = "auto",
                  lam: float = 1.0, density: float = 0.2) -> dict:
    """Representation-aware merging over
    :class:`~repro_torch.expert.Expert` artifacts (or raw task-vector /
    packed trees).

    ``"task_arithmetic"`` merges the experts' ternary reconstructions;
    ``"ties"`` runs TIES on them (``density`` is the trim fraction);
    ``"packed"`` runs Task Arithmetic on the planes (:func:`merge_packed`);
    ``"auto"`` picks ``"packed"`` when every input is packed-resident,
    else ``"task_arithmetic"``.  Returns a dense task-vector tree.
    """
    from repro_torch.expert import DENSE, PACKED, Expert, as_expert

    experts = [as_expert(e) if (not isinstance(e, Expert)
                                and hasattr(e, "packed")) else e
               for e in experts]

    def is_packed_resident(e):
        if isinstance(e, Expert):
            return PACKED in e.available() and DENSE not in e.available()
        leaves = tree_util.leaves(e, is_leaf=_is_pt)
        return bool(leaves) and all(_is_pt(leaf) for leaf in leaves)

    if method == "auto":
        method = ("packed" if all(is_packed_resident(e) for e in experts)
                  else "task_arithmetic")
    if method == "packed":
        packed = [e.as_(PACKED) if isinstance(e, Expert) else e
                  for e in experts]
        return merge_packed(packed, lam=lam)
    dense = [e.to_dense_tau() if isinstance(e, Expert) else e
             for e in experts]
    if method in ("task_arithmetic", "ta"):
        return task_arithmetic(dense, lam=lam)
    if method == "ties":
        return ties_merge(dense, density=density, lam=lam)
    raise ValueError(f"unknown merge method {method!r}; choose "
                     "task_arithmetic | ties | packed | auto")


def merge_packed(packed_taus: Sequence[dict], lam: float = 1.0) -> dict:
    """Task Arithmetic over packed trees: per leaf lam * sum_i scale_i *
    (pos_i - neg_i), summed in f32 in order, then the leaf's dtype."""
    def merge_leaf(*pts: PackedTernary):
        acc = None
        for p in pts:
            contrib = unpack_ternary(p).signs.to(torch.float32) * p.scale
            acc = contrib if acc is None else acc + contrib
        return (lam * acc).to(pts[0].orig_dtype).reshape(pts[0].shape)

    return tree_util.tree_map(merge_leaf, *packed_taus, is_leaf=_is_pt)


# ---------------------------------------------------------------------------
# LoraHub-style gradient-free composition
# ---------------------------------------------------------------------------


def compose_lora(modules: Sequence[dict], weights) -> dict:
    """L_m = (sum w_i A_i, sum w_i B_i): eq. (1) of the paper."""
    def f(*ls):
        stack = torch.stack([leaf.to(torch.float32) for leaf in ls])
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=stack.device)
        w = w.reshape((-1,) + (1,) * (stack.dim() - 1))
        return (w * stack).sum(dim=0).to(ls[0].dtype)
    return tree_util.tree_map(f, *modules)


def lorahub_search(modules: Sequence[dict],
                   loss_fn: Callable[[dict], float], n_iters: int = 40,
                   seed: int = 0, init_sigma: float = 0.35,
                   l1_reg: float = 0.05) -> tuple[np.ndarray, float]:
    """Gradient-free weight search (stand-in for Nevergrad's Shiwa):
    (1+1)-ES with 1/5th-rule step adaptation and random restarts,
    minimising ``loss_fn(compose_lora(modules, w)) + l1_reg * |w|_1``.
    Host numpy with the reference's generator.  Returns (best_weights,
    best_loss)."""
    rng = np.random.default_rng(seed)
    n = len(modules)

    def total(w: np.ndarray) -> float:
        loss = float(loss_fn(compose_lora(modules, np.asarray(w,
                                                              np.float32))))
        return loss + l1_reg * float(np.abs(w).sum())

    best_w = np.zeros((n,), np.float64)
    best_l = total(best_w)
    w, lcur, sigma = best_w.copy(), best_l, init_sigma
    for _ in range(n_iters):
        cand = w + rng.normal(0.0, sigma, size=n)
        cand = np.clip(cand, -1.5, 1.5)
        lc = total(cand)
        if lc < lcur:
            w, lcur = cand, lc
            sigma *= 1.3
            if lc < best_l:
                best_w, best_l = cand.copy(), lc
        else:
            sigma *= 0.82
        if sigma < 1e-3:  # restart
            w = rng.normal(0.0, init_sigma, size=n)
            lcur = total(w)
            sigma = init_sigma
    return best_w, best_l


def pairwise_similarity_matrix(packed: Sequence[dict]) -> np.ndarray:
    """Expert-expert cosine similarity by popcount algebra: the mean over
    leaves of each leaf's ternary cosine (fast routing or dedup of an
    expert library)."""
    from repro_torch.core.ternary_ops import cosine_similarity

    def tree_cos(a, b):
        la = tree_util.leaves(a, is_leaf=_is_pt)
        lb = tree_util.leaves(b, is_leaf=_is_pt)
        return float(np.mean([float(cosine_similarity(x, y))
                              for x, y in zip(la, lb)]))

    n = len(packed)
    m = np.eye(n)
    for i in range(n):
        for j in range(i + 1, n):
            m[i, j] = m[j, i] = tree_cos(packed[i], packed[j])
    return m
