"""The served tokens held to the plain reference.

For each sampled request the reference runs once over its prompt and
its served tokens (all but the last) and reads, at each position whose
next token was served, how far the served token's logit lies below the
reference's best there.  The expert's weights are worked out again from
the inputs (base and fine-tune leaves regenerated from the seed,
compressed by :mod:`cardbench.reference.compeft`): base + scale * signs in
float32 on the overlay path, the merged bf16 tree on the merge path.

The control puts the reference in the program's place one precision
below the configuration's bf16: every weight rounded to fp8 (e4m3) with
one scale per unit and leaf, the token it puts first at each position read
under the float32 reference.
"""

from __future__ import annotations

import torch

from cardbench.lib import weights
from cardbench.reference import compeft, lm

FP8_MAX = 448.0


def expert_weights(cfg: dict, seed: int, expert: int, dev, density: float,
                   alpha: float, merged: bool) -> dict:
    """{path: float32 leaf} of one expert, from the seed alone."""
    W = {}
    for i, (path, *_) in enumerate(weights.layout(cfg)):
        base = weights.base_leaf(cfg, seed, i, dev)
        tuned = weights.finetune_leaf(base, seed, expert, i)
        leaf = (compeft.merged_leaf(base, tuned, density, alpha).float()
                if merged else compeft.expert_leaf(base, tuned, density,
                                                   alpha))
        W[path] = leaf
        del base, tuned
    return W


def fp8(W: dict) -> dict:
    """Every leaf through float8 e4m3 and back, one scale per unit slice
    (per leaf for the leaves without a unit axis)."""
    out = {}
    for path, w in W.items():
        unit = path.startswith("blocks/") and w.dim() > 1
        red = tuple(range(1, w.dim())) if unit else tuple(range(w.dim()))
        amax = w.abs().amax(dim=red, keepdim=True).clamp_min(1e-30)
        s = amax / FP8_MAX
        out[path] = (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return out


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    return logits.max(dim=-1).values - logits.gather(
        -1, chosen[:, None].to(torch.int64))[:, 0]


def check(cfg: dict, seed: int, samples: list, dev, density: float,
          alpha: float, merged: bool, capacity_factor=None,
          control: bool = False) -> dict:
    """samples: [(expert index, prompt ids, served ids, left pads of its
    prefill batch)].  Returns the
    widest gap, the gaps' 99th percentile, their mean and their count (and
    the control's, with ``control``)."""
    by_expert: dict = {}
    for e, prompt, served, pad in samples:
        by_expert.setdefault(e, []).append((prompt, served, pad))
    all_gaps, ctl_gaps = [], []
    for e, items in sorted(by_expert.items()):
        W = expert_weights(cfg, seed, e, dev, density, alpha, merged)
        W8 = fp8(W) if control else None
        for prompt, served, pad in items:
            p = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
            s = torch.as_tensor(served, dtype=torch.int64, device=dev)
            seq = torch.cat([p, s[:-1]])
            L = p.numel()
            kw = dict(capacity_factor=capacity_factor, pad=pad,
                      prompt_len=L if capacity_factor else None)
            ref = lm.forward(cfg, W, seq, **kw)[L - 1:]
            all_gaps.append(gaps(ref, s))
            if control:
                low = lm.forward(cfg, W8, seq, **kw)[L - 1:]
                ctl_gaps.append(gaps(ref, low.argmax(dim=-1)))
                del low
            del ref
        del W, W8
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
    g = torch.cat(all_gaps)
    out = {"gap_max": float(g.max()), "gap_p99": float(g.quantile(0.99)),
           "gap_mean": float(g.mean()), "positions": int(g.numel())}
    if control:
        c = torch.cat(ctl_gaps)
        out.update(control_gap_max=float(c.max()),
                   control_gap_p99=float(c.quantile(0.99)),
                   control_gap_mean=float(c.mean()))
    return out


def merged_tree_off(cfg: dict, seed: int, expert: int, tree: dict, dev,
                    density: float, alpha: float) -> dict:
    """The program's merged tree of ``expert`` against the reference's:
    the elements that differ by more than one step of the leaf's type
    (2^-7 of |value| + scale in bf16, 2^-23 in f32: the program's scale is
    the f32 std, the reference's the f64 one, rounded)."""
    off, worst = 0, 0.0
    for i, (path, *_) in enumerate(weights.layout(cfg)):
        base = weights.base_leaf(cfg, seed, i, dev)
        tuned = weights.finetune_leaf(base, seed, expert, i)
        sg, s = compeft.compress_leaf(compeft.task_vector(base, tuned),
                                      density, alpha)
        del tuned
        want = base.to(torch.float32).add_(sg.to(torch.float32).mul_(s))
        want = want.to(base.dtype).to(torch.float32)
        bits = 7 if base.dtype == torch.bfloat16 else 23
        step = (want.abs() + s) * 2.0 ** -bits
        ratio = (tree[path].to(torch.float32) - want).abs().div_(step)
        off += int((ratio > 1.0).sum())
        worst = max(worst, float(ratio.max()))
        del base, sg, want, step, ratio
    return {"merged_off": off, "merged_worst_steps": worst}
