"""Plain reference of Algorithm 1 as the program states it, and of the
merge-on-swap.

ComPEFT keeps the signs of the ``density`` share of a task vector's
entries with the largest magnitude and gives each survivor the magnitude
``alpha * std(tau)`` (one threshold and scale per leaf).  The streaming
form states its threshold as the lower edge of the refined histogram
bin that holds the k-th largest magnitude (k = round(n * density), at
least 1): 2048 bins of |tau| over [0, max], then 2048 sub-bins of the bin
that holds the k-th largest, each element binned by
``(|x| - lo) / w * 2048``.  This file works that out again in plain
PyTorch, leaf by leaf, with the scale's moments in float64; it imports
nothing of the program.  The planes are packed as the program's are: bit
``i % 32`` of word ``i // 32`` over the leaf's C-order elements.
"""

from __future__ import annotations

import torch

NBINS = 2048
CHUNK = 1 << 26            # elements per step (bounds the temporaries)


def _hist(mag: torch.Tensor, lo, w, nbins: int = NBINS) -> torch.Tensor:
    """Counts of ``mag`` in ``nbins`` bins over [lo, lo + w] (int64)."""
    counts = torch.zeros(nbins, dtype=torch.int64, device=mag.device)
    w = torch.clamp_min(w, 1e-30)
    for s in range(0, mag.numel(), CHUNK):
        m = mag[s:s + CHUNK]
        keep = (m >= lo) & (m <= lo + w)
        q = (m[keep] - lo) / w * nbins
        counts += torch.bincount(q.clamp(0, nbins - 1).to(torch.int64),
                                 minlength=nbins)
    return counts


def _select(counts: torch.Tensor, keep) -> torch.Tensor:
    """Smallest bin whose suffix count reaches ``keep``."""
    suffix = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
    ids = torch.nonzero(suffix >= keep)
    return ids.max() if ids.numel() else torch.zeros((), dtype=torch.int64,
                                                     device=counts.device)


def threshold(tau: torch.Tensor, density: float) -> torch.Tensor:
    """The leaf's keep threshold (f32 0-d tensor)."""
    flat = tau.reshape(-1).to(torch.float32)
    mag = flat.abs()
    n = torch.tensor(float(flat.numel()), dtype=torch.float32,
                     device=flat.device)
    keep = torch.clamp_min(torch.round(n * density), 1.0).to(torch.int64)
    smax = mag.max()
    if float(smax) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=flat.device)
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    coarse = _hist(mag, zero, smax)
    cb = _select(coarse, keep)
    cw = torch.clamp_min(smax, 1e-30) / NBINS
    lo1 = cb.to(torch.float32) * cw
    suffix = torch.flip(torch.cumsum(torch.flip(coarse, (0,)), 0), (0,))
    above = suffix[cb + 1] if int(cb) + 1 < NBINS else 0
    refined = _hist(mag, lo1, cw)
    rb = _select(refined, torch.clamp_min(keep - above, 1))
    return lo1 + rb.to(torch.float32) * (cw / NBINS)


def scale(tau: torch.Tensor, alpha: float) -> float:
    """alpha * std(tau) (population), the moments summed in float64."""
    flat = tau.reshape(-1)
    s1 = s2 = 0.0
    for s in range(0, flat.numel(), CHUNK):
        c = flat[s:s + CHUNK].to(torch.float64)
        s1 += float(c.sum())
        s2 += float((c * c).sum())
    n = flat.numel()
    mean = s1 / n
    return alpha * max(s2 / n - mean * mean, 0.0) ** 0.5


def signs(tau: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """int8 signs of the kept entries (|x| >= thr), in tau's shape."""
    flat = tau.reshape(-1)
    out = torch.empty(flat.numel(), dtype=torch.int8, device=tau.device)
    for s in range(0, flat.numel(), CHUNK):
        c = flat[s:s + CHUNK]
        kept = c.abs() >= thr
        out[s:s + CHUNK] = ((kept & (c > 0)).to(torch.int8)
                            - (kept & (c < 0)).to(torch.int8))
    return out.reshape(tau.shape)


def pack(sg: torch.Tensor, sign: int) -> torch.Tensor:
    """The plane of ``sign`` as int32 words: bit i % 32 of word i // 32 set
    where element i (C order) has that sign."""
    flat = sg.reshape(-1)
    n = flat.numel()
    words = torch.empty(-(-n // 32), dtype=torch.int32, device=sg.device)
    shifts = torch.arange(32, dtype=torch.int64, device=sg.device)
    step = CHUNK // 32 * 32
    for s in range(0, n, step):
        b = (flat[s:s + step] == sign).to(torch.int64)
        b = torch.nn.functional.pad(b, (0, (-b.numel()) % 32))
        w = (b.reshape(-1, 32) << shifts).sum(dim=1)
        words[s // 32:s // 32 + w.numel()] = torch.where(
            w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    return words


def task_vector(base: torch.Tensor, tuned: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """tau = tuned - base in float32, held in ``dtype`` (float32 as the
    configuration states; bfloat16 for the control)."""
    tau = tuned.to(torch.float32) - base.to(torch.float32)
    return tau if dtype == torch.float32 else tau.to(dtype).to(torch.float32)


def compress_leaf(tau: torch.Tensor, density: float, alpha: float = 1.0):
    """-> (signs int8 in the leaf's shape, scale as float32)."""
    thr = threshold(tau, density)
    return signs(tau, thr), torch.tensor(scale(tau, alpha),
                                         dtype=torch.float32,
                                         device=tau.device)


def expert_leaf(base: torch.Tensor, tuned: torch.Tensor, density: float,
                alpha: float = 1.0) -> torch.Tensor:
    """The expert's effective leaf in float32: base + scale * signs, the
    compression worked out from (base, fine-tune)."""
    sg, s = compress_leaf(task_vector(base, tuned), density, alpha)
    out = base.to(torch.float32)
    return out.add_(sg.to(torch.float32).mul_(s))


def merged_leaf(base: torch.Tensor, tuned: torch.Tensor, density: float,
                alpha: float = 1.0) -> torch.Tensor:
    """Merge-on-swap's leaf: round(f32(base) + f32(scale) * signs) to the
    base's type."""
    return expert_leaf(base, tuned, density, alpha).to(base.dtype)
