"""The statistics the end-to-end metrics are made of.

A request that failed, or never delivered a token, counts as beyond every
served one: it is a miss in every percentile, never dropped.  Rates are
taken over all the work and all the time of the window.
"""

from __future__ import annotations

import math
from typing import Optional

INF = math.inf


def percentile(values: list, q: float) -> Optional[float]:
    """The q-th percentile (0-100) with linear interpolation between
    order statistics, infinities (misses) sorting last.  None for no
    values; inf where the percentile falls among the misses."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    a, b, w = xs[lo], xs[hi], pos - lo
    if w == 0 or a == INF:
        return a
    if b == INF:
        return INF
    return a + (b - a) * w


def ttfts(requests: list) -> list:
    """Seconds from each request's due time to the delivery of its first
    token; inf for a request that failed or delivered nothing."""
    return [r.first - r.due if r.served else INF for r in requests]


def tpots(requests: list) -> list:
    """(last delivery - first delivery) / (tokens - 1) over the requests
    that asked for at least 2 tokens; inf for such a request that failed
    or delivered fewer than 2."""
    out = []
    for r in requests:
        if r.budget < 2:
            continue
        if not r.served or r.tokens < 2:
            out.append(INF)
            continue
        out.append((r.last - r.first) / (r.tokens - 1))
    return out
