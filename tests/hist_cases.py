"""Edge and skewed inputs for the port's segmented histogram sweep and
segment absmax, made with numpy from a seed.  Shared by the CPU tests
(against the JAX package) and the card tests (kernel against plain); it
imports neither JAX nor torch."""

import numpy as np


def edge_case(seed: int, nbins: int, *, layout: str = "segments",
              cols: int = 96, big: bool = False):
    """(buf [R, C] f32, row_seg [R] int32, row_valid [R] int32, lo [S] f32,
    width [S] f32, S) with five segments:

    0. all zeros, window [0, 0] (a frozen leaf's coarse sweep);
    1. mostly +-0.5, window lo = 0.5, width 0 (only |x| == 0.5 is in
       range), with 0.5's neighbours one ulp either side;
    2. Gaussian with a ragged last row, window [0.25, 0.25 + 1.5]; the
       magnitudes lo, lo + w (its f32 sum), one ulp past each, and bin
       edges lo + k w / nbins with their neighbours, planted with both
       signs;
    3. 90% equal magnitudes (+-0.01, random signs), coarse window [0, max];
    4. a row with no valid column, then a ragged row of large values.

    Padding columns hold 7.0, so a sweep that reads them shows it.
    ``layout``: "segments" (contiguous rows per segment, as the
    compression builds them), "single" (one segment over all rows, as with
    ``per_tensor=False``) or "interleaved" (the rows of the segments dealt
    round-robin).  ``big`` makes segments 2 and 3 span several of the
    kernel's row blocks at cols = 8192.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows = (3, 2, 40, 36, 2) if big else (3, 2, 5, 4, 2)
    R, C = sum(rows), cols
    buf = np.full((R, C), 7.0, f32)
    row_seg = np.repeat(np.arange(5), rows).astype(np.int32)
    row_valid = np.full(R, C, np.int32)
    starts = np.cumsum((0,) + rows[:-1])

    def fill(s, vals):
        r0, nr = starts[s], rows[s]
        flat = np.concatenate([buf[r, :row_valid[r]] for r in
                               range(r0, r0 + nr)])
        flat[:] = vals(flat.size)
        k = 0
        for r in range(r0, r0 + nr):
            buf[r, :row_valid[r]] = flat[k:k + row_valid[r]]
            k += row_valid[r]

    lo = np.zeros(5, f32)
    width = np.zeros(5, f32)
    # 0: all zeros
    fill(0, lambda n: np.zeros(n, f32))
    # 1: +-0.5 and its neighbours, window of width 0 at 0.5
    half = f32(0.5)
    near = np.array([half, -half, np.nextafter(half, f32(1)),
                     np.nextafter(half, f32(0)), f32(0.25)], f32)
    fill(1, lambda n: rng.choice(near, n, p=[0.4, 0.3, 0.1, 0.1, 0.1]))
    lo[1] = half
    # 2: Gaussian, a ragged last row, planted edges
    row_valid[starts[2] + rows[2] - 1] = C // 3 + 1
    lo[2], width[2] = f32(0.25), f32(1.5)
    hi = f32(lo[2] + width[2])
    ks = rng.integers(0, nbins + 1, 24)
    edges = (lo[2] + ks.astype(f32) * (width[2] / f32(nbins))).astype(f32)
    plant = np.concatenate([
        [lo[2], hi, np.nextafter(lo[2], f32(0)), np.nextafter(hi, f32(9))],
        edges, np.nextafter(edges, f32(0)), np.nextafter(edges, f32(9))])
    plant = np.concatenate([plant, -plant]).astype(f32)

    def gauss_planted(n):
        v = (rng.standard_normal(n) * 0.8).astype(f32)
        v[:plant.size] = plant
        return v
    fill(2, gauss_planted)
    # 3: 90% equal magnitudes
    fill(3, lambda n: np.where(
        rng.random(n) < 0.9, np.where(rng.random(n) < 0.5, -0.01, 0.01),
        0.01 * rng.standard_normal(n)).astype(f32))
    # 4: an empty row, then a ragged row
    row_valid[starts[4]] = 0
    row_valid[starts[4] + 1] = 5
    fill(4, lambda n: (rng.standard_normal(n) * 1e3).astype(f32))
    valid = np.arange(C)[None, :] < row_valid[:, None]
    mag = np.where(valid, np.abs(buf), 0.0)
    for s in (3, 4):
        width[s] = mag[row_seg == s].max()
    S = 5
    if layout == "single":
        row_seg[:] = 0
        lo, width, S = np.zeros(1, f32), np.asarray([mag.max()], f32), 1
    elif layout == "interleaved":
        rank = np.concatenate([np.arange(n) for n in rows])
        order = np.lexsort((row_seg, rank))
        buf, row_seg, row_valid = buf[order], row_seg[order], row_valid[order]
    elif layout != "segments":
        raise ValueError(layout)
    return (np.ascontiguousarray(buf), row_seg, row_valid, lo, width, S)
