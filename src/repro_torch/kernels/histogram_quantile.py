"""O(n) streaming threshold for Algorithm 1: segmented histogram + moments.

Port of ``repro/kernels/histogram_quantile.py``.  Two sweeps over the flat
``[R, C]`` segment buffer that holds every leaf of a task vector find, per
segment (leaf), the lower edge of the refined histogram bin holding the
k-th largest magnitude:

  pass 1 (coarse)  2048 bins of |tau| over [0, max_s], with sum, sum of
                   squares and sum |tau| in the same sweep;
  pass 2 (refine)  2048 sub-bins inside the coarse bin that holds the
                   k-th largest magnitude.

``|x| >= threshold`` then keeps the same top-k set as the exact quantile.
Each sweep is :func:`segment_hist_moments`, the CUDA kernel
``csrc/histogram.cu`` on the card and :func:`segment_hist_moments_plain`
(the JAX package's jnp path, in PyTorch) on the CPU; the pre-pass that
finds each segment's max, the coarse sweep's range, is
:func:`segment_absmax`, a kernel of the same source, and
:func:`_segment_absmax` on the CPU.  Both versions of a sweep bin with the
Pallas/jnp formula ``(|x| - lo) / w * nbins``, so their counts are
bitwise those of the reference's jnp and Pallas paths.  (The reference's
host numpy path, its default off the TPU, bins as ``(|x| - lo) * (nbins /
w)`` and sums the moments in f64: its thresholds can differ in the last
sub-bin on rare inputs, and its scales within f32 rounding.)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NBINS = 2048
MAX_NBINS = 8192       # the kernel keeps one int per bin in shared memory
ROW_CHUNK = 4096       # rows per step of the plain sweeps (bounds temporaries)


def segment_hist_moments_plain(buf, row_seg, row_valid, lo, width, *,
                               n_seg: int, nbins: int = NBINS,
                               with_moments: bool = True):
    """One sweep: buf [R, C] -> (hist [S, nbins] int32, sum, sumsq, max,
    sum|x| [S] f32).  Elements are binned by ``(|x| - lo_s) / w_s *
    nbins`` and clipped into [0, nbins-1]; padding (col >= row_valid) and
    out-of-range magnitudes are dropped.  Rows go in chunks to bound the
    temporaries."""
    R, C = buf.shape
    dev = buf.device
    counts = torch.zeros(n_seg * nbins, dtype=torch.int64, device=dev)
    ssum = torch.zeros(n_seg, dtype=torch.float32, device=dev)
    ssq = torch.zeros_like(ssum)
    smax = torch.zeros_like(ssum)
    sabs = torch.zeros_like(ssum)
    cols = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    for r0 in range(0, R, ROW_CHUNK):
        x = buf[r0:r0 + ROW_CHUNK].to(torch.float32)
        seg = row_seg[r0:r0 + ROW_CHUNK].to(torch.int64)
        mag = x.abs()
        valid = cols < row_valid[r0:r0 + ROW_CHUNK][:, None]
        lo_r = lo[seg][:, None]
        w_r = width[seg].clamp_min(1e-30)[:, None]
        q = (mag - lo_r) / w_r * nbins
        # clamping before the cast equals the reference's cast-then-clip
        # for every in-range element, and keeps the cast defined
        b = q.clamp(0, nbins - 1).to(torch.int64)
        in_range = valid & (mag >= lo_r) & (mag <= lo_r + w_r)
        idx = (seg[:, None] * nbins + b)[in_range]
        counts += torch.bincount(idx, minlength=n_seg * nbins)
        if with_moments:
            xm = torch.where(valid, x, 0.0)
            magm = torch.where(valid, mag, 0.0)
            ssum.index_add_(0, seg, xm.sum(dim=1))
            ssq.index_add_(0, seg, (xm * xm).sum(dim=1))
            sabs.index_add_(0, seg, magm.sum(dim=1))
            smax.scatter_reduce_(0, seg, magm.amax(dim=1), reduce="amax")
    hist = counts.reshape(n_seg, nbins).to(torch.int32)
    return hist, ssum, ssq, smax, sabs


def _check_sweep_inputs(buf, tensors):
    """Raise unless the kernels can take ``buf`` [R, C] f32 and the
    per-row / per-segment vectors ``(name, t, dtype, n)``."""
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if buf.dtype != torch.float32 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous [R, C] float32 tensor")
    if buf.shape[0] >= 2 ** 31 or buf.shape[1] >= 2 ** 31:
        raise ValueError("buf must have fewer than 2**31 rows and columns")
    for name, t, dt, n in tensors:
        if (t.dtype != dt or t.shape != (n,) or not t.is_contiguous()
                or t.device != buf.device):
            raise ValueError(f"{name} must be a contiguous [{n}] {dt} tensor "
                             "on buf's device")


def segment_hist_moments(buf, row_seg, row_valid, lo, width, *, n_seg: int,
                         nbins: int = NBINS, with_moments: bool = True):
    """The sweep of :func:`segment_hist_moments_plain`: CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise."""
    if buf.device.type == "cpu":
        return segment_hist_moments_plain(buf, row_seg, row_valid, lo, width,
                                          n_seg=n_seg, nbins=nbins,
                                          with_moments=with_moments)
    R, C = buf.shape
    _check_sweep_inputs(buf, (("row_seg", row_seg, torch.int32, R),
                              ("row_valid", row_valid, torch.int32, R),
                              ("lo", lo, torch.float32, n_seg),
                              ("width", width, torch.float32, n_seg)))
    if not 1 <= nbins <= MAX_NBINS:
        raise ValueError(f"nbins must be in [1, {MAX_NBINS}]")
    dev = buf.device
    hist = torch.empty((n_seg, nbins), dtype=torch.int32, device=dev)
    mom = torch.empty((n_seg, 4), dtype=torch.float32, device=dev)
    # scratch: each segment run's moment partial at its first row, and
    # per segment its first and end row
    part = torch.empty((R if with_moments else 1, 4), dtype=torch.float32,
                       device=dev)
    info = torch.empty((2 * max(n_seg, 1),), dtype=torch.int32, device=dev)
    lib = build.library("histogram")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.segment_hist_moments(
        buf.data_ptr(), row_seg.data_ptr(), row_valid.data_ptr(),
        lo.data_ptr(), width.data_ptr(), hist.data_ptr(), part.data_ptr(),
        info.data_ptr(), mom.data_ptr(), R, C, n_seg, nbins,
        int(with_moments), stream)
    build.check(rc, "segment_hist_moments")
    segment_hist_moments.launches += 1
    return hist, mom[:, 0], mom[:, 1], mom[:, 2], mom[:, 3]


segment_hist_moments.launches = 0


def _segment_absmax(buf, row_seg, row_valid, *, n_seg: int):
    """Per-segment max |x| over valid elements, at least 0 (plain
    PyTorch; max is order-independent, so it is exact on any device)."""
    R, C = buf.shape
    smax = torch.zeros(n_seg, dtype=torch.float32, device=buf.device)
    cols = torch.arange(C, dtype=torch.int32, device=buf.device)[None, :]
    for r0 in range(0, R, ROW_CHUNK):
        x = buf[r0:r0 + ROW_CHUNK]
        valid = cols < row_valid[r0:r0 + ROW_CHUNK][:, None]
        mag = torch.where(valid, x.to(torch.float32).abs(), 0.0)
        smax.scatter_reduce_(0, row_seg[r0:r0 + ROW_CHUNK].to(torch.int64),
                             mag.amax(dim=1), reduce="amax")
    return smax


def segment_absmax(buf, row_seg, row_valid, *, n_seg: int):
    """The pre-pass of :func:`_segment_absmax`: CPU tensors take the plain
    version, CUDA tensors launch the kernel (an integer max over the bit
    patterns of |x|, bitwise the plain version's) or raise."""
    if buf.device.type == "cpu":
        return _segment_absmax(buf, row_seg, row_valid, n_seg=n_seg)
    R, C = buf.shape
    _check_sweep_inputs(buf, (("row_seg", row_seg, torch.int32, R),
                              ("row_valid", row_valid, torch.int32, R)))
    smax = torch.empty((n_seg,), dtype=torch.float32, device=buf.device)
    lib = build.library("histogram")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.segment_absmax(buf.data_ptr(), row_seg.data_ptr(),
                            row_valid.data_ptr(), smax.data_ptr(), R, C,
                            n_seg, stream)
    build.check(rc, "segment_absmax")
    segment_absmax.launches += 1
    return smax


segment_absmax.launches = 0


def _suffix(hist: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(hist, (1,)), dim=1), (1,))


def _select_bin(hist, keep):
    """Smallest bin index b with suffix_count(b) >= keep (the bin holding
    the keep-th largest in-range magnitude).  hist [S, B], keep [S]."""
    ge = _suffix(hist) >= keep[:, None]
    ids = torch.arange(hist.shape[1], device=hist.device)[None, :]
    idx = torch.where(ge, ids, -1).amax(dim=1)
    return idx.clamp_min(0)


def segmented_quantile_moments(buf, row_seg, row_valid, seg_count, density,
                               *, n_seg: int, nbins: int = NBINS):
    """Two-pass histogram threshold + moments over a segment buffer.

    buf [R, C] f32 (padding zeroed); row_seg / row_valid [R] int32;
    seg_count [S] int32 or int64 elements per segment; density the kept
    fraction.
    Returns per-segment f32 ``threshold``, ``mean``, ``std``,
    ``mean_abs``, ``max``, ``sum``, ``sumsq``, int32 ``keep``, and the
    refine sweep's window ``refine_lo`` / ``refine_width``; nothing is
    read back to the host.
    """
    from repro_torch.kernels import ops
    sweep = ops.kernel("segment_hist_moments")
    absmax = ops.kernel("segment_absmax")
    n = seg_count.to(torch.float32)
    keep = torch.clamp_min(torch.round(n * density), 1.0).to(torch.int32)
    zeros = torch.zeros((n_seg,), dtype=torch.float32, device=buf.device)
    smax = absmax(buf, row_seg, row_valid, n_seg=n_seg)
    coarse, ssum, ssq, _, sabs = sweep(buf, row_seg, row_valid, zeros, smax,
                                       n_seg=n_seg, nbins=nbins)
    cb = _select_bin(coarse, keep)
    cw = torch.clamp_min(smax, 1e-30) / nbins
    lo1 = cb.to(torch.float32) * cw
    suffix = torch.nn.functional.pad(_suffix(coarse), (0, 1))
    above = torch.where(cb + 1 < nbins,
                        torch.gather(suffix, 1, (cb + 1)[:, None])[:, 0], 0)
    keep_in_bin = torch.clamp_min(keep - above, 1)
    refined = sweep(buf, row_seg, row_valid, lo1, cw, n_seg=n_seg,
                    nbins=nbins, with_moments=False)[0]
    rb = _select_bin(refined, keep_in_bin)
    thr = lo1 + rb.to(torch.float32) * (cw / nbins)
    thr = torch.where(smax > 0.0, thr, 0.0)
    nmax = torch.clamp_min(n, 1.0)
    mean = ssum / nmax
    var = torch.clamp_min(ssq / nmax - mean * mean, 0.0)
    return {"threshold": thr, "mean": mean, "std": torch.sqrt(var),
            "mean_abs": sabs / nmax, "max": smax, "sum": ssum,
            "sumsq": ssq, "keep": keep, "refine_lo": lo1, "refine_width": cw}
