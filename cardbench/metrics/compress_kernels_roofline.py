"""The compression kernels (absmax, the histogram sweeps and their
moments, the pack): the least time the traced slice's compressions need
of them (``cardbench/work/compress.py``: the task vector read once, the
planes written once, at 3.35 TB/s) over their summed device time."""

from cardbench.lib import peaks, spec, trace


def read(rec):
    if rec.trace is None or not rec.traced_compressions:
        return None
    w = spec.work("compress")
    secs = trace.kernel_seconds(rec.trace, *w.NEEDLES)
    if secs <= 0:
        return None
    ops, nbytes = w.compression(rec.leaf_sizes)
    return 100.0 * rec.traced_compressions * peaks.least_seconds(
        ops, nbytes) / secs
