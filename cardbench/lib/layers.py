"""Shared arithmetic of the per-layer metric readers: the model's share
of the bf16 peak over a window, the device's idle share and kernel 1's
roofline share over the traced slice.  The work is counted from the
configuration's shapes and what the window served (``cardbench/work``),
never from a kernel's launch geometry."""

from __future__ import annotations

from cardbench.lib import peaks, spec, trace


def mfu(rec):
    """Model operations of every served prompt and fed-back token over
    the window's seconds, as a share (%) of the bf16 peak."""
    mf = spec.work("model_flops")
    served = [t for t in rec.tracked if not t.failed and t.tokens]
    if not served:
        return None
    ops = sum(mf.sequence(rec.cfg, len(t.spec.prompt), t.tokens - 1)
              for t in served)
    return 100.0 * ops / ((rec.t_close - rec.t_open) * peaks.BF16_FLOPS)


def idle_share(rec):
    """1 - (union of kernel intervals) / the traced slice, in %."""
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])


def ternary_roofline(rec):
    """Kernel 1's least time for the traced slice's work over its device
    time, in %.  Per flush in the slice: each row's decode steps after its
    first emission of the chunk (emitted - 1; the step that makes the
    next chunk's pending token is left out), at the chunk's distinct
    experts; the prompts of the requests first delivered there (their
    prefills ran since the previous flush), once per distinct expert."""
    if rec.trace is None or not getattr(rec, "slice_flushes", None):
        return None
    w = spec.work("ternary_matmul_grouped")
    secs = trace.kernel_seconds(rec.trace, *w.NEEDLES)
    if secs <= 0:
        return None
    a, b = rec.slice_flushes
    least = 0.0
    for now, carried in rec.flushes[a:b]:
        if not carried:
            continue
        experts = {t.spec.expert for t, _ in carried}
        steps = max(n - 1 for _, n in carried)
        rows = sum(n - 1 for _, n in carried)
        if steps > 0:
            ops, nbytes = w.call(rec.cfg, rows / steps, len(experts))
            least += steps * peaks.least_seconds(ops, nbytes)
        firsts = [t for t, _ in carried if t.first == now]
        if firsts:
            ops, nbytes = w.call(rec.cfg, sum(len(t.spec.prompt)
                                              for t in firsts),
                                 len({t.spec.expert for t in firsts}))
            least += peaks.least_seconds(ops, nbytes)
    return 100.0 * least / secs

