#!/usr/bin/env python3
"""Time the compression's histogram passes of one checkout's package.

    python3 tools/histogram_probe.py [--src DIR] [--tag NAME]

``chip_smoke.py`` checks and times the passes of this checkout; this
script times those of the package under ``--src`` (default this
checkout's ``src``), such as the parent commit unpacked with ``git
archive``, so that two versions of the kernel are timed by one script on
one card with the same inputs.  It checks nothing.  Over the segment
buffer of one qwen2.5-3b expert at full width and ``chip_smoke.py``'s
default depth and seed (4 units, seed 0: ``buf [75622, 8192]`` f32, 14
segments) it times, by
``chip_smoke.sweep_times``: the coarse sweep (lo = 0, width = max), the
refine sweep at the window ``segmented_quantile_moments`` takes for
density 0.1 (the package's own ``_select_bin`` over the coarse counts),
the coarse sweep over ``chip_smoke.skewed_buffer``'s copy, and the segment
absmax (its plain version, and the kernel where the package has one).
Prints one JSON line last and writes it to
``chiprun_out/histogram_probe[-TAG].json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("histogram_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import (absmax_bound, cuda_ms, finetune, gpu_line,
                            skewed_buffer, sweep_times)
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.core.compeft import STREAM_COLS, _build_segment_buffer
    from repro_torch.kernels import histogram_quantile as hq
    from repro_torch.models import build as build_model

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gpu = gpu_line()
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=4)
    base = build_model(cfg).init(seed=0, device=dev)
    ft = finetune(torch, base, torch.Generator(device=dev).manual_seed(0))
    leaves = [b.float() - a.float() for a, b in zip(tree_util.leaves(base),
                                                   tree_util.leaves(ft))]
    del base, ft
    buf, row_seg, row_valid, seg_count, _ = _build_segment_buffer(
        leaves, STREAM_COLS, dev)
    del leaves
    R, C = buf.shape
    S = int(seg_count.numel())
    n_el = float(seg_count.sum())
    skew = skewed_buffer(torch, buf, row_seg, row_valid, seg_count,
                         torch.Generator(device=dev).manual_seed(5))[0]
    smax = hq._segment_absmax(buf, row_seg, row_valid, n_seg=S)
    lo0 = torch.zeros_like(smax)
    coarse = hq.segment_hist_moments(buf, row_seg, row_valid, lo0, smax,
                                     n_seg=S)[0]
    keep = torch.clamp_min(torch.round(seg_count.to(torch.float32) * 0.1),
                           1.0).to(torch.int32)
    cw = torch.clamp_min(smax, 1e-30) / hq.NBINS
    lo1 = hq._select_bin(coarse, keep).to(torch.float32) * cw
    sweeps = {"coarse": (buf, lo0, smax, True),
              "refine": (buf, lo1, cw, False),
              "skewed_coarse": (skew, lo0, hq._segment_absmax(
                  skew, row_seg, row_valid, n_seg=S), True)}
    out = {"gpu": gpu, "src": os.path.abspath(args.src), "R": R, "C": C,
           "S": S, "nbins": hq.NBINS}
    out.update(sweep_times(torch, hq, row_seg, row_valid, sweeps, n_el))
    b, by = absmax_bound(R, C, S, n_el)
    absmax = {"plain_ms": cuda_ms(torch, lambda: hq._segment_absmax(
        buf, row_seg, row_valid, n_seg=S), 3), "bound_ms": b, "bound_by": by}
    if hasattr(hq, "segment_absmax"):
        absmax["ms"] = cuda_ms(torch, lambda: hq.segment_absmax(
            buf, row_seg, row_valid, n_seg=S), 10)
    out["absmax"] = absmax
    out["skewed_over_coarse"] = out["skewed_coarse"]["ms"] / out["coarse"]["ms"]
    path = os.path.join(ROOT, "chiprun_out", "histogram_probe"
                        + (f"-{args.tag}" if args.tag else "") + ".json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(gpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
