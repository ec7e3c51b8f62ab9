"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name (``cardbench/lib/spec.py``).  The run
makes its inputs from the seed, sets the system up (``setup_s``), serves
or compresses for ``--seconds`` (``--trace 1``: a slice of it under the
profiler, and the per-layer metrics instead of the end-to-end ones), then
frees the program's state and holds what the window produced to the
plain reference in ``cardbench/reference``.  The numbers compared are
printed beside their limits as the last lines of standard error and as
the result's last key; the result is the last line of standard output.

It exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), when a file it needs is missing, and when the process
holds ``jax``, ``jaxlib``, ``flax`` or the JAX package after the window.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Modules of the JAX stack or the JAX package in this process,
    compared by whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def environment(root: Path) -> None:
    """Every cache the program or its libraries write goes inside the
    checkout, at a fixed path; nothing may pull in JAX."""
    cache = root / "cardbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(cell, seed: int, seconds: float, traced: bool, dev,
             t_start: float, control: bool = False, warm: bool = True,
             faults=None) -> dict:
    """Set up, run the window, read the metrics, check; returns the result
    (without the forbidden-module test).  Set-up first builds or loads the
    program's kernels, timed on its own (``setup_parts.build_s``: the nvcc
    build of a checkout's first run, a load after it), then the driver's
    steps, each timed (``setup_parts``).  ``control`` adds the control's
    readings (``cardbench/readings.py``); ``warm=False`` skips the graph
    warm-up; ``faults(state)`` may break the program under the window (the
    harness's tests)."""
    import torch
    from cardbench.lib import spec, trace
    drv = spec.driver(cell.workload["driver"])
    on_card = torch.device(dev).type == "cuda"
    parts = {"start_s": time.monotonic() - t_start}
    t = time.monotonic()
    if on_card:
        from repro_torch.kernels import build
        build.build_all()
    parts["build_s"] = time.monotonic() - t
    st = drv.setup(cell, seed, dev, warm=warm)
    if faults is not None:
        faults(st)
    if on_card:
        torch.cuda.synchronize(dev)
    rec = types.SimpleNamespace(cfg=cell.config, cell=cell, seed=seed,
                                trace=None, slice=trace.Slice() if traced
                                else None)
    drv.window(st, seconds, rec)
    rec.setup_s = rec.t_open - t_start
    if traced:
        if rec.slice.prof is None:
            raise RuntimeError("the traced slice never started")
        rec.trace = rec.slice.reduce()
        rec.slice = None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        v = spec.metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    readings = drv.check(st, rec, seed, control=control)
    limits = cell.workload["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["setup_parts"] = {**parts, **st.parts,
                          "window_open_s": rec.setup_s}
    out["readings"] = {k: v for k, v in readings.items() if k not in limits}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    environment(root)
    from cardbench.lib import spec
    cell = spec.load_cell(args.workload, root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cardbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
