"""The rate sweep of an open-loop cell: one set-up, then a window at each
base rate in turn, to find the highest rate that the cell's mix sustains.

    python3 cardbench/sweep.py --workload <name> --seed <n> --seconds 20 \
        --rates 1 2 3 4 [--out chiprun_out/sweep_<name>.jsonl]

Per rate it prints one line: requests offered and served per second,
TTFT's median and 95th percentile over all requests, the 95th percentile
of the first and the last third of the arrivals (a queue that grows
through the window reads higher in the last), and the drain (seconds
from the end of the arrivals to the last completion).  The cell's file
keeps the rate chosen; the benchmark's own runs never sweep.
"""

import argparse
import json
import sys
import types
from pathlib import Path


def summary(rec, rate: float, seconds: float) -> dict:
    from cardbench.lib import stats
    tr = sorted(rec.tracked, key=lambda t: t.due)
    n = len(tr)
    tt = stats.ttfts(tr)
    third = max(n // 3, 1)
    p95 = lambda xs: stats.percentile(xs, 95)  # noqa: E731
    served = sum(t.served for t in tr)
    return {"base_rate": rate, "requests": n, "failed": rec.failed,
            "offered_per_s": n / seconds,
            "served_per_s": served / (rec.t_close - rec.t_open),
            "ttft_p50_ms": 1e3 * stats.percentile(tt, 50),
            "ttft_p95_ms": 1e3 * p95(tt),
            "ttft_p95_first_third_ms": 1e3 * p95(tt[:third]),
            "ttft_p95_last_third_ms": 1e3 * p95(tt[-third:]),
            "tpot_p95_ms": 1e3 * p95(stats.tpots(tr)),
            "drain_s": rec.t_close - rec.t_open - seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    from cardbench.lib import spec
    run = spec.load_module(root / "cardbench" / "run.py", "cardbench_run")
    run.environment(root)
    import torch
    if not torch.cuda.is_available():
        print("cardbench: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, root)
    dev = torch.device("cuda", 0)
    drv = spec.driver(cell.workload["driver"])
    st = drv.setup(cell, args.seed, dev)
    arrivals = cell.workload["traffic"]["arrivals"]
    for rate in args.rates:
        arrivals["base_rate"] = rate
        rec = types.SimpleNamespace(cfg=cell.config, cell=cell,
                                    seed=args.seed, trace=None, slice=None)
        drv.window(st, args.seconds, rec)
        line = summary(rec, rate, args.seconds)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
