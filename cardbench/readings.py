"""The readings that a cell's limits are set from: the program's and
the control's numbers on many seeds, in one process.

    python3 cardbench/readings.py --workload <name> --seeds 101 102 ... \
        --seconds 5 [--out chiprun_out/readings_<name>.jsonl]

Each seed is a full run of the cell (its own weights, experts and
traffic; no graph warm-up) with a short window, whose check also puts
the reference in the program's place one precision below the
configuration's (``control_*`` readings).  The benchmark's own runs never
run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
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
    for seed in args.seeds:
        t0 = time.monotonic()
        out = run.run_cell(cell, seed, args.seconds, False, dev, t0,
                           control=True, warm=False)
        line = {"seed": seed, "s": time.monotonic() - t0,
                "attempted": out["attempted"], "failed": out["failed"],
                **{k: c["value"] for k, c in out["checks"].items()},
                **out["readings"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
