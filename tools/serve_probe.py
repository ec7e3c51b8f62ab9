#!/usr/bin/env python3
"""Time the warm serving paths of one checkout's package.

    python3 tools/serve_probe.py [--src DIR] [--tag NAME] [--reps 5]

``chip_smoke.py`` times the serving paths of this checkout once each,
among many other phases; this script times those of the package under
``--src`` (default this checkout's ``src``), such as the parent commit
unpacked with ``git archive``, so that two versions are timed by one
script on one card with the same inputs.  It checks only that the
repetitions repeat their tokens.  At ``chip_smoke.py``'s default width,
depth and seed (qwen2.5-3b, 4 units, 4 experts at density 0.1, seed 0)
it serves, each ``--reps`` times on one warm engine after a cold run:
phase 3's 8 requests in mixed waves (``continuous=False``), timed as
the decode tokens/s of the waves, and phase 3d's 16 refill requests
(``max_batch=4``, ``cache_len=256``, ``decode_chunk=8``), timed as
tokens/s end to end.  Prints one JSON line last (every repetition) and
writes it to ``chiprun_out/serve_probe[-TAG].json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("serve_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import (finetune, fresh, gpu_line, make_requests,
                            refill_requests)
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.expert import DENSE, PACKED
    from repro_torch.models import build as build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=4)
    model = build_model(cfg)
    base = model.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    experts = []
    for i in range(4):
        ex = api.compress(base, finetune(torch, base, gen), name=f"e{i}",
                          density=0.1, device=dev)
        ex.as_(PACKED)
        ex.drop(DENSE)
        experts.append(ex)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts)
    out = {"gpu": gpu_line(), "src": os.path.abspath(args.src),
           "decode_tokens_per_s": [], "refill_tokens_per_s": []}

    wave = api.serve(model, base, reg, max_batch=4, cache_len=128,
                     decode_chunk=8, continuous=False)
    reqs = make_requests(torch, cfg, 0)
    wave.run(reqs)
    refill = api.serve(model, base, reg, max_batch=4, cache_len=256,
                       decode_chunk=8)
    rreqs = refill_requests(torch, cfg, 0)
    refill.run(rreqs)
    for rep in range(args.reps):
        n0 = len(wave.wave_log)
        rr = fresh(reqs, 100 * (rep + 1))
        torch.cuda.synchronize()
        wave.run(rr)
        torch.cuda.synchronize()
        if [r.out_tokens for r in rr] != [r.out_tokens for r in reqs]:
            raise SystemExit("serve_probe: a warm run gave other tokens")
        waves = wave.wave_log[n0:]
        out["decode_tokens_per_s"].append(
            sum(w["tokens"] - w["rows"] for w in waves)
            / sum(w["seconds"] - w["prefill_s"] for w in waves))
        rr = fresh(rreqs, 10000 * (rep + 1))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        refill.run(rr)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if [r.out_tokens for r in rr] != [r.out_tokens for r in rreqs]:
            raise SystemExit("serve_probe: a warm refill gave other tokens")
        out["refill_tokens_per_s"].append(
            sum(r.max_new_tokens for r in rr) / secs)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "serve_probe" + (f"-{args.tag}" if args.tag else "") + ".json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
