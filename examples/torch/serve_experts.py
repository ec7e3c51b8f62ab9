"""End-to-end multi-expert serving on the PyTorch port: the paper's
headline scenario, through the ``repro_torch.api`` facade.

Builds a base model and several ComPEFT-compressed experts in an
``ExpertRegistry``, then serves a mixed batch of requests through the
zero-merge engine, reporting swap bytes against the uncompressed baseline
(paper Table 5 quantities).

    PYTHONPATH=src python examples/torch/serve_experts.py [--experts 4] \
        [--requests 12] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import api as capi
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.expert import GOLOMB, PACKED
from repro_torch.models import build
from repro_torch.serve import Request, uncompressed_baseline_bytes


def finetune(base, seed, scale=0.01):
    """base + seeded Gaussian noise on every leaf."""
    leaves = tree_util.leaves(base)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    return tree_util.unflatten_like(base, [
        (l.float() + scale * torch.randn(l.shape, generator=gen,
                                         device=l.device)).to(l.dtype)
        for l in leaves])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2_5_3b", d_model=96, n_units=2)
    api = build(cfg)
    base = api.init(seed=0, device=args.device)

    # expert library: base + per-task deltas, ComPEFT-compressed
    registry = capi.registry(device=args.device)
    for i in range(args.experts):
        ft = finetune(base, 100 + i)
        ex = registry.add(capi.compress(base, ft, name=f"expert{i}",
                                        density=args.density, alpha=1.0,
                                        device=args.device))
        if i == 0:
            dense = uncompressed_baseline_bytes(ex)
            print(f"expert artifact: {ex.nbytes(PACKED):,} B packed "
                  f"({ex.nbytes(GOLOMB):,} B on the wire) vs "
                  f"{dense:,} B dense bf16 ({dense/ex.nbytes(PACKED):.1f}x)")

    engine = capi.serve(api, base, registry, max_batch=4, cache_len=64,
                        device_cache_bytes=1 << 26)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, expert=f"expert{i % args.experts}",
                    prompt=torch.as_tensor(rng.integers(1, cfg.vocab, 16)),
                    max_new_tokens=6)
            for i in range(args.requests)]

    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    print(f"served {len(reqs)} requests across {args.experts} experts "
          f"in {dt:.1f}s")
    for r in reqs[:3]:
        print(f"  req{r.uid} [{r.expert}]: {r.out_tokens}")
    s = engine.swap_summary()
    print("swap stats:", {k: v for k, v in s.items()
                          if k in ('hits', 'misses', 'promotions',
                                   'store_to_host_bytes',
                                   'host_to_device_bytes', 'n_swaps',
                                   'n_waves', 'admitted', 'stack_builds')})
    dense_equiv = uncompressed_baseline_bytes(registry.get("expert0")) * 2
    print(f"wire bytes per miss: {dense_equiv:,} dense f32 baseline vs "
          f"{s['store_to_host_bytes'] // max(s['misses'], 1):,} compressed "
          f"(experts stay packed on device: "
          f"{s['host_to_device_bytes'] // max(s['misses'], 1):,} B resident)")
    print("OK")


if __name__ == "__main__":
    main()
