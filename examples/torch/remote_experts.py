"""Fetching experts over the network on the PyTorch port: the claim
ComPEFT is named for.

A publisher host compresses an expert and publishes it through a
transport backend as one checksummed wire blob; a consumer host builds an
``ExpertRegistry`` over that transport and serves the expert without ever
seeing a dense checkpoint.  The link here is simulated (configurable
bandwidth and latency), so the run is reproducible anywhere; swap in
``LocalTransport`` (shared filesystem) or ``HTTPTransport`` (any static
file server) without touching the serving code.

    PYTHONPATH=src python examples/torch/remote_experts.py [--density 0.1] \
        [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import api as capi
from repro_torch.configs import get_smoke_config
from repro_torch.expert import GOLOMB, PACKED
from repro_torch.models import build
from repro_torch.serve import Request, uncompressed_baseline_bytes
from repro_torch.transport import SimulatedNetworkTransport

from serve_experts import finetune


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--bandwidth-mbps", type=float, default=16.0,
                    help="simulated link bandwidth (megabits/s)")
    ap.add_argument("--latency-ms", type=float, default=40.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    model = build(cfg)
    base = model.init(seed=0, device=args.device)

    # ---- publisher host: compress fine-tunes, publish wire blobs --------
    transport = SimulatedNetworkTransport(
        bandwidth_bps=args.bandwidth_mbps * 1e6 / 8,
        latency_s=args.latency_ms / 1e3, seed=0)
    local_experts = []
    for i in range(2):
        ft = finetune(base, 100 + i)
        ex = capi.compress(base, ft, name=f"expert{i}",
                           density=args.density, alpha=1.0,
                           device=args.device)
        local_experts.append(ex)
        pub = capi.publish(ex, transport, rep=GOLOMB)
        dense = uncompressed_baseline_bytes(ex)
        print(f"published {pub['name']}: {pub['nbytes']:,} B on the wire "
              f"vs {dense:,} B dense bf16 ({dense / pub['nbytes']:.1f}x)")

    # ---- consumer host: a registry over the remote store ----------------
    registry = capi.registry(transport=transport, device=args.device)
    engine = capi.serve(model, base, registry, max_batch=4, cache_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, expert=f"expert{i % 2}",
                    prompt=torch.as_tensor(rng.integers(1, cfg.vocab, 12)),
                    max_new_tokens=4)
            for i in range(4)]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    print(f"served {len(reqs)} requests over the simulated link in "
          f"{dt:.1f}s; tokens: {[r.out_tokens for r in reqs]}")

    s = engine.swap_summary()
    print(f"remote fetches: {s['remote_fetches']} "
          f"({s['remote_bytes']:,} B on the wire, "
          f"{s['remote_seconds']*1e3:.0f} ms in transfer+decode, "
          f"prefetch hits: {s['prefetch_hits']})")

    # fetched experts are bit-identical to the publisher's local planes
    for ex in local_experts:
        got = registry.get(ex.name).packed
        for p, pt in ex.packed.items():
            assert torch.equal(pt.pos.cpu(), got[p].pos.cpu())
            assert torch.equal(pt.neg.cpu(), got[p].neg.cpu())
    print("fetched experts bit-identical to published ones; "
          f"wire bytes per expert: {s['remote_bytes'] // 2:,} "
          f"(packed on the device: {local_experts[0].nbytes(PACKED):,} B)")
    print("OK")


if __name__ == "__main__":
    main()
