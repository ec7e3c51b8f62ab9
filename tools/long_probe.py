#!/usr/bin/env python3
"""Where the time of a long prompt goes on the card.

    python3 tools/long_probe.py [--prompt 32768] [--units 2] [--seed 0]

``chip_smoke.py`` phase 3l serves one long prompt and gates its memory
and its chunking; this script measures where that prompt's time goes,
with the same request (``chip_smoke.long_request``: greedy, e0, 16 new
tokens) at qwen2.5-3b's full width and ``--units`` of depth, on one
expert compressed at density 0.1 and served on the zero-merge overlay
(``max_batch=1``, ``cache_len`` prompt + 16, ``decode_chunk=8``):

* a cold serve, then a warm one: prefill ms and decode tokens/s;
* one warm serve under ``torch.profiler`` (``chip_smoke.profile_wave``):
  device ms by kernel family, split into prefill and decode, and the
  idle share of the wall time (the profiler's own host cost inflates the
  wall time of so many small launches, so the idle share is an upper
  bound);
* one attention layer alone (bf16 q, k, v of the model's heads over the
  prompt, causal, a row mask, the model's chunks): wall ms of a warm call
  and its device ms under ``torch.profiler``, beside the bound of the
  work its tile schedule does (q k^T and P v in f32 over the kept tiles,
  q, k, v read and the output written once), and the host's time a tile
  step beyond the device's.

Prints one JSON line last and writes it to ``chiprun_out/long_probe.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def attention_layer(torch, cfg, T: int, seed: int) -> dict:
    """One attention layer over T positions alone (see the module's
    notes)."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import bound_ms, tile_steps
    from repro_torch.models import attention
    a = cfg.pattern[0].attn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 37)
    q = torch.randn((1, T, a.n_q, a.head_dim), generator=g, device=dev)
    k, v = (torch.randn((1, T, a.n_kv, a.head_dim), generator=g,
                        device=dev) for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    start = torch.zeros((1,), dtype=torch.int32, device=dev)

    def call():
        return attention.flash_attention(
            q, k, v, a, kv_start=start, chunk_q=attention.CHUNK_Q,
            chunk_k=attention.CHUNK_K)

    call()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    call()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type.name == "CUDA") / 1e3
    tiles = tile_steps(T, T)
    cq, ck = min(attention.CHUNK_Q, T), min(attention.CHUNK_K, T)
    flops = 4 * a.n_q * a.head_dim * cq * ck * tiles
    nbytes = 2 * (2 * T * a.n_q * a.head_dim + 2 * T * a.n_kv * a.head_dim)
    bound, by = bound_ms(nbytes, flops)
    return {"T": T, "wall_ms": wall_ms, "device_ms": device_ms,
            "tile_steps": tiles, "bound_ms": bound, "bound_by": by,
            "host_us_per_tile_beyond_device":
                1e3 * (wall_ms - device_ms) / tiles}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt", type=int, default=32768)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("long_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke
    from chip_smoke import finetune, fresh, gpu_line, profile_wave
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.expert import PACKED
    from repro_torch.kernels import build
    from repro_torch.models import build as build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gpu = gpu_line()
    build.build_all()
    chip_smoke.LONG_PROMPT = args.prompt
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=args.units)
    model = build_model(cfg)
    base = model.init(seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ex = api.compress(base, finetune(torch, base, gen), name="e0",
                      density=0.1, device=dev)
    ex.as_(PACKED)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=[ex])
    T = args.prompt
    engine = api.serve(model, base, reg, max_batch=1, cache_len=T + 16,
                       decode_chunk=8, continuous=False)
    req = chip_smoke.long_request(torch, cfg, args.seed)
    engine.run([req])
    warm = fresh([req], 100)
    n0 = len(engine.wave_log)
    engine.run(warm)
    torch.cuda.synchronize()
    if warm[0].out_tokens != req.out_tokens:
        print("long_probe: a warm run gave other tokens", file=sys.stderr)
        return 1
    w = engine.wave_log[n0]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof = profile_wave(torch, engine, [req], out_dir, "profile_long")
    res = {"gpu": gpu, "prompt": T, "units": args.units,
           "prefill_ms": w["prefill_s"] * 1e3,
           "decode_tokens_per_s": (w["tokens"] - w["rows"])
           / (w["seconds"] - w["prefill_s"]),
           "profile": prof,
           "attention_layer": attention_layer(torch, cfg, T, args.seed)}
    print(f"long_probe [{gpu}]: prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_tokens_per_s']:.1f} tokens/s; profiled serve: wall "
          f"{prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms; one attention layer: "
          + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in res["attention_layer"].items()))
    with open(os.path.join(out_dir, "long_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
