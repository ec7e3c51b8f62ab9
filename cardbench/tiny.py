"""Smoke-size cells for the CPU tests: a temporary checkout root whose
``BENCHMARK.json``, configurations and workloads are tiny copies of the
real ones' kinds (the code stays in ``cardbench/``).  They run in
float32, so the program reads within rounding of the reference and the
limits can be tight."""

from __future__ import annotations

import json
from pathlib import Path

DENSE = {"hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "num_hidden_layers": 2, "rms_norm_eps": 1e-06,
         "rope_theta": 1000000.0, "tie_word_embeddings": True,
         "torch_dtype": "float32", "vocab_size": 512, "head_dim": 16,
         "qkv_bias": True, "port_arch": "qwen2_5_3b",
         "sliding_window": None}
MOE = dict(DENSE, tie_word_embeddings=False, qkv_bias=False,
           num_local_experts=4, num_experts_per_tok=2,
           moe_capacity_factor=1.25, sliding_window=32,
           port_arch="mixtral_8x7b", pad_token_id=1)
ENGINE = {"max_batch": 3, "max_stack": 3, "decode_chunk": 2,
          "cache_len": 64, "continuous": True, "scheduler": "fifo",
          "kv_layout": "dense"}
TRAFFIC = {"template_seed": 3, "arrivals": {"kind": "offline"},
           "experts": {"n": 3, "zipf_alpha": 1.1},
           "prompt": [{"weight": 1.0, "lo": 3, "hi": 9}],
           "output": [{"weight": 1.0, "lo": 2, "hi": 7}]}
CELLS = {
    "tiny.mixed": ("tiny", {
        "driver": "serve", "traffic": TRAFFIC, "call_size": 5,
        "experts": {"n": 3, "density": 0.1, "alpha": 1.0},
        "engine": ENGINE, "warm_rows": [3], "trace_seconds": 1,
        "check": {"requests": 3, "limits": {"gap_max": 0.001}}}),
    "tiny.open": ("tiny", {
        "driver": "serve",
        "traffic": dict(TRAFFIC, arrivals={
            "kind": "open_loop", "base_rate": 20.0, "burst_every_s": 0.4,
            "burst_duration_s": 0.1, "burst_rate_x": 4.0}),
        "experts": {"n": 3, "density": 0.1, "alpha": 1.0},
        "engine": ENGINE, "warm_rows": [1, 2, 3], "trace_seconds": 1,
        "check": {"requests": 3, "limits": {"gap_max": 0.001}}}),
    "tiny-moe.swap": ("tiny-moe", {
        "driver": "serve", "traffic": TRAFFIC, "call_size": 5,
        "experts": {"n": 3, "density": 0.1, "alpha": 1.0},
        "engine": {"max_batch": 3, "decode_chunk": 2, "cache_len": 64,
                   "scheduling": "grouped", "scheduler": "fifo"},
        "warm_rows": [1, 2, 3], "trace_seconds": 1,
        "check": {"requests": 3, "capacity_factor": 1.25,
                  "limits": {"gap_max": 0.001, "merged_off": 0}}}),
    "tiny.compress": ("tiny", {
        "driver": "compress",
        "experts": {"finetunes": 2, "density": 0.1, "alpha": 1.0},
        "trace_seconds": 1,
        "check": {"limits": {"plane_bits_off": 0, "scale_rel_err": 1e-5}}}),
}


def make_root(root: Path, cells=None) -> Path:
    """Write a checkout root holding the tiny cells (all by default)."""
    cells = cells or list(CELLS)
    (root / "cardbench" / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "cardbench" / "configs").mkdir(parents=True, exist_ok=True)
    configs = {"tiny": DENSE, "tiny-moe": MOE}
    bench = {"configs": [], "workloads": [], "per_layer": [],
             "end_to_end": [{"name": "tokens_per_s", "unit": "tokens/s",
                             "workloads": [c for c in cells
                                           if CELLS[c][1]["driver"]
                                           == "serve"]},
                            {"name": "compress_ms", "unit": "ms",
                             "workloads": [c for c in cells
                                           if CELLS[c][1]["driver"]
                                           == "compress"]},
                            {"name": "setup_s", "unit": "s"}]}
    for name, cfg in configs.items():
        f = f"cardbench/configs/{name}.json"
        (root / f).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "file": f})
    for c in cells:
        cfg, wl = CELLS[c]
        (root / "cardbench" / "workloads" / f"{c}.json").write_text(
            json.dumps(wl))
        bench["workloads"].append({"name": c, "config": cfg, "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
