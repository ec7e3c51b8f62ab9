"""Dry run sized for the H100: per-rank memory, FLOPs, collective bytes and
roofline terms of every (architecture x input shape) cell on the
production meshes, computed on the CPU without allocating a weight.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--cross-host-gbs 50]

Port of ``repro/launch/dryrun.py``'s purpose.  The reference lowers each
cell with XLA on a TPU pod and reads the compiler's memory and cost
analysis and the post-SPMD HLO's collectives; the port has no compiler to
ask, so it counts what its own step does:

* **Memory** (bytes per rank): parameters, gradients, optimizer slots,
  error feedback and the KV cache, exact from the ported rules
  (``train_state_shardings``, ``cache_shardings``; a dim that does not
  divide is rounded up); activations from the tensors one unit saves for
  its backward at the rank's local shapes
  (``torch.autograd.graph.saved_tensors_hooks`` on the meta device),
  plus each unit's input, which the checkpoint of every unit keeps (the
  step recomputes a unit in its backward); a prefill holds one unit's
  saved set at most, and a decode or prefill cell gathers one unit's
  weights whole ("gathered_unit").  "fits" compares the sum with 80 GB.
* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over one
  unit at local shapes (forward and backward for training, plus the
  recomputed forward), times the units, plus the head.  A cell of a
  family with recurrent blocks above 4096 tokens counts one unit at 2048
  and 4096 tokens and fits a * T + b * T**2 (the scans are linear, the
  global attention quadratic), since the scans' chunk loops are slow to
  trace on the meta device.
* **Collective bytes** (received per rank and step) by kind, from the
  rules and the step's algorithm: FSDP gathers (forward and recompute),
  the gradients' data sums (a reduce-scatter by ``all_to_all``: a rank
  receives the other D - 1 ranks' copies of its block, (D - 1) / D of
  the leaf as the unit uses it; a leaf not cut over "data" is
  all-reduced, a reduce-scatter and an all-gather: 2 (D - 1) / D of it),
  tensor-parallel sums (six per unit and microbatch: two in the forward,
  two in the recompute, two in the backward; each an all-reduce in rank
  order, 2 (M - 1) / M of the activation), the vocab-parallel lookup,
  head and
  loss, the sequence-parallel combine of decode, and the cross-pod
  planes at 2 bits a parameter.  A decode or prefill cell gathers each
  unit's weights whole, as the port's sequence-parallel decode runs
  them.
* **Roofline terms** at the H100's 989 TFLOP/s bf16 dense, 3.35 TB/s HBM
  and 450 GB/s each way over NVLink ("model" lies inside one 8-card
  host); the rate across hosts (the "data" and "pod" collectives) is a
  named argument with no default, and its term is null without it.  The
  HBM term counts each unit's weights once per pass, the optimizer's
  state read and written once, the activations written and read once and
  the KV cache read once a decode step: an estimate.

Nothing here is measured; every number is computed.  Results go to
``dryrun_out/<mesh>/<arch>__<shape>.json`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.registry import normalize
from repro_torch.core.gradient_compression import GradCompressionConfig
from repro_torch.distributed.sharding import (_axes_of, cache_shardings,
                                              decode_layout, param_shardings,
                                              train_state_shardings)
from repro_torch.train.train_step import TrainConfig, init_train_state
from repro_torch.train.within_pod import AxisSizes, tensor_parallel_family

# ---------------------------------------------------------------------------
# Cell table (the reference's)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k runs only for sub-quadratic-memory archs
LONG_OK = {"rwkv6_3b", "jamba_1_5_large_398b", "mixtral_8x7b", "gemma2_9b"}

BIG_PARAM_THRESHOLD = 50e9   # adafactor + bf16 EF above this

# the H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3
# rate, NVLink 4 rate each way, device memory
H100 = {"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12,
        "nvlink_bytes_s": 450e9, "hbm_bytes": 80e9}

# the production meshes: "model" inside one 8-card NVLink host, the same
# card counts as the reference's (16, 16) and (2, 16, 16) pods
MESH_SINGLE = {"data": 32, "model": 8}
MESH_MULTI = {"pod": 2, "data": 32, "model": 8}

SCAN_FIT_T = (2048, 4096)


def cell_list(include_paper_arch: bool = False):
    archs = [a for a in ARCHS if include_paper_arch or a != "llama_7b"]
    cells = []
    for a in archs:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            cells.append((a, s))
    return cells


def _train_cfg_for(cfg, shape, multi_pod: bool = False) -> TrainConfig:
    big = cfg.param_count() > BIG_PARAM_THRESHOLD
    gb = SHAPES[shape]["global_batch"]
    # microbatch size chosen per pod, as in the reference
    per_pod = gb // (2 if multi_pod else 1)
    micro = max(1, per_pod // (16 if big else 32))
    return TrainConfig(
        microbatches=micro,
        optimizer="adafactor" if big else "adamw",
        grad_compression=GradCompressionConfig(enabled=True, density=0.05),
    )


# ---------------------------------------------------------------------------
# Bytes of blocks
# ---------------------------------------------------------------------------


def _blocks(entry, sizes) -> int:
    n = 1
    for a in _axes_of(entry):
        n *= sizes.get(a, 1)
    return n


def local_shape(shape, spec, sizes) -> tuple:
    """A rank's block shape of a leaf (a dim that does not divide rounds
    up, as a padded partition would)."""
    return tuple(-(-d // _blocks(e, sizes)) for d, e in zip(shape, spec))


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def state_bytes(tree, specs, sizes) -> dict:
    """{"rank": bytes of one rank's blocks, "logical": bytes of the
    logical tree, "blocks": the sum over each leaf's distinct blocks
    (the logical bytes when every cut divides)}."""
    flat = dict(tree_util.flatten_with_paths(specs))
    out = {"rank": 0, "logical": 0, "blocks": 0}
    for path, leaf in tree_util.flatten_with_paths(tree):
        spec, shape = flat[path], tuple(leaf.shape)
        loc = _nbytes(local_shape(shape, spec, sizes), leaf.dtype)
        out["rank"] += loc
        out["logical"] += _nbytes(shape, leaf.dtype)
        out["blocks"] += loc * math.prod(_blocks(e, sizes) for e in spec)
    return out


# ---------------------------------------------------------------------------
# One unit on the meta device
# ---------------------------------------------------------------------------


def _used_shape(shape, spec, sizes, tp: bool) -> tuple:
    """A leaf's shape as a unit uses it: "data" dims gathered, "model"
    dims kept cut under tensor parallelism, else gathered too."""
    return tuple(-(-d // sizes["model"]) if tp and "model" in _axes_of(e)
                 else d for d, e in zip(shape, spec))


def _unit_tree(params, specs, stack, sizes, tp):
    """One unit's leaves at the shapes the unit uses, on the meta
    device, each requiring grad."""
    flat = dict(tree_util.flatten_with_paths(specs))
    out = {}
    for path, leaf in tree_util.flatten_with_paths(params[stack]):
        shape = _used_shape(tuple(leaf.shape)[1:],
                            flat[f"{stack}/{path}"][1:], sizes, tp)
        t = torch.zeros(shape, dtype=leaf.dtype, device="meta")
        out[path] = t.requires_grad_(t.is_floating_point())
    return tree_util.unflatten_paths(out)


def _unit_cost(cfg, params, specs, sizes, tp, stack, pattern, rows, T,
               train: bool, enc_len: int = 0) -> dict:
    """FLOPs (forward; forward + backward) and saved bytes of one unit
    over [rows, T] at local shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import transformer as tf
    unit = _unit_tree(params, specs, stack, sizes, tp)
    leaves = [t for t in tree_util.leaves(unit) if t.requires_grad]
    ids = {id(t) for t in leaves}
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = torch.zeros((rows, T, cfg.d_model), dtype=dt, device="meta",
                    requires_grad=train)
    enc = (torch.zeros((rows, enc_len, cfg.d_model), dtype=dt,
                       device="meta") if enc_len else None)
    saved = [0]

    def pack(t):
        base = t._base if t._base is not None else t
        if id(base) not in ids and id(t) not in ids:
            saved[0] += t.numel() * t.element_size()
        return t

    pos = torch.arange(T, device="meta")[None]
    with FlopCounterMode(display=False) as fc:
        # grad mode in a prefill too: what the unit saves bounds the
        # working set a forward holds at once
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _ = tf._train_unit(x, unit, cfg, pattern, pos, enc)
        fwd = fc.get_total_flops()
        if train:
            torch.autograd.grad(y.float().sum(), [x] + leaves,
                                allow_unused=True)
    return {"fwd": fwd, "fwd_bwd": fc.get_total_flops(), "saved": saved[0]}


def _unit_cost_fit(cfg, params, specs, sizes, tp, stack, pattern, rows, T,
                   train, enc_len=0) -> dict:
    """:func:`_unit_cost`, fitted in T for a recurrent family above the
    fit's longest length (see the module's notes)."""
    recurrent = any(b.kind in ("mamba", "rwkv") for b in pattern)
    if not recurrent or T <= SCAN_FIT_T[1]:
        return _unit_cost(cfg, params, specs, sizes, tp, stack, pattern,
                          rows, T, train, enc_len)
    (t1, t2) = SCAN_FIT_T
    c1 = _unit_cost(cfg, params, specs, sizes, tp, stack, pattern, rows,
                    t1, train, enc_len)
    c2 = _unit_cost(cfg, params, specs, sizes, tp, stack, pattern, rows,
                    t2, train, enc_len)
    out = {}
    for k in c1:
        # v(T) = a T + b T^2 through both points
        b = (c2[k] / t2 - c1[k] / t1) / (t2 - t1)
        a = c1[k] / t1 - b * t1
        out[k] = int(round(a * T + b * T * T))
    out["fitted"] = True
    return out


def _decode_unit_cost(cfg, cache, cspecs, sizes, rows, pattern) -> dict:
    """FLOPs of one unit's one-token step over the rank's cache slices
    (weights whole, as the sequence-parallel decode runs them)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, device="meta")
    unit = tf._unit(params["blocks"], 0)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    flat = dict(tree_util.flatten_with_paths(cspecs))
    x = torch.zeros((rows, 1, cfg.d_model), dtype=dt, device="meta")
    cur = torch.zeros((), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        for i, b in enumerate(pattern):
            name = f"block{i}"
            st = {}
            for k, t in cache["layers"][name].items():
                # the ring's slice; a recurrent state whole (its
                # sequence-parallel decode keeps it so), the rank's rows
                shape = (local_shape(tuple(t.shape), flat[
                    f"layers/{name}/{k}"], sizes) if k in ("k", "v", "pos")
                    else tuple(t.shape))
                shape = shape[:1] + (rows,) + shape[2:] if t.dim() > 2 \
                    else shape
                st[k] = torch.zeros(shape[1:], dtype=t.dtype, device="meta")
            cross = None
            if "cross" in cache and b.kind == "attn":
                ck = cache["cross"]["k"]
                cross = tuple(torch.zeros((rows,) + tuple(ck.shape[2:]),
                                          dtype=ck.dtype, device="meta")
                              for _ in range(2))
            x = tf._decode_block(x, unit[name], b, cfg, st, cur, {}, None,
                                 None, cross=cross)
    return {"fwd": fc.get_total_flops()}


def _head_flops(cfg, rows, T, v_local, train: bool) -> int:
    """The head matmul (and its backward) at the rank's vocab slice."""
    f = 2 * rows * T * cfg.d_model * v_local
    return 3 * f if train else f


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def _leaf_gather_bytes(leaf, spec, sizes, gather_model: bool) -> dict:
    """Bytes one rank receives to gather one use of a leaf: its "model"
    blocks over NVLink (when gathered), then its "data" blocks across
    hosts."""
    loc = _nbytes(local_shape(tuple(leaf.shape), spec, sizes), leaf.dtype)
    mb = math.prod(sizes["model"] for e in spec if "model" in _axes_of(e))
    db = math.prod(sizes["data"] for e in spec if "data" in _axes_of(e))
    out = {"model": 0, "data": 0}
    if gather_model:
        out["model"] = loc * (mb - 1)
        loc *= mb
    out["data"] = loc * (db - 1)
    return out


def _grad_sum_bytes(used: int, spec, sizes) -> int:
    """Bytes one rank receives to sum a used leaf's gradient over the
    data ranks: the other ranks' copies of its block when the leaf is cut
    over "data" (a reduce-scatter), else twice that (a reduce-scatter
    of the flattened leaf and an all-gather of the sums)."""
    D = sizes.get("data", 1)
    cut = any("data" in (e if isinstance(e, tuple) else (e,))
              for e in spec)
    return used * (D - 1) // D if cut else 2 * used * (D - 1) // D


def dry_cell(arch: str, shape: str, multi_pod: bool = False,
             cross_host_bytes_s: Optional[float] = None) -> dict:
    """Every number of one cell, per rank (see the module's notes)."""
    from repro_torch.models import transformer as tf
    arch = normalize(arch)
    cfg = get_config(arch)
    sizes = dict(MESH_MULTI if multi_pod else MESH_SINGLE)
    mesh = AxisSizes(sizes)
    n_ranks = math.prod(sizes.values())
    sh = SHAPES[shape]
    kind, T, B = sh["kind"], sh["seq_len"], sh["global_batch"]
    params = tf.init_params(cfg, device="meta")
    pspecs = param_shardings(params, cfg, mesh)
    flat_specs = dict(tree_util.flatten_with_paths(pspecs))
    tp = sizes["model"] > 1 and tensor_parallel_family(cfg)
    dp = sizes.get("pod", 1) * sizes["data"]
    mem: dict = {}
    colls = {"fsdp_gather": 0, "fsdp_gather_model": 0, "grad_data_sum": 0,
             "tp_sum": 0, "vocab": 0, "sp_combine": 0, "pod_planes": 0}
    cross_host = nvlink = 0
    flops = 0
    notes = []
    act_dt = 2 if cfg.dtype == "bfloat16" else 4
    v_local = cfg.vocab // sizes["model"] if tp and \
        "model" in flat_specs["embed"] else cfg.vocab
    enc_len = cfg.frontend.n_tokens if cfg.enc_n_units else 0
    text_T = T
    if cfg.frontend is not None:
        n_mod = min(cfg.frontend.n_tokens, T // 2)
        text_T = T - n_mod
        if cfg.enc_n_units:
            enc_len = n_mod
    dec_T = text_T if cfg.enc_n_units else T
    stacks = [("blocks", cfg.pattern, cfg.n_units, enc_len)]
    if cfg.enc_n_units:
        stacks.append(("enc_blocks", cfg.enc_pattern, cfg.enc_n_units, 0))

    if kind in ("train", "prefill"):
        train = kind == "train"
        if train:
            tcfg = _train_cfg_for(cfg, shape, multi_pod)
            state = init_train_state(params, tcfg, multi_pod=multi_pod)
            sspecs = train_state_shardings(state, cfg, mesh)
            parts = {k: state_bytes(state[k], sspecs[k], sizes)
                     for k in state if k != "step"}
            mem["params"] = parts["params"]["rank"]
            mem["optimizer"] = parts["opt"]["rank"]
            mem["ef"] = parts.get("ef", {"rank": 0})["rank"]
            micro = tcfg.microbatches
            # microbatches accumulate the gradients in f32
            mem["grads"] = (_n_local(params, flat_specs, sizes) * 4
                            if micro > 1 else mem["params"])
            mem["logical_state"] = sum(p["logical"] for p in parts.values())
            mem["state_blocks"] = sum(p["blocks"] for p in parts.values())
        else:
            micro = 1
            pb = state_bytes(params, pspecs, sizes)
            cache = tf.init_decode_cache(cfg, B, T, device="meta")
            kb = state_bytes(cache, cache_shardings(cache, mesh, B), sizes)
            mem.update(params=pb["rank"], kv_cache=kb["rank"],
                       logical_state=pb["logical"] + kb["logical"],
                       state_blocks=pb["blocks"] + kb["blocks"])
        mb_rows = B // (micro * (2 if multi_pod else 1)) if train else B
        data_ranks = sizes["data"] if train else dp
        rows = -(-mb_rows // data_ranks)
        if mb_rows % data_ranks:
            notes.append(f"a microbatch of {mb_rows} rows does not divide "
                         f"over {data_ranks} data ranks: {rows} a rank")
        unit_saved, x_bytes, used_total = 0, 0, 0
        for stack, pattern, n_units, enc in stacks:
            Tn = enc_len if stack == "enc_blocks" else dec_T
            c = _unit_cost_fit(cfg, params, pspecs, sizes, tp, stack,
                               pattern, rows, Tn, train, enc)
            if c.get("fitted"):
                notes.append(f"{stack}: FLOPs and saved bytes fitted in T")
            per = c["fwd_bwd"] + (c["fwd"] if train else 0)
            flops += per * n_units * micro
            unit_saved = max(unit_saved, c["saved"])
            x_bytes += rows * Tn * cfg.d_model * act_dt * n_units
            # collectives of the unit's leaves
            for path, leaf in tree_util.flatten_with_paths(params[stack]):
                spec = flat_specs[f"{stack}/{path}"]
                one = leaf[0]
                gb = _leaf_gather_bytes(one, spec[1:], sizes, not tp)
                passes = 2 if train else 1
                colls["fsdp_gather"] += gb["data"] * passes * n_units * micro
                colls["fsdp_gather_model"] += (gb["model"] * passes
                                               * n_units * micro)
                used = _nbytes(_used_shape(tuple(one.shape), spec[1:],
                                           sizes, tp), one.dtype)
                used_total += used * n_units
                if train:
                    colls["grad_data_sum"] += (_grad_sum_bytes(
                        used, spec[1:], sizes) * n_units * micro)
            if tp:
                act = rows * Tn * cfg.d_model * act_dt
                sums = (6 if train else 2) * len(pattern)
                M = sizes["model"]
                colls["tp_sum"] += 2 * act * (M - 1) // M * sums \
                    * n_units * micro
        flops += _head_flops(cfg, rows, text_T, v_local, train) * micro
        for k in ("embed", "lm_head", "final_norm", "frontend_proj",
                  "enc_final_norm"):
            if k in params:
                gb = _leaf_gather_bytes(params[k], flat_specs[k], sizes,
                                        not tp)
                colls["fsdp_gather"] += gb["data"] * micro
                colls["fsdp_gather_model"] += gb["model"] * micro
                used = _nbytes(_used_shape(tuple(params[k].shape),
                                           flat_specs[k], sizes, tp),
                               params[k].dtype)
                used_total += used
                if train:
                    colls["grad_data_sum"] += _grad_sum_bytes(
                        used, flat_specs[k], sizes) * micro
        if tp and v_local != cfg.vocab:
            # the lookup gathers the rows' embeddings; in training the
            # head's input gradient is summed, and the loss gathers the
            # rows' maxima and sums their exps and target logits
            M = sizes["model"]
            xb = rows * T * cfg.d_model * act_dt
            yb = rows * text_T * 4
            colls["vocab"] += micro * ((M - 1) * xb + (
                2 * (M - 1) * (xb + 2 * yb) // M + (M - 1) * yb
                if train else 0))
        mem["gathered_unit"] = used_total // max(
            sum(n for _, _, n, _ in stacks), 1)
        mem["activations"] = (x_bytes + unit_saved
                              + rows * text_T * v_local * 4 * 2
                              if train else unit_saved)
        if train and multi_pod:
            n_loc = _n_local(params, flat_specs, sizes)
            n_leaves = len(flat_specs)
            colls["pod_planes"] = (n_loc * 2 // 8 + 4 * n_leaves) * (
                sizes["pod"] - 1)
        # weights read in the forward, the recompute and the backward
        hbm = (used_total * (3 if train else 1) * micro
               + 2 * (mem.get("optimizer", 0) + mem.get("grads", 0)
                      + mem.get("ef", 0))
               + 2 * mem["activations"] + mem.get("kv_cache", 0))
    else:   # decode: one token for every row against a seq_len cache
        baxes, seq_axes = decode_layout(mesh, B)
        rows = B // dp if baxes is not None else B
        cache = tf.init_decode_cache(cfg, B, T, device="meta")
        cspecs = cache_shardings(cache, mesh, B)
        pb = state_bytes(params, pspecs, sizes)
        kb = state_bytes(cache, cspecs, sizes)
        mem.update(params=pb["rank"], kv_cache=kb["rank"],
                   logical_state=pb["logical"] + kb["logical"],
                   state_blocks=pb["blocks"] + kb["blocks"])
        # one unit's weights gathered whole while it runs
        mem["gathered_unit"] = sum(
            _nbytes(tuple(leaf.shape)[1:], leaf.dtype)
            for stack, *_ in stacks
            for leaf in tree_util.leaves(params[stack]))
        c = _decode_unit_cost(cfg, cache, cspecs, sizes, rows, cfg.pattern)
        flops = c["fwd"] * cfg.n_units + _head_flops(cfg, rows, 1,
                                                     cfg.vocab, False)
        for path, leaf in tree_util.flatten_with_paths(params):
            gb = _leaf_gather_bytes(leaf, flat_specs[path], sizes, True)
            colls["fsdp_gather"] += gb["data"]
            colls["fsdp_gather_model"] += gb["model"]
        n_seq = math.prod(sizes[a] for a in seq_axes)
        n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_units
        a = next((b.attn for b in cfg.pattern if b.kind == "attn"), None)
        if a is not None and n_seq > 1:
            colls["sp_combine"] = (n_seq - 1) * rows * a.n_q * (
                a.head_dim + 2) * 4 * n_attn
        if any(x in seq_axes for x in ("data", "pod")):
            notes.append("the sequence is cut over every axis: the "
                         "combine crosses hosts")
        mem["activations"] = 0
        hbm = pb["logical"] + mem["kv_cache"]
    for k in ("fsdp_gather", "grad_data_sum", "pod_planes"):
        cross_host += colls[k]
    nvlink = colls["fsdp_gather_model"] + colls["tp_sum"] + colls["vocab"]
    if kind == "decode":
        seq_cross = any(x in decode_layout(mesh, B)[1] for x in ("data",
                                                               "pod"))
        if seq_cross:
            cross_host += colls["sp_combine"]
        else:
            nvlink += colls["sp_combine"]
    total = sum(v for k, v in mem.items()
                if k not in ("logical_state", "state_blocks"))
    terms = {"compute_s": flops / H100["bf16_flops_s"],
             "hbm_s": hbm / H100["hbm_bytes_s"],
             "nvlink_s": nvlink / H100["nvlink_bytes_s"],
             "cross_host_s": (cross_host / cross_host_bytes_s
                              if cross_host_bytes_s else None)}
    return {"arch": arch, "shape": shape, "kind": kind,
            "mesh": "pod2x32x8" if multi_pod else "32x8",
            "n_ranks": n_ranks, "seq_len": T, "global_batch": B,
            "rows_per_rank": rows, "tensor_parallel": tp,
            "memory_bytes": dict(mem, total=total),
            "fits": total <= H100["hbm_bytes"],
            "flops": flops, "hbm_bytes": hbm,
            "collective_bytes": dict(colls, nvlink=nvlink,
                                     cross_host=cross_host),
            "roofline_s": terms,
            "bound_by": max((k for k, v in terms.items() if v is not None),
                            key=lambda k: terms[k]),
            "hardware": dict(H100, cross_host_bytes_s=cross_host_bytes_s),
            "param_count": cfg.param_count(),
            "notes": notes}


def _n_local(params, flat_specs, sizes) -> int:
    """Elements of one rank's blocks of every parameter."""
    return sum(math.prod(local_shape(tuple(leaf.shape), flat_specs[p],
                                     sizes))
               for p, leaf in tree_util.flatten_with_paths(params))


def result_path(arch: str, shape: str, multi_pod: bool, out_dir: str) -> str:
    d = os.path.join(out_dir, "pod2x32x8" if multi_pod else "32x8")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{normalize(arch)}__{shape}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cross-host-gbs", type=float, default=None,
                    help="the rate between hosts, GB/s each way (no "
                    "default: the cross-host term is null without it)")
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)
    if args.all:
        cells = cell_list()
    elif args.arch and args.shape:
        cells = [(normalize(args.arch), args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    rate = args.cross_host_gbs * 1e9 if args.cross_host_gbs else None
    for arch, shape in cells:
        res = dry_cell(arch, shape, args.multi_pod, rate)
        with open(result_path(arch, shape, args.multi_pod, args.out),
                  "w") as f:
            json.dump(res, f, indent=1)
        m = res["memory_bytes"]
        print(f"[dryrun] {arch} {shape} {res['mesh']}: "
              f"{m['total'] / 1e9:.2f} GB a rank "
              f"({'fits' if res['fits'] else 'does not fit'}), "
              f"{res['flops']:.3e} FLOPs, "
              f"{res['collective_bytes']['nvlink'] / 1e9:.3f} GB NVLink, "
              f"{res['collective_bytes']['cross_host'] / 1e9:.3f} GB "
              f"across hosts, bound by {res['bound_by']}", flush=True)
    print(f"[dryrun] {len(cells)} cells written under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
