#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--units 4] [--seed 0]

At the full width of qwen2.5-3b (d_model 2048, 16 q / 2 kv heads of 128,
QKV bias, swiglu d_ff 11008, vocab 151936, tied embeddings, rope theta
1e6, bf16 base) with the depth cut to ``--units`` (default 4 of 36) and
random weights from ``--seed``, it runs, in order, stopping at the first
failure with a non-zero exit:

  1. require CUDA; print the card's name and power limit; build the three
     kernels (one nvcc per source, in parallel) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (grouped matmul: row independence too);
  3. the main path, with every launch count set to 0 just before it and
     read just after: compress 4 experts (base + seeded noise on every
     leaf, density 0.1) through ``api.compress(...).as_(PACKED)``, then
     serve 8 greedy requests over them and ``BASE`` in FIFO mixed waves
     (``api.serve(max_batch=4, cache_len=128, decode_chunk=8)``);
  4. check the result: tokens in range; one expert's planes bitwise equal
     to the plain compression of its tau; every row's tokens bitwise
     unchanged when the other rows of its wave carry other experts; every
     request's tokens equal to the same request served alone, or parting
     from them first where the two candidates lie within about one bf16
     ulp of the top logit (alone, a row has no padding and other batch
     shapes, so its bf16 logits are not bitwise the wave row's); the first
     decode step's logits through the kernels within about one bf16 ulp
     of each logit's value from the plain versions;
  5. time the kernels and a warm re-run (which must repeat its tokens),
     profile one wave with ``torch.profiler``, and print the ``kernels``
     JSON line and the end-to-end numbers, each tagged with the card's
     name and power limit.

The last line of standard output is ``{"ok": true, "device": ...}``; a
run that fails prints no such line.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and f32 rate
# outside the tensor cores; the kernels below do f32 arithmetic on CUDA
# cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rand_planes(torch, shape, gen, dev):
    """Disjoint random pos/neg int32 planes with about 6% of bits set each
    (the density-0.1 experts of the main path have 5%)."""
    def sparse():
        w = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                          generator=gen, device=dev)
        for _ in range(3):
            w &= torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                               generator=gen, device=dev)
        return w
    pos = sparse()
    return pos, sparse() & ~pos


def check_grouped_matmul(torch, cfg, gen, dev, report):
    """Kernel vs plain at the wq, wg, ffn-wo and tied-head shapes for
    M in {1, 4, 256}, E = 4 with a zero (BASE) slot and -1 rows; every
    launch has rows on experts with a nonzero scale.

    Tolerance: the kernel sums K terms in order, the plain version through
    cuBLAS f32 (TF32 off); both are f32, so |kernel - plain| <= 1e-4 *
    max |plain| per launch.  Row independence: every row of the M = 1 and
    M = 4 launches, and 8 rows of each M = 256 launch, equal bitwise the
    same row launched alone."""
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_grouped, ternary_matmul_grouped_plain)
    a, d = cfg.pattern[0].attn, cfg.d_model
    f, V = cfg.pattern[0].ffn.d_ff, cfg.vocab
    shapes = {"wq": (d, a.n_q * a.head_dim, False),
              "wg": (d, f, False), "ffn_wo": (f, d, False),
              "tied_head": (d, V, True)}
    E = 4
    worst = 0.0
    for i, (name, (K, N, tr)) in enumerate(shapes.items()):
        if tr:
            pos, neg = rand_planes(torch, (E, N, -(-K // 32)), gen, dev)
        else:
            pos, neg = rand_planes(torch, (E, K, N // 32), gen, dev)
        pos[0] = 0
        neg[0] = 0
        scales = torch.tensor([0.0, 0.013, 0.021, 0.008], device=dev)
        for M in (1, 4, 256):
            x = torch.randn((M, K), generator=gen, device=dev)
            eid = torch.randint(-1, E, (M,), generator=gen, device=dev,
                                dtype=torch.int32)
            # the first rows cover -1, BASE and two experts at every M;
            # the single row of M = 1 carries an expert
            lead = [-1, 0, 1 + i % 3, 1 + (i + 1) % 3] if M > 1 else [
                1 + i % 3]
            eid[:len(lead)] = torch.tensor(lead, dtype=torch.int32)
            got = ternary_matmul_grouped(x, pos, neg, scales, eid,
                                         transpose_rhs=tr)
            want = ternary_matmul_grouped_plain(x, pos, neg, scales, eid,
                                                transpose_rhs=tr)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max()) + 1e-30
            check(err <= tol, f"grouped {name} M={M}: err {err} > tol {tol}")
            check(bool((got[eid < 0] == 0).all()),
                  f"grouped {name} M={M}: -1 rows not zero")
            rows = range(M) if M <= 4 else list(range(4)) + [
                int(r) for r in torch.randint(4, M, (4,), generator=gen,
                                              device=dev)]
            for m in rows:
                alone = ternary_matmul_grouped(x[m:m + 1], pos, neg, scales,
                                               eid[m:m + 1], transpose_rhs=tr)
                check(torch.equal(alone[0], got[m]),
                      f"grouped {name} M={M}: row {m} differs alone")
            worst = max(worst, err)
            log(f"  grouped {name:9s} M={M:3d}: max|err| {err:.3e} "
                f"(tol {tol:.3e}), rows alone bitwise equal")
    report["ternary_matmul_grouped"] = {"max_abs_err": worst}


def check_compression_kernels(torch, tau, dev, report):
    """Histogram (coarse sweep) and pack over one expert's full segment
    buffer: counts and planes bitwise equal; moments within a relative
    1e-4 (both sum in f32, in different orders)."""
    from repro_torch import tree as tree_util
    from repro_torch.core.compeft import STREAM_COLS, _build_segment_buffer
    from repro_torch.kernels import histogram_quantile as hq
    from repro_torch.kernels.pack import (pack_ternary_planes_segmented,
                                          pack_ternary_planes_segmented_plain)
    leaves = tree_util.leaves(tau)
    buf, row_seg, row_valid, seg_count, _ = _build_segment_buffer(
        leaves, STREAM_COLS, dev)
    S = len(leaves)
    smax = hq._segment_absmax(buf, row_seg, row_valid, n_seg=S)
    lo = torch.zeros_like(smax)
    got = hq.segment_hist_moments(buf, row_seg, row_valid, lo, smax, n_seg=S)
    want = hq.segment_hist_moments_plain(buf, row_seg, row_valid, lo, smax,
                                         n_seg=S)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), "histogram counts differ")
    mom_err = mom_rel = 0.0
    for g, w, name in zip(got[1:], want[1:], ("sum", "sumsq", "max",
                                              "sum_abs")):
        rel = float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
        tol = 1e-4 if name in ("sumsq", "max", "sum_abs") else None
        if name == "sum":    # a signed sum near 0: relative to sum |x|
            rel = float(((g - w).abs() / want[4].clamp_min(1e-30)).max())
            tol = 1e-4
        check(rel <= tol, f"histogram {name}: rel err {rel} > {tol}")
        mom_err = max(mom_err, float((g - w).abs().max()))
        mom_rel = max(mom_rel, rel)
    stats = hq.segmented_quantile_moments(buf, row_seg, row_valid, seg_count,
                                          0.1, n_seg=S)
    thr = stats["threshold"][row_seg.to(torch.int64)].contiguous()
    p_got = pack_ternary_planes_segmented(buf, thr)
    p_want = pack_ternary_planes_segmented_plain(buf, thr)
    check(torch.equal(p_got[0], p_want[0]) and torch.equal(p_got[1],
                                                           p_want[1]),
          "pack planes differ")
    log(f"  histogram over [{buf.shape[0]}, {buf.shape[1]}]: counts bitwise "
        f"equal, moments max|err| {mom_err:.3e} (max rel {mom_rel:.2e})")
    log(f"  pack over [{buf.shape[0]}, {buf.shape[1]}]: planes bitwise equal")
    report["segment_hist_moments"] = {"max_abs_err": mom_err,
                                      "moments_max_rel_err": mom_rel}
    report["pack_ternary_planes_segmented"] = {"max_abs_err": 0.0}

    # times at these shapes
    R, C = buf.shape
    t = cuda_ms(torch, lambda: hq.segment_hist_moments(
        buf, row_seg, row_valid, lo, smax, n_seg=S), 10)
    tp = cuda_ms(torch, lambda: hq.segment_hist_moments_plain(
        buf, row_seg, row_valid, lo, smax, n_seg=S), 3)
    nb = R * C * 4 + R * 8 + S * 8 + S * hq.NBINS * 4 + S * 16
    b, by = bound_ms(nb, 6 * float(seg_count.sum()))
    report["segment_hist_moments"].update(
        ms=t, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
        shape=f"buf [{R}, {C}], {S} segments, 2048 bins, coarse sweep")
    t = cuda_ms(torch, lambda: pack_ternary_planes_segmented(buf, thr), 10)
    tp = cuda_ms(torch, lambda: pack_ternary_planes_segmented_plain(
        buf, thr), 3)
    b, by = bound_ms(R * C * 4 + R * 4 + 2 * R * C // 8, 3.0 * R * C)
    report["pack_ternary_planes_segmented"].update(
        ms=t, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
        shape=f"tau [{R}, {C}]")


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def finetune(torch, base, gen, scale=0.01):
    """base + seeded noise on every leaf, made on the card."""
    from repro_torch import tree as tree_util
    return tree_util.tree_map(
        lambda l: (l.float() + scale * torch.randn(
            l.shape, generator=gen, device=l.device)).to(l.dtype), base)


def make_requests(torch, cfg, seed):
    from repro_torch.serve import BASE, Request
    g = torch.Generator().manual_seed(seed + 7)
    names = ["e0", "e1", "e2", "e3", "e0", BASE, "e2", "e3"]
    out = []
    for i, name in enumerate(names):
        L = int(torch.randint(16, 65, (1,), generator=g))
        prompt = torch.randint(2, cfg.vocab, (L,), generator=g)
        out.append(Request(uid=i, expert=name, prompt=prompt,
                           max_new_tokens=16))
    return out


def grouped_timing(torch, engine, wave, report):
    """Time the grouped kernel at the largest launch of the main path: the
    tied head in its transposed form over the wave's embedding planes."""
    from repro_torch.kernels.ref import dense_of_planes
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_grouped, ternary_matmul_grouped_plain)
    experts = list(dict.fromkeys(r.expert for r in wave))
    ov = engine._overlay_for(tuple(experts))
    ed = ov["embed"]
    eid = torch.as_tensor([experts.index(r.expert) for r in wave],
                          dtype=torch.int32, device=ed.pos.device)
    M, (E, N, W) = len(wave), ed.pos.shape
    K = engine.api.cfg.d_model
    g = torch.Generator(device=ed.pos.device).manual_seed(3)
    x = torch.randn((M, K), generator=g, device=ed.pos.device)
    run = lambda: ternary_matmul_grouped(x, ed.pos, ed.neg, ed.scales,  # noqa
                                         eid, transpose_rhs=True)
    plain = lambda: ternary_matmul_grouped_plain(  # noqa: E731
        x, ed.pos, ed.neg, ed.scales, eid, transpose_rhs=True)
    t = cuda_ms(torch, run, 20)
    tp = cuda_ms(torch, plain, 3)
    # data-dependent work: one add per nonzero weight of each row's expert
    nnz = [float(dense_of_planes(ed.pos[e], ed.neg[e], K).abs().sum())
           for e in range(E)]
    used = sorted({int(e) for e in eid.tolist() if e >= 0})
    ops = sum(2 * nnz[int(e)] for e in eid.tolist() if e >= 0)
    nbytes = M * K * 4 + len(used) * 2 * N * W * 4 + E * 4 + M * 4 + M * N * 4
    b, by = bound_ms(nbytes, ops)
    report["ternary_matmul_grouped"].update(
        ms=t, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
        shape=f"tied head, transpose_rhs: x [{M}, {K}], planes "
              f"[{E}, {N}, {W}], {len(used)} distinct experts")


def row_independence_check(torch, engine, wave):
    """The mixed-wave contract at fixed shapes: serve the wave again with
    every other row on BASE; each row's tokens must be bitwise unchanged
    (same batch, same padding, so every op runs at the same shape)."""
    from repro_torch.serve import BASE, Request
    for j, r in enumerate(wave):
        variant = [Request(uid=1000 + 10 * r.uid + i,
                           expert=q.expert if i == j else BASE,
                           prompt=q.prompt, max_new_tokens=q.max_new_tokens)
                   for i, q in enumerate(wave)]
        engine.run(variant)
        check(variant[j].out_tokens == r.out_tokens,
              f"request {r.uid}: tokens depend on the other rows' experts: "
              f"{r.out_tokens} vs {variant[j].out_tokens}")


def solo_check(torch, engine, reqs):
    """Each request served alone vs in its mixed wave.

    Alone, a request has no left padding (other rope positions), other
    batch shapes (other cuBLAS and reduction configurations) and other
    attention lengths, so its bf16 logits are not bitwise those of its
    wave row.  The gate: the tokens are equal, or the first token that
    differs is a near-tie in the solo context -- both candidates within
    about one bf16 ulp of the top logit's own value (2**-7 * |top|, one
    ulp at least and under two), recomputed by a prefill over the prompt
    and the solo tokens before the divergence.  The primary gate of the
    mixed-wave contract is :func:`row_independence_check`, which is
    bitwise.
    """
    from repro_torch.serve import Request
    out = {"exact": 0, "near_tie": []}
    for r in reqs:
        solo = Request(uid=100 + r.uid, expert=r.expert, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
        engine.run([solo])
        if solo.out_tokens == r.out_tokens:
            out["exact"] += 1
            continue
        s = next(i for i, (a, b) in enumerate(zip(solo.out_tokens,
                                                  r.out_tokens)) if a != b)
        ctx = torch.cat([torch.as_tensor(r.prompt, dtype=torch.int64),
                         torch.as_tensor(solo.out_tokens[:s],
                                         dtype=torch.int64)])
        ov = engine._overlay_for((r.expert,))
        logits, _ = engine.api.prefill(
            engine.base, {"tokens": ctx[None].to(engine.dev)}, 128,
            delta=ov, eid=torch.zeros(1, dtype=torch.int32,
                                      device=engine.dev))
        lg = logits[0, -1].float()
        top = float(lg.max())
        tol = 2.0 ** -7 * abs(top)
        gaps = (top - float(lg[solo.out_tokens[s]]),
                top - float(lg[r.out_tokens[s]]))
        entry = {"uid": r.uid, "step": s, "solo_token": solo.out_tokens[s],
                 "mixed_token": r.out_tokens[s], "gaps": gaps, "top": top,
                 "tol": tol}
        out["near_tie"].append(entry)
        log(f"  request {r.uid}: solo and mixed first differ at step {s}; "
            f"gaps to the top logit {top:.4f}: {gaps[0]:.4f} / {gaps[1]:.4f} "
            f"(tol {tol:.4f})")
        check(max(gaps) <= tol, f"request {r.uid}: solo and mixed tokens "
              f"differ at step {s} beyond a near-tie: {entry}")
    log(f"  solo serves: {out['exact']} of {len(reqs)} token streams equal "
        f"the mixed wave's, the rest part at near-ties")
    return out


def profile_wave(torch, engine, wave, out_dir):
    """torch.profiler over one warm serve of a wave (prefill + 16 tokens):
    device time by kernel family and the device's idle share of the wall
    time.  The full table goes to chiprun_out/profile_wave.txt."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [dataclasses.replace(r, uid=300 + r.uid, out_tokens=[],
                                status="pending") for r in wave]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    families = {"grouped ternary kernel": 0.0, "cuBLAS GEMM": 0.0,
                "other PyTorch kernels": 0.0}
    launches = {k: 0 for k in families}
    kernels = sorted((ev for ev in prof.key_averages()
                      if ev.device_type.name == "CUDA"),
                     key=lambda ev: -ev.self_device_time_total)
    for ev in kernels:
        us = ev.self_device_time_total
        name = ev.key.lower()
        fam = ("grouped ternary kernel" if "grouped" in name else
               "cuBLAS GEMM" if any(s in name for s in (
                   "gemm", "cutlass", "xmma", "sm90", "nvjet")) else
               "other PyTorch kernels")
        families[fam] += us / 1e3
        launches[fam] += ev.count
    busy = sum(families.values())
    with open(os.path.join(out_dir, "profile_wave.txt"), "w") as f:
        f.write("device_ms\tlaunches\tkernel\n")
        for ev in kernels:
            f.write(f"{ev.self_device_time_total / 1e3:.3f}\t{ev.count}\t"
                    f"{ev.key}\n")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "device_ms_by_family": families, "launches_by_family": launches}
    log("  profile of one warm wave: wall {:.1f} ms, device busy {:.1f} ms"
        " ({})".format(wall_ms, busy, ", ".join(
            f"{k} {v:.1f} ms / {launches[k]} launches"
            for k, v in families.items())))
    return out


def logits_check(torch, engine, wave):
    """First decode step of a wave through the kernels vs the plain
    versions, both on the card from the same prefill cache.

    Tolerance (bf16-aware): every logit within about one bf16 ulp of its
    own value, |kernel - plain| <= 2**-7 * max(|kernel|, |plain|).  The
    kernel's f32 delta sums differ from the plain sums only in the last
    f32 bits, which a bf16 rounding of the sum nearly always absorbs.  The
    overlay's own effect on the logits (the same step without it) is
    logged beside the error, to show what the check can see."""
    from repro_torch.kernels import ops
    experts = list(dict.fromkeys(r.expert for r in wave))
    ov = engine._overlay_for(tuple(experts))
    eid = torch.as_tensor([experts.index(r.expert) for r in wave],
                          dtype=torch.int32, device=engine.dev)
    toks, start = engine._pad_prompts(wave)
    api = engine.api
    logits, cache = api.prefill(engine.base, {"tokens": toks}, 128,
                                delta=ov, eid=eid, start=start)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    lk, _ = api.decode_step(engine.base, tok, copy.deepcopy(cache),
                            delta=ov, eid=eid)
    with ops.plain_versions():
        lp, _ = api.decode_step(engine.base, tok, copy.deepcopy(cache),
                                delta=ov, eid=eid)
    lb, _ = api.decode_step(engine.base, tok, copy.deepcopy(cache))
    torch.cuda.synchronize()
    lk, lp, lb = lk.float(), lp.float(), lb.float()
    diff = (lk - lp).abs()
    tol = 2.0 ** -7 * torch.maximum(lk.abs(), lp.abs())
    err = float(diff.max())
    over = int((diff > tol).sum())
    effect = float((lk - lb).abs().max())
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    check(over == 0, f"decode logits: {over} logits differ from the plain "
          f"versions' by more than 2**-7 of their value (max err {err})")
    same = bool(torch.equal(lk.argmax(-1), lp.argmax(-1)))
    check(same, "decode logits: argmax differs from the plain versions'")
    log(f"  first decode step logits: max|kernel - plain| {err:.4e} "
        f"(tol 2**-7 * |logit| each, at most {float(tol.max()):.4e}); "
        f"the overlay moves them by up to {effect:.4e}")
    return {"max_abs_err": err, "tol": "2**-7 * max(|kernel|, |plain|)",
            "tol_max": float(tol.max()), "overlay_effect": effect,
            "argmax_equal": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--units", type=int, default=4,
                    help="repeat units (layers) of qwen2.5-3b, 1..36")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-after", choices=("kernels", "all"),
                    default="all", help="end after phase 2 (a first build "
                    "and correctness check of new kernels)")
    args = ap.parse_args(argv)
    if not 1 <= args.units <= 36:
        ap.error("--units must be in 1..36")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api, tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.core.compeft import CompressionConfig, compress_packed
    from repro_torch.expert import DENSE, PACKED
    from repro_torch.kernels import build, ops
    from repro_torch.models import build as build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gpu = gpu_line()
    tag = f"[{gpu}]"
    log(gpu)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    details: dict = {"gpu": gpu, "units": args.units, "seed": args.seed}
    report: dict = {}

    log("phase 1: build kernels")
    t0 = time.monotonic()
    build.build_all()
    details["build_s"] = time.monotonic() - t0
    log(f"  built {', '.join(build.SOURCES)} in {details['build_s']:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    details["ptxas"] = build.build_logs

    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=args.units)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    log("phase 2: kernels against their plain versions")
    check_grouped_matmul(torch, cfg, gen, dev, report)
    model = build_model(cfg)
    base = model.init(seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in tree_util.leaves(base))
    log(f"  base: {n_params / 1e6:.1f} M params, {args.units} units")
    ft0 = finetune(torch, base, gen)
    tau0 = tree_util.tree_map(lambda a, b: b.float() - a.float(), base, ft0)
    check_compression_kernels(torch, tau0, dev, report)
    del tau0
    if args.stop_after == "kernels":
        log(json.dumps({"kernels_checked": report}))
        return 0

    log("phase 3: main path (compress 4 experts, serve 8 requests)")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    experts, compress_s = [], []
    for i in range(4):
        ft = ft0 if i == 0 else finetune(torch, base, gen)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ex = api.compress(base, ft, name=f"e{i}", density=0.1, device=dev)
        ex.as_(PACKED)
        torch.cuda.synchronize()
        compress_s.append(time.monotonic() - t0)
        if i:
            ex.drop(DENSE)
        experts.append(ex)
        del ft
    del ft0
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts)
    engine = api.serve(model, base, reg, max_batch=4,
                       cache_len=128, decode_chunk=8)
    reqs = make_requests(torch, cfg, args.seed)
    engine.run(reqs)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    log("phase 4: checks")
    for r in reqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.uid}: bad tokens {r.out_tokens}")
    tau = experts[0].as_(DENSE)
    with ops.plain_versions():
        want = compress_packed(tau, CompressionConfig(density=0.1))
    got = experts[0].as_(PACKED)
    n_leaves, worst_scale = 0, 0.0
    for (path, w), (_, g) in zip(
            tree_util.flatten_with_paths(want, is_leaf=_is_pt),
            tree_util.flatten_with_paths(got, is_leaf=_is_pt)):
        check(torch.equal(w.pos, g.pos) and torch.equal(w.neg, g.neg),
              f"expert e0 {path}: planes differ from the plain compression")
        rel = abs(float(w.scale) - float(g.scale)) / max(float(w.scale),
                                                         1e-30)
        check(rel <= 1e-4, f"expert e0 {path}: scale rel err {rel}")
        worst_scale = max(worst_scale, rel)
        n_leaves += 1
    experts[0].drop(DENSE)
    del tau, want
    log(f"  e0: planes of {n_leaves} leaves bitwise equal to the plain "
        f"compression; scales within rel {worst_scale:.2e} (tol 1e-4)")

    for w in (reqs[:4], reqs[4:]):
        row_independence_check(torch, engine, w)
    log("  every row's tokens are bitwise unchanged when the other rows of "
        "its wave carry BASE instead of their experts")
    details["solo"] = solo_check(torch, engine, reqs)
    details["logits"] = logits_check(torch, engine, reqs[:4])

    log("phase 5: numbers")
    # a second, warm run of the same requests: the timed one (the first
    # paid one-time setup such as cuBLAS handles); it must repeat exactly
    timed = [dataclasses.replace(r, uid=200 + r.uid, out_tokens=[],
                                 status="pending") for r in reqs]
    n0 = len(engine.wave_log)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.run(timed)
    serve_s = time.monotonic() - t0
    waves = engine.wave_log[n0:]
    check([r.out_tokens for r in timed] == [r.out_tokens for r in reqs],
          "a second run of the same requests gave other tokens")
    grouped_timing(torch, engine, reqs[:4], report)
    details["profile"] = profile_wave(torch, engine, reqs[:4], out_dir)
    kernels = []
    for name, src, replaces in (
            ("ternary_matmul_grouped", "src/repro_torch/kernels/csrc/"
             "ternary_matmul.cu", "src/repro/kernels/ternary_matmul.py:150"),
            ("pack_ternary_planes_segmented", "src/repro_torch/kernels/"
             "csrc/pack.cu", "src/repro/kernels/pack.py:102"),
            ("segment_hist_moments", "src/repro_torch/kernels/csrc/"
             "histogram.cu", "src/repro/kernels/histogram_quantile.py:151")):
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    prefill_ms = [w["prefill_s"] * 1e3 for w in waves]
    dec_tok = sum(w["tokens"] - w["rows"] for w in waves)
    dec_s = sum(w["seconds"] - w["prefill_s"] for w in waves)
    numbers = {"compress_s_per_expert": compress_s,
               "prefill_ms_per_wave": prefill_ms,
               "decode_tokens_per_s": dec_tok / dec_s,
               "serve_s_8_requests": serve_s,
               "peak_memory_gib": peak / 2 ** 30,
               "params_m": n_params / 1e6}
    details.update(kernels=kernels, numbers=numbers, launches=launches)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(f"compress seconds per expert {tag}: "
        + ", ".join(f"{s:.3f}" for s in compress_s))
    log(f"prefill ms per wave (4 rows) {tag}: "
        + ", ".join(f"{t:.1f}" for t in prefill_ms))
    log(f"decode tokens/s (4 rows, chunk 8) {tag}: "
        f"{numbers['decode_tokens_per_s']:.1f}")
    log(f"peak memory {tag}: {numbers['peak_memory_gib']:.2f} GiB")
    if details["profile"]["idle_share"] is not None:
        log(f"device idle share of one profiled wave {tag}: "
            f"{details['profile']['idle_share']:.3f}")
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _is_pt(x) -> bool:
    return hasattr(x, "pos") and hasattr(x, "neg")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
    except Exception:       # any other failure: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
