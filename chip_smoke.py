#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--units 2] [--seed 0]
                          [--stop-after kernels|training|configs|families|
                                        mesh|within|long|all]

At the full width of qwen2.5-3b (d_model 2048, 16 q / 2 kv heads of 128,
QKV bias, swiglu d_ff 11008, vocab 151936, tied embeddings, rope theta
1e6, bf16 base) with the depth cut to ``--units`` (default 2 of 36) and
random weights from ``--seed``, it runs, in order, stopping at the first
failure with a non-zero exit:

  1. require CUDA; print the card's name and power limit; build the six
     kernel sources (one nvcc per source, in parallel) and print the
     build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (segment absmax bitwise, and the coarse, refine
     and skewed coarse histogram sweeps with bitwise counts and moments
     equal across two launches, over one expert's segment buffer; grouped
     matmul: row independence too; the merge
     kernels bitwise at the tied embedding, E = 1 and 3; the scalar pack
     bitwise at the tied embedding's size with -0.0 and +-threshold
     planted; popcount_dot bitwise over two such plane pairs; the
     single-expert matmul on FFN-down, wq and wg planes, bitwise each row
     of a grouped launch on the same expert; the fused sampler
     (``sample_tokens``: scale, top-k cut and draw in one launch): tokens
     and gumbel noise bitwise its plain version at [4, V] for the three
     configs' vocabularies, f32 and bf16 logits, T 0.7 and 1.0, top_k 0,
     1, 40, 1000, V - 1 and V, stream positions up to 2**31, bf16 logits
     whose k-th value is tied many times or is a zero of either sign, each
     row launched alone; then timed beside ``torch.topk`` and the composite
     path it replaced);
  3. the main paths, each with every launch count set to 0 just before it
     and read just after: compress 4 experts (base + seeded noise on every
     leaf, density 0.1) through ``api.compress(...).as_(PACKED)``, then
     serve 8 greedy requests over them and ``BASE`` in FIFO mixed waves
     (``api.serve(max_batch=4, cache_len=128, decode_chunk=8,
     continuous=False)``, each decode chunk one CUDA graph replay); then
     the same requests by merge-on-swap (``scheduling="grouped"``), and a
     merged ensemble of three experts; then, counted apart as a check and
     not a path, the ensemble's oracle, a loop of single-expert merges
     (``unpack_add``, which no path of the port calls);
  3c. the artifact path on the same experts (``artifact_path``): e0
     compressed again with ``method="exact"`` (bitwise
     ``pack_tree(compress(.))``), the experts saved as ``.cpft`` and
     ``.npz`` and loaded back bitwise, the same 8 requests served from a
     cold-Golomb registry over the loaded experts (tokens exactly phase
     3's), the similarity matrix and ``scaled_dot`` by popcount (equal to
     the plain versions'), ``api.merge`` by packed, task arithmetic and
     TIES (packed bitwise task arithmetic), and, counted apart as a
     check, ``ops.ternary_matvec`` over unit 0's projections;
  3d. continuous admission at full width (``refill_path``): 16 greedy
     requests over e0-e3 and ``BASE`` (prompts of 16-64 tokens, budgets
     of 4-32, from ``--seed``) with ``max_batch=4``, ``cache_len=256``,
     ``decode_chunk=8`` and slot refill: at least 4 admissions; the graph
     chunks bitwise equal to the same chunks run eagerly; at
     ``decode_chunk`` 0 (the eager loop), 1 and 16 every request placed
     as at chunk 8 bitwise equal, the others reported (an admission at
     another wave position sees other rope positions in bf16); and on an
     f32 copy of the model, tokens bitwise equal at ``decode_chunk`` 0, 1,
     8 and 16 and each request equal to its solo serve;
  3e. llama-7b (2 of 32 units), gemma2-9b (2 of 21), qwen3-32b (2 of
     64; per-head q/k RMSNorm) and qwen1.5-110b (1 of 80; d_model 8192,
     d_ff 49152, a segment buffer past 2**31 elements) at full width on
     the overlay (``config_path``): 4 experts compressed (e0's planes
     checked at once, then every task vector dropped), phase 3's 8
     requests and gates (planes, row independence, logits, solo
     near-ties, a warm run repeating its tokens; qwen3's solo gate and
     qwen1.5's solo and logits gates on an f32 copy, since in bf16 they
     part by 2-4 ulps), decode tokens/s, peak memory, the grouped matmul
     at every launch shape (each launch within 1e-4 of the plain
     version) and one profiled wave, then everything freed (the cyclic
     collector run first); then mixtral-8x7b (2 of 32 units, top-2
     of 8 experts) by merge-on-swap (``moe_path``): 4 experts (the f32
     router included), phase 3's 8 requests with ``scheduling="mixed"``
     and no overlay plan, one kernel-4 merge per distinct expert, every
     merged tree bitwise the plain merge, merged logits within 2**-7 of
     the plain merge's, rows bitwise independent of their neighbours'
     prompts, unpadded rows equal to their solo serves up to a near-tie
     on an f32 copy (a padded row's pad tokens take MoE capacity, and a
     bf16 ulp can flip a top-2 choice, so those solo serves are
     reported), graph chunks bitwise eager ones, a warm run repeating
     its tokens; decode tokens/s, swap seconds against the merge's byte
     bound, kernel 4 on the widest leaf and one profiled 4-row batch;
  3f. the families outside the overlay (``merge_path``), each served by
     merge-on-swap through ``api.serve(..., scheduling="mixed")`` (no
     overlay plan, kernel 4 once per leaf per distinct expert): rwkv6-3b
     (rwkv blocks, 4 of 32 units), seamless-m4t-medium (all 12 encoder
     and 6 of 12 decoder units; zero stub frames [4, 1024, 1024], a
     cross-KV of 1024 source positions) and internvl2-1b (12 of 24
     units; a 256-position zero ``mm_embeds`` prefix in a ``cache_len``
     of 384)
     at full width, and jamba-1.5-large (mamba, attention and MoE blocks)
     at smoke size: 4 experts compressed (e0's planes bitwise the plain
     compression), phase 3's 8 requests (``max_batch=4``,
     ``decode_chunk=8``, ``continuous=False``); gates: no plan, one merge
     per distinct expert, merged trees bitwise the plain merge, the first
     decode step's logits within 2**-7 of the plain merge's, kernels 2,
     3, 3a and 4 launched, graph chunks bitwise the same chunks run
     eagerly, a warm run repeating its tokens, rows bitwise independent
     of their neighbours' prompts of the same lengths, unpadded rows
     equal to their solo serves up to a near-tie (on an f32 copy where
     bf16 parts beyond it); reported: compress and swap seconds per
     expert (swaps beside the merge's byte bound), prefill ms per batch,
     decode tokens/s, peak memory, one profiled batch, and the share of a
     decode step (rwkv, jamba) or a prefill (seamless's encoder) that
     the plain recurrent scans or the encoder take; then one jamba mamba
     block at full width (d_model 8192, d_inner 16384, d_state 16,
     dt_rank 512; f32) on 4 rows: a 64-token chunked prefill and 16
     decode steps against one chunked forward over the 80 tokens, within
     1e-4 of the largest |output| (``mamba_module_check``).
     ``--stop-after families`` ends after phases 3 and 3f;
  3m. the serving mesh at full width (``mesh_path``), each rank a process
     that this script starts as ``chip_smoke.py --mesh-child SPEC`` (one
     torch thread of work a rank; the experts' planes handed over in a
     git-ignored ``_artifacts_*`` directory): mesh (2, 1), two ranks on
     the card over gloo with eager chunks, serves phase 3's 8 requests
     greedy and sampled (T 0.8, top_k 40) and paged (chunks of 4), each
     bitwise the mesh-free run's in bf16 with no capture and no KV block
     left, and crashes a paged run at chunk 2 with a snapshot per chunk;
     mesh (1, 2), two ranks over gloo (vocab-parallel embed and head,
     batch-sharded KV), bitwise the mesh-free run on an f32 copy and, in
     bf16, phase 3's tokens or parting first at a near-tie; mesh (1, 1)
     under NCCL with graphed chunks, bitwise phase 3's, phase 3d's and the
     paged tokens, and the (2, 1) snapshot resumed (continued rows
     bitwise, no block left); with more than one card, (2, 1) and (1, 2)
     one rank a card under NCCL; then the compressed multi-pod train step
     (qwen2.5-3b at 1 unit, 3 AdamW steps of 4 x 64 tokens) as 1 NCCL pod
     and as 2 gloo pods on the card, parameters, error feedback and losses
     bitwise a one-process oracle.  The ranks start after phase 3d (run
     before 3c) and the worlds run two or three at a time, beside phase
     3c in this process: (2, 1) beside (1, 2), then (1, 1) (which resumes
     (2, 1)'s snapshot) beside the two multi-pod steps, until phase 3c's
     merges (its largest allocation), which wait for every rank to end;
     this process then takes the mesh-free references and the oracles
     and reads every world's results.  Every rank's tokens must equal rank 0's,
     and a failed rank fails the run (and stops every rank).  Reported
     per run: ranks, backend, cards, decode tokens/s of a warm run (with
     the other worlds running beside it) and the collectives' device and
     host ms a decode step from ``torch.profiler``; kernels 1
     and S must launch under the mesh (rank 0's counts join the
     ``kernels`` line as ``launches_mesh``).  ``--stop-after mesh`` ends
     after phases 3, 3d and 3m;
  3w. (run right after phase 3, while this process holds least of the
     card) training inside a pod and sequence-parallel decode
     (``within_path``), ranks as gloo processes sharing the card: after
     (c)'s mesh-free step, (d)'s world of four beside this process's
     other references and the world of two, then the world of four: (a)
     the within-pod step on qwen2.5-3b at 1 unit, 2 AdamW
     steps of 8 x 64 tokens in 2 microbatches with half of the targets
     of data rank 0's rows at -1, on (1, 2, 1) (FSDP) and (2, 2, 1)
     (FSDP and compressed pods), every rank's blocks and the losses
     bitwise a one-process oracle
     (``within_pod.within_pod_in_one_process``), and (1, 1, 2) (tensor
     parallelism) on an f32 copy, each rank's parameters within 1e-4 of
     the mesh-free step's; (b) on an f32 copy
     at ``--units`` with e0-e3 on the overlay, sequence-parallel decode
     of phase 3's requests in waves of 4 on (data 1, model 2) with
     ``cache_len`` 1024 and of one 4096-token prompt on (2, 2) with
     ``cache_len`` 8192 (the ring cut over every axis), the first decode
     step's logits within 1e-4 of the largest |logit| of the mesh-free
     run and the greedy tokens equal up to a near-tie; (c) the MoE
     family on "model": mixtral-8x7b at full width, 1 unit, f32, 2 AdamW
     steps of (a)'s batches, its mesh-free step first in this process
     (freed before any rank starts), then the four ranks on (1, 2, 2)
     with the experts cut on d_ff as published and on E
     (``expert_parallel=True``), every rank's losses within 1e-4 and
     every parameter block within 1e-4 of the mesh-free step's, each
     expert leaf a quarter of the logical one; reported: step seconds,
     state bytes a rank beside the mesh-free state's (and expert bytes),
     peak memory a rank, the collectives of a profiled step, decode ms a
     step beside the mesh-free run's and the combine's; (d) the families
     beyond decoder-only attention on "model" as the reference places
     them, f32, 2 AdamW steps of (a)'s batches (a frontend's frames or
     patches besides the 64 text tokens) on (1, 2, 2), a world of four
     of its own beside (a)'s world of two and (b)'s decode references,
     each rank held to the mesh-free step (run in this process beside
     it, its parameters read when written) at (c)'s tolerances,
     every block of its state at its placed shape and every leaf placed
     on "model" cut over it: rwkv6-3b at full width with 1 unit (its
     channel mix cut on d_ff), internvl2-1b at full width with 1 unit
     (its FFN cut, attention whole), seamless-m4t-medium at full width
     with 1 + 1 units (encoder and cross-attention heads cut) and jamba
     at smoke size with 1 unit (mamba on d_inner, attention heads,
     experts on E);
     and one full-width jamba mamba mixer (d_model 8192, d_inner 16384)
     forward and backward on (1, 1, 2) beside (a)'s world of two, its
     output and every gradient block within 1e-5 of the largest |value|
     of the whole mixer's in the rank's process; reported: step seconds,
     state bytes a rank beside the mesh-free state's, peak memory a rank
     and the collectives' host and device ms; (e) prefill and decode
     inside a pod on the cut weights (``within_pod.make_pod_serve``:
     each unit gathered over "data" only and run cut over "model", the
     decode cache placed by ``cache_pspec``), by (a)'s (1, 1, 2) ranks
     (qwen2.5-3b at ``--units``, f32), (c)'s mixtral ranks on d_ff and on
     E and (d)'s families, each before its AdamW steps: 4 prompts of 128
     tokens at ``cache_len`` 1024 and 8 greedy steps (jamba adds one
     prompt at batch 1, the long-context layout), against the mesh-free
     run in this process on the same weights: the first step's logits
     within 1e-4 of the largest |logit|, the tokens equal up to a
     near-tie, every parameter block and cache leaf at its placed shape;
     reported: prefill ms and decode ms a step a rank beside the
     mesh-free run's, peak memory a rank and the collectives of a
     profiled decode step; kernel 1 must
     launch under both decode meshes (rank 0's counts join the
     ``kernels`` line as ``launches_within``).  ``--stop-after within``
     ends after phases 3 and 3w;
  3s. phase 3d's 16 requests sampled at temperature 0.8, top_k 40 and 0
     (``sampled_path``, uids kept): graph chunks bitwise the same chunks
     run eagerly, requests placed alike bitwise at ``decode_chunk`` 0, 1
     and 16, and on the f32 copy every stream bitwise across chunk sizes
     and equal to its solo serve;
  3p. paged KV and the three schedulers (``paged_path``): 24 closed
     requests from ``repro_torch.serve.traffic.generate`` (prompts of 16
     and 96 tokens, budgets of 8 and 32, priorities 0 and 1, Zipf
     experts e0-e3) with ``max_batch=4``, ``cache_len=256``,
     ``kv_block_size=16``, ``decode_chunk=8``, served paged under
     ``fifo``, ``priority`` and ``affinity`` and sampled (T 0.8, top_k
     40) under ``affinity``; the gates: every paged stream equal to the
     dense FIFO run's by the near-tie rule (its head-of-line blocks
     recorded), on an f32 copy the paged streams bitwise across
     ``decode_chunk`` 1, 8 and 16 and equal to their solo serves (greedy
     under each scheduler, sampled under affinity), the graph chunks
     bitwise the same chunks run eagerly, no capture on a warm engine, no
     block left in use and the peak within the pool, pools of half and a
     quarter of the default (the quarter re-queues overflow rows), the
     blocked head at full width (priority admits past it, fifo keeps
     order), and no "position" or "wrap" block on the paged path; then,
     reported, the generator's open-loop timeline per scheduler, dense
     and paged, one warm paged run profiled, and the paged attention's
     device time per step beside the dense ring's;
  3r. the remote tiers (``remote_path``): the 4 experts published as
     PACKED wire blobs; phase 3's 8 requests served on fresh engines from
     a ``LocalTransport`` directory, from ``serve_local_http`` on
     127.0.0.1 (mixed, and by merge-on-swap from a second registry), and
     from a ``ReplicatedTransport`` over 3 chaos-wrapped in-memory
     replicas (R 2; a seeded bitflip on one owner of e1, the other owner
     down after 5 reads a name): tokens bitwise phase 3's (3b's for
     merge-on-swap), fetched planes bitwise the published, kernel 1's
     launches per wave phase 3's; a fresh engine captures its decode
     graphs while e2 and e3 are still on a simulated 3 s link (no capture
     error, prefetch hits, no prefetch error, tokens bitwise a local
     registry's); e2 blacked out under paged KV and the affinity
     scheduler: its 2 requests fail naming e2 and "unavailable", one
     quarantine, no KV block left in use, survivors equal the no-fault
     run by the near-tie rule in bf16 and bitwise on an f32 copy; every
     prefetch stage's planes on the host; reported: bytes on the wire
     per expert (PACKED, GOLOMB, DENSE reckoned), one expert's HTTP
     fetch, CRC-and-decode and host-to-device seconds, the cold and warm
     first token of a remote request, remote against prefetch seconds;
  3k. kill and resume (``durability_path``): phase 3d's 16 requests
     served with a journal and a snapshot after every chunk, served again
     and crashed from a chunk hook at the first chunk where rows admitted
     after the last snapshot are in flight, then resumed on the same warm
     engine (no capture, every kept buffer at its address) and on a
     fresh one; phase 3p's 24 requests paged, sampled (T 0.8, top_k 40)
     under affinity, likewise (no KV block in use after the resume); the
     crash journaled only, resumed through ``api.serve(resume=True)`` (no
     snapshot step); a finished run resumed from its journal alone (no
     wave) and another seed refused ("sampling mismatch"); the base saved
     with ``checkpoint.manager.save``, the experts published as PACKED
     blobs, and ``repro_torch.serve.restart_child`` killed by SIGKILL at
     the same chunk, its run resumed here.  In bf16 rows continued from
     a restored wave are bitwise the uninterrupted run's, and a row served
     again from its prompt equals it or parts first at a near-tie (on a
     sampled engine, of the draw's scores); on an f32 copy every stream
     is bitwise and every resume completes.  Kernel 1 launches in every
     resume, the sampler in sampled ones.  Reported: journal bytes per
     record, snapshot bytes, commit and device-to-host seconds,
     ``resume_seconds``, ``first_resumed_token_s``, the ``RecoveryPlan``,
     the child's seconds, and phase 3d's warm tokens/s with no journal,
     the journal alone and a snapshot every 1 and 4 chunks;
  3t. produce an expert (``training_path``): ``train_loop`` with AdamW,
     20 steps of 8 x 64 tokens of task 1 from the base (the mean loss of
     the last 5 below the first 5's); Adafactor with a checkpoint every 5
     steps and failures injected at steps 7 and 13, every leaf of the
     final state bitwise an uninterrupted run's (train steps run under
     deterministic algorithms); the trained tau compressed to PACKED,
     its planes bitwise the plain compression's, its held-out
     ``eval_loss`` below the base's, served mixed with e0-e3 and BASE in
     phase 3's 8 requests (e1 replaced by it) with the row-independence
     and solo gates; a rank-8 LoRA trained by SGD, compressed with
     ``kind="lora"`` and reconstructed (base, fine-tuned, reconstructed
     ``eval_loss`` reported); ``compress_leaf_for_allgather`` over the
     fine-tune's gradients, each leaf's plane density within 0.5 points
     of 0.05 and the error feedback bitwise ``g - s * signs``; reported:
     train step ms, tokens/s and model FLOP utilisation (AdamW and
     Adafactor), peak memory, checkpoint save and restore seconds, the
     compress seconds and the served wave's decode tokens/s;
  3l. long sequences (``long_phase``), the chunked flash attention of
     ``models/attention.py`` at the model's chunks of 512: (a) one greedy
     request on e0 with a 32768-token prompt from ``--seed`` and 16 new
     tokens through ``api.serve(max_batch=1, cache_len=32784,
     decode_chunk=8)``, the peak device memory above the phase's start
     below a quarter of the whole-matrix scores' bytes (B Hq T S 4 / 4,
     17.2 GB), a warm run repeating its tokens; (b) the same prompt's
     prefill (e0's overlay, the row mask) at chunks of 512 and 2048: the
     engine's first token the bf16 greedy choice at 512, and on an f32
     copy the last-token logits within 1e-4 of the largest |logit| (in
     bf16 they are reported); (c) at 4096 tokens, chunked against
     one tile of the whole sequence, f32: one attention call at the
     model's heads (output within 2e-5 and dq, dk, dv within 1e-4 of
     their largest values) and one AdamW step of ``train_step`` on an f32
     copy over one row (loss and gradient norm within 1e-5 relative, each
     leaf's ``mu`` within 1e-4 of its largest); reported: prefill ms,
     decode tokens/s, tile steps a layer, peak memory and seconds of each
     form.  ``--stop-after long`` ends after phases 3 and 3l;
  4. check the result: tokens in range; one expert's planes bitwise equal
     to the plain compression of its tau (and one warm compression of it
     profiled: device ms by pass and the host share); every row's tokens
     bitwise
     unchanged when the other rows of its wave carry other experts; every
     request's tokens equal to the same request served alone, or parting
     from them first where the two candidates lie within about one bf16
     ulp of the top logit (alone, a row has no padding and other batch
     shapes, so its bf16 logits are not bitwise the wave row's); the first
     decode step's logits through the kernels within about one bf16 ulp
     of each logit's value from the plain versions; on the merge path,
     4 swaps, every merged expert and the ensemble bitwise equal to their
     plain and loop oracles, tokens bitwise those of the same run on the
     plain versions, and merged logits within a tenth of the overlay's
     effect of the base-plus-overlay logits;
  5. time the kernels and warm re-runs of both serving paths (which must
     repeat their tokens): the grouped matmul at every shape the wave
     launches it with (decode and prefill, on the wave's own planes), with
     its launches per wave, and the short kernels by CUDA graph (device
     time); profile one wave with ``torch.profiler`` (device time by
     kernel family, split into prefill and decode, and the idle share),
     and print the ``kernels`` JSON line (ten kernels) and the
     end-to-end numbers, each tagged with the card's name and power
     limit: decode tokens/s (greedy, and sampled on the same wave, whose
     profile must hold no ``torch.topk`` kernel),
     wall and device-busy time and idle share of phase 3's warm wave
     (greedy and sampled) and of phase 3d's warm run, the graph captures
     and capture seconds of every serving engine, and the grouped
     kernel's cost of the eight expert slots (its decode launches timed
     on the slot stack and on a stack of only the wave's experts).

The last line of standard output is ``{"ok": true, "device": ...}``; a
run that fails prints no such line.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import tempfile
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and f32 rate
# outside the tensor cores; the kernels below do f32 arithmetic on CUDA
# cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# 32-bit integer operations outside the tensor cores: 64 INT32 lanes per
# SM (half the 128 f32 lanes behind the f32 rate), 132 SMs, 1.98 GHz
INT32_OPS_PER_S = 16.7e12


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


_T0 = time.monotonic()


def log(msg: str) -> None:
    """Print ``msg``; a phase's opening line also gets the seconds since
    the script started, so a run's log shows where its time went."""
    if msg.startswith("phase "):
        msg = f"{msg} (at {time.monotonic() - _T0:.1f} s)"
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn()``: after a warm-up call, ``reps``
    calls launched back to back between two CUDA events, their elapsed
    time over ``reps``.  The host's launch work overlaps the device's
    execution, so a kernel shorter than its wrapper's host work reads as
    the host's time per call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, n: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn()``: ``n`` calls captured into
    one CUDA graph, replayed ``replays`` times between two CUDA events.
    A replay launches no Python, so a kernel shorter than its wrapper's
    host work reads as its own device time (``cuda_ms`` would read the
    host's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                             # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (n * replays)


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


def skewed_buffer(torch, buf, row_seg, row_valid, seg_count, gen):
    """A copy of the segment buffer with its largest segment at 90% equal
    magnitudes (+-0.01, random signs; the rest Gaussian, as bf16-upcast
    deltas repeat exact values) and its second largest all zeros (a
    frozen leaf); padding stays zero."""
    out = buf.clone()
    order = torch.argsort(seg_count.to(torch.int64), descending=True)
    big, zero = int(order[0]), int(order[1])
    C = buf.shape[1]
    cols = torch.arange(C, device=buf.device)[None, :]
    rows = torch.nonzero(row_seg == big)[:, 0]
    for r0 in range(0, rows.numel(), 4096):
        rr = rows[r0:r0 + 4096]
        n = rr.numel()
        sign = torch.where(torch.rand((n, C), generator=gen,
                                      device=buf.device) < 0.5, -0.01, 0.01)
        other = 0.01 * torch.randn((n, C), generator=gen, device=buf.device)
        v = torch.where(torch.rand((n, C), generator=gen, device=buf.device)
                        < 0.9, sign, other)
        out[rr] = torch.where(cols < row_valid[rr][:, None], v, 0.0)
    out[row_seg == zero] = 0.0
    return out, big, zero


def moment_errors(got, want):
    """Max abs and max relative error of the sweep's moments (sum,
    sumsq, max, sum |x|) against the plain version's; the signed sum,
    near 0, relative to sum |x|."""
    err = rel = 0.0
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        den = want[4] if i == 0 else w.abs()
        rel = max(rel, float(((g - w).abs() / den.clamp_min(1e-30)).max()))
        err = max(err, float((g - w).abs().max()))
    return err, rel


def sweep_times(torch, hq, row_seg, row_valid, sweeps, n_el, reps=10):
    """Times of the histogram sweeps ``{name: (x, lo, width,
    with_moments)}`` of the package ``hq`` (back-to-back launches between
    CUDA events; the buffer is 50x the L2 cache), each beside its bound:
    the bytes read once over 3.35 TB/s, against 3 operations per element
    (6 with moments)."""
    times = {}
    for name, (x, lo, w, mom) in sweeps.items():
        R, C = x.shape
        S = lo.numel()
        t = cuda_ms(torch, lambda: hq.segment_hist_moments(  # noqa: B023
            x, row_seg, row_valid, lo, w, n_seg=S, with_moments=mom), reps)
        nb = (R * C * 4 + R * 8 + S * 8 + S * hq.NBINS * 4
              + (S * 16 if mom else 0))
        b, by = bound_ms(nb, (6.0 if mom else 3.0) * n_el)
        times[name] = {"ms": t, "bound_ms": b, "bound_by": by}
    return times


def absmax_bound(R, C, S, n_el):
    """The segment absmax's bound: the buffer and the row vectors read
    once, the maxima written once, against 2 operations per element."""
    return bound_ms(R * C * 4 + R * 8 + S * 4, 2.0 * n_el)


def check_compression_kernels(torch, tau, dev, report):
    """The compression kernels over one expert's full segment buffer, each
    against its plain version on the same inputs: segment_absmax bitwise;
    the coarse sweep (lo = 0, width = max), the refine sweep at the window
    that ``segmented_quantile_moments`` computes for density 0.1, and the
    coarse sweep over ``skewed_buffer``'s copy, each with counts bitwise
    equal, moments bitwise equal across two launches and within a
    relative 1e-4 of the plain version (both sum in f32, in different
    orders); the pack's planes bitwise.  Then the times of all five, each
    beside its bound (as :func:`sweep_times` takes them)."""
    from repro_torch import tree as tree_util
    from repro_torch.core.compeft import STREAM_COLS, _build_segment_buffer
    from repro_torch.kernels import histogram_quantile as hq
    from repro_torch.kernels.pack import (pack_ternary_planes_segmented,
                                          pack_ternary_planes_segmented_plain)
    leaves = tree_util.leaves(tau)
    buf, row_seg, row_valid, seg_count, _ = _build_segment_buffer(
        leaves, STREAM_COLS, dev)
    S = len(leaves)
    R, C = buf.shape
    n_el = float(seg_count.sum())
    skew, big, zero = skewed_buffer(torch, buf, row_seg, row_valid,
                                    seg_count, torch.Generator(
                                        device=dev).manual_seed(5))
    smax = hq.segment_absmax(buf, row_seg, row_valid, n_seg=S)
    smax_k = hq.segment_absmax(skew, row_seg, row_valid, n_seg=S)
    for name, x, got in (("buffer", buf, smax), ("skewed buffer", skew,
                                                  smax_k)):
        want = hq._segment_absmax(x, row_seg, row_valid, n_seg=S)
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"segment_absmax over the {name} differs from the plain "
              "version")
    log(f"  segment_absmax over [{R}, {C}] and its skewed copy: bitwise "
        "equal to the plain version")
    stats = hq.segmented_quantile_moments(buf, row_seg, row_valid, seg_count,
                                          0.1, n_seg=S)
    lo0 = torch.zeros_like(smax)
    sweeps = {"coarse": (buf, lo0, smax, True),
              "refine": (buf, stats["refine_lo"], stats["refine_width"],
                         False),
              "skewed_coarse": (skew, lo0, smax_k, True)}
    mom_err = mom_rel = 0.0
    for name, (x, lo, w, mom) in sweeps.items():
        kw = dict(n_seg=S, with_moments=mom)
        got = hq.segment_hist_moments(x, row_seg, row_valid, lo, w, **kw)
        again = hq.segment_hist_moments(x, row_seg, row_valid, lo, w, **kw)
        want = hq.segment_hist_moments_plain(x, row_seg, row_valid, lo, w,
                                             **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(again[0],
                                                           want[0]),
              f"histogram {name}: counts differ from the plain version")
        msg = ""
        if mom:
            check(all(torch.equal(g, a) for g, a in zip(got[1:], again[1:])),
                  f"histogram {name}: moments differ between two launches")
            err, rel = moment_errors(got, want)
            check(rel <= 1e-4, f"histogram {name}: moments rel err {rel} > "
                  "1e-4")
            mom_err, mom_rel = max(mom_err, err), max(mom_rel, rel)
            msg = (f", moments equal across two launches, max|err| "
                   f"{err:.3e} (max rel {rel:.2e})")
        log(f"  histogram {name} sweep: {int(got[0].sum())} in range, counts "
            f"bitwise equal{msg}")
    report["segment_hist_moments"] = {"max_abs_err": mom_err,
                                      "moments_max_rel_err": mom_rel}
    thr = stats["threshold"][row_seg.to(torch.int64)].contiguous()
    p_got = pack_ternary_planes_segmented(buf, thr)
    p_want = pack_ternary_planes_segmented_plain(buf, thr)
    check(torch.equal(p_got[0], p_want[0]) and torch.equal(p_got[1],
                                                           p_want[1]),
          "pack planes differ")
    log(f"  pack over [{R}, {C}]: planes bitwise equal")
    report["pack_ternary_planes_segmented"] = {"max_abs_err": 0.0}
    del p_got, p_want, want

    # times at these shapes
    times = sweep_times(torch, hq, row_seg, row_valid, sweeps, n_el)
    times["skewed_coarse"]["segments"] = {"equal_90pct": big, "zero": zero}
    tp = cuda_ms(torch, lambda: hq.segment_hist_moments_plain(
        buf, row_seg, row_valid, lo0, smax, n_seg=S), 3)
    coarse = times["coarse"]
    report["segment_hist_moments"].update(
        ms=coarse["ms"], plain_ms=tp, bound_ms=coarse["bound_ms"],
        bound_by=coarse["bound_by"], library_ms=None,
        library_note="null: torch.histc has no segments, padding or "
                     "moments",
        shape=f"buf [{R}, {C}], {S} segments, {hq.NBINS} bins, coarse sweep",
        sweeps=times)
    t = cuda_ms(torch, lambda: hq.segment_absmax(buf, row_seg, row_valid,
                                                 n_seg=S), 10)
    tp = cuda_ms(torch, lambda: hq._segment_absmax(buf, row_seg, row_valid,
                                                   n_seg=S), 3)
    b, by = absmax_bound(R, C, S, n_el)
    report["segment_absmax"] = {
        "max_abs_err": 0.0, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": None,
        "library_note": "null: no PyTorch call takes a segmented max over "
                        "the valid columns of each row",
        "shape": f"buf [{R}, {C}], {S} segments"}
    del skew
    t = cuda_ms(torch, lambda: pack_ternary_planes_segmented(buf, thr), 10)
    tp = cuda_ms(torch, lambda: pack_ternary_planes_segmented_plain(
        buf, thr), 3)
    b, by = bound_ms(R * C * 4 + R * 4 + 2 * R * C // 8, 3.0 * R * C)
    report["pack_ternary_planes_segmented"].update(
        ms=t, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
        shape=f"tau [{R}, {C}]")
    for name, e in times.items():
        log(f"  histogram {name} sweep {e['ms']:.4f} ms (bound "
            f"{e['bound_ms']:.4f})")
    am = report["segment_absmax"]
    log(f"  segment_absmax {am['ms']:.4f} ms (bound {am['bound_ms']:.4f}, "
        f"plain {am['plain_ms']:.3f})")


def bits(torch, t):
    """The bit patterns of a bf16 or f32 tensor (so -0.0 != +0.0)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_merge_kernels(torch, leaf, gen, dev, report):
    """unpack_add and unpack_add_many against their plain versions,
    bitwise, at the path's largest leaf (the tied embedding, viewed flat as
    [1, n] as ``ops.apply_ternary_delta*_flat`` pass it), with -0.0
    planted in the base, a plane word with both bits set, E = 1 and E = 3
    with weights [0.5, 1.0, 0.25] and [0.5, -1.0, 0.25] multiplied into
    the scales in f32; the fused form also equals a loop of unpack_add on
    the card.  Then their CUDA-event times beside their bounds."""
    from repro_torch.kernels.unpack_add import (
        unpack_add, unpack_add_many, unpack_add_many_plain, unpack_add_plain)
    n = leaf.numel()
    base = leaf.reshape(1, n).clone()
    base[0, :4096:7] = -0.0
    W = -(-n // 32)
    pos, neg = rand_planes(torch, (3, 1, W), gen, dev)
    pos[0, 0, 0], neg[0, 0, 0] = -1, 0xFFFF
    raw = torch.tensor([0.013, 0.021, 0.008], device=dev)
    runs = {}
    for E, w in ((1, [1.0]), (3, [0.5, 1.0, 0.25]), (3, [0.5, -1.0, 0.25])):
        s = raw[:E] * torch.tensor(w, device=dev)
        got = unpack_add_many(base, pos[:E], neg[:E], s)
        want = unpack_add_many_plain(base, pos[:E], neg[:E], s)
        loop = base
        for e in range(E):
            loop = unpack_add(loop, pos[e], neg[e], s[e])
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"unpack_add_many E={E} weights {w}: differs from plain")
        check(torch.equal(bits(torch, got), bits(torch, loop)),
              f"unpack_add_many E={E} weights {w}: differs from a loop of "
              "unpack_add")
        if E == 1:
            single = unpack_add_plain(base, pos[0], neg[0], s[0])
            check(torch.equal(bits(torch, loop), bits(torch, single)),
                  "unpack_add: differs from plain")
        runs[E] = s
        del got, want, loop
    log(f"  unpack_add / unpack_add_many over [1, {n}] bf16 (E = 1, 3; a "
        "negative weight; -0.0 planted): bitwise equal to the plain "
        "versions and to a loop of unpack_add")
    el = base.element_size()

    def bound(E):
        return bound_ms(2 * n * el + E * 2 * n / 8, 2.0 * E * n)

    t1 = cuda_ms(torch, lambda: unpack_add(base, pos[0], neg[0],
                                           runs[1][0]), 20)
    t1p = cuda_ms(torch, lambda: unpack_add_plain(base, pos[0], neg[0],
                                                  runs[1][0]), 3)
    b1, by1 = bound(1)
    tm = {E: cuda_ms(torch, lambda: unpack_add_many(  # noqa: B023
        base, pos[:E], neg[:E], runs[E]), 20) for E in (1, 3)}
    tmp = {E: cuda_ms(torch, lambda: unpack_add_many_plain(  # noqa: B023
        base, pos[:E], neg[:E], runs[E]), 3) for E in (1, 3)}
    b3, by3 = bound(3)
    shape = f"tied embedding viewed flat: base [1, {n}] bf16, planes "
    report["unpack_add"] = {
        "max_abs_err": 0.0, "ms": t1, "plain_ms": t1p, "bound_ms": b1,
        "bound_by": by1, "library_ms": None, "shape": shape + f"[1, {W}]"}
    report["unpack_add_many"] = {
        "max_abs_err": 0.0, "ms": tm[1], "plain_ms": tmp[1], "bound_ms": b1,
        "bound_by": by1, "library_ms": None, "shape": shape + f"[1, 1, {W}]",
        "e3": {"ms": tm[3], "plain_ms": tmp[3], "bound_ms": b3,
               "bound_by": by3}}
    log(f"  unpack_add {t1:.3f} ms, unpack_add_many E=1 {tm[1]:.3f} ms, "
        f"E=3 {tm[3]:.3f} ms (bounds {b1:.3f} / {b1:.3f} / {b3:.3f} ms)")


def check_artifact_kernels(torch, cfg, gen, dev, report):
    """The artifact path's kernels against their plain versions at full
    width, on inputs from ``gen`` (a generator of their own: the experts
    drawn later stay the ones of the earlier slices):

    * pack_ternary_planes over a tau of the tied embedding's size viewed
      flat, [1, V * d] f32, with -0.0, 0.0 and values at +-the exact
      density-0.1 threshold planted: bitwise its plain version and
      pack_ternary(compress_leaf(.)) at that threshold;
    * popcount_dot over the planes of two such taus: bitwise its plain
      version, and dot(a, a) == nnz(a);
    * ternary_matmul at the FFN-down, wq and wg shapes (planes [K, N / 32],
      x [4, K]): within 1e-4 * max |plain| of its plain version (f32 sums
      in other orders), and bitwise every row of a grouped launch whose
      rows all carry that expert (one routine in two kernels).

    Then CUDA-event times beside the bounds (kernel 6 by CUDA graph:
    device time), and cuBLAS ``x @ W`` on the dense f32 ternary matrix as
    a yardstick (a different input: the unpacked matrix, not the
    planes)."""
    from repro_torch.core.compeft import (CompressionConfig, _topk_threshold,
                                          compress_leaf)
    from repro_torch.core.packing import pack_ternary, popcount
    from repro_torch.kernels.pack import (pack_ternary_planes,
                                          pack_ternary_planes_plain)
    from repro_torch.kernels.popcount_dot import (popcount_dot,
                                                  popcount_dot_plain)
    from repro_torch.kernels.ref import dense_of_planes
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul, ternary_matmul_grouped, ternary_matmul_plain)
    n = cfg.vocab * cfg.d_model
    W = -(-n // 32)

    def tau_and_threshold():
        tau = 0.01 * torch.randn((1, n), generator=gen, device=dev)
        flat = tau.view(-1)
        flat[::4099] = -0.0
        flat[1::8191] = 0.0
        thr = _topk_threshold(flat.abs(), 0.1)
        flat[2::6151] = thr
        flat[3::6151] = -thr
        return tau, thr

    tau, thr = tau_and_threshold()
    a = pack_ternary_planes(tau, thr)
    want = pack_ternary_planes_plain(tau, thr)
    torch.cuda.synchronize()
    check(torch.equal(a[0], want[0]) and torch.equal(a[1], want[1]),
          "pack_ternary_planes: planes differ from the plain version")
    del want
    pt = pack_ternary(compress_leaf(tau[0], CompressionConfig(density=0.1),
                                    threshold=thr))
    check(torch.equal(a[0][0], pt.pos) and torch.equal(a[1][0], pt.neg),
          "pack_ternary_planes: planes differ from "
          "pack_ternary(compress_leaf(.))")
    del pt
    t7 = cuda_ms(torch, lambda: pack_ternary_planes(tau, thr), 20)
    t7p = cuda_ms(torch, lambda: pack_ternary_planes_plain(tau, thr), 3)
    b7, by7 = bound_ms(n * 4 + 4 + 2 * W * 4, 4.0 * n)
    log(f"  pack_ternary_planes over [1, {n}] f32 (-0.0, 0.0 and +-thr "
        "planted): bitwise equal to the plain version and to "
        "pack_ternary(compress_leaf(.))")
    del tau
    tau_b, thr_b = tau_and_threshold()
    b = pack_ternary_planes(tau_b, thr_b)
    del tau_b
    ap, an, bp, bn = a[0][0], a[1][0], b[0][0], b[1][0]
    dot = popcount_dot(ap, an, bp, bn)
    dot_plain = popcount_dot_plain(ap, an, bp, bn)
    self_dot = popcount_dot(ap, an, ap, an)
    nnz_a = int(popcount(ap).sum() + popcount(an).sum())
    torch.cuda.synchronize()
    check(torch.equal(dot, dot_plain),
          f"popcount_dot: {int(dot)} != plain {int(dot_plain)}")
    check(int(self_dot) == nnz_a,
          f"popcount_dot: dot(a, a) {int(self_dot)} != nnz(a) {nnz_a}")
    t8 = cuda_ms(torch, lambda: popcount_dot(ap, an, bp, bn), 50)
    t8p = cuda_ms(torch, lambda: popcount_dot_plain(ap, an, bp, bn), 3)
    b8, by8 = bound_ms(4 * W * 4 + 4, 11.0 * W)
    log(f"  popcount_dot over two [{W}]-word plane pairs: {int(dot)} "
        f"bitwise equal to the plain version; dot(a, a) = nnz(a) = {nnz_a}")
    del a, b, ap, an, bp, bn

    d, f = cfg.d_model, cfg.pattern[0].ffn.d_ff
    k6 = []
    for name, (K, N) in (("ffn_down", (f, d)), ("wq", (d, d)),
                         ("wg", (d, f))):
        pos, neg = rand_planes(torch, (3, K, N // 32), gen, dev)
        x = torch.randn((4, K), generator=gen, device=dev)
        scales = torch.tensor([0.021, 0.013, 0.008], device=dev)
        got = ternary_matmul(x, pos[1], neg[1], scales[1])
        plain = ternary_matmul_plain(x, pos[1], neg[1], scales[1])
        grouped = ternary_matmul_grouped(
            x, pos, neg, scales, torch.ones(4, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        tol = 1e-4 * float(plain.abs().max())
        check(err <= tol, f"ternary_matmul {name}: err {err} > tol {tol}")
        check(torch.equal(got, grouped), f"ternary_matmul {name}: rows "
              "differ from the grouped kernel's rows on the same expert")
        t6 = graph_ms(torch, lambda: ternary_matmul(  # noqa: B023
            x, pos[1], neg[1], scales[1]))
        t6p = cuda_ms(torch, lambda: ternary_matmul_plain(  # noqa: B023
            x, pos[1], neg[1], scales[1]), 5)
        dense = dense_of_planes(pos[1], neg[1], N)
        t_cublas = cuda_ms(torch, lambda: x @ dense, 50)  # noqa: B023
        nnz6 = float(dense.abs().sum())
        b6, by6 = bound_ms(4 * K * 4 + 2 * K * (N // 32) * 4 + 4 + 4 * N * 4,
                           2.0 * nnz6 * 4)
        k6.append({"name": name, "max_abs_err": err, "ms": t6,
                   "plain_ms": t6p, "bound_ms": b6, "bound_by": by6,
                   "cublas_dense_ms": t_cublas,
                   "shape": f"x [4, {K}], planes [{K}, {N // 32}]"})
        log(f"  ternary_matmul {name} x [4, {K}] @ planes [{K}, {N // 32}]: "
            f"max|err| {err:.3e} (tol {tol:.3e}); every row bitwise equal "
            f"to the grouped kernel's; {t6:.4f} ms by CUDA graph (bound "
            f"{b6:.5f}, plain {t6p:.3f}, cuBLAS on the dense matrix "
            f"{t_cublas:.4f})")
        del pos, neg, dense
    err = max(r["max_abs_err"] for r in k6)
    main6 = k6[0]
    report["pack_ternary_planes"] = {
        "max_abs_err": 0.0, "ms": t7, "plain_ms": t7p, "bound_ms": b7,
        "bound_by": by7, "library_ms": None,
        "library_note": "null: no PyTorch call packs bits",
        "shape": f"tied embedding's size viewed flat: tau [1, {n}] f32"}
    report["popcount_dot"] = {
        "max_abs_err": 0.0, "ms": t8, "plain_ms": t8p, "bound_ms": b8,
        "bound_by": by8, "library_ms": None,
        "library_note": "null: no PyTorch call counts bits",
        "shape": f"two plane pairs of the tied embedding's size, 4 x [{W}] "
                 "int32"}
    report["ternary_matmul"] = {
        "max_abs_err": err, "ms": main6["ms"], "plain_ms": main6["plain_ms"],
        "bound_ms": main6["bound_ms"], "bound_by": main6["bound_by"],
        "library_ms": None,
        "library_note": "null: no PyTorch call unpacks bit planes",
        "cublas_dense_ms": main6["cublas_dense_ms"],
        "cublas_dense_note": "x @ W on the unpacked f32 ternary matrix: "
                             "another input, a yardstick",
        "timing": "CUDA graph of 50 launches (device time)",
        "shape": f"FFN down: {main6['shape']}", "shapes": k6}
    log(f"  pack_ternary_planes {t7:.4f} ms (bound {b7:.4f}), popcount_dot "
        f"{t8:.4f} ms (bound {b8:.4f})")


SAMPLER_SHAPES = ((4, 151936), (4, 32000), (4, 256000))
# operations of csrc/sample.cu: threefry-2x32 is 72 integer ops (2 key
# adds, 20 rounds of add, funnel rotate and xor, 10 injection adds), the
# bits and mantissa 3 more, for each element drawn; then about 10 f32
# operations (uniform 4, two logf, two negations, the add of the logit,
# the compare).  Every element is divided by T (one f32 operation).  With
# a cut, the fast path (top_k < 2048) of the radix select touches every
# element twice: the first digit pass (the order map, 5 operations, the
# top digit's shift and the shared-memory count) and the candidate test
# (the order map again and a compare), 13 integer operations.  Only the
# candidates (keys whose top digit is at least the k-th largest's) take
# the last two digit passes (each the order map, the prefix mask and
# compare, the digit's shift and mask, the count) and the survivor test,
# 21 more, and only the survivors are drawn.
SAMPLER_INT_OPS = 75
SAMPLER_F32_OPS = 10
SAMPLER_SELECT_OPS = 13
SAMPLER_CANDIDATE_OPS = 21


def sampler_inputs(torch, B, V, dtype, seed, dev, grid=None):
    """Logits [B, V] in ``dtype`` (bf16 as the model hands them on the
    card), on a grid of ``grid`` when given (so the k-th value is tied
    many times), keys from (seed, uid) and stream positions up to 2**31."""
    from repro_torch.serve import sampling
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
    if grid:
        logits = torch.round(logits / grid) * grid
    uids = [7, 2014, 2 ** 31, 2 ** 32 - 1][:B]
    gen = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31][:B], device=dev)
    return (logits.to(dtype).contiguous(),
            sampling.row_keys(seed, uids).to(dev), gen)


def sampler_order(torch, x):
    """The order-preserving keys of f32 ``x`` that the kernel selects by
    (-0.0 takes the key of +0.0), as int64."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)


def sampler_work(torch, x, T, top_k) -> tuple[int, int]:
    """This run's candidates (keys whose top 11-bit digit is at least
    the k-th largest's: what the fast path's last two digit passes see;
    0 without a cut) and survivors (the elements drawn) for logits ``x``."""
    from repro_torch.kernels.sample import scale_and_mask
    masked = scale_and_mask(x, T, top_k)
    drawn = int(torch.isfinite(masked).sum())
    if not 0 < top_k < x.shape[-1]:
        return 0, drawn
    scaled = scale_and_mask(x, T, 0)
    kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
    top = sampler_order(torch, scaled) >> 21
    return int((top >= sampler_order(torch, kth) >> 21).sum()), drawn


def sampler_bound(B, V, itemsize, candidates, drawn,
                  cut) -> tuple[float, str]:
    """The fused sampler's least time: its bytes (logits read once, keys,
    gen and tokens) or its operations, integer and f32 on their own lanes:
    the division of every element, the selection's work when there is a
    cut (on the fast path, top_k < 2048, the timed one: every element's
    first pass and candidate test, and this run's
    ``candidates``' last passes), and the draw of the ``drawn`` elements
    (the survivors of this run's inputs; every element without a cut)."""
    n = B * V
    t_bytes = (itemsize * n + 28 * B) / HBM_BYTES_PER_S
    int_ops = ((SAMPLER_SELECT_OPS * n + SAMPLER_CANDIDATE_OPS * candidates
                if cut else 0) + SAMPLER_INT_OPS * drawn)
    # F32_OPS_PER_S counts an FMA as two: an f32 instruction costs two
    f32_ops = 2 * n + SAMPLER_F32_OPS * drawn
    t_ops = max(int_ops / INT32_OPS_PER_S, 2 * f32_ops / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_fused_sampler(torch, x, keys, gen, T, top_k, what):
    """One case: tokens and noise bitwise the plain version's, the
    noise-free launch the same tokens, each row equal launched alone."""
    from repro_torch.kernels.sample import sample_tokens, sample_tokens_plain
    tok, noise = sample_tokens(x, keys, gen, T, top_k, noise=True)
    want, wnoise = sample_tokens_plain(x, keys, gen, T, top_k, noise=True)
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, noise), bits(torch, wnoise)),
          f"sampler {what} T={T} top_k={top_k}: noise differs from the "
          "plain version's")
    check(torch.equal(tok, want), f"sampler {what} T={T} top_k={top_k}: "
          f"tokens {tok.tolist()} vs plain {want.tolist()}")
    check(torch.equal(sample_tokens(x, keys, gen, T, top_k), tok),
          f"sampler {what} T={T} top_k={top_k}: the noise-free launch "
          "differs")
    for b in range(x.shape[0]):
        alone = sample_tokens(x[b:b + 1], keys[b:b + 1], gen[b:b + 1], T,
                              top_k)
        check(torch.equal(alone, tok[b:b + 1]),
              f"sampler {what} T={T} top_k={top_k}: row {b} differs alone")


def check_sampler(torch, dev, report):
    """The fused sampler (``sample_tokens``: scale, top-k cut, draw)
    against its plain version on the card, bitwise (tokens, and the noise
    in check mode), at the vocabularies of the three configs (B = 4), f32
    and bf16 logits, T in {0.7, 1.0}, top_k in {0, 1, 40, 1000, V - 1, V},
    stream positions up to 2**31, and bf16 logits on a grid of 0.5 whose
    k-th value is tied many times (with rows whose k-th value is +-0.0);
    every row also launched alone.  Then, at each shape with bf16 logits
    and T 0.8, the device ms by CUDA graph of the fused kernel (top_k 40
    and 0), its plain version, ``torch.topk`` alone
    (the selection stage's library yardstick) and the composite path the
    fused kernel replaced (PyTorch scale, topk and where, then the kernel
    without a cut), beside the bound."""
    from repro_torch.kernels.sample import (sample_gumbel_argmax,
                                            sample_tokens,
                                            sample_tokens_plain,
                                            scale_and_mask)
    rows = []
    for i, (B, V) in enumerate(SAMPLER_SHAPES):
        cases = 0
        for dtype in (torch.float32, torch.bfloat16):
            x, keys, gen = sampler_inputs(torch, B, V, dtype, 100 + i, dev)
            for T in (0.7, 1.0):
                for top_k in (0, 1, 40, 1000, V - 1, V):
                    check_fused_sampler(torch, x, keys, gen, T, top_k,
                                        f"[{B}, {V}] {dtype}")
                    cases += 1
        x, keys, gen = sampler_inputs(torch, B, V, torch.float32, 150 + i,
                                      dev, grid=0.5)
        x[2] = -1.0 - torch.rand(V, generator=torch.Generator(
            device=dev).manual_seed(i), device=dev)
        x[2, :10], x[2, 10:30], x[2, 30:50] = 0.5, 0.0, -0.0
        x[3] = x[2].flip(0)
        x = x.to(torch.bfloat16)
        for step in range(3):        # zeros of both signs win draws
            for T in (0.7, 1.0):
                for top_k in (1, 10, 11, 40, 1000, V - 1):
                    check_fused_sampler(torch, x, keys, gen + step, T, top_k,
                                        f"[{B}, {V}] tied bf16")
                    cases += 1
        kept = torch.isfinite(scale_and_mask(x, 1.0, 40)).sum(-1).tolist()
        check(kept[2:] == [50, 50], f"sampler [{B}, {V}]: {kept[2:]} of the "
              "50 values at or above a +-0.0 threshold kept")

        x, keys, gen = sampler_inputs(torch, B, V, torch.bfloat16, 200 + i,
                                      dev)
        row = {"B": B, "V": V, "dtype": "bfloat16", "temperature": 0.8,
               "cases_checked": cases}
        for top_k in (40, 0):
            def fused(k=top_k):
                return sample_tokens(x, keys, gen, 0.8, k)

            def plain(k=top_k):
                return sample_tokens_plain(x, keys, gen, 0.8, k)

            def composite(k=top_k):
                return sample_gumbel_argmax(scale_and_mask(x, 0.8, k), keys,
                                            gen)

            cand, drawn = sampler_work(torch, x, 0.8, top_k)
            b, by = sampler_bound(B, V, x.element_size(), cand, drawn,
                                  top_k > 0)
            r = {"ms": graph_ms(torch, fused, 50),
                 "plain_ms": graph_ms(torch, plain, 4, 3),
                 "composite_ms": graph_ms(torch, composite, 10),
                 "bound_ms": b, "bound_by": by, "candidates": cand,
                 "drawn": drawn}
            if top_k:
                x32 = scale_and_mask(x, 0.8, 0)
                r["topk_ms"] = graph_ms(torch, lambda: torch.topk(  # noqa: B023
                    x32, top_k, dim=-1), 20)
            row[f"top_k_{top_k}"] = r
            log(f"  sampler [{B}, {V:6d}] bf16 top_k {top_k:2d}: fused "
                f"{r['ms']:.4f} ms by CUDA graph (bound {b:.5f}, {by}, "
                f"{cand} candidates, {drawn} drawn), composite "
                f"{r['composite_ms']:.4f}, plain {r['plain_ms']:.3f}" + (
                    f", torch.topk {r['topk_ms']:.4f}" if top_k else ""))
        rows.append(row)
        log(f"  sampler [{B}, {V:6d}]: {cases} cases bitwise the plain "
            "version (tokens and noise, f32 and bf16, T 0.7/1.0, top_k 0, 1,"
            " 40, 1000, V-1, V, tied thresholds, each row alone)")
    head = rows[0]["top_k_40"]
    report["sample_tokens"] = dict(
        max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["topk_ms"], shapes=rows,
        shape=f"logits [{rows[0]['B']}, {rows[0]['V']}] bf16, T 0.8, "
              "top_k 40",
        library_note="torch.topk(scaled, 40) alone: the selection stage "
                     "only (no PyTorch call draws on JAX's threefry stream)",
        timing="CUDA graph of 50 launches (device time); the plain "
               "version's launches by CUDA graph too")


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def finetune(torch, base, gen, scale=0.01):
    """base + seeded noise on every leaf, made on the card: each leaf's
    noise scaled and the leaf added in place (the values of ``l.float() +
    scale * noise``, with one f32 temporary a leaf)."""
    from repro_torch import tree as tree_util

    def leaf(l):
        r = torch.randn(l.shape, generator=gen, device=l.device)
        return r.mul_(scale).add_(l).to(l.dtype)
    return tree_util.tree_map(leaf, base)


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


def grouped_launch_shapes(torch, engine, wave) -> dict:
    """Every launch of the grouped kernel in one serve of ``wave``,
    counted by (M, K, N, transposed) through a counting stand-in in the
    dispatch table the model reads (``ops.kernel``).  A CUDA graph calls
    the wrapper only while it is captured, so the shapes are counted on
    the eager loop (``decode_chunk=0``) of an engine like ``engine``; its
    tokens must equal the graph engine's bitwise, and the graph engine's
    launches of a warm serve of the same wave (prefill launches plus each
    replay's count) must add up to the eager count."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    real, counts = ops.KERNELS["ternary_matmul_grouped"], {}

    def counting(x, pos, neg, scales, eid, *, transpose_rhs=False):
        N = pos.shape[1] if transpose_rhs else pos.shape[2] * 32
        key = (x.shape[0], x.shape[1], N, transpose_rhs)
        counts[key] = counts.get(key, 0) + 1
        return real(x, pos, neg, scales, eid, transpose_rhs=transpose_rhs)

    eager = ServeEngine(engine.api, engine.base, engine.registry,
                        dataclasses.replace(engine.cfg, decode_chunk=0))
    prev = ops._table
    ops._table = dict(prev, ternary_matmul_grouped=counting)
    try:
        reqs = fresh(wave, 900)
        eager.run(reqs)
    finally:
        ops._table = prev
    del eager
    check([r.out_tokens for r in reqs] == [r.out_tokens for r in wave],
          "the eager loop gave other tokens than the graph chunks")
    c0 = engine.swap_summary()["graph_captures"]
    ops.reset_launch_counts()
    graphed = fresh(wave, 950)
    engine.run(graphed)
    torch.cuda.synchronize()
    n = ops.launch_counts()["ternary_matmul_grouped"]
    check(engine.swap_summary()["graph_captures"] == c0,
          "a warm serve of the wave captured a graph")
    check(n == sum(counts.values()), f"grouped launches: {n} through the "
          f"graphs, {sum(counts.values())} on the eager loop")
    log(f"  eager loop: tokens bitwise the graph chunks'; {n} grouped "
        "launches per wave on both (the graphs' counted per replay)")
    return counts


def grouped_shape_rows(torch, engine, wave) -> list:
    """The grouped kernel at every shape one warm wave launches it with
    (decode M = 4, prefill M = 4 T over the padded prompt length T), on
    the wave's own expert planes (unit 0 of each projection, the untied
    head, the embedding for the tied head) and its own expert indices:
    device ms by CUDA graph, the bound (bytes read once per distinct
    expert, or 2 ops per nonzero weight per row), and launches per wave.
    A decode row also times the same launch on a stack of only the wave's
    experts (the cost of the engine's empty slots).  Each shape's launch
    is held against the plain version on the same inputs, within phase
    2's tolerance (1e-4 of the largest |plain|).  Returns the rows; the
    head's decode row carries its inputs under ``"inputs"``."""
    from repro_torch import tree as tree_util
    from repro_torch.core.packing import popcount
    from repro_torch.kernels.ternary_matmul import (
        launch_cols, ternary_matmul_grouped, ternary_matmul_grouped_plain)
    from repro_torch.models.delta import MatmulDelta, slice_unit
    experts = list(dict.fromkeys(r.expert for r in wave))
    ov = engine._overlay_for(tuple(experts))
    cfg = engine.api.cfg
    eid = torch.as_tensor([engine.slot_of(r.expert) for r in wave],
                          dtype=torch.int32, device=engine.dev)
    planes = {}                   # (K, N, transposed) -> (names, pos, neg, s)
    leaves = tree_util.flatten_with_paths(slice_unit(ov["blocks"], 0))
    if isinstance(ov.get("lm_head"), MatmulDelta):
        leaves.append(("lm_head", ov["lm_head"]))
    for path, md in leaves:
        if not isinstance(md, MatmulDelta):
            continue
        key = (md.pos.shape[1], 32 * md.pos.shape[2], False)
        names = planes[key][0] if key in planes else []
        name = "/".join(path.split("/")[-2:])
        planes[key] = (names + [name] * (name not in names), md.pos, md.neg,
                       md.scales)
    if cfg.tie_embeddings:
        ed = ov["embed"]
        planes[(cfg.d_model, ed.pos.shape[1], True)] = (
            ["tied_head"], ed.pos, ed.neg, ed.scales)
    counts = grouped_launch_shapes(torch, engine, wave)
    g = torch.Generator(device=engine.dev).manual_seed(3)
    rows = []
    for (M, K, N, tr), n_launch in sorted(counts.items()):
        names, pos, neg, scales = planes[(K, N, tr)]
        E, _, W = pos.shape
        x = torch.randn((M, K), generator=g, device=engine.dev)
        ids = torch.repeat_interleave(eid, M // len(wave))
        run = lambda: ternary_matmul_grouped(  # noqa: E731, B023
            x, pos, neg, scales, ids, transpose_rhs=tr)
        t = graph_ms(torch, run, 20 if M > len(wave) else 50)
        nnz = [int(popcount(pos[e] ^ neg[e]).sum()) for e in range(E)]
        used = {int(e) for e in ids.tolist() if e >= 0}
        ops = sum(2 * nnz[int(e)] for e in ids.tolist() if e >= 0)
        nbytes = (M * K * 4 + len(used) * 2 * W * pos.shape[1] * 4 + E * 4
                  + M * 4 + M * N * 4)
        b, by = bound_ms(nbytes, ops)
        row = {"names": names, "phase": "decode" if M == len(wave) else
               "prefill", "M": M, "K": K, "N": N, "transpose_rhs": tr,
               "cols": launch_cols(N, tr),
               "launches_per_wave": n_launch, "ms": t, "bound_ms": b,
               "bound_by": by, "distinct_experts": len(used)}
        want = ternary_matmul_grouped_plain(x, pos, neg, scales, ids,
                                            transpose_rhs=tr)
        err = float((run() - want).abs().max())
        tol = 1e-4 * float(want.abs().max()) + 1e-30
        check(err <= tol, f"grouped {names} M={M} K={K} N={N}: err {err} "
              f"> tol {tol} against the plain version")
        row["max_abs_err"], row["tol"] = err, tol
        del want
        if M == len(wave):
            # the same launch on a stack of only the wave's experts: the
            # cost of the engine's empty slots, bitwise the same rows
            keep = sorted(used)
            idx = torch.as_tensor(keep, device=engine.dev)
            pc, nc, sc = pos[idx].contiguous(), neg[idx].contiguous(), \
                scales[idx].contiguous()
            ids_c = torch.as_tensor([keep.index(e) if e >= 0 else -1
                                     for e in ids.tolist()],
                                    dtype=torch.int32, device=engine.dev)
            run_c = lambda: ternary_matmul_grouped(  # noqa: E731, B023
                x, pc, nc, sc, ids_c, transpose_rhs=tr)
            check(torch.equal(run(), run_c()), f"grouped {names}: the slot "
                  "stack and the wave's own stack give other rows")
            row["ms_compact"] = graph_ms(torch, run_c, 50)
            row["slots"] = E
            if N == cfg.vocab:
                row["inputs"] = (x, pos, neg, scales, ids)
        rows.append(row)
        log(f"  grouped {', '.join(names):20s} M={M:3d} K={K:5d} N={N:6d}: "
            f"{t:.4f} ms by CUDA graph (bound {b:.5f}, {by}), "
            f"{n_launch} launches per wave"
            + (f"; {row['ms_compact']:.4f} ms on the wave's {len(used)} "
               f"experts alone (not {E} slots)" if "ms_compact" in row
               else ""))
    check(any("inputs" in r for r in rows), "no head launch in the wave")
    return rows


def grouped_timing(torch, engine, wave, report):
    """Phase 3's grouped-kernel numbers (:func:`grouped_shape_rows`); the
    tied head at decode is the kernel's headline row, and its plain
    version is timed there too."""
    from repro_torch.kernels.ternary_matmul import ternary_matmul_grouped_plain
    rows = grouped_shape_rows(torch, engine, wave)
    row = next(r for r in rows if "inputs" in r)
    x, pos, neg, scales, ids = row.pop("inputs")
    tp = cuda_ms(torch, lambda: ternary_matmul_grouped_plain(
        x, pos, neg, scales, ids, transpose_rhs=True), 3)
    est = sum(r["ms"] * r["launches_per_wave"] for r in rows)
    pad = sum((r["ms"] - r["ms_compact"]) * r["launches_per_wave"]
              for r in rows if "ms_compact" in r)
    report["ternary_matmul_grouped"].update(
        ms=row["ms"], plain_ms=tp, bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None,
        timing="CUDA graph of 50 launches (device time)",
        shape=f"tied head, transpose_rhs: x [{row['M']}, {row['K']}], "
              f"planes {list(pos.shape)}, {row['distinct_experts']} "
              "distinct experts",
        shapes=rows, wave_ms_from_shapes=est, slot_padding_ms_per_wave=pad)
    log(f"  grouped kernel per wave from these times: {est:.2f} ms over "
        f"{sum(r['launches_per_wave'] for r in rows)} launches; the empty "
        f"expert slots cost the decode launches {pad:.3f} ms per wave")


def planes_check(torch, expert) -> dict:
    """The expert's planes bitwise equal to the plain compression of its
    tau (the same density 0.1), its scales within a relative 1e-4."""
    from repro_torch import tree as tree_util
    from repro_torch.core.compeft import CompressionConfig, compress_packed
    from repro_torch.expert import DENSE, PACKED
    from repro_torch.kernels import ops
    with ops.plain_versions():
        want = compress_packed(expert.as_(DENSE),
                               CompressionConfig(density=0.1))
    got = expert.as_(PACKED)
    n_leaves, worst_scale = 0, 0.0
    for (path, w), (_, g) in zip(
            tree_util.flatten_with_paths(want, is_leaf=_is_pt),
            tree_util.flatten_with_paths(got, is_leaf=_is_pt)):
        check(torch.equal(w.pos, g.pos) and torch.equal(w.neg, g.neg),
              f"expert {expert.name} {path}: planes differ from the plain "
              "compression")
        rel = abs(float(w.scale) - float(g.scale)) / max(float(w.scale),
                                                         1e-30)
        check(rel <= 1e-4, f"expert {expert.name} {path}: scale rel err "
              f"{rel}")
        worst_scale = max(worst_scale, rel)
        n_leaves += 1
    del want
    log(f"  {expert.name}: planes of {n_leaves} leaves bitwise equal to the "
        f"plain compression; scales within rel {worst_scale:.2e} (tol 1e-4)")
    return {"leaves": n_leaves, "worst_scale_rel": worst_scale}


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


def near_tie(torch, engine, r, tokens, other, what, gate=True):
    """Where two streams of request ``r`` first part, both candidates must
    lie within about one bf16 ulp of the top logit's own value (2**-7 *
    |top|, one ulp at least and under two), recomputed by a prefill over
    the prompt and the common tokens before the divergence (on the
    overlay, or on the expert's merged params when the engine serves by
    merge-on-swap).  On a sampled
    engine the scores are the draw's (the scaled, top-k masked logits
    plus the gumbel noise of the request's stream at that token) and the
    ulp is divided by the temperature.  Returns the divergence
    (``within`` says whether it met the rule), or None when the streams
    are equal; with ``gate`` a divergence beyond the rule fails the
    run."""
    if tokens == other:
        return None
    s = next(i for i, (a, b) in enumerate(zip(tokens, other)) if a != b)
    ctx = torch.cat([torch.as_tensor(r.prompt, dtype=torch.int64),
                     torch.as_tensor(tokens[:s], dtype=torch.int64)])
    if engine._plan is None:        # merge-on-swap: the merged params
        params, kw = engine._params_for(r.expert), {}
    else:
        params, kw = engine.base, dict(
            delta=engine._overlay_for((r.expert,)),
            eid=torch.full((1,), engine.slot_of(r.expert),
                           dtype=torch.int32, device=engine.dev))
    logits, _ = engine.api.prefill(
        params, {"tokens": ctx[None].to(engine.dev),
                 **engine._frontend_stub(1)}, engine.cfg.cache_len, **kw)
    lg = logits[0, -1].float()
    tol = 2.0 ** -7 * abs(float(lg.max()))
    samp = engine.cfg.sampling
    if not samp.greedy:
        from repro_torch.kernels.sample import scale_and_mask
        from repro_torch.serve.sampling import fold_in, gumbel, row_keys
        key = fold_in(row_keys(samp.seed, [r.uid]), torch.tensor([s]))
        lg = (scale_and_mask(lg[None].cpu(), samp.temperature, samp.top_k)
              + gumbel(key, lg.numel()))[0]
        tol /= max(samp.temperature, 1e-6)
    top = float(lg.max())
    gaps = (top - float(lg[tokens[s]]), top - float(lg[other[s]]))
    entry = {"uid": r.uid, "step": s, "tokens": (tokens[s], other[s]),
             "gaps": gaps, "top": top, "tol": tol,
             "within": max(gaps) <= tol}
    log(f"  request {r.uid}: {what} first differ at step {s}; gaps to the "
        f"top logit {top:.4f}: {gaps[0]:.4f} / {gaps[1]:.4f} (tol "
        f"{tol:.4f})")
    check(entry["within"] or not gate, f"request {r.uid}: {what} differ at "
          f"step {s} beyond a near-tie: {entry}")
    return entry


def solo_check(torch, engine, reqs, gate=True):
    """Each request served alone vs in its mixed wave.

    Alone, a request has no left padding (other rope positions), other
    batch shapes (other cuBLAS and reduction configurations) and other
    attention lengths, so its bf16 logits are not bitwise those of its
    wave row.  The gate: the tokens are equal, or they part first at a
    near-tie in the solo context (:func:`near_tie`).  The primary gate of
    the mixed-wave contract is :func:`row_independence_check`, which is
    bitwise.
    """
    from repro_torch.serve import Request
    out = {"exact": 0, "near_tie": []}
    for r in reqs:
        solo = Request(uid=100 + r.uid, expert=r.expert, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
        engine.run([solo])
        entry = near_tie(torch, engine, r, solo.out_tokens, r.out_tokens,
                         "solo and mixed", gate)
        if entry is None:
            out["exact"] += 1
        else:
            out["near_tie"].append(entry)
    log(f"  solo serves: {out['exact']} of {len(reqs)} token streams equal "
        f"the mixed wave's; {sum(e['within'] for e in out['near_tie'])} "
        "part at near-ties, "
        f"{sum(not e['within'] for e in out['near_tie'])} beyond")
    return out


def profile_wave(torch, engine, wave, out_dir, name="profile_wave"):
    """torch.profiler over one warm serve of a wave (prefill + 16 tokens;
    or phase 3d's refill traffic): device time by kernel family, split
    into prefill and decode, and the device's idle share of the wall
    time.  The engine synchronises after the prefill, so every kernel
    that starts before the first decode chunk (marked with
    ``record_function``) belongs to the prefill; later admissions'
    prefills fall in the decode part, and a merge-on-swap engine's merge
    (the merge kernel) in the prefill part.  Each chunk is a CUDA graph
    replay, whose kernels the trace lists one by one.  The full table goes
    to chiprun_out/<name>.txt."""
    from torch.profiler import ProfilerActivity, profile, record_function
    reqs = fresh(wave, 300)
    chunk_fn = engine._chunk_fn

    def marked_chunk(*args, **kwargs):
        with record_function("decode_chunk"):
            return chunk_fn(*args, **kwargs)

    engine._chunk_fn = marked_chunk
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine.run(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        engine._chunk_fn = chunk_fn

    def family(name):
        name = name.lower()
        return ("grouped ternary kernel" if "grouped" in name else
                "merge kernel" if "unpack_add" in name else
                "sampler kernel" if name.startswith("sample_") or
                "::sample_" in name else
                "cuBLAS GEMM" if any(s in name for s in (
                    "gemm", "cutlass", "xmma", "sm90", "nvjet")) else
                "other PyTorch kernels")

    families = {"grouped ternary kernel": 0.0, "merge kernel": 0.0,
                "sampler kernel": 0.0, "cuBLAS GEMM": 0.0,
                "other PyTorch kernels": 0.0}
    launches = {k: 0 for k in families}
    # the marker's own device-side range is an annotation, not a kernel
    kernels = sorted((ev for ev in prof.key_averages()
                      if ev.device_type.name == "CUDA"
                      and ev.key != "decode_chunk"),
                     key=lambda ev: -ev.self_device_time_total)
    for ev in kernels:
        fam = family(ev.key)
        families[fam] += ev.self_device_time_total / 1e3
        launches[fam] += ev.count
    busy = sum(families.values())
    # prefill / decode split on the trace's own timeline
    events = prof.events()
    marks = [ev.time_range.start for ev in events if ev.name == "decode_chunk"]
    split = None
    if marks:
        t_dec = min(marks)
        split = {ph: {k: 0.0 for k in families} for ph in ("prefill",
                                                           "decode")}
        for ev in events:
            if ev.device_type.name != "CUDA" or ev.name == "decode_chunk":
                continue
            ph = "prefill" if ev.time_range.start < t_dec else "decode"
            split[ph][family(ev.name)] += ev.time_range.elapsed_us() / 1e3
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write("device_ms\tlaunches\tkernel\n")
        for ev in kernels:
            f.write(f"{ev.self_device_time_total / 1e3:.3f}\t{ev.count}\t"
                    f"{ev.key}\n")
    # torch.topk's kernels (gatherTopK, radixFindKthValues, ...)
    topk = sum(ev.count for ev in kernels
               if "topk" in ev.key.lower() or "radix" in ev.key.lower())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "topk_launches": topk,
           "device_ms_by_family": families, "launches_by_family": launches,
           "device_ms_by_phase": split}
    log(f"  {name}: " + "one warm serve: wall {:.1f} ms, device busy {:.1f} ms"
        " ({})".format(wall_ms, busy, ", ".join(
            f"{k} {v:.1f} ms / {launches[k]} launches"
            for k, v in families.items())))
    if split:
        for ph, fams in split.items():
            log(f"  {ph}: device {sum(fams.values()):.2f} ms (" + ", ".join(
                f"{k} {v:.2f}" for k, v in fams.items()) + ")")
    return out


def profile_compress(torch, tau, out_dir):
    """torch.profiler over one warm ``compress_packed`` of a full-width
    expert (density 0.1): device ms by pass, and the host share (the part
    of the wall time in which the device is idle).  Each pass is marked
    with ``record_function`` around its call: the segment buffer's build,
    the absmax, the coarse sweep (with its segment-moment reduction), the
    refine sweep and the pack.  One stream runs the kernels in launch
    order, so a pass's device range holds its kernels (memsets and copies
    included) and nothing else; every other kernel (keep counts, bin
    selection, thresholds, scales) is counted as bin selection.  The full
    list goes to chiprun_out/profile_compress.txt."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from repro_torch.core import compeft
    from repro_torch.kernels import ops
    cfg = compeft.CompressionConfig(density=0.1)
    compeft.compress_packed(tau, cfg)
    torch.cuda.synchronize()

    def marked(name, fn):
        def call(*args, **kwargs):
            with record_function(name(kwargs) if callable(name) else name):
                return fn(*args, **kwargs)
        return call

    marks = ("buffer build", "absmax", "coarse", "refine", "pack")
    build_buf, prev = compeft._build_segment_buffer, ops._table
    compeft._build_segment_buffer = marked("buffer build", build_buf)
    ops._table = dict(
        prev, segment_absmax=marked("absmax", prev["segment_absmax"]),
        segment_hist_moments=marked(
            lambda kw: "coarse" if kw.get("with_moments", True) else "refine",
            prev["segment_hist_moments"]),
        pack_ternary_planes_segmented=marked(
            "pack", prev["pack_ternary_planes_segmented"]))
    try:
        # a warm-up cycle, whose events are dropped: without it the tracer
        # has missed the device ranges of the first marked passes
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            compeft.compress_packed(tau, cfg)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.monotonic()
            compeft.compress_packed(tau, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        compeft._build_segment_buffer, ops._table = build_buf, prev

    # the schedule's own range (ProfilerStep#n) is an annotation too
    cuda = [ev for ev in prof.events() if ev.device_type.name == "CUDA"
            and not ev.name.startswith("ProfilerStep")]
    spans = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in cuda
             if ev.name in marks]
    passes = dict.fromkeys(("buffer build", "absmax", "coarse", "refine",
                            "bin selection", "pack"), 0.0)
    rows = []
    for ev in sorted((ev for ev in cuda if ev.name not in marks),
                     key=lambda ev: ev.time_range.start):
        t = ev.time_range.start
        k = next((n for t0_, t1_, n in spans if t0_ <= t < t1_),
                 "bin selection")
        ms = ev.time_range.elapsed_us() / 1e3
        passes[k] += ms
        rows.append((k, ms, ev.name))
    with open(os.path.join(out_dir, "profile_compress.txt"), "w") as f:
        f.write("pass\tdevice_ms\tkernel\n")
        for k, m, name in rows:
            f.write(f"{k}\t{m:.4f}\t{name}\n")
    check(len(spans) == len(marks), "profile_compress: the device ranges of "
          f"the marked passes were not all traced ({len(spans)} of "
          f"{len(marks)})")
    busy = sum(passes.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "host_share": 1 - busy / wall_ms, "device_ms_by_pass": passes,
           "device_launches": len(rows)}
    log(f"  profile of one compress_packed: wall {wall_ms:.2f} ms, device "
        f"busy {busy:.2f} ms (host share {out['host_share']:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    return out


def logits_check(torch, engine, wave, gate=True, f32=False):
    """First decode step of a wave through the kernels vs the plain
    versions, both on the card from the same prefill cache.

    Tolerance (bf16-aware): every logit within about one bf16 ulp of its
    own value, |kernel - plain| <= 2**-7 * max(|kernel|, |plain|).  The
    kernel's f32 delta sums differ from the plain sums only in the last
    f32 bits, which a bf16 rounding of the sum nearly always absorbs.  The
    overlay's own effect on the logits (the same step without it) is
    logged beside the error, to show what the check can see.  With
    ``gate=False`` the comparison is reported, not enforced (finite
    logits still are).  ``f32`` (an f32 model, where no bf16 rounding
    absorbs anything): every logit within 1e-4 of the largest |logit|,
    phase 2's tolerance for the kernel's own output (a bound relative to
    each value fails on logits near zero: qwen1.5-110b's f32 copy had 38
    beyond 2**-7 of their value at a largest error of 4.1e-6)."""
    from repro_torch.kernels import ops
    experts = list(dict.fromkeys(r.expert for r in wave))
    ov = engine._overlay_for(tuple(experts))
    eid = torch.as_tensor([engine.slot_of(r.expert) for r in wave],
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
    big = torch.maximum(lk.abs(), lp.abs())
    tol = 1e-4 * big.max() if f32 else 2.0 ** -7 * big
    what = ("1e-4 of the largest |logit|" if f32 else
            "2**-7 * |logit| each")
    err = float(diff.max())
    over = int((diff > tol).sum())
    effect = float((lk - lb).abs().max())
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    check(over == 0 or not gate, f"decode logits: {over} logits differ from "
          f"the plain versions' by more than {what} (max err {err})")
    same = bool(torch.equal(lk.argmax(-1), lp.argmax(-1)))
    check(same or not gate,
          "decode logits: argmax differs from the plain versions'")
    log(f"  first decode step logits{' (f32)' if f32 else ''}: "
        f"max|kernel - plain| {err:.4e} (tol {what}, at most "
        f"{float(tol.max()):.4e}"
        + ("" if gate else f"; reported: {over} beyond it") + "); "
        f"the overlay moves them by up to {effect:.4e}")
    return {"max_abs_err": err, "tol": (
        "1e-4 * max(|kernel|, |plain|) over the step" if f32 else
        "2**-7 * max(|kernel|, |plain|)"),
            "tol_max": float(tol.max()), "overlay_effect": effect,
            "argmax_equal": same, "over_tol": over}


def ensemble_loop(torch, reg, base, names, weights):
    """The reference's ensemble oracle: every leaf merged one weight-scaled
    expert at a time with ``ops.apply_ternary_delta_flat``."""
    from repro_torch import tree as tree_util
    from repro_torch.core.packing import PackedTernary
    from repro_torch.kernels import ops
    packs = [reg.fetch_packed(n) for n in names]
    out = {}
    for path, leaf in tree_util.flatten_with_paths(base):
        acc = leaf
        for pk, w in zip(packs, weights):
            if path in pk:
                pt = pk[path]
                acc = ops.apply_ternary_delta_flat(acc, PackedTernary(
                    pos=pt.pos, neg=pt.neg, scale=pt.scale * w,
                    shape=pt.shape, orig_dtype=pt.orig_dtype))
        out[path] = acc
    return tree_util.unflatten_paths(out)


def merged_params_check(torch, reg, base, names):
    """Every expert's merged params through the kernel bitwise equal to
    those through the plain version."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops
    for name in names:
        got = reg.merged_params(base, [name])
        with ops.plain_versions():
            want = reg.merged_params(base, [name])
        torch.cuda.synchronize()
        for (path, g), (_, w) in zip(tree_util.flatten_with_paths(got),
                                     tree_util.flatten_with_paths(want)):
            check(torch.equal(bits(torch, g), bits(torch, w)),
                  f"merged {name} {path}: kernel differs from plain")
        del got, want
    log(f"  merged params of {', '.join(names)}: every leaf bitwise equal "
        "to the plain versions'")


def merge_effect_check(torch, engine, gengine, reqs):
    """The merge carries the expert: each request alone at batch 1, the
    prefill's last logits on the merged params against those on the base
    plus the expert's overlay.  The gate: their largest difference is
    below a tenth of the overlay's own effect (the largest |overlay -
    base alone|); rounding the merged weights to bf16 moves the logits
    far less than the delta does."""
    api, dev = engine.api, engine.dev
    out = []
    for r in reqs:
        toks = {"tokens": torch.as_tensor(r.prompt, dtype=torch.int64
                                          )[None].to(dev)}
        merged = gengine.registry.merged_params(gengine.base, [r.expert])
        lm, _ = api.prefill(merged, toks, 128)
        lo, _ = api.prefill(engine.base, toks, 128,
                            delta=engine._overlay_for((r.expert,)),
                            eid=torch.full((1,), engine.slot_of(r.expert),
                                           dtype=torch.int32, device=dev))
        lb, _ = api.prefill(engine.base, toks, 128)
        lm, lo, lb = lm.float(), lo.float(), lb.float()
        diff = float((lm - lo).abs().max())
        effect = float((lo - lb).abs().max())
        check(bool(torch.isfinite(lm).all()), "non-finite merged logits")
        check(diff < 0.1 * effect, f"request {r.uid} ({r.expert}): merged "
              f"vs overlay logits differ by {diff}, not below a tenth of "
              f"the overlay's effect {effect}")
        log(f"  request {r.uid} ({r.expert}) alone: max|merged - overlay| "
            f"{diff:.4e}, overlay effect {effect:.4e} (gate: diff < "
            f"{0.1 * effect:.4e})")
        out.append({"uid": r.uid, "expert": r.expert, "max_abs_diff": diff,
                    "overlay_effect": effect})
        del merged
    return out


def artifact_path(torch, api, model, base, experts, reqs, cfg, dev, tmp,
                  before_merges=None):
    """Phase 3c: the rest of the artifact loop on the same experts, each
    step driven with the launch counts set to 0 just before it and read
    just after, its checks between the steps (they launch nothing):

    1. e0's tau compressed again with ``method="exact"`` (the scalar pack
       kernel once per leaf): its planes bitwise ``pack_tree(compress(.))``
       and ``unpack(PACKED)`` bitwise ``compress``'s signs;
    2. the 4 experts saved as ``.cpft`` (Golomb) and e0 also as ``.npz``,
       all loaded back with ``api.load``: e0's two files carry the same
       streams byte for byte;
    3. a cold-Golomb registry over the loaded ``.cpft`` experts serves
       the 8 requests mixed: tokens exactly the mixed path's, and every
       expert's planes, decoded on promotion, bitwise the originals (the
       one decode of each stream: the host codec takes tens of seconds
       per 619 M-parameter expert);
    4. ``pairwise_similarity_matrix`` over the 4 experts and
       ``scaled_dot`` of e0 and e1 per leaf (popcount_dot per pair and
       leaf): equal to the plain versions';
    5. ``api.merge`` of e0-e2 by ``packed``, ``task_arithmetic`` and
       ``ties``: seconds and peak memory; packed bitwise task arithmetic
       (``before_merges()`` first, where given);
    6. ``ops.ternary_matvec`` over unit 0's 2-D projections of each
       expert, a check (no path calls it): within 1e-4 * max |plain| of
       the plain version.

    Returns (numbers, path launches, check launches)."""
    from repro_torch import tree as tree_util
    from repro_torch.core.compeft import CompressionConfig, compress
    from repro_torch.core.merging import pairwise_similarity_matrix
    from repro_torch.core.packing import (PackedTernary, pack_tree,
                                          unpack_tree)
    from repro_torch.core.ternary_ops import scaled_dot
    from repro_torch.expert import DENSE, GOLOMB, PACKED, TERNARY
    from repro_torch.kernels import ops
    out, launches = {}, {}

    def counted(step, fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        result = fn()
        torch.cuda.synchronize()
        out[f"{step}_s"] = time.monotonic() - t0
        for k, v in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        return result

    # 1. the exact compression
    tau = experts[0].as_(DENSE)
    exact = api.compress(tau, name="e0x", density=0.1, method="exact",
                         device=dev)
    counted("exact_compress", lambda: exact.as_(PACKED))
    n_leaves = len(exact.packed)
    check(launches["pack_ternary_planes"] == n_leaves,
          f"exact compression: {launches['pack_ternary_planes']} launches of "
          f"pack_ternary_planes for {n_leaves} leaves")
    tern = compress(tau, CompressionConfig(density=0.1))
    want = dict(tree_util.flatten_with_paths(pack_tree(tern),
                                             is_leaf=_is_pt))
    back = dict(tree_util.flatten_with_paths(unpack_tree(exact.as_(PACKED)),
                                             is_leaf=_is_ct))
    signs = dict(tree_util.flatten_with_paths(tern, is_leaf=_is_ct))
    for path, pt in exact.packed.items():
        check(torch.equal(pt.pos, want[path].pos)
              and torch.equal(pt.neg, want[path].neg)
              and torch.equal(pt.scale, want[path].scale),
              f"exact {path}: planes differ from pack_tree(compress(.))")
        check(torch.equal(back[path].signs, signs[path].signs),
              f"exact {path}: unpack(PACKED) differs from compress's signs")
    del tern, want, back, signs, exact
    log(f"  exact compression of e0: {launches['pack_ternary_planes']} "
        "launches of "
        f"pack_ternary_planes in {out['exact_compress_s']:.3f} s; planes "
        "bitwise pack_tree(compress(.)), unpack(PACKED) bitwise its signs")

    # 2. save and load (host codecs: no kernel).  Loading is lazy: the
    # streams are decoded once, by the cold tier's promotions in step 3,
    # where the decoded planes are held against the originals.
    saved, encode_s, load_s, loaded = {}, {}, {}, {}
    files = [(e, os.path.join(tmp, f"{e.name}.cpft")) for e in experts]
    files.append((experts[0], os.path.join(tmp, "e0.npz")))
    for ex, path in files:
        t0 = time.monotonic()
        saved[path] = api.save(ex, path)
        encode_s[os.path.basename(path)] = time.monotonic() - t0
    for ex, path in files:
        t0 = time.monotonic()
        loaded[os.path.basename(path)] = api.load(path, device=dev)
        load_s[os.path.basename(path)] = time.monotonic() - t0
    npz, cpft = loaded.pop("e0.npz"), loaded["e0.cpft"]
    check(npz.as_(GOLOMB) == cpft.as_(GOLOMB),
          "e0.npz and e0.cpft carry different Golomb streams")
    out.update(
        file_bytes={os.path.basename(p): st["compressed_bytes"]
                    for p, st in saved.items()},
        ratio_vs_bf16={os.path.basename(p): st["ratio"]
                       for p, st in saved.items()},
        golomb_encode_s=encode_s, load_s=load_s)
    log("  saved and loaded: " + ", ".join(
        f"{os.path.basename(p)} {st['compressed_bytes'] / 2 ** 20:.1f} MiB "
        f"(x{st['ratio']:.1f} vs bf16)" for p, st in saved.items())
        + "; e0.npz holds e0.cpft's streams byte for byte")

    # 3. the cold-Golomb tier serving the mixed path's requests
    creg = api.registry(cold_golomb=True, device=dev,
                        device_cache_bytes=16 << 30,
                        experts=list(loaded.values()))
    del loaded, npz, cpft
    ceng = api.serve(model, base, creg, max_batch=4, cache_len=128,
                     decode_chunk=8, continuous=False)
    creqs = fresh(reqs, 800)
    counted("cold_serve", lambda: ceng.run(creqs))
    check([r.out_tokens for r in creqs] == [r.out_tokens for r in reqs],
          "cold-Golomb serve: tokens differ from the mixed path's")
    for ex in experts:
        got = creg.fetch_packed(ex.name)
        for path, pt in ex.packed.items():
            check(torch.equal(got[path].pos, pt.pos)
                  and torch.equal(got[path].neg, pt.neg)
                  and torch.equal(got[path].scale, pt.scale),
                  f"{ex.name}.cpft {path}: planes differ after save, load "
                  "and decode")
    stats = creg.device().stats
    check(stats.promotions == len(experts),
          f"cold tier: {stats.promotions} promotions, expected "
          f"{len(experts)}")
    waves = ceng.wave_log
    out.update(cold_golomb_decode_s=stats.golomb_decode_seconds,
               cold_promotions=stats.promotions,
               cold_decode_tokens_per_s=(
                   sum(w["tokens"] - w["rows"] for w in waves)
                   / sum(w["seconds"] - w["prefill_s"] for w in waves)),
               cold_prefill_ms_per_wave=[w["prefill_s"] * 1e3
                                         for w in waves])
    log(f"  cold-Golomb registry: {stats.promotions} promotions, Golomb "
        f"decode {stats.golomb_decode_seconds:.2f} s; every expert's planes "
        "bitwise the originals; tokens equal the mixed path's")
    del creg, ceng

    # 4. similarity by popcount
    packs = [e.as_(PACKED) for e in experts]
    e0, e1 = experts[0].packed, experts[1].packed
    sim = counted("similarity", lambda: (
        pairwise_similarity_matrix(packs),
        {p: scaled_dot(e0[p], e1[p]) for p in e0}))
    with ops.plain_versions():
        sim_plain = (pairwise_similarity_matrix(packs),
                     {p: scaled_dot(e0[p], e1[p]) for p in e0})
    check(bool((sim[0] == sim_plain[0]).all()),
          f"similarity matrix differs from the plain versions': {sim[0]} "
          f"vs {sim_plain[0]}")
    for p in e0:
        check(torch.equal(sim[1][p], sim_plain[1][p]),
              f"scaled_dot {p}: differs from the plain version's")
    out["similarity"] = sim[0].tolist()
    log(f"  pairwise similarity of e0-e3 by popcount ({launches['popcount_dot']}"
        " launches) and scaled_dot of e0, e1 per leaf: equal to the plain "
        f"versions'; off-diagonal {sim[0][0, 1]:.6f} .. {sim[0][2, 3]:.6f}")

    # 5. merges
    if before_merges is not None:
        before_merges()
    merged, peak, held = {}, {}, {}
    for method in ("packed", "task_arithmetic", "ties"):
        torch.cuda.reset_peak_memory_stats()
        held[method] = torch.cuda.memory_allocated() / 2 ** 30
        merged[method] = counted(f"merge_{method}", lambda: api.merge(
            experts[:3], method=method))   # noqa: B023
        peak[method] = torch.cuda.max_memory_allocated() / 2 ** 30
        if method == "ties":
            del merged[method]
    for (path, a), (_, b) in zip(
            tree_util.flatten_with_paths(merged["packed"]),
            tree_util.flatten_with_paths(merged["task_arithmetic"])):
        check(torch.equal(bits(torch, a), bits(torch, b)),
              f"merge {path}: packed differs from task arithmetic")
    del merged
    for e in experts[:3]:
        e.drop(TERNARY)
    out["merge_peak_gib"], out["merge_held_before_gib"] = peak, held
    log("  api.merge of e0-e2: " + ", ".join(
        f"{m} {out[f'merge_{m}_s']:.2f} s (peak {peak[m]:.2f} GiB, "
        f"{held[m]:.2f} held before)" for m in peak)
        + "; packed bitwise task arithmetic")

    # 6. the single-expert matmul, a check (no path calls it)
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for ex in experts:
        for path, pt in ex.packed.items():
            leaf, name = pt.shape, path.rsplit("/", 1)[-1]
            if not path.startswith("blocks/"):
                continue
            if name in ("wq", "wk", "wv", "wg", "wu"):     # [U, d, ...]
                K, N = leaf[1], math.prod(leaf[2:])
            elif name == "wo":                           # [U, ..., d]
                K, N = math.prod(leaf[1:-1]), leaf[-1]
            else:                                        # biases, norms
                continue
            nw = K * N // 32
            unit0 = PackedTernary(pos=pt.pos[:nw], neg=pt.neg[:nw],
                                  scale=pt.scale, shape=(K, N),
                                  orig_dtype=pt.orig_dtype)
            x = torch.randn((4, K), generator=gen, device=dev)
            y = ops.ternary_matvec(x, unit0)
            with ops.plain_versions():
                yp = ops.ternary_matvec(x, unit0)
            err = float((y - yp).abs().max())
            check(err <= 1e-4 * float(yp.abs().max()) + 1e-30,
                  f"ternary_matvec {ex.name} {path}: err {err}")
            worst = max(worst, err)
    check_launches = ops.launch_counts()
    out["ternary_matvec_max_abs_err"] = worst
    log(f"  ternary_matvec over unit 0's projections of e0-e3 "
        f"({check_launches['ternary_matmul']} launches, a check): max|err| "
        f"{worst:.3e} against the plain version")
    return out, launches, check_launches


def refill_requests(torch, cfg, seed):
    """Phase 3d's traffic: 16 greedy requests over e0-e3 and ``BASE``,
    prompts of 16-64 tokens and budgets of 4-32, drawn from the seed."""
    from repro_torch.serve import BASE, Request
    g = torch.Generator().manual_seed(seed + 13)
    names = ["e0", "e1", "e2", "e3", BASE]
    out = []
    for i in range(16):
        name = names[int(torch.randint(0, 5, (1,), generator=g))]
        L = int(torch.randint(16, 65, (1,), generator=g))
        budget = int(torch.randint(4, 33, (1,), generator=g))
        out.append(Request(uid=2000 + i, expert=name, max_new_tokens=budget,
                           prompt=torch.randint(2, cfg.vocab, (L,),
                                                generator=g)))
    return out


def graph_stats(engine) -> dict:
    s = engine.swap_summary()
    return {k: s[k] for k in ("graphs", "graph_captures", "graph_capture_s",
                              "graph_replays", "admitted")}


def placements(engine, reqs, n0: int) -> list:
    """How each request was placed in the waves logged since ``n0``: at a
    wave's start (its padded prompt length and rows) or admitted into a
    running wave (the wave position and rows)."""
    out = {}
    for w in engine.wave_log[n0:]:
        for u in w["uids"]:
            out[u] = ("wave", w["prompt_len"], w["rows"])
        for u, cur in w["admitted_at"]:
            out[u] = ("admitted", cur, w["rows"])
    return [out[r.uid] for r in reqs]


def refill_path(torch, api, model, base, reg, cfg, seed):
    """Phase 3d: continuous admission at full width, driven with the
    launch counts set to 0 just before it and read just after: 16
    requests through ``max_batch=4``, ``cache_len=256``,
    ``decode_chunk=8`` with slot refill (at least 4 admissions).  Then,
    as checks:

    - the same run with each chunk computed eagerly on the card (the
      chunk's own loop, called without its graph: the same kernels, the
      same shapes and the same admission points): tokens bitwise equal;
    - the same traffic on fresh engines with ``decode_chunk`` 0 (the
      eager per-token loop), 1 and 16.  A request placed at the same wave
      position in a wave of as many rows runs the same shapes and must
      give the same tokens bitwise.  One admitted at another position
      (the eager loop refills a slot at the step its row ends, a chunked
      wave at the chunk's end) has its prompt at other rope positions,
      so its bf16 logits differ in the last bits: where its stream parts
      from chunk 8's, the divergence and its gaps to the top logit are
      reported (:func:`near_tie`), not gated;
    - the same traffic on an f32 copy of the model (:func:`f32_refill`),
      where the reference's contract is exact: tokens bitwise equal at
      ``decode_chunk`` 0, 1, 8 and 16 for every request.

    Returns (engine, requests, path launches, numbers)."""
    from repro_torch.kernels import ops
    kw = dict(max_batch=4, cache_len=256)
    reqs = refill_requests(torch, cfg, seed)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine = api.serve(model, base, reg, decode_chunk=8, **kw)
    engine.run(reqs)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = ops.launch_counts()
    for r in reqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"refill request {r.uid}: bad tokens {r.out_tokens}")
    stats = {8: graph_stats(engine)}
    check(stats[8]["admitted"] >= 4, f"refill path: {stats[8]['admitted']} "
          "admissions, expected at least 4")
    want = [r.out_tokens for r in reqs]
    placed = placements(engine, reqs, 0)

    eager = eager_chunks(torch, api.serve(model, base, reg, decode_chunk=8,
                                          **kw))
    rr = fresh(reqs, 500)
    eager.run(rr)
    check([r.out_tokens for r in rr] == want, "refill path: the graph "
          "chunks' tokens differ from the same chunks run eagerly")
    check(graph_stats(eager)["graph_captures"] == 0,
          "the eager chunk check captured a graph")
    del eager

    compared = {}
    for K in (0, 1, 16):
        other = api.serve(model, base, reg, decode_chunk=K, **kw)
        rr = fresh(reqs, 1000 * (K + 1))
        t1 = time.monotonic()
        other.run(rr)
        torch.cuda.synchronize()
        stats[K] = dict(graph_stats(other), serve_s=time.monotonic() - t1)
        c = {"equal": 0, "same_placement": 0, "parted": []}
        for r, q, p, p8 in zip(reqs, rr, placements(other, rr, 0), placed):
            if p == p8:
                c["same_placement"] += 1
                check(q.out_tokens == r.out_tokens, f"refill request "
                      f"{r.uid}: placed alike ({p}) at decode_chunk {K} "
                      "and 8, but its tokens differ")
            entry = near_tie(torch, engine, r, r.out_tokens, q.out_tokens,
                             f"bf16 decode_chunk 8 and {K}", gate=False)
            if entry is None:
                c["equal"] += 1
            else:
                c["parted"].append(dict(entry, placed=(p8, p)))
        compared[K] = c
        del other
    log(f"  refill path: {len(reqs)} requests, {stats[8]['admitted']} "
        f"admitted into {len(engine.wave_log)} waves; the graph chunks "
        "bitwise equal to the same chunks run eagerly; bf16 against "
        "decode_chunk 8: " + "; ".join(
            f"{K}: {c['equal']} equal ({c['same_placement']} placed alike, "
            f"all equal), {len(c['parted'])} placed otherwise part "
            f"({sum(e['within'] for e in c['parted'])} at near-ties)"
            for K, c in compared.items())
        + " (admissions per chunk size: "
        + ", ".join(f"{k}: {v['admitted']}" for k, v in sorted(stats.items()))
        + ")")
    return engine, reqs, launches, {"cold_serve_s": cold_s,
                                    "by_chunk": stats, "bf16_against_8":
                                    compared}


def eager_chunks(torch, engine):
    """``engine`` with each decode chunk computed eagerly on the card: the
    chunk's own loop called without its graph (the same kernels, shapes
    and admission points)."""
    from repro_torch.serve.decode_loop import host_decode_steps
    chunk, K = engine._chunker, engine.cfg.decode_chunk
    engine._chunk_fn = lambda p, o, e, tok, cache, rem, gen, keys: (
        tok, cache, chunk._run(p, o, e, tok, cache, torch.as_tensor(
            rem, dtype=torch.int32, device=tok.device), gen, keys,
            host_decode_steps(max(rem), K)))
    return engine


def f32_refill(torch, api, model, base, reg, reqs):
    """Phase 3d on an f32 copy of the model (the same weights widened,
    the same experts and traffic), where the reference's contract is
    exact: tokens bitwise equal at ``decode_chunk`` 0, 1, 8 and 16 with
    slot refill, and each request equal to its solo serve (by the
    near-tie rule; f32 leaves it nothing to excuse in practice)."""
    from repro_torch import tree as tree_util
    from repro_torch.models import build as build_model
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    base32 = tree_util.tree_map(lambda t: t.float(), base)
    kw = dict(max_batch=4, cache_len=256)
    runs, admitted = {}, {}
    for K in (8, 0, 1, 16):
        eng = api.serve(model32, base32, reg, decode_chunk=K, **kw)
        rr = fresh(reqs, 5000 + 100 * K)
        eng.run(rr)
        runs[K] = [r.out_tokens for r in rr]
        admitted[K] = eng.swap_summary()["admitted"]
        if K == 8:
            check(admitted[8] >= 4, f"f32 refill: {admitted[8]} admissions")
            solo = solo_check(torch, eng, rr)
        del eng
        check(runs[K] == runs[8], f"f32 refill: tokens at decode_chunk={K} "
              "differ from decode_chunk=8")
    same_bf16 = sum(a == b for a, b in zip(runs[8],
                                           [r.out_tokens for r in reqs]))
    log(f"  f32 copy: tokens bitwise equal at decode_chunk 0, 1, 8 and 16 "
        f"(admitted {admitted}); {solo['exact']} of {len(reqs)} equal "
        f"their solo serves; {same_bf16} of {len(reqs)} streams equal the "
        "bf16 run's")
    del base32
    return {"admitted": admitted, "solo": solo,
            "streams_equal_to_bf16": same_bf16}


# Phase 3e's configurations at full width, their depth cut: llama-7b (the
# paper's base family; untied head) with 4 of 32 units, gemma2-9b (GeGLU,
# softcaps, sandwich norms, tied head over vocab 256000) with 2 of 21
# units (4 layers: 2 local, 2 global), qwen3-32b (per-head q/k RMSNorm,
# q projection 8192 wide from d_model 5120) with 2 of 64 and qwen1.5-110b
# (d_model 8192, d_ff 49152, QKV bias, untied head over vocab 152064;
# 3.85 B parameters, so its segment buffer passes 2**31 elements) with 1
# of 80, all on the overlay; then mixtral-8x7b (top-2 of 8 experts) with
# 2 of 32 units by merge-on-swap (``moe_path``)
WIDE_CONFIGS = (("llama_7b", 2), ("gemma2_9b", 2), ("qwen3_32b", 2),
                ("qwen1_5_110b", 1))
MOE_CONFIG = ("mixtral_8x7b", 2)
# configurations whose bf16 solo serves part from their waves beyond the
# near-tie rule (NVIDIA H100 80GB HBM3, 700 W): on qwen3-32b 7 of 8
# parted, 2 beyond it (requests 1 and 2 at 2 and 4 bf16 ulps of the top
# logit, 3.94), where its f32 copy's 8 equal their solo serves; on
# qwen1.5-110b request 3 parted at 2 ulps (top 4.09).  A solo serve sees
# other rope positions and shapes, so bf16 logits move by ulps, and these
# wide models (d_model 5120 and 8192, vocab 152k) move them further.
# Their solo gate runs on an f32 copy, as phase 3d's does; the bf16 solo
# serves are reported.
SOLO_ON_F32 = ("qwen3_32b", "qwen1_5_110b")
# likewise the first decode step's logits through the kernels against the
# plain versions: on qwen1.5-110b 132 of 4 x 152064 bf16 logits differed
# by more than 2**-7 of their value (at most 0.015625, two ulps of a
# logit in [1, 2)); each projection's kernel output is held within 1e-4
# of the plain one's at every launch shape (``grouped_shape_rows``), and
# the f32 sums' last bits round bf16 activations an ulp apart often
# enough, through an FFN of 49152, that the logits inherit it.  The gate
# runs on the f32 copy (within 1e-4 of the largest |logit|); the bf16
# comparison is reported.
LOGITS_ON_F32 = ("qwen1_5_110b",)


def f32_copy(torch, model, base):
    """(model, params) of an f32 copy: the same weights widened."""
    from repro_torch import tree as tree_util
    from repro_torch.models import build as build_model
    return (build_model(dataclasses.replace(model.cfg, dtype="float32")),
            tree_util.tree_map(lambda t: t.float(), base))


def f32_gates(torch, api, model, base, reg, reqs, logits=False):
    """Phase 3's 8 requests on an f32 copy of the model (the weights
    widened, the same experts and engine settings): each request equal
    to its solo serve by the near-tie rule (f32 leaves it nothing to
    excuse in practice) and, with ``logits``, the first decode step's
    logits through the kernels within 1e-4 of the largest |logit| of the
    plain versions' (``logits_check``'s f32 form).  The copy is freed
    before it returns."""
    model32, base32 = f32_copy(torch, model, base)
    eng = api.serve(model32, base32, reg, max_batch=4, cache_len=128,
                    decode_chunk=8, continuous=False)
    rr = fresh(reqs, 7000)
    eng.run(rr)
    solo = solo_check(torch, eng, rr)
    same_bf16 = sum(a.out_tokens == b.out_tokens for a, b in zip(rr, reqs))
    log(f"  f32 copy: {solo['exact']} of {len(reqs)} equal their solo "
        f"serves; {same_bf16} of {len(reqs)} streams equal the bf16 run's")
    out = {"solo": solo, "streams_equal_to_bf16": same_bf16}
    if logits:
        out["logits"] = logits_check(torch, eng, rr[:4], f32=True)
    del eng, base32
    free_all(torch)
    return out


def free_all(torch) -> None:
    """Free what a phase dropped: engines sit in reference cycles (their
    decode chunks and registries point back at them), so their device
    buffers wait for Python's cyclic collector; then the allocator's
    cache is released to CUDA, so the next configuration's large
    buffers are not split out of this one's blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def compress_experts(torch, api, base, seed, dev):
    """4 experts (base + seeded noise, density 0.1) through
    ``api.compress(...).as_(PACKED)``, each compression timed; e0's planes
    held against the plain compression of its tau as soon as it is made,
    then every DENSE tau dropped, so at most one task vector (and its
    segment buffer) is on the card at a time, and each fine-tune freed
    once its task vector is made.  The check's own memory is
    left out of the peak: the peak before it is returned and the counter
    reset after it.  Returns (experts, seconds, e0's planes check, the
    peak before the check)."""
    from repro_torch.expert import DENSE, PACKED
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    experts, compress_s, planes = [], [], None
    for i in range(4):
        ft = finetune(torch, base, gen)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ex = api.compress(base, ft, name=f"e{i}", density=0.1, device=dev)
        del ft                      # the task vector is made: free it first
        ex.as_(PACKED)
        torch.cuda.synchronize()
        compress_s.append(time.monotonic() - t0)
        if i == 0:
            peak = torch.cuda.max_memory_allocated()
            planes = planes_check(torch, ex)
            torch.cuda.reset_peak_memory_stats()
        ex.drop(DENSE)
        experts.append(ex)
    return experts, compress_s, planes, peak


def config_path(torch, api, arch, units, seed, dev, out_dir):
    """Phase 3e: one more configuration at full width, its depth cut to
    ``units``, with random weights from ``seed``: compress 4 experts
    (density 0.1) through ``api.compress(...).as_(PACKED)``, then serve 8
    greedy requests over them and ``BASE`` (``max_batch=4``,
    ``cache_len=128``, ``decode_chunk=8``, ``continuous=False``), the
    launch counts set to 0 just before and read just after.  Then phase
    3's gates on it (e0's planes bitwise the plain compression, rows
    bitwise independent of their neighbours' experts, the first decode
    step's logits within 2**-7 of the plain versions', solo serves equal
    up to the near-tie rule (these two on an f32 copy for
    ``LOGITS_ON_F32`` and ``SOLO_ON_F32``, each grouped launch shape
    within 1e-4 of the plain version), a warm run repeating its tokens)
    and its
    numbers (decode tokens/s of the warm run, the grouped kernel at every
    launch shape of a wave, one profiled wave, the memory held on entry
    and the peak).  e0's planes are checked as soon as it is compressed
    (:func:`compress_experts`).  Everything it made is freed before it
    returns (numbers, launches)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build as build_model
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(arch), n_units=units)
    model = build_model(cfg)
    base = model.init(seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_util.leaves(base))
    log(f"  {arch}: {n_params / 1e6:.1f} M params, {units} of "
        f"{get_config(arch).n_units} units, full width; "
        f"{held / 2 ** 30:.2f} GiB held by earlier phases")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    experts, compress_s, planes, peak0 = compress_experts(torch, api, base,
                                                          seed, dev)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts)
    engine = api.serve(model, base, reg, max_batch=4, cache_len=128,
                       decode_chunk=8, continuous=False)
    reqs = make_requests(torch, cfg, seed)
    engine.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = max(peak0, torch.cuda.max_memory_allocated())
    log(f"  launches on the {arch} path: {launches}")
    for name in MIXED_PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {arch} path")
    for r in reqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"{arch} request {r.uid}: bad tokens {r.out_tokens}")
    out = {"params_m": n_params / 1e6, "units": units,
           "compress_s_per_expert": compress_s,
           "peak_memory_gib": peak / 2 ** 30,
           "held_on_entry_gib": held / 2 ** 30, "planes_e0": planes}
    for w in (reqs[:4], reqs[4:]):
        row_independence_check(torch, engine, w)
    log(f"  {arch}: every row's tokens bitwise unchanged when the other "
        "rows of its wave carry BASE")
    on_f32 = arch in LOGITS_ON_F32
    out["solo"] = solo_check(torch, engine, reqs,
                             gate=arch not in SOLO_ON_F32)
    out["logits"] = logits_check(torch, engine, reqs[:4], gate=not on_f32)
    if arch in SOLO_ON_F32:
        out["f32"] = f32_gates(torch, api, model, base, reg, reqs,
                               logits=on_f32)
    timed = fresh(reqs, 200)
    n0 = len(engine.wave_log)
    torch.cuda.synchronize()
    engine.run(timed)
    check([r.out_tokens for r in timed] == [r.out_tokens for r in reqs],
          f"{arch}: a second run of the same requests gave other tokens")
    waves = engine.wave_log[n0:]
    out["decode_tokens_per_s"] = (
        sum(w["tokens"] - w["rows"] for w in waves)
        / sum(w["seconds"] - w["prefill_s"] for w in waves))
    out["prefill_ms_per_wave"] = [w["prefill_s"] * 1e3 for w in waves]
    rows = grouped_shape_rows(torch, engine, reqs[:4])
    for r in rows:
        r.pop("inputs", None)
    out["grouped_shapes"] = rows
    out["profile"] = profile_wave(torch, engine, reqs[:4], out_dir,
                                  f"profile_{arch}")
    out["graphs"] = graph_stats(engine)
    log(f"  {arch}: decode {out['decode_tokens_per_s']:.1f} tokens/s (4 "
        f"rows, chunk 8), device busy {out['profile']['device_busy_ms']:.1f}"
        f" of {out['profile']['wall_ms']:.1f} ms of a warm wave")
    del engine, reg, experts, base, model
    free_all(torch)
    return out, launches


def wide_phase(torch, api, seed, dev, out_dir):
    """Phase 3e: every configuration of ``WIDE_CONFIGS`` on the overlay,
    then ``MOE_CONFIG`` by merge-on-swap.  Returns ({arch: numbers},
    {arch: launches})."""
    wide, launches = {}, {}
    free_all(torch)          # earlier phases' garbage, before the first
    for arch, units in WIDE_CONFIGS:
        log(f"phase 3e: {arch} at full width, {units} unit"
            f"{'s' * (units != 1)} (compress 4 experts, serve 8 requests, "
            "phase 3's gates)")
        t0 = time.monotonic()
        wide[arch], launches[arch] = config_path(torch, api, arch, units,
                                                 seed, dev, out_dir)
        wide[arch]["phase_s"] = time.monotonic() - t0
    arch, units = MOE_CONFIG
    log(f"phase 3e: {arch} at full width, {units} units, by merge-on-swap "
        "(compress 4 experts, serve 8 requests with mixed scheduling, "
        "merges bitwise, graphs bitwise eager)")
    t0 = time.monotonic()
    wide[arch], launches[arch] = moe_path(torch, api, arch, units, seed,
                                          dev, out_dir)
    wide[arch]["phase_s"] = time.monotonic() - t0
    log("  phase 3e took " + ", ".join(
        f"{a} {w['phase_s']:.1f} s" for a, w in wide.items()))
    return wide, launches


def merge_bound(torch, base, packed) -> tuple[int, float]:
    """Bytes one expert's merge must move (every base leaf read and the
    merged leaf written once, each plane word and scale read once) and
    their time at the card's memory rate."""
    from repro_torch import tree as tree_util
    nbytes = 0
    for path, leaf in tree_util.flatten_with_paths(base):
        nbytes += 2 * leaf.numel() * leaf.element_size()
        if path in packed:
            nbytes += 2 * packed[path].pos.numel() * 4 + 4
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def merged_logits_check(torch, reg, engine, reqs):
    """The first decode step of a batch of one expert's requests on its
    params merged through kernel 4 against those merged by the plain
    versions (the same prefill and step on each), within 2**-7 of each
    logit's value; the merge's own effect (the same step on the base) is
    logged beside."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import _row_mask_ok
    api, expert = engine.api, reqs[0].expert
    toks, start = engine._pad_prompts(reqs)
    # the engine's merge-path prefill: its stub modality input, and
    # ``start`` only where its rules pass it
    batch = {"tokens": toks, **engine._frontend_stub(len(reqs))}
    start = start if _row_mask_ok(api.cfg) else None
    L = engine.cfg.cache_len
    out = []
    for plain in (False, True):
        with ops.plain_versions() if plain else contextlib.nullcontext():
            params = reg.merged_params(engine.base, [expert])
        logits, cache = api.prefill(params, batch, L, start=start)
        tok = torch.argmax(logits[:, -1].float(), dim=-1).to(
            torch.int32)[:, None]
        out.append(api.decode_step(params, tok, cache)[0].float())
        del params, cache
    lb, cache = api.prefill(engine.base, batch, L, start=start)
    tok = torch.argmax(lb[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    lb = api.decode_step(engine.base, tok, cache)[0].float()
    lk, lp = out
    diff = (lk - lp).abs()
    tol = 2.0 ** -7 * torch.maximum(lk.abs(), lp.abs())
    err, over = float(diff.max()), int((diff > tol).sum())
    effect = float((lk - lb).abs().max())
    check(bool(torch.isfinite(lk).all()), "non-finite merged logits")
    check(over == 0, f"merged decode logits: {over} logits differ from the "
          f"plain merge's by more than 2**-7 of their value (max err {err})")
    log(f"  first decode step on {expert} merged: max|kernel - plain| "
        f"{err:.4e} (tol 2**-7 * |logit|, at most {float(tol.max()):.4e}); "
        f"the merge moves them by up to {effect:.4e}")
    return {"expert": expert, "max_abs_err": err,
            "tol": "2**-7 * max(|kernel|, |plain|)",
            "tol_max": float(tol.max()), "merge_effect": effect}


def moe_row_checks(torch, engine, reqs, gate_solo=True) -> dict:
    """The row contracts of an MoE engine's batches (one expert each).

    The GShard dispatch groups each row's prompt apart (S = T), but the
    left-pad tokens of a row shorter than its batch's longest route too
    and take capacity slots ahead of its real tokens, so such a row
    depends on its padding, in the reference as here.  The gates: (a)
    every row's tokens bitwise unchanged when the other rows of its batch
    carry other prompts of the same lengths (so the same padding and
    shapes); (b) with ``gate_solo``, every row without padding (the
    longest of its batch) equal to its solo serve up to the near-tie
    rule.  Padded rows' solo serves are reported."""
    from repro_torch.serve import Request
    by_uid = {r.uid: r for r in reqs}
    g = torch.Generator().manual_seed(5)
    unpadded, padded = [], []
    for b in [b for b in engine.batch_log if b["uids"][0] in by_uid]:
        rows = [by_uid[u] for u in b["uids"]]
        width = max(len(r.prompt) for r in rows)
        for j, r in enumerate(rows):
            (unpadded if len(r.prompt) == width else padded).append(r)
            if len(rows) == 1:
                continue
            variant = [Request(
                uid=3000 + 10 * r.uid + i, expert=q.expert,
                max_new_tokens=q.max_new_tokens,
                prompt=q.prompt if i == j else torch.randint(
                    2, engine.api.cfg.vocab, (len(q.prompt),), generator=g))
                for i, q in enumerate(rows)]
            engine.run(variant)
            check(variant[j].out_tokens == r.out_tokens,
                  f"request {r.uid}: tokens depend on the other rows' "
                  f"prompts: {r.out_tokens} vs {variant[j].out_tokens}")
    log(f"  every row's tokens bitwise unchanged when the other rows of its "
        f"batch carry other prompts of the same lengths; solo serves of the "
        f"{len(unpadded)} unpadded rows "
        f"({'gated' if gate_solo else 'reported'}), then of the {len(padded)} "
        "padded ones (reported: a padded row depends on its padding)")
    return {"unpadded_solo": solo_check(torch, engine, unpadded,
                                        gate=gate_solo),
            "padded_solo": solo_check(torch, engine, padded, gate=False)}


def moe_f32_rows(torch, api, model, base, reg, reqs,
                 cache_len: int = 128) -> dict:
    """:func:`moe_row_checks` on an f32 copy of the MoE model (the weights
    widened, the same experts, merged into f32 by kernel 4), with the
    unpadded rows' solo gate.  In bf16 an ulp of a solo serve's other
    batch shape can flip a top-2 choice whose two router probabilities
    nearly tie, and then the row takes other experts: mixtral's unpadded
    request 4 parted from its solo serve at step 7 with both tokens 1.8
    and 2.0 below the top logit (NVIDIA H100 80GB HBM3, 700 W).  The copy
    is freed before it returns."""
    model32, base32 = f32_copy(torch, model, base)
    eng = api.serve(model32, base32, reg, scheduling="mixed", max_batch=4,
                    cache_len=cache_len, decode_chunk=8, continuous=False)
    rr = fresh(reqs, 7000)
    eng.run(rr)
    out = moe_row_checks(torch, eng, rr)
    out["streams_equal_to_bf16"] = sum(
        a.out_tokens == b.out_tokens for a, b in zip(rr, reqs))
    log(f"  f32 copy: {out['streams_equal_to_bf16']} of {len(reqs)} streams "
        "equal the bf16 run's")
    del eng, base32
    free_all(torch)
    return out


def moe_path(torch, api, arch, units, seed, dev, out_dir):
    """Phase 3e's MoE case: ``arch`` (mixtral-8x7b) at full width, ``units``
    of its depth, random weights from ``seed``, which the zero-merge
    overlay does not cover, so it is served by merge-on-swap (the f32
    router merged too): :func:`merge_path` with the unpadded rows' solo
    gate on an f32 copy (``moe_f32_rows``)."""
    from repro_torch.configs import get_config
    return merge_path(torch, api, arch, dataclasses.replace(
        get_config(arch), n_units=units), 128, seed, dev, out_dir,
        solo_on_f32=True)


# ---------------------------------------------------------------------------
# Phase 3f: the families outside the overlay
# ---------------------------------------------------------------------------

# (arch, units, cache_len) at full width, depth cut to fit the script's
# time: rwkv6-3b 4 of 32 units, seamless-m4t-medium 6 of 12 decoder units
# beside all 12 encoder units, internvl2-1b 12 of 24 units (its
# 256-position mm prefix sits in the cache ahead of the prompt, so the
# ring holds 384)
FAMILY_CONFIGS = (("rwkv6_3b", 4, 128), ("seamless_m4t_medium", 6, 128),
                  ("internvl2_1b", 12, 384))
# jamba-1.5-large: one full-width unit of 8 blocks holds 45.2 B parameters
# (90 GB in bf16), so it runs at smoke size (2 units)
FAMILY_SMOKE = ("jamba_1_5_large_398b", 2, 128)
MERGE_PATH_KERNELS = ("pack_ternary_planes_segmented",
                      "segment_hist_moments", "segment_absmax",
                      "unpack_add_many")


def merge_row_gates(torch, api, model, base, reg, engine, reqs,
                    cache_len: int, solo_on_f32: bool) -> dict:
    """:func:`moe_row_checks` in the model's dtype with the solo serves
    reported; then the same checks on an f32 copy with the unpadded rows'
    solo gate (:func:`moe_f32_rows`), with ``solo_on_f32`` always, else
    only where an unpadded row parts from its solo serve beyond a
    near-tie.  The MoE path sets ``solo_on_f32``: in bf16 an ulp of the
    solo serve's other batch shape can flip a top-2 choice whose router
    probabilities nearly tie, after which the row runs other experts and
    its tokens part by more than a near-tie (mixtral's request 4 did, see
    :func:`moe_f32_rows`), so its solo gate is always the f32 copy's."""
    out = {"bf16": moe_row_checks(torch, engine, reqs, gate_solo=False)}
    beyond = [e for e in out["bf16"]["unpadded_solo"]["near_tie"]
              if not e["within"]]
    if beyond:
        log(f"  {len(beyond)} unpadded rows part from their solo serves "
            "beyond a near-tie: the solo gate runs on an f32 copy")
    if beyond or solo_on_f32:
        out["f32"] = moe_f32_rows(torch, api, model, base, reg, reqs,
                                  cache_len)
    return out


def recurrent_share(torch, model, base, cfg, cache_len: int) -> dict:
    """Device ms of one decode step of 4 rows (one CUDA graph of 8 steps
    replayed, ``graph_ms``) against the recurrent blocks' time mixers
    alone (the rwkv time mix or the mamba mixer of every unit, their
    projections included) and their scans alone (the chunk-1 step of the
    rwkv recurrence or of the selective scan on inputs of the step's
    shapes), each timed the same way."""
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import rwkv as rwkv_mod
    dev = base["embed"].device
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(2, cfg.vocab, (4, 32), generator=g).to(dev)
    logits, cache = model.prefill(base, {"tokens": toks}, cache_len)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    step_ms = graph_ms(torch, lambda: model.decode_step(base, tok, cache),
                       n=8, replays=3)
    d, U, f32 = cfg.d_model, cfg.n_units, torch.float32
    x = torch.randn((4, 1, d), generator=g).to(dev, base["embed"].dtype)
    mixers, cores = [], []
    for i, b in enumerate(cfg.pattern):
        name, bp = f"block{i}", base["blocks"][f"block{i}"]
        st = cache["layers"][name]
        for u in range(U):
            p = {k: t[u] for k, t in bp[b.kind].items()}
            if b.kind == "rwkv":
                mixers.append(lambda p=p, b=b, u=u, st=st:
                              rwkv_mod.rwkv_time_mix(
                                  x, p, b.rwkv, state=(st["S"][u],
                                                       st["tm"][u]),
                                  chunk=1, impl="einsum"))
            elif b.kind == "mamba":
                mixers.append(lambda p=p, b=b, u=u, st=st:
                              mamba_mod.mamba_decode_step(
                                  x, p, b.mamba, (st["h"][u],
                                                  st["conv"][u])))
        if b.kind == "rwkv":
            dh = b.rwkv.head_dim
            r, k, v = (torch.randn((4, 1, d // dh, dh), generator=g).to(dev)
                       for _ in range(3))
            w = -torch.rand((4, 1, d // dh, dh), generator=g).to(dev)
            ce = torch.zeros_like(w)     # a chunk of 1: ce = ci - log w = 0
            S0 = st["S"][0]
            uu = bp["rwkv"]["u"][0].reshape(d // dh, dh).to(f32)
            cores += [lambda r=r, k=k, v=v, w=w, ce=ce, S0=S0, uu=uu:
                      rwkv_mod._chunk_step(S0, r, k, v, w, ce, uu,
                                           "einsum")] * U
        elif b.kind == "mamba":
            din, ds = b.mamba.expand * d, b.mamba.d_state
            dt, xa = (torch.rand((4, 1, din), generator=g).to(dev)
                      for _ in range(2))
            bb, cc = (torch.randn((4, 1, ds), generator=g).to(dev)
                      for _ in range(2))
            A = -torch.rand((din, ds), generator=g).to(dev)
            h0 = st["h"][0]
            cores += [lambda dt=dt, xa=xa, bb=bb, cc=cc, A=A, h0=h0:
                      mamba_mod._ssm_chunk(h0, dt, xa, bb, cc, A)] * U

    def run_all(fns):
        for fn in fns:
            fn()

    mixer_ms = graph_ms(torch, lambda: run_all(mixers), n=4, replays=3)
    core_ms = graph_ms(torch, lambda: run_all(cores), n=4, replays=3)
    out = {"decode_step_ms": step_ms, "mixers_ms": mixer_ms,
           "scans_ms": core_ms, "mixer_share": mixer_ms / step_ms,
           "scan_share": core_ms / step_ms, "blocks": len(mixers)}
    log(f"  one decode step of 4 rows {step_ms:.3f} ms (graph replay); "
        f"the {len(mixers)} recurrent mixers alone {mixer_ms:.3f} ms "
        f"({100 * out['mixer_share']:.1f}%), their scans alone "
        f"{core_ms:.3f} ms ({100 * out['scan_share']:.1f}%)")
    del cache
    return out


def encoder_share(torch, model, base, cfg, cache_len: int) -> dict:
    """Milliseconds of a 4-row prefill of 64-token prompts over zero stub
    frames against its encoder alone (``cuda_ms``, 3 calls each)."""
    from repro_torch.models import transformer as tf
    dev = base["embed"].device
    g = torch.Generator().manual_seed(12)
    fe = cfg.frontend
    frames = torch.zeros((4, fe.n_tokens, fe.embed_dim), device=dev)
    batch = {"tokens": torch.randint(2, cfg.vocab, (4, 64),
                                     generator=g).to(dev), "frames": frames}
    prefill_ms = cuda_ms(torch, lambda: model.prefill(base, batch,
                                                      cache_len), 3)
    enc_ms = cuda_ms(torch, lambda: tf.encode(base, frames, cfg), 3)
    log(f"  a 4-row prefill over {fe.n_tokens} stub frames {prefill_ms:.2f} "
        f"ms, its encoder alone {enc_ms:.2f} ms "
        f"({100 * enc_ms / prefill_ms:.1f}%)")
    return {"prefill_ms": prefill_ms, "encoder_ms": enc_ms,
            "encoder_share": enc_ms / prefill_ms}


def merge_path(torch, api, arch, cfg, cache_len, seed, dev, out_dir,
               solo_on_f32=False):
    """A configuration no overlay plan covers (an MoE, recurrent, enc-dec
    or frontend family), ``cfg`` of ``arch`` with random weights from
    ``seed``, served through ``api.serve(..., scheduling="mixed")`` by
    merge-on-swap (``ExpertRegistry.merged_params``, kernel 4 once per
    leaf per distinct expert).  With the launch counts set to 0 just
    before and read just after: 4 experts compressed (e0's planes bitwise
    the plain compression) and phase 3's 8 greedy requests served
    (``max_batch=4``, ``cache_len``, ``decode_chunk=8``,
    ``continuous=False``; a frontend family on the zero stub inputs the
    engine feeds it).  The gates: no overlay plan; one merge per distinct
    expert served (the reference's ``n_swaps``) and no mixed wave; every
    expert's merged tree bitwise the plain merge (``unpack_add_many_ref``);
    the first decode step's logits on the merged params within 2**-7 of
    the plain merge's; each row bitwise independent of its batch
    neighbours' prompts and, unpadded, equal to its solo serve up to the
    near-tie rule (:func:`merge_row_gates`); the decode chunks' CUDA graphs
    bitwise the same chunks run eagerly; a warm run repeating its tokens;
    kernels 2, 3, 3a and 4 launched.  Reported: compress seconds, decode
    tokens/s, prefill ms per batch, swap seconds per expert against the
    merge's byte bound, kernel 4 on the widest leaf, one profiled batch of
    4 rows with its swap, and for a recurrent or enc-dec model the share
    of a decode step its scans take or of a prefill its encoder takes.
    Everything it made is freed before it returns (numbers, launches)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build as build_model
    from repro_torch.serve import BASE
    held = torch.cuda.memory_allocated()
    full = get_config(arch)
    smoke = cfg.d_model != full.d_model
    model = build_model(cfg)
    base = model.init(seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_util.leaves(base))
    log(f"  {arch}: {n_params / 1e6:.1f} M params, {cfg.n_units} units"
        + (" (smoke size)" if smoke else
           f" of {full.n_units}, full width")
        + f"; {held / 2 ** 30:.2f} GiB held by earlier phases")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    experts, compress_s, planes, peak0 = compress_experts(torch, api, base,
                                                          seed, dev)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts)
    kw = dict(scheduling="mixed", max_batch=4, cache_len=cache_len,
              decode_chunk=8, continuous=False)
    engine = api.serve(model, base, reg, **kw)
    reqs = make_requests(torch, cfg, seed)
    engine.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = max(peak0, torch.cuda.max_memory_allocated())
    log(f"  launches on the {arch} path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for name in MERGE_PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {arch} path")
    check(engine._plan is None, f"{arch}: the engine planned an overlay")
    served = list(dict.fromkeys(r.expert for r in reqs if r.expert != BASE))
    summ = engine.swap_summary()
    check(summ["n_swaps"] == len(served) and summ["n_waves"] == 0,
          f"{arch}: {summ['n_swaps']} merges and {summ['n_waves']} mixed "
          f"waves for {len(served)} distinct experts, expected "
          f"{len(served)} and 0")
    for r in reqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"{arch} request {r.uid}: bad tokens {r.out_tokens}")
    swaps = [dict(x) for x in engine.swap_log]
    nbytes, bound = merge_bound(torch, base, reg.fetch_packed("e0"))
    log(f"  {arch}: merge-on-swap, no overlay plan; {summ['n_swaps']} merges "
        f"for experts {', '.join(served)}, 0 mixed waves; swap s "
        + ", ".join(f"{x['expert']} {x['seconds']:.4f}" for x in swaps)
        + f" (bound {bound:.3f} ms: {nbytes / 1e9:.2f} GB read and written)")
    out = {"params_m": n_params / 1e6, "units": cfg.n_units, "smoke": smoke,
           "cache_len": cache_len, "compress_s_per_expert": compress_s,
           "peak_memory_gib": peak / 2 ** 30,
           "held_on_entry_gib": held / 2 ** 30, "planes_e0": planes,
           "swap_s": swaps, "swap_bytes": nbytes, "swap_bound_ms": bound,
           "n_swaps": summ["n_swaps"]}
    merged_params_check(torch, reg, base, [f"e{i}" for i in range(4)])
    out["logits"] = merged_logits_check(
        torch, reg, engine, [r for r in reqs if r.expert == "e0"])
    out["rows"] = merge_row_gates(torch, api, model, base, reg, engine,
                                  reqs, cache_len, solo_on_f32)
    # the graphs against the same chunks run eagerly
    eager = eager_chunks(torch, api.serve(model, base, reg, **kw))
    ereqs = fresh(reqs, 500)
    eager.run(ereqs)
    check([r.out_tokens for r in ereqs] == [r.out_tokens for r in reqs],
          f"{arch}: the graph chunks differ from the same chunks run eagerly")
    check(eager.swap_summary()["graph_captures"] == 0,
          f"{arch}: the eager engine captured a graph")
    del eager
    log(f"  {arch}: graph chunks bitwise the same chunks run eagerly")
    timed = fresh(reqs, 200)
    b0 = len(engine.batch_log)
    torch.cuda.synchronize()
    engine.run(timed)
    check([r.out_tokens for r in timed] == [r.out_tokens for r in reqs],
          f"{arch}: a second run of the same requests gave other tokens")
    batches = engine.batch_log[b0:]
    out["decode_tokens_per_s"] = (
        sum(b["tokens"] - b["rows"] for b in batches)
        / sum(b["seconds"] - b["prefill_s"] for b in batches))
    out["prefill_ms_per_batch"] = [b["prefill_s"] * 1e3 for b in batches]
    out["batch_rows"] = [b["rows"] for b in batches]
    out["graphs"] = graph_stats(engine)
    # kernel 4 on the widest leaf, beside its bound
    pk = reg.fetch_packed("e1")
    path, leaf = max(tree_util.flatten_with_paths(base),
                     key=lambda kv: kv[1].numel())
    pt = pk[path]
    ms = cuda_ms(torch, lambda: ops.apply_ternary_delta_many_flat(
        leaf, [pt]), 5)
    leaf_bytes = (2 * leaf.numel() * leaf.element_size()
                  + 2 * pt.pos.numel() * 4)
    out["widest_leaf_merge"] = {
        "path": path, "shape": list(leaf.shape), "ms": ms,
        "bound_ms": leaf_bytes / HBM_BYTES_PER_S * 1e3}
    log(f"  unpack_add_many on {path} {list(leaf.shape)}: {ms:.3f} ms "
        f"(bound {out['widest_leaf_merge']['bound_ms']:.3f}, bytes)")
    # one 4-row batch of one expert, its merge included; served once
    # first, so that its decode graphs (no batch above had 4 rows) are
    # captured outside the profile, and then e2 in between, so that the
    # profiled batch merges e1 again
    wave = [dataclasses.replace(r, expert="e1") for r in reqs[:4]]
    engine.run(fresh(wave, 800))
    engine.run(fresh(reqs[2:3], 850))
    out["profile"] = profile_wave(torch, engine, wave, out_dir,
                                  f"profile_{arch}")
    if any(b.kind != "attn" for b in cfg.pattern):
        out["recurrent"] = recurrent_share(torch, model, base, cfg,
                                           cache_len)
    if cfg.enc_n_units:
        out["encoder"] = encoder_share(torch, model, base, cfg, cache_len)
    log(f"  {arch}: decode {out['decode_tokens_per_s']:.1f} tokens/s (rows "
        f"per batch {out['batch_rows']}, chunk 8), prefill ms "
        + ", ".join(f"{x:.1f}" for x in out["prefill_ms_per_batch"])
        + f", peak memory {out['peak_memory_gib']:.2f} GiB, compress s "
        + ", ".join(f"{x:.3f}" for x in compress_s))
    del engine, reg, experts, base, model, pk, pt, leaf
    free_all(torch)
    return out, launches


def mamba_module_check(torch, dev, seed) -> dict:
    """One jamba mamba block at full width (d_model 8192, d_inner 16384,
    d_state 16, d_conv 4, dt_rank 512), f32 weights and states, 4 rows:
    a 64-token chunked prefill followed by 16 decode steps against one
    chunked forward over all 80 tokens, every output and the final state
    within 1e-4 of the largest |value| (the two sum the scan in other
    orders), both timed (``cuda_ms``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import transformer as tf
    cfg = get_config("jamba_1_5_large_398b")
    b = next(b for b in cfg.pattern if b.kind == "mamba")
    m = dataclasses.replace(b.mamba, dt_rank=b.mamba.dt_rank
                            or -(-cfg.d_model // 16))
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    p = {k: v[0] for k, v in tf._init_mamba(m, cfg.d_model, 1, torch.float32,
                                             gen, dev).items()}
    x = torch.randn((4, 80, cfg.d_model), generator=gen, device=dev)
    full, (h_full, _) = mamba_mod.mamba_forward(x, p, m)

    def split_run():
        y0, st = mamba_mod.mamba_forward(x[:, :64], p, m)
        ys = [y0]
        for t in range(64, 80):
            y, st = mamba_mod.mamba_decode_step(x[:, t:t + 1], p, m, st)
            ys.append(y)
        return torch.cat(ys, dim=1), st

    split, (h_split, _) = split_run()
    torch.cuda.synchronize()
    err = float((split - full).abs().max())
    tol = 1e-4 * float(full.abs().max())
    herr = float((h_split - h_full).abs().max())
    htol = 1e-4 * float(h_full.abs().max())
    check(err <= tol and herr <= htol,
          f"mamba block at full width: prefill + decode differs from one "
          f"forward by {err} (tol {tol}), state by {herr} (tol {htol})")
    full_ms = cuda_ms(torch, lambda: mamba_mod.mamba_forward(x, p, m), 3)
    prefill_ms = cuda_ms(torch, lambda: mamba_mod.mamba_forward(
        x[:, :64], p, m), 3)
    split_ms = cuda_ms(torch, split_run, 2)
    step_ms = (split_ms - prefill_ms) / 16
    out = {"d_model": cfg.d_model, "d_inner": m.expand * cfg.d_model,
           "d_state": m.d_state, "dt_rank": m.dt_rank, "rows": 4,
           "max_abs_err": err, "tol": tol, "state_err": herr,
           "state_tol": htol, "forward_80_ms": full_ms,
           "prefill_64_ms": prefill_ms, "prefill_and_16_steps_ms": split_ms,
           "decode_step_ms": step_ms}
    log(f"  mamba block at full width, 4 rows: 64-token prefill + 16 steps "
        f"vs one forward over 80: max err {err:.3e} (tol {tol:.3e}), state "
        f"{herr:.3e} (tol {htol:.3e}); forward over 80 {full_ms:.2f} ms, "
        f"prefill of 64 {prefill_ms:.2f} ms, a decode step {step_ms:.3f} ms")
    del p, x, full, split
    free_all(torch)
    return out


def family_phase(torch, api, seed, dev, out_dir):
    """Phase 3f: every configuration of ``FAMILY_CONFIGS`` at full width,
    ``FAMILY_SMOKE`` at smoke size, then the full-width mamba block.
    Returns ({arch: numbers}, {arch: launches})."""
    fams, launches = {}, {}
    free_all(torch)
    from repro_torch.configs import get_config, get_smoke_config
    for arch, units, cache_len in FAMILY_CONFIGS + (FAMILY_SMOKE,):
        smoke = (arch, units, cache_len) == FAMILY_SMOKE
        log(f"phase 3f: {arch} {'at smoke size' if smoke else 'at full width'}"
            f", {units} units, by merge-on-swap (compress 4 experts, serve 8 "
            f"requests, cache_len {cache_len})")
        cfg = (get_smoke_config(arch, n_units=units) if smoke else
               dataclasses.replace(get_config(arch), n_units=units))
        t0 = time.monotonic()
        fams[arch], launches[arch] = merge_path(
            torch, api, arch, cfg, cache_len, seed, dev, out_dir)
        fams[arch]["phase_s"] = time.monotonic() - t0
    log("phase 3f: one jamba mamba block at full width")
    t0 = time.monotonic()
    fams["mamba_block"] = mamba_module_check(torch, dev, seed)
    fams["mamba_block"]["phase_s"] = time.monotonic() - t0
    log("  phase 3f took " + ", ".join(
        f"{a} {w['phase_s']:.1f} s" for a, w in fams.items()))
    return fams, launches


SAMPLING = dict(temperature=0.8, seed=0)


def sampled_path(torch, api, model, base, reg, reqs, top_k):
    """Phase 3s, one top-k setting: phase 3d's 16 refill requests on the
    same model and experts, sampled at temperature 0.8 (``max_batch=4``,
    ``cache_len=256``, ``decode_chunk=8``, slot refill), the launch counts
    set to 0 just before and read just after; uids are kept, since a
    request's stream is keyed by (seed, uid).  Then, as checks: the graph
    chunks bitwise equal to the same chunks run eagerly; at
    ``decode_chunk`` 0, 1 and 16 every request placed as at chunk 8
    bitwise equal, the others' partings reported (other rope positions in
    bf16); and on the f32 copy, every stream bitwise equal across chunk
    sizes 0, 1, 8 and 16 and to its solo serve.  Returns (engine,
    requests, launches, numbers)."""
    from repro_torch.kernels import ops
    kw = dict(max_batch=4, cache_len=256, top_k=top_k, **SAMPLING)
    sreqs = fresh(reqs, 0)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine = api.serve(model, base, reg, decode_chunk=8, **kw)
    engine.run(sreqs)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = ops.launch_counts()
    vocab = model.cfg.vocab
    for r in sreqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < vocab for t in r.out_tokens),
              f"sampled request {r.uid}: bad tokens {r.out_tokens}")
    for name in ("sample_tokens", "ternary_matmul_grouped"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              f"sampled path (top_k {top_k})")
    want = [r.out_tokens for r in sreqs]
    greedy = sum(a == r.out_tokens for a, r in zip(want, reqs))
    placed = placements(engine, sreqs, 0)
    eager = eager_chunks(torch, api.serve(model, base, reg, decode_chunk=8,
                                          **kw))
    rr = fresh(reqs, 0)
    eager.run(rr)
    check([r.out_tokens for r in rr] == want, f"sampled (top_k {top_k}): "
          "the graph chunks' tokens differ from the same chunks run eagerly")
    del eager
    compared = {}
    for K in (0, 1, 16):
        other = api.serve(model, base, reg, decode_chunk=K, **kw)
        rr = fresh(reqs, 0)
        other.run(rr)
        c = {"equal": 0, "same_placement": 0, "parted": []}
        for r, q, p, p8 in zip(sreqs, rr, placements(other, rr, 0), placed):
            if p == p8:
                c["same_placement"] += 1
                check(q.out_tokens == r.out_tokens, f"sampled request "
                      f"{r.uid} (top_k {top_k}): placed alike ({p}) at "
                      f"decode_chunk {K} and 8, but its tokens differ")
            if q.out_tokens == r.out_tokens:
                c["equal"] += 1
            else:
                step = next(i for i, (a, b) in enumerate(
                    zip(r.out_tokens, q.out_tokens)) if a != b)
                c["parted"].append({"uid": r.uid, "step": step,
                                    "placed": (p8, p)})
        compared[K] = c
        del other
    f32 = f32_sampled(torch, api, model, base, reg, reqs, kw)
    log(f"  sampled top_k {top_k}: {len(sreqs)} requests, "
        f"{graph_stats(engine)['admitted']} admitted; graph chunks bitwise "
        "the same chunks run eagerly; bf16 against decode_chunk 8: "
        + "; ".join(f"{K}: {c['equal']} equal ({c['same_placement']} "
                    f"placed alike, all equal), {len(c['parted'])} part"
                    for K, c in compared.items())
        + f"; {greedy} of {len(reqs)} streams equal the greedy ones")
    return engine, sreqs, launches, {
        "top_k": top_k, "cold_serve_s": cold_s, "bf16_against_8": compared,
        "streams_equal_to_greedy": greedy, "f32": f32,
        "graphs": graph_stats(engine)}


def f32_sampled(torch, api, model, base, reg, reqs, kw):
    """Sampled refill traffic on an f32 copy of the model (the same
    weights widened, experts and uids): every stream bitwise equal at
    ``decode_chunk`` 0, 1, 8 and 16, and each equal to the same request
    (same uid) served alone.  A draw depends only on (seed, uid, gen), so
    where the logits agree the tokens must."""
    from repro_torch import tree as tree_util
    from repro_torch.models import build as build_model
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    base32 = tree_util.tree_map(lambda t: t.float(), base)
    runs = {}
    for K in (8, 0, 1, 16):
        eng = api.serve(model32, base32, reg, decode_chunk=K, **kw)
        rr = fresh(reqs, 0)
        eng.run(rr)
        runs[K] = [r.out_tokens for r in rr]
        check(runs[K] == runs[8], f"f32 sampled (top_k {kw['top_k']}): "
              f"tokens at decode_chunk={K} differ from decode_chunk=8")
        if K == 8:
            check(eng.swap_summary()["admitted"] >= 4,
                  "f32 sampled: fewer than 4 admissions")
            for r in rr:
                solo = fresh([r], 0)
                eng.run(solo)
                check(solo[0].out_tokens == r.out_tokens, f"f32 sampled "
                      f"request {r.uid}: solo serve {solo[0].out_tokens} "
                      f"vs in the wave {r.out_tokens}")
        del eng
    del base32
    log(f"  f32 copy, sampled top_k {kw['top_k']}: streams bitwise equal at "
        f"decode_chunk 0, 1, 8 and 16 and to their solo serves")
    return {"equal_across_chunks": True, "solo_equal": len(reqs)}


# ---------------------------------------------------------------------------
# Phase 3p: paged KV and the three schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = ("fifo", "priority", "affinity")
PAGED = dict(max_batch=4, cache_len=256, kv_block_size=16, decode_chunk=8)


def paged_traffic(cfg, seed, closed=True):
    """Phase 3p's traffic from ``repro_torch.serve.traffic.generate``: 24
    requests over e0-e3 (Zipf 1.1), prompts of 16 and 96 tokens (a
    quarter long), budgets of 8 and 32 (a quarter long), priorities 0
    (weight 0.2) and 1 (0.8), bursts of 4x for 1 s in every 4 s at a base
    rate of 8 requests/s.  Closed traffic sets every ``arrival_s`` to 0."""
    from repro_torch.serve.traffic import TrafficConfig, generate
    reqs = generate(TrafficConfig(
        seed=seed, n_requests=24, base_rate=8.0, burst_every_s=4.0,
        burst_duration_s=1.0, burst_rate_x=4.0, n_experts=4, zipf_alpha=1.1,
        expert_prefix="e", prompt_len_short=16, prompt_len_long=96,
        long_frac=0.25, max_new_short=8, max_new_long=32, long_out_frac=0.25,
        vocab=cfg.vocab, priorities=((0, 0.2), (1, 0.8))))
    if closed:
        for r in reqs:
            r.arrival_s = 0.0
    return reqs


def record_blocks(engine):
    """Count, by reason, every time ``engine`` finds a queued request it
    cannot place into a finished slot ("stack", "position", "wrap" or
    "kv_blocks"); under FIFO each such find is a head-of-line block."""
    import collections
    reasons = collections.Counter()
    decide = engine._admission_block_reason

    def recorded(*args, **kwargs):
        why = decide(*args, **kwargs)
        if why is not None:
            reasons[why] += 1
        return why

    engine._admission_block_reason = recorded
    return reasons


def kv_check(engine, what):
    kv = engine.swap_summary()["kv"]
    check(kv["blocks_in_use"] == 0, f"{what}: {kv['blocks_in_use']} KV "
          "blocks still in use after the run")
    check(kv["blocks_total"] is None
          or kv["blocks_peak"] <= kv["blocks_total"],
          f"{what}: peak {kv['blocks_peak']} blocks above the pool's "
          f"{kv['blocks_total']}")
    return kv


def valid_tokens(reqs, vocab, what):
    for r in reqs:
        check(r.status == "done" and len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < vocab for t in r.out_tokens),
              f"{what} request {r.uid}: bad tokens {r.out_tokens}")


def near_ties(torch, engine, reqs, others, what):
    """Each request's stream against another run's, by the near-tie rule
    (a gate); returns (equal, partings)."""
    equal, parted = 0, []
    for r, q in zip(reqs, others):
        entry = near_tie(torch, engine, r, r.out_tokens, q.out_tokens, what)
        if entry is None:
            equal += 1
        else:
            parted.append(entry)
    return equal, parted


def blocked_head_requests(torch, cfg):
    """``tests/test_paged_kv.py``'s blocked head at block size 16: with 6
    usable blocks and 2 rows the wave holds uid 0 (3 blocks, 20 tokens)
    and uid 1 (2 blocks, 2 tokens); when uid 1 ends, the head uid 2 needs
    5 blocks of the 3 free, while uid 3 needs 2."""
    from repro_torch.serve import Request
    g = torch.Generator().manual_seed(7)
    prompt = lambda n: torch.randint(2, cfg.vocab, (n,), generator=g)  # noqa
    return [Request(uid=0, expert="e0", prompt=prompt(6), max_new_tokens=20),
            Request(uid=1, expert="e0", prompt=prompt(3), max_new_tokens=2),
            Request(uid=2, expert="e0", prompt=prompt(30), max_new_tokens=40),
            Request(uid=3, expert="e0", prompt=prompt(3), max_new_tokens=2)]


def paged_path(torch, api, model, base, reg, cfg, seed, out_dir):
    """Phase 3p: paged KV under the graphed decode chunk and the three
    schedulers, at full width (``max_batch=4``, ``cache_len=256``,
    ``kv_block_size=16``, ``decode_chunk=8``), on 24 closed requests of
    :func:`paged_traffic`.  The main path, driven with the launch counts
    set to 0 just before it and read just after: the traffic served paged
    under ``fifo``, ``priority`` and ``affinity``, and sampled (T 0.8,
    top_k 40) under ``affinity``.  Then the gates:

    (a) a dense FIFO run of the traffic (its head-of-line blocks
        recorded); every paged stream equal to its dense stream by the
        near-tie rule (paged rows decode at ``Lp + i``, dense rows at the
        wave's position: other rope positions in bf16);
    (b) on an f32 copy, per scheduler, the paged streams bitwise equal at
        ``decode_chunk`` 1, 8 and 16 and equal to each request's paged
        solo serve;
    (c) the graphed paged chunks bitwise the same chunks run eagerly, and
        a warm paged engine captures no graph;
    (d) no block in use after any run, the peak within the pool; at half
        the default pool, and at a quarter (which re-queues overflow
        rows), the streams of (a) by the near-tie rule; the blocked head
        at full width: ``priority`` admits past it (``deferred >= 1``),
        ``fifo`` keeps head order;
    (e) no "position" or "wrap" block on the paged path;
    (f) the sampled affinity traffic keeps (b) on the f32 copy.

    Then, reported: the same generator's open-loop timeline per
    scheduler, dense and paged (``summarize``, TTFT by priority,
    deadline misses, admissions, deferrals, peak blocks), one warm run
    profiled paged and one dense, and the paged attention's device time
    per step beside the dense one's.  Returns (launches, numbers)."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops
    from repro_torch.models import build as build_model
    import numpy as np
    from repro_torch.serve.traffic import summarize
    vocab = cfg.vocab
    reqs = paged_traffic(cfg, seed)
    dense_kw = {k: v for k, v in PAGED.items() if k != "kv_block_size"}

    # the main path
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engines, runs, blocks = {}, {}, {}
    for sched in SCHEDULERS:
        eng = api.serve(model, base, reg, kv_layout="paged", scheduler=sched,
                        **PAGED)
        blocks[sched] = record_blocks(eng)
        rr = fresh(reqs, 0)
        eng.run(rr)
        engines[sched], runs[sched] = eng, rr
    seng = api.serve(model, base, reg, kv_layout="paged",
                     scheduler="affinity", top_k=40, **SAMPLING, **PAGED)
    sreqs = fresh(reqs, 0)
    seng.run(sreqs)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = ops.launch_counts()
    for name in ("ternary_matmul_grouped", "sample_tokens"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              "paged path")
    out = {"cold_serve_s": cold_s, "schedulers": {}}
    for sched in SCHEDULERS:
        eng = engines[sched]
        valid_tokens(runs[sched], vocab, f"paged/{sched}")
        s = eng.swap_summary()
        check(s["graph_captures"] >= 1 and s["graph_replays"] >= 1,
              f"paged/{sched}: the decode chunks ran no CUDA graph")
        # (e)
        check(not ({"position", "wrap"} & set(blocks[sched])),
              f"paged/{sched} reported dense blocks: {dict(blocks[sched])}")
        out["schedulers"][sched] = {
            "kv": kv_check(eng, f"paged/{sched}"),
            "blocks": dict(blocks[sched]), "admitted": s["admitted"],
            "deferred": s["scheduler"]["deferred"],
            "queue_depth_max": s["scheduler"]["queue_depth_max"],
            "stack_hit_rate": s["stack_hit_rate"],
            "graphs": graph_stats(eng)}
    valid_tokens(sreqs, vocab, "paged sampled/affinity")
    kv_check(seng, "paged sampled/affinity")

    # (a) the dense FIFO run, then every paged stream against it
    dense = api.serve(model, base, reg, **dense_kw)
    dblocks = record_blocks(dense)
    drr = fresh(reqs, 0)
    dense.run(drr)
    valid_tokens(drr, vocab, "dense/fifo")
    out["dense"] = {"blocks": dict(dblocks),
                    "admitted": dense.swap_summary()["admitted"],
                    "waves": len(dense.wave_log)}
    against = {}
    for sched in SCHEDULERS:
        eq, parted = near_ties(torch, engines[sched], runs[sched], drr,
                               f"bf16 paged/{sched} and dense/fifo")
        against[sched] = {"equal": eq, "parted": parted}
    out["bf16_against_dense"] = against
    log(f"  paged path: 24 requests; dense/fifo admitted "
        f"{out['dense']['admitted']} in {out['dense']['waves']} waves, "
        f"head-of-line blocks {dict(dblocks)}; paged against dense/fifo "
        "(bf16, near-tie rule): " + "; ".join(
            f"{s}: {a['equal']} equal, {len(a['parted'])} part at near-ties"
            for s, a in against.items()) + "; paged blocks " + "; ".join(
            f"{s}: {dict(blocks[s])}" for s in SCHEDULERS))

    # (c) the graphed chunks against the same chunks run eagerly; warm
    # engines capture nothing
    eager = eager_chunks(torch, api.serve(model, base, reg, kv_layout="paged",
                                          **PAGED))
    rr = fresh(reqs, 0)
    eager.run(rr)
    check([r.out_tokens for r in rr] == [r.out_tokens for r in runs["fifo"]],
          "paged path: the graph chunks' tokens differ from the same chunks "
          "run eagerly")
    check(graph_stats(eager)["graph_captures"] == 0,
          "the paged eager chunk check captured a graph")
    kv_check(eager, "paged eager chunks")
    del eager
    warm = {}
    for sched in SCHEDULERS:
        eng = engines[sched]
        c0 = eng.swap_summary()["graph_captures"]
        rr = fresh(reqs, 0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        eng.run(rr)
        torch.cuda.synchronize()
        warm[sched] = time.monotonic() - t1
        check([r.out_tokens for r in rr]
              == [r.out_tokens for r in runs[sched]],
              f"a warm paged/{sched} run gave other tokens")
        check(eng.swap_summary()["graph_captures"] == c0,
              f"a warm paged/{sched} engine captured a graph")
        kv_check(eng, f"warm paged/{sched}")
    c0 = dense.swap_summary()["graph_captures"]
    rr = fresh(reqs, 0)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    dense.run(rr)
    torch.cuda.synchronize()
    warm["dense/fifo"] = time.monotonic() - t1
    check([r.out_tokens for r in rr] == [r.out_tokens for r in drr],
          "a warm dense/fifo run gave other tokens")
    n_tok = sum(r.max_new_tokens for r in reqs)
    out["warm_serve_s"] = warm
    out["warm_tokens_per_s"] = {k: n_tok / v for k, v in warm.items()}
    log("  graph chunks bitwise the same chunks run eagerly; warm engines "
        "capture no graph; warm closed traffic, tokens/s end to end: "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    out["warm_tokens_per_s"].items()))

    # (d) smaller pools and the blocked head
    default = 4 * (256 // 16) + 1
    pools = {}
    for nb, sched in ((default // 2, "fifo"), (default // 4, "priority")):
        eng = api.serve(model, base, reg, kv_layout="paged", scheduler=sched,
                        kv_blocks=nb, **PAGED)
        pblocks = record_blocks(eng)
        rr = fresh(reqs, 0)
        eng.run(rr)
        valid_tokens(rr, vocab, f"paged/{sched}, {nb} blocks")
        kv = kv_check(eng, f"paged/{sched}, {nb} blocks")
        eq, parted = near_ties(torch, eng, rr, runs[sched],
                               f"bf16 paged/{sched} at {nb} and "
                               f"{default} blocks")
        requeued = sum(w["requeued"] for w in eng.wave_log)
        pools[nb] = {"scheduler": sched, "kv": kv, "requeued": requeued,
                     "blocks": dict(pblocks), "equal": eq,
                     "parted": parted,
                     "deferred": eng.swap_summary()["scheduler"]["deferred"]}
        del eng
    quarter = pools[default // 4]
    check(quarter["requeued"] >= 1, f"a pool of {default // 4} blocks "
          "re-queued no overflow row")
    out["pools"] = pools
    heads = {}
    for sched in ("priority", "fifo"):
        eng = api.serve(model, base, reg, kv_layout="paged", scheduler=sched,
                        max_batch=2, cache_len=256, kv_block_size=16,
                        kv_blocks=7, decode_chunk=8)
        hr = blocked_head_requests(torch, cfg)
        eng.run(hr)
        valid_tokens(hr, vocab, f"blocked head/{sched}")
        kv_check(eng, f"blocked head/{sched}")
        heads[sched] = {"first_token_order": sorted(
            range(4), key=lambda i: hr[i].t_first_s),
            "deferred": eng.swap_summary()["scheduler"]["deferred"],
            "tokens": [r.out_tokens for r in hr]}
        del eng
    check(heads["priority"]["first_token_order"].index(3)
          < heads["priority"]["first_token_order"].index(2)
          and heads["priority"]["deferred"] >= 1,
          f"priority did not admit past the blocked head: {heads}")
    check(heads["fifo"]["first_token_order"].index(2)
          < heads["fifo"]["first_token_order"].index(3),
          f"fifo did not keep head order: {heads}")
    out["blocked_head"] = {k: {"first_token_order": v["first_token_order"],
                               "deferred": v["deferred"]}
                           for k, v in heads.items()}
    log("  pools: " + "; ".join(
        f"{nb} blocks ({p['scheduler']}): peak {p['kv']['blocks_peak']} of "
        f"{p['kv']['blocks_total']}, {p['requeued']} re-queued, "
        f"{p['deferred']} deferred, {p['equal']} of 24 equal, "
        f"{len(p['parted'])} part at near-ties" for nb, p in pools.items())
        + "; blocked head: priority admits uid 3 past uid 2 (deferred "
        f"{heads['priority']['deferred']}), fifo keeps head order")

    # (b) and (f) on an f32 copy
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    base32 = tree_util.tree_map(lambda t: t.float(), base)

    def f32_runs(sched, **kw):
        runs32 = {}
        for K in (8, 1, 16):
            eng = api.serve(model32, base32, reg, kv_layout="paged",
                            scheduler=sched, **dict(PAGED, decode_chunk=K),
                            **kw)
            rr = fresh(reqs, 0)
            eng.run(rr)
            kv_check(eng, f"f32 paged/{sched} at decode_chunk {K}")
            runs32[K] = [r.out_tokens for r in rr]
            check(runs32[K] == runs32[8], f"f32 paged/{sched} {kw}: tokens "
                  f"at decode_chunk={K} differ from decode_chunk=8")
            del eng
        return runs32[8]

    def solos(**kw):
        eng = api.serve(model32, base32, reg, kv_layout="paged", **PAGED,
                        **kw)
        got = []
        for r in reqs:
            solo = fresh([r], 0)
            eng.run(solo)
            got.append(solo[0].out_tokens)
        kv_check(eng, "f32 paged solo serves")
        return got

    solo = solos()
    f32 = {}
    for sched in SCHEDULERS:
        toks = f32_runs(sched)
        for r, a, b in zip(reqs, toks, solo):
            check(a == b, f"f32 paged/{sched} request {r.uid}: {a} in the "
                  f"wave, {b} served alone")
        f32[sched] = toks
    eng = api.serve(model32, base32, reg, **dense_kw)
    rr = fresh(reqs, 0)
    eng.run(rr)
    out["f32_dense_equal_paged"] = sum(
        r.out_tokens == t for r, t in zip(rr, f32["fifo"]))
    del eng
    samp = dict(top_k=40, **SAMPLING)
    stoks = f32_runs("affinity", **samp)
    for r, a, b in zip(reqs, stoks, solos(**samp)):
        check(a == b, f"f32 sampled paged/affinity request {r.uid}: {a} in "
              f"the wave, {b} served alone")
    out["f32_sampled_equal_greedy"] = sum(
        a == b for a, b in zip(stoks, f32["affinity"]))
    del model32, base32
    log("  f32 copy: paged streams bitwise equal at decode_chunk 1, 8 and 16 "
        "under fifo, priority and affinity, and sampled under affinity, each "
        "equal to its solo serve; "
        f"{out['f32_dense_equal_paged']} of 24 equal the dense/fifo streams")

    # reported: the open-loop timeline, dense and paged, per scheduler
    open_loop = {}
    for layout in ("dense", "paged"):
        for sched in SCHEDULERS:
            if layout == "paged":
                eng = engines[sched]
            elif sched == "fifo":
                eng = dense
            else:
                eng = api.serve(model, base, reg, scheduler=sched,
                                **dense_kw)
                eng.run(fresh(reqs, 0))        # warm: captures its graphs
            ol = paged_traffic(cfg, seed, closed=False)
            reasons = record_blocks(eng)
            n0 = len(eng.wave_log)
            eng.run(ol)
            valid_tokens(ol, vocab, f"open-loop {layout}/{sched}")
            waves = eng.wave_log[n0:]
            rec = summarize(ol)
            by_prio = {}
            for p in sorted({r.priority for r in ol}):
                t = [r.t_first_s - r.arrival_s for r in ol if r.priority == p]
                by_prio[str(p)] = {q: float(np.percentile(t, q))
                                   for q in (50, 95, 99)}
            rec.update(
                ttft_by_priority_s=by_prio, admitted=sum(
                    w["admitted"] for w in waves),
                waves=len(waves), rows=[w["rows"] for w in waves],
                deferred=eng._sched.deferred, blocks=dict(reasons),
                blocks_peak=max((w.get("kv_blocks_peak", 0) for w in waves),
                                default=0))
            if layout == "paged":
                kv_check(eng, f"open-loop paged/{sched}")
            open_loop[f"{layout}/{sched}"] = rec
            if layout == "dense" and sched != "fifo":
                del eng
    out["open_loop"] = open_loop
    out["profile"] = profile_wave(torch, engines["fifo"], reqs, out_dir,
                                  "profile_paged")
    out["dense_profile"] = profile_wave(torch, dense, reqs, out_dir,
                                        "profile_paged_traffic_dense")
    out["attention_ms_per_step"] = attention_step_ms(torch, model.cfg)
    return launches, out


def remote_requests(reqs, uid0):
    """Phase 3's 8 requests reordered so that the first FIFO wave holds
    only e0, e1 and ``BASE`` and the second only e2 and e3."""
    order = [r for r in reqs if r.expert not in ("e2", "e3")] + \
        [r for r in reqs if r.expert in ("e2", "e3")]
    return fresh(order, uid0)


def timed_spans(obj, attr, spans):
    """Wrap the method ``attr`` of ``obj`` so that each call's (start,
    end) on the monotonic clock is appended to ``spans``."""
    inner = getattr(obj, attr)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return inner(*args, **kwargs)
        finally:
            spans.append((t0, time.monotonic()))
    setattr(obj, attr, timed)


def host_stages(torch, cache, seen):
    """Hold every prefetch stage of ``cache`` to the host: each staged
    tree's tensors must lie on the CPU (gate (e)); records the thread and
    the devices seen in ``seen``."""
    import threading
    stage = cache._stage

    def checked(name):
        tree, secs = stage(name)
        devs = sorted({t.device.type for pt in (tree or {}).values()
                       for t in (pt.pos, pt.neg, pt.scale)})
        seen.append((name, threading.current_thread().name, devs))
        check(devs in ([], ["cpu"]), f"the prefetch stage of {name} made "
              f"tensors on {devs}")
        return tree, secs
    cache._stage = checked


def planes_equal(torch, got, want, what):
    """``got`` (on any device) bitwise the published planes ``want``."""
    for path, pt in want.items():
        g = got[path]
        dev = pt.pos.device
        check(torch.equal(g.pos.to(dev), pt.pos)
              and torch.equal(g.neg.to(dev), pt.neg)
              and torch.equal(g.scale.to(dev), pt.scale),
              f"{what} {path}: fetched planes differ from the published")


def remote_path(torch, api, model, base, reg, experts, reqs, greqs,
                grouped_per_wave, art, tmp):
    """Phase 3r: the remote tiers at full width.  The 4 experts are
    published as PACKED wire blobs (no decode on arrival) and phase 3's 8
    requests served, each run on a fresh engine (phase 3's config) with
    the launch counts set to 0 just before it and read just after, from:

    1. a ``LocalTransport`` in a temporary directory;
    2. an ``HTTPTransport`` against ``serve_local_http`` on 127.0.0.1,
       mixed, then by merge-on-swap (``scheduling="grouped"``) from a
       second HTTP registry;
    3. a ``ReplicatedTransport`` over 3 ``ChaosTransport``-wrapped
       in-memory replicas, R = 2: one owner of e1 flips a seeded bit of
       e1's second read, the other goes down after 5 reads of each name.

    Gates: (a) every fetched tree bitwise the published planes, tokens
    bitwise phase 3's (mixed) and phase 3b's (merge-on-swap); (b) kernel
    1's launches per wave equal phase 3's; (c) a fresh engine whose e2
    and e3 sit behind a simulated link of 3 s captures its first wave's
    decode graphs while their prefetch stages are in flight: no capture
    error, ``prefetch_hits >= 1``, ``prefetch_errors == 0``, tokens
    bitwise a local registry's; (d) blackout of e2 (``quarantine_after=
    1``) under paged KV and the affinity scheduler: the e2 requests fail
    with an error naming e2 and "unavailable", the rest end done, 2
    failed, 1 quarantine, no KV block in use; survivors equal the
    no-fault run by the near-tie rule in bf16 and bitwise on an f32 copy;
    (e) every staged tree lies on the CPU until ``fetch`` moves it.
    Returns (numbers, launches)."""
    import threading
    from repro_torch import tree as tree_util
    from repro_torch.core.packing import tree_packed_bytes
    from repro_torch.expert import PACKED
    from repro_torch.kernels import ops
    from repro_torch.models import build as build_model
    from repro_torch.transport import (ChaosFault, ChaosTransport,
                                       HTTPTransport, InMemoryTransport,
                                       LocalTransport, ReplicaFault,
                                       ReplicatedTransport,
                                       SimulatedNetworkTransport,
                                       decode_expert, serve_local_http)
    kw = dict(max_batch=4, cache_len=128, decode_chunk=8, continuous=False)
    out, launches, stages = {}, {}, []
    want = [r.out_tokens for r in reqs]
    names = [e.name for e in experts]
    published = {e.name: e.packed for e in experts}

    def remote_registry(**rkw):
        r = api.registry(device=base["embed"].device,
                         device_cache_bytes=16 << 30, **rkw)
        host_stages(torch, r.device(), stages)
        return r

    def counted_run(what, engine, rr):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.run(rr)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        got = ops.launch_counts()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got, secs

    def mixed_gates(what, rreg, engine, rr, got):
        check([r.out_tokens for r in rr] == want,
              f"{what}: tokens differ from phase 3's")
        n = len(engine.wave_log)
        check(n == 2 and got["ternary_matmul_grouped"] / n
              == grouped_per_wave, f"{what}: "
              f"{got['ternary_matmul_grouped']} grouped launches in {n} "
              f"waves, phase 3 launched {grouped_per_wave} per wave")
        for name in names:
            planes_equal(torch, rreg.fetch_packed(name), published[name],
                         what)
        s = engine.swap_summary()
        check(s["prefetch_errors"] == 0 and s["failed"] == 0,
              f"{what}: {s['prefetch_errors']} prefetch errors, "
              f"{s['failed']} failed requests")
        return {k: s[k] for k in (
            "remote_fetches", "remote_bytes", "remote_seconds",
            "prefetch_issued", "prefetch_hits", "prefetch_seconds",
            "retries", "transport_bytes_wasted", "promotions",
            "host_to_device_bytes")}

    # 1. publish (PACKED) into a directory, serve from it
    root = os.path.join(tmp, "experts")
    local = LocalTransport(root)
    t0 = time.monotonic()
    info = [api.publish(e, local, rep=PACKED) for e in experts]
    out["publish_packed_s"] = time.monotonic() - t0
    blobs = {n: local.fetch_bytes(n) for n in names}
    params = sum(int(math.prod(pt.shape)) for pt in published["e0"].values())
    out["wire_bytes_per_expert"] = {
        "packed": {i["name"]: i["nbytes"] for i in info},
        "golomb": {k[:-5]: v for k, v in art["file_bytes"].items()
                   if k.endswith(".cpft")},
        "dense_reckoned": 2 * params}
    lreg = remote_registry(transport=local)
    leng = api.serve(model, base, lreg, **kw)
    rr = fresh(reqs, 1100)
    got, secs = counted_run("local", leng, rr)
    out["local"] = dict(mixed_gates("LocalTransport", lreg, leng, rr, got),
                        serve_s=secs)
    lreg.close()
    del leng, lreg
    log(f"  LocalTransport: 4 PACKED blobs of {info[0]['nbytes'] / 2**20:.1f}"
        f" MiB published in {out['publish_packed_s']:.2f} s; tokens bitwise "
        "phase 3's, planes bitwise the published, grouped launches per wave"
        " equal phase 3's")

    # 2. loopback HTTP: the per-expert costs, mixed serve, merge-on-swap
    server, url = serve_local_http(root)
    try:
        http = HTTPTransport(url)
        t0 = time.monotonic()
        raw = http.fetch_bytes("e0")
        fetch_s = time.monotonic() - t0
        t0 = time.monotonic()
        host = decode_expert(raw, device="cpu")
        decode_s = time.monotonic() - t0
        del raw
        hreg = remote_registry(transport=HTTPTransport(url))
        heng = api.serve(model, base, hreg, **kw)
        rr = fresh(reqs, 1200)
        got, secs = counted_run("http", heng, rr)
        out["http"] = dict(mixed_gates("HTTPTransport", hreg, heng, rr,
                                       got), serve_s=secs)
        # one promotion from the cold tier: the host-to-device copy alone
        cache = hreg.device()
        cache._drop_tree("e0")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tree = cache.fetch("e0")
        torch.cuda.synchronize()
        h2d_s = time.monotonic() - t0
        nbytes = tree_packed_bytes(tree)
        planes_equal(torch, tree, published["e0"], "HTTP promotion")
        hreg.close()
        del heng, hreg, tree, cache
        out["per_expert"] = {
            "http_fetch_s": fetch_s, "crc_decode_s": decode_s,
            "h2d_s": h2d_s, "h2d_bytes": nbytes,
            "h2d_gb_per_s": nbytes / h2d_s / 1e9}
        planes_equal(torch, host.packed, published["e0"],
                     "HTTP fetch and decode")
        del host

        # the cold and warm first token of a request whose expert is
        # remote (a fresh registry and engine, one request, then again),
        # its tokens those of the same request alone on a local registry
        solo = fresh([reqs[1]], 1302)
        api.serve(model, base, reg, **kw).run(solo)
        creg = remote_registry(transport=HTTPTransport(url))
        ceng = api.serve(model, base, creg, **kw)
        ttft = []
        for uid in (1300, 1301):
            one = fresh([reqs[1]], uid)
            ceng.run(one)
            check(one[0].out_tokens == solo[0].out_tokens,
                  "the remote first-token request's tokens differ from "
                  "the same request served alone from a local registry")
            ttft.append(one[0].t_first_s)
        out["ttft_s"] = {"cold": ttft[0], "warm": ttft[1]}
        creg.close()
        del ceng, creg

        greg = remote_registry(transport=HTTPTransport(url))
        geng = api.serve(model, base, greg, scheduling="grouped",
                         max_batch=4, cache_len=128, decode_chunk=8)
        rr = fresh(greqs, 1400)
        got, secs = counted_run("http merge", geng, rr)
        check([r.out_tokens for r in rr] == [r.out_tokens for r in greqs],
              "merge-on-swap over HTTP: tokens differ from phase 3b's")
        check(got["unpack_add_many"] > 0, "merge-on-swap over HTTP did not "
              "launch unpack_add_many")
        gs = geng.swap_summary()
        check(gs["n_swaps"] == 4 and gs["prefetch_errors"] == 0,
              f"merge-on-swap over HTTP: {gs['n_swaps']} swaps, "
              f"{gs['prefetch_errors']} prefetch errors")
        out["http_merge"] = {"serve_s": secs, "prefetch_hits":
                             gs["prefetch_hits"],
                             "remote_seconds": gs["remote_seconds"],
                             "prefetch_seconds": gs["prefetch_seconds"]}
        greg.close()
        del geng, greg
    finally:
        server.shutdown()
        server.server_close()
    log(f"  HTTP on 127.0.0.1: tokens bitwise phase 3's (mixed) and phase "
        "3b's (merge-on-swap, 4 swaps); planes bitwise the published")

    # 3. a replicated fleet: a bitflip on one owner of e1, the other owner
    # down mid-stream
    probe = ReplicatedTransport([InMemoryTransport() for _ in range(3)],
                                replication_factor=2)
    flip, down = probe._owners("e1")
    fleet = [ChaosTransport(
        InMemoryTransport(), seed=0,
        faults=[ChaosFault("e1", 1, "bitflip")] if i == flip else (),
        replica_faults=[ReplicaFault("blackout", at=5)] if i == down
        else ()) for i in range(3)]
    for e in experts:
        api.publish(e, fleet, rep=PACKED, replication_factor=2)
    rreg = remote_registry(replicas=fleet, replication_factor=2)
    reng = api.serve(model, base, rreg, **kw)
    rr = fresh(reqs, 1500)
    got, secs = counted_run("replicated", reng, rr)
    out["replicated"] = dict(mixed_gates("ReplicatedTransport", rreg, reng,
                                         rr, got), serve_s=secs)
    fired = {i: [f["kind"] for f in c.fired()] for i, c in enumerate(fleet)}
    check("bitflip" in fired[flip] and "replica_blackout" in fired[down],
          f"the replicated fleet's faults did not fire: {fired}")
    out["replicated"].update(
        faults=fired, health=rreg.health()["replicas"]["replicas"])
    rreg.close()
    del reng, rreg
    log(f"  replicated (3 replicas, R 2): replica {flip} flipped a bit of "
        f"e1, replica {down} went down after 5 reads a name ({fired}); "
        "tokens bitwise phase 3's")

    # (c) capture while the prefetch stages of e2 and e3 are in flight
    inner = InMemoryTransport()
    for n in ("e2", "e3"):
        inner._put(n, blobs[n])
    link = SimulatedNetworkTransport(bandwidth_bps=1e12, latency_s=3.0,
                                     inner=inner)
    gets, caps = [], []
    timed_spans(link, "_get", gets)
    sreg = remote_registry(transport=link)
    sreg.add(experts[0], experts[1])        # local overlays, card-resident
    seng = api.serve(model, base, sreg, **kw)
    timed_spans(seng._chunker, "_capture", caps)
    order = remote_requests(reqs, 1600)
    ops.reset_launch_counts()
    seng.run(order)
    torch.cuda.synchronize()
    for k, v in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    ss = seng.swap_summary()
    overlapped = [c for c in caps
                  if any(g[0] < c[0] and c[1] < g[1] for g in gets)]
    check(len(caps) >= 1 and overlapped, f"no capture ran inside a prefetch "
          f"stage: captures {caps}, link reads {gets}")
    check(ss["prefetch_hits"] >= 1 and ss["prefetch_errors"] == 0,
          f"prefetch under capture: {ss['prefetch_hits']} hits, "
          f"{ss['prefetch_errors']} errors")
    ref = remote_requests(reqs, 1700)
    api.serve(model, base, reg, **kw).run(ref)
    check([r.out_tokens for r in order] == [r.out_tokens for r in ref],
          "prefetch under capture: tokens differ from a local registry's")
    planes_equal(torch, sreg.fetch_packed("e2"), published["e2"],
                 "simulated link")
    out["capture_overlap"] = {
        "captures": len(caps), "captures_in_flight": len(overlapped),
        "prefetch_hits": ss["prefetch_hits"],
        "prefetch_seconds": ss["prefetch_seconds"],
        "remote_seconds": ss["remote_seconds"]}
    sreg.close()
    del seng, sreg
    log(f"  capture under prefetch: {len(overlapped)} of {len(caps)} "
        f"captures ran while e2/e3 were on the 3 s link; "
        f"{ss['prefetch_hits']} prefetch hits, 0 errors; tokens bitwise a "
        "local registry's")

    # (d) blackout of e2 under paged KV and the affinity scheduler, bf16
    # and on an f32 copy
    pkw = dict(max_batch=4, cache_len=128, decode_chunk=8,
               kv_layout="paged", kv_block_size=16, scheduler="affinity")
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    base32 = tree_util.tree_map(lambda t: t.float(), base)
    blackout = {}
    for dtype, m, b in (("bf16", model, base), ("f32", model32, base32)):
        clean_eng = api.serve(m, b, reg, **pkw)
        clean = fresh(reqs, 1800)
        clean_eng.run(clean)
        store = InMemoryTransport()
        for n in names:
            store._put(n, blobs[n])
        breg = api.registry(transport=ChaosTransport(store, blackout=["e2"],
                                                     seed=0),
                            device=base["embed"].device,
                            device_cache_bytes=16 << 30, quarantine_after=1)
        host_stages(torch, breg.device(), stages)
        beng = api.serve(m, b, breg, **pkw)
        rr = fresh(reqs, 1900)
        beng.run(rr)
        s = beng.swap_summary()
        hit = [r for r in rr if r.expert == "e2"]
        for r in hit:
            check(r.status == "failed" and r.out_tokens == []
                  and "e2" in r.error and "unavailable" in r.error,
                  f"blackout {dtype}: request {r.uid} on e2 ended "
                  f"{r.status} ({r.error})")
        check(all(r.status == "done" for r in rr if r.expert != "e2"),
              f"blackout {dtype}: a request on another expert failed")
        check(s["failed"] == len(hit) == 2 and s["quarantines"] == 1,
              f"blackout {dtype}: failed {s['failed']}, quarantines "
              f"{s['quarantines']}")
        kv_check(beng, f"blackout {dtype}")
        survivors = [(r, c) for r, c in zip(rr, clean) if r.expert != "e2"]
        if dtype == "f32":
            check(all(r.out_tokens == c.out_tokens for r, c in survivors),
                  "blackout f32: a survivor's tokens differ from the "
                  "no-fault run's")
            equal, parted = len(survivors), []
        else:
            equal, parted = near_ties(torch, clean_eng,
                                      [c for _, c in survivors],
                                      [r for r, _ in survivors],
                                      "blackout bf16 against no fault")
        blackout[dtype] = {"failed": s["failed"],
                           "quarantines": s["quarantines"],
                           "survivors_equal": equal, "parted": parted,
                           "prefetch_errors": s["prefetch_errors"],
                           "kv": s["kv"]}
        breg.close()
        del clean_eng, beng, breg
    del model32, base32
    out["blackout"] = blackout
    check(stages and all(d in ([], ["cpu"]) for _, _, d in stages)
          and all(t != threading.current_thread().name
                  for _, t, _ in stages),
          "a prefetch stage ran off a worker or made device tensors")
    out["stages"] = {"n": len(stages), "on_host": True}
    log(f"  blackout of e2 (paged, affinity): 2 failed, 1 quarantine, no "
        f"block in use; survivors bf16 {blackout['bf16']['survivors_equal']}"
        f" of 6 equal ({len(blackout['bf16']['parted'])} at near-ties), "
        "f32 all 6 bitwise; every one of "
        f"{len(stages)} prefetch stages left its planes on the host")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 3k: kill and resume (journal, snapshots, resume, a SIGKILL child)
# ---------------------------------------------------------------------------

DURABLE = dict(max_batch=4, cache_len=256, decode_chunk=8)


class Crashed(Exception):
    pass


def journal_frames(path) -> list:
    """(kind, bytes) of every record of a journal file, its 8-byte frame
    header included."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 4
    while pos + 8 <= len(data):
        n, _ = struct.unpack_from("<II", data, pos)
        out.append((json.loads(data[pos + 8:pos + 8 + n])["k"], 8 + n))
        pos += 8 + n
    return out


def kill_chunk(snap_dir) -> int:
    """From the journal of an uninterrupted run: the first chunk k (counted
    from the run's first) such that rows were admitted at chunk k - 1's
    boundary, after its snapshot (so they are served again from their
    prompts), a row that emitted in chunk k - 1 is still unfinished (so it
    continues from the restored KV), and requests remain after chunk k."""
    from repro_torch.serve import journal as journal_mod
    recs = journal_mod.read_records(
        os.path.join(snap_dir, journal_mod.JOURNAL_NAME))
    budget = {d["uid"]: d["max_new"] for d in recs[0]["d"]["requests"]}
    total, chunk, first = {}, None, None
    admitted, live, unfinished = set(), {}, {}
    for rec in recs[1:]:
        if rec["k"] == "chunk":
            chunk = rec["d"]["i"]
            first = chunk if first is None else first
            for row in rec["d"]["rows"]:
                total[row["uid"]] = row["total"]
            live[chunk] = any(total[row["uid"]] < budget[row["uid"]]
                              for row in rec["d"]["rows"])
            unfinished[chunk] = any(total.get(u, 0) < b
                                    for u, b in budget.items())
        elif rec["k"] == "admit" and chunk is not None:
            admitted.add(chunk)
    for k in sorted(unfinished):
        if k - 1 in admitted and live.get(k - 1) and unfinished[k]:
            return k - first + 1
    raise CheckFailed("phase 3k: no chunk of the run has an admission after "
                      "its last snapshot with rows in flight")


def kept_ptrs(engine) -> dict:
    """Every kept buffer's address (the tensors a decode graph reads)."""
    from repro_torch import tree as tree_util
    return {f"{kind}{rows}/{path}": t.data_ptr()
            for kind, states in (("dense", engine._states),
                                 ("paged", engine._paged_states))
            for rows, st in states.items()
            for path, t in tree_util.flatten_with_paths(st)}


def crash_run(engine, reqs, rel: int) -> None:
    """Serve ``reqs`` on ``engine``, crashing from a chunk hook at the
    run's chunk ``rel``."""
    kill = engine._chunk_idx + rel

    def crash(i):
        if i == kill:
            raise Crashed(f"crash at chunk {i}")

    engine.chunk_hooks.append(crash)
    try:
        engine.run(reqs)
        raise CheckFailed(f"phase 3k: the crash at chunk {rel} never came")
    except Crashed:
        pass
    finally:
        engine.chunk_hooks.remove(crash)


def continued_uids(snap_dir) -> set:
    """Requests of the last snapshot's wave still unfinished in the
    journal: ``resume()`` continues them from the restored KV."""
    from repro_torch.serve import journal as journal_mod
    from repro_torch.serve.snapshot import load_snapshot
    st = journal_mod.replay(os.path.join(snap_dir, journal_mod.JOURNAL_NAME))
    if not st.snapshots:
        return set()
    snap = load_snapshot(snap_dir, int(st.snapshots[-1]["step"]))
    budget = {d["uid"]: d["max_new"] for d in st.meta["requests"]}
    return {u for u in snap.row_uids
            if len(st.tokens.get(u, [])) < budget[u] and u not in st.failed}


def checked_resume(torch, resume, snap_dir, want: dict, exact: bool,
                   what: str) -> dict:
    """Run ``resume()`` (a call that resumes an engine from ``snap_dir``)
    against the uninterrupted run's tokens ``want``.  ``exact`` (an f32
    copy): the resume completes and every stream is bitwise ``want``.
    Otherwise (bf16): rows continued from the restored wave are bitwise
    ``want``; a row served again from its prompt runs at other positions
    and may part from ``want``: where it parts inside its journaled
    prefix (the journal's prefix check then raises) the parting must be
    a near-tie (:func:`near_tie`, a gate); past the prefix it is
    reported.  Kernel 1 must launch at least once a chunk, the sampler
    when sampled.  Returns the numbers."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    seen = {}
    verify, orig_resume = ServeEngine._verify_journal_prefix, ServeEngine.resume

    def spy(requests, state):
        seen["requests"] = requests
        return verify(requests, state)

    def recorded(self):
        seen["engine"], seen["n0"] = self, len(self.wave_log)
        return orig_resume(self)

    from repro_torch.serve import journal as journal_mod
    cont = continued_uids(snap_dir)
    journaled = {u: len(t) for u, t in journal_mod.replay(os.path.join(
        snap_dir, journal_mod.JOURNAL_NAME)).tokens.items()}
    before = ops.launch_counts()
    ServeEngine._verify_journal_prefix = staticmethod(spy)
    ServeEngine.resume = recorded
    raised = None
    try:
        resume()
    except RuntimeError as e:
        if exact or "diverged from the journal" not in str(e):
            raise
        raised = str(e)
    finally:
        ServeEngine._verify_journal_prefix = staticmethod(verify)
        ServeEngine.resume = orig_resume
    torch.cuda.synchronize()
    engine = seen["engine"]
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()}
    chunks = sum(w["chunks"] for w in engine.wave_log[seen["n0"]:])
    check(launches["ternary_matmul_grouped"] >= chunks,
          f"{what}: kernel 1 launched {launches['ternary_matmul_grouped']} "
          f"times over {chunks} chunks")
    if not engine.cfg.sampling.greedy and chunks:
        check(launches["sample_tokens"] > 0,
              f"{what}: the sampler was not launched")
    out = {"completed": raised is None, "prefix_check": raised,
           "continued": sorted(cont), "parted": [], "chunks": chunks,
           "launches": {k: v for k, v in launches.items() if v}}
    for r in seen["requests"]:
        check(r.status == "done", f"{what}: request {r.uid} ended "
              f"{r.status}: {r.error}")
        if exact or r.uid in cont:
            check(r.out_tokens == want[r.uid], f"{what}: request {r.uid}"
                  f"{' (continued)' if r.uid in cont else ''} differs from "
                  f"the uninterrupted run: {r.out_tokens} vs {want[r.uid]}")
            continue
        entry = near_tie(torch, engine, r, want[r.uid], r.out_tokens,
                         f"{what}: uninterrupted and resumed", gate=False)
        if entry is not None:
            entry["journaled"] = journaled.get(r.uid, 0)
            check(entry["within"] or entry["step"] >= entry["journaled"],
                  f"{what}: request {r.uid} parts from its journaled "
                  f"tokens beyond a near-tie: {entry}")
            out["parted"].append(entry)
    if raised is not None:
        log(f"  {what}: the prefix check raised ({raised}); each parted row "
            "is a near-tie")
    else:
        rs = engine.recovery_stats
        out.update(resume_s=rs["resume_seconds"],
                   first_resumed_token_s=rs.get("first_resumed_token_s"),
                   plan=rs["plan"].as_dict())
    return out


def durability_case(torch, api, model, base, reg, kw, traffic, d, exact,
                    what, fresh_engine):
    """Cases (a) and (b) on one model copy: the traffic served
    uninterrupted on an engine journaling into ``d`` with a snapshot after
    every chunk; a second run crashed from a chunk hook at the chunk
    :func:`kill_chunk` picks; ``resume()`` on the same, now warm, engine
    (gates: no capture, every kept buffer at its address, no KV block in
    use) and, with ``fresh_engine``, on a fresh engine.  Returns
    (numbers, uninterrupted tokens, kill chunk)."""
    full = dict(kw, snapshot_dir=d, snapshot_every_chunks=1)
    eng = api.serve(model, base, reg, **full)
    clean = fresh(traffic, 0)
    eng.run(clean)
    want = {r.uid: r.out_tokens for r in clean}
    frames = journal_frames(os.path.join(d, "journal.bin"))
    rel = kill_chunk(d)
    crash_run(eng, fresh(traffic, 0), rel)
    ptrs, c0 = kept_ptrs(eng), eng.swap_summary()["graph_captures"]
    warm = checked_resume(torch, lambda: eng.resume(), d, want, exact,
                          f"{what}, warm resume")
    after, s = kept_ptrs(eng), eng.swap_summary()
    check({k: after[k] for k in ptrs} == ptrs,
          f"{what}: the warm resume moved a kept buffer")
    warm["captures"] = s["graph_captures"] - c0
    check(warm["captures"] == 0,
          f"{what}: the warm resume captured {warm['captures']} graphs")
    check(s["kv"]["blocks_in_use"] == 0, f"{what}: {s['kv']['blocks_in_use']}"
          " KV blocks in use after the resume")
    out = {"kill_chunk": rel, "warm": warm, "journal_bytes": {
        k: [b for kind, b in frames if kind == k]
        for k in ("run_start", "sched", "admit", "chunk", "snap")}}
    if fresh_engine:
        eng2 = api.serve(model, base, reg, **full)
        out["fresh"] = checked_resume(torch, lambda: eng2.resume(), d,
                                      want, exact, f"{what}, fresh resume")
        check(eng2.swap_summary()["kv"]["blocks_in_use"] == 0,
              f"{what}: KV blocks in use after the fresh resume")
    for k in ("warm", "fresh"):
        p = out.get(k, {}).get("plan")
        check(p is None or (p["snapshot_step"] is not None
                            and p["replayed_rows"] > 0
                            and p["reprefilled_rows"] > 0),
              f"{what}, {k}: the resume restored no wave or served no row "
              f"again: {p}")
    return out, want, rel


def start_child(setup, snap, rel) -> dict:
    """Start the SIGKILL child on the card and return at once; the handle
    goes to :func:`finish_child`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    log_path = snap + ".log"
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.restart_child", snap,
             setup, str(rel)], env=env, stdout=f, stderr=subprocess.STDOUT)
    _RANKS.append(proc)
    return {"proc": proc, "log": log_path, "t0": time.monotonic()}


def finish_child(h, snap, rel, what) -> dict:
    """Wait for the SIGKILL child: returns its seconds (from its start);
    gates: killed by SIGKILL, ``rel`` chunks journaled, no clean end."""
    import signal
    from repro_torch.serve import journal as journal_mod
    proc = h["proc"]
    proc.wait(timeout=300)
    child_s = time.monotonic() - h["t0"]
    with open(h["log"]) as f:
        err = f.read()
    check(proc.returncode == -signal.SIGKILL,
          f"{what}: the child ended with {proc.returncode}, not SIGKILL: "
          f"{err[-3000:]}")
    st = journal_mod.replay(os.path.join(snap, journal_mod.JOURNAL_NAME))
    check(st.chunks == rel and not st.clean_end and st.snapshots,
          f"{what}: the child journaled {st.chunks} chunks and "
          f"{len(st.snapshots)} snapshots, clean end {st.clean_end}")
    return {"child_s": child_s, "journaled_chunks": st.chunks,
            "journal_records": st.n_records}


def warm_rate(torch, engine, reqs, reps=2) -> dict:
    """Tokens/s of warm runs of ``reqs`` on ``engine`` (after a cold one):
    end to end, and decode (the waves' time past their prefills)."""
    engine.run(fresh(reqs, 0))
    ends, decs = [], []
    for _ in range(reps):
        n0 = len(engine.wave_log)
        rr = fresh(reqs, 0)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.run(rr)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        waves = engine.wave_log[n0:]
        ends.append(sum(r.max_new_tokens for r in rr) / wall)
        decs.append(sum(w["tokens"] - w["rows"] for w in waves)
                    / sum(w["seconds"] - w["prefill_s"] for w in waves))
    return {"tokens_per_s": ends, "decode_tokens_per_s": decs}


def durability_path(torch, api, model, base, reg, experts, cfg, seed, units,
                    tmp):
    """Phase 3k: kill and resume at full width.  The main path, driven
    with the launch counts set to 0 just before it and read just after,
    in bf16:

    (a) phase 3d's 16 refill requests (``max_batch`` 4, ``cache_len`` 256,
        ``decode_chunk`` 8) served uninterrupted with a snapshot after
        every chunk, served again and crashed from a chunk hook where rows
        admitted after the last snapshot are in flight, then ``resume()``
        (i) on the same warm engine (0 captures, every kept buffer at its
        address) and (ii) on a fresh engine;
    (b) phase 3p's 24 closed requests, paged (block 16), affinity,
        sampled (T 0.8, top_k 40), likewise, resumed warm (0 KV blocks in
        use after it);
    (c) the crash of (a) journaled only (``snapshot_every_chunks=0``),
        resumed through ``api.serve(resume=True)``: no snapshot step;
    (d) a finished run resumed from its journal alone (no wave), and a
        resume with another seed refused ("sampling mismatch");
    (e) the base saved with ``checkpoint.manager.save`` and the experts
        published as PACKED blobs; ``repro_torch.serve.restart_child``
        serves (a)'s traffic and dies by SIGKILL at (a)'s chunk; resumed
        in this process;
    and phase 3d's traffic timed with no journal, the journal alone and a
    snapshot every 1 and 4 chunks.  In bf16 rows continued from a
    restored wave must equal the uninterrupted run bitwise; a row served
    again from its prompt runs at other positions and may part at a
    near-tie (a gate), which the journal's prefix check reports by
    raising.  Then (a), (b), (c) and (e) on an f32 copy, where every
    stream must equal the uninterrupted run bitwise and every resume
    complete.  Returns (launches, numbers)."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops
    from repro_torch.models import build as build_model
    from repro_torch.serve import snapshot as snap_mod
    from repro_torch.serve.restart_child import write_setup
    reqs = refill_requests(torch, cfg, seed)
    preqs = paged_traffic(cfg, seed)
    pkw = dict(PAGED, kv_layout="paged", scheduler="affinity", top_k=40,
               **SAMPLING)
    snaps = []
    write, save = snap_mod.write_snapshot, snap_mod.manager.save

    def timed_save(state, d, step, extra_meta=None):
        t0 = time.monotonic()
        path = save(state, d, step, extra_meta=extra_meta)
        snaps[-1].update(commit_s=time.monotonic() - t0, bytes=sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)))
        return path

    def timed_write(engine, **kw):
        snaps.append({"layout": engine.cfg.kv_layout,
                      "dtype": str(engine.base["embed"].dtype)})
        t0 = time.monotonic()
        path = write(engine, **kw)
        snaps[-1]["total_s"] = time.monotonic() - t0
        return path

    snap_mod.write_snapshot, snap_mod.manager.save = timed_write, timed_save
    out = {}
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out["a"], want, rel = durability_case(
            torch, api, model, base, reg, DURABLE, reqs,
            os.path.join(tmp, "a"), False, "3k (a) dense greedy bf16", True)
        out["b"], pwant, _ = durability_case(
            torch, api, model, base, reg, pkw, preqs,
            os.path.join(tmp, "b"), False,
            "3k (b) paged sampled affinity bf16", False)
        # (c)
        dc = os.path.join(tmp, "c")
        crash_run(api.serve(model, base, reg, snapshot_dir=dc, **DURABLE),
                  fresh(reqs, 0), rel)
        out["c"] = checked_resume(
            torch, lambda: api.serve(model, base, reg, snapshot_dir=dc,
                                     resume=True, **DURABLE),
            dc, want, False, "3k (c) journal only bf16")
        check(out["c"].get("plan") is None
              or out["c"]["plan"]["snapshot_step"] is None,
              f"3k (c): a snapshot step without snapshots: {out['c']}")
        # (d)
        dd = os.path.join(tmp, "d")
        jeng = api.serve(model, base, reg, snapshot_dir=dd, **DURABLE)
        done = fresh(reqs, 0)
        jeng.run(done)
        check({r.uid: r.out_tokens for r in done} == want,
              "3k (d): a journaled run gave other tokens than (a)'s")
        eng = api.serve(model, base, reg, snapshot_dir=dd, **DURABLE)
        got = eng.resume()
        plan = eng.recovery_stats["plan"].as_dict()
        check({r.uid: r.out_tokens for r in got} == want
              and len(eng.wave_log) == 0 and plan["snapshot_step"] is None
              and plan["replayed_rows"] == plan["reprefilled_rows"] == 0,
              f"3k (d): a finished run did not resume from its journal "
              f"alone: {plan}, {len(eng.wave_log)} waves")
        bad = dict(pkw, seed=SAMPLING["seed"] + 1)
        try:
            api.serve(model, base, reg, snapshot_dir=os.path.join(tmp, "b"),
                      **bad).resume()
            raise CheckFailed("3k (d): a resume with another seed ran")
        except ValueError as e:
            check("sampling mismatch" in str(e), f"3k (d): {e}")
        out["d"] = {"plan": plan, "mismatch": "refused"}
        # (e)
        setup = os.path.join(tmp, "setup")
        ts = time.monotonic()
        write_setup(setup, arch="qwen2_5_3b", n_units=units, base=base,
                    experts=experts, requests=reqs, engine_kw=DURABLE,
                    registry_kw={"device_cache_bytes": 16 << 30})
        setup_s = time.monotonic() - ts
        base_bytes = sum(os.path.getsize(os.path.join(setup, "base", x, f))
                         for x in os.listdir(os.path.join(setup, "base"))
                         for f in os.listdir(os.path.join(setup, "base", x)))
        # the f32 child (for the f32 copy below) runs beside the bf16 one
        setup32 = os.path.join(tmp, "setup32")
        write_setup(setup32, arch="qwen2_5_3b", n_units=units, base=base,
                    experts=experts, requests=reqs, engine_kw=DURABLE,
                    dtype="float32",
                    registry_kw={"device_cache_bytes": 16 << 30})
        de, de32 = os.path.join(tmp, "e"), os.path.join(tmp, "e32")
        child = start_child(setup, de, rel)
        child32 = start_child(setup32, de32, rel)
        out["e"] = finish_child(child, de, rel, "3k (e) bf16")
        out["e"].update(setup_s=setup_s, base_bytes=base_bytes)
        eng = api.serve(model, base, reg, snapshot_dir=de,
                        snapshot_every_chunks=1, **DURABLE)
        out["e"]["resume"] = checked_resume(
            torch, lambda: eng.resume(), de, want, False, "3k (e) SIGKILL child bf16")
        # decode tokens/s: no journal, the journal alone, a snapshot every
        # 1 and every 4 chunks
        rates = {}
        for name, kw in (("none", {}),
                         ("journal", dict(snapshot_dir=os.path.join(
                             tmp, "r1"))),
                         ("snapshot_every_1", dict(snapshot_dir=os.path.join(
                             tmp, "r2"), snapshot_every_chunks=1)),
                         ("snapshot_every_4", dict(snapshot_dir=os.path.join(
                             tmp, "r3"), snapshot_every_chunks=4))):
            rates[name] = warm_rate(torch, api.serve(model, base, reg,
                                                     **DURABLE, **kw), reqs)
        out["rates"] = rates
        torch.cuda.synchronize()
        out["path_s"] = time.monotonic() - t0
        launches = ops.launch_counts()
        for name in ("ternary_matmul_grouped", "sample_tokens"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the durability path")

        # the f32 copy: every stream bitwise, every resume complete
        model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
        base32 = tree_util.tree_map(lambda t: t.float(), base)
        f32 = {}
        f32["a"], want32, rel32 = durability_case(
            torch, api, model32, base32, reg, DURABLE, reqs,
            os.path.join(tmp, "a32"), True, "3k (a) dense greedy f32", True)
        check(rel32 == rel, f"3k: the f32 run's kill chunk {rel32} is not "
              f"bf16's {rel}")
        f32["b"], _, _ = durability_case(
            torch, api, model32, base32, reg, pkw, preqs,
            os.path.join(tmp, "b32"), True,
            "3k (b) paged sampled affinity f32", False)
        dc32 = os.path.join(tmp, "c32")
        crash_run(api.serve(model32, base32, reg, snapshot_dir=dc32,
                            **DURABLE), fresh(reqs, 0), rel)
        f32["c"] = checked_resume(
            torch, lambda: api.serve(model32, base32, reg, snapshot_dir=dc32,
                                     resume=True, **DURABLE),
            dc32, want32, True, "3k (c) journal only f32")
        check(f32["c"]["plan"]["snapshot_step"] is None,
              f"3k (c) f32: {f32['c']['plan']}")
        f32["e"] = finish_child(child32, de32, rel, "3k (e) f32")
        eng = api.serve(model32, base32, reg, snapshot_dir=de32,
                        snapshot_every_chunks=1, **DURABLE)
        f32["e"]["resume"] = checked_resume(
            torch, lambda: eng.resume(), de32, want32, True,
            "3k (e) SIGKILL child f32")
        out["f32"] = f32
        del model32, base32, eng
    finally:
        snap_mod.write_snapshot, snap_mod.manager.save = write, save
    out["snapshots"] = snaps
    return launches, out


# ---------------------------------------------------------------------------
# Phase 3t: produce an expert (train, restart, compress, serve), LoRA and
# gradient compression
# ---------------------------------------------------------------------------


TRAIN = dict(seq_len=64, global_batch=8, task_id=1)   # 512 tokens a step
TRAIN_STEPS = 20          # (a): AdamW
RESTART_STEPS = 15        # (b): Adafactor, failures at 7 and 13
LORA_STEPS = 20           # (d): SGD on a rank-8 LoRA
LORA_LR = 0.05
GRAD_DENSITY = 0.05       # (e)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_PEAK_FLOPS = 989e12


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_numbers(hist, n_params, tokens) -> dict:
    """A run's step times (host clock, each ending with its loss on the
    host): median and minimum over the steps after the first two (which
    pay one-time setup), tokens/s and the model FLOP utilisation 6 N
    tokens / step time against the dense bf16 peak."""
    secs = sorted(h["sec"] for h in hist[2:])
    med = secs[len(secs) // 2]
    return {"step_ms_median": med * 1e3, "step_ms_min": secs[0] * 1e3,
            "tokens_per_s": tokens / med,
            "mfu": 6 * n_params * tokens / med / BF16_PEAK_FLOPS,
            "losses": [h["loss"] for h in hist]}


def profile_train_step(torch, model, tcfg, state, batch, out_dir) -> dict:
    """torch.profiler over one warm train step from ``state`` (its result
    dropped): the forward and backward, a synchronisation, then the
    optimizer update, so each kernel falls in one part.  Device ms by
    part and family (cuBLAS GEMM or other), launches, wall and the idle
    share; the full table goes to chiprun_out/profile_train_step.txt."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.train.train_step import (_apply_optimizer,
                                              _microbatch_grads,
                                              deterministic)
    dev = batch["tokens"].device
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        with deterministic(dev):
            with record_function("forward_backward"):
                _, grads = _microbatch_grads(model, state["params"], batch,
                                             tcfg.microbatches)
                torch.cuda.synchronize()
            with record_function("optimizer_update"):
                new, _ = _apply_optimizer(state, grads, tcfg)
                torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    del new, grads
    t_upd = min((ev.time_range.start for ev in prof.events()
                 if ev.name == "optimizer_update"
                 and ev.device_type.name == "CPU"), default=None)
    fams = ("cuBLAS GEMM", "other PyTorch kernels")
    parts = {ph: {f: 0.0 for f in fams} for ph in ("forward_backward",
                                                  "optimizer_update")}
    counts = {ph: 0 for ph in parts}
    for ev in prof.events():
        if ev.device_type.name != "CUDA" or ev.name in parts:
            continue
        name = ev.name.lower()
        fam = fams[0] if any(k in name for k in (
            "gemm", "cutlass", "xmma", "sm90", "nvjet")) else fams[1]
        ph = ("optimizer_update" if t_upd is not None
              and ev.time_range.start >= t_upd else "forward_backward")
        parts[ph][fam] += ev.time_range.elapsed_us() / 1e3
        counts[ph] += 1
    kernels = sorted((ev for ev in prof.key_averages()
                      if ev.device_type.name == "CUDA"
                      and ev.key not in parts),
                     key=lambda ev: -ev.self_device_time_total)
    with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as f:
        f.write("device_ms\tlaunches\tkernel\n")
        for ev in kernels:
            f.write(f"{ev.self_device_time_total / 1e3:.3f}\t{ev.count}\t"
                    f"{ev.key}\n")
    busy = sum(sum(v.values()) for v in parts.values())

    def median_step_ms(det: bool) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with (deterministic(dev) if det else contextlib.nullcontext()):
                _, g = _microbatch_grads(model, state["params"], batch,
                                         tcfg.microbatches)
                n, _ = _apply_optimizer(state, g, tcfg)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
            del g, n
        return sorted(times)[1]

    # what the deterministic mode costs a step (the same step without it)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "device_ms": parts,
           "launches": counts,
           "step_ms_deterministic": median_step_ms(True),
           "step_ms_nondeterministic": median_step_ms(False)}
    log("  profiled train step: wall {:.1f} ms, device busy {:.1f} ms "
        "(idle {:.1%}); ".format(wall_ms, busy, out["idle_share"])
        + "; ".join(f"{ph} " + ", ".join(f"{f} {v:.2f} ms" for f, v in
                                          parts[ph].items())
                    + f" ({counts[ph]} launches)" for ph in parts)
        + "; a step {:.2f} ms deterministic, {:.2f} ms without".format(
            out["step_ms_deterministic"], out["step_ms_nondeterministic"]))
    return out


def training_phase(torch, api, model, base, experts, reqs, cfg, seed, dev):
    """Phase 3t as a path: every launch count set to 0 just before and
    read just after; the compression and serving kernels must launch."""
    from repro_torch.kernels import ops
    log("phase 3t: produce an expert (AdamW fine-tune, Adafactor restart, "
        "compress and serve the trained tau, LoRA, gradient compression)")
    ops.reset_launch_counts()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="_artifacts_", dir=ROOT) as tmp:
        trained = training_path(torch, api, model, base, experts, reqs, cfg,
                                seed, dev, tmp)
    trained["phase_s"] = time.monotonic() - t0
    launches = ops.launch_counts()
    log(f"  launches on the training path: {launches}; phase 3t took "
        f"{trained['phase_s']:.1f} s")
    for name in MIXED_PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the training path")
    return trained, launches


def training_path(torch, api, model, base, experts, reqs, cfg, seed, dev,
                  tmp):
    """Phase 3t.  (a) ``train_loop`` with AdamW for TRAIN_STEPS steps on
    task 1 (batch 8 x 64) from the base: the mean loss of the last 5
    steps below the first 5's.  (b) Adafactor, ``ckpt_every=5``, a
    ``FailureInjector`` at steps 7 and 13: every leaf of the final state
    bitwise an uninterrupted run's; one save and one restore of its state
    timed.  (c) tau = theta_ft - theta_init compressed by
    ``api.compress(...).as_(PACKED)`` (kernels 3a, 3, 2): planes bitwise
    the plain compression's; held-out ``eval_loss`` of the fine-tune below
    the base's; the training state freed, then phase 3's 8 requests with
    e1 replaced by the trained expert served mixed over e0-e3 and BASE
    (kernel 1): row independence bitwise, solo serves up to a near-tie,
    a warm run repeating its tokens.  (d) a rank-8 LoRA trained by
    ``apply_lora`` and autograd (LORA_STEPS SGD steps), compressed with
    ``kind="lora"`` and reconstructed; base, fine-tuned and reconstructed
    ``eval_loss`` reported.  (e) ``compress_leaf_for_allgather`` (exact
    threshold, density 0.05) over the fine-tune's gradients of one batch:
    each leaf's plane density within 0.5 points of 0.05, the error
    feedback bitwise ``g - s * signs`` of its own planes.  Returns the
    numbers."""
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import gradient_compression as gc
    from repro_torch.core.packing import popcount
    from repro_torch.data.pipeline import eval_loss, make_batch_for
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.expert import DENSE, PACKED
    from repro_torch.peft import LoraConfig, apply_lora, init_lora
    from repro_torch.train import (LoopConfig, TrainConfig,
                                   init_train_state, make_train_step,
                                   train_loop)
    from repro_torch.train.train_step import deterministic, value_and_grad
    out: dict = {}
    cuda = dev.type == "cuda"
    n_params = sum(t.numel() for t in tree_util.leaves(base))
    tokens = TRAIN["seq_len"] * TRAIN["global_batch"]

    def clone(tree):
        return tree_util.tree_map(lambda t: t.clone(), tree)

    def quiet(_msg):
        pass

    log(f"  (a) AdamW, {TRAIN_STEPS} steps of {TRAIN['global_batch']} x "
        f"{TRAIN['seq_len']} tokens on task {TRAIN['task_id']}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=3,
                       total_steps=TRAIN_STEPS)
    state, hist = train_loop(
        model, tcfg, LoopConfig(total_steps=TRAIN_STEPS, log_every=5,
                                **TRAIN),
        make_train_step(model, tcfg),
        state=init_train_state(clone(base), tcfg),
        log=lambda m: log(f"    {m}"))
    out["adamw"] = step_numbers(hist, n_params, tokens)
    if cuda:
        out["adamw"]["peak_memory_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["adamw"]["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  loss curve: {', '.join(f'{x:.3f}' for x in losses)}")
    check(last < first, f"phase 3t (a): the loss did not fall (first 5 "
          f"{first:.4f}, last 5 {last:.4f})")
    if cuda:
        out["adamw"]["profile"] = profile_train_step(
            torch, model, tcfg, state,
            make_batch_for(cfg, TRAIN_STEPS, device=dev, **TRAIN),
            os.path.join(ROOT, "chiprun_out"))
    ft = state["params"]
    del state

    log(f"  (b) Adafactor, {RESTART_STEPS} steps, checkpoints every 5, "
        "failures at steps 7 and 13")
    fcfg = TrainConfig(optimizer="adafactor", peak_lr=1e-3, warmup_steps=3,
                       total_steps=RESTART_STEPS)
    fstep = make_train_step(model, fcfg)
    kw = dict(total_steps=RESTART_STEPS, ckpt_every=5, log_every=1000,
              **TRAIN)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sa, ha = train_loop(model, fcfg, LoopConfig(**kw), fstep,
                        state=init_train_state(clone(base), fcfg), log=quiet)
    out["adafactor"] = step_numbers(ha, n_params, tokens)
    if cuda:
        out["adafactor"]["peak_memory_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    msgs: list = []
    sb, hb = train_loop(model, fcfg, LoopConfig(
        ckpt_dir=os.path.join(tmp, "restart"), **kw), fstep,
        injector=FailureInjector(fail_at_steps=(7, 13)),
        state=init_train_state(clone(base), fcfg), log=msgs.append)
    check(sum("restored to step" in m for m in msgs) == 2,
          f"phase 3t (b): expected two restores, the loop logged {msgs}")
    n_leaves = 0
    for (path, a), (_, b) in zip(tree_util.flatten_with_paths(sa),
                                 tree_util.flatten_with_paths(sb)):
        check(torch.equal(a, b), f"phase 3t (b): {path} of the restarted "
              "run differs from the uninterrupted run's")
        n_leaves += 1
    log(f"  restarted run ({len(hb)} steps run, 2 restores) bitwise the "
        f"uninterrupted run over {n_leaves} leaves")
    timed = os.path.join(tmp, "timed")
    sync(torch, dev)
    t0 = time.monotonic()
    saved = ckpt.save(sb, timed, RESTART_STEPS)
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    back = ckpt.restore(sb, timed, device=dev)
    sync(torch, dev)
    restore_s = time.monotonic() - t0
    for (path, a), (_, b) in zip(tree_util.flatten_with_paths(sb),
                                 tree_util.flatten_with_paths(back)):
        check(torch.equal(a, b), f"phase 3t (b): {path} restored otherwise")
    out["checkpoint"] = {
        "save_s": save_s, "restore_s": restore_s,
        "bytes": sum(os.path.getsize(os.path.join(saved, f))
                     for f in os.listdir(saved)),
        "restarted_steps_run": len(hb)}
    del sa, sb, back

    log("  (c) compress the trained tau, serve it beside e0-e3")
    sync(torch, dev)
    t0 = time.monotonic()
    ex = api.compress(base, ft, name="trained", density=0.1, device=dev)
    ex.as_(PACKED)
    sync(torch, dev)
    out["compress_s"] = time.monotonic() - t0
    out["planes"] = planes_check(torch, ex)
    recon = tree_util.tree_map(lambda b, t: (b.float() + t).to(b.dtype),
                               base, ex.to_dense_tau())
    ev = {"base": eval_loss(model, base, cfg, TRAIN["task_id"]),
          "fine-tuned": eval_loss(model, ft, cfg, TRAIN["task_id"]),
          "ComPEFT reconstructed": eval_loss(model, recon, cfg,
                                             TRAIN["task_id"])}
    del recon
    out["eval_loss_full"] = ev
    log("  held-out eval_loss on task 1: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ev.items()))
    check(ev["fine-tuned"] < ev["base"], f"phase 3t (c): the fine-tune's "
          f"eval_loss {ev['fine-tuned']:.4f} is not below the base's "
          f"{ev['base']:.4f}")
    ex.drop(DENSE)

    log(f"  (e) gradient compression over the fine-tune's gradients "
        f"(exact threshold, density {GRAD_DENSITY})")
    batch = make_batch_for(cfg, TRAIN_STEPS, device=dev, **TRAIN)
    with deterministic(dev):
        _, grads = value_and_grad(
            lambda p, b: model.loss_and_logits(p, b)[0], ft, batch)
    del ft
    gcfg = gc.GradCompressionConfig(density=GRAD_DENSITY,
                                    exact_threshold=True)
    dens, gauss, sizes = {}, {}, {}
    sync(torch, dev)
    t0 = time.monotonic()
    for path, g in tree_util.flatten_with_paths(grads):
        err0 = torch.zeros(g.shape, dtype=torch.float32, device=dev)
        pos, neg, scale, err = gc.compress_leaf_for_allgather(g, err0, gcfg)
        d = float(popcount(pos).sum() + popcount(neg).sum()) / g.numel()
        # one element of a leaf under 1000 is more than 0.1 point
        check(g.numel() < 1000 or abs(d - GRAD_DENSITY) <= 0.005,
              f"phase 3t (e): {path}: plane density {d:.5f}, want "
              f"{GRAD_DENSITY} +- 0.005")
        signs = gc._unpack_planes(pos, neg, g.shape[-1])
        check(torch.equal(err, (g.float() + err0) - signs * scale),
              f"phase 3t (e): {path}: error feedback is not g - s * signs")
        dens[path], sizes[path] = d, g.numel()
        g32 = g.float()
        thr = gc.gaussian_topk_threshold(g32, GRAD_DENSITY)
        gauss[path] = float((g32.abs() >= thr).float().mean())
        del pos, neg, err, signs, g32
    sync(torch, dev)
    out["grad_compression"] = {
        "seconds": time.monotonic() - t0, "density_exact": dens,
        "density_gaussian": gauss,
        "worst_exact_pp": 100 * max(
            abs(d - GRAD_DENSITY) for p, d in dens.items()
            if sizes[p] >= 1000), "sizes": sizes}
    del grads
    log(f"  {len(dens)} leaves: plane density (leaves of 1000 or more) "
        f"within {out['grad_compression']['worst_exact_pp']:.3f} points of "
        f"{GRAD_DENSITY}; error feedback bitwise; the Gaussian threshold "
        f"keeps {min(gauss.values()):.4f}-{max(gauss.values()):.4f}")
    if cuda:
        torch.cuda.empty_cache()

    treg = api.registry(device=dev, device_cache_bytes=16 << 30,
                        experts=[*experts, ex])
    engine = api.serve(model, base, treg, max_batch=4, cache_len=128,
                       decode_chunk=8, continuous=False)
    treqs = [dataclasses.replace(r, expert="trained" if r.expert == "e1"
                                 else r.expert)
             for r in fresh(reqs, 5000)]
    engine.run(treqs)
    for r in treqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"phase 3t request {r.uid}: bad tokens {r.out_tokens}")
    for w in (treqs[:4], treqs[4:]):
        row_independence_check(torch, engine, w)
    log("  every row's tokens bitwise unchanged when the other rows of its "
        "wave carry BASE")
    out["solo"] = solo_check(torch, engine, treqs)
    timed_reqs = fresh(treqs, 200)
    n0 = len(engine.wave_log)
    sync(torch, dev)
    engine.run(timed_reqs)
    check([r.out_tokens for r in timed_reqs] == [r.out_tokens
                                                 for r in treqs],
          "phase 3t: a second run of the same requests gave other tokens")
    waves = engine.wave_log[n0:]
    out["decode_tokens_per_s"] = (
        sum(w["tokens"] - w["rows"] for w in waves)
        / sum(w["seconds"] - w["prefill_s"] for w in waves))
    del engine, treg

    log(f"  (d) LoRA rank 8, {LORA_STEPS} SGD steps (lr {LORA_LR}) on task "
        f"{TRAIN['task_id']}")
    lcfg = LoraConfig(rank=8, alpha=16.0)
    lora0 = init_lora(torch.Generator(device=dev).manual_seed(seed + 11),
                      base, lcfg)

    def lora_loss(lp, b):
        return model.loss_and_logits(apply_lora(base, lp, lcfg), b)[0]

    lora, lora_losses = lora0, []
    sync(torch, dev)
    t0 = time.monotonic()
    for s in range(LORA_STEPS):
        b = make_batch_for(cfg, s, device=dev, **TRAIN)
        loss, g = value_and_grad(lora_loss, lora, b)
        lora = tree_util.tree_map(lambda p, gg: p - LORA_LR * gg, lora, g)
        lora_losses.append(float(loss))
    lora_s = (time.monotonic() - t0) / LORA_STEPS
    log(f"  LoRA loss curve: {', '.join(f'{x:.3f}' for x in lora_losses)}")
    lex = api.compress(lora0, lora, name="trained-lora", kind="lora",
                       density=0.1, device=dev)
    tau_hat = dict(tree_util.flatten_with_paths(lex.to_dense_tau()))
    lora_hat = tree_util.unflatten_like(lora0, [
        (l.float() + tau_hat[p]).to(l.dtype)
        for p, l in tree_util.flatten_with_paths(lora0)])
    lev = {name: eval_loss(model, apply_lora(base, lp, lcfg), cfg,
                           TRAIN["task_id"])
           for name, lp in (("base", lora0), ("fine-tuned", lora),
                            ("ComPEFT reconstructed", lora_hat))}
    log("  LoRA held-out eval_loss: " + ", ".join(
        f"{k} {v:.4f}" for k, v in lev.items()))
    out["lora"] = {"losses": lora_losses, "eval_loss": lev,
                   "step_ms": lora_s * 1e3,
                   "n_adapters": len(lora0),
                   "packed_bytes": lex.nbytes(PACKED)}
    del lora0, lora, lora_hat, lex, tau_hat
    if cuda:
        torch.cuda.empty_cache()
    return out


LONG_PROMPT = 32768       # 3l: one prompt of the reference's prefill_32k
LONG_NEW = 16             # its new tokens
LONG_CHUNKS = (512, 2048)  # (b): the model's chunk, and a coarser one
WHOLE_T = 4096            # (c): the reference's train_4k length


def long_request(torch, cfg, seed):
    """One greedy request on e0: a LONG_PROMPT-token prompt from
    ``seed``."""
    from repro_torch.serve import Request
    g = torch.Generator().manual_seed(seed + 29)
    prompt = torch.randint(2, cfg.vocab, (LONG_PROMPT,), generator=g)
    return Request(uid=0, expert="e0", prompt=prompt,
                   max_new_tokens=LONG_NEW)


def tile_steps(T: int, S: int, causal: bool = True,
               chunk: int = 0) -> int:
    """Tile steps of one attention call over [T, S] at the model's
    chunks (or ``chunk``): the schedule's length."""
    from repro_torch.models import attention
    cq, ck = chunk or attention.CHUNK_Q, chunk or attention.CHUNK_K
    return len(attention._chunk_pairs(-(-T // min(cq, T)),
                                      -(-S // min(ck, S)),
                                      causal and T == S, None))


@contextlib.contextmanager
def attention_chunks(chunk: int):
    """The model's attention chunks set to ``chunk`` for a block."""
    from repro_torch.models import attention
    saved = attention.CHUNK_Q, attention.CHUNK_K
    attention.CHUNK_Q = attention.CHUNK_K = chunk
    try:
        yield
    finally:
        attention.CHUNK_Q, attention.CHUNK_K = saved


def gpu_mem_above(torch, before: int) -> int:
    """Peak device bytes since the last reset, above ``before``."""
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def mem_mark(torch) -> int:
    """Free the dropped, reset the peak, and return the bytes held."""
    free_all(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def long_phase(torch, api, model, base, reg, cfg, seed, dev):
    """Phase 3l as a path: every launch count set to 0 just before the
    served long request and read just after; kernel 1 must launch.  The
    checks of (b) and (c) run after the counts are read."""
    from repro_torch.kernels import ops
    log(f"phase 3l: long sequences ({LONG_PROMPT}-token prompt served on "
        f"e0, chunks {LONG_CHUNKS[0]} against {LONG_CHUNKS[1]}, chunked "
        f"against whole at {WHOLE_T})")
    t0 = time.monotonic()
    before = mem_mark(torch)
    ops.reset_launch_counts()
    out, engine, req = long_serve(torch, api, model, base, reg, cfg, seed,
                                  before)
    launches = ops.launch_counts()
    log(f"  launches on the long-prompt path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    check(launches["ternary_matmul_grouped"] > 0,
          "ternary_matmul_grouped was not launched on the long-prompt path")
    out["chunks"] = long_chunk_check(torch, model, base, engine, req)
    del engine
    out["whole"] = whole_check(torch, model, base, cfg, seed, dev)
    out["phase_s"] = time.monotonic() - t0
    log(f"  phase 3l took {out['phase_s']:.1f} s")
    return out, launches


def long_serve(torch, api, model, base, reg, cfg, seed, before):
    """(a) The long request through ``api.serve`` (``max_batch=1``,
    ``cache_len`` prompt + new tokens, ``decode_chunk=8``): 16 tokens in
    the vocabulary; the peak device memory above what was held before,
    including the engine's cache and its graph capture, below a quarter
    of the whole-matrix scores' bytes, B Hq T S 4 / 4; a warm run
    repeating the tokens, its prefill ms and decode tokens/s."""
    a = cfg.pattern[0].attn
    T = LONG_PROMPT
    scores = 1 * a.n_q * T * T * 4
    engine = api.serve(model, base, reg, max_batch=1, cache_len=T + LONG_NEW,
                       decode_chunk=8, continuous=False)
    req = long_request(torch, cfg, seed)
    t0 = time.monotonic()
    engine.run([req])
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    peak = gpu_mem_above(torch, before)
    check(len(req.out_tokens) == LONG_NEW
          and all(0 <= t < cfg.vocab for t in req.out_tokens),
          f"long request: bad tokens {req.out_tokens}")
    check(peak < scores / 4,
          f"long request: peak memory {peak} bytes above the phase's start,"
          f" not below a quarter of the whole-matrix scores ({scores} / 4)")
    warm = fresh([req], 100)
    n0 = len(engine.wave_log)
    engine.run(warm)
    torch.cuda.synchronize()
    check(warm[0].out_tokens == req.out_tokens,
          "a warm run of the long request gave other tokens")
    w = engine.wave_log[n0]
    out = {"prompt": T, "cache_len": T + LONG_NEW, "cold_serve_s": cold_s,
           "prefill_ms": w["prefill_s"] * 1e3,
           "cold_prefill_ms": engine.wave_log[n0 - 1]["prefill_s"] * 1e3,
           "decode_tokens_per_s": (w["tokens"] - w["rows"])
           / (w["seconds"] - w["prefill_s"]),
           "peak_above_start_bytes": peak, "score_bytes": scores,
           "gate_bytes": scores / 4,
           "tile_steps_per_layer": tile_steps(T, T),
           "attention_layers": cfg.n_units * len(cfg.pattern),
           "tokens": list(req.out_tokens)}
    log(f"  (a) {T}-token prompt served: prefill {out['prefill_ms']:.1f} ms "
        f"warm ({out['cold_prefill_ms']:.1f} cold), decode "
        f"{out['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{peak / 2 ** 30:.2f} GiB above the phase's start (gate "
        f"{scores / 4 / 2 ** 30:.2f} GiB; the whole score matrix "
        f"{scores / 2 ** 30:.2f} GiB); {out['tile_steps_per_layer']} tile "
        f"steps a layer, {out['attention_layers']} layers")
    return out, engine, req


def long_chunk_check(torch, model, base, engine, req):
    """(b) The long prompt's prefill with the engine's overlay of e0 and
    its row mask, at the model's chunks and at coarser ones.  In bf16 the
    engine's first token is the greedy choice of the model's chunks (the
    same arithmetic); the two chunkings' last-token logits are reported
    (every activation is rounded to bf16, so they part by bf16 ulps).  On
    an f32 copy they agree within 1e-4 of the largest |logit| (the f32
    logits tolerance of phase 3e)."""
    ov = engine._overlay_for(("e0",))
    eid = torch.as_tensor([engine.slot_of("e0")], dtype=torch.int32,
                          device=engine.dev)
    toks, start = engine._pad_prompts([req])
    model32, base32 = f32_copy(torch, model, base)
    runs, logits = {}, {}
    for dtype, mdl, params in (("bf16", model, base),
                               ("f32", model32, base32)):
        for chunk in LONG_CHUNKS:
            with attention_chunks(chunk):
                before = mem_mark(torch)
                t0 = time.monotonic()
                lg, _ = mdl.prefill(params, {"tokens": toks},
                                    LONG_PROMPT + 1, delta=ov, eid=eid,
                                    start=start)
                logits[dtype, chunk] = lg[0, -1].float()
                del lg
                peak = gpu_mem_above(torch, before)
                runs[f"{dtype}_{chunk}"] = {
                    "prefill_s": time.monotonic() - t0,
                    "peak_above_start_bytes": peak,
                    "tile_steps_per_layer": tile_steps(
                        LONG_PROMPT, LONG_PROMPT, chunk=chunk)}
    del model32, base32
    free_all(torch)
    errs = {}
    for dtype in ("bf16", "f32"):
        a, b = (logits[dtype, c] for c in LONG_CHUNKS)
        check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
              f"long prefill ({dtype}): non-finite logits")
        errs[dtype] = (float((a - b).abs().max()),
                       1e-4 * float(torch.maximum(a.abs(), b.abs()).max()))
    err, tol = errs["f32"]
    out = {"runs": runs, "max_abs_err": err, "tol": tol,
           "bf16_max_abs_err": errs["bf16"][0]}
    check(err <= tol, f"long prefill (f32 copy): logits at chunks "
          f"{LONG_CHUNKS} differ by {err} (tol {tol})")
    first = int(logits["bf16", LONG_CHUNKS[0]].argmax())
    check(first == req.out_tokens[0],
          f"long prefill: greedy token {first} of the direct prefill, the "
          f"engine's first token {req.out_tokens[0]}")
    log(f"  (b) chunks {LONG_CHUNKS[0]} / {LONG_CHUNKS[1]}: prefill "
        + "; ".join(f"{k} {v['prefill_s']:.2f} s ("
                    f"{v['tile_steps_per_layer']} tiles a layer, peak "
                    f"{v['peak_above_start_bytes'] / 2 ** 30:.2f} GiB)"
                    for k, v in runs.items())
        + f"; last-token logits, f32 copy: max err {err:.3e} (tol "
        f"{tol:.3e}); bf16: max err {errs['bf16'][0]:.3e} (reported); the "
        "engine's first token is the bf16 greedy choice")
    return out


def whole_check(torch, model, base, cfg, seed, dev):
    """(c) At WHOLE_T tokens, chunked (the model's chunks) against one
    tile of the whole sequence (chunk WHOLE_T), f32: one attention call
    at the model's heads (output within 2e-5 of its largest |value|, dq,
    dk, dv of a seeded cotangent within 1e-4 of their largest), then one
    AdamW step of ``train_step`` on an f32 copy over one row of WHOLE_T
    tokens (loss and gradient norm within 1e-5 relative, each leaf's
    ``mu``, 0.1 times its clipped gradient, within 1e-4 of the leaf's
    largest); peak memory and seconds of both forms."""
    from repro_torch import tree as tree_util
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.models import attention
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    a = cfg.pattern[0].attn
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    q, w = (torch.randn((1, WHOLE_T, a.n_q, a.head_dim), generator=g,
                        device=dev) for _ in range(2))
    k, v = (torch.randn((1, WHOLE_T, a.n_kv, a.head_dim), generator=g,
                        device=dev) for _ in range(2))
    runs: dict = {}
    for chunk in (attention.CHUNK_Q, WHOLE_T):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        before = mem_mark(torch)
        t0 = time.monotonic()
        with torch.enable_grad():
            o = attention.flash_attention(qq, kk, vv, a, chunk_q=chunk,
                                          chunk_k=chunk)
            grads = torch.autograd.grad((o * w).sum(), (qq, kk, vv))
        runs[chunk] = {"out": o.detach(), "grads": grads,
                       "peak": gpu_mem_above(torch, before),
                       "s": time.monotonic() - t0}
        del qq, kk, vv, o
    c, x = runs[attention.CHUNK_Q], runs[WHOLE_T]
    errs = {"out": float((c["out"] - x["out"]).abs().max())}
    tols = {"out": 2e-5 * float(x["out"].abs().max())}
    for n, gc_, gx in zip("qkv", c["grads"], x["grads"]):
        errs[f"d{n}"] = float((gc_ - gx).abs().max())
        tols[f"d{n}"] = 1e-4 * float(gx.abs().max())
    for n in errs:
        check(errs[n] <= tols[n], f"attention at {WHOLE_T}: {n} chunked "
              f"against whole differs by {errs[n]} (tol {tols[n]})")
    out = {"attention": {
        "max_abs_err": errs, "tol": tols,
        "peak_bytes": {"chunked": c["peak"], "whole": x["peak"]},
        "seconds": {"chunked": c["s"], "whole": x["s"]},
        "tile_steps": {"chunked": tile_steps(WHOLE_T, WHOLE_T),
                       "whole": 1}}}
    del runs, c, x, q, k, v, w
    log(f"  (c) one attention call at {WHOLE_T} (fwd + bwd, f32): chunked "
        f"against whole max err " + ", ".join(
            f"{n} {e:.3e} (tol {tols[n]:.3e})" for n, e in errs.items())
        + "; peak {:.1f} MiB chunked, {:.1f} MiB whole".format(
            *(out["attention"]["peak_bytes"][f] / 2 ** 20
              for f in ("chunked", "whole"))))

    model32, base32 = f32_copy(torch, model, base)
    batch = make_batch_for(cfg, 0, seq_len=WHOLE_T, global_batch=1,
                           task_id=1, device=dev)
    tcfg = TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=3,
                       total_steps=10)
    step = make_train_step(model32, tcfg)
    steps: dict = {}
    # the first step pays one-time setup (cuBLAS handles, the allocator's
    # growth): a chunked step first, untimed
    for chunk in (attention.CHUNK_Q, attention.CHUNK_Q, WHOLE_T):
        with attention_chunks(chunk):
            state = init_train_state(
                tree_util.tree_map(lambda t: t.clone(), base32), tcfg)
            before = mem_mark(torch)
            t0 = time.monotonic()
            new, metrics = step(state, batch)
            torch.cuda.synchronize()
            steps[chunk] = {"s": time.monotonic() - t0,
                            "peak": gpu_mem_above(torch, before),
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "mu": new["opt"]["mu"]}
            del state, new
    c, x = steps[attention.CHUNK_Q], steps[WHOLE_T]
    mu_err = 0.0
    for mc, mx in zip(tree_util.leaves(c["mu"]), tree_util.leaves(x["mu"])):
        scale = float(mx.abs().max()) or 1.0
        mu_err = max(mu_err, float((mc - mx).abs().max()) / scale)
    loss_rel = abs(c["loss"] - x["loss"]) / abs(x["loss"])
    norm_rel = abs(c["grad_norm"] - x["grad_norm"]) / x["grad_norm"]
    check(loss_rel <= 1e-5, f"train step at {WHOLE_T}: loss {c['loss']} "
          f"chunked against {x['loss']} whole")
    check(norm_rel <= 1e-5, f"train step at {WHOLE_T}: gradient norm "
          f"{c['grad_norm']} chunked against {x['grad_norm']} whole")
    check(mu_err <= 1e-4, f"train step at {WHOLE_T}: a leaf's mu differs "
          f"by {mu_err} of its largest")
    out["train_step"] = {
        "loss": {"chunked": c["loss"], "whole": x["loss"]},
        "loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
        "mu_rel_err": mu_err,
        "peak_bytes": {"chunked": c["peak"], "whole": x["peak"]},
        "seconds": {"chunked": c["s"], "whole": x["s"]}}
    del steps, c, x, model32, base32
    free_all(torch)
    ts = out["train_step"]
    log(f"  (c) one AdamW step at 1 x {WHOLE_T} (f32 copy): loss "
        f"{ts['loss']['chunked']:.6f} chunked, {ts['loss']['whole']:.6f} "
        f"whole (rel {loss_rel:.2e}); grad norm rel {norm_rel:.2e}; mu "
        f"within {mu_err:.2e} of each leaf's largest; peak "
        f"{ts['peak_bytes']['chunked'] / 2 ** 30:.2f} / "
        f"{ts['peak_bytes']['whole'] / 2 ** 30:.2f} GiB, "
        f"{ts['seconds']['chunked']:.2f} / {ts['seconds']['whole']:.2f} s")
    return out


def attention_step_ms(torch, cfg):
    """Device ms of one decode step's attention, every layer, by CUDA
    graph: the paged write, gather attention and normalisation against
    the dense ring's write and attention, at phase 3p's shapes (4 rows,
    256 positions: 16 blocks of 16 per row out of 65, per-row positions
    of 20-120)."""
    from repro_torch.models.attention import (cache_write, decode_attention,
                                              finalize_partial,
                                              paged_attention_partial,
                                              paged_cache_write)
    dev = torch.device("cuda")
    a = cfg.pattern[0].attn
    B, BS, NB, S = 4, 16, 65, 256
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    q, kn, vn = rnd(B, 1, a.n_q, a.head_dim), rnd(B, 1, a.n_kv,
                                                 a.head_dim), rnd(
        B, 1, a.n_kv, a.head_dim)
    kp, vp = rnd(NB, BS, a.n_kv, a.head_dim), rnd(NB, BS, a.n_kv,
                                                 a.head_dim)
    tables = (torch.arange(B * 16, device=dev, dtype=torch.int32)
              .reshape(B, 16) + 1)
    lens = torch.tensor([100, 40, 20, 120], dtype=torch.int32, device=dev)
    start = torch.tensor([4, 8, 0, 2], dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    kc, vc = rnd(B, S, a.n_kv, a.head_dim), rnd(B, S, a.n_kv, a.head_dim)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    cur = torch.tensor(120, dtype=torch.int32, device=dev)

    def paged():
        paged_cache_write(kp, vp, tables, lens, active, kn, vn)
        o, m, l = paged_attention_partial(q, kp, vp, tables, lens, start, a)
        return finalize_partial(o, m, l)[:, None].to(q.dtype)

    def dense():
        cache_write(kc, vc, pos, kn, vn, cur)
        return decode_attention(q, kc, vc, pos, cur, a,
                                start=start).to(q.dtype)

    layers = cfg.n_units * len(cfg.pattern)
    return {"paged": graph_ms(torch, paged) * layers,
            "dense": graph_ms(torch, dense) * layers, "layers": layers}


# ---------------------------------------------------------------------------
# phase 3m: the serving mesh and the multi-pod train step, one process a rank
# ---------------------------------------------------------------------------

MESH_TRAFFIC = {
    # phase 3's waves: continuous=False, so the mesh runs are comparable
    "p3": dict(max_batch=4, cache_len=128, decode_chunk=8, continuous=False),
    # phase 3d's refill traffic
    "refill": dict(max_batch=4, cache_len=256, decode_chunk=8),
    # phase 3's requests paged, chunks of 4 (a crash at chunk 2 leaves
    # rows of the snapshotted wave unfinished)
    "paged": dict(max_batch=4, cache_len=128, decode_chunk=4,
                  kv_layout="paged", kv_block_size=16),
}
MESH_SAMPLED = dict(temperature=0.8, top_k=40)
MESH_KILL_AT = 2
MESH_TRAIN = dict(seq_len=64, global_batch=4, task_id=1)
MESH_TRAIN_STEPS = 3


class MeshCrash(Exception):
    pass


def traffic_rows(reqs) -> list:
    return [[r.uid, r.expert, [int(t) for t in
                               torch_list(r.prompt)], r.max_new_tokens]
            for r in reqs]


def torch_list(t) -> list:
    return t.reshape(-1).tolist() if hasattr(t, "reshape") else list(t)


def mesh_setup(torch, experts, traffic: dict, tmp) -> str:
    """What every rank loads: the experts' packed planes (host copies)
    and the traffic (uids, experts, prompts, budgets)."""
    d = os.path.join(tmp, "mesh_setup")
    os.makedirs(d)
    torch.save({ex.name: {"kind": ex.kind, "density": ex.density,
                          "alpha": ex.alpha,
                          "packed": {p: dataclasses.replace(
                              pt, pos=pt.pos.cpu(), neg=pt.neg.cpu(),
                              scale=pt.scale.cpu())
                              for p, pt in ex.packed.items()}}
                for ex in experts}, os.path.join(d, "experts.pt"))
    with open(os.path.join(d, "traffic.json"), "w") as f:
        json.dump(traffic, f)
    return d


def tree_digest(torch, tree) -> dict:
    """{path: sha256 of the leaf's bytes}: bitwise equality of two trees
    held in different processes.  The leaves hash in threads (hashlib
    lets go of the GIL on large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import tree as tree_util

    def digest(t):
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        return hashlib.sha256(raw.numpy()).hexdigest()

    paths, leaves = zip(*tree_util.flatten_with_paths(tree))
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(paths, pool.map(digest, leaves)))


def collectives_of(prof) -> dict:
    """The collectives' self device and host time in a profile (NCCL
    kernels, or the c10d ops around gloo's host exchange: all-reduces,
    all-gathers and the all-to-alls of the ordered reduce-scatters), and
    calls."""
    keys = ("allreduce", "all_reduce", "allgather", "all_gather",
            "alltoall", "all_to_all", "nccl")
    dev_us = cpu_us = calls = 0.0
    for e in prof.key_averages():
        if any(k in e.key.lower() for k in keys):
            dev_us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
            cpu_us += e.self_cpu_time_total
            calls += e.count
    return {"device_ms": dev_us / 1e3, "host_ms": cpu_us / 1e3,
            "calls": int(calls)}


def mesh_serve_case(torch, api, model, base, experts, traffic, case, mesh,
                    dev, rank) -> dict:
    """One engine of a rank over one case's traffic: its tokens, launch
    counts and gauges; ``timed`` adds a warm run (decode tokens/s) and a
    profiled one (the collectives' ms per decode step)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request
    m, b = f32_copy(torch, model, base) if case.get("f32") else (model,
                                                                 base)
    kw = dict(MESH_TRAFFIC[case["traffic"]], **case.get("engine", {}))
    if case.get("snapshot_dir"):
        kw.update(snapshot_dir=case["snapshot_dir"], snapshot_every_chunks=1)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts, mesh=mesh)
    eng = api.serve(m, b, reg, mesh=mesh, **kw)

    def requests(uid0=0):
        return [Request(uid=uid0 + u, expert=e, prompt=torch.as_tensor(p),
                        max_new_tokens=n)
                for u, e, p, n in traffic[case["traffic"]]]
    out = {"name": case["name"], "rank": rank}
    ops.reset_launch_counts()
    if case.get("op") == "crash":
        def hook(i):
            if i == MESH_KILL_AT:
                raise MeshCrash(f"injected crash at chunk {i}")
        eng.chunk_hooks.append(hook)
        try:
            eng.run(requests())
        except MeshCrash:
            out["crashed"] = True
        check(out.get("crashed", False), f"{case['name']}: no crash came")
        done = []
    elif case.get("op") == "resume":
        done = eng.resume()
        out["continued"] = [u for w in eng.wave_log if w.get("resumed")
                            for u in w["uids"]]
        out["plan"] = dataclasses.asdict(eng.recovery_stats["plan"])
    else:
        done = eng.run(requests())
    torch.cuda.synchronize(dev)
    out["launches"] = ops.launch_counts()
    out["tokens"] = {str(r.uid): [int(t) for t in r.out_tokens]
                     for r in done}
    out["status"] = sorted({r.status for r in done})
    s = eng.swap_summary()
    out["summary"] = {k: s.get(k) for k in (
        "graph_captures", "graph_replays", "kv", "mesh", "shards",
        "n_expert_shards", "admitted")}
    if case.get("timed"):
        w0 = len(eng.wave_log)
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        eng.run(requests(10000))
        torch.cuda.synchronize(dev)
        waves = eng.wave_log[w0:]
        out["warm_s"] = time.monotonic() - t0
        out["decode_tokens_per_s"] = (
            sum(w["tokens"] - w["rows"] for w in waves)
            / sum(w["seconds"] - w["prefill_s"] for w in waves))
        from torch.profiler import ProfilerActivity, profile
        w0 = len(eng.wave_log)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(requests(20000))
            torch.cuda.synchronize(dev)
        steps = sum((w["tokens"] - w["rows"]) / w["rows"]
                    for w in eng.wave_log[w0:])
        c = collectives_of(prof)
        out["collectives"] = dict(
            c, decode_steps=steps,
            device_ms_per_step=c["device_ms"] / max(steps, 1),
            host_ms_per_step=c["host_ms"] / max(steps, 1))
    eng.registry.close()
    del eng, reg, m, b
    free_all(torch)
    return out


def mesh_train_child(torch, spec, dev) -> dict:
    """The compressed multi-pod step, this rank one pod of a
    ("pod", "data", "model") = (world, 1, 1) mesh: digests of the
    parameters and the rank's error feedback after the steps, and the
    losses."""
    from repro_torch.configs import get_config
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=1)
    model = build_model(cfg)
    params = model.init(seed=spec["seed"], device=dev)
    tcfg = mesh_tcfg(TrainConfig, GradCompressionConfig)
    state = init_train_state(params, tcfg, multi_pod=True)
    step = make_train_step(model, tcfg, mesh=make_production_mesh(
        multi_pod=True, device="cuda"))
    torch.set_grad_enabled(True)
    losses, secs = [], []
    for s in range(MESH_TRAIN_STEPS):
        batch = make_batch_for(cfg, s, device=dev, **MESH_TRAIN)
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        secs.append(time.monotonic() - t0)
    return {"params": tree_digest(torch, state["params"]),
            "ef": tree_digest(torch, state["ef"]), "losses": losses,
            "step_s": secs}


def mesh_tcfg(TrainConfig, GradCompressionConfig):
    return TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=3,
                       total_steps=20, grad_compression=GradCompressionConfig(
                           enabled=True, density=0.05))


def load_experts(torch, setup: str, dev) -> list:
    """The experts :func:`mesh_setup` handed over, on ``dev``."""
    from repro_torch import tree as tree_util
    from repro_torch.expert import Expert
    saved = torch.load(os.path.join(setup, "experts.pt"),
                       weights_only=False)
    return [Expert.from_packed(
        name, e["kind"], tree_util.unflatten_paths({
            p: dataclasses.replace(pt, pos=pt.pos.to(dev),
                                   neg=pt.neg.to(dev),
                                   scale=pt.scale.to(dev))
            for p, pt in e["packed"].items()}),
        density=e["density"], alpha=e["alpha"])
        for name, e in saved.items()]


def mesh_child(spec_path: str) -> int:
    """One rank of a phase 3m run (``--mesh-child SPEC``): joins the
    world, builds the mesh, serves its cases (or runs the multi-pod
    step) and writes its results beside the spec."""
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import build as build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", spec["device_index"])
    torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], init_method=f"tcp://127.0.0.1:{spec['port']}",
        rank=spec["rank"], world_size=spec["world"])
    try:
        if spec["op"] == "train":
            res = mesh_train_child(torch, spec, dev)
        elif spec["op"] == "within":
            res = within_child(torch, spec, dev,
                               load_experts(torch, spec["setup"], dev))
        else:
            mesh = make_serve_mesh(tuple(spec["shape"]), device="cuda")
            cfg = dataclasses.replace(get_config("qwen2_5_3b"),
                                      n_units=spec["units"])
            model = build_model(cfg)
            base = model.init(seed=spec["seed"], device=dev)
            experts = load_experts(torch, spec["setup"], dev)
            with open(os.path.join(spec["setup"], "traffic.json")) as f:
                traffic = json.load(f)
            res = [mesh_serve_case(torch, api, model, base, experts,
                                   traffic, case, mesh, dev, spec["rank"])
                   for case in spec["cases"]]
        with open(spec["out"], "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(torch, spec: dict, world: int, backend: str, devices: list,
              tmp, what: str, timeout: int = 600) -> list:
    """Start ``world`` ranks of ``spec`` (``chip_smoke.py --mesh-child``),
    rank r on card ``devices[r]``, and wait for all: a rank that fails
    fails the run.  Returns every rank's results, in rank order."""
    return wait_ranks(start_ranks(spec, world, backend, devices, tmp, what,
                                  timeout))


# every rank process started: a run that fails while some still run
# stops them on its way out (``stop_ranks``)
_RANKS: list = []


def stop_ranks() -> None:
    _RANKS.append(None)         # no rank starts after this
    for k in [k for k in _RANKS if k is not None]:
        if k.poll() is None:
            k.kill()
            k.wait()


def start_ranks(spec: dict, world: int, backend: str, devices: list, tmp,
                what: str, timeout: int = 600) -> dict:
    """Start the ranks of :func:`run_ranks` and return at once; the
    handle goes to :func:`wait_ranks`."""
    import socket
    import threading
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if spec["op"] == "within":
        # four ranks and this process share the card: less reserve
        env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    kids, outs = [], []
    for r in range(world):
        check(None not in _RANKS, f"{what}: the run is stopping")
        path = os.path.join(tmp, f"{what}_rank{r}.json")
        outs.append(path + ".out")
        with open(path, "w") as f:
            json.dump(dict(spec, rank=r, world=world, port=port,
                           backend=backend, device_index=devices[r],
                           out=outs[-1]), f)
        # output to a file, not a pipe: no rank waits on a full pipe
        # while this process is busy elsewhere
        with open(path + ".log", "w") as f:
            kids.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-child",
                 path], env=env, stdout=f, stderr=subprocess.STDOUT))
        _RANKS.append(kids[-1])
    h = {"kids": kids, "outs": outs, "what": what, "world": world,
         "timeout": timeout, "t0": time.monotonic()}

    def watch():            # when the last rank ended, for the log
        for k in kids:
            k.wait()
        h["t_end"] = time.monotonic()
    threading.Thread(target=watch, daemon=True).start()
    return h


def wait_ranks(h: dict) -> list:
    """Wait for every rank :func:`start_ranks` started (killing them all
    if one is not done in time); a rank that fails fails the run.
    Returns every rank's results, in rank order."""
    kids = h["kids"]
    try:
        for k in kids:
            k.wait(timeout=h["timeout"])
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
                k.wait()
    failed = []
    for r, (k, o) in enumerate(zip(kids, h["outs"])):
        if k.returncode != 0:
            with open(o[:-len(".out")] + ".log") as f:
                failed.append(f"rank {r} ended with {k.returncode}: "
                              f"{f.read()[-3000:]}")
    check(not failed, f"phase 3m {h['what']}: " + "\n".join(failed))
    log(f"  {h['what']}: {h['world']} rank(s) done "
        f"{h.get('t_end', time.monotonic()) - h['t0']:.1f} s after their "
        "start")
    res = []
    for o in h["outs"]:
        with open(o) as f:
            res.append(json.load(f))
    return res


def multipod_oracle(torch, seed, n_pods, dev) -> dict:
    """The multi-pod step's one-process version
    (``train_step.pods_in_one_process``) over the same steps; digests and
    losses as :func:`mesh_train_child` gives them."""
    from repro_torch.configs import get_config
    from repro_torch.core import gradient_compression as gc
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.models import build as build_model
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=1)
    model = build_model(cfg)
    tcfg = mesh_tcfg(TrainConfig, gc.GradCompressionConfig)
    state = init_train_state(model.init(seed=seed, device=dev), tcfg,
                             multi_pod=True)
    efs = [state["ef"]] * n_pods
    losses = []
    with torch.enable_grad():
        for s in range(MESH_TRAIN_STEPS):
            batch = make_batch_for(cfg, s, device=dev, **MESH_TRAIN)
            state, efs, loss, _ = ts.pods_in_one_process(model, tcfg, state,
                                                         efs, batch)
            losses.append(float(loss))
    out = {"params": tree_digest(torch, state["params"]),
           "ef": [tree_digest(torch, e) for e in efs], "losses": losses}
    del state, efs
    free_all(torch)
    return out


def mesh_start(torch, experts, reqs, rreqs, seed, units, tmp) -> dict:
    """Start phase 3m's ranks and return at once, so that this process
    runs phase 3c while they serve: (2, 1) beside (1, 2), then, from a
    thread, as soon as (2, 1) is done (its snapshot is what (1, 1)
    resumes), (1, 1) beside the two multi-pod steps.  Each rank is
    host-bound on one torch thread, and the card has room for them beside
    phase 3c up to its merges (:func:`mesh_wait`).  The handle goes to
    :func:`mesh_path`."""
    import threading
    traffic = {"p3": traffic_rows(reqs), "refill": traffic_rows(rreqs),
               "paged": traffic_rows(reqs)}
    setup = mesh_setup(torch, experts, traffic, tmp)
    spec = {"op": "serve", "setup": setup, "seed": seed, "units": units}
    snap = os.path.join(tmp, "mesh_snap")
    run = {"spec": spec, "tmp": tmp, "snap": snap, "t0": time.monotonic()}
    log("  (a) mesh (2, 1): two ranks on the card over gloo, eager chunks; "
        "(b) mesh (1, 2): two ranks on the card over gloo, vocab-parallel "
        "head, batch-sharded KV; both at once, beside phase 3c")
    run["h21"] = start_ranks(dict(spec, shape=[2, 1], cases=[
        {"name": "p3", "traffic": "p3", "timed": True},
        {"name": "p3s", "traffic": "p3", "engine": MESH_SAMPLED},
        {"name": "paged", "traffic": "paged"},
        {"name": "crash", "traffic": "paged", "op": "crash",
         "snapshot_dir": snap}]), 2, "gloo", [0, 0], tmp, "mesh21")
    run["h12"] = start_ranks(dict(spec, shape=[1, 2], cases=[
        {"name": "p3", "traffic": "p3", "timed": True},
        {"name": "p3_f32", "traffic": "p3", "f32": True}]), 2, "gloo",
        [0, 0], tmp, "mesh12")

    def second():
        try:
            run["res21"] = wait_ranks(run["h21"])
            log("  (c) mesh (1, 1) under NCCL: one rank, graphed chunks; the "
                "(2, 1) snapshot resumed; (e) the compressed multi-pod step: "
                f"1 NCCL pod, 2 gloo pods on the card ({MESH_TRAIN_STEPS} "
                f"AdamW steps of {MESH_TRAIN['global_batch']} x "
                f"{MESH_TRAIN['seq_len']} tokens, 1 unit); all three at once")
            run["h11"] = start_ranks(dict(spec, shape=[1, 1], cases=[
                {"name": "p3", "traffic": "p3", "timed": True},
                {"name": "refill", "traffic": "refill"},
                {"name": "paged", "traffic": "paged"},
                {"name": "resume", "traffic": "paged", "op": "resume",
                 "snapshot_dir": snap}]), 1, "nccl", [0], tmp, "mesh11")
            run["h_train"] = {
                pods: start_ranks({"op": "train", "seed": seed}, pods,
                                  backend, [0] * pods, tmp, f"train{pods}")
                for pods, backend in ((1, "nccl"), (2, "gloo"))}
        except BaseException as e:      # raised again by mesh_path
            run["error"] = e
    run["thread"] = threading.Thread(target=second, daemon=True)
    run["thread"].start()
    return run


def mesh_wait(run: dict) -> None:
    """Wait until every rank :func:`mesh_start` started has ended (their
    results are read by :func:`mesh_path`): phase 3c calls it before its
    merges, the largest allocation of this process (40 GB), which the
    card would not hold beside the ranks."""
    run["thread"].join()
    hs = [run[k] for k in ("h12", "h11") if k in run]
    for h in hs + list(run.get("h_train", {}).values()):
        for k in h["kids"]:
            k.wait(timeout=h["timeout"])


def mesh_path(torch, api, model, base, reg, engine, reqs, rreqs,
              run: dict) -> tuple[dict, dict]:
    """Phase 3m: the port's serving mesh at full width, one process a
    rank, the ranks started by :func:`mesh_start`: the mesh-free
    references, then every world's results against them.  Returns
    (report, kernel launches on the mesh runs: rank 0's, summed over the
    serving cases)."""
    from repro_torch.kernels import ops
    n_cards = torch.cuda.device_count()
    spec, tmp = run["spec"], run["tmp"]
    out: dict = {"cards": n_cards}

    # the mesh-free references beside phase 3's own tokens
    def mesh_free(traffic_name, f32=False, **kw):
        m, b = f32_copy(torch, model, base) if f32 else (model, base)
        e = api.serve(m, b, reg, **dict(MESH_TRAFFIC[traffic_name], **kw))
        rr = [dataclasses.replace(r, out_tokens=[], status="pending",
                                  t_admit_s=None, t_first_s=None,
                                  t_done_s=None) for r in
              (reqs if traffic_name != "refill" else rreqs)]
        e.run(rr)
        toks = {str(r.uid): [int(t) for t in r.out_tokens] for r in rr}
        del e, m, b
        free_all(torch)
        return toks
    want = {"p3": {str(r.uid): list(r.out_tokens) for r in reqs},
            "refill": {str(r.uid): list(r.out_tokens) for r in rreqs},
            "p3s": mesh_free("p3", **MESH_SAMPLED),
            "paged": mesh_free("paged"),
            "p3_f32": mesh_free("p3", f32=True)}
    launches = {k: 0 for k in ops.launch_counts()}

    def take(res, what):
        for case in res[0]:
            for k, n in case["launches"].items():
                launches[k] += n
        for r, per in enumerate(res[1:], 1):
            for a, b in zip(res[0], per):
                check(a["tokens"] == b["tokens"], f"phase 3m {what}: rank "
                      f"{r}'s {a['name']} tokens differ from rank 0's")
        return {c["name"]: c for c in res[0]}

    def report(what, world, backend, cards, cases):
        for name, c in cases.items():
            line = f"phase 3m {what} {name}: {world} ranks, {backend}, " \
                   f"cards {cards}; graph captures " \
                   f"{c['summary']['graph_captures']}"
            if "decode_tokens_per_s" in c:
                co = c["collectives"]
                line += (f"; decode {c['decode_tokens_per_s']:.1f} tokens/s;"
                         f" collectives {co['device_ms_per_step']:.3f} device"
                         f" ms / {co['host_ms_per_step']:.3f} host ms a "
                         f"decode step ({co['calls']} calls)")
            log(f"{line} [{gpu_line()}]")
        out[what] = {"ranks": world, "backend": backend, "cards": cards,
                     "cases": cases}

    run["thread"].join()
    if "error" in run:
        raise run["error"]
    cases = take(run["res21"], "mesh (2, 1)")
    for name, ref in (("p3", "p3"), ("p3s", "p3s"), ("paged", "paged")):
        check(cases[name]["tokens"] == want[ref], f"phase 3m mesh (2, 1) "
              f"{name}: tokens differ from the mesh-free run's (bf16)")
        check(cases[name]["summary"]["graph_captures"] == 0,
              f"phase 3m mesh (2, 1) {name}: a gloo mesh captured a graph")
    check(cases["paged"]["summary"]["kv"]["blocks_in_use"] == 0,
          "phase 3m mesh (2, 1): KV blocks left in use")
    check([s["resident_experts"] for s in cases["p3"]["summary"]["shards"]]
          != [0, 0], "phase 3m mesh (2, 1): no expert on the shards")
    log("  mesh (2, 1): phase 3's tokens bitwise (greedy and sampled, "
        "bf16), the paged run's bitwise, no capture, shards "
        f"{[s['resident_experts'] for s in cases['p3']['summary']['shards']]}")
    report("mesh (2, 1)", 2, "gloo", [0, 0], cases)

    cases = take(wait_ranks(run["h12"]), "mesh (1, 2)")
    check(cases["p3_f32"]["tokens"] == want["p3_f32"], "phase 3m mesh "
          "(1, 2): f32 tokens differ from the mesh-free f32 run's")
    ties = []
    for r in reqs:
        e = near_tie(torch, engine, r, list(r.out_tokens),
                     cases["p3"]["tokens"][str(r.uid)],
                     "mesh (1, 2) and mesh-free (bf16)")
        if e is not None:
            ties.append(e)
    out["mesh12_bf16_near_ties"] = ties
    log(f"  mesh (1, 2): f32 tokens bitwise; bf16: "
        f"{len(reqs) - len(ties)} of {len(reqs)} streams bitwise, "
        f"{len(ties)} part at near-ties")
    report("mesh (1, 2)", 2, "gloo", [0, 0], cases)

    cases = take(wait_ranks(run["h11"]), "mesh (1, 1)")
    for name in ("p3", "refill", "paged"):
        check(cases[name]["tokens"] == want[name], f"phase 3m mesh (1, 1) "
              f"{name}: tokens differ from the mesh-free run's (bf16)")
        check(cases[name]["summary"]["graph_captures"] > 0,
              f"phase 3m mesh (1, 1) {name}: no graph was captured")
    res = cases["resume"]
    check(res["status"] == ["done"] and res["continued"],
          f"phase 3m resume: {res['status']}, continued {res['continued']}")
    for u in res["continued"]:
        check(res["tokens"][str(u)] == want["paged"][str(u)],
              f"phase 3m resume: continued row {u} differs (bf16)")
    same = sum(res["tokens"][u] == t for u, t in want["paged"].items())
    check(res["summary"]["kv"]["blocks_in_use"] == 0,
          "phase 3m resume: KV blocks left in use")
    out["resume"] = {"continued": res["continued"], "plan": res["plan"],
                     "streams_equal": same}
    log(f"  mesh (1, 1): phase 3's, 3d's and the paged tokens bitwise with "
        f"graphs; the (2, 1) snapshot resumed: rows {res['continued']} "
        f"continued bitwise, {same} of {len(want['paged'])} streams equal "
        "the uninterrupted run's")
    report("mesh (1, 1)", 1, "nccl", [0], cases)

    if n_cards > 1:
        log("  (d) one rank per card under NCCL: meshes (2, 1) and (1, 2)")
        for shape, name, ref in (((2, 1), "p3", "p3"),
                                 ((1, 2), "p3_f32", "p3_f32")):
            what = f"mesh {shape} nccl"
            cases = take(run_ranks(torch, dict(spec, shape=list(shape),
                                               cases=[{
                                                   "name": name,
                                                   "traffic": "p3",
                                                   "f32": name == "p3_f32",
                                                   "timed": True}]),
                                   2, "nccl", [0, 1], tmp,
                                   f"mesh{shape[0]}{shape[1]}nccl"), what)
            check(cases[name]["tokens"] == want[ref],
                  f"phase 3m {what}: tokens differ from the mesh-free run's")
            report(what, 2, "nccl", [0, 1], cases)

    train = {}
    for pods, backend in ((1, "nccl"), (2, "gloo")):
        oracle = multipod_oracle(torch, spec["seed"], pods,
                                 torch.device("cuda"))
        res = wait_ranks(run["h_train"][pods])
        for r, got in enumerate(res):
            check(got["params"] == oracle["params"],
                  f"phase 3m multi-pod ({pods} {backend}): rank {r}'s "
                  "parameters differ from the oracle's")
            check(got["ef"] == oracle["ef"][r],
                  f"phase 3m multi-pod ({pods} {backend}): rank {r}'s "
                  "error feedback differs from the oracle's")
            check(got["losses"] == oracle["losses"],
                  f"phase 3m multi-pod ({pods} {backend}): losses "
                  f"{got['losses']} != {oracle['losses']}")
        train[f"{pods}_{backend}"] = {"losses": res[0]["losses"],
                                      "step_s": res[0]["step_s"]}
        log(f"phase 3m multi-pod {pods} {backend} pod(s): parameters, error "
            f"feedback and losses bitwise the oracle; step seconds "
            f"{[round(x, 3) for x in res[0]['step_s']]} [{gpu_line()}]")
    out["multipod"] = train
    for name in ("ternary_matmul_grouped", "sample_tokens"):
        check(launches[name] > 0, f"phase 3m: {name} was not launched "
              "under the mesh")
    return out, launches


# ---------------------------------------------------------------------------
# phase 3w: training inside a pod and sequence-parallel decode, one process
# a rank
# ---------------------------------------------------------------------------

# (name, mesh shape, f32): the within-pod train steps of part (a); the
# first two run on two ranks, the last on four
WITHIN_TRAIN = (("fsdp", (1, 2, 1), False), ("tp", (1, 1, 2), True),
                ("pods", (2, 2, 1), False))
# every within-pod step trains on 8 x 64 tokens in 2 microbatches, half
# of the targets of the rows data rank 0 (of pod 0) takes at -1; part (a)
# runs 2 steps (warmup_cosine's learning rate is 0 at step 0, so the
# second moves the parameters after the first moved the moments)
WITHIN_BATCH = dict(seq_len=64, global_batch=8, task_id=1)
WITHIN_MICRO = 2
WITHIN_STEPS = 2
WITHIN_PARAM_TOL = 1e-4      # f32, a mesh with "model" against the
WITHIN_LOSS_TOL = 1e-4       # mesh-free step
# part (c): mixtral-8x7b at full width, 1 unit, f32, on (1, 2, 2): as
# published (TP inside the experts) and with expert_parallel=True
MOE_SHAPE = (1, 2, 2)
MOE_CASES = (("moe_tp", False), ("moe_ep", True))
# warmup_cosine's learning rate is 0 at step 0, so of the 2 steps only
# the second moves a parameter; a third costs about 13 s a layout
MOE_STEPS = 2
MOE_PARAM_TOL = 1e-5    # f32, one AdamW update at lr 3.3e-4
MOE_NORM_TOL = 1e-5     # relative: the global gradient norm before the clip
EXPERT_LEAVES = ("wg_e", "wu_e", "wo_e")
# part (d): the families beyond decoder-only attention on "model", f32,
# on (1, 2, 2) at (c)'s tolerances (``family_config``), and one
# full-width jamba mamba mixer on (1, 1, 2) against the whole mixer
FAMILY_SHAPE = (1, 2, 2)
FAMILY_ARCHS = {"rwkv6": "rwkv6_3b", "internvl2": "internvl2_1b",
                "seamless": "seamless_m4t_medium"}
FAMILY_CASES = ("rwkv6", "internvl2", "seamless", "jamba_smoke")
FAMILY_STEPS = 2
MAMBA_SHAPE = (1, 1, 2)
MAMBA_ROWS, MAMBA_T = 2, 256
MAMBA_TOL = 1e-5        # of each tensor's largest |value|, f32
SP_LOGIT_TOL = 1e-4          # of the largest |logit|, f32
# the sequence-parallel decode cases: phase 3's 8 requests (16 to 64
# prompt tokens) in waves of 4 on (data 1, model 2); one 4096-token prompt
# on (2, 2) (the sequence over every axis, the long-context layout).  Each
# ring is short enough that every rank's slice holds positions the rows
# attend to: the waves' 64 slots (32 a rank) wrap in their 16 steps, and
# the long prompt reaches the last rank's 1152 slots (3456 onwards).
SP_CASES = {"waves": dict(shape=(1, 2), cache_len=64, steps=16),
            "long": dict(shape=(2, 2), cache_len=4608, steps=32,
                         prompt=4096, expert="e1")}
# part (e): prefill and decode inside a pod on the cut weights
# (``within_pod.make_pod_serve``), before the AdamW steps of (a)'s (1, 1,
# 2) ranks (qwen2.5-3b at --units, f32), (c)'s mixtral ranks and (d)'s
# families: SERVE_ROWS prompts of SERVE_T tokens (a frontend's frames or
# patches besides) at cache_len SERVE_CACHE_LEN, then SERVE_STEPS greedy
# steps; jamba adds one prompt at batch 1 (the long-context layout: the
# sequence over every axis, mamba's states on d_inner).  Each against the
# mesh-free prefill and decode in this process, on the same weights.
SERVE_ROWS, SERVE_T, SERVE_CACHE_LEN, SERVE_STEPS = 4, 128, 1024, 8
SERVE_QWEN_SHAPE = (1, 1, 2)


def serve_batches(torch, cfg, name: str, dev) -> list:
    """Part (e)'s prompts of ``cfg``: [(case, batch)], "b4" SERVE_ROWS
    rows of SERVE_T tokens (with seeded frames or patch embeddings for a
    frontend), and for jamba "b1", one row (the long-context layout)."""
    g = torch.Generator().manual_seed(23)
    out = []
    for case, rows in (("b4", SERVE_ROWS),) + (
            (("b1", 1),) if name.startswith("jamba") else ()):
        batch = {"tokens": torch.randint(2, cfg.vocab, (rows, SERVE_T),
                                         generator=g).to(dev)}
        if cfg.frontend is not None:
            batch["frames" if cfg.enc_n_units else "mm_embeds"] = \
                torch.randn((rows, cfg.frontend.n_tokens,
                             cfg.frontend.embed_dim), generator=g).to(dev)
        out.append((case, batch))
    return out


def serve_reference(torch, model, params, name: str, dev) -> dict:
    """Part (e)'s mesh-free run of ``name`` in this process: each case's
    prefill, then SERVE_STEPS greedy steps; -> per case the first step's
    logits, every step's (for the near-tie rule) and the tokens (CPU),
    prefill ms and decode ms a step."""
    out = {}
    with torch.no_grad():
        for case, batch in serve_batches(torch, model.cfg, name, dev):
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            lg, cache = model.prefill(params, batch, SERVE_CACHE_LEN)
            torch.cuda.synchronize(dev)
            res = {"prefill_ms": (time.monotonic() - t0) * 1e3,
                   "step_ms": [], "logits": [], "tokens": []}
            tok = lg[:, -1].argmax(-1)[:, None]
            for _ in range(SERVE_STEPS):
                torch.cuda.synchronize(dev)
                t0 = time.monotonic()
                lg, cache = model.decode_step(params, tok, cache)
                tok = lg[:, 0].argmax(-1)[:, None]
                torch.cuda.synchronize(dev)
                res["step_ms"].append((time.monotonic() - t0) * 1e3)
                res["logits"].append(lg[:, 0].float().cpu())
                res["tokens"].append(tok[:, 0].tolist())
            res["first"] = res["logits"][0]
            out[case] = res
            del cache
    return out


def pod_serve_child(torch, name: str, cfg, params, mesh, spec, dev) -> dict:
    """One rank's part (e) on ``params``, its blocks under
    ``param_shardings`` (before any AdamW step): each case of
    :func:`serve_batches` prefilled and decoded SERVE_STEPS greedy steps
    through ``within_pod.make_pod_serve``, the last one profiled.
    Every parameter block and every cache leaf is held to its placed
    shape (``param_shardings``, ``cache_placement``).  The first step's
    logits go to a file beside the rank's results; returned: tokens,
    prefill ms, decode ms a step, peak memory, the collectives of the
    profiled step, the cache leaves cut and every block not at its
    placed shape."""
    from repro_torch import tree as tree_util
    from repro_torch.distributed.sharding import (cache_placement,
                                                  local_shard,
                                                  param_shardings)
    from repro_torch.models import build as build_model
    from repro_torch.models.transformer import init_decode_cache
    from repro_torch.train import within_pod as wp
    from torch.profiler import ProfilerActivity, profile
    model = build_model(cfg)
    index = {a: mesh.get_local_rank(a) for a in ("pod", "data", "model")}

    def misplaced(tree, logical, specs, what):
        flat, sp = (dict(tree_util.flatten_with_paths(x))
                    for x in (logical, specs))
        return [f"{what} {p} is {tuple(t.shape)}, placed "
                f"{tuple(local_shard(flat[p], sp[p], mesh, index).shape)}"
                for p, t in tree_util.flatten_with_paths(tree)
                if t.shape != local_shard(flat[p], sp[p], mesh,
                                          index).shape]

    meta = model.init(device="meta")
    out = {"name": f"serve_{name}", "cases": {},
           "wrong_blocks": misplaced(params, meta, param_shardings(
               meta, cfg, mesh), "parameter")}
    firsts = {}
    for case, batch in serve_batches(torch, cfg, name, dev):
        B = batch["tokens"].shape[0]
        prefill, step = wp.make_pod_serve(model, mesh, B, SERVE_CACHE_LEN)
        free_all(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        lg, cache = prefill(params, batch)
        torch.cuda.synchronize(dev)
        res = {"prefill_ms": (time.monotonic() - t0) * 1e3, "step_ms": [],
               "tokens": []}
        logical = init_decode_cache(cfg, B, SERVE_CACHE_LEN,
                                    device="meta")
        out["wrong_blocks"] += misplaced(cache, logical, cache_placement(
            logical, mesh, B), f"{case} cache")
        res["cut_cache_leaves"] = sum(
            t.numel() < l.numel() for t, l in zip(
                tree_util.leaves(cache), tree_util.leaves(logical)))
        tok = lg[:, -1].argmax(-1)[:, None]
        for s in range(SERVE_STEPS):
            last = s + 1 == SERVE_STEPS     # profiled, not timed
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof:
                lg, cache = step(params, tok, cache)
                tok = lg[:, 0].argmax(-1)[:, None]
                torch.cuda.synchronize(dev)
            if not last:
                res["step_ms"].append((time.monotonic() - t0) * 1e3)
            res["tokens"].append(tok[:, 0].tolist())
            if s == 0:
                firsts[case] = lg[:, 0].float().cpu()
        res["collectives"] = collectives_of(prof)
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["cases"][case] = res
        del cache, prefill, step
    torch.save(firsts, spec["out"] + f".serve_{name}.pt")
    free_all(torch)
    return out


def qwen_serve_child(torch, spec, dev) -> dict:
    """Part (e)'s qwen2.5-3b ranks on SERVE_QWEN_SHAPE (the world of
    two): an f32 copy at ``--units`` of the seeded weights (as the
    decode references' copy), each rank's blocks cut from it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    from repro_torch.train import within_pod as wp
    mesh = make_production_mesh(shape=SERVE_QWEN_SHAPE, device="cuda")
    model = build_model(dataclasses.replace(get_config("qwen2_5_3b"),
                                            n_units=spec["units"]))
    m32, b32 = f32_copy(torch, model, model.init(seed=spec["seed"],
                                                 device=dev))
    local = wp.pod_serve_params(b32, m32.cfg, mesh, device=dev)
    del b32
    free_all(torch)
    return pod_serve_child(torch, "qwen", m32.cfg, local, mesh, spec, dev)


def serve_gates(torch, name: str, ranks: list, firsts: list,
                ref: dict) -> dict:
    """Part (e)'s gates on one configuration: every rank's tokens equal
    rank 0's, and its blocks at their placed shapes; each case's first
    decode step's logits within SP_LOGIT_TOL of the largest |logit| of
    the mesh-free run's and its greedy tokens equal up to a near-tie
    (:func:`sp_gates`), on every rank."""
    cases = list(ref)
    for r, rank in enumerate(ranks):
        check(not rank["wrong_blocks"], f"phase 3w (e) {name}: rank {r}: "
              + "; ".join(rank["wrong_blocks"][:4]))
        check(all(rank["cases"][c]["tokens"] == ranks[0]["cases"][c][
            "tokens"] for c in cases), f"phase 3w (e) {name}: rank {r}'s "
              "tokens differ from rank 0's")
    want = {k: [ref[c][k] for c in cases]
            for k in ("first", "tokens", "logits")}
    gates = [sp_gates(torch, f"(e) {name}", [f[c] for c in cases],
                      [rank["cases"][c]["tokens"] for c in cases], want)
             for rank, f in zip(ranks, firsts)]
    return {"first_logits_rel_err": max(g["first_logits_rel_err"]
                                        for g in gates),
            "near_ties": gates[0]["near_ties"]}


def serve_report(name: str, shape, ranks: list, ref: dict,
                 gates: dict) -> dict:
    """Part (e)'s report of one configuration, and its log line."""
    rep = dict(gates, shape=list(shape), cases={})
    for c in ref:
        got = [r["cases"][c] for r in ranks]
        rep["cases"][c] = {
            "prefill_ms": [g["prefill_ms"] for g in got],
            "decode_ms_per_step": [sum(g["step_ms"][1:])
                                   / max(len(g["step_ms"]) - 1, 1)
                                   for g in got],
            "mesh_free_prefill_ms": ref[c]["prefill_ms"],
            "mesh_free_decode_ms_per_step": sum(ref[c]["step_ms"][1:])
            / max(len(ref[c]["step_ms"]) - 1, 1),
            "peak_gib": [g["peak_gib"] for g in got],
            "collectives": [g["collectives"] for g in got],
            "cut_cache_leaves": got[0]["cut_cache_leaves"]}
    log(f"phase 3w (e) {name} on {tuple(shape)}: first-step logits within "
        f"{gates['first_logits_rel_err']:.2e} of the largest, "
        f"{len(gates['near_ties'])} near-ties; " + "; ".join(
            f"{c}: prefill ms rank 0 {v['prefill_ms'][0]:.1f} (mesh-free "
            f"{v['mesh_free_prefill_ms']:.1f}), decode ms a step "
            f"{v['decode_ms_per_step'][0]:.1f} (mesh-free "
            f"{v['mesh_free_decode_ms_per_step']:.1f}), peak GiB a rank "
            f"{[round(x, 2) for x in v['peak_gib']]}, "
            f"{v['cut_cache_leaves']} cache leaves cut, collectives of a "
            f"profiled step {v['collectives'][0]}"
            for c, v in rep["cases"].items()) + f" [{gpu_line()}]")
    return rep


def state_nbytes(tree) -> int:
    from repro_torch import tree as tree_util
    return sum(t.numel() * t.element_size()
               for t in tree_util.leaves(tree))


def within_tcfg(TrainConfig, GradCompressionConfig):
    return dataclasses.replace(mesh_tcfg(TrainConfig, GradCompressionConfig),
                               microbatches=WITHIN_MICRO)


def within_batches(torch, cfg, shape, dev, steps=WITHIN_STEPS) -> list:
    """The within-pod steps' global batches on a mesh of ``shape``: half
    of the targets of the rows data rank 0 of pod 0 takes (its share of
    each microbatch, ``within_pod.local_rows``) at -1, so the data ranks
    hold uneven counts of valid targets.  A frontend config's rows hold
    its ``n_tokens`` frames or patches besides their 64 text tokens."""
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.train import within_pod as wp
    n = WITHIN_BATCH["global_batch"]
    rows = wp.local_rows({"i": torch.arange(n)}, wp.AxisSizes(dict(zip(
        ("pod", "data", "model"), shape))), {"pod": 0, "data": 0,
                                             "model": 0}, WITHIN_MICRO)["i"]
    kw = dict(WITHIN_BATCH)
    if cfg.frontend is not None:
        kw["seq_len"] += cfg.frontend.n_tokens
    out = []
    for s in range(steps):
        batch = make_batch_for(cfg, s, device=dev, **kw)
        batch["targets"] = batch["targets"].clone()   # not the tokens' view
        g = torch.Generator().manual_seed(17 + s)
        T = WITHIN_BATCH["seq_len"]
        for r in rows.tolist():
            cols = torch.randperm(T, generator=g)[:T // 2].to(dev)
            batch["targets"][r, cols] = -1
        out.append(batch)
    return out


def within_train_child(torch, name, shape, f32, spec, dev) -> dict:
    """One rank of a within-pod train step (qwen2.5-3b at 1 unit, 2 AdamW
    steps of 8 x 64 tokens in 2 microbatches, masked targets): digests
    of its blocks, the losses, step seconds, resident state bytes beside
    the mesh-free state's, the collectives of the last step (profiled);
    on an f32 mesh with "model", the largest parameter difference from
    the mesh-free step."""
    from repro_torch.configs import get_config
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train import within_pod as wp
    from repro_torch import tree as tree_util
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=1,
                              dtype="float32" if f32 else "bfloat16")
    model = build_model(cfg)
    mesh = make_production_mesh(shape=shape, device="cuda")
    tcfg = within_tcfg(TrainConfig, GradCompressionConfig)
    pods = shape[0] > 1
    torch.cuda.reset_peak_memory_stats(dev)
    free_bytes = state_nbytes({k: v for k, v in init_train_state(
        model.init(device="meta"), tcfg, multi_pod=pods).items()
        if k != "step"})
    # the rank's blocks of the parameters, and zero slots and error
    # feedback of their shapes: the cut of a fresh logical state
    params = model.init(seed=spec["seed"], device=dev)
    local = init_train_state(shard_tree(params, param_shardings(
        params, cfg, mesh), mesh), tcfg, multi_pod=pods)
    del params
    free_all(torch)
    step = make_train_step(model, tcfg, mesh=mesh)
    torch.set_grad_enabled(True)
    losses, secs = [], []
    batches = within_batches(torch, cfg, shape, dev)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        if i + 1 < len(batches):
            local, met = step(local, batch)
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                local, met = step(local, batch)
                torch.cuda.synchronize(dev)
        losses.append(float(met["loss"]))
        secs.append(time.monotonic() - t0)
    out = {"name": name, "losses": losses, "step_s": secs,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "state_bytes": state_nbytes({k: v for k, v in local.items()
                                        if k != "step"}),
           "mesh_free_state_bytes": free_bytes,
           "digest": tree_digest(torch, local)}
    if shape[2] > 1:
        plain = make_train_step(model, tcfg)
        st = init_train_state(model.init(seed=spec["seed"], device=dev),
                              tcfg)
        plain_losses = []
        for batch in batches:
            st, met = plain(st, batch)
            plain_losses.append(float(met["loss"]))
        want = wp.shard_train_state(st, cfg, mesh)
        out["plain_losses"] = plain_losses
        out["max_param_diff"] = max(
            float((a - b).abs().max()) for a, b in zip(
                tree_util.leaves(local["params"]),
                tree_util.leaves(want["params"])))
        del st, want
    out["collectives"] = collectives_of(prof)
    del local
    torch.set_grad_enabled(False)
    free_all(torch)
    return out


def moe_config(ep: bool):
    """mixtral-8x7b at full width, 1 unit, f32; ``ep`` overrides the
    published layout (TP inside the experts) with expert parallelism."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_units=1,
                              dtype="float32")
    if ep:
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, expert_parallel=True))
    return cfg


def expert_nbytes(tree) -> int:
    from repro_torch import tree as tree_util
    return sum(t.numel() * t.element_size()
               for p, t in tree_util.flatten_with_paths(tree)
               if p.split("/")[-1] in EXPERT_LEAVES)


def mesh_free_reference(torch, cfg, seed, dev, path, shape, steps,
                        serve_name=None) -> dict:
    """A mesh-free step of ``cfg`` in this process, ``steps`` AdamW steps
    of the batches of a mesh of ``shape`` (part (c)'s mixtral: about 27
    GB of f32 state and gradients, freed before the ranks start): the
    final parameters written to ``path`` for the ranks' gates; returned:
    the losses, gradient norms, step seconds, the state's bytes (and its
    expert bytes), parameters and peak memory; with ``serve_name``, first
    part (e)'s mesh-free run on the initial weights (``"serve"``,
    :func:`serve_reference`)."""
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.models import build as build_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch import tree as tree_util
    model = build_model(cfg)
    tcfg = within_tcfg(TrainConfig, GradCompressionConfig)
    free_all(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(model.init(seed=seed, device=dev), tcfg)
    served = (serve_reference(torch, model, state["params"], serve_name, dev)
              if serve_name else None)
    step = make_train_step(model, tcfg)
    losses, norms, secs = [], [], []
    with torch.enable_grad():
        for batch in within_batches(torch, cfg, shape, dev, steps):
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            secs.append(time.monotonic() - t0)
    # written whole before its name appears: a rank may wait for it
    torch.save(tree_util.tree_map(lambda t: t.cpu(), state["params"]),
               path + ".part")
    os.replace(path + ".part", path)
    out = {"path": path, "losses": losses, "grad_norms": norms,
           "step_s": secs,
           "state_bytes": state_nbytes({k: v for k, v in state.items()
                                        if k != "step"}),
           "expert_bytes": expert_nbytes(state["params"]),
           "n_params": sum(t.numel() for t in tree_util.leaves(
               state["params"])),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    if served is not None:
        out["serve"] = served
    del state, step
    free_all(torch)
    return out


def within_moe_child(torch, name, ep, spec, dev) -> dict:
    """One rank of part (c): mixtral at full width, 1 unit, f32, on (1, 2,
    2) as ``moe_config(ep)`` places it, part (e)'s serving on its blocks
    (:func:`pod_serve_child`), then ``MOE_STEPS`` AdamW steps of 8 x 64
    tokens in 2 microbatches (masked targets), the last profiled; then
    its parameter blocks against the mesh-free step's, cut from the file
    the parent wrote (``spec["moe_ref"]``, mapped, not read whole).
    Returned: losses, gradient norms, step seconds, resident state and
    expert bytes beside the mesh-free state's, the expert leaves'
    shapes, peak memory, the collectives of the profiled step, the
    largest parameter difference and every block not at its placed shape
    (or an expert block not a quarter of its leaf)."""
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.distributed.sharding import (local_shard,
                                                  param_shardings,
                                                  shard_tree)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch import tree as tree_util
    from torch.profiler import ProfilerActivity, profile
    import torch.distributed as dist
    cfg = moe_config(ep)
    model = build_model(cfg)
    mesh = make_production_mesh(shape=MOE_SHAPE, device="cuda")
    tcfg = within_tcfg(TrainConfig, GradCompressionConfig)
    free_all(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    free_gib = [torch.cuda.mem_get_info(dev)[0] / 2**30]
    # two ranks at a time draw the whole tree (6.9 GB) and cut their blocks
    for r in range(0, spec["world"], 2):
        if spec["rank"] in (r, r + 1):
            params = model.init(seed=spec["seed"], device=dev)
            local = init_train_state(shard_tree(params, param_shardings(
                params, cfg, mesh), mesh), tcfg)
            del params
            free_all(torch)
        dist.barrier()
    free_gib.append(torch.cuda.mem_get_info(dev)[0] / 2**30)
    served = pod_serve_child(torch, name, cfg, local["params"], mesh, spec,
                             dev)
    step = make_train_step(model, tcfg, mesh=mesh)
    torch.set_grad_enabled(True)
    losses, norms, secs = [], [], []
    batches = within_batches(torch, cfg, MOE_SHAPE, dev, MOE_STEPS)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        if i + 1 < len(batches):
            local, met = step(local, batch)
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                local, met = step(local, batch)
                torch.cuda.synchronize(dev)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.monotonic() - t0)
    torch.set_grad_enabled(False)
    out = {"name": name, "losses": losses, "grad_norms": norms,
           "step_s": secs,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "state_bytes": state_nbytes({k: v for k, v in local.items()
                                        if k != "step"}),
           "expert_bytes": expert_nbytes(local["params"]),
           "expert_shapes": {p: list(t.shape) for p, t in
                             tree_util.flatten_with_paths(local["params"])
                             if p.split("/")[-1] in EXPERT_LEAVES},
           "collectives": collectives_of(prof), "card_free_gib": free_gib,
           "serve": served}
    del step
    free_all(torch)
    ref = torch.load(spec["moe_ref"], map_location="cpu", mmap=True,
                     weights_only=True)
    specs = dict(tree_util.flatten_with_paths(param_shardings(
        ref, cfg, mesh)))
    want = dict(tree_util.flatten_with_paths(ref))
    index = {a: mesh.get_local_rank(a) for a in ("pod", "data", "model")}
    worst, wrong = 0.0, []
    for path, got in tree_util.flatten_with_paths(local["params"]):
        block = local_shard(want[path], specs[path], mesh, index)
        if got.shape != block.shape:
            wrong.append(f"{path} is {tuple(got.shape)}, placed "
                         f"{tuple(block.shape)}")
            continue
        if (path.split("/")[-1] in EXPERT_LEAVES
                and block.numel() * 4 != want[path].numel()):
            wrong.append(f"{path} is not cut to a quarter")
        worst = max(worst, float((got - block.to(dev)).abs().max()))
    out.update(max_param_diff=worst, wrong_blocks=wrong)
    del local, ref, want
    free_all(torch)
    return out


def step_gates(torch, ref, ranks, name) -> dict:
    """Part (c)'s and (d)'s gates on one layout, from what its ranks
    report: every rank's losses and gradient norms equal rank 0's, the
    losses within WITHIN_LOSS_TOL and the norms (before the clip) within
    MOE_NORM_TOL of the mesh-free step's, which ties the gradients' scale
    to it; every block at its placed shape (in (c) an expert block a
    quarter of its leaf: E or d_ff over "model", another dim over
    "data"), every parameter within MOE_PARAM_TOL of the mesh-free
    step's block."""
    for r, rank in enumerate(ranks):
        check(rank["losses"] == ranks[0]["losses"]
              and rank["grad_norms"] == ranks[0]["grad_norms"],
              f"phase 3w {name}: rank {r}'s losses or gradient norms differ "
              "from rank 0's")
        check(not rank["wrong_blocks"], f"phase 3w {name}: rank {r}: "
              + "; ".join(rank["wrong_blocks"][:4]))
    losses, norms = ranks[0]["losses"], ranks[0]["grad_norms"]
    gap = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    check(gap <= WITHIN_LOSS_TOL, f"phase 3w {name}: losses {losses} vs "
          f"mesh-free {ref['losses']}")
    norm_gap = max(abs(a - b) / b for a, b in zip(norms, ref["grad_norms"]))
    check(norm_gap <= MOE_NORM_TOL, f"phase 3w {name}: gradient norms "
          f"{norms} vs mesh-free {ref['grad_norms']}")
    worst = max(r["max_param_diff"] for r in ranks)
    check(worst <= MOE_PARAM_TOL, f"phase 3w {name}: parameters "
          f"{worst:.3e} from the mesh-free step's")
    return {"max_param_diff": worst, "loss_gap": gap,
            "grad_norm_rel_gap": norm_gap}


def family_config(name: str):
    """Part (d)'s configurations, f32: rwkv6-3b and internvl2-1b at full
    width with 1 unit, seamless-m4t-medium at full width with 1 encoder
    and 1 decoder unit, jamba at smoke size with 1 unit (8 blocks: its
    attention, 7 mamba, 4 MoE FFNs)."""
    from repro_torch.configs import get_config, get_smoke_config
    if name == "jamba_smoke":
        return get_smoke_config("jamba_1_5_large_398b", n_units=1)
    cfg = get_config(FAMILY_ARCHS[name])
    cfg = dataclasses.replace(cfg, n_units=1, dtype="float32")
    if cfg.enc_n_units:
        cfg = dataclasses.replace(cfg, enc_n_units=1)
    return cfg


def family_ref_path(tmp, name: str) -> str:
    """Where part (d)'s mesh-free step of ``name`` leaves its final
    parameters."""
    return os.path.join(tmp, f"family_{name}.pt")


def family_references(torch, seed, dev, tmp) -> dict:
    """Part (d)'s mesh-free steps in this process, one configuration at a
    time (:func:`mesh_free_reference`), their final parameters in files
    under ``tmp``, each after part (e)'s mesh-free run."""
    return {name: mesh_free_reference(
        torch, family_config(name), seed, dev,
        family_ref_path(tmp, name), FAMILY_SHAPE, FAMILY_STEPS,
        serve_name=name)
        for name in FAMILY_CASES}


def within_family_child(torch, name, spec, dev) -> dict:
    """One rank of part (d): ``family_config(name)`` on (1, 2, 2), part
    (e)'s serving on its blocks (:func:`pod_serve_child`), then
    ``FAMILY_STEPS`` AdamW steps of 8 rows of 64 text tokens in 2
    microbatches (masked targets), the last profiled; then every block of
    its state against its placed shape and its parameter blocks against
    the mesh-free step's (read from ``spec["family_refs"][name]`` once
    the parent has written it).  Returned: losses,
    gradient norms, step seconds, resident state bytes, peak memory, the
    collectives of the profiled step, the largest parameter difference,
    every block not at its placed shape, and how many leaves are cut
    over "model"."""
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.distributed.sharding import (local_shard,
                                                  train_state_shardings)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train import within_pod as wp
    from repro_torch import tree as tree_util
    from torch.profiler import ProfilerActivity, profile
    cfg = family_config(name)
    model = build_model(cfg)
    mesh = make_production_mesh(shape=FAMILY_SHAPE, device="cuda")
    tcfg = within_tcfg(TrainConfig, GradCompressionConfig)
    free_all(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    local = wp.shard_train_state(init_train_state(
        model.init(seed=spec["seed"], device=dev), tcfg), cfg, mesh)
    free_all(torch)
    served = pod_serve_child(torch, name, cfg, local["params"], mesh, spec,
                             dev)
    step = make_train_step(model, tcfg, mesh=mesh)
    torch.set_grad_enabled(True)
    losses, norms, secs = [], [], []
    batches = within_batches(torch, cfg, FAMILY_SHAPE, dev, FAMILY_STEPS)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        if i + 1 < len(batches):
            local, met = step(local, batch)
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                local, met = step(local, batch)
                torch.cuda.synchronize(dev)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.monotonic() - t0)
    torch.set_grad_enabled(False)
    out = {"name": name, "losses": losses, "grad_norms": norms,
           "step_s": secs,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "state_bytes": state_nbytes({k: v for k, v in local.items()
                                        if k != "step"}),
           "collectives": collectives_of(prof), "serve": served}
    del step
    free_all(torch)
    index = {a: mesh.get_local_rank(a) for a in ("pod", "data", "model")}
    meta = init_train_state(model.init(device="meta"), tcfg)
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        meta, cfg, mesh)))
    whole = dict(tree_util.flatten_with_paths(meta))
    wrong, cut = [], 0
    for path, got in tree_util.flatten_with_paths(local):
        if path == "step":
            continue
        placed = local_shard(whole[path], specs[path], mesh, index).shape
        if got.shape != placed:
            wrong.append(f"{path} is {tuple(got.shape)}, placed "
                         f"{tuple(placed)}")
        elif "model" in specs[path]:
            d = specs[path].index("model")
            if got.shape[d] * FAMILY_SHAPE[2] != whole[path].shape[d]:
                wrong.append(f"{path} is not cut over 'model'")
            cut += 1
    path = spec["family_refs"][name]
    t0 = time.monotonic()
    while not os.path.exists(path):     # the parent writes it beside us
        check(time.monotonic() - t0 < 600, f"phase 3w (d) {name}: no "
              "mesh-free parameters after 600 s")
        time.sleep(0.5)
    ref = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    pspecs = dict(tree_util.flatten_with_paths(wp.logical_specs(cfg, mesh)))
    worst = 0.0
    for path, got in tree_util.flatten_with_paths(local["params"]):
        block = local_shard(dict(tree_util.flatten_with_paths(ref))[path],
                            pspecs[path], mesh, index)
        if got.shape == block.shape:
            worst = max(worst, float((got - block.to(dev)).abs().max()))
    out.update(max_param_diff=worst, wrong_blocks=wrong, model_cut=cut)
    del local, ref
    free_all(torch)
    return out


def family_gates(torch, ref, ranks, name) -> dict:
    """Part (d)'s gates on one configuration: (c)'s (:func:`step_gates`),
    every leaf placed on "model" cut over it on every rank."""
    for r, rank in enumerate(ranks):
        check(rank["model_cut"] > 0, f"phase 3w (d) {name}: rank {r} "
              "holds no leaf cut over 'model'")
    return step_gates(torch, ref, ranks, f"(d) {name}")


def within_mamba_child(torch, spec, dev) -> dict:
    """One rank of part (d)'s full-width jamba mamba mixer on (1, 1, 2):
    this rank's d_inner slice (its placed blocks, ``in_proj`` regrouped
    over "model") forward and backward over MAMBA_ROWS x MAMBA_T tokens
    with a seeded cotangent, then the whole mixer in this process on the
    same inputs; the output and this rank's block of every leaf's
    gradient, each within MAMBA_TOL of its largest |value|.  Returned:
    the errors, the placed shapes, seconds of the cut and the whole
    mixer's forward and backward, the collectives of a profiled cut one,
    and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import local_shard, param_pspec
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models.transformer import _init_mamba
    from repro_torch.train import within_pod as wp
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config("jamba_1_5_large_398b"),
                              dtype="float32")
    b = next(b for b in cfg.pattern if b.kind == "mamba")
    mesh = make_production_mesh(shape=MAMBA_SHAPE, device="cuda")
    free_all(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 5)
    whole = {k: v[0] for k, v in _init_mamba(
        b.mamba, cfg.d_model, 1, torch.float32, gen, dev).items()}
    specs = {k: param_pspec(f"blocks/block1/mamba/{k}", (1,) + tuple(
        v.shape), cfg, mesh)[1:] for k, v in whole.items()}
    mine = {k: local_shard(v, specs[k], mesh) for k, v in whole.items()}
    run = wp.PodRun(cfg, mesh, wp.logical_specs(cfg, mesh))
    x = torch.randn((MAMBA_ROWS, MAMBA_T, cfg.d_model), generator=gen,
                    device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)

    def grads(p, tp=None, regroup=False):
        req = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            used = dict(req, in_proj=run.leaf(
                req["in_proj"], specs["in_proj"], regroup=True)) \
                if regroup else req
            out, _ = mamba_mod.mamba_forward(x, used, b.mamba, tp=tp)
            g = torch.autograd.grad((out * cot).sum(), list(req.values()))
        return out.detach(), dict(zip(req, g))

    secs = {}
    for what in ("cut", "cut", "whole"):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        if what == "cut":
            out, g = grads(mine, run.tp, True)
        else:
            want_out, want_g = grads(whole)
        torch.cuda.synchronize(dev)
        secs.setdefault(what, []).append(time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads(mine, run.tp, True)
        torch.cuda.synchronize(dev)

    def rel(a, w):
        return float((a - w).abs().max()) / max(float(w.abs().max()),
                                                1e-30)

    errs = {"out": rel(out, want_out)}
    for k, w in want_g.items():
        errs[k] = rel(g[k], local_shard(w, specs[k], mesh))
    out = {"errors": errs, "seconds": secs,
           "shapes": {k: list(v.shape) for k, v in mine.items()},
           "whole_shapes": {k: list(v.shape) for k, v in whole.items()},
           "n_params": sum(v.numel() for v in whole.values()),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "collectives": collectives_of(prof)}
    del whole, mine, g, want_g
    free_all(torch)
    return out


def mamba_gates(ranks) -> dict:
    """The full-width mixer's gates: on every rank the output and each
    leaf's gradient block within MAMBA_TOL of the whole mixer's, and
    every leaf but the norm cut in two along d_inner (``in_proj`` [D, 2
    Din / 2], ``out_proj`` [Din / 2, D])."""
    worst = 0.0
    for r, rank in enumerate(ranks):
        for k, e in rank["errors"].items():
            check(e <= MAMBA_TOL, f"phase 3w (d) mamba mixer: rank {r}'s "
                  f"{k} {e:.3e} of its largest from the whole mixer's")
            worst = max(worst, e)
        sh, wh = rank["shapes"], rank["whole_shapes"]
        check(sh["in_proj"] == [wh["in_proj"][0], wh["in_proj"][1] // 2]
              and sh["out_proj"] == [wh["out_proj"][0] // 2,
                                     wh["out_proj"][1]],
              f"phase 3w (d) mamba mixer: rank {r} holds {sh}")
    return {"max_rel_err": worst}


def sp_prompts(torch, traffic, case: str, vocab: int, dev) -> list:
    """The waves of a decode case: [(expert names, tokens [B, T]
    left-padded with 0, start [B])]."""
    if case == "long":
        g = torch.Generator().manual_seed(11)
        c = SP_CASES["long"]
        toks = torch.randint(2, vocab, (1, c["prompt"]), generator=g)
        return [([c["expert"]], toks.to(dev),
                 torch.zeros(1, dtype=torch.int32, device=dev))]
    waves = []
    for i in range(0, len(traffic), 4):
        rows = traffic[i:i + 4]
        T = max(len(p) for _, _, p, _ in rows)
        toks = torch.zeros((len(rows), T), dtype=torch.int64)
        for j, (_, _, p, _) in enumerate(rows):
            toks[j, T - len(p):] = torch.as_tensor(p)
        start = torch.as_tensor([T - len(p) for _, _, p, _ in rows],
                                dtype=torch.int32)
        waves.append(([e for _, e, _, _ in rows], toks.to(dev),
                      start.to(dev)))
    return waves


def sp_decode(torch, model, params, reg, waves, case: str, dev, mesh=None,
              keep_logits=False) -> dict:
    """Greedy decode of each wave on the zero-merge overlay: the prefill,
    then ``steps`` one-token steps.  With ``mesh`` (data, model) this rank
    prefills its rows, keeps its sequence slice of every ring and decodes
    through the sequence-parallel attention.  -> first decode step's
    logits, tokens, step ms, the combine's collectives (one more profiled
    step), kernel launches; on a mesh, per wave, the rows whose attention
    found a position in this rank's slice of the first ring at the last
    step (its partial was not empty)."""
    from repro_torch.distributed.collectives import (make_sp_decode_attn,
                                                     shard_decode_cache)
    from repro_torch.distributed.sharding import decode_layout
    from repro_torch.kernels import ops
    from repro_torch.models.delta import SlotOverlay, plan_overlay
    from torch.profiler import ProfilerActivity, profile
    c = SP_CASES[case]
    slots = SlotOverlay(plan_overlay(params, model.cfg), 8, dev)
    out = {"first": [], "tokens": [], "step_ms": [], "logits": []}
    ops.reset_launch_counts()
    for names, toks, start in waves:
        B = toks.shape[0]
        if mesh is not None and decode_layout(mesh, B)[0] is not None:
            check(mesh.shape[0] == 1, "phase 3w: rows cut over 'data'")
        overlay = slots.place(names, reg.fetch_packed)
        eid = torch.as_tensor([slots.slot_of(n) for n in names],
                              dtype=torch.int32, device=dev)
        attn = (make_sp_decode_attn(mesh, B, c["cache_len"])
                if mesh is not None else None)
        lg, cache = model.prefill(params, {"tokens": toks}, c["cache_len"],
                                  delta=overlay, eid=eid, start=start)
        if mesh is not None:
            cache = shard_decode_cache(cache, mesh, B)
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        toks_out, logits = [], []
        for s in range(c["steps"]):
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            lg, cache = model.decode_step(params, tok, cache, delta=overlay,
                                          eid=eid, decode_attn=attn)
            tok = lg[:, 0].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize(dev)
            out["step_ms"].append((time.monotonic() - t0) * 1e3)
            toks_out.append(tok[:, 0].tolist())
            if s == 0:
                out["first"].append(lg[:, 0].float().cpu())
            if keep_logits:
                logits.append(lg[:, 0].float())
        out["tokens"].append(toks_out)
        out["logits"].append(logits)
        if mesh is not None:
            pos = next(v["pos"] for v in cache["layers"].values()
                       if "pos" in v)[0]
            seen = ((pos[None, :] >= 0) & (pos[None, :] >= start[:, None])
                    & (pos[None, :] < cache["cur"]))
            out.setdefault("rows_seen", []).append(int(seen.any(1).sum()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, tok, cache, delta=overlay, eid=eid,
                              decode_attn=attn)
            torch.cuda.synchronize(dev)
        out.setdefault("combine", []).append(collectives_of(prof))
        del cache
    out["launches"] = ops.launch_counts()
    return out


def within_sp_child(torch, case, spec, dev, experts) -> tuple[dict, dict]:
    """One rank of a sequence-parallel decode case on an f32 copy of the
    4-unit model: (JSON results, tensors: the first step's logits)."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build as build_model
    mesh = make_production_mesh(shape=SP_CASES[case]["shape"],
                                device="cuda")
    cfg = dataclasses.replace(get_config("qwen2_5_3b"),
                              n_units=spec["units"])
    model = build_model(cfg)
    m32, b32 = f32_copy(torch, model, model.init(seed=spec["seed"],
                                                 device=dev))
    free_all(torch)
    reg = api.registry(device=dev, device_cache_bytes=16 << 30,
                       experts=experts)
    with open(os.path.join(spec["setup"], "traffic.json")) as f:
        traffic = json.load(f)["p3"]
    res = sp_decode(torch, m32, b32, reg,
                    sp_prompts(torch, traffic, case, cfg.vocab, dev), case,
                    dev, mesh=mesh)
    first = res.pop("first")
    res.pop("logits")
    reg.close()
    del m32, b32, reg
    free_all(torch)
    return dict(res, case=case), {"first": first}


def within_child(torch, spec, dev, experts) -> list:
    """A phase 3w rank: its within-pod train steps and its
    sequence-parallel decode case, in one world; in the world of four,
    first part (c)'s MoE steps (``spec["moe_ref"]``), while the card
    holds nothing of the other cases; in the world of two, first part
    (d)'s full-width mamba mixer, then part (e)'s qwen2.5-3b serving on
    (1, 1, 2); in part (d)'s world of four
    (``spec["family_refs"]``), its families alone."""
    if spec.get("family_refs"):
        return [within_family_child(torch, name, spec, dev)
                for name in FAMILY_CASES]
    res = []
    if spec.get("moe_ref") and spec["world"] == 4:
        res += [within_moe_child(torch, name, ep, spec, dev)
                for name, ep in MOE_CASES]
    if spec["world"] == 2 and spec.get("mamba"):
        res.append(dict(within_mamba_child(torch, spec, dev),
                        name="mamba_mixer"))
        res.append(qwen_serve_child(torch, spec, dev))
    for name, shape, f32 in WITHIN_TRAIN:
        if shape[0] * shape[1] * shape[2] == spec["world"]:
            res.append(within_train_child(torch, name, shape, f32, spec,
                                          dev))
    for case, c in SP_CASES.items():
        if c["shape"][0] * c["shape"][1] == spec["world"]:
            out, tensors = within_sp_child(torch, case, spec, dev, experts)
            torch.save(tensors, spec["out"] + f".{case}.pt")
            res.append(out)
    return res


def within_oracle(torch, seed, shape, dev) -> dict:
    """The within-pod step's one-process version
    (``within_pod.within_pod_in_one_process``) over the same steps:
    digests of every rank's blocks and the losses."""
    from repro_torch.configs import get_config
    from repro_torch.core.gradient_compression import GradCompressionConfig
    from repro_torch.models import build as build_model
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import within_pod as wp
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_units=1,
                              dtype="bfloat16")
    model = build_model(cfg)
    tcfg = within_tcfg(TrainConfig, GradCompressionConfig)
    state = init_train_state(model.init(seed=seed, device=dev), tcfg,
                             multi_pod=shape[0] > 1)
    sizes = dict(zip(("pod", "data", "model"), shape))
    mesh = wp.AxisSizes(sizes)
    states = {c: wp.shard_train_state(state, cfg, mesh, dict(zip(sizes, c)))
              for c in wp._coords(sizes)}
    del state
    losses = []
    with torch.enable_grad():
        for batch in within_batches(torch, cfg, shape, dev):
            res = wp.within_pod_in_one_process(model, tcfg, shape, states,
                                               batch)
            states = {c: r[0] for c, r in res.items()}
            losses.append(float(res[wp._coords(sizes)[0]][1]["loss"]))
    out = {"digest": [tree_digest(torch, states[c])
                      for c in wp._coords(sizes)], "losses": losses}
    del states
    free_all(torch)
    return out


def sp_gates(torch, what, got_first, got_tokens, ref) -> dict:
    """A mesh run's first decode step's logits within SP_LOGIT_TOL of the
    largest |logit| of the mesh-free run's, and its greedy tokens equal
    up to a near-tie: where a row first parts, both tokens within about
    one bf16 ulp of the top logit (2**-7 * |top|) of the mesh-free step
    there."""
    worst, ties = 0.0, []
    for w, (first, want) in enumerate(zip(got_first, ref["first"])):
        err = float((first - want).abs().max())
        worst = max(worst, err / float(want.abs().max()))
        for b in range(want.shape[0]):
            a = [t[b] for t in got_tokens[w]]
            e = [t[b] for t in ref["tokens"][w]]
            if a == e:
                continue
            s = next(i for i, (x, y) in enumerate(zip(a, e)) if x != y)
            lg = ref["logits"][w][s][b]
            top = float(lg.max())
            gaps = (top - float(lg[a[s]]), top - float(lg[e[s]]))
            tol = 2.0 ** -7 * abs(top)
            ties.append({"wave": w, "row": b, "step": s, "gaps": gaps,
                         "tol": tol})
            check(max(gaps) <= tol, f"phase 3w {what}: wave {w} row {b} "
                  f"parts at step {s} beyond a near-tie: {gaps} > {tol}")
    check(worst <= SP_LOGIT_TOL, f"phase 3w {what}: first decode step's "
          f"logits off by {worst:.3e} of the largest |logit|")
    return {"first_logits_rel_err": worst, "near_ties": ties}


def within_phase(torch, api, model, base, reg, experts, reqs, args):
    """Phase 3w with its log lines and timing -> (report, launches)."""
    log("phase 3w: training inside a pod ((a) (1, 2, 1) FSDP, (1, 1, 2) "
        "tensor parallelism on an f32 copy, (2, 2, 1) with compressed pods; "
        "(c) mixtral at full width on (1, 2, 2), experts cut on d_ff and on "
        "E; (d) rwkv6, internvl2, seamless and jamba on (1, 2, 2), a "
        "full-width jamba mamba mixer on (1, 1, 2); (e) prefill and decode "
        "on the cut weights before (a)'s (1, 1, 2), (c)'s and (d)'s steps) "
        "and (b) sequence-parallel decode ((1, 2) and (2, 2)), ranks as "
        "gloo processes on the card")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="_artifacts_", dir=ROOT) as tmp:
        within, launches = within_path(torch, api, model, base, reg,
                                       experts, reqs, args.seed, args.units,
                                       tmp)
    within["phase_s"] = time.monotonic() - t0
    log(f"  launches on the decode runs (rank 0): "
        f"{ {k: v for k, v in launches.items() if v} }; phase 3w took "
        f"{within['phase_s']:.1f} s [{gpu_line()}]")
    return within, launches


def within_path(torch, api, model, base, reg, experts, reqs, seed, units,
                tmp) -> tuple[dict, dict]:
    """Phase 3w: the within-pod train step ((1, 2, 1) FSDP and (1, 1, 2)
    tensor parallelism on two ranks, (2, 2, 1) with compressed pods on
    four), mixtral's experts and the other families on (1, 2, 2), a
    full-width mamba mixer on (1, 1, 2), and sequence-parallel decode
    ((1, 2) and (2, 2)), every rank a gloo process on the card.  Returns (report, kernel launches of rank 0
    on the decode runs)."""
    from repro_torch.kernels import ops
    traffic = {"p3": traffic_rows(reqs)}
    setup = mesh_setup(torch, experts, traffic, tmp)
    spec = {"op": "within", "setup": setup, "seed": seed, "units": units}
    out: dict = {"gpu": gpu_line()}
    dev = base["embed"].device
    # part (c)'s mesh-free step first, while no rank holds the card (50
    # GB); its final parameters go to a file for the world of four
    t0 = time.monotonic()
    ref_path = os.path.join(tmp, "moe_mesh_free.pt")
    moe_ref = mesh_free_reference(torch, moe_config(False), seed, dev,
                                  ref_path, MOE_SHAPE, MOE_STEPS,
                                  serve_name="mixtral")
    # part (e)'s mesh-free runs (tensors: kept here, not sent to ranks)
    serve_refs = {"mixtral": moe_ref.pop("serve")}
    out["moe_mesh_free"] = dict(moe_ref, seconds=time.monotonic() - t0)
    log(f"phase 3w (c) mesh-free mixtral, 1 unit at full width, f32, "
        f"{moe_ref['n_params']} parameters: losses {moe_ref['losses']}; "
        f"step s {[round(x, 3) for x in moe_ref['step_s']]}; state bytes "
        f"{moe_ref['state_bytes']} (experts {moe_ref['expert_bytes']} of "
        f"parameters); peak {moe_ref['peak_gib']:.2f} GiB [{gpu_line()}]")
    # part (d)'s world of four (at most 8 GiB a rank) starts now; each
    # rank reads its configurations' mesh-free parameters when this
    # process has written them (``family_references``, beside it)
    hf = start_ranks(dict(spec, family_refs={
        name: family_ref_path(tmp, name) for name in FAMILY_CASES}), 4,
        "gloo", [0] * 4, tmp, "within_family", timeout=900)
    t0 = time.monotonic()
    family_refs = family_references(torch, seed, dev, tmp)
    out["family_mesh_free_s"] = time.monotonic() - t0
    serve_refs.update((name, ref.pop("serve"))
                      for name, ref in family_refs.items())
    for name, ref in family_refs.items():
        log(f"phase 3w (d) mesh-free {name} ({ref['n_params']} "
            f"parameters, f32): losses {ref['losses']}; gradient norms "
            f"{ref['grad_norms']}; step s "
            f"{[round(x, 3) for x in ref['step_s']]}; state bytes "
            f"{ref['state_bytes']}; peak {ref['peak_gib']:.2f} GiB "
            f"[{gpu_line()}]")
    # the world of two (about 9 GiB a rank) beside it, while this process
    # takes the decode references (a few GB)
    h2 = start_ranks(dict(spec, mamba=True), 2, "gloo", [0, 0], tmp,
                     "within2", timeout=900)
    # the mesh-free decode references on the f32 copy
    m32, b32 = f32_copy(torch, model, base)
    refs = {}
    for case in SP_CASES:
        t0 = time.monotonic()
        refs[case] = sp_decode(torch, m32, b32, reg, sp_prompts(
            torch, traffic["p3"], case, model.cfg.vocab, dev), case, dev,
            keep_logits=True)
        out[f"{case}_mesh_free"] = {
            "decode_ms_per_step": sum(refs[case]["step_ms"][1:])
            / max(len(refs[case]["step_ms"]) - 1, 1),
            "seconds": time.monotonic() - t0}
    serve_refs["qwen"] = serve_reference(torch, m32, b32, "qwen", dev)
    del m32, b32
    free_all(torch)
    results = {2: wait_ranks(h2)}
    out["world2_s"] = time.monotonic() - h2["t0"]
    by_family = [{r["name"]: r for r in rank} for rank in wait_ranks(hf)]
    out["family_world_s"] = time.monotonic() - hf["t0"]
    out["parent_gib"] = {"card_free": torch.cuda.mem_get_info()[0] / 2**30,
                         "allocated": torch.cuda.memory_allocated() / 2**30,
                         "reserved": torch.cuda.memory_reserved() / 2**30}
    log(f"  this process holds {out['parent_gib']} GiB while the ranks run")
    launches = {k: 0 for k in ops.launch_counts()}
    t0 = time.monotonic()
    results[4] = run_ranks(torch, dict(spec, moe_ref=ref_path), 4, "gloo",
                           [0] * 4, tmp, "within4", timeout=900)
    out["world4_s"] = time.monotonic() - t0
    for world, res in results.items():
        by = [{r["name"] if "name" in r else r["case"]: r for r in rank}
              for rank in res]
        if world == 4:
            by4 = by
        for name, shape, f32 in WITHIN_TRAIN:
            if name not in by[0]:
                continue
            ranks = [b[name] for b in by]
            for r in ranks[1:]:
                check(r["losses"] == ranks[0]["losses"], f"phase 3w train "
                      f"{shape}: ranks' losses differ")
            rep = {"shape": list(shape), "f32": f32,
                   "losses": ranks[0]["losses"],
                   "step_s": [r["step_s"] for r in ranks],
                   "state_bytes": [r["state_bytes"] for r in ranks],
                   "peak_gib": [r["peak_gib"] for r in ranks],
                   "mesh_free_state_bytes": ranks[0]["mesh_free_state_bytes"],
                   "collectives": [r["collectives"] for r in ranks]}
            if shape[2] == 1:
                t1 = time.monotonic()
                oracle = within_oracle(torch, seed, shape, dev)
                out[f"oracle_{name}_s"] = time.monotonic() - t1
                for r, got in enumerate(ranks):
                    check(got["digest"] == oracle["digest"][r],
                          f"phase 3w train {shape}: rank {r}'s blocks "
                          "differ from the oracle's")
                check(ranks[0]["losses"] == oracle["losses"],
                      f"phase 3w train {shape}: losses "
                      f"{ranks[0]['losses']} != {oracle['losses']}")
                rep["bitwise_oracle"] = True
            else:
                worst = max(r["max_param_diff"] for r in ranks)
                check(worst <= WITHIN_PARAM_TOL, f"phase 3w train {shape}: "
                      f"parameters {worst:.3e} from the mesh-free step")
                rep["max_param_diff"] = worst
                rep["plain_losses"] = ranks[0]["plain_losses"]
            out[f"train_{name}"] = rep
            log(f"phase 3w train {shape}{' f32' if f32 else ''}: losses "
                f"{rep['losses']}; step s rank 0 "
                f"{[round(x, 3) for x in rep['step_s'][0]]}; state bytes a "
                f"rank {rep['state_bytes']} vs mesh-free "
                f"{rep['mesh_free_state_bytes']}; peak GiB a rank "
                f"{[round(x, 2) for x in rep['peak_gib']]}; "
                + ("bitwise the oracle" if "bitwise_oracle" in rep else
                   f"max |param diff| {rep['max_param_diff']:.3e}")
                + f" [{gpu_line()}]")
        for case, c in SP_CASES.items():
            if case not in by[0]:
                continue
            ranks = [b[case] for b in by]
            for r in ranks[1:]:
                check(r["tokens"] == ranks[0]["tokens"], f"phase 3w sp "
                      f"{case}: ranks' tokens differ")
            firsts = [torch.load(os.path.join(
                tmp, f"within{world}_rank{r}.json.out.{case}.pt"))["first"]
                for r in range(world)]
            gates = sp_gates(torch, f"sp {case} {c['shape']}", firsts[0],
                             ranks[0]["tokens"], refs[case])
            for f in firsts[1:]:
                check(all(torch.equal(a, b) for a, b in zip(f, firsts[0])),
                      f"phase 3w sp {case}: ranks' logits differ")
            seen = [sum(r["rows_seen"]) for r in ranks]
            check(min(seen) > 0, f"phase 3w sp {case}: a rank's ring slice "
                  f"held no position a row attends to (rows per rank "
                  f"{seen}): its partials were all empty")
            name = "ternary_matmul_grouped"
            check(ranks[0]["launches"][name] > 0,
                  f"phase 3w sp {case}: {name} was not launched")
            for k, n in ranks[0]["launches"].items():
                launches[k] += n
            steps = ranks[0]["step_ms"]
            rep = dict(gates, shape=list(c["shape"]), ranks=world,
                       cache_len=c["cache_len"], steps=c["steps"],
                       decode_ms_per_step=sum(steps) / len(steps),
                       combine=ranks[0]["combine"],
                       rows_seen=[r["rows_seen"] for r in ranks],
                       launches=ranks[0]["launches"])
            out[f"sp_{case}"] = rep
            log(f"phase 3w sp decode {case} on {c['shape']} ({world} ranks, "
                f"cache_len {c['cache_len']}): first-step logits within "
                f"{gates['first_logits_rel_err']:.2e} of the largest, "
                f"{len(gates['near_ties'])} near-ties; rows with a "
                f"non-empty partial per rank and wave {rep['rows_seen']}; "
                f"decode "
                f"{rep['decode_ms_per_step']:.2f} ms a step (mesh-free "
                f"{out[case + '_mesh_free']['decode_ms_per_step']:.2f}); "
                f"combine {ranks[0]['combine'][0]} [{gpu_line()}]")
    # part (c): the first cases of the world of four
    for name, ep in MOE_CASES:
        ranks = [b[name] for b in by4]
        gates = step_gates(torch, moe_ref, ranks, name)
        rep = dict(gates, shape=list(MOE_SHAPE), expert_parallel=ep,
                   losses=ranks[0]["losses"],
                   mesh_free_losses=moe_ref["losses"],
                   grad_norms=ranks[0]["grad_norms"],
                   mesh_free_grad_norms=moe_ref["grad_norms"],
                   step_s=[r["step_s"] for r in ranks],
                   state_bytes=[r["state_bytes"] for r in ranks],
                   mesh_free_state_bytes=moe_ref["state_bytes"],
                   expert_bytes=[r["expert_bytes"] for r in ranks],
                   mesh_free_expert_bytes=moe_ref["expert_bytes"],
                   expert_shapes=ranks[0]["expert_shapes"],
                   peak_gib=[r["peak_gib"] for r in ranks],
                   card_free_gib=[r["card_free_gib"] for r in ranks],
                   collectives=[r["collectives"] for r in ranks])
        out[f"train_{name}"] = rep
        log(f"phase 3w (c) {name} on {MOE_SHAPE} (mixtral, 1 unit at "
            f"full width, f32, experts cut on "
            f"{'E' if ep else 'd_ff'} over 'model'): losses "
            f"{rep['losses']} (mesh-free {rep['mesh_free_losses']}); "
            f"gradient norms {rep['grad_norms']} (mesh-free "
            f"{rep['mesh_free_grad_norms']}, largest relative gap "
            f"{gates['grad_norm_rel_gap']:.2e}); "
            f"max |param diff| {gates['max_param_diff']:.3e}; step s "
            f"a rank {[[round(x, 3) for x in r] for r in rep['step_s']]}"
            f" (the last profiled); state bytes a rank "
            f"{rep['state_bytes']} vs mesh-free "
            f"{rep['mesh_free_state_bytes']}; expert bytes a rank "
            f"{rep['expert_bytes']} vs {rep['mesh_free_expert_bytes']}; "
            f"expert leaves {rep['expert_shapes']}; peak GiB a rank "
            f"{[round(x, 2) for x in rep['peak_gib']]} (card free GiB "
            f"at the start and after the cut {rep['card_free_gib']}); "
            f"collectives of the profiled step {rep['collectives']} "
            f"[{gpu_line()}]")
    # part (d): the families on (1, 2, 2), the mixer on (1, 1, 2)
    for name in FAMILY_CASES:
        ref = family_refs[name]
        ranks = [b[name] for b in by_family]
        gates = family_gates(torch, ref, ranks, name)
        rep = dict(gates, shape=list(FAMILY_SHAPE),
                   losses=ranks[0]["losses"], mesh_free_losses=ref["losses"],
                   grad_norms=ranks[0]["grad_norms"],
                   mesh_free_grad_norms=ref["grad_norms"],
                   step_s=[r["step_s"] for r in ranks],
                   mesh_free_step_s=ref["step_s"],
                   state_bytes=[r["state_bytes"] for r in ranks],
                   mesh_free_state_bytes=ref["state_bytes"],
                   peak_gib=[r["peak_gib"] for r in ranks],
                   mesh_free_peak_gib=ref["peak_gib"],
                   model_cut_leaves=ranks[0]["model_cut"],
                   collectives=[r["collectives"] for r in ranks])
        out[f"train_{name}"] = rep
        log(f"phase 3w (d) {name} on {FAMILY_SHAPE} (f32, "
            f"{ref['n_params']} parameters, {rep['model_cut_leaves']} "
            f"state leaves of a rank cut over 'model'): losses "
            f"{rep['losses']} (mesh-free {rep['mesh_free_losses']}); "
            f"gradient norms {rep['grad_norms']} (mesh-free "
            f"{rep['mesh_free_grad_norms']}, largest relative gap "
            f"{gates['grad_norm_rel_gap']:.2e}); max |param diff| "
            f"{gates['max_param_diff']:.3e}; step s a rank "
            f"{[[round(x, 3) for x in r] for r in rep['step_s']]} (the "
            f"last profiled; mesh-free "
            f"{[round(x, 3) for x in ref['step_s']]}; beside this "
            f"process's references and the world of two); state bytes "
            f"a rank "
            f"{rep['state_bytes']} vs mesh-free "
            f"{rep['mesh_free_state_bytes']}; peak GiB a rank "
            f"{[round(x, 2) for x in rep['peak_gib']]} (mesh-free "
            f"{ref['peak_gib']:.2f}); collectives of the profiled step "
            f"{rep['collectives']} [{gpu_line()}]")
    ranks = [next(r for r in rank if r.get("name") == "mamba_mixer")
             for rank in results[2]]
    gates = mamba_gates(ranks)
    out["mamba_mixer"] = dict(gates, ranks=ranks, shape=list(MAMBA_SHAPE))
    log(f"phase 3w (d) jamba mamba mixer at full width on {MAMBA_SHAPE} "
        f"({ranks[0]['n_params']} parameters, f32, {MAMBA_ROWS} x "
        f"{MAMBA_T} tokens): output and gradients within "
        f"{gates['max_rel_err']:.2e} of the whole mixer's largest; rank "
        f"0 holds {ranks[0]['shapes']}; forward and backward s cut "
        f"{[round(x, 3) for x in ranks[0]['seconds']['cut']]} (the first "
        f"cold), whole {[round(x, 3) for x in ranks[0]['seconds']['whole']]}"
        f"; peak GiB a rank {[round(r['peak_gib'], 2) for r in ranks]}; "
        f"collectives of a profiled cut pass {ranks[0]['collectives']} "
        f"[{gpu_line()}]")
    # part (e): serving inside a pod before the AdamW steps, every world
    serving = [("qwen", "qwen", SERVE_QWEN_SHAPE, "within2",
                [next(r for r in rank if r.get("name") == "serve_qwen")
                 for rank in results[2]])]
    serving += [(name, "mixtral", MOE_SHAPE, "within4",
                 [b[name]["serve"] for b in by4]) for name, _ in MOE_CASES]
    serving += [(name, name, FAMILY_SHAPE, "within_family",
                 [b[name]["serve"] for b in by_family])
                for name in FAMILY_CASES]
    for name, ref_name, shape, world, ranks in serving:
        firsts = [torch.load(os.path.join(
            tmp, f"{world}_rank{r}.json.out.serve_{name}.pt"))
            for r in range(len(ranks))]
        gates = serve_gates(torch, name, ranks, firsts, serve_refs[ref_name])
        out[f"serve_{name}"] = serve_report(name, shape, ranks,
                                            serve_refs[ref_name], gates)
    os.remove(ref_path)
    return out, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--units", type=int, default=2,
                    help="repeat units (layers) of qwen2.5-3b, 1..36")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-child", help=argparse.SUPPRESS)
    ap.add_argument("--stop-after",
                    choices=("kernels", "training", "configs", "families",
                             "mesh", "within", "long", "all"),
                    default="all", help="end after phase 2 (kernels: a "
                    "first build and correctness check of new kernels), "
                    "after phases 3 and 3t (training: a quick check of the "
                    "training path), or after phases 3 and 3e (configs: a "
                    "quick check of the full-width configurations; "
                    "families: after phases 3 and 3f; mesh: after phases "
                    "3, 3d and 3m; within: after phases 3 and 3w; long: "
                    "after phases 3 and 3l)")
    args = ap.parse_args(argv)
    if args.mesh_child:
        return mesh_child(args.mesh_child)
    if not 1 <= args.units <= 36:
        ap.error("--units must be in 1..36")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api, tree as tree_util
    from repro_torch.configs import get_config
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
    # its own generator: the experts below draw from ``gen`` exactly as
    # before the merge kernels were checked here
    check_merge_kernels(torch, base["embed"], torch.Generator(
        device=dev).manual_seed(args.seed + 1), dev, report)
    check_artifact_kernels(torch, cfg, torch.Generator(
        device=dev).manual_seed(args.seed + 2), dev, report)
    check_sampler(torch, dev, report)
    if args.stop_after == "kernels":
        log(json.dumps({"kernels_checked": report}))
        return 0

    log("phase 3: mixed path (compress 4 experts, serve 8 requests)")
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
    engine = api.serve(model, base, reg, max_batch=4, cache_len=128,
                       decode_chunk=8, continuous=False)
    reqs = make_requests(torch, cfg, args.seed)
    engine.run(reqs)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grouped_per_wave = launches["ternary_matmul_grouped"] / len(
        engine.wave_log)
    log(f"  launches on the mixed path: {launches}")
    for name in MIXED_PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the mixed path")

    if args.stop_after == "long":
        long, long_launches = long_phase(torch, api, model, base, reg, cfg,
                                         args.seed, dev)
        with open(os.path.join(out_dir, "chip_smoke_long.json"), "w") as f:
            json.dump({"gpu": gpu, "long": long, "launches": long_launches},
                      f, indent=1)
        return 0

    if args.stop_after == "configs":
        wide, wide_launches = wide_phase(torch, api, args.seed, dev, out_dir)
        with open(os.path.join(out_dir, "chip_smoke_configs.json"),
                  "w") as f:
            json.dump({"gpu": gpu, "wide_configs": wide,
                       "launches": wide_launches}, f, indent=1)
        return 0

    if args.stop_after == "families":
        fams, fam_launches = family_phase(torch, api, args.seed, dev,
                                          out_dir)
        with open(os.path.join(out_dir, "chip_smoke_families.json"),
                  "w") as f:
            json.dump({"gpu": gpu, "families": fams,
                       "launches": fam_launches}, f, indent=1)
        return 0

    if args.stop_after == "training":
        trained, train_launches = training_phase(
            torch, api, model, base, experts, reqs, cfg, args.seed, dev)
        with open(os.path.join(out_dir, "chip_smoke_training.json"),
                  "w") as f:
            json.dump({"gpu": gpu, "trained": trained,
                       "launches": train_launches}, f, indent=1)
        log(json.dumps({k: v for k, v in trained.items()
                        if k != "grad_compression"}))
        return 0

    # phase 3w before the later phases' engines fill the card: its four
    # ranks share it with this process
    within, within_launches = within_phase(torch, api, model, base, reg,
                                           experts, reqs, args)
    if args.stop_after == "within":
        with open(os.path.join(out_dir, "chip_smoke_within.json"),
                  "w") as f:
            json.dump({"gpu": gpu, "within": within,
                       "launches": within_launches}, f, indent=1)
        return 0

    log("phase 3b: merge path (the same 8 requests by merge-on-swap, then "
        "a merged ensemble of e0-e2)")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gengine = api.serve(model, base, reg, scheduling="grouped", max_batch=4,
                        cache_len=128, decode_chunk=8)
    greqs = fresh(reqs, 400)
    gengine.run(greqs)
    merge_launches = ops.launch_counts()
    log(f"  launches on the merge path: {merge_launches}")
    check(merge_launches["unpack_add_many"] > 0,
          "unpack_add_many was not launched on the merge path")
    ops.reset_launch_counts()
    ens_names, ens_w = ["e0", "e1", "e2"], [0.5, 1.0, 0.25]
    ens = gengine.merged_ensemble_params(ens_names, ens_w)
    ens_launches = ops.launch_counts()
    log(f"  launches by the merged ensemble: {ens_launches}")
    check(ens_launches["unpack_add_many"] > 0,
          "unpack_add_many was not launched by the merged ensemble")
    # the ensemble's oracle, a loop of single merges: a check, not a path
    # (no path of the port calls unpack_add), so its launches are kept apart
    ops.reset_launch_counts()
    ens_loop = ensemble_loop(torch, reg, base, ens_names, ens_w)
    check_launches = ops.launch_counts()
    gpeak = torch.cuda.max_memory_allocated()
    log(f"  launches by the ensemble's loop check: {check_launches}")
    check(check_launches["unpack_add"] > 0,
          "unpack_add was not launched by the ensemble's loop check")

    log("phase 3d: continuous admission (16 requests, slot refill, "
        "max_batch 4, cache_len 256, decode_chunk 8)")
    rengine, rreqs, refill_launches, refill = refill_path(
        torch, api, model, base, reg, cfg, args.seed)
    log(f"  launches on the refill path: {refill_launches}")
    check(refill_launches["ternary_matmul_grouped"] > 0,
          "ternary_matmul_grouped was not launched on the refill path")
    refill["f32"] = f32_refill(torch, api, model, base, reg, rreqs)

    # phase 3m's ranks serve and train while this process runs phase 3c
    log("phase 3m: the serving mesh (ranks as processes: (2, 1) and (1, 2) "
        "over gloo on the card, (1, 1) under NCCL) and the compressed "
        "multi-pod step; its ranks start now and run beside phase 3c")
    with tempfile.TemporaryDirectory(prefix="_artifacts_",
                                     dir=ROOT) as mesh_tmp:
        mesh_run = mesh_start(torch, experts, reqs, rreqs, args.seed,
                              args.units, mesh_tmp)

        log("phase 3c: artifact path (exact compression, save / load, "
            "cold-Golomb serve, similarity, merges), beside phase 3m's "
            "ranks")
        with tempfile.TemporaryDirectory(prefix="_artifacts_",
                                         dir=ROOT) as tmp:
            art, art_launches, matvec_launches = artifact_path(
                torch, api, model, base, experts, reqs, cfg, dev, tmp,
                before_merges=lambda: mesh_wait(mesh_run))
        log(f"  launches on the artifact path: {art_launches}")
        for name in ARTIFACT_PATH_KERNELS:
            check(art_launches[name] > 0,
                  f"kernel {name} was not launched on the artifact path")
        check(matvec_launches["ternary_matmul"] > 0,
              "ternary_matmul was not launched by the ternary_matvec check")

        log("phase 3m: the mesh-free references and every world's results")
        t0 = time.monotonic()
        mesh, mesh_launches = mesh_path(torch, api, model, base, reg,
                                        engine, reqs, rreqs, mesh_run)
    mesh["phase_s"] = time.monotonic() - t0
    mesh["ranks_s"] = time.monotonic() - mesh_run["t0"]
    log(f"  launches on the mesh runs (rank 0): "
        f"{ {k: v for k, v in mesh_launches.items() if v} }; phase 3m took "
        f"{mesh['phase_s']:.1f} s after phase 3c ({mesh['ranks_s']:.1f} s "
        f"from its ranks' start) [{gpu}]")
    if args.stop_after == "mesh":
        with open(os.path.join(out_dir, "chip_smoke_mesh.json"), "w") as f:
            json.dump({"gpu": gpu, "mesh": mesh,
                       "launches": mesh_launches}, f, indent=1)
        return 0

    wide, wide_launches = wide_phase(torch, api, args.seed, dev, out_dir)
    fams, fam_launches = family_phase(torch, api, args.seed, dev, out_dir)

    sampled, sampled_launches = {}, {}
    for top_k in (40, 0):
        log(f"phase 3s: sampled refill traffic (16 requests, temperature "
            f"0.8, top_k {top_k})")
        _, _, sampled_launches[top_k], sampled[top_k] = sampled_path(
            torch, api, model, base, reg, rreqs, top_k)

    log("phase 3p: paged KV under fifo, priority and affinity (24 "
        "requests, max_batch 4, cache_len 256, kv_block_size 16, "
        "decode_chunk 8)")
    t0 = time.monotonic()
    paged_launches, paged = paged_path(torch, api, model, base, reg, cfg,
                                       args.seed, out_dir)
    paged["phase_s"] = time.monotonic() - t0
    log(f"  launches on the paged path: {paged_launches}; phase 3p took "
        f"{paged['phase_s']:.1f} s")

    log("phase 3r: remote tiers (PACKED blobs over a directory, loopback "
        "HTTP and a replicated fleet with faults; capture under prefetch; "
        "blackout)")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="_artifacts_", dir=ROOT) as tmp:
        remote, remote_launches = remote_path(
            torch, api, model, base, reg, experts, reqs, greqs,
            grouped_per_wave, art, tmp)
    remote["phase_s"] = time.monotonic() - t0
    log(f"  launches on the remote paths: {remote_launches}; phase 3r took "
        f"{remote['phase_s']:.1f} s")
    for name in ("ternary_matmul_grouped", "unpack_add_many"):
        check(remote_launches[name] > 0,
              f"kernel {name} was not launched on the remote paths")

    log("phase 3k: kill and resume (journal, a snapshot per chunk, "
        "resume warm and fresh, paged sampled affinity, journal only, a "
        "SIGKILL child; bf16, then an f32 copy)")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="_artifacts_", dir=ROOT) as tmp:
        durable_launches, durable = durability_path(
            torch, api, model, base, reg, experts, cfg, args.seed,
            args.units, tmp)
    durable["phase_s"] = time.monotonic() - t0
    log(f"  launches on the durability path: {durable_launches}; phase 3k "
        f"took {durable['phase_s']:.1f} s")

    trained, train_launches = training_phase(torch, api, model, base,
                                             experts, reqs, cfg, args.seed,
                                             dev)
    long, long_launches = long_phase(torch, api, model, base, reg, cfg,
                                     args.seed, dev)

    log("phase 4: checks")
    for r in reqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.uid}: bad tokens {r.out_tokens}")
    details["planes_e0"] = planes_check(torch, experts[0])
    tau = experts[0].as_(DENSE)
    details["compress_profile"] = profile_compress(torch, tau, out_dir)
    experts[0].drop(DENSE)
    del tau

    for w in (reqs[:4], reqs[4:]):
        row_independence_check(torch, engine, w)
    log("  every row's tokens are bitwise unchanged when the other rows of "
        "its wave carry BASE instead of their experts")
    details["solo"] = solo_check(torch, engine, reqs)
    # bf16: reported (admitted rows sit at other rope positions than a
    # solo serve's); the gate is the f32 copy's, in phase 3d
    details["refill_solo"] = solo_check(torch, rengine, rreqs, gate=False)
    details["logits"] = logits_check(torch, engine, reqs[:4])

    # the merge path
    for r in greqs:
        check(len(r.out_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"merge path request {r.uid}: bad tokens {r.out_tokens}")
    gsum = gengine.swap_summary()
    check(gsum["n_swaps"] == 4 and gsum["n_waves"] == 0,
          f"merge path: {gsum['n_swaps']} swaps and {gsum['n_waves']} mixed "
          "waves, expected 4 and 0")
    merged_params_check(torch, reg, base, [f"e{i}" for i in range(4)])
    for (path, g), (_, w) in zip(tree_util.flatten_with_paths(ens),
                                 tree_util.flatten_with_paths(ens_loop)):
        check(torch.equal(bits(torch, g), bits(torch, w)),
              f"ensemble {path}: differs from the loop of single merges")
    del ens, ens_loop
    log("  merged ensemble of e0-e2 (weights 0.5, 1.0, 0.25) bitwise equal "
        "to a loop of apply_ternary_delta_flat over the scaled experts")
    preqs = fresh(reqs, 600)
    with ops.plain_versions():
        api.serve(model, base, reg, scheduling="grouped", max_batch=4,
                  cache_len=128, decode_chunk=8).run(preqs)
    check([r.out_tokens for r in preqs] == [r.out_tokens for r in greqs],
          "merge path: tokens differ from the same run on the plain "
          "versions")
    log("  merge path: 4 swaps, 0 mixed waves; tokens bitwise equal to the "
        "same run on the plain versions")
    details["merge_effect"] = merge_effect_check(torch, engine, gengine,
                                                 [reqs[0], reqs[1]])

    log("phase 5: numbers")
    # a second, warm run of the same requests: the timed one (the first
    # paid one-time setup such as cuBLAS handles); it must repeat exactly
    timed = fresh(reqs, 200)
    n0 = len(engine.wave_log)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.run(timed)
    serve_s = time.monotonic() - t0
    waves = engine.wave_log[n0:]
    check([r.out_tokens for r in timed] == [r.out_tokens for r in reqs],
          "a second run of the same requests gave other tokens")
    grouped_timing(torch, engine, reqs[:4], report)
    gtimed = fresh(reqs, 700)
    b0, s0 = len(gengine.batch_log), len(gengine.swap_log)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    gengine.run(gtimed)
    gserve_s = time.monotonic() - t0
    check([r.out_tokens for r in gtimed] == [r.out_tokens for r in greqs],
          "a second merge-path run of the same requests gave other tokens")
    batches = gengine.batch_log[b0:]
    swaps = list(gengine.swap_log)[s0:]
    details["profile"] = profile_wave(torch, engine, reqs[:4], out_dir)
    # phase 3's wave sampled (temperature 0.8, top_k 40): its cold run
    # captures the graphs, the warm one is timed like the greedy one
    sengine = api.serve(model, base, reg, max_batch=4, cache_len=128,
                        decode_chunk=8, continuous=False, top_k=40,
                        **SAMPLING)
    sengine.run(fresh(reqs, 0))
    n0 = len(sengine.wave_log)
    torch.cuda.synchronize()
    sengine.run(fresh(reqs, 0))
    swaves = sengine.wave_log[n0:]
    details["sampled_profile"] = profile_wave(torch, sengine, reqs[:4],
                                              out_dir, "profile_sampled")
    check(details["sampled_profile"]["topk_launches"] == 0,
          "the sampled wave launched torch.topk kernels: the sampler is one "
          "fused launch a step")
    del sengine
    rtimed = fresh(rreqs, 3000)
    c0, rw0 = rengine.swap_summary()["graph_captures"], len(rengine.wave_log)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rengine.run(rtimed)
    torch.cuda.synchronize()
    refill_s = time.monotonic() - t0
    rwaves = rengine.wave_log[rw0:]
    check([r.out_tokens for r in rtimed] == [r.out_tokens for r in rreqs],
          "a second run of the refill traffic gave other tokens")
    check(rengine.swap_summary()["graph_captures"] == c0,
          "a warm run of the refill traffic captured a graph")
    details["refill_profile"] = profile_wave(torch, rengine, rreqs, out_dir,
                                             "profile_refill")
    kernels = []
    for name, src, replaces in (
            ("ternary_matmul_grouped", "src/repro_torch/kernels/csrc/"
             "ternary_matmul.cu", "src/repro/kernels/ternary_matmul.py:150"),
            ("pack_ternary_planes_segmented", "src/repro_torch/kernels/"
             "csrc/pack.cu", "src/repro/kernels/pack.py:102"),
            ("segment_hist_moments", "src/repro_torch/kernels/csrc/"
             "histogram.cu", "src/repro/kernels/histogram_quantile.py:151"),
            ("segment_absmax", "src/repro_torch/kernels/csrc/histogram.cu",
             "src/repro/kernels/histogram_quantile.py:283"),
            ("unpack_add_many", "src/repro_torch/kernels/csrc/unpack_add.cu",
             "src/repro/kernels/unpack_add.py:112"),
            ("unpack_add", "src/repro_torch/kernels/csrc/unpack_add.cu",
             "src/repro/kernels/unpack_add.py:65"),
            ("ternary_matmul", "src/repro_torch/kernels/csrc/"
             "ternary_matmul.cu", "src/repro/kernels/ternary_matmul.py:76"),
            ("pack_ternary_planes", "src/repro_torch/kernels/csrc/pack.cu",
             "src/repro/kernels/pack.py:64"),
            ("popcount_dot", "src/repro_torch/kernels/csrc/popcount_dot.cu",
             "src/repro/kernels/popcount_dot.py:32"),
            ("sample_tokens", "src/repro_torch/kernels/csrc/sample.cu",
             "src/repro/serve/decode_loop.py:87")):
        r = report[name]
        # each kernel's launches on the paths that run it: the mixed path,
        # the merge path, the merged ensemble, the artifact path, the
        # refill path, phase 3e's configurations (the MoE one by
        # merge-on-swap), phase 3f's families (by merge-on-swap), the
        # sampled paths, the paged path, the remote
        # paths, the durability path, the training path, the long-prompt
        # path and the mesh runs (rank 0's)
        n_launch = (launches[name] + merge_launches[name]
                    + ens_launches[name] + art_launches[name]
                    + refill_launches[name] + paged_launches[name]
                    + remote_launches[name] + durable_launches[name]
                    + train_launches[name] + mesh_launches[name]
                    + within_launches[name] + long_launches[name]
                    + sum(c[name] for c in wide_launches.values())
                    + sum(c[name] for c in fam_launches.values())
                    + sum(c[name] for c in sampled_launches.values()))
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": n_launch,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "shape": r["shape"], "launches_mesh": mesh_launches[name],
                 "launches_within": within_launches[name],
                 "launches_long": long_launches[name],
                 "launches_families": sum(c[name]
                                          for c in fam_launches.values())}
        if name == "unpack_add":
            entry["check_launches"] = check_launches[name]
        if name == "ternary_matmul":
            entry["check_launches"] = matvec_launches[name]
        if "library_note" in r:
            entry["library_note"] = r["library_note"]
        kernels.append(entry)
    prefill_ms = [w["prefill_s"] * 1e3 for w in waves]
    dec_tok = sum(w["tokens"] - w["rows"] for w in waves)
    dec_s = sum(w["seconds"] - w["prefill_s"] for w in waves)
    s_dec_tok = sum(w["tokens"] - w["rows"] for w in swaves)
    s_dec_s = sum(w["seconds"] - w["prefill_s"] for w in swaves)
    g_prefill_ms = [b["prefill_s"] * 1e3 for b in batches]
    g_dec_tok = sum(b["tokens"] - b["rows"] for b in batches)
    g_dec_s = sum(b["seconds"] - b["prefill_s"] for b in batches)
    numbers = {"compress_s_per_expert": compress_s,
               "prefill_ms_per_wave": prefill_ms,
               "decode_tokens_per_s": dec_tok / dec_s,
               "sampled_decode_tokens_per_s": s_dec_tok / s_dec_s,
               "serve_s_8_requests": serve_s,
               "peak_memory_gib": peak / 2 ** 30,
               "merge_swap_s_per_expert": {x["expert"]: x["seconds"]
                                           for x in swaps},
               "merge_prefill_ms_per_batch": g_prefill_ms,
               "merge_batch_rows": [b["rows"] for b in batches],
               "merge_decode_tokens_per_s": g_dec_tok / g_dec_s,
               "merge_serve_s_8_requests": gserve_s,
               "merge_peak_memory_gib": gpeak / 2 ** 30,
               "artifact_path": art,
               "refill": dict(
                   refill, warm_serve_s=refill_s,
                   tokens=sum(r.max_new_tokens for r in rtimed),
                   tokens_per_s=sum(r.max_new_tokens for r in rtimed)
                   / refill_s,
                   first_token_after_admit_ms=[
                       (r.t_first_s - r.t_admit_s) * 1e3 for r in rtimed],
                   admit_after_start_ms=[r.t_admit_s * 1e3 for r in rtimed],
                   waves=rwaves),
               "graphs": {"mixed": graph_stats(engine),
                          "merge": graph_stats(gengine),
                          "refill": graph_stats(rengine)},
               "wide_configs": wide, "families": fams,
               "sampled": sampled, "paged": paged,
               "remote": remote, "durable": durable, "trained": trained,
               "mesh": mesh, "within": within, "long": long,
               "params_m": n_params / 1e6}
    details.update(kernels=kernels, numbers=numbers, launches={
        "mixed_path": launches, "merge_path": merge_launches,
        "ensemble": ens_launches, "ensemble_loop_check": check_launches,
        "artifact_path": art_launches, "refill_path": refill_launches,
        "paged_path": paged_launches, "remote_path": remote_launches,
        "durable_path": durable_launches, "training_path": train_launches,
        "within_path": within_launches, "long_path": long_launches,
        "ternary_matvec_check": matvec_launches,
        **{f"{a}_path": c for a, c in wide_launches.items()},
        **{f"{a}_path": c for a, c in fam_launches.items()},
        **{f"sampled_top_k_{k}_path": c
           for k, c in sampled_launches.items()}})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(f"compress seconds per expert {tag}: "
        + ", ".join(f"{s:.3f}" for s in compress_s))
    cp = details["compress_profile"]
    log(f"compress_packed device ms by pass {tag}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cp["device_ms_by_pass"].items())
        + f"; busy {cp['device_busy_ms']:.2f} of {cp['wall_ms']:.2f} ms wall"
        f" (host share {cp['host_share']:.3f})")
    for name, e in report["segment_hist_moments"]["sweeps"].items():
        log(f"segment_hist_moments {name} sweep ms {tag}: {e['ms']:.4f} "
            f"(bound {e['bound_ms']:.4f})")
    log(f"prefill ms per wave (4 rows) {tag}: "
        + ", ".join(f"{t:.1f}" for t in prefill_ms))
    log(f"decode tokens/s (4 rows, chunk 8) {tag}: "
        f"{numbers['decode_tokens_per_s']:.1f}")
    log(f"sampled decode tokens/s (the same wave, temperature 0.8, top_k 40)"
        f" {tag}: {numbers['sampled_decode_tokens_per_s']:.1f} (greedy "
        f"{numbers['decode_tokens_per_s']:.1f})")
    for r in report["sample_tokens"]["shapes"]:
        for top_k in (40, 0):
            e = r[f"top_k_{top_k}"]
            log(f"sample_tokens [{r['B']}, {r['V']}] bf16 top_k {top_k} ms "
                f"by CUDA graph {tag}: {e['ms']:.4f} (bound "
                f"{e['bound_ms']:.5f}, {e['bound_by']}; composite "
                f"{e['composite_ms']:.4f}; plain {e['plain_ms']:.3f}"
                + (f"; torch.topk {e['topk_ms']:.4f}" if top_k else "")
                + ")")
    for arch, w in fams.items():
        if arch == "mamba_block":
            log(f"jamba mamba block at full width (4 rows, f32) {tag}: "
                f"forward over 80 tokens {w['forward_80_ms']:.2f} ms, "
                f"prefill of 64 {w['prefill_64_ms']:.2f} ms, a decode step "
                f"{w['decode_step_ms']:.3f} ms; prefill + 16 steps vs one "
                f"forward max err {w['max_abs_err']:.3e} (tol "
                f"{w['tol']:.3e})")
            continue
        p = w["profile"]
        log(f"{arch} ({w['units']} units, {w['params_m']:.1f} M params, "
            f"{'smoke size' if w['smoke'] else 'full width'}, merge-on-swap)"
            f" {tag}: decode tokens/s {w['decode_tokens_per_s']:.1f} (rows "
            f"per batch {w['batch_rows']}); prefill ms per batch "
            + ", ".join(f"{t:.1f}" for t in w["prefill_ms_per_batch"])
            + "; swap s per expert " + ", ".join(
                f"{x['expert']} {x['seconds']:.4f}" for x in w["swap_s"])
            + f" (bound {w['swap_bound_ms']:.3f} ms); a profiled 4-row batch"
            f" with its merge: wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['device_busy_ms']:.1f} ms, idle share "
            f"{p['idle_share']:.3f}; compress s per expert " + ", ".join(
                f"{t:.3f}" for t in w["compress_s_per_expert"])
            + f"; peak memory {w['peak_memory_gib']:.2f} GiB")
        if "recurrent" in w:
            r = w["recurrent"]
            log(f"{arch} decode step (4 rows, graph) {tag}: "
                f"{r['decode_step_ms']:.3f} ms; recurrent mixers "
                f"{r['mixers_ms']:.3f} ms ({100 * r['mixer_share']:.1f}%), "
                f"their scans {r['scans_ms']:.3f} ms "
                f"({100 * r['scan_share']:.1f}%)")
        if "encoder" in w:
            e = w["encoder"]
            log(f"{arch} prefill (4 rows, 64 tokens) {tag}: "
                f"{e['prefill_ms']:.2f} ms, encoder {e['encoder_ms']:.2f} ms "
                f"({100 * e['encoder_share']:.1f}%)")
    for arch, w in wide.items():
        p = w["profile"]
        if arch == MOE_CONFIG[0]:
            log(f"{arch} ({w['units']} units, {w['params_m']:.1f} M params, "
                f"merge-on-swap) {tag}: decode tokens/s "
                f"{w['decode_tokens_per_s']:.1f} (rows per batch "
                f"{w['batch_rows']}); prefill ms per batch " + ", ".join(
                    f"{t:.1f}" for t in w["prefill_ms_per_batch"])
                + "; swap s per expert " + ", ".join(
                    f"{x['expert']} {x['seconds']:.4f}" for x in w["swap_s"])
                + f" (bound {w['swap_bound_ms']:.3f} ms); a profiled "
                f"4-row batch with its merge: wall {p['wall_ms']:.1f} ms, "
                f"device busy {p['device_busy_ms']:.1f} ms, idle share "
                f"{p['idle_share']:.3f}, merge kernel "
                f"{p['device_ms_by_family']['merge kernel']:.2f} ms; "
                "compress s per expert " + ", ".join(
                    f"{t:.3f}" for t in w["compress_s_per_expert"])
                + f"; peak memory {w['peak_memory_gib']:.2f} GiB "
                f"({w['held_on_entry_gib']:.2f} held on entry)")
            continue
        log(f"{arch} ({w['units']} units, {w['params_m']:.1f} M params) "
            f"{tag}: decode tokens/s {w['decode_tokens_per_s']:.1f}; "
            "prefill ms per wave " + ", ".join(
                f"{t:.1f}" for t in w["prefill_ms_per_wave"])
            + f"; warm wave wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['device_busy_ms']:.1f} ms, idle share "
            f"{p['idle_share']:.3f}; compress s per expert " + ", ".join(
                f"{t:.3f}" for t in w["compress_s_per_expert"])
            + f"; peak memory {w['peak_memory_gib']:.2f} GiB "
            f"({w['held_on_entry_gib']:.2f} held on entry)")
        for r in w["grouped_shapes"]:
            log(f"{arch} ternary_matmul_grouped {', '.join(r['names'])} "
                f"{r['phase']} ms by CUDA graph {tag}: {r['ms']:.4f} (bound "
                f"{r['bound_ms']:.5f}, M={r['M']} K={r['K']} N={r['N']}, "
                f"{r['launches_per_wave']} launches per wave)")
    for top_k, smp in sampled.items():
        log(f"sampled refill traffic, top_k {top_k}, bf16, against "
            f"decode_chunk 8 {tag}: " + "; ".join(
                f"chunk {K}: {c['equal']} of 16 equal, {len(c['parted'])} "
                "parted" for K, c in smp["bf16_against_8"].items())
            + "; f32 copy: all equal at chunks 0/1/8/16 and to their solo "
            "serves")
    log(f"merge path: swap seconds per expert {tag}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in numbers["merge_swap_s_per_expert"].items()))
    log(f"merge path: prefill ms per batch (rows "
        f"{numbers['merge_batch_rows']}) {tag}: "
        + ", ".join(f"{t:.1f}" for t in g_prefill_ms))
    log(f"merge path: decode tokens/s (batches of 1-2 rows, chunk 8) {tag}: "
        f"{numbers['merge_decode_tokens_per_s']:.1f}")
    for name in ("unpack_add", "unpack_add_many"):
        r = report[name]
        log(f"{name} ms at the tied embedding, E = 1 {tag}: {r['ms']:.4f} "
            f"(bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.3f})")
    e3 = report["unpack_add_many"]["e3"]
    log(f"unpack_add_many ms at the tied embedding, E = 3 {tag}: "
        f"{e3['ms']:.4f} (bound {e3['bound_ms']:.4f}, plain "
        f"{e3['plain_ms']:.3f})")
    log(f"peak memory {tag}: mixed path {numbers['peak_memory_gib']:.2f} "
        f"GiB, merge path and ensemble "
        f"{numbers['merge_peak_memory_gib']:.2f} GiB")
    log(f"artifact path {tag}: exact compression of e0 "
        f"{art['exact_compress_s']:.3f} s (streaming {compress_s[0]:.3f} s); "
        "Golomb encode s " + ", ".join(
            f"{k} {v:.2f}" for k, v in art["golomb_encode_s"].items())
        + "; load s (lazy) " + ", ".join(
            f"{k} {v:.3f}" for k, v in art["load_s"].items()))
    log(f"artifact path {tag}: cold-Golomb serve {art['cold_serve_s']:.2f} s "
        f"(Golomb decode of the 4 experts {art['cold_golomb_decode_s']:.2f} "
        "s), decode tokens/s "
        f"{art['cold_decode_tokens_per_s']:.1f}; similarity "
        f"{art['similarity_s']:.3f} s; merges " + ", ".join(
            f"{m} {art[f'merge_{m}_s']:.2f} s / peak {g:.2f} GiB"
            for m, g in art["merge_peak_gib"].items()))
    for name in ("segment_absmax", "pack_ternary_planes", "popcount_dot",
                 "ternary_matmul"):
        r = report[name]
        log(f"{name} ms {tag}: {r['ms']:.4f} (bound {r['bound_ms']:.5f}, "
            f"plain {r['plain_ms']:.3f}; {r['shape']})")
    log(f"cuBLAS x @ W on the dense f32 ternary FFN-down matrix {tag}: "
        f"{report['ternary_matmul']['cublas_dense_ms']:.4f} ms (another "
        "input, a yardstick)")
    for r in report["ternary_matmul"]["shapes"]:
        log(f"ternary_matmul {r['name']} ms by CUDA graph {tag}: "
            f"{r['ms']:.4f} (bound {r['bound_ms']:.5f}; {r['shape']})")
    for r in report["ternary_matmul_grouped"]["shapes"]:
        log(f"ternary_matmul_grouped {', '.join(r['names'])} {r['phase']} ms "
            f"by CUDA graph {tag}: {r['ms']:.4f} (bound {r['bound_ms']:.5f}, "
            f"M={r['M']} K={r['K']} N={r['N']}, {r['launches_per_wave']} "
            "launches per wave)")
    for key, what in (("profile", "phase 3's warm wave"),
                      ("sampled_profile", "phase 3's warm wave, sampled"),
                      ("refill_profile", "phase 3d's warm refill run")):
        p = details[key]
        if p["idle_share"] is not None:
            log(f"{what} {tag}: wall {p['wall_ms']:.1f} ms, device busy "
                f"{p['device_busy_ms']:.1f} ms, idle share "
                f"{p['idle_share']:.3f}")
    rf = numbers["refill"]
    log(f"refill traffic (16 requests, {rf['tokens']} tokens, "
        f"{rf['by_chunk'][8]['admitted']} admitted) {tag}: warm serve "
        f"{rf['warm_serve_s']:.3f} s, {rf['tokens_per_s']:.1f} tokens/s "
        f"end to end; admitted at ms "
        + ", ".join(f"{t:.1f}" for t in rf["admit_after_start_ms"])
        + "; first token after admission ms "
        + ", ".join(f"{t:.1f}" for t in rf["first_token_after_admit_ms"]))
    log(f"refill traffic, bf16, against decode_chunk 8 {tag}: " + "; ".join(
        f"chunk {K}: {c['equal']} of 16 equal, {len(c['parted'])} parted "
        f"({sum(e['within'] for e in c['parted'])} within 2**-7 of the top)"
        for K, c in rf["bf16_against_8"].items())
        + f"; solo serves {details['refill_solo']['exact']} of 16 equal; "
        f"f32 copy: all equal at chunks 0/1/8/16, "
        f"{rf['f32']['solo']['exact']} of 16 equal their solo serves")
    for name, g in numbers["graphs"].items():
        log(f"graphs of the {name} engine {tag}: {g['graphs']} graphs, "
            f"{g['graph_captures']} captures in {g['graph_capture_s']:.2f} s, "
            f"{g['graph_replays']} replays")
    for K, g in sorted(rf["by_chunk"].items()):
        log(f"refill traffic at decode_chunk={K} {tag}: "
            f"{g['graph_captures']} captures in {g['graph_capture_s']:.2f} s"
            + (f", serve {g['serve_s']:.2f} s (cold)" if "serve_s" in g
               else f", serve {rf['cold_serve_s']:.2f} s (cold)"))
    for name, p in (("warm closed paged/fifo run", paged["profile"]),
                    ("the same traffic, dense/fifo", paged["dense_profile"])):
        log(f"{name} {tag}: wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['device_busy_ms']:.1f} ms, idle share "
            + (f"{p['idle_share']:.3f}" if p["idle_share"] is not None
               else "not measured"))
    log(f"paged traffic, closed (24 requests, "
        f"{sum(r.max_new_tokens for r in paged_traffic(cfg, args.seed))} "
        f"tokens), warm tokens/s end to end {tag}: " + ", ".join(
            f"{k} {v:.1f}" for k, v in paged["warm_tokens_per_s"].items())
        + "; dense/fifo head-of-line blocks "
        f"{paged['dense']['blocks']}; paged blocks " + "; ".join(
            f"{k}: {v['blocks']}, {v['deferred']} deferred, peak "
            f"{v['kv']['blocks_peak']} of {v['kv']['blocks_total']} blocks"
            for k, v in paged["schedulers"].items()))
    for k, v in paged["schedulers"].items():
        g = v["graphs"]
        log(f"graphs of the paged/{k} engine {tag}: {g['graphs']} graphs, "
            f"{g['graph_captures']} captures in {g['graph_capture_s']:.2f} s,"
            f" {g['graph_replays']} replays (cold run; a warm run captured "
            "none)")
    for k, a in paged["bf16_against_dense"].items():
        log(f"paged/{k} against dense/fifo, bf16 {tag}: {a['equal']} of 24 "
            "equal; partings " + (", ".join(
                f"uid {e['uid']} at step {e['step']} (gaps {e['gaps'][0]:.4f}"
                f" / {e['gaps'][1]:.4f}, tol {e['tol']:.4f})"
                for e in a["parted"]) or "none"))
    at = paged["attention_ms_per_step"]
    log(f"decode attention device ms per step ({at['layers']} layers, 4 rows,"
        f" 256 positions) by CUDA graph {tag}: paged {at['paged']:.4f}, dense "
        f"{at['dense']:.4f}")
    for k, rec in paged["open_loop"].items():
        log(f"open-loop {k} (24 requests, base 8/s, 4x bursts) {tag}: "
            f"tokens/s {rec['tokens_per_s']:.1f}, span {rec['span_s']:.3f} s, "
            f"TTFT s p50/p95/p99 all {rec['ttft_p50_s']:.3f}/"
            f"{rec['ttft_p95_s']:.3f}/{rec['ttft_p99_s']:.3f}, " + ", ".join(
                f"p{p} {v[50]:.3f}/{v[95]:.3f}/{v[99]:.3f}"
                for p, v in rec["ttft_by_priority_s"].items())
            + ", deadline misses " + ", ".join(
                f"p{p} {v['deadline_miss']}"
                for p, v in rec["per_priority"].items())
            + f", {rec['waves']} waves of rows {rec['rows']}, "
            f"{rec['admitted']} admitted, {rec['deferred']} deferred, blocks "
            f"{rec['blocks']}, peak {rec['blocks_peak']} KV blocks")
    wb = remote["wire_bytes_per_expert"]
    log(f"bytes on the wire per expert {tag}: PACKED " + ", ".join(
        f"{k} {v}" for k, v in wb["packed"].items()) + "; GOLOMB (phase 3c's"
        " files) " + ", ".join(f"{k} {v}" for k, v in wb["golomb"].items())
        + f"; DENSE reckoned at 2 bytes a parameter {wb['dense_reckoned']}")
    pe = remote["per_expert"]
    log(f"remote e0 (PACKED) {tag}: fetch over loopback HTTP "
        f"{pe['http_fetch_s']:.3f} s, CRC and decode {pe['crc_decode_s']:.3f}"
        f" s, host-to-device promotion {pe['h2d_s']:.4f} s for "
        f"{pe['h2d_bytes']} bytes ({pe['h2d_gb_per_s']:.2f} GB/s)")
    log(f"first token of a request whose expert is remote (HTTP) {tag}: "
        f"cold {remote['ttft_s']['cold']:.3f} s, warm "
        f"{remote['ttft_s']['warm']:.3f} s")
    for k in ("local", "http", "replicated"):
        r = remote[k]
        log(f"remote serve over {k} {tag}: {r['serve_s']:.2f} s cold, "
            f"remote_seconds {r['remote_seconds']:.3f} against "
            f"prefetch_seconds {r['prefetch_seconds']:.3f} "
            f"({r['prefetch_hits']} prefetch hits, {r['retries']} retries, "
            f"{r['transport_bytes_wasted']} bytes wasted)")
    co = remote["capture_overlap"]
    log(f"capture under prefetch {tag}: {co['captures_in_flight']} of "
        f"{co['captures']} captures inside a 3 s link read; remote_seconds "
        f"{co['remote_seconds']:.3f} against prefetch_seconds "
        f"{co['prefetch_seconds']:.3f}")
    log(f"phase 3r took {remote['phase_s']:.1f} s {tag}")
    dk = durable
    jb = dk["a"]["journal_bytes"]
    log(f"phase 3k journal {tag}: {len(jb['chunk'])} chunk records of "
        f"{min(jb['chunk'])}-{max(jb['chunk'])} bytes (mean "
        f"{sum(jb['chunk']) / len(jb['chunk']):.1f}), run_start "
        f"{jb['run_start'][0]} bytes, admit {min(jb['admit'])}-"
        f"{max(jb['admit'])}, snap {min(jb['snap'])}-{max(jb['snap'])}")
    for key in sorted({(x["layout"], x["dtype"]) for x in dk["snapshots"]}):
        xs = [x for x in dk["snapshots"] if (x["layout"], x["dtype"]) == key]
        commit = sorted(x["commit_s"] for x in xs)
        d2h = sorted(x["total_s"] - x["commit_s"] for x in xs)
        log(f"phase 3k snapshots {key[0]} {key[1]} {tag}: {len(xs)}, "
            f"{xs[0]['bytes']} bytes each; commit (npz + manifest + "
            f"rename) s median {commit[len(xs) // 2]:.4f} (min "
            f"{commit[0]:.4f}, max {commit[-1]:.4f}); device-to-host copy "
            f"and metadata s median {d2h[len(xs) // 2]:.4f}")
    for name, r in (("(a) dense bf16 warm", dk["a"]["warm"]),
                    ("(a) dense bf16 fresh", dk["a"]["fresh"]),
                    ("(b) paged sampled bf16 warm", dk["b"]["warm"]),
                    ("(c) journal only bf16", dk["c"]),
                    ("(e) SIGKILL child bf16", dk["e"]["resume"]),
                    ("(a) dense f32 warm", dk["f32"]["a"]["warm"]),
                    ("(a) dense f32 fresh", dk["f32"]["a"]["fresh"]),
                    ("(b) paged sampled f32 warm", dk["f32"]["b"]["warm"]),
                    ("(c) journal only f32", dk["f32"]["c"]),
                    ("(e) SIGKILL child f32", dk["f32"]["e"]["resume"])):
        parted = ", ".join(f"uid {e['uid']} at token {e['step']}"
                           for e in r["parted"]) or "none"
        times = (f"resume_seconds {r['resume_s']:.3f}, "
                 f"first_resumed_token_s {r['first_resumed_token_s']:.3f}, "
                 f"plan {r['plan']}" if r["completed"] else
                 "the prefix check raised (near-tie)")
        log(f"phase 3k {name} {tag}: completed {r['completed']}; {times}; "
            f"{len(r['continued'])} rows continued bitwise; parted from the "
            f"uninterrupted run: {parted}")
    log(f"phase 3k SIGKILL child {tag}: base checkpoint "
        f"{dk['e']['base_bytes']} bytes, setup (save + publish) "
        f"{dk['e']['setup_s']:.1f} s; child {dk['e']['child_s']:.1f} s "
        f"(f32 {dk['f32']['e']['child_s']:.1f} s) to its SIGKILL at chunk "
        f"{dk['a']['kill_chunk']}")
    log(f"phase 3k phase 3d's traffic, warm tokens/s end to end / decode "
        f"{tag}: " + "; ".join(
            f"{k} " + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in zip(
                v["tokens_per_s"], v["decode_tokens_per_s"]))
            for k, v in dk["rates"].items()))
    log(f"phase 3k took {dk['phase_s']:.1f} s {tag}")
    tr = trained
    for opt in ("adamw", "adafactor"):
        x = tr[opt]
        log(f"phase 3t {opt} train step {tag}: median {x['step_ms_median']:.2f}"
            f" ms (min {x['step_ms_min']:.2f}), {x['tokens_per_s']:.1f} "
            f"tokens/s, MFU {100 * x['mfu']:.2f}% of the dense bf16 peak "
            f"(6 N tokens, N {n_params / 1e6:.1f} M), peak memory "
            f"{x['peak_memory_gib']:.2f} GiB")
    pr = tr["adamw"]["profile"]
    log(f"phase 3t profiled AdamW step {tag}: wall {pr['wall_ms']:.1f} ms, "
        f"device busy {pr['device_busy_ms']:.1f} ms (idle "
        f"{100 * pr['idle_share']:.1f}%); " + "; ".join(
            f"{ph} " + ", ".join(f"{f} {v:.2f} ms" for f, v in d.items())
            for ph, d in pr["device_ms"].items())
        + f"; deterministic {pr['step_ms_deterministic']:.2f} ms, without "
        f"{pr['step_ms_nondeterministic']:.2f} ms")
    log(f"phase 3t losses {tag}: AdamW " + ", ".join(
        f"{v:.3f}" for v in tr["adamw"]["losses"]) + "; LoRA " + ", ".join(
        f"{v:.3f}" for v in tr["lora"]["losses"]))
    ck = tr["checkpoint"]
    log(f"phase 3t checkpoint {tag}: {ck['bytes']} bytes, save "
        f"{ck['save_s']:.3f} s, restore {ck['restore_s']:.3f} s")
    log(f"phase 3t trained expert {tag}: compress {tr['compress_s']:.3f} s; "
        "eval_loss " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 tr["eval_loss_full"].items())
        + f"; served wave decode {tr['decode_tokens_per_s']:.1f} tokens/s")
    log(f"phase 3t LoRA {tag}: {tr['lora']['step_ms']:.2f} ms a step; "
        "eval_loss " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 tr["lora"]["eval_loss"].items()))
    log(f"phase 3t gradient compression {tag}: "
        f"{tr['grad_compression']['seconds']:.3f} s over the tree; worst "
        f"density {tr['grad_compression']['worst_exact_pp']:.3f} points off")
    log(f"phase 3t took {tr['phase_s']:.1f} s {tag}")
    lg, lw, lr = long, long["whole"], long["chunks"]["runs"]
    log(f"phase 3l {LONG_PROMPT}-token prompt on e0 {tag}: prefill "
        f"{lg['prefill_ms']:.1f} ms warm ({lg['cold_prefill_ms']:.1f} cold), "
        f"decode {lg['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{lg['peak_above_start_bytes'] / 2 ** 30:.2f} GiB above the "
        f"phase's start (gate {lg['gate_bytes'] / 2 ** 30:.2f} GiB), "
        f"{lg['tile_steps_per_layer']} tile steps a layer; chunks "
        + " / ".join(f"{c}: {lr[f'bf16_{c}']['prefill_s']:.2f} s"
                     for c in LONG_CHUNKS)
        + f", f32 logits max err {lg['chunks']['max_abs_err']:.3e}; at "
        f"{WHOLE_T} chunked / whole: attention peak "
        f"{lw['attention']['peak_bytes']['chunked'] / 2 ** 20:.1f} / "
        f"{lw['attention']['peak_bytes']['whole'] / 2 ** 20:.1f} MiB, "
        f"train step peak "
        f"{lw['train_step']['peak_bytes']['chunked'] / 2 ** 30:.2f} / "
        f"{lw['train_step']['peak_bytes']['whole'] / 2 ** 30:.2f} GiB, "
        f"{lw['train_step']['seconds']['chunked']:.2f} / "
        f"{lw['train_step']['seconds']['whole']:.2f} s; phase 3l took "
        f"{lg['phase_s']:.1f} s")
    log(f"grouped kernel: empty expert slots cost {tag}: "
        f"{report['ternary_matmul_grouped']['slot_padding_ms_per_wave']:.3f}"
        " ms per wave")
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


MIXED_PATH_KERNELS = ("ternary_matmul_grouped", "pack_ternary_planes_segmented",
                      "segment_hist_moments", "segment_absmax")
ARTIFACT_PATH_KERNELS = ("pack_ternary_planes", "popcount_dot",
                         "ternary_matmul_grouped")


def fresh(reqs, uid0):
    """Unserved copies of requests (same experts, prompts and budgets)."""
    return [dataclasses.replace(r, uid=uid0 + r.uid, out_tokens=[],
                                status="pending", t_admit_s=None,
                                t_first_s=None, t_done_s=None)
            for r in reqs]


def _is_pt(x) -> bool:
    return hasattr(x, "pos") and hasattr(x, "neg")


def _is_ct(x) -> bool:
    return hasattr(x, "signs")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
    except Exception:       # any other failure: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
    finally:
        stop_ranks()
