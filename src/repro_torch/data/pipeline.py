"""Deterministic, stateless synthetic data pipeline (port of
``repro/data/pipeline.py``).

Every batch is a pure function of (task_id, step) through JAX's threefry
draws, which :mod:`repro_torch.prng` reproduces: the tokens are bitwise
the reference's for the same (task_id, step).  There is no iterator
state, so a restarted job regenerates the identical token stream from the
step counter alone.

The generator is an order-1 latent Markov chain per task: learnable but
non-degenerate, and different ``task_id``s give different conditionals.
The draws are made on the host (a batch is a few thousand integers) and
the batch is placed on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    task_id: int = 0
    latent_vocab: int = 64   # chain runs on a small alphabet mapped into vocab
    noise: float = 0.1


def _chain_params(task_id: int, latent: int):
    rng = np.random.default_rng(1234 + task_id)
    a = int(rng.integers(1, latent))
    c = int(rng.integers(0, latent))
    perm = rng.permutation(latent)
    return a | 1, c, torch.as_tensor(perm, dtype=torch.int64)  # odd multiplier


def sample_tokens(key: torch.Tensor, dcfg: DataConfig) -> torch.Tensor:
    """[B, T+1] int64 tokens of the task's Markov chain (stateless), from
    a key [2] of :mod:`repro_torch.prng`.

    task_id >= 100: the "mixture task": batch row i follows base task
    1 + i % 3, each base chain drawn under ``fold_in(key, task)``.
    """
    B, T = dcfg.global_batch, dcfg.seq_len
    if dcfg.task_id >= 100:
        subs = [sample_tokens(prng.fold_in(key, t),
                              dataclasses.replace(dcfg, task_id=t))
                for t in (1, 2, 3)]                     # three base chains
        stack = torch.stack(subs)                      # [3, B, T+1]
        rows = torch.arange(B)
        return stack[rows % 3, rows]                   # row i -> task 1+i%3
    a, c, perm = _chain_params(dcfg.task_id, dcfg.latent_vocab)
    L = dcfg.latent_vocab
    k0, k1 = prng.split(key)
    x = prng.randint(k0, B, 0, L)
    noise_keys = prng.split(k1, T)                     # [T, 2]
    # the scan's draws for every step at once: [T, B] each
    flips = prng.bernoulli(noise_keys, dcfg.noise, B)
    rnds = prng.randint(prng.fold_in(noise_keys, 1), B, 0, L)
    seq = [x]
    for t in range(T):
        x = torch.where(flips[t], rnds[t], (a * x + c) % L)
        seq.append(x)
    seq = torch.stack(seq, dim=1)                      # [B, T+1]
    # map latent alphabet into the model vocab (spread tokens out)
    stride = max(1, dcfg.vocab // (2 * L))
    return (perm[seq] * stride + 1) % dcfg.vocab


def make_lm_batch(step: int, dcfg: DataConfig, device="cuda") -> dict:
    """{"tokens", "targets"}: [B, T] int32 each, on ``device``."""
    dev = resolve_device(device)
    key = prng.fold_in(prng.prng_key(9000 + dcfg.task_id), step)
    toks = sample_tokens(key, dcfg).to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "targets": toks[:, 1:].contiguous().to(dev)}


def make_batch_for(cfg, step: int, seq_len: int, global_batch: int,
                   task_id: int = 0, device="cuda") -> dict:
    """Family-aware batch builder.  A frontend family's batch holds
    ``seq_len - n_tokens`` text tokens (at least 1) and the stub modality
    input [B, n_tokens, embed_dim] f32, the reference's normal draw under
    ``fold_in(PRNGKey(77 + task_id), step)``: ``frames`` for audio,
    ``mm_embeds`` otherwise."""
    dev = resolve_device(device)
    n_mod = cfg.frontend.n_tokens if cfg.frontend is not None else 0
    text_len = max(seq_len - n_mod, 1) if n_mod else seq_len
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=text_len,
                      global_batch=global_batch, task_id=task_id)
    batch = make_lm_batch(step, dcfg, device=dev)
    if cfg.frontend is not None:
        key = prng.fold_in(prng.prng_key(77 + task_id), step)
        emb = prng.normal(key, (global_batch, n_mod,
                                cfg.frontend.embed_dim)).to(dev)
        batch["frames" if cfg.family == "audio" else "mm_embeds"] = emb
    return batch


def eval_loss(api, params, cfg, task_id: int, n_batches: int = 2,
              seq_len: int = 64, global_batch: int = 8) -> float:
    """Deterministic held-out loss (steps 10_000+ are never trained on),
    on the device the parameters lie on."""
    dev = tree_util.leaves(params)[0].device
    tot = 0.0
    with torch.no_grad():
        for i in range(n_batches):
            b = make_batch_for(cfg, 10_000 + i, seq_len, global_batch,
                               task_id, device=dev)
            loss, _ = api.loss_and_logits(params, b)
            tot += float(loss)
    return tot / n_batches

