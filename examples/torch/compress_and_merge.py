"""Expert algebra on compressed artifacts on the PyTorch port: Task
Arithmetic, TIES merging and LoraHub-style few-shot composition over
ComPEFT ``Expert`` artifacts (paper §3.6/3.7), through the
``repro_torch.api`` facade.

    PYTHONPATH=src python examples/torch/compress_and_merge.py \
        [--steps 40] [--device cuda]
"""

import argparse

import numpy as np
import torch

from repro_torch import api as capi
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core.merging import lorahub_search, pairwise_similarity_matrix
from repro_torch.data.pipeline import eval_loss, make_batch_for
from repro_torch.expert import PACKED
from repro_torch.models import build
from repro_torch.peft import LoraConfig, apply_lora, init_lora
from repro_torch.train.train_step import value_and_grad


def add_tau(lora0, tau):
    """lora0 + tau leafwise (f32, cast back)."""
    return tree_util.tree_map(
        lambda a, d: (a.float() + d.float()).to(a.dtype), lora0, tau)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2_5_3b", d_model=96, n_units=2)
    api = build(cfg)
    base = api.init(seed=0, device=args.device)
    lcfg = LoraConfig(rank=4, alpha=8.0)

    def loss_fn(lp, b):
        return api.loss_and_logits(apply_lora(base, lp, lcfg), b)[0]

    # train three task experts
    experts = {}
    for task in (1, 2, 3):
        lora0 = init_lora(task, base, lcfg)
        lora = lora0
        for s in range(args.steps):
            b = make_batch_for(cfg, s, 48, 8, task_id=task,
                               device=args.device)
            g = value_and_grad(loss_fn, lora, b)[1]
            lora = tree_util.tree_map(lambda p, gg: p - 0.5 * gg, lora, g)
        experts[task] = (lora0, lora)
        print(f"expert {task} trained")

    # one Expert artifact per task: tau = lora - lora0, Algorithm 1
    arts = {t: capi.compress(experts[t][0], experts[t][1], name=f"task{t}",
                             kind="lora", density=0.2, device=args.device)
            for t in experts}

    print("\nexpert similarity (popcount cosine):")
    sim = pairwise_similarity_matrix([a.as_(PACKED) for a in arts.values()])
    print(np.round(sim, 3))

    print("\nmerging (lower eval loss on each task is better):")
    merged_ta = capi.merge(list(arts.values()), method="task_arithmetic",
                           lam=0.7)
    merged_ties = capi.merge(list(arts.values()), method="ties",
                             density=0.3, lam=0.7)
    merged_fast = capi.merge(list(arts.values()), method="packed", lam=0.7)
    for name, m in (("task-arithmetic", merged_ta), ("ties", merged_ties),
                    ("packed-TA (bitplane fast path)", merged_fast)):
        losses = [eval_loss(api, apply_lora(base, add_tau(experts[t][0], m),
                                            lcfg), cfg, t, n_batches=1,
                            seq_len=48, global_batch=8)
                  for t in experts]
        print(f"  {name:32s}: avg loss {np.mean(losses):.4f}")

    print("\nLoraHub few-shot composition for unseen mixture task 100:")
    mods = [arts[t].to_dense_tau() for t in arts]
    shot = make_batch_for(cfg, 0, 48, 9, task_id=100, device=args.device)

    def few_shot(tc):
        with torch.no_grad():
            lp = apply_lora(base, add_tau(experts[1][0], tc), lcfg)
            return float(api.loss_and_logits(lp, shot)[0])

    w, best = lorahub_search(mods, few_shot, n_iters=30, seed=0)
    zero = tree_util.tree_map(torch.zeros_like, mods[0])
    print(f"  weights={np.round(w, 3)} loss={best:.4f} "
          f"(zero-composition={few_shot(zero):.4f})")
    print("OK")


if __name__ == "__main__":
    main()
