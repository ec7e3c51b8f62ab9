"""Train a LoRA expert on the PyTorch port, compress it with ComPEFT,
save the Golomb artifact, and verify the reconstructed expert: the full
expert production pipeline (paper §2 + §3.1 at a small scale) on the
``repro_torch.api`` facade.

    PYTHONPATH=src python examples/torch/train_expert.py [--steps 60] \
        [--task 1] [--device cuda]
"""

import argparse
import os
import tempfile

from repro_torch import api as capi
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import eval_loss, make_batch_for
from repro_torch.models import build
from repro_torch.peft import LoraConfig, apply_lora, init_lora
from repro_torch.train import (LoopConfig, TrainConfig, make_train_step,
                               train_loop)
from repro_torch.train.train_step import value_and_grad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--task", type=int, default=1)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2_5_3b", d_model=96, n_units=3)
    api = build(cfg)
    n = sum(l.numel() for l in tree_util.leaves(api.init(device=args.device)))
    print(f"model: {cfg.name}-smoke ({n:,} params)")

    # 1) brief base pretraining (task 0)
    tcfg = TrainConfig(peak_lr=1e-2, warmup_steps=5, total_steps=200)
    step_fn = make_train_step(api, tcfg)
    lcfg = LoopConfig(total_steps=args.steps, seq_len=48, global_batch=8,
                      task_id=0, ckpt_dir=None, log_every=20)
    state, _ = train_loop(api, tcfg, lcfg, step_fn, device=args.device)
    base = state["params"]

    # 2) LoRA fine-tune on the expert task
    lcfg_l = LoraConfig(rank=4, alpha=8.0)
    lora0 = init_lora(7, base, lcfg_l)

    def loss_fn(lp, batch):
        return api.loss_and_logits(apply_lora(base, lp, lcfg_l), batch)[0]

    lora = lora0
    for s in range(args.steps):
        b = make_batch_for(cfg, s, 48, 8, task_id=args.task,
                           device=args.device)
        loss, g = value_and_grad(loss_fn, lora, b)
        if s % 20 == 0:
            print(f"  lora step {s}: loss {float(loss):.4f}")
        lora = tree_util.tree_map(lambda p, gg: p - 0.5 * gg, lora, g)

    # 3) compress + save the expert artifact (Golomb wire format), then
    # 4) re-load and verify quality
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "expert_task%d.npz" % args.task)
        expert = capi.compress(lora0, lora, name=f"task{args.task}",
                               kind="lora", density=args.density, alpha=1.0,
                               device=args.device)
        stats = expert.save(out)
        print(f"saved {os.path.basename(out)}: "
              f"{stats['compressed_bytes']:,} bytes "
              f"({stats['ratio']:.1f}x smaller than bf16 dense)")
        taus = capi.load(out, device=args.device).as_path_dict("dense")
    lora_hat = tree_util.unflatten_like(lora0, [
        (l.float() + taus[p].float().reshape(l.shape)).to(l.dtype)
        for p, l in tree_util.flatten_with_paths(lora0)])

    for name, lp in (("base (no expert)", lora0), ("fine-tuned", lora),
                     ("ComPEFT reconstructed", lora_hat)):
        l = eval_loss(api, apply_lora(base, lp, lcfg_l), cfg, args.task,
                      n_batches=2, seq_len=48, global_batch=8)
        print(f"  eval[{name:24s}]: {l:.4f}")
    print("OK")


if __name__ == "__main__":
    main()
