"""The plain reference against the program at smoke size on the CPU: the
dense model's forward and its prefill-then-decode logits, mixtral's MoE
layer and its merged tree, and the streaming compression's planes and
scales.  (The reference imports nothing of the program; these tests do,
to hold the two side by side.)"""

import dataclasses

import pytest
import torch

from cardbench import tiny
from cardbench.lib import serving, weights
from cardbench.reference import compeft, lm


def _model(cfg):
    from repro_torch.models import build
    model = build(serving.port_config(cfg))
    return model, serving.make_base(cfg, model, 3, "cpu")


def test_dense_forward_and_prefill_then_decode():
    cfg = dict(tiny.DENSE, torch_dtype="float32")
    model, base = _model(cfg)
    W = {p: t.float() for p, t in weights.flatten(base).items()}
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg["vocab_size"], (1, 12), generator=g)
    ref = lm.forward(cfg, W, toks[0])
    logits, _ = model.forward(base, {"tokens": toks})
    assert float((logits[0] - ref).abs().max()) < 1e-4
    # prefill 8 tokens, then decode the next 4 through the cache
    out, cache = model.prefill(base, {"tokens": toks[:, :8]}, 32)
    got = [out[0, -1]]
    for i in range(8, 11):
        step, _ = model.decode_step(base, toks[:, i:i + 1].to(torch.int32),
                                    cache)
        got.append(step[0, -1])
    assert float((torch.stack(got) - ref[7:11]).abs().max()) < 1e-4


def test_moe_layer_with_capacity_and_left_pads():
    cfg = dict(tiny.MOE, torch_dtype="float32")
    mc = serving.port_config(cfg)
    model, base = _model(cfg)
    W = {p: t.float() for p, t in weights.flatten(base).items()}
    from repro_torch.models.ffn import moe_ffn
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 10, cfg["hidden_size"], generator=g)
    unit = {k: v[0] for k, v in base["blocks"]["block0"]["ffn"].items()}
    got, _ = moe_ffn(x, unit, mc.pattern[0].ffn)
    want = lm.moe(x[0], W, 0, cfg, cfg["moe_capacity_factor"])
    assert float((got[0] - want).abs().max()) < 1e-5
    # without capacity the published layer drops nothing: some rows differ
    free = lm.moe(x[0], W, 0, cfg, None)
    assert float((free - want).abs().max()) >= 0.0
    # a padded prompt: the program's left-padded prefill row
    toks = torch.randint(2, cfg["vocab_size"], (7,), generator=g)
    pad = 5
    row = torch.cat([torch.full((pad,), cfg["pad_token_id"]), toks])[None]
    start = torch.tensor([pad], dtype=torch.int32)
    logits, _ = model.prefill(base, {"tokens": row}, 32, start=start)
    ref = lm.forward(cfg, W, toks, cfg["moe_capacity_factor"], pad=pad,
                     prompt_len=7)
    assert float((logits[0, -1] - ref[-1]).abs().max()) < 1e-4


def test_merged_tree_is_the_references():
    from repro_torch import api
    from cardbench.reference import serve_check
    cfg = dict(tiny.MOE, torch_dtype="bfloat16")
    model, base = _model(cfg)
    flat = weights.flatten(base)
    ft = weights.finetune_tree(cfg, flat, 3, 0)
    ex = api.compress(base, ft, name="x0", density=0.1, device="cpu")
    reg = api.registry(experts=[ex], device="cpu")
    merged = weights.flatten(reg.merged_params(base, ["x0"]))
    out = serve_check.merged_tree_off(cfg, 3, 0, merged, "cpu", 0.1, 1.0)
    assert out["merged_off"] == 0
    # the bf16 leaves bit for bit
    for path, leaf in flat.items():
        if leaf.dtype == torch.bfloat16:
            want = compeft.merged_leaf(leaf, weights.flatten(ft)[path], 0.1)
            assert torch.equal(merged[path], want), path


@pytest.mark.parametrize("density", [0.1, 0.05])
def test_streaming_compression_planes_and_scales(density):
    from repro_torch.core.compeft import CompressionConfig, compress_packed
    cfg = tiny.DENSE
    model, base = _model(cfg)
    flat = weights.flatten(base)
    ft = weights.flatten(weights.finetune_tree(cfg, flat, 3, 1))
    tau = {p: ft[p].float() - flat[p].float() for p in flat}
    got = compress_packed(weights.unflatten(tau),
                          CompressionConfig(density=density))
    got = weights.flatten(got)
    for p, t in tau.items():
        sg, s = compeft.compress_leaf(t, density)
        assert torch.equal(got[p].pos, compeft.pack(sg, 1)), p
        assert torch.equal(got[p].neg, compeft.pack(sg, -1)), p
        assert abs(float(got[p].scale) - float(s)) <= 1e-6 * float(s), p


def test_control_precision_moves_the_task_vector():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 1e-2
    base = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    tuned = (base + t)
    exact = compeft.task_vector(base, tuned)
    low = compeft.task_vector(base, tuned, torch.bfloat16)
    assert not torch.equal(exact, low)
    assert dataclasses.is_dataclass(tiny) is False
