"""The kernels' work from the configurations' shapes, against counts
worked out by hand."""

import json
from pathlib import Path

import pytest

from cardbench.lib import peaks, spec

ROOT = Path(__file__).resolve().parents[1]
QWEN = json.loads((ROOT / "cardbench/configs/qwen2.5-3b.json").read_text())
# Mixtral-8x7B's published widths at 4 of its 32 units (a merge's leaves)
MIXTRAL = {"hidden_size": 4096, "intermediate_size": 14336,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "head_dim": 128, "num_hidden_layers": 4, "vocab_size": 32000,
           "num_local_experts": 8, "num_experts_per_tok": 2,
           "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


def test_one_decode_step_of_qwen_through_kernel_1():
    # per unit: q 2048x2048, k and v 2048x256, o 2048x2048, gate and up
    # 2048x11008, down 11008x2048 = 77,070,336 weights; x 36 units, plus
    # the tied head 2048 x 151,936 = 311,164,928: 3,085,697,024 weights
    w = spec.work("ternary_matmul_grouped")
    ops, nbytes = w.call(QWEN, 16, 8)
    assert ops == 2 * 16 * 3_085_697_024
    # 8 experts' planes at 2 bits a weight, and 16 rows of f32 inputs and
    # outputs: (36 x 51,968 + 153,984) x 4 bytes x 16
    assert nbytes == 8 * 3_085_697_024 / 4 + 16 * 2_024_832 * 4
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(
        6_300_983_296 / 3.35e12)


def test_one_mixtral_merge_through_kernel_4():
    from cardbench.lib import weights
    leaves = []
    for _, shape, dt, _, _ in weights.layout(MIXTRAL):
        n = 1
        for s in shape:
            n *= s
        leaves.append((n, 4 if dt == "float32" else 2))
    # 6,067,097,600 bf16 weights read and written (4 bytes each), the f32
    # router's 131,072 (8 bytes each), and every weight's two planes at
    # one bit each: 6,067,228,672 / 4 bytes
    ops, nbytes = spec.work("unpack_add_many").swap(leaves)
    assert ops == 0
    assert nbytes == 6_067_097_600 * 4 + 131_072 * 8 + 6_067_228_672 // 4
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(
        25_786_246_144 / 3.35e12)


def test_model_operations_per_token():
    mf = spec.work("model_flops")
    # qwen: 2 x 3,085,697,024 matrix weights, plus 4 x 16 x 128 x 36 per
    # attended position
    assert mf.token(QWEN, 1) == 2 * 3_085_697_024 + 4 * 16 * 128 * 36
    # mixtral at 4 units: attention 2 x 4096 x 4096 + 2 x 4096 x 1024,
    # router 4096 x 8, two experts of 3 x 4096 x 14336 per unit, head
    # 4096 x 32000
    per = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert mf.matrix_params(MIXTRAL) == 4 * per + 4096 * 32000
    assert mf.sequence(QWEN, 3, 1) == 4 * 2 * 3_085_697_024 + \
        4 * 16 * 128 * 36 * (1 + 2 + 3 + 4)


def test_compression_work():
    ops, nbytes = spec.work("compress").compression([64, 100])
    assert nbytes == 4 * 164 + 8 * (2 + 4)
