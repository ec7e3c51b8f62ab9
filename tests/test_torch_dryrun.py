"""The port's dry run (``repro_torch.launch.dryrun``) on three cells of
the H100 meshes, on the CPU and the meta device: a training cell
(qwen2.5-3b ``train_4k`` on (32, 8)), a decode cell (qwen3-32b
``decode_32k`` on (2, 32, 8)) and a ``long_500k`` cell (gemma2-9b, the
sequence cut over every axis).  Each row carries per-rank bytes, FLOPs,
collective bytes by kind, the roofline terms at the H100's numbers and
"fits"; the rank's blocks of every leaf, times the blocks, are the
logical state's bytes; the cell table is the reference's."""

import json

import pytest

from repro_torch.launch import dryrun

CELLS = [("qwen2_5_3b", "train_4k", False), ("qwen3_32b", "decode_32k", True),
         ("gemma2_9b", "long_500k", False)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_dry_cell_rows(arch, shape, multi_pod, tmp_path):
    res = dryrun.dry_cell(arch, shape, multi_pod)
    assert res["n_ranks"] == (512 if multi_pod else 256)
    mem = res["memory_bytes"]
    assert mem["state_blocks"] == mem["logical_state"] > 0
    assert mem["params"] * res["n_ranks"] >= mem["logical_state"] // 8
    assert res["fits"] == (mem["total"] <= 80e9)
    assert res["flops"] > 0
    terms = res["roofline_s"]
    assert terms["compute_s"] == res["flops"] / 989e12
    assert terms["cross_host_s"] is None
    colls = res["collective_bytes"]
    if res["kind"] == "train":
        assert res["tensor_parallel"] and colls["tp_sum"] > 0
        # a reduce-scatter receives (D - 1) / D of each cut leaf once, the
        # FSDP gathers as much twice (forward and recompute)
        assert 0 < colls["grad_data_sum"] < colls["fsdp_gather"]
    else:
        assert colls["sp_combine"] > 0
    again = dryrun.dry_cell(arch, shape, multi_pod, cross_host_bytes_s=50e9)
    assert again["roofline_s"]["cross_host_s"] == colls["cross_host"] / 50e9
    path = dryrun.result_path(arch, shape, multi_pod, str(tmp_path))
    with open(path, "w") as f:
        json.dump(res, f)


def _reference_table():
    """SHAPES and LONG_OK of ``repro/launch/dryrun.py``, read from its
    source (importing it would set XLA's device count for the whole
    process)."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src", "repro", "launch", "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("SHAPES", "LONG_OK",
                                           "BIG_PARAM_THRESHOLD")):
            out[node.targets[0].id] = eval(compile(  # noqa: S307
                ast.Expression(node.value), path, "eval"))
    return out


def test_cell_table_is_the_reference_s():
    ref = _reference_table()
    assert dryrun.SHAPES == ref["SHAPES"]
    assert dryrun.LONG_OK == ref["LONG_OK"]
    assert dryrun.BIG_PARAM_THRESHOLD == ref["BIG_PARAM_THRESHOLD"]
    from repro_torch.configs import ARCHS
    assert dryrun.cell_list() == [
        (a, s) for a in ARCHS if a != "llama_7b" for s in ref["SHAPES"]
        if s != "long_500k" or a in ref["LONG_OK"]]
    assert len(dryrun.cell_list(include_paper_arch=True)) == len(
        dryrun.cell_list()) + 3
