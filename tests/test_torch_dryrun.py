"""The port's dry run (``repro_torch.launch.dryrun``) on five cells of
the H100 meshes, on the CPU and the meta device: training cells
(qwen2.5-3b ``train_4k`` on (32, 8); the MoE family's, mixtral on (32,
8) with its experts cut on d_ff and llama4 on (2, 32, 8) with its
experts cut on E, both tensor-parallel, with no whole-leaf gather over
"model"), a decode cell (qwen3-32b ``decode_32k`` on (2, 32, 8)) and a
``long_500k`` cell (gemma2-9b, the sequence cut over every axis); and
``train_4k`` of the families beyond decoder-only attention (jamba,
rwkv6, seamless, internvl2) tensor-parallel on (32, 8); the serving
cells (every ``decode_32k`` and ``long_500k``, and two ``prefill_32k``)
with each unit cut over "model" as training cuts it, nothing gathered
over "model", and jamba's ``decode_32k`` and ``long_500k`` fitting.
Each row carries per-rank bytes, FLOPs, collective bytes by kind, the
roofline terms at the H100's numbers and "fits"; the rank's blocks of
every leaf, times the blocks, are the logical state's bytes; the cell
table is the reference's."""

import functools
import json

import pytest

from repro_torch.launch import dryrun

# one computation of a cell for the tests of this module
cell = functools.lru_cache(maxsize=None)(dryrun.dry_cell)

CELLS = [("qwen2_5_3b", "train_4k", False), ("qwen3_32b", "decode_32k", True),
         ("gemma2_9b", "long_500k", False),
         ("mixtral_8x7b", "train_4k", False),
         ("llama4_maverick_400b", "train_4k", True)]


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
    assert colls["fsdp_gather_model"] == 0
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


# the families beyond decoder-only attention: recurrent blocks (mamba,
# rwkv), an encoder with cross-attention, a vision frontend
FAMILIES = ["jamba_1_5_large_398b", "rwkv6_3b", "seamless_m4t_medium",
            "internvl2_1b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trains_tensor_parallel(arch):
    """``train_4k`` on (32, 8) with "model" tensor-parallel for every
    family: sums over "model" counted, nothing gathered over it; jamba's
    unit (``gathered_unit``: the leaves a rank uses while the units run,
    gathered over "data", a unit's share) is an eighth of the whole
    leaves' (its norms and routers are whole) and its ``in_proj``
    regroup is counted."""
    import math
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    res = cell(arch, "train_4k")
    colls = res["collective_bytes"]
    assert res["tensor_parallel"] and colls["tp_sum"] > 0
    assert colls["fsdp_gather_model"] == 0
    cfg = get_config(arch)
    params = init_params(cfg, device="meta")
    # the leaves a rank uses while the units run, each whole
    whole = sum(math.prod(t.shape) * t.element_size()
                for t in tree_util.leaves(params))
    units = cfg.n_units + cfg.enc_n_units
    unit = res["memory_bytes"]["gathered_unit"]
    assert whole // (8 * units) <= unit < whole // units
    is_mamba = any(b.kind == "mamba" for b in cfg.pattern)
    assert (colls["tp_regroup"] > 0) == is_mamba
    if is_mamba:
        assert unit <= 1.01 * whole / (8 * units)


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


JAMBA = "jamba_1_5_large_398b"
SERVE_CELLS = ([c for c in dryrun.cell_list()
                if c[1] in ("decode_32k", "long_500k")]
               + [("rwkv6_3b", "prefill_32k"),
                  ("mixtral_8x7b", "prefill_32k")])


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_serving_cells_cut_every_unit_over_model(arch, shape):
    """A serving cell on (32, 8) gathers no leaf over "model", sums over
    it, and counts the unit a rank uses cut (``gathered_unit`` at most
    the whole unit's share); a decode step's exchanges are counted
    (``tp_heads`` where the heads are cut), a prefill's KV all-to-all."""
    import math
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import heads_shardable
    from repro_torch.models.transformer import init_params
    from repro_torch.train.within_pod import AxisSizes
    res = cell(arch, shape)
    colls = res["collective_bytes"]
    assert res["tensor_parallel"] and colls["fsdp_gather_model"] == 0
    assert colls["tp_sum"] > 0 and res["flops"] > 0
    cfg = get_config(arch)
    whole = sum(math.prod(t.shape) * t.element_size()
                for t in tree_util.leaves(init_params(cfg, device="meta")))
    assert res["memory_bytes"]["gathered_unit"] < whole // (
        cfg.n_units + cfg.enc_n_units)
    cut = any(b.kind == "attn" and heads_shardable(
        cfg, AxisSizes(dryrun.MESH_SINGLE), b.attn.n_q)
        for b in cfg.pattern)
    if res["kind"] == "decode":
        assert (colls["tp_heads"] > 0) == cut
        assert colls["kv_all_to_all"] == 0
    else:
        assert (colls["kv_all_to_all"] > 0) == cut
        assert colls["tp_heads"] == 0


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_jamba_serving_cells_fit_with_the_training_unit(shape):
    """jamba's decode cells on (32, 8) fit in 80 GB: a rank uses the unit
    cut as ``train_4k`` uses it (11.07 GB, where the whole unit took 88.33
    GB), and mamba's state is gathered over "model" only where the batch
    divides (``decode_32k``; ``long_500k`` holds it on d_inner)."""
    res = cell(JAMBA, shape)
    mem = res["memory_bytes"]
    assert res["fits"] and mem["total"] <= 80e9
    assert mem["gathered_unit"] == cell(JAMBA, "train_4k")[
        "memory_bytes"]["gathered_unit"]
    assert 11e9 < mem["gathered_unit"] < 11.2e9
    colls = res["collective_bytes"]
    assert (colls["tp_state"] > 0) == (shape == "decode_32k")
    assert colls["tp_regroup"] > 0
