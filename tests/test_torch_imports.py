"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch/``) import neither JAX nor the JAX
package, and CUDA entry points never fall back to the CPU."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    ex = os.path.join(ROOT, "examples", "torch")
    out += sorted(os.path.join(ex, f) for f in os.listdir(ex)
                  if f.endswith(".py"))
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    # repro_torch is allowed; ml_dtypes comes with JAX, which the card's
    # machine does not have
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"repro_torch.serve.engine", "repro_torch.serve.scheduler",
            "repro_torch.transport.backends", "repro_torch.transport.retry",
            "repro_torch.transport.chaos",
            "repro_torch.transport.replication",
            "repro_torch.distributed.fault", "repro_torch.serve.journal",
            "repro_torch.serve.snapshot", "repro_torch.checkpoint.manager",
            "repro_torch.serve.restart_child", "repro_torch.prng",
            "repro_torch.data.pipeline", "repro_torch.optim.schedules",
            "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
            "repro_torch.train.train_step", "repro_torch.train.trainer",
            "repro_torch.peft.lora", "repro_torch.peft.ia3",
            "repro_torch.peft.task_vector",
            "repro_torch.core.gradient_compression",
            "repro_torch.models.ffn", "repro_torch.configs.qwen3_32b",
            "repro_torch.configs.qwen1_5_110b",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.llama4_maverick_400b",
            "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.models.rwkv", "repro_torch.models.mamba",
            "repro_torch.core.baselines", "repro_torch.configs.rwkv6_3b",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.configs.internvl2_1b",
            "repro_torch.train.within_pod",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro', "
            "'ml_dtypes'))))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_statements(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_serve_exports_every_name_of_the_reference():
    """``repro_torch.serve`` exports every name of ``repro.serve``: the
    schedulers, the paged-KV helpers, the journal and the snapshots."""
    import repro.serve as jserve
    import repro_torch.serve as tserve
    missing = [n for n in jserve.__all__ if not hasattr(tserve, n)]
    assert missing == []
    assert set(jserve.__all__) <= set(tserve.__all__)
    from repro_torch.serve import (FIFOScheduler, JournalWriter,  # noqa
                                   load_snapshot,
                                   uncompressed_baseline_bytes)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    with pytest.raises(RuntimeError, match="CUDA"):
        api.registry()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(get_smoke_config("qwen2_5_3b", n_units=1)).init()


def test_cuda_tensor_never_takes_the_plain_version():
    """A wrapper given a CUDA tensor must launch its kernel or raise; the
    dispatch reads the device, so a meta tensor (neither CPU nor CUDA) is
    refused rather than computed."""
    from repro_torch.kernels.histogram_quantile import segment_hist_moments
    from repro_torch.kernels.pack import pack_ternary_planes_segmented
    from repro_torch.kernels.ternary_matmul import ternary_matmul_grouped
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ternary_matmul_grouped(torch.empty(2, 32, **meta),
                               torch.empty(1, 32, 1, dtype=torch.int32,
                                           **meta),
                               torch.empty(1, 32, 1, dtype=torch.int32,
                                           **meta),
                               torch.empty(1, **meta),
                               torch.empty(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        pack_ternary_planes_segmented(torch.empty(2, 32, **meta),
                                      torch.empty(2, **meta))
    from repro_torch.kernels.pack import pack_ternary_planes
    from repro_torch.kernels.popcount_dot import popcount_dot
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    words = torch.empty(4, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ternary_matmul(torch.empty(2, 4, **meta), words.reshape(4, 1),
                       words.reshape(4, 1), torch.empty((), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        pack_ternary_planes(torch.empty(2, 40, **meta),
                            torch.empty((), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        popcount_dot(words, words, words, words)
    from repro_torch.kernels.sample import sample_gumbel_argmax
    with pytest.raises(ValueError, match="unsupported device"):
        sample_gumbel_argmax(torch.empty(2, 32, **meta),
                             torch.empty(2, 2, dtype=torch.int64, **meta),
                             torch.empty(2, dtype=torch.int64, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        segment_hist_moments(torch.empty(2, 32, **meta),
                             torch.empty(2, dtype=torch.int32, **meta),
                             torch.empty(2, dtype=torch.int32, **meta),
                             torch.empty(1, **meta), torch.empty(1, **meta),
                             n_seg=1)


def test_converters_default_to_the_card():
    """convert.* place tensors on the card by default, so without one they
    raise unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np
    from repro_torch import convert
    tree = {"w": np.ones((2, 3), np.float32)}
    for fn in (convert.tensor_from_numpy, convert.params_from_jax):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(tree["w"] if fn is convert.tensor_from_numpy else tree)
    assert convert.params_from_jax(tree, device="cpu")["w"].device.type == \
        "cpu"


def test_merges_never_take_the_plain_version_off_the_cpu():
    """The merge entry points dispatch on the base's device: a meta tensor
    is refused by both unpack_add wrappers, never computed plainly."""
    from repro_torch.core.packing import PackedTernary
    from repro_torch.kernels import ops
    meta = dict(device="meta")
    base = torch.empty(2, 64, **meta)
    pt = PackedTernary(pos=torch.empty(4, dtype=torch.int32, **meta),
                       neg=torch.empty(4, dtype=torch.int32, **meta),
                       scale=torch.empty((), **meta), shape=(2, 64))
    for fn in (ops.apply_ternary_delta, ops.apply_ternary_delta_flat,
               lambda b, p: ops.apply_ternary_delta_many_flat(b, [p, p],
                                                              [0.5, 1.0])):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(base, pt)


def test_artifact_entry_points_default_to_the_card(tmp_path):
    """api.load and the wire decoder place planes on the card by default,
    so without one they raise unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import api
    from repro_torch.transport import wire
    ex = api.compress({"w": torch.ones(64)}, density=0.5, device="cpu")
    path = str(tmp_path / "w.cpft")
    api.save(ex, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        wire.decode_expert(open(path, "rb").read())
    assert api.load(path, device="cpu").packed["w"].pos.device.type == "cpu"


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repository
    (or on a machine without CUDA) exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_mesh_modules_export_the_serving_mesh():
    """The serving mesh's modules and the package's new exports."""
    import repro_torch.distributed as d
    from repro_torch.launch import mesh
    from repro_torch.serve.paged_kv import __all__ as paged_all
    assert {"ServeComm", "RowLayout", "local_shard", "shard_params",
            "serve_param_shardings", "serve_stack_shardings",
            "serve_kv_sharding", "serve_row_shards", "ElasticPlan",
            "FailureInjector", "SimulatedFailure",
            "StragglerMonitor"} <= set(d.__all__)
    assert all(hasattr(d, n) for n in d.__all__)
    assert {"make_serve_mesh", "make_production_mesh",
            "mesh_axes"} <= set(dir(mesh))
    assert {"ShardedBlockAllocator", "shard_pool_blocks"} <= set(paged_all)


def test_training_mesh_modules_export_the_rules():
    """The training rules, the sequence-parallel decode and the step
    inside a pod are exported."""
    import repro_torch.distributed as d
    from repro_torch.train import within_pod
    assert {"param_pspec", "train_state_shardings", "cache_pspec",
            "decode_layout", "batch_axes", "batch_shardings",
            "serve_cache_shardings", "heads_shardable", "shard_tree",
            "assemble", "flash_combine", "make_sp_decode_attn",
            "shard_decode_cache", "make_vp_embed_lookup",
            "batch_axes_of"} <= set(d.__all__)
    assert all(hasattr(d, n) for n in d.__all__)
    assert {"make_within_pod_step", "within_pod_in_one_process",
            "shard_train_state", "PodRun"} <= set(dir(within_pod))
