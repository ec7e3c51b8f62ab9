"""The harness: every cell, configuration and metric is found by name,
a new cell is a new file, traffic is a function of the seed, failures
are misses, rates run over the whole window, and nothing the harness runs
imports JAX or the JAX package (nor, in the reference, the program)."""

import json
import math
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

from cardbench import tiny
from cardbench.lib import spec, stats, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "cardbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = spec.load_cell(cell, ROOT)
    assert c.chips == 1
    spec.driver(c.workload["driver"])
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_every_configuration_file_matches_the_program(entry):
    from cardbench.lib import serving
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mc = serving.port_config(cfg)
    assert mc.d_model == cfg["hidden_size"]
    assert mc.n_units == cfg["num_hidden_layers"]
    assert (ROOT / cfg["reference"]).exists()


@pytest.mark.parametrize("kernel", ["ternary_matmul_grouped",
                                    "unpack_add_many", "compress",
                                    "model_flops"])
def test_every_work_file_is_found(kernel):
    assert spec.work(kernel)


def test_a_cell_in_a_new_folder_is_found_without_edits(tmp_path):
    root = tiny.make_root(tmp_path, ["tiny.mixed"])
    c = spec.load_cell("tiny.mixed", root)
    assert c.config["hidden_size"] == tiny.DENSE["hidden_size"]
    assert c.workload["driver"] == "serve"
    with pytest.raises(KeyError):
        spec.load_cell("tiny.compress", root)


OPEN = tiny.CELLS["tiny.open"][1]["traffic"]


def test_traffic_is_a_function_of_the_seed():
    a = traffic.generate(OPEN, 2 ** 31 + 7, 512, seconds=3.0)
    b = traffic.generate(OPEN, 2 ** 31 + 7, 512, seconds=3.0)
    c = traffic.generate(OPEN, 12345, 512, seconds=3.0)
    key = lambda r: (r.expert, r.max_new, r.due, tuple(r.prompt))  # noqa
    assert [key(r) for r in a] == [key(r) for r in b]
    assert [key(r) for r in a] != [key(r) for r in c]
    # every seed gets the same work in the same order
    assert [(r.due, r.expert, r.max_new, len(r.prompt)) for r in a] == \
        [(r.due, r.expert, r.max_new, len(r.prompt)) for r in c]


def test_offline_calls_repeat_the_same_work():
    t = tiny.CELLS["tiny.mixed"][1]["traffic"]
    a = traffic.generate(t, 9, 512, n=7, uid0=0)
    b = traffic.generate(t, 9, 512, n=7, uid0=7)
    assert [r.uid for r in b] == list(range(7, 14))
    assert [r.max_new for r in a] == [r.max_new for r in b]


def _tracked(due, first, last, tokens, budget, failed=False):
    from cardbench.lib.serving import Tracked
    spec_ = types.SimpleNamespace(max_new=budget, prompt=[1, 2])
    return Tracked(spec=spec_, req=None, due=due, first=first, last=last,
                   tokens=tokens, failed=failed)


def test_percentiles_count_failures_as_misses():
    ok = [_tracked(0.0, 0.1 * i, 0.1 * i + 1, 5, 5) for i in range(1, 20)]
    bad = _tracked(0.0, None, None, 0, 5, failed=True)
    assert stats.percentile(stats.ttfts(ok + [bad]), 95) > max(
        stats.ttfts(ok))
    assert stats.percentile(stats.ttfts(ok + [bad] * 2), 95) == math.inf
    assert stats.percentile(stats.tpots(ok + [bad] * 2), 95) == math.inf
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_rates_run_over_the_whole_window():
    rd = spec.metric_reader("tokens_per_s")
    ts = [_tracked(0.0, 1.0, 2.0, 10, 10), _tracked(0.0, 1.0, 8.0, 30, 30),
          _tracked(0.0, None, None, 0, 9, failed=True)]
    rec = types.SimpleNamespace(tracked=ts, t_open=2.0, t_close=10.0)
    assert rd.read(rec) == pytest.approx(40 / 8.0)
    rec = types.SimpleNamespace(compressions=4, t_open=1.0, t_close=3.0)
    assert spec.metric_reader("compress_ms").read(rec) == pytest.approx(500)


def test_sweep_reads_a_queue_that_grows():
    from cardbench import sweep
    # TTFT grows with the due time: the last third waits longest
    ts = [_tracked(float(i), i + 0.5 * i, i + 0.5 * i + 1, 5, 5)
          for i in range(9)]
    rec = types.SimpleNamespace(tracked=ts[::-1], failed=0, t_open=0.0,
                                t_close=15.0)
    line = sweep.summary(rec, 2.0, 9.0)
    assert line["requests"] == 9
    assert line["offered_per_s"] == pytest.approx(1.0)
    assert line["drain_s"] == pytest.approx(6.0)
    assert line["ttft_p95_last_third_ms"] > line["ttft_p95_first_third_ms"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    run = spec.load_module(ROOT / "cardbench" / "run.py", "cardbench_run_t")
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert run.forbidden_modules() == ["repro"]


_RUN_TINY = """
import sys, time, pathlib, torch
sys.path[:0] = ["src", "."]
torch.set_num_threads(1)
from cardbench import tiny
from cardbench.lib import spec
run = spec.load_module(pathlib.Path("cardbench/run.py"), "cb_run")
root = tiny.make_root(pathlib.Path(sys.argv[1]), ["tiny.mixed",
                                                  "tiny.compress"])
for c in ("tiny.mixed", "tiny.compress"):
    out = run.run_cell(spec.load_cell(c, root), 5, 0.2, False,
                       torch.device("cpu"), time.monotonic())
    assert out["correct"], out
print("FORBIDDEN", run.forbidden_modules())
"""

_REFERENCE_ONLY = """
import sys
sys.path[:0] = ["."]
import cardbench.reference.lm, cardbench.reference.compeft
import cardbench.reference.serve_check
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_a_run_imports_no_jax_nor_the_jax_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", _RUN_TINY, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_the_reference_imports_neither_jax_nor_the_program():
    out = subprocess.run([sys.executable, "-c", _REFERENCE_ONLY], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("LOADED")][0]
    loaded = set(eval(line[len("LOADED "):]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
