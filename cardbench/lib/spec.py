"""What one run measures, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics.  Everything that belongs to one of them
sits in a file of its own, found by its name:

* a cell ``<name>``: ``cardbench/workloads/<name>.json`` (its window
  driver, traffic, engine settings, traced slice and check sizes);
* a configuration: the ``file`` that ``BENCHMARK.json`` gives it;
* a metric ``<name>``: ``cardbench/metrics/<name>.py``, whose
  ``read(rec)`` returns the number or None;
* a window driver ``<kind>``: ``cardbench/drivers/<kind>.py``;
* a kernel's work: ``cardbench/work/<kernel>.py``.

So a later change adds a cell, a configuration or a metric by adding files
and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / "cardbench"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (metric names hold dots, so no import)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the configuration file
    workload: dict          # cardbench/workloads/<name>.json
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, without the
    list, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    workload = load_json(root / "cardbench" / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, workload=workload, end_to_end=e2e,
                per_layer=per_layer)


def metric_reader(name: str, root: Path = ROOT):
    path = root / "cardbench" / "metrics" / f"{name}.py"
    return load_module(path, f"cardbench_metric_{name.replace('.', '_')}")


def driver(kind: str, root: Path = ROOT):
    return load_module(root / "cardbench" / "drivers" / f"{kind}.py",
                       f"cardbench_driver_{kind}")


def work(kernel: str, root: Path = ROOT):
    return load_module(root / "cardbench" / "work" / f"{kernel}.py",
                       f"cardbench_work_{kernel}")
