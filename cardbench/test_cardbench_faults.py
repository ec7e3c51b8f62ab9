"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU at smoke size (its look for a card
skipped), once for each fault a cell can have.  And the control, the
reference one precision below, reads above each limit that the program
keeps."""

import time

import pytest
import torch

from cardbench import tiny
from cardbench.lib import spec
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run():
    return spec.load_module(ROOT / "cardbench" / "run.py", "cb_run_faults")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(run, root, cell, faults=None, control=False, seed=11):
    torch.set_num_threads(1)
    return run.run_cell(spec.load_cell(cell, root), seed, 0.2, False,
                        torch.device("cpu"), time.monotonic(),
                        control=control, faults=faults)


def _alter_tokens(monkeypatch):
    from repro_torch.serve import decode_loop
    orig = decode_loop.DecodeChunk._run

    def bad(self, *a, **k):
        buf = orig(self, *a, **k)
        return torch.where(buf >= 0, (buf + 1) % 512, buf)
    monkeypatch.setattr(decode_loop.DecodeChunk, "_run", bad)


@pytest.mark.parametrize("cell", ["tiny.mixed", "tiny.open",
                                  "tiny-moe.swap"])
def test_a_token_altered_where_it_is_produced(run, root, cell, monkeypatch):
    assert _run(run, root, cell)["correct"]
    _alter_tokens(monkeypatch)
    assert not _run(run, root, cell)["correct"]


def test_rows_served_with_other_experts(run, root):
    def rotate(st):     # every request reaches the next fine-tune's slot
        st.names[:] = st.names[1:] + st.names[:1]
    assert not _run(run, root, "tiny.mixed", faults=rotate)["correct"]


def test_a_merged_tree_altered(run, root, monkeypatch):
    from repro_torch.serve.expert_cache import ExpertRegistry
    orig = ExpertRegistry.merged_params

    def bad(self, *a, **k):
        out = orig(self, *a, **k)
        out["embed"][0, 0] += 1.0
        return out
    monkeypatch.setattr(ExpertRegistry, "merged_params", bad)
    out = _run(run, root, "tiny-moe.swap")
    assert not out["correct"]
    assert out["checks"]["merged_off"]["value"] > 0


def test_a_compression_answer_altered(run, root, monkeypatch):
    from repro_torch.core import compeft as port
    orig = port.compress_packed

    def bad(*a, **k):
        out = orig(*a, **k)
        out["embed"].pos[0] ^= 1
        return out
    monkeypatch.setattr(port, "compress_packed", bad)
    out = _run(run, root, "tiny.compress")
    assert not out["correct"]
    assert out["checks"]["plane_bits_off"]["value"] > 0


@pytest.mark.parametrize("cell,reading,control", [
    ("tiny.mixed", "gap_max", "control_gap_max"),
    ("tiny-moe.swap", "gap_max", "control_gap_max"),
    ("tiny.compress", "plane_bits_off", "control_plane_bits_off")])
def test_the_control_fails_where_the_program_passes(run, root, cell,
                                                    reading, control):
    out = _run(run, root, cell, control=True, seed=5)
    limit = out["checks"][reading]["limit"]
    assert out["checks"][reading]["value"] <= limit
    assert out["readings"][control] > limit
