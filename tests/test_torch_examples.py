"""The port's five examples (``examples/torch/``) run at smoke size on
the CPU (``--device cpu``), each in its own process, and end in ``OK``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args", [
    ("quickstart.py", []),
    ("serve_experts.py", ["--experts", "3", "--requests", "6"]),
    ("remote_experts.py", ["--latency-ms", "2"]),
    ("train_expert.py", ["--steps", "12"]),
    ("compress_and_merge.py", ["--steps", "8"])])
def test_example_runs_on_the_cpu(script, args):
    # one torch thread: smoke sizes gain nothing from a pool, and the test
    # workers running beside this process would fight it for cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", script),
         "--device", "cpu", *args], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK", out.stdout[-2000:]
