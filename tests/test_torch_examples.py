"""The port's two examples (examples/torch_round_trip.py and
examples/torch_distributed.py), run as a user runs them, with ``--device
cpu``: exit code 0, so every assert in them held, and the lines they
print."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,lines", [
    ("torch_round_trip.py", ["lz4 low-level: 65536 -> ", "cascaded: 64000 -> ", "manager: 80000 -> ",
                             "sharded over 8 device(s): OK"]),
    ("torch_distributed.py", ["mesh: 8 devices", "lz4: 64 chunks round-tripped sharded over 8 devices",
                              "cascaded: 64 chunks round-tripped sharded over 8 devices"]),
])
def test_example_runs_on_the_cpu(tmp_path, script, lines):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), "--device", "cpu"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert len(out) == len(lines)
    for got, want in zip(out, lines):
        assert got.startswith(want), (got, want)
