"""Whole runs of every cell on the CPU at a small size (the port's plain
versions stand for the kernels): sound runs read correct; the control and
every fault planted under the timed path read not correct; without a card
the command exits non-zero and prints no result."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from tpucomp_torch import ChunkBatch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 12345
# partitions a call here: one, since the LZ codecs' plain encoders are slow
# on the CPU; Cascaded needs a few dozen mixed partitions before one leaves
# the raw fallback.  A codec not named here takes one: a new codec's cells
# run here from its files alone.
MORE_PARTITIONS = {"cascaded": 32}


def run(cell, alter=None, traced=False):
    _, _, config, _ = harness.load_cell(cell)
    return harness.run_cell(cell, SEED, 0.2, traced, time.perf_counter(), device="cpu",
                            partitions=MORE_PARTITIONS.get(config["codec"], 1), alter=alter)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in harness.metrics_of(spec, cell, False)}
    assert set(line["metrics"]) == e2e - {"compress_peak_mib"}  # a peak of device memory is read on a card only
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = run(cell, alter=lambda e: e.control())
    assert not line["correct"]
    wrong = line["checks"].get("comp_rows_wrong", line["checks"].get("artifact_bytes_wrong"))
    assert wrong["value"] > wrong["limit"]


def _flip(t: torch.Tensor, at: int) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[at] ^= 1
    return t


def _after_setup(entry, phase, wrap, setup_only=False):
    """Pass set-up's call through (it makes the streams the window
    restores) and change every later answer of ``phase`` with ``wrap``;
    with ``setup_only``, change set-up's answer alone."""
    call, n = entry.calls[phase], [0]

    def changed():
        n[0] += 1
        out = call()
        return wrap(out) if (n[0] == 1) == setup_only else out

    entry.calls[phase] = changed


def _altered(entry, phase, setup_only=False):
    """One byte changed where the answer is produced."""
    def wrap(out):
        if isinstance(out, ChunkBatch):  # byte 9 of the last partition's stream
            return ChunkBatch(_flip(out.data, out.data.numel() - out.data.shape[1] + 9), out.lengths)
        if isinstance(out[0], ChunkBatch):
            return ChunkBatch(_flip(out[0].data, out[0].data.numel() - 5), out[0].lengths), out[1]
        return _flip(out[0], out[1] - 3 if phase == "compress" else out[0].numel() - 5), out[1]

    _after_setup(entry, phase, wrap, setup_only)


def _half_left_out(entry, phase):
    """The second half of the partitions never processed: zero output."""
    def wrap(out):
        if isinstance(out, ChunkBatch):
            data, n = out.data.clone(), out.lengths.clone()
            data[data.shape[0] // 2 :] = 0
            n[n.shape[0] // 2 :] = 0
            return ChunkBatch(data, n)
        if isinstance(out[0], ChunkBatch):
            data = out[0].data.clone()
            data[data.shape[0] // 2 :] = 0
            return ChunkBatch(data, out[0].lengths), out[1]
        first = out[0].clone()
        end = out[1] if phase == "compress" else first.numel()
        first[end // 2 : end] = 0
        return first, out[1]

    _after_setup(entry, phase, wrap)


def _unchanged(entry, phase):
    """The call hands back its input as its answer."""
    def wrap(out):
        if phase == "compress":
            if hasattr(entry, "batch"):
                return ChunkBatch(entry.batch.data.clone(), entry.batch.lengths.clone())
            return entry.buffer.clone(), entry.buffer.numel()
        if hasattr(entry, "batch"):
            return ChunkBatch(entry.streams.data.clone(), entry.streams.lengths.clone()), out[1]
        return entry.artifact.clone(), out[1]

    _after_setup(entry, phase, wrap)


@pytest.mark.parametrize("phase", ["compress", "decompress"])
@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_under_the_timed_path_is_not_correct(cell, fault, phase):
    line = run(cell, alter=lambda e: fault(e, phase))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_streams_set_up_made_are_compared(cell):
    """The decompress half restores set-up's streams; a byte altered there
    alone reads not correct in the compress comparison itself."""
    line = run(cell, alter=lambda e: _altered(e, "compress", setup_only=True))
    wrong = line["checks"].get("comp_rows_wrong", line["checks"].get("artifact_bytes_wrong"))
    assert wrong["value"] > wrong["limit"] and not line["correct"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert p.returncode != 0 and p.stdout == ""
