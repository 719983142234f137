"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tpucomp_torch
from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    run = SPEC["run_seconds"]
    assert 1 <= run <= 51 and (2 + 14 * 24) * (run + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec, w, config, traffic = harness.load_cell(cell)
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("benchmark/") and config["name"] == w["config"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (BENCH / "data" / f"{traffic['data']}.py").exists()
    assert (BENCH / "entries" / f"{traffic['entry']}.py").exists()
    assert (BENCH / "reference" / f"{config['codec']}.py").exists()
    assert callable(harness.load_module("seed", config["seed_transform"]).apply)
    assert all(hasattr(tpucomp_torch, config["port"][k]) for k in ("codec", "opts", "manager"))
    e2e = [m["name"] for m in harness.metrics_of(spec, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2 and harness.metrics_of(spec, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("metric,reader", [
    ("lz4_compress_roofline", "compress_roofline"), ("snappy_decompress_roofline", "decompress_roofline"),
    ("idle_pct.compress.lz4", "idle_pct.compress"), ("compress_gbps.snappy", "compress_gbps"),
    ("setup_s", "setup_s"), ("snappy_encode_ns_per_seq", "encode_ns_per_seq"),
    ("snappy_decode_ns_per_elem", "snappy_decode_ns_per_elem"), ("cascaded4k_compress_roofline", "compress_roofline"),
    ("host_us.decompress.cascaded4k", "host_us.decompress"),
])
def test_a_metric_is_read_by_its_general_reader(metric, reader):
    assert harness.load_module("metrics", metric).__file__ == str(BENCH / "metrics" / f"{reader}.py")


def test_a_metric_with_no_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "table_roofline")


def test_the_seed_transforms_leave_the_work_as_it_is():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 4, 4096, dtype=np.uint8).tobytes()
    got = np.frombuffer(harness.load_module("seed", "xor_bytes").apply(raw, 2**40 + 3), np.uint8)
    want = np.frombuffer(raw, np.uint8)
    assert (got != want).all() and ((got[:, None] == got[None, :]) == (want[:, None] == want[None, :])).all()
    col = np.repeat(rng.integers(-2**31, 2**31, 64, dtype=np.int64), 16).astype(np.int32)
    got = np.frombuffer(harness.load_module("seed", "add_int32").apply(col.tobytes(), 9), np.int32)
    assert (got != col).all() and (np.diff(got.astype(np.uint32)) == np.diff(col.astype(np.uint32))).all()


STAND_IN_REFERENCE = '''"""A stand-in reference: the port's own Snappy, enough to see the wiring."""
import tpucomp_torch

CONTROL = {}
ARTIFACT_FORMAT = 1


def artifact_header(opts):
    return b""


def compress(data, lengths, opts, **control):
    out = tpucomp_torch.snappy_codec.compress(tpucomp_torch.ChunkBatch(data, lengths), tpucomp_torch.SnappyOpts())
    return out.data, out.lengths
'''

STAND_IN_SEED = '''import sys


def apply(raw, seed):
    print("stand-in seed transform applied", file=sys.stderr)
    return raw
'''


def test_a_new_codec_seed_transform_and_metric_are_new_files_only(tmp_path):
    """A codec the benchmark does not know, with a seed transform and an
    end-to-end metric of its own, runs from files added beside an
    untouched copy of the benchmark, through the CPU run tests' own path
    (``test_benchmark_run.run``), which names no table it must join."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "corpus").symlink_to(ROOT / "corpus")
    assert "standin" not in {json.loads((ROOT / c["file"]).read_text())["codec"] for c in SPEC["configs"]}
    config = {"name": "standin-64k", "source": "a stand-in", "codec": "standin",
              "port": {"codec": "snappy_codec", "opts": "SnappyOpts", "manager": "SnappyManager"},
              "opts": {}, "partition_bytes": 65536, "seed_transform": "unchanged"}
    (tmp_path / "benchmark" / "configs" / "standin-64k.json").write_text(json.dumps(config))
    (tmp_path / "benchmark" / "reference" / "standin.py").write_text(STAND_IN_REFERENCE)
    (tmp_path / "benchmark" / "seed" / "unchanged.py").write_text(STAND_IN_SEED)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "standin-64k", "source": "a stand-in",
                            "file": "benchmark/configs/standin-64k.json", "reduced": [], "why": "wiring"})
    spec["workloads"].append({"name": "standin.batch-mixed", "config": "standin-64k", "traffic": "batch-mixed",
                              "chips": 1, "why": "wiring"})
    spec["end_to_end"].append({"name": "compress_gbps.standin", "unit": "GB/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["standin.batch-mixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json; from benchmark.tests import test_benchmark_run as t; "
            "print(json.dumps(t.run('standin.batch-mixed')))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "stand-in seed transform applied" in p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"compress_gbps.standin", "setup_s"}


def test_config_files_are_distinct_and_uncut():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    assert all(c["reduced"] == [] for c in SPEC["configs"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "tpucomp", "bench"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & {"tpucomp_torch", "tests", "jax", "tpucomp"}
