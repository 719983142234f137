"""The readers of the per-layer metrics of the Snappy cell and of the 4 KB
Cascaded cell, on hand-made records of the port's tracer: the numbers they
read, and None where the run has nothing for them or the port has no
tracer."""

from __future__ import annotations

import types

import pytest

from benchmark import harness
from benchmark import trace as btrace
from tpucomp_torch.utils import profiling


@pytest.fixture
def tracer():
    profiling.reset()
    yield profiling
    profiling.reset()


def _rec(name, parent, start, end, cost=1_000):
    """A record whose own entry and exit take ``cost`` ns each."""
    return profiling.SpanRecord(name, parent, start, end, None, start + cost, end - cost)


def _calls(phase, n):
    """n Snappy calls through the batch API: api > snappy > first kernel
    wrapper (the table in a compress) > .launch, call k's first launch
    ending (10 + k) us after its start: the port's host time before it is
    (10 + k) us less the api's entry, the launch's exit and the three
    entries between, (5 + k) us."""
    step = "table" if phase == "compress" else "decode"
    recs = []
    for k in range(n):
        t = k * 10**6
        api = _rec(f"{phase}.api", None, t, t + 900_000)
        route = _rec(f"{phase}.snappy", api, t + 1_000, t + 800_000)
        first = _rec(f"{phase}.snappy.{step}", route, t + 2_000, t + 50_000)
        recs += [api, route, first, _rec(f"{phase}.snappy.{step}.launch", first, t + 4_000, t + (10 + k) * 1_000)]
        if phase == "compress":  # the encode after the table
            enc = _rec("compress.snappy.encode", route, t + 60_000, t + 90_000)
            recs += [enc, _rec("compress.snappy.encode.launch", enc, t + 70_000, t + 80_000)]
    return recs


def _run(windows=None):
    return harness.Run(entry=types.SimpleNamespace(config={"codec": "snappy"}), setup_s=1.0,
                       compress_peak_bytes=None, windows=windows or {})


def _window(op_s, calls):
    return btrace.Window(calls=calls, window_s=1.0, busy_s=0.5, ops=3 * calls, op_s=op_s, idle_s={})


DECODE = "void tpucomp_snappy::(anonymous namespace)::snappy_decode_kernel(DecodeParams)"
REWRITE = "void tpucomp_snappy::(anonymous namespace)::snappy_rewrite_kernel(DecodeParams, int*)"
READERS = [
    # metric, records, counters, windows, expected
    ("snappy_decode_ns_per_elem", _calls("decompress", 2), {"snappy.decode.elements": 4_000},
     {"decompress": _window({DECODE: 0.006, REWRITE: 0.003, "Memcpy DtoH": 0.001}, calls=3)},
     1e9 * (0.006 / 3) / (4_000 / 2)),
    ("snappy_table_large_bucket_pct", [], {"lz.table.positions": 5_000, "lz.table.large_bucket_positions": 1_550},
     None, 31.0),
    ("snappy_encode_ns_per_seq", _calls("compress", 4), {"snappy.encode.sequences": 8_000},
     {"compress": _window({"snappy_encode_kernel": 0.005, "lz_match_group_kernel": 0.004}, calls=5)},
     1e9 * (0.005 / 5) / (8_000 / 4)),
    ("host_us.compress.snappy", _calls("compress", 3), {}, None, 6.0),
    ("host_us.decompress.snappy", _calls("decompress", 4), {}, None, 6.5),
    ("cascaded4k_wasted_chunk_pct", [], {"cascaded.encode.chunks": 65_536, "cascaded.encode.chunks_discarded": 16_384},
     None, 25.0),
]


@pytest.mark.parametrize("metric,records,counts,windows,want", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_the_records(monkeypatch, metric, records, counts, windows, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert harness.load_module("metrics", metric).read(_run(windows)) == pytest.approx(want)


@pytest.mark.parametrize("metric,records,counts,windows,want", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_none_without_records(tracer, metric, records, counts, windows, want):
    assert harness.load_module("metrics", metric).read(_run(windows)) is None


def test_decode_reader_reads_none_without_its_kernel(monkeypatch):
    """Elements counted but only the rewrite kernel in the window."""
    monkeypatch.setattr(profiling, "spans", lambda: _calls("decompress", 2))
    monkeypatch.setattr(profiling, "counters", lambda: {"snappy.decode.elements": 4_000})
    run = _run({"decompress": _window({REWRITE: 0.003}, calls=3)})
    assert harness.load_module("metrics", "snappy_decode_ns_per_elem").read(run) is None


@pytest.mark.parametrize("metric", [r[0] for r in READERS])
def test_reader_reads_none_from_a_port_without_the_tracer(monkeypatch, metric):
    for name in ("spans", "counters"):
        monkeypatch.delattr(profiling, name)
    run = _run({"compress": _window({"snappy_encode_kernel": 1.0}, calls=4),
                "decompress": _window({DECODE: 1.0}, calls=4)})
    assert harness.load_module("metrics", metric).read(run) is None
