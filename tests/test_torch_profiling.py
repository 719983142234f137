"""The port's tracer (tpucomp_torch/utils/profiling.py): off it records
nothing and enters no profiler range; on, under ``torch.profiler``, the
spans of each layer nest and land in the Chrome trace; the benchmark's
unchanged trace reduction names idle gaps by them; the per-layer metrics
that read the records.  Tests marked ``cuda`` drive the kernel wrappers'
spans and the kernels' counters on the card and skip without one."""

import ctypes
import json
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpucomp_torch
from benchmark import harness
from benchmark import trace as btrace
from tpucomp_torch.utils import profiling

CPU = [ProfilerActivity.CPU]


@pytest.fixture
def tracer():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def _rows(n=3, c=1024, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 6, (n, c // 4), dtype=np.int32).repeat(4, 1)[:, : c // 4]
    arr = np.ascontiguousarray(words).view(np.uint8).reshape(n, c)
    return tpucomp_torch.ChunkBatch(torch.from_numpy(arr.copy()), torch.full((n,), c, dtype=torch.int32))


def _batch_round_trip(codec, opts):
    batch = _rows()
    comp = codec.compress(batch, opts)
    data, statuses = codec.decompress(comp, batch.data.shape[1], opts)
    assert torch.equal(data.data, batch.data) and not statuses.any()


def _manager_round_trip():
    buf = _rows().data.reshape(-1)[:2500]
    art, size = tpucomp_torch.LZ4Manager(uncomp_chunk_size=1024, device="cpu").compress(buf)
    out, statuses = tpucomp_torch.create_manager(art[:size]).decompress(art[:size])
    assert torch.equal(out, buf) and not statuses.any()


PATHS = {
    "lz4": lambda: _batch_round_trip(tpucomp_torch.lz4_codec, tpucomp_torch.LZ4Opts()),
    "snappy": lambda: _batch_round_trip(tpucomp_torch.snappy_codec, tpucomp_torch.SnappyOpts()),
    "cascaded": lambda: _batch_round_trip(tpucomp_torch.cascaded_codec, tpucomp_torch.CascadedOpts()),
    "manager": _manager_round_trip,
}

# the spans each CPU path records (the plain route stops at the codec routing),
# child -> parent
EXPECTED = {
    "lz4": {"compress.api": None, "compress.lz4": "compress.api",
            "decompress.api": None, "decompress.lz4": "decompress.api"},
    "snappy": {"compress.api": None, "compress.snappy": "compress.api",
               "decompress.api": None, "decompress.snappy": "decompress.api"},
    "cascaded": {"compress.api": None, "compress.cascaded": "compress.api",
                 "decompress.api": None, "decompress.cascaded": "decompress.api"},
    "manager": {"compress.manager": None, "compress.manager.stage": "compress.manager",
                "compress.lz4": "compress.manager", "compress.manager.assemble": "compress.manager",
                "decompress.manager.open": None, "decompress.manager": None,
                "decompress.manager.read_header": "decompress.manager",
                "decompress.manager.slice": "decompress.manager", "decompress.lz4": "decompress.manager"},
}


def _tracing() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _no_range(*a, **k):
    raise AssertionError("a profiler range was entered while tracing was off")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_off_records_nothing_and_enters_no_range(tracer, monkeypatch, path):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_range)
    assert not _tracing()
    PATHS[path]()
    assert tracer.spans() == [] and tracer.counters() == {} and tracer.dropped() == 0


def test_off_span_is_the_shared_null_context(tracer):
    a, b = tracer.span("compress.api"), tracer.span("decompress.manager.slice", device=torch.device("cuda:0"))
    assert a is b
    with a as rec:
        assert rec is None
    assert tracer.counter_ptr("lz4.encode.sequences", torch.device("cpu")) is None
    assert tracer.spans() == [] and tracer.counters() == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_on_spans_nest_and_land_in_the_chrome_trace(tracer, tmp_path, path):
    with profile(activities=CPU) as prof:
        assert _tracing()
        PATHS[path]()
    assert not _tracing()
    recs = tracer.spans()
    got = {s.name: (s.parent.name if s.parent else None) for s in recs}
    assert got == EXPECTED[path]
    assert len(recs) == len(EXPECTED[path])  # one call of each
    for s in recs:
        assert s.start_ns <= s.open_ns <= s.close_ns <= s.end_ns and s.events is None and s.device_ms() is None
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(EXPECTED[path]) <= annotated


def test_a_span_stamps_its_own_cost(tracer):
    """The record's four stamps split a span's interval into its own entry,
    its body and its own exit; the body of the parent holds the child whole."""
    with profile(activities=CPU):
        with tracer.span("compress.api") as outer:
            with tracer.span(".launch") as inner:
                t = time.perf_counter_ns()
    assert outer.start_ns < outer.open_ns <= inner.start_ns < inner.open_ns <= t
    assert t <= inner.close_ns < inner.end_ns <= outer.close_ns < outer.end_ns
    for s in (outer, inner):
        assert s.cost_ns() == s.end_ns - s.start_ns - (s.close_ns - s.open_ns) > 0


def test_relative_names_follow_the_innermost_open_span(tracer):
    with profile(activities=CPU):
        with tracer.span(".launch"):
            pass
        with tracer.span("compress.lz4"):
            with tracer.span(".table"):
                with tracer.span(".launch"):
                    pass
    names = [s.name for s in tracer.spans()]
    assert names == ["launch", "compress.lz4", "compress.lz4.table", "compress.lz4.table.launch"]
    assert tracer.spans()[-1].root().name == "compress.lz4"


def test_records_are_capped_and_counted(tracer, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with profile(activities=CPU):
        with tracer.span("compress.api"):
            for _ in range(4):
                with tracer.span("compress.lz4"):
                    pass
    assert [s.name for s in tracer.spans()] == ["compress.api"] + ["compress.lz4"] * 2
    assert tracer.dropped() == 2
    assert tracer.spans()[2].parent is tracer.spans()[0]


def test_reset_clears_records_and_counters(tracer):
    with profile(activities=CPU):
        with tracer.span("compress.api"):
            ptr = tracer.counter_ptr("lz4.decode.sequences", torch.device("cpu"))
    ctypes.c_int64.from_address(ptr).value += 2
    assert tracer.spans() and tracer.counters() == {**dict.fromkeys(profiling.COUNTERS, 0), "lz4.decode.sequences": 2}
    tracer.reset()
    assert tracer.spans() == [] and tracer.counters() == {} and tracer.dropped() == 0


def test_counter_addresses_are_slots_of_one_buffer(tracer):
    """A kernel adds to a counter through its address: the slots of one
    int64 buffer, zeroed when made, in the order of COUNTERS."""
    dev = torch.device("cpu")
    with profile(activities=CPU):
        ptrs = [tracer.counter_ptr(n, dev) for n in profiling.COUNTERS]
        assert tracer.counter_ptr(profiling.COUNTERS[0], dev) == ptrs[0]  # made once
    assert [p - ptrs[0] for p in ptrs] == [8 * i for i in range(len(ptrs))]
    for i, p in enumerate(ptrs):
        ctypes.c_int64.from_address(p).value += 10 + i
    assert tracer.counters() == {n: 10 + i for i, n in enumerate(profiling.COUNTERS)}


def test_decode_counters_are_adjacent_slots_reset_with_the_others(tracer):
    """The decode kernel adds to ``cascaded.decode.chunks`` through its
    address and to ``.partitions_raw`` in the slot after it."""
    i = profiling.COUNTERS.index("cascaded.decode.chunks")
    assert profiling.COUNTERS[i + 1] == "cascaded.decode.partitions_raw"
    with profile(activities=CPU):
        ptr = tracer.counter_ptr("cascaded.decode.chunks", torch.device("cpu"))
    ctypes.c_int64.from_address(ptr).value += 16
    ctypes.c_int64.from_address(ptr + 8).value += 3
    want = {**dict.fromkeys(profiling.COUNTERS, 0), "cascaded.decode.chunks": 16, "cascaded.decode.partitions_raw": 3}
    assert tracer.counters() == want
    tracer.reset()
    assert tracer.counters() == {}


def test_lz4_decode_counters_are_adjacent_slots(tracer):
    """The LZ4 decode kernel adds to ``lz4.decode.sequences`` through its
    address, and to ``.handoffs`` and ``.walker_waits`` in the two slots
    after it; nothing else moves."""
    i = profiling.COUNTERS.index("lz4.decode.sequences")
    assert profiling.COUNTERS[i + 1:i + 3] == ("lz4.decode.handoffs", "lz4.decode.walker_waits")
    with profile(activities=CPU):
        ptr = tracer.counter_ptr("lz4.decode.sequences", torch.device("cpu"))
    for k, v in enumerate((5_000, 320, 41)):
        ctypes.c_int64.from_address(ptr + 8 * k).value += v
    want = {**dict.fromkeys(profiling.COUNTERS, 0), "lz4.decode.sequences": 5_000, "lz4.decode.handoffs": 320,
            "lz4.decode.walker_waits": 41}
    assert tracer.counters() == want


def test_trace_reduce_labels_gaps_with_the_port_spans():
    """The benchmark's own reduction, unchanged: an idle gap inside a port
    span nested in ``compress.call`` is labelled by the port span."""
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev("compress.window", "user_annotation", 0, 1000),
        ev("compress.call", "user_annotation", 0, 500),
        ev("compress.api", "user_annotation", 5, 490),
        ev("compress.cascaded.encode", "user_annotation", 10, 100),
        ev("compress.cascaded.encode.launch", "user_annotation", 100, 8),
        ev("cascaded_encode_kernel", "kernel", 110, 380),
        ev("compress.read_sizes", "user_annotation", 500, 300),
        ev("Memcpy DtoH", "gpu_memcpy", 790, 10),
    ]
    w = btrace.reduce({"traceEvents": events}, "compress", 1)
    assert w.ops == 2 and w.busy_s == pytest.approx(390e-6)
    assert w.idle_s["compress.cascaded.encode"] == pytest.approx(110e-6)
    assert w.idle_s["compress.read_sizes"] == pytest.approx(300e-6)
    assert w.idle_s["compress.between_calls"] == pytest.approx(200e-6)


# ---- the per-layer metrics that read the tracer's records


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _rec(name, parent, start, end, events=None, cost=0):
    """A record whose own entry and exit take ``cost`` ns each."""
    return profiling.SpanRecord(name, parent, start, end, events, start + cost, end - cost)


def _calls(phase, codec, n):
    """n calls through the batch API: api > codec > kernel wrapper > .launch,
    call k's outermost span starting at k * 1e6 ns, its first launch ending
    (10 + k) us after, each span's entry and exit taking 1 us: the port's
    host time before the launch is (10 + k) us less the api's entry, the
    launch's exit and the three entries between, (5 + k) us."""
    recs = []
    kernel = "table" if phase == "compress" and codec == "lz4" else "encode" if phase == "compress" else "decode"
    for k in range(n):
        t = k * 10**6
        api = _rec(f"{phase}.api", None, t, t + 900_000, cost=1_000)
        route = _rec(f"{phase}.{codec}", api, t + 1_000, t + 800_000, cost=1_000)
        step = _rec(f"{phase}.{codec}.{kernel}", route, t + 2_000, t + 50_000, cost=1_000)
        launch = _rec(f"{phase}.{codec}.{kernel}.launch", step, t + 4_000, t + (10 + k) * 1_000, cost=1_000)
        recs += [api, route, step, launch]
        if kernel == "table":  # the encode after the table
            enc = _rec("compress.lz4.encode", route, t + 60_000, t + 90_000, cost=1_000)
            recs += [enc, _rec("compress.lz4.encode.launch", enc, t + 70_000, t + 80_000, cost=1_000)]
    return recs


def _run(codec, windows=None):
    return harness.Run(entry=types.SimpleNamespace(config={"codec": codec}), setup_s=1.0,
                       compress_peak_bytes=None, windows=windows or {})


def _window(op_s, calls=4):
    return btrace.Window(calls=calls, window_s=1.0, busy_s=0.5, ops=2 * calls, op_s=op_s, idle_s={})


# the Cascaded kernels' names as the profiler records them, one per instantiation
ENC64 = ("void tpucomp::(anonymous namespace)::cascaded_encode_kernel<unsigned long long, false>"
         "(tpucomp::(anonymous namespace)::EncodeParams)")
ENC32 = ENC64.replace("unsigned long long", "unsigned int")
DEC64 = ("void tpucomp::(anonymous namespace)::cascaded_decode_kernel<unsigned long long>"
         "(tpucomp::(anonymous namespace)::DecodeParams)")
DEC32 = DEC64.replace("unsigned long long", "unsigned int")
IO = {"compress": (268_451_840, 41_222_144), "decompress": (41_222_144, 268_484_608)}  # bytes read, written


READERS = [
    # metric, codec, records, counters, windows, expected
    ("host_us.compress.cascaded", "cascaded", _calls("compress", "cascaded", 5), {}, None, 7.0),
    ("host_us.decompress.cascaded", "cascaded", _calls("decompress", "cascaded", 4), {}, None, 6.5),
    ("host_us.compress.lz4", "lz4", _calls("compress", "lz4", 3) + _calls("decompress", "lz4", 3), {}, None, 6.0),
    ("host_us.decompress.lz4", "lz4", _calls("decompress", "lz4", 3), {}, None, 6.0),
    ("manager_ms.compress.assemble", "lz4",
     [_rec("compress.manager.assemble", None, 0, 1, (_Event(1.0), _Event(x))) for x in (6.0, 8.5, 7.0)],
     {}, None, 6.0),
    ("manager_ms.decompress.slice", "lz4",
     [_rec("decompress.manager.slice", None, 0, 1, (_Event(0.0), _Event(x))) for x in (4.0, 4.5)]
     + [_rec("decompress.manager.read_header", None, 0, 1)], {}, None, 4.25),
    ("cascaded_wasted_chunk_pct", "cascaded", [],
     {"cascaded.encode.chunks": 400, "cascaded.encode.chunks_discarded": 260}, None, 65.0),
    ("lz4_encode_ns_per_seq", "lz4", _calls("compress", "lz4", 5), {"lz4.encode.sequences": 10_000},
     {"compress": _window({"tpucomp_lz4::(anonymous namespace)::lz4_encode_kernel(EncodeParams)": 0.008,
                           "lz_match_table_kernel": 0.02})}, 1e9 * (0.008 / 4) / (10_000 / 5)),
    ("lz4_decode_ns_per_seq", "lz4", _calls("decompress", "lz4", 2), {"lz4.decode.sequences": 3_000},
     {"decompress": _window({"lz4_decode_kernel": 0.006}, calls=3)}, 1e9 * (0.006 / 3) / (3_000 / 2)),
    ("lz_table_large_bucket_pct", "lz4", [],
     {"lz.table.positions": 2_000, "lz.table.large_bucket_positions": 680}, None, 34.0),
    ("lz4_decode_walker_wait_pct", "lz4", [],
     {"lz4.decode.sequences": 6_000, "lz4.decode.handoffs": 400, "lz4.decode.walker_waits": 100}, None, 25.0),
    ("cascaded_decode_ns_per_chunk", "cascaded", _calls("decompress", "cascaded", 4),
     {"cascaded.encode.chunks": 9_999, "cascaded.decode.chunks": 262_144},
     {"decompress": _window({DEC64: 0.006, "Memcpy DtoH (Device -> Pageable)": 0.001}, calls=5)},
     1e9 * (0.006 / 5) / (262_144 / 4)),
]


KERNEL_ROOFLINES = [
    # metric, the phase's window, expected
    ("cascaded64_encode_roofline", {"compress": _window({ENC64: 0.0024, "Memcpy DtoH (Device -> Pageable)": 0.001})},
     100.0 * sum(IO["compress"]) / 3.35e12 / (0.0024 / 4)),
    ("cascaded64_decode_roofline", {"decompress": _window({DEC64: 0.0036, ENC32: 0.5}, calls=6)},
     100.0 * sum(IO["decompress"]) / 3.35e12 / (0.0036 / 6)),
    ("cascaded64_encode_roofline", {"compress": _window({ENC32: 0.0024, DEC64: 0.003})}, None),  # no 64-bit encode
    ("cascaded64_decode_roofline", {"decompress": _window({DEC32: 0.0036})}, None),  # no 64-bit decode
    ("cascaded64_decode_roofline", {"compress": _window({DEC64: 0.0036})}, None),  # no decompress window
]


@pytest.mark.parametrize("metric,windows,want", KERNEL_ROOFLINES,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(KERNEL_ROOFLINES)])
def test_kernel_roofline_reads_one_instantiation(tracer, metric, windows, want):
    """The least time of a call's bytes at 3.35 TB/s over the 64-bit
    kernel's device time a call, the other operations and instantiations
    left out; None where no 64-bit op ran.  The port's tracer is not read."""
    run = harness.Run(entry=types.SimpleNamespace(config={"codec": "cascaded"}, io_bytes=IO.__getitem__),
                      setup_s=1.0, compress_peak_bytes=None, windows=windows)
    got = harness.load_module("metrics", metric).read(run)
    assert got is None if want is None else got == pytest.approx(want)
    if want is not None:
        assert 0 < got <= 100


def test_decode_ns_per_chunk_reads_none_without_its_counter(monkeypatch):
    """Decode spans and the kernel in the window, but no decode counter (a
    port whose decode kernel counts nothing): None."""
    monkeypatch.setattr(profiling, "spans", lambda: _calls("decompress", "cascaded", 4))
    monkeypatch.setattr(profiling, "counters", lambda: {"cascaded.encode.chunks": 65_536})
    run = _run("cascaded", {"decompress": _window({DEC32: 0.006}, calls=5)})
    assert harness.load_module("metrics", "cascaded_decode_ns_per_chunk").read(run) is None


def test_walker_wait_pct_reads_none_without_handoffs(monkeypatch):
    """Sequences counted but no hand-off (a port whose decode kernel walks
    and copies on one warp): None."""
    monkeypatch.setattr(profiling, "counters", lambda: {"lz4.decode.sequences": 6_000})
    assert harness.load_module("metrics", "lz4_decode_walker_wait_pct").read(_run("lz4")) is None


@pytest.mark.parametrize("metric,codec,records,counts,windows,want", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_the_records(monkeypatch, metric, codec, records, counts, windows, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert harness.load_module("metrics", metric).read(_run(codec, windows)) == pytest.approx(want)


@pytest.mark.parametrize("metric,codec,records,counts,windows,want", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_none_without_records(tracer, metric, codec, records, counts, windows, want):
    assert harness.load_module("metrics", metric).read(_run(codec, windows)) is None


@pytest.mark.parametrize("metric", [r[0] for r in READERS])
def test_reader_reads_none_from_a_port_without_the_tracer(monkeypatch, metric):
    """The parent of the tracer's change has ``profiling`` without
    ``spans`` and ``counters``: the readers give None and do not raise."""
    for name in ("spans", "counters"):
        monkeypatch.delattr(profiling, name)
    codec = "lz4" if "lz4" in metric or "manager" in metric else "cascaded"
    run = _run(codec, {"compress": _window({"lz4_encode_kernel": 1.0}),
                       "decompress": _window({"lz4_decode_kernel": 1.0})})
    assert harness.load_module("metrics", metric).read(run) is None


# ---- on the card: the wrappers' spans and the kernels' counters


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["lz4", "snappy", "cascaded"])
def test_card_wrappers_span_and_kernels_count(tracer, cuda, codec):
    from tpucomp_torch.utils.corpus import load_corpus

    c = 65536
    arr = np.frombuffer(load_corpus(64 * c), np.uint8).reshape(64, c)
    batch = tpucomp_torch.ChunkBatch(torch.from_numpy(arr.copy()).to(cuda),
                                     torch.full((64,), c, dtype=torch.int32, device=cuda))
    api = getattr(tpucomp_torch, f"{codec}_codec")
    opts = {"lz4": tpucomp_torch.LZ4Opts, "snappy": tpucomp_torch.SnappyOpts,
            "cascaded": tpucomp_torch.CascadedOpts}[codec]()
    comp = api.compress(batch, opts)  # off: no buffer, no record
    assert tracer.spans() == [] and tracer.counters() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        comp_on = api.compress(batch, opts)
        data, statuses = api.decompress(comp_on, c, opts)
        torch.cuda.synchronize()
    assert torch.equal(comp_on.lengths, comp.lengths) and torch.equal(data.data, batch.data)
    names = {s.name for s in tracer.spans()}
    kernels = {"lz4": ("table", "encode"), "snappy": ("table", "encode"), "cascaded": ("encode",)}[codec]
    for k in kernels:
        assert {f"compress.{codec}.{k}", f"compress.{codec}.{k}.launch"} <= names
    assert {f"decompress.{codec}.decode", f"decompress.{codec}.decode.launch"} <= names
    counts = tracer.counters()
    if codec == "cascaded":
        layers = comp_on.data[:, :3].to(torch.int64)
        raw = int(((layers[:, 0] | layers[:, 1] << 8 | layers[:, 2] << 16) == 0).sum())
        assert counts["cascaded.encode.partitions_raw"] == raw
        kept = (64 - raw) * (c // opts.chunk_size)
        assert counts["cascaded.encode.chunks"] - counts["cascaded.encode.chunks_discarded"] == kept
        assert (counts["cascaded.decode.chunks"], counts["cascaded.decode.partitions_raw"]) == (kept, raw)
    elif codec == "lz4":
        assert counts["lz4.encode.sequences"] == counts["lz4.decode.sequences"] > 64
    else:
        assert counts["snappy.decode.elements"] >= counts["snappy.encode.sequences"] > 64


@pytest.mark.cuda
def test_card_64bit_cascaded_kernels_count_and_read_as_the_benchmark_reads_them(tracer, cuda):
    """The benchmark's int64 timestamp configuration on the card, one call a
    phase in the benchmark's traced windows: the streams equal the plain
    reference's and restore; the decode kernel counts every chunk and no raw
    partition; the per-kernel roofline readers find the 64-bit kernels by
    their names and read at most 100%, and the decode reader reads a time a
    chunk."""
    from benchmark.entries.batch import port_opts, rows_wrong
    from benchmark.reference import cascaded as ref

    root = harness.ROOT
    config = json.loads((root / "benchmark" / "configs" / "cascaded-int64.json").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / "batch-timestamps.json").read_text())
    rows, c = 64, int(config["partition_bytes"])
    raw = harness.load_module("data", traffic["data"]).make(rows * c, int(traffic["data_seed"]), root, {})
    raw = harness.load_module("seed", config["seed_transform"]).apply(raw, 2**31 + 12345)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(rows, c).to(cuda)
    lengths = torch.full((rows,), c, dtype=torch.int32, device=cuda)
    codec, opts = tpucomp_torch.cascaded_codec, port_opts(config)
    batch = tpucomp_torch.ChunkBatch(data, lengths)
    comp = codec.compress(batch, opts)  # off: no buffer, no record
    assert tracer.counters() == {}
    windows, out = {}, {}

    def loop(phase):
        def calls(span):
            with span(f"{phase}.call"):
                out[phase] = codec.compress(batch, opts) if phase == "compress" else codec.decompress(comp, c, opts)
            return types.SimpleNamespace(calls=1)
        return calls

    for phase in ("compress", "decompress"):
        _, windows[phase] = btrace.profile(phase, loop(phase), lambda: None)
    counts = tracer.counters()
    ref_comp, ref_sizes = ref.compress(data, lengths, config["opts"])
    assert rows_wrong(out["compress"].data, out["compress"].lengths, ref_comp, ref_sizes) == 0
    restored, statuses = out["decompress"]
    assert torch.equal(restored.data, data) and not statuses.any()
    assert counts["cascaded.decode.chunks"] == rows * c // opts.chunk_size
    assert counts["cascaded.decode.partitions_raw"] == counts["cascaded.encode.partitions_raw"] == 0
    stream_bytes = int(comp.lengths.to(torch.int64).sum())
    io = {"compress": (rows * c + 4 * rows, stream_bytes + 4 * rows),
          "decompress": (stream_bytes + 4 * rows, rows * c + 8 * rows)}
    run = harness.Run(entry=types.SimpleNamespace(config=config, io_bytes=io.__getitem__), setup_s=0.0,
                      compress_peak_bytes=None, windows=windows)
    names = sorted(windows["compress"].op_s) + sorted(windows["decompress"].op_s)
    for metric in ("cascaded64_encode_roofline", "cascaded64_decode_roofline"):
        got = harness.load_module("metrics", metric).read(run)
        assert got is not None and 0 < got <= 100, (metric, got, names)
    assert harness.load_module("metrics", "cascaded_decode_ns_per_chunk").read(run) > 0
