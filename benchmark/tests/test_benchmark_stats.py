"""The metric arithmetic and the trace reduction, on made-up inputs."""

from __future__ import annotations

import pytest

from benchmark import stats, trace


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate_gbps(256 * 2**20, 100, 2.0) == pytest.approx(256 * 2**20 * 100 / 2.0 / 1e9)


def test_p95_and_the_samples_beyond_it():
    q, above = stats.p95([float(i) for i in range(1, 101)])
    assert q == pytest.approx(95.05) and above == 5
    q, above = stats.p95([float(i) for i in range(1, 201)])
    assert 190 < q < 191 and above == 10
    assert stats.p95([3.0]) == (3.0, 0)


def test_roofline_counts_each_byte_once_at_the_hbm_rate():
    assert stats.roofline_s(3.35e9, 0) == pytest.approx(1e-3)
    assert stats.roofline_s(2**28 + 4 * 4096, 10**8 + 4 * 4096) == pytest.approx((2**28 + 10**8 + 8 * 4096) / 3.35e12)


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (7.0, 7.0)]
    assert stats.union_length(iv) == 4.0
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.gaps([(-1.0, 4.0), (8.0, 11.0)], 0.0, 10.0) == [(4.0, 8.0)]  # clipped to the window


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce_reads_the_window_ops_and_idle_by_span():
    events = [
        _ev("compress.window", "user_annotation", 100, 100),
        _ev("compress.call", "user_annotation", 100, 30),
        _ev("compress.read_sizes", "user_annotation", 130, 20),
        _ev("compress.call", "user_annotation", 150, 30),
        _ev("compress.read_sizes", "user_annotation", 180, 20),
        _ev("table_kernel", "kernel", 110, 20),
        _ev("encode_kernel", "kernel", 125, 10),
        _ev("Memcpy DtoH", "gpu_memcpy", 145, 2),
        _ev("table_kernel", "kernel", 160, 20),
        _ev("compress.window", "gpu_user_annotation", 100, 100),  # not a device operation
        _ev("before", "kernel", 10, 20),  # outside the window
    ]
    w = trace.reduce({"traceEvents": events}, "compress", calls=2)
    assert w.calls == 2 and w.ops == 4
    assert w.window_s == pytest.approx(100e-6) and w.busy_s == pytest.approx(47e-6)
    assert w.idle_pct == pytest.approx(53.0)
    assert w.op_s["table_kernel"] == pytest.approx(40e-6)
    # gaps 100-110 and 147-160 fall in calls, 135-145 and 180-200 in reads
    assert w.idle_s["compress.call"] == pytest.approx(23e-6)
    assert w.idle_s["compress.read_sizes"] == pytest.approx(30e-6)


def test_reduce_needs_its_window():
    with pytest.raises(RuntimeError):
        trace.reduce([_ev("k", "kernel", 0, 1)], "decompress", calls=1)
