#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpucomp_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main paths, Cascaded, LZ4, Snappy and the high-level
managers, in phases, each printing one line (any failure raises and exits
non-zero):

1. device: the card's name, and its power limit from nvidia-smi
2. build: the CUDA kernels from tpucomp_torch/csrc, with nvcc, timed
3. Cascaded kernel vs plain: every kernel case of tests/torch_cases.py (the test
   matrix, the rest of the option space, random options and shapes, two
   16 MB partitions) on CUDA tensors, with corrupt, damaged and garbage
   streams, through both the kernels and their plain PyTorch versions; exact equality (tolerance 0: the codec is
   lossless and every output is an integer tensor).  A few default-option
   partitions are also checked against tests/oracles/cascaded_oracle.py.
4. Cascaded main path: 256 MB of the mixed corpus and of the run-heavy corpus, as
   uint8[4096, 65536], through tpucomp_torch.cascaded_codec.compress /
   decompress on cuda:0; exact round trips, all SUCCESS, both kernels
   launched (launch counters reset just before)
5. Cascaded times: CUDA-event medians (with min and max) of the kernels, of their
   plain versions at the same shape, and of a device-to-device copy of the
   same bytes
6. LZ4 kernels vs plain: the cases of tests/torch_lz4_cases.py (strides 1,
   2 and 4; chunks from 64 B to 1 MB and one of 16 MB; the match table's
   edge rows: nearest occurrences exactly 65535 and 65536 back at its 64K
   segment seams in 70 KB and 16 MB rows, windows that agree in three of
   four bytes, all-distinct windows, tiny rows, an odd capacity; the
   oracle's streams and the golden fixtures; garbage, truncated,
   bit-flipped and hand-corrupted streams; undersized outputs; the decode
   kernel's window cases), tolerance 0: the match-table kernel against
   lz77.match_table at strides 1, 2 and 4 on every encode case, the
   encoder against _compress_plain, the decoder against _decompress_plain;
   streams of stride 1 up to 64 KB also equal the oracle's.  Then the
   table kernel and a whole compress timed on 1 MB rows of all-distinct
   windows and of zeros (each must compress in under 115 ms)
7. LZ4 main path: both corpora through tpucomp_torch.lz4_codec.compress /
   decompress; exact round trips, all SUCCESS, all three kernels launched
   (launch counters reset just before)
8. LZ4 times: the three kernels (match table, encode given the table,
   decode), a whole compress, the plain versions and the torch pre-pass
   the plain encoder runs (timed once each; plain encode 512 chunks at a
   time) and a device copy; the kernels are held to the plain versions on
   the whole batch; the peak memory of one compress; the decode time per
   sequence
9. profile: one step of each main path (Cascaded, LZ4, Snappy) under
   torch.profiler: device time by stage (LZ: table, encode, decode), the
   largest kernels and the device's idle share; the Cascaded output
   zero-fills timed alone
10. Snappy kernels vs plain: the cases of tests/torch_snappy_cases.py
   (chunks from 64 B to 1 MB and one of 16 MB; the match table's edge rows
   with the Snappy window, 32768 and 32769 back; the oracle's streams, the
   golden fixtures, foreign large-token streams, crafted edge streams;
   garbage, truncated, bit-flipped and damaged streams; undersized
   outputs, outputs that go back across earlier elements, and a 1 MB row
   of them, timed; the decode kernel's window cases), tolerance 0, the
   match table with the Snappy limits included; streams up to 64 KB also
   equal the oracle's; the 1 MB worst-case rows timed as in phase 6
11. Snappy main path: both corpora through tpucomp_torch.snappy_codec;
   exact round trips, all SUCCESS, all three Snappy kernels launched and
   no other codec's (launch counters reset just before)
12. Snappy times: as phase 8, with the Snappy limits; the decode time per
   element
13. high-level managers: the 256 MB mixed corpus as one buffer through
   LZ4Manager, SnappyManager and CascadedManager at their default chunk
   sizes, create_manager on each artifact, exact round trips, the
   codec's kernels launched; compress and decompress wall times, with
   the artifact assembly and the stream slicing timed alone
14. scaling: the LZ4 and Snappy encode walks (given the table) and decode
   kernels on the first 1,056, 2,112 and 4,096 chunks of mixed (~8, 16
   and 31 warps per SM): time per sequence or element against the warps
   per SM

Then one JSON line of per-kernel results, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B, C = 4096, 65536  # 256 MB in 64 KB partitions
ITERS, WARMUP = 7, 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
LZ4_PLAIN_SLICE = 512  # the plain LZ4 and Snappy encoders run the batch 512 chunks at a time (memory)
SCALING_CHUNKS = (1056, 2112, 4096)  # ~8, 16 and 31 resident warps per SM on an H100's 132 SMs


def bound_ms(nbytes: int) -> float:
    """The least time to move ``nbytes`` through device memory once."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _lz4_table(data, lengths, stride=1):
    """The match-table kernel with the LZ4 limits, as codecs.lz4.compress
    launches it."""
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.kernels import lz77_cuda

    return lz77_cuda.match_table(data, lengths, stride, lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH)


def _snappy_table(data, lengths):
    """The match-table kernel with the Snappy limits, as
    codecs.snappy.compress launches it."""
    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import lz77_cuda

    return lz77_cuda.match_table(data, lengths, 1, ts.MAX_OFFSET, ts.MIN_MATCH)


def _equal(name, got, want):
    """Max |got - want| over integer tensors; raises unless it is 0."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: max abs difference {err}")
    return err


def phase_matrix(dev):
    """Kernel vs plain on every case; returns the max abs error per kernel,
    the number of comparisons and the number of inputs."""
    import numpy as np
    import torch

    import torch_cases
    from oracles.cascaded_oracle import cascaded_compress_oracle
    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.core.options import opts_from_fields
    from tpucomp_torch.kernels import cascaded_cuda as kc

    err = {"encode": 0, "decode": 0}
    n_cases = 0

    def decode_both(label, comp, sizes, o, cap):
        nonlocal n_cases
        got = kc.decompress(comp, sizes, o, cap)
        want = cc._decompress_plain(comp, sizes, o, cap)
        torch.cuda.synchronize()
        for part, g, w in zip(("data", "bytes", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"{label} decode {part}", g, w))
        n_cases += 1
        return got

    rng = np.random.default_rng(0)
    cases = torch_cases.kernel_cases()
    for label, fields, arr, lens in cases:
        o = opts_from_fields(fields)
        w = torch_cases.WIDTH[fields["type"]]
        d = torch.from_numpy(arr).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        comp, sizes = kc.compress(d, ln, o)
        want = cc._compress_plain(d, ln, o)
        torch.cuda.synchronize()
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, want[0]),
                            _equal(f"{label} encode sizes", sizes, want[1]))
        n_cases += 1
        cap = arr.shape[1] - arr.shape[1] % w
        data, nbytes, status = decode_both(label, comp, sizes, o, cap)
        for i, n in enumerate(lens):  # an empty partition compresses to 0 bytes
            n = min(int(n) // w * w, cap)
            if lens[i] and (int(status[i]) != 0 or not torch.equal(data[i, :n], d[i, :n])):
                raise AssertionError(f"{label}: partition {i} does not round-trip")
        if fields == torch_cases.DEFAULT and arr.shape[1] <= 65536:
            for i in np.nonzero(lens)[0]:
                ref = cascaded_compress_oracle(arr[i, : lens[i]].tobytes(), np.int32)
                if comp[i, : int(sizes[i])].cpu().numpy().tobytes() != ref:
                    raise AssertionError(f"{label}: partition {i} differs from the oracle")
        # mismatched options, an undersized output and damaged streams
        decode_both(f"{label} other-opts", comp, sizes,
                    opts_from_fields({**fields, "num_rles": (fields["num_rles"] + 1) % 3,
                                      "num_deltas": 0}), cap)
        decode_both(f"{label} undersized", comp, sizes, o, max(w, cap // 4 // w * w))
        rows, szs = torch_cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
        decode_both(f"{label} damaged", torch.from_numpy(rows).to(dev),
                    torch.from_numpy(szs).to(dev), o, cap)

    src, src_lens = torch_cases.corrupt_source()
    o = opts_from_fields(torch_cases.DEFAULT)
    comp, sizes = kc.compress(torch.from_numpy(src).to(dev), torch.from_numpy(src_lens).to(dev), o)
    labels, rows, szs = torch_cases.corrupt_cases(comp.cpu().numpy(), sizes.cpu().numpy())
    decode_both("corrupt " + ",".join(labels), torch.from_numpy(rows).to(dev),
                torch.from_numpy(szs).to(dev), o, src.shape[1])

    try:
        kc.compress(torch.zeros(1, 64, dtype=torch.uint8, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev),
                    opts_from_fields(torch_cases.opts(type=torch_cases.LONGLONG)))
    except NotImplementedError:
        pass
    else:
        raise AssertionError("8-byte elements must raise NotImplementedError on CUDA")
    return err, n_cases, len(cases) + 1


def phase_main_path(dev, corpora):
    """The user's path at full size: exact round trips through the kernels."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.kernels import cascaded_cuda as kc

    for name, data in corpora.items():
        batch = tpucomp_torch.ChunkBatch(data, torch.full((B,), C, dtype=torch.int32, device=dev))
        before = dict(kc.LAUNCHES)
        comp = tpucomp_torch.cascaded_codec.compress(batch)
        out, status = tpucomp_torch.cascaded_codec.decompress(comp, C)
        torch.cuda.synchronize()
        for k in ("encode", "decode"):
            if kc.LAUNCHES[k] <= before[k]:
                raise AssertionError(f"{name}: the {k} kernel was not launched")
        if not (torch.equal(out.data, data) and bool((out.lengths == C).all())
                and bool((status == 0).all())):
            raise AssertionError(f"{name}: 256 MB round trip is not exact")
        total = int(comp.lengths.to(torch.int64).sum())
        fallback = float(((comp.data[:, :3] == 0).all(1)).float().mean())
        print(f"phase 4 main path {name}: 256 MB exact round trip, all SUCCESS, "
              f"ratio {B * C / total:.4f}, fallback share {fallback:.4f}", flush=True)


def phase_times(dev, corpora):
    """CUDA-event times of kernels, plain versions and a copy; returns
    (times dict, max abs err of kernel vs plain at the main shape)."""
    import torch

    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.utils.profiling import wall

    o = CascadedOpts()
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    nbytes = B * C
    times, err = {}, {"encode": 0, "decode": 0}
    for name, data in corpora.items():
        comp, sizes = kc.compress(data, lengths, o)
        t = {}
        # plain, kernel, kernel, plain: a drift in clocks shows as a spread
        t["plain_encode"] = wall(cc._compress_plain, data, lengths, o, iters=ITERS, warmup=1,
                                 bytes_processed=nbytes)
        t["kernel_encode"] = wall(kc.compress, data, lengths, o, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["kernel_decode"] = wall(kc.decompress, comp, sizes, o, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["plain_decode"] = wall(cc._decompress_plain, comp, sizes, o, C, iters=ITERS, warmup=1,
                                 bytes_processed=nbytes)
        pc, ps = cc._compress_plain(data, lengths, o)
        err["encode"] = max(err["encode"], _equal(f"{name} encode rows", comp, pc),
                            _equal(f"{name} encode sizes", sizes, ps))
        del pc, ps
        got = kc.decompress(comp, sizes, o, C)
        want = cc._decompress_plain(comp, sizes, o, C)
        for part, g, w in zip(("data", "bytes", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"{name} decode {part}", g, w))
        del got, want
        dst = torch.empty_like(data)
        t["d2d_copy"] = wall(dst.copy_, data, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        times[name] = {k: v.summary() for k, v in t.items()}
        times[name]["comp_bytes"] = int(sizes.to(torch.int64).sum())
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 5 times {name} 256 MB [4096 x 64 KB]: {line}", flush=True)
        del comp, sizes, dst
        torch.cuda.empty_cache()
    return times, err


def _lz4_decode_both(err, comp, sizes, cap, label):
    import torch

    from tpucomp_torch.codecs import lz4 as tl
    from tpucomp_torch.kernels import lz4_cuda as kl

    got = kl.decompress(comp, sizes, cap)
    want = tl._decompress_plain(comp, sizes, cap)
    torch.cuda.synchronize()
    for part, g, w in zip(("data", "lengths", "status"), got, want):
        err["decode"] = max(err["decode"], _equal(f"{label} decode {part}", g, w))
    return got


def phase_lz4_matrix(dev):
    """LZ4 kernel vs plain on every case; returns the max abs error per
    kernel and the number of comparisons."""
    import numpy as np
    import torch

    import torch_lz4_cases as cases
    from oracles.lz4_oracle import lz4_compress_oracle
    from tpucomp_torch.codecs import lz4 as tl
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.kernels import lz4_cuda as kl

    err = {"table": 0, "encode": 0, "decode": 0}
    n = 0

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rng = np.random.default_rng(2)
    _, rows, rows_len = cases.compress_rows(rng)
    encode_cases = [(f"rows stride {s}", rows, rows_len, s) for s in (1, 2, 4)]
    encode_cases += [(f"typed stride {s}", *cases.typed_rows(rng), s) for s in (2, 4)]
    encode_cases += [("merged 64 KB", *cases.merged_table_row(), 1)]
    encode_cases += [(name, arr, lens, 1) for name, arr, lens in cases.kernel_sizes(rng)]
    encode_cases += [("16 MB chunk", *cases.big_chunk(rng), 1)]
    for label, arr, lens in cases.table_rows(np.random.default_rng(21)):
        encode_cases += [(f"{label} stride {s}", arr, lens, s) for s in (1, 2, 4)]
    for label, arr, lens, stride in encode_cases:
        d, ln = cuda(arr, lens)
        for s in (1, 2, 4):  # the table at every stride, with the LZ4 limits
            err["table"] = max(err["table"], _equal(f"{label} table stride {s}", _lz4_table(d, ln, s),
                                                    lz77.match_table(d, ln, s)))
            n += 1
        comp, sizes = kl.encode(d, ln, _lz4_table(d, ln, stride))
        want = tl._compress_plain(d, ln, stride)
        torch.cuda.synchronize()
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, want[0]),
                            _equal(f"{label} encode sizes", sizes, want[1]))
        del want
        if stride == 1 and arr.shape[1] <= 65536:
            for i in range(len(lens)):
                if comp[i, : int(sizes[i])].cpu().numpy().tobytes() != \
                        lz4_compress_oracle(arr[i, : lens[i]].tobytes()):
                    raise AssertionError(f"{label}: chunk {i} differs from the oracle")
        c = arr.shape[1]
        out, olen, status = _lz4_decode_both(err, comp, sizes, c, label)
        if bool(status.any()) or not torch.equal(olen, ln) or not torch.equal(
                out, d * (torch.arange(c, device=dev)[None, :] < ln[:, None])):
            raise AssertionError(f"{label}: the kernels' round trip is not exact")
        _lz4_decode_both(err, comp, sizes, max(1, c // 4), f"{label} undersized")
        n += 3
        if label == "rows stride 1":
            _lz4_decode_both(err, *cuda(*cases.oracle_streams(arr, lens, comp.shape[1])), c, "oracle streams")
            labels, bad, bad_sizes = cases.corrupt_streams(comp[0].cpu().numpy(), int(sizes[0]))
            _lz4_decode_both(err, *cuda(bad, bad_sizes), c, "corrupt " + ",".join(labels))
            n += 2
        del d, ln, comp, sizes, out
    names, comp, sizes, outs = cases.golden_streams()
    out, olen, status = _lz4_decode_both(err, *cuda(comp, sizes), max(map(len, outs)), "golden")
    for i, want in enumerate(outs):
        if int(status[i]) or out[i, : int(olen[i])].cpu().numpy().tobytes() != want:
            raise AssertionError(f"golden {names[i]} does not decode")
    comp, sizes, cap = cases.s_max_overrun()
    _lz4_decode_both(err, *cuda(comp, sizes), cap, "past the sequence bound")
    n += 2
    for label, comp, sizes, cap in cases.window_cases(cases.window_rows(np.random.default_rng(7)),
                                                      lz4_compress_oracle):
        _lz4_decode_both(err, *cuda(comp, sizes), cap, label)
        n += 1
    for seed in range(4):
        comps, szs = cases.garbage_batch(np.random.default_rng(100 + seed), 64, cases.C + 600)
        _lz4_decode_both(err, *cuda(comps, szs), cases.C, f"garbage seed {seed}")
        n += 1
    _time_worst_row(_lz4_table, tl.compress, dev, "LZ4")
    return err, n, len(encode_cases)


def _time_worst_row(table, compress, dev, label):
    """CUDA-event times of the table kernel and of a whole compress on the
    rows that stress the table most: 1 MB of all-distinct 4-byte windows
    (every position a key of its own: the longest search a hash chain
    would walk, and no early end for any search), and 1 MB of zeros (every
    window equal)."""
    import numpy as np
    import torch

    import torch_lz4_cases as cases
    from tpucomp_torch.utils.profiling import wall

    c = 1 << 20
    for name, row in (("all-distinct windows", cases.unique_windows(np.random.default_rng(31), c)),
                      ("zeros", np.zeros(c, np.uint8))):
        d = torch.from_numpy(row[None, :].copy()).to(dev)
        ln = torch.full((1,), c, dtype=torch.int32, device=dev)
        tt = wall(table, d, ln, iters=ITERS, warmup=WARMUP)
        tc = wall(compress, d, ln, iters=ITERS, warmup=WARMUP)
        print(f"  {label} 1 MB row of {name}: table kernel {tt.median_ms:.3f} ms (min {tt.min_ms:.3f}, "
              f"max {tt.max_ms:.3f}), whole compress {tc.median_ms:.3f} ms (min {tc.min_ms:.3f}, "
              f"max {tc.max_ms:.3f})", flush=True)
        if tc.median_ms >= 115.0:
            raise AssertionError(f"{label}: the 1 MB {name} row takes {tc.median_ms:.3f} ms to compress")


def phase_lz4_main_path(corpora):
    """The user's LZ4 path at full size: exact round trips through the kernels."""
    import torch

    import tpucomp_torch

    for name, data in corpora.items():
        batch = tpucomp_torch.ChunkBatch(data, torch.full((B,), C, dtype=torch.int32, device=data.device))
        comp = tpucomp_torch.lz4_codec.compress(batch)
        out, status = tpucomp_torch.lz4_codec.decompress(comp, C)
        torch.cuda.synchronize()
        if not (torch.equal(out.data, data) and bool((out.lengths == C).all())
                and not bool(status.any())):
            raise AssertionError(f"LZ4 {name}: 256 MB round trip is not exact")
        total = int(comp.lengths.to(torch.int64).sum())
        print(f"phase 7 LZ4 main path {name}: 256 MB exact round trip, all SUCCESS, "
              f"ratio {B * C / total:.4f}", flush=True)


def _timed_once(fn, *args, nbytes: int):
    """(result, WallResult) of one call timed with CUDA events."""
    import torch

    from tpucomp_torch.utils.profiling import WallResult

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, WallResult([start.elapsed_time(end)], nbytes)


def phase_lz4_times(corpora):
    """CUDA-event times of the LZ4 kernels (match table, encode, decode),
    of a whole compress, of the plain versions and of the torch pre-pass
    that the plain encoder still runs, and a copy, with the kernels held
    to the plain versions; returns (times dict, max abs err per kernel)."""
    import torch

    from tpucomp_torch.codecs import lz4 as tl
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.utils.profiling import wall

    nbytes = B * C

    def plain_encode(data, lengths):
        parts = [tl._compress_plain(data[i : i + LZ4_PLAIN_SLICE], lengths[i : i + LZ4_PLAIN_SLICE])
                 for i in range(0, B, LZ4_PLAIN_SLICE)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    times, err = {}, {"table": 0, "encode": 0, "decode": 0}
    for name, data in corpora.items():
        lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
        t = {}
        # the plain table, and the torch pre-pass the CUDA path no longer runs, timed once each
        (want_tbl, t["plain_table"]) = _timed_once(lz77.match_table, data, lengths, nbytes=nbytes)
        _, t["old_prepass"] = _timed_once(lz77.candidate_tables, data, lengths, nbytes=nbytes)
        tbl = _lz4_table(data, lengths)
        err["table"] = max(err["table"], _equal(f"LZ4 {name} table", tbl, want_tbl))
        del want_tbl
        comp, sizes = kl.encode(data, lengths, tbl)
        (pc, ps), t["plain_encode"] = _timed_once(plain_encode, data, lengths, nbytes=nbytes)
        t["kernel_table"] = wall(_lz4_table, data, lengths, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        t["kernel_encode"] = wall(kl.encode, data, lengths, tbl, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["kernel_decode"] = wall(kl.decompress, comp, sizes, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        want, t["plain_decode"] = _timed_once(tl._decompress_plain, comp, sizes, C, nbytes=nbytes)
        del tbl
        t["compress"] = wall(tl.compress, data, lengths, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        err["encode"] = max(err["encode"], _equal(f"LZ4 {name} encode rows", comp, pc),
                            _equal(f"LZ4 {name} encode sizes", sizes, ps))
        got = kl.decompress(comp, sizes, C)
        for part, g, w in zip(("data", "lengths", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"LZ4 {name} decode {part}", g, w))
        del pc, ps, got, want
        seqs, steps, total, ok = tl._delimit(comp, sizes, C, comp.shape[1] // 3 + 2)
        literal_bytes = int(seqs[1].sum())
        del seqs
        if not bool(ok.all()) or not bool((total == C).all()):
            raise AssertionError(f"LZ4 {name}: the streams do not parse")
        dst = torch.empty_like(data)
        t["d2d_copy"] = wall(dst.copy_, data, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        times[name] = {k: v.summary() for k, v in t.items()}
        times[name]["comp_bytes"] = int(sizes.to(torch.int64).sum())
        times[name]["sequences"] = int(steps.sum())
        times[name]["literal_bytes"] = literal_bytes
        times[name]["compress_peak_mb"] = _peak_compress(tl.compress, data, lengths)
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 8 LZ4 times {name} 256 MB [4096 x 64 KB] (plain versions timed once, "
              f"encode {LZ4_PLAIN_SLICE} chunks at a time): {line}; "
              f"{times[name]['sequences']} sequences, {times[name]['comp_bytes']} stream bytes; peak memory of "
              f"one compress {times[name]['compress_peak_mb']:.1f} MB above its inputs; decode "
              f"{_ns_per_step(t['kernel_decode'], steps)} ns per sequence of one chunk's walk", flush=True)
        del comp, sizes, dst, steps, total, ok
        torch.cuda.empty_cache()
    return times, err


def _ns_per_step(t, steps) -> str:
    """A decode kernel's median time over the mean (and the largest) count
    of steps per chunk: the time of one step of one chunk's walk, as all
    chunks walk at once."""
    return (f"{t.median_ms * 1e6 / float(steps.double().mean()):.1f} "
            f"({t.median_ms * 1e6 / int(steps.max()):.1f} over the longest chunk's {int(steps.max())})")


def _snappy_tables(data, lengths):
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.codecs import snappy as ts

    return lz77.candidate_tables(data, lengths, max_offset=ts.MAX_OFFSET, end_margin=ts.MIN_MATCH)


def _snappy_decode_both(err, comp, sizes, cap, label):
    import torch

    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks

    got = ks.decompress(comp, sizes, cap)
    want = ts._decompress_plain(comp, sizes, cap)
    torch.cuda.synchronize()
    for part, g, w in zip(("data", "lengths", "status"), got, want):
        err["decode"] = max(err["decode"], _equal(f"{label} decode {part}", g, w))
    return got


def phase_snappy_matrix(dev):
    """Snappy kernel vs plain on every case; returns the max abs error per
    kernel, the number of comparisons and the number of encode inputs."""
    import numpy as np
    import torch

    import torch_snappy_cases as cases
    from oracles.snappy_oracle import snappy_compress_oracle
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    err = {"table": 0, "encode": 0, "decode": 0}
    n = 0

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rng = np.random.default_rng(3)
    encode_cases = [("rows", *cases.compress_rows(rng)[1:]), ("window 64 KB", *cases.window_row()),
                    ("128 KB rows", *cases.large_rows(rng))]
    encode_cases += [(name, arr, lens) for name, arr, lens in cases.kernel_sizes(rng)]
    encode_cases += [("16 MB chunk", *cases.big_chunk(rng))]
    table_cases = cases.table_rows(np.random.default_rng(22))
    for label, arr, lens in encode_cases + table_cases:
        d, ln = cuda(arr, lens)
        tbl = _snappy_table(d, ln)
        err["table"] = max(err["table"], _equal(f"Snappy {label} table", tbl,
                                                lz77.match_table(d, ln, 1, ts.MAX_OFFSET, ts.MIN_MATCH)))
        comp, sizes = ks.encode(d, ln, tbl)
        want = ts._compress_plain(d, ln)
        n += 1
        del tbl
        torch.cuda.synchronize()
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, want[0]),
                            _equal(f"{label} encode sizes", sizes, want[1]))
        del want
        if arr.shape[1] <= 65536:
            for i in range(len(lens)):
                if comp[i, : int(sizes[i])].cpu().numpy().tobytes() != \
                        snappy_compress_oracle(arr[i, : lens[i]].tobytes()):
                    raise AssertionError(f"Snappy {label}: chunk {i} differs from the oracle")
        c = arr.shape[1]
        out, olen, status = _snappy_decode_both(err, comp, sizes, c, label)
        if bool(status.any()) or not torch.equal(olen, ln) or not torch.equal(
                out, d * (torch.arange(c, device=dev)[None, :] < ln[:, None])):
            raise AssertionError(f"Snappy {label}: the kernels' round trip is not exact")
        _snappy_decode_both(err, comp, sizes, max(1, c // 4), f"{label} undersized")
        n += 3
        if label == "rows":
            _snappy_decode_both(err, *cuda(*cases.oracle_streams(arr, lens, comp.shape[1])), c, "oracle streams")
            bad, bad_sizes = cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
            _snappy_decode_both(err, *cuda(bad, bad_sizes), c, "damaged")
            n += 2
        del d, ln, comp, sizes, out
    names, comp, sizes, outs = cases.golden_streams()
    out, olen, status = _snappy_decode_both(err, *cuda(comp, sizes), max(map(len, outs)), "golden")
    labels, comp, sizes, outs2 = cases.foreign_streams(rng)
    out2, olen2, status2 = _snappy_decode_both(err, *cuda(comp, sizes), 4096, "foreign")
    for (o, ol, st), nm, ws in (((out, olen, status), names, outs), ((out2, olen2, status2), labels, outs2)):
        for i, w in enumerate(ws):
            if int(st[i]) or o[i, : int(ol[i])].cpu().numpy().tobytes() != w:
                raise AssertionError(f"Snappy {nm[i]} does not decode")
    n += 2
    for labels, comp, sizes in cases.crafted_streams():
        _, olen, status = _snappy_decode_both(err, *cuda(comp, sizes), cases.CRAFTED_CAP,
                                              "crafted " + ",".join(labels))
        for i, name in enumerate(labels):
            if (int(status[i]), int(olen[i])) != cases.CRAFTED_EXPECT[name]:
                raise AssertionError(f"Snappy crafted {name}: status {int(status[i])} length {int(olen[i])}")
        n += 1
    comp, sizes, cap = cases.long_back_row()
    comp, sizes = cuda(comp, sizes)
    _snappy_decode_both(err, comp, sizes, cap, "long back row")
    t = wall(ks.decompress, comp, sizes, cap, iters=ITERS, warmup=WARMUP)
    print(f"  Snappy decode of the 1 MB row rewritten by start: {t.median_ms:.3f} ms "
          f"(min {t.min_ms:.3f}, max {t.max_ms:.3f})", flush=True)
    n += 1
    for label, comp, sizes, cap in cases.window_cases(np.random.default_rng(7)):
        _snappy_decode_both(err, *cuda(comp, sizes), cap, label)
        n += 1
    for seed in range(4):
        comps, szs = cases.garbage_batch(np.random.default_rng(100 + seed), 64, cases.C + 600)
        _snappy_decode_both(err, *cuda(comps, szs), cases.C, f"garbage seed {seed}")
        n += 1
    _time_worst_row(_snappy_table, ts.compress, dev, "Snappy")
    return err, n, len(encode_cases) + len(table_cases)


def phase_snappy_main_path(corpora):
    """The user's Snappy path at full size: exact round trips through the kernels."""
    import torch

    import tpucomp_torch

    for name, data in corpora.items():
        batch = tpucomp_torch.ChunkBatch(data, torch.full((B,), C, dtype=torch.int32, device=data.device))
        comp = tpucomp_torch.snappy_codec.compress(batch)
        out, status = tpucomp_torch.snappy_codec.decompress(comp, C)
        torch.cuda.synchronize()
        if not (torch.equal(out.data, data) and bool((out.lengths == C).all())
                and not bool(status.any())):
            raise AssertionError(f"Snappy {name}: 256 MB round trip is not exact")
        total = int(comp.lengths.to(torch.int64).sum())
        print(f"phase 11 Snappy main path {name}: 256 MB exact round trip, all SUCCESS, "
              f"ratio {B * C / total:.4f}", flush=True)


def phase_snappy_times(corpora):
    """CUDA-event times of the Snappy kernels (match table, encode, decode),
    of a whole compress, of the plain versions and of the torch pre-pass
    that the plain encoder still runs, and a copy, with the kernels held
    to the plain versions; returns (times dict, max abs err per kernel).  Also counts the elements of the
    streams and the sequences of the parse (runs of copy elements with one
    offset; plus each chunk's last, literal-only sequence)."""
    import torch

    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    nbytes = B * C

    def plain_encode(data, lengths):
        parts = [ts._compress_plain(data[i : i + LZ4_PLAIN_SLICE], lengths[i : i + LZ4_PLAIN_SLICE])
                 for i in range(0, B, LZ4_PLAIN_SLICE)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    times, err = {}, {"table": 0, "encode": 0, "decode": 0}
    for name, data in corpora.items():
        lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
        t = {}
        # the plain table, and the torch pre-pass the CUDA path no longer runs, timed once each
        (want_tbl, t["plain_table"]) = _timed_once(lz77.match_table, data, lengths, 1, ts.MAX_OFFSET, ts.MIN_MATCH,
                                                   nbytes=nbytes)
        _, t["old_prepass"] = _timed_once(_snappy_tables, data, lengths, nbytes=nbytes)
        tbl = _snappy_table(data, lengths)
        err["table"] = max(err["table"], _equal(f"Snappy {name} table", tbl, want_tbl))
        del want_tbl
        comp, sizes = ks.encode(data, lengths, tbl)
        (pc, ps), t["plain_encode"] = _timed_once(plain_encode, data, lengths, nbytes=nbytes)
        t["kernel_table"] = wall(_snappy_table, data, lengths, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        t["kernel_encode"] = wall(ks.encode, data, lengths, tbl, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["kernel_decode"] = wall(ks.decompress, comp, sizes, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        want, t["plain_decode"] = _timed_once(ts._decompress_plain, comp, sizes, C, nbytes=nbytes)
        del tbl
        t["compress"] = wall(ts.compress, data, lengths, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        err["encode"] = max(err["encode"], _equal(f"Snappy {name} encode rows", comp, pc),
                            _equal(f"Snappy {name} encode sizes", sizes, ps))
        got = ks.decompress(comp, sizes, C)
        for part, g, w in zip(("data", "lengths", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"Snappy {name} decode {part}", g, w))
        del pc, ps, got, want
        (_, lit_len, _, mlen, off), steps, total, ok = ts._delimit(comp, sizes, C, comp.shape[1] // 2 + 2)
        literal_bytes = int(lit_len.sum())
        del lit_len
        if not bool(ok.all()) or not bool((total == C).all()):
            raise AssertionError(f"Snappy {name}: the streams do not parse")
        cont = torch.zeros_like(mlen, dtype=torch.bool)
        cont[:, 1:] = (mlen[:, :-1] > 0) & (off[:, 1:] == off[:, :-1])
        sequences = int(((mlen > 0) & ~cont).sum()) + B
        del mlen, off, cont
        dst = torch.empty_like(data)
        t["d2d_copy"] = wall(dst.copy_, data, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        times[name] = {k: v.summary() for k, v in t.items()}
        times[name]["comp_bytes"] = int(sizes.to(torch.int64).sum())
        times[name]["elements"] = int(steps.sum())
        times[name]["sequences"] = sequences
        times[name]["literal_bytes"] = literal_bytes
        times[name]["compress_peak_mb"] = _peak_compress(ts.compress, data, lengths)
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 12 Snappy times {name} 256 MB [4096 x 64 KB] (plain versions timed once, "
              f"encode {LZ4_PLAIN_SLICE} chunks at a time): {line}; {times[name]['elements']} elements, "
              f"{sequences} sequences, {times[name]['comp_bytes']} stream bytes; peak memory of one compress "
              f"{times[name]['compress_peak_mb']:.1f} MB above its inputs; decode "
              f"{_ns_per_step(t['kernel_decode'], steps)} ns per element of one chunk's walk", flush=True)
        del comp, sizes, dst, steps, total, ok
        torch.cuda.empty_cache()
    return times, err


def phase_scaling(corpora):
    """The LZ4 and Snappy encode (the walk alone, given the match table) and
    decode kernels on the first 1,056,
    2,112 and 4,096 chunks of the mixed batch: about 8, 16 and 31 warps per
    SM, all resident at once.  The time per step of one chunk's walk is the
    kernel's median over the mean (and the largest) count of steps per
    chunk: sequences for LZ4 (both kernels) and Snappy encode, elements
    for Snappy decode.  Flat across the sizes: the walk waits on latency;
    growing with the warps per SM: it waits for issue slots.  Returns
    {"<codec> <kernel>": [row per size]}."""
    import torch

    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"]
    lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    result = {}
    for codec, kern, table in (("lz4", kl, _lz4_table), ("snappy", ks, _snappy_table)):
        tbl = table(data, lengths)
        comp, sizes = kern.encode(data, lengths, tbl)
        elements, sequences = _walk_steps(codec, comp, sizes)
        for k, unit, steps in (("encode", "sequence", sequences),
                               ("decode", "sequence" if codec == "lz4" else "element", elements)):
            rows = []
            for n in SCALING_CHUNKS:
                if k == "encode":
                    t = wall(kern.encode, data[:n], lengths[:n], tbl[:n], iters=ITERS, warmup=WARMUP)
                else:
                    t = wall(kern.decompress, comp[:n], sizes[:n], C, iters=ITERS, warmup=WARMUP)
                mean, most = float(steps[:n].double().mean()), int(steps[:n].max())
                rows.append({"chunks": n, "warps_per_sm": n / sms, "median_ms": t.median_ms,
                             "min_ms": t.min_ms, "max_ms": t.max_ms, f"{unit}s_per_chunk": mean,
                             f"most_{unit}s": most, f"ns_per_{unit}": t.median_ms * 1e6 / mean,
                             f"ns_per_{unit}_longest": t.median_ms * 1e6 / most})
            result[f"{codec} {k}"] = rows
            line = "; ".join(f"{r['chunks']} chunks ({r['warps_per_sm']:.1f} warps/SM): {r['median_ms']:.3f} ms "
                             f"({r['min_ms']:.3f}-{r['max_ms']:.3f}), {r[f'ns_per_{unit}']:.1f} ns per {unit} "
                             f"(mean {r[f'{unit}s_per_chunk']:.0f} per chunk), {r[f'ns_per_{unit}_longest']:.1f} "
                             f"over the longest chunk's {r[f'most_{unit}s']}" for r in rows)
            print(f"phase 14 scaling {codec} {k} mixed: {line}", flush=True)
        del tbl, comp, sizes, elements, sequences
        torch.cuda.empty_cache()
    return result


def _walk_steps(codec, comp, sizes):
    """Per-chunk counts of a batch's streams, int64[B] each: (elements,
    sequences).  LZ4: both are its sequences.  Snappy: its elements, and
    the sequences of the parse (runs of copy elements with one offset,
    plus the chunk's last, literal-only sequence)."""
    import torch

    from tpucomp_torch.codecs import lz4 as tl
    from tpucomp_torch.codecs import snappy as ts

    if codec == "lz4":
        steps = tl._delimit(comp, sizes, C, comp.shape[1] // 3 + 2)[1]
        return steps, steps
    (_, _, _, mlen, off), steps, _, _ = ts._delimit(comp, sizes, C, comp.shape[1] // 2 + 2)
    cont = torch.zeros_like(mlen, dtype=torch.bool)
    cont[:, 1:] = (mlen[:, :-1] > 0) & (off[:, 1:] == off[:, :-1])
    return steps, ((mlen > 0) & ~cont).sum(1) + 1


def _peak_compress(compress, data, lengths):
    """Peak device memory of one ``compress(data, lengths)`` call above
    what was allocated before it, in MB (1e6 bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = compress(data, lengths)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 1e6


def phase_hlif(corpora, counters, paths):
    """The 256 MB mixed corpus as one buffer through each manager at its
    default chunk size: create_manager on the artifact, exact round trip,
    the codec's kernels launched (the counters of ``paths[codec]``) and no
    other; host-clock compress and decompress times, and the assembly and
    slicing alone (CUDA events)."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.highlevel import headers as hdr
    from tpucomp_torch.highlevel import manager as tm
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"].reshape(-1)
    n = data.numel()
    out_lines = {}
    for name, cls in (("lz4", tpucomp_torch.LZ4Manager), ("snappy", tpucomp_torch.SnappyManager),
                      ("cascaded", tpucomp_torch.CascadedManager)):
        mgr = cls()
        for counts in counters.values():
            for k in counts:
                counts[k] = 0
        walls = {}
        for stage in ("compress", "decompress"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stage == "compress":
                artifact, size = mgr.compress(data)
            else:
                mgr2 = tpucomp_torch.create_manager(artifact)
                out, statuses = mgr2.decompress(artifact)
            torch.cuda.synchronize()
            walls[stage] = (time.perf_counter() - t0) * 1e3
        if type(mgr2) is not cls or mgr2.uncomp_chunk_size != mgr.uncomp_chunk_size:
            raise AssertionError(f"HLIF {name}: create_manager gave {type(mgr2).__name__}")
        if not torch.equal(out, data) or bool(statuses.any()):
            raise AssertionError(f"HLIF {name}: 256 MB round trip is not exact")
        launched = {k: n for c in paths[name] for k, n in counters[c].items()}
        if not all(launched.values()) or any(
                any(c.values()) for k, c in counters.items() if k not in paths[name]):
            raise AssertionError(f"HLIF {name}: launches {counters}")
        # the assembly and the slicing alone, at the manager's shapes
        cs = mgr.uncomp_chunk_size
        k = n // cs
        comp, sizes = mgr._codec_compress(data.view(k, cs), torch.full((k,), cs, dtype=torch.int32,
                                                                         device=data.device))
        common = hdr.CommonHeader.unpack(artifact[: hdr.COMMON_HEADER_SIZE].cpu().numpy().tobytes())
        head = artifact[: hdr.sections_offset(mgr.format_id)].cpu().numpy().tobytes()
        cfg = mgr.configure_compression(n)
        t_asm = wall(tm._assemble_artifact, comp, sizes, head, data_off=common.comp_data_offset,
                     sections_off=hdr.sections_offset(mgr.format_id), out_max=cfg.max_compressed_buffer_size,
                     iters=ITERS, warmup=WARMUP)
        t_slice = wall(tm._slice_streams, artifact, common, hdr.sections_offset(mgr.format_id),
                       mgr._max_comp_chunk_size(cs), iters=ITERS, warmup=WARMUP)
        out_lines[name] = {"chunk": cs, "chunks": k, "artifact_bytes": size, "compress_ms": walls["compress"],
                           "decompress_ms": walls["decompress"], "assemble_ms": t_asm.median_ms,
                           "slice_ms": t_slice.median_ms, "launches": launched}
        print(f"phase 13 HLIF {name}: {n / 2**20:.0f} MB mixed as one buffer, {k} chunks of {cs} B, create_manager -> "
              f"{type(mgr2).__name__}, exact round trip, all SUCCESS, ratio {n / size:.4f}; compress "
              f"{walls['compress']:.3f} ms ({n / walls['compress'] / 1e6:.3f} GB/s), decompress "
              f"{walls['decompress']:.3f} ms ({n / walls['decompress'] / 1e6:.3f} GB/s) (host clock, one "
              f"call each); alone: assembly {t_asm.median_ms:.3f} ms, slicing {t_slice.median_ms:.3f} ms "
              f"(medians of {ITERS}); launches {launched}", flush=True)
        del artifact, out, statuses, comp, sizes
        torch.cuda.empty_cache()
    return out_lines


def phase_profile(corpora):
    """One step of each main path (Cascaded, LZ4, Snappy) on the mixed corpus under
    torch.profiler, its stages called as the codecs call them (LZ: match
    table, encode, decode): device time by stage and by kernel, and the
    device's idle share over the step's wall time.  The Cascaded wrappers'
    output zero-fills are timed alone, at the wrappers' shapes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"]
    lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
    o = CascadedOpts()
    stages = ("table", "encode", "decode")

    def cascaded_step():
        with record_function("encode"):
            comp, sizes = kc.compress(data, lengths, o)
        with record_function("decode"):
            kc.decompress(comp, sizes, o, C)

    def lz_step(kern, table):
        def step():
            with record_function("table"):
                tbl = table(data, lengths)
            with record_function("encode"):
                comp, sizes = kern.encode(data, lengths, tbl)
            with record_function("decode"):
                kern.decompress(comp, sizes, C)
        return step

    def zeros(cols):
        return wall(torch.zeros, B, cols, dtype=torch.uint8, device=data.device, iters=ITERS, warmup=WARMUP)

    def step_wall_ms(step):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return sorted(walls)[1]

    for path, step in (("cascaded", cascaded_step), ("lz4", lz_step(kl, _lz4_table)),
                       ("snappy", lz_step(ks, _snappy_table))):
        wall_ms = step_wall_ms(step)  # host clock, without the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        avg = {e.key: e for e in prof.key_averages()}
        # device work: the device-side entries (kernels, copies, fills), but
        # not the annotated ranges, which the profiler also lists as
        # device-side spans over their kernels, nor its own buffer requests
        work = {k: e.self_device_time_total / 1e3 for k, e in avg.items()
                if e.device_type != DeviceType.CPU and k not in stages
                and not k.startswith("Activity Buffer") and e.self_device_time_total > 0}
        busy = sum(work.values())
        if busy <= 0:
            print(f"phase 9 profile {path}: the profiler reported no device time (not measured)", flush=True)
            continue
        parts = [f"{s} {avg[s].device_time_total / 1e3:.3f} ms" for s in stages if s in avg]
        names = {"table": "lz_match_table_kernel", "encode": f"{path}_encode_kernel",
                 "decode": f"{path}_decode_kernel"}
        kernels = {s: sum(v for k, v in work.items() if names[s] in k) for s in stages}
        top = ", ".join(f"{k[:70]} {v:.3f} ms" for k, v in sorted(work.items(), key=lambda kv: -kv[1])[:6])
        # only the Cascaded wrappers still fill their outputs: the LZ kernels write every byte
        fill = (zeros(cc.partition_output_max(C, o)).median_ms + zeros(C).median_ms) if path == "cascaded" else 0.0
        print(f"phase 9 profile {path} mixed step: wall {wall_ms:.3f} ms (median of 3, no profiler), "
              f"device busy {busy:.3f} ms (profiled step), "
              f"device idle {max(0.0, 1 - busy / wall_ms):.4f}; ranges: {', '.join(parts)}; "
              f"kernels: " + ", ".join(f"{s} {v:.3f} ms" for s, v in kernels.items() if v or s != "table")
              + f"; output zero-fills alone {fill:.3f} ms; largest: {top}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import numpy as np

    from tpucomp_torch.kernels import _build
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.kernels import lz77_cuda as kt
    from tpucomp_torch.kernels import snappy_cuda as ks

    # each wrapper module's launch counts, and the modules each main path launches
    counters = {"cascaded": kc.LAUNCHES, "lz4": kl.LAUNCHES, "snappy": ks.LAUNCHES, "table": kt.LAUNCHES}
    paths = {"cascaded": ("cascaded",), "lz4": ("lz4", "table"), "snappy": ("snappy", "table")}
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path, ROOT)}",
          flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    from bench import load_corpus, runheavy_corpus

    def make_corpora():
        return {
            name: torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).to(dev)
            for name, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus))
        }

    t0 = time.perf_counter()
    matrix_err, n_cases, n_inputs = phase_matrix(dev)
    print(f"phase 3 kernel vs plain: {n_cases} comparisons on {n_inputs} inputs equal "
          f"(tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    corpora = make_corpora()

    def reset_counts():
        for counts in counters.values():
            for k in counts:
                counts[k] = 0

    def launched(codec):
        """The launch counts of ``codec``'s kernels (LZ: match table,
        encode, decode)."""
        return {k: n for c in paths[codec] for k, n in counters[c].items()}

    def only_launched(codec):
        """True when the last main path launched every kernel of ``codec``
        once per corpus or more, and no other kernel."""
        return all(n >= len(corpora) for n in launched(codec).values()) and not any(
            any(c.values()) for name, c in counters.items() if name not in paths[codec])

    reset_counts()
    phase_main_path(dev, corpora)
    launches = {"cascaded": launched("cascaded")}
    if not only_launched("cascaded"):
        raise AssertionError(f"the Cascaded main path launched {counters}")

    times, main_err = phase_times(dev, corpora)

    t0 = time.perf_counter()
    lz4_err, n_lz4, n_lz4_inputs = phase_lz4_matrix(dev)
    print(f"phase 6 LZ4 kernel vs plain: {n_lz4} comparisons on {n_lz4_inputs} encode inputs "
          f"and their streams, the oracle's, the golden fixtures and 4 garbage batches equal "
          f"(tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    reset_counts()
    phase_lz4_main_path(corpora)
    launches["lz4"] = launched("lz4")
    if not only_launched("lz4"):
        raise AssertionError(f"the LZ4 main path did not launch the LZ4 kernels alone: {counters}")

    lz4_times, lz4_main_err = phase_lz4_times(corpora)
    phase_profile(corpora)

    t0 = time.perf_counter()
    snappy_err, n_snappy, n_snappy_inputs = phase_snappy_matrix(dev)
    print(f"phase 10 Snappy kernel vs plain: {n_snappy} comparisons on {n_snappy_inputs} encode inputs "
          f"and their streams, the oracle's, the golden fixtures, foreign and crafted streams and 4 "
          f"garbage batches equal (tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    reset_counts()
    phase_snappy_main_path(corpora)
    launches["snappy"] = launched("snappy")
    if not only_launched("snappy"):
        raise AssertionError(f"the Snappy main path did not launch the Snappy kernels alone: {counters}")
    print(f"  launches on the main paths: {json.dumps(launches)}", flush=True)

    snappy_times, snappy_main_err = phase_snappy_times(corpora)
    hlif = phase_hlif(corpora, counters, paths)
    scaling = phase_scaling(corpora)

    kernels = []
    mixed, lz4_mixed, snappy_mixed = times["mixed"], lz4_times["mixed"], snappy_times["mixed"]
    # bounds: each input read once, each output written once.  LZ encode:
    # the chunk, a table entry (2 bytes) per literal byte and per
    # sequence, the stream; the table: the chunk and 2 bytes per position
    lz = {"lz4": lz4_mixed, "snappy": snappy_mixed}
    rows = [
        ("cascaded_encode", "cascaded_encode.cu", "tpucomp/kernels/cascaded_pallas.py:294", launches["cascaded"]["encode"],
         mixed, "encode", max(matrix_err["encode"], main_err["encode"]), B * C + mixed["comp_bytes"] + 8 * B),
        ("cascaded_decode", "cascaded_decode.cu", "tpucomp/kernels/cascaded_pallas.py:874", launches["cascaded"]["decode"],
         mixed, "decode", max(matrix_err["decode"], main_err["decode"]), mixed["comp_bytes"] + B * C + 12 * B),
        ("lz_match_table", "lz_match_table.cu", "tpucomp/codecs/lz77.py:43",
         launches["lz4"]["table"] + launches["snappy"]["table"], lz4_mixed, "table",
         max(lz4_err["table"], lz4_main_err["table"], snappy_err["table"], snappy_main_err["table"]), 3 * B * C + 4 * B),
    ]
    for codec, enc, dec in (("lz4", "lz_pallas.py:757", "lz_pallas.py:398"),
                            ("snappy", "snappy_pallas.py:360", "snappy_pallas.py:41")):
        t = lz[codec]
        err = {"lz4": (lz4_err, lz4_main_err), "snappy": (snappy_err, snappy_main_err)}[codec]
        rows += [
            (f"{codec}_encode", f"{codec}_encode.cu", f"tpucomp/kernels/{enc}", launches[codec]["encode"], t, "encode",
             max(e["encode"] for e in err),
             B * C + 2 * (t["literal_bytes"] + t["sequences"]) + t["comp_bytes"] + 8 * B),
            (f"{codec}_decode", f"{codec}_decode.cu", f"tpucomp/kernels/{dec}", launches[codec]["decode"], t, "decode",
             max(e["decode"] for e in err), t["comp_bytes"] + B * C + 12 * B),
        ]
    for name, src, line, n_launch, t, k, err, nbytes in rows:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tpucomp_torch/csrc/{src}",
            "replaces": line,
            "launches": n_launch,
            "max_abs_err": err,
            "ms": t[f"kernel_{k}"]["median_ms"],
            "plain_ms": t[f"plain_{k}"]["median_ms"],
            "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(f"  HLIF: {json.dumps(hlif)}", flush=True)
    print(f"  scaling: {json.dumps(scaling)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
