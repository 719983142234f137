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
6. LZ4 kernel vs plain: the cases of tests/torch_lz4_cases.py (strides 1,
   2 and 4; chunks from 64 B to 1 MB and one of 16 MB; the oracle's
   streams and the golden fixtures; garbage, truncated, bit-flipped and
   hand-corrupted streams; undersized outputs), tolerance 0; streams of
   stride 1 up to 64 KB also equal the oracle's
7. LZ4 main path: both corpora through tpucomp_torch.lz4_codec.compress /
   decompress; exact round trips, all SUCCESS, both kernels launched
   (launch counters reset just before)
8. LZ4 times: the candidate-table pre-pass, both kernels, the plain
   versions (timed once each; encode 512 chunks at a time) and a device
   copy; the kernels are held to the plain versions on the whole batch
9. profile: one step of each main path (Cascaded, LZ4, Snappy) under
   torch.profiler: device time by stage, the largest kernels and the
   device's idle share; the output zero-fills timed alone
10. Snappy kernel vs plain: the cases of tests/torch_snappy_cases.py
   (chunks from 64 B to 1 MB and one of 16 MB; the oracle's streams, the
   golden fixtures, foreign large-token streams, crafted edge streams;
   garbage, truncated, bit-flipped and damaged streams; undersized
   outputs), tolerance 0, except the data of the one crafted stream on
   which the kernel is known to differ (ROADMAP Queue 3), held to its
   stream-order result; streams up to 64 KB also equal the oracle's
11. Snappy main path: both corpora through tpucomp_torch.snappy_codec;
   exact round trips, all SUCCESS, both Snappy kernels launched and no
   other codec's (launch counters reset just before)
12. Snappy times: the candidate-table pre-pass, both kernels, the plain
   versions (timed once each; encode 512 chunks at a time) and a device
   copy; the kernels are held to the plain versions on the whole batch
13. high-level managers: the 256 MB mixed corpus as one buffer through
   LZ4Manager, SnappyManager and CascadedManager at their default chunk
   sizes, create_manager on each artifact, exact round trips, the
   codec's kernels launched; compress and decompress wall times, with
   the artifact assembly and the stream slicing timed alone

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


def bound_ms(nbytes: int) -> float:
    """The least time to move ``nbytes`` through device memory once."""
    return nbytes / HBM_BYTES_PER_S * 1e3


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

    err = {"encode": 0, "decode": 0}
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
    for label, arr, lens, stride in encode_cases:
        d, ln = cuda(arr, lens)
        nmp, dist = lz77.candidate_tables(d, ln, stride)
        comp, sizes = kl.compress(d, ln, nmp, dist)
        want = tl._compress_plain(d, ln, stride)
        torch.cuda.synchronize()
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, want[0]),
                            _equal(f"{label} encode sizes", sizes, want[1]))
        del nmp, dist, want
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
    for seed in range(4):
        comps, szs = cases.garbage_batch(np.random.default_rng(100 + seed), 64, cases.C + 600)
        _lz4_decode_both(err, *cuda(comps, szs), cases.C, f"garbage seed {seed}")
        n += 1
    return err, n, len(encode_cases)


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
    """CUDA-event times of the LZ4 pre-pass, kernels, plain versions and a
    copy, with the kernels held to the plain versions; returns (times
    dict, max abs err per kernel)."""
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

    times, err = {}, {"encode": 0, "decode": 0}
    for name, data in corpora.items():
        lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
        nmp, dist = lz77.candidate_tables(data, lengths)
        comp, sizes = kl.compress(data, lengths, nmp, dist)
        t = {}
        t["prepass"] = wall(lz77.candidate_tables, data, lengths, iters=3, warmup=1,
                            bytes_processed=nbytes)
        (pc, ps), t["plain_encode"] = _timed_once(plain_encode, data, lengths, nbytes=nbytes)
        t["kernel_encode"] = wall(kl.compress, data, lengths, nmp, dist, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["kernel_decode"] = wall(kl.decompress, comp, sizes, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        want, t["plain_decode"] = _timed_once(tl._decompress_plain, comp, sizes, C, nbytes=nbytes)
        del nmp, dist
        err["encode"] = max(err["encode"], _equal(f"LZ4 {name} encode rows", comp, pc),
                            _equal(f"LZ4 {name} encode sizes", sizes, ps))
        got = kl.decompress(comp, sizes, C)
        for part, g, w in zip(("data", "lengths", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"LZ4 {name} decode {part}", g, w))
        del pc, ps, got, want
        _, steps, total, ok = tl._delimit(comp, sizes, C, comp.shape[1] // 3 + 2)
        if not bool(ok.all()) or not bool((total == C).all()):
            raise AssertionError(f"LZ4 {name}: the streams do not parse")
        dst = torch.empty_like(data)
        t["d2d_copy"] = wall(dst.copy_, data, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        times[name] = {k: v.summary() for k, v in t.items()}
        times[name]["comp_bytes"] = int(sizes.to(torch.int64).sum())
        times[name]["sequences"] = int(steps.sum())
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 8 LZ4 times {name} 256 MB [4096 x 64 KB] (plain versions timed once, "
              f"encode {LZ4_PLAIN_SLICE} chunks at a time): {line}; "
              f"{times[name]['sequences']} sequences, {times[name]['comp_bytes']} stream bytes", flush=True)
        del comp, sizes, dst, steps, total, ok
        torch.cuda.empty_cache()
    return times, err


def _snappy_tables(data, lengths):
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.codecs import snappy as ts

    return lz77.candidate_tables(data, lengths, max_offset=ts.MAX_OFFSET, end_margin=ts.MIN_MATCH)


def _snappy_decode_both(err, comp, sizes, cap, label, special=None, labels=()):
    """Kernel vs plain decode; rows named in ``special`` (label -> bytes)
    hold the kernel's data to the given bytes instead of the plain's."""
    import torch

    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks

    got = ks.decompress(comp, sizes, cap)
    want = ts._decompress_plain(comp, sizes, cap)
    torch.cuda.synchronize()
    rows = [i for i, name in enumerate(labels) if special and name in special]
    if rows:
        for i in rows:
            n = int(got[1][i])
            if got[0][i, :n].cpu().numpy().tobytes() != special[labels[i]] or bool(got[0][i, n:].any()):
                raise AssertionError(f"{label} {labels[i]}: the kernel's data is not the stream-order result")
        keep = torch.ones(len(labels), dtype=torch.bool, device=comp.device)
        keep[rows] = False
        got, want = (got[0][keep], *got[1:]), (want[0][keep], *want[1:])
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
    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks

    err = {"encode": 0, "decode": 0}
    n = 0

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rng = np.random.default_rng(3)
    encode_cases = [("rows", *cases.compress_rows(rng)[1:]), ("window 64 KB", *cases.window_row()),
                    ("128 KB rows", *cases.large_rows(rng))]
    encode_cases += [(name, arr, lens) for name, arr, lens in cases.kernel_sizes(rng)]
    encode_cases += [("16 MB chunk", *cases.big_chunk(rng))]
    for label, arr, lens in encode_cases:
        d, ln = cuda(arr, lens)
        comp, sizes = ks.compress(d, ln, *_snappy_tables(d, ln))
        want = ts._compress_plain(d, ln)
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
    special = cases.kernel_data()
    for labels, comp, sizes in cases.crafted_streams():
        _, olen, status = _snappy_decode_both(err, *cuda(comp, sizes), cases.CRAFTED_CAP,
                                              "crafted " + ",".join(labels), special, labels)
        for i, name in enumerate(labels):
            if (int(status[i]), int(olen[i])) != cases.CRAFTED_EXPECT[name]:
                raise AssertionError(f"Snappy crafted {name}: status {int(status[i])} length {int(olen[i])}")
        n += 1
    for seed in range(4):
        comps, szs = cases.garbage_batch(np.random.default_rng(100 + seed), 64, cases.C + 600)
        _snappy_decode_both(err, *cuda(comps, szs), cases.C, f"garbage seed {seed}")
        n += 1
    return err, n, len(encode_cases)


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
    """CUDA-event times of the Snappy pre-pass, kernels, plain versions and
    a copy, with the kernels held to the plain versions; returns (times
    dict, max abs err per kernel).  Also counts the elements of the
    streams and the sequences of the parse (runs of copy elements with one
    offset; plus each chunk's last, literal-only sequence)."""
    import torch

    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    nbytes = B * C

    def plain_encode(data, lengths):
        parts = [ts._compress_plain(data[i : i + LZ4_PLAIN_SLICE], lengths[i : i + LZ4_PLAIN_SLICE])
                 for i in range(0, B, LZ4_PLAIN_SLICE)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    times, err = {}, {"encode": 0, "decode": 0}
    for name, data in corpora.items():
        lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
        nmp, dist = _snappy_tables(data, lengths)
        comp, sizes = ks.compress(data, lengths, nmp, dist)
        t = {}
        t["prepass"] = wall(_snappy_tables, data, lengths, iters=3, warmup=1, bytes_processed=nbytes)
        (pc, ps), t["plain_encode"] = _timed_once(plain_encode, data, lengths, nbytes=nbytes)
        t["kernel_encode"] = wall(ks.compress, data, lengths, nmp, dist, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["kernel_decode"] = wall(ks.decompress, comp, sizes, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        want, t["plain_decode"] = _timed_once(ts._decompress_plain, comp, sizes, C, nbytes=nbytes)
        del nmp, dist
        err["encode"] = max(err["encode"], _equal(f"Snappy {name} encode rows", comp, pc),
                            _equal(f"Snappy {name} encode sizes", sizes, ps))
        got = ks.decompress(comp, sizes, C)
        for part, g, w in zip(("data", "lengths", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"Snappy {name} decode {part}", g, w))
        del pc, ps, got, want
        (_, _, _, mlen, off), steps, total, ok = ts._delimit(comp, sizes, C, comp.shape[1] // 2 + 2)
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
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 12 Snappy times {name} 256 MB [4096 x 64 KB] (plain versions timed once, "
              f"encode {LZ4_PLAIN_SLICE} chunks at a time): {line}; {times[name]['elements']} elements, "
              f"{sequences} sequences, {times[name]['comp_bytes']} stream bytes", flush=True)
        del comp, sizes, dst, steps, total, ok
        torch.cuda.empty_cache()
    return times, err


def phase_hlif(corpora, counters):
    """The 256 MB mixed corpus as one buffer through each manager at its
    default chunk size: create_manager on the artifact, exact round trip,
    the codec's kernels launched; host-clock compress and decompress
    times, and the assembly and slicing alone (CUDA events)."""
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
        launched = dict(counters[name])
        if not (launched["encode"] and launched["decode"]) or any(
                any(c.values()) for k, c in counters.items() if k != name):
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
    torch.profiler, its stages called as the codecs call them: device time
    by stage and by kernel, and the device's idle share over the step's
    wall time.  The wrappers' output zero-fills are timed alone, at the
    wrappers' shapes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.codecs import lz77
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size, snappy_max_compressed_chunk_size
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.kernels import snappy_cuda as ks
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"]
    lengths = torch.full((B,), C, dtype=torch.int32, device=data.device)
    o = CascadedOpts()
    stages = ("prepass", "encode", "decode")

    def cascaded_step():
        with record_function("encode"):
            comp, sizes = kc.compress(data, lengths, o)
        with record_function("decode"):
            kc.decompress(comp, sizes, o, C)

    def lz4_step():
        with record_function("prepass"):
            nmp, dist = lz77.candidate_tables(data, lengths)
        with record_function("encode"):
            comp, sizes = kl.compress(data, lengths, nmp, dist)
        with record_function("decode"):
            kl.decompress(comp, sizes, C)

    def snappy_step():
        with record_function("prepass"):
            nmp, dist = _snappy_tables(data, lengths)
        with record_function("encode"):
            comp, sizes = ks.compress(data, lengths, nmp, dist)
        with record_function("decode"):
            ks.decompress(comp, sizes, C)

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

    for path, step, enc_cols in (("cascaded", cascaded_step, cc.partition_output_max(C, o)),
                                 ("lz4", lz4_step, lz4_max_compressed_chunk_size(C)),
                                 ("snappy", snappy_step, snappy_max_compressed_chunk_size(C))):
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
        kernels = {s: sum(v for k, v in work.items() if f"{path}_{s}_kernel" in k) for s in stages[1:]}
        top = ", ".join(f"{k[:70]} {v:.3f} ms" for k, v in sorted(work.items(), key=lambda kv: -kv[1])[:6])
        fill = zeros(enc_cols).median_ms + zeros(C).median_ms
        print(f"phase 9 profile {path} mixed step: wall {wall_ms:.3f} ms (median of 3, no profiler), "
              f"device busy {busy:.3f} ms (profiled step), "
              f"device idle {max(0.0, 1 - busy / wall_ms):.4f}; ranges: {', '.join(parts)}; "
              f"kernels: encode {kernels['encode']:.3f} ms, decode {kernels['decode']:.3f} ms; "
              f"output zero-fills alone {fill:.3f} ms; largest: {top}", flush=True)


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
    from tpucomp_torch.kernels import snappy_cuda as ks

    counters = {"cascaded": kc.LAUNCHES, "lz4": kl.LAUNCHES, "snappy": ks.LAUNCHES}
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

    t0 = time.perf_counter()
    matrix_err, n_cases, n_inputs = phase_matrix(dev)
    print(f"phase 3 kernel vs plain: {n_cases} comparisons on {n_inputs} inputs equal "
          f"(tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    from bench import load_corpus, runheavy_corpus

    corpora = {
        name: torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).to(dev)
        for name, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus))
    }

    def reset_counts():
        for counts in counters.values():
            for k in counts:
                counts[k] = 0

    def only_launched(codec):
        """True when the last main path launched both kernels of ``codec``
        once per corpus or more, and no other codec's kernel."""
        return all(counters[codec][k] >= len(corpora) for k in ("encode", "decode")) and not any(
            any(c.values()) for name, c in counters.items() if name != codec)

    reset_counts()
    phase_main_path(dev, corpora)
    launches = {"cascaded": dict(kc.LAUNCHES)}
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
    launches["lz4"] = dict(kl.LAUNCHES)
    if not only_launched("lz4"):
        raise AssertionError(f"the LZ4 main path did not launch the LZ4 kernels alone: {counters}")

    lz4_times, lz4_main_err = phase_lz4_times(corpora)
    phase_profile(corpora)

    t0 = time.perf_counter()
    snappy_err, n_snappy, n_snappy_inputs = phase_snappy_matrix(dev)
    print(f"phase 10 Snappy kernel vs plain: {n_snappy} comparisons on {n_snappy_inputs} encode inputs "
          f"and their streams, the oracle's, the golden fixtures, foreign and crafted streams and 4 "
          f"garbage batches equal (tolerance 0; the one known divergent stream equals its stream-order "
          f"result), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    reset_counts()
    phase_snappy_main_path(corpora)
    launches["snappy"] = dict(ks.LAUNCHES)
    if not only_launched("snappy"):
        raise AssertionError(f"the Snappy main path did not launch the Snappy kernels alone: {counters}")
    print(f"  launches on the main paths: {json.dumps(launches)}", flush=True)

    snappy_times, snappy_main_err = phase_snappy_times(corpora)
    hlif = phase_hlif(corpora, counters)

    kernels = []
    mixed, lz4_mixed, snappy_mixed = times["mixed"], lz4_times["mixed"], snappy_times["mixed"]
    rows = (
        ("cascaded", "encode", "cascaded_encode.cu", "cascaded_pallas.py:294", mixed, max(matrix_err["encode"], main_err["encode"]),
         B * C + mixed["comp_bytes"] + 8 * B),
        ("cascaded", "decode", "cascaded_decode.cu", "cascaded_pallas.py:874", mixed, max(matrix_err["decode"], main_err["decode"]),
         mixed["comp_bytes"] + B * C + 12 * B),
        ("lz4", "encode", "lz4_encode.cu", "lz_pallas.py:757", lz4_mixed, max(lz4_err["encode"], lz4_main_err["encode"]),
         B * C + lz4_mixed["comp_bytes"] + 8 * lz4_mixed["sequences"] + 8 * B),
        ("lz4", "decode", "lz4_decode.cu", "lz_pallas.py:398", lz4_mixed, max(lz4_err["decode"], lz4_main_err["decode"]),
         lz4_mixed["comp_bytes"] + B * C + 12 * B),
        ("snappy", "encode", "snappy_encode.cu", "snappy_pallas.py:360", snappy_mixed,
         max(snappy_err["encode"], snappy_main_err["encode"]),
         B * C + snappy_mixed["comp_bytes"] + 8 * snappy_mixed["sequences"] + 8 * B),
        ("snappy", "decode", "snappy_decode.cu", "snappy_pallas.py:41", snappy_mixed,
         max(snappy_err["decode"], snappy_main_err["decode"]),
         snappy_mixed["comp_bytes"] + B * C + 12 * B),
    )
    for codec, k, src, line, t, err, nbytes in rows:
        kernels.append({
            "name": f"{codec}_{k}",
            "route": "cuda",
            "source": f"tpucomp_torch/csrc/{src}",
            "replaces": f"tpucomp/kernels/{line}",
            "launches": launches[codec][k],
            "max_abs_err": err,
            "ms": t[f"kernel_{k}"]["median_ms"],
            "plain_ms": t[f"plain_{k}"]["median_ms"],
            "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(f"  HLIF: {json.dumps(hlif)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
