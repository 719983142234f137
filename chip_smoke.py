#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpucomp_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main paths, Cascaded, LZ4, Snappy and the high-level
managers, then the host surface above them (the routing flag, sharding,
multihost, the CLI, native staging), the batch-API conformance matrix,
the bench and the examples, in phases, each printing one line (any
failure raises and exits non-zero):

1. device: the card's name, and its power limit from nvidia-smi
2. build: the CUDA kernels from tpucomp_torch/csrc, with nvcc, timed
3. Cascaded kernel vs plain: every kernel case of tests/torch_cases.py (the test
   matrix, the rest of the option space, random options and shapes, two
   16 MB partitions) on CUDA tensors, with corrupt, damaged and garbage
   streams, through both the kernels and their plain PyTorch versions; exact equality (tolerance 0: the codec is
   lossless and every output is an integer tensor).  A few default-option
   partitions are also checked against tests/oracles/cascaded_oracle.py.
   The cases include 8-byte elements (LONGLONG / ULONGLONG: the matrix's,
   the wide rows', the random ones' and tests/torch_cases.py::w8_cases,
   ranges that wrap, values past 2**32 and 2**63, ragged lengths).
   Then CascadedManager's shape (256 partitions of 4 KB, one chunk each;
   INT, SHORT and LONGLONG) the same way, and the 8-byte route: a LONGLONG
   and a ULONGLONG batch through codecs.cascaded launch each kernel once
   and equal the plain version on the CPU
4. Cascaded main path: 256 MB of the mixed corpus and of the run-heavy corpus
   (tpucomp_torch/utils/corpus.py), as
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
   four bytes, all-distinct windows, tiny rows, an odd capacity; its
   grouping path's rows (group_rows: one bucket, a frequent window in its
   bucket, zeros, distinct windows, 64 KB edges and collisions, 65,536
   and 65,537 bytes); the oracle's streams and the golden fixtures;
   garbage, truncated, bit-flipped and hand-corrupted streams; undersized
   outputs; the decode kernel's window cases), tolerance 0: the
   match-table kernel against lz77.match_table at strides 1, 2 and 4 on
   every encode case, the encoder against _compress_plain, the decoder
   against _decompress_plain; streams of stride 1 up to 64 KB also equal
   the oracle's.  Then the table kernel and a whole compress timed on 1 MB
   rows of all-distinct windows, of zeros and of windows in one bucket of
   the grouping kernel's hash (each must compress in under 115 ms)
7. LZ4 main path: both corpora through tpucomp_torch.lz4_codec.compress /
   decompress; exact round trips, all SUCCESS, all three kernels launched
   (launch counters reset just before)
8. LZ4 times: the three kernels (match table, encode given the table,
   decode), a whole compress, the plain versions and the torch pre-pass
   the plain encoder runs (timed once each; plain encode 512 chunks at a
   time) and a device copy; the kernels are held to the plain versions on
   the whole batch; the peak memory of one compress; the decode time per
   sequence
9. profile: one step of each main path (Cascaded, LZ4, Snappy) through
   the batch API under torch.profiler: device time by the port's own
   spans (LZ: compress.<codec>.table, .encode, decompress.<codec>.decode),
   the largest kernels, the device time of fill kernels in the step (the
   tracer's counter buffer, zeroed at the first traced launch; no kernel
   output: every kernel writes all of its outputs) and the device's idle
   share; then phase 23
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
   sizes, and CascadedManager(opts=LONGLONG), create_manager on each
   artifact, exact round trips, the
   codec's kernels and the managers' copy kernel (pack, unpack) launched
   and no other; compress and decompress wall times (host
   clock, one call; and CUDA-event medians of several calls), with the
   artifact assembly and the stream slicing alone: the copy kernel's
   artifact and rows equal to the plain versions' (run on the card), and
   both times beside the bound (stream bytes read once, the artifact or
   the rows written once)
14. scaling: the LZ4 and Snappy encode walks (given the table) and decode
   kernels on the first 1,056, 2,112 and 4,096 chunks of mixed (~8, 16
   and 31 warps per SM): time per sequence or element against the warps
   per SM
15. routing flag: with config.use_cuda_kernels = False, each codec's
   compress and decompress of 16 MB of mixed on cuda:0 raise ValueError
   (a tensor on the card takes its kernel or raises) and launch no kernel;
   True on a CPU batch raises; True on the card launches the codec's
   kernels and equals None's bytes; the flag goes back to None
16. sharding: the 256 MB mixed batch through parallel.sharding's
   sharded_compress / sharded_decompress (gather=True) for each codec,
   over make_mesh() (every card) and [cuda:0] * 3 (4096 rows are no
   multiple of 3: padding and order on the card): rows and sizes equal one
   codec.compress of the whole batch, exact round trips, all SUCCESS, the
   kernels launched; CUDA-event times of each call
17. multihost: two worker processes sharing cuda:0 under gloo (NCCL takes
   one rank per card), each with half of the 256 MB mixed batch, through
   parallel.multihost's compress_distributed, gather_to_host and
   decompress_distributed for Cascaded and LZ4, then one NCCL run at world
   size torch.cuda.device_count(): the gathered rows equal one
   single-process compress, exact round trips; host-clock times, the
   gather's included
18. CLI and native: the 256 MB mixed corpus as a file through
   tpucomp_torch.cli compress, info and decompress for each format
   (byte-exact; a corrupted artifact returns 1), and the native library's
   ragged staging held to numpy at 256 MB; pack_chunks / unpack_chunks
   (a numpy copy per row) timed against the same work staged through the
   library; host-clock times
19. Cascaded 8-byte main path and times (run right after phase 5, beside
   the 4-byte times): 256 MB as uint8[4096, 65536] through
   tpucomp_torch.cascaded_codec under LONGLONG on the runheavy64 and
   timestamps64 corpora (tpucomp_torch/utils/corpus.py) and on mixed, and
   under ULONGLONG on timestamps64; exact round trips, all SUCCESS, both
   kernels launched once a cell and no other (counts reset just before);
   CUDA-event medians of 7 after 2 warm-ups of the kernels, the plain
   versions timed once, the kernels held to them on each whole batch;
   each cell's byte bounds (the kernels line's 8-byte rows read
   timestamps64 under LONGLONG)
20. conformance: tests/test_batch_api.py's matrix through the port's
   low-level codecs (lowlevel/{cascaded,lz4,snappy}.py) on cuda:0, batch
   sizes 1, 11, 127, 1025 and 10025 at capacity 2048 (its payload
   generator and seed, tests/torch_batch_cases.py): temp sizes 0, sizes
   within compress_get_max_output_chunk_size, get_decompress_size equal to
   the input lengths, exact round trips, compressed rows and sizes and
   decoded rows equal to the plain versions (tolerance 0); garbage rows
   give only SUCCESS or ERROR_CANNOT_DECOMPRESS, length 0 where decode
   failed
21. bench: ``python -m tpucomp_torch.bench --codec main`` and ``--codec
   snappy`` as subprocesses (every cell at 256 MB): exit codes, the last
   lines parsed, every round trip exact, each cell's kernels launched;
   the Cascaded cells' whole calls held to phase 5's kernel medians (below
   0.9 x is an impossible reading and fails), each cell's times printed
   beside its kernels' (the LZ cells beside phases 8 and 12, on another
   rotation of the corpus)
22. examples: examples/torch_round_trip.py and examples/torch_distributed.py
   run on the card as subprocesses, exit code 0 (their asserts held)
23. tracer (run right after phase 9): the port's spans and counters
   (tpucomp_torch/utils/profiling.py) on both corpora at 256 MB.  Tracing
   off, a round trip of each codec records nothing and makes no counter
   buffer.  Under torch.profiler the kernels' counters hold to the
   streams: cascaded.encode.partitions_raw equals the partitions whose
   header has zero layer bytes, the chunks run less those discarded are
   every chunk of the other partitions, and none is discarded on
   runheavy; lz4.encode.sequences and lz4.decode.sequences both equal the
   sequences the streams hold; snappy.encode.sequences and
   snappy.decode.elements equal the Snappy streams' sequences and elements

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
    from tpucomp_torch.core.types import width_of
    from tpucomp_torch.kernels import cascaded_cuda as kc

    err = {"encode": 0, "decode": 0}
    n_cases = 0
    n_w8 = 0  # of them, comparisons of 8-byte elements

    def decode_both(label, comp, sizes, o, cap):
        nonlocal n_cases, n_w8
        got = kc.decompress(comp, sizes, o, cap)
        want = cc._decompress_plain(comp, sizes, o, cap)
        torch.cuda.synchronize()
        for part, g, w in zip(("data", "bytes", "status"), got, want):
            err["decode"] = max(err["decode"], _equal(f"{label} decode {part}", g, w))
        n_cases += 1
        n_w8 += width_of(o.type) == 8
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
        n_w8 += w == 8
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

    # CascadedManager's shape: 4 KB partitions, one chunk each
    raw = b"".join(torch_cases.profile_bytes(rng, prof, 4096 * 64, 4) for prof in ("runs", "random", "ramp", "signed"))
    arr, lens = torch_cases.batch(raw, 256, 4096)
    lens[-1] -= 1001
    cases_4k = [("4 KB partitions", fields) for fields in (torch_cases.DEFAULT, torch_cases.opts(type=torch_cases.SHORT),
                                                            torch_cases.opts(type=torch_cases.LONGLONG))]
    for label, fields in cases_4k:
        o = opts_from_fields(fields)
        d, ln = torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)
        comp, sizes = kc.compress(d, ln, o)
        want = cc._compress_plain(d, ln, o)
        torch.cuda.synchronize()
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, want[0]),
                            _equal(f"{label} encode sizes", sizes, want[1]))
        n_cases += 1
        n_w8 += width_of(o.type) == 8
        decode_both(label, comp, sizes, o, 4096)
        rows, szs = torch_cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
        decode_both(f"{label} damaged", torch.from_numpy(rows).to(dev), torch.from_numpy(szs).to(dev), o, 4096)

    # 8-byte elements through the codec's route on the card: each call
    # launches its kernel once, equal to the plain version on the CPU
    for type_ in (torch_cases.LONGLONG, torch_cases.ULONGLONG):
        o8 = opts_from_fields(torch_cases.opts(type=type_))
        arr8, lens8 = torch_cases.config_case(rng, torch_cases.opts(type=type_), 4096, "runs")
        d8, ln8 = torch.from_numpy(arr8).to(dev), torch.from_numpy(lens8).to(dev)
        before = dict(kc.LAUNCHES)
        comp8, sizes8 = cc.compress(d8, ln8, o8)
        out8 = cc.decompress(comp8, sizes8, o8, arr8.shape[1])
        torch.cuda.synchronize()
        if kc.LAUNCHES != {k: n + 1 for k, n in before.items()} or not comp8.is_cuda:
            raise AssertionError(f"an 8-byte batch did not launch each Cascaded kernel once: {kc.LAUNCHES} "
                                 f"(before {before})")
        want8 = cc._compress_plain(torch.from_numpy(arr8), torch.from_numpy(lens8), o8)
        for part, g, w in zip(("rows", "sizes"), (comp8, sizes8), want8):
            err["encode"] = max(err["encode"], _equal(f"8-byte route encode {part}", g.cpu(), w))
        for part, g, w in zip(("data", "bytes", "status"), out8, cc._decompress_plain(*want8, o8, arr8.shape[1])):
            err["decode"] = max(err["decode"], _equal(f"8-byte route decode {part}", g.cpu(), w))
        n_cases += 2
        n_w8 += 2
        kept = ln8 // 8 * 8  # lengths count whole elements
        if bool(out8[2].any()) or not torch.equal(out8[0], d8 * (torch.arange(arr8.shape[1], device=dev) < kept[:, None])):
            raise AssertionError("the 8-byte route does not round-trip")
    return err, n_cases, n_w8, len(cases) + 1 + len(cases_4k) + 2


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


def phase_w8(dev, corpora, counters, paths):
    """8-byte elements at full size: LONGLONG on runheavy64, timestamps64
    and mixed, ULONGLONG on timestamps64, each as uint8[4096, 65536]
    through tpucomp_torch.cascaded_codec (launch counts reset just before,
    read just after: both Cascaded kernels once a cell, nothing else),
    exact round trips, all SUCCESS; then CUDA-event medians of the kernels
    and the plain versions timed once, the kernels held to them on the
    whole batch.  Returns (launches, times by cell, max abs err)."""
    import numpy as np
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.core.types import DataType
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.utils.corpus import runheavy64_corpus, timestamps64_corpus
    from tpucomp_torch.utils.profiling import wall

    data = dict(corpora)
    for name, gen in (("runheavy64", runheavy64_corpus), ("timestamps64", timestamps64_corpus)):
        data[name] = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).to(dev)
    cells = [("runheavy64", DataType.LONGLONG), ("timestamps64", DataType.LONGLONG), ("mixed", DataType.LONGLONG),
             ("timestamps64", DataType.ULONGLONG)]
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    nbytes = B * C

    _reset_counts(counters)
    for name, type_ in cells:
        batch = tpucomp_torch.ChunkBatch(data[name], lengths)
        comp = tpucomp_torch.cascaded_codec.compress(batch, CascadedOpts(type=type_))
        out, status = tpucomp_torch.cascaded_codec.decompress(comp, C, CascadedOpts(type=type_))
        torch.cuda.synchronize()
        if not (torch.equal(out.data, data[name]) and bool((out.lengths == C).all()) and bool((status == 0).all())):
            raise AssertionError(f"{name} {type_.name}: 256 MB round trip is not exact")
        del batch, comp, out, status
    launches = dict(counters["cascaded"])
    if any(n != len(cells) for n in launches.values()) or any(
            any(c.values()) for k, c in counters.items() if k not in paths["cascaded"]):
        raise AssertionError(f"the 8-byte main path launched {counters}")

    times, err = {}, {"encode": 0, "decode": 0}
    for name, type_ in cells:
        o = CascadedOpts(type=type_)
        d = data[name]
        comp, sizes = kc.compress(d, lengths, o)
        t = {}
        t["plain_encode"] = wall(cc._compress_plain, d, lengths, o, iters=1, warmup=0, bytes_processed=nbytes)
        t["kernel_encode"] = wall(kc.compress, d, lengths, o, iters=ITERS, warmup=WARMUP, bytes_processed=nbytes)
        t["kernel_decode"] = wall(kc.decompress, comp, sizes, o, C, iters=ITERS, warmup=WARMUP,
                                  bytes_processed=nbytes)
        t["plain_decode"] = wall(cc._decompress_plain, comp, sizes, o, C, iters=1, warmup=0,
                                 bytes_processed=nbytes)
        label = f"{name} {type_.name}"
        pc, ps = cc._compress_plain(d, lengths, o)
        err["encode"] = max(err["encode"], _equal(f"{label} encode rows", comp, pc),
                            _equal(f"{label} encode sizes", sizes, ps))
        del pc, ps
        for part, g, w in zip(("data", "bytes", "status"), kc.decompress(comp, sizes, o, C),
                              cc._decompress_plain(comp, sizes, o, C)):
            err["decode"] = max(err["decode"], _equal(f"{label} decode {part}", g, w))
        cell = f"{name}_{type_.name.lower()}"
        times[cell] = {k: v.summary() for k, v in t.items()}
        comp_bytes = int(sizes.to(torch.int64).sum())
        times[cell]["comp_bytes"] = comp_bytes
        # the byte bounds of the kernels line, and each kernel's multiple of its own
        bounds = {"encode": bound_ms(nbytes + comp_bytes + 8 * B), "decode": bound_ms(comp_bytes + nbytes + 12 * B)}
        fallback = float(((comp[:, :3] == 0).all(1)).float().mean())
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, min {v.min_ms:.3f}, "
                         f"max {v.max_ms:.3f})" for k, v in t.items())
        line += "; " + ", ".join(f"{k} bound {b:.4f} ms ({t['kernel_' + k].median_ms / b:.2f}x)"
                                 for k, b in bounds.items())
        print(f"phase 19 8-byte {label} 256 MB [4096 x 64 KB]: exact round trip, all SUCCESS, ratio "
              f"{nbytes / comp_bytes:.4f}, fallback share {fallback:.4f}; {line} "
              f"(plain versions timed once)", flush=True)
        del comp, sizes
        torch.cuda.empty_cache()
    return launches, times, err


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
    for label, arr, lens in cases.table_rows(np.random.default_rng(21)) + cases.group_rows(np.random.default_rng(23)):
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
    would walk, and no early end for any search), 1 MB of zeros (every
    window equal), and 1 MB whose windows at multiples of 4 all fall in one
    bucket of the grouping kernel's hash (torch_lz4_cases.one_bucket_row;
    rows past 64 KB take the radix path, which has no buckets)."""
    import numpy as np
    import torch

    import torch_lz4_cases as cases
    from tpucomp_torch.utils.profiling import wall

    c = 1 << 20
    for name, row in (("all-distinct windows", cases.unique_windows(np.random.default_rng(31), c)),
                      ("zeros", np.zeros(c, np.uint8)),
                      ("one-bucket windows", cases.one_bucket_row(np.random.default_rng(32), c, 4))):
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

    import torch_lz4_cases as lz4_cases
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
    table_cases = cases.table_rows(np.random.default_rng(22)) + lz4_cases.group_rows(np.random.default_rng(23))
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
    default chunk size, and through CascadedManager(opts=LONGLONG):
    create_manager on the artifact, exact round trip,
    the codec's kernels and the copy kernel launched (the counters of
    ``paths[codec]`` and ``manager``) and no other; compress and decompress
    times on the host clock (one call) and by CUDA events (medians of
    several), and the assembly and slicing alone (CUDA events): the copy
    kernel held to the plain versions on the card, both timed beside the
    bound."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.core.types import DataType
    from tpucomp_torch.highlevel import headers as hdr
    from tpucomp_torch.highlevel import manager as tm
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"].reshape(-1)
    n = data.numel()
    out_lines = {}
    for name, codec, cls, kwargs in (
            ("lz4", "lz4", tpucomp_torch.LZ4Manager, {}), ("snappy", "snappy", tpucomp_torch.SnappyManager, {}),
            ("cascaded", "cascaded", tpucomp_torch.CascadedManager, {}),
            ("cascaded_longlong", "cascaded", tpucomp_torch.CascadedManager,
             {"opts": CascadedOpts(type=DataType.LONGLONG)})):
        mgr = cls(**kwargs)
        _reset_counts(counters)
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
        path = paths[codec] + ("manager",)
        launched = {k: n for c in path for k, n in counters[c].items()}
        if not all(launched.values()) or any(
                any(c.values()) for k, c in counters.items() if k not in path):
            raise AssertionError(f"HLIF {name}: launches {counters}")
        # the assembly and the slicing alone, at the manager's shapes
        cs = mgr.uncomp_chunk_size
        k = n // cs
        comp, sizes = mgr._codec_compress(data.view(k, cs), torch.full((k,), cs, dtype=torch.int32,
                                                                         device=data.device))
        common = hdr.CommonHeader.unpack(artifact[: hdr.COMMON_HEADER_SIZE].cpu().numpy().tobytes())
        head = artifact[: hdr.sections_offset(mgr.format_id)].cpu().numpy().tobytes()
        cfg = mgr.configure_compression(n)
        layout = {"data_off": common.comp_data_offset, "sections_off": hdr.sections_offset(mgr.format_id),
                  "out_max": cfg.max_compressed_buffer_size}
        max_chunk = mgr._max_comp_chunk_size(cs)
        got, want = tm._assemble_artifact(comp, sizes, head, **layout), tm._assemble_plain(comp, sizes, head, **layout)
        if got[1] != want[1] or not torch.equal(got[0], want[0]):
            raise AssertionError(f"HLIF {name}: the copy kernel's artifact differs from the plain assembly's")
        del got, want
        sliced = artifact[:size]
        got = tm._slice_streams(sliced, common, layout["sections_off"], max_chunk)
        want = tm._slice_plain(sliced, common, layout["sections_off"], max_chunk)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"HLIF {name}: the copy kernel's rows differ from the plain slicing's")
        del got, want
        t_asm = wall(tm._assemble_artifact, comp, sizes, head, **layout, iters=ITERS, warmup=WARMUP)
        t_asm_plain = wall(tm._assemble_plain, comp, sizes, head, **layout, iters=3, warmup=1)
        t_slice = wall(tm._slice_streams, sliced, common, layout["sections_off"], max_chunk, iters=ITERS,
                       warmup=WARMUP)
        t_slice_plain = wall(tm._slice_plain, sliced, common, layout["sections_off"], max_chunk, iters=3, warmup=1)
        stream_bytes = common.comp_data_size
        asm_bound, slice_bound = bound_ms(stream_bytes + layout["out_max"]), bound_ms(stream_bytes + k * max_chunk)
        # the whole calls again, as CUDA-event medians (one host-clock call spreads)
        t_comp = wall(mgr.compress, data, iters=ITERS, warmup=WARMUP)
        t_decomp = wall(mgr2.decompress, artifact, iters=ITERS, warmup=WARMUP)
        out_lines[name] = {"chunk": cs, "chunks": k, "artifact_bytes": size, "compress_ms": walls["compress"],
                           "decompress_ms": walls["decompress"], "compress_event_ms": t_comp.summary(),
                           "decompress_event_ms": t_decomp.summary(), "assemble_ms": t_asm.median_ms,
                           "assemble_plain_ms": t_asm_plain.median_ms, "assemble_bound_ms": asm_bound,
                           "slice_ms": t_slice.median_ms, "slice_plain_ms": t_slice_plain.median_ms,
                           "slice_bound_ms": slice_bound, "launches": launched}
        print(f"phase 13 HLIF {name}: {n / 2**20:.0f} MB mixed as one buffer, {k} chunks of {cs} B, create_manager -> "
              f"{type(mgr2).__name__}, exact round trip, all SUCCESS, ratio {n / size:.4f}; compress "
              f"{walls['compress']:.3f} ms ({n / walls['compress'] / 1e6:.3f} GB/s), decompress "
              f"{walls['decompress']:.3f} ms ({n / walls['decompress'] / 1e6:.3f} GB/s) (host clock, one "
              f"call each); by CUDA events, median of {ITERS}: compress {t_comp.median_ms:.3f} ms "
              f"(min {t_comp.min_ms:.3f}, max {t_comp.max_ms:.3f}), decompress {t_decomp.median_ms:.3f} ms "
              f"(min {t_decomp.min_ms:.3f}, max {t_decomp.max_ms:.3f}); alone, the copy kernel equal to the plain "
              f"versions: assembly {t_asm.median_ms:.3f} ms (plain {t_asm_plain.median_ms:.3f}, bound "
              f"{asm_bound:.3f}), slicing {t_slice.median_ms:.3f} ms (plain {t_slice_plain.median_ms:.3f}, bound "
              f"{slice_bound:.3f}) (medians of {ITERS}, plain of 3); launches {launched}", flush=True)
        del artifact, sliced, out, statuses, comp, sizes
        torch.cuda.empty_cache()
    return out_lines


def phase_profile(corpora):
    """One step of each main path (Cascaded, LZ4, Snappy) on the mixed
    corpus, a compress and a decompress through the batch API, under
    torch.profiler: device time by the port's own spans (LZ:
    compress.<codec>.table, compress.<codec>.encode, decompress.<codec>.decode;
    Cascaded: the encode and decode; ``_device_ms_by_span``), the largest
    kernels, the device time of fill kernels in the step (the first traced
    step fills the tracer's counter buffer; no kernel's output is filled:
    every kernel writes all of its outputs) and the device's idle share
    over the step's host-clock wall (median of 3 steps without the
    profiler)."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpucomp_torch

    batch = tpucomp_torch.ChunkBatch(corpora["mixed"], torch.full((B,), C, dtype=torch.int32,
                                                                  device=corpora["mixed"].device))
    for codec, opts in (("cascaded", tpucomp_torch.CascadedOpts()), ("lz4", tpucomp_torch.LZ4Opts()),
                        ("snappy", tpucomp_torch.SnappyOpts())):
        api = getattr(tpucomp_torch, f"{codec}_codec")

        def step():
            api.decompress(api.compress(batch, opts), C, opts)

        stages = ([f"compress.{codec}.table"] if codec != "cascaded" else []) + [
            f"compress.{codec}.encode", f"decompress.{codec}.decode"]
        wall_ms = statistics.median(_host_ms(step)[1] for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        by_span = _device_ms_by_span(prof, stages)
        avg = {e.key: e for e in prof.key_averages()}
        # device work: kernels, copies and fills, not the spans over them nor the profiler's buffers
        work = {k: e.self_device_time_total / 1e3 for k, e in avg.items()
                if e.device_type != DeviceType.CPU and not k.startswith(("compress.", "decompress.", "Activity Buffer"))
                and e.self_device_time_total > 0}
        busy = sum(work.values())
        if busy <= 0:
            print(f"phase 9 profile {codec}: the profiler reported no device time (not measured)", flush=True)
            continue
        parts = [f"{s} {ms:.3f} ms" for s, ms in by_span.items()]
        top = ", ".join(f"{k[:70]} {v:.3f} ms" for k, v in sorted(work.items(), key=lambda kv: -kv[1])[:6])
        fill = sum(v for k, v in work.items() if "fill" in k.lower())
        print(f"phase 9 profile {codec} mixed step: wall {wall_ms:.3f} ms (median of 3, no profiler), "
              f"device busy {busy:.3f} ms (profiled step), device idle {max(0.0, 1 - busy / wall_ms):.4f}; "
              f"port spans: {', '.join(parts)}; fill kernels in the step {fill:.3f} ms; largest: {top}",
              flush=True)


def _device_ms_by_span(prof, names) -> dict:
    """Device ms of the operations launched inside each span named in
    ``names``, from the profiler's Chrome trace: an operation belongs to
    every such span that holds the host call that launched it (matched by
    the profiler's correlation id)."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in names]
    ms = dict.fromkeys(names, 0.0)
    for e in events:
        t = launched.get(e.get("args", {}).get("correlation"))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and t is not None:
            for name, t0, t1 in spans:
                if t0 <= t <= t1:
                    ms[name] += e["dur"] / 1e3
    return ms


def phase_tracer(corpora):
    """The port's tracer (tpucomp_torch/utils/profiling.py) on the main paths
    at 256 MB: with tracing off a round trip of each codec records nothing
    and makes no counter buffer; under torch.profiler the kernels' counters
    hold to the streams on both corpora: cascaded.encode.partitions_raw is
    the partitions whose header has zero layer bytes, the chunks run less
    those discarded are every chunk of the other partitions, none is
    discarded on runheavy; lz4.encode.sequences and lz4.decode.sequences
    both equal the sequences the streams hold, as snappy.encode.sequences
    and snappy.decode.elements equal the Snappy streams' sequences and
    elements (_walk_steps); the match table's lz.table.positions and
    lz.table.large_bucket_positions, under either codec, equal what the
    rows' buckets hold (torch_lz4_cases.group_counts).  Returns the
    counters by corpus."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import torch_lz4_cases as cases
    import tpucomp_torch
    from tpucomp_torch.utils import profiling

    apis = {"cascaded": (tpucomp_torch.cascaded_codec, tpucomp_torch.CascadedOpts()),
            "lz4": (tpucomp_torch.lz4_codec, tpucomp_torch.LZ4Opts()),
            "snappy": (tpucomp_torch.snappy_codec, tpucomp_torch.SnappyOpts())}
    result = {}
    for name, data in corpora.items():
        batch = tpucomp_torch.ChunkBatch(data, torch.full((B,), C, dtype=torch.int32, device=data.device))
        grouped = cases.group_counts(data.cpu().numpy(), batch.lengths.cpu().numpy(), 1)
        profiling.reset()
        for api, opts in apis.values():
            api.decompress(api.compress(batch, opts), C, opts)
        torch.cuda.synchronize()
        if profiling.spans() or profiling.counters():
            raise AssertionError(f"phase 23 {name}: tracing off recorded {profiling.counters()}")
        got = {}
        for codec, (api, opts) in apis.items():
            profiling.reset()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                comp = api.compress(batch, opts)
                data_out, statuses = api.decompress(comp, C, opts)
                torch.cuda.synchronize()
            if not torch.equal(data_out.data, data) or statuses.any():
                raise AssertionError(f"phase 23 {name} {codec}: the traced round trip is not exact")
            counts = {k: v for k, v in profiling.counters().items()
                      if k.startswith(f"{codec}.") or (codec != "cascaded" and k.startswith("lz.table."))}
            if codec == "cascaded":
                head = comp.data[:, :3].to(torch.int64)
                raw = int(((head[:, 0] | head[:, 1] << 8 | head[:, 2] << 16) == 0).sum())
                kept = (B - raw) * (C // opts.chunk_size)
                ran, discarded = counts["cascaded.encode.chunks"], counts["cascaded.encode.chunks_discarded"]
                ok = (counts["cascaded.encode.partitions_raw"] == raw and ran - discarded == kept
                      and (name != "runheavy" or discarded == 0))
                counts["headers_raw"], counts["wasted_chunk_pct"] = raw, 100.0 * discarded / ran
            else:
                elements, sequences = (int(x.sum()) for x in _walk_steps(codec, comp.data, comp.lengths))
                counts["stream_sequences"], counts["stream_elements"] = sequences, elements
                ok = counts[f"{codec}.encode.sequences"] == sequences and (
                    counts["lz4.decode.sequences"] == sequences if codec == "lz4"
                    else counts["snappy.decode.elements"] == elements) and grouped == (
                    counts["lz.table.positions"], counts["lz.table.large_bucket_positions"])
                counts["large_bucket_pct"] = 100.0 * grouped[1] / grouped[0]
            if not ok:
                raise AssertionError(f"phase 23 {name} {codec}: counters do not hold to the streams: {counts}")
            got[codec] = counts
        profiling.reset()
        result[name] = got
        print(f"phase 23 tracer {name}: off, no record and no counter buffer; on, {json.dumps(got)}", flush=True)
    return result


def _host_ms(fn, *args, **kwargs):
    """(result, host-clock ms) of one call that ends in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _reset_counts(counters):
    for counts in counters.values():
        for key in counts:
            counts[key] = 0


def _codecs():
    import tpucomp_torch

    return {"cascaded": tpucomp_torch.cascaded_codec, "lz4": tpucomp_torch.lz4_codec,
            "snappy": tpucomp_torch.snappy_codec}


def phase_routing_flag(corpora, counters, paths, smi):
    """config.use_cuda_kernels on the card: False refuses 16 MB of mixed
    (the first 256 partitions) on cuda:0 in each codec's compress and
    decompress with ValueError and launches nothing; True launches the
    codec's kernels and gives None's bytes; True on a CPU batch raises.
    The flag goes back to None."""
    import torch

    import tpucomp_torch
    from tpucomp_torch import config

    k = B // 16  # 16 MB
    batch = tpucomp_torch.ChunkBatch(corpora["mixed"][:k], torch.full((k,), C, dtype=torch.int32,
                                                                        device=corpora["mixed"].device))
    try:
        for name, codec in _codecs().items():
            config.use_cuda_kernels = None
            comp = codec.compress(batch)
            out, statuses = codec.decompress(comp, C)
            torch.cuda.synchronize()
            _reset_counts(counters)
            config.use_cuda_kernels = False
            for step, call in (("compress", lambda: codec.compress(batch)),
                               ("decompress", lambda: codec.decompress(comp, C))):
                try:
                    call()
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"routing flag False: {name} {step} of a card batch did not raise")
            if any(any(c.values()) for c in counters.values()):
                raise AssertionError(f"routing flag False: {name} launched {counters}")
            config.use_cuda_kernels = True
            forced = codec.compress(batch)
            forced_out, forced_statuses = codec.decompress(forced, C)
            torch.cuda.synchronize()
            if not all(n > 0 for c in paths[name] for n in counters[c].values()):
                raise AssertionError(f"routing flag True: {name} did not launch its kernels: {counters}")
            for part, g, w in (("rows", forced.data, comp.data), ("sizes", forced.lengths, comp.lengths),
                               ("data", forced_out.data, out.data), ("statuses", forced_statuses, statuses)):
                _equal(f"routing flag True {name} {part}", g, w)
        try:
            tpucomp_torch.cascaded_codec.compress(tpucomp_torch.ChunkBatch(batch.data[:1].cpu(),
                                                                           batch.lengths[:1].cpu()))
        except ValueError:
            pass
        else:
            raise AssertionError("routing flag True: a CPU batch did not raise")
    finally:
        config.use_cuda_kernels = None
    print(f"phase 15 routing flag: use_cuda_kernels=False refuses 16 MB mixed [256 x 64 KB] on cuda:0 in every "
          f"codec's compress and decompress with ValueError and launches nothing; True launches each codec's "
          f"kernels and equals None's bytes; True on a CPU batch raises ValueError; flag back to None | {smi}",
          flush=True)
    return {"false_on_the_card": "ValueError", "true_on_the_cpu": "ValueError"}


def phase_sharding(corpora, counters, paths, smi):
    """The 256 MB mixed batch through sharding.sharded_compress and
    sharded_decompress (gather=True) for each codec over make_mesh() (every
    card) and [cuda:0] * 3 (4096 rows are no multiple of 3: padding and
    order on the card): rows and sizes equal one codec.compress of the
    whole batch, exact round trips, all SUCCESS, the codec's kernels
    launched.  CUDA-event medians of each call."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.parallel import sharding as sh
    from tpucomp_torch.utils.profiling import wall

    data = corpora["mixed"]
    batch = tpucomp_torch.ChunkBatch(data, torch.full((B,), C, dtype=torch.int32, device=data.device))
    meshes = {"make_mesh()": sh.make_mesh(), "[cuda:0] * 3": sh.make_mesh(["cuda:0"] * 3)}
    result = {}
    for name, codec in _codecs().items():
        single = codec.compress(batch)
        for label, mesh in meshes.items():
            _reset_counts(counters)
            comp = sh.sharded_compress(codec, batch, mesh, gather=True)
            out, statuses = sh.sharded_decompress(codec, comp, C, mesh, gather=True)
            torch.cuda.synchronize()
            launched = {k: n for c in paths[name] for k, n in counters[c].items()}
            if not all(n >= len(mesh) for n in launched.values()):
                raise AssertionError(f"sharded {name} over {label}: launches {counters}")
            _equal(f"sharded {name} over {label} rows", comp.data, single.data)
            _equal(f"sharded {name} over {label} sizes", comp.lengths, single.lengths)
            if not (torch.equal(out.data, batch.data) and bool((out.lengths == C).all())
                    and statuses.shape == (B,) and not bool(statuses.any())):
                raise AssertionError(f"sharded {name} over {label}: 256 MB round trip is not exact")
            t_comp = wall(sh.sharded_compress, codec, batch, mesh, gather=True, iters=3, warmup=1)
            t_decomp = wall(sh.sharded_decompress, codec, comp, C, mesh, gather=True, iters=3, warmup=1)
            result[f"{name} {label}"] = {"devices": [str(d) for d in mesh], "launches": launched,
                                         "compress_ms": t_comp.summary(), "decompress_ms": t_decomp.summary()}
            print(f"phase 16 sharding {name} over {label} ({len(mesh)} shards): 256 MB mixed, rows equal one "
                  f"compress, exact round trip, all SUCCESS, launches {launched}; by CUDA events, median of 3: "
                  f"compress {t_comp.median_ms:.3f} ms (min {t_comp.min_ms:.3f}, max {t_comp.max_ms:.3f}), "
                  f"decompress {t_decomp.median_ms:.3f} ms (min {t_decomp.min_ms:.3f}, max {t_decomp.max_ms:.3f}) "
                  f"| {smi}", flush=True)
            del comp, out, statuses
        del single
        torch.cuda.empty_cache()
    return result


def _multihost_worker(rank, world, port, backend, out_path):
    """One rank of phase 17: its block of the 256 MB mixed batch through
    compress_distributed, gather_to_host and decompress_distributed (Cascaded
    and LZ4) on its card; the gathered rows must equal one single-process
    compress, the round trip be exact.  Writes its times to ``out_path``."""
    import numpy as np
    import torch

    import tpucomp_torch
    from tpucomp_torch.kernels import cascaded_cuda as kc
    from tpucomp_torch.kernels import lz4_cuda as kl
    from tpucomp_torch.parallel import multihost
    from tpucomp_torch.utils.corpus import load_corpus

    multihost.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, backend=backend)
    dev = multihost.local_device()
    data = np.frombuffer(load_corpus(B * C), np.uint8).reshape(B, C)
    lengths = np.full((B,), C, np.int32)
    rows = B // world
    mine = slice(rank * rows, (rank + 1) * rows)
    batch = multihost.make_global_batch(data[mine], lengths[mine], device=dev)
    result = {"rank": rank, "device": str(dev), "backend": backend}
    for name, codec, counts in (("cascaded", tpucomp_torch.cascaded_codec, kc.LAUNCHES),
                                ("lz4", tpucomp_torch.lz4_codec, kl.LAUNCHES)):
        before = dict(counts)
        comp, t_comp = _host_ms(multihost.compress_distributed, codec, batch, device=dev)
        (got, got_sizes), t_gather = _host_ms(multihost.gather_to_host, comp)
        (out, statuses), t_decomp = _host_ms(multihost.decompress_distributed, codec, comp, C, device=dev)
        (odata, olens), t_gather_out = _host_ms(multihost.gather_to_host, out)
        if not all(counts[k] > before[k] for k in ("encode", "decode")):
            raise AssertionError(f"rank {rank} {name}: kernels not launched ({counts}, before {before})")
        single = codec.compress(tpucomp_torch.ChunkBatch.from_numpy(data, lengths, dev))
        if not (np.array_equal(got_sizes, single.lengths.cpu().numpy())
                and np.array_equal(got, single.data.cpu().numpy())):
            raise AssertionError(f"rank {rank} {name}: gathered rows differ from one compress")
        if bool(statuses.any()) or not (np.array_equal(odata, data) and (olens == C).all()):
            raise AssertionError(f"rank {rank} {name}: round trip is not exact")
        result[name] = {"compress_ms": t_comp, "gather_ms": t_gather, "decompress_ms": t_decomp,
                        "gather_decompressed_ms": t_gather_out, "gathered_bytes": int(got.nbytes)}
        del comp, out, statuses, single
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


def _run_ranks(world, backend, tmp):
    """Spawn ``world`` ranks of _multihost_worker; their results, rank
    order.  Every process is joined, or killed at its time limit."""
    import multiprocessing

    from tpucomp_torch.parallel import multihost

    ctx = multiprocessing.get_context("spawn")
    port = multihost.free_port()
    outs = [os.path.join(tmp, f"{backend}-{world}-{r}.json") for r in range(world)]
    procs = [ctx.Process(target=_multihost_worker, args=(r, world, port, backend, outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"multihost {backend} x {world}: exit codes {codes}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def phase_multihost(smi):
    """Two ranks on cuda:0 under gloo (NCCL takes one rank per card), each
    with half of the 256 MB mixed batch, then one NCCL run at world size
    torch.cuda.device_count(); gathered rows equal one single-process
    compress, exact round trips.  Host-clock times of each rank's calls."""
    import tempfile

    import torch

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend in ((2, "gloo"), (torch.cuda.device_count(), "nccl")):
            ranks = _run_ranks(world, backend, tmp)
            result[f"{backend} x {world}"] = ranks
            for name in ("cascaded", "lz4"):
                line = "; ".join(
                    f"rank {r['rank']} ({r['device']}): compress {r[name]['compress_ms']:.1f} ms, gather "
                    f"{r[name]['gather_ms']:.1f} ms ({r[name]['gathered_bytes'] / 1e6:.1f} MB), decompress "
                    f"{r[name]['decompress_ms']:.1f} ms, gather of the decompressed rows "
                    f"{r[name]['gather_decompressed_ms']:.1f} ms" for r in ranks)
                print(f"phase 17 multihost {name} {backend} x {world} ranks: 256 MB mixed, gathered rows equal "
                      f"one compress, exact round trip, all SUCCESS (host clock, one call each): {line} | {smi}",
                      flush=True)
    return result


def phase_cli_native(corpora, smi):
    """The 256 MB mixed corpus through the CLI per format (compress, info,
    decompress; byte-exact; a corrupted artifact returns 1), and the native
    staging held to numpy at 256 MB.  Host-clock times."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    import tpucomp_torch
    from tpucomp_torch import cli, native
    from tpucomp_torch.native import staging

    payload = corpora["mixed"].cpu().numpy().reshape(-1)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "mixed.bin")
        payload.tofile(src)
        for fmt in ("cascaded", "lz4", "snappy"):
            art, back = os.path.join(tmp, f"{fmt}.tpc"), os.path.join(tmp, f"{fmt}.back")
            t = {}
            for step, argv in (("compress", ["compress", "-f", fmt, src, art]), ("info", ["info", art]),
                               ("decompress", ["decompress", art, back])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    (rc, t[step]) = _host_ms(cli.main, argv)
                if rc != 0:
                    raise AssertionError(f"CLI {fmt} {step} returned {rc}: {buf.getvalue()}")
                if step == "info" and f"format:            {fmt}" not in buf.getvalue():
                    raise AssertionError(f"CLI info of {fmt}: {buf.getvalue()}")
            if not np.array_equal(np.fromfile(back, np.uint8), payload):
                raise AssertionError(f"CLI {fmt}: 256 MB round trip is not exact")
            result[fmt] = {**{f"{k}_ms": v for k, v in t.items()}, "artifact_bytes": os.path.getsize(art)}
        blob = np.fromfile(os.path.join(tmp, "lz4.tpc"), np.uint8)
        blob[blob.size // 2:] = np.random.default_rng(7).integers(0, 256, blob.size - blob.size // 2, dtype=np.uint8)
        blob.tofile(os.path.join(tmp, "corrupt.tpc"))
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["decompress", os.path.join(tmp, "corrupt.tpc"), os.path.join(tmp, "corrupt.back")])
        if rc != 1:
            raise AssertionError(f"CLI decompress of a corrupted artifact returned {rc}")

    if not native.available():
        raise AssertionError("the native library did not build (g++)")
    sizes = np.random.default_rng(11).integers(0, C + 1, B).astype(np.int64)
    concat = payload[: int(sizes.sum())]
    ends = np.cumsum(sizes)
    chunks = [concat[e - n : e].tobytes() for e, n in zip(ends, sizes)]
    dense, t_pack = _host_ms(staging.pack_ragged, concat, sizes, C)
    flat, t_unpack = _host_ms(staging.unpack_ragged, dense, sizes)
    mask = np.arange(C) < sizes[:, None]
    ref = np.zeros((B, C), np.uint8)
    ref[mask] = concat
    if not (np.array_equal(dense, ref) and np.array_equal(flat, ref[mask])):
        raise AssertionError("native staging differs from numpy")

    # pack_chunks / unpack_chunks (a numpy copy per row) against the same
    # work staged through the library (a concatenation, then tc_pack_ragged;
    # tc_unpack_ragged, then a slice per row), from and to a list of chunks
    def staged_pack(chunks):
        arrs = [np.frombuffer(c, np.uint8) for c in chunks]
        return staging.pack_ragged(np.concatenate(arrs), np.array([a.size for a in arrs]), C)

    def staged_unpack(data, lengths):
        sizes = lengths.astype(np.int64)
        flat, ends = staging.unpack_ragged(data, sizes), np.cumsum(sizes)
        return [flat[e - n : e].tobytes() for e, n in zip(ends, sizes)]

    batch = tpucomp_torch.pack_chunks(chunks, C, device="cpu")
    data, lengths = batch.data.numpy(), batch.lengths.numpy()
    calls = {"pack_chunks": lambda: tpucomp_torch.pack_chunks(chunks, C, device="cpu").data.numpy(),
             "staged_pack": lambda: staged_pack(chunks),
             "unpack_chunks": lambda: tpucomp_torch.unpack_chunks(batch),
             "staged_unpack": lambda: staged_unpack(data, lengths)}
    t = {k: [] for k in calls}
    for i in range(5):  # each pair in turns, the order swapped every round; medians of 5 are kept
        for pair in (("pack_chunks", "staged_pack"), ("unpack_chunks", "staged_unpack")):
            for name in pair[:: 1 if i % 2 == 0 else -1]:
                out, ms = _host_ms(calls[name])  # the previous output is freed before the call
                t[name].append(ms)
                good = out == chunks if "unpack" in name else np.array_equal(out, ref)
                if not good:
                    raise AssertionError(f"{name} differs from the chunks")
                del out
    result["staging"] = {"bytes": int(sizes.sum()), "pack_ragged_ms": t_pack, "unpack_ragged_ms": t_unpack,
                         **{f"{k}_ms": sorted(v)[2] for k, v in t.items()}}
    line = "; ".join(f"{fmt} compress {r['compress_ms']:.1f} ms ({B * C / r['artifact_bytes']:.4f}x), info "
                     f"{r['info_ms']:.1f} ms, decompress {r['decompress_ms']:.1f} ms"
                     for fmt, r in result.items() if fmt != "staging")
    s = result["staging"]
    print(f"phase 18 CLI and native: 256 MB mixed as a file, byte-exact round trips, a corrupted artifact "
          f"returns 1 (host clock, one call each, file reads and writes included): {line}; native staging of "
          f"{s['bytes'] / 1e6:.1f} MB in 4096 rows of 64 KB equal to numpy: pack_ragged {t_pack:.1f} ms, "
          f"unpack_ragged {t_unpack:.1f} ms; from and to a list of chunks (median of 5, in turns): pack_chunks "
          f"{s['pack_chunks_ms']:.1f} ms against staged {s['staged_pack_ms']:.1f} ms, unpack_chunks "
          f"{s['unpack_chunks_ms']:.1f} ms against staged {s['staged_unpack_ms']:.1f} ms | {smi}", flush=True)
    return result


def phase_conformance(dev, counters, paths, smi):
    """tests/test_batch_api.py's matrix through the port's low-level codecs
    (lowlevel/{cascaded,lz4,snappy}.py) on the card, at batch sizes 1, 11,
    127, 1025 and 10025 and capacity 2048 (its payload generator and seed,
    tests/torch_batch_cases.py): temp sizes 0, sizes within
    compress_get_max_output_chunk_size, get_decompress_size equal to the
    input lengths, exact round trips, every compressed row and size and
    every decoded row, length and status equal to the plain versions'
    (tolerance 0); a garbage batch gives only SUCCESS or
    ERROR_CANNOT_DECOMPRESS, length 0 where decode failed, equal to the
    plain versions too.  Each codec launches its own kernels and no
    other's.  Returns the max abs error per kernel and the rows checked by codec."""
    import numpy as np
    import torch

    import torch_batch_cases as cases
    import tpucomp_torch
    from tpucomp_torch.codecs import cascaded as cc
    from tpucomp_torch.codecs import lz4 as tl
    from tpucomp_torch.codecs import snappy as ts
    from tpucomp_torch.core.options import CascadedOpts
    from tpucomp_torch.core.types import Status

    o = CascadedOpts()
    plain = {"cascaded": (lambda d, n: cc._compress_plain(d, n, o), lambda c, s, k: cc._decompress_plain(c, s, o, k)),
             "lz4": (tl._compress_plain, tl._decompress_plain),
             "snappy": (ts._compress_plain, ts._decompress_plain)}
    cap = cases.CAPACITY
    allowed = {int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS)}
    err = {"encode": 0, "decode": 0}
    codecs = _codecs()
    rows = dict.fromkeys(codecs, 0)
    t0 = time.perf_counter()
    for name, codec in codecs.items():
        enc_plain, dec_plain = plain[name]

        def decode_both(label, comp):
            out, statuses = codec.decompress(comp, cap)
            for part, g, w in zip(("data", "lengths", "status"), (out.data, out.lengths, statuses),
                                  dec_plain(comp.data, comp.lengths, cap)):
                err["decode"] = max(err["decode"], _equal(f"conformance {name} {label} decode {part}", g, w))
            return out, statuses

        _reset_counts(counters)
        for n in cases.BATCH_SIZES:
            payloads = cases.payloads(np.random.default_rng(0), name, n)
            batch = tpucomp_torch.pack_chunks(payloads, capacity=cap, device=dev)
            if codec.compress_get_temp_size(n, cap) or codec.decompress_get_temp_size(n, cap):
                raise AssertionError(f"conformance {name} x {n}: a temp size is not 0")
            comp = codec.compress(batch)
            want = enc_plain(batch.data, batch.lengths)
            err["encode"] = max(err["encode"], _equal(f"conformance {name} x {n} rows", comp.data, want[0]),
                                _equal(f"conformance {name} x {n} sizes", comp.lengths, want[1]))
            if not bool((comp.lengths <= codec.compress_get_max_output_chunk_size(cap)).all()):
                raise AssertionError(f"conformance {name} x {n}: a size exceeds the worst-case bound")
            _equal(f"conformance {name} x {n} get_decompress_size", codec.get_decompress_size(comp), batch.lengths)
            out, statuses = decode_both(f"x {n}", comp)
            if bool(statuses.any()) or tpucomp_torch.unpack_chunks(out) != payloads:
                raise AssertionError(f"conformance {name} x {n}: the round trip is not exact")
            rows[name] += n
            del batch, comp, want, out, statuses
        garbage, sizes = cases.garbage(np.random.default_rng(0))
        g = tpucomp_torch.ChunkBatch(torch.from_numpy(garbage).to(dev), torch.from_numpy(sizes).to(dev))
        out, statuses = decode_both("garbage", g)
        st = statuses.cpu().numpy()
        if not set(np.unique(st).tolist()) <= allowed or (out.lengths.cpu().numpy()[st != 0] != 0).any():
            raise AssertionError(f"conformance {name} garbage: statuses {st}, lengths {out.lengths}")
        launched = {k: n for c in paths[name] for k, n in counters[c].items()}
        if not all(launched.values()) or any(any(c.values()) for k, c in counters.items() if k not in paths[name]):
            raise AssertionError(f"conformance {name}: launches {counters}")
    torch.cuda.empty_cache()
    print(f"phase 20 conformance: tests/test_batch_api.py's matrix through the low-level codecs on the card, "
          f"batch sizes {cases.BATCH_SIZES} at capacity {cap} ({rows} rows by codec): temp sizes 0, sizes "
          f"within the bound, get_decompress_size = lengths, exact round trips, compressed rows and sizes and "
          f"decoded rows equal to the plain versions (tolerance 0, max abs err {err}); garbage rows give only "
          f"SUCCESS or ERROR_CANNOT_DECOMPRESS with length 0 where decode failed "
          f"({time.perf_counter() - t0:.1f} s) | {smi}", flush=True)
    return err, rows


BENCH_MODES = ("main", "snappy")  # between them, every cell of the bench


def phase_bench(times, lz4_times, snappy_times, smi):
    """``python -m tpucomp_torch.bench --codec main`` and ``--codec snappy``
    as subprocesses: exit code 0, one JSON line, every cell at 256 MB with
    an exact round trip and its codec's kernels launched (and no other's),
    the card's name and power limit.  The Cascaded cells hold phase 4-5's
    bytes: a whole call that reads below 0.9 x its kernel's median from
    phase 5 is an impossible reading and fails.  Returns the bench lines
    by mode."""
    import torch

    lines = {}
    t_phase = time.perf_counter()
    for mode in BENCH_MODES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpucomp_torch.bench", "--codec", mode], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bench --codec {mode} exited {proc.returncode}: {proc.stderr[-3000:]}")
        out = proc.stdout.strip().splitlines()
        line = json.loads(out[-1])
        lines[mode] = line
        dev_info = line["device"]
        if dev_info["platform"] != "gpu" or dev_info["kind"] != torch.cuda.get_device_name(0) or \
                not dev_info["power_limit"]:
            raise AssertionError(f"bench --codec {mode}: device {dev_info}")
        print(f"phase 21 bench --codec {mode} ({time.perf_counter() - t0:.1f} s, build {line['build_s']:.2f} s): "
              f"value {line['value']:.4f} {line['unit']}, vs_baseline {line['vs_baseline']}, "
              f"device {dev_info['kind']}, {dev_info['power_limit']}", flush=True)
        _bench_cells(line, times, lz4_times, snappy_times)
    print(f"  phase 21 subprocesses: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return lines


def _bench_cells(line, times, lz4_times, snappy_times):
    """Check each cell of one bench line and print its whole-call times
    beside the kernels' times of phases 5, 8 and 12."""
    import tpucomp_torch.bench as tb

    kernels = {"cascaded": {"cascaded.encode", "cascaded.decode"},
               "lz4": {"lz77.table", "lz4.encode", "lz4.decode"},
               "snappy": {"lz77.table", "snappy.encode", "snappy.decode"}}
    kernel_times = {"cascaded": times["mixed"], "cascaded-runheavy": times["runheavy"]}
    for cell, r in line["cells"].items():
        want = {k: tb.WARMUP + tb.ITERS + (2 if k.endswith(("encode", "table")) else 1)
                for k in kernels[r["codec"]]}
        if not r["roundtrip_ok"] or r["bytes"] != B * C or r["launches"] != want:
            raise AssertionError(f"bench {cell}: round trip {r['roundtrip_ok']}, {r['bytes']} bytes, "
                                 f"launches {r['launches']} (want {want})")
        text = (f"  {cell} (seed {r['seed']}): whole calls encode {r['encode_ms']:.3f} ms (min "
                f"{r['encode_min_ms']:.3f}, max {r['encode_max_ms']:.3f}), decode {r['decode_ms']:.3f} ms (min "
                f"{r['decode_min_ms']:.3f}, max {r['decode_max_ms']:.3f}); {r['encode_gbps']:.3f} / "
                f"{r['decode_gbps']:.3f} GB/s, ratio {r['ratio']:.4f}, peak memory of a compress "
                f"{r['peak_compress_bytes'] / 1e6:.1f} MB; launches {r['launches']}")
        if cell in kernel_times:
            kt = kernel_times[cell]
            for k in ("encode", "decode"):
                if r[f"{k}_ms"] < 0.9 * kt[f"kernel_{k}"]["median_ms"]:
                    raise AssertionError(f"bench {cell}: a whole {k} call reads {r[f'{k}_ms']:.3f} ms, below "
                                         f"0.9 x its kernel's {kt[f'kernel_{k}']['median_ms']:.3f} ms (phase 5)")
            text += (f"; phase 5's kernels on the same bytes: encode {kt['kernel_encode']['median_ms']:.3f} "
                     f"ms, decode {kt['kernel_decode']['median_ms']:.3f} ms")
        elif cell in ("lz4", "snappy"):
            kt = {"lz4": lz4_times, "snappy": snappy_times}[cell]["mixed"]
            text += (f"; phase {8 if cell == 'lz4' else 12}'s kernels on mixed seed 0, another rotation of "
                     f"the corpus: table {kt['kernel_table']['median_ms']:.3f} + encode "
                     f"{kt['kernel_encode']['median_ms']:.3f} ms, whole compress {kt['compress']['median_ms']:.3f}"
                     f" ms, decode {kt['kernel_decode']['median_ms']:.3f} ms")
        if "copy_gbps" in r:
            text += (f"; ceiling (median over {tb.CEILING_GROUPS} groups of {tb.ITERS}): aligned copy "
                     f"{r['copy_ms']:.3f} ms ({r['copy_gbps']:.1f} GB/s), the JAX bench's shifted copy "
                     f"{r['memcpy_ms']:.3f} ms ({r['memcpy_gbps']:.1f} GB/s)")
        print(text, flush=True)


EXAMPLES = ("torch_round_trip.py", "torch_distributed.py")


def phase_examples(smi):
    """The port's two examples run as a user runs them, on the card (their
    default device): exit code 0, so every assert in them held."""
    result = {}
    for script in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script)], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"example {script} exited {proc.returncode}: {proc.stderr[-3000:]}")
        result[script] = proc.stdout.strip().splitlines()
        print(f"phase 22 example {script}: rc 0 ({time.perf_counter() - t0:.1f} s): "
              f"{' | '.join(result[script])} | {smi}", flush=True)
    return result


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
    from tpucomp_torch.kernels import manager_cuda as km
    from tpucomp_torch.kernels import snappy_cuda as ks

    # each wrapper module's launch counts, and the modules each main path launches
    counters = {"cascaded": kc.LAUNCHES, "lz4": kl.LAUNCHES, "snappy": ks.LAUNCHES, "table": kt.LAUNCHES,
                "manager": km.LAUNCHES}
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

    from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus

    def make_corpora():
        return {
            name: torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).to(dev)
            for name, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus))
        }

    t0 = time.perf_counter()
    matrix_err, n_cases, n_w8, n_inputs = phase_matrix(dev)
    print(f"phase 3 kernel vs plain: {n_cases} comparisons on {n_inputs} inputs equal "
          f"(tolerance 0), {n_w8} of them of 8-byte elements, oracle agrees; LONGLONG and ULONGLONG "
          f"batches through codecs.cascaded launch the kernels ({time.perf_counter() - t0:.1f} s)", flush=True)

    corpora = make_corpora()

    def launched(codec):
        """The launch counts of ``codec``'s kernels (LZ: match table,
        encode, decode)."""
        return {k: n for c in paths[codec] for k, n in counters[c].items()}

    def only_launched(codec):
        """True when the last main path launched every kernel of ``codec``
        once per corpus or more, and no other kernel."""
        return all(n >= len(corpora) for n in launched(codec).values()) and not any(
            any(c.values()) for name, c in counters.items() if name not in paths[codec])

    _reset_counts(counters)
    phase_main_path(dev, corpora)
    launches = {"cascaded": launched("cascaded")}
    if not only_launched("cascaded"):
        raise AssertionError(f"the Cascaded main path launched {counters}")

    times, main_err = phase_times(dev, corpora)
    launches["cascaded_w8"], w8_times, w8_err = phase_w8(dev, corpora, counters, paths)

    t0 = time.perf_counter()
    lz4_err, n_lz4, n_lz4_inputs = phase_lz4_matrix(dev)
    print(f"phase 6 LZ4 kernel vs plain: {n_lz4} comparisons on {n_lz4_inputs} encode inputs "
          f"and their streams, the oracle's, the golden fixtures and 4 garbage batches equal "
          f"(tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    _reset_counts(counters)
    phase_lz4_main_path(corpora)
    launches["lz4"] = launched("lz4")
    if not only_launched("lz4"):
        raise AssertionError(f"the LZ4 main path did not launch the LZ4 kernels alone: {counters}")

    lz4_times, lz4_main_err = phase_lz4_times(corpora)
    phase_profile(corpora)
    tracer_counts = phase_tracer(corpora)

    t0 = time.perf_counter()
    snappy_err, n_snappy, n_snappy_inputs = phase_snappy_matrix(dev)
    print(f"phase 10 Snappy kernel vs plain: {n_snappy} comparisons on {n_snappy_inputs} encode inputs "
          f"and their streams, the oracle's, the golden fixtures, foreign and crafted streams and 4 "
          f"garbage batches equal (tolerance 0), oracle agrees ({time.perf_counter() - t0:.1f} s)", flush=True)

    _reset_counts(counters)
    phase_snappy_main_path(corpora)
    launches["snappy"] = launched("snappy")
    if not only_launched("snappy"):
        raise AssertionError(f"the Snappy main path did not launch the Snappy kernels alone: {counters}")
    print(f"  launches on the main paths: {json.dumps(launches)}", flush=True)

    snappy_times, snappy_main_err = phase_snappy_times(corpora)
    hlif = phase_hlif(corpora, counters, paths)
    scaling = phase_scaling(corpora)
    host = {"routing_flag": phase_routing_flag(corpora, counters, paths, smi),
            "sharding": phase_sharding(corpora, counters, paths, smi),
            "multihost": phase_multihost(smi),
            "cli_native": phase_cli_native(corpora, smi)}
    conformance_err, conformance_rows = phase_conformance(dev, counters, paths, smi)
    bench_lines = phase_bench(times, lz4_times, snappy_times, smi)
    examples = phase_examples(smi)

    kernels = []
    mixed, lz4_mixed, snappy_mixed = times["mixed"], lz4_times["mixed"], snappy_times["mixed"]
    # 8-byte rows on a real 64-bit column, the cell with the most Cascaded work
    # (no fallback, every chunk bit-packed); phase 19 prints every cell's bound
    w8 = w8_times["timestamps64_longlong"]
    # bounds: each input read once, each output written once.  LZ encode:
    # the chunk, a table entry (2 bytes) per literal byte and per
    # sequence, the stream; the table: the chunk and 2 bytes per position
    lz = {"lz4": lz4_mixed, "snappy": snappy_mixed}
    rows = [
        ("cascaded_encode", "cascaded_encode.cu", "tpucomp/kernels/cascaded_pallas.py:294", launches["cascaded"]["encode"],
         mixed, "encode", max(matrix_err["encode"], main_err["encode"]), B * C + mixed["comp_bytes"] + 8 * B),
        ("cascaded_decode", "cascaded_decode.cu", "tpucomp/kernels/cascaded_pallas.py:874", launches["cascaded"]["decode"],
         mixed, "decode", max(matrix_err["decode"], main_err["decode"]), mixed["comp_bytes"] + B * C + 12 * B),
        # 8-byte elements: the same sources' 64-bit instantiations, in place
        # of tpucomp's XLA path (its Pallas kernels take widths 1, 2 and 4)
        ("cascaded_encode_w8", "cascaded_encode.cu", "tpucomp/codecs/cascaded.py:546",
         launches["cascaded_w8"]["encode"], w8, "encode", max(matrix_err["encode"], w8_err["encode"]),
         B * C + w8["comp_bytes"] + 8 * B),
        ("cascaded_decode_w8", "cascaded_decode.cu", "tpucomp/codecs/cascaded.py:714",
         launches["cascaded_w8"]["decode"], w8, "decode", max(matrix_err["decode"], w8_err["decode"]),
         w8["comp_bytes"] + B * C + 12 * B),
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
    print(f"  8-byte cells: {json.dumps(w8_times)}", flush=True)
    print(f"  HLIF: {json.dumps(hlif)}", flush=True)
    print(f"  scaling: {json.dumps(scaling)}", flush=True)
    print(f"  host surface: {json.dumps(host)}", flush=True)
    print(f"  conformance: {json.dumps({'rows_by_codec': conformance_rows, 'max_abs_err': conformance_err})}",
          flush=True)
    for mode, line in bench_lines.items():
        print(f"  bench --codec {mode}: {json.dumps(line)}", flush=True)
    print(f"  tracer counters: {json.dumps(tracer_counts)}", flush=True)
    print(f"  examples: {json.dumps(examples)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
