"""The port's bench: batched codec throughput on one NVIDIA GPU.

    python -m tpucomp_torch.bench [--codec main|all|cascaded|cascaded-runheavy|lz4|snappy]
                                  [--mb MB] [--device cuda|cpu]

Counterpart of the JAX package's ``bench.py``, with its modes and its
one-line output, measured the way the card is measured.  Each cell is a
batch of ``uint8[B, 65536]`` partitions with full lengths on the device
(256 MB, ``B = 4096``, unless ``--mb`` says otherwise), compressed by one
call of ``codecs.{cascaded,lz4,snappy}.compress`` over the whole batch
with the default options, then decompressed by one ``decompress`` call.
Each call is timed between CUDA events (``utils.profiling.wall``): the
median of 7 calls after 2 warm-ups, with min and max.  256 MB exceeds the
H100's 50 MB L2, so no cache flush is needed.  The kernels are built
before the first warm-up and the build seconds are reported as set-up,
apart from the times, as are the seconds spent making a cell's corpus.

Corpora (``CELLS``, from ``utils/corpus.py``: the JAX bench's bytes and seeds): Cascaded
on the mixed corpus (seed 0) and on the run-heavy int32 columns (seed 2),
LZ4 and Snappy on the mixed corpus rotated by seed 1.

``main`` runs Cascaded on mixed (with the copy ceiling), Cascaded on
runheavy and LZ4, its headline the geomean of min(encode, decode) GB/s
over Cascaded-mixed and LZ4; ``all`` runs those and Snappy, its headline
the geomean over the three codecs; a single codec's headline is its
min(encode, decode).  One JSON line is printed: ``metric`` (the headline
with a detail string), ``value``, ``unit``, ``harness``, ``vs_baseline``
(the headline over half the card's HBM rate, null on a card not in
``HBM_GBPS``), ``cells`` (every cell's numbers as fields), ``device``
(platform, name, count, power limit) and ``build_s`` (the kernels'
build, which the first cell carries).  If a round trip
is not exact the line is printed and the exit code is 1.

Without a CUDA device the bench raises and prints nothing.  ``--device
cpu`` is for the tests: it runs the plain PyTorch versions, one timed call
per stage and no warm-up, on the host clock; its line says ``"platform":
"cpu"`` and ``vs_baseline`` is null, so no host time reads as a device
metric.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpucomp_torch.core.chunking import ChunkBatch
from tpucomp_torch.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp_torch.core.types import Status
from tpucomp_torch.utils import corpus as _corpus
from tpucomp_torch.utils.profiling import WallResult, wall

CHUNK = 64 * 1024  # the partition size of the JAX bench
ITERS, WARMUP = 7, 2
CEILING_GROUPS = 3  # groups of ITERS copies of each form, in turns
HARNESS = "torch-256MB-cuda-events"
# device-memory rate by card name, GB/s (NVIDIA's data sheet: H100 SXM, 3.35 TB/s)
HBM_GBPS = {"H100 80GB HBM3": 3350.0}
PEAK_SLACK = 1.05  # a copy that reads more than this over the card's rate is a timing fault
# cell -> (codec, corpus, seed): the JAX bench's corpora and seeds
CELLS = {
    "cascaded": ("cascaded", "mixed", 0),
    "cascaded-runheavy": ("cascaded", "runheavy", 2),
    "lz4": ("lz4", "mixed", 1),
    "snappy": ("snappy", "mixed", 1),
}


def codec_calls(name: str):
    """(compress, decompress) of one codec with its default options, as
    functions of (data, lengths) and (comp, sizes): the calls each cell
    times."""
    if name == "cascaded":
        from tpucomp_torch.codecs import cascaded as cc

        opts = CascadedOpts()
        return (lambda d, n: cc.compress(d, n, opts)), (lambda c, s: cc.decompress(c, s, opts, CHUNK))
    if name == "lz4":
        from tpucomp_torch.codecs import lz4 as m

        opts = LZ4Opts()
    elif name == "snappy":
        from tpucomp_torch.codecs import snappy as m

        opts = SnappyOpts()
    else:
        raise ValueError(f"unknown codec {name!r}")
    return (lambda d, n: m.compress(d, n, opts)), (lambda c, s: m.decompress(c, s, opts, out_capacity=CHUNK))


def _device(device) -> torch.device:
    """The bench's device; a CUDA device that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA device and found none "
                           "(--device cpu runs the plain versions for the tests)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the bench runs on cuda or cpu, not {dev}")
    return dev


def _build_s(dev: torch.device) -> float | None:
    """Seconds to build and load the kernels (0 once built in this process);
    None on the CPU, which runs no kernel."""
    if dev.type != "cuda":
        return None
    from tpucomp_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    return time.perf_counter() - t0


def _time(fn, dev: torch.device, iters: int, warmup: int) -> WallResult:
    """Per-call times of ``fn()``: CUDA events on a card, the host clock on
    the CPU."""
    if dev.type == "cuda":
        return wall(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return WallResult(ms)


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count, by "module.kernel"."""
    from tpucomp_torch.kernels import cascaded_cuda, lz4_cuda, lz77_cuda, snappy_cuda

    return {f"{mod.__name__.rsplit('.', 1)[-1].removesuffix('_cuda')}.{k}": n
            for mod in (cascaded_cuda, lz4_cuda, lz77_cuda, snappy_cuda) for k, n in mod.LAUNCHES.items()}


def cell_batch(cell: str, total_mb: float = 256, device="cuda") -> ChunkBatch:
    """The batch ``cell`` (a key of ``CELLS``) times: its corpus's first
    ``total_mb`` MB as ``uint8[B, 65536]`` partitions with full lengths
    on ``device``."""
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r}")
    _, kind, seed = CELLS[cell]
    dev = _device(device)
    total = int(total_mb * 2**20)
    b = total // CHUNK
    if b < 1:
        raise ValueError(f"{total} bytes make no {CHUNK}-byte partition")
    raw = _corpus.runheavy_corpus(total, seed) if kind == "runheavy" else _corpus.load_corpus(total, seed)
    data = np.frombuffer(raw, np.uint8)[: b * CHUNK].reshape(b, CHUNK)
    return ChunkBatch(torch.from_numpy(data.copy()).to(dev), torch.full((b,), CHUNK, dtype=torch.int32, device=dev))


def _peak_compress_bytes(compress, batch: ChunkBatch, dev: torch.device) -> int | None:
    """Device memory one compress allocates at its peak above what was
    allocated before it; None on the CPU."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = compress(batch.data, batch.lengths)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    return int(peak)


def hbm_gbps(dev: torch.device) -> float | None:
    """The card's device-memory rate in GB/s, None for the CPU or a card
    not in ``HBM_GBPS``."""
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    return next((v for k, v in HBM_GBPS.items() if k in name), None)


def _ceiling(data: torch.Tensor, comp: torch.Tensor, dev: torch.device, iters: int, warmup: int) -> dict:
    """Two device copies of the cell's bytes, interleaved in
    ``CEILING_GROUPS`` groups of ``iters``: ``dst.copy_(data)``, aligned,
    and the JAX bench's form, the compressed rows' ``[:, 8:8 + CHUNK]``
    (shifted by 8 bytes, rows ``comp.shape[1]`` apart).  Medians, in GB/s
    of the uncompressed bytes; a copy that reads above the card's rate
    raises."""
    if comp.shape[1] < 8 + CHUNK:
        raise ValueError(f"compressed rows of {comp.shape[1]} bytes hold no shifted {CHUNK}-byte copy")
    dst = torch.empty_like(data)
    forms = {"copy": data, "memcpy": comp[:, 8 : 8 + CHUNK]}
    ms = {k: [] for k in forms}
    for g in range(CEILING_GROUPS):
        for k in list(forms)[:: 1 if g % 2 == 0 else -1]:
            ms[k] += _time(lambda: dst.copy_(forms[k]), dev, iters, warmup).ms
    nbytes = data.numel()
    peak = hbm_gbps(dev)
    out = {}
    for k, v in ms.items():
        med = statistics.median(v)
        if peak is not None and 2 * nbytes / 1e6 / med > PEAK_SLACK * peak:
            raise RuntimeError(f"the {k} ceiling reads {2 * nbytes / 1e6 / med:.1f} GB/s moved, above the "
                               f"card's {peak} GB/s: the timing is wrong")
        out[f"{k}_gbps"] = nbytes / 1e6 / med
        out[f"{k}_ms"] = med
    return out


def _measure(codec: str, batch: ChunkBatch, dev: torch.device, iters: int, warmup: int,
             measure_roofline: bool) -> dict:
    """Time ``iters`` compress and decompress calls of the whole batch,
    check the round trip and return the cell's numbers."""
    compress, decompress = codec_calls(codec)
    nbytes = batch.data.numel()
    peak = _peak_compress_bytes(compress, batch, dev)
    enc = _time(lambda: compress(batch.data, batch.lengths), dev, iters, warmup)
    comp, sizes = compress(batch.data, batch.lengths)
    dec = _time(lambda: decompress(comp, sizes), dev, iters, warmup)
    data, lengths, statuses = decompress(comp, sizes)
    ok = (torch.equal(data, batch.data) and torch.equal(lengths, batch.lengths)
          and not bool((statuses != int(Status.SUCCESS)).any()))
    res = {
        "codec": codec, "bytes": nbytes, "partitions": batch.batch_size, "partition_bytes": CHUNK,
        "encode_gbps": nbytes / 1e6 / enc.median_ms, "decode_gbps": nbytes / 1e6 / dec.median_ms,
        "encode_ms": enc.median_ms, "encode_min_ms": enc.min_ms, "encode_max_ms": enc.max_ms,
        "decode_ms": dec.median_ms, "decode_min_ms": dec.min_ms, "decode_max_ms": dec.max_ms,
        "ratio": nbytes / int(sizes.to(torch.int64).sum()),
        "roundtrip_ok": bool(ok),
        "peak_compress_bytes": peak,
        "iters": iters, "warmup": warmup,
    }
    if measure_roofline:
        res.update(_ceiling(batch.data, comp, dev, iters, warmup))
    return res


def _cell(cell: str, total_mb: float, dev: torch.device, iters: int, warmup: int,
          measure_roofline: bool) -> dict:
    """One cell of ``CELLS`` at ``total_mb`` MB, with the kernel launches
    it made (``launches``: none on the CPU) and the seconds spent making
    its batch (``setup_s``); its tensors are freed, and the allocator's
    cache emptied, before it returns."""
    codec, kind, seed = CELLS[cell]
    build_s = _build_s(dev)
    t0 = time.perf_counter()
    batch = cell_batch(cell, total_mb, dev)
    setup_s = time.perf_counter() - t0
    before = _launch_counts()
    res = _measure(codec, batch, dev, iters, warmup, measure_roofline)
    launches = {k: n - before[k] for k, n in _launch_counts().items() if n != before[k]}
    del batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {**res, "launches": launches, "build_s": build_s, "setup_s": setup_s, "corpus": kind, "seed": seed}


def bench_cascaded(total_mb: float = 256, iters: int = ITERS, warmup: int = WARMUP, corpus_kind: str = "mixed",
                   measure_roofline: bool = False, device="cuda") -> dict:
    """Cascaded (``CascadedOpts()``) on the mixed corpus (seed 0) or the
    run-heavy columns (seed 2), ``total_mb`` MB in 64 KB partitions; with
    ``measure_roofline``, the copy ceiling on the same bytes."""
    if corpus_kind not in ("mixed", "runheavy"):
        raise ValueError(f"unknown corpus {corpus_kind!r}")
    cell = "cascaded" if corpus_kind == "mixed" else "cascaded-runheavy"
    return _cell(cell, total_mb, _device(device), iters, warmup, measure_roofline)


def bench_lz(codec_name: str, total_mb: float = 256, iters: int = ITERS, warmup: int = WARMUP,
             device="cuda") -> dict:
    """LZ4 (``LZ4Opts()``) or Snappy (``SnappyOpts()``) on the mixed corpus
    rotated by seed 1, ``total_mb`` MB in 64 KB partitions; the compress
    time is the whole call, match-table kernel and encode kernel."""
    if codec_name not in ("lz4", "snappy"):
        raise ValueError(f"unknown LZ codec {codec_name!r}")
    return _cell(codec_name, total_mb, _device(device), iters, warmup, False)


def device_info(dev: torch.device) -> dict:
    """The platform, the device's name and count, and (on a card) its power
    limit as nvidia-smi reports it for that card, found by its UUID (torch's
    device index need not be nvidia-smi's)."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or platform.machine(), "count": 1,
                "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
    try:
        line = subprocess.run(["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = None  # no nvidia-smi: the limit is not known
    if line and line.rsplit(",", 1)[0].strip() != name:
        raise RuntimeError(f"nvidia-smi reports {line!r} for {uuid}, which torch names {name!r}")
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
            "power_limit": line.rsplit(",", 1)[-1].strip() if line else None, "nvidia_smi": line}


def _detail(label: str, r: dict) -> str:
    s = (f"{label}:enc={r['encode_gbps']:.3f},dec={r['decode_gbps']:.3f},"
         f"ratio={r['ratio']:.2f},ok={r['roundtrip_ok']}")
    if "copy_gbps" in r:
        s += f",memcpy-roofline={r['memcpy_gbps']:.1f},copy={r['copy_gbps']:.1f}"
    return s


def _geomean(cells: list[dict]) -> float:
    vals = [min(r["encode_gbps"], r["decode_gbps"]) for r in cells]
    return float(np.prod(vals)) ** (1 / len(vals))


def run(codec: str = "main", total_mb: float = 256, device="cuda") -> dict:
    """The bench's result line for ``codec`` (a mode of ``--codec``) as a dict."""
    dev = _device(device)
    iters, warmup = (ITERS, WARMUP) if dev.type == "cuda" else (1, 0)
    kw = {"total_mb": total_mb, "iters": iters, "warmup": warmup, "device": dev}
    corpus = "mixed_v1 corpus (vendored Silesia-profile stand-in), 64KB chunks"
    if codec in ("main", "all"):
        cells = {"cascaded": bench_cascaded(measure_roofline=True, **kw),
                 "cascaded-runheavy": bench_cascaded(corpus_kind="runheavy", **kw),
                 "lz4": bench_lz("lz4", **kw)}
        if codec == "all":
            cells["snappy"] = bench_lz("snappy", **kw)
        heads = ["cascaded", "lz4"] + (["snappy"] if codec == "all" else [])
        value = _geomean([cells[k] for k in heads])
        labels = {"cascaded": "cascaded-mixed"} if codec == "main" else {}
        detail = " ".join(_detail(labels.get(k, k), r) for k, r in cells.items())
        metric = (f"geomean min(enc,dec) GB/s/card, {'+'.join(heads)}, {corpus} ({detail})" if codec == "main"
                  else f"geomean min(enc,dec) GB/s/card over codecs ({detail})")
    elif codec in ("cascaded", "cascaded-runheavy"):
        kind = "runheavy" if codec.endswith("runheavy") else "mixed"
        cells = {codec: bench_cascaded(corpus_kind=kind, **kw)}
    elif codec in ("lz4", "snappy"):
        cells = {codec: bench_lz(codec, **kw)}
    else:
        raise ValueError(f"unknown codec mode {codec!r}")
    if codec not in ("main", "all"):
        r = cells[codec]
        value = min(r["encode_gbps"], r["decode_gbps"])
        metric = (f"{codec} 64KB-chunk batch min(encode,decode) GB/s/card (enc={r['encode_gbps']:.2f} "
                  f"dec={r['decode_gbps']:.2f} ratio={r['ratio']:.2f} ok={r['roundtrip_ok']})")
    hbm = hbm_gbps(dev)
    return {
        "metric": metric,
        "value": value,
        "unit": "GB/s",
        "harness": HARNESS if dev.type == "cuda" else "torch-cpu-host-clock",
        "vs_baseline": value / (0.5 * hbm) if hbm else None,
        "cells": cells,
        "device": device_info(dev),
        "build_s": sum(r["build_s"] for r in cells.values()) if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpucomp_torch.bench", description=__doc__.split("\n\n")[0])
    p.add_argument("--codec", choices=["cascaded", "cascaded-runheavy", "lz4", "snappy", "all", "main"],
                   default="main")
    p.add_argument("--mb", type=float, default=256, help="megabytes (2**20) per cell, in 64 KB partitions")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions, for the tests)")
    args = p.parse_args(argv)
    line = run(args.codec, args.mb, args.device)
    print(json.dumps(line), flush=True)
    return 0 if all(r["roundtrip_ok"] for r in line["cells"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
