#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpucomp_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's Cascaded main path once, in phases, each printing one
line (any failure raises and exits non-zero):

1. device: the card's name, and its power limit from nvidia-smi
2. build: the CUDA kernels from tpucomp_torch/csrc, with nvcc, timed
3. kernel vs plain: every kernel case of tests/torch_cases.py (the test
   matrix, the rest of the option space, random options and shapes, two
   16 MB partitions) on CUDA tensors, with corrupt, damaged and garbage
   streams, through both the kernels and their plain PyTorch versions; exact equality (tolerance 0: the codec is
   lossless and every output is an integer tensor).  A few default-option
   partitions are also checked against tests/oracles/cascaded_oracle.py.
4. main path: 256 MB of the mixed corpus and of the run-heavy corpus, as
   uint8[4096, 65536], through tpucomp_torch.cascaded_codec.compress /
   decompress on cuda:0; exact round trips, all SUCCESS, both kernels
   launched (launch counters reset just before)
5. times: CUDA-event medians (with min and max) of the kernels, of their
   plain versions at the same shape, and of a device-to-device copy of the
   same bytes

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
        line = ", ".join(f"{k} {v.gbps:.3f} GB/s (median {v.median_ms:.3f} ms, "
                         f"min {v.min_ms:.3f}, max {v.max_ms:.3f})" for k, v in t.items())
        print(f"phase 5 times {name} 256 MB [4096 x 64 KB]: {line}", flush=True)
        del comp, sizes, dst
        torch.cuda.empty_cache()
    return times, err


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
    for k in kc.LAUNCHES:
        kc.LAUNCHES[k] = 0
    phase_main_path(dev, corpora)
    launches = dict(kc.LAUNCHES)

    times, main_err = phase_times(dev, corpora)
    kernels = []
    for k, src, line in (("encode", "cascaded_encode.cu", 294), ("decode", "cascaded_decode.cu", 874)):
        kernels.append({
            "name": f"cascaded_{k}",
            "route": "cuda",
            "source": f"tpucomp_torch/csrc/{src}",
            "replaces": f"tpucomp/kernels/cascaded_pallas.py:{line}",
            "launches": launches[k],
            "max_abs_err": max(matrix_err[k], main_err[k]),
            "ms": times["mixed"][f"kernel_{k}"]["median_ms"],
            "plain_ms": times["mixed"][f"plain_{k}"]["median_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
