"""A/B times of variants of the port's LZ match-table kernel, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_table_ab.py base=tpucomp_torch/csrc new=DIR [...]

Each NAME=DIR is a directory holding ``lz_match_table.cu`` with the C
interface of ``tpucomp_torch/csrc/lz_match_table.cu``, with or without
its ``counters`` argument (a tree from before it: given null, or left
out); it is built with nvcc into its own library (headers are looked up in
DIR, then in ``tpucomp_torch/csrc``).  ``scripts/table_variants`` holds
the hash-chain design (``hash_chain``) and the radix sort that was the
whole table before rows of up to 64 KB got the grouping kernel
(``radix_lsd``).  Every variant is held to ``lz77.match_table`` on the
whole batch, then timed with CUDA events at the grid its library gives,
and also at one CTA per SM where that differs (the scratch then fits the
50 MB L2), in turns: the variants in order, then in reverse, 4 rounds of 2
calls each on the 256 MB mixed and run-heavy corpora (uint8[4096, 65536],
stride 1, LZ4 limits), 2 rounds on mixed with Snappy's limits, at strides
2 and 4, and on 4096 copies of a 64 KB row whose windows at stride 4 all
fall in one bucket of the grouping kernel's hash (``one_bucket_row``).
Then the 1 MB one-bucket row: 1 MB of distinct 4-byte words that all fall
in one bucket of the hash chain's hash, which is the grouping kernel's
too, at stride 4 (every window compared is such a word), checked the same
way and timed in 3 rounds of one call each.  Prints the card, then one
line per input, variant and grid: median, min and max ms.
"""

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import torch_lz4_cases as cases  # noqa: E402
from tpucomp_torch.codecs import lz77  # noqa: E402
from tpucomp_torch.codecs import snappy  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus  # noqa: E402

B, C = 4096, 65536
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HASH_MUL, HASH_BITS = 2654435761, 13  # the hash of scripts/table_variants/hash_chain and of the grouping kernel
COUNTED = re.compile(r"tc_lz_match_table\([^)]*counters", re.S)


def build(name, src, tmp):
    """The variant's library, and whether its entry point takes the counters."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(tmp, f"lib{name}.so")
    path = os.path.join(src, "lz_match_table.cu")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-I", src, "-I", os.path.join(ROOT, "tpucomp_torch", "csrc"), "-o", lib, path],
                   check=True)
    counted = bool(COUNTED.search(open(path).read()))
    lib = ctypes.CDLL(lib)
    lib.tc_lz_match_table_grid.argtypes = [LL, LL, ctypes.POINTER(LL)]
    lib.tc_lz_match_table.argtypes = [P, P, P, P, LL, LL, I, I, I, I] + [P] * (2 if counted else 1)
    return lib, counted


def grid_of(lib, b, c):
    """(grid, scratch bytes) the library gives for b rows of c bytes."""
    scratch = LL(0)
    grid = lib.tc_lz_match_table_grid(b, c, ctypes.byref(scratch))
    assert grid > 0, f"grid query failed: {grid}"
    return grid, scratch.value


def one_bucket_row(c):
    """c bytes of distinct little-endian words w with (w * HASH_MUL mod 2**32)
    >> (32 - HASH_BITS) == 0: every aligned window is in bucket 0."""
    inv = pow(HASH_MUL, -1, 1 << 32)
    t = np.arange(1, c // 4 + 1, dtype=np.uint64)
    return ((t * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)


def compare(libs, data, lengths, stride, label, rounds, per_round, one_cta_per_sm, limits=None):
    """Checks each variant against lz77.match_table, then times them in
    turns: ``rounds`` rounds of each variant once in order and once in
    reverse (``per_round`` 2), or once, in order and in reverse by turns
    (``per_round`` 1).  ``limits``: (max_offset, end_margin), LZ4's by
    default."""
    b, c = data.shape
    max_offset, end_margin = limits or (lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = lz77.match_table(data, lengths, stride, max_offset, end_margin)
    out = torch.empty(b, c, dtype=torch.uint16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for n, (lib, counted) in libs.items():
        grid, scratch_bytes = grid_of(lib, b, c)
        grids = [("own grid", grid)] + ([("1 CTA/SM", sms)] if one_cta_per_sm and grid > sms else [])
        scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device="cuda")
        for mode, g in grids:
            def run(lib=lib, g=g, scratch=scratch, counted=counted):
                err = lib.tc_lz_match_table(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                            b, c, stride, max_offset, end_margin, g, *([None] if counted else []),
                                            stream)
                assert err == 0, err
            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"{n} ({mode}) differs from lz77.match_table on {label}")
            runs[(n, mode, g)] = (run, [])
    keys = list(runs)
    for r in range(rounds):
        order = keys + keys[::-1] if per_round == 2 else keys[::-1] if r % 2 else keys
        for k in order:
            run, ts = runs[k]
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            run()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
    for (n, mode, g), (_, ts) in runs.items():
        print(f"{label} {n} {mode} (grid {g}): median {statistics.median(ts):.3f} ms, "
              f"min {min(ts):.3f}, max {max(ts):.3f} ({len(ts)} calls)", flush=True)


def main():
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(n, d, tmp) for n, d in variants.items()}
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        for corpus, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus)):
            data = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).cuda()
            compare(libs, data, lengths, 1, corpus, 4, 2, True)
            if corpus == "mixed":
                compare(libs, data, lengths, 1, "mixed, Snappy limits", 2, 2, False,
                        (snappy.MAX_OFFSET, snappy.MIN_MATCH))
                for stride in (2, 4):
                    compare(libs, data, lengths, stride, f"mixed, stride {stride}", 2, 2, False)
            del data
            torch.cuda.empty_cache()
        row = cases.one_bucket_row(np.random.default_rng(5), C, 4)
        data = torch.from_numpy(np.broadcast_to(row, (B, C)).copy()).cuda()
        compare(libs, data, lengths, 4, "64 KB one-bucket rows, stride 4", 2, 2, False)
        del data
        torch.cuda.empty_cache()
        row = torch.from_numpy(one_bucket_row(1 << 20)[None, :].copy()).cuda()
        compare(libs, row, torch.full((1,), 1 << 20, dtype=torch.int32, device="cuda"), 4,
                "one-bucket 1 MB row, stride 4", 3, 1, False)


if __name__ == "__main__":
    main()
