"""Check the port's LZ match-table and LZ4 / Snappy encode kernels on the CPU, under a host emulation of CUDA.

Run from the repository root (needs g++ and no card)::

    python3 scripts/cuda_emu/check_lz_encode.py [CSRC_DIR] [--seeds N]

Builds ``lz_match_table.cu``, ``lz4_encode.cu`` and ``snappy_encode.cu``
of CSRC_DIR (``tpucomp_torch/csrc`` by default) with g++ against
``include/emu.h`` (launches rewritten to the emulator's, dynamic shared
memory to its static buffer; the headers of CSRC_DIR rewritten alike),
calls their C entry points on CPU tensors as the wrappers call them on
the card, and holds the tables to ``lz77.match_table`` and the streams to
the plain encoders with tolerance 0, the encoders' sequence counters
(``utils/profiling.py``) to the sequences the streams hold
(``lz_streams.py``), and the table's two counters to
``torch_lz4_cases.group_counts``: the compress rows (strides 1, 2 and 4),
the typed and edge rows, the table rows of
tests/torch_{lz4,snappy}_cases.py that stay small (window edges and
collisions at 70 KB, tiny rows, odd capacities), the grouping path's rows
(``group_rows``: one bucket, a frequent window in its bucket, zeros,
distinct windows, both sides of 64 KB; tables only, at strides 1, 2 and
4 with LZ4's limits and 1 with Snappy's) and N random batches.  The emulation checks logic only (no timing, memory model or
nvcc); the ``cuda`` tests on the card stay the judge.  Prints one line per
codec and every mismatch; exits 1 on any.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import torch_lz4_cases as lc  # noqa: E402
import torch_snappy_cases as sc  # noqa: E402
from lz_streams import stream_counts  # noqa: E402
from tpucomp_torch.codecs import lz4 as tl  # noqa: E402
from tpucomp_torch.codecs import lz77  # noqa: E402
from tpucomp_torch.codecs import snappy as ts  # noqa: E402
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size, snappy_max_compressed_chunk_size  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*)>>>\(")
DYNAMIC = re.compile(r"extern __shared__ __align__\(16\) uint8_t (\w+)\[\];")
LIMITS = {"lz4": (lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH), "snappy": (ts.MAX_OFFSET, ts.MIN_MATCH)}


def emulated(text: str) -> str:
    """CUDA source with its launches and dynamic shared memory rewritten to the emulator's."""
    return LAUNCH.sub(r"emu_launch(\1, emu_cfg(\2))(", DYNAMIC.sub(r"uint8_t* \1 = emu_dynamic_smem();", text))


def build(src: str, out_dir: str):
    for name in os.listdir(src):
        if name.endswith(".cuh"):
            with open(os.path.join(src, name)) as f, open(os.path.join(out_dir, name), "w") as g:
                g.write(emulated(f.read()))
    cpp = []
    for name in ("lz_match_table", "lz4_encode", "snappy_encode"):
        cpp.append(os.path.join(out_dir, f"{name}.cpp"))
        with open(os.path.join(src, f"{name}.cu")) as f, open(cpp[-1], "w") as g:
            g.write(emulated(f.read()))
    lib = os.path.join(out_dir, "libencode_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", out_dir, "-include", "emu.h", "-o", lib, *cpp, os.path.join(HERE, "emu.cpp")], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_lz_match_table_grid.argtypes = [LL, LL, ctypes.POINTER(LL)]
    lib.tc_lz_match_table.argtypes = [P, P, P, P, LL, LL, I, I, I, I, P, P]
    lib.tc_lz4_encode.argtypes = [P, P, P, P, P, LL, LL, LL, P, P]
    lib.tc_snappy_encode.argtypes = [P, P, P, P, P, LL, LL, LL, P, P]
    return lib


def table(lib, data, lengths, stride, max_offset, end_margin):
    """(the table kernel's result, as kernels/lz77_cuda.py launches it, and its two counters)."""
    b, c = data.shape
    out = torch.full((b, c), 0xABCD, dtype=torch.int32).to(torch.uint16)  # entries the kernel must all write
    counters = torch.zeros(2, dtype=torch.int64)
    if b == 0 or c == 0:
        return out, (0, 0)
    scratch_bytes = LL(0)
    grid = lib.tc_lz_match_table_grid(b, c, ctypes.byref(scratch_bytes))
    assert grid > 0
    scratch = torch.full((scratch_bytes.value,), 0x5A, dtype=torch.uint8)
    err = lib.tc_lz_match_table(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, c,
                                stride, max_offset, end_margin, grid, counters.data_ptr(), None)
    assert err == 0
    return out, tuple(counters.tolist())


def encode(lib, codec, data, lengths, tbl):
    """(rows, sizes, the sequence counter)."""
    b, c = data.shape
    row = (lz4_max_compressed_chunk_size if codec == "lz4" else snappy_max_compressed_chunk_size)(c)
    out = torch.full((b, row), 0xAB, dtype=torch.uint8)  # bytes the kernel must all write
    sizes = torch.full((b,), -7, dtype=torch.int32)
    counter = torch.zeros(1, dtype=torch.int64)
    fn = lib.tc_lz4_encode if codec == "lz4" else lib.tc_snappy_encode
    assert fn(data.data_ptr(), lengths.data_ptr(), tbl.data_ptr(), out.data_ptr(), sizes.data_ptr(), b, c, row,
              counter.data_ptr(), None) == 0
    return out, sizes, int(counter)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", nargs="?", default=os.path.join(ROOT, "tpucomp_torch", "csrc"))
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.csrc, tmp)
        bad = 0

        def check(codec, arr, lens, stride, label, streams=True):
            nonlocal bad
            data = torch.from_numpy(np.ascontiguousarray(arr))
            lengths = torch.from_numpy(np.asarray(lens, np.int32)).contiguous()
            mo, em = LIMITS[codec]
            got, counted = table(lib, data, lengths, stride, mo, em)
            want = lz77.match_table(data, lengths, stride, mo, em)
            if not torch.equal(got.to(torch.int32), want.to(torch.int32)):
                bad += 1
                where = (got.to(torch.int32) != want.to(torch.int32)).nonzero()[:4].tolist()
                print(f"MISMATCH {codec} {label} stride {stride}: table differs at {where}")
                return
            held = lc.group_counts(np.asarray(arr), np.asarray(lens), stride)
            if counted != held:
                bad += 1
                print(f"MISMATCH {codec} {label} stride {stride}: the table counted {counted}, "
                      f"the rows hold {held}")
                return
            if not streams:
                return
            comp, sizes, sequences = encode(lib, codec, data, lengths, got)
            want = (tl._compress_plain(data, lengths, stride) if codec == "lz4"
                    else ts._compress_plain(data, lengths))
            for part, g, w in zip(("rows", "sizes"), (comp, sizes), want):
                if not torch.equal(g, w):
                    bad += 1
                    where = (g != w).nonzero()[:4].tolist()
                    print(f"MISMATCH {codec} {label} stride {stride}: {part} differ at {where}")
                    return
            held = stream_counts(codec, comp, sizes, data.shape[1])[1]
            if sequences != held:
                bad += 1
                print(f"MISMATCH {codec} {label} stride {stride}: counted {sequences} sequences, "
                      f"the streams hold {held}")

        for codec, cases in (("lz4", lc), ("snappy", sc)):
            n0 = bad
            rng = np.random.default_rng(11)
            _, rows, rows_len = cases.compress_rows(rng)
            strides = (1, 2, 4) if codec == "lz4" else (1,)
            for s in strides:
                check(codec, rows, rows_len, s, "compress rows")
            if codec == "lz4":
                arr, lens = lc.typed_rows(rng)
                for s in (2, 4):
                    check(codec, arr, lens, s, "typed rows")
            for label, arr, lens in cases.table_rows(rng):
                if arr.shape[1] <= 1 << 17:
                    check(codec, arr, lens, 1, label, streams=arr.shape[1] < 1 << 17)
            for label, arr, lens in lc.group_rows(np.random.default_rng(23)):
                for s in strides if codec == "lz4" else (1,):
                    check(codec, arr, lens, s, label, streams=False)
            for seed in range(args.seeds):
                r = np.random.default_rng(7000 + seed)
                arr, lens = cases.random_batch(r, 9000)[:2]
                check(codec, arr, lens, strides[seed % len(strides)], f"random {seed}")
            print(f"{codec}: {'all equal' if bad == n0 else f'{bad - n0} mismatches'}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
