"""Check the port's LZ match-table and LZ4 / Snappy encode kernels on the CPU, under a host emulation of CUDA.

Run from the repository root (needs g++ and no card)::

    python3 scripts/cuda_emu/check_lz_encode.py [CSRC_DIR] [--seeds N]

Builds ``lz_match_table.cu``, ``lz4_encode.cu`` and ``snappy_encode.cu``
of CSRC_DIR (``tpucomp_torch/csrc`` by default) with g++ against
``include/emu.h`` (launches rewritten to the emulator's, dynamic shared
memory to its static buffer), calls their C entry points on CPU tensors
as the wrappers call them on the card, and holds the tables to
``lz77.match_table`` and the streams to the plain encoders with tolerance
0: the compress rows (strides 1, 2 and 4), the typed and edge rows, the
table rows of tests/torch_{lz4,snappy}_cases.py that stay small (window
edges and collisions at 70 KB, tiny rows, odd capacities) and N random
batches.  The emulation checks logic only (no timing, memory model or
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
from tpucomp_torch.codecs import lz4 as tl  # noqa: E402
from tpucomp_torch.codecs import lz77  # noqa: E402
from tpucomp_torch.codecs import snappy as ts  # noqa: E402
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size, snappy_max_compressed_chunk_size  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*)>>>\(")
DYNAMIC = re.compile(r"extern __shared__ __align__\(16\) uint8_t (\w+)\[\];")
LIMITS = {"lz4": (lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH), "snappy": (ts.MAX_OFFSET, ts.MIN_MATCH)}


def build(src: str, out_dir: str):
    cpp = []
    for name in ("lz_match_table", "lz4_encode", "snappy_encode"):
        with open(os.path.join(src, f"{name}.cu")) as f:
            text = DYNAMIC.sub(r"uint8_t* \1 = emu_dynamic_smem();", f.read())
        cpp.append(os.path.join(out_dir, f"{name}.cpp"))
        with open(cpp[-1], "w") as f:
            f.write(LAUNCH.sub(r"emu_launch(\1, emu_cfg(\2))(", text))
    lib = os.path.join(out_dir, "libencode_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", src, "-include", "emu.h", "-o", lib, *cpp, os.path.join(HERE, "emu.cpp")], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_lz_match_table_grid.argtypes = [LL, LL, ctypes.POINTER(LL)]
    lib.tc_lz_match_table.argtypes = [P, P, P, P, LL, LL, I, I, I, I, P]
    lib.tc_lz4_encode.argtypes = [P, P, P, P, P, LL, LL, LL, P]
    lib.tc_snappy_encode.argtypes = [P, P, P, P, P, LL, LL, LL, P]
    return lib


def table(lib, data, lengths, stride, max_offset, end_margin):
    """The table kernel's result, as kernels/lz77_cuda.py launches it."""
    b, c = data.shape
    out = torch.full((b, c), 0xABCD, dtype=torch.int32).to(torch.uint16)  # entries the kernel must all write
    if b == 0 or c == 0:
        return out
    scratch_bytes = LL(0)
    grid = lib.tc_lz_match_table_grid(b, c, ctypes.byref(scratch_bytes))
    assert grid > 0
    scratch = torch.full((scratch_bytes.value,), 0x5A, dtype=torch.uint8)
    err = lib.tc_lz_match_table(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, c,
                                stride, max_offset, end_margin, grid, None)
    assert err == 0
    return out


def encode(lib, codec, data, lengths, tbl):
    b, c = data.shape
    row = (lz4_max_compressed_chunk_size if codec == "lz4" else snappy_max_compressed_chunk_size)(c)
    out = torch.full((b, row), 0xAB, dtype=torch.uint8)  # bytes the kernel must all write
    sizes = torch.full((b,), -7, dtype=torch.int32)
    fn = lib.tc_lz4_encode if codec == "lz4" else lib.tc_snappy_encode
    assert fn(data.data_ptr(), lengths.data_ptr(), tbl.data_ptr(), out.data_ptr(), sizes.data_ptr(), b, c, row,
              None) == 0
    return out, sizes


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
            got = table(lib, data, lengths, stride, mo, em)
            want = lz77.match_table(data, lengths, stride, mo, em)
            if not torch.equal(got.to(torch.int32), want.to(torch.int32)):
                bad += 1
                where = (got.to(torch.int32) != want.to(torch.int32)).nonzero()[:4].tolist()
                print(f"MISMATCH {codec} {label} stride {stride}: table differs at {where}")
                return
            if not streams:
                return
            comp, sizes = encode(lib, codec, data, lengths, got)
            want = (tl._compress_plain(data, lengths, stride) if codec == "lz4"
                    else ts._compress_plain(data, lengths))
            for part, g, w in zip(("rows", "sizes"), (comp, sizes), want):
                if not torch.equal(g, w):
                    bad += 1
                    where = (g != w).nonzero()[:4].tolist()
                    print(f"MISMATCH {codec} {label} stride {stride}: {part} differ at {where}")
                    return

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
            for seed in range(args.seeds):
                r = np.random.default_rng(7000 + seed)
                arr, lens = cases.random_batch(r, 9000)[:2]
                check(codec, arr, lens, strides[seed % len(strides)], f"random {seed}")
            print(f"{codec}: {'all equal' if bad == n0 else f'{bad - n0} mismatches'}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
