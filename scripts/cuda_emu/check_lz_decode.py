"""Check the port's LZ4 and Snappy decode kernels on the CPU, under a host emulation of CUDA.

Run from the repository root (needs g++ and no card)::

    python3 scripts/cuda_emu/check_lz_decode.py [CSRC_DIR] [--seeds N]

Builds ``lz4_decode.cu`` and ``snappy_decode.cu`` of CSRC_DIR
(``tpucomp_torch/csrc`` by default) with g++ against ``include/emu.h``
(each ``kernel<<<grid, block, ...>>>(args)`` launch is rewritten to the
emulator's), calls their C entry points on CPU tensors as the wrappers
call them on the card, and holds data, lengths and statuses to the plain
versions with tolerance 0: the crafted, golden, foreign and window cases
of tests/torch_{lz4,snappy}_cases.py, garbage batches, a 1 MB Snappy row
rewritten by start, and N random batches with damaged copies.  The
emulation checks logic only (no timing, memory model or nvcc); the
``cuda`` tests on the card stay the judge.  Prints one line per codec and
every mismatch; exits 1 on any.
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
from oracles.lz4_oracle import lz4_compress_oracle  # noqa: E402
from tpucomp_torch.codecs import lz4 as tl  # noqa: E402
from tpucomp_torch.codecs import snappy as ts  # noqa: E402
from tpucomp_torch.kernels import snappy_cuda as ks  # noqa: E402

P, LL = ctypes.c_void_p, ctypes.c_longlong
LAUNCH = re.compile(r"(\w+)<<<(.*)>>>\(")


def build(src: str, out_dir: str):
    cpp = []
    for name in ("lz4_decode", "snappy_decode"):
        with open(os.path.join(src, f"{name}.cu")) as f:
            text = LAUNCH.sub(r"emu_launch(\1, emu_cfg(\2))(", f.read())
        cpp.append(os.path.join(out_dir, f"{name}.cpp"))
        with open(cpp[-1], "w") as f:
            f.write(text)
    lib = os.path.join(out_dir, "libdecode_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", src, "-include", "emu.h", "-o", lib, *cpp, os.path.join(HERE, "emu.cpp")], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_lz4_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P]
    lib.tc_snappy_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, LL, P]
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", nargs="?", default=os.path.join(ROOT, "tpucomp_torch", "csrc"))
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.csrc, tmp)
        bad = 0

        def check(codec, comp, sizes, cap, label):
            nonlocal bad
            comp = torch.as_tensor(np.ascontiguousarray(comp))
            sizes = torch.as_tensor(np.asarray(sizes, np.int32)).contiguous()
            b, cmax = comp.shape
            out = torch.full((b, cap), 0xAB, dtype=torch.uint8)  # bytes the kernels must all write
            ln = torch.full((b,), -7, dtype=torch.int32)
            st = torch.full((b,), -7, dtype=torch.int32)
            ptrs = (comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), ln.data_ptr(), st.data_ptr(), b, cmax, cap)
            if codec == "lz4":
                err = lib.tc_lz4_decode(*ptrs, None)
                want = tl._decompress_plain(comp, sizes, cap)
            else:
                slots = max(1, min(-(-b // 32), ks.REWRITE_SCRATCH // cap))
                scratch = torch.full((slots * cap,), 0x55, dtype=torch.int32)
                err = lib.tc_snappy_decode(*ptrs, scratch.data_ptr(), slots, None)
                want = ts._decompress_plain(comp, sizes, cap)
            for part, g, w in zip(("data", "lengths", "status"), (out, ln, st), want):
                if err or not torch.equal(g, w):
                    bad += 1
                    where = (g != w).nonzero()[:4].tolist()
                    print(f"MISMATCH {codec} {label}: {part} differs at {where} (launch error {err})")
                    return

        for codec, cases, plain in (("snappy", sc, ts), ("lz4", lc, tl)):
            n0 = bad
            if codec == "snappy":
                for labels, comp, sizes in sc.crafted_streams():
                    check(codec, comp, sizes, sc.CRAFTED_CAP, "crafted " + ",".join(labels))
                check(codec, *sc.long_back_row(), "1 MB row rewritten by start")
                _, comp, sizes, outs = sc.golden_streams()
                check(codec, comp, sizes, max(map(len, outs)), "golden")
                _, comp, sizes, _ = sc.foreign_streams(np.random.default_rng(4))
                check(codec, comp, sizes, 4096, "foreign")
                window = sc.window_cases(np.random.default_rng(7))
            else:
                check(codec, *lc.s_max_overrun(), "s_max overrun")
                window = lc.window_cases(lc.window_rows(np.random.default_rng(7)), lz4_compress_oracle)
            for label, comp, sizes, cap in window:
                check(codec, comp, sizes, cap, label)
            for seed in range(3):
                comp, sizes = cases.garbage_batch(np.random.default_rng(100 + seed), 16, cases.C + 600)
                check(codec, comp, sizes, cases.C, f"garbage {seed}")
            for seed in range(args.seeds):
                rng = np.random.default_rng(5000 + seed)
                arr, lens = cases.random_batch(rng, 6000)[:2]
                comp, sizes = plain.compress(torch.from_numpy(arr), torch.from_numpy(lens))
                c = arr.shape[1]
                check(codec, comp, sizes, c, f"random {seed}")
                dmg, dmg_sizes = cases.damage(rng, comp.numpy(), sizes.numpy())
                for cap in (c, int(rng.integers(1, c + 64))):
                    check(codec, dmg, dmg_sizes, cap, f"random {seed} damaged, capacity {cap}")
            print(f"{codec}: {'all equal' if bad == n0 else f'{bad - n0} mismatches'}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
