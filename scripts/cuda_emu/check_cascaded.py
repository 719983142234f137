"""Check the port's Cascaded encode and decode kernels on the CPU, under a host emulation of CUDA.

Run from the repository root (needs g++ and no card)::

    python3 scripts/cuda_emu/check_cascaded.py [CSRC_DIR] [--fuzz N] [-D NAME=VALUE ...]

Builds ``cascaded_encode.cu`` and ``cascaded_decode.cu`` of CSRC_DIR
(``tpucomp_torch/csrc`` by default) with g++ against ``include/emu.h``
(launches rewritten to the emulator's, dynamic shared memory to its
static buffer) three times, once for each way the kernels spread a batch
over teams: as shipped, with one team per CTA (``-D
TC_CASCADED_SMEM_BUDGET=1``: each chunk of a partition in a round of its
own) and with the encoder writing every chunk in place (``-D
TC_CASCADED_SMEM_MAX=1``); ``-D`` given on the command line builds that
one set of macros alone.  Each build's C entry points are called on CPU tensors as
``kernels/cascaded_cuda.py`` calls them on the card, into outputs
pre-filled with a marker byte (every byte must be written), and holds
rows, sizes, data, byte counts and statuses to ``_compress_plain`` /
``_decompress_plain`` with tolerance 0, and the kernels' counters
(``utils/profiling.py``) to the rows the encoder wrote (raw partitions by
their headers, chunks run outside them by their lengths; the decoder's on
the rows as written): the kernel cases of
tests/torch_cases.py that stay small (the test matrix, the rest of the
option space, N random option sets and shapes, and the 8-byte profiles
of ``w8_cases``; not the two 16 MB partitions), each decoded as written,
with mismatched options, into an undersized output and damaged; the
corrupt streams; and batches of 4 KB partitions (CascadedManager's
default shape, INT and LONGLONG).  Every element width, 8 included, goes
through all three builds.  The emulation checks logic
only (no timing, memory model or nvcc); the ``cuda`` tests on the card stay
the judge.  Prints one line per group and every mismatch; exits 1 on any.
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
import torch_cases  # noqa: E402
from tpucomp_torch.codecs import cascaded as cc  # noqa: E402
from tpucomp_torch.core.options import opts_from_fields  # noqa: E402
from tpucomp_torch.core.types import width_of  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LAUNCH = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<(.*)>>>\(")
DYNAMIC = re.compile(r"extern __shared__ __align__\(16\) uint32_t (\w+)\[\];")
MARK = 0xAB  # bytes the kernels must all overwrite


def build(src: str, out_dir: str, defines=()):
    cpp = []
    for name in ("cascaded_encode", "cascaded_decode"):
        with open(os.path.join(src, f"{name}.cu")) as f:
            text = DYNAMIC.sub(r"uint32_t* \1 = reinterpret_cast<uint32_t*>(emu_dynamic_smem());", f.read())
        cpp.append(os.path.join(out_dir, f"{name}.cpp"))
        with open(cpp[-1], "w") as f:
            f.write(LAUNCH.sub(r"emu_launch(\1, emu_cfg(\2))(", text))
    lib = os.path.join(out_dir, "libcascaded_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", src, "-include", "emu.h", *[f"-D{d}" for d in defines], "-o", lib, *cpp,
                    os.path.join(HERE, "emu.cpp")], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_cascaded_encode.argtypes = [P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I, P, P]
    lib.tc_cascaded_decode.argtypes = [P, P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I, P, P]
    return lib


def encode(lib, data, lengths, o, counters=None):
    """The encode kernel's (rows, sizes), as kernels/cascaded_cuda.py launches
    it; ``counters`` (int64[3]) takes its chunks, chunks discarded and raw
    partitions."""
    b, c = data.shape
    pmax = cc.partition_output_max(c, o)
    out = torch.full((b, pmax), MARK, dtype=torch.uint8)
    sizes = torch.full((b,), -7, dtype=torch.int32)
    err = lib.tc_cascaded_encode(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), sizes.data_ptr(), b, c,
                                 pmax, width_of(o.type), int(o.type), o.chunk_num_elements,
                                 max(1, -(-c // o.chunk_size)), o.num_rles, o.num_deltas, int(o.use_bp),
                                 None if counters is None else counters.data_ptr(), None)
    assert err == 0
    return out, sizes


def _rows_counted(comp, lengths, c, o):
    """(raw, chunks kept) of the encoder's rows (of ``c`` input bytes): raw
    partitions are the non-empty ones whose header has zero layer bytes;
    the others keep all their chunks (at most k a partition)."""
    n_elems = lengths.to(torch.int64).clamp(min=0) // width_of(o.type)
    layers = comp[:, 0].to(torch.int64) | comp[:, 1].to(torch.int64) << 8 | comp[:, 2].to(torch.int64) << 16
    raw = (lengths > 0) & (layers == 0)
    k = max(1, -(-c // o.chunk_size))
    return raw, int(torch.where(raw, 0, (-(-n_elems // o.chunk_num_elements)).clamp(max=k)).sum())


def counts_wrong(comp, lengths, c, o, counters) -> str:
    """What differs between the encoder's counters and its rows."""
    raw, kept = _rows_counted(comp, lengths, c, o)
    chunks, discarded, partitions_raw = counters.tolist()
    want = (kept + discarded, int(raw.sum()))
    if (chunks, partitions_raw) != want or discarded > chunks:
        return f"counters {counters.tolist()}, rows give chunks - discarded {kept}, raw {want[1]}"
    return ""


def decode_counts_wrong(comp, lengths, c, o, counters) -> str:
    """What differs between the decoder's counters, on the rows as the
    encoder wrote them, and those rows: every kept chunk decoded, every raw
    partition with an element copied."""
    raw, kept = _rows_counted(comp, lengths, c, o)
    want = [kept, int((raw & (lengths.to(torch.int64) >= width_of(o.type))).sum())]
    return "" if counters.tolist() == want else f"decode counters {counters.tolist()}, rows give {want}"


def decode(lib, comp, sizes, o, cap, counters=None):
    """The decode kernel's (data, byte counts, statuses); ``counters``
    (int64[2]) takes its chunks run and raw partitions."""
    b, cmax = comp.shape
    out = torch.full((b, cap), MARK, dtype=torch.uint8)
    nbytes = torch.full((b,), -7, dtype=torch.int32)
    status = torch.full((b,), -7, dtype=torch.int32)
    err = lib.tc_cascaded_decode(comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), nbytes.data_ptr(),
                                 status.data_ptr(), b, cmax, cap, width_of(o.type), int(o.type),
                                 o.chunk_num_elements, max(1, -(-cap // o.chunk_size)), o.num_rles,
                                 o.num_deltas, int(o.use_bp), None if counters is None else counters.data_ptr(),
                                 None)
    assert err == 0
    return out, nbytes, status


def manager_cases(rng):
    """Batches of 4 KB partitions, one chunk each at the default options
    and at LONGLONG's (CascadedManager's shape): run-heavy, random and
    mixed rows, the last ragged."""
    raw = b"".join(torch_cases.profile_bytes(rng, p, 4096 * 8, 4) for p in ("runs", "random", "ramp"))
    arr, lens = torch_cases.batch(raw, 24, 4096)
    lens[-1] -= 1001
    return [("4 KB partitions", torch_cases.DEFAULT, arr, lens),
            ("4 KB partitions LONGLONG", torch_cases.opts(type=torch_cases.LONGLONG), arr, lens)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", nargs="?", default=os.path.join(ROOT, "tpucomp_torch", "csrc"))
    ap.add_argument("--fuzz", type=int, default=24)
    ap.add_argument("-D", dest="defines", action="append", default=[])
    args = ap.parse_args()
    plans = [args.defines] if args.defines else [[], ["TC_CASCADED_SMEM_BUDGET=1"], ["TC_CASCADED_SMEM_MAX=1"]]
    bad = 0
    for defines in plans:
        print(f"build {' '.join(f'-D{d}' for d in defines) or 'as shipped'}:", flush=True)
        bad += check(args, defines)
    sys.exit(1 if bad else 0)


def check(args, defines) -> int:
    """Every group of cases through one build; returns the mismatches."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.csrc, tmp, defines)
        bad = 0

        def same(label, got, want):
            nonlocal bad
            for i, (g, w) in enumerate(zip(got, want)):
                if g.shape != w.shape or not torch.equal(g, w):
                    bad += 1
                    where = (g != w).nonzero()[:4].tolist() if g.shape == w.shape else "shape"
                    print(f"MISMATCH {label}: output {i} differs at {where}", flush=True)
                    return False
            return True

        def decode_both(label, comp, sizes, o, cap):
            same(f"{label} decode", decode(lib, comp, sizes, o, cap), cc._decompress_plain(comp, sizes, o, cap))

        rng = np.random.default_rng(0)
        groups = [("matrix", torch_cases.compress_cases()), ("wide", torch_cases.wide_cases()),
                  ("fuzz", torch_cases.fuzz_cases(0, args.fuzz)), ("w8", torch_cases.w8_cases()),
                  ("manager", manager_cases(rng))]
        for group, cases in groups:
            n0 = bad
            for label, fields, arr, lens in cases:
                o = opts_from_fields(fields)
                w = torch_cases.WIDTH[fields["type"]]
                d, ln = torch.from_numpy(arr), torch.from_numpy(lens)
                counters = torch.zeros(3, dtype=torch.int64)
                comp, sizes = encode(lib, d, ln, o, counters)
                if not same(f"{label} encode", (comp, sizes), cc._compress_plain(d, ln, o)):
                    continue
                wrong = counts_wrong(comp, ln, arr.shape[1], o, counters)
                if wrong:
                    bad += 1
                    print(f"MISMATCH {label} encode: {wrong}", flush=True)
                cap = arr.shape[1] - arr.shape[1] % w
                counters = torch.zeros(2, dtype=torch.int64)
                if same(f"{label} decode", decode(lib, comp, sizes, o, cap, counters),
                        cc._decompress_plain(comp, sizes, o, cap)):
                    wrong = decode_counts_wrong(comp, ln, arr.shape[1], o, counters)
                    if wrong:
                        bad += 1
                        print(f"MISMATCH {label} decode: {wrong}", flush=True)
                decode_both(f"{label} other-opts", comp, sizes,
                            opts_from_fields({**fields, "num_rles": (fields["num_rles"] + 1) % 3,
                                              "num_deltas": 0}), cap)
                decode_both(f"{label} undersized", comp, sizes, o, max(w, cap // 4 // w * w))
                rows, szs = torch_cases.damage(rng, comp.numpy(), sizes.numpy())
                decode_both(f"{label} damaged", torch.from_numpy(rows), torch.from_numpy(szs), o, cap)
            print(f"  {group}: {len(cases)} inputs, {'all equal' if bad == n0 else f'{bad - n0} mismatches'}",
                  flush=True)

        n0 = bad
        src, src_lens = torch_cases.corrupt_source()
        o = opts_from_fields(torch_cases.DEFAULT)
        comp, sizes = encode(lib, torch.from_numpy(src), torch.from_numpy(src_lens), o)
        labels, rows, szs = torch_cases.corrupt_cases(comp.numpy(), sizes.numpy())
        for fields in (torch_cases.DEFAULT, torch_cases.opts(num_rles=1)):
            decode_both("corrupt " + ",".join(labels), torch.from_numpy(rows), torch.from_numpy(szs),
                        opts_from_fields(fields), src.shape[1])
        print(f"  corrupt: {len(labels)} streams, {'all equal' if bad == n0 else f'{bad - n0} mismatches'}",
              flush=True)
    return bad


if __name__ == "__main__":
    main()
