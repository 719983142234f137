"""A/B times of variants of the port's Cascaded encode and decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_cascaded_ab.py parent=DIR new=tpucomp_torch/csrc \\
        staged=scripts/cascaded_variants/staged_row [...]

Each NAME=DIR[+MACRO=VALUE...] is a directory holding
``cascaded_encode.cu`` and ``cascaded_decode.cu`` with the C interface of
``tpucomp_torch/csrc`` (an older tree's ``tpucomp_torch/csrc`` works: a
source includes the headers beside it first; a source DIR lacks is taken
from ``tpucomp_torch/csrc``), built with nvcc into a library of its own,
with the macros given after ``+`` defined.  A decode entry point that
takes no counter address (a tree from before its counters) is called
without one; every other is called with a null one, as untraced calls are.
``scripts/cascaded_variants/staged_row`` holds the decode that first
copies each chunked partition's compressed row into shared memory.  The
inputs are the 256 MB mixed and run-heavy corpora as uint8[4096, 65536]
(the main path) and as uint8[65536, 4096] (CascadedManager's default
chunks), all with ``CascadedOpts()``, and the int64 timestamp column as
uint8[4096, 65536] with ``CascadedOpts(type=LONGLONG)``.  On each
input every variant is first held to ``_compress_plain`` /
``_decompress_plain`` (tolerance 0) with its outputs zeroed, then again
with its outputs filled with 0xAB: a variant that passes only the first
needs its outputs zeroed (the first port's kernels, whose wrappers
zero-filled) and is reported so.  Then the kernels are timed with CUDA
events, outputs
allocated outside the timing, in turns: 8 rounds of every variant in
order and in reverse, one encode and one decode call each.  The zero-fill
of both outputs that such a wrapper needs is timed beside them.  Prints
the card and its power limit, then one line per input, variant and
kernel: median, min and max ms.
"""

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]
from tpucomp_torch.codecs import cascaded as cc  # noqa: E402
from tpucomp_torch.core.options import CascadedOpts  # noqa: E402
from tpucomp_torch.core.types import DataType, width_of  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus, timestamps64_corpus  # noqa: E402

TOTAL = 4096 * 65536
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ROUNDS = 8


def build(name, spec, tmp):
    """The variant's library: each source compiled by its own nvcc, all at once, then linked."""
    src, *defines = spec.split("+")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-I", os.path.join(ROOT, "tpucomp_torch", "csrc"), *[f"-D{d}" for d in defines]]
    objs = [os.path.join(tmp, f"{name}.{k}.o") for k in ("encode", "decode")]
    sources = [os.path.join(d, f"cascaded_{k}.cu") for k in ("encode", "decode")
               for d in (src, os.path.join(ROOT, "tpucomp_torch", "csrc"))]
    sources = [sources[0] if os.path.exists(sources[0]) else sources[1],
               sources[2] if os.path.exists(sources[2]) else sources[3]]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", obj, path]) for obj, path in zip(objs, sources)]
    if any(p.wait() for p in procs):
        sys.exit(f"{name}: nvcc failed")
    lib = os.path.join(tmp, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_cascaded_encode.argtypes = [P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I, P, P]
    with open(sources[1]) as f:
        entry = f.read().split('extern "C" int tc_cascaded_decode(', 1)[1].split(")", 1)[0]
    lib.decode_counters = "counters" in entry
    lib.tc_cascaded_decode.argtypes = [P, P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I] + [P] * (1 + lib.decode_counters)
    return lib


def kernels(lib, data, lengths, o):
    """(encode(out, sizes), decode(comp, sizes, out, nbytes, status)) of a
    library, launched as kernels/cascaded_cuda.py launches them."""
    b, c = data.shape
    w = width_of(o.type)
    args = (w, int(o.type), o.chunk_num_elements, max(1, -(-c // o.chunk_size)), o.num_rles, o.num_deltas,
            int(o.use_bp))
    stream = torch.cuda.current_stream().cuda_stream
    tail = (None, stream) if lib.decode_counters else (stream,)
    pmax = cc.partition_output_max(c, o)

    def encode(out, sizes):
        err = lib.tc_cascaded_encode(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), sizes.data_ptr(), b, c,
                                     pmax, *args, None, stream)
        assert err == 0, err

    def decode(comp, comp_sizes, out, nbytes, status):
        err = lib.tc_cascaded_decode(comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), nbytes.data_ptr(),
                                     status.data_ptr(), b, pmax, c, *args, *tail)
        assert err == 0, err

    return encode, decode


def timed(fn, *args):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn(*args)
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def compare(libs, label, data, lengths, o):
    b, c = data.shape
    pmax = cc.partition_output_max(c, o)
    want_comp, want_sizes = cc._compress_plain(data, lengths, o)
    want = cc._decompress_plain(want_comp, want_sizes, o, c)
    enc_out = (torch.empty(b, pmax, dtype=torch.uint8, device="cuda"), torch.empty(b, dtype=torch.int32, device="cuda"))
    dec_out = (torch.empty(b, c, dtype=torch.uint8, device="cuda"), torch.empty(b, dtype=torch.int32, device="cuda"),
               torch.empty(b, dtype=torch.int32, device="cuda"))
    runs = {}
    for name, lib in libs.items():
        encode, decode = kernels(lib, data, lengths, o)
        writes_all = True
        for fill in (0, 0xAB):
            for t in enc_out + dec_out:
                t.fill_(fill)
            encode(*enc_out)
            decode(want_comp, want_sizes, *dec_out)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(enc_out + dec_out, (want_comp, want_sizes) + want))
            if not same and fill == 0:
                sys.exit(f"{name} differs from the plain version on {label}")
            writes_all = same
        print(f"{label} {name}: equal to the plain version"
              + ("" if writes_all else " with zeroed outputs only (needs a zero-fill)"), flush=True)
        runs[name] = (encode, decode, [], [])
    fills = []
    keys = list(runs)
    for _ in range(ROUNDS):
        for k in keys + keys[::-1]:
            encode, decode, te, td = runs[k]
            te.append(timed(encode, *enc_out))
            td.append(timed(decode, want_comp, want_sizes, *dec_out))
        fills.append(timed(lambda: (torch.zeros(b, pmax, dtype=torch.uint8, device="cuda"),
                                    torch.zeros(b, c, dtype=torch.uint8, device="cuda"))))
    for name, (_, _, te, td) in runs.items():
        for kern, ts in (("encode", te), ("decode", td)):
            print(f"{label} {name} {kern}: median {statistics.median(ts):.3f} ms, min {min(ts):.3f}, "
                  f"max {max(ts):.3f} ({len(ts)} calls)", flush=True)
    print(f"{label} zero-fill of both outputs: median {statistics.median(fills):.3f} ms, min {min(fills):.3f}, "
          f"max {max(fills):.3f}", flush=True)


def main():
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    int32, int64 = CascadedOpts(), CascadedOpts(type=DataType.LONGLONG)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(n, spec, tmp) for n, spec in variants.items()}
        for label, gen, c, o in (("mixed 4096 x 64 KB", load_corpus, 65536, int32),
                                 ("runheavy 4096 x 64 KB", runheavy_corpus, 65536, int32),
                                 ("mixed 65536 x 4 KB", load_corpus, 4096, int32),
                                 ("runheavy 65536 x 4 KB", runheavy_corpus, 4096, int32),
                                 ("timestamps64 LONGLONG 4096 x 64 KB", timestamps64_corpus, 65536, int64)):
            data = torch.from_numpy(np.frombuffer(gen(TOTAL), np.uint8).reshape(-1, c).copy()).cuda()
            lengths = torch.full((data.shape[0],), c, dtype=torch.int32, device="cuda")
            compare(libs, label, data, lengths, o)
            del data
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
