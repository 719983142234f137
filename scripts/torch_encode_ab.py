"""A/B times of variants of the port's LZ4 and Snappy encode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_encode_ab.py base=tpucomp_torch/csrc new=DIR [...]

Each NAME=DIR is a directory holding ``lz4_encode.cu``, ``snappy_encode.cu``
and the headers they include; each is built with nvcc into its own
library.  The match tables come from the package's own table kernel.  On
the 256 MB mixed and run-heavy corpora (uint8[4096, 65536]) every
variant's streams are held to the first variant's, which are held to the
plain encoder on the first 256 chunks; then each encode is timed with
CUDA events, in turns: the variants in order, then in reverse, 4 rounds.
Prints the card, then one line per corpus, codec and variant: median, min
and max ms.
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
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
from bench import load_corpus, runheavy_corpus  # noqa: E402
from tpucomp_torch.codecs import lz4 as tl  # noqa: E402
from tpucomp_torch.codecs import lz77  # noqa: E402
from tpucomp_torch.codecs import snappy as ts  # noqa: E402
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size, snappy_max_compressed_chunk_size  # noqa: E402
from tpucomp_torch.kernels import lz77_cuda  # noqa: E402

B, C = 4096, 65536
P, LL = ctypes.c_void_p, ctypes.c_longlong
CODECS = {"lz4": ((lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH), tl, lz4_max_compressed_chunk_size(C), "tc_lz4_encode"),
          "snappy": ((ts.MAX_OFFSET, ts.MIN_MATCH), ts, snappy_max_compressed_chunk_size(C), "tc_snappy_encode")}


def build(name, src, tmp):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(tmp, f"lib{name}.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-o", lib, os.path.join(src, "lz4_encode.cu"), os.path.join(src, "snappy_encode.cu")],
                   check=True)
    lib = ctypes.CDLL(lib)
    for _, _, _, fn in CODECS.values():
        getattr(lib, fn).argtypes = [P, P, P, P, P, LL, LL, LL, P]
    return lib


def main():
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(n, d, tmp) for n, d in variants.items()}
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for corpus, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus)):
            data = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).cuda()
            for codec, (limits, plain, row, fn) in CODECS.items():
                table = lz77_cuda.match_table(data, lengths, 1, *limits)
                outs = {n: (torch.empty(B, row, dtype=torch.uint8, device="cuda"),
                            torch.empty(B, dtype=torch.int32, device="cuda")) for n in libs}
                runs = {}
                for n, lib in libs.items():
                    out, sizes = outs[n]

                    def run(f=getattr(lib, fn), out=out, sizes=sizes):
                        err = f(data.data_ptr(), lengths.data_ptr(), table.data_ptr(), out.data_ptr(),
                                sizes.data_ptr(), B, C, row, stream)
                        assert err == 0, err
                    run()
                    runs[n] = (run, [])
                torch.cuda.synchronize()
                first = next(iter(libs))
                want = plain._compress_plain(data[:256], lengths[:256])
                if not (torch.equal(outs[first][0][:256], want[0]) and torch.equal(outs[first][1][:256], want[1])):
                    sys.exit(f"{codec} {first} differs from the plain encoder on {corpus}")
                for n in libs:
                    if not all(torch.equal(a, b) for a, b in zip(outs[n], outs[first])):
                        sys.exit(f"{codec} {n} differs from {first} on {corpus}")
                keys = list(runs)
                for _ in range(4):
                    for k in keys + keys[::-1]:
                        run, times = runs[k]
                        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        s.record()
                        run()
                        e.record()
                        e.synchronize()
                        times.append(s.elapsed_time(e))
                for n, (_, times) in runs.items():
                    print(f"{corpus} {codec} {n}: median {statistics.median(times):.3f} ms, min {min(times):.3f}, "
                          f"max {max(times):.3f} ({len(times)} calls)", flush=True)
                del table, outs, runs
            del data


if __name__ == "__main__":
    main()
