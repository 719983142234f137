"""A/B times of variants of the port's LZ4 and Snappy decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_decode_ab.py old=DIR new=tpucomp_torch/csrc [--chunks 1056,4096]

Each DIR holds lz4_decode.cu, snappy_decode.cu and the headers they
include (a copy of ``tpucomp_torch/csrc`` at some commit).  Each variant
is built with nvcc into its own library, and its kernels' registers,
shared memory and spills are printed from ``ptxas``; every decode is held
to the input, then timed with CUDA events on the 256 MB mixed and
run-heavy batches (uint8[4096, 65536], the streams of the port's encode
kernels) and on their first 1,056 chunks (~8 chunks an SM; ``--chunks``
gives other counts), in the order
A B ... B A, 4 times each: medians with min and max.
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
from tpucomp_torch.codecs import lz4 as cl  # noqa: E402
from tpucomp_torch.codecs import snappy as cs  # noqa: E402
from tpucomp_torch.kernels import snappy_cuda as ks  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus  # noqa: E402

B, C = 4096, 65536
CHUNKS = (1056, B)
P, LL = ctypes.c_void_p, ctypes.c_longlong
KERNEL = re.compile(r"Compiling entry function '(\w+)'")


def ptxas_report(log: str) -> str:
    """Each kernel's registers, shared memory and spills, from ``ptxas -v``."""
    out, name = [], None
    for ln in log.splitlines():
        if m := KERNEL.search(ln):
            name = next((k for k in ("lz4_decode", "snappy_decode", "snappy_rewrite") if k in m.group(1)), m.group(1))
        elif name and ("spill" in ln or "registers" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return "\n  ".join(out)


def build(name, src, out_dir):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out_dir, f"libab_{name}.so")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, os.path.join(src, "lz4_decode.cu"),
                        os.path.join(src, "snappy_decode.cu")], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    print(name, "\n  " + ptxas_report(r.stderr))
    lib = ctypes.CDLL(lib)
    lib.tc_lz4_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, P]
    lib.tc_snappy_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, LL, P, P]
    return lib


def main():
    args = sys.argv[1:]
    chunks = CHUNKS
    if "--chunks" in args:
        i = args.index("--chunks")
        chunks = tuple(int(n) for n in args[i + 1].split(","))
        del args[i:i + 2]
    variants = dict(a.split("=", 1) for a in args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(n, d, tmp) for n, d in variants.items()}
        names = list(libs)
        order = names + names[::-1]
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        for corpus, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus)):
            data = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).cuda()
            for codec, kern in (("lz4", cl), ("snappy", cs)):
                comp, sizes = kern.compress(data, lengths)
                out = torch.empty(B, C, dtype=torch.uint8, device="cuda")
                ln = torch.empty(B, dtype=torch.int32, device="cuda")
                st = torch.empty(B, dtype=torch.int32, device="cuda")
                slots = max(1, min(B // 32, ks.REWRITE_SCRATCH // C))
                scratch = torch.empty(slots * C, dtype=torch.int32, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                for rows in chunks:
                    args = (comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), ln.data_ptr(), st.data_ptr(), rows,
                            comp.shape[1], C)

                    def run(n):
                        if codec == "lz4":
                            return libs[n].tc_lz4_decode(*args, None, stream)
                        return libs[n].tc_snappy_decode(*args, scratch.data_ptr(), slots, None, stream)

                    times = {n: [] for n in names}
                    for n in order:
                        out.fill_(7)
                        assert run(n) == 0
                        torch.cuda.synchronize()
                        assert torch.equal(out[:rows], data[:rows]) and not st[:rows].any(), (n, codec, corpus)
                        for _ in range(4):
                            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                            e0.record()
                            run(n)
                            e1.record()
                            e1.synchronize()
                            times[n].append(e0.elapsed_time(e1))
                    print(f"{codec} {corpus} {rows} chunks: " + ", ".join(
                        f"{n} {statistics.median(t):.3f} ms ({min(t):.3f}-{max(t):.3f})" for n, t in times.items()),
                        flush=True)
                del comp, sizes, out, scratch
            del data
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
