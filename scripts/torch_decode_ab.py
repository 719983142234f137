"""A/B times of variants of the port's LZ4 and Snappy decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_decode_ab.py old=DIR new=tpucomp_torch/csrc

Each DIR holds lz4_decode.cu, snappy_decode.cu and the headers they
include (a copy of ``tpucomp_torch/csrc`` at some commit).  Each variant
is built with nvcc into its own library; every decode is held to the
input, then timed with CUDA events on the 256 MB mixed and run-heavy
batches (uint8[4096, 65536], the streams of the port's encode kernels),
in the order A B ... B A, 4 times each: medians with min and max.
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
from tpucomp_torch.kernels import lz4_cuda as kl  # noqa: E402
from tpucomp_torch.kernels import snappy_cuda as ks  # noqa: E402

B, C = 4096, 65536
P, LL = ctypes.c_void_p, ctypes.c_longlong


def build(name, src, out_dir):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out_dir, f"libab_{name}.so")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, os.path.join(src, "lz4_decode.cu"),
                        os.path.join(src, "snappy_decode.cu")], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    print(name, " | ".join(ln.strip() for ln in r.stderr.splitlines() if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(lib)
    lib.tc_lz4_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, P]
    lib.tc_snappy_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, LL, P, P]
    return lib


def main():
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
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
            for codec, kern in (("lz4", kl), ("snappy", ks)):
                comp, sizes = kern.compress(data, lengths)
                out = torch.empty(B, C, dtype=torch.uint8, device="cuda")
                ln = torch.empty(B, dtype=torch.int32, device="cuda")
                st = torch.empty(B, dtype=torch.int32, device="cuda")
                slots = max(1, min(B // 32, ks.REWRITE_SCRATCH // C))
                scratch = torch.empty(slots * C, dtype=torch.int32, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                args = (comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), ln.data_ptr(), st.data_ptr(), B,
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
                    assert torch.equal(out, data) and not st.any(), (n, codec, corpus)
                    for _ in range(4):
                        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        e0.record()
                        run(n)
                        e1.record()
                        e1.synchronize()
                        times[n].append(e0.elapsed_time(e1))
                print(f"{codec} {corpus}: " + ", ".join(
                    f"{n} {statistics.median(t):.3f} ms ({min(t):.3f}-{max(t):.3f})" for n, t in times.items()),
                    flush=True)
                del comp, sizes, out, scratch
            del data
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
