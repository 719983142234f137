"""Cycle breakdown of the port's LZ match-table kernel, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_table_clocks.py [CSRC_DIR]

Copies ``lz_match_table.cu`` and its headers (``tpucomp_torch/csrc`` by
default) into a temporary directory, inserts clock64() reads after each
barrier of the kernel (thread 0 of each CTA sums the cycles between them
per phase), builds it with nvcc and runs it on the 256 MB mixed and
run-heavy corpora (uint8[4096, 65536], LZ4 limits).  Prints, per job (one
64 KB chunk), the cycles of each phase summed over the jobs and divided by
their number: ``stage`` (the bytes into shared memory), ``hist`` (the four
digit histograms and their scan), then for the four scatter passes
together ``rank`` (a tile's ranks), ``scan`` (the places per digit and
warp), ``lay`` (the tile laid out in digit order) and ``copy`` (written
out), and ``final`` (the predecessors and the table's writes).  The
counters cost time of their own.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
from bench import load_corpus, runheavy_corpus  # noqa: E402

B, C = 4096, 65536
NAMES = ["stage", "hist", "rank", "scan", "lay", "copy", "final", "jobs"]
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def patch(path, reps):
    s = open(path).read()
    for a, b, count in reps:
        if s.count(a) != count:
            sys.exit(f"{os.path.basename(path)}: the patch point {a[:60]!r} is not there {count} times")
        s = s.replace(a, b)
    open(path, "w").write(s)


def tick(slot):
    return (f"    if (tid == 0) {{ const long long t1 = clock64(); "
            f"atomicAdd(&g_clk[{slot}], (unsigned long long)(t1 - ck)); ck = t1; }}\n")


def instrument(d):
    sync = "__syncthreads();"
    patch(f"{d}/lz_match_table.cu", [
        ("namespace tpucomp_lzt {\n", "namespace tpucomp_lzt {\n__device__ unsigned long long g_clk[8];\n", 1),
        ("  for (long long job = blockIdx.x;", "  long long ck = 0;  // thread 0's clock at the last barrier\n  for (long long job = blockIdx.x;", 1),
        (f"    {sync}  // the previous job is done with the shared memory\n",
         f"    {sync}  // the previous job is done with the shared memory\n"
         "    if (tid == 0) { ck = clock64(); atomicAdd(&g_clk[7], 1ull); }\n", 1),
        (f"    {sync}\n\n    // the four digit histograms", f"    {sync}\n{tick(0)}\n    // the four digit histograms", 1),
        (f"        {sync}  // the histogram scan, or the last tile's copy-out, is done\n",
         f"        {sync}  // the histogram scan, or the last tile's copy-out, is done\n"
         "        if (tid == 0) { const long long t1 = clock64(); atomicAdd(&g_clk[pass == 0 && ck_first ? 1 : 5], "
         "(unsigned long long)(t1 - ck)); ck = t1; ck_first = false; }\n", 1),
        ("    for (int pass = 0; pass < 4; ++pass) {\n      const Idx* src",
         "    bool ck_first = true;\n    for (int pass = 0; pass < 4; ++pass) {\n      const Idx* src", 1),
    ])
    # the barriers inside a tile, in order: after the ranks, after the warp scan, after the starts, after the layout
    s = open(f"{d}/lz_match_table.cu").read()
    head, tile = s.split("        int ev[kItems], dv[kItems], rk[kItems];", 1)
    tile, rest = tile.split("    // predecessors in the sorted order", 1)
    parts = tile.split(f"        {sync}\n")
    if len(parts) != 5:
        sys.exit(f"lz_match_table.cu: {len(parts) - 1} barriers in a tile, not 4")
    slots = [2, 3, 3, 4]
    tile = "".join(p + f"        {sync}\n" + tick(slot).replace("    if", "        if")
                   for p, slot in zip(parts, slots)) + parts[-1]
    rest = rest.replace("      out[i] = (uint16_t)(dist <= p.max_offset && i <= n - p.end_margin ? dist : 0);\n    }\n",
                        "      out[i] = (uint16_t)(dist <= p.max_offset && i <= n - p.end_margin ? dist : 0);\n    }\n"
                        f"    {sync}\n{tick(6)}", 1)
    s = head + "        int ev[kItems], dv[kItems], rk[kItems];" + tile + "    // predecessors in the sorted order" + rest
    s += ('extern "C" int tc_table_clocks(void* host, int zero) {\n'
          "  if (zero) { unsigned long long z[8] = {0};\n"
          "    return (int)cudaMemcpyToSymbol(tpucomp_lzt::g_clk, z, sizeof z); }\n"
          "  return (int)cudaMemcpyFromSymbol(host, tpucomp_lzt::g_clk, 64);\n}\n")
    open(f"{d}/lz_match_table.cu", "w").write(s)


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tpucomp_torch", "csrc")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    with tempfile.TemporaryDirectory() as d:
        for f in os.listdir(src):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(src, f), d)
        instrument(d)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        lib = os.path.join(d, "libclocks.so")
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                            "-fPIC", "-shared", "-o", lib, f"{d}/lz_match_table.cu"], capture_output=True, text=True)
        if r.returncode:
            sys.exit(r.stderr[-3000:])
        L = ctypes.CDLL(lib)
        L.tc_lz_match_table_grid.argtypes = [LL, LL, ctypes.POINTER(LL)]
        L.tc_lz_match_table.argtypes = [P, P, P, P, LL, LL, I, I, I, I, P]
        L.tc_table_clocks.argtypes = [P, I]
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        out = torch.empty(B, C, dtype=torch.uint16, device="cuda")
        for corpus, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus)):
            data = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).cuda()
            scratch_bytes = LL(0)
            grid = L.tc_lz_match_table_grid(B, C, ctypes.byref(scratch_bytes))
            scratch = torch.empty(scratch_bytes.value, dtype=torch.uint8, device="cuda")
            L.tc_table_clocks(None, 1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            assert L.tc_lz_match_table(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, C,
                                       1, 65535, 13, grid, torch.cuda.current_stream().cuda_stream) == 0
            e.record()
            e.synchronize()
            host = (ctypes.c_ulonglong * 8)()
            L.tc_table_clocks(host, 0)
            jobs = host[7]
            line = ", ".join(f"{n} {host[i] / jobs:.0f}" for i, n in enumerate(NAMES[:-1]))
            print(f"{corpus}: {s.elapsed_time(e):.3f} ms (grid {grid}); cycles per job: {line}; "
                  f"total {sum(host[:7]) / jobs:.0f}; {jobs} jobs", flush=True)


if __name__ == "__main__":
    main()
