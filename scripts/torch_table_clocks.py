"""Cycle breakdown of the port's LZ match-table kernel, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_table_clocks.py [CSRC_DIR]

Copies ``lz_match_table.cu`` and its headers (``tpucomp_torch/csrc`` by
default) into a temporary directory, inserts clock64() reads into the
grouping kernel (rows of up to 64 KB) after each of its block barriers
(thread 0 of each CTA sums the cycles between them per phase) and around
each warp task (lane 0 sums them per kind), builds it with nvcc and runs
it on the 256 MB mixed and run-heavy corpora (uint8[4096, 65536], LZ4
limits).  Prints, per job (one 64 KB row), the cycles of each phase summed
over the jobs and divided by their number: ``stage`` (the bytes into
shared memory and the counters zeroed), ``hist`` (the buckets'
histogram), ``scan`` (their starts, the lists by class), ``scatter`` (the
positions into their buckets), ``tasks`` (the warps' tasks: buckets of 33
to 1,024 positions sorted by a warp, then rounds of small buckets),
``huge`` (the buckets the CTA sorts) and ``write`` (a flag a slot, then
the table in two halves); then the warp cycles of the tasks by kind, summed over the
warps (``large`` and ``small``, per job: over 32 warps, the ``tasks``
phase's share of each), the large buckets a job and the CTA's.
The counters cost time of their own.
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
from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus  # noqa: E402

B, C = 4096, 65536
PHASES = ["stage", "hist", "scan", "scatter", "tasks", "huge", "write"]  # g_clk[0 .. 6]
LARGE, SMALL, N_LARGE, N_HUGE, JOBS = 7, 8, 9, 10, 11
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def patch(path, reps):
    s = open(path).read()
    for a, b, count in reps:
        if s.count(a) != count:
            sys.exit(f"{os.path.basename(path)}: the patch point {a[:60]!r} is not there {count} times")
        s = s.replace(a, b)
    open(path, "w").write(s)


def tick(slot, indent="    "):
    return (f"{indent}if (tid == 0) {{ const long long t1 = clock64(); "
            f"atomicAdd(&g_clk[{slot}], (unsigned long long)(t1 - ck)); ck = t1; }}\n")


def instrument(d):
    sync = "    __syncthreads();\n"
    lane_add = "      if (lane == 0) {} += clock64() - tw;\n"
    patch(f"{d}/lz_match_table.cu", [
        ("namespace tpucomp_lzg {\nnamespace {\n",
         "namespace tpucomp_lzg {\nnamespace {\n__device__ unsigned long long g_clk[12];\n", 1),
        ("  unsigned long long positions = 0, large = 0;  // this thread's share of the counters\n",
         "  unsigned long long positions = 0, large = 0;  // this thread's share of the counters\n"
         "  long long ck = 0;  // thread 0's clock at the last barrier\n"
         "  unsigned long long t_large = 0, t_small = 0;  // lane 0's cycles in the warp's tasks\n", 1),
        ("    __syncthreads();  // the previous job is done with the shared memory\n",
         "    __syncthreads();  // the previous job is done with the shared memory\n"
         f"    if (tid == 0) {{ ck = clock64(); atomicAdd(&g_clk[{JOBS}], 1ull); }}\n", 1),
        ("    if (tid < kCtl) ctl[tid] = 0;\n" + sync, "    if (tid < kCtl) ctl[tid] = 0;\n" + sync + tick(0), 1),
        (sync + "    {  // the scan:", sync + tick(1) + "    {  // the scan:", 1),
        ("make_uint4(starts[0], starts[1], starts[2], starts[3]);\n    }\n" + sync,
         "make_uint4(starts[0], starts[1], starts[2], starts[3]);\n    }\n" + sync + tick(2), 1),
        (sync + "\n    // 3. the warps' tasks", sync + tick(3) + "\n    // 3. the warps' tasks", 1),
        ("      if (t >= rounds) break;\n", "      if (t >= rounds) break;\n      const long long tw = clock64();\n", 1),
        ("        warp_sort(slot, s, m, sw, stride, lane);\n        continue;\n",
         "        warp_sort(slot, s, m, sw, stride, lane);\n"
         + lane_add.format("t_large").replace("      ", "        ", 1)
         + f"        if (lane == 0) atomicAdd(&g_clk[{N_LARGE}], 1ull);\n        continue;\n", 1),
        ("        t -= r;\n      }\n    }\n" + sync,
         "        t -= r;\n      }\n" + lane_add.format("t_small") + "    }\n" + sync + tick(4)
         + f"    if (tid == 0) atomicAdd(&g_clk[{N_HUGE}], (unsigned long long)ctl[kNHuge]);\n", 1),
        ("    // 4. a flag a slot", sync + tick(5) + "    // 4. a flag a slot", 1),
        ("out[i] = buf[i - lo];\n    }\n", "out[i] = buf[i - lo];\n    }\n" + sync + tick(6), 1),
        ("  if (p.counters) {\n",
         f"  if (lane == 0) {{ atomicAdd(&g_clk[{LARGE}], t_large); atomicAdd(&g_clk[{SMALL}], t_small); }}\n"
         "  if (p.counters) {\n", 1),
    ])
    with open(f"{d}/lz_match_table.cu", "a") as f:
        f.write('extern "C" int tc_table_clocks(void* host, int zero) {\n'
                "  if (zero) { unsigned long long z[12] = {0};\n"
                "    return (int)cudaMemcpyToSymbol(tpucomp_lzg::g_clk, z, sizeof z); }\n"
                "  return (int)cudaMemcpyFromSymbol(host, tpucomp_lzg::g_clk, 96);\n}\n")


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
        L.tc_lz_match_table.argtypes = [P, P, P, P, LL, LL, I, I, I, I, P, P]
        L.tc_table_clocks.argtypes = [P, I]
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        out = torch.empty(B, C, dtype=torch.uint16, device="cuda")
        for corpus, gen in (("mixed", load_corpus), ("runheavy", runheavy_corpus)):
            data = torch.from_numpy(np.frombuffer(gen(B * C), np.uint8).reshape(B, C).copy()).cuda()
            scratch_bytes = LL(0)
            grid = L.tc_lz_match_table_grid(B, C, ctypes.byref(scratch_bytes))
            scratch = torch.empty(max(scratch_bytes.value, 1), dtype=torch.uint8, device="cuda")
            L.tc_table_clocks(None, 1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            assert L.tc_lz_match_table(data.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, C,
                                       1, 65535, 13, grid, None, torch.cuda.current_stream().cuda_stream) == 0
            e.record()
            e.synchronize()
            host = (ctypes.c_ulonglong * 12)()
            L.tc_table_clocks(host, 0)
            jobs = host[JOBS]
            line = ", ".join(f"{n} {host[i] / jobs:.0f}" for i, n in enumerate(PHASES))
            print(f"{corpus}: {s.elapsed_time(e):.3f} ms (grid {grid}); cycles per job: {line}; "
                  f"total {sum(host[:len(PHASES)]) / jobs:.0f}; warp cycles of the tasks per job over 32 warps: "
                  f"large {host[LARGE] / jobs / 32:.0f}, small {host[SMALL] / jobs / 32:.0f}; "
                  f"{host[N_LARGE] / jobs:.1f} large and {host[N_HUGE] / jobs:.2f} huge buckets a job; "
                  f"{jobs} jobs", flush=True)


if __name__ == "__main__":
    main()
