"""Cycle breakdown of the port's LZ4 and Snappy decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_decode_clocks.py [CSRC_DIR]

Copies the kernel sources (``tpucomp_torch/csrc`` by default) into a
temporary directory, inserts clock64() counters at fixed points of the
decode kernels, builds them with nvcc and decodes the 256 MB mixed batch's
streams (uint8[4096, 65536], from the port's encode kernels) on its first
1,056 and its 4,096 chunks.  Prints, per step of one chunk's walk (an LZ4
sequence or a Snappy element), the cycles summed over the warps: ``walk``
(finding the batch's elements), ``flat`` and ``dep`` (write_batch's two
passes: literals and far matches, then near matches in order), ``fill``
(the window's refills), ``total`` (the whole kernel per warp), and the
counts ``n_dep`` (near matches), ``flat_bytes`` (bytes of the first
pass), ``n_fill`` (refills) and ``batches``.  The counters cost time of
their own, so the kernel's time here is above its time in chip_smoke.py.
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
from bench import load_corpus  # noqa: E402
from tpucomp_torch.kernels import lz4_cuda as kl  # noqa: E402
from tpucomp_torch.kernels import snappy_cuda as ks  # noqa: E402

B, C = 4096, 65536
NAMES = ["walk", "flat", "dep", "n_dep", "flat_bytes", "batches", "total", "steps", "fill", "n_fill"]


def patch(path, reps):
    s = open(path).read()
    for a, b in reps:
        if s.count(a) != 1:
            sys.exit(f"{os.path.basename(path)}: the patch point {a[:60]!r} is not there once")
        s = s.replace(a, b)
    open(path, "w").write(s)


def instrument(d):
    patch(f"{d}/lz_decode_common.cuh", [
        ("namespace tpucomp_lzd {\n",
         "namespace tpucomp_lzd {\nstatic __device__ unsigned long long g_prof[16];\n"),
        ("    __syncwarp();  // every lane is done reading the old window\n",
         "    __syncwarp();  // every lane is done reading the old window\n    const long long f0 = clock64();\n"),
        ("      }\n    }\n    __syncwarp();\n  }\n",
         "      }\n    }\n    __syncwarp();\n    if (lane == 0) { atomicAdd(&g_prof[8], (unsigned long long)"
         "(clock64() - f0)); atomicAdd(&g_prof[9], 1ull); }\n  }\n"),
        ("bool d_lit, int o_first, int o_end) {\n",
         "bool d_lit, int o_first, int o_end, long long* T) {\n  long long t0 = clock64();\n"),
        ("  __syncwarp();\n  for (unsigned dep",
         "  __syncwarp();\n  T[1] += clock64() - t0;\n  t0 = clock64();\n  T[4] += total;\n  for (unsigned dep"),
        ("    __syncwarp();\n  }\n}\n", "    __syncwarp();\n    T[3] += 1;\n  }\n  T[2] += clock64() - t0;\n}\n"),
    ])
    for name, anchor, loop_end in (
            ("lz4_decode", "    bool last = false;\n    do {\n", "    } while (k < m && !last);\n"),
            ("snappy_decode", "    int my_p = p, my_o = o, k = 0;\n    do {\n", "    } while (k < m && p < comp_len);\n")):
        patch(f"{d}/{name}.cu", [
            ("  while (!done && step < s_stop) {\n",
             "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tstart = clock64();\n"
             "  long long tw = 0;\n  while (!done && step < s_stop) {\n"),
            (anchor, anchor.replace("    do {\n", "    tw = clock64();\n    do {\n")),
            (loop_end, loop_end + "    T[0] += clock64() - tw;\n    T[5] += 1;\n"),
            ("written);\n    }\n", "written, T);\n    }\n"),
            ("  if (lane == 0) {\n    P.lengths[b]",
             "  T[6] = clock64() - tstart;\n  T[7] = step;\n"
             "  if (lane == 0) for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)T[i]);\n"
             "  if (lane == 0) {\n    P.lengths[b]"),
        ])
        with open(f"{d}/{name}.cu", "a") as f:
            f.write(f'extern "C" int tc_prof_{name}(void* host, int zero) {{\n'
                    "  if (zero) { unsigned long long z[16] = {0};\n"
                    "    return (int)cudaMemcpyToSymbol(tpucomp_lzd::g_prof, z, sizeof z); }\n"
                    "  return (int)cudaMemcpyFromSymbol(host, tpucomp_lzd::g_prof, 128);\n}\n")


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
                            "-fPIC", "-shared", "-o", lib, f"{d}/lz4_decode.cu", f"{d}/snappy_decode.cu"],
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(r.stderr[-3000:])
        L = ctypes.CDLL(lib)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.tc_lz4_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, P]
        L.tc_snappy_decode.argtypes = [P, P, P, P, P, LL, LL, LL, P, LL, P, P]
        L.tc_prof_lz4_decode.argtypes = L.tc_prof_snappy_decode.argtypes = [P, I]

        data = torch.from_numpy(np.frombuffer(load_corpus(B * C), np.uint8).reshape(B, C).copy()).cuda()
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        streams = {
            "lz4": kl.compress(data, lengths),
            "snappy": ks.compress(data, lengths),
        }
        scratch = torch.empty(C, dtype=torch.int32, device="cuda")
        for codec, prof in (("lz4", L.tc_prof_lz4_decode), ("snappy", L.tc_prof_snappy_decode)):
            comp, sizes = streams[codec]
            for n in (1056, B):
                out = torch.empty(n, C, dtype=torch.uint8, device="cuda")
                ln = torch.empty(n, dtype=torch.int32, device="cuda")
                st = torch.empty(n, dtype=torch.int32, device="cuda")
                args = (comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), ln.data_ptr(), st.data_ptr(), n,
                        comp.shape[1], C)
                prof(None, 1)
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                if codec == "lz4":
                    err = L.tc_lz4_decode(*args, None, None)
                else:
                    err = L.tc_snappy_decode(*args, scratch.data_ptr(), 1, None, None)
                e1.record()
                torch.cuda.synchronize()
                assert err == 0 and torch.equal(out, data[:n]) and not st.any(), codec
                buf = (ctypes.c_ulonglong * 16)()
                prof(buf, 0)
                v = dict(zip(NAMES, list(buf)))
                print(f"{codec} {n} chunks {e0.elapsed_time(e1):.3f} ms; per step (summed over warps): "
                      + ", ".join(f"{k} {v[k] / v['steps']:.2f}" for k in NAMES if k != "steps"), flush=True)


if __name__ == "__main__":
    main()
