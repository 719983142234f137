"""Cycle breakdown of the port's LZ4 and Snappy decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_decode_clocks.py [CSRC_DIR] [--dump FILE.json]

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
pass), ``n_fill`` (refills) and ``batches``.  An LZ4 kernel whose idle
warps take over the copies of chunks still running (``lz4_handoff.cuh``)
gives ``walk``, ``fill``, ``wait_w`` (the chunk's own warp waiting on its
helper: a full ring, or the drain before a refill) and ``total_w`` (its
own warp's cycles), ``flat`` and ``dep`` of both warps, and the helpers'
``wait_c`` (waits for a batch) and ``total_c``.

Then the tail: each warp's cycles from its start to its end, as median,
90th percentile and maximum over the warps of a role, the sequences of the
warp with the most cycles, and the span of that warp against the kernel's
(``%globaltimer``, ns): where the two are close, the kernel lasts as long
as its heaviest chunk.  ``--dump`` writes each chunk's steps, cycles and
stream size to a JSON file.  The counters cost time of their own, so the
kernel's time here is above its time in the benchmark.
"""

import ctypes
import json
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
from tpucomp_torch.codecs import lz4 as cl  # noqa: E402
from tpucomp_torch.codecs import snappy as cs  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus  # noqa: E402

B, C = 4096, 65536
NAMES = ["walk", "flat", "dep", "n_dep", "flat_bytes", "batches", "total", "steps", "fill", "n_fill"]
SPLIT_NAMES = ["walk", "flat", "dep", "n_dep", "flat_bytes", "batches", "total_w", "steps", "fill", "n_fill",
               "wait_w", "wait_c", "total_c"]  # the kernel that hands copies to helpers


def patch(path, reps):
    s = open(path).read()
    for a, b in reps:
        if s.count(a) != 1:
            sys.exit(f"{os.path.basename(path)}: the patch point {a[:60]!r} is not there once")
        s = s.replace(a, b)
    open(path, "w").write(s)


# one warp's record: cycles from its start to its end, steps, %globaltimer at its start and end
RECORD = ("  if (lane == 0) {{ g_warps[2 * b + {role}][0] = clock64() - tstart; g_warps[2 * b + {role}][1] = step;\n"
          "    g_warps[2 * b + {role}][2] = g0; g_warps[2 * b + {role}][3] = gtimer(); }}\n")


def instrument(d):
    """Inserts the counters; returns whether the LZ4 kernel is the split one."""
    patch(f"{d}/lz_decode_common.cuh", [
        ("namespace tpucomp_lzd {\n",
         "namespace tpucomp_lzd {\nstatic __device__ unsigned long long g_prof[16];\n"
         "static __device__ long long g_warps[2 * 4096][4];\n"
         "__device__ __forceinline__ long long gtimer() {\n"
         "  long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
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
    split = "Handoff" in open(f"{d}/lz4_decode.cu").read()
    one_warp = [("snappy_decode", "    int my_p = p, my_o = o, k = 0;\n    do {\n", "    } while (k < m && p < comp_len);\n")]
    if not split:
        one_warp.append(("lz4_decode", "    bool last = false;\n    do {\n", "    } while (k < m && !last);\n"))
    for name, anchor, loop_end in one_warp:
        record = RECORD.format(role=0) if name == "lz4_decode" else ""
        patch(f"{d}/{name}.cu", [
            ("  while (!done && step < s_stop) {\n",
             "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tstart = clock64(), g0 = gtimer();\n"
             "  long long tw = 0;\n  while (!done && step < s_stop) {\n"),
            (anchor, anchor.replace("    do {\n", "    tw = clock64();\n    do {\n")),
            (loop_end, loop_end + "    T[0] += clock64() - tw;\n    T[5] += 1;\n"),
            ("written);\n    }\n", "written, T);\n    }\n"),
            ("  if (lane == 0) {\n    P.lengths[b]",
             "  T[6] = clock64() - tstart;\n  T[7] = step;\n"
             "  if (lane == 0) for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)T[i]);\n"
             + record + "  if (lane == 0) {\n    P.lengths[b]"),
        ])
    if split:
        patch(f"{d}/lz4_handoff.cuh", [
            ("  int sent, waits;", "  int sent, waits;\n  long long wc = 0;"),
            ("{ mbar_wait(&empty[n % kSlots], (n / kSlots) & 1); }",
             "{\n    const long long t0 = clock64();\n    mbar_wait(&empty[n % kSlots], (n / kSlots) & 1);\n"
             "    wc += clock64() - t0;\n  }"),
        ])
        patch(f"{d}/lz4_decode.cu", [
            ("  while (!done && step < s_stop) {\n",
             "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tw = 0, Tw = 0, nb = 0;\n"
             "  const long long tstart = clock64(), g0 = gtimer();\n  while (!done && step < s_stop) {\n"),
            ("    bool last = false;\n    do {\n", "    bool last = false;\n    tw = clock64();\n    do {\n"),
            ("    } while (k < m && !last);\n", "    } while (k < m && !last);\n    Tw += clock64() - tw;\n    ++nb;\n"),
            ("!is_match, o_first, written);", "!is_match, o_first, written, T);"),
            ("  if (lane == 0 && P.counters) {",
             "  if (lane == 0) {\n    atomicAdd(&g_prof[0], (unsigned long long)Tw);\n"
             "    for (int i = 1; i < 5; ++i) atomicAdd(&g_prof[i], (unsigned long long)T[i]);\n"
             "    atomicAdd(&g_prof[5], (unsigned long long)nb);\n"
             "    atomicAdd(&g_prof[6], (unsigned long long)(clock64() - tstart));\n"
             "    atomicAdd(&g_prof[7], (unsigned long long)step);\n"
             "    atomicAdd(&g_prof[10], (unsigned long long)h.wc);\n  }\n" + RECORD.format(role=0)
             + "  if (lane == 0 && P.counters) {"),
            ("  int4 head, tail;\n",
             "  int4 head, tail;\n  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0}, Twc = 0;\n"
             "  const long long tstart = clock64(), g0 = gtimer();\n  int step = 0;\n"),
            ("    mbar_wait(&full[s], (t / kSlots) & 1);\n",
             "    const long long tc = clock64();\n    mbar_wait(&full[s], (t / kSlots) & 1);\n"
             "    Twc += clock64() - tc;\n"),
            ("head.y);\n", "head.y, T);\n      step += head.x;\n"),
            ("  end_row(P, b, out, head.w & kRowOk, tail.w, head.y, head.z, lane);\n",
             "  end_row(P, b, out, head.w & kRowOk, tail.w, head.y, head.z, lane);\n"
             "  if (lane == 0) {\n    for (int i = 1; i < 5; ++i) atomicAdd(&g_prof[i], (unsigned long long)T[i]);\n"
             "    atomicAdd(&g_prof[11], (unsigned long long)Twc);\n"
             "    atomicAdd(&g_prof[12], (unsigned long long)(clock64() - tstart));\n  }\n"
             + RECORD.format(role=1)),
        ])
    for name in ("lz4_decode", "snappy_decode"):
        with open(f"{d}/{name}.cu", "a") as f:
            f.write(f'extern "C" int tc_prof_{name}(void* host, void* warps, int zero) {{\n'
                    "  if (zero) { unsigned long long z[16] = {0};\n"
                    "    void* w = nullptr;\n"
                    "    int e = (int)cudaGetSymbolAddress(&w, tpucomp_lzd::g_warps);\n"
                    "    if (!e) e = (int)cudaMemset(w, 0, sizeof tpucomp_lzd::g_warps);\n"
                    "    return e ? e : (int)cudaMemcpyToSymbol(tpucomp_lzd::g_prof, z, sizeof z); }\n"
                    "  int e = (int)cudaMemcpyFromSymbol(host, tpucomp_lzd::g_prof, 128);\n"
                    "  return e ? e : (int)cudaMemcpyFromSymbol(warps, tpucomp_lzd::g_warps, sizeof tpucomp_lzd::g_warps);\n}\n")
    return split


def tail(warps, n, kernel_ms, split):
    """The per-warp spread of one LZ4 run, and whether the kernel's span follows its heaviest warp."""
    lines, roles = [], (("own warp", 0), ("helper", 1)) if split else (("warp", 0),)
    for role, r in roles:
        w = warps[r:2 * n:2]
        if r:
            w = w[w[:, 3] > 0]  # the chunks that were helped
            lines.append(f"  helped: {len(w)} of {n} chunks")
            if not len(w):
                continue
        cycles = np.sort(w[:, 0])
        heavy = int(np.argmax(w[:, 0]))
        span_ns = w[heavy, 3] - w[heavy, 2]
        lines.append(f"  {role}: cycles median {int(np.median(cycles))}, p90 {int(cycles[int(0.9 * (len(cycles) - 1))])}, "
                     f"max {int(cycles[-1])} (chunk {heavy}, {int(w[heavy, 1])} sequences, span {span_ns / 1e6:.3f} ms)")
    w = warps[: 2 * n]
    w = w[w[:, 3] > 0]
    lines.append(f"  kernel: {kernel_ms:.3f} ms by events, {(w[:, 3].max() - w[:, 2].min()) / 1e6:.3f} ms from the "
                 "first warp's start to the last warp's end")
    return "\n".join(lines)


def main():
    args = sys.argv[1:]
    dump = None
    if "--dump" in args:
        i = args.index("--dump")
        dump = args[i + 1]
        del args[i:i + 2]
    src = args[0] if args else os.path.join(ROOT, "tpucomp_torch", "csrc")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    with tempfile.TemporaryDirectory() as d:
        for f in os.listdir(src):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(src, f), d)
        split = instrument(d)
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
        L.tc_prof_lz4_decode.argtypes = L.tc_prof_snappy_decode.argtypes = [P, P, I]

        data = torch.from_numpy(np.frombuffer(load_corpus(B * C), np.uint8).reshape(B, C).copy()).cuda()
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        streams = {"lz4": cl.compress(data, lengths), "snappy": cs.compress(data, lengths)}
        scratch = torch.empty(C, dtype=torch.int32, device="cuda")
        dumped = {}
        for codec, prof in (("lz4", L.tc_prof_lz4_decode), ("snappy", L.tc_prof_snappy_decode)):
            comp, sizes = streams[codec]
            names = SPLIT_NAMES if codec == "lz4" and split else NAMES
            for n in (1056, B):
                out = torch.empty(n, C, dtype=torch.uint8, device="cuda")
                ln = torch.empty(n, dtype=torch.int32, device="cuda")
                st = torch.empty(n, dtype=torch.int32, device="cuda")
                args = (comp.data_ptr(), sizes.data_ptr(), out.data_ptr(), ln.data_ptr(), st.data_ptr(), n,
                        comp.shape[1], C)
                assert prof(None, None, 1) == 0
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
                warps = np.zeros((2 * 4096, 4), np.int64)
                assert prof(buf, warps.ctypes.data, 0) == 0
                v = dict(zip(names, list(buf)))
                ms = e0.elapsed_time(e1)
                print(f"{codec} {n} chunks {ms:.3f} ms; per step (summed over warps): "
                      + ", ".join(f"{k} {v[k] / v['steps']:.2f}" for k in names if k != "steps"), flush=True)
                if codec == "lz4":
                    print(tail(warps, n, ms, split), flush=True)
                    dumped[n] = {"steps": warps[0:2 * n:2, 1].tolist(), "cycles": warps[0:2 * n:2, 0].tolist(),
                                 "copier_cycles": warps[1:2 * n:2, 0].tolist() if split else None,
                                 "comp_sizes": sizes[:n].tolist(), "kernel_ms": ms}
        if dump:
            with open(dump, "w") as f:
                json.dump(dumped, f)


if __name__ == "__main__":
    main()
