"""Cycle breakdown of the port's Cascaded encode and decode kernels, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_cascaded_clocks.py [CSRC_DIR]

Copies ``cascaded_encode.cu``, ``cascaded_decode.cu`` and
``cascaded_common.cuh`` (``tpucomp_torch/csrc`` by default) into a
temporary directory, inserts clock64() counters at fixed points (lane 0
of each team adds its cycles to one counter per phase), builds them with
nvcc and runs each kernel 4 times on the 256 MB mixed and run-heavy
corpora as uint8[4096, 65536] and on mixed as uint8[65536, 4096]
(CascadedManager's chunks), with ``CascadedOpts()``, and on the 256 MB
int64 timestamp column as uint8[4096, 65536] with
``CascadedOpts(type=LONGLONG)`` (the 64-bit units).  Prints, per input
and kernel, the cycles per chunk of each phase summed over the teams:
encode ``load``, ``rle``, ``counts`` (packing an RLE-count blob),
``delta``, ``final`` (packing the final blob), ``vote`` and ``totals``
(waits at the two CTA barriers of a round), ``copy`` (staged chunks to
the row), ``tail`` (the partition's header, raw copy and zeros); decode
``walk`` (following the chain and parsing, by the partition's first
team), ``vote``, ``unpack``, ``delta``, ``counts`` (unpacking an
RLE-count blob), ``rle`` (expanding runs), ``counts wait`` (the CTA
barrier), ``place`` and ``tail``.  The counters cost time of their own.
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
sys.path[:0] = [ROOT]
from tpucomp_torch.codecs import cascaded as cc  # noqa: E402
from tpucomp_torch.core.options import CascadedOpts  # noqa: E402
from tpucomp_torch.core.types import DataType, width_of  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus, runheavy_corpus, timestamps64_corpus  # noqa: E402

TOTAL, CALLS = 4096 * 65536, 4
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ENCODE = ["load", "rle", "counts", "delta", "final", "vote", "totals", "copy", "tail"]
DECODE = ["walk", "vote", "unpack", "delta", "counts", "rle", "counts wait", "place", "tail"]

TAKE = """extern "C" int tc_clocks_take(void* host) {
  cudaMemcpyFromSymbol(host, tc_clocks, sizeof(tc_clocks));
  unsigned long long zero[32] = {0};
  return (int)cudaMemcpyToSymbol(tc_clocks, zero, sizeof(zero));
}
"""

# (a text found on exactly one line, a line to insert before it, a line to insert after it)
ENCODE_PROBES = [
    ("const uint8_t* src = in + e0 * w;", "long long clk = clock64();", ""),
    ("if (j < room) stage[j] = 0;  // delta headers", "", "CLK(0);"),
    ("const int runs = team_rle(", "", "CLK(1);"),
    ("stage + pos, room - pos, stage + pos + hw, room - pos - hw);", "", "CLK(2);"),
    ("n = max(n - 1, 0);", "", "CLK(3);"),
    ("kDirect ? room - pos - fhw : (long long)p.arr_words);", "", "CLK(4);"),
    ("if (!__syncthreads_or(active)) break;", "long long clk = clock64();", "CLK(5);"),
    ("if (lane == 0) totals[team] = st.total;", "", "clk = clock64();"),
    ("long long before = 0, round = 0;", "CLK(6);", ""),
    ("                 lane, 32);", "", "CLK(7);"),
    ("const int tid = s * 32 + lane, nth = p.slots * 32;", "long long clk = clock64();", ""),
    ("zero_bytes(o + end, p.pmax - end, tid, nth);", "", "CLK(8);"),
]
DECODE_PROBES = [
    ("bool any = false;", "long long clk = clock64();", ""),
    ("any = __any_sync(kFull, at >= 0);", "", "CLK(0);"),
    ("if (!__syncthreads_or(any)) break;", "clk = clock64();", "CLK(1);"),
    ("long long n = team_read_blob(", "long long clk = clock64();", "CLK(2);"),
    ("team_delta_decode(cur, n,", "", "CLK(3);"),
    ("team_read_blob<uint32_t>(row, ci.base + ci.rle_off[r]", "", "CLK(4);"),
    ("n = team_rle_decode(cur, z, n, alt, e);", "", "CLK(5);"),
    ("if (lane == 0) counts[team] = n;", "", "clk = clock64();"),
    ("long long before = 0, round = 0;", "CLK(6);", ""),
    ("placed_end += round;", "", "CLK(7);"),
    ("const int tid = s * 32 + lane, nth = p.slots * 32;", "long long clk = clock64();", ""),
    ("zero_bytes(o + end, p.out_capacity - end, tid, nth);", "", "CLK(8);"),
]


def instrument(src, name, probes, base, tmp):
    """The source with its probes; counters [base, base + 9) of one array
    that the encode source defines."""
    with open(os.path.join(src, f"{name}.cu")) as f:
        lines = f.read().split("\n")
    for anchor, before, after in probes:
        at = [i for i, line in enumerate(lines) if anchor in line]
        assert len(at) == 1, f"{name}: {len(at)} lines hold the probe anchor {anchor!r}"
        lines[at[0]] = "\n".join(x for x in (before, lines[at[0]], after) if x)
    text = "\n".join(lines)
    decl = ("__device__ unsigned long long tc_clocks[32];\n" + TAKE if base == 0
            else "extern __device__ unsigned long long tc_clocks[32];\n")
    macro = (f"#define CLK(k) do {{ if (lane_id() == 0) atomicAdd(&tc_clocks[{base} + (k)], "
             "(unsigned long long)(clock64() - clk)); clk = clock64(); } while (0)\n")
    include = '#include "cascaded_common.cuh"\n'
    text = text.replace(include, include + "namespace tpucomp {\n" + decl + macro + "}\n", 1)
    out = os.path.join(tmp, f"{name}.cu")
    with open(out, "w") as f:
        f.write(text)
    return out


def build(src, tmp):
    shutil.copy(os.path.join(src, "cascaded_common.cuh"), tmp)
    srcs = [instrument(src, "cascaded_encode", ENCODE_PROBES, 0, tmp),
            instrument(src, "cascaded_decode", DECODE_PROBES, 16, tmp)]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(tmp, "libclocks.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-rdc=true",
                    "-Xcompiler", "-fPIC", "-shared", "-o", lib, *srcs], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_cascaded_encode.argtypes = [P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I, P, P]
    lib.tc_cascaded_decode.argtypes = [P, P, P, P, P, LL, LL, LL, I, I, I, I, I, I, I, P, P]
    lib.tc_clocks_take.argtypes = [P]
    return lib


def take(lib):
    host = (ctypes.c_ulonglong * 32)()
    assert lib.tc_clocks_take(ctypes.cast(host, P)) == 0
    return list(host)


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tpucomp_torch", "csrc")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    int32, int64 = CascadedOpts(), CascadedOpts(type=DataType.LONGLONG)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(src, tmp)
        for label, gen, c, o in (("mixed 4096 x 64 KB", load_corpus, 65536, int32),
                                 ("runheavy 4096 x 64 KB", runheavy_corpus, 65536, int32),
                                 ("mixed 65536 x 4 KB", load_corpus, 4096, int32),
                                 ("timestamps64 LONGLONG 4096 x 64 KB", timestamps64_corpus, 65536, int64)):
            w = width_of(o.type)
            data = torch.from_numpy(np.frombuffer(gen(TOTAL), np.uint8).reshape(-1, c).copy()).cuda()
            b = data.shape[0]
            lengths = torch.full((b,), c, dtype=torch.int32, device="cuda")
            pmax = cc.partition_output_max(c, o)
            # the options, then no counters and the stream
            args = (w, int(o.type), o.chunk_num_elements, max(1, -(-c // o.chunk_size)), o.num_rles,
                    o.num_deltas, int(o.use_bp), None, torch.cuda.current_stream().cuda_stream)
            comp = torch.empty(b, pmax, dtype=torch.uint8, device="cuda")
            sizes = torch.empty(b, dtype=torch.int32, device="cuda")
            out = torch.empty(b, c, dtype=torch.uint8, device="cuda")
            nbytes, status = (torch.empty(b, dtype=torch.int32, device="cuda") for _ in range(2))
            chunks = b * (c // o.chunk_size)
            take(lib)
            for kern, names in (("encode", ENCODE), ("decode", DECODE)):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(CALLS):
                    if kern == "encode":
                        err = lib.tc_cascaded_encode(data.data_ptr(), lengths.data_ptr(), comp.data_ptr(),
                                                     sizes.data_ptr(), b, c, pmax, *args)
                    else:
                        err = lib.tc_cascaded_decode(comp.data_ptr(), sizes.data_ptr(), out.data_ptr(),
                                                     nbytes.data_ptr(), status.data_ptr(), b, pmax, c, *args)
                    assert err == 0, err
                e.record()
                e.synchronize()
                clocks = take(lib)[16:25] if kern == "decode" else take(lib)[:9]
                if kern == "decode":
                    assert bool((status == 0).all()) and torch.equal(out, data), "decode is not exact"
                per = ", ".join(f"{n} {v / CALLS / chunks:.0f}" for n, v in zip(names, clocks))
                print(f"{label} {kern}: {s.elapsed_time(e) / CALLS:.3f} ms a call with counters; cycles per "
                      f"chunk: {per}", flush=True)
            del data, comp, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
