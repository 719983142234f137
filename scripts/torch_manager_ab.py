"""A/B times of variants of the managers' stream-copy kernel, on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/torch_manager_ab.py a=DIR b=tpucomp_torch/csrc

Each DIR holds a ``manager_copy.cu`` (a copy of ``tpucomp_torch/csrc`` at
some commit, or a variant).  Each is built with nvcc into its own library.
On the 256 MB mixed corpus, as LZ4Manager (4096 streams of the LZ4
encoder, rows of 65,800 bytes) and CascadedManager (65,536 streams of
4 KB partitions) stage it, every variant's pack and unpack are held to
the plain versions (``_assemble_plain``, ``_slice_plain``, run on the
card), then each launch is timed alone with CUDA events (the cumsum and
the size read left out), in the order A B ... B A, 4 times, 10 launches
a turn: medians with min and max, beside the bound (stream bytes read
once, the artifact or the rows written once, at 3.35 TB/s) and the
plain versions' times.
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
import tpucomp_torch  # noqa: E402
from tpucomp_torch.highlevel import headers as hdr  # noqa: E402
from tpucomp_torch.highlevel import manager as tm  # noqa: E402
from tpucomp_torch.utils.corpus import load_corpus  # noqa: E402
from tpucomp_torch.utils.profiling import wall  # noqa: E402

N = 256 << 20
HBM_BYTES_PER_S = 3.35e12
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build(name, src, out_dir):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out_dir, f"libab_{name}.so")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, os.path.join(src, "manager_copy.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    print(name, " | ".join(ln.strip() for ln in r.stderr.splitlines() if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(lib)
    lib.tc_manager_pack.argtypes = [P, P, P, P, LL, LL, P, I, LL, LL, LL, P, P]
    lib.tc_manager_unpack.argtypes = [P, P, P, LL, LL, LL, LL, LL, P, P]
    return lib


def shape(mgr, data):
    """The manager's streams of ``data`` and its layout."""
    cs = mgr.uncomp_chunk_size
    k = N // cs
    comp, sizes = mgr._codec_compress(data.view(k, cs), torch.full((k,), cs, dtype=torch.int32, device=data.device))
    data_off = hdr.data_region_offset(mgr.format_id, k)
    common = hdr.CommonHeader(format=mgr.format_id, comp_data_size=0, decomp_data_size=N, num_chunks=k,
                              uncomp_chunk_size=cs, comp_data_offset=data_off)
    head = common.pack() + hdr.pack_format_spec(mgr.format_id, mgr.opts)
    layout = {"data_off": data_off, "sections_off": hdr.sections_offset(mgr.format_id),
              "out_max": mgr.configure_compression(N).max_compressed_buffer_size}
    return comp, sizes, head, layout, mgr._max_comp_chunk_size(cs)


def main():
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    data = torch.from_numpy(np.frombuffer(load_corpus(N), np.uint8).copy()).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(n, d, tmp) for n, d in variants.items()}
        names = list(libs)
        for label, mgr in (("lz4 4096 x 65,800", tpucomp_torch.LZ4Manager()),
                           ("cascaded 65,536 x 4,104", tpucomp_torch.CascadedManager())):
            comp, sizes, head, layout, max_chunk = shape(mgr, data)
            k, row = comp.shape
            sizes64 = sizes.to(torch.int64)
            inc = sizes64.cumsum(0)
            want, size = tm._assemble_plain(comp, sizes, head, **layout)
            common = hdr.CommonHeader.unpack(want[:64].cpu().numpy().tobytes())
            sliced = want[:size]
            want_rows, want_sizes = tm._slice_plain(sliced, common, layout["sections_off"], max_chunk)
            h = np.frombuffer(head, np.uint8)
            stream = torch.cuda.current_stream().cuda_stream
            art = torch.empty(layout["out_max"], dtype=torch.uint8, device=dev)
            rows = torch.empty(k, max_chunk, dtype=torch.uint8, device=dev)
            got_sizes = torch.empty(k, dtype=torch.int32, device=dev)

            def pack(lib):
                return lib.tc_manager_pack(comp.data_ptr(), sizes64.data_ptr(), inc.data_ptr(), art.data_ptr(), k,
                                           row, h.ctypes.data, h.size, layout["sections_off"], layout["data_off"],
                                           layout["out_max"], None, stream)

            def unpack(lib):
                return lib.tc_manager_unpack(sliced.data_ptr(), rows.data_ptr(), got_sizes.data_ptr(), size, k,
                                             max_chunk, layout["sections_off"], common.comp_data_offset, None, stream)

            for n, lib in libs.items():
                art.fill_(0xAB)
                rows.fill_(0xAB)
                assert pack(lib) == 0 and unpack(lib) == 0
                torch.cuda.synchronize()
                if not (torch.equal(art, want) and torch.equal(rows, want_rows) and torch.equal(got_sizes, want_sizes)):
                    sys.exit(f"{n} {label}: differs from the plain versions")
            times = {(n, op): [] for n in names for op in ("pack", "unpack")}
            for _ in range(4):
                for n in names + names[::-1]:
                    for op, fn in (("pack", pack), ("unpack", unpack)):
                        times[(n, op)] += wall(fn, libs[n], iters=10, warmup=2).ms
            plain = {"pack": wall(tm._assemble_plain, comp, sizes, head, **layout, iters=3, warmup=1).median_ms,
                     "unpack": wall(tm._slice_plain, sliced, common, layout["sections_off"], max_chunk, iters=3,
                                    warmup=1).median_ms}
            bound = {"pack": (common.comp_data_size + layout["out_max"]) / HBM_BYTES_PER_S * 1e3,
                     "unpack": (common.comp_data_size + k * max_chunk) / HBM_BYTES_PER_S * 1e3}
            print(f"{label}: {common.comp_data_size} stream bytes", flush=True)
            for op in ("pack", "unpack"):
                line = ", ".join(f"{n} {statistics.median(times[(n, op)]):.4f} ms (min {min(times[(n, op)]):.4f}, "
                                 f"max {max(times[(n, op)]):.4f})" for n in names)
                print(f"  {op}: {line}; bound {bound[op]:.4f} ms; plain {plain[op]:.3f} ms", flush=True)
            del comp, sizes, want, sliced, want_rows, art, rows
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
