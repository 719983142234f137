"""Build and load the port's CUDA kernels.

All ``tpucomp_torch/csrc/*.cu`` sources are compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and linked into one shared library with a plain C interface,
``tpucomp_torch/_build/libtpucomp_kernels-<hash>.so``, at first use, and
loaded with ``ctypes``.  The kernels that count (``utils/profiling.py``)
take the address of their counters as the argument before the stream, null
while tracing is off.  ``ptxas``'s report of each kernel's registers and
shared memory goes beside it, into ``<hash>.log``.  The hash covers every source and header, so a
changed source builds anew.  A missing ``nvcc`` or a failed build raises
with the compiler's output; nothing degrades silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes of each C entry point
SIGNATURES = {
    # data, lengths, out, sizes, batch, row_bytes, pmax, width, dtype, elems,
    # k, nr, nd, bp, counters, stream
    "tc_cascaded_encode": [_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # comp, comp_sizes, out, out_bytes, status, batch, row_bytes,
    # out_capacity, width, dtype, elems, k, nr, nd, bp, counters, stream
    "tc_cascaded_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # batch, row_bytes, scratch_bytes (out) -> the table kernel's grid
    "tc_lz_match_table_grid": [_L, _L, ctypes.POINTER(_L)],
    # data, lengths, out, scratch, batch, row_bytes, stride, max_offset, end_margin, grid,
    # counters, stream
    "tc_lz_match_table": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P, _P],
    # data, lengths, table, out, sizes, batch, row_bytes, out_row, counter, stream
    "tc_lz4_encode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _P],
    # comp, comp_sizes, out, lengths, status, batch, row_bytes, out_capacity, counter, stream
    "tc_lz4_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _P],
    # data, lengths, table, out, sizes, batch, row_bytes, out_row, counter, stream
    "tc_snappy_encode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _P],
    # comp, comp_sizes, out, lengths, status, batch, row_bytes, out_capacity,
    # scratch, slots, counter, stream
    "tc_snappy_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _L, _P, _P],
    # comp, sizes, inc, artifact, k, row, head, head_bytes, sections_off, data_off, out_max,
    # counter, stream
    "tc_manager_pack": [_P, _P, _P, _P, _L, _L, _P, _I, _L, _L, _L, _P, _P],
    # artifact, rows, sizes, numel, k, max_chunk, sections_off, data_off, counter, stream
    "tc_manager_unpack": [_P, _P, _P, _L, _L, _L, _L, _L, _P, _P],
}


class BuildError(RuntimeError):
    """The kernels could not be built."""


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc is None and toolkit.exists():
        nvcc = str(toolkit)
    if nvcc is None:
        raise BuildError(
            "nvcc not found: the CUDA kernels of tpucomp_torch are built from "
            f"tpucomp_torch/csrc at first use and need the CUDA toolkit (nvcc on PATH or {toolkit})"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(SOURCES.glob("*.cu")) + sorted(SOURCES.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpucomp_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    path = library_path()
    if path.exists():
        return path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objects, procs = [], []
    for src in sorted(SOURCES.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
        objects.append(obj)
    logs = []
    try:
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            logs.append(err)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed (loaded once per process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
