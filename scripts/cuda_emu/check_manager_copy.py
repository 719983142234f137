"""Check the managers' stream-copy kernel on the CPU, under a host emulation of CUDA.

Run from the repository root (needs g++ and no card)::

    python3 scripts/cuda_emu/check_manager_copy.py [CSRC_DIR]

Builds ``manager_copy.cu`` of CSRC_DIR (``tpucomp_torch/csrc`` by default)
with g++ against ``include/emu.h`` (each ``kernel<<<grid, block, ...>>>``
launch rewritten to the emulator's), calls both C entry points on CPU
tensors as ``kernels/manager_cuda.py`` calls them on the card, into
outputs pre-filled with a marker byte (every byte must be written), and
holds them to the plain versions (``highlevel/manager.py``'s
``_assemble_artifact`` and ``_slice_streams``) with tolerance 0, and
their counters (``manager.pack.bytes``, ``manager.unpack.bytes``) to the
artifact's ``comp_data_size``: each manager's codec output at its default
chunk (LZ4, Snappy, Cascaded INT and LONGLONG, ``tests/
torch_manager_cases.py``), the shape cases (k = 1, zero sizes among full
rows, rows of exactly max_chunk, offsets at every residue mod 16, many
streams in one 16-byte word), 64 rows of 4 KB, and every artifact sliced
again with its tables damaged (streams past its end, wrapping offsets,
sizes past the rows) and from every base alignment mod 16.  The emulation
checks logic only (no timing, memory model or nvcc); the ``cuda`` tests
on the card stay the judge.  Prints one line per group and every
mismatch; exits 1 on any.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import torch_manager_cases as mc  # noqa: E402
from tpucomp_torch.highlevel import headers as hdr  # noqa: E402
from tpucomp_torch.highlevel import manager as tm  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LAUNCH = re.compile(r"(\w+)<<<(.*)>>>\(")
MARK = 0xAB  # bytes the kernel must all overwrite


def build(src: str, out_dir: str):
    with open(os.path.join(src, "manager_copy.cu")) as f:
        text = LAUNCH.sub(r"emu_launch(\1, emu_cfg(\2))(", f.read())
    cpp = os.path.join(out_dir, "manager_copy.cpp")
    with open(cpp, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, "libmanager_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", src, "-include", "emu.h", "-o", lib, cpp, os.path.join(HERE, "emu.cpp")], check=True)
    lib = ctypes.CDLL(lib)
    lib.tc_manager_pack.argtypes = [P, P, P, P, LL, LL, P, I, LL, LL, LL, P, P]
    lib.tc_manager_unpack.argtypes = [P, P, P, LL, LL, LL, LL, LL, P, P]
    return lib


def pack(lib, case, counter):
    """The kernel's (artifact, size), as manager_cuda.pack launches it."""
    comp = torch.from_numpy(case.comp)
    sizes = torch.from_numpy(case.sizes).to(torch.int64)
    inc = sizes.cumsum(0)
    artifact = torch.full((case.out_max,), MARK, dtype=torch.uint8)
    head = np.frombuffer(case.static_head, np.uint8)
    err = lib.tc_manager_pack(comp.data_ptr(), sizes.data_ptr(), inc.data_ptr(), artifact.data_ptr(), case.k,
                              comp.shape[1], head.ctypes.data, head.size, case.sections_off, case.data_off,
                              case.out_max, counter.data_ptr(), None)
    assert err == 0
    return artifact, case.data_off + int(inc[-1])


def unpack(lib, artifact, common, sections_off, max_chunk, counter):
    """The kernel's (rows, sizes), as manager_cuda.unpack launches it."""
    k = common.num_chunks
    rows = torch.full((k, max_chunk), MARK, dtype=torch.uint8)
    sizes = torch.full((k,), -7, dtype=torch.int32)
    err = lib.tc_manager_unpack(artifact.data_ptr(), rows.data_ptr(), sizes.data_ptr(), artifact.numel(), k,
                                max_chunk, sections_off, common.comp_data_offset, counter.data_ptr(), None)
    assert err == 0
    return rows, sizes


def at_base(artifact: np.ndarray, shift: int) -> torch.Tensor:
    """``artifact`` as a view that starts ``shift`` bytes past a 64-byte
    aligned allocation."""
    buf = torch.full((artifact.size + shift,), 0x5C, dtype=torch.uint8)
    buf[shift:] = torch.from_numpy(artifact)
    return buf[shift:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", nargs="?", default=os.path.join(ROOT, "tpucomp_torch", "csrc"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.csrc, tmp)
        bad = 0

        def same(label, got, want):
            nonlocal bad
            for i, (g, w) in enumerate(zip(got, want)):
                if not isinstance(g, torch.Tensor):
                    where = None if g == w else (g, w)
                elif g.shape != w.shape:
                    where = "shape"
                else:
                    where = None if torch.equal(g, w) else (g != w).nonzero()[:4].tolist()
                if where is not None:
                    bad += 1
                    print(f"MISMATCH {label}: output {i} differs at {where}", flush=True)
                    return False
            return True

        def counted(label, counter, want):
            nonlocal bad
            if int(counter[0]) != want:
                bad += 1
                print(f"MISMATCH {label}: counter {int(counter[0])}, want {want}", flush=True)

        def slice_both(label, artifact, case):
            common = hdr.CommonHeader.unpack(artifact[: hdr.COMMON_HEADER_SIZE].numpy().tobytes())
            counter = torch.zeros(1, dtype=torch.int64)
            got = unpack(lib, artifact, common, case.sections_off, case.max_chunk, counter)
            want = tm._slice_streams(artifact, common, case.sections_off, case.max_chunk)
            if same(label, got, want):
                tables = artifact[case.sections_off : case.sections_off + 16 * case.k].numpy()
                sizes = tables[8 * case.k :].view("<i8")
                counted(label, counter, int(np.clip(sizes, 0, case.max_chunk).sum()))

        groups = [("managers", mc.manager_cases()), ("shapes", mc.shape_cases()),
                  ("64 x 4 KB", [mc.many_small(k=64)])]
        for group, cases in groups:
            n0 = bad
            for case in cases:
                counter = torch.zeros(1, dtype=torch.int64)
                got = pack(lib, case, counter)
                want = tm._assemble_artifact(torch.from_numpy(case.comp), torch.from_numpy(case.sizes),
                                             case.static_head, **case.layout())
                if not same(f"{case.label} pack", got, want):
                    continue
                total = int(case.sizes.astype(np.int64).sum())
                counted(f"{case.label} pack", counter, total)
                artifact, size = want
                for shift in range(16):  # the artifact, cut to its size, from every base alignment
                    slice_both(f"{case.label} unpack (base + {shift})", at_base(artifact[:size].numpy(), shift), case)
                slice_both(f"{case.label} unpack (whole buffer)", artifact, case)
                for label, art in mc.damaged(case, artifact.numpy(), size):
                    for shift in (0, 7):
                        slice_both(f"{case.label} unpack {label} (base + {shift})", at_base(art, shift), case)
            print(f"  {group}: {len(cases)} cases, {'all equal' if bad == n0 else f'{bad - n0} mismatches'}",
                  flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
