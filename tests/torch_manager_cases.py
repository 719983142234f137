"""Inputs of the managers' stream copy (assembly and slicing), shared by the
port's tests, the emulator check and chip_smoke.py.

The copy sees bytes and an offset table only, so most cases are
synthetic rows at a manager's widths; ``manager_case`` runs a manager's
codec (its plain version, on the CPU) on a small buffer.  Each case is a
``Case``: the codec's rows and sizes (numpy) and the manager's layout.
``damaged`` rewrites a sound artifact's tables so that streams point past
its end, wrap, or carry sizes the rows cannot hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpucomp_torch.core.options import CascadedOpts, LZ4Opts
from tpucomp_torch.core.types import DataType
from tpucomp_torch.highlevel import headers as hdr
from tpucomp_torch.highlevel import manager as tm

LZ4_ROW = 65800  # LZ4Manager's max_chunk at 64 KB chunks: no multiple of 16
MANAGERS = {
    "lz4": (tm.LZ4Manager, {}),
    "snappy": (tm.SnappyManager, {}),
    "cascaded": (tm.CascadedManager, {}),
    "cascaded_longlong": (tm.CascadedManager, {"opts": CascadedOpts(type=DataType.LONGLONG)}),
}


@dataclasses.dataclass
class Case:
    label: str
    comp: np.ndarray       # uint8[k, row]: the codec's rows
    sizes: np.ndarray      # int32[k]
    static_head: bytes
    data_off: int
    sections_off: int
    out_max: int
    max_chunk: int         # the manager's, for slicing

    @property
    def k(self) -> int:
        return self.comp.shape[0]

    def layout(self) -> dict:
        return {"data_off": self.data_off, "sections_off": self.sections_off, "out_max": self.out_max}


def _case(label, comp, sizes, fmt, opts, max_chunk, chunk=65536, decomp=0) -> Case:
    k = comp.shape[0]
    data_off = hdr.data_region_offset(fmt, k)
    common = hdr.CommonHeader(format=fmt, comp_data_size=0, decomp_data_size=decomp, num_chunks=k,
                              uncomp_chunk_size=chunk, comp_data_offset=data_off)
    return Case(label, np.ascontiguousarray(comp, np.uint8), np.asarray(sizes, np.int32),
                common.pack() + hdr.pack_format_spec(fmt, opts), data_off, hdr.sections_offset(fmt),
                data_off + k * max_chunk, max_chunk)


def synthetic(rng, label: str, sizes, row: int = LZ4_ROW) -> Case:
    """Random rows of ``row`` bytes with the given sizes, in LZ4Manager's layout."""
    sizes = np.asarray(sizes, np.int32)
    comp = rng.integers(0, 256, (sizes.size, row), dtype=np.uint8)
    return _case(label, comp, sizes, hdr.FORMAT_LZ4, LZ4Opts(), row)


def shape_cases(seed: int = 0) -> list[Case]:
    """k = 1; zero sizes among full rows; every row exactly max_chunk; sizes
    that put the offsets at every residue mod 16; all sizes zero; sizes of 1
    to 40 bytes on short rows (many streams in one 16-byte word)."""
    rng = np.random.default_rng(seed)
    r = LZ4_ROW
    return [
        synthetic(rng, "k=1", [r // 2 + 3]),
        synthetic(rng, "k=1 full", [r]),
        synthetic(rng, "zero sizes among full", [r, 0, 0, r, 5, 0, r, 0]),
        synthetic(rng, "every row max_chunk", [r] * 5),
        synthetic(rng, "offsets at every residue", [17 + 4096 * (i % 3) for i in range(35)]),
        synthetic(rng, "all sizes zero", [0] * 6),
        synthetic(rng, "tiny streams", rng.integers(0, 41, 48), row=40),
        synthetic(rng, "ragged", rng.integers(0, r + 1, 12)),
    ]


def many_small(seed: int = 1, k: int = 65536, row: int = 4104) -> Case:
    """CascadedManager's default shape: ``k`` streams of up to 4 KB."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, row + 1, k).astype(np.int32)
    sizes[rng.integers(0, k, k // 16)] = 0
    sizes[rng.integers(0, k, k // 16)] = row
    comp = rng.integers(0, 256, (k, row), dtype=np.uint8)
    return _case(f"{k} x 4 KB", comp, sizes, hdr.FORMAT_CASCADED, CascadedOpts(), row, chunk=4096)


def manager_case(name: str, payload: bytes) -> Case:
    """``payload`` through manager ``name``'s codec on the CPU, as its
    ``compress`` stages it: the rows and sizes it assembles."""
    cls, kwargs = MANAGERS[name]
    mgr = cls(device="cpu", **kwargs)
    n, cs = len(payload), mgr.uncomp_chunk_size
    k = mgr.configure_compression(n).num_chunks
    padded = torch.zeros(k * cs, dtype=torch.uint8)
    padded[:n] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    lengths = (n - torch.arange(k) * cs).clamp(0, cs).to(torch.int32)
    comp, sizes = mgr._codec_compress(padded.view(k, cs), lengths)
    return _case(f"{name} manager", comp.numpy(), sizes.to(torch.int32).numpy(), mgr.format_id, mgr.opts,
                 mgr._max_comp_chunk_size(cs), chunk=cs, decomp=n)


def payload(seed: int, n: int) -> bytes:
    """Runs of small values: every codec compresses it, none to nothing."""
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 40, n), rng.integers(1, 9, n))[:n].astype(np.uint8).tobytes()


def manager_cases() -> list[Case]:
    """Each manager at its default chunk: 1.4 chunks of 64 KB for LZ4 and
    Snappy, 5.3 chunks of 4 KB for Cascaded (INT and LONGLONG)."""
    return [manager_case(name, payload(i, 92000 if name in ("lz4", "snappy") else 21700))
            for i, name in enumerate(MANAGERS)]


def _put_u64(art: np.ndarray, at: int, v: int) -> None:
    art[at : at + 8] = np.frombuffer((v % 2**64).to_bytes(8, "little"), np.uint8)


def damaged(case: Case, artifact: np.ndarray, size: int) -> list[tuple[str, np.ndarray]]:
    """(label, artifact) pairs: ``artifact`` (uint8, at least ``size`` bytes:
    a sound assembly of ``case``) with its tables rewritten, or cut."""
    k, so, d = case.k, case.sections_off, case.data_off
    art = artifact[:size].copy()
    n = art.size
    sizes = case.sizes.astype(np.int64)
    offs = np.cumsum(sizes) - sizes
    out = []

    def edit(label, *puts, cut=None, magic=False):
        a = art.copy()
        if magic:  # a clamp to byte 0 then reads something other than the magic's zeros
            a[:4] = (0x11, 0x22, 0x33, 0x44)
        for which, i, v in puts:  # which 0: the offset table, 1: the sizes
            _put_u64(a, so + 8 * (which * k + i), int(v))
        out.append((label, a if cut is None else a[:cut].copy()))

    last = k - 1
    edit("offset past the end", (0, 0, n - d + 5))
    edit("stream runs past the end", (0, last, n - d - max(1, int(sizes[last]) // 2)),
         (1, last, max(2, int(sizes[last]))))
    edit("offset above 2**63", (0, min(1, last), 2**63 + 12345))
    edit("offset above 2**63, magic damaged", (0, last, 2**63 + 12345), (1, last, 33), magic=True)
    edit("offset wraps to the header", (0, 0, 2**64 - d + 3), (1, 0, min(case.max_chunk, 40)))
    edit("negative size", (1, 0, 2**64 - 5))
    edit("size past max_chunk", (1, last, case.max_chunk + 1000))
    edit("size above 2**32", (1, 0, 2**32 + 7))
    edit("size above 2**63", (1, last, 2**63 + 9))
    edit("cut after half the streams", cut=max(so + 16 * k, d + int(offs[last] + sizes[last]) // 2))
    edit("cut right after the tables", cut=so + 16 * k)
    return out
