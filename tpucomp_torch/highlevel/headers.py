"""Self-describing artifact headers (counterpart of ``tpucomp.highlevel.headers``).

Byte-compatible with the reference's CommonHeader / per-format
FormatSpecHeader structs (x86-64 layout), and so with the JAX package's
artifacts:

    offset  field
    0       u32 magic_number (0)
    4       u8 major_version (2), u8 minor_version (2), u8 format, pad
    8       u64 comp_data_size
    16      u64 decomp_data_size
    24      u64 num_chunks
    32      u8 include_chunk_starts (1), pad x3
    36      u32 full_comp_buffer_checksum (reserved, 0)
    40      u32 decomp_buffer_checksum (reserved, 0)
    44      u8 include_per_chunk_comp_buffer_checksums (0)
    45      u8 include_per_chunk_decomp_buffer_checksums (0), pad x2
    48      u64 uncomp_chunk_size
    56      u32 comp_data_offset, pad x4
    64      FormatSpecHeader (LZ4: u32 dtype; Snappy: 1 byte;
            Cascaded: {u64 chunk_size, u32 type, u32 num_RLEs,
            u32 num_deltas, u32 use_bp} = 24 B)

After the format header, aligned up to 8 bytes: chunk_offsets u64 x n,
chunk_sizes u64 x n, per-chunk comp checksums u32 x n, per-chunk decomp
checksums u32 x n (reserved zeros), then the packed compressed chunks.
Chunk offsets are relative to the packed-data region.  Host ``struct``
code only.
"""

from __future__ import annotations

import dataclasses
import struct

from tpucomp_torch.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp_torch.core.sizing import round_up_to
from tpucomp_torch.core.types import DataType

COMMON_HEADER_SIZE = 64
MAGIC = 0
MAJOR, MINOR = 2, 2

# FormatType enum (reference hlif_shared_types.hpp:57-64)
FORMAT_LZ4 = 0
FORMAT_SNAPPY = 1
FORMAT_ANS = 2
FORMAT_GDEFLATE = 3
FORMAT_CASCADED = 4
FORMAT_BITCOMP = 5

FORMAT_SPEC_SIZE = {FORMAT_LZ4: 4, FORMAT_SNAPPY: 1, FORMAT_CASCADED: 24}

_COMMON = "<IBBBxQQQB3xIIBB2xQI4x"


@dataclasses.dataclass
class CommonHeader:
    format: int
    comp_data_size: int
    decomp_data_size: int
    num_chunks: int
    uncomp_chunk_size: int
    comp_data_offset: int
    magic_number: int = MAGIC
    major_version: int = MAJOR
    minor_version: int = MINOR

    def pack(self) -> bytes:
        return struct.pack(
            _COMMON,
            self.magic_number,
            self.major_version,
            self.minor_version,
            self.format,
            self.comp_data_size,
            self.decomp_data_size,
            self.num_chunks,
            1,  # include_chunk_starts
            0,
            0,
            0,
            0,
            self.uncomp_chunk_size,
            self.comp_data_offset,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "CommonHeader":
        (magic, major, minor, fmt, comp_sz, decomp_sz, nchunks, _starts, _c1, _c2, _f1, _f2,
         chunk_sz, data_off) = struct.unpack(_COMMON, bytes(buf[:COMMON_HEADER_SIZE]))
        return cls(fmt, comp_sz, decomp_sz, nchunks, chunk_sz, data_off, magic, major, minor)


def pack_format_spec(fmt: int, opts) -> bytes:
    if fmt == FORMAT_LZ4:
        return struct.pack("<I", int(opts.data_type))
    if fmt == FORMAT_SNAPPY:
        return b"\x00"
    if fmt == FORMAT_CASCADED:
        return struct.pack(
            "<QIiii",
            opts.chunk_size,
            int(opts.type),
            opts.num_rles,
            opts.num_deltas,
            1 if opts.use_bp else 0,
        )
    raise ValueError(f"unsupported format {fmt}")


def unpack_format_spec(fmt: int, buf: bytes):
    if fmt == FORMAT_LZ4:
        (dt,) = struct.unpack("<I", bytes(buf[:4]))
        return LZ4Opts(data_type=DataType(dt))
    if fmt == FORMAT_SNAPPY:
        return SnappyOpts()
    if fmt == FORMAT_CASCADED:
        cs, dt, nr, nd, bp = struct.unpack("<QIiii", bytes(buf[:24]))
        return CascadedOpts(chunk_size=cs, type=DataType(dt), num_rles=nr, num_deltas=nd, use_bp=bool(bp))
    raise ValueError(f"unsupported format {fmt}")


def sections_offset(fmt: int) -> int:
    """Start of the chunk-offsets section (8-byte aligned after the format header)."""
    return round_up_to(COMMON_HEADER_SIZE + FORMAT_SPEC_SIZE[fmt], 8)


def data_region_offset(fmt: int, num_chunks: int) -> int:
    """Start of the packed compressed chunks."""
    return sections_offset(fmt) + num_chunks * (8 + 8 + 4 + 4)
