"""LZ4 low-level batch API (counterpart of ``tpucomp.lowlevel.lz4``).

Decompression does not read the options: LZ4 streams delimit themselves.
"""

from __future__ import annotations

from tpucomp_torch.codecs import lz4 as _lz4
from tpucomp_torch.core.options import LZ4Opts
from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size
from tpucomp_torch.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts: LZ4Opts) -> int:
    return lz4_max_compressed_chunk_size(chunk_bytes)


CODEC = BatchCodec(
    name="lz4",
    default_opts=LZ4Opts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=_lz4.compress,
    decompress_fn=lambda comp, sizes, opts, cap: _lz4.decompress(comp, sizes, out_capacity=cap),
    decompress_size_fn=lambda comp, sizes, opts: _lz4.get_decompress_size(comp, sizes),
)
