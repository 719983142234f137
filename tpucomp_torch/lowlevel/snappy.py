"""Snappy low-level batch API (counterpart of ``tpucomp.lowlevel.snappy``).

The options are reserved: Snappy streams delimit themselves.
"""

from __future__ import annotations

from tpucomp_torch.codecs import snappy as _snappy
from tpucomp_torch.core.options import SnappyOpts
from tpucomp_torch.core.sizing import snappy_max_compressed_chunk_size
from tpucomp_torch.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts: SnappyOpts) -> int:
    return snappy_max_compressed_chunk_size(chunk_bytes)


CODEC = BatchCodec(
    name="snappy",
    default_opts=SnappyOpts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=_snappy.compress,
    decompress_fn=lambda comp, sizes, opts, cap: _snappy.decompress(comp, sizes, out_capacity=cap),
    decompress_size_fn=_snappy.get_decompress_size,
)
