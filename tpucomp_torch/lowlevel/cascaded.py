"""Cascaded low-level batch API (counterpart of ``tpucomp.lowlevel.cascaded``)."""

from __future__ import annotations

from tpucomp_torch.codecs import cascaded as _cc
from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.sizing import cascaded_max_compressed_chunk_size
from tpucomp_torch.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts: CascadedOpts) -> int:
    return cascaded_max_compressed_chunk_size(chunk_bytes)


def _decompress_size(comp, comp_sizes, opts):
    return _cc.get_decompress_size(comp, comp_sizes)


CODEC = BatchCodec(
    name="cascaded",
    default_opts=CascadedOpts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=_cc.compress,
    decompress_fn=_cc.decompress,
    decompress_size_fn=_decompress_size,
)
