"""Low-level batch API ("LLIF" equivalent).

PyTorch counterpart of ``tpucomp.lowlevel.api``: a ``BatchCodec`` of plain
functions over dense chunk batches.  PyTorch's caching allocator owns
scratch, so the *GetTempSize members report 0, as the reference's cascaded
path does; "async on a stream" is PyTorch's current CUDA stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpucomp_torch.core.chunking import ChunkBatch


@dataclasses.dataclass(frozen=True)
class BatchCodec:
    """Format-generic low-level batch interface."""

    name: str
    default_opts: Any
    # host math: worst-case compressed size for one chunk of n bytes
    max_compressed_chunk_size: Callable[[int, Any], int]
    # (data, lengths, opts) -> (comp, comp_sizes)
    compress_fn: Callable
    # (comp, comp_sizes, opts, out_capacity) -> (data, lengths, statuses)
    decompress_fn: Callable
    # (comp, comp_sizes, opts) -> sizes
    decompress_size_fn: Callable

    def compress_get_temp_size(self, batch_size: int, max_chunk_bytes: int, opts=None) -> int:
        return 0

    def decompress_get_temp_size(self, batch_size: int, max_chunk_bytes: int, opts=None) -> int:
        return 0

    def compress_get_max_output_chunk_size(self, max_chunk_bytes: int, opts=None) -> int:
        return self.max_compressed_chunk_size(max_chunk_bytes, opts or self.default_opts)

    def compress(self, batch: ChunkBatch, opts=None) -> ChunkBatch:
        """Batched compression; returns a ChunkBatch of compressed streams."""
        opts = opts or self.default_opts
        comp, sizes = self.compress_fn(batch.data, batch.lengths, opts)
        return ChunkBatch(comp, sizes)

    def decompress(self, comp: ChunkBatch, out_capacity: int, opts=None):
        """Batched decompression; returns (ChunkBatch, statuses int32[B])."""
        opts = opts or self.default_opts
        data, lengths, statuses = self.decompress_fn(comp.data, comp.lengths, opts, out_capacity)
        return ChunkBatch(data, lengths), statuses

    def get_decompress_size(self, comp: ChunkBatch, opts=None) -> torch.Tensor:
        opts = opts or self.default_opts
        return self.decompress_size_fn(comp.data, comp.lengths, opts)
