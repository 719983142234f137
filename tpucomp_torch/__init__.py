"""tpucomp_torch: the PyTorch / CUDA port of tpucomp.

Batched lossless compression over dense chunk batches, byte-identical to
the JAX package ``tpucomp``, which stays the reference.  It holds the
Cascaded (RLE / Delta / BitPack) and LZ4 codecs: hand-written CUDA kernels
for NVIDIA Hopper on the GPU, and a plain PyTorch formulation of each
kernel, which a batch on the CPU takes.  Batches go to the card unless
the caller asks for the CPU.

Quick start::

    from tpucomp_torch import pack_chunks, unpack_chunks, cascaded_codec, lz4_codec

    chunks = [bytes(range(256)) * 256] * 8
    batch = pack_chunks(chunks, device="cuda")
    for codec in (cascaded_codec, lz4_codec):
        comp = codec.compress(batch)
        out, statuses = codec.decompress(comp, batch.capacity)
        assert unpack_chunks(out) == chunks and not statuses.any()
"""

from tpucomp_torch.core.chunking import ChunkBatch, pack_chunks, unpack_chunks
from tpucomp_torch.core.options import CascadedOpts, LZ4Opts
from tpucomp_torch.core.types import DataType, Status
from tpucomp_torch.lowlevel.cascaded import CODEC as cascaded_codec
from tpucomp_torch.lowlevel.lz4 import CODEC as lz4_codec

__all__ = [
    "ChunkBatch",
    "pack_chunks",
    "unpack_chunks",
    "DataType",
    "Status",
    "CascadedOpts",
    "LZ4Opts",
    "cascaded_codec",
    "lz4_codec",
]
