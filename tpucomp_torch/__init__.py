"""tpucomp_torch: the PyTorch / CUDA port of tpucomp.

Batched lossless compression over dense chunk batches, byte-identical to
the JAX package ``tpucomp``, which stays the reference.  This slice holds
the Cascaded (RLE / Delta / BitPack) codec: a plain PyTorch formulation on
the CPU and hand-written CUDA kernels for NVIDIA Hopper on the GPU.

Quick start::

    import torch
    from tpucomp_torch import pack_chunks, unpack_chunks, cascaded_codec

    batch = pack_chunks([bytes(range(256)) * 64] * 8, device="cuda")
    comp = cascaded_codec.compress(batch)
    out, statuses = cascaded_codec.decompress(comp, batch.capacity)
    assert unpack_chunks(out)[0] == bytes(range(256)) * 64
"""

from tpucomp_torch.core.chunking import ChunkBatch, pack_chunks, unpack_chunks
from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.types import DataType, Status
from tpucomp_torch.lowlevel.cascaded import CODEC as cascaded_codec

__all__ = [
    "ChunkBatch",
    "pack_chunks",
    "unpack_chunks",
    "DataType",
    "Status",
    "CascadedOpts",
    "cascaded_codec",
]
