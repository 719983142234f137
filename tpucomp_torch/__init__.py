"""tpucomp_torch: the PyTorch / CUDA port of tpucomp.

Batched lossless compression over dense chunk batches, byte-identical to
the JAX package ``tpucomp``, which stays the reference.  It holds the
Cascaded (RLE / Delta / BitPack), LZ4 and Snappy codecs: hand-written CUDA
kernels for NVIDIA Hopper on the GPU, and a plain PyTorch formulation of
each kernel, which a batch on the CPU takes.  The high-level managers
write self-describing artifacts that the JAX package reads, and read
its.  Batches and managers go to the card unless the caller asks for the
CPU (``device="cpu"``).

Quick start::

    from tpucomp_torch import pack_chunks, unpack_chunks, cascaded_codec, lz4_codec, snappy_codec

    chunks = [bytes(range(256)) * 256] * 8
    batch = pack_chunks(chunks, device="cuda")
    for codec in (cascaded_codec, lz4_codec, snappy_codec):
        comp = codec.compress(batch)
        out, statuses = codec.decompress(comp, batch.capacity)
        assert unpack_chunks(out) == chunks and not statuses.any()

High-level (one contiguous buffer, self-describing artifact)::

    from tpucomp_torch import SnappyManager, create_manager

    artifact, size = SnappyManager(uncomp_chunk_size=65536).compress(payload)
    data, statuses = create_manager(artifact).decompress(artifact)

Tests: on a CPU, ``python -m pytest tests/test_torch_*.py -q`` holds the
port to tpucomp (Snappy in ``tests/test_torch_snappy.py``, the managers
in ``tests/test_torch_highlevel.py``).  On an NVIDIA GPU,
``python3 chip_smoke.py`` and ``python -m pytest tests/test_torch_kernels.py
tests/test_torch_lz4_kernels.py tests/test_torch_snappy_kernels.py -m cuda
--noconftest -o addopts="" -q`` hold the kernels to their plain versions.
"""

from tpucomp_torch.core.chunking import ChunkBatch, join_stream, pack_chunks, split_stream, unpack_chunks
from tpucomp_torch.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp_torch.core.types import DataType, Status
from tpucomp_torch.highlevel.manager import CascadedManager, LZ4Manager, SnappyManager, create_manager
from tpucomp_torch.lowlevel.cascaded import CODEC as cascaded_codec
from tpucomp_torch.lowlevel.lz4 import CODEC as lz4_codec
from tpucomp_torch.lowlevel.snappy import CODEC as snappy_codec

__all__ = [
    "ChunkBatch",
    "pack_chunks",
    "unpack_chunks",
    "split_stream",
    "join_stream",
    "DataType",
    "Status",
    "CascadedOpts",
    "LZ4Opts",
    "SnappyOpts",
    "cascaded_codec",
    "lz4_codec",
    "snappy_codec",
    "LZ4Manager",
    "SnappyManager",
    "CascadedManager",
    "create_manager",
]
