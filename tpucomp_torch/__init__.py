"""tpucomp_torch: the PyTorch / CUDA port of tpucomp.

Batched lossless compression over dense chunk batches, byte-identical to
the JAX package ``tpucomp``, which stays the reference.  It holds the
Cascaded (RLE / Delta / BitPack), LZ4 and Snappy codecs: hand-written CUDA
kernels for NVIDIA Hopper on the GPU, and a plain PyTorch formulation of
each kernel, which a batch on the CPU takes.  The high-level managers
write self-describing artifacts that the JAX package reads, and read
its.  Batches and managers go to the card unless the caller asks for the
CPU (``device="cpu"``).  Above them: ``config.use_cuda_kernels`` (the
routing flag), ``parallel.sharding`` (a batch over the cards of one
process), ``parallel.multihost`` (one process per card on
``torch.distributed``), the CLI (``python -m tpucomp_torch.cli``),
``native`` (a g++-built host library for staging) and the
``lowlevel.stubs`` slots.

Layers, from the entry points down; each imports only the layers below
it: ``lowlevel`` (the batch API) and ``highlevel`` (the managers) ->
``codecs`` (routing by device; the plain PyTorch versions, with ``ops``)
-> ``kernels`` (a wrapper module a kernel source, ``*_cuda.py``, and
``_build.py``, which builds the library and launches every entry point
through one helper) -> ``core`` and ``utils``.

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

On the CPU, name the devices: ``python -m tpucomp_torch.cli compress
--device cpu ...``, a mesh of ``["cpu"] * n`` for ``sharded_compress``,
``device="cpu"`` and the gloo backend for ``multihost`` (two such
processes: ``tests/test_torch_multihost.py``).

Tests: on a CPU, ``python -m pytest tests/test_torch_*.py -q`` holds the
port to tpucomp (Snappy in ``tests/test_torch_snappy.py``, the managers
in ``tests/test_torch_highlevel.py``, the host surface in
``tests/test_torch_{parallel,multihost,cli,native,config}.py``).  On an
NVIDIA GPU, ``python3 chip_smoke.py`` (phases 15-18: the routing flag,
sharding over every card and over ``[cuda:0] * 3``, two gloo ranks on one
card and NCCL at one rank per card, the CLI and staging) and
``python -m pytest tests/test_torch_kernels.py tests/test_torch_lz4_kernels.py
tests/test_torch_snappy_kernels.py tests/test_torch_config.py -m cuda
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
