"""Wrappers of the LZ4 codec's hand-written CUDA kernels.

=================  ============================  ======================================================
kernel             source                        replaces (TPU kernel) / plain PyTorch version
=================  ============================  ======================================================
encode             ``csrc/lz4_encode.cu``        ``tpucomp/kernels/lz_pallas.py::_lz4_encode_kernel``
                                                 / ``codecs/lz4.py::_compress_plain``
decode             ``csrc/lz4_decode.cu``        ``tpucomp/kernels/lz_pallas.py::_lz4_decode_kernel``
                                                 / ``codecs/lz4.py::_decompress_plain``
=================  ============================  ======================================================

The encode kernel reads the match table that ``kernels/lz77_cuda.py``
makes with the LZ4 limits; ``codecs.lz4.compress`` launches the two in
turn.  Both kernels write every byte of their outputs (zeros past each
row's stream or length), so they are allocated with ``torch.empty``.
``LAUNCHES`` counts the launches of each kernel.  The checks, the launch
and its ``.launch`` span are ``kernels/_build.py``'s.

Spans (``utils/profiling.py``): ``compress.lz4.encode`` and
``decompress.lz4.decode``.  Counters: ``lz4.encode.sequences``, and
``lz4.decode.sequences`` with the two slots after it,
``lz4.decode.handoffs`` and ``lz4.decode.walker_waits``.
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size
from tpucomp_torch.kernels import _build
from tpucomp_torch.utils.profiling import span

LAUNCHES = {"encode": 0, "decode": 0}


def encode(data: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor):
    """Encode kernel: data uint8[B, C], lengths int32[B] in [0, C] and their
    match table with the LZ4 limits and the stride of the matches
    (``lz77_cuda.match_table``), uint16[B, C], on one CUDA device -> (comp
    uint8[B, LZ4MAX], comp_sizes int32[B])."""
    with span("compress.lz4.encode"):
        dev = _build.check_cuda("tc_lz4_encode", data, lengths, table)
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError("data must be uint8[B, C]")
        b, c = data.shape
        if table.dtype != torch.uint16 or tuple(table.shape) != (b, c):
            raise ValueError(f"table must be uint16[{b}, {c}]")
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
            raise ValueError(f"lengths must be int32[{b}]")
        if c > 1 << 24:
            raise ValueError("the LZ4 encode kernel takes chunks of at most 16 MB")
        data, lengths, table = (t.contiguous() for t in (data, lengths, table))
        out_row = lz4_max_compressed_chunk_size(c)
        out = torch.empty(b, out_row, dtype=torch.uint8, device=dev)  # the kernel writes every byte
        sizes = torch.empty(b, dtype=torch.int32, device=dev)
        if b == 0:
            return out, sizes
        _build.launch(
            "tc_lz4_encode", dev, "lz4.encode.sequences",
            data.data_ptr(), lengths.data_ptr(), table.data_ptr(), out.data_ptr(), sizes.data_ptr(),
            b, c, out_row,
        )
        LAUNCHES["encode"] += 1
        return out, sizes


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, out_capacity: int):
    """Decode kernel: comp uint8[B, CMAX], comp_sizes int32[B] on one CUDA
    device -> (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B])."""
    with span("decompress.lz4.decode"):
        dev = _build.check_cuda("tc_lz4_decode", comp, comp_sizes)
        if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
            raise ValueError("comp must be uint8[B, CMAX] with CMAX >= 1")
        if not 1 <= out_capacity < 2**31:
            raise ValueError("out_capacity must be in [1, 2**31)")
        b, cmax = comp.shape
        if cmax >= 2**30:
            raise ValueError("the decode kernel takes rows below 2**30 bytes")
        comp = comp.contiguous()
        comp_sizes = comp_sizes.to(torch.int32).contiguous()
        out = torch.empty(b, out_capacity, dtype=torch.uint8, device=dev)  # the kernel writes every byte
        lengths = torch.empty(b, dtype=torch.int32, device=dev)
        status = torch.empty(b, dtype=torch.int32, device=dev)
        if b == 0:
            return out, lengths, status
        _build.launch(
            "tc_lz4_decode", dev, "lz4.decode.sequences",
            comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), lengths.data_ptr(), status.data_ptr(),
            b, cmax, out_capacity,
        )
        LAUNCHES["decode"] += 1
        return out, lengths, status
