"""Wrappers of the Cascaded codec's hand-written CUDA kernels.

=================  ==============================  =======================================================
kernel             source                          replaces (TPU kernel) / plain PyTorch version
=================  ==============================  =======================================================
encode             ``csrc/cascaded_encode.cu``     ``tpucomp/kernels/cascaded_pallas.py::_encode_kernel``
                                                   / ``codecs/cascaded.py::_compress_plain``
decode             ``csrc/cascaded_decode.cu``     ``tpucomp/kernels/cascaded_pallas.py::_decode_kernel``
                                                   / ``codecs/cascaded.py::_decompress_plain``
=================  ==============================  =======================================================

Every element type is taken: the kernels hold widths 1, 2 and 4 in 32-bit
units and the 8-byte types (LONGLONG / ULONGLONG) in 64-bit units, one
instantiation each.  Both kernels write every byte of their outputs (rows
up to PMAX or ``out_capacity``, zeros past the data, and every size and
status), so outputs are allocated with ``torch.empty``.  ``LAUNCHES``
counts the launches of each kernel.  The checks, the launch and its
``.launch`` span are ``kernels/_build.py``'s.

Spans (``utils/profiling.py``): ``compress.cascaded.encode`` and
``decompress.cascaded.decode``.  Counters: ``cascaded.encode.chunks``,
``.chunks_discarded`` and ``.partitions_raw`` for the encode kernel, and
``cascaded.decode.chunks`` and ``.partitions_raw`` for the decode kernel
(one address each, the first's; the others are the slots after it).
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.sizing import partition_output_max
from tpucomp_torch.core.types import width_of
from tpucomp_torch.kernels import _build
from tpucomp_torch.utils.profiling import span

LAUNCHES = {"encode": 0, "decode": 0}


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: CascadedOpts):
    """Encode kernel: data uint8[B, C], lengths int32[B] on one CUDA device ->
    (comp uint8[B, PMAX], comp_sizes int32[B])."""
    with span("compress.cascaded.encode"):
        dev = _build.check_cuda("tc_cascaded_encode", data, lengths)
        opts.validate()
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError("data must be uint8[B, C]")
        data = data.contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        b, c = data.shape
        pmax = partition_output_max(c, opts)
        out = torch.empty(b, pmax, dtype=torch.uint8, device=dev)
        sizes = torch.empty(b, dtype=torch.int32, device=dev)
        if b == 0:
            return out, sizes
        _build.launch(
            "tc_cascaded_encode", dev, "cascaded.encode.chunks",
            data.data_ptr(), lengths.data_ptr(), out.data_ptr(), sizes.data_ptr(),
            b, c, pmax, width_of(opts.type), int(opts.type), opts.chunk_num_elements,
            max(1, -(-c // opts.chunk_size)), opts.num_rles, opts.num_deltas, int(opts.use_bp),
        )
        LAUNCHES["encode"] += 1
        return out, sizes


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: CascadedOpts, out_capacity: int):
    """Decode kernel: comp uint8[B, CMAX], comp_sizes int32[B] on one CUDA
    device -> (data uint8[B, out_capacity], out_bytes int32[B], statuses
    int32[B])."""
    with span("decompress.cascaded.decode"):
        dev = _build.check_cuda("tc_cascaded_decode", comp, comp_sizes)
        opts.validate()
        if comp.dtype != torch.uint8 or comp.dim() != 2:
            raise ValueError("comp must be uint8[B, CMAX]")
        w = width_of(opts.type)
        if out_capacity % w:
            raise ValueError("out_capacity must be a multiple of the element width")
        comp = comp.contiguous()
        comp_sizes = comp_sizes.to(torch.int32).contiguous()
        b, cmax = comp.shape
        out = torch.empty(b, out_capacity, dtype=torch.uint8, device=dev)
        out_bytes = torch.empty(b, dtype=torch.int32, device=dev)
        status = torch.empty(b, dtype=torch.int32, device=dev)
        if b == 0:
            return out, out_bytes, status
        _build.launch(
            "tc_cascaded_decode", dev, "cascaded.decode.chunks",
            comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), out_bytes.data_ptr(),
            status.data_ptr(), b, cmax, out_capacity, w, int(opts.type), opts.chunk_num_elements,
            max(1, -(-out_capacity // opts.chunk_size)), opts.num_rles, opts.num_deltas, int(opts.use_bp),
        )
        LAUNCHES["decode"] += 1
        return out, out_bytes, status
