"""Wrappers of the Cascaded codec's hand-written CUDA kernels.

=================  ==============================  =======================================================
kernel             source                          replaces (TPU kernel) / plain PyTorch version
=================  ==============================  =======================================================
encode             ``csrc/cascaded_encode.cu``     ``tpucomp/kernels/cascaded_pallas.py::_encode_kernel``
                                                   / ``codecs/cascaded.py::_compress_plain``
decode             ``csrc/cascaded_decode.cu``     ``tpucomp/kernels/cascaded_pallas.py::_decode_kernel``
                                                   / ``codecs/cascaded.py::_decompress_plain``
=================  ==============================  =======================================================

The wrappers take CUDA tensors only and launch on PyTorch's current
stream; they raise on anything the kernels do not take (a CPU tensor goes
to the plain version through ``codecs.cascaded.compress`` /
``decompress``, never through here).  Every element type is taken: the
kernels hold widths 1, 2 and 4 in 32-bit units and the 8-byte types
(LONGLONG / ULONGLONG) in 64-bit units, one instantiation each.  Both kernels write every byte of
their outputs (rows up to PMAX or ``out_capacity``, zeros past the data,
and every size and status), so outputs are allocated with ``torch.empty``.
``LAUNCHES`` counts the launches of each kernel.

Spans (``utils/profiling.py``): ``compress.cascaded.encode`` and
``decompress.cascaded.decode``, each with a ``.launch`` child around the
foreign call alone.  Each kernel takes one more argument, the address of
its first counter in the tracer's buffer: ``cascaded.encode.chunks``,
followed by ``.chunks_discarded`` and ``.partitions_raw``, for the encode
kernel, and ``cascaded.decode.chunks``, followed by ``.partitions_raw``,
for the decode kernel.  It is null while tracing is off, and the kernel
then counts nothing.
"""

from __future__ import annotations

import torch

from tpucomp_torch.codecs import cascaded as cc
from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.types import width_of
from tpucomp_torch.kernels import _build
from tpucomp_torch.utils import profiling
from tpucomp_torch.utils.profiling import span

LAUNCHES = {"encode": 0, "decode": 0}


def _check(opts: CascadedOpts, *tensors: torch.Tensor) -> None:
    opts.validate()
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the CUDA cascaded kernels take CUDA tensors, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("all tensors must lie on one device")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"cascaded {what} kernel launch failed with CUDA error {err}")


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: CascadedOpts):
    """Encode kernel: data uint8[B, C], lengths int32[B] on one CUDA device ->
    (comp uint8[B, PMAX], comp_sizes int32[B])."""
    with span("compress.cascaded.encode"):
        _check(opts, data, lengths)
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError("data must be uint8[B, C]")
        data = data.contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        b, c = data.shape
        pmax = cc.partition_output_max(c, opts)
        out = torch.empty(b, pmax, dtype=torch.uint8, device=data.device)
        sizes = torch.empty(b, dtype=torch.int32, device=data.device)
        if b == 0:
            return out, sizes
        with torch.cuda.device(data.device):
            counters = profiling.counter_ptr("cascaded.encode.chunks", data.device)
            lib = _build.load()
            with span(".launch"):
                err = lib.tc_cascaded_encode(
                    data.data_ptr(), lengths.data_ptr(), out.data_ptr(), sizes.data_ptr(),
                    b, c, pmax, width_of(opts.type), int(opts.type), opts.chunk_num_elements,
                    max(1, -(-c // opts.chunk_size)), opts.num_rles, opts.num_deltas, int(opts.use_bp),
                    counters, _stream(data.device),
                )
        _raise_if(err, "encode")
        LAUNCHES["encode"] += 1
        return out, sizes


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: CascadedOpts, out_capacity: int):
    """Decode kernel: comp uint8[B, CMAX], comp_sizes int32[B] on one CUDA
    device -> (data uint8[B, out_capacity], out_bytes int32[B], statuses
    int32[B])."""
    with span("decompress.cascaded.decode"):
        _check(opts, comp, comp_sizes)
        if comp.dtype != torch.uint8 or comp.dim() != 2:
            raise ValueError("comp must be uint8[B, CMAX]")
        w = width_of(opts.type)
        if out_capacity % w:
            raise ValueError("out_capacity must be a multiple of the element width")
        comp = comp.contiguous()
        comp_sizes = comp_sizes.to(torch.int32).contiguous()
        b, cmax = comp.shape
        out = torch.empty(b, out_capacity, dtype=torch.uint8, device=comp.device)
        out_bytes = torch.empty(b, dtype=torch.int32, device=comp.device)
        status = torch.empty(b, dtype=torch.int32, device=comp.device)
        if b == 0:
            return out, out_bytes, status
        with torch.cuda.device(comp.device):
            counters = profiling.counter_ptr("cascaded.decode.chunks", comp.device)
            lib = _build.load()
            with span(".launch"):
                err = lib.tc_cascaded_decode(
                    comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), out_bytes.data_ptr(),
                    status.data_ptr(), b, cmax, out_capacity, w, int(opts.type), opts.chunk_num_elements,
                    max(1, -(-out_capacity // opts.chunk_size)), opts.num_rles, opts.num_deltas,
                    int(opts.use_bp), counters, _stream(comp.device),
                )
        _raise_if(err, "decode")
        LAUNCHES["decode"] += 1
        return out, out_bytes, status
