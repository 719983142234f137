"""Wrappers of the LZ4 codec's hand-written CUDA kernels.

=================  ============================  ======================================================
kernel             source                        replaces (TPU kernel) / plain PyTorch version
=================  ============================  ======================================================
encode             ``csrc/lz4_encode.cu``        ``tpucomp/kernels/lz_pallas.py::_lz4_encode_kernel``
                                                 / ``codecs/lz4.py::_compress_plain``
decode             ``csrc/lz4_decode.cu``        ``tpucomp/kernels/lz_pallas.py::_lz4_decode_kernel``
                                                 / ``codecs/lz4.py::_decompress_plain``
=================  ============================  ======================================================

The wrappers take CUDA tensors only and launch on PyTorch's current
stream; they raise on anything the kernels do not take (a CPU tensor goes
to the plain version through ``codecs.lz4.compress`` / ``decompress``,
never through here).  The encode kernel reads the match table that
``kernels/lz77_cuda.py`` makes with the LZ4 limits; ``codecs.lz4.compress``
launches the two in turn.  Both kernels write every byte of their outputs
(zeros past each row's stream or length), so they are allocated with
``torch.empty``.  ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.sizing import lz4_max_compressed_chunk_size
from tpucomp_torch.kernels import _build

LAUNCHES = {"encode": 0, "decode": 0}


def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the CUDA LZ4 kernels take CUDA tensors, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("all tensors must lie on one device")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"LZ4 {what} kernel launch failed with CUDA error {err}")


def encode(data: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor):
    """Encode kernel: data uint8[B, C], lengths int32[B] in [0, C] and their
    match table with the LZ4 limits and the stride of the matches
    (``lz77_cuda.match_table``), uint16[B, C], on one CUDA device -> (comp
    uint8[B, LZ4MAX], comp_sizes int32[B])."""
    _check(data, lengths, table)
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
    out = torch.empty(b, out_row, dtype=torch.uint8, device=data.device)  # the kernel writes every byte
    sizes = torch.empty(b, dtype=torch.int32, device=data.device)
    if b == 0:
        return out, sizes
    with torch.cuda.device(data.device):
        err = _build.load().tc_lz4_encode(
            data.data_ptr(), lengths.data_ptr(), table.data_ptr(), out.data_ptr(), sizes.data_ptr(),
            b, c, out_row, _stream(data.device),
        )
    _raise_if(err, "encode")
    LAUNCHES["encode"] += 1
    return out, sizes


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, out_capacity: int):
    """Decode kernel: comp uint8[B, CMAX], comp_sizes int32[B] on one CUDA
    device -> (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B])."""
    _check(comp, comp_sizes)
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError("comp must be uint8[B, CMAX] with CMAX >= 1")
    if not 1 <= out_capacity < 2**31:
        raise ValueError("out_capacity must be in [1, 2**31)")
    b, cmax = comp.shape
    if cmax >= 2**30:
        raise ValueError("the decode kernel takes rows below 2**30 bytes")
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(torch.int32).contiguous()
    out = torch.empty(b, out_capacity, dtype=torch.uint8, device=comp.device)  # the kernel writes every byte
    lengths = torch.empty(b, dtype=torch.int32, device=comp.device)
    status = torch.empty(b, dtype=torch.int32, device=comp.device)
    if b == 0:
        return out, lengths, status
    with torch.cuda.device(comp.device):
        err = _build.load().tc_lz4_decode(
            comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), lengths.data_ptr(),
            status.data_ptr(), b, cmax, out_capacity, _stream(comp.device),
        )
    _raise_if(err, "decode")
    LAUNCHES["decode"] += 1
    return out, lengths, status
