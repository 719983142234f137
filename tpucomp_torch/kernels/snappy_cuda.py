"""Wrappers of the Snappy codec's hand-written CUDA kernels.

=================  ============================  ==========================================================
kernel             source                        replaces (TPU kernel) / plain PyTorch version
=================  ============================  ==========================================================
encode             ``csrc/snappy_encode.cu``     ``tpucomp/kernels/snappy_pallas.py::_snappy_encode_kernel``
                                                 / ``codecs/snappy.py::_compress_plain``
decode             ``csrc/snappy_decode.cu``     ``tpucomp/kernels/snappy_pallas.py::_snappy_decode_kernel``
                                                 / ``codecs/snappy.py::_decompress_plain``
=================  ============================  ==========================================================

The wrappers take CUDA tensors only and launch on PyTorch's current
stream; they raise on anything the kernels do not take (a CPU tensor goes
to the plain version through ``codecs.snappy.compress`` / ``decompress``,
never through here).  Outputs are allocated with ``torch.zeros``, so bytes
the kernels do not write are zero, as in the plain version.  ``LAUNCHES``
counts the launches of each kernel.
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.sizing import snappy_max_compressed_chunk_size
from tpucomp_torch.kernels import _build

LAUNCHES = {"encode": 0, "decode": 0}


def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the CUDA Snappy kernels take CUDA tensors, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("all tensors must lie on one device")


def _raise_if(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"Snappy {what} kernel launch failed with CUDA error {err}")


def compress(data: torch.Tensor, lengths: torch.Tensor, nmp: torch.Tensor, dist: torch.Tensor):
    """Encode kernel: data uint8[B, C], lengths int32[B] in [0, C] and the
    candidate tables nmp, dist int32[B, C] that ``lz77.candidate_tables``
    made for them with the Snappy limits, on one CUDA device -> (comp
    uint8[B, SNAPPYMAX], comp_sizes int32[B])."""
    _check(data, lengths, nmp, dist)
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[B, C]")
    b, c = data.shape
    if c > 1 << 24:  # a literal header holds lengths of at most 2**24 bytes
        raise ValueError("the Snappy encode kernel takes chunks of at most 16 MB")
    for name, t in (("nmp", nmp), ("dist", dist)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, c):
            raise ValueError(f"{name} must be int32[{b}, {c}]")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32[{b}]")
    data, lengths, nmp, dist = (t.contiguous() for t in (data, lengths, nmp, dist))
    out_row = snappy_max_compressed_chunk_size(c)
    out = torch.zeros(b, out_row, dtype=torch.uint8, device=data.device)
    sizes = torch.zeros(b, dtype=torch.int32, device=data.device)
    if b == 0:
        return out, sizes
    with torch.cuda.device(data.device):
        err = _build.load().tc_snappy_encode(
            data.data_ptr(), lengths.data_ptr(), nmp.data_ptr(), dist.data_ptr(),
            out.data_ptr(), sizes.data_ptr(), b, c, out_row,
            torch.cuda.current_stream(data.device).cuda_stream,
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
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(torch.int32).contiguous()
    out = torch.zeros(b, out_capacity, dtype=torch.uint8, device=comp.device)
    lengths = torch.zeros(b, dtype=torch.int32, device=comp.device)
    status = torch.zeros(b, dtype=torch.int32, device=comp.device)
    if b == 0:
        return out, lengths, status
    with torch.cuda.device(comp.device):
        err = _build.load().tc_snappy_decode(
            comp.data_ptr(), comp_sizes.data_ptr(), out.data_ptr(), lengths.data_ptr(),
            status.data_ptr(), b, cmax, out_capacity,
            torch.cuda.current_stream(comp.device).cuda_stream,
        )
    _raise_if(err, "decode")
    LAUNCHES["decode"] += 1
    return out, lengths, status
