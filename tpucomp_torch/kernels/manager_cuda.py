"""Wrapper of the managers' batched stream-copy kernel.

=================  ============================  ==========================================================
kernel             source                        replaces / plain PyTorch version
=================  ============================  ==========================================================
pack, unpack       ``csrc/manager_copy.cu``      no TPU kernel: the plain versions' per-byte int64 index
                                                 (``permute.place``'s ``index_put_``, the ``artifact[src]``
                                                 gather) / ``highlevel/manager.py::_assemble_plain``,
                                                 ``_slice_plain``
=================  ============================  ==========================================================

``pack`` writes a manager's whole artifact in one launch (header, tables,
the streams packed gaplessly, zeros past them) after one cumsum of the
sizes; ``unpack`` cuts the streams out of an artifact by its own tables.
The kernel writes every byte of its outputs, so they are allocated with
``torch.empty``.  ``LAUNCHES`` counts the launches of each entry point.
The checks, the launch and its ``.launch`` span are ``kernels/_build.py``'s.

Spans (``utils/profiling.py``): the ``.launch`` is a child of the
manager's ``compress.manager.assemble`` / ``decompress.manager.slice``.
Counters: ``manager.pack.bytes`` and ``manager.unpack.bytes``, the stream
bytes each entry point copied (on a sound artifact, its
``comp_data_size``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpucomp_torch.kernels import _build

LAUNCHES = {"pack": 0, "unpack": 0}
MAX_SECTIONS_OFF = 128  # the static head a launch carries, in bytes


def pack(comp: torch.Tensor, sizes: torch.Tensor, static_head: bytes, *, data_off: int, sections_off: int,
         out_max: int):
    """comp uint8[k, row] and sizes[k] (integers in [0, row]) on one CUDA
    device -> (artifact uint8[out_max], comp_data_size as an int64 tensor of
    one element on the device), the artifact equal to ``_assemble_plain``'s."""
    dev = _build.check_cuda("tc_manager_pack", comp, sizes)
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError("comp must be uint8[k, row]")
    k, row = comp.shape
    if tuple(sizes.shape) != (k,) or sizes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"sizes must be int32[{k}] or int64[{k}]")
    if not 1 <= k < 2**31:
        raise ValueError("the manager kernel takes 1 to 2**31 - 1 chunks")
    if not (len(static_head) <= sections_off <= MAX_SECTIONS_OFF and sections_off % 8 == 0):
        raise ValueError(f"the static head must fit sections_off, a multiple of 8 up to {MAX_SECTIONS_OFF}")
    if data_off != sections_off + 24 * k or out_max < data_off:
        raise ValueError("data_off must follow the offset, size and checksum tables, and out_max it")
    comp = comp.contiguous()
    sizes = sizes.to(torch.int64).contiguous()
    inc = sizes.cumsum(0)
    artifact = torch.empty(out_max, dtype=torch.uint8, device=dev)  # the kernel writes every byte
    head = np.frombuffer(static_head, np.uint8)
    _build.launch(
        "tc_manager_pack", dev, "manager.pack.bytes",
        comp.data_ptr(), sizes.data_ptr(), inc.data_ptr(), artifact.data_ptr(), k, row,
        head.ctypes.data, len(static_head), sections_off, data_off, out_max,
    )
    LAUNCHES["pack"] += 1
    return artifact, inc[-1]


def unpack(artifact: torch.Tensor, num_chunks: int, data_off: int, sections_off: int, max_chunk: int):
    """The artifact's streams by its own tables (uint8[n] on a CUDA device)
    -> (rows uint8[num_chunks, max_chunk], sizes int32[num_chunks]), equal
    to ``_slice_plain``'s, damaged tables included."""
    dev = _build.check_cuda("tc_manager_unpack", artifact)
    if artifact.dtype != torch.uint8 or artifact.dim() != 1:
        raise ValueError("the artifact must be uint8[n]")
    k = int(num_chunks)
    if not 1 <= k < 2**31 or max_chunk < 1:
        raise ValueError("the manager kernel takes 1 to 2**31 - 1 chunks and max_chunk >= 1")
    if sections_off + 16 * k > artifact.numel():
        raise ValueError(f"the artifact ({artifact.numel()} bytes) ends inside its offset and size tables")
    artifact = artifact.contiguous()
    rows = torch.empty(k, max_chunk, dtype=torch.uint8, device=dev)  # the kernel writes every byte
    sizes = torch.empty(k, dtype=torch.int32, device=dev)
    _build.launch(
        "tc_manager_unpack", dev, "manager.unpack.bytes",
        artifact.data_ptr(), rows.data_ptr(), sizes.data_ptr(), artifact.numel(), k, max_chunk,
        sections_off, data_off,
    )
    LAUNCHES["unpack"] += 1
    return rows, sizes
