"""Plain reference of a manager's self-describing artifact.

The layout of tpucomp's (and nvCOMP 2.2's) high-level artifacts, written
out from the format and not from the port:

    offset  field
    0       u32 magic (0), u8 major (2), u8 minor (2), u8 format, pad
    8       u64 comp_data_size          16  u64 decomp_data_size
    24      u64 num_chunks              32  u8 include_chunk_starts (1), pad x3
    36      u32 x 2 buffer checksums (reserved, 0)
    44      u8 x 2 per-chunk checksum flags (0), pad x2
    48      u64 uncomp_chunk_size       56  u32 comp_data_offset, pad x4
    64      the format's own header (``reference/<codec>.py``
            ``artifact_header``; its format byte is ``ARTIFACT_FORMAT``)

then, from the next multiple of 8: the chunks' u64 offsets (relative to
the data region), their u64 sizes, two u32 checksum tables (zeros), and
the compressed chunks packed gaplessly in order.
"""

from __future__ import annotations

import importlib
import struct

import numpy as np
import torch

from benchmark.reference import _plain


def build(codec: str, opts: dict, streams: torch.Tensor, sizes: torch.Tensor, decomp_size: int,
          chunk_size: int) -> torch.Tensor:
    """The artifact (uint8, exactly its size) of the chunks' ``streams``
    (uint8[k, W], valid up to ``sizes``) of a ``decomp_size``-byte buffer
    cut into ``chunk_size``-byte chunks."""
    codec_ref = importlib.import_module(f"benchmark.reference.{codec}")
    fmt, spec = codec_ref.ARTIFACT_FORMAT, codec_ref.artifact_header(opts)
    k = streams.shape[0]
    sizes64 = sizes.to(torch.int64).cpu().numpy()
    offsets = np.cumsum(sizes64) - sizes64
    sections = _plain.round_up_to(64 + len(spec), 8)
    data_off = sections + 24 * k
    common = struct.pack("<IBBBxQQQB3xIIBB2xQI4x", 0, 2, 2, fmt, int(sizes64.sum()), decomp_size, k, 1, 0, 0, 0, 0,
                         chunk_size, data_off)
    head = bytearray(data_off)
    head[: 64 + len(spec)] = common + spec
    head[sections : sections + 16 * k] = np.concatenate([offsets, sizes64]).astype("<u8").tobytes()
    keep = torch.arange(streams.shape[1], device=streams.device)[None, :] < sizes.to(torch.int64)[:, None]
    head_t = torch.frombuffer(head, dtype=torch.uint8).to(streams.device)
    return torch.cat([head_t, streams[keep]])
