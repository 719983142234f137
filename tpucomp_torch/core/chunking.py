"""Chunk-batch representation and host-side ragged <-> dense staging.

A batch of B chunks with capacity C bytes is the dense pair::

    ChunkBatch(data: uint8[B, C], lengths: int32[B])

of torch tensors on one device.  Rows are zero past ``lengths[b]`` when
built by ``pack_chunks``.  Batches go to the card (``device="cuda"``)
unless the caller asks for another device; ``device="cpu"`` selects the
codecs' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class ChunkBatch:
    """A batch of independent chunks in dense padded form."""

    data: torch.Tensor      # uint8[B, C]
    lengths: torch.Tensor   # int32[B], valid bytes per row

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @classmethod
    def from_numpy(cls, data: np.ndarray, lengths: np.ndarray, device="cuda") -> "ChunkBatch":
        """Copy numpy (uint8[B, C], int[B]) arrays onto ``device``; the
        batch never shares memory with the arrays."""
        return cls(
            torch.from_numpy(np.array(data, np.uint8, order="C")).to(device),
            torch.from_numpy(np.array(lengths, np.int32, order="C")).to(device),
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(uint8[B, C], int32[B]) numpy copies of the batch."""
        return self.data.cpu().numpy(), self.lengths.cpu().numpy().astype(np.int32)


def pack_chunks(
    chunks: Sequence[bytes | np.ndarray], capacity: int | None = None, device="cuda"
) -> ChunkBatch:
    """Pack byte strings / uint8 arrays into a dense ChunkBatch on ``device``."""
    arrs = [
        np.frombuffer(c, dtype=np.uint8) if isinstance(c, (bytes, bytearray))
        else np.asarray(c, dtype=np.uint8).reshape(-1)
        for c in chunks
    ]
    lengths = np.array([a.size for a in arrs], dtype=np.int32)
    cap = int(capacity if capacity is not None else (lengths.max() if len(arrs) else 0))
    if len(arrs) and lengths.max() > cap:
        raise ValueError(f"chunk of {lengths.max()} bytes exceeds capacity {cap}")
    data = np.zeros((len(arrs), cap), np.uint8)
    for i, a in enumerate(arrs):
        data[i, : a.size] = a
    return ChunkBatch(torch.from_numpy(data).to(device), torch.from_numpy(lengths).to(device))


def unpack_chunks(batch: ChunkBatch) -> List[bytes]:
    """Extract the valid bytes of every row as Python byte strings."""
    data, lengths = batch.to_numpy()
    return [data[i, : min(int(n), data.shape[1])].tobytes() for i, n in enumerate(lengths)]


def split_stream(stream: bytes | np.ndarray, chunk_size: int, device="cuda") -> ChunkBatch:
    """Split one contiguous byte stream into ``chunk_size`` chunks on
    ``device`` (the high-level manager's chunking step); an empty stream
    gives one empty chunk."""
    buf = (np.frombuffer(stream, np.uint8) if isinstance(stream, (bytes, bytearray))
           else np.asarray(stream, np.uint8).reshape(-1))
    n = buf.size
    num_chunks = max(1, -(-n // chunk_size))
    data = np.zeros((num_chunks, chunk_size), np.uint8)
    data.reshape(-1)[:n] = buf
    lengths = np.full((num_chunks,), chunk_size, np.int32)
    lengths[-1] = n - (num_chunks - 1) * chunk_size
    return ChunkBatch(torch.from_numpy(data).to(device), torch.from_numpy(lengths).to(device))


def join_stream(batch: ChunkBatch) -> bytes:
    """Concatenate the valid bytes of every row back into one stream."""
    return b"".join(unpack_chunks(batch))
