"""Codec options as frozen dataclasses.

PyTorch counterparts of ``tpucomp.core.options.LZ4Opts``, ``SnappyOpts``
and ``CascadedOpts`` (the reference's hipcompBatchedLZ4Opts_t,
hipcompBatchedSnappyOpts_t and hipcompBatchedCascadedOpts_t).  int64 is
native in torch, so the JAX package's 64-bit-mode check has no
counterpart here; every other check keeps its message.
"""

from __future__ import annotations

import dataclasses

from tpucomp_torch.core import sizing
from tpucomp_torch.core.types import DataType, width_of


@dataclasses.dataclass(frozen=True)
class LZ4Opts:
    """LZ4 codec options.

    ``data_type`` sets the match finder's granularity: with a 2- or 4-byte
    type, matches start on element boundaries at element-multiple offsets.
    Streams are valid LZ4 blocks for any setting.
    """

    data_type: DataType = DataType.UCHAR

    def validate(self) -> None:
        if width_of(self.data_type) not in (1, 2, 4):
            raise ValueError("LZ4 data_type must be 1, 2 or 4 bytes wide")


@dataclasses.dataclass(frozen=True)
class SnappyOpts:
    """Snappy codec options (reserved, mirrors the reference's empty struct)."""

    reserved: int = 0


@dataclasses.dataclass(frozen=True)
class CascadedOpts:
    """Cascaded scheme configuration.

    Defaults mirror the reference default {4096, INT, 2 RLEs, 1 delta,
    bitpack on}.  ``chunk_size`` is the internal chunk the scheme processes
    at a time (512..16384 bytes, multiple of the element width); a
    partition (= one batch entry) is split into such chunks.
    """

    chunk_size: int = 4096
    type: DataType = DataType.INT
    num_rles: int = 2
    num_deltas: int = 1
    use_bp: bool = True

    def validate(self) -> None:
        w = width_of(self.type)
        if not (sizing.CASCADED_MIN_CHUNK <= self.chunk_size <= sizing.CASCADED_MAX_CHUNK):
            raise ValueError(
                f"cascaded chunk_size {self.chunk_size} outside "
                f"[{sizing.CASCADED_MIN_CHUNK}, {sizing.CASCADED_MAX_CHUNK}]"
            )
        if self.chunk_size % w != 0:
            raise ValueError("cascaded chunk_size must be a multiple of the element width")
        # Run counts are uint16 and bitpack stores element counts in 16 bits.
        if self.chunk_size // w >= 65536:
            raise ValueError("cascaded chunk must hold < 65536 elements")
        if not (0 <= self.num_rles <= 7):
            raise ValueError("num_rles must be in [0, 7]")
        if not (0 <= self.num_deltas <= 7):
            raise ValueError("num_deltas must be in [0, 7]")
        if 0 < self.num_rles < self.num_deltas:
            # decompression's layer order only inverts compression's
            # (RLE before Delta within each layer) when num_deltas <=
            # num_rles or num_rles == 0
            raise ValueError("num_deltas must be <= num_rles (or num_rles == 0)")

    @property
    def chunk_num_elements(self) -> int:
        return self.chunk_size // width_of(self.type)


def opts_from_fields(fields: dict) -> CascadedOpts:
    """Build CascadedOpts from plain fields (ints and bools), such as
    ``dataclasses.asdict`` of the JAX package's opts with each value cast
    to ``int``."""
    return CascadedOpts(
        chunk_size=int(fields["chunk_size"]),
        type=DataType(int(fields["type"])),
        num_rles=int(fields["num_rles"]),
        num_deltas=int(fields["num_deltas"]),
        use_bp=bool(fields["use_bp"]),
    )
