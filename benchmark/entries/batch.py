"""The low-level batch entry: ``tpucomp_torch.<codec>_codec``.

A caller holds B partitions of C bytes on the card as a ``ChunkBatch``
and calls ``BatchCodec.compress`` / ``.decompress`` on it.  A compress
ends when the compressed sizes are on the host (the caller lays out its
write from them), a decompress when the statuses are (the caller must
check them).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib

import torch

import tpucomp_torch
from tpucomp_torch import ChunkBatch

CHECK_ROWS = 512  # rows compared at a time


def port_opts(config: dict):
    """The configuration's ``opts`` as the port's options object, the class
    that ``port.opts`` names: a field whose default is an enum takes the
    member of that name, any other the value as its default's type."""
    cls = getattr(tpucomp_torch, config["port"]["opts"])
    kinds = {f.name: type(f.default) for f in dataclasses.fields(cls)}
    return cls(**{k: kinds[k][v] if issubclass(kinds[k], enum.Enum) else kinds[k](v)
                  for k, v in config["opts"].items()})


def reference(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['codec']}")


def rows_wrong(comp: torch.Tensor, sizes: torch.Tensor, ref: torch.Tensor, ref_sizes: torch.Tensor) -> int:
    """Rows whose size differs from the reference's, or whose bytes up to
    it do."""
    bad = sizes.to(ref_sizes.device) != ref_sizes
    if comp.shape[1] < ref.shape[1]:
        bad |= ref_sizes > comp.shape[1]
    w = min(comp.shape[1], ref.shape[1])
    t = torch.arange(w, device=ref.device)[None, :]
    for i in range(0, ref.shape[0], CHECK_ROWS):
        r = slice(i, i + CHECK_ROWS)
        diff = (comp[r, :w].to(ref.device) != ref[r, :w]) & (t < ref_sizes[r, None].to(torch.int64))
        bad[r] |= diff.any(1)
    return int(bad.sum())


def restored_rows_wrong(data: torch.Tensor, lengths: torch.Tensor, statuses: torch.Tensor,
                        ref: torch.Tensor, ref_lengths: torch.Tensor) -> int:
    """Rows restored with other bytes, another length or a failed status."""
    bad = (lengths.to(ref.device) != ref_lengths) | (statuses.to(ref.device) != int(tpucomp_torch.Status.SUCCESS))
    if data.shape != ref.shape:
        return int(ref.shape[0])
    for i in range(0, ref.shape[0], CHECK_ROWS):
        r = slice(i, i + CHECK_ROWS)
        bad[r] |= (data[r].to(ref.device) != ref[r]).any(1)
    return int(bad.sum())


class Entry:
    read_names = {"compress": "read_sizes", "decompress": "read_statuses"}

    def __init__(self, config: dict, traffic: dict, data: torch.Tensor):
        self.config = config
        self.codec = getattr(tpucomp_torch, config["port"]["codec"])
        self.opts = port_opts(config)
        self.c = int(config["partition_bytes"])
        b = data.numel() // self.c
        self.batch = ChunkBatch(data.view(b, self.c), torch.full((b,), self.c, dtype=torch.int32, device=data.device))
        self.bytes_per_call = b * self.c
        self.streams = None
        self.calls = {"compress": self._compress, "decompress": self._decompress}

    def _compress(self):
        return self.codec.compress(self.batch, self.opts)

    def _decompress(self):
        return self.codec.decompress(self.streams, self.c, self.opts)

    def read(self, phase: str, out) -> bool:
        """The host read that ends a call; True when the result is usable."""
        if phase == "compress":
            return bool((out.lengths.cpu() > 0).all())
        return not bool(out[1].cpu().any())

    def prepare(self, compressed) -> None:
        """Set-up: the streams the decompress phase restores."""
        self.streams = compressed

    def stream_bytes(self) -> int:
        return int(self.streams.lengths.to(torch.int64).sum())

    def io_bytes(self, phase: str) -> tuple[int, int]:
        """(bytes a call must read, bytes it must write): the data by its
        lengths and the streams by their sizes, with the int32 arrays."""
        b = self.batch.batch_size
        if phase == "compress":
            return self.bytes_per_call + 4 * b, self.stream_bytes() + 4 * b
        return self.stream_bytes() + 4 * b, self.bytes_per_call + 8 * b

    def bypass(self, phase: str):
        return None  # the batch API is the lowest public entry

    def release(self) -> None:
        self.batch = self.streams = None

    def control(self) -> None:
        """Put the reference's control in the program's place for compress."""
        ref = reference(self.config)

        def control_compress():
            comp, sizes = ref.compress(self.batch.data, self.batch.lengths, self.config["opts"], **ref.CONTROL)
            return ChunkBatch(comp, sizes)

        self.calls["compress"] = control_compress

    def check(self, retained: dict, ref_data: torch.Tensor) -> dict:
        """Every retained output against the plain reference on the
        benchmark's own copy of the input."""
        b = ref_data.numel() // self.c
        data = ref_data.view(b, self.c)
        lengths = torch.full((b,), self.c, dtype=torch.int32, device=data.device)
        ref = reference(self.config)
        ref_comp, ref_sizes = ref.compress(data, lengths, self.config["opts"])
        comp_wrong = sum(rows_wrong(o.data, o.lengths, ref_comp, ref_sizes) for o in retained["compress"])
        del ref_comp
        decomp_wrong = sum(restored_rows_wrong(o[0].data, o[0].lengths, o[1], data, lengths)
                           for o in retained["decompress"])
        return {"comp_rows_wrong": comp_wrong, "decomp_rows_wrong": decomp_wrong}
