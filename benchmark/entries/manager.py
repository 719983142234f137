"""The high-level entry: one buffer through a manager, a self-describing
artifact back.

A caller holds one contiguous buffer on the card, compresses it with the
codec's manager (the configuration's ``port.manager``, chunks of the
configuration's partition size) into an artifact, and restores an
artifact with ``create_manager(artifact).decompress(artifact)``.  A
compress ends when the artifact's size is on the host (the manager reads
it itself), a decompress when the chunk statuses are.

The layer's own cost is read against the same chunks through the batch
API (``bypass``), which compresses the same partitions with the same
kernels.
"""

from __future__ import annotations

import torch

import tpucomp_torch
from benchmark.entries import batch as batch_entry
from benchmark.reference import artifact as ref_artifact
from tpucomp_torch import ChunkBatch

class Entry:
    read_names = {"compress": "read_size", "decompress": "read_statuses"}

    def __init__(self, config: dict, traffic: dict, data: torch.Tensor):
        self.config = config
        self.c = int(config["partition_bytes"])
        self.opts = batch_entry.port_opts(config)
        manager = getattr(tpucomp_torch, config["port"]["manager"])
        self.manager = manager(uncomp_chunk_size=self.c, opts=self.opts, device=data.device)
        self.buffer = data
        self.bytes_per_call = data.numel()
        self.artifact = None
        self._bypass_streams = None
        self.calls = {"compress": self._compress, "decompress": self._decompress}

    def _compress(self):
        return self.manager.compress(self.buffer)

    def _decompress(self):
        return tpucomp_torch.create_manager(self.artifact).decompress(self.artifact)

    def read(self, phase: str, out) -> bool:
        if phase == "compress":
            return out[1] > 0  # the manager returns the size as a host int
        return not bool(out[1].cpu().any())

    def prepare(self, compressed) -> None:
        self.artifact = compressed[0][: compressed[1]]

    def stream_bytes(self) -> int:
        return int(self.artifact.numel())

    def _chunks(self) -> ChunkBatch:
        k = self.bytes_per_call // self.c
        return ChunkBatch(self.buffer.view(k, self.c),
                          torch.full((k,), self.c, dtype=torch.int32, device=self.buffer.device))

    def bypass(self, phase: str):
        """The same chunks through the batch API, as (call, read)."""
        codec = getattr(tpucomp_torch, self.config["port"]["codec"])
        chunks = self._chunks()
        if phase == "compress":
            return (lambda: codec.compress(chunks, self.opts)), (lambda out: bool((out.lengths.cpu() > 0).all()))
        if self._bypass_streams is None:
            self._bypass_streams = codec.compress(chunks, self.opts)
        streams = self._bypass_streams
        return (lambda: codec.decompress(streams, self.c, self.opts)), (lambda out: not bool(out[1].cpu().any()))

    def release(self) -> None:
        self.buffer = self.artifact = self._bypass_streams = self.manager = None

    def control(self) -> None:
        """Put the reference's control in the program's place for compress."""
        ref = batch_entry.reference(self.config)

        def control_compress():
            chunks = self._chunks()
            comp, sizes = ref.compress(chunks.data, chunks.lengths, self.config["opts"], **ref.CONTROL)
            art = ref_artifact.build(self.config["codec"], self.config["opts"], comp, sizes, self.bytes_per_call, self.c)
            return art, art.numel()

        self.calls["compress"] = control_compress

    def check(self, retained: dict, ref_data: torch.Tensor) -> dict:
        """Every retained artifact, headers and layout included, against
        the one the plain reference builds, and every restored buffer
        against the benchmark's own copy of the input."""
        k = -(-ref_data.numel() // self.c)
        padded = torch.zeros(k * self.c, dtype=torch.uint8, device=ref_data.device)
        padded[: ref_data.numel()] = ref_data
        lengths = (ref_data.numel() - torch.arange(k, device=ref_data.device) * self.c).clamp(0, self.c)
        ref = batch_entry.reference(self.config)
        comp, sizes = ref.compress(padded.view(k, self.c), lengths.to(torch.int32), self.config["opts"])
        want = ref_artifact.build(self.config["codec"], self.config["opts"], comp, sizes, ref_data.numel(), self.c)
        del comp
        art_wrong = 0
        for art, size in retained["compress"]:
            n = min(size, want.numel(), art.numel())
            art_wrong += abs(size - want.numel()) + int((art[:n].to(want.device) != want[:n]).sum())
        restored_wrong = 0
        for data, statuses in retained["decompress"]:
            if data.numel() != ref_data.numel():
                restored_wrong += k
                continue
            got = torch.zeros_like(padded)
            got[: data.numel()] = data.to(got.device)
            bad = (got.view(k, self.c) != padded.view(k, self.c)).any(1)
            bad |= statuses.to(bad.device) != int(tpucomp_torch.Status.SUCCESS)
            restored_wrong += int(bad.sum())
        return {"artifact_bytes_wrong": art_wrong, "decomp_rows_wrong": restored_wrong}
