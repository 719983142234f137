"""The low-level batch entry with the host read a caller of many small
partitions makes: the sizes or statuses copied into a pinned buffer kept
from call to call, then checked by numpy on the calling thread.

The calls, the scratch, the control and the comparison are the batch
entry's.  Only ``read`` differs: ``batch`` copies into pageable memory and
checks with torch, whose intra-op threads stall when the host's other
load takes their cores, which over 65,536 partitions a call sets the
rate's spread rather than the port does.
"""

from __future__ import annotations

import torch

from benchmark.entries import batch


class Entry(batch.Entry):
    def __init__(self, config: dict, traffic: dict, data: torch.Tensor):
        super().__init__(config, traffic, data)
        pin = data.device.type == "cuda"
        self.host = {phase: torch.empty(self.batch.batch_size, dtype=torch.int32, pin_memory=pin)
                     for phase in self.read_names}

    def read(self, phase: str, out) -> bool:
        """The host read that ends a call; True when the result is usable."""
        src = (out.lengths if phase == "compress" else out[1]).reshape(-1)
        host = self.host[phase][: src.numel()]
        host.copy_(src, non_blocking=True)
        if src.is_cuda:
            torch.cuda.current_stream(src.device).synchronize()
        got = host.numpy()
        if phase == "compress":
            return bool((got > 0).all())
        return not bool(got.any())
