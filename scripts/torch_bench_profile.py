#!/usr/bin/env python3
"""One torch.profiler window over each bench cell's calls on the card.

    python3 scripts/torch_bench_profile.py

For every cell of ``tpucomp_torch.bench`` (``bench.CELLS``: Cascaded on
the mixed corpus, seed 0, and on the run-heavy columns, seed 2; LZ4 and
Snappy on mixed rotated by seed 1): the bench's own 256 MB batch
(``bench.cell_batch``) through the calls the bench times, one compress and
one decompress, first three times on the host clock without the profiler,
then once under ``torch.profiler``.  Prints, per cell, the step's wall
ms, the device's busy ms (every kernel and copy), its idle share of the
wall and the largest kernels, with the card's name and power limit, as
one JSON line.  Whatever the whole calls do on the host between kernels
(Python, host reads of sizes) shows as idle.  Run it in a process of its
own: chip_smoke.py phase 21 does.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from tpucomp_torch import bench
from tpucomp_torch.utils.profiling import device_work


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("torch_bench_profile.py profiles the card and found none")
    dev = torch.device("cuda")
    result = {"cells": {}, "device": bench.device_info(dev)}
    for cell, (codec, kind, seed) in bench.CELLS.items():
        batch = bench.cell_batch(cell, device=dev)
        compress, decompress = bench.codec_calls(codec)

        def step():
            decompress(*compress(batch.data, batch.lengths))

        step()  # the kernels build and load before the window
        wall_ms, _, work = device_work(step)
        busy = sum(work.values())
        result["cells"][cell] = {"corpus": kind, "seed": seed, "bytes": batch.data.numel(), "wall_ms": wall_ms,
                                 "busy_ms": busy, "idle": max(0.0, 1 - busy / wall_ms) if work else None,
                                 "largest": dict(sorted(work.items(), key=lambda kv: -kv[1])[:5])}
        del batch
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
