"""Data-parallel compression over the devices of one process, with the
PyTorch / CUDA port (tpucomp_torch); the counterpart of
examples/distributed.py.

Chunks are independent, so the batch splits into row blocks, one per
device of a mesh (a list of devices: ``make_mesh()`` is every card);
each device compresses its rows, and the results come back in chunk
order, byte-identical to one compress of the whole batch.

Keep outputs sharded (``gather=False``) between pipeline stages and
gather once at the end: a batch held on one card is copied block by
block to the others, and ``gather=True`` copies every result back
(PERF.md: on four H100s a 256 MB batch on ``cuda:0`` took longer sharded
over four cards than on one).

Run on every card of this machine, or on the host over ``["cpu"] * 8``:
    python examples/torch_distributed.py [--device cuda|cpu]

One process per card (several hosts): tpucomp_torch.parallel.multihost
(initialize -> make_global_batch -> compress_distributed ->
gather_to_host), as in tests/test_torch_multihost.py.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tpucomp_torch import CascadedOpts, cascaded_codec, lz4_codec, pack_chunks
from tpucomp_torch.core.types import Status
from tpucomp_torch.parallel import sharding as sh


def main(device):
    rng = np.random.default_rng(0)
    cap = 4096
    # cascaded is an element-typed scheme (default int32): keep chunk byte
    # lengths element-aligned, as the reference requires (in_bytes % sizeof(T))
    n = rng.integers(64, cap, 64) // 4 * 4
    chunks = [
        np.repeat(rng.integers(0, 9, k), rng.integers(1, 9, k))[:k].astype(np.uint8).tobytes()
        for k in n
    ]
    mesh = sh.make_mesh() if device == "cuda" else sh.make_mesh([device] * 8)
    batch = pack_chunks(chunks, capacity=cap, device=mesh[0])
    print(f"mesh: {len(mesh)} devices ({', '.join(map(str, mesh))})")

    for name, codec, opts in (
        ("lz4", lz4_codec, None),
        ("cascaded", cascaded_codec, CascadedOpts(chunk_size=cap)),
    ):
        comp = sh.sharded_compress(codec, batch, mesh, opts=opts, gather=False)
        # comp stays sharded: each device holds its rows' compressed chunks.
        out, statuses = sh.sharded_decompress(
            codec, comp, cap, mesh, opts=opts, gather=True  # gather once, at the end
        )
        st = statuses.cpu().numpy()
        assert st.shape == (len(chunks),) and (st == int(Status.SUCCESS)).all(), st
        data = out.data.cpu().numpy()
        for i, ch in enumerate(chunks):
            assert data[i, : len(ch)].tobytes() == ch, f"chunk {i}"
        # the shards hold padded rows for an even split: count only the
        # first len(chunks) rows so the ratio reflects the real payload
        comp_bytes = int(comp.gather("cpu").lengths[: len(chunks)].sum())
        ratio = int(batch.lengths.sum()) / max(1, comp_bytes)
        print(f"{name}: {len(chunks)} chunks round-tripped sharded over {len(mesh)} devices, ratio {ratio:.2f}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default: every card) or cpu (['cpu'] * 8)")
    main(p.parse_args().device)
