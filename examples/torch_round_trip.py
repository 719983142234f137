"""End-to-end examples of the PyTorch / CUDA port (tpucomp_torch): the
low-level batch API, the Cascaded codec, a high-level manager and
sharding, the counterparts of examples/round_trip.py.

Run: python examples/torch_round_trip.py [--device cuda|cpu]

The work runs on the card (``--device cuda``, the default); ``--device
cpu`` runs the plain PyTorch versions on the host, sharded over
``["cpu"] * 8``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tpucomp_torch import (
    CascadedOpts,
    LZ4Manager,
    cascaded_codec,
    create_manager,
    lz4_codec,
    pack_chunks,
    unpack_chunks,
)


def lowlevel_example(device):
    chunks = [(b"the quick brown fox " * 300)[:4096]] * 16
    batch = pack_chunks(chunks, device=device)
    comp = lz4_codec.compress(batch)
    out, statuses = lz4_codec.decompress(comp, out_capacity=batch.capacity)
    assert unpack_chunks(out) == chunks and not statuses.any()
    total = int(comp.lengths.sum())
    print(f"lz4 low-level: {sum(map(len, chunks))} -> {total} bytes")


def cascaded_example(device):
    cols = np.repeat(np.arange(1000, dtype=np.int32), 16)
    batch = pack_chunks([cols.tobytes()], device=device)
    comp = cascaded_codec.compress(batch, CascadedOpts())
    out, statuses = cascaded_codec.decompress(comp, batch.capacity)
    assert unpack_chunks(out)[0] == cols.tobytes() and not statuses.any()
    print(f"cascaded: {cols.nbytes} -> {int(comp.lengths[0])} bytes")


def manager_example(device):
    payload = (b"self-describing artifact " * 4000)[:80_000]
    mgr = LZ4Manager(uncomp_chunk_size=16384, device=device)
    artifact, size = mgr.compress(payload)
    data, statuses = create_manager(artifact).decompress(artifact)
    assert data.cpu().numpy().tobytes() == payload and not statuses.any()
    print(f"manager: {len(payload)} -> {size} bytes, auto-detected format")


def sharding_example(device):
    from tpucomp_torch.parallel import sharding as sh

    mesh = sh.make_mesh() if device == "cuda" else sh.make_mesh([device] * 8)
    chunks = [bytes(np.random.default_rng(i).integers(0, 8, 2048, dtype=np.uint8)) for i in range(16)]
    batch = pack_chunks(chunks, device=mesh[0])
    comp = sh.sharded_compress(lz4_codec, batch, mesh, gather=True)
    out, statuses = sh.sharded_decompress(lz4_codec, comp, batch.capacity, mesh, gather=True)
    assert unpack_chunks(out) == chunks and not statuses.any()
    print(f"sharded over {len(mesh)} device(s): OK")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = p.parse_args().device
    lowlevel_example(device)
    cascaded_example(device)
    manager_example(device)
    sharding_example(device)
