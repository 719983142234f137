"""The format-generic batch-API conformance suite (tests/test_batch_api.py)
through the port's low-level codecs on the CPU.

The same payloads (tests/test_batch_api.py's generator and seed, copied
into tests/torch_batch_cases.py so that chip_smoke.py phase 20 can run the
matrix on the card without jax): the batch-size matrix with zero temp
sizes, the worst-case bound, ``get_decompress_size`` and exact round
trips; compressed bytes equal to tpucomp's; crash safety on garbage.  The
reference matrix's rows of 1025 and 10025 chunks are marked ``slow``, as
tpucomp marks its 1025 row; phase 20 runs every size on the card.
"""

import numpy as np
import pytest
import torch

import tpucomp
import test_batch_api

from tpucomp_torch import ChunkBatch, pack_chunks, unpack_chunks
from tpucomp_torch.core.types import Status
from tpucomp_torch.lowlevel.cascaded import CODEC as CASCADED
from tpucomp_torch.lowlevel.lz4 import CODEC as LZ4
from tpucomp_torch.lowlevel.snappy import CODEC as SNAPPY

import torch_batch_cases as cases

CODECS = {"lz4": LZ4, "snappy": SNAPPY, "cascaded": CASCADED}
CAPACITY = cases.CAPACITY
SIZES = [pytest.param(n, marks=pytest.mark.slow) if n > 127 else n for n in cases.BATCH_SIZES]


def test_payloads_are_the_jax_suites():
    for name in CODECS:
        for n in (1, 11, 127):
            assert cases.payloads(np.random.default_rng(0), name, n) == \
                test_batch_api._payloads(np.random.default_rng(0), name, n), (name, n)
    assert cases.CAPACITY == test_batch_api.CAPACITY


@pytest.mark.parametrize("name", list(CODECS))
@pytest.mark.parametrize("batch_size", SIZES)
def test_roundtrip_matrix(rng, name, batch_size):
    codec = CODECS[name]
    payloads = cases.payloads(rng, name, batch_size)
    batch = pack_chunks(payloads, capacity=CAPACITY, device="cpu")

    assert codec.compress_get_temp_size(batch_size, CAPACITY) == 0
    assert codec.decompress_get_temp_size(batch_size, CAPACITY) == 0
    bound = codec.compress_get_max_output_chunk_size(CAPACITY)

    comp = codec.compress(batch)
    assert comp.data.device.type == "cpu" and comp.batch_size == batch_size
    assert bool((comp.lengths <= bound).all())

    # the size query must give the original lengths
    np.testing.assert_array_equal(codec.get_decompress_size(comp).numpy(), [len(p) for p in payloads])

    out, statuses = codec.decompress(comp, CAPACITY)
    assert bool((statuses == int(Status.SUCCESS)).all())
    got = unpack_chunks(out)
    for i, p in enumerate(payloads):
        assert got[i] == p, f"{name} chunk {i}"


@pytest.mark.parametrize("name", list(CODECS))
@pytest.mark.parametrize("batch_size", [1, 11])
def test_compressed_bytes_equal_tpucomp(rng, name, batch_size):
    """Rows and sizes of the port's compress equal tpucomp's low-level
    codec's (its XLA path on the CPU) on the matrix's payloads."""
    payloads = cases.payloads(rng, name, batch_size)
    ours = CODECS[name].compress(pack_chunks(payloads, capacity=CAPACITY, device="cpu"))
    ref = test_batch_api.CODECS[name].compress(tpucomp.pack_chunks(payloads, capacity=CAPACITY))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))


@pytest.mark.parametrize("name", list(CODECS))
def test_crash_safety_on_garbage(rng, name):
    """Garbage input yields statuses, never a crash; lengths are 0 wherever
    decode failed."""
    garbage, sizes = cases.garbage(rng)
    out, statuses = CODECS[name].decompress(ChunkBatch(torch.from_numpy(garbage), torch.from_numpy(sizes)), CAPACITY)
    statuses = statuses.numpy()
    assert statuses.shape == (cases.GARBAGE_ROWS,)
    assert set(np.unique(statuses)) <= {int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS)}
    assert (out.lengths.numpy()[statuses != int(Status.SUCCESS)] == 0).all()


@pytest.mark.parametrize("name", list(CODECS))
def test_incompressible_stays_within_bound(rng, name):
    codec = CODECS[name]
    payloads = [rng.integers(0, 256, CAPACITY, dtype=np.uint8).tobytes() for _ in range(4)]
    comp = codec.compress(pack_chunks(payloads, capacity=CAPACITY, device="cpu"))
    assert bool((comp.lengths <= codec.compress_get_max_output_chunk_size(CAPACITY)).all())
    out, statuses = codec.decompress(comp, CAPACITY)
    assert bool((statuses == int(Status.SUCCESS)).all())
    assert unpack_chunks(out) == payloads
