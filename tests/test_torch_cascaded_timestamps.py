"""The benchmark's int64 timestamp configuration (``benchmark/configs/cascaded-int64.json``)
held to tpucomp and to the benchmark's plain reference, on the CPU at small sizes.

The column is ``benchmark/data/timestamps64.py`` (a frozen copy of the
port's ``timestamps64_corpus``) in 64 KiB partitions under
``CascadedOpts{4096, LONGLONG, 2 RLE, 1 Delta, BitPack}``, its seed
varied by ``benchmark/seed/add_int64.py``.  tpucomp's XLA path
(``_compress_xla``, x64 on, tests/conftest.py) fixes the streams; the
benchmark's reference (``benchmark/reference/cascaded.py``) and the port's
``cascaded_codec`` on the CPU route must give the same bytes and sizes,
the port must restore every byte, the reference's control must differ on
every row, and the seed transform must leave every size as it is.
Tolerance: none, every output is an integer tensor.  On the card, the
64-bit kernels' counters and names are held in tests/test_torch_profiling.py
(a file without JAX).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucomp.codecs import cascaded as jcc

import tpucomp_torch
from benchmark import harness
from benchmark.entries.batch import port_opts
from benchmark.reference import cascaded as ref
from tpucomp_torch.utils import corpus

from torch_reference import jax_opts

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "cascaded-int64.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" / "batch-timestamps.json").read_text())
C = int(CONFIG["partition_bytes"])
ROWS = 4
SEEDS = [1, 7, 2**31 + 12345]


def _data(seed: int | None = None, rows: int = ROWS) -> bytes:
    raw = harness.load_module("data", TRAFFIC["data"]).make(rows * C, int(TRAFFIC["data_seed"]), ROOT, {})
    return raw if seed is None else harness.load_module("seed", CONFIG["seed_transform"]).apply(raw, seed)


def _batch(raw: bytes) -> tuple[torch.Tensor, torch.Tensor]:
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(-1, C)
    return data, torch.full((data.shape[0],), C, dtype=torch.int32)


def _port(data, lengths):
    comp = tpucomp_torch.cascaded_codec.compress(tpucomp_torch.ChunkBatch(data, lengths), port_opts(CONFIG))
    return comp.data, comp.lengths


def _fields() -> dict:
    o = port_opts(CONFIG)
    return dict(chunk_size=o.chunk_size, type=int(o.type), num_rles=o.num_rles, num_deltas=o.num_deltas,
                use_bp=o.use_bp)


def _rows_equal(a, a_sizes, b, b_sizes) -> bool:
    """Equal sizes, and equal bytes up to each size."""
    a, b, a_sizes, b_sizes = (torch.from_numpy(np.array(t)) for t in (a, b, a_sizes, b_sizes))
    if not torch.equal(a_sizes.to(torch.int64), b_sizes.to(torch.int64)):
        return False
    return all(torch.equal(a[i, :n], b[i, :n]) for i, n in enumerate(b_sizes.tolist()))


@pytest.mark.parametrize("total", [8, 4096 + 3, 5 * C + 17])
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_timestamps64_equals_the_port_corpus(seed, total):
    got = harness.load_module("data", "timestamps64").make(total, seed, ROOT, {})
    assert got == corpus.timestamps64_corpus(total, seed)


@pytest.mark.parametrize("seed", [None, SEEDS[-1]])
def test_reference_and_port_give_tpucomps_streams(seed):
    """tpucomp's XLA streams, the reference's and the port's CPU route's:
    the same sizes and bytes; the streams are not raw (Delta and BitPack
    carry the column), and the port restores every byte."""
    data, lengths = _batch(_data(seed))
    want, want_sizes = jcc._compress_xla(jnp.asarray(data.numpy()), jnp.asarray(lengths.numpy()),
                                         jax_opts(_fields()))
    ref_comp, ref_sizes = ref.compress(data, lengths, CONFIG["opts"])
    comp, sizes = _port(data, lengths)
    assert _rows_equal(ref_comp, ref_sizes, want, want_sizes)
    assert _rows_equal(comp, sizes, want, want_sizes)
    assert (comp[:, :3] != 0).all() and (sizes < C // 4).all()
    out, statuses = tpucomp_torch.cascaded_codec.decompress(tpucomp_torch.ChunkBatch(comp, sizes), C,
                                                            port_opts(CONFIG))
    assert torch.equal(out.data, data) and torch.equal(out.lengths, lengths)
    assert (statuses == int(tpucomp_torch.Status.SUCCESS)).all()


def test_the_control_differs_on_every_row():
    data, lengths = _batch(_data(SEEDS[0]))
    comp, sizes = ref.compress(data, lengths, CONFIG["opts"])
    ctl, ctl_sizes = ref.compress(data, lengths, CONFIG["opts"], **ref.CONTROL)
    assert (ctl_sizes != sizes).all()
    assert all(not torch.equal(ctl[i, :n], comp[i, :n]) for i, n in enumerate(sizes.tolist()))


@pytest.mark.parametrize("rows", [2, ROWS])
def test_the_seed_keeps_every_size(rows):
    """add_int64 moves every value by one constant below 2**40: the bytes
    change, every value stays below 2**63, and every stream keeps its size."""
    base = _data(rows=rows)
    _, base_sizes = ref.compress(*_batch(base), CONFIG["opts"])
    for seed in SEEDS:
        raw = _data(seed, rows)
        assert raw != base and len(raw) == len(base)
        k = np.frombuffer(raw, np.uint64) - np.frombuffer(base, np.uint64)
        assert (k == k[0]).all() and 1 <= int(k[0]) < 2**40
        assert int(np.frombuffer(raw, np.uint64).max()) < 2**63
        _, sizes = ref.compress(*_batch(raw), CONFIG["opts"])
        assert torch.equal(sizes, base_sizes)

