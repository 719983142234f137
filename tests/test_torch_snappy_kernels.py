"""The Snappy CUDA kernels (match table, encode, decode): held to their
plain versions on the card, and their routing checked on the CPU.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a fixture
decides, not the import).  On the card::

    python -m pytest tests/test_torch_snappy_kernels.py -m cuda --noconftest -o addopts="" -q

Tolerance: none.  Every output is an integer tensor and must be equal.
"""

import numpy as np
import pytest
import torch

from oracles.snappy_oracle import snappy_compress_oracle
from tpucomp_torch.codecs import lz77
from tpucomp_torch.codecs import snappy as ts
from tpucomp_torch.kernels import lz77_cuda
from tpucomp_torch.kernels import snappy_cuda as ks

import torch_snappy_cases as cases

ENCODE_CASES = ["rows", "window64k", "large128k", "C64", "C4096", "C65536", "C1048576", "C16M"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda:0")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def _encode_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "rows":
        return cases.compress_rows(rng)[1:]
    if name == "window64k":
        return cases.window_row()
    if name == "large128k":
        return cases.large_rows(rng)
    if name == "C16M":
        return cases.big_chunk(rng)
    return dict((k, (a, n)) for k, a, n in cases.kernel_sizes(rng))[name]


def _table(d, n):
    return lz77_cuda.match_table(d, n, 1, ts.MAX_OFFSET, ts.MIN_MATCH)


def _compress_both(d, n):
    """The table kernel held to ``lz77.match_table`` with the Snappy
    limits, then the encode kernel on that table held to the plain
    encoder."""
    table = _table(d, n)
    assert torch.equal(table, lz77.match_table(d, n, 1, ts.MAX_OFFSET, ts.MIN_MATCH))
    comp, sizes = ks.encode(d, n, table)
    _equal((comp, sizes), ts._compress_plain(d, n))
    return comp, sizes


def _decode_both(comp, sizes, cap):
    got = ks.decompress(comp, sizes, cap)
    _equal(got, ts._decompress_plain(comp, sizes, cap))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCODE_CASES)
def test_snappy_kernels_equal_plain(cuda, name):
    arr, lens = _encode_case(name)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = _compress_both(d, n)
    if arr.shape[1] <= 1 << 17:
        for i in range(len(lens)):
            assert comp[i, : int(sizes[i])].cpu().numpy().tobytes() == \
                snappy_compress_oracle(arr[i, : lens[i]].tobytes()), (name, i)
    c = arr.shape[1]
    out, olen, status = _decode_both(comp, sizes, c)
    assert torch.equal(out, d * (torch.arange(c, device=cuda)[None, :] < n[:, None]))
    assert torch.equal(olen, n) and not status.any()
    _decode_both(comp, sizes, max(1, c // 4))  # undersized output
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snappy_decode_garbage_equal_plain(cuda, seed):
    comps, sizes = cases.garbage_batch(np.random.default_rng(100 + seed), 16, cases.C + 600)
    _decode_both(torch.from_numpy(comps).to(cuda), torch.from_numpy(sizes).to(cuda), cases.C)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_snappy_decode_fixtures_and_foreign_streams_equal_plain(cuda):
    names, comp, sizes, outs = cases.golden_streams()
    cap = max(map(len, outs))
    out, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    for i, want in enumerate(outs):
        assert int(status[i]) == 0 and out[i, : int(olen[i])].cpu().numpy().tobytes() == want, names[i]
    labels, comp, sizes, outs = cases.foreign_streams(np.random.default_rng(4))
    out, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), 4096)
    for i, want in enumerate(outs):
        assert int(status[i]) == 0 and out[i, : int(olen[i])].cpu().numpy().tobytes() == want, labels[i]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("group", range(4))
def test_snappy_decode_crafted_streams_equal_plain(cuda, group):
    """Reads past the row end, the s_max bound, int32 wraps, and outputs
    that go back across earlier elements (resolved by start, as the plain
    version and the JAX package do)."""
    labels, comp, sizes = cases.crafted_streams()[group]
    _, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda),
                                   cases.CRAFTED_CAP)
    for i, label in enumerate(labels):
        assert (int(status[i]), int(olen[i])) == cases.CRAFTED_EXPECT[label], label
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_snappy_decode_long_back_row_equal_plain(cuda):
    """1 MB of output whose every 324 bytes go back: the whole row is
    rewritten by start, in time linear in the row."""
    comp, sizes, cap = cases.long_back_row()
    _, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    assert int(status[0]) == 0 and int(olen[0]) == cap
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_snappy_decode_window_cases_equal_plain(cuda, case):
    """The new design's regimes: matches in their own parse batch, periods
    1-15, streams longer than the staged window with reads past the row's
    end, an odd CMAX."""
    label, comp, sizes, cap = cases.window_cases(np.random.default_rng(7))[case]
    _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(40))
def test_snappy_random_batches_equal_plain(cuda, seed):
    """Random rows, lengths and capacities; the kernels' streams, then
    damaged copies of them, decoded at random output capacities."""
    rng = np.random.default_rng(5000 + seed)
    arr, lens = cases.random_batch(rng, 40000)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = _compress_both(d, n)
    c = arr.shape[1]
    out, olen, status = _decode_both(comp, sizes, c)
    assert torch.equal(olen, n) and not status.any()
    bad, bad_sizes = cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
    for cap in (c, int(rng.integers(1, c + 64))):
        _decode_both(torch.from_numpy(bad).to(cuda), torch.from_numpy(bad_sizes).to(cuda), cap)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_snappy_table_rows_equal_plain(cuda, case):
    """The match-table kernel's edges with the Snappy limits: nearest
    occurrences exactly 32768 and 32769 back, at its 64K segment seams, in
    70 KB and 16 MB rows; windows that agree in three of four bytes; rows
    of n in {0, 3, 4, 5}; a capacity of 37."""
    label, arr, lens = cases.table_rows(np.random.default_rng(22))[case]
    _compress_both(torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_snappy_cuda_compress_finds_its_own_candidates(cuda, monkeypatch):
    """A CUDA compress runs the match-table kernel, never the torch
    pre-pass (``lz77.candidate_tables`` and its sort)."""
    arr, lens = cases.compress_rows(np.random.default_rng(5))[1:]
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    want = ts._compress_plain(d, n)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA compress ran the torch pre-pass")

    for name in ("candidate_tables", "nearest_prev_occurrence"):
        monkeypatch.setattr(lz77, name, refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    _equal(ts.compress(d, n), want)


@pytest.mark.cuda
def test_snappy_launch_counters_move(cuda):
    before, table_before = dict(ks.LAUNCHES), lz77_cuda.LAUNCHES["table"]
    data = (torch.arange(4 * 8192, device=cuda) % 251).to(torch.uint8).view(4, 8192)
    lengths = torch.full((4,), 8192, dtype=torch.int32, device=cuda)
    comp, sizes = ts.compress(data, lengths)
    out, nbytes, status = ts.decompress(comp, sizes, out_capacity=8192)
    assert ks.LAUNCHES == {k: before[k] + 1 for k in ("encode", "decode")}
    assert lz77_cuda.LAUNCHES["table"] == table_before + 1
    assert torch.equal(out, data) and not status.any()


def test_cpu_tensors_never_touch_the_snappy_kernels():
    before, table_before = dict(ks.LAUNCHES), lz77_cuda.LAUNCHES["table"]
    arr, lens = cases.batch([np.arange(3000, dtype=np.uint8) % 13, b"abc" * 100, b""], 4096)
    comp, sizes = ts.compress(torch.from_numpy(arr), torch.from_numpy(lens))
    out, nbytes, status = ts.decompress(comp, sizes, out_capacity=4096)
    assert not status.any() and torch.equal(nbytes, torch.from_numpy(lens))
    assert ks.LAUNCHES == before and lz77_cuda.LAUNCHES["table"] == table_before


def test_snappy_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CUDA tensors reach the wrappers' launch; there is no fallback to
    the plain version (a tensor on neither CPU nor CUDA raises through the
    public entry points too)."""
    data = torch.zeros(2, 64, dtype=torch.uint8)
    lengths = torch.full((2,), 64, dtype=torch.int32)
    table = torch.zeros(2, 64, dtype=torch.uint16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _table(data, lengths)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.encode(data, lengths, table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.decompress(data, lengths, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.decompress(data.to("meta"), lengths.to("meta"), out_capacity=64)
    with pytest.raises(ValueError, match="uint8"):
        ts.compress(data.to(torch.int32), lengths)
    with pytest.raises(ValueError, match="out_capacity"):
        ts.decompress(data, lengths, out_capacity=0)
