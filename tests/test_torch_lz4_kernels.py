"""The LZ4 CUDA kernels (match table, encode, decode): held to their plain
versions on the card, and their routing checked on the CPU.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a fixture
decides, not the import).  On the card::

    python -m pytest tests/test_torch_lz4_kernels.py -m cuda --noconftest -o addopts="" -q

Tolerance: none.  Every output is an integer tensor and must be equal.
"""

import numpy as np
import pytest
import torch

from oracles.lz4_oracle import lz4_compress_oracle
from tpucomp_torch.codecs import lz4 as tl
from tpucomp_torch.codecs import lz77
from tpucomp_torch.core.options import LZ4Opts
from tpucomp_torch.core.types import DataType
from tpucomp_torch.kernels import lz4_cuda as kl
from tpucomp_torch.kernels import lz77_cuda

import torch_lz4_cases as cases

ENCODE_CASES = ["rows-1", "rows-2", "rows-4", "typed-2", "typed-4", "merged64k",
                "C64", "C4096", "C65536", "C1048576", "C16M"]


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
    if name.startswith("rows"):
        return cases.compress_rows(rng)[1:] + (int(name[-1]),)
    if name.startswith("typed"):
        return cases.typed_rows(rng) + (int(name[-1]),)
    if name == "merged64k":
        return cases.merged_table_row() + (1,)
    if name == "C16M":
        return cases.big_chunk(rng) + (1,)
    return dict((k, (a, n)) for k, a, n in cases.kernel_sizes(rng))[name] + (1,)


def _decode_both(comp, sizes, cap):
    got = kl.decompress(comp, sizes, cap)
    _equal(got, tl._decompress_plain(comp, sizes, cap))
    return got


def _table(d, n, stride):
    return lz77_cuda.match_table(d, n, stride, lz77.MAX_OFFSET, lz77.LAST_VALID_MATCH)


def _compress_both(d, n, stride):
    """The table kernel held to ``lz77.match_table``, then the encode kernel
    on that table held to the plain encoder."""
    table = _table(d, n, stride)
    assert torch.equal(table, lz77.match_table(d, n, stride))
    comp, sizes = kl.encode(d, n, table)
    _equal((comp, sizes), tl._compress_plain(d, n, stride))
    return comp, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCODE_CASES)
def test_lz4_kernels_equal_plain(cuda, name):
    arr, lens, stride = _encode_case(name)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = _compress_both(d, n, stride)
    if stride == 1 and arr.shape[1] <= 65536:
        for i in range(len(lens)):
            assert comp[i, : int(sizes[i])].cpu().numpy().tobytes() == \
                lz4_compress_oracle(arr[i, : lens[i]].tobytes()), (name, i)
    c = arr.shape[1]
    out, olen, status = _decode_both(comp, sizes, c)
    assert torch.equal(out, d * (torch.arange(c, device=cuda)[None, :] < n[:, None]))
    assert torch.equal(olen, n) and not status.any()
    _decode_both(comp, sizes, max(1, c // 4))  # undersized output
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lz4_decode_garbage_equal_plain(cuda, seed):
    comps, sizes = cases.garbage_batch(np.random.default_rng(100 + seed), 16, cases.C + 600)
    _decode_both(torch.from_numpy(comps).to(cuda), torch.from_numpy(sizes).to(cuda), cases.C)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lz4_decode_fixtures_and_corrupt_streams_equal_plain(cuda):
    names, comp, sizes, outs = cases.golden_streams()
    cap = max(map(len, outs))
    out, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    for i, want in enumerate(outs):
        assert int(status[i]) == 0 and out[i, : int(olen[i])].cpu().numpy().tobytes() == want, names[i]
    arr, lens = cases.batch([np.arange(4000, dtype=np.uint8) % 7], 4096)
    ref = lz4_compress_oracle(arr[0, : lens[0]].tobytes())
    row = np.zeros(cases.lz4_max(4096), np.uint8)
    row[: len(ref)] = np.frombuffer(ref, np.uint8)
    _, rows, szs = cases.corrupt_streams(row, len(ref))
    _decode_both(torch.from_numpy(rows).to(cuda), torch.from_numpy(szs).to(cuda), 4096)
    comp, sizes, cap = cases.s_max_overrun()
    out, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    assert int(status[0]) == 0 and int(olen[0]) == 8013
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4))
def test_lz4_decode_window_cases_equal_plain(cuda, case):
    """The new design's regimes: matches in their own parse batch, periods
    1-15, streams longer than the staged window with reads past the row's
    end, an odd CMAX."""
    rows = cases.window_rows(np.random.default_rng(7))
    label, comp, sizes, cap = cases.window_cases(rows, lz4_compress_oracle)[case]
    _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(40))
def test_lz4_random_batches_equal_plain(cuda, seed):
    """Random rows, lengths, capacities and strides; the kernels' streams,
    then damaged copies of them, decoded at random output capacities."""
    rng = np.random.default_rng(1000 + seed)
    arr, lens, stride = cases.random_batch(rng)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = _compress_both(d, n, stride)
    c = arr.shape[1]
    out, olen, status = _decode_both(comp, sizes, c)
    assert torch.equal(olen, n) and not status.any()
    bad, bad_sizes = cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
    for cap in (c, int(rng.integers(1, c + 64))):
        _decode_both(torch.from_numpy(bad).to(cuda), torch.from_numpy(bad_sizes).to(cuda), cap)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6))
def test_lz4_table_rows_equal_plain(cuda, case):
    """The match-table kernel's edges: nearest occurrences exactly 65535 and
    65536 back, at its 64K segment seams, in 70 KB and 16 MB rows; windows
    that agree in three of four bytes; all-distinct windows; rows of n in
    {0, 3, 4, 12, 13, 14}; a capacity of 37.  Strides 1, 2 and 4."""
    label, arr, lens = cases.table_rows(np.random.default_rng(21))[case]
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    for stride in (1, 2, 4):
        _compress_both(d, n, stride)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lz4_cuda_compress_finds_its_own_candidates(cuda, monkeypatch):
    """A CUDA compress runs the match-table kernel, never the torch
    pre-pass (``lz77.candidate_tables`` and its sort)."""
    arr, lens = cases.compress_rows(np.random.default_rng(5))[1:]
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    want = tl._compress_plain(d, n)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA compress ran the torch pre-pass")

    for name in ("candidate_tables", "nearest_prev_occurrence"):
        monkeypatch.setattr(lz77, name, refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    _equal(tl.compress(d, n), want)


@pytest.mark.cuda
def test_lz4_launch_counters_move(cuda):
    before, table_before = dict(kl.LAUNCHES), lz77_cuda.LAUNCHES["table"]
    data = (torch.arange(4 * 8192, device=cuda) % 251).to(torch.uint8).view(4, 8192)
    lengths = torch.full((4,), 8192, dtype=torch.int32, device=cuda)
    comp, sizes = tl.compress(data, lengths, LZ4Opts(data_type=DataType.UINT))
    out, nbytes, status = tl.decompress(comp, sizes, out_capacity=8192)
    assert kl.LAUNCHES == {k: before[k] + 1 for k in ("encode", "decode")}
    assert lz77_cuda.LAUNCHES["table"] == table_before + 1
    assert torch.equal(out, data) and not status.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 64), (2, 0), (0, 0)])
def test_lz_table_counts_only_launches(cuda, shape):
    """The table wrapper counts a launch only where it launches its kernel:
    an empty batch or an empty row launches none.  An empty batch
    compresses with no launch at all."""
    table_before = lz77_cuda.LAUNCHES["table"]
    data = torch.zeros(shape, dtype=torch.uint8, device=cuda)
    lengths = torch.zeros(shape[0], dtype=torch.int32, device=cuda)
    table = _table(data, lengths, 1)
    assert table.shape == shape and lz77_cuda.LAUNCHES["table"] == table_before
    if shape[0] == 0 and shape[1] > 0:
        before = dict(kl.LAUNCHES)
        comp, sizes = tl.compress(data, lengths)
        assert lz77_cuda.LAUNCHES["table"] == table_before and kl.LAUNCHES == before
        _equal((comp, sizes), tl._compress_plain(data, lengths))


@pytest.mark.parametrize("shape", [(2, 0), (0, 0)])
def test_lz4_compress_refuses_zero_width_rows_on_the_cpu(shape):
    """A batch of rows with no columns raises one ValueError before routing."""
    data = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="C > 0"):
        tl.compress(data, torch.zeros(shape[0], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 0), (0, 0)])
def test_lz4_compress_refuses_zero_width_rows_on_the_card(cuda, shape):
    """The same ValueError on the card, with no kernel launched."""
    before, table_before = dict(kl.LAUNCHES), lz77_cuda.LAUNCHES["table"]
    data = torch.zeros(shape, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="C > 0"):
        tl.compress(data, torch.zeros(shape[0], dtype=torch.int32, device=cuda))
    assert kl.LAUNCHES == before and lz77_cuda.LAUNCHES["table"] == table_before


def test_cpu_tensors_never_touch_the_lz4_kernels():
    before, table_before = dict(kl.LAUNCHES), lz77_cuda.LAUNCHES["table"]
    arr, lens = cases.batch([np.arange(3000, dtype=np.uint8) % 13, b"abc" * 100], 4096)
    comp, sizes = tl.compress(torch.from_numpy(arr), torch.from_numpy(lens))
    out, nbytes, status = tl.decompress(comp, sizes, out_capacity=4096)
    assert not status.any() and torch.equal(nbytes, torch.from_numpy(lens))
    assert kl.LAUNCHES == before and lz77_cuda.LAUNCHES["table"] == table_before


def test_lz4_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CUDA tensors reach the wrappers' launch; there is no fallback to
    the plain version (a tensor on neither CPU nor CUDA raises through the
    public entry point too)."""
    data = torch.zeros(2, 64, dtype=torch.uint8)
    lengths = torch.full((2,), 64, dtype=torch.int32)
    table = torch.zeros(2, 64, dtype=torch.uint16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _table(data, lengths, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kl.encode(data, lengths, table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kl.decompress(data, lengths, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.decompress(data.to("meta"), lengths.to("meta"), out_capacity=64)
    with pytest.raises(ValueError, match="uint8"):
        tl.compress(data.to(torch.int32), lengths)
    with pytest.raises(ValueError, match="1, 2 or 4 bytes"):
        tl.compress(data, lengths, LZ4Opts(data_type=DataType.LONGLONG))
