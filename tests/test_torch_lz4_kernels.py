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
def test_lz4_decode_one_cta_of_unlike_rows_equal_plain(cuda):
    """Rows as unlike as they get, each walked by its own warp and copied
    by a helper: 2,000 5-byte sequences, one literal run, an empty stream,
    and a row that fails after 12 hand-offs, which comes out all zeros with
    status 12."""
    comp, sizes, cap, bad = cases.handoff_rows(np.random.default_rng(3))
    out, olen, status = _decode_both(torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda), cap)
    assert olen.tolist() == [cap, 3000, 0, 0] and status.tolist() == [0, 0, 0, 12]
    assert not out[bad].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lz4_decode_past_s_max_equal_plain(cuda):
    """A row that ends past the JAX loop's sequence bound, beside rows that
    do not: the warp that ends it continues the last recorded match."""
    comp, sizes, cap = cases.s_max_overrun()
    rows, lens = cases.batch([comp[0], comp[0][:40], b"", comp[0]], comp.shape[1])
    lens[:] = [sizes[0], 40, 0, sizes[0] - 1]
    out, olen, status = _decode_both(torch.from_numpy(rows).to(cuda), torch.from_numpy(lens).to(cuda), cap)
    assert int(status[0]) == 0 and int(olen[0]) == 8013
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lz4_decode_1mb_row(cuda):
    """A 1 MB row of the mixed corpus (tens of thousands of hand-offs and
    many refills of the stream window) decodes to its input; at a capacity
    one byte short it fails whole."""
    from tpucomp_torch.utils.corpus import load_corpus

    c = 1 << 20
    data = torch.from_numpy(np.frombuffer(load_corpus(c), np.uint8).copy()).view(1, c).to(cuda)
    n = torch.full((1,), c, dtype=torch.int32, device=cuda)
    comp, sizes = tl.compress(data, n)
    out, olen, status = kl.decompress(comp, sizes, c)
    assert torch.equal(out, data) and int(olen[0]) == c and not status.any()
    out, olen, status = kl.decompress(comp, sizes, c - 1)
    assert not out.any() and int(olen[0]) == 0 and int(status[0]) == 12


@pytest.mark.cuda
def test_lz4_decode_counts_handoffs_only_while_tracing(cuda):
    """A chunk's own warp counts the ring slots it fills for the warp that
    helps it, a batch of up to 16 sequences a slot and one for the row's
    end where no batch carries it, and the fills that waited on the
    helper, beside the sequences it completed; with tracing off nothing is
    counted.  The launch gives these four rows idle warps, which help from
    about the first batch on, so the slots are at most the rows' batches."""
    from torch.profiler import ProfilerActivity, profile

    from tpucomp_torch.utils import profiling

    comp, sizes, cap, _ = cases.handoff_rows(np.random.default_rng(3))
    comp, sizes = torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda)
    profiling.reset()
    try:
        kl.decompress(comp, sizes, cap)
        torch.cuda.synchronize()
        assert profiling.counters() == {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            kl.decompress(comp, sizes, cap)
            torch.cuda.synchronize()
        counts = profiling.counters()
    finally:
        profiling.reset()
    # rows: 2,001 sequences (126 slots), 1 (1), none (1), 192 before the failing batch (12 + 1)
    assert counts["lz4.decode.sequences"] == 2001 + 1 + 192
    assert 0 < counts["lz4.decode.handoffs"] <= 126 + 1 + 1 + 13
    assert 0 <= counts["lz4.decode.walker_waits"] <= counts["lz4.decode.handoffs"]


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
@pytest.mark.parametrize("case", range(10))
def test_lz4_table_group_rows_equal_plain(cuda, case):
    """The grouping path of the match-table kernel (rows of up to 64 KB):
    rows whose windows at stride 4 or 2 all fall in one bucket of its hash,
    a frequent window among distinct ones of its bucket (sorted by a warp,
    and by the CTA), windows its 32-bit sort values cannot tell apart,
    zeros, all-distinct windows, Snappy's window edge and
    the collision row at 64 KB, and rows of 65,536 and 65,537 bytes, either
    side of the switch to the radix path.  Strides 1, 2 and 4."""
    label, arr, lens = cases.group_rows(np.random.default_rng(23))[case]
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    for stride in (1, 2, 4):
        _compress_both(d, n, stride)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["zeros 64 KB", "distinct windows 64 KB", "mixed 65,536 B",
                                   "frequent window in its bucket", "mixed 65,537 B"])
def test_lz_table_counters_read_grouped_positions(cuda, label):
    """Traced, the table kernel counts the valid positions it grouped and
    those in buckets of more than 32 (its sorts): all of them on zeros, none
    on all-distinct windows, what the rows' buckets hold elsewhere, and
    nothing for rows past 64 KB, which the radix path takes."""
    from torch.profiler import ProfilerActivity, profile

    from tpucomp_torch.utils import profiling

    arr, lens = dict((k, (a, n)) for k, a, n in cases.group_rows(np.random.default_rng(23)))[label]
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    for stride in (1, 4):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            table = _table(d, n, stride)
        counts = profiling.counters()
        profiling.reset()
        assert torch.equal(table, lz77.match_table(d, n, stride))
        positions, large = cases.group_counts(arr, lens, stride)
        assert (counts["lz.table.positions"], counts["lz.table.large_bucket_positions"]) == (positions, large)
        if label == "zeros 64 KB":
            assert large == positions == (len(arr[0]) - 3 + stride - 1) // stride
        elif label == "distinct windows 64 KB":
            assert large == 0 and positions == (len(arr[0]) - 3 + stride - 1) // stride
        elif label == "mixed 65,537 B":
            assert positions == 0
        else:
            assert 0 < large < positions


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
