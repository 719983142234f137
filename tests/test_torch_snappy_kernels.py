"""The Snappy CUDA kernels: held to their plain versions on the card, and
their routing checked on the CPU.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a fixture
decides, not the import).  On the card::

    python -m pytest tests/test_torch_snappy_kernels.py -m cuda --noconftest -o addopts="" -q

Tolerance: none.  Every output is an integer tensor and must be equal,
except the data of the one stream listed in
``torch_snappy_cases.kernel_data`` (ROADMAP Queue 3), which is held to
its stream-order result.
"""

import numpy as np
import pytest
import torch

from oracles.snappy_oracle import snappy_compress_oracle
from tpucomp_torch.codecs import lz77
from tpucomp_torch.codecs import snappy as ts
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


def _tables(d, n):
    return lz77.candidate_tables(d, n, max_offset=ts.MAX_OFFSET, end_margin=ts.MIN_MATCH)


def _decode_both(comp, sizes, cap):
    got = ks.decompress(comp, sizes, cap)
    _equal(got, ts._decompress_plain(comp, sizes, cap))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCODE_CASES)
def test_snappy_kernels_equal_plain(cuda, name):
    arr, lens = _encode_case(name)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = ks.compress(d, n, *_tables(d, n))
    _equal((comp, sizes), ts._compress_plain(d, n))
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
@pytest.mark.parametrize("group", range(3))
def test_snappy_decode_crafted_streams_equal_plain(cuda, group):
    """Reads past the row end, the s_max bound, int32 wraps; on the one
    divergent stream the data is the stream-order result while lengths
    and statuses equal the plain version's."""
    labels, comp, sizes = cases.crafted_streams()[group]
    comp, sizes = torch.from_numpy(comp).to(cuda), torch.from_numpy(sizes).to(cuda)
    got = ks.decompress(comp, sizes, cases.CRAFTED_CAP)
    want = ts._decompress_plain(comp, sizes, cases.CRAFTED_CAP)
    _equal(got[1:], want[1:])
    special = cases.kernel_data()
    for i, label in enumerate(labels):
        assert (int(got[2][i]), int(got[1][i])) == cases.CRAFTED_EXPECT[label], label
        if label in special:
            assert got[0][i, : int(got[1][i])].cpu().numpy().tobytes() == special[label], label
            assert not got[0][i, int(got[1][i]):].any()
            assert not torch.equal(got[0][i], want[0][i])
        else:
            assert torch.equal(got[0][i], want[0][i]), label
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(40))
def test_snappy_random_batches_equal_plain(cuda, seed):
    """Random rows, lengths and capacities; the kernels' streams, then
    damaged copies of them, decoded at random output capacities."""
    rng = np.random.default_rng(5000 + seed)
    arr, lens = cases.random_batch(rng, 40000)
    d, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = ks.compress(d, n, *_tables(d, n))
    _equal((comp, sizes), ts._compress_plain(d, n))
    c = arr.shape[1]
    out, olen, status = _decode_both(comp, sizes, c)
    assert torch.equal(olen, n) and not status.any()
    bad, bad_sizes = cases.damage(rng, comp.cpu().numpy(), sizes.cpu().numpy())
    for cap in (c, int(rng.integers(1, c + 64))):
        _decode_both(torch.from_numpy(bad).to(cuda), torch.from_numpy(bad_sizes).to(cuda), cap)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_snappy_launch_counters_move(cuda):
    before = dict(ks.LAUNCHES)
    data = (torch.arange(4 * 8192, device=cuda) % 251).to(torch.uint8).view(4, 8192)
    lengths = torch.full((4,), 8192, dtype=torch.int32, device=cuda)
    comp, sizes = ts.compress(data, lengths)
    out, nbytes, status = ts.decompress(comp, sizes, out_capacity=8192)
    assert ks.LAUNCHES == {"encode": before["encode"] + 1, "decode": before["decode"] + 1}
    assert torch.equal(out, data) and not status.any()


def test_cpu_tensors_never_touch_the_snappy_kernels():
    before = dict(ks.LAUNCHES)
    arr, lens = cases.batch([np.arange(3000, dtype=np.uint8) % 13, b"abc" * 100, b""], 4096)
    comp, sizes = ts.compress(torch.from_numpy(arr), torch.from_numpy(lens))
    out, nbytes, status = ts.decompress(comp, sizes, out_capacity=4096)
    assert not status.any() and torch.equal(nbytes, torch.from_numpy(lens))
    assert ks.LAUNCHES == before


def test_snappy_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CUDA tensors reach the wrappers' launch; there is no fallback to
    the plain version (a tensor on neither CPU nor CUDA raises through the
    public entry points too)."""
    data = torch.zeros(2, 64, dtype=torch.uint8)
    lengths = torch.full((2,), 64, dtype=torch.int32)
    tables = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.compress(data, lengths, tables, tables)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.decompress(data, lengths, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.decompress(data.to("meta"), lengths.to("meta"), out_capacity=64)
    with pytest.raises(ValueError, match="uint8"):
        ts.compress(data.to(torch.int32), lengths)
    with pytest.raises(ValueError, match="out_capacity"):
        ts.decompress(data, lengths, out_capacity=0)
