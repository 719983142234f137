"""The plain match table of the port's LZ encoders (tpucomp_torch.codecs.lz77.
match_table) equals what the JAX package's pre-pass gives, on the CPU.

``match_table`` is the plain version of the card's match-table kernel
(csrc/lz_match_table.cu): the distance to the exact nearest previous
occurrence of each position's 4-byte window, within each format's limits,
0 for none.  It is held to ``tpucomp.codecs.lz77.nearest_prev_occurrence``
(the pre-pass of the JAX package's Pallas encoders) with the same limits
applied in numpy: LZ4 (window 65535, last candidate at n - 13, strides 1,
2 and 4) and Snappy (32768, n - 4).  Inputs are numpy rows from a seed:
the profiles, window-edge rows of 70 KB, rows whose windows agree in three
of four bytes, rows of n in {0, 3, 4, 5, 12, 13, 14}, and the 64 KB rows
aimed at the card kernel's grouping path (``torch_lz4_cases.group_rows``),
whose aim is checked here too.

Tolerance: none.  The tables are integer arrays and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucomp.codecs import lz77 as jlz77

from tpucomp_torch.codecs import lz77

import torch_lz4_cases as cases

FORMATS = {"lz4": (65535, 13), "snappy": (32768, 4)}
ROWS = ["profiles", "window edge lz4", "window edge snappy", "collisions", "tiny",
        "one bucket at stride 4", "one bucket at stride 2", "frequent window in its bucket"]
GROUP_ROWS = [label for label, _, _ in cases.group_rows(np.random.default_rng(23))]


def _rows(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "profiles":
        return cases.batch(list(cases.profiles(rng).values()), cases.C)
    if name == "window edge lz4":
        return cases.window_edge_row(rng, 70000, 65535)
    if name == "window edge snappy":
        return cases.window_edge_row(rng, 70000, 32768)
    if name == "collisions":
        return cases.collision_row(rng, 70001)
    if name in GROUP_ROWS:
        return dict((k, (a, n)) for k, a, n in cases.group_rows(np.random.default_rng(23)))[name]
    return cases.batch([rng.integers(0, 3, n).astype(np.uint8) for n in (0, 3, 4, 5, 12, 13, 14)], 14)


def _reference(arr, lens, stride, max_offset, end_margin):
    """The JAX package's nearest previous occurrence, row by row, with the
    limits applied in numpy."""
    out = np.zeros(arr.shape, np.int64)
    i = np.arange(arr.shape[1])
    for b in range(len(lens)):
        j = np.asarray(jlz77.nearest_prev_occurrence(jnp.asarray(arr[b]), int(lens[b]), stride)).astype(np.int64)
        keep = (j >= 0) & (i - j <= max_offset) & (i <= int(lens[b]) - end_margin)
        out[b] = np.where(keep, i - j, 0)
    return out


@pytest.mark.parametrize("fmt,stride", [("lz4", 1), ("lz4", 2), ("lz4", 4), ("snappy", 1)])
@pytest.mark.parametrize("name", ROWS)
def test_match_table_equals_tpucomp(name, fmt, stride):
    arr, lens = _rows(name)
    max_offset, end_margin = FORMATS[fmt]
    got = lz77.match_table(torch.from_numpy(arr), torch.from_numpy(lens), stride, max_offset, end_margin)
    assert got.dtype == torch.uint16 and tuple(got.shape) == arr.shape
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), _reference(arr, lens, stride, max_offset, end_margin))


def test_match_table_holds_the_window_edges():
    """The planted copies at exactly the window's distance are candidates;
    those one byte further back are not."""
    for fmt, (max_offset, end_margin) in FORMATS.items():
        arr, lens = _rows(f"window edge {fmt}")
        got = lz77.match_table(torch.from_numpy(arr), torch.from_numpy(lens), 1, max_offset, end_margin)
        got = got.to(torch.int64).numpy()[0]
        assert (got == max_offset).any(), fmt
        assert not (got > max_offset).any(), fmt


def _bucket_sizes(row, n, stride):
    r = row[:n].astype(np.uint32)
    keys = (r[:-3] | r[1:-2] << 8 | r[2:-1] << 16 | r[3:] << 24)[::stride]
    return keys, np.bincount(cases.group_buckets(keys).astype(np.int64), minlength=1 << cases.GROUP_HASH_BITS)


@pytest.mark.parametrize("name", GROUP_ROWS)
def test_group_rows_reach_their_paths(name):
    """Each row of ``group_rows`` reaches the part of the grouping path it
    is named for: one bucket at its stride; a frequent window among
    distinct ones of its bucket, in a bucket a warp sorts (up to 512
    positions) and in two the CTA does (with up to 4,096 others beside the
    frequent window); every position large on zeros, none on distinct
    windows; and the 64 KB switch."""
    arr, lens = _rows(name)
    if name.startswith("one bucket"):
        stride = int(name[-1])
        keys, sizes = _bucket_sizes(arr[0], int(lens[0]), stride)
        assert sizes[0] == keys.size and len(np.unique(keys)) > keys.size * 0.9
    elif name == "frequent window in its bucket":  # a warp's sort, the CTA's bitmap with a few or many others
        for row, n, lo, hi, others in zip(arr, lens, (33, 513, 4097), (512, 4096, 1 << 16), (100, 300, 2000)):
            keys, sizes = _bucket_sizes(row, int(n), 4)
            in0 = keys[cases.group_buckets(keys) == 0]
            _, counts = np.unique(in0, return_counts=True)
            assert lo <= sizes[0] <= hi and counts.max() > in0.size // 2 and in0.size - counts.max() > others
    elif name == "clashing windows":  # equal hash bits 3 .. 18 (and bucket), different windows
        for row, n in zip(arr, lens):
            keys = _bucket_sizes(row, int(n), 4)[0]
            u = np.unique(keys)
            mid = (u.astype(np.uint64) * cases.GROUP_HASH_MUL & 0xFFFFFFFF) >> 3
            _, counts = np.unique(mid, return_counts=True)
            assert (counts > 1).sum() >= 1
    elif name == "zeros 64 KB":
        assert cases.group_counts(arr, lens, 1) == (65533, 65533)
    elif name == "distinct windows 64 KB":
        assert cases.group_counts(arr, lens, 1) == (65533, 0)
    elif name.startswith("mixed"):
        assert arr.shape[1] == cases.GROUP_MAX_ROW + name.endswith("537 B")
        assert (cases.group_counts(arr, lens, 1)[0] > 0) == (arr.shape[1] <= cases.GROUP_MAX_ROW)
    else:  # the window edge and the collisions at 64 KB
        assert arr.shape[1] == cases.GROUP_MAX_ROW and cases.group_counts(arr, lens, 1)[0] == 65533
