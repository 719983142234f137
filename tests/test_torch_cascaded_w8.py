"""8-byte Cascaded elements (LONGLONG / ULONGLONG) held to tpucomp.

On the CPU, tpucomp's `_compress_xla` / `_decompress_xla` (x64 on,
tests/conftest.py) fix the w = 8 streams; the port's plain version must
give the same bytes, and its CUDA kernels are held to the plain version on
the card (tests/test_torch_kernels.py, chip_smoke.py phase 3).  Tolerance:
none, every output is an integer tensor.

Also pins the w = 8 sizing: `partition_output_max` keeps a 4-byte slack
word for w = 8, but a w = 8 partition never needs it.  Its size is a
multiple of 8 (chunk totals are rounded to 8, the fallback is 8 + the
input's whole elements) and so is the cap, 8 + roundUp4(input bytes), so
the trailing pad of the last chunk can never cross the cap: every size
stays within `compress_get_max_output_chunk_size` of its length.
"""

import numpy as np
import pytest
import torch

import tpucomp
from tpucomp.codecs import cascaded as jcc

import tpucomp_torch
from tpucomp_torch.codecs import cascaded as tcc
from tpucomp_torch.core.options import opts_from_fields

import torch_cases
from torch_reference import (assert_decode_equal, capacity, jax_compress, jax_decompress, jax_opts,
                             port_compress, port_decompress)

W8 = torch_cases.w8_cases()
W8_TYPES = (torch_cases.LONGLONG, torch_cases.ULONGLONG)


@pytest.mark.parametrize("label,fields,arr,lens", W8, ids=[c[0] for c in W8])
def test_w8_profiles_identical(label, fields, arr, lens):
    """Rows, sizes, and the decode of the streams as written, damaged,
    into an undersized output and with other options: all equal to
    tpucomp; every partition round-trips."""
    ref_comp, ref_sizes = jax_compress(fields, arr, lens)
    comp, sizes = port_compress(fields, arr, lens)
    np.testing.assert_array_equal(sizes, ref_sizes)
    np.testing.assert_array_equal(comp, ref_comp)
    cap = capacity(fields, arr)
    got = port_decompress(fields, comp, sizes, cap)
    assert_decode_equal(got, jax_decompress(fields, comp, sizes, cap), label)
    for i, n in enumerate(lens):
        assert got[2][i] == 0 and got[1][i] == n // 8 * 8
        np.testing.assert_array_equal(got[0][i, : n // 8 * 8], arr[i, : n // 8 * 8])
    damaged = torch_cases.damage(np.random.default_rng(6), comp, sizes)
    other = {**fields, "type": W8_TYPES[fields["type"] == torch_cases.LONGLONG]}
    for f, rows, szs, c in ((fields, *damaged, cap), (fields, comp, sizes, cap // 4 // 8 * 8),
                            (other, comp, sizes, cap)):
        assert_decode_equal(port_decompress(f, rows, szs, c), jax_decompress(f, rows, szs, c), label)


SIZING_SETS = ((4096, 2, 1, True), (512, 7, 7, True), (16384, 0, 1, False), (8192, 1, 0, True))
# every option set for the 8-byte types; one each for the narrower types,
# which hold the bound that core/sizing.py gives every width
SIZING_OPTS = ([dict(type=t, chunk_size=cs, num_rles=nr, num_deltas=nd, use_bp=bp)
                for t in W8_TYPES for cs, nr, nd, bp in SIZING_SETS]
               + [dict(type=t, chunk_size=cs, num_rles=nr, num_deltas=nd, use_bp=bp)
                  for t, (cs, nr, nd, bp) in zip((torch_cases.CHAR, torch_cases.UCHAR, torch_cases.SHORT,
                                                   torch_cases.USHORT, torch_cases.INT, torch_cases.UINT),
                                                  SIZING_SETS * 2)])


@pytest.mark.parametrize("fields", SIZING_OPTS, ids=lambda f: "-".join(str(v) for v in f.values()))
def test_w8_sizing_agrees_between_the_packages(fields):
    o, jo = opts_from_fields(fields), jax_opts(fields)
    assert tcc.chunk_metadata_size(o) == jcc.chunk_metadata_size(jo)
    assert tcc.chunk_output_max(o) == jcc.chunk_output_max(jo)
    for c in [1, 7, 8, 12, 4096, 10004, 65536, 65540, 1 << 20]:
        assert tcc.partition_output_max(c, o) == jcc.partition_output_max(c, jo), c
        assert (tpucomp_torch.cascaded_codec.compress_get_max_output_chunk_size(c, o)
                == tpucomp.cascaded_codec.compress_get_max_output_chunk_size(c, jo)), c
        cap = tpucomp_torch.cascaded_codec.compress_get_max_output_chunk_size(c, o)
        if torch_cases.WIDTH[fields["type"]] == 8:
            # the slack word: PMAX is 4 bytes above the cap, rounded to 8
            assert tcc.partition_output_max(c, o) == (cap + 4 + 7) // 8 * 8
        else:
            assert tcc.partition_output_max(c, o) == cap


def _within_the_cap(fields, arr, lens):
    """The port's rows and sizes (equal to tpucomp's by the tests above and
    tests/test_torch_cascaded*.py): every size a multiple of 8, within the
    cap of its length, and zeros from it to PMAX."""
    o = opts_from_fields(fields)
    comp, sizes = tcc.compress(torch.from_numpy(arr), torch.from_numpy(lens), o)
    pmax = tcc.partition_output_max(arr.shape[1], o)
    assert comp.shape == (arr.shape[0], pmax)
    for i, n in enumerate(lens):
        size = int(sizes[i])
        assert size % 8 == 0 and size <= tpucomp_torch.cascaded_codec.compress_get_max_output_chunk_size(int(n))
        assert not comp[i, size:].any()
    return comp, sizes


W8_MATRIX = [c for c in (torch_cases.compress_cases() + torch_cases.wide_cases() + torch_cases.fuzz_cases(0, 48)
                         + torch_cases.fuzz_cases(7, 3) + W8)
             if c[1]["type"] in W8_TYPES]


def test_no_w8_case_writes_past_the_cap():
    """Every w = 8 case of the matrix, the wide, fuzz and profile cases."""
    assert len(W8_MATRIX) >= 15
    for label, fields, arr, lens in W8_MATRIX:
        _within_the_cap(fields, arr, lens)


@pytest.mark.parametrize("type_", W8_TYPES)
def test_a_seeded_search_finds_no_partition_in_the_slack_word(type_):
    """1024 rows of 8 KB (two 4 KB chunks) of runs whose last k elements
    are random int64s, k from 900 to 1023, so the sizes sweep across the
    fallback (at k ~ 970): tpucomp and the port agree, every size stays
    within the cap, and the search reaches it (non-fallback partitions
    exactly at the cap)."""
    rng = np.random.default_rng(11)
    b, c, n = 1024, 8192, 1024
    cols = np.repeat(rng.integers(-20, 20, n * b), rng.integers(1, 8, n * b))[: n * b].reshape(b, n)
    k = rng.integers(900, n, b)
    cols = np.where(np.arange(n) >= n - k[:, None], rng.integers(-2**62, 2**62, (b, n)), cols)
    arr = cols.astype(np.int64).view(np.uint8).reshape(b, c)
    lens = (c - rng.integers(0, 64, b)).astype(np.int32)
    fields = torch_cases.opts(type=type_)
    comp, sizes = _within_the_cap(fields, arr, lens)
    ref_comp, ref_sizes = jax_compress(fields, arr, lens)
    np.testing.assert_array_equal(sizes.numpy(), ref_sizes)
    np.testing.assert_array_equal(comp.numpy(), ref_comp)
    layered = comp[:, :3].numpy().any(1)
    at_cap = sizes.numpy() == 8 + lens // 8 * 8
    assert (~layered).any() and (layered & at_cap).any()
