"""The port's LZ4 codec (tpucomp_torch.codecs.lz4 / lz77) equals tpucomp on
the CPU.

The same numpy inputs go through both packages (tests/torch_lz4_cases.py).
tpucomp has two LZ4 encoders that emit different bytes: its XLA path
clamps parses to 4 KB blocks and caps matches, its Pallas kernel is the
uncapped greedy parse and equals the sequential oracle.  The port's
encoder computes what the kernel computes, so compress is held to
``tpucomp.kernels.lz_pallas.compress`` (interpret mode, as
tests/test_lz_pallas.py runs it) and to the oracle; decompress is held to
``tpucomp.codecs.lz4.decompress`` (the XLA path, the default on a CPU).

Tolerance: none.  Every output is an integer array and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp
from oracles.lz4_oracle import lz4_compress_oracle
from tpucomp.codecs import lz4 as jl
from tpucomp.codecs import lz77 as jlz77
from tpucomp.kernels import lz_pallas

import tpucomp_torch
from tpucomp_torch.codecs import lz4 as tl
from tpucomp_torch.codecs import lz77
from tpucomp_torch.core.options import LZ4Opts
from tpucomp_torch.core.types import DataType
from tpucomp_torch.utils import permute

import torch_lz4_cases as cases

C = cases.C
CMAX = cases.lz4_max(C)
STRIDE_TYPE = {1: None, 2: LZ4Opts(DataType.USHORT), 4: LZ4Opts(DataType.UINT)}


def _port_compress(arr, lens, stride=1):
    comp, sizes = tl.compress(torch.from_numpy(arr), torch.from_numpy(lens), STRIDE_TYPE[stride])
    return comp.numpy(), sizes.numpy()


def _port_decompress(comp, sizes, cap):
    return [x.numpy() for x in tl.decompress(torch.from_numpy(comp), torch.from_numpy(sizes), out_capacity=cap)]


def _jax_decompress(comp, sizes, cap):
    return [np.asarray(x) for x in jl.decompress(jnp.asarray(comp), jnp.asarray(sizes), out_capacity=cap)]


def _assert_decode_equal(got, want, label=""):
    for name, g, w in zip(("data", "lengths", "status"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.fixture(scope="module")
def rows():
    return cases.compress_rows(np.random.default_rng(7))


@pytest.fixture(scope="module")
def port_streams(rows):
    return {s: _port_compress(rows[1], rows[2], s) for s in (1, 2, 4)}


# ---------------------------------------------------------------------------
# primitives


def test_ffill_and_fill_from_markers_equal_tpucomp():
    from tpucomp.utils import permute as jperm

    rng = np.random.default_rng(3)
    vals = rng.integers(-50, 50, (3, 40)).astype(np.int32)
    src = rng.random((3, 40)) < 0.2
    want = np.stack([np.asarray(jperm.ffill(jnp.asarray(v), jnp.asarray(s))) for v, s in zip(vals, src)])
    np.testing.assert_array_equal(permute.ffill(torch.from_numpy(vals), torch.from_numpy(src)).numpy(), want)
    starts = np.sort(rng.choice(60, (3, 8), replace=False), axis=1).astype(np.int32)
    valid = rng.random((3, 8)) < 0.7
    params = [rng.integers(0, 1000, (3, 8)).astype(np.int32) for _ in range(2)]
    got = permute.fill_from_markers(torch.from_numpy(starts), torch.from_numpy(valid),
                                    [torch.from_numpy(p) for p in params], 50)
    for b in range(3):
        ref = jperm.fill_from_markers(jnp.asarray(starts[b]), jnp.asarray(valid[b]),
                                      [jnp.asarray(p[b]) for p in params], 50)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_nearest_prev_occurrence_and_match_lengths_equal_tpucomp(rows, stride):
    _, arr, lens = rows
    arr, lens = arr[:10], lens[:10]  # the profiles
    n = torch.from_numpy(lens)
    j = lz77.nearest_prev_occurrence(torch.from_numpy(arr), n, stride)
    mlen, dist, cand = lz77.match_lengths(torch.from_numpy(arr), n, j)
    for b in range(len(lens)):
        jj = jlz77.nearest_prev_occurrence(jnp.asarray(arr[b]), int(lens[b]), stride)
        np.testing.assert_array_equal(j[b].numpy(), np.asarray(jj), err_msg=f"row {b}")
        ref = jlz77.match_lengths(jnp.asarray(arr[b]), int(lens[b]), jj, lz77.MAX_OFFSET)
        for g, r in zip((mlen, dist, cand), ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r), err_msg=f"row {b}")


# ---------------------------------------------------------------------------
# compression


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_compress_equals_pallas_kernel(rows, port_streams, stride):
    names, arr, lens = rows
    comp, sizes = port_streams[stride]
    ref_comp, ref_sizes = lz_pallas.compress(jnp.asarray(arr), jnp.asarray(lens), stride=stride,
                                             interpret=True)
    np.testing.assert_array_equal(sizes, np.asarray(ref_sizes))
    np.testing.assert_array_equal(comp, np.asarray(ref_comp))
    assert comp.shape == (len(lens), CMAX) and sizes[names.index("small0")] == 0


def test_compress_equals_uncapped_oracle(rows, port_streams):
    names, arr, lens = rows
    comp, sizes = port_streams[1]
    for i, name in enumerate(names):
        assert comp[i, : sizes[i]].tobytes() == lz4_compress_oracle(arr[i, : lens[i]].tobytes()), name
        assert not comp[i, sizes[i]:].any(), name


def test_compress_typed_data_equals_pallas_kernel():
    arr, lens = cases.typed_rows(np.random.default_rng(11))
    for stride in (2, 4):
        comp, sizes = _port_compress(arr, lens, stride)
        ref = lz_pallas.compress(jnp.asarray(arr), jnp.asarray(lens), stride=stride, interpret=True)
        np.testing.assert_array_equal(sizes, np.asarray(ref[1]))
        np.testing.assert_array_equal(comp, np.asarray(ref[0]))


def test_compress_merged_table_boundary_equals_oracle():
    """tests/test_lz4.py::test_merged_table_boundary_matches at 64 KB: the
    port keeps positions and distances in two int32 tables, so positions
    >= 32768 and distances near 65535 stay exact."""
    arr, lens = cases.merged_table_row()
    comp, sizes = _port_compress(arr, lens)
    assert comp[0, : sizes[0]].tobytes() == lz4_compress_oracle(arr[0].tobytes())


def test_compress_clamps_lengths_to_the_row():
    arr, lens = cases.batch([b"abcd" * 16, b"xyz" * 10], 64)
    clamped = _port_compress(arr, np.array([-5, 64], np.int32))
    np.testing.assert_array_equal(clamped[1], [0, len(lz4_compress_oracle(arr[1].tobytes()))])


# ---------------------------------------------------------------------------
# decompression


def test_decompress_equals_tpucomp_on_every_producer(rows, port_streams):
    """The port's, the XLA path's and the oracle's streams decode to the
    original bytes through both packages, with equal results."""
    names, arr, lens = rows
    xla = [np.asarray(x) for x in jl.compress(jnp.asarray(arr), jnp.asarray(lens))]
    oracle = cases.oracle_streams(arr, lens, CMAX)
    for label, (comp, sizes) in (("port", port_streams[1]), ("port-stride4", port_streams[4]),
                                 ("xla", xla), ("oracle", oracle)):
        got = _port_decompress(comp, sizes, C)
        _assert_decode_equal(got, _jax_decompress(comp, sizes, C), label)
        assert not got[2].any(), label
        np.testing.assert_array_equal(got[1], lens, err_msg=label)
        for i in range(len(lens)):
            np.testing.assert_array_equal(got[0][i, : lens[i]], arr[i, : lens[i]], err_msg=f"{label} {names[i]}")


def test_decompress_golden_fixtures_equal_tpucomp():
    names, comp, sizes, outs = cases.golden_streams()
    cap = max(map(len, outs))
    got = _port_decompress(comp, sizes, cap)
    _assert_decode_equal(got, _jax_decompress(comp, sizes, cap), "golden")
    for i, want in enumerate(outs):
        assert got[2][i] == 0 and got[0][i, : got[1][i]].tobytes() == want, names[i]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompress_garbage_equals_tpucomp(seed):
    comps, sizes = cases.garbage_batch(np.random.default_rng(100 + seed), 8, C + 600)
    _assert_decode_equal(_port_decompress(comps, sizes, C), _jax_decompress(comps, sizes, C), f"seed {seed}")


def test_decompress_corrupt_and_undersized_equal_tpucomp(port_streams):
    comp, sizes = port_streams[1]
    labels, rows, szs = cases.corrupt_streams(comp[0], int(sizes[0]))
    got = _port_decompress(rows, szs, C)
    _assert_decode_equal(got, _jax_decompress(rows, szs, C), "corrupt")
    assert got[2][labels.index("zero_size")] == 0 and got[2][labels.index("negative_size")] == 12
    for cap in (256, 1000):
        got = _port_decompress(comp, sizes, cap)
        _assert_decode_equal(got, _jax_decompress(comp, sizes, cap), f"cap {cap}")
        assert got[2].any()


def test_decompress_past_the_sequence_bound_equals_tpucomp():
    comp, sizes, cap = cases.s_max_overrun()
    got = _port_decompress(comp, sizes, cap)
    _assert_decode_equal(got, _jax_decompress(comp, sizes, cap), "s_max overrun")
    assert got[2][0] == 0 and got[1][0] == 8013


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_equal_tpucomp(seed):
    """Random rows (tests/torch_lz4_cases.py::random_row) through both
    encoders, then damaged copies of the streams through both decoders."""
    rng = np.random.default_rng(2000 + seed)
    arr, lens = cases.batch([cases.random_row(rng, int(rng.integers(0, C + 1))) for _ in range(4)], C)
    stride = (1, 2, 4)[seed]
    comp, sizes = _port_compress(arr, lens, stride)
    ref = lz_pallas.compress(jnp.asarray(arr), jnp.asarray(lens), stride=stride, interpret=True)
    np.testing.assert_array_equal(sizes, np.asarray(ref[1]))
    np.testing.assert_array_equal(comp, np.asarray(ref[0]))
    bad, bad_sizes = cases.damage(rng, comp, sizes)
    for cap in (C, 1000):
        _assert_decode_equal(_port_decompress(bad, bad_sizes, cap), _jax_decompress(bad, bad_sizes, cap),
                             f"seed {seed} cap {cap}")


def test_long_lsic_runs_decode_where_the_xla_path_cuts_them():
    """A match of 140,000 bytes needs an LSIC run of 549 bytes.  The port
    decodes it as the format says; tpucomp's XLA path packs the run's byte
    count into 9 bits and rejects the stream (a known reference quirk)."""
    raw = b"A" * 140000
    arr, lens = cases.batch([raw], len(raw))
    comp, sizes = _port_compress(arr, lens)
    assert comp[0, : sizes[0]].tobytes() == lz4_compress_oracle(raw)
    data, n, status = _port_decompress(comp, sizes, len(raw))
    assert status[0] == 0 and n[0] == len(raw) and data[0].tobytes() == raw
    assert _jax_decompress(comp, sizes, len(raw))[2][0] == 12


def test_get_decompress_size_equals_tpucomp(rows, port_streams):
    comp, sizes = port_streams[1]
    comps, gsizes = cases.garbage_batch(np.random.default_rng(9), 8, CMAX)
    for cm, sz in ((comp, sizes), (comps, gsizes)):
        for cap in (None, 300):
            kw = {} if cap is None else {"out_capacity": cap}
            got = tl.get_decompress_size(torch.from_numpy(cm), torch.from_numpy(sz), **kw).numpy()
            np.testing.assert_array_equal(got, np.asarray(jl.get_decompress_size(jnp.asarray(cm), jnp.asarray(sz), **kw)))
    np.testing.assert_array_equal(tl.get_decompress_size(torch.from_numpy(comp), torch.from_numpy(sizes)).numpy(),
                                  rows[2])


# ---------------------------------------------------------------------------
# the slice end to end


def test_lz4_codec_round_trip_through_pack_chunks(rng):
    """pack_chunks -> lz4_codec.compress -> decompress -> unpack_chunks, and
    the codec's host API equal to tpucomp's."""
    chunks = [cases.profiles(rng, 3000)["runs"].tobytes(), rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
              b"", b"0123456789" * 700]
    batch = tpucomp_torch.pack_chunks(chunks, 8192, device="cpu")
    codec, ref_codec = tpucomp_torch.lz4_codec, tpucomp.lz4_codec
    comp = codec.compress(batch)
    out, status = codec.decompress(comp, batch.capacity)
    assert tpucomp_torch.unpack_chunks(out) == chunks and not status.any()
    ref_out, ref_status = ref_codec.decompress(
        tpucomp.ChunkBatch(jnp.asarray(comp.data.numpy()), jnp.asarray(comp.lengths.numpy())), batch.capacity)
    assert tpucomp.unpack_chunks(ref_out) == chunks and not np.asarray(ref_status).any()
    np.testing.assert_array_equal(codec.get_decompress_size(comp).numpy(), [len(c) for c in chunks])
    assert codec.name == ref_codec.name == "lz4"
    assert codec.default_opts == LZ4Opts() and int(codec.default_opts.data_type) == int(ref_codec.default_opts.data_type)
    for n in (0, 1, 4096, 65536, 1 << 24):
        assert codec.compress_get_max_output_chunk_size(n) == ref_codec.compress_get_max_output_chunk_size(n)
        assert codec.compress_get_temp_size(8, n) == ref_codec.compress_get_temp_size(8, n) == 0
        assert codec.decompress_get_temp_size(8, n) == ref_codec.decompress_get_temp_size(8, n) == 0
