"""The port's Snappy codec (tpucomp_torch.codecs.snappy) equals tpucomp on
the CPU.

The same numpy inputs go through both packages (tests/torch_snappy_cases.py).
tpucomp has two Snappy encoders that emit different bytes: its XLA path
clamps parses to 4 KB blocks and caps matches, its Pallas kernel is the
uncapped greedy parse and equals the sequential oracle.  The port's
encoder computes what the kernel computes, so compress is held to
``tpucomp.kernels.snappy_pallas.compress`` (interpret mode, as
tests/test_snappy_pallas.py runs it) and to the oracle; decompress is held
to ``tpucomp.codecs.snappy.decompress`` (the XLA path, the default on a
CPU), data, lengths and statuses, garbage included.

Tolerance: none.  Every output is an integer array and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp
from oracles.snappy_oracle import snappy_compress_oracle
from tpucomp.codecs import lz77 as jlz77
from tpucomp.codecs import snappy as js
from tpucomp.kernels import snappy_pallas

import tpucomp_torch
from tpucomp_torch.codecs import lz77
from tpucomp_torch.codecs import snappy as ts
from tpucomp_torch.core.options import SnappyOpts

import torch_snappy_cases as cases

C = cases.C
CMAX = cases.CMAX


def _port_compress(arr, lens):
    comp, sizes = ts.compress(torch.from_numpy(arr), torch.from_numpy(lens))
    return comp.numpy(), sizes.numpy()


def _port_decompress(comp, sizes, cap):
    return [x.numpy() for x in ts.decompress(torch.from_numpy(comp), torch.from_numpy(sizes), out_capacity=cap)]


def _jax_decompress(comp, sizes, cap):
    return [np.asarray(x) for x in js.decompress(jnp.asarray(comp), jnp.asarray(sizes), out_capacity=cap)]


def _assert_decode_equal(got, want, label=""):
    for name, g, w in zip(("data", "lengths", "status"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def _assert_oracle(arr, lens, comp, sizes, names):
    for i, name in enumerate(names):
        assert comp[i, : sizes[i]].tobytes() == snappy_compress_oracle(arr[i, : lens[i]].tobytes()), name
        assert not comp[i, sizes[i]:].any(), name


@pytest.fixture(scope="module")
def rows():
    return cases.compress_rows(np.random.default_rng(7))


@pytest.fixture(scope="module")
def port_streams(rows):
    return _port_compress(rows[1], rows[2])


@pytest.fixture(scope="module")
def pallas_streams(rows):
    """The one interpret-mode encode of the module's C = 2048 rows."""
    comp, sizes = snappy_pallas.compress(jnp.asarray(rows[1]), jnp.asarray(rows[2]), interpret=True)
    return np.asarray(comp), np.asarray(sizes)


# ---------------------------------------------------------------------------
# compression


def test_candidate_tables_with_snappy_limits_equal_pallas_tables(rows):
    """lz77.candidate_tables with the window 32768 and the last candidate
    at n - 4 gives the tables snappy_pallas.compress builds (:591-607)."""
    _, arr, lens = rows
    nmp, dist = lz77.candidate_tables(torch.from_numpy(arr), torch.from_numpy(lens),
                                      max_offset=ts.MAX_OFFSET, end_margin=ts.MIN_MATCH)
    i = jnp.arange(C, dtype=jnp.int32)
    for b in range(len(lens)):
        j = jlz77.nearest_prev_occurrence(jnp.asarray(arr[b]), int(lens[b]), 1)
        cand = (j >= 0) & (i - j <= 32768) & (i <= int(lens[b]) - 4)
        want = np.minimum.accumulate(np.where(np.asarray(cand), np.arange(C), lz77.INF)[::-1])[::-1]
        np.testing.assert_array_equal(nmp[b].numpy(), want, err_msg=f"row {b}")
        np.testing.assert_array_equal(dist[b].numpy(), np.asarray(i - j), err_msg=f"row {b}")


def test_compress_equals_pallas_kernel(rows, port_streams, pallas_streams):
    names, arr, lens = rows
    comp, sizes = port_streams
    np.testing.assert_array_equal(sizes, pallas_streams[1])
    np.testing.assert_array_equal(comp, pallas_streams[0])
    assert comp.shape == (len(lens), CMAX)


def test_compress_equals_oracle(rows, port_streams):
    names, arr, lens = rows
    _assert_oracle(arr, lens, *port_streams, names)


def test_empty_chunk_compresses_to_one_byte(rows, port_streams):
    names = rows[0]
    comp, sizes = port_streams
    i = names.index("small0")
    assert sizes[i] == 1 and not comp[i].any()  # varint(0)


def test_compress_window_row_equals_pallas_and_oracle():
    """The 64 KB row: a match at distance exactly 32768, one a byte past
    the window, matches at positions past 32768 (tests/test_snappy.py::
    test_merged_table_boundary_matches)."""
    arr, lens = cases.window_row()
    comp, sizes = _port_compress(arr, lens)
    _assert_oracle(arr, lens, comp, sizes, ["window"])
    ref = snappy_pallas.compress(jnp.asarray(arr), jnp.asarray(lens), interpret=True)
    np.testing.assert_array_equal(comp, np.asarray(ref[0]))


def test_compress_large_rows_equal_oracle(rng):
    """128 KB rows: a literal with the 4-byte header, a long copy2(64) run."""
    arr, lens = cases.large_rows(rng)
    comp, sizes = _port_compress(arr, lens)
    _assert_oracle(arr, lens, comp, sizes, ["literal", "match"])
    assert comp[0, 3] == 62 << 2  # varint(131072) takes 3 bytes


def test_compress_clamps_lengths_to_the_row():
    arr, lens = cases.batch([b"abcd" * 16, b"xyz" * 10], 64)
    _, sizes = _port_compress(arr, np.array([-5, 64], np.int32))
    np.testing.assert_array_equal(sizes, [1, len(snappy_compress_oracle(arr[1].tobytes()))])


# ---------------------------------------------------------------------------
# decompression


def test_decompress_equals_tpucomp_on_every_producer(rows, port_streams):
    """The port's, the XLA path's and the oracle's streams decode to the
    original bytes through both packages, with equal results."""
    names, arr, lens = rows
    xla = [np.asarray(x) for x in js.compress(jnp.asarray(arr), jnp.asarray(lens))]
    oracle = cases.oracle_streams(arr, lens, CMAX)
    for label, (comp, sizes) in (("port", port_streams), ("xla", xla), ("oracle", oracle)):
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


def test_decompress_foreign_streams_equal_tpucomp(rng):
    """Literal tags 60-63, copy1 up to offset 2047, copy4, overlapping
    copies, 1-byte and empty outputs."""
    labels, comp, sizes, outs = cases.foreign_streams(rng)
    got = _port_decompress(comp, sizes, 4096)
    _assert_decode_equal(got, _jax_decompress(comp, sizes, 4096), "foreign")
    for i, want in enumerate(outs):
        assert got[2][i] == 0 and got[0][i, : got[1][i]].tobytes() == want, labels[i]


@pytest.mark.parametrize("group", range(4))
def test_decompress_crafted_streams_equal_tpucomp(group):
    """The JAX decoder's edges (tests/torch_snappy_cases.py::crafted_streams):
    reads wrapping past the row end, the s_max bound, int32 wraps of
    4-byte lengths and offsets (a zero-length literal is accepted; a
    negative one moves the output back across earlier elements), the
    4-byte varint."""
    labels, comp, sizes = cases.crafted_streams()[group]
    got = _port_decompress(comp, sizes, cases.CRAFTED_CAP)
    _assert_decode_equal(got, _jax_decompress(comp, sizes, cases.CRAFTED_CAP), ",".join(labels))
    for i, label in enumerate(labels):
        assert (got[2][i], got[1][i]) == cases.CRAFTED_EXPECT[label], label


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompress_garbage_equals_tpucomp(seed):
    comps, sizes = cases.garbage_batch(np.random.default_rng(100 + seed), 8, C + 600)
    _assert_decode_equal(_port_decompress(comps, sizes, C), _jax_decompress(comps, sizes, C), f"seed {seed}")


def test_decompress_damaged_undersized_and_empty_equal_tpucomp(port_streams):
    """Bit flips, 255-runs, truncated, zero, negative and past-the-row
    sizes; outputs smaller than the data; size 0."""
    comp, sizes = port_streams
    bad, bad_sizes = cases.damage(np.random.default_rng(5), comp, sizes)
    _assert_decode_equal(_port_decompress(bad, bad_sizes, C), _jax_decompress(bad, bad_sizes, C), "damaged")
    for cap in (61, 1000):
        got = _port_decompress(comp, sizes, cap)
        _assert_decode_equal(got, _jax_decompress(comp, sizes, cap), f"cap {cap}")
        assert got[2].any() and not got[2][sizes <= 3].any()
    zero = np.zeros_like(sizes)
    got = _port_decompress(comp, zero, C)
    _assert_decode_equal(got, _jax_decompress(comp, zero, C), "size 0")
    assert (got[2] == 12).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_equal_tpucomp(seed):
    """Random rows (tests/torch_lz4_cases.py::random_row) through the
    port's encoder, held to the oracle (the Pallas kernel's equal), then
    damaged copies of the streams through both decoders."""
    rng = np.random.default_rng(3000 + seed)
    arr, lens = cases.random_batch(rng, 4096)
    comp, sizes = _port_compress(arr, lens)
    _assert_oracle(arr, lens, comp, sizes, range(len(lens)))
    bad, bad_sizes = cases.damage(rng, comp, sizes)
    c = arr.shape[1]
    for cap in (c, 1000):
        _assert_decode_equal(_port_decompress(bad, bad_sizes, cap), _jax_decompress(bad, bad_sizes, cap),
                             f"seed {seed} cap {cap}")


def test_get_decompress_size_equals_tpucomp(rows, port_streams):
    comp, sizes = port_streams
    comps, gsizes = cases.garbage_batch(np.random.default_rng(9), 8, CMAX)
    gsizes[:2] = (0, -4)
    labels, crafted, csizes = cases.crafted_streams()[2]
    for cm, sz in ((comp, sizes), (comps, gsizes), (crafted, csizes)):
        got = ts.get_decompress_size(torch.from_numpy(cm), torch.from_numpy(sz)).numpy()
        np.testing.assert_array_equal(got, np.asarray(js.get_decompress_size(jnp.asarray(cm), jnp.asarray(sz))))
    np.testing.assert_array_equal(ts.get_decompress_size(torch.from_numpy(comp), torch.from_numpy(sizes)).numpy(),
                                  rows[2])


# ---------------------------------------------------------------------------
# the slice end to end


def test_snappy_codec_round_trip_through_pack_chunks(rng):
    """pack_chunks -> snappy_codec.compress -> decompress -> unpack_chunks,
    the streams decoded by tpucomp too, and the codec's host API equal to
    tpucomp's."""
    chunks = [cases.profiles(rng, 3000)["runs"].tobytes(), rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
              b"", b"0123456789" * 700]
    batch = tpucomp_torch.pack_chunks(chunks, 8192, device="cpu")
    codec, ref_codec = tpucomp_torch.snappy_codec, tpucomp.snappy_codec
    comp = codec.compress(batch)
    out, status = codec.decompress(comp, batch.capacity)
    assert tpucomp_torch.unpack_chunks(out) == chunks and not status.any()
    ref_out, ref_status = ref_codec.decompress(
        tpucomp.ChunkBatch(jnp.asarray(comp.data.numpy()), jnp.asarray(comp.lengths.numpy())), batch.capacity)
    assert tpucomp.unpack_chunks(ref_out) == chunks and not np.asarray(ref_status).any()
    np.testing.assert_array_equal(codec.get_decompress_size(comp).numpy(), [len(c) for c in chunks])
    assert codec.name == ref_codec.name == "snappy" and codec.default_opts == SnappyOpts()
    for n in (0, 1, 4096, 65536, 1 << 24):
        assert codec.compress_get_max_output_chunk_size(n) == ref_codec.compress_get_max_output_chunk_size(n)
        assert codec.compress_get_temp_size(8, n) == ref_codec.compress_get_temp_size(8, n) == 0
        assert codec.decompress_get_temp_size(8, n) == ref_codec.decompress_get_temp_size(8, n) == 0


def test_snappy_manager_end_to_end(rng):
    """One buffer through the port's SnappyManager on the CPU, across
    chunks, auto-detected by create_manager, and read by tpucomp's."""
    payload = np.repeat(rng.integers(0, 40, 9000), rng.integers(1, 9, 9000))[:9000].astype(np.uint8).tobytes()
    artifact, size = tpucomp_torch.SnappyManager(uncomp_chunk_size=4096, device="cpu").compress(payload)
    mgr = tpucomp_torch.create_manager(artifact)
    assert isinstance(mgr, tpucomp_torch.SnappyManager) and mgr.device.type == "cpu"
    out, statuses = mgr.decompress(artifact)
    assert out.numpy().tobytes() == payload and not statuses.any() and statuses.shape == (3,)
    ref_out, ref_statuses = tpucomp.create_manager(jnp.asarray(artifact.numpy())).decompress(
        jnp.asarray(artifact.numpy()))
    assert np.asarray(ref_out).tobytes() == payload and not np.asarray(ref_statuses).any()
    assert mgr.get_compressed_output_size(artifact) == size
