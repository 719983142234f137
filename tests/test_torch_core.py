"""tpucomp_torch core and utils held to tpucomp's (exact equality)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import tpucomp
from tpucomp.codecs import cascaded as jcc
from tpucomp.core import options as jopts
from tpucomp.core import sizing as jsizing
from tpucomp.core import types as jtypes

import tpucomp_torch
from tpucomp_torch.codecs import cascaded as tcc
from tpucomp_torch.core import chunking, options, sizing, types
from tpucomp_torch.utils import bits


def to_port(jax_opts):
    return options.opts_from_fields({k: int(v) for k, v in dataclasses.asdict(jax_opts).items()})


def test_enum_values_equal():
    for ours, ref in ((types.DataType, jtypes.DataType), (types.Status, jtypes.Status)):
        assert {m.name: int(m) for m in ours} == {m.name: int(m) for m in ref}
    for dt in jtypes.DataType:
        if dt != jtypes.DataType.BITS:
            assert types.width_of(types.DataType(int(dt))) == jtypes.width_of(dt)
            w = jtypes.width_of(dt)
            assert types.SIGNED_OF_WIDTH[w].itemsize == w


def test_sizing_functions_equal():
    for n in [0, 1, 3, 4, 255, 256, 4095, 4096, 65536, 65537, 16 << 20]:
        for name in ("lz4_max_compressed_chunk_size", "snappy_max_compressed_chunk_size",
                     "cascaded_max_compressed_chunk_size"):
            assert getattr(sizing, name)(n) == getattr(jsizing, name)(n), (name, n)
    for name in ("LZ4_MIN_CHUNK", "LZ4_MAX_CHUNK", "CASCADED_MIN_CHUNK", "CASCADED_MAX_CHUNK",
                 "CASCADED_RECOMMENDED_CHUNK"):
        assert getattr(sizing, name) == getattr(jsizing, name)


SWEEP_OPTS = [
    jopts.CascadedOpts(),
    jopts.CascadedOpts(num_rles=0, num_deltas=0, use_bp=False),
    jopts.CascadedOpts(num_rles=7, num_deltas=7, use_bp=False),
    jopts.CascadedOpts(num_rles=0, num_deltas=3),
    jopts.CascadedOpts(type=jtypes.DataType.UCHAR, chunk_size=512, num_rles=1, num_deltas=0),
    jopts.CascadedOpts(type=jtypes.DataType.SHORT, chunk_size=16384, num_rles=3, num_deltas=2),
    jopts.CascadedOpts(type=jtypes.DataType.USHORT, chunk_size=2048, use_bp=False),
    jopts.CascadedOpts(type=jtypes.DataType.LONGLONG, chunk_size=8192),
    jopts.CascadedOpts(type=jtypes.DataType.ULONGLONG, num_rles=1, num_deltas=1, use_bp=False),
]


def _opts_id(jo):
    return f"{jo.type.name}-c{jo.chunk_size}-r{jo.num_rles}d{jo.num_deltas}{'-bp' if jo.use_bp else ''}"


@pytest.mark.parametrize("jo", SWEEP_OPTS, ids=_opts_id)
def test_cascaded_sizes_equal(jo):
    o = to_port(jo)
    assert tcc.chunk_metadata_size(o) == jcc.chunk_metadata_size(jo)
    assert tcc.chunk_output_max(o) == jcc.chunk_output_max(jo)
    for c in [1, 3, 8, 511, 512, 4096, 10000, 65536, 65539, 1 << 20]:
        assert tcc.partition_output_max(c, o) == jcc.partition_output_max(c, jo), c
    assert tcc._schedule(o) == jcc._schedule(jo)
    assert tcc._inverse_schedule(o) == jcc._inverse_schedule(jo)


VALIDATE_CASES = [
    dict(),
    dict(chunk_size=511),
    dict(chunk_size=16385),
    dict(chunk_size=16384, type=jtypes.DataType.UCHAR),
    dict(chunk_size=513, type=jtypes.DataType.SHORT),
    dict(chunk_size=514, type=jtypes.DataType.SHORT),
    dict(chunk_size=4100, type=jtypes.DataType.LONGLONG),
    dict(num_rles=8),
    dict(num_rles=-1),
    dict(num_deltas=8),
    dict(num_rles=1, num_deltas=2),
    dict(num_rles=0, num_deltas=7),
    dict(num_rles=7, num_deltas=7, use_bp=False),
]


@pytest.mark.parametrize(
    "kw", VALIDATE_CASES, ids=lambda kw: "-".join(f"{k}{int(v)}" for k, v in kw.items()) or "default")
def test_validate_raises_on_the_same_opts(kw):
    jo = jopts.CascadedOpts(**kw)
    o = to_port(jo)
    try:
        jo.validate()
        ref = None
    except ValueError as e:
        ref = str(e)
    if ref is None:
        o.validate()
    else:
        with pytest.raises(ValueError) as exc:
            o.validate()
        assert str(exc.value) == ref
    assert o.chunk_num_elements == jo.chunk_num_elements


def test_opts_from_fields_round_trip():
    for jo in SWEEP_OPTS:
        o = to_port(jo)
        assert {k: int(v) for k, v in dataclasses.asdict(o).items()} == \
            {k: int(v) for k, v in dataclasses.asdict(jo).items()}
        assert isinstance(o.type, types.DataType)


def test_pack_unpack_chunks_equal_tpucomp(rng):
    chunks = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in [0, 1, 7, 100, 64]]
    chunks.append(np.arange(33, dtype=np.uint8))
    for cap in (None, 128):
        ours = chunking.pack_chunks(chunks, cap, device="cpu")
        ref = tpucomp.pack_chunks(chunks, cap)
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
        assert ours.data.dtype == torch.uint8 and ours.lengths.dtype == torch.int32
        assert (ours.batch_size, ours.capacity) == (ref.batch_size, ref.capacity)
        assert chunking.unpack_chunks(ours) == tpucomp.unpack_chunks(ref)
        assert chunking.unpack_chunks(ours) == [c if isinstance(c, bytes) else c.tobytes() for c in chunks]
    with pytest.raises(ValueError):
        chunking.pack_chunks(chunks, 50, device="cpu")


@pytest.mark.parametrize("make", ["pack_chunks", "from_numpy"])
def test_batches_default_to_the_card(make):
    """Without ``device`` a batch asks for the card; on a machine without
    one that is torch's own error, never a silent CPU batch."""
    fn = chunking.pack_chunks if make == "pack_chunks" else chunking.ChunkBatch.from_numpy
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = ([b"abc", b"de"],) if make == "pack_chunks" else (np.zeros((2, 3), np.uint8), [3, 2])
    if torch.cuda.is_available():
        batch = fn(*args)
        assert batch.data.is_cuda and batch.lengths.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(*args)


def test_chunk_batch_numpy_round_trip(rng):
    data = rng.integers(0, 256, (3, 40), dtype=np.uint8)
    lengths = np.array([40, 0, 17], np.int32)
    batch = tpucomp_torch.ChunkBatch.from_numpy(data, lengths, "cpu")
    d, ln = batch.to_numpy()
    data[0] ^= 1  # the batch holds its own copy
    assert int(batch.data[0, 0]) == int(d[0, 0]) != int(data[0, 0])
    data[0] ^= 1
    np.testing.assert_array_equal(d, data)
    np.testing.assert_array_equal(ln, lengths)
    assert ln.dtype == np.int32


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_units_bytes_round_trip(rng, width):
    raw = rng.integers(0, 256, (5, 16 * width), dtype=np.uint8)
    units = bits.bytes_to_units_le(torch.from_numpy(raw), width)
    ref = raw.view(np.dtype(f"<u{width}"))
    got = units.numpy().view(np.uint64) if width == 8 else units.numpy()
    np.testing.assert_array_equal(got, ref.astype(got.dtype))
    np.testing.assert_array_equal(bits.units_to_bytes_le(units, width).numpy(), raw)
    # offsets that are not aligned to the unit width still read correctly
    sliced = torch.from_numpy(raw.reshape(-1))[1 : 1 + 8 * width]
    np.testing.assert_array_equal(
        bits.units_to_bytes_le(bits.bytes_to_units_le(sliced, width), width).numpy(),
        raw.reshape(-1)[1 : 1 + 8 * width],
    )


def test_bit_width_and_shifts():
    vals = [0, 1, 2, 3, 4, 255, 256, 2**31, 2**32 - 1, 2**62, 2**63 - 1, -1, -(2**63)]
    t = torch.tensor(vals, dtype=torch.int64)
    assert bits.bit_width(t).tolist() == [(v % 2**64).bit_length() for v in vals]
    for s in [0, 1, 31, 32, 63, 64, 70]:
        assert bits.shl(t, s).tolist() == [
            ((v % 2**64) << s) % 2**64 - (2**64 if ((v % 2**64) << s) % 2**64 >= 2**63 else 0)
            if s < 64 else 0 for v in vals]
        assert [x % 2**64 for x in bits.shr(t, s).tolist()] == [
            (v % 2**64) >> s if s < 64 else 0 for v in vals]
    assert bits.mask_of_bits(torch.tensor([0, 1, 32, 63, 64, 65])).tolist() == \
        [0, 1, 2**32 - 1, 2**63 - 1, -1, -1]
    for w in (1, 2, 4):
        x = torch.tensor([0, 1, 2 ** (8 * w - 1), 2 ** (8 * w) - 1])
        assert bits.to_signed(x, w).tolist() == [0, 1, -(2 ** (8 * w - 1)), -1]


@pytest.mark.parametrize("name", ["load_corpus", "runheavy_corpus"])
def test_corpus_loaders_equal_the_bench(name):
    """The port's copies of the bench's corpus loaders give the same bytes."""
    import bench
    from tpucomp_torch.utils import corpus

    for total, seed in ((1 << 16, 0), (3 << 20, 5)):
        assert getattr(corpus, name)(total, seed) == getattr(bench, name)(total, seed)


def test_64_bit_corpora_are_the_columns_they_name():
    """runheavy64: the run-heavy runs (4 to 47 equal values, drift of
    -3..3 a run) as int64 at 1.7e15 + 1000 * drift; timestamps64: strictly
    increasing int64 steps of 900 to 1100 from the same base.  Both seeded,
    cut to the byte count asked for."""
    from tpucomp_torch.utils import corpus

    rh = np.frombuffer(corpus.runheavy64_corpus(1 << 20), np.int64)
    assert corpus.runheavy64_corpus(1 << 20) == rh.tobytes() and rh.size == 1 << 17
    starts = np.flatnonzero(np.diff(rh)) + 1
    assert np.diff(starts).min() >= 4  # runs of a drift of 0 join their neighbours
    assert np.abs(np.diff(rh[starts])).max() <= 3000 and ((rh - corpus.BASE64) % 1000 == 0).all()
    assert (rh >> 32).min() > 0 and abs(int(rh[0]) - corpus.BASE64) <= 3000
    ts = np.frombuffer(corpus.timestamps64_corpus(1 << 20), np.int64)
    steps = np.diff(ts)
    assert steps.min() >= 900 and steps.max() <= 1100 and ts[0] - corpus.BASE64 in range(900, 1101)
    assert len(corpus.timestamps64_corpus(1001)) == 1001
    assert corpus.timestamps64_corpus(4096, seed=4) != corpus.timestamps64_corpus(4096)


def test_corpus_loader_raises_without_the_mixed_corpus(monkeypatch, tmp_path):
    """A missing corpus raises; it is never replaced by other data."""
    from tpucomp_torch.utils import corpus

    monkeypatch.setattr(corpus, "MIXED", tmp_path / "mixed_v1.bin.gz")
    with pytest.raises(FileNotFoundError, match="mixed corpus"):
        corpus.load_corpus(1 << 16)


def test_profiling_trace_writes_a_directory(tmp_path):
    """profiling.trace writes a torch.profiler trace that holds the
    annotate range (host activity only without a card)."""
    from tpucomp_torch.utils import profiling

    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("pack_and_compress"):
            tpucomp_torch.cascaded_codec.compress(chunking.pack_chunks([b"abcd" * 64], device="cpu"))
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert "pack_and_compress" in files[0].read_text()


@pytest.mark.parametrize("measure", ["wall", "device_work"])
def test_device_measurements_raise_without_a_card(monkeypatch, measure):
    """wall and device_work time the card: without one they raise and run
    nothing, so no host time is reported as a device time."""
    from tpucomp_torch.utils import profiling

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(profiling, measure)(lambda: calls.append(1))
    assert calls == []
