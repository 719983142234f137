"""The port's high-level managers (tpucomp_torch.highlevel) equal tpucomp's
on the CPU.

Headers are byte-identical.  Cascaded artifacts are byte-identical to
tpucomp's manager.  tpucomp's LZ4 and Snappy managers write the streams of
the encoder they route to, which on a CPU is the XLA path (4 KB parse
blocks); the port's encoders compute what tpucomp's Pallas kernels
compute, so the port's LZ4 and Snappy artifacts are held to tpucomp's
``_assemble_artifact`` fed the Pallas streams (interpret mode), which is
what tpucomp's manager writes where its Pallas route is on.  Artifacts
decode across the packages in both directions.

Tolerance: none.  Every output is bytes or integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp
from tpucomp.core import options as jopts
from tpucomp.core.types import DataType as JDataType
from tpucomp.highlevel import headers as jhdr
from tpucomp.highlevel import manager as jm
from tpucomp.kernels import lz_pallas, snappy_pallas

import tpucomp_torch
from tpucomp_torch.core import options as topts
from tpucomp_torch.core.types import DataType, Status
from tpucomp_torch.highlevel import headers as hdr
from tpucomp_torch.highlevel import manager as tm

import torch_manager_cases as mc

CHUNK = 4096
MANAGERS = {
    "lz4": (tm.LZ4Manager, jm.LZ4Manager),
    "snappy": (tm.SnappyManager, jm.SnappyManager),
    "cascaded": (tm.CascadedManager, jm.CascadedManager),
}


def _payload(rng, n):
    return np.repeat(rng.integers(0, 40, n), rng.integers(1, 9, n))[:n].astype(np.uint8).tobytes()


def _port(name, **kw):
    return MANAGERS[name][0](uncomp_chunk_size=CHUNK, device="cpu", **kw)


def _ref(name, **kw):
    return MANAGERS[name][1](uncomp_chunk_size=CHUNK, **kw)


def _bytes(artifact, size=None):
    a = artifact.numpy() if isinstance(artifact, torch.Tensor) else np.asarray(artifact)
    return a[: size if size is not None else a.size].tobytes()


@pytest.fixture(scope="module")
def payload():
    return _payload(np.random.default_rng(21), 9000)  # three chunks, the last one partial


@pytest.fixture(scope="module")
def pallas_artifacts(payload):
    """tpucomp's LZ4 and Snappy artifacts of ``payload`` as its manager
    writes them where its Pallas route is on: the interpret-mode Pallas
    streams through its ``_assemble_artifact``."""
    out = {}
    for name, kernel in (("lz4", lz_pallas), ("snappy", snappy_pallas)):
        mgr = _ref(name)
        n = len(payload)
        cfg = mgr.configure_compression(n)
        k = cfg.num_chunks
        chunks = np.zeros(k * CHUNK, np.uint8)
        chunks[:n] = np.frombuffer(payload, np.uint8)
        lengths = np.clip(n - np.arange(k) * CHUNK, 0, CHUNK).astype(np.int32)
        comp, sizes = kernel.compress(jnp.asarray(chunks.reshape(k, CHUNK)), jnp.asarray(lengths), interpret=True)
        common = jhdr.CommonHeader(format=mgr.format_id, comp_data_size=0, decomp_data_size=n, num_chunks=k,
                                   uncomp_chunk_size=CHUNK, comp_data_offset=jhdr.data_region_offset(mgr.format_id, k))
        head = bytearray(common.pack()) + jhdr.pack_format_spec(mgr.format_id, mgr.opts)
        head += b"\x00" * (jhdr.sections_offset(mgr.format_id) - len(head))
        artifact, size = jm._assemble_artifact(
            comp, sizes, jnp.asarray(np.frombuffer(bytes(head), np.uint8)), data_off=common.comp_data_offset,
            sections_off=jhdr.sections_offset(mgr.format_id), out_max=cfg.max_compressed_buffer_size)
        out[name] = (np.asarray(artifact), int(size))
    return out


# ---------------------------------------------------------------------------
# headers


def test_header_bytes_equal_tpucomp():
    for fmt in (hdr.FORMAT_LZ4, hdr.FORMAT_SNAPPY, hdr.FORMAT_CASCADED):
        fields = dict(format=fmt, comp_data_size=0x1122334455, decomp_data_size=0x66778899, num_chunks=7,
                      uncomp_chunk_size=65536, comp_data_offset=0x58)
        raw = hdr.CommonHeader(**fields).pack()
        assert raw == jhdr.CommonHeader(**fields).pack() and len(raw) == hdr.COMMON_HEADER_SIZE == 64
        assert hdr.CommonHeader.unpack(raw) == hdr.CommonHeader(**fields)
        assert hdr.sections_offset(fmt) == jhdr.sections_offset(fmt)
        for k in (1, 5, 4096):
            assert hdr.data_region_offset(fmt, k) == jhdr.data_region_offset(fmt, k)
    for dt in (DataType.UCHAR, DataType.USHORT, DataType.UINT):
        raw = hdr.pack_format_spec(hdr.FORMAT_LZ4, topts.LZ4Opts(dt))
        assert raw == jhdr.pack_format_spec(jhdr.FORMAT_LZ4, jopts.LZ4Opts(JDataType(int(dt))))
        assert hdr.unpack_format_spec(hdr.FORMAT_LZ4, raw) == topts.LZ4Opts(dt)
    assert hdr.pack_format_spec(hdr.FORMAT_SNAPPY, topts.SnappyOpts()) == \
        jhdr.pack_format_spec(jhdr.FORMAT_SNAPPY, jopts.SnappyOpts()) == b"\x00"
    o = topts.CascadedOpts(chunk_size=2048, type=DataType.SHORT, num_rles=1, num_deltas=0, use_bp=False)
    raw = hdr.pack_format_spec(hdr.FORMAT_CASCADED, o)
    assert raw == jhdr.pack_format_spec(jhdr.FORMAT_CASCADED, jopts.CascadedOpts(
        chunk_size=2048, type=JDataType.SHORT, num_rles=1, num_deltas=0, use_bp=False))
    assert hdr.unpack_format_spec(hdr.FORMAT_CASCADED, raw) == o
    with pytest.raises(ValueError, match="unsupported format"):
        hdr.pack_format_spec(hdr.FORMAT_GDEFLATE, None)


# ---------------------------------------------------------------------------
# managers on the CPU


@pytest.mark.parametrize("name", list(MANAGERS))
def test_manager_round_trip(rng, name):
    mgr = _port(name)
    payload = _payload(rng, 20000)  # multi-chunk, unaligned tail
    cfg = mgr.configure_compression(len(payload))
    assert cfg == tm.CompressionConfig(**vars(_ref(name).configure_compression(len(payload))))
    assert cfg.num_chunks == 5
    artifact, size = mgr.compress(payload)
    assert artifact.shape == (cfg.max_compressed_buffer_size,) and artifact.device.type == "cpu"
    assert size <= cfg.max_compressed_buffer_size and mgr.get_compressed_output_size(artifact) == size
    assert mgr.configure_decompression(artifact) == tm.DecompressionConfig(len(payload), 5)
    out, statuses = mgr.decompress(artifact)
    assert not statuses.any() and statuses.shape == (5,)
    assert out.numpy().tobytes() == payload
    assert mgr.get_required_scratch_buffer_size() == 0


@pytest.mark.parametrize("name", list(MANAGERS))
def test_create_manager_autodetect(rng, name):
    mgr = _port(name)
    payload = _payload(rng, 9000)
    artifact, _ = mgr.compress(payload)
    for source in (artifact, artifact.numpy(), _bytes(artifact)):
        mgr2 = tm.create_manager(source, device="cpu")
        assert type(mgr2) is type(mgr) and mgr2.uncomp_chunk_size == CHUNK and mgr2.opts == mgr.opts
        out, statuses = mgr2.decompress(source)
        assert not statuses.any() and out.numpy().tobytes() == payload
    assert tm.create_manager(artifact).device.type == "cpu"  # a tensor's own device


@pytest.mark.parametrize("n", [1, 5, 4095, 4096, 4097])
def test_tiny_and_boundary_sizes(rng, n):
    """Exact round trips for LZ4 and Snappy; Cascaded (INT elements) keeps
    what tpucomp keeps of a tail shorter than an element, byte for byte."""
    payload = bytes(rng.integers(0, 5, n).astype(np.uint8))
    for name in MANAGERS:
        mgr = _port(name)
        artifact, size = mgr.compress(payload)
        out, statuses = mgr.decompress(artifact)
        assert not statuses.any(), name
        if name == "cascaded":
            ref, ref_size = _ref(name).compress(payload)
            assert size == int(ref_size) and _bytes(artifact) == _bytes(ref)
            assert out.numpy().tobytes() == np.asarray(_ref(name).decompress(ref)[0]).tobytes()
        else:
            assert out.numpy().tobytes() == payload, name


@pytest.mark.parametrize("name", list(MANAGERS))
def test_empty_buffer(name):
    """An empty buffer gives tpucomp's artifact and decodes to nothing, with
    tpucomp's status: SUCCESS for LZ4 and Snappy, ERROR_CANNOT_DECOMPRESS
    for Cascaded."""
    artifact, size = _port(name).compress(b"")
    ref, ref_size = _ref(name).compress(b"")
    assert size == int(ref_size) and _bytes(artifact) == _bytes(ref)
    out, statuses = tm.create_manager(artifact).decompress(artifact)
    want = Status.ERROR_CANNOT_DECOMPRESS if name == "cascaded" else Status.SUCCESS
    assert out.numel() == 0 and statuses.tolist() == [want]
    if name == "cascaded":  # tpucomp's LZ decoders take seconds to compile here
        assert np.asarray(_ref(name).decompress(ref)[1]).tolist() == [want]


def test_cascaded_chunk_of_no_whole_elements_does_not_decode(rng):
    """CascadedManager(uncomp_chunk_size=4097) on INT writes tpucomp's
    artifact, but its chunk is not a whole number of elements, so the
    decode's output capacity is refused (tpucomp fails inside its trace)."""
    payload = _payload(rng, 9000)
    artifact, size = tm.CascadedManager(uncomp_chunk_size=4097, device="cpu").compress(payload)
    ref, ref_size = jm.CascadedManager(uncomp_chunk_size=4097).compress(payload)
    assert size == int(ref_size) and _bytes(artifact) == _bytes(ref)
    with pytest.raises(ValueError, match="out_capacity must be a multiple of the element width"):
        tm.create_manager(artifact).decompress(artifact)


def test_compress_takes_bytes_arrays_sequences_and_tensors(payload):
    mgr = _port("snappy")
    want, size = mgr.compress(payload)
    arr = np.frombuffer(payload, np.uint8)
    for data in (bytearray(payload), arr, arr.reshape(-1, 9), list(payload), torch.from_numpy(arr.copy())):
        got, got_size = mgr.compress(data)
        assert got_size == size and torch.equal(got, want)


def test_unknown_format_rejected(rng):
    artifact, _ = _port("lz4").compress(_payload(rng, 100))
    bad = artifact.clone()
    bad[6] = hdr.FORMAT_GDEFLATE  # the format byte
    with pytest.raises(ValueError, match="unsupported format"):
        tm.create_manager(bad)


def test_header_fields(rng):
    artifact, size = _port("lz4").compress(_payload(rng, 10000))
    head = hdr.CommonHeader.unpack(_bytes(artifact, 64))
    assert head.magic_number == 0 and (head.major_version, head.minor_version) == (2, 2)
    assert (head.format, head.decomp_data_size, head.num_chunks, head.uncomp_chunk_size) == \
        (hdr.FORMAT_LZ4, 10000, 3, CHUNK)
    assert head.comp_data_offset == hdr.data_region_offset(hdr.FORMAT_LZ4, 3)
    assert head.comp_data_offset + head.comp_data_size == size
    sec = hdr.sections_offset(hdr.FORMAT_LZ4)
    raw = artifact[sec : sec + 48].numpy()
    offs, szs = raw[:24].view("<u8"), raw[24:48].view("<u8")
    assert offs[0] == 0 and (offs[1:] == np.cumsum(szs)[:-1]).all() and offs[-1] + szs[-1] == head.comp_data_size
    assert not artifact[sec + 48 : head.comp_data_offset].any()  # reserved checksum sections


# ---------------------------------------------------------------------------
# the plain assembly and slicing: the edge behaviour the copy kernel is held to

EDGE_SIZES = {"zero first": [0, 19], "zero last": [23, 0], "all zero": [0, 0], "one full": [24],
              "zeros between": [7, 0, 0, 24, 1]}
EDGE_ROW = 24


def _edge_case(label):
    return mc.synthetic(np.random.default_rng(len(label)), label, EDGE_SIZES[label], row=EDGE_ROW)


def _assembled_by_hand(case):
    """The artifact written out from the layout, in numpy."""
    sizes = case.sizes.astype(np.int64)
    offs = np.cumsum(sizes) - sizes
    art = np.zeros(case.out_max, np.uint8)
    art[: len(case.static_head)] = np.frombuffer(case.static_head, np.uint8)
    art[8:16] = np.frombuffer(int(sizes.sum()).to_bytes(8, "little"), np.uint8)
    so, k = case.sections_off, case.k
    art[so : so + 16 * k] = np.concatenate([offs, sizes]).astype("<u8").view(np.uint8)
    for i in range(k):
        art[case.data_off + offs[i] : case.data_off + offs[i] + sizes[i]] = case.comp[i, : sizes[i]]
    return art, case.data_off + int(sizes.sum())


def _sliced_by_hand(art, case):
    """Rows and sizes read byte by byte from the tables: each index
    data_off + offset + t wraps as an int64 and is clamped into the
    artifact; sizes are the tables' low 32 bits."""
    k, so = case.k, case.sections_off
    tables = art[so : so + 16 * k].copy().view("<u8").astype(object)
    rows = np.zeros((k, case.max_chunk), np.uint8)
    for i in range(k):
        size = int(tables[k + i]) - (2**64 if tables[k + i] >= 2**63 else 0)
        for t in range(min(max(size, 0), case.max_chunk)):
            at = (case.data_off + int(tables[i]) + t + 2**63) % 2**64 - 2**63
            rows[i, t] = art[min(max(at, 0), art.size - 1)]
    sizes = np.array([int(v) % 2**32 for v in tables[k:]], np.uint64).astype(np.uint32).view(np.int32)
    return rows, sizes


@pytest.mark.parametrize("label", list(EDGE_SIZES))
def test_assemble_places_zero_size_streams(label):
    """Zero-size streams take no byte, the bytes past the streams stay 0,
    and the artifact equals the layout written out by hand and tpucomp's
    assembly of the same rows."""
    case = _edge_case(label)
    artifact, size = tm._assemble_artifact(torch.from_numpy(case.comp), torch.from_numpy(case.sizes),
                                           case.static_head, **case.layout())
    want, want_size = _assembled_by_hand(case)
    assert size == want_size and artifact.numpy().tobytes() == want.tobytes()
    assert not artifact[size:].any()
    head = np.zeros(case.sections_off, np.uint8)
    head[: len(case.static_head)] = np.frombuffer(case.static_head, np.uint8)
    ref, ref_size = jm._assemble_artifact(jnp.asarray(case.comp), jnp.asarray(case.sizes), jnp.asarray(head),
                                          **case.layout())
    assert int(ref_size) == size and np.asarray(ref).tobytes() == want.tobytes()


@pytest.mark.parametrize("label", list(EDGE_SIZES))
def test_slice_streams_gives_back_the_assembled_rows(label):
    case = _edge_case(label)
    artifact, size = tm._assemble_artifact(torch.from_numpy(case.comp), torch.from_numpy(case.sizes),
                                           case.static_head, **case.layout())
    artifact = artifact[:size]
    rows, sizes = tm._slice_streams(artifact, hdr.CommonHeader.unpack(_bytes(artifact, 64)), case.sections_off,
                                    case.max_chunk)
    keep = np.arange(EDGE_ROW)[None, :] < case.sizes[:, None]
    assert rows.numpy().tobytes() == np.where(keep, case.comp, 0).astype(np.uint8).tobytes()
    assert sizes.dtype == torch.int32 and (sizes.numpy() == case.sizes).all()


DAMAGE_CASE = _edge_case("zeros between")
DAMAGED = dict(mc.damaged(DAMAGE_CASE, *_assembled_by_hand(DAMAGE_CASE)))


@pytest.mark.parametrize("label", list(DAMAGED))
def test_slice_streams_clamps_tables_that_point_past_the_end(label):
    """Tables that point past the artifact's end, wrap, or give sizes the
    rows cannot hold: every byte read from the index clamped into the
    artifact, sizes cut to 32 bits, held to a byte-by-byte reading."""
    case, art = DAMAGE_CASE, DAMAGED[label]
    artifact = torch.from_numpy(art.copy())
    rows, sizes = tm._slice_streams(artifact, hdr.CommonHeader.unpack(_bytes(artifact, 64)), case.sections_off,
                                    case.max_chunk)
    want_rows, want_sizes = _sliced_by_hand(art, case)
    assert rows.numpy().tobytes() == want_rows.tobytes() and (sizes.numpy() == want_sizes).all()


# ---------------------------------------------------------------------------
# against tpucomp


def test_cascaded_artifact_byte_identical_to_tpucomp(payload):
    for opts in (None, (topts.CascadedOpts(chunk_size=2048, num_rles=1, num_deltas=1),
                        jopts.CascadedOpts(chunk_size=2048, num_rles=1, num_deltas=1))):
        kw_port, kw_ref = ({}, {}) if opts is None else ({"opts": opts[0]}, {"opts": opts[1]})
        artifact, size = _port("cascaded", **kw_port).compress(payload)
        ref, ref_size = _ref("cascaded", **kw_ref).compress(payload)
        assert size == int(ref_size) and _bytes(artifact) == _bytes(ref)


@pytest.mark.parametrize("name", ["lz4", "snappy"])
def test_lz_artifacts_equal_tpucomp_assembly_of_pallas_streams(payload, pallas_artifacts, name):
    artifact, size = _port(name).compress(payload)
    ref, ref_size = pallas_artifacts[name]
    assert size == ref_size and _bytes(artifact) == ref.tobytes()


def test_lz4_manager_writes_opts_but_compresses_bytes(payload, pallas_artifacts):
    """Like tpucomp's: a typed LZ4Opts goes into the format header, and the
    streams stay byte-granular."""
    opts = topts.LZ4Opts(DataType.UINT)
    artifact, _ = _port("lz4", opts=opts).compress(payload)
    ref = pallas_artifacts["lz4"][0].copy()
    ref[64:68] = np.frombuffer(hdr.pack_format_spec(hdr.FORMAT_LZ4, opts), np.uint8)
    assert _bytes(artifact) == ref.tobytes()
    assert tm.create_manager(artifact).opts == opts


@pytest.mark.parametrize("name", list(MANAGERS))
def test_artifacts_decode_across_packages(payload, name):
    """A port artifact decodes in tpucomp, and a tpucomp artifact in the port."""
    artifact, _ = _port(name).compress(payload)
    ref_mgr = tpucomp.create_manager(jnp.asarray(artifact.numpy()))
    out, statuses = ref_mgr.decompress(jnp.asarray(artifact.numpy()))
    assert type(ref_mgr) is MANAGERS[name][1]
    assert np.asarray(out).tobytes() == payload and not np.asarray(statuses).any()
    ref, _ = _ref(name).compress(payload)
    mgr = tpucomp_torch.create_manager(np.asarray(ref), device="cpu")
    out, statuses = mgr.decompress(np.asarray(ref))
    assert type(mgr) is MANAGERS[name][0]
    assert out.numpy().tobytes() == payload and not statuses.any()


def test_split_and_join_stream_equal_tpucomp(payload):
    for n, cs in ((len(payload), CHUNK), (0, 64), (4096, 4096), (100, 7)):
        batch = tpucomp_torch.split_stream(payload[:n], cs, device="cpu")
        ref = tpucomp.split_stream(payload[:n], cs)
        np.testing.assert_array_equal(batch.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(batch.lengths.numpy(), np.asarray(ref.lengths))
        assert tpucomp_torch.join_stream(batch) == tpucomp.join_stream(ref) == payload[:n]
