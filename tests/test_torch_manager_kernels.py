"""The managers' stream-copy kernel (``kernels/manager_cuda.py``): pack and
unpack held to the plain versions on the card, and the routing checked on
the CPU.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a fixture
decides, not the import).  On the card::

    python -m pytest tests/test_torch_manager_kernels.py -m cuda --noconftest -o addopts="" -q

Tolerance: none.  Every output is bytes or integers and must be equal.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpucomp_torch
from tpucomp_torch import config
from tpucomp_torch.highlevel import headers as hdr
from tpucomp_torch.highlevel import manager as tm
from tpucomp_torch.kernels import manager_cuda as km
from tpucomp_torch.utils import profiling

import torch_manager_cases as mc

SHAPES = [c.label for c in mc.shape_cases()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda:0")


@pytest.fixture
def flag():
    yield
    config.use_cuda_kernels = None


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.shape == w.shape and torch.equal(g.cpu(), w.cpu())
        else:
            assert g == w


def _common(artifact: torch.Tensor) -> hdr.CommonHeader:
    return hdr.CommonHeader.unpack(artifact[: hdr.COMMON_HEADER_SIZE].cpu().numpy().tobytes())


def _at_base(artifact: np.ndarray, shift: int, dev) -> torch.Tensor:
    """``artifact`` on ``dev`` as a view ``shift`` bytes past an allocation's start."""
    buf = torch.full((artifact.size + shift,), 0x5C, dtype=torch.uint8)
    buf[shift:] = torch.from_numpy(artifact)
    return buf.to(dev)[shift:]


def _pack_both(case, dev):
    """The kernel's artifact on ``dev`` held to the plain version's on the
    CPU, the bytes past the streams zero; returns the plain (artifact, size)."""
    comp, sizes = torch.from_numpy(case.comp), torch.from_numpy(case.sizes)
    want = tm._assemble_plain(comp, sizes, case.static_head, **case.layout())
    got = tm._assemble_artifact(comp.to(dev), sizes.to(dev), case.static_head, **case.layout())
    assert got[0].is_cuda
    _equal(got, want)
    assert not got[0][want[1]:].any()
    return want


def _slice_both(artifact: torch.Tensor, case):
    common = _common(artifact)
    got = tm._slice_streams(artifact, common, case.sections_off, case.max_chunk)
    assert got[0].is_cuda
    _equal(got, tm._slice_plain(artifact.cpu(), common, case.sections_off, case.max_chunk))
    return got


def _round_trips(case, dev):
    """Pack, then unpack the artifact from every base alignment, then with
    its tables damaged."""
    artifact, size = _pack_both(case, dev)
    sizes = torch.from_numpy(case.sizes)
    keep = torch.arange(case.comp.shape[1])[None, :] < sizes[:, None].to(torch.int64)
    want = torch.where(keep, torch.from_numpy(case.comp), 0)[:, : case.max_chunk]
    for shift in range(16):
        rows, got_sizes = _slice_both(_at_base(artifact[:size].numpy(), shift, dev), case)
        assert torch.equal(rows[:, : want.shape[1]].cpu(), want) and torch.equal(got_sizes.cpu(), sizes)
    for label, art in mc.damaged(case, artifact.numpy(), size):
        for shift in (0, 7):
            _slice_both(_at_base(art, shift, dev), case)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(mc.MANAGERS))
def test_manager_streams_pack_and_unpack_as_plain(cuda, name):
    """Each manager's own codec output (LZ4, Snappy, Cascaded INT at its
    4 KB default and LONGLONG)."""
    _round_trips(mc.manager_case(name, mc.payload(5, 92000 if name in ("lz4", "snappy") else 21700)), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("label", SHAPES)
def test_shapes_pack_and_unpack_as_plain(cuda, label):
    """k = 1; zero sizes among full rows; rows of exactly max_chunk; offsets
    at every residue mod 16; many streams in one 16-byte word."""
    _round_trips(next(c for c in mc.shape_cases() if c.label == label), cuda)


@pytest.mark.cuda
def test_65536_streams_of_4k(cuda):
    """CascadedManager's default shape at 256 MB, held to the plain versions
    run on the card."""
    case = mc.many_small()
    comp, sizes = torch.from_numpy(case.comp).to(cuda), torch.from_numpy(case.sizes).to(cuda)
    artifact, size = tm._assemble_artifact(comp, sizes, case.static_head, **case.layout())
    want, want_size = tm._assemble_plain(comp, sizes, case.static_head, **case.layout())
    assert size == want_size and torch.equal(artifact, want)
    del want
    common = _common(artifact)
    got = tm._slice_streams(artifact[:size], common, case.sections_off, case.max_chunk)
    _equal(got, tm._slice_plain(artifact[:size], common, case.sections_off, case.max_chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(mc.MANAGERS))
def test_managers_on_the_card_write_the_cpu_artifact(cuda, name):
    """A whole manager call on the card equals the one on the CPU, and each
    entry point launches once a call."""
    cls, kwargs = mc.MANAGERS[name]
    data = mc.payload(11, 150000 if name in ("lz4", "snappy") else 30000)
    want, want_size = cls(device="cpu", **kwargs).compress(data)
    before = dict(km.LAUNCHES)
    artifact, size = cls(device=cuda, **kwargs).compress(data)
    assert km.LAUNCHES == {"pack": before["pack"] + 1, "unpack": before["unpack"]}
    assert size == want_size and torch.equal(artifact.cpu(), want)
    out, statuses = tpucomp_torch.create_manager(artifact[:size]).decompress(artifact[:size])
    assert km.LAUNCHES == {"pack": before["pack"] + 1, "unpack": before["unpack"] + 1}
    assert bytes(out.cpu().numpy()) == data and not statuses.any()  # whole elements: Cascaded keeps them all


@pytest.mark.cuda
def test_counters_read_comp_data_size_while_tracing(cuda):
    """Off: no counter buffer.  On, over three calls of each direction:
    manager.pack.bytes and manager.unpack.bytes each equal three times the
    artifact's comp_data_size, and the manager's spans hold the kernel's
    .launch."""
    profiling.reset()
    try:
        mgr = tpucomp_torch.LZ4Manager(device=cuda)
        data = mc.payload(3, 200000)
        mgr.compress(data)
        assert profiling.counters() == {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(3):
                artifact, size = mgr.compress(data)
                out, _ = tpucomp_torch.create_manager(artifact[:size]).decompress(artifact[:size])
            torch.cuda.synchronize()
        assert bytes(out.cpu().numpy()) == data
        counts = profiling.counters()
        total = _common(artifact).comp_data_size
        assert counts["manager.pack.bytes"] == counts["manager.unpack.bytes"] == 3 * total > 0
        names = {s.name for s in profiling.spans()}
        assert {"compress.manager.assemble.launch", "decompress.manager.slice.launch"} <= names
    finally:
        profiling.reset()


@pytest.mark.cuda
def test_unpack_refuses_an_artifact_that_ends_inside_its_tables(cuda):
    case = mc.shape_cases()[2]
    artifact, size = _pack_both(case, cuda)
    cut = artifact[: case.sections_off + 16 * case.k - 1].to(cuda)
    with pytest.raises(ValueError, match="ends inside its offset and size tables"):
        tm._slice_streams(cut, _common(artifact), case.sections_off, case.max_chunk)


# ---- on the CPU: the routing


@pytest.mark.parametrize("name", list(mc.MANAGERS))
def test_cpu_managers_take_the_plain_versions(name):
    """A manager on the CPU launches nothing: its artifact is the plain
    assembly, and slicing it gives back the codec's rows."""
    case = mc.manager_case(name, mc.payload(2, 70000 if name in ("lz4", "snappy") else 9000))
    before = dict(km.LAUNCHES)
    comp, sizes = torch.from_numpy(case.comp), torch.from_numpy(case.sizes)
    artifact, size = tm._assemble_artifact(comp, sizes, case.static_head, **case.layout())
    want = tm._assemble_plain(comp, sizes, case.static_head, **case.layout())
    assert size == want[1] and torch.equal(artifact, want[0])
    rows, got_sizes = tm._slice_streams(artifact[:size], _common(artifact), case.sections_off, case.max_chunk)
    assert torch.equal(got_sizes, sizes)
    assert km.LAUNCHES == before


def test_flag_true_refuses_cpu_tensors(flag):
    case = mc.shape_cases()[0]
    config.use_cuda_kernels = True
    with pytest.raises(ValueError, match="use_cuda_kernels is True"):
        tm._assemble_artifact(torch.from_numpy(case.comp), torch.from_numpy(case.sizes), case.static_head,
                              **case.layout())
    with pytest.raises(ValueError, match="use_cuda_kernels is True"):
        tm._slice_streams(torch.zeros(4096, dtype=torch.uint8), _common(torch.zeros(64, dtype=torch.uint8)),
                          case.sections_off, case.max_chunk)
