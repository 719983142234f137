"""The port's CUDA kernels: held to their plain versions on the card, and
their routing and build checked on the CPU.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a fixture
decides, not the import).  On the card::

    python -m pytest tests/test_torch_kernels.py -m cuda -p no:xdist

Tolerance: none.  Every output is an integer tensor and must be equal.
"""

import numpy as np
import pytest
import torch

from tpucomp_torch.codecs import cascaded as cc
from tpucomp_torch.core.options import CascadedOpts, opts_from_fields
from tpucomp_torch.core.types import DataType
from tpucomp_torch.kernels import _build
from tpucomp_torch.kernels import cascaded_cuda as kc

import torch_cases

CASES = torch_cases.kernel_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda:0")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("label,fields,arr,lens", CASES, ids=[c[0] for c in CASES])
def test_kernels_equal_plain(cuda, label, fields, arr, lens):
    o = opts_from_fields(fields)
    d, ln = torch.from_numpy(arr).to(cuda), torch.from_numpy(lens).to(cuda)
    comp, sizes = kc.compress(d, ln, o)
    _equal((comp, sizes), cc._compress_plain(d, ln, o))
    cap = arr.shape[1] - arr.shape[1] % torch_cases.WIDTH[fields["type"]]
    damaged = torch_cases.damage(np.random.default_rng(len(label)), comp.cpu().numpy(),
                                 sizes.cpu().numpy())
    for rows, szs in ((comp, sizes), tuple(torch.from_numpy(a).to(cuda) for a in damaged)):
        for c in (cap, max(8, cap // 4 // 8 * 8)):
            _equal(kc.decompress(rows, szs, o, c), cc._decompress_plain(rows, szs, o, c))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_decode_corrupt_streams_equal_plain(cuda):
    src, lens = torch_cases.corrupt_source()
    o = opts_from_fields(torch_cases.DEFAULT)
    comp, sizes = kc.compress(torch.from_numpy(src).to(cuda), torch.from_numpy(lens).to(cuda), o)
    _, rows, szs = torch_cases.corrupt_cases(comp.cpu().numpy(), sizes.cpu().numpy())
    rows, szs = torch.from_numpy(rows).to(cuda), torch.from_numpy(szs).to(cuda)
    for fields in (torch_cases.DEFAULT, torch_cases.opts(num_rles=1)):
        o = opts_from_fields(fields)
        _equal(kc.decompress(rows, szs, o, src.shape[1]),
               cc._decompress_plain(rows, szs, o, src.shape[1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_launch_counters_move_and_w8_raises(cuda):
    """Each codec call on the card launches its kernel once, 8-byte
    elements included (the kernels equal the plain version); the wrapper
    raises on what a w = 8 launch cannot take: an output capacity that is
    not a multiple of 8."""
    o = CascadedOpts()
    before = dict(kc.LAUNCHES)
    data = torch.arange(4096, dtype=torch.int32, device=cuda).view(torch.uint8).view(4, 4096)
    lengths = torch.full((4,), 4096, dtype=torch.int32, device=cuda)
    comp, sizes = cc.compress(data, lengths, o)
    out, nbytes, status = cc.decompress(comp, sizes, o, 4096)
    assert kc.LAUNCHES == {"encode": before["encode"] + 1, "decode": before["decode"] + 1}
    assert torch.equal(out, data) and bool((status == 0).all())
    for type_ in (DataType.LONGLONG, DataType.ULONGLONG):
        o8 = CascadedOpts(type=type_)
        before = dict(kc.LAUNCHES)
        comp, sizes = cc.compress(data, lengths, o8)
        got = cc.decompress(comp, sizes, o8, 4096)
        assert comp.is_cuda and kc.LAUNCHES == {"encode": before["encode"] + 1, "decode": before["decode"] + 1}
        want = cc._compress_plain(data.cpu(), lengths.cpu(), o8)
        _equal((comp.cpu(), sizes.cpu()), want)
        _equal([t.cpu() for t in got], cc._decompress_plain(*want, o8, 4096))
        assert torch.equal(got[0], data) and bool((got[2] == 0).all())
        with pytest.raises(ValueError, match="multiple of the element width"):
            kc.decompress(comp, sizes, o8, 4092)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_w8_codec_and_manager_round_trip_on_the_card(cuda):
    """cascaded_codec and CascadedManager take an 8-byte batch on the card
    through the kernels: the same streams and artifact as on the CPU, an
    exact round trip, and both Cascaded kernels launched."""
    import tpucomp_torch

    o8 = CascadedOpts(type=DataType.LONGLONG)
    raw = (np.arange(3000, dtype=np.int64) // 7).tobytes()
    for dev in (cuda, "cpu"):
        before = dict(kc.LAUNCHES)
        batch = tpucomp_torch.pack_chunks([raw[:8000], raw[8000:20000]], device=dev)
        comp = tpucomp_torch.cascaded_codec.compress(batch, o8)
        out, status = tpucomp_torch.cascaded_codec.decompress(comp, batch.capacity, o8)
        assert tpucomp_torch.unpack_chunks(out) == tpucomp_torch.unpack_chunks(batch) and not status.any()
        artifact, size = tpucomp_torch.CascadedManager(opts=o8, device=dev).compress(raw)
        data, statuses = tpucomp_torch.create_manager(artifact).decompress(artifact)
        assert bytes(data.cpu().numpy()) == raw and not statuses.any()
        if dev == cuda:
            gpu = (comp.data.cpu(), comp.lengths.cpu(), artifact.cpu())
            assert all(kc.LAUNCHES[k] >= before[k] + 2 for k in ("encode", "decode"))
        else:
            assert kc.LAUNCHES == before
    assert torch.equal(gpu[0], comp.data) and torch.equal(gpu[1], comp.lengths)
    assert torch.equal(gpu[2], artifact)


@pytest.mark.parametrize("type_", [DataType.LONGLONG, DataType.ULONGLONG])
def test_w8_batches_off_the_cpu_take_the_plain_version(monkeypatch, type_):
    """The codec routes by device alone: an 8-byte batch on a device other
    than the CPU reaches the kernel wrappers, as every other type does, and
    never the plain version (which runs only on CPU tensors)."""
    calls = []

    def kernel(name):
        def fn(*args):
            calls.append(name)
            return name
        return fn

    def plain(*args):
        raise AssertionError("an 8-byte batch off the CPU reached the plain version")

    monkeypatch.setattr(cc, "_compress_plain", plain)
    monkeypatch.setattr(cc, "_decompress_plain", plain)
    monkeypatch.setattr(kc, "compress", kernel("compress"))
    monkeypatch.setattr(kc, "decompress", kernel("decompress"))
    o = CascadedOpts(type=type_)
    rows = torch.zeros(2, 64, dtype=torch.uint8, device="meta")
    sizes = torch.zeros(2, dtype=torch.int32, device="meta")
    assert cc.compress(rows, sizes, o) == "compress"
    assert cc.decompress(rows, sizes, o, 64) == "decompress"
    assert calls == ["compress", "decompress"]


def test_cpu_tensors_never_touch_the_kernels():
    before = dict(kc.LAUNCHES)
    arr, lens = torch_cases.config_case(np.random.default_rng(3), torch_cases.DEFAULT, 4096, "runs")
    comp, sizes = cc.compress(torch.from_numpy(arr), torch.from_numpy(lens), CascadedOpts())
    out, nbytes, status = cc.decompress(comp, sizes, CascadedOpts(), 4096)
    assert (status == 0).all()
    assert kc.LAUNCHES == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CUDA tensors reach the wrappers' launch; there is no fallback to
    the plain version (a tensor on neither CPU nor CUDA raises through the
    public entry point too)."""
    data = torch.zeros(2, 64, dtype=torch.uint8)
    lengths = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kc.compress(data, lengths, CascadedOpts())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kc.decompress(data, lengths, CascadedOpts(), 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.compress(data.to("meta"), lengths.to("meta"), CascadedOpts())
    with pytest.raises(ValueError, match="multiple of the element width"):
        cc.decompress(data, lengths, CascadedOpts(), 63)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-toolkit"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_library_name_follows_the_sources(monkeypatch, tmp_path):
    """The library is rebuilt when a source changes: its name hashes them."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "SOURCES", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert sorted(p.name for p in _build._sources()) == ["a.cu"]
    assert {"tc_cascaded_encode", "tc_cascaded_decode", "tc_lz_match_table", "tc_lz_match_table_grid",
            "tc_lz4_encode", "tc_lz4_decode", "tc_snappy_encode", "tc_snappy_decode", "tc_manager_pack",
            "tc_manager_unpack"} == set(_build.SIGNATURES)


def test_build_signatures_name_the_sources_entry_points():
    """Every C entry point the loader binds is defined in the sources, with
    as many parameters as its argtypes, and the sources define no other."""
    import re

    defined = {}
    for src in _build._sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            defined[name] = len([p for p in params.split(",") if p.strip()])
    assert defined == {name: len(args) for name, args in _build.SIGNATURES.items()}


def test_build_compiles_each_source_then_links_one_library(monkeypatch, tmp_path):
    """One nvcc per source, all started before any is waited on, then one
    link; the compilers' reports land in the log and no object is left."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (src / name).write_text(f"// {name}")
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        # a compile finishes only once both have started
        f'case " $* " in *" -c "*) n=0; until [ "$(wc -l < {calls})" -ge 2 ]; do\n'
        '  n=$((n + 1)); [ $n -gt 100 ] && exit 1; sleep 0.1; done;; esac\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
        'echo "ptxas info    : Used 1 registers" >&2\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "SOURCES", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(fake))
    path = _build.build()
    lines = calls.read_text().splitlines()
    assert len(lines) == 3 and all(" -c " in f" {x} " for x in lines[:2])
    assert sorted(x.split()[-1] for x in lines[:2]) == [str(src / "a.cu"), str(src / "b.cu")]
    assert lines[2].startswith("-shared -o")
    assert path.read_text() == "built\n" and path == _build.library_path()
    assert path.with_suffix(".log").read_text().count("Used 1 registers") == 2
    assert sorted(p.name for p in path.parent.iterdir()) == sorted([path.name, path.with_suffix(".log").name])
    assert _build.build() == path and len(calls.read_text().splitlines()) == 3  # built once
