"""The port's kernel-routing flag and API stubs (tpucomp_torch.config,
tpucomp_torch.lowlevel.stubs).

``config.use_cuda_kernels`` has tpucomp's tri-state: None routes by the
batch's device, False takes the plain PyTorch versions and raises on a
batch that is not on the CPU (a tensor on the card takes its kernel or
raises), True takes the CUDA kernels and raises on a CPU batch (the port
has no interpret mode).  The stubs raise ``NotSupportedError`` with tpucomp's
status on every member.

Tolerance: none.  Every output is an integer tensor and must be equal.
Tests marked ``cuda`` need an NVIDIA GPU and skip without one; on a GPU::

    python -m pytest tests/test_torch_config.py -m cuda --noconftest -o addopts="" -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpucomp_torch
from tpucomp_torch import config
from tpucomp_torch.codecs import cascaded as tcc
from tpucomp_torch.codecs import lz4 as tl
from tpucomp_torch.codecs import snappy as ts
from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.types import DataType, Status
from tpucomp_torch.lowlevel import stubs
from tpucomp_torch.parallel import sharding as sh

CAP = 1024
CODECS = {"cascaded": tpucomp_torch.cascaded_codec, "lz4": tpucomp_torch.lz4_codec,
          "snappy": tpucomp_torch.snappy_codec}
# each codec's plain versions, as its public entry points call them
PLAIN = {
    "cascaded": (lambda d, n: tcc._compress_plain(d, n, CascadedOpts()),
                 lambda c, s: tcc._decompress_plain(c, s, CascadedOpts(), CAP)),
    "lz4": (lambda d, n: tl._compress_plain(d, n, 1), lambda c, s: tl._decompress_plain(c, s, CAP)),
    "snappy": (ts._compress_plain, lambda c, s: ts._decompress_plain(c, s, CAP)),
}


@pytest.fixture
def flag():
    """The routing flag, set back to None after the test."""
    yield config
    config.use_cuda_kernels = None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _chunks(rng, b=4):
    """Run-heavy rows of 16 B to 1 KB (whole INT elements)."""
    out = []
    for _ in range(b):
        n = int(rng.integers(16, CAP + 1)) // 4 * 4
        out.append(np.repeat(rng.integers(0, 9, n), rng.integers(1, 7, n))[:n].astype(np.uint8).tobytes())
    return out


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1", "meta"])
def test_kernels_enabled_by_setting_and_device(flag, device):
    """Only a CPU batch takes the plain version by default; any other goes
    to the kernels, whose wrappers refuse what is not on a CUDA device.
    False and True assert a route and refuse a batch on the other's
    device."""
    on_cpu = device == "cpu"
    config.use_cuda_kernels = None
    assert config.kernels_enabled(device) is not on_cpu
    config.use_cuda_kernels = False
    if on_cpu:
        assert config.kernels_enabled(device) is False
    else:
        with pytest.raises(ValueError, match="use_cuda_kernels is False"):
            config.kernels_enabled(device)
    config.use_cuda_kernels = True
    if on_cpu:
        with pytest.raises(ValueError, match="cpu"):
            config.kernels_enabled(device)
    else:
        assert config.kernels_enabled(torch.device(device)) is True


@pytest.mark.parametrize("setting", [None, False])
@pytest.mark.parametrize("name", sorted(CODECS))
def test_none_and_false_give_the_plain_bytes_on_the_cpu(flag, rng, setting, name):
    config.use_cuda_kernels = setting
    chunks = _chunks(rng)
    batch = tpucomp_torch.pack_chunks(chunks, capacity=CAP, device="cpu")
    codec, (plain_compress, plain_decompress) = CODECS[name], PLAIN[name]
    comp = codec.compress(batch)
    want = plain_compress(batch.data, batch.lengths)
    assert torch.equal(comp.data, want[0]) and torch.equal(comp.lengths, want[1])
    out, statuses = codec.decompress(comp, CAP)
    want = plain_decompress(comp.data, comp.lengths)
    for got, ref in zip((out.data, out.lengths, statuses), want):
        assert torch.equal(got, ref)
    assert not statuses.any() and tpucomp_torch.unpack_chunks(out) == chunks


@pytest.mark.parametrize("name", sorted(CODECS))
def test_true_raises_on_a_cpu_batch(flag, rng, name):
    batch = tpucomp_torch.pack_chunks(_chunks(rng), capacity=CAP, device="cpu")
    codec = CODECS[name]
    comp = codec.compress(batch)  # routed by device: the plain version
    config.use_cuda_kernels = True
    with pytest.raises(ValueError, match="use_cuda_kernels is True"):
        codec.compress(batch)
    with pytest.raises(ValueError, match="use_cuda_kernels is True"):
        codec.decompress(comp, CAP)


def test_true_raises_on_a_cpu_batch_of_8_byte_elements(flag, rng):
    """8-byte Cascaded types follow the flag as every other type does: a
    forced kernel route refuses a CPU batch."""
    opts = CascadedOpts(type=DataType.LONGLONG)
    batch = tpucomp_torch.pack_chunks(_chunks(rng), capacity=CAP, device="cpu")
    config.use_cuda_kernels = True
    with pytest.raises(ValueError, match="cpu"):
        tpucomp_torch.cascaded_codec.compress(batch, opts)


STUB_MEMBERS = ["compress_get_temp_size", "compress_get_max_output_chunk_size", "compress",
                "decompress_get_temp_size", "decompress", "get_decompress_size"]


@pytest.mark.parametrize("name", ["ANS", "GDEFLATE", "BITCOMP"])
def test_stubs_raise_not_supported_with_tpucomps_status(name):
    # imported here: the card's machine, which runs this file's cuda tests, has no jax
    from tpucomp.lowlevel import stubs as jstubs

    ours, ref = getattr(stubs, name), getattr(jstubs, name)
    assert ours.name == ref.name
    assert dataclasses.asdict(ours.default_opts) == dataclasses.asdict(ref.default_opts)
    for member in STUB_MEMBERS:
        with pytest.raises(stubs.NotSupportedError) as err:
            getattr(ours, member)(16, 65536)
        assert isinstance(err.value, NotImplementedError)
        assert int(err.value.status) == int(jstubs.NotSupportedError.status)
        assert err.value.status == Status.ERROR_NOT_SUPPORTED
        with pytest.raises(jstubs.NotSupportedError):
            getattr(ref, member)(16, 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODECS))
def test_false_refuses_a_card_batch_with_no_launch(flag, cuda, name):
    """A tensor on the card takes its kernel or raises: False raises
    before anything runs, 8-byte Cascaded types included."""
    from tpucomp_torch.kernels import cascaded_cuda, lz4_cuda, lz77_cuda, snappy_cuda

    batch = tpucomp_torch.pack_chunks(_chunks(np.random.default_rng(1), 8), capacity=CAP, device=cuda)
    codec = CODECS[name]
    comp = codec.compress(batch)
    counters = [cascaded_cuda.LAUNCHES, lz4_cuda.LAUNCHES, lz77_cuda.LAUNCHES, snappy_cuda.LAUNCHES]
    before = [dict(c) for c in counters]
    config.use_cuda_kernels = False
    with pytest.raises(ValueError, match="use_cuda_kernels is False"):
        codec.compress(batch)
    with pytest.raises(ValueError, match="use_cuda_kernels is False"):
        codec.decompress(comp, CAP)
    if name == "cascaded":
        with pytest.raises(ValueError, match="use_cuda_kernels is False"):
            codec.compress(batch, CascadedOpts(type=DataType.LONGLONG))
    torch.cuda.synchronize()
    assert [dict(c) for c in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODECS))
def test_sharded_over_one_card_three_times_equals_one_compress(cuda, name):
    """11 rows over [cuda:0] * 3: the padding and the order on the card."""
    chunks = _chunks(np.random.default_rng(2), 11)
    batch = tpucomp_torch.pack_chunks(chunks, capacity=CAP, device=cuda)
    codec, mesh = CODECS[name], sh.make_mesh([cuda] * 3)
    single = codec.compress(batch)
    comp = sh.sharded_compress(codec, batch, mesh, gather=True)
    assert torch.equal(comp.data, single.data) and torch.equal(comp.lengths, single.lengths)
    out, statuses = sh.sharded_decompress(codec, comp, CAP, mesh, gather=True)
    assert statuses.shape == (11,) and not statuses.any()
    assert tpucomp_torch.unpack_chunks(out) == chunks
