"""The plain Snappy reference (``reference/snappy.py``) against the
sequential oracle and the port's plain encoder, on small rows; its control
against both, and through the oracle's decoder; its artifact header
against the port's manager."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tpucomp_torch
from benchmark import harness
from benchmark.reference import artifact
from benchmark.reference import snappy as ref

ROOT = Path(__file__).resolve().parents[2]
_spec = importlib.util.spec_from_file_location("snappy_oracle", ROOT / "tests" / "oracles" / "snappy_oracle.py")
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)
MIXED = json.loads((ROOT / "benchmark" / "traffic" / "batch-mixed.json").read_text())["data_params"]


def _rows(name: str) -> list[bytes]:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":  # few symbols: matches everywhere; all 256: none
        return [rng.integers(0, k, n, dtype=np.uint8).tobytes() for k, n in ((2, 8192), (4, 5000), (256, 3000))]
    if name == "corpus":
        blob = harness.load_module("data", "mixed").make(3 * 8192, 11, ROOT, MIXED)
        return [blob[i : i + 8192] for i in range(0, len(blob), 8192)]
    if name == "runs":
        return [bytes(8192), b"abc" * 2000, bytes(rng.integers(0, 256, 4100, dtype=np.uint8)) * 2]
    return [bytes(rng.integers(0, 3, n, dtype=np.uint8)) for n in range(6)]  # lengths 0 to 5


def _batch(rows: list[bytes]):
    c = max(8, max(map(len, rows)))
    data = torch.zeros(len(rows), c, dtype=torch.uint8)
    for i, r in enumerate(rows):
        data[i, : len(r)] = torch.from_numpy(np.frombuffer(r, np.uint8).copy())
    return data, torch.tensor([len(r) for r in rows], dtype=torch.int32)


def _streams(out: torch.Tensor, sizes: torch.Tensor) -> list[bytes]:
    return [bytes(out[i, : int(sizes[i])].numpy()) for i in range(out.shape[0])]


CASES = ["random", "corpus", "runs", "short"]


@pytest.mark.parametrize("case", CASES)
def test_reference_equals_the_oracle_and_the_port(case):
    rows = _rows(case)
    data, lengths = _batch(rows)
    out, sizes = ref.compress(data, lengths, {}, block_rows=2)
    assert out.shape == (len(rows), ref.max_compressed_size(data.shape[1])) and sizes.dtype == torch.int32
    assert _streams(out, sizes) == [oracle.snappy_compress_oracle(r) for r in rows]
    port = tpucomp_torch.snappy_codec.compress(tpucomp_torch.ChunkBatch(data, lengths), tpucomp_torch.SnappyOpts())
    assert torch.equal(sizes, port.lengths) and torch.equal(out, port.data)


@pytest.mark.parametrize("case", CASES)
def test_control_is_lossless_snappy_with_a_4k_window(case):
    rows = _rows(case)
    data, lengths = _batch(rows)
    got = _streams(*ref.compress(data, lengths, {}, **ref.CONTROL))
    assert got == [oracle.snappy_compress_oracle(r, max_offset=ref.CONTROL["max_offset"]) for r in rows]
    assert [oracle.snappy_decompress_oracle(s) for s in got] == rows
    if case in ("corpus", "runs"):  # matches past 4095 bytes back: other bytes than tpucomp's
        assert got != _streams(*ref.compress(data, lengths, {}))


def test_artifact_header_equals_the_port_manager():
    buf = torch.frombuffer(bytearray(_rows("corpus")[0] + _rows("runs")[1][:1808]), dtype=torch.uint8)
    c = 4096
    art, size = tpucomp_torch.SnappyManager(uncomp_chunk_size=c, device="cpu").compress(buf)
    k = -(-buf.numel() // c)
    padded = torch.zeros(k * c, dtype=torch.uint8)
    padded[: buf.numel()] = buf
    lengths = (buf.numel() - torch.arange(k) * c).clamp(0, c).to(torch.int32)
    want = artifact.build("snappy", {}, *ref.compress(padded.view(k, c), lengths, {}), buf.numel(), c)
    assert torch.equal(art[:size], want)
