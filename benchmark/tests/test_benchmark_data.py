"""The frozen data sources give the port's corpus bytes, and the mixed
corpus is pinned by its hash."""

from __future__ import annotations

import gzip
import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness
from tpucomp_torch.utils import corpus

ROOT = Path(__file__).resolve().parents[2]
PARAMS = json.loads((ROOT / "benchmark" / "traffic" / "batch-mixed.json").read_text())["data_params"]


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, 123456789012])
def test_mixed_equals_the_port_corpus(seed):
    got = harness.load_module("data", "mixed").make(3 * 2**20 + 17, seed, ROOT, PARAMS)
    assert got == corpus.load_corpus(3 * 2**20 + 17, seed)


@pytest.mark.parametrize("seed", [0, 2, 9, 2**31 + 5])
def test_runheavy_equals_the_port_corpus(seed):
    got = harness.load_module("data", "runheavy").make(2**20 + 8, seed, ROOT, {})
    assert got == corpus.runheavy_corpus(2**20 + 8, seed)


def test_a_changed_corpus_fails_before_any_timing(tmp_path):
    (tmp_path / "corpus").mkdir()
    shutil.copy(ROOT / PARAMS["file"], tmp_path / PARAMS["file"])
    mixed = harness.load_module("data", "mixed")
    assert len(mixed.make(1000, 3, tmp_path, PARAMS)) == 1000
    blob = bytearray(gzip.decompress((ROOT / PARAMS["file"]).read_bytes()))
    blob[12345] ^= 1
    (tmp_path / PARAMS["file"]).write_bytes(gzip.compress(bytes(blob)))
    with pytest.raises(RuntimeError, match="sha256"):
        mixed.make(1000, 3, tmp_path, PARAMS)
    (tmp_path / PARAMS["file"]).unlink()
    with pytest.raises(FileNotFoundError):
        mixed.make(1000, 3, tmp_path, PARAMS)
