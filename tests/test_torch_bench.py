"""The port's bench (tpucomp_torch.bench), the counterpart of
tests/test_bench.py, on the CPU (``device="cpu"``: the plain versions,
timed on the host clock, which is no device metric and is not asserted).

The Cascaded streams are byte-identical to tpucomp's, so the port's bench
ratio at 1 MB must equal the JAX bench's exactly, on both corpora.  The
LZ cells run on 4 partitions: the plain LZ encoders step one sequence at
a time.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench

from tpucomp_torch import bench as tbench


@pytest.mark.parametrize("kind", ["mixed", "runheavy"])
def test_cascaded_ratio_equals_the_jax_bench(kind):
    want = bench.bench_cascaded(total_mb=1, iters=1, tile=8, corpus_kind=kind)
    got = tbench.bench_cascaded(total_mb=1, iters=1, warmup=0, corpus_kind=kind, device="cpu")
    assert got["roundtrip_ok"] is True and want["roundtrip_ok"] is True
    assert got["ratio"] == want["ratio"]
    assert got["bytes"] == 1 << 20 and got["partitions"] == 16
    assert got["encode_gbps"] > 0 and got["decode_gbps"] > 0
    assert got["peak_compress_bytes"] is None and got["build_s"] is None  # no card: no device numbers
    assert got["launches"] == {}  # a CPU batch takes the plain versions


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_lz_round_trip_on_four_partitions(codec):
    r = tbench.bench_lz(codec, total_mb=0.25, iters=1, warmup=0, device="cpu")
    assert r["roundtrip_ok"] is True
    assert r["partitions"] == 4 and r["seed"] == 1
    assert r["ratio"] > 1.0


def test_ceiling_copies_both_forms():
    r = tbench.bench_cascaded(total_mb=0.25, iters=1, warmup=0, corpus_kind="runheavy", measure_roofline=True,
                              device="cpu")
    assert r["roundtrip_ok"] is True
    for k in ("copy", "memcpy"):
        assert r[f"{k}_gbps"] > 0 and r[f"{k}_ms"] > 0


def test_main_prints_one_line_on_the_cpu(capsys):
    assert tbench.main(["--codec", "main", "--mb", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"]["platform"] == "cpu" and line["vs_baseline"] is None
    assert line["unit"] == "GB/s" and line["value"] > 0
    assert set(line["cells"]) == {"cascaded", "cascaded-runheavy", "lz4"}
    for name, cell in line["cells"].items():
        assert cell["roundtrip_ok"] is True and cell["bytes"] == 1 << 20, name
    assert "memcpy_gbps" in line["cells"]["cascaded"]
    heads = [min(line["cells"][k]["encode_gbps"], line["cells"][k]["decode_gbps"]) for k in ("cascaded", "lz4")]
    assert line["value"] == pytest.approx((heads[0] * heads[1]) ** 0.5, rel=1e-12)
    assert line["metric"].startswith("geomean min(enc,dec)") and "cascaded-mixed:enc=" in line["metric"]


def test_without_a_card_the_bench_raises_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tbench.main(["--codec", "main", "--mb", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tbench.bench_lz("lz4", total_mb=1)
    assert capsys.readouterr().out == ""


def test_a_failed_round_trip_prints_the_line_and_exits_1(monkeypatch, capsys):
    from tpucomp_torch.codecs import cascaded as cc

    real = cc.decompress

    def wrong(comp, sizes, opts, cap):
        data, lengths, statuses = real(comp, sizes, opts, cap)
        return data ^ 1, lengths, statuses

    monkeypatch.setattr(cc, "decompress", wrong)
    assert tbench.main(["--codec", "cascaded-runheavy", "--mb", "0.25", "--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["cells"]["cascaded-runheavy"]["roundtrip_ok"] is False


@pytest.mark.parametrize("cell", sorted(tbench.CELLS))
def test_cell_batch_holds_the_jax_bench_bytes(cell):
    """Each cell's batch is the JAX bench's corpus for that cell (bench.py:
    Cascaded mixed seed 0 and runheavy seed 2, LZ mixed seed 1), cut into
    full 64 KB partitions."""
    codec, kind, seed = tbench.CELLS[cell]
    total = 1 << 18
    want = bench.runheavy_corpus(total) if kind == "runheavy" else bench.load_corpus(total, seed=seed)
    batch = tbench.cell_batch(cell, total_mb=0.25, device="cpu")
    assert batch.data.shape == (4, tbench.CHUNK) and batch.data.dtype == torch.uint8
    assert batch.data.numpy().tobytes() == want
    assert batch.lengths.tolist() == [tbench.CHUNK] * 4


def _fake_card(monkeypatch, smi_line):
    """torch.cuda and nvidia-smi faked for one card known by its UUID;
    returns the nvidia-smi argv seen."""
    import subprocess
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: SimpleNamespace(uuid="1234-abcd"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    seen = []

    def run(argv, **kw):
        seen.append(argv)
        return subprocess.CompletedProcess(argv, 0, stdout=smi_line + "\n", stderr="")

    monkeypatch.setattr(tbench.subprocess, "run", run)
    return seen


def test_device_info_asks_nvidia_smi_for_this_card_only(monkeypatch):
    seen = _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3, 500.00 W")
    info = tbench.device_info(torch.device("cuda", 0))
    assert seen and "--id=GPU-1234-abcd" in seen[0]
    assert info["kind"] == "NVIDIA H100 80GB HBM3" and info["power_limit"] == "500.00 W"


def test_device_info_refuses_another_cards_line(monkeypatch):
    _fake_card(monkeypatch, "NVIDIA A100-SXM4-40GB, 400.00 W")
    with pytest.raises(RuntimeError, match="nvidia-smi reports"):
        tbench.device_info(torch.device("cuda", 0))
