"""The benchmark's runner: one cell, one seed, one run.

Everything that belongs to one configuration, traffic mix, data source,
entry or metric lives in a file of its own, found by the name that
``BENCHMARK.json`` or the traffic file gives it:

    configs/<file named in BENCHMARK.json>   the codec, its options, the partition size
    traffic/<traffic>.json                   data source and its parameters, entry, partitions a call
    data/<source>.py                         make(total_bytes, seed, root, params) -> bytes
    entries/<entry>.py                       Entry: the calls into tpucomp_torch, their host reads,
                                             and the comparison with the plain reference
    metrics/<metric>.py                      read(run) -> number, or None where it has nothing to read
    seed/<seed_transform>.py                 apply(raw, seed) -> bytes: how the seed varies the data
    reference/<codec>.py                     the plain reference the comparison runs, and the
                                             codec's header in a manager's artifact

A run is a closed loop: one caller issues calls back to back and each
call ends when its result is on the host.  The partitions come from the
traffic's data source at its own fixed ``data_seed``, in data order; the
run's seed changes their bytes only in a way that leaves the codec's work
as it is (the configuration's ``seed_transform``): every seed gets the
same work, since the order and mix of partitions set a kernel's time.  Set-up makes the
data, builds and warms the kernels on the cell's own shapes, reads the
scratch one compress needs, and makes the streams the decompress phase
restores.  The window then has two halves of ``seconds / 2``: repeated
compresses of the batch, and repeated decompresses of those streams.  A
traced run (``trace=True``) runs each half as a short profiled window
instead and reports the per-layer metrics.  After the window, with the
program's state freed, the outputs of two calls of each half (one drawn
from the seed among the first four, and the last) and set-up's compress,
whose streams the decompress half restores, are compared with the plain
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import stats, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PHASES = ("compress", "decompress")
TRACE_PHASE_S = 1.0  # the longest profiled window of a traced run, per phase
PAIRED_S = 2.0  # host-clock time spent on each phase's manager-against-codec pairs
FORBIDDEN = ("jax", "jaxlib", "flax", "tpucomp")  # top-level module names the run may not hold


@dataclasses.dataclass
class Phase:
    calls: int
    failed: int
    wall_s: float
    latencies_s: list
    retained: list


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    entry: object
    setup_s: float
    compress_peak_bytes: int | None  # None off the card
    phases: dict = dataclasses.field(default_factory=dict)   # phase -> Phase (untraced runs)
    windows: dict = dataclasses.field(default_factory=dict)  # phase -> trace.Window (traced runs)
    _paired: dict = dataclasses.field(default_factory=dict)

    @property
    def bytes_per_call(self) -> int:
        return self.entry.bytes_per_call

    def paired_ms(self, phase: str):
        """(median ms of the entry's call, median ms of the same work
        through its bypass), in turns, each ended by its host read; None
        for an entry with no bypass."""
        if phase not in self._paired:
            self._paired[phase] = paired_ms(self.entry, phase)
        return self._paired[phase]


def _reader_stems(name: str):
    """A metric's readers, most specific first: the name itself, then the
    name less its last ``.part`` (``idle_pct.compress.lz4`` ->
    ``idle_pct.compress``) and less its first ``part_``
    (``lz4_compress_roofline`` -> ``compress_roofline``)."""
    yield name
    if "." in name:
        yield from _reader_stems(name.rsplit(".", 1)[0])
    elif "_" in name:
        yield from _reader_stems(name.split("_", 1)[1])


def load_module(kind: str, name: str):
    """``<kind>/<name>.py``; a metric split by cells or codecs is read by
    its general reader unless it has one of its own (``_reader_stems``)."""
    stems = _reader_stems(name) if kind == "metrics" else [name]
    path = next((p for p in (HERE / kind / f"{stem}.py" for stem in stems) if p.exists()), None)
    if path is None:
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} in {HERE / kind}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, its cell, the cell's configuration, its traffic)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[name]
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, traffic


def metrics_of(spec: dict, cell_name: str, traced: bool) -> list[dict]:
    """The cell's metrics of one kind: per-layer when traced, else end-to-end."""
    return [m for m in spec["per_layer" if traced else "end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_phase(entry, phase: str, seconds: float, keep_index: int, span, dev: torch.device) -> Phase:
    """Calls back to back for ``seconds`` (at least one), each timed from
    its start to the end of its host read; keeps the outputs of call
    ``keep_index`` and of the last."""
    call, read_name = entry.calls[phase], f"{phase}.{entry.read_names[phase]}"
    lat, retained, failed, i = [], [], 0, 0
    _sync(dev)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with span(f"{phase}.call"):
            out = call()
        with span(read_name):
            ok = entry.read(phase, out)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        failed += not ok
        last = t1 - start >= seconds
        if i == keep_index or last:
            retained.append(out)
        del out
        i += 1
        if last:
            break
    _sync(dev)
    return Phase(calls=i, failed=failed, wall_s=time.perf_counter() - start, latencies_s=lat, retained=retained)


def paired_ms(entry, phase: str):
    bypass = entry.bypass(phase)
    if bypass is None:
        return None
    pairs = [(entry.calls[phase], lambda out: entry.read(phase, out)), bypass]
    ms = ([], [])
    start, turn = time.perf_counter(), 0
    while time.perf_counter() - start < PAIRED_S or turn < 2:
        for k in (0, 1) if turn % 2 == 0 else (1, 0):
            call, read = pairs[k]
            t0 = time.perf_counter()
            read(call())
            ms[k].append(1e3 * (time.perf_counter() - t0))
        turn += 1
    return float(np.median(ms[0])), float(np.median(ms[1]))


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips}


def smi(fields: str) -> str:
    """The card's ``fields`` as nvidia-smi reads them (its name and power
    limit go beside every number a run prints)."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, traced: bool, t0: float, device: str = "cuda",
             partitions: int | None = None, alter=None, root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line as a dict.

    ``partitions`` (the tests' small sizes) overrides the traffic's
    partitions a call; ``alter(entry)`` (the control and the tests'
    faults) changes the entry's calls before set-up."""
    marks = [("imports", time.perf_counter())]
    spec, cell, config, traffic = load_cell(name, root)
    dev = torch.device(device)
    seed = seed % (1 << 63)
    c = int(config["partition_bytes"])
    total = c * int(partitions or traffic["partitions"])
    raw = load_module("data", traffic["data"]).make(total, int(traffic["data_seed"]), root,
                                                    traffic.get("data_params", {}))
    raw = load_module("seed", config["seed_transform"]).apply(raw, seed)
    marks.append(("data", time.perf_counter()))
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    entry = load_module("entries", traffic["entry"]).Entry(config, traffic, data)
    del data
    if alter is not None:
        alter(entry)

    marks.append(("to_device", time.perf_counter()))
    # set-up: build and warm the kernels on this cell's shapes, read one
    # compress's scratch, make the streams the decompress phase restores
    streams_made = entry.calls["compress"]()
    entry.read("compress", streams_made)
    entry.prepare(streams_made)
    entry.read("decompress", entry.calls["decompress"]())
    marks.append(("build_and_warm_up", time.perf_counter()))
    peak_bytes, setup_peak = None, 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        entry.read("compress", entry.calls["compress"]())
        torch.cuda.synchronize(dev)
        peak_bytes = torch.cuda.max_memory_allocated(dev) - before
    setup_s = time.perf_counter() - t0
    marks.append(("peak_read", t0 + setup_s))
    keep = seed % 4
    log("set-up by stage: " + ", ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip([("", t0)] + marks, marks)))
    log(f"cell {name}: {entry.bytes_per_call} bytes a call, seed {seed}, set-up {setup_s:.3f} s; "
        f"card {smi('name,power.limit') if dev.type == 'cuda' else 'none'}")

    run = Run(entry, setup_s, peak_bytes)
    retained = {}
    for phase in PHASES:
        if traced:
            window_s = min(seconds / 2, TRACE_PHASE_S)
            res, run.windows[phase] = trace.profile(
                phase, lambda span: run_phase(entry, phase, window_s, keep, span, dev),
                lambda: entry.read(phase, entry.calls[phase]()))
        else:
            res = run_phase(entry, phase, seconds / 2, keep, trace.span_factory(False), dev)
            run.phases[phase] = res
            q, above = stats.p95(res.latencies_s)
            log(f"{phase}: {res.calls} calls in {res.wall_s:.4f} s, median {1e3 * float(np.median(res.latencies_s)):.4f} ms, "
                f"p95 {1e3 * q:.4f} ms with {above} of {res.calls} calls above it")
        retained[phase] = ([streams_made] if phase == "compress" else []) + res.retained
        run.phases.setdefault(phase, res)

    if dev.type == "cuda":
        log(f"card after the window: {smi('clocks.sm,clocks.mem,power.draw,temperature.gpu')}")
    metrics = {}
    for m in metrics_of(spec, name, traced):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    stream_bytes = entry.stream_bytes()
    log(f"ratio {entry.bytes_per_call / stream_bytes:.6f} ({entry.bytes_per_call} / {stream_bytes} bytes)")

    info = device_info(dev, int(cell.get("chips", 1)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        info["memory_peak_bytes"] = int(max(setup_peak, torch.cuda.max_memory_allocated(dev)))
    if traced:
        info["busy_s"] = sum(w.busy_s for w in run.windows.values())
        info["window_s"] = sum(w.window_s for w in run.windows.values())

    # the comparison, once the program's state is freed
    attempted = sum(p.calls for p in run.phases.values())
    failed = sum(p.failed for p in run.phases.values())
    entry.release()
    run.phases.clear()
    del streams_made
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    t_check = time.perf_counter()
    numbers = entry.check(retained, ref_data)
    numbers["calls_failed"] = failed
    log(f"comparison with the plain reference: {time.perf_counter() - t_check:.3f} s")
    checks = {k: {"value": int(v), "limit": 0} for k, v in numbers.items()}

    line = {"correct": all(v["value"] <= v["limit"] for v in checks.values()), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": info}
    if traced:
        line["breakdown"] = breakdown(run.windows)
    line["checks"] = checks
    return line


def breakdown(windows: dict) -> dict:
    """The device operations that took most time, and idle time by what
    the host was doing, over both traced windows."""
    ops, idle = {}, {}
    for w in windows.values():
        for k, v in w.op_s.items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in w.idle_s.items():
            idle[k] = idle.get(k, 0.0) + v
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def main(argv: list[str], t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 benchmark/run.py", description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the benchmark measures {chips} CUDA device(s) and found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures tpucomp_torch alone")
        return 3
    for k, v in line["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0
