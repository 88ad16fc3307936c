"""One run of one cell, driven by ``BENCHMARK.json``.

The workload's entry names its configuration (``configs`` -> a JSON file
of sizes) and its traffic mix (``traffic/<mix>.json``, whose ``driver``
names the general code under ``drivers/`` that builds the system under
test and makes its inputs). Each per-layer metric is a reader under
``metrics/``, found by its name (``glue_share.train`` ->
``metrics/glue_share_train.py``). Adding a configuration, a mix or a
metric adds files and entries; no file here changes.

A run: set-up (imports, the port's kernels, seeded weights and inputs,
warm-up of every shape the traffic uses), then either the measured window
of ``--seconds`` (``--trace 0``: the end-to-end metrics) or a short traced
sub-window (``--trace 1``: the per-layer metrics), then the correctness
check against the plain reference once the program's state is freed.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "actalker_tpu")
GIB = 2 ** 30


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; the interpreter's
    start, before any import)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def metric_module(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict          # the configuration file's contents
    traffic: dict
    bench: dict

    def metrics(self, kind: str) -> List[dict]:
        name = self.workload["name"]
        return [m for m in self.bench[kind]
                if "workloads" not in m or name in m["workloads"]]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(wl, config, traffic, bench)


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc libraries go to its own ``_build/``)."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


class Readings:
    """What a per-layer reader takes from a ``--trace 1`` run.

    The unprofiled window (host clock, as the ``--trace 0`` window, with
    the benchmark's UNet spans): ``window_s``, the ``units`` it completed
    (window-steps or micro-steps) and ``unet_span_s``. The traced
    sub-window that follows it (``torch.profiler``, which slows the host):
    its reduction ``summary``, ``traced_units``, ``commits``, and the
    port's kernel launch counters over it. The yardsticks: least seconds
    per unit by kernel, model FLOPs per unit."""

    def __init__(self):
        self.window_s = 0.0
        self.units = 0
        self.unet_span_s: Optional[float] = None
        self.summary = None
        self.traced_units = 0
        self.commits = 0
        self.launches: Dict[str, int] = {}
        self.bounds: Dict[str, tuple] = {}
        self.flops_per_unit: Optional[float] = None


def read_metric(name: str, readings: Readings) -> Optional[float]:
    mod = importlib.import_module(f"portbench.metrics.{metric_module(name)}")
    value = mod.read(readings)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def run(args) -> int:
    import torch

    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return measure(cell, driver, dev, args.seed, args.seconds, args.trace)


def measure(cell: Cell, driver, dev, seed: int, seconds: float, trace: bool) -> int:
    """Set-up, window, check and the result line; the device may be the CPU
    (the tests drive a run at micro size)."""
    import torch

    cuda = dev.type == "cuda"
    state = driver.setup(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    _log(f"set-up {setup_s:.2f} s")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    readings = Readings()
    if trace:
        from portbench.trace import Tracer

        # the unprofiled window first (the host-clock readings), then the
        # traced sub-window (the device's readings)
        with driver.instrument(state, readings):
            window_s, units = _window(driver, state, seconds, cuda)
        traced = Readings()
        t0 = time.perf_counter()
        with driver.instrument(state, traced):
            with Tracer() if cuda else _NoTrace() as tracer:
                for _ in range(int(cell.traffic["trace_calls"])):
                    readings.traced_units += driver.call(state)
                if not cuda:
                    tracer.window_s = time.perf_counter() - t0
        readings.summary = tracer.summary
        readings.commits, readings.launches = traced.commits, traced.launches
        if readings.traced_units:
            _log(f"profiler: {tracer.window_s / readings.traced_units:.4f} s a unit "
                 f"traced, {window_s / units:.4f} unprofiled")
    else:
        window_s, units = _window(driver, state, seconds, cuda)
    readings.window_s, readings.units = window_s, units
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = driver.outcome(state)
    driver.yardsticks(state, readings)

    _log(f"window {window_s:.3f} s, {units} units, peak {window_peak / GIB:.3f} GiB")
    driver.release(state)
    t_check = time.perf_counter()
    compared = driver.check(state, trace, readings)
    _log(f"check {time.perf_counter() - t_check:.2f} s")
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that no run may hold: {found}",
              file=sys.stderr)
        return 4

    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            v = read_metric(m["name"], readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(state, window_s, units)
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gib"] = window_peak / GIB
        for m in cell.metrics("end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in compared) and failed == 0
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": int(cell.workload["chips"]),
              "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if trace and readings.summary is not None:
        s = readings.summary
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": [[g, v] for g, v in s.device_ops()],
                               "idle_gaps": [[g, v] for g, v in s.idle_gaps]}
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    for n, v, lim in compared:
        print(f"compared {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _window(driver, state, seconds: float, cuda: bool):
    """Whole calls, the card synchronized after each, until ``seconds``
    have passed: (host seconds, units completed)."""
    import torch

    units = 0
    t0 = time.perf_counter()
    ends = [0.0]
    while True:
        units += driver.call(state)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        ends.append(window_s)
        if window_s >= seconds:
            # each call's seconds, to tell a pace that drifts within a run
            # from one that each process keeps
            calls = " ".join(f"{b - a:.4f}" for a, b in zip(ends, ends[1:]))
            _log(f"calls (s): {calls}")
            return window_s, units


def _log(msg: str) -> None:
    print(f"[portbench {process_age_s():8.2f}] {msg}", file=sys.stderr, flush=True)


class _NoTrace:
    summary = None
    window_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
