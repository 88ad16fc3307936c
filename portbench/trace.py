"""The traced sub-window: ``torch.profiler`` on the card, read back from
its chrome trace into device intervals grouped by kernel family, the busy
time, and the idle gaps labelled by what the host was doing.

The group table is a copy of the port's ``tools/profile_step.py``
``GROUPS`` (first match wins; the port's own kernels first).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

GROUPS = (
    ("K1 grouped scan", ("ssm_grouped_kernel",)),
    ("K5 scan", ("ssm_scan_",)),
    ("K6 scan adjoint", ("ssm_bwd_",)),
    ("K2 attention", ("mha_fwd_kernel",)),
    ("K2-bwd attention backward", ("dkdv_kernel", "dq_kernel", "row_dot")),
    ("K3 frame attention", ("frame_attn_",)),
    ("K4 GEGLU", ("gemm_tn_kernel",)),
    ("K7-LN layer norm", ("layer_norm_",)),
    ("K7-GN group norm", ("gn_stats_kernel", "gn_finalize_kernel",
                          "gn_apply_kernel", "gn_cluster_kernel")),
    ("K8 GN + SiLU + conv3x3", ("gn_silu_conv3x3_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("cuDNN convs", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "cublas", "splitk")),
    ("reductions", ("reduce", "norm_kernel", "softmax")),
    ("memcpy / memset", ("memcpy", "memset")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled",
                                "copy", "cat", "index", "fill")),
)
# the library groups; every other group that is not one of the port's
# own kernels ("K...") is plain glue
LIBRARY = ("cuDNN convs", "cuBLAS GEMMs")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def is_port_kernel(group: str) -> bool:
    return group.startswith("K")


class Summary:
    """What the readers take from one traced window."""

    def __init__(self, window_s: float, groups: Dict[str, float],
                 busy_s: float, idle_gaps: List[Tuple[str, float]]):
        self.window_s = window_s
        self.groups = groups            # group -> device seconds
        self.busy_s = busy_s            # union of device intervals
        self.idle_gaps = idle_gaps      # (host activity, seconds), longest first

    def device_ops(self, top: int = 10):
        return sorted(self.groups.items(), key=lambda kv: -kv[1])[:top]

    def glue_s(self) -> float:
        return sum(s for g, s in self.groups.items()
                   if not is_port_kernel(g) and g not in LIBRARY)

    def port_s(self) -> float:
        return sum(s for g, s in self.groups.items() if is_port_kernel(g))


def _union(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def summarize(events, t0_us: float, t1_us: float, window_s: float) -> Summary:
    """Reduce chrome-trace events clipped to [t0, t1] (profiler clock, us)."""
    groups, dev = {}, []
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            a0, b0 = max(a, t0_us), min(a + d, t1_us)
            if b0 <= a0:
                continue
            g = group_of(e["name"]) if cat == "kernel" else "memcpy / memset"
            groups[g] = groups.get(g, 0.0) + (b0 - a0) / 1e6
            dev.append((a0, b0))
        elif cat in ("cpu_op", "cuda_runtime", "user_annotation", "python_function"):
            host.append((a, a + d, e["name"]))
    busy = _union(dev) / 1e6
    # device gaps inside the window, each labelled by the innermost host
    # event running when it opened
    gaps = {}
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    cursor = t0_us
    for a, b in dev + [(t1_us, t1_us)]:
        if a > cursor:
            label, best = "host idle", None
            i = bisect.bisect_right(starts, cursor)
            for ha, hb, name in reversed(host[max(0, i - 500):i]):
                if hb > cursor and (best is None or hb - ha < best):
                    label, best = name, hb - ha
            gaps[label] = gaps.get(label, 0.0) + (a - cursor) / 1e6
        cursor = max(cursor, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s, groups, busy, idle)


class Tracer:
    """``with Tracer() as t: ...`` profiles the block on a synchronized card;
    afterwards ``t.summary`` holds its reduction. The chrome trace is
    written under the run's TMPDIR and removed once read."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.mark0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        kern = [float(e["ts"]) for e in xs if e.get("cat") == "kernel"]
        ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in xs
                if e.get("cat") == "kernel"]
        if not kern:
            self.summary: Optional[Summary] = None
            return False
        # the profiler's clock spans the window from its first host event
        t0 = min(float(e["ts"]) for e in xs)
        t1 = max(max(ends), t0 + self.window_s * 1e6)
        self.summary = summarize(events, t0, t1, (t1 - t0) / 1e6)
        return False
