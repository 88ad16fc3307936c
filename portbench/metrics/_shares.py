"""Arithmetic the readers share: shares of the traced device time, the
kernels' roofline, the whole step's share of the bf16 peak, the device's
idle share.

The profiler slows the host (on an H100's host a traced training
micro-step took 66-82% longer), so what depends on the host's pace (``mfu``, ``device_idle``)
takes its time from the unprofiled window, and only the device's own
time from the trace."""
from __future__ import annotations

from portbench.roofline import PEAK_BF16


def glue_share(r):
    """% of the device time in kernels that are neither the port's own
    nor cuBLAS / cuDNN (plain glue: norms, elementwise, copies, reductions,
    memcpy / memset)."""
    s = r.summary
    total = sum(s.groups.values()) if s is not None else 0.0
    return None if total <= 0 else 100.0 * s.glue_s() / total


def kernel_roofline(r):
    """% of the port's kernel time that their least time takes: the bound
    of every launch the window should hold (launches per unit, checked
    against the port's own launch counters) over the device time of the
    port's kernel groups."""
    s = r.summary
    if s is None or not r.bounds or r.traced_units <= 0:
        return None
    for name, (per_unit, _) in r.bounds.items():
        if r.launches.get(name) != per_unit * r.traced_units:
            return None
    spent = s.port_s()
    least = sum(secs for _, secs in r.bounds.values()) * r.traced_units
    return None if spent <= 0 else 100.0 * least / spent


def mfu(r):
    """% of the bf16 peak that the model FLOPs of the completed units take
    over the unprofiled window (host clock)."""
    if not r.flops_per_unit or r.window_s <= 0:
        return None
    return 100.0 * r.flops_per_unit * r.units / (r.window_s * PEAK_BF16)


def device_idle(r):
    """% of the unprofiled window in which no operation runs on the card:
    one less the device's busy seconds a unit (from the trace; the card's
    work does not change under the profiler) over the unprofiled window's
    seconds a unit."""
    s = r.summary
    if s is None or r.traced_units <= 0 or r.units <= 0 or r.window_s <= 0:
        return None
    busy = s.busy_s / r.traced_units
    return 100.0 * max(0.0, 1.0 - busy / (r.window_s / r.units))
