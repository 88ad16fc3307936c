"""What the readers of the program's own spans share: the port's span table
(``actalker_tpu_torch.utils.observability.span_table``). Spans record only
while a profiler runs, so the table holds the traced sub-window alone.

``table()`` is None where the program records no spans (a port without the
span API) or recorded none. ``infer_table(r)`` is also None unless the
sampler's counter of window-steps equals the traced window's, as the launch
counters guard ``kernel_roofline``."""
from __future__ import annotations


def table():
    try:
        from actalker_tpu_torch.utils import observability
    except ImportError:
        return None
    read = getattr(observability, "span_table", None)
    if read is None:
        return None
    t = read()
    return t if t.get("spans") else None


def infer_table(r):
    t = table()
    if t is None or r.traced_units <= 0:
        return None
    if t["counters"].get("sampler.window_steps") != r.traced_units:
        return None
    return t


def device_ms(t, name: str, key: str = "device_ms"):
    row = t["spans"].get(name)
    return None if row is None else row[key]
