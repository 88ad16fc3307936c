"""``k1_ms.infer``: K1's device ms a window-step (the grouped scan of the
SSM control blocks on their gather path)."""


def read(r):
    s = r.summary
    if s is None or r.traced_units <= 0 or "K1 grouped scan" not in s.groups:
        return None
    return 1e3 * s.groups["K1 grouped scan"] / r.traced_units
