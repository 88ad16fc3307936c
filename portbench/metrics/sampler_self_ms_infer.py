"""``sampler_self_ms.infer``: device ms a window-step that the sampler's own
spans hold outside their children: ``sampler.window`` less its UNet call
(input stacking, guidance combine, Euler step, overlap ``index_add_``),
plus ``sampler.step`` less its windows (the step's set-up and average)."""
from portbench.metrics._spans import device_ms, infer_table


def read(r):
    t = infer_table(r)
    if t is None:
        return None
    ms = [device_ms(t, n, "self_device_ms") for n in ("sampler.window", "sampler.step")]
    if None in ms:
        return None
    return sum(ms) / r.traced_units
