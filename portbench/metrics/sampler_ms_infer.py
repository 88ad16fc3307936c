"""``sampler_ms.infer``: ms a window-step spends outside UNet forwards
(the pipeline's stacking and budget, the guidance combine, the Euler step,
the overlap average, and host time the card waits on): the unprofiled
window less the benchmark's UNet spans in it, over its window-steps."""


def read(r):
    if r.unet_span_s is None or r.units <= 0:
        return None
    return 1e3 * max(0.0, r.window_s - r.unet_span_s) / r.units
