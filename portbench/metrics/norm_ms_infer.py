"""``norm_ms.infer``: device ms a window-step in the program's ``unet.norm``
spans (the plain GroupNorm / LayerNorm paths, or the fused calls), each
from its start event to its end event."""
from portbench.metrics._spans import device_ms, infer_table


def read(r):
    t = infer_table(r)
    ms = None if t is None else device_ms(t, "unet.norm")
    return None if ms is None else ms / r.traced_units
