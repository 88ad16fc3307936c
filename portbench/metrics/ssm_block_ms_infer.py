"""``ssm_block_ms.infer``: device ms a window-step in the program's
``unet.ssm`` spans (each control block: its projections, the gather, K1,
the scatter, the out-norm and out-projection)."""
from portbench.metrics._spans import device_ms, infer_table


def read(r):
    t = infer_table(r)
    ms = None if t is None else device_ms(t, "unet.ssm")
    return None if ms is None else ms / r.traced_units
