"""``k1_fill.infer``: % of the (row, branch) slots K1 walks that are active,
from the SSM blocks' counters ``ssm.k1_active`` over ``ssm.k1_slots``."""
from portbench.metrics._spans import infer_table


def read(r):
    t = infer_table(r)
    if t is None:
        return None
    c = t["counters"]
    slots, active = c.get("ssm.k1_slots"), c.get("ssm.k1_active")
    if not slots or active is None:
        return None
    return 100.0 * active / slots
