"""``mfu.infer``: see ``_shares.mfu``."""
from portbench.metrics._shares import mfu as read  # noqa: F401
