"""``device_idle.train``: see ``_shares.device_idle``."""
from portbench.metrics._shares import device_idle as read  # noqa: F401
