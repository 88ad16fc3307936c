"""``kernel_roofline.train``: see ``_shares.kernel_roofline``."""
from portbench.metrics._shares import kernel_roofline as read  # noqa: F401
