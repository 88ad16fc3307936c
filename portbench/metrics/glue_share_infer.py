"""``glue_share.infer``: see ``_shares.glue_share``."""
from portbench.metrics._shares import glue_share as read  # noqa: F401
