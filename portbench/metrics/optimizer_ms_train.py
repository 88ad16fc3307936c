"""``optimizer_ms.train``: device ms of the optimizer's multi-tensor
kernels (grad-norm clip and AdamW) a commit."""


def read(r):
    s = r.summary
    ms = s.groups.get("optimizer (multi-tensor)") if s is not None else None
    if not ms or r.commits <= 0:
        return None
    return 1e3 * ms / r.commits
