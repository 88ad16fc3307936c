"""``commit_ms.train``: device ms a commit in the program's
``trainer.commit`` spans (divide, clip, AdamW, the gradients cleared),
when the spans count the traced window's commits."""
from portbench.metrics._spans import table


def read(r):
    t = table()
    row = None if t is None else t["spans"].get("trainer.commit")
    if row is None or r.commits <= 0 or row["n"] != r.commits:
        return None
    return row["device_ms"] / r.commits
