"""GiB by which the chunk runner's captures grew the device's reserved
memory in this process: the program's counter ``training/loop.py``
``runner_counts()["pool_bytes"]`` (the reserved bytes right after each
capture less right after the cache was emptied before it).  None where
the program has no such counter or captured nothing."""
import sys


def read(ctx):
    counts = getattr(sys.modules.get("repro_torch.training.loop"),
                     "runner_counts", None)
    if counts is None or not counts()["graphs"]:
        return None
    return counts()["pool_bytes"] / 2 ** 30
