"""Host seconds of the chunk runner's set-up in this process: its eager
warm-ups and graph captures, each ending in a synchronize (the program's
counter ``training/loop.py`` ``runner_counts()["capture_s"]``).  None
where the program has no such counter or captured nothing."""
import sys


def read(ctx):
    counts = getattr(sys.modules.get("repro_torch.training.loop"),
                     "runner_counts", None)
    if counts is None or not counts()["graphs"]:
        return None
    return counts()["capture_s"]
