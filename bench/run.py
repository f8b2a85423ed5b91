"""The benchmark of the PyTorch and CUDA port of MKOR, one run of one cell:

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cell's cards.  It makes
the weights and token batches from the seed, sets up the port's training
step and chunk runner, warms up and captures every graph, then runs whole
chunks for ``--seconds`` seconds (``--trace 0``: the end-to-end metrics)
or traces a fixed number of chunks with ``torch.profiler`` (``--trace
1``: the per-layer metrics), and checks the set-up's steps, the last of
them graph replays, against the plain reference (``reference.py``).  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
compared number with its limit); the compared numbers are also the last
lines of standard error.  Kernel builds stay inside the checkout
(``build/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" /
                                                  "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    import harness
    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(spec, args.seed % (2 ** 63), args.seconds,
                         bool(args.trace), T_START)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
