"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
train step's phases read out of the trace in full (``phases.breakdown``):

    python3 bench/phase_report.py --workload NAME --seed N [--out DIR]

Prints one JSON line: the run's result line (``result``), the program's
chunk-runner counts, and for each phase and the runner its ms a step,
busy and idle ms a step, kernels a step, kernel ms a step by
``devtrace.kind`` and the five largest kernels by name; with the share of
the precondition and SMW kernels' time that falls in ``second_order``, of
the library GEMMs' in ``forward`` and ``backward``, and where the
``direct_copy_kernel`` time falls.  ``--out`` also writes the line to
``DIR/<workload>.<seed>.json``.
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
sys.path.insert(0, str(ROOT / "src"))


def shares(rows):
    """Shares of kernel kinds' time by phase, from ``breakdown`` rows."""
    def total(kinds, phase_names):
        return sum(rows[p]["kinds"].get(k, 0.0) for p in phase_names
                   if p in rows for k in kinds)
    every = list(rows)
    out = {}
    own = total(("precond", "smw"), every)
    if own:
        out["own_in_second_order"] = total(("precond", "smw"),
                                           ["second_order"]) / own
    gemm = total(("gemm",), every)
    if gemm:
        out["gemm_in_forward_backward"] = total(
            ("gemm",), ["forward", "backward"]) / gemm
    out["direct_copy_ms"] = {
        p: sum(v for k, v in r["ops"].items() if "direct_copy" in k)
        for p, r in rows.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    import devtrace
    import harness
    import phases
    traces = []

    class Kept(devtrace.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            traces.append(self)

    # the harness builds its Trace through its ``trace_lib``: keep it
    harness.trace_lib = type(sys)("kept_devtrace")
    harness.trace_lib.__dict__.update(devtrace.__dict__, Trace=Kept)
    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    result = harness.run(spec, args.seed % (2 ** 63), 0.0, True, T_START)
    tr = traces[-1]
    rows = phases.breakdown(tr, top=None)
    counts = getattr(sys.modules.get("repro_torch.training.loop"),
                     "runner_counts", lambda **_: {})
    line = {"workload": args.workload, "seed": args.seed,
            "steps": tr.steps, "window_s": tr.window_s,
            "whole_steps": len(phases.whole_steps(tr)),
            "runner_counts": counts(),
            "runner_counts_by_key": {str(k): v for k, v in
                                     counts(by_key=True).items()},
            "shares": shares(rows) if rows else None,
            "phases": rows and {
                p: {**r, "ops": dict(list(r["ops"].items())[:8])}
                for p, r in rows.items()},
            "result": result}
    text = json.dumps(line)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"{args.workload}.{args.seed}.json").write_text(
            text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
