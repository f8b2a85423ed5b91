"""The readings the limits of ``correct`` are set from, at a cell's own
size, on the card:

    python3 bench/calibrate.py --workload NAME --seeds 11 12 13

For each seed it works out the checked steps with the plain reference in
float32, and compares with them (``harness.compare``) runs put in the
program's place: the control, the reference computed with float8 e4m3
dense operands (the precision below the configuration's bfloat16), and
the faults: half the batch left out (the mean over the other half),
under MKOR the precondition skipped (both factors I), and every step
past the warm-up given the batch its graph was captured with (a replay
whose bound batch is never refreshed).  A step that returns its state unchanged reads 1 on
the change and needs no run.  One JSON line a seed.  The program's own
readings come from the benchmark's runs (``run.py``), which print them.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def readings(spec, seed: int, device: str = "cuda", names=None):
    """``{run: numbers, run + "_at": where each is worst}`` for the
    control and each fault (or the runs ``names``), for one seed."""
    import datagen
    import harness
    import reference
    cfg, traffic = spec.cfg, spec.traffic
    opt = traffic["optimizer"]
    k = harness.check_steps(opt, traffic["chunk"])
    pool = datagen.batch_pool(seed, traffic["pool_batches"],
                              traffic["batch"], traffic["seq_len"],
                              cfg["vocab_size"], traffic["markov"])
    batches = harness.to_device(pool[:k], device)

    def ref(**kw):
        return reference.run(cfg, opt, reference.init_weights(
            cfg, seed, device), batches, seed, **kw)

    runs = {"control": {"precision": "fp8"},
            "half_batch": {"half_batch": True},
            "stale_batch": {"stale_keys": harness.graph_keys(opt)}}
    if opt["name"] == "mkor":
        runs["identity_factors"] = {"identity_factors": True}
    want = ref()
    out = {}
    for name, kw in runs.items():
        if names is not None and name not in names:
            continue
        out[name] = harness.compare(ref(**kw), want)
        out[name + "_at"] = dict(harness.WORST)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import harness
    spec = harness.load_spec(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(spec, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
