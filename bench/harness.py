"""One run of one cell: set-up, the measured (or traced) window, the
reading of the metrics, and the comparison with the plain reference that
decides ``correct``.

The cell's configuration, traffic mix, limits and per-layer readers are
files found by name (``configs/``, ``traffic/``, ``limits/``,
``metrics/``); nothing here names a cell.  The program under test is
``repro_torch``: the launcher's optimizer (``launch/train.py``
``build_optimizer``), the train step (``training/loop.py``
``make_train_step``) and the chunk runner (``make_chunk_runner``), whose
steps are CUDA graph replays with one metrics fetch a chunk.  The weights
and the token batches are the benchmark's, made from the seed
(``reference.init_weights``, ``datagen.batch_pool``), and the program gets
the same tensors the reference starts from.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import datagen
import reference
import devtrace as trace_lib

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")
BETA1 = 0.9                      # LAMB's first-moment decay
REPLAYS_CHECKED = 3              # steps past the warm-up the check follows


def graph_keys(opt: Dict) -> int:
    """The chunk runner's graphs: one a ``count % inv_freq`` residue under
    MKOR, one under LAMB."""
    return opt["inv_freq"] if opt["name"] == "mkor" else 1


def warmup_steps(opt: Dict) -> int:
    """Steps before every graph has been captured and replayed once: each
    key's first step runs eagerly, its second is captured and replayed."""
    return 2 * graph_keys(opt)


def check_steps(opt: Dict, chunk: int) -> int:
    """Steps the correctness check follows, whole chunks from the first:
    the warm-up, then at least ``REPLAYS_CHECKED`` steps that replay a
    graph captured before (as every step of the window does).  Under MKOR
    the warm-up is two ``inv_freq`` periods, so every group of layers has
    inverted twice."""
    n = warmup_steps(opt) + REPLAYS_CHECKED
    return -(-n // chunk) * chunk


def load_spec(workload: str) -> SimpleNamespace:
    """The cell ``workload`` of ``BENCHMARK.json``: its configuration, its
    traffic mix, its limits and its per-layer metric names."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}
    per_layer = [m["name"] for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return SimpleNamespace(name=workload, chips=cell["chips"], cfg=cfg,
                           traffic=traffic, limits=limits,
                           per_layer=per_layer, end_to_end=end_to_end)


def load_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# --------------------------------------------------------------------- #
# The program under test
# --------------------------------------------------------------------- #
class Program:
    """The launcher's optimizer, train step and chunk runner for a cell,
    on ``device``; ``fault`` wraps the train step (the fault tests)."""

    def __init__(self, cfg: Dict, traffic: Dict, device: str,
                 fault: Optional[Callable] = None):
        import dataclasses
        from repro_torch.launch import train as launcher
        from repro_torch.models import config as config_lib
        from repro_torch.models import model as model_lib
        from repro_torch.training import loop
        fields = {f.name for f in dataclasses.fields(config_lib.ModelConfig)}
        kw = {k: v for k, v in cfg.items() if k in fields and k != "pattern"}
        self.model_cfg = config_lib.ModelConfig(
            **kw, pattern=tuple(config_lib.LayerSpec(**p)
                                for p in cfg["pattern"]))
        opt = traffic["optimizer"]
        # the kernels on the card; the CPU tests run the plain route
        self.opt, _ = launcher.build_optimizer(
            opt["name"], opt["lr"], inv_freq=opt.get("inv_freq", 10),
            rank=opt.get("rank", 1), staleness=opt.get("staleness", 0),
            quant=opt.get("factor_quant", "none"),
            use_kernels=device == "cuda")
        step = loop.make_train_step(self.model_cfg, self.opt)
        if fault is not None:
            step = fault(step)
        self.runner = loop.make_chunk_runner(step)
        self.meta = reference.flatten(model_lib.init_params(
            self.model_cfg, device="meta"))

    def check_layout(self, params: Dict) -> None:
        """The benchmark's weights must be the program's tree, leaf for
        leaf, in shape and dtype."""
        ours = reference.flatten(params)
        if sorted(ours) != sorted(self.meta):
            raise SystemExit(f"parameter trees differ: benchmark "
                             f"{sorted(set(ours) - set(self.meta))}, program "
                             f"{sorted(set(self.meta) - set(ours))}")
        for k, t in ours.items():
            m = self.meta[k]
            if tuple(t.shape) != tuple(m.shape) or t.dtype != m.dtype:
                raise SystemExit(f"leaf {k}: benchmark {tuple(t.shape)} "
                                 f"{t.dtype}, program {tuple(m.shape)} "
                                 f"{m.dtype}")


def lamb_moments(state: Dict) -> Dict:
    return state["backend"]["m"] if "backend" in state else state["m"]


def offdiag_norm(j, rows: int = 2048) -> float:
    """‖J − diag(J)‖_F of one (d, d) slice, in float32, by row blocks."""
    import torch
    total = 0.0
    for r0 in range(0, j.shape[0], rows):
        blk = j[r0:r0 + rows].float()
        idx = torch.arange(blk.shape[0], device=blk.device)
        blk[idx, idx + r0] = 0.0
        total += float(blk.square().sum())
    return math.sqrt(total)


def program_offdiag(state: Dict, params_flat: Dict) -> Dict[str, List[float]]:
    """The off-diagonal norms of the program's factor banks, by
    ``<layer>/<side>`` and stacked slice (the banks' slots are the layers
    of one shape, in sorted path order)."""
    out = {}
    groups = reference.factor_groups(params_flat)
    for gid, bank in state.get("factor_banks", {}).items():
        for slot, layer in enumerate(groups[gid]):
            for side in ("l_inv", "r_inv"):
                j = bank[side][slot]
                out[f"{layer}/{side}"] = [
                    offdiag_norm(s) for s in j.reshape(-1, *j.shape[-2:])]
    return out


def state_bytes(tree) -> int:
    seen, total = set(), 0
    for t in reference.flatten(tree).values():
        if hasattr(t, "untyped_storage") and t.device.type != "cpu":
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


# --------------------------------------------------------------------- #
# The comparison
# --------------------------------------------------------------------- #
def _median_nonzero(values: List[float]) -> float:
    nz = [v for v in values if v > 0]
    return statistics.median(nz) if nz else 0.0


WORST: Dict[str, str] = {}       # the key each number's worst gap is at


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keys: List[str]) -> Dict[str, float]:
    """|got − want| / max(want, median of want) for each of ``keys``."""
    med = _median_nonzero([want[k] for k in keys])
    out = {}
    for k in keys:
        den = max(want[k], med)
        gap = abs(got[k] - want[k]) / den if den > 0 else \
            (0.0 if got[k] == want[k] else math.inf)
        out[k] = math.inf if math.isnan(gap) else gap
    return out


def _worst_and_median(out: Dict[str, float], name: str,
                      gaps: Dict[str, float]) -> None:
    WORST[name] = max(gaps, key=gaps.get)
    out[name] = gaps[WORST[name]]
    out[name + "_median"] = statistics.median(gaps.values())


def direction_gaps(got: Dict[str, List[float]], want: Dict[str, List[float]],
                   norms: Dict[str, float], keys: List[str]
                   ) -> Dict[str, float]:
    """For each of ``keys``: the root mean square over the seeded
    directions of the gap between the program's and the reference's
    projections of LAMB's first moment (an estimate of the norm of their
    difference), over the reference's moment norm (``norms``) or the
    median leaf's, whichever is larger."""
    med = _median_nonzero([norms[k] for k in keys])
    out = {}
    for k in keys:
        den = max(norms[k], med)
        rms = math.sqrt(statistics.fmean(
            (g - w) ** 2 for g, w in zip(got[k], want[k])))
        gap = rms / den if den > 0 else (0.0 if rms == 0 else math.inf)
        out[k] = math.inf if math.isnan(gap) else gap
    return out


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers the comparison can hold the program to: each step's
    loss (the worst relative gap, and the first step's), the first
    gradient as LAMB takes it and the parameters' change over the checked
    steps (by leaf: the gap of the norms over the reference's norm or the
    median leaf's, whichever is larger, at the worst leaf and the median
    leaf; the change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's), the first gradient as LAMB takes it
    in seeded directions (``grad_dir_gap``: it sees the direction that
    the rescale and the trust ratio keep out of the norms; the same
    leaves), and under MKOR the factors'
    off-diagonal norms (by slice, the same way).  Which of them decide
    ``correct`` is the cell's limits file."""
    out = {}
    if len(got["losses"]) != len(want["losses"]):
        return {"loss_gap": math.inf}
    gaps = [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                 want["losses"])]
    gaps = [x if math.isfinite(x) else math.inf for x in gaps]
    out["loss_gap"], out["loss_gap_first"] = max(gaps), gaps[0]
    grads = want["grad_norms"]
    _worst_and_median(out, "grad_gap", leaf_gaps(
        got["grad_norms"], grads, sorted(grads)))
    med = _median_nonzero(list(grads.values()))
    moved = [k for k in sorted(grads) if grads[k] >= 1e-3 * med]
    _worst_and_median(out, "change_gap", leaf_gaps(
        got["change_norms"], want["change_norms"], moved))
    _worst_and_median(out, "grad_dir_gap", direction_gaps(
        got["grad_proj"], want["grad_proj"],
        {k: (1.0 - BETA1) * v for k, v in grads.items()}, moved))
    if want.get("offdiag"):
        g = {f"{k}#{i}": v for k, vs in got["offdiag"].items()
             for i, v in enumerate(vs)}
        w = {f"{k}#{i}": v for k, vs in want["offdiag"].items()
             for i, v in enumerate(vs)}
        if sorted(g) != sorted(w):
            out["factor_gap"] = math.inf
        else:
            _worst_and_median(out, "factor_gap", leaf_gaps(g, w, sorted(w)))
    return out


def to_device(batches: List[Dict], device) -> List[Dict]:
    import torch
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in batches]


# --------------------------------------------------------------------- #
# One run
# --------------------------------------------------------------------- #
def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(spec: SimpleNamespace, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda",
        fault: Optional[Callable] = None, say=print) -> Dict:
    """Set-up, the window, the readings and the comparison.  Returns the
    result line: a dict, its keys in the result format's order, the compared
    numbers with their limits last (``check``)."""
    import torch
    stages: Dict[str, float] = {}
    mark = time.perf_counter()
    from repro_torch.kernels import build
    from repro_torch.training import loop

    def stage(name):
        nonlocal mark
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - mark
        mark = now

    stages["import"] = mark - t_start
    cfg, traffic = spec.cfg, spec.traffic
    opt = traffic["optimizer"]
    program = Program(cfg, traffic, device, fault)
    stage("program")
    if device == "cuda":
        build.build()
        for name in build.KERNEL_SOURCES:
            build.library(name)
    stage("kernels")

    params = reference.init_weights(cfg, seed, device)
    program.check_layout(params)
    opt_state = program.opt.init(params)
    stage("init")

    chunk = traffic["chunk"]
    if traffic["pool_batches"] < check_steps(opt, chunk):
        raise SystemExit("the pool has fewer batches than the checked steps")
    pool = datagen.batch_pool(seed, traffic["pool_batches"],
                              traffic["batch"], traffic["seq_len"],
                              cfg["vocab_size"], traffic["markov"])
    stage("pool")

    runner, step, check_s = program.runner, 0, 0.0

    def feed(n):
        nonlocal params, opt_state, step
        stacked = loop.stack_batches(
            [pool[(step + k) % len(pool)] for k in range(n)])
        params, opt_state, metrics = runner(params, opt_state, stacked)
        step += n
        return metrics["loss"].tolist()

    # The checked steps are the set-up's warm-up and capture: the first
    # step through the runner alone (LAMB's moments then hold the first
    # gradient), the rest of its chunk, then whole chunks, until every
    # graph key has been captured and the last steps replay graphs as the
    # window does.  Reading the program's numbers is not set-up.
    k_check = check_steps(opt, chunk)
    sizes = [1] + [chunk - 1] * (chunk > 1) + [chunk] * (k_check // chunk - 1)
    losses, got = [], {}
    for i, n in enumerate(sizes):
        losses += feed(n)
        if i == 0:
            t_read = time.perf_counter()
            moments = reference.flatten(lamb_moments(opt_state))
            got["grad_norms"] = {k: float(m.norm()) / (1.0 - BETA1)
                                 for k, m in moments.items()}
            got["grad_proj"] = reference.moment_projections(moments, seed)
            del moments
            check_s += time.perf_counter() - t_read
    stage("warmup")
    setup_s = time.perf_counter() - t_start - check_s
    got["losses"] = losses
    flat = reference.flatten(params)
    got["change_norms"] = {
        k: float((p.float() - reference.init_leaf(cfg, seed, k, device)
                  .float()).norm()) for k, p in flat.items()}
    got["offdiag"] = program_offdiag(opt_state, flat)
    stage("check reads")

    attempted = failed = 0
    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        before = dict(build.launch_counts())
        n_chunks = traffic["trace_steps"] // chunk
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                out = feed(chunk)
                attempted += len(out)
                failed += sum(not math.isfinite(x) for x in out)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        stage("traced window")
        after = build.launch_counts()
        credited = {k: after.get(k, 0) - before.get(k, 0) for k in after
                    if after.get(k, 0) != before.get(k, 0)}
        dev_events, host_events = trace_lib.collect(prof)
        del prof
        tr = trace_lib.Trace(dev_events, host_events, attempted, window_s,
                             credited)
        stage("trace read")
    else:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ends = []
        while True:
            out = feed(chunk)
            attempted += len(out)
            failed += sum(not math.isfinite(x) for x in out)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        window_s = ends[-1]
        say("chunk seconds: " + " ".join(
            f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)))

    found = banned_modules()
    if found:
        raise SystemExit("the run loaded " + ", ".join(found) +
                         " (JAX or the JAX package)")
    peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    held = state_bytes((params, opt_state))
    tokens = traffic["batch"] * traffic["seq_len"]

    metrics = {}
    if traced:
        ctx = SimpleNamespace(trace=tr, cfg=cfg, traffic=traffic,
                              state_bytes=held)
        units = {m["name"]: m["unit"] for m in json.loads(
            (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
        for name in spec.per_layer:
            value = load_reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        values = {"tokens_per_s": attempted * tokens / window_s,
                  "peak_reserved_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    stage("metrics")
    # the program's state is freed before the reference runs
    if device == "cuda":
        program.runner.release()
    del params, opt_state, program, runner, flat
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    stage("release")
    want = reference.run(cfg, opt, reference.init_weights(cfg, seed, device),
                         to_device(pool[:k_check], device), seed)
    stage("reference")
    numbers = compare(got, want)

    # the numbers the cell's limits name decide; with no limits (while
    # they are being set) every number is shown and nothing is correct
    shown = [k for k in spec.limits] or sorted(numbers)
    check = {k: {"value": numbers.get(k, math.inf),
                 "limit": spec.limits.get(k)} for k in shown}
    correct = bool(spec.limits) and failed == 0 and all(
        c["value"] <= c["limit"] for c in check.values())

    say(f"set-up stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()) +
        f"; setup_s {setup_s:.3f}; checked steps {k_check}")
    say(f"losses: program {got['losses']} reference {want['losses']}")
    say("numbers: " + json.dumps(numbers))
    say("worst at: " + ", ".join(f"{k} {v}" for k, v in WORST.items()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": spec.chips, "memory_peak_bytes": peak}
    if traced:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        say(f"card: {power_limit()}")
        say(f"own kernel events in the trace {json.dumps(tr.own_counts())}"
            f" / launches credited to the traced replays "
            f"{json.dumps(tr.credited)}")
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["check"] = check
    return result
