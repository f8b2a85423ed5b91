"""The port's contract lint: run a few data-parallel MKOR steps of each twin
with the wire log open, then the contract checks (``contracts.py``).

    PYTHONPATH=src python -m repro_torch.analysis.lint --config bert-large \\
        --reduced --dist --dist-devices 2 --device cpu

The counterpart of ``python -m repro.analysis.lint``, which traces and
never runs: the port has no traced program, so it runs the real
``training/loop.make_dist_train_step`` over gloo ranks that this process
spawns (joined by a ``file://`` store in a temporary directory), on the
CPU or, several ranks to a card, with collectives staged through the host.
Twins, each ``--steps`` steps from the same seed at ``--inv-freq``:
``base`` (staleness 0), ``stale`` (staleness 1; baseline ``base``),
``health`` (the sentinel on; baseline ``base``), ``int8`` (int8 factors)
and ``remap`` (the last worker dead, owners re-split; baseline ``base``).
Each rank's log is one target.  Without ``--dist`` one process runs the
twins without collectives: only the state's dtypes are checked.  Prints
each twin's per-step wire bytes beside the analytic count and the report;
exits 1 iff an ERROR-level diagnostic.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from repro_torch.analysis import contracts
from repro_torch.configs import registry
from repro_torch.core import firstorder
from repro_torch.core.mkor import MKORConfig, mkor
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.sharding import collectives
from repro_torch.training import loop as train_lib

TWINS = ("base", "stale", "health", "int8", "remap")
# the twin each differential check holds a twin to
BASELINES = {"stale": "sync", "health": "plain", "remap": "static"}
# the dist step's scalar means: the loss and its two extra metrics
N_MEANS = 3


def twin_config(name: str, world: int, *, inv_freq: int,
                rank: int) -> MKORConfig:
    kw = {"base": {}, "stale": {"staleness": 1}, "health": {"health": True},
          "int8": {"factor_quant": "int8"},
          "remap": {"live": (True,) * (world - 1) + (False,)}}[
              name.split("@")[0]]
    return MKORConfig(inv_freq=inv_freq, rank=rank, **kw)


@dataclasses.dataclass
class LintJob:
    config: str
    reduced: bool
    device: Optional[str]
    twins: tuple = TWINS
    steps: int = 4
    inv_freq: int = 2
    rank: int = 1
    global_batch: int = 4
    seq_len: int = 16
    # wrap(twin) -> None or a function taking ``collectives.transport``
    # and returning the transport that twin's run uses (faults planted
    # by the tests)
    wrap: Optional[Callable] = None


def run_twin(job: LintJob, twin: str, rank: int, world: int):
    """Run one twin in this process (rank ``rank`` of ``world``; 1: no
    process group, no collectives).  Returns (wire records, meta)."""
    cfg = registry.get_config(job.config)
    if job.reduced:
        cfg = cfg.reduced()
    device = resolve_device(job.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(cfg, seed=0, device=device)
    mcfg = twin_config(twin, world, inv_freq=job.inv_freq, rank=job.rank)
    if world > 1:
        dist = collectives.dist_axes()
        mcfg = dataclasses.replace(mcfg, dist=dist)
        opt = mkor(firstorder.lamb(1e-3), mcfg)
        step = train_lib.make_dist_train_step(cfg, opt, dist)
    else:
        opt = mkor(firstorder.lamb(1e-3), mcfg)
        step = train_lib.make_train_step(cfg, opt)
    state = opt.init(params)
    ds = pipeline.make_dataset(cfg, global_batch=job.global_batch,
                               seq_len=job.seq_len, seed=0)
    orig = collectives.transport
    fault = job.wrap(twin) if job.wrap is not None else None
    if fault is not None:
        collectives.transport = fault(orig)
    try:
        with collectives.wire_log(device) as log:
            for i in range(job.steps):
                batch = pipeline.make_batch(ds, i)
                if cfg.is_encoder_decoder:
                    batch["frontend_embeds"] = pipeline.encoder_frames(
                        cfg, job.global_batch, i, 0)
                params, state, _ = step(
                    params, state, train_lib.batch_to_device(batch, device))
    finally:
        collectives.transport = orig
    meta = contracts.target_meta(params, state, mcfg, world,
                                 n_means=N_MEANS,
                                 inexact_stats=log.inexact_stats())
    return log.records, meta


def _rank(rank: int, job: LintJob, world: int, store: str, out: str):
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=rank, world_size=world)
    try:
        res = {t: run_twin(job, t, rank, world) for t in job.twins}
    finally:
        tdist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def run_ranks(job: LintJob, world: int) -> List[Dict]:
    """Every twin of ``job`` on ``world`` spawned gloo ranks (1: in this
    process).  Returns each rank's {twin: (records, meta)}."""
    if world <= 1:
        return [{t: run_twin(job, t, 0, 1) for t in job.twins}]
    with tempfile.TemporaryDirectory() as tmpdir:
        out = os.path.join(tmpdir, "wire")
        tmp.start_processes(_rank, (job, world, os.path.join(tmpdir, "store"),
                                    out), nprocs=world, join=True,
                            start_method="spawn")
        res = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                res.append(pickle.load(f))
    return res


def targets_of(config: str, per_rank: List[Dict]) -> List[contracts.Target]:
    """One target a (rank, twin), each twin with its baseline attached: the
    ``base`` twin (a twin ``NAME@TAG`` is twin NAME run again, as the tests
    run planted faults, and takes the same baseline)."""
    out = []
    for r, twins in enumerate(per_rank):
        made = {}
        for t, (records, meta) in twins.items():
            log = collectives.WireLog()
            log.records = list(records)
            made[t] = contracts.Target(f"{config}/{t}/rank{r}", log.steps(),
                                       dict(meta))
        for t, target in made.items():
            kind = BASELINES.get(t.split("@")[0])
            if kind is not None and "base" in made:
                contracts.attach_baseline(target, made["base"], kind)
        out.extend(made.values())
    return out


def bytes_lines(targets: List[contracts.Target]) -> List[str]:
    """Each target's ungated bytes a step by what, the analytic count, and
    the reference's bf16-width stat budget (``bucket_comm_cost``) beside
    the port's 4-byte width."""
    lines = []
    for t in targets:
        a = t.meta["analytic_step_bytes"]
        comm = t.meta["bucket_comm"].values()
        r1 = sum(c["rank1_stats_bytes_per_step"] for c in comm)
        gated = [sum(r.nbytes for r in s if r.phase) for s in t.steps]
        per = [contracts.bytes_by_what(contracts.ungated(s))
               for s in t.steps]
        lines.append(
            f"{t.name}: ungated bytes a step {per}"
            f"; analytic {a}; phase-step bytes {gated}; factored layers' "
            f"ā+ḡ {r1} B a step at 4 B an element, {r1 // 2} B at the "
            "reference's bf16 width")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="registry arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dist", action="store_true",
                    help="run the twins data parallel over gloo ranks")
    ap.add_argument("--dist-devices", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu, or the GPU (default)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--inv-freq", type=int, default=2)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--checkers", nargs="*", default=None)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    world = args.dist_devices if args.dist else 1
    if args.global_batch % world:
        raise SystemExit(f"--global-batch {args.global_batch} must be a "
                         f"multiple of {world}")
    twins = TWINS if world > 1 else TWINS[:-1]
    job = LintJob(args.config, args.reduced, args.device, twins=twins,
                  steps=args.steps, inv_freq=args.inv_freq, rank=args.rank,
                  global_batch=args.global_batch, seq_len=args.seq_len)
    print(f"lint: {args.config}{' (reduced)' if args.reduced else ''}, "
          f"twins {', '.join(twins)}, {args.steps} steps, world {world}",
          flush=True)
    targets = targets_of(args.config, run_ranks(job, world))
    for line in bytes_lines(targets):
        print(line)
    report = contracts.run_checkers(targets, names=args.checkers)
    print(report.render())
    if args.json:
        report.to_json(args.json)
    return report.exit_code()


if __name__ == "__main__":
    sys.exit(main())
