"""Training launcher of the port (counterpart of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch ARCH [--reduced] \\
        --optimizer mkor|mkor_h|eva|lamb|sgd|adamw --steps N \\
        --global-batch B --seq-len S --inv-freq F [--rank R] \\
        [--staleness 0|1] [--quant none|bf16|int8] [--use-kernels] \\
        [--chunk N] [--ckpt-dir D [--ckpt-every N]] [--health] \\
        [--chaos SPEC] [--elastic [--elastic-slow-factor X]] \\
        [--log-json FILE] [--trace-out FILE] [--device cpu] \\
        [--dist [--dist-devices W] [--dist-backend nccl|gloo]]

``--arch`` takes every name of ``configs/registry.py`` (the ten assigned
configs and bert-large; ``--reduced`` for the smoke-scale variant).  An
encoder-decoder model (whisper-base) gets its stub encoder frames with
each batch (``data/pipeline.py`` ``encoder_frames``), a prefix VLM
(pixtral-12b) its stub patch embeddings from the pipeline.  Runs on the
GPU unless ``--device cpu`` is given (and raises when there is no GPU).  ``--rank`` and ``--staleness`` select block rank-r updates and
the double-buffered inverse banks (defaults 1 and 0, as in the
reference).  ``--optimizer`` builds what the reference's launcher builds:
``mkor`` and ``mkor_h`` (MKOR-H, the sticky switch to first order) and
``eva`` (the Eva baseline, ``core/eva.py``) on a LAMB backend, ``lamb``,
``sgd`` (momentum 0.9) and ``adamw``.  ``--quant`` is the factor storage (``MKORConfig.factor_quant``,
the reference launcher's flag): ``int8`` keeps codes, per-slice scales and
fp32 error feedback.  ``--use-kernels`` sends MKOR's (and MKOR-H's)
banked SMW, block update and precondition through the hand-written CUDA
kernels (their int8 variants with ``--quant int8``); it needs a CUDA
device.  ``--chunk N``
(default 8, as in the reference) runs N steps a chunk through the chunk
runner (``training/loop.py``): on the GPU each step is a replay of a CUDA
graph of the whole step, with one metrics fetch a chunk, and the log lines
of a chunk print at its end; ``--chunk 1`` runs the per-step loop.  On the
CPU the chunked steps run eagerly and print the same lines.
``--ckpt-dir D`` resumes from the newest valid checkpoint in D (rolling
back past corrupt ones), with the data cursor from its metadata, and
saves there every ``--ckpt-every`` steps (at chunk boundaries) and at
the end, in the reference's format (``checkpointing/``).  ``--health``
turns on MKOR's numerical-health sentinel (per-bucket quarantine and
recovery, ``MKORConfig.health``) and ``--chaos SPEC`` injects faults at
exact steps (``training/chaos.py``: ``grad_nan``, ``factor_inf``,
``window_flip``, ``payload_corrupt``), both for the MKOR optimizers only;
the host sites (``kill_shard``, ``delay_shard``, ``drop_collective``)
need ``--elastic``.  Prints the logged steps' loss and ``done: final
loss``; ``--log-json FILE`` also writes the logged steps' metrics there
(``loss``, ``grad_norm``, ... , ``step``, ``wall_s``), as the reference.
Once the chunk runner has captured graphs, the first chunk that
captures nothing new prints its set-up counts (``runner:``, from
``loop.runner_counts``: graphs, eager warm-ups, host seconds in warm-ups
and captures, the graph pool's growth).  ``--trace-out FILE`` runs the
last chunk under ``torch.profiler``, writes it to FILE as a Chrome trace
(the phase marks and the runner's ranges show in Perfetto), and prints
the milliseconds a step in each phase of the train step
(``training/phases.py`` ``split``: the mark kernels on the GPU, the
phase ranges on the CPU); give enough ``--steps`` that every graph key
was captured before it (2 × ``--inv-freq`` under MKOR).

``--elastic`` (MKOR optimizers only) runs the steps under the elastic
supervisor (``training/resilience.py`` ``elastic_train``): retries with
backoff around each span, the straggler policy
(``--elastic-slow-factor``), the host chaos sites (a ``kill_shard``
quarantines the dead rank's orphaned buckets and rebuilds the runner with
the owners remapped over the survivors: :func:`setup`'s
``make_runner(live)``), and SIGTERM: the ranks stop at the same span
boundary, rank 0 takes an emergency checkpoint with the data cursor (no
final save), prints ``preempted: emergency checkpoint taken, exiting
cleanly`` and the launcher exits 0.  Under ``--elastic`` the runner keeps
its inputs (``donate=False``): a retried span re-presents them.

``--dist`` trains data parallel (``training/loop.py``
``make_dist_train_step``, MKOR with owner-sharded inversions) over
``--dist-devices`` ranks; ``--global-batch`` must be a multiple of it.
Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process joins
that group; otherwise the launcher spawns the ranks itself, joined by a
``file://`` store in a temporary directory, and forwards a SIGTERM it
receives to them.  The backend is NCCL on CUDA,
one card a rank, and gloo on the CPU; ``--dist-backend gloo`` puts
several ranks on one card (collectives staged through the host, eager
only: it refuses ``--chunk`` > 1, since a CUDA graph cannot hold the host
copies).  NCCL with more ranks than cards exits.  Rank 0 alone prints and
writes checkpoints (``"world"`` in their metadata); a checkpoint of
another world restores all the same (the state is replicated).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from repro_torch import checkpointing
from repro_torch.configs import registry
from repro_torch.core import firstorder, schedule as sched_lib
from repro_torch.core.eva import EvaConfig, eva
from repro_torch.core.mkor import MKORConfig, mkor, mkor_h
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.sharding import collectives
from repro_torch.training import chaos as chaos_lib
from repro_torch.training import loop as train_lib
from repro_torch.training import phases, resilience


def build_optimizer(name: str, lr, *, inv_freq: int = 10, rank: int = 1,
                    staleness: int = 0, quant: str = "none",
                    use_kernels: bool = False, health: bool = False,
                    dist=None, live=None):
    """Returns ``(optimizer, mkor_cfg)``; ``mkor_cfg`` is None for the
    first-order optimizers.  ``dist``: the data-parallel spec MKOR
    owner-shards its inversions over (the world group); ``live``: the
    elastic liveness mask the owners split over (the state tree does not
    depend on it, so a state carries over to a rebuilt optimizer)."""
    backend = firstorder.lamb(lr)
    if name in ("mkor", "mkor_h"):
        mcfg = MKORConfig(inv_freq=inv_freq, rank=rank, staleness=staleness,
                          factor_quant=quant, use_kernels=use_kernels,
                          health=health, dist=dist, live=live)
        return (mkor if name == "mkor" else mkor_h)(backend, mcfg), mcfg
    if name == "eva":
        return eva(backend, EvaConfig()), None
    if name == "lamb":
        return backend, None
    if name == "sgd":
        return firstorder.sgd(lr, momentum=0.9), None
    if name == "adamw":
        return firstorder.adamw(lr), None
    raise ValueError(name)


def build_schedule(kind: str, peak: float, steps: int):
    if kind == "constant":
        return sched_lib.constant(peak)
    if kind == "wsd":
        return sched_lib.wsd(peak, max(steps // 10, 1),
                             max(steps * 7 // 10, 1), max(steps // 5, 1))
    if kind == "cosine":
        return sched_lib.warmup_cosine(peak, max(steps // 10, 1), steps)
    if kind == "linear":
        return sched_lib.warmup_linear(peak, max(steps // 10, 1), steps)
    raise ValueError(kind)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", default="mkor",
                    choices=["mkor", "mkor_h", "eva", "lamb", "sgd", "adamw"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["constant", "wsd", "cosine", "linear"])
    ap.add_argument("--inv-freq", type=int, default=10)
    ap.add_argument("--rank", type=int, default=1,
                    help="block rank-r updates (paper §4): buffer the last "
                         "r stat vectors per factor and consume the window "
                         "with one block-Woodbury update per phase step")
    ap.add_argument("--staleness", type=int, default=0,
                    help="1 = double-buffered inverse banks: the phase-step "
                         "inversion runs one window ahead against the "
                         "pending bank; 0 = synchronous schedule")
    ap.add_argument("--quant", default="none",
                    choices=["none", "bf16", "int8"],
                    help="factor storage: none = factor_dtype (bf16), bf16, "
                         "or int8 codes with per-slice scales and fp32 "
                         "error feedback (decoded inside the kernels)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant of the arch")
    ap.add_argument("--use-kernels", action="store_true",
                    help="MKOR (or MKOR-H) through the hand-written CUDA "
                         "kernels")
    ap.add_argument("--health", action="store_true",
                    help="numerical-health sentinel: per-bucket "
                         "quarantine/recovery of corrupted factor state "
                         "(MKOR optimizers only)")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault injections, e.g. "
                         "'grad_nan@5,factor_inf@15[:bucket]' "
                         "(training/chaos.py; sites: "
                         "grad_nan, factor_inf, window_flip, "
                         "payload_corrupt); MKOR optimizers only. "
                         "Host sites (kill_shard, delay_shard, "
                         "drop_collective; site@step[:shard]) need "
                         "--elastic")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic fault tolerance (training/resilience.py): "
                         "retry/backoff around dispatch, SIGTERM emergency "
                         "checkpoint, straggler EWMAs with owner demotion, "
                         "and kill-shard failover (owner remap + orphan "
                         "quarantine), every decision agreed across ranks; "
                         "MKOR optimizers only")
    ap.add_argument("--elastic-slow-factor", type=float, default=2.0,
                    help="straggler policy: demote a shard whose step-time "
                         "EWMA exceeds this multiple of the median "
                         "(--elastic)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="steps per chunk: CUDA graph replays with one "
                         "metrics fetch a chunk (1 = per-step dispatch); "
                         "log cadence aligns to chunk boundaries")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    ap.add_argument("--dist", action="store_true",
                    help="explicit-collective data-parallel step with "
                         "owner-sharded MKOR inversions over "
                         "--dist-devices ranks (torchrun's group when "
                         "RANK / WORLD_SIZE are set, else spawned)")
    ap.add_argument("--dist-devices", type=int, default=8,
                    help="data-parallel world size for --dist "
                         "(--global-batch must be a multiple of it)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend for --dist (default "
                         "nccl on CUDA, one card a rank; gloo on the CPU; "
                         "gloo on CUDA puts several ranks on one card, "
                         "eager only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-json", default="",
                    help="write the logged steps' metrics to this JSON file "
                         "(rank 0)")
    ap.add_argument("--trace-out", default="",
                    help="profile the last chunk, write it to this Chrome "
                         "trace file and print the ms a step in each phase "
                         "of the train step (rank 0; not with --elastic)")
    return ap.parse_args(argv)


def _dist_worker(rank: int, argv: List[str], world: int, store: str,
                 results) -> None:
    """A spawned rank: join the file store's group, train, and hand rank
    0's final loss back."""
    args = parse_args(argv)
    tdist.init_process_group(args.dist_backend, init_method=f"file://{store}",
                             rank=rank, world_size=world)
    try:
        final = _train(args, rank, world)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        results.put(final)


def main(argv: Optional[List[str]] = None) -> float:
    args = parse_args(argv)
    if not args.dist:
        return _train(args, 0, 1)
    device = resolve_device(args.device)
    if args.dist_backend is None:
        args.dist_backend = "nccl" if device.type == "cuda" else "gloo"
    if args.dist_backend == "nccl" and device.type != "cuda":
        raise SystemExit("--dist-backend nccl needs CUDA devices")
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if torchrun else args.dist_devices
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if torchrun \
        else world
    if args.dist_backend == "nccl" and local > torch.cuda.device_count():
        raise SystemExit(
            f"--dist with NCCL runs one rank a card: {local} ranks on "
            f"{torch.cuda.device_count()} card(s); pass --dist-backend gloo "
            "to put several ranks on one card")
    if args.dist_backend == "gloo" and device.type == "cuda" and \
            args.chunk > 1:
        raise SystemExit(
            "--dist-backend gloo on CUDA stages each collective through the "
            "host, which a CUDA graph cannot hold: pass --chunk 1")
    if args.global_batch % world:
        raise SystemExit(f"--global-batch {args.global_batch} must be a "
                         f"multiple of the data world size {world}")
    if torchrun:
        tdist.init_process_group(args.dist_backend)
        try:
            return _train(args, tdist.get_rank(), world)
        finally:
            tdist.destroy_process_group()
    child_argv = list(sys.argv[1:] if argv is None else argv) + [
        "--dist-backend", args.dist_backend]
    results = tmp.get_context("spawn").SimpleQueue()
    with tempfile.TemporaryDirectory() as tmpdir:
        ctx = tmp.start_processes(
            _dist_worker, (child_argv, world, os.path.join(tmpdir, "store"),
                           results),
            nprocs=world, join=False, start_method="spawn")

        def forward(signum, frame):
            # the ranks take their emergency checkpoint (--elastic)
            for proc in ctx.processes:
                if proc.is_alive():
                    os.kill(proc.pid, signum)
        previous = signal.signal(signal.SIGTERM, forward)
        try:
            while not ctx.join():
                pass
        finally:
            signal.signal(signal.SIGTERM, previous)
    return results.get()


@dataclass
class Run:
    """One process's run, as :func:`setup` builds it: the rank's device,
    the model config, the chaos plan, ``make_optimizer(live) ->
    (optimizer, mkor_cfg)`` and ``make_runner(live) -> runner`` for a
    liveness mask (the elastic remap rebuilds with them; ``None``: every
    rank live), the params and optimizer state (restored from
    ``--ckpt-dir`` when it holds a valid checkpoint), the data config, the
    first step (the restored data cursor) and ``say`` (prints on rank 0
    alone)."""
    args: argparse.Namespace
    rank: int
    world: int
    device: torch.device
    cfg: Any
    plan: Optional[chaos_lib.ChaosPlan]
    mcfg: Optional[MKORConfig]
    make_optimizer: Callable
    make_runner: Callable
    params: Any
    opt_state: Any
    ds: Any
    start: int
    say: Callable


def setup(args: argparse.Namespace, rank: int = 0, world: int = 1) -> Run:
    """Build rank ``rank`` of ``world``'s run (1: no process group) from
    the parsed arguments (:func:`parse_args`)."""
    lead = rank == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    device = resolve_device(args.device)
    dist = None
    if args.dist:
        dist = collectives.dist_axes()
        if device.type == "cuda" and args.dist_backend == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
    if args.use_kernels and device.type != "cuda":
        raise SystemExit("--use-kernels needs a CUDA device")
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    lr = build_schedule(args.schedule, args.lr, args.steps)
    plan = None
    if args.chaos:
        plan = chaos_lib.parse_chaos_spec(args.chaos)
        if plan.host_faults and not args.elastic:
            raise SystemExit("host chaos sites (kill_shard/delay_shard/"
                             "drop_collective) need --elastic")

    def make_optimizer(live=None):
        """(optimizer, mkor_cfg) for a liveness mask."""
        opt_l, mcfg_l = build_optimizer(
            args.optimizer, lr, inv_freq=args.inv_freq, rank=args.rank,
            staleness=args.staleness, quant=args.quant,
            use_kernels=args.use_kernels, health=args.health, dist=dist,
            live=live)
        if plan is not None and plan.injections:
            if mcfg_l is None:
                raise SystemExit("--chaos needs an MKOR optimizer (the "
                                 "injection sites live in MKOR state)")
            opt_l = chaos_lib.chaotic(opt_l, plan, mcfg_l)
        return opt_l, mcfg_l

    opt, mcfg = make_optimizer()
    if args.health and mcfg is None:
        raise SystemExit("--health needs an MKOR optimizer")
    if args.elastic and mcfg is None:
        raise SystemExit("--elastic needs an MKOR optimizer (failover "
                         "quarantines MKOR factor state)")
    if args.elastic and args.trace_out:
        raise SystemExit("--trace-out traces the chunk loop, which "
                         "--elastic replaces")
    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    say(f"arch={cfg.name} params={model_lib.param_count(params):,} "
        f"optimizer={args.optimizer} steps={args.steps} "
        f"batch={args.global_batch}x{args.seq_len} device={device}"
        + (f" rank={args.rank} staleness={args.staleness} "
           f"quant={args.quant}" if args.optimizer in ("mkor", "mkor_h")
           else "")
        + (" health" if args.health else "")
        + (f" chaos={args.chaos}" if args.chaos else "")
        + (" elastic" if args.elastic else "")
        + (" kernels=cuda" if args.use_kernels else "")
        + (f" dist={world}x data-parallel backend={args.dist_backend}"
           if args.dist else ""))

    def make_runner(live=None):
        """The chunk runner of the step for a liveness mask (a rebuild with
        a new mask is the failover remap: the same state tree, owners
        re-split).  ``--chunk 1`` runs eager steps; under ``--elastic``
        the runner keeps its inputs (no donation)."""
        opt_l, _ = make_optimizer(live)
        step = train_lib.make_dist_train_step(cfg, opt_l, dist) if dist \
            else train_lib.make_train_step(cfg, opt_l)
        return train_lib.make_chunk_runner(step, donate=not args.elastic,
                                           capture=args.chunk > 1)

    ds = pipeline.make_dataset(cfg, global_batch=args.global_batch,
                               seq_len=args.seq_len, seed=args.seed)
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir:
        # the newest VALID checkpoint: a crash mid-save rolls back to the
        # one before it; each leaf lands on its init leaf's device
        restored = checkpointing.restore_latest_valid(args.ckpt_dir,
                                                      (params, opt_state))
        if restored is not None:
            (params, opt_state), meta, latest = restored
            start = pipeline.cursor_from_metadata(
                meta, fallback_step=int(meta.get("step", latest)) + 1).step
            # the state is replicated, so any world restores it
            from_world = meta.get("world")
            note = (f"; elastic resume from world {from_world} into {world}"
                    if from_world and from_world != world else "")
            say(f"restored checkpoint step {latest} (data cursor "
                f"{start}{note})")
    return Run(args, rank, world, device, cfg, plan, mcfg, make_optimizer,
               make_runner, params, opt_state, ds, start, say)


def _runner_line() -> str:
    """The chunk runner's set-up counts, in total and by graph key."""
    c = train_lib.runner_counts()
    keys = "; ".join(
        f"{k}: {v['capture_s']:.3f} s, {v['pool_bytes'] / 2 ** 30:.3f} GiB"
        for k, v in train_lib.runner_counts(by_key=True).items())
    return (f"runner: graphs={c['graphs']} warm_ups={c['warm_ups']} "
            f"capture_s={c['capture_s']:.3f} "
            f"pool_gib={c['pool_bytes'] / 2 ** 30:.3f} (by key: {keys})")


def _traced_chunk(runner, params, opt_state, stacked, device, path, say):
    """One chunk under ``torch.profiler``: the Chrome trace to ``path``,
    and the ms a step in each phase (``phases.split``) printed."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    n = len(next(iter(stacked.values())))
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        out = runner(params, opt_state, stacked)
        sync()
        window_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    split = phases.split(phases.marks_of(prof), window_s, n)
    say(f"trace: {path}, {n} steps, {window_s * 1e3 / n:.3f} ms a step; "
        + ("phase ms a step: " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) if split else
           "too few whole steps marked to split into phases"))
    return out


def _train(args: argparse.Namespace, rank: int, world: int) -> float:
    """One process's training run: rank ``rank`` of ``world`` (1: no
    process group)."""
    run = setup(args, rank, world)
    say, ds = run.say, run.ds
    params, opt_state, start = run.params, run.opt_state, run.start

    def save_ckpt(next_step: int, p, s, extra=None) -> None:
        # the metadata carries the data cursor (the next unconsumed
        # batch), so a resumed run never trains a batch twice
        if rank != 0:
            return
        meta = {"step": next_step - 1, "world": world,
                "cursor": pipeline.cursor_metadata(
                    pipeline.cursor_for_step(next_step))}
        meta.update(extra or {})
        checkpointing.save(args.ckpt_dir, next_step - 1, (p, s), meta)

    history = []
    t0 = time.time()

    def log_step(step: int, metrics) -> None:
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m.setdefault("wall_s", time.time() - t0)
            history.append(m)
            say(f"step {step:5d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} ({m['wall_s']:.1f}s)")

    def make_batch(step: int):
        batch = pipeline.make_batch(ds, step)
        if run.cfg.is_encoder_decoder:
            batch["frontend_embeds"] = pipeline.encoder_frames(
                run.cfg, args.global_batch, step, args.seed)
        return batch

    preempted = False
    if args.elastic:
        supervisor = resilience.ElasticSupervisor(
            world=world, monitor=resilience.StragglerMonitor(
                world, slow_factor=args.elastic_slow_factor), echo=say)
        with resilience.PreemptionGuard() as guard:
            params, opt_state, _, preempted = resilience.elastic_train(
                run.make_runner, params, opt_state, make_batch=make_batch,
                stack_batches=train_lib.stack_batches, start=start,
                steps=args.steps - start, chunk=args.chunk,
                supervisor=supervisor, plan=run.plan, mcfg=run.mcfg,
                save=save_ckpt if args.ckpt_dir else None,
                ckpt_every=args.ckpt_every, guard=guard,
                on_metrics=lambda step, hi, m: log_step(step, m))
    else:
        # the runner binds its static buffers at its first call: the
        # restored tensors
        runner = run.make_runner()
        i = start
        sizes = train_lib.chunk_schedule(args.steps - start, args.chunk)
        counts, said = train_lib.runner_counts(), False
        for c, n in enumerate(sizes):
            stacked = train_lib.stack_batches(
                [make_batch(i + k) for k in range(n)])
            if args.trace_out and rank == 0 and c == len(sizes) - 1:
                params, opt_state, metrics = _traced_chunk(
                    runner, params, opt_state, stacked, run.device,
                    args.trace_out, say)
            else:
                params, opt_state, metrics = runner(params, opt_state,
                                                    stacked)
            new = train_lib.runner_counts()
            if not said and new["graphs"] and new == counts:
                said = True
                say(_runner_line())
            counts = new
            for k in range(n):
                log_step(i + k, {key: v[k] for key, v in metrics.items()})
            prev, i = i, i + n
            if args.ckpt_dir and args.ckpt_every and i < args.steps \
                    and (i // args.ckpt_every) > (prev // args.ckpt_every):
                save_ckpt(i, params, opt_state,
                          {"loss": float(metrics["loss"][n - 1])})
    if args.ckpt_dir and not preempted:
        save_ckpt(args.steps, params, opt_state)
    if args.log_json and rank == 0:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        with open(args.log_json, "w") as f:
            json.dump(history, f, indent=1)
    final = history[-1]["loss"] if history else float("nan")
    if preempted:
        say("preempted: emergency checkpoint taken, exiting cleanly")
        return final
    say(f"done: final loss {final:.4f}")
    if not np.isfinite(final):
        raise SystemExit("training diverged")
    return final


if __name__ == "__main__":
    main()
