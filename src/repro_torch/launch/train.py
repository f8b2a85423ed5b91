"""Training launcher of the port (counterpart of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch bert-large [--reduced] \\
        --optimizer mkor|mkor_h|eva|lamb|sgd|adamw --steps N \\
        --global-batch B --seq-len S --inv-freq F [--rank R] \\
        [--staleness 0|1] [--quant none|bf16|int8] [--use-kernels] \\
        [--chunk N] [--ckpt-dir D [--ckpt-every N]] [--health] \\
        [--chaos SPEC] [--device cpu] \\
        [--dist [--dist-devices W] [--dist-backend nccl|gloo]]

Runs on the GPU unless ``--device cpu`` is given (and raises when there is
no GPU).  ``--rank`` and ``--staleness`` select block rank-r updates and
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
need ``--elastic``, which is not ported yet.  Prints the logged steps'
loss and ``done: final loss``.

``--dist`` trains data parallel (``training/loop.py``
``make_dist_train_step``, MKOR with owner-sharded inversions) over
``--dist-devices`` ranks; ``--global-batch`` must be a multiple of it.
Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process joins
that group; otherwise the launcher spawns the ranks itself, joined by a
``file://`` store in a temporary directory.  The backend is NCCL on CUDA,
one card a rank, and gloo on the CPU; ``--dist-backend gloo`` puts
several ranks on one card (collectives staged through the host, eager
only: it refuses ``--chunk`` > 1, since a CUDA graph cannot hold the host
copies).  NCCL with more ranks than cards exits.  Rank 0 alone prints and
writes checkpoints (``"world"`` in their metadata); a checkpoint of
another world restores all the same (the state is replicated).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import List, Optional

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


def build_optimizer(name: str, lr, *, inv_freq: int = 10, rank: int = 1,
                    staleness: int = 0, quant: str = "none",
                    use_kernels: bool = False, health: bool = False,
                    dist=None):
    """Returns ``(optimizer, mkor_cfg)``; ``mkor_cfg`` is None for the
    first-order optimizers.  ``dist``: the data-parallel spec MKOR
    owner-shards its inversions over (the world group)."""
    backend = firstorder.lamb(lr)
    if name in ("mkor", "mkor_h"):
        mcfg = MKORConfig(inv_freq=inv_freq, rank=rank, staleness=staleness,
                          factor_quant=quant, use_kernels=use_kernels,
                          health=health, dist=dist)
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


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
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
    return ap.parse_args(argv)


def _dist_worker(rank: int, argv: List[str], world: int, store: str,
                 results) -> None:
    """A spawned rank: join the file store's group, train, and hand rank
    0's final loss back."""
    args = _parse(argv)
    tdist.init_process_group(args.dist_backend, init_method=f"file://{store}",
                             rank=rank, world_size=world)
    try:
        final = _train(args, rank, world)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        results.put(final)


def main(argv: Optional[List[str]] = None) -> float:
    args = _parse(argv)
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
        tmp.start_processes(_dist_worker,
                            (child_argv, world, os.path.join(tmpdir, "store"),
                             results),
                            nprocs=world, start_method="spawn")
    return results.get()


def _train(args: argparse.Namespace, rank: int, world: int) -> float:
    """One process's training run: rank ``rank`` of ``world`` (1: no
    process group)."""
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
        if plan.host_faults:
            raise SystemExit("host chaos sites (kill_shard/delay_shard/"
                             "drop_collective) need --elastic, which is not "
                             "ported yet (ROADMAP.md queue 1 item 8: "
                             "elastic)")
    opt, mcfg = build_optimizer(args.optimizer, lr, inv_freq=args.inv_freq,
                                rank=args.rank, staleness=args.staleness,
                                quant=args.quant,
                                use_kernels=args.use_kernels,
                                health=args.health, dist=dist)
    if plan is not None and plan.injections:
        if mcfg is None:
            raise SystemExit("--chaos needs an MKOR optimizer (the "
                             "injection sites live in MKOR state)")
        opt = chaos_lib.chaotic(opt, plan, mcfg)
    if args.health and mcfg is None:
        raise SystemExit("--health needs an MKOR optimizer")
    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    say(f"arch={cfg.name} params={model_lib.param_count(params):,} "
        f"optimizer={args.optimizer} steps={args.steps} "
        f"batch={args.global_batch}x{args.seq_len} device={device}"
        + (f" rank={args.rank} staleness={args.staleness} "
           f"quant={args.quant}" if args.optimizer in ("mkor", "mkor_h")
           else "")
        + (" health" if args.health else "")
        + (f" chaos={args.chaos}" if args.chaos else "")
        + (" kernels=cuda" if args.use_kernels else "")
        + (f" dist={world}x data-parallel backend={args.dist_backend}"
           if args.dist else ""))

    ds = pipeline.make_dataset(cfg, global_batch=args.global_batch,
                               seq_len=args.seq_len, seed=args.seed)
    step_fn = train_lib.make_dist_train_step(cfg, opt, dist) if args.dist \
        else train_lib.make_train_step(cfg, opt)
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

    def save_ckpt(next_step: int, extra=None) -> None:
        # the metadata carries the data cursor (the next unconsumed
        # batch), so a resumed run never trains a batch twice
        if not lead:
            return
        meta = {"step": next_step - 1, "world": world,
                "cursor": pipeline.cursor_metadata(
                    pipeline.cursor_for_step(next_step))}
        meta.update(extra or {})
        checkpointing.save(args.ckpt_dir, next_step - 1, (params, opt_state),
                           meta)

    t0 = time.time()
    final = float("nan")

    def log_step(step: int, metrics) -> None:
        nonlocal final
        if step % args.log_every == 0 or step == args.steps - 1:
            final = float(metrics["loss"])
            say(f"step {step:5d} loss={final:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({time.time() - t0:.1f}s)")

    # built after the restore, so its static buffers are the restored
    # tensors
    runner = train_lib.make_chunk_runner(step_fn) if args.chunk > 1 \
        else None
    i = start
    for n in train_lib.chunk_schedule(args.steps - start, args.chunk):
        if runner is None:            # --chunk 1: the per-step loop
            batch = train_lib.batch_to_device(pipeline.make_batch(ds, i),
                                              device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            log_step(i, metrics)
            last = metrics["loss"]
        else:
            stacked = train_lib.stack_batches(
                [pipeline.make_batch(ds, i + k) for k in range(n)])
            params, opt_state, metrics = runner(params, opt_state, stacked)
            for k in range(n):
                log_step(i + k, {key: v[k] for key, v in metrics.items()})
            last = metrics["loss"][n - 1]
        prev, i = i, i + n
        if args.ckpt_dir and args.ckpt_every and i < args.steps \
                and (i // args.ckpt_every) > (prev // args.ckpt_every):
            save_ckpt(i, {"loss": float(last)})
    if args.ckpt_dir:
        save_ckpt(args.steps)
    say(f"done: final loss {final:.4f}")
    if not np.isfinite(final):
        raise SystemExit("training diverged")
    return final


if __name__ == "__main__":
    main()
