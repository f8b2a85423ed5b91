"""Dry run of the port: size every (config x input shape) from shapes
alone, on the ``meta`` device (counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --quant int8 \\
        --staleness 1

Nothing is lowered or compiled, and no mesh, HLO or roofline is made: the
reference's dry run compiles on a fake XLA mesh, which PyTorch has no
counterpart of.  What it reports:

* train shapes: the factor-bank report (:func:`factor_bucket_report`, the
  reference's per-bucket ``bucket_cost`` and ``bucket_comm_cost`` columns
  for ``--world`` data-parallel workers), and the one number the
  reference's dry run cannot give: ``state_bytes``, the bytes of each
  top-level entry of ``opt.init(meta params)`` (``factor_banks``,
  ``pending_banks``, ``stat_windows``, ``health``, ``backend`` ...),
  printed beside the sum of the analytic columns and their difference.
  That difference is pinned (:func:`unmodelled_state_bytes`): the window
  counts (one int32 a bank slot) and, for int8 banks at staleness >= 1,
  the pending bank's fp32 error feedback, which the reference's
  ``bucket_cost`` leaves out;
* ``prefill_32k``, ``decode_32k`` and ``long_500k``: the parameter counts
  and the bytes of the decode cache at that context (on ``meta``).

One JSON per combination goes to ``--out`` (default
``experiments/dryrun_torch/``, beside the reference's
``experiments/dryrun/``).  ``--device cpu`` or ``cuda`` also allocates the
params and the optimizer state for real and prints the allocated bytes
beside ``state_bytes`` (only for configs that fit there).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.core import firstorder
from repro_torch.core import stats as statlib
from repro_torch.core.mkor import MKORConfig, manifest_for, mkor, mkor_h
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.tree import tree_bytes

# the reference's stat wire width in its comm columns (bf16); the port's
# wire sums fp32 (sharding/collectives.py), twice that
REFERENCE_STATS_BYTES = torch.bfloat16.itemsize
# the analytic columns of resident optimizer state
STATE_COLUMNS = ("factor_bytes", "window_bytes", "pending_factor_bytes",
                 "quant_scale_bytes", "quant_ef_bytes", "health_state_bytes")
# state entries of MKOR's own (the backend's and the step count are not in
# the factor columns)
MKOR_ENTRIES = ("factor_banks", "pending_banks", "stat_windows", "health")


def make_optimizer(name: str, cfg: ModelConfig,
                   mcfg: MKORConfig = MKORConfig()):
    backend = firstorder.lamb(1e-3)
    if name == "mkor":
        return mkor(backend, mcfg)
    if name == "mkor_h":
        return mkor_h(backend, mcfg)
    if name == "lamb":
        return backend
    raise ValueError(f"unknown optimizer {name!r}")


def factor_bucket_report(params, mcfg: MKORConfig = MKORConfig(),
                         world_size: int = 1) -> List[Dict[str, Any]]:
    """Per-bucket factor FLOPs and bytes and collective payload bytes of
    the bank layout, from the params' shapes alone (meta tensors do)."""
    fbytes = statlib.factor_itemsize(mcfg.factor_dtype, mcfg.factor_quant)
    return [{**statlib.bucket_cost(b, fbytes, rank=mcfg.rank,
                                   staleness=mcfg.staleness,
                                   health=mcfg.health,
                                   factor_quant=mcfg.factor_quant),
             **statlib.bucket_comm_cost(b, world_size, fbytes,
                                        REFERENCE_STATS_BYTES,
                                        rank=mcfg.rank,
                                        factor_quant=mcfg.factor_quant)}
            for b in manifest_for(params, mcfg)]


def _leaves_with_keys(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, keys + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, keys + (str(i),))
    elif tree is not None:
        yield keys, tree


def active_param_counts(cfg: ModelConfig, params) -> Dict[str, int]:
    """(total, active, non-embedding-active) parameter counts; MoE expert
    tensors scaled by top_k / n_experts for the active count."""
    total, active, embed = 0, 0.0, 0
    for keys, leaf in _leaves_with_keys(params):
        n = leaf.numel()
        total += n
        frac = 1.0
        if cfg.moe is not None and "w" in keys[-1] and leaf.ndim >= 4 \
                and leaf.shape[-3] == cfg.moe.n_experts:
            frac = cfg.moe.top_k / cfg.moe.n_experts
        active += n * frac
        if "embed" in keys or "lm_head" in keys:
            embed += n
    return {"total": total, "active": int(active),
            "active_non_embed": int(active) - embed}


def state_bytes(state) -> Dict[str, int]:
    """Bytes of each top-level entry of an optimizer state."""
    return {k: tree_bytes(v) for k, v in state.items()}


def unmodelled_state_bytes(params, mcfg: MKORConfig) -> int:
    """The state bytes the analytic columns leave out, by the rule this
    module pins: an int32 window count a bank slot wherever windows exist
    (rank > 1 or staleness >= 1), and at int8 with staleness >= 1 the
    pending bank's fp32 error feedback, full shape (the reference's
    ``bucket_cost`` counts only its codes and scales)."""
    windows = mcfg.rank > 1 or mcfg.staleness > 0
    pending_ef = mcfg.factor_quant == "int8" and mcfg.staleness > 0
    out = 0
    for b in manifest_for(params, mcfg):
        if windows:
            out += 4 * b.n_slots
        if pending_ef:
            out += 4 * statlib.bucket_slices(b) * (b.d_in ** 2 + b.d_out ** 2)
    return out


def should_skip(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" \
            and cfg.name not in registry.long_context_archs():
        return ("pure full-attention architecture; long_500k needs "
                "sub-quadratic decode (DESIGN.md §5)")
    return None


def dry_one(cfg: ModelConfig, shape: InputShape, *, optimizer: str = "mkor",
            mcfg: MKORConfig = MKORConfig(), world_size: int = 16,
            device: str = "meta") -> Dict[str, Any]:
    """One (config, shape) row, from ``meta`` tensors; ``device`` other
    than ``meta`` also allocates params and state there and reads the
    bytes allocated."""
    mode = shape.mode
    if shape.name == "long_500k":
        cfg = registry.long_context_variant(cfg)
    params = model_lib.init_params(cfg, device="meta")
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mode": mode,
        "world": world_size,
        "optimizer": optimizer if mode == "train" else None,
        "params": active_param_counts(cfg, params)}
    if mode != "train":
        cache = model_lib.init_decode_cache(cfg, shape.global_batch,
                                            shape.seq_len, device="meta")
        rec["cache_bytes"] = state_bytes(cache)
        return rec
    opt = make_optimizer(optimizer, cfg, mcfg)
    sb = state_bytes(opt.init(params))
    rec["state_bytes"] = sb
    if optimizer in ("mkor", "mkor_h"):
        fb = factor_bucket_report(params, mcfg, world_size)
        analytic = sum(b[k] for b in fb for k in STATE_COLUMNS)
        own = sum(v for k, v in sb.items() if k in MKOR_ENTRIES)
        rec.update(
            mkor={"rank": mcfg.rank, "staleness": mcfg.staleness,
                  "factor_quant": mcfg.factor_quant, "health": mcfg.health},
            factor_buckets=fb, mkor_state_bytes=own, analytic_bytes=analytic,
            state_minus_analytic=own - analytic,
            unmodelled_bytes=unmodelled_state_bytes(params, mcfg))
    if device != "meta":
        rec["allocated_bytes"] = allocated_state_bytes(
            cfg, opt, resolve_device(device))
    return rec


def allocated_state_bytes(cfg: ModelConfig, opt, dev) -> int:
    """The bytes ``opt.init`` allocates for ``cfg``'s params on ``dev``
    (the CUDA allocator's count on a card, the tensors' bytes elsewhere)."""
    params = model_lib.init_params(cfg, device=dev)
    if dev.type != "cuda":
        return tree_bytes(opt.init(params))
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    state = opt.init(params)
    torch.cuda.synchronize(dev)
    out = torch.cuda.memory_allocated(dev) - before
    del state
    return out


def format_row(r: Dict[str, Any]) -> str:
    head = f"{r['arch']:17s} {r['shape']:12s} w{r['world']:<3d} "
    p = r["params"]
    tail = f"params={p['total']:,} active={p['active']:,}"
    if "cache_bytes" in r:
        return head + f"cache={sum(r['cache_bytes'].values()) / 2**30:.3f}" \
            f"GiB " + tail
    fb = r.get("factor_buckets") or []
    note = ""
    if fb:
        flops = sum(b["smw_flops_per_inv"] for b in fb)
        mem = sum(b["factor_bytes"] for b in fb)
        r1 = sum(b["rank1_stats_bytes_per_step"] for b in fb)
        kfac = sum(b["kfac_factor_bytes_per_inv"] for b in fb)
        hb = sum(b["health_state_bytes"] for b in fb)
        note = (f"buckets={len(fb)} smw={flops:.2e}F "
                f"factors={mem / 2**30:.2f}GiB "
                f"r1comm={r1 / 2**20:.2f}MiB/step "
                f"(kfac {kfac / 2**20:.0f}MiB/inv) "
                + (f"health={hb}B " if hb else "")
                + f"state={r['mkor_state_bytes']:,}B "
                f"analytic={r['analytic_bytes']:,}B "
                f"diff={r['state_minus_analytic']:,}B "
                f"(pinned {r['unmodelled_bytes']:,}B) ")
    total = sum(r["state_bytes"].values())
    alloc = (f"allocated={r['allocated_bytes']:,}B "
             if "allocated_bytes" in r else "")
    return head + note + f"opt_state={total:,}B " + alloc + tail


def tag_of(arch: str, shape: str, world: int, optimizer: str,
           mcfg: MKORConfig) -> str:
    tag = f"{arch}_{shape}_w{world}"
    if optimizer != "mkor":
        tag += f"_{optimizer}"
    if mcfg.factor_quant != "none":
        tag += f"_{mcfg.factor_quant}"
    if mcfg.staleness:
        tag += f"_s{mcfg.staleness}"
    if mcfg.health:
        tag += "_health"
    return tag


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all' (assigned pool)")
    ap.add_argument("--shape", default="all",
                    help="input shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="size the comm columns for the reference's "
                         "2-pod data axis (32 workers)")
    ap.add_argument("--world", type=int, default=None,
                    help="data-parallel workers of the comm columns "
                         "(default: the reference's data axis, 16, or 32 "
                         "with --multi-pod)")
    ap.add_argument("--optimizer", default="mkor",
                    choices=["mkor", "mkor_h", "lamb"])
    ap.add_argument("--health", action="store_true",
                    help="the numerical-health sentinel's state")
    ap.add_argument("--quant", default="none",
                    choices=["none", "bf16", "int8"],
                    help="factor residency format: int8 halves the owner "
                         "gather's wire bytes against bf16, but holds codes "
                         "plus fp32 error feedback, 2.5x a bf16 bank's "
                         "resident bytes")
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--device", default="meta",
                    help="meta (shapes alone), or cpu / cuda to also "
                         "allocate the state there and read its bytes")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="shorthand for --arch all --shape all")
    args = ap.parse_args(argv)

    world = args.world or (32 if args.multi_pod else 16)
    archs = registry.ASSIGNED if (args.all or args.arch == "all") \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape == "all") \
        else [args.shape]
    mcfg = MKORConfig(health=args.health, factor_quant=args.quant,
                      staleness=args.staleness)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for arch in archs:
        cfg = registry.get_config(arch)
        for shape_name in shapes:
            shape = INPUT_SHAPES[shape_name]
            tag = tag_of(arch, shape_name, world, args.optimizer, mcfg)
            skip = should_skip(cfg, shape)
            if skip:
                rec = {"arch": arch, "shape": shape_name, "world": world,
                       "skipped": skip}
                print(f"{arch:17s} {shape_name:12s} SKIP: {skip}")
            else:
                rec = dry_one(cfg, shape, optimizer=args.optimizer,
                              mcfg=mcfg, world_size=world,
                              device=args.device)
                print(format_row(rec))
            rows.append(rec)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
