"""The contract checks the port can make at run time (counterpart of
``repro/analysis/checkers.py``).

A :class:`Target` is one rank's run of a data-parallel MKOR step: its
wire log split by step (``sharding/collectives.py`` ``wire_log``) and a
``meta`` dict of what the checks compare it with (:func:`target_meta`:
the factor dims, the dense layers, the gradient and stat bytes at the
port's wire width, the state's float64 leaves, MKOR's config).  A
collective is *ungated* when a step makes it whatever the phase (stats,
gradient halves, means) and *phase-step* when a bucket's owner-sharded
inversion makes it (the reference's ``lax.cond``-gated collectives).

Each checker is ``(target) -> [Diagnostic]`` with the reference's checker
name and diagnostic codes, kept only where the log can show the contract:

* ``comm-linearity``: no ungated payload of a factor's shape; at most
  dense layers + 8 ungated collectives a step; ungated bytes a step within
  1.5x the O(d) budget (the flat fp32 gradient's reduce-scatter and
  all-gather, the stats at 4 bytes an element, 1 MiB); phase-step factor
  bytes within 4x the KFAC-style payload (a warning);
* ``dtype-discipline``: no float64 on the wire or in the state; the stat
  payload summed in fp32 and, where the run rounds it, bf16-exact;
* ``staleness-bound``: a staleness >= 1 run moves no ungated factor
  payload and no more ungated bytes (over 1 KiB) a step than its
  staleness-0 twin;
* ``health-gating``: the sentinel adds no ungated collective and no
  ungated byte (over 1 KiB) a step over its health-off twin;
* ``elastic-remap``: a remapped run (a dead worker) adds none over the
  fully live twin;
* ``quant-discipline``: under int8 factors every factor-shaped payload is
  int8 codes and no owner-gather payload is in half precision.

The reference's jaxpr, HLO, donation and VMEM checks have no counterpart
(``pallas-kernels``, ``donation``, the ε-guard and ``swap-not-gated``
codes): they read a traced program, which PyTorch does not make.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from repro_torch.analysis.diagnostics import Diagnostic, Report, Severity
from repro_torch.core import stats as statlib
from repro_torch.tree import tree_leaves

# the reference's constants (repro/analysis/checkers.py)
_FIXED_UNGATED_COLLECTIVES = 8
_BYTES_SLACK = 1.5
_MIN_FACTOR_DIM = 8
_EXTRA_BYTES_SLACK = 1024
# the port's stat wire width: bf16-rounded values summed as fp32
STATS_WIRE_BYTES = 4


@dataclass
class Target:
    name: str
    steps: List[list]
    meta: Dict[str, Any] = field(default_factory=dict)


def _d(checker, code, severity, message, target, **context) -> Diagnostic:
    return Diagnostic(checker=checker, code=code, severity=severity,
                      message=message, target=target.name, context=context)


def _is_factor_square(shape, factor_dims) -> bool:
    if len(shape) < 2:
        return False
    a, b = shape[-2], shape[-1]
    return a == b and a >= _MIN_FACTOR_DIM and \
        (not factor_dims or a in factor_dims)


def ungated(step) -> list:
    return [r for r in step if not r.phase]


def ungated_counts(target: Target) -> List[int]:
    return [len(ungated(s)) for s in target.steps]


def ungated_bytes(target: Target) -> List[int]:
    return [sum(r.nbytes for r in ungated(s)) for s in target.steps]


def bytes_by_what(step) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in step:
        out[r.what] = out.get(r.what, 0) + r.nbytes
    return out


# --------------------------------------------------------------------- #
# What a run is held to
# --------------------------------------------------------------------- #
def analytic_step_bytes(params, world: int, n_means: int) -> Dict[str, int]:
    """The ungated bytes a step of the dist train step moves, by what: the
    flat fp32 gradient (every leaf) padded to a multiple of the world,
    reduce-scattered whole and all-gathered a shard; each dense layer's ā
    at 4 bytes an element; ``n_means`` fp32 scalar means (the loss and the
    extra metrics)."""
    n = sum(t.numel() for t in tree_leaves(params))
    shard = -(-n // world)
    stats = 0
    for path in statlib.iter_dense_layers(params):
        dense = statlib.tree_get(params, path)
        lead = 1
        for d in dense["probe"].shape[:-1]:
            lead *= d
        stats += lead * dense["w"].shape[-2]
    return {"grad": 4 * (shard * world + shard),
            "stats": STATS_WIRE_BYTES * stats, "mean": 4 * n_means}


def target_meta(params, state, mcfg, world: int, *, n_means: int,
                inexact_stats: int,
                stats_payload: Optional[str] = "bfloat16") -> Dict[str, Any]:
    """``meta`` of a run of MKOR (``mcfg``) over ``world`` workers on
    ``params``, with its optimizer ``state`` and the fp32 stat payloads
    its wire log counted not bf16-exact (``WireLog.inexact_stats``)."""
    from repro_torch.core.mkor import manifest_for
    manifest = manifest_for(params, mcfg)
    fbytes = statlib.factor_itemsize(mcfg.factor_dtype, mcfg.factor_quant)
    f64 = []

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, keys + (str(i),))
        elif isinstance(node, torch.Tensor) and node.dtype == torch.float64:
            f64.append("/".join(keys))
    walk(state, ())
    analytic = analytic_step_bytes(params, world, n_means)
    return {
        "world": world,
        "factor_dims": sorted({d for b in manifest
                               for d in (b.d_in, b.d_out)}),
        "n_dense_layers": len(statlib.iter_dense_layers(params)),
        "grad_f32_bytes": 4 * sum(t.numel() for t in tree_leaves(params)),
        "stats_f32_bytes": analytic["stats"],
        "analytic_step_bytes": analytic,
        "bucket_comm": {b.bucket_id: statlib.bucket_comm_cost(
            b, world, fbytes, STATS_WIRE_BYTES, rank=mcfg.rank,
            factor_quant=mcfg.factor_quant) for b in manifest},
        "staleness": mcfg.staleness, "health": mcfg.health,
        "factor_quant": mcfg.factor_quant, "live": mcfg.live,
        "stats_payload": stats_payload, "inexact_stats": inexact_stats,
        "f64_paths": f64}


def attach_baseline(target: Target, base: Target, kind: str) -> Target:
    """The differential baseline of a twin: ``kind`` ``sync`` (the
    staleness-0 run), ``plain`` (health off) or ``static`` (every worker
    live): the twin's ungated counts and bytes a step."""
    target.meta[f"{kind}_ungated_count"] = ungated_counts(base)
    target.meta[f"{kind}_ungated_bytes"] = ungated_bytes(base)
    return target


# --------------------------------------------------------------------- #
# The checkers
# --------------------------------------------------------------------- #
def _factor_payloads(target, checker, code, what) -> List[Diagnostic]:
    dims = set(target.meta.get("factor_dims", ()))
    out = []
    for i, step in enumerate(target.steps):
        for r in ungated(step):
            if _is_factor_square(r.shape, dims):
                out.append(_d(
                    checker, code, Severity.ERROR,
                    f"{what}: step {i} {r.op} ({r.what}) moves a "
                    f"factor-shaped payload {list(r.shape)} outside any "
                    "phase step -- O(d^2) on the wire every step; factor "
                    "traffic rides the phase-step owner gather", target,
                    step=i, op=r.op, shape=list(r.shape)))
    return out


def _extra_over(target, checker, kind, what,
                collectives: bool = True) -> List[Diagnostic]:
    """Ungated collectives (``collectives``) and bytes a step over the
    ``kind`` twin."""
    out = []
    counts, nbytes = ungated_counts(target), ungated_bytes(target)
    base_c = target.meta.get(f"{kind}_ungated_count")
    base_b = target.meta.get(f"{kind}_ungated_bytes")
    prefix = checker.split("-")[0]
    for i in range(len(counts)):
        if collectives and base_c is not None and i < len(base_c) and \
                counts[i] > base_c[i]:
            out.append(_d(
                checker, f"{prefix}.extra-step-collectives", Severity.ERROR,
                f"{what}: step {i} runs {counts[i]} ungated collectives "
                f"against {base_c[i]} in its twin (+{counts[i] - base_c[i]})",
                target, step=i, count=counts[i], base_count=base_c[i]))
        if base_b is not None and i < len(base_b) and \
                nbytes[i] > base_b[i] + _EXTRA_BYTES_SLACK:
            out.append(_d(
                checker, f"{prefix}.extra-step-bytes", Severity.ERROR,
                f"{what}: step {i} moves {nbytes[i]} ungated bytes "
                f"against {base_b[i]} in its twin "
                f"(+{nbytes[i] - base_b[i]})", target, step=i,
                bytes=nbytes[i], base_bytes=base_b[i]))
    return out


def check_comm_linearity(target: Target) -> List[Diagnostic]:
    """MKOR's linear communication: no per-step factor payload, the count
    and the bytes of the per-step collectives within the explicit
    design's."""
    m = target.meta
    out = _factor_payloads(target, "comm-linearity",
                           "comm.factor-payload-per-step", "per step")
    n_stat = m.get("n_dense_layers")
    if n_stat is not None:
        bound = n_stat + _FIXED_UNGATED_COLLECTIVES
        worst = max(ungated_counts(target), default=0)
        if worst > bound:
            out.append(_d(
                "comm-linearity", "comm.collective-count-drift",
                Severity.ERROR,
                f"{worst} per-step collectives, at most {bound} expected "
                f"({n_stat} stat means + {_FIXED_UNGATED_COLLECTIVES} "
                "fixed gradient and metric collectives)", target,
                n_ungated=worst, bound=bound))
    grad = m.get("grad_f32_bytes")
    if grad is not None:
        world = max(m.get("world", 1), 1)
        budget = grad * (1 + 1 / world) + m.get("stats_f32_bytes", 0) \
            + 2 ** 20
        worst = max(ungated_bytes(target), default=0)
        if worst > _BYTES_SLACK * budget:
            out.append(_d(
                "comm-linearity", "comm.bytes-over-budget", Severity.ERROR,
                f"per-step payload {worst / 2**20:.1f} MiB exceeds "
                f"{_BYTES_SLACK}x the O(d) budget {budget / 2**20:.1f} MiB",
                target, payload_bytes=worst, budget_bytes=int(budget)))
    comm = m.get("bucket_comm") or {}
    if comm:
        dims = set(m.get("factor_dims", ()))
        budget = sum(c["kfac_factor_bytes_per_inv"] for c in comm.values())
        for i, step in enumerate(target.steps):
            gated = sum(r.nbytes for r in step if r.phase
                        and _is_factor_square(r.shape, dims))
            if gated > 4 * max(budget, 1):
                out.append(_d(
                    "comm-linearity", "comm.gated-factor-bytes",
                    Severity.WARNING,
                    f"step {i}: phase-step factor collectives carry "
                    f"{gated / 2**20:.1f} MiB against the owner-sharded "
                    f"budget {budget / 2**20:.1f} MiB", target, step=i,
                    gated_bytes=gated, budget=budget))
    return out


def check_dtype_discipline(target: Target) -> List[Diagnostic]:
    """No float64 on the wire or in the state; the stat payload summed in
    fp32, and bf16-exact where the run rounds it."""
    out = []
    for path in target.meta.get("f64_paths", ()):
        out.append(_d(
            "dtype-discipline", "dtype.f64-promotion", Severity.ERROR,
            f"float64 state leaf {path}", target, path=path))
    if target.meta.get("stats_payload", "bfloat16") == "bfloat16" and \
            target.meta.get("inexact_stats"):
        out.append(_d(
            "dtype-discipline", "dtype.stats-payload-not-bf16",
            Severity.WARNING,
            f"{target.meta['inexact_stats']} stat payload(s) not "
            "bf16-rounded: full fp32 values on the wire", target,
            n=target.meta["inexact_stats"]))
    for i, step in enumerate(target.steps):
        for r in step:
            if r.dtype == "float64":
                out.append(_d(
                    "dtype-discipline", "dtype.f64-promotion",
                    Severity.ERROR, f"step {i}: {r.op} ({r.what}) moves "
                    "float64", target, step=i, op=r.op))
            if r.what != "stats":
                continue
            if r.dtype != "float32":
                out.append(_d(
                    "dtype-discipline", "dtype.stats-accum-not-f32",
                    Severity.ERROR,
                    f"step {i}: the stat payload {list(r.shape)} is summed "
                    f"in {r.dtype}; the sum must run in fp32", target,
                    step=i, dtype=r.dtype, shape=list(r.shape)))
    return out


def check_staleness_bound(target: Target) -> List[Diagnostic]:
    """A staleness >= 1 run: no ungated factor payload, and no ungated
    byte a step over its staleness-0 twin."""
    if not target.meta.get("staleness"):
        return []
    return _factor_payloads(target, "staleness-bound",
                            "staleness.ungated-factor-bytes",
                            "staleness run") + \
        _extra_over(target, "staleness-bound", "sync", "staleness run",
                    collectives=False)


def check_health_gating(target: Target) -> List[Diagnostic]:
    """The sentinel is wire-free: no ungated factor payload, no extra
    ungated collective or byte over the health-off twin."""
    if not target.meta.get("health"):
        return []
    return _factor_payloads(target, "health-gating",
                            "health.ungated-factor-bytes", "health run") + \
        _extra_over(target, "health-gating", "plain", "health run")


def check_elastic_remap(target: Target) -> List[Diagnostic]:
    """A remap moves ownership, not per-step traffic: no ungated factor
    payload, no extra ungated collective or byte over the live twin."""
    live = target.meta.get("live")
    if live is None or all(live):
        return []
    return _factor_payloads(target, "elastic-remap",
                            "elastic.ungated-factor-bytes",
                            "remapped run") + \
        _extra_over(target, "elastic-remap", "static", "remapped run")


def check_quant_discipline(target: Target) -> List[Diagnostic]:
    """int8 factors: every factor-shaped payload is int8 codes, and no
    owner-gather payload (codes, scales) is summed in half precision."""
    if target.meta.get("factor_quant") != "int8":
        return []
    dims = set(target.meta.get("factor_dims", ()))
    out = []
    for i, step in enumerate(target.steps):
        for r in step:
            if _is_factor_square(r.shape, dims) and r.dtype != "int8":
                out.append(_d(
                    "quant-discipline", "quant.wire-not-int8-origin",
                    Severity.ERROR,
                    f"step {i}: {r.op} ({r.what}) moves a factor-shaped "
                    f"payload {list(r.shape)} as {r.dtype}: under int8 "
                    "factors the owner gather ships the stored codes",
                    target, step=i, op=r.op, dtype=r.dtype))
            elif r.what == "owner_gather" and \
                    r.dtype in ("bfloat16", "float16"):
                out.append(_d(
                    "quant-discipline", "quant.accum-not-f32",
                    Severity.ERROR,
                    f"step {i}: an owner-gather payload {list(r.shape)} is "
                    f"summed in {r.dtype}; codes and scales sum in int8 or "
                    "fp32", target, step=i, dtype=r.dtype))
    return out


CHECKERS: Dict[str, Callable] = {
    "comm-linearity": check_comm_linearity,
    "dtype-discipline": check_dtype_discipline,
    "staleness-bound": check_staleness_bound,
    "health-gating": check_health_gating,
    "elastic-remap": check_elastic_remap,
    "quant-discipline": check_quant_discipline,
}


def run_checkers(targets: Iterable[Target], *,
                 names: Optional[Iterable[str]] = None) -> Report:
    report = Report()
    selected = list(names) if names else list(CHECKERS)
    unknown = [n for n in selected if n not in CHECKERS]
    if unknown:
        raise KeyError(f"unknown checker(s) {unknown}; "
                       f"available: {sorted(CHECKERS)}")
    for target in targets:
        for name in selected:
            report.extend(CHECKERS[name](target))
    return report
