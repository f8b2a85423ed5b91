"""Deterministic fault injection for the numerical-health sentinel (port
of ``repro/training/chaos.py``).

The harness wraps a ``GradientTransformation`` and, at exact step counts,
poisons one element of a chosen tensor inside its update.  Everything
downstream -- detection, per-bucket quarantine, cooldown, recovery -- is
exercised exactly as a real flipped bit would exercise it.  The sites,
their defaults and the spec grammar are the reference's:

* ``grad_nan``        -- NaN into the first weight-gradient element of the
                         target bucket's first layer.
* ``factor_inf``      -- Inf into the active L⁻¹ bank.
* ``window_flip``     -- NaN into the ā ring stat window (needs rank > 1
                         or staleness 1, which allocate windows).
* ``payload_corrupt`` -- NaN into the ā stat vector.

With int8 factor state ``factor_inf`` and ``window_flip`` target int8
codes, which hold no Inf or NaN: the poison raises, as the reference's
``jnp.asarray(value, int8)`` does (``OverflowError`` for Inf,
``ValueError`` for NaN).

A hit must not be a host branch: the optimizer's ``count`` is a CPU
tensor, and a CUDA graph of the step (``training/loop.py``) would freeze
the branch it took, or need a graph of its own.  So :func:`chaotic` adds
to the optimizer's ``plan`` one 0/1 float32 scalar per injection,
``chaos_hit_<i>`` (1 on the injection's step), and leaves the plan's key
as it is: the chunk runner writes the scalars into device buffers before
each replay, like LAMB's.  The poison is ``where(hit > 0, value, x[0,
..., 0])`` written into a copy of the leaf, so the caller's tensor is
never written.  Called eagerly without ``scalars=``, the wrapper makes the
same scalars itself (``firstorder.device_scalars``).

Checkpoint faults are host-side files: :func:`truncate_checkpoint` and
:func:`corrupt_checkpoint` damage a saved checkpoint directory byte for
byte as the reference's do, for ``checkpointing.restore_latest_valid`` to
roll back past.  The host sites (``HOST_SITES``: ``kill_shard``,
``delay_shard``, ``drop_collective``) never enter the step:
:func:`chaotic` leaves them alone, and ``training/resilience.py``
``elastic_train`` takes them from ``ChaosPlan.host_events`` and fires them
at span boundaries (the launcher's ``--elastic``).

CLI: ``python -m repro_torch.launch.train ... --health --chaos
"grad_nan@5,factor_inf@15"`` (optionally ``site@step:bucket_id``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import GradientTransformation, device_scalars
from repro_torch.core.mkor import MKORConfig, manifest_for
from repro_torch.tree import tree_leaves

SITES = ("grad_nan", "factor_inf", "window_flip", "payload_corrupt")
HOST_SITES = ("kill_shard", "delay_shard", "drop_collective")

_DEFAULT_VALUE = {"grad_nan": float("nan"), "factor_inf": float("inf"),
                  "window_flip": float("nan"),
                  "payload_corrupt": float("nan")}
_DELAY_FACTOR = 3.0                 # default delay_shard slowdown


@dataclass(frozen=True)
class Injection:
    site: str
    step: int
    bucket: Optional[str] = None    # bucket_id; None = first bucket
    value: Optional[float] = None   # poison value; None = site default

    def poison(self) -> float:
        return _DEFAULT_VALUE[self.site] if self.value is None \
            else self.value


@dataclass(frozen=True)
class HostFault:
    """A supervisor-level event (HOST_SITES), fired at a step boundary;
    never enters the step."""
    site: str
    step: int
    shard: int = 0                  # target worker (drop_collective: n/a)
    value: Optional[float] = None   # delay_shard slowdown factor

    def factor(self) -> float:
        return _DELAY_FACTOR if self.value is None else self.value


@dataclass(frozen=True)
class ChaosPlan:
    injections: Tuple[Injection, ...] = ()
    host_faults: Tuple[HostFault, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.injections or self.host_faults)

    def host_events(self, start: int, stop: int) -> Tuple[HostFault, ...]:
        """Host faults with ``start <= step < stop``, in step order."""
        return tuple(sorted((f for f in self.host_faults
                             if start <= f.step < stop),
                            key=lambda f: f.step))


def parse_chaos_spec(spec: str) -> ChaosPlan:
    """``"site@step[:bucket],site@step..."`` -> :class:`ChaosPlan`.

    In-graph sites take an optional ``:bucket_id``; host sites
    (``kill_shard``/``delay_shard``/``drop_collective``) take an optional
    ``:shard`` index instead."""
    inj, host = [], []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            site, rest = item.split("@", 1)
            arg = None
            if ":" in rest:
                rest, arg = rest.split(":", 1)
            step = int(rest)
        except ValueError:
            raise ValueError(f"bad chaos spec item {item!r} "
                             f"(want site@step[:bucket])") from None
        if site in HOST_SITES:
            try:
                shard = int(arg) if arg is not None else 0
            except ValueError:
                raise ValueError(f"bad chaos spec item {item!r} "
                                 f"(host sites want site@step[:shard])"
                                 ) from None
            host.append(HostFault(site=site, step=step, shard=shard))
        elif site in SITES:
            inj.append(Injection(site=site, step=step, bucket=arg))
        else:
            raise ValueError(f"unknown chaos site {site!r}; one of "
                             f"{SITES + HOST_SITES}")
    return ChaosPlan(tuple(inj), tuple(host))


def _as_value(value: float, dtype: torch.dtype):
    """``value`` in ``dtype``, raising where ``jnp.asarray(value, dtype)``
    does: an Inf or NaN, or an integer out of range, for an integer
    dtype."""
    if dtype.is_floating_point:
        return float(value)
    v = int(value)           # OverflowError for Inf, ValueError for NaN
    info = torch.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise OverflowError(f"Python integer {v} out of bounds for "
                            f"{str(dtype).removeprefix('torch.')}")
    return v


def _poison_elem(x: torch.Tensor, hit: torch.Tensor,
                 value: float) -> torch.Tensor:
    """A copy of ``x`` with element [0, ..., 0] set to ``value`` where the
    0-d ``hit`` is > 0 (a device select: no host read)."""
    poison = torch.full((), _as_value(value, x.dtype), dtype=x.dtype,
                        device=x.device)
    out = x.clone()
    idx = (0,) * x.ndim
    out[idx] = torch.where(hit > 0, poison, x[idx])
    return out


def _resolve_bucket(manifest, bucket_id):
    buckets = list(manifest)
    if not buckets:
        raise ValueError("chaos: no eligible MKOR buckets to inject into")
    if bucket_id is None:
        return buckets[0]
    for b in buckets:
        if b.bucket_id == bucket_id:
            return b
    raise ValueError(f"chaos: bucket {bucket_id!r} not in manifest "
                     f"{[b.bucket_id for b in buckets]}")


def hit_name(i: int) -> str:
    """The plan scalar of injection ``i``."""
    return f"chaos_hit_{i}"


def hit_values(plan: ChaosPlan, count: int) -> Dict[str, np.float32]:
    """Each injection's 0/1 hit at step ``count``."""
    return {hit_name(i): np.float32(count == inj.step)
            for i, inj in enumerate(plan.injections)}


def _apply(plan: ChaosPlan, mcfg: MKORConfig, hits, grads, state, stats):
    manifest = manifest_for(grads, mcfg)
    for i, inj in enumerate(plan.injections):
        bucket = _resolve_bucket(manifest, inj.bucket)
        hit = hits[hit_name(i)]
        val = inj.poison()
        path = bucket.paths[0]
        if inj.site == "grad_nan":
            dense = statlib.tree_get(grads, path)
            grads = statlib.tree_set(
                grads, path,
                {**dense, "w": _poison_elem(dense["w"], hit, val)})
        elif inj.site == "payload_corrupt":
            if stats is None or statlib.get_a_vec(stats, path) is None:
                raise ValueError("chaos: payload_corrupt needs rank-1 "
                                 "stats (collect_stats=True)")
            node = statlib.tree_get(stats, path)
            stats = statlib.tree_set(
                stats, path,
                {**node, "a": _poison_elem(node["a"], hit, val)})
        elif inj.site == "factor_inf":
            if "factor_banks" not in state:
                raise ValueError("chaos: factor_inf needs the bank layout")
            bank = state["factor_banks"][bucket.bucket_id]
            state = {**state, "factor_banks": {
                **state["factor_banks"],
                bucket.bucket_id: {
                    **bank,
                    "l_inv": _poison_elem(bank["l_inv"], hit, val)}}}
        elif inj.site == "window_flip":
            if "stat_windows" not in state:
                raise ValueError("chaos: window_flip needs stat windows "
                                 "(rank > 1 or staleness >= 1)")
            win = state["stat_windows"][bucket.bucket_id]
            state = {**state, "stat_windows": {
                **state["stat_windows"],
                bucket.bucket_id: {
                    **win, "a": _poison_elem(win["a"], hit, val)}}}
        else:                                       # pragma: no cover
            raise ValueError(inj.site)
    return grads, state, stats


def chaotic(optimizer: GradientTransformation, plan: ChaosPlan,
            mcfg: MKORConfig) -> GradientTransformation:
    """Wrap ``optimizer`` so ``plan``'s injections fire inside its update
    (module docstring).  ``precompute`` and ``observe`` are the
    optimizer's; ``plan`` is the optimizer's with the hit scalars added
    and the same key.  A plan without injections returns the optimizer
    untouched (host faults are not handled here)."""
    if not plan.injections:
        return optimizer

    def plan_fn(state, **kw):
        key, scalars = optimizer.plan(state, **kw)
        return key, {**scalars, **hit_values(plan, int(state["count"]))}

    def update(grads, state, params=None, stats=None, loss=None,
               scalars=None, **kw):
        hits = scalars if scalars is not None else device_scalars(
            hit_values(plan, int(state["count"])),
            tree_leaves(grads)[0].device)
        grads, state, stats = _apply(plan, mcfg, hits, grads, state, stats)
        return optimizer.update(grads, state, params=params, stats=stats,
                                loss=loss, scalars=scalars, **kw)

    return GradientTransformation(
        optimizer.init, update, optimizer.precompute,
        plan_fn if optimizer.plan is not None else None, optimizer.observe)


# --------------------------------------------------------------------- #
# Host-side checkpoint faults (crash / corruption simulation)
# --------------------------------------------------------------------- #
def _ckpt_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def truncate_checkpoint(directory: str, step: int, nbytes: int = 64) -> str:
    """Truncate ``arrays.npz`` to ``nbytes`` -- a crash mid-array-write."""
    path = os.path.join(_ckpt_dir(directory, step), "arrays.npz")
    with open(path, "rb") as f:
        head = f.read(nbytes)
    with open(path, "wb") as f:
        f.write(head)
    return path


def corrupt_checkpoint(directory: str, step: int,
                       mode: str = "arrays") -> str:
    """Damage one file of a saved checkpoint.

    mode: ``arrays`` flips bytes inside arrays.npz (CRC-detectable),
    ``manifest`` overwrites the manifest with garbage, ``marker``
    removes the COMMITTED marker (a crash before the commit)."""
    d = _ckpt_dir(directory, step)
    if mode == "marker":
        path = os.path.join(d, "COMMITTED")
        os.remove(path)
        return path
    if mode == "manifest":
        path = os.path.join(d, "manifest.msgpack")
        with open(path, "wb") as f:
            f.write(b"\x00garbage\xff")
        return path
    if mode == "arrays":
        path = os.path.join(d, "arrays.npz")
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            # flip bytes in the back half: past the zip directory header,
            # inside some member's payload
            for off in range(len(data) // 2, len(data) // 2 + 8):
                data[off] ^= 0xFF
            f.seek(0)
            f.write(data)
        return path
    raise ValueError(f"unknown corrupt mode {mode!r}")
