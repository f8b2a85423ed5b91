"""Elastic fault tolerance: the host-side supervisor (port of
``repro/training/resilience.py``).

The data-parallel step pins each bucket's inversion slices to an owner
rank (``core/stats.py`` ``bucket_owner_map``), so one lost rank would kill
the run and orphan that bucket's second-order state.  This module is what
happens outside the step to make the run degrade instead, with the
reference's names, statuses and event dicts:

* :class:`RetryPolicy` / :func:`with_retries`: bounded attempts with
  decorrelated-jitter backoff around the span dispatch (the same sleeps as
  the reference for the same seed: both draw from ``random.Random``).
* :class:`PreemptionGuard`: SIGTERM as a flag polled at span boundaries;
  ``elastic_train`` then takes an emergency checkpoint with the data
  cursor and the caller exits 0.
* :class:`StragglerMonitor` / :class:`ElasticSupervisor`: per-shard
  step-time EWMAs and the failover state machine (live, suspect, dead,
  demoted) that owns the liveness mask ``MKORConfig.live``.
* :func:`orphaned_buckets` / :func:`quarantine_orphans`: the buckets a dead
  rank owned slices of under the old map, and their reset: active and
  pending banks to the identity, windows and write counts to zero, the
  health cooldown armed.
* :func:`split_schedule` / :func:`elastic_train`: the chunk loop of the
  launcher's ``--elastic``, spans cut at every host fault
  (``training/chaos.py`` ``kill_shard``, ``delay_shard``,
  ``drop_collective``).

**Every rank decides the same way.**  The reference is one controller
deciding for all its devices.  The port runs one process a rank, and two
ranks that take different transitions build different masks, whose
owner-sharded gathers then disagree or hang.  So when ``mcfg.dist`` spans
more than one rank, :func:`elastic_train` agrees on every input of a
decision through one small all-reduce (max) at each span boundary: before
the first span the preemption flag, after each span the flag and the
span's wall time.  The flag is OR-ed (every rank stops at the same span)
and the time is the slowest rank's, from which every rank builds the
reference's per-shard times ``[per_step * delay_i]``, so every monitor sees
the same input.  The chaos plan is the same on every rank, so a kill and a
drop fire together; a simulated drop raises before the runner on every
rank, so the retry is taken everywhere.  Before each span runs, a second
all-reduce holds every rank's liveness mask against the others' and
raises on any difference: a rank never runs a span on a mask of its own.
At world 1, or without ``dist``, no collective runs.  A real failure
inside one rank's runner is not agreed on: it raises there, as in the
reference.

**int8 factor state.**  The reference's quarantine resets every leaf of an
orphaned bank with ``_identity_like`` (``src/repro/core/mkor.py:379``), which
broadcasts ``eye(d)`` to the leaf's shape; an int8 bank's per-slice scale
has fewer dimensions, and the broadcast raises ``ValueError``
(``src/repro/training/resilience.py:336``).  The port resets each leaf the
same way and raises at the same leaf with a message that names that
failure; it does not reset the codes to 127·I, which would be a fix the
reference lacks.

**The runner rebuild.**  A new mask builds a new runner; the old one's
``release()`` (``training/loop.py`` ``ChunkRunner.release``) frees its
graphs, static buffers and pool before the new one captures, so the card
never holds two graph pools.
"""
from __future__ import annotations

import random
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import stats as statlib
from repro_torch.core.mkor import MKORConfig, manifest_for
from repro_torch.sharding import collectives
from repro_torch.tree import tree_leaves, tree_map

# failover state machine (the reference's statuses)
LIVE = "live"          # healthy, owns its slice ranges
SUSPECT = "suspect"    # straggling: EWMA over threshold, not yet demoted
DEAD = "dead"          # declared lost: owns nothing, orphans quarantined
DEMOTED = "demoted"    # alive but slow: owns nothing, still computes grads
STATUSES = (LIVE, SUSPECT, DEAD, DEMOTED)


class Preempted(Exception):
    """Raised (or returned as a flag) when SIGTERM interrupted training."""


class CollectiveDropped(RuntimeError):
    """A (simulated) collective timeout: the retryable dispatch failure the
    chaos ``drop_collective`` site raises."""


# --------------------------------------------------------------------- #
# Retry / backoff
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with decorrelated-jitter backoff: sleep_k ~
    Uniform(base_s, 3 * sleep_{k-1}) clipped to cap_s, drawn from
    ``random.Random(seed)`` (the reference's schedule for the same seed)."""
    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    seed: int = 0

    def sleeps(self) -> List[float]:
        """The full (max_attempts - 1)-entry backoff schedule."""
        rng = random.Random(self.seed)
        out, prev = [], self.base_s
        for _ in range(max(self.max_attempts - 1, 0)):
            prev = min(self.cap_s, rng.uniform(self.base_s, 3.0 * prev))
            out.append(prev)
        return out


def with_retries(fn: Callable[[], Any], policy: RetryPolicy, *,
                 retry_on: Tuple[type, ...] = (CollectiveDropped, OSError),
                 on_retry: Optional[Callable[[int, BaseException], None]]
                 = None,
                 sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn`` with up to ``policy.max_attempts`` attempts.  Only
    ``retry_on`` exceptions are retried; anything else propagates at once,
    as does the last retryable failure.  ``on_retry(attempt, exc)``
    observes each retry; ``sleep`` is injectable."""
    sleeps = policy.sleeps()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.max_attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(sleeps[attempt])


# --------------------------------------------------------------------- #
# Preemption
# --------------------------------------------------------------------- #
class PreemptionGuard:
    """SIGTERM (by default) as a polled flag.  A context manager; the
    previous handlers come back on exit."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: Dict[int, Any] = {}
        self._hits: List[int] = []

    def __enter__(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        self._hits.append(signum)

    @property
    def triggered(self) -> bool:
        return bool(self._hits)


# --------------------------------------------------------------------- #
# Straggler awareness
# --------------------------------------------------------------------- #
class StragglerMonitor:
    """Per-shard step-time EWMAs: a shard whose EWMA exceeds
    ``slow_factor`` times the median EWMA (``sorted(ewma)[world // 2]``,
    the reference's: at world 2 that is the larger EWMA, so no shard is
    ever flagged) for ``patience`` consecutive observations is flagged,
    once ``min_obs`` observations are in."""

    def __init__(self, world: int, *, alpha: float = 0.3,
                 slow_factor: float = 2.0, patience: int = 2,
                 min_obs: int = 3):
        self.world = world
        self.alpha = alpha
        self.slow_factor = slow_factor
        self.patience = patience
        self.min_obs = min_obs
        self.ewma = [0.0] * world
        self.n_obs = 0
        self._strikes = [0] * world

    def observe(self, shard_times_s: Sequence[float]) -> List[int]:
        """Feed one step's per-shard wall times; returns the shards whose
        strike count just reached ``patience``."""
        if len(shard_times_s) != self.world:
            raise ValueError(f"expected {self.world} shard times, got "
                             f"{len(shard_times_s)}")
        a = self.alpha
        for i, t in enumerate(shard_times_s):
            self.ewma[i] = t if self.n_obs == 0 \
                else (1 - a) * self.ewma[i] + a * float(t)
        self.n_obs += 1
        if self.n_obs < self.min_obs:
            return []
        med = sorted(self.ewma)[self.world // 2]
        flagged = []
        for i, e in enumerate(self.ewma):
            if med > 0 and e > self.slow_factor * med:
                self._strikes[i] += 1
                if self._strikes[i] == self.patience:
                    flagged.append(i)
            else:
                self._strikes[i] = 0
        return flagged


# --------------------------------------------------------------------- #
# Failover state machine
# --------------------------------------------------------------------- #
@dataclass
class ElasticSupervisor:
    """Worker statuses and the liveness mask derived from them::

        live --observe slow--> suspect --patience--> demoted
        live/suspect --declare_dead--> dead
        demoted --recover--> live       (dead workers never recover in-run)

    A transition that changes the mask rebuilds the runner with
    ``MKORConfig.live`` set to it; a death also quarantines the orphans.
    ``echo`` prints the supervisor's lines (the launcher passes rank 0's
    printer, so one rank speaks)."""
    world: int
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    monitor: Optional[StragglerMonitor] = None
    demote_stragglers: bool = True
    status: List[str] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    echo: Callable[[str], None] = print

    def __post_init__(self):
        if not self.status:
            self.status = [LIVE] * self.world
        if self.monitor is None:
            self.monitor = StragglerMonitor(self.world)

    def live_mask(self) -> Tuple[bool, ...]:
        return tuple(s in (LIVE, SUSPECT) for s in self.status)

    def n_live(self) -> int:
        return sum(self.live_mask())

    def _log(self, step: int, kind: str, shard: int) -> None:
        self.events.append({"step": step, "event": kind, "shard": shard,
                            "mask": self.live_mask()})
        self.echo(f"[elastic] step {step}: shard {shard} {kind} "
                  f"(live {self.n_live()}/{self.world})")

    def declare_dead(self, shard: int, step: int = -1) -> bool:
        """live/suspect/demoted → dead.  True iff the mask changed (the
        caller remaps and quarantines)."""
        if self.status[shard] == DEAD:
            return False
        owned = self.status[shard] in (LIVE, SUSPECT)
        self.status[shard] = DEAD
        if self.n_live() == 0:
            raise RuntimeError("elastic: every worker is dead")
        self._log(step, "declared dead", shard)
        return owned

    def observe_step_times(self, shard_times_s: Sequence[float],
                           step: int = -1) -> bool:
        """Feed per-shard step times and apply the straggler policy.  True
        iff the mask changed (a demotion)."""
        changed = False
        for shard in self.monitor.observe(shard_times_s):
            if self.status[shard] != LIVE:
                continue
            if self.demote_stragglers:
                self.status[shard] = DEMOTED
                self._log(step, "demoted (straggler)", shard)
                changed = True
            else:
                self.status[shard] = SUSPECT
                self._log(step, "suspect (straggler)", shard)
        return changed

    def recover(self, shard: int, step: int = -1) -> bool:
        """demoted/suspect → live (the shard caught back up)."""
        if self.status[shard] not in (DEMOTED, SUSPECT):
            return False
        changed = self.status[shard] == DEMOTED
        self.status[shard] = LIVE
        self._log(step, "recovered", shard)
        return changed


# --------------------------------------------------------------------- #
# Orphan quarantine (host-side state surgery)
# --------------------------------------------------------------------- #
def orphaned_buckets(tree, cfg: MKORConfig, dead: Sequence[int],
                     old_live: Optional[Tuple[bool, ...]] = None
                     ) -> List[str]:
    """Bucket ids whose slices the ``dead`` workers owned under the OLD
    map (``old_live``), in manifest order."""
    manifest = manifest_for(tree, cfg)
    owners = statlib.bucket_owner_map(
        manifest, collectives.world_size(cfg.dist), old_live)
    return [b.bucket_id for b in manifest
            if any(owners[b.bucket_id][w][1] > owners[b.bucket_id][w][0]
                   for w in dead)]


def _identity_like(leaf: torch.Tensor) -> torch.Tensor:
    """``eye(d)`` (d the leaf's last dim) broadcast to the leaf's shape in
    its dtype, as the reference's ``_identity_like``; where that broadcast
    fails (an int8 bank's per-slice scale) the reference's ``ValueError``,
    naming it."""
    shape = tuple(leaf.shape)
    d = shape[-1] if shape else 1
    ok = len(shape) >= 2 and all(s == e or e == 1 for s, e in
                                 zip(shape[-2:], (d, d)))
    if not ok:
        raise ValueError(
            f"Cannot broadcast to shape with fewer dimensions: arr_shape="
            f"({d}, {d}) shape={shape}: the quarantine resets every leaf of "
            "an orphaned bank with the reference's _identity_like "
            "(src/repro/core/mkor.py:379, called at "
            "src/repro/training/resilience.py:336), which fails the same "
            "way on int8 factor state")
    eye = torch.eye(d, dtype=leaf.dtype, device=leaf.device)
    return eye.expand(shape).contiguous()


def quarantine_orphans(opt_state, tree, cfg: MKORConfig,
                       dead: Sequence[int],
                       old_live: Optional[Tuple[bool, ...]] = None):
    """The reference's reset of the orphaned buckets: active AND pending
    banks to the identity (the first-order passthrough; a dead owner's
    pending inversion is discarded), windows and write counts to zero, and
    with the sentinel on ``cooldown = health_cooldown`` and ``trips + 1``.
    Healthy buckets are untouched; a state without ``"factor_banks"`` (the
    per-layer layout) comes back as it is.  New tensors, on each leaf's
    device; the caller's are not written.  Returns ``(new_opt_state,
    orphaned_bucket_ids)``."""
    orphans = orphaned_buckets(tree, cfg, dead, old_live)
    if not orphans or "factor_banks" not in opt_state:
        return opt_state, orphans

    state = dict(opt_state)
    for key in ("factor_banks", "pending_banks"):
        if key not in state:
            continue
        banks = dict(state[key])
        for bid in orphans:
            banks[bid] = {k: _identity_like(v) for k, v in banks[bid].items()}
        state[key] = banks
    if "stat_windows" in state:
        wins = dict(state["stat_windows"])
        for bid in orphans:
            wins[bid] = tree_map(torch.zeros_like, wins[bid])
        state["stat_windows"] = wins
    if "health" in state:
        health = dict(state["health"])
        for bid in orphans:
            h = health[bid]
            health[bid] = {
                "cooldown": torch.full_like(h["cooldown"],
                                            cfg.health_cooldown),
                "trips": h["trips"] + 1}
        state["health"] = health
    return state, orphans


# --------------------------------------------------------------------- #
# The elastic chunk loop (launch/train.py --elastic)
# --------------------------------------------------------------------- #
def split_schedule(start: int, n_steps: int, chunk: int,
                   event_steps: Sequence[int]) -> List[Tuple[int, int]]:
    """Spans ``[(lo, hi), ...)`` covering ``[start, start + n_steps)``, at
    most ``chunk`` steps each, with a boundary at every event step."""
    stop = start + n_steps
    cuts = sorted({s for s in event_steps if start < s < stop})
    spans, lo = [], start
    for cut in cuts + [stop]:
        while lo < cut:
            hi = min(lo + chunk, cut)
            spans.append((lo, hi))
            lo = hi
    return spans


class _Agreement:
    """The span-boundary collectives of a data-parallel run (module
    docstring): all-reduce max of a few float64 values, on the parameters'
    device through ``collectives.transport``.  Inactive (no collective)
    without ``dist`` or at world 1."""

    def __init__(self, mcfg: Optional[MKORConfig], params):
        dist = mcfg.dist if mcfg is not None else None
        self.dist = dist if collectives.world_size(dist) > 1 else None
        leaves = tree_leaves(params)
        self.device = leaves[0].device if leaves else torch.device("cpu")

    def _max(self, values: Sequence[float]) -> List[float]:
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        return collectives.all_reduce_max(t).cpu().tolist()

    def boundary(self, stop: bool, seconds: float) -> Tuple[bool, float]:
        """(any rank's flag, the slowest rank's seconds)."""
        if self.dist is None:
            return stop, seconds
        flag, seconds = self._max([float(stop), seconds])
        return flag > 0, seconds

    def check_mask(self, mask: Tuple[bool, ...], step: int) -> None:
        """Raise unless every rank holds ``mask``."""
        if self.dist is None:
            return
        m = [float(x) for x in mask]
        got = self._max(m + [-x for x in m])
        hi, lo = got[:len(m)], [-x for x in got[len(m):]]
        if hi != lo:
            raise RuntimeError(
                f"elastic: at step {step} this rank's liveness mask {mask} "
                f"differs from another rank's (some rank holds a live "
                f"worker where another holds it dead: {hi} against {lo}); "
                "stopping before the span runs")


def elastic_train(runner_factory: Callable, params, opt_state, *,
                  make_batch: Callable[[int], Dict],
                  stack_batches: Callable,
                  start: int, steps: int, chunk: int,
                  supervisor: ElasticSupervisor,
                  plan=None,
                  mcfg: Optional[MKORConfig] = None,
                  save: Optional[Callable[[int, Any, Any, Dict], None]]
                  = None,
                  ckpt_every: int = 0,
                  on_metrics: Optional[Callable[[int, int, Dict], None]]
                  = None,
                  guard: Optional[PreemptionGuard] = None,
                  sleep: Callable[[float], None] = time.sleep,
                  clock: Callable[[], float] = time.perf_counter):
    """Run steps ``[start, start + steps)`` under the supervisor (the
    reference's loop, with the agreement of the module docstring).

    ``runner_factory(live_mask_or_None) -> runner`` builds the chunk runner
    for a mask; ``save(step, params, opt_state, extra_meta)`` persists a
    checkpoint whose ``step`` is the next unconsumed batch.  ``plan``'s
    host faults fire at the span boundaries :func:`split_schedule` aligns
    to them: ``kill_shard`` declares the shard dead, quarantines its
    orphans and rebuilds the runner; ``delay_shard`` inflates that shard's
    reported step time; ``drop_collective`` fails one dispatch, which the
    retry policy absorbs.  ``clock`` times a span (with ``sleep``,
    injectable: a test need not read the host clock).

    Returns ``(params, opt_state, history, preempted)``; ``preempted`` is
    True when the guard tripped and the emergency checkpoint was taken."""
    echo = supervisor.echo
    agree = _Agreement(mcfg, params)
    runner = runner_factory(None)
    host = list(plan.host_events(start, start + steps)) if plan else []
    delays: Dict[int, float] = {}          # shard -> slowdown factor
    drops: List[int] = []                  # steps with an armed drop
    history: List[Dict[str, float]] = []
    preempted = False

    def rebuild():
        # free the old runner's graphs and buffers before the new captures
        nonlocal runner
        release = getattr(runner, "release", None)
        if release is not None:
            release()
        runner = None
        runner = runner_factory(supervisor.live_mask())

    def apply_fault(f, at_step: int):
        nonlocal opt_state
        if f.site == "kill_shard":
            old_live = supervisor.live_mask()
            if supervisor.declare_dead(f.shard, at_step):
                opt_state, orphans = quarantine_orphans(
                    opt_state, params, mcfg, [f.shard], old_live)
                echo(f"[elastic] step {at_step}: quarantined "
                     f"{len(orphans)} orphaned bucket(s) {orphans}; "
                     f"remapping owners over {supervisor.n_live()} "
                     "survivors")
                rebuild()
        elif f.site == "delay_shard":
            delays[f.shard] = f.factor()
            echo(f"[elastic] step {at_step}: shard {f.shard} delayed "
                 f"x{f.factor():g} (chaos)")
        elif f.site == "drop_collective":
            drops.append(f.step)
        else:
            raise ValueError(f"not a host fault site: {f.site}")

    def triggered() -> bool:
        return guard is not None and guard.triggered

    stop, _ = agree.boundary(triggered(), 0.0)
    for lo, hi in split_schedule(start, steps, chunk,
                                 [f.step for f in host]):
        if stop:
            preempted = True
            break
        for f in [f for f in host if f.step <= lo]:
            apply_fault(f, lo)
        host = [f for f in host if f.step > lo]
        agree.check_mask(supervisor.live_mask(), lo)

        stacked = stack_batches([make_batch(s) for s in range(lo, hi)])
        armed = [s for s in drops if lo <= s < hi]

        def attempt():
            if armed:
                armed.clear()
                raise CollectiveDropped(
                    f"chaos: collective dropped at step {lo}")
            return runner(params, opt_state, stacked)

        t0 = clock()
        params, opt_state, metrics = with_retries(
            attempt, supervisor.retry, sleep=sleep,
            on_retry=lambda a, e: echo(
                f"[elastic] step {lo}: dispatch failed ({e}); "
                f"retry {a + 1}/{supervisor.retry.max_attempts - 1}"))
        rows = {key: [float(x) for x in v] for key, v in metrics.items()}
        stop, seconds = agree.boundary(triggered(), clock() - t0)
        per_step = seconds / max(hi - lo, 1)

        # the per-shard report: the slowest rank's time per step on every
        # shard, inflated for shards under a chaos delay
        times = [per_step * delays.get(i, 1.0)
                 for i in range(supervisor.world)]
        for _ in range(lo, hi):
            if supervisor.observe_step_times(times, lo):
                rebuild()

        for k in range(hi - lo):
            m = {key: v[k] for key, v in rows.items()}
            m["step"] = lo + k
            history.append(m)
            if on_metrics is not None:
                on_metrics(lo + k, hi, m)

        if save is not None and ckpt_every and hi < start + steps \
                and (hi // ckpt_every) > (lo // ckpt_every):
            save(hi, params, opt_state, {"loss": history[-1]["loss"]})

    if preempted and save is not None:
        at = history[-1]["step"] + 1 if history else start
        save(at, params, opt_state, {"emergency": True})
        echo(f"[elastic] preemption: emergency checkpoint at cursor step "
             f"{at}; exiting cleanly")
    return params, opt_state, history, preempted
