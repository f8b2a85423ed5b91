"""The port's elastic supervisor (``repro_torch/training/resilience.py``)
against ``repro/training/resilience.py``: the counterparts of
``tests/test_resilience.py``, each run through both packages on the same
inputs.

Held: the retry schedule (the same floats for the same seed) and
``with_retries``'s recovery, exhaustion and non-retryable errors; the
SIGTERM guard; the straggler EWMAs and flags on the same time sequences
(at world 2 the median is the larger EWMA, so neither package ever flags
a shard); the supervisor's transitions and events; ``orphaned_buckets``
for every dead worker at world 8 on the conftest autoencoder;
``quarantine_orphans`` on a real 4-step state (staleness 1 and the
sentinel, rank 1 and rank 2, carried into the port through
``interop.opt_state_from_numpy``) leaf by leaf, bit for bit; int8 state,
on which both packages raise; ``split_schedule`` over a grid; and the
elastic loop with a fake runner for a dropped collective, a delayed
shard and preemption, the port's clock and sleeps injected (no host clock
is read)."""
import builtins
import importlib
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.core import baseline_net as j_net
from repro.core import firstorder as j_fo
from repro.training import chaos as j_chaos
from repro.training import resilience as j_res
from repro_torch import interop
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.training import chaos as t_chaos
from repro_torch.training import resilience as t_res

from test_torch_dist import _host
from torch_dist_worker import ae_batch

j_mkor = importlib.import_module("repro.core.mkor")
CPU = torch.device("cpu")


# --------------------------------------------------------------------- #
# Retry / backoff, preemption
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [dict(), dict(max_attempts=6, base_s=0.1,
                                             cap_s=1.0, seed=3),
                                dict(max_attempts=9, seed=4),
                                dict(max_attempts=1, seed=7)])
def test_retry_policy_sleeps_equal_reference(kw):
    got = t_res.RetryPolicy(**kw).sleeps()
    assert got == j_res.RetryPolicy(**kw).sleeps()
    assert len(got) == max(kw.get("max_attempts", 3) - 1, 0)


def _retry_trace(res, fails, error, max_attempts):
    """What ``with_retries`` did with ``fn`` failing ``fails`` times with
    ``error`` (the package's own ``CollectiveDropped``, or a builtin)."""
    exc_type = getattr(res, error, None) or getattr(builtins, error)
    calls, slept, retries = [], [], []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc_type("down")
        return "ok"
    try:
        out = res.with_retries(
            fn, res.RetryPolicy(max_attempts=max_attempts, seed=5),
            sleep=slept.append, on_retry=lambda a, e: retries.append(a))
    except exc_type as exc:
        out = type(exc).__name__
    return out, len(calls), slept, retries


@pytest.mark.parametrize("fails,error,attempts", [
    (2, "CollectiveDropped", 3), (5, "CollectiveDropped", 2),
    (1, "OSError", 3), (1, "ValueError", 5)],
    ids=["recovers", "exhausts", "oserror", "non-retryable"])
def test_with_retries_matches_reference(fails, error, attempts):
    got, want = (_retry_trace(res, fails, error, attempts)
                 for res in (t_res, j_res))
    assert got == want
    if error == "ValueError":
        assert got[:2] == ("ValueError", 1)       # never retried
    elif fails < attempts:
        assert got[0] == "ok" and len(got[2]) == fails


def test_preemption_guard_catches_sigterm_and_restores_handler():
    before = signal.getsignal(signal.SIGTERM)
    with t_res.PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)      # caught, not fatal
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before


# --------------------------------------------------------------------- #
# Straggler monitor, supervisor
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("world,kw", [
    (4, dict()), (4, dict(patience=1, min_obs=1)),
    (8, dict(slow_factor=1.5, alpha=0.5)), (2, dict(min_obs=1))])
def test_straggler_monitor_matches_reference(world, kw):
    rng = np.random.default_rng(world)
    mons = [res.StragglerMonitor(world, **kw) for res in (j_res, t_res)]
    flagged = [[], []]
    for i in range(40):
        times = list(rng.uniform(0.5, 1.5, world))
        if 10 <= i < 25:
            times[world - 1] *= 4.0          # a slow spell of the last shard
        for k, mon in enumerate(mons):
            flagged[k].append(mon.observe(times))
    assert flagged[1] == flagged[0]
    assert mons[1].ewma == mons[0].ewma
    assert mons[1]._strikes == mons[0]._strikes
    if world == 2:
        # the median sorted(ewma)[1] is the larger EWMA: nothing is flagged
        assert not any(flagged[0])
    else:
        assert any(flagged[0])


def _supervisor_calls(res):
    sup = res.ElasticSupervisor(
        4, monitor=res.StragglerMonitor(4, patience=1, min_obs=1))
    out = [sup.observe_step_times([1.0, 1.0, 1.0, 9.0], step=3),
           sup.status[3], sup.live_mask(),
           sup.recover(3, step=7), sup.declare_dead(2, step=8),
           sup.declare_dead(2, step=9), sup.recover(2), sup.n_live(),
           sup.observe_step_times([1.0, 9.0, 1.0, 1.0], step=10)]
    sup.declare_dead(0)
    sup.declare_dead(3)
    with pytest.raises(RuntimeError, match="every worker"):
        sup.declare_dead(1)
    return out, sup.status, sup.events


def test_supervisor_transitions_and_events_match_reference():
    got, want = (_supervisor_calls(res) for res in (t_res, j_res))
    assert got == want
    assert [e["event"] for e in got[2]][:2] == ["demoted (straggler)",
                                                "recovered"]


# --------------------------------------------------------------------- #
# Orphan quarantine
# --------------------------------------------------------------------- #
def _cfgs(world=8, **kw):
    dist = (("data", world),)
    return (j_mkor.MKORConfig(dist=dist, exclude=(), **kw),
            t_mkor.MKORConfig(dist=dist, exclude=(), **kw))


def test_orphaned_buckets_match_reference(ae_params):
    j_cfg, t_cfg = _cfgs()
    params = interop.params_from_numpy(_host(ae_params), CPU)
    for dead in range(8):
        want = j_res.orphaned_buckets(ae_params, j_cfg, [dead])
        assert t_res.orphaned_buckets(params, t_cfg, [dead]) == want
    old = (True, False, True, True, True, True, False, True)
    for dead in range(8):
        assert t_res.orphaned_buckets(params, t_cfg, [dead], old) \
            == j_res.orphaned_buckets(ae_params, j_cfg, [dead], old)


def _jax_state(ae_params, steps, **kw):
    opt = j_mkor.mkor(j_fo.sgd(1e-2, momentum=0.9),
                      j_mkor.MKORConfig(exclude=(), **kw))
    state = opt.init(ae_params)

    def step_fn(p, s, b):
        _, g, st = j_net.grads_and_full_stats(p, b)
        return opt.update(g, s, params=p, stats=st)[1]
    step = jax.jit(step_fn)
    for i in range(steps):
        state = step(ae_params, state, ae_batch(i))
    return state


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("rank", [1, 2])
def test_quarantine_orphans_matches_reference(ae_params, rank):
    """A real 4-step state (staleness 1, the sentinel): the port's
    quarantine equals JAX's leaf by leaf, bit for bit, for a dead worker
    on the full map and on an already-remapped one; orphans reset, the
    rest untouched, the caller's state unwritten."""
    common = dict(staleness=1, health=True, inv_freq=2, rank=rank)
    j_state = _jax_state(ae_params, 4, **common)
    j_cfg, t_cfg = _cfgs(**common)
    params = interop.params_from_numpy(_host(ae_params), CPU)
    for dead, old in ((0, None), (1, (False,) + (True,) * 7)):
        t_state = interop.opt_state_from_numpy(_host(j_state), CPU)
        before = interop.opt_state_to_numpy(t_state)
        want, want_ids = j_res.quarantine_orphans(
            j_state, ae_params, j_cfg, [dead], old)
        got, got_ids = t_res.quarantine_orphans(
            t_state, params, t_cfg, [dead], old)
        assert got_ids == want_ids and got_ids
        w, g = _leaves(_host(want)), _leaves(interop.opt_state_to_numpy(got))
        assert len(w) == len(g)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        for a, b in zip(_leaves(interop.opt_state_to_numpy(t_state)),
                        _leaves(before)):
            assert a.tobytes() == b.tobytes()     # the input is unwritten
        for bid in got_ids:
            h = got["health"][bid]
            assert int(h["cooldown"]) == t_cfg.health_cooldown
            assert int(h["trips"]) == int(t_state["health"][bid]["trips"]) + 1


def test_quarantine_per_layer_state_returned_unchanged(ae_params):
    j_cfg, t_cfg = _cfgs(layout="per_layer")
    params = interop.params_from_numpy(_host(ae_params), CPU)
    opt = t_mkor.mkor(t_fo.sgd(1e-2),
                      t_mkor.MKORConfig(exclude=(), layout="per_layer"))
    state = opt.init(params)
    got, ids = t_res.quarantine_orphans(state, params, t_cfg, [0])
    j_state = j_mkor.mkor(j_fo.sgd(1e-2), j_mkor.MKORConfig(
        exclude=(), layout="per_layer")).init(ae_params)
    _, want_ids = j_res.quarantine_orphans(j_state, ae_params, j_cfg, [0])
    assert got is state and ids == want_ids


def test_quarantine_int8_state_raises_in_both(ae_params):
    """The reference's quarantine broadcasts eye(d) to an int8 bank's
    per-slice scale and raises ``ValueError``; the port raises at the same
    leaf, naming it."""
    kw = dict(factor_quant="int8", staleness=1)
    j_cfg, t_cfg = _cfgs(**kw)
    j_state = _jax_state(ae_params, 4, **kw)
    with pytest.raises(ValueError, match="fewer dimensions") as jax_err:
        j_res.quarantine_orphans(j_state, ae_params, j_cfg, [0])
    t_state = interop.opt_state_from_numpy(_host(j_state), CPU)
    params = interop.params_from_numpy(_host(ae_params), CPU)
    with pytest.raises(ValueError, match="fewer dimensions") as port_err:
        t_res.quarantine_orphans(t_state, params, t_cfg, [0])
    # the same leaf: the broadcast's shapes in both messages
    shapes = str(jax_err.value).split("arr_shape=")[1]
    assert f"arr_shape={shapes}" in str(port_err.value)
    assert "src/repro/core/mkor.py:379" in str(port_err.value)


# --------------------------------------------------------------------- #
# Schedule and the elastic loop with a fake runner
# --------------------------------------------------------------------- #
def test_split_schedule_matches_reference():
    for start in (0, 2, 5):
        for steps in (0, 1, 4, 9):
            for chunk in (1, 2, 3, 8):
                for events in ([], [0], [3], [3, 5], [start + 1, 40],
                               [start + steps]):
                    assert t_res.split_schedule(start, steps, chunk, events) \
                        == j_res.split_schedule(start, steps, chunk, events)


def _fake_factory(log):
    def factory(live):
        log.append(("build", live))

        def runner(params, state, stacked):
            n = len(stacked["step"])
            log.append(("run", tuple(int(s) for s in stacked["step"])))
            return params, state, {"loss": np.arange(n, dtype=np.float32)
                                   + float(stacked["step"][0])}
        return runner
    return factory


def _fake_batches():
    return (lambda s: {"step": np.asarray([s])},
            lambda bs: {"step": np.concatenate([b["step"] for b in bs])})


class _Clock:
    """A clock that advances ``tick`` seconds a call."""

    def __init__(self, tick):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _drive(res, *, plan=None, world=4, guard=None, saves=None, steps=8,
           start=0, chunk=2, monitor=None, **kw):
    log, slept = [], []
    make_batch, stack = _fake_batches()
    sup = res.ElasticSupervisor(world, monitor=monitor)
    _, _, hist, pre = res.elastic_train(
        _fake_factory(log), {}, {}, make_batch=make_batch,
        stack_batches=stack, start=start, steps=steps, chunk=chunk,
        supervisor=sup, plan=plan, guard=guard, sleep=slept.append,
        save=None if saves is None else
        (lambda at, p, s, extra: saves.append((at, extra))),
        ckpt_every=kw.pop("ckpt_every", 0), **kw)
    return hist, pre, log, slept, sup


def test_elastic_train_clean_and_drop_match_reference():
    for spec in (None, "drop_collective@2", "drop_collective@3"):
        runs = []
        for res, chaos in ((j_res, j_chaos), (t_res, t_chaos)):
            plan = chaos.parse_chaos_spec(spec) if spec else None
            hist, pre, log, slept, _ = _drive(res, plan=plan, start=1,
                                              steps=6)
            runs.append((hist, pre, log, slept))
        assert runs[1] == runs[0]
        hist, pre, log, slept = runs[1]
        assert [h["step"] for h in hist] == list(range(1, 7)) and not pre
        assert len(slept) == (1 if spec else 0)
        assert slept == t_res.RetryPolicy().sleeps()[:len(slept)]


def test_elastic_train_delay_shard_demotes_with_injected_clock():
    """``delay_shard@2:3`` with the port's clock injected: shard 3 demoted
    and the runner rebuilt for the new mask; the events equal the JAX
    supervisor's fed the same per-shard times; no host clock is read."""
    mon = dict(slow_factor=2.0, patience=2, min_obs=1)
    plan = t_chaos.parse_chaos_spec("delay_shard@2:3")
    hist, _, log, _, sup = _drive(
        t_res, plan=plan, clock=_Clock(0.5),
        monitor=t_res.StragglerMonitor(4, **mon))
    assert len(hist) == 8 and sup.status[3] == t_res.DEMOTED
    builds = [e[1] for e in log if e[0] == "build"]
    assert builds[0] is None and builds[-1] == (True, True, True, False)
    # the JAX supervisor on the times the port reported: 0.5 s a span of
    # 2 steps, shard 3 x3 from step 2
    ref = j_res.ElasticSupervisor(4, monitor=j_res.StragglerMonitor(4, **mon))
    for lo in (0, 2, 4, 6):
        times = [0.25 * (3.0 if i == 3 and lo >= 2 else 1.0)
                 for i in range(4)]
        for _ in range(2):
            ref.observe_step_times(times, lo)
    assert sup.events == ref.events and sup.status == ref.status


def test_elastic_train_preemption_matches_reference():
    runs = []
    for res in (j_res, t_res):
        class TrippedGuard:
            calls = 0

            @property
            def triggered(self):
                TrippedGuard.calls += 1
                return TrippedGuard.calls > 1      # trip after 1st span
        saves = []
        hist, pre, log, _, _ = _drive(res, guard=TrippedGuard(), saves=saves,
                                      ckpt_every=4)
        runs.append((hist, pre, log, saves))
    assert runs[1] == runs[0]
    hist, pre, _, saves = runs[1]
    assert pre and [h["step"] for h in hist] == [0, 1]
    assert saves == [(2, {"emergency": True})]     # cursor = next batch
