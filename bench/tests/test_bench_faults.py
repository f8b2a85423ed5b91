"""The timed path broken underneath a whole run, on the CPU: each fault a
training cell can have, and a stale replay and a skipped precondition,
makes ``correct`` false under the cell's limits.
The run skips the look for a card (``device="cpu"``, toy widths in
float32, where the unbroken program reads correct)."""
import json
import time

import pytest

from conftest import BENCH, CELLS


def unchanged(step):
    """A step that returns its parameters and state unchanged."""
    def broken(params, opt_state, batch, scalars=None, view=None):
        _, _, metrics = step(params, opt_state, batch, scalars=scalars,
                             view=view)
        return params, opt_state, metrics
    broken.plan, broken.observe = step.plan, step.observe
    return broken


def half_batch(step):
    """Half of the batch left out: the mean over the other half."""
    def broken(params, opt_state, batch, scalars=None, view=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, opt_state, half, scalars=scalars, view=view)
    broken.plan, broken.observe = step.plan, step.observe
    return broken


def stale_replay(keys):
    """Of steps that cycle over ``keys`` graphs (each first eager, then
    captured and replayed), every later replay runs on the batch its
    graph was captured with: a bound batch that is never refreshed."""
    def wrap(step):
        seen = []

        def broken(params, opt_state, batch, scalars=None, view=None):
            i = len(seen)
            seen.append(batch)
            if i >= 2 * keys:
                batch = seen[keys + i % keys]
            return step(params, opt_state, batch, scalars=scalars,
                        view=view)
        broken.plan, broken.observe = step.plan, step.observe
        return broken
    return wrap


def _run(spec_factory, cell, fault):
    import harness
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    spec = spec_factory(cell, limits=limits)
    if fault is stale_replay:
        fault = stale_replay(harness.graph_keys(spec.traffic["optimizer"]))
    return harness.run(spec, 97, 0.1, False, time.perf_counter(),
                       device="cpu", fault=fault, say=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(spec_factory, cell):
    assert _run(spec_factory, cell, None)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, stale_replay])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(spec_factory, cell, fault):
    res = _run(spec_factory, cell, fault)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", [c for c in CELLS if ".mkor" in c])
def test_skipped_precondition_is_not_correct(spec_factory, cell,
                                             monkeypatch):
    """The program's precondition returns G (both factors I)."""
    from repro_torch.core import mkor
    monkeypatch.setattr(mkor, "precondition",
                        lambda l_inv, r_inv, g_w: g_w.float())
    res = _run(spec_factory, cell, None)
    assert not res["correct"], res["check"]
