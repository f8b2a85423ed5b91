"""The phase split of ``bench/phases.py`` and its readers, on traces built
by hand: each step's marks and kernels laid out on a clock in µs."""
import importlib.util
from types import SimpleNamespace

import pytest

from conftest import BENCH
import devtrace
import phases

MKOR = ("forward", "backward", "second_order", "first_order", "apply",
        "end")
LAMB = tuple(p for p in MKOR if p != "second_order")
US = 1e-6


def _step(t0, order, lengths, kernels=()):
    """Marks of one step from ``t0`` (µs): each phase of ``order`` lasts
    its ``lengths`` entry; ``kernels``: (name, phase, offset, duration)
    placed inside a phase."""
    events, starts, t = [], {}, t0
    for p, dt in zip(order, list(lengths) + [0]):
        starts[p] = t
        events.append((f"repro_mark_{p}_kernel", t * US, (t + 1) * US))
        t += dt
    for name, p, off, dur in kernels:
        s = starts[p] + off
        events.append((name, s * US, (s + dur) * US))
    return events, t


def _trace(n_steps, order=MKOR, lengths=(100, 200, 50, 30, 20), gap=40,
           kernels=(), drop=None, window_extra=0):
    device, t = [], 0
    for i in range(n_steps):
        ev, t = _step(t, order, lengths, kernels)
        if drop is not None and i in drop[0]:
            ev = [e for e in ev if e[0] != f"repro_mark_{drop[1]}_kernel"]
        device += ev
        t += gap
    window_s = (t + window_extra) * US
    return devtrace.Trace(device, [], n_steps, window_s)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


DEVICE_METRICS = ("forward_ms_per_step", "backward_ms_per_step",
                  "mkor_ms_per_step", "firstorder_ms_per_step",
                  "apply_ms_per_step", "runner_ms_per_step")


def test_split_gives_each_phase_its_interval():
    t = _trace(10)
    got = phases.split(t)
    assert got == pytest.approx({
        "forward": 0.1, "backward": 0.2, "second_order": 0.05,
        "first_order": 0.03, "apply": 0.02, "runner": 0.04})


def test_lamb_step_has_no_second_order_and_backward_runs_to_first_order():
    t = _trace(8, order=LAMB, lengths=(100, 200, 30, 20))
    got = phases.split(t)
    assert set(got) == {"forward", "backward", "first_order", "apply",
                        "runner"}
    assert got["backward"] == pytest.approx(0.2)
    ctx = SimpleNamespace(trace=t)
    assert _reader("mkor_ms_per_step")(ctx) is None
    assert _reader("backward_ms_per_step")(ctx) == pytest.approx(0.2)


def test_a_step_with_a_missing_mark_is_dropped():
    # 40 steps, one without its apply mark: 39 whole steps (97.5 %)
    t = _trace(40, drop=([7], "apply"))
    assert len(phases.whole_steps(t)) == 39
    got = phases.split(t)
    assert got["forward"] == pytest.approx(0.1)
    # the dropped step's time is counted as the runner's
    assert got["runner"] == pytest.approx(
        t.window_s * 1e3 / 40 - (0.1 + 0.2 + 0.05 + 0.03 + 0.02))


def test_out_of_order_marks_are_dropped():
    ev, _ = _step(0, ("forward", "first_order", "backward", "apply", "end"),
                  (10, 10, 10, 10))
    assert phases.whole_steps(devtrace.Trace(ev, [], 1, 1e-4)) == []


@pytest.mark.parametrize("missing,readable", [(1, True), (2, True),
                                              (3, False), (40, False)])
def test_no_reading_below_95_percent_whole_steps(missing, readable):
    t = _trace(40, drop=(range(missing), "backward"))
    ctx = SimpleNamespace(trace=t)
    for name in DEVICE_METRICS:
        assert (_reader(name)(ctx) is not None) == readable, name


def test_no_marks_no_reading():
    t = devtrace.Trace([("gemm_kernel", 0.0, 1e-3)], [], 4, 2e-3)
    assert phases.split(t) is None and phases.breakdown(t) is None
    ctx = SimpleNamespace(trace=t)
    assert all(_reader(n)(ctx) is None for n in DEVICE_METRICS)


@pytest.mark.parametrize("order", [MKOR, LAMB])
def test_the_six_metrics_times_steps_make_the_window(order):
    t = _trace(12, order=order,
               lengths=(100, 200, 50, 30, 20)[:len(order) - 1], gap=70,
               window_extra=500)
    ctx = SimpleNamespace(trace=t)
    total = sum(_reader(n)(ctx) or 0.0 for n in DEVICE_METRICS)
    assert total * t.steps == pytest.approx(t.window_s * 1e3)


def test_breakdown_puts_each_kernel_in_the_phase_it_starts_in():
    kernels = [("nvjet_tst_256x128_TNT", "forward", 5, 50),
               ("nvjet_tst_256x128_NNT", "backward", 5, 150),
               ("void mkor::wg::wgmma_gemm_kernel<true>", "second_order", 5,
                20),
               ("block_smw_kernel", "second_order", 30, 10),
               ("direct_copy_kernel", "apply", 2, 10)]
    t = _trace(5, kernels=kernels)
    b = phases.breakdown(t)
    assert b["forward"]["kinds"] == {"gemm": pytest.approx(0.05)}
    assert b["backward"]["kinds"] == {"gemm": pytest.approx(0.15)}
    assert b["second_order"]["kinds"] == {"precond": pytest.approx(0.02),
                                          "smw": pytest.approx(0.01)}
    assert b["apply"]["kernels"] == pytest.approx(1.0)
    assert b["runner"]["kernels"] == 0
    # busy: the kernels and the 1 µs marks, clipped to each phase
    assert b["forward"]["busy_ms"] == pytest.approx(0.051)
    assert b["apply"]["busy_ms"] == pytest.approx(0.011)
    assert sum(r["wall_ms"] for r in b.values()) * t.steps == \
        pytest.approx(t.window_s * 1e3)


def test_program_counter_readers_need_the_counter(monkeypatch):
    import sys
    ctx = SimpleNamespace(trace=None)
    monkeypatch.setitem(sys.modules, "repro_torch.training.loop",
                        SimpleNamespace())
    assert _reader("capture_s")(ctx) is None
    assert _reader("graph_pool_gib")(ctx) is None
    counts = dict(graphs=10, warm_ups=10, capture_s=12.5,
                  pool_bytes=3 * 2 ** 30)
    monkeypatch.setitem(sys.modules, "repro_torch.training.loop",
                        SimpleNamespace(runner_counts=lambda: counts))
    assert _reader("capture_s")(ctx) == 12.5
    assert _reader("graph_pool_gib")(ctx) == 3.0
    counts["graphs"] = 0
    assert _reader("capture_s")(ctx) is None
