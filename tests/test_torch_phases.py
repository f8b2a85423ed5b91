"""The train step's phase marks (``training/phases.py``), the chunk
runner's set-up counts and the launcher's ``--trace-out``, on the CPU:
eager steps of a tiny model under the CPU profiler show the phase ranges
in step order, the marks change no bit of a step, and the phase split
adds up to its window."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import firstorder, mkor
from repro_torch.core.eva import EvaConfig, eva
from repro_torch.data import pipeline
from repro_torch.launch import train as launcher
from repro_torch.models import config as config_lib
from repro_torch.models import model as model_lib
from repro_torch.training import loop, phases
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
CFG = config_lib.ModelConfig(name="t", arch_type="dense", n_layers=2,
                             d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                             vocab_size=64, dtype="float32",
                             scan_layers=False, remat=False,
                             vocab_pad_multiple=1)
SECOND = ["forward", "backward", "second_order", "first_order", "apply"]
FIRST = ["forward", "backward", "first_order", "apply"]
OPTIMIZERS = {
    "lamb": (lambda: firstorder.lamb(1e-3), FIRST),
    "sgd": (lambda: firstorder.sgd(1e-2, momentum=0.9), FIRST),
    "mkor": (lambda: mkor.mkor(firstorder.lamb(1e-3),
                               mkor.MKORConfig(inv_freq=2)), SECOND),
    "mkor-staleness1": (lambda: mkor.mkor(
        firstorder.lamb(1e-3), mkor.MKORConfig(inv_freq=2, staleness=1)),
        SECOND),
    "eva": (lambda: eva(firstorder.lamb(1e-3), EvaConfig()), SECOND),
}


def _setup(name, steps=2):
    opt = OPTIMIZERS[name][0]()
    params = model_lib.init_params(CFG, seed=0, device=CPU)
    ds = pipeline.make_dataset(CFG, global_batch=2, seq_len=8, seed=0)
    return (loop.make_train_step(CFG, opt), params, opt.init(params),
            [pipeline.make_batch(ds, i) for i in range(steps)])


def _phase_ranges(prof):
    """(phase, start_ns, end_ns) of the phase ranges, by start."""
    out = [(ev.name()[len(phases.RANGE):], ev.start_ns(),
            ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith(phases.RANGE)]
    return sorted(out, key=lambda r: r[1])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_step_shows_the_phase_ranges_in_step_order(name):
    """One eager step under the CPU profiler: the ranges of the table's
    phases, in order, one after another; ``second_order`` only where the
    optimizer runs a backend itself (MKOR, Eva)."""
    step, params, state, batches = _setup(name, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, loop.batch_to_device(batches[0], CPU))
    ranges = _phase_ranges(prof)
    assert [r[0] for r in ranges] == OPTIMIZERS[name][1]
    for (_, _, end), (_, start, _) in zip(ranges, ranges[1:]):
        assert end <= start
    assert phases._open is None


def test_marks_outside_a_profiler_open_no_range():
    step, params, state, batches = _setup("mkor", 1)
    step(params, state, loop.batch_to_device(batches[0], CPU))
    assert phases._open is None


def test_runner_counts_stay_zero_on_the_cpu():
    """The CPU chunk runner runs eager steps: no warm-up, no capture."""
    loop.reset_runner_counts()
    step, params, state, batches = _setup("mkor", 5)
    loop.train_epoch(step, params, state, batches, chunk=2)
    assert loop.runner_counts() == dict(graphs=0, warm_ups=0, capture_s=0.0,
                                        pool_bytes=0)
    assert loop.runner_counts(by_key=True) == {}


def _bits(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


@pytest.mark.parametrize("name", ["lamb", "mkor"])
def test_marks_off_leaves_the_step_bit_identical(name, monkeypatch):
    """Three steps with the marks on, under the profiler (ranges open and
    close), and with them off: the same params, state and metrics."""
    step, params, state, batches = _setup(name, 3)

    def run():
        p, s, rows = params, state, []
        for b in batches:
            p, s, m = step(p, s, loop.batch_to_device(b, CPU))
            rows.append(m)
        return _bits((p, s, rows))

    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    monkeypatch.setattr(phases, "ENABLED", False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = run()
    assert _phase_ranges(prof) == []
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("value,enabled", [("0", False), ("1", True),
                                           (None, True)])
def test_the_switch_is_read_at_import(value, enabled):
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_PHASE_MARKS"}
    if value is not None:
        env["REPRO_TORCH_PHASE_MARKS"] = value
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.training import phases; "
         "print(phases.ENABLED)"], env=env, capture_output=True, text=True,
        timeout=120, check=True)
    assert out.stdout.strip() == str(enabled)


def test_runner_step_marks_the_end_after_the_write_back():
    """Inside ``runner_step`` the step's own ``end`` is held: the
    ``apply`` range runs on over what the runner writes after the step,
    and ends where ``runner_step`` ends; a step that raises leaves no open
    range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phases.runner_step(CPU):
            phases.mark("forward", CPU)
            phases.mark("apply", CPU)
            phases.mark("end", CPU)           # held
            with torch.profiler.record_function("write_back"):
                torch.ones(4).add_(1)
        with pytest.raises(ValueError):
            with phases.runner_step(CPU):
                phases.mark("forward", CPU)
                raise ValueError("a failed capture")
    assert phases._open is None and phases._held == 0
    events = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name() in ("write_back", phases.RANGE + "apply")}
    apply, write = events[phases.RANGE + "apply"], events["write_back"]
    assert apply[0] <= write[0] and write[1] <= apply[1]


def _marks(order, t0, lengths):
    out, t = [], t0
    for p, dt in zip(order, list(lengths) + [0]):
        out.append((p, t))
        t += dt
    return out, t


def test_split_of_marks_sums_to_the_window():
    marks, t = [], 0.0
    for _ in range(20):
        m, t = _marks(SECOND + ["end"], t, (1e-3, 2e-3, 5e-4, 3e-4, 2e-4))
        marks += m
        t += 4e-4
    got = phases.split(marks, t + 1e-3, 20)
    assert got["forward"] == pytest.approx(1.0)
    assert got["second_order"] == pytest.approx(0.5)
    assert sum(got.values()) == pytest.approx((t + 1e-3) * 1e3 / 20)
    # a step without its backward mark is left out: 19 of 20 still read
    assert phases.split([m for m in marks if m != marks[1]], t, 20)
    # 18 of 20 whole steps (90 %) do not
    assert phases.split([m for i, m in enumerate(marks) if i not in (1, 7)],
                        t, 20) is None


def test_split_of_first_order_steps_has_no_second_order():
    marks, t = [], 0.0
    for _ in range(4):
        m, t = _marks(FIRST + ["end"], t, (1e-3, 2e-3, 3e-4, 2e-4))
        marks += m
    got = phases.split(marks, t, 4)
    assert "second_order" not in got
    assert got["backward"] == pytest.approx(2.0)


def test_launcher_trace_out_writes_the_trace_and_prints_the_phases(
        tmp_path, capsys):
    """``--trace-out`` on the CPU: the last chunk's Chrome trace holds the
    phase ranges, and the printed split names every phase of the MKOR
    step and the runner."""
    path = tmp_path / "trace.json"
    launcher.main(["--arch", "bert-large", "--reduced", "--steps", "4",
                   "--global-batch", "2", "--seq-len", "16", "--inv-freq",
                   "2", "--chunk", "2", "--device", "cpu", "--trace-out",
                   str(path)])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("trace:"))
    for p in SECOND + ["runner"]:
        assert f" {p} " in line
    # the ranges are host operations: a user annotation would be mirrored
    # onto the device's timeline and read as device work
    cats = {(e["name"], e.get("cat")) for e in
            json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("repro_torch.")}
    assert {n for n, _ in cats} >= {phases.RANGE + p for p in SECOND}
    assert {c for _, c in cats} == {"cpu_op"}
    assert "runner:" not in out       # nothing captured on the CPU
    assert np.isfinite(float(out.split("done: final loss")[1]))
