"""Phase marks of the train step: where forward, backward, the second- and
first-order optimizer work and the parameter update begin, on the
device's clock and on the host's.

:func:`mark` is called where a phase begins, in step order (``PHASES``):

* ``forward``: the top of the step, before MKOR's staleness-1 tick (when
  there is one) and the loss;
* ``backward``: before ``torch.autograd.grad`` (``loop.value_and_grad``);
* ``second_order``: the top of the update of an optimizer that runs a
  first-order backend itself (MKOR, Eva): its factor updates,
  preconditioning and glue; absent under a first-order optimizer;
* ``first_order``: before the backend's update (LAMB), or before the
  optimizer's update when the optimizer is first order;
* ``apply``: before ``apply_updates``; the phase holds the step's global
  norms and, in the chunk runner, its write-back into the static buffers
  and the metrics row;
* ``end``: the end of the step, which opens no phase.  The chunk runner
  holds the step's own ``end`` back and marks it after its write-back
  (:func:`runner_step`).

On a CUDA device a mark launches that phase's empty kernel
(``csrc/marks.cu``, ``repro_mark_<phase>_kernel``) on the current
stream, so a CUDA graph capture takes it in and every replay runs it:
on the trace each phase runs from its mark's start to the next mark's.
The launches are not counted by ``kernels/build.py``.  While a profiler
runs, a mark also opens a host range ``repro_torch.phase.<phase>``
(closed by the next mark), so eager steps, on the CPU too, show their
phases.  The ranges (and :func:`span`'s) are recorded as operations, not
as user annotations: the profiler mirrors a user annotation onto the
device's timeline as an event spanning the kernels launched inside it,
which a reader of the device's events would count as device work.  :func:`split` turns the marks of a trace into milliseconds a
phase (the launcher's ``--trace-out``; the benchmark reads the same rule
in ``bench/phases.py``).

``REPRO_TORCH_PHASE_MARKS=0``, read once at import, turns the marks off
(no launch, no range): the way to measure what they cost.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PHASES = ("forward", "backward", "second_order", "first_order", "apply",
          "end")
ENABLED = os.environ.get("REPRO_TORCH_PHASE_MARKS", "1") != "0"
KERNEL = "repro_mark_{}_kernel"
RANGE = "repro_torch.phase."

_open = None    # the phase range open now
_held = 0       # > 0: the caller marks the step's end (runner_step)


def span(name: str):
    """A profiler range ``name`` while a profiler runs (a host operation,
    module docstring); nothing (a null context) otherwise."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return contextlib.nullcontext()


def _close() -> None:
    global _open
    if _open is not None:
        _open.__exit__(None, None, None)
        _open = None


def mark(phase: str, device: torch.device) -> None:
    """Phase ``phase`` of the step begins here, on ``device`` (module
    docstring)."""
    global _open
    if not ENABLED or (phase == "end" and _held):
        return
    _close()
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.check(build.library("marks").repro_mark(
            PHASES.index(phase), build.stream_handle(device)),
            KERNEL.format(phase))
    if phase != "end" and torch.autograd._profiler_enabled():
        _open = torch._C._profiler._RecordFunctionFast(RANGE + phase)
        _open.__enter__()


@contextlib.contextmanager
def runner_step(device: torch.device):
    """Around the chunk runner's step and its write-back: the step's own
    ``end`` is held back, and marked on leaving, after the write-back.  A
    step that raises leaves no mark and no open range."""
    global _held
    _held += 1
    try:
        yield
    except BaseException:
        _held -= 1
        _close()
        raise
    _held -= 1
    mark("end", device)


# --------------------------------------------------------------------- #
# Reading the marks of a trace
# --------------------------------------------------------------------- #
def steps_of(marks: Iterable[Tuple[str, float]]
             ) -> List[List[Tuple[str, float]]]:
    """The whole steps among ``marks`` ((phase, start) pairs, any order):
    each a run ``forward`` … ``end`` in the order of ``PHASES``, with or
    without ``second_order``.  A step that misses a mark (a trace can drop
    events) or holds one out of order is left out."""
    steps, cur = [], None
    for phase, t in sorted(marks, key=lambda m: m[1]):
        if phase == "forward":
            cur = [(phase, t)]
        elif cur is not None:
            cur.append((phase, t))
            if phase == "end":
                got = [p for p, _ in cur]
                if got in (list(PHASES), [p for p in PHASES
                                          if p != "second_order"]):
                    steps.append(cur)
                cur = None
    return steps


def split(marks: Iterable[Tuple[str, float]], window_s: float,
          n_steps: int) -> Optional[Dict[str, float]]:
    """Milliseconds a step in each phase, and ``runner`` for the rest of
    the window: each phase of a whole step runs from its mark to the next
    (:func:`steps_of`), averaged over the whole steps; ``runner`` is the
    window's time a step less the phases', so the phases and ``runner``
    times ``n_steps`` make the window.  None when under 95 % of the
    ``n_steps`` steps are whole."""
    steps = steps_of(marks)
    if not steps or len(steps) < 0.95 * n_steps:
        return None
    out = {p: 0.0 for p in PHASES[:-1]}
    for step in steps:
        for (p, t0), (_, t1) in zip(step, step[1:]):
            out[p] += (t1 - t0) * 1e3 / len(steps)
    if not any(p == "second_order" for s in steps for p, _ in s):
        del out["second_order"]
    out["runner"] = window_s * 1e3 / n_steps - sum(out.values())
    return out


def marks_of(prof) -> List[Tuple[str, float]]:
    """(phase, start seconds) of each mark in a finished ``torch.profiler``
    session: the mark kernels where the trace has any, else the host
    ranges (each range's start, and the ``apply`` range's end as the
    step's ``end``)."""
    kernels, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        try:
            start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        except AttributeError:
            start, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        for p in PHASES:
            if ev.name() == KERNEL.format(p):
                kernels.append((p, start))
            elif ev.name() == RANGE + p:
                ranges.append((p, start))
                if p == "apply":
                    ranges.append(("end", start + dur))
    return kernels or ranges
