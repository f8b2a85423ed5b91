"""The train step's phases on the device's clock, from the program's phase
marks: empty kernels ``repro_mark_<phase>_kernel`` that the program
launches where each phase of the step begins (``forward``, ``backward``,
``second_order`` under MKOR, ``first_order``, ``apply``) and where the
step ends (``end``), captured into its CUDA graphs so that every replay
runs them.

A step counts when its marks are all in the trace, in that order (with or
without ``second_order``): traces drop events.  Each phase of such a step
runs from its mark's start to the next mark's; the window's time outside
the steps, the chunk runner's eager writes between replays and the idle
while the host binds, observes and fetches, is the runner's.  The
milliseconds a step are averages over the whole steps, and the runner's
is the window's time a step less the phases', so the phases and the
runner times the window's steps make the window.  Below 95 % whole steps,
or with no marks (a program without them), there is no reading.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import devtrace

PHASES = ("forward", "backward", "second_order", "first_order", "apply",
          "end")
MARK = re.compile(r"(?<![A-Za-z0-9_])repro_mark_(forward|backward|"
                  r"second_order|first_order|apply|end)_kernel\b")
MIN_WHOLE = 0.95
RUNNER = "runner"


def marks(trace) -> List[Tuple[str, float]]:
    """(phase, start_s) of every mark kernel in the trace, by start."""
    out = []
    for name, s, _ in trace.device:
        m = MARK.search(name)
        if m:
            out.append((m.group(1), s))
    return sorted(out, key=lambda x: x[1])


def whole_steps(trace) -> List[List[Tuple[str, float]]]:
    """The steps whose marks are all there, in order."""
    lamb = [p for p in PHASES if p != "second_order"]
    steps, cur = [], None
    for phase, t in marks(trace):
        if phase == "forward":
            cur = [(phase, t)]
        elif cur is not None:
            cur.append((phase, t))
            if phase == "end":
                if [p for p, _ in cur] in (list(PHASES), lamb):
                    steps.append(cur)
                cur = None
    return steps


def _readable(trace, steps) -> bool:
    return bool(steps) and trace.steps > 0 and trace.window_s > 0 and \
        len(steps) >= MIN_WHOLE * trace.steps


def split(trace) -> Optional[Dict[str, float]]:
    """Device milliseconds a step in each phase present, and ``runner``;
    None where the marks cannot be read (module docstring)."""
    steps = whole_steps(trace)
    if not _readable(trace, steps):
        return None
    out: Dict[str, float] = defaultdict(float)
    for step in steps:
        for (p, t0), (_, t1) in zip(step, step[1:]):
            out[p] += (t1 - t0) * 1e3 / len(steps)
    out[RUNNER] = trace.window_s * 1e3 / trace.steps - sum(out.values())
    return dict(out)


def phase_ms(trace, phase: str) -> Optional[float]:
    """One phase's milliseconds a step, or None."""
    return (split(trace) or {}).get(phase)


def breakdown(trace, top: Optional[int] = 5) -> Optional[Dict[str, Dict]]:
    """For each phase and the runner: ms a step (``wall_ms``, as
    :func:`split`), the device's busy ms a step inside it (``busy_ms``:
    the union of kernel intervals, clipped to the phase), kernels a step
    (``kernels``, the marks left out), kernel ms a step by
    ``devtrace.kind`` (``kinds``) and by name (``ops``, the ``top``
    largest, largest first; None: all).
    A kernel belongs to the phase in which it starts.  None where the
    marks cannot be read."""
    steps = whole_steps(trace)
    wall = split(trace)
    if wall is None:
        return None
    # the phases' intervals in time order; the gaps between them are the
    # runner's
    bounds, labels = [], []
    for step in steps:
        for (p, t0), (_, t1) in zip(step, step[1:]):
            bounds += [t0, t1]
            labels.append(p)

    def phase_at(t: float) -> str:
        i = bisect.bisect_right(bounds, t) - 1
        return labels[i // 2] if i >= 0 and i % 2 == 0 else RUNNER

    n, per = len(steps), trace.steps
    out = {p: {"wall_ms": ms, "busy_ms": 0.0, "kernels": 0.0,
               "kinds": defaultdict(float), "ops": defaultdict(float)}
           for p, ms in wall.items()}
    for name, s, e in trace.device:
        p = phase_at(s)
        if MARK.search(name) or p not in out:
            continue
        scale = 1.0 / (per if p == RUNNER else n)
        out[p]["kernels"] += scale
        out[p]["kinds"][devtrace.kind(name)] += (e - s) * 1e3 * scale
        out[p]["ops"][name[:devtrace.NAME_CHARS]] += (e - s) * 1e3 * scale
    for s, e in trace.busy_intervals():
        # split each busy interval at the phase boundaries it crosses
        lo = bisect.bisect_right(bounds, s)
        cuts = [s] + bounds[lo:bisect.bisect_left(bounds, e)] + [e]
        for a, b in zip(cuts, cuts[1:]):
            p = phase_at((a + b) / 2)
            if p in out:
                out[p]["busy_ms"] += (b - a) * 1e3 / (
                    per if p == RUNNER else n)
    for row in out.values():
        row["kinds"] = dict(row["kinds"])
        row["ops"] = dict(sorted(row["ops"].items(),
                                 key=lambda kv: -kv[1])[:top])
    return out
