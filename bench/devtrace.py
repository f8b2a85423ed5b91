"""Reading a ``torch.profiler`` trace of the window: the device's
operations and the host's, the union of the device's busy intervals, the
kernels by kind, and the breakdown the result line carries.

Kernel kinds, by name: the program's own kernels (those its CUDA sources
define), the library GEMMs (cuBLAS and CUTLASS), and everything else on
the device (copies, sets and PyTorch's pointwise and reduction kernels).
"""
from __future__ import annotations

import functools
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# The program's own kernels, by the __global__ names of its CUDA sources:
# the precondition (fused_precond and the GEMMs of matmul under it), and
# the SMW updates.
OWN_PRECOND = re.compile(r"(?<![A-Za-z0-9_])(wgmma_gemm_kernel|gemm_kernel|"
                         r"sumsq_kernel|sum_parts_kernel|rescale_kernel)\b")
OWN_SMW = re.compile(r"(?<![A-Za-z0-9_])(block_smw_kernel|matvec_kernel|"
                     r"rank1_update_kernel)\b")
NAME_CHARS = 160                 # an operation's name in the breakdown
LIBRARY_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|sm90_|sm80_|"
                          r"gemv|dot_kernel|splitK", re.IGNORECASE)


@functools.lru_cache(maxsize=None)
def kind(name: str) -> str:
    """"precond", "smw", "gemm" (a library GEMM) or "other"."""
    if OWN_PRECOND.search(name):
        return "precond"
    if OWN_SMW.search(name):
        return "smw"
    if LIBRARY_GEMM.search(name):
        return "gemm"
    return "other"


@dataclass
class Trace:
    """The traced window: device and host events as (name, start_s,
    end_s), the steps it held, its host wall time and the launches the
    program credited to it."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    steps: int
    window_s: float
    credited: Dict[str, int] = field(default_factory=dict)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            out[kind(name)] += e - s
        return out

    def own_counts(self) -> Dict[str, int]:
        """Events of the program's own kernels, by kernel name."""
        out: Dict[str, int] = defaultdict(int)
        for name, _, _ in self.device:
            m = OWN_PRECOND.search(name) or OWN_SMW.search(name)
            if m:
                out[m.group(1)] += 1
        return dict(out)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            total[name] += e - s
        return [[k[:NAME_CHARS], v] for k, v in sorted(
            total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between busy intervals, each named by
        the innermost host operation running at its middle."""
        busy = self.busy_intervals()
        gaps = sorted(((e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])
                       if s1 > e0), key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda x: x[1])
        out = []
        for s, e in gaps:
            mid, best = (s + e) / 2, None
            for name, hs, he in host:
                if hs > mid:
                    break
                if he >= mid and (best is None or he - hs < best[1]):
                    best = (name, he - hs)
            out.append([best[0][:NAME_CHARS] if best else
                        "no host operation", e - s])
        return out


def collect(prof) -> Tuple[List, List]:
    """(device events, host events) of a finished ``torch.profiler``
    session, as (name, start_s, end_s), from its raw event list."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        try:
            start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        except AttributeError:
            start, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        (device if ev.device_type() == cuda else host).append(
            (ev.name(), start, start + dur))
    return device, host

