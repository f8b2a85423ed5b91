#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build of every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
     source, in parallel, timed);
  3. each of the six kernels, and the int8 variants of three of them
     (fused_smw[int8], fused_block_smw[int8], fused_precond[int8]: codes
     of an int8 bank with per-slice scales), against its plain PyTorch
     version on the card, at the shapes full-width bert-large gives it and
     at ragged shapes: max abs error and tolerance, kernel / plain /
     library ms, and the least time the card could take (bytes over 3.35
     TB/s, or operations over the peak of their type -- 989 TFLOP/s for
     the bf16 tensor cores, 67 TFLOP/s for fp32 -- whichever is larger);
     matmul and fused_precond on both GEMM cores (the Hopper core of
     wgmma_gemm.cuh where the route sends them, the WMMA core of gemm.cuh
     forced), each launch's core read from the per-core counts, with
     TFLOP/s and the share of the bf16 peak;
  4. full-width bert-large (24 layers, random weights from seed 0, batch 8
     x 128) trained with mkor(lamb) through the kernels on three paths,
     each with the launch counts set to 0 just before it and read just
     after:
     a. rank 1, staleness 0 (inv_freq 3): step 0 against the plain route
        from the same state (banks, update, loss after the step), then 6
        steps with losses, step time, peak memory, launches and fallbacks,
        a profiler breakdown and phase times of one more step;
     b. block rank 4 (inv_freq 4, stagger), 8 steps: every bucket consumes
        a partial and a full window; at each bucket's first full window
        the banks after the kernel update against the plain route from
        the same state; profiler breakdown and phase times of a step;
     c. staleness 1 at rank 1 (inv_freq 3), 9 steps: precompute runs
        before each forward pass, every tick's launched banks against the
        plain route from the same state, and every bucket's promoted
        active bank leaves the identity; profiler breakdown and phase
        times of a step;
     d.-f. the same three schedules with int8 factor state
        (factor_quant="int8": int8 codes, per-slice scales and fp32 error
        feedback) through the int8 kernels -- rank 1 (inv_freq 3, 6
        steps), rank 4 (inv_freq 4, 8 steps) and staleness 1 (inv_freq 3,
        9 steps) -- each bucket's first inversion (first launching tick
        with a non-empty window) held against the plain route from the
        same state on the reconstructed fp32 bank decode(codes) + error
        feedback, with codes at most one step apart; the kernel route
        decodes no bank (only window rows);
     each profiled step also lists the host's waits on the device; on
     paths a-c every GEMM of matmul and fused_precond must run on the
     Hopper core (per-core counts), on d-f the counts are printed;
  5. one JSON line listing every kernel, the card's name and power limit,
     and, last, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a result when there is no CUDA device or when the port's
sources are not beside it.
"""
from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
PEAK_FP32_OPS_PER_S = 67e12       # H100 SXM fp32, outside the tensor cores
REPLACES = {
    "fused_smw": "src/repro/kernels/rank1_smw.py:355",
    "fused_precond": "src/repro/kernels/precond.py:108",
    "matmul": "src/repro/kernels/matmul.py:35",
    "fused_block_smw": "src/repro/kernels/rank1_smw.py:294",
    "matvec": "src/repro/kernels/rank1_smw.py:57",
    "rank1_update": "src/repro/kernels/rank1_smw.py:87",
    # the quant bodies of the same three Pallas kernels
    "fused_smw[int8]": "src/repro/kernels/rank1_smw.py:139",
    "fused_block_smw[int8]": "src/repro/kernels/rank1_smw.py:214",
    "fused_precond[int8]": "src/repro/kernels/precond.py:57",
}
SOURCES = {
    "fused_smw": "src/repro_torch/csrc/rank1_smw.cu",
    "fused_precond": "src/repro_torch/csrc/precond.cu",
    "matmul": "src/repro_torch/csrc/matmul.cu",
    "fused_block_smw": "src/repro_torch/csrc/block_smw.cu",
    "matvec": "src/repro_torch/csrc/rank1_smw.cu",
    "rank1_update": "src/repro_torch/csrc/rank1_smw.cu",
    "fused_smw[int8]": "src/repro_torch/csrc/rank1_smw.cu",
    "fused_block_smw[int8]": "src/repro_torch/csrc/block_smw.cu",
    "fused_precond[int8]": "src/repro_torch/csrc/precond.cu",
}
# the peak rate of each kernel's operations: tensor-core GEMMs in bf16
# (int8 codes enter them as bf16), the SMW kernels' fp32 FMAs on the CUDA
# cores
PEAK_OPS = {"fused_smw": PEAK_FP32_OPS_PER_S,
            "fused_precond": PEAK_BF16_OPS_PER_S,
            "matmul": PEAK_BF16_OPS_PER_S,
            "fused_block_smw": PEAK_FP32_OPS_PER_S,
            "matvec": PEAK_FP32_OPS_PER_S,
            "rank1_update": PEAK_FP32_OPS_PER_S,
            "fused_smw[int8]": PEAK_FP32_OPS_PER_S,
            "fused_block_smw[int8]": PEAK_FP32_OPS_PER_S,
            "fused_precond[int8]": PEAK_BF16_OPS_PER_S}
# the kernels each training path must launch (and must not)
_NOT_INT8 = ("fused_smw", "fused_block_smw", "fused_precond")
PATH_KERNELS = {
    "rank1": (("fused_smw", "fused_precond", "matmul"), ("fused_block_smw",)),
    "rank4": (("fused_block_smw", "fused_precond", "matmul"), ("fused_smw",)),
    "staleness1": (("fused_block_smw", "fused_precond", "matmul"),
                   ("fused_smw",)),
    "int8_rank1": (("fused_smw[int8]", "fused_precond[int8]", "matmul"),
                   _NOT_INT8 + ("fused_block_smw[int8]",)),
    "int8_rank4": (("fused_block_smw[int8]", "fused_precond[int8]",
                    "matmul"), _NOT_INT8 + ("fused_smw[int8]",)),
    "int8_staleness1": (("fused_block_smw[int8]", "fused_precond[int8]",
                         "matmul"), _NOT_INT8 + ("fused_smw[int8]",)),
}
# the paths whose GEMMs all run on the Hopper core (bf16 factors); the int8
# paths' GEMMs take int8 codes and stay on the WMMA core
WGMMA_PATHS = ("rank1", "rank4", "staleness1")
TRAIN_STEPS = 6                   # rank 1: two full inv_freq=3 windows
RANK4_STEPS = 8                   # rank 4, inv_freq 4: two windows a bucket
STALE_STEPS = 9                   # staleness 1, inv_freq 3: three ticks


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelRow:
    """Accumulates one kernel's numbers over the shapes it is checked at:
    times and bounds summed over the bert-large main-path shapes (one
    call each), the error maxed over every shape."""

    def __init__(self, name: str):
        self.name, self.err = name, 0.0
        self.ms = self.plain_ms = self.bytes = self.ops = 0.0
        self.library_ms = None
        # further timings at the same shapes, printed beside the row
        self.other_ms = collections.defaultdict(float)

    def add(self, err, ms=None, plain_ms=None, n_bytes=0.0, n_ops=0.0,
            library_ms=None):
        self.err = max(self.err, err)
        if ms is not None:
            self.ms += ms
            self.plain_ms += plain_ms
            self.bytes += n_bytes
            self.ops += n_ops
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms

    def bound(self, n_bytes, n_ops):
        return bound_ms(n_bytes, n_ops, PEAK_OPS[self.name])

    def as_json(self, launches: int):
        b_ms, b_by = self.bound(self.bytes, self.ops)
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name], "replaces": REPLACES[self.name],
                "launches": launches, "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": self.library_ms}


def bf16_close(got, want, rel=2.0 ** -7, floor=1e-5):
    """(max abs error, worst ratio to the elementwise tolerance
    rel·|want| + floor·max|want|).

    For bf16 outputs (the defaults): kernel and plain version round the
    same fp32 value to bf16, but their fp32 sums run in another order, so
    an element may land on the neighbouring bf16 value: one ulp, at most
    2^-7 of the element itself.  The floor 1e-5·max|want| covers elements
    near zero, whose fp32 rounding differences are ~1e-7 of the largest
    entry.  Being elementwise, the bound sees the rank-1 (rank-r) term of
    an SMW update even where it is small beside the diagonal.  fp32
    outputs pass a tighter (rel, floor)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = rel * want.abs() + floor * want.abs().max()
    return diff.max().item(), (diff / tol).max().item()


def near_identity(torch, b, d, gen, dtype):
    """A bank of well-conditioned symmetric factors, like MKOR's inverses."""
    x = torch.randn((b, d, d), generator=gen, device="cuda") * (0.5 / d)
    return (torch.eye(d, device="cuda") + x + x.transpose(1, 2)).to(dtype)


# ----------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# ----------------------------------------------------------------------- #
def check_fused_smw(torch, rows):
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_smw"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, d, main in [(96, 1024, True), (24, 1024, True), (24, 4096, True),
                       (3, 1001, False)]:
        j = near_identity(torch, b, d, gen, torch.bfloat16)
        # v ~ N(0, 1): s = vᵀJv ≈ d and the rank-1 term coef·uuᵀ is ~1/d
        # an element, beside off-diagonal entries of J of ~0.7/d, so a
        # kernel that drops or misweights it fails the elementwise bound
        v = torch.randn((b, d), generator=gen, device="cuda")
        for variant in ("paper", "exact_smw"):
            got = rk.fused_smw(j, v, gamma=0.9, variant=variant)
            want = rk.fused_smw_plain(j, v, gamma=0.9, variant=variant)
            torch.cuda.synchronize()
            err, ratio = bf16_close(got, want)
            print(f"fused_smw {b}x{d}x{d} {variant}: max_abs_err {err:.3e}, "
                  f"worst |got-want| / (2^-7|want| + 1e-5 max|want|) "
                  f"{ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"fused_smw {b}x{d} {variant} disagrees with its plain "
                    "version")
            row.add(err)
        if main:
            ms = time_ms(torch, lambda: rk.fused_smw(j, v, gamma=0.9))
            plain = time_ms(torch, lambda: rk.fused_smw_plain(j, v,
                                                              gamma=0.9))
            n_bytes = b * (2 * d * d * 2 + d * 4)
            n_ops = b * 4.0 * d * d
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_smw {b}x{d}x{d}: {ms:.4f} ms, plain {plain:.4f} ms,"
                  f" bound {bms:.4f} ms ({by})")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del j, v


def rate(n_ops, ms):
    """TFLOP/s and the share of the bf16 tensor-core peak."""
    tf = n_ops / ms / 1e9
    return f"{tf:.1f} TFLOP/s ({100 * tf * 1e12 / PEAK_BF16_OPS_PER_S:.1f} % of peak)"


def expect_cores(torch, fn, want_counts, want_cores, tag):
    """Run ``fn`` with the counts at 0 and require its kernel launches and
    the GEMM cores they ran on."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts, cores = ops.launch_counts(), ops.gemm_core_counts()
    require(counts == want_counts and cores == want_cores,
            f"{tag}: launches {counts}, GEMM cores {cores}; expected "
            f"{want_counts}, {want_cores}")
    return out


def check_fused_precond(torch, rows):
    """fused_precond on the core its route picks -- the Hopper core (TMA +
    wgmma, T as a bf16 hi/lo pair) at the bert-large shapes and at ragged
    shapes TMA takes, the WMMA core at (3, 1001, 600) -- and, at the
    bert-large shapes, on the WMMA core forced, each against the plain
    version, rescale on and off.  Timed at the bert-large shapes: both
    cores, the plain version, and a yardstick of two torch.bmm plus the
    norms (T rounded to bf16 between them: a cheaper function, not
    library_ms)."""
    from repro_torch.kernels import precond as pc
    row = rows["fused_precond"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, di, do, main in [(96, 1024, 1024, True), (24, 1024, 4096, True),
                            (24, 4096, 1024, True), (2, 1000, 712, False),
                            (2, 712, 1000, False), (3, 64, 136, False),
                            (3, 1001, 600, False)]:
        r = near_identity(torch, b, di, gen, torch.bfloat16)
        l = near_identity(torch, b, do, gen, torch.bfloat16)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        route = pc.precond_route(r.dtype, g.dtype, l.dtype, di, do,
                                 r.data_ptr(), g.data_ptr(), l.data_ptr())
        require(route == ("wmma" if di % 8 or do % 8 else "wgmma"),
                f"fused_precond {b}x{di}x{do}: route {route}")
        for core in (None, "wmma") if main else (None,):
            for rescale in (True, False):
                got = expect_cores(
                    torch, lambda: pc.fused_precond(r, g, l, rescale=rescale,
                                                    core=core),
                    {"fused_precond": 1, "matmul": 1}, {core or route: 2},
                    f"fused_precond {b}x{di}x{do}")
                want = pc.fused_precond_plain(r, g, l, rescale=rescale)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                # the float32 intermediate rides the tensor cores as a
                # bf16 hi/lo pair (16 significant bits) and sums run in
                # another order: 2e-4 of the largest entry
                tol = 2e-4 * want.abs().max().item()
                print(f"fused_precond {b}x{di}x{do} rescale={rescale} "
                      f"[{core or route}]: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e})")
                require(math.isfinite(err) and err <= tol,
                        f"fused_precond {b}x{di}x{do} [{core or route}] "
                        "disagrees with its plain version")
                row.add(err)
                del got, want
        if main:
            ms = time_ms(torch, lambda: pc.fused_precond(r, g, l))
            old = time_ms(torch, lambda: pc.fused_precond(r, g, l,
                                                          core="wmma"))
            plain = time_ms(torch, lambda: pc.fused_precond_plain(r, g, l))

            def yardstick():
                if do >= di:
                    d = torch.bmm(r, torch.bmm(g, l), out_dtype=torch.float32)
                else:
                    d = torch.bmm(torch.bmm(r, g), l, out_dtype=torch.float32)
                gn = torch.linalg.vector_norm(g, dim=(1, 2), dtype=torch.float32)
                dn = torch.linalg.vector_norm(d, dim=(1, 2))
                return d * (gn / dn.clamp(min=1e-30))[:, None, None]
            yard = time_ms(torch, yardstick)
            n_bytes = b * ((di * di + do * do + di * do) * 2 + di * do * 4)
            n_ops = b * 2.0 * di * do * (di + do)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_precond {b}x{di}x{do}: wgmma core {ms:.4f} ms "
                  f"{rate(n_ops, ms)}; wmma core {old:.4f} ms "
                  f"{rate(n_ops, old)}; plain {plain:.4f} ms; yardstick "
                  f"(two bf16 torch.bmm + norms, T rounded to bf16) "
                  f"{yard:.4f} ms; bound {bms:.4f} ms ({by})")
            require(ms < old, f"fused_precond {b}x{di}x{do}: the wgmma core "
                    f"({ms:.4f} ms) is not faster than the wmma core "
                    f"({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops)
            row.other_ms["wmma core"] += old
            row.other_ms["two torch.bmm + norms"] += yard
        del r, l, g


def library_matmul(torch, a, w):
    """The one PyTorch call that computes matmul's function: bf16 inputs,
    fp32 output (``torch.bmm(..., out_dtype=float32)`` where this torch
    has it; else the bf16-output ``torch.bmm``, and the name says so)."""
    try:
        torch.bmm(a[:1, :16, :16], w[:1, :16, :16], out_dtype=torch.float32)
        return (lambda: torch.bmm(a, w, out_dtype=torch.float32),
                "torch.bmm(out_dtype=float32)")
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.bmm(a, w), "torch.bmm (bf16 out)")


def check_matmul(torch, rows):
    """matmul on the core its route picks (the Hopper core for bf16 rows of
    16-byte multiples, the WMMA core for 1001 x 600 x 701) and, at the
    bert-large shapes, on the WMMA core forced; the Hopper core's hi/lo
    pair epilogue (fused_precond's first product) wherever it runs.  Timed
    at the bert-large shapes: both cores, the plain version, torch.bmm."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.ref import split_hi_lo
    row = rows["matmul"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    # the first products fused_precond hands to matmul at bert-large:
    # G L⁻¹ for the 1024x1024 and 1024x4096 buckets, R⁻¹ G for 4096x1024;
    # then ragged shapes, one batch that wraps the persistent grid
    for b, m, k, n, main in [(96, 1024, 1024, 1024, True),
                             (24, 1024, 4096, 4096, True),
                             (24, 4096, 4096, 1024, True),
                             (2, 1000, 600, 712, False),
                             (3, 64, 96, 136, False),
                             (300, 128, 128, 128, False),
                             (3, 1001, 600, 701, False)]:
        a = (torch.randn((b, m, k), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        w = (torch.randn((b, k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        route = mm.route_of(a, w)
        require(route == ("wmma" if k % 8 or n % 8 else "wgmma"),
                f"matmul {b}x{m}x{k}x{n}: route {route}")
        want = mm.matmul_plain(a, w)
        # bf16 products are exact in fp32: only the summation order differs
        tol = 1e-5 * want.abs().max().item() * math.sqrt(k)
        for core in (None, "wmma") if main else (None,):
            got = expect_cores(torch, lambda: mm.matmul(a, w, core=core),
                               {"matmul": 1}, {core or route: 1},
                               f"matmul {b}x{m}x{k}x{n}")
            err = (got - want).abs().max().item()
            print(f"matmul {b}x{m}x{k}x{n} [{core or route}]: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e})")
            require(math.isfinite(err) and err <= tol,
                    f"matmul {b}x{m}x{k}x{n} [{core or route}] disagrees "
                    "with its plain version")
            row.add(err)
            del got
        if route == "wgmma":
            hi, lo = expect_cores(torch, lambda: mm.matmul_split(a, w),
                                  {"matmul": 1}, {"wgmma": 1},
                                  f"matmul hi/lo {b}x{m}x{k}x{n}")
            err = (hi.float() + lo.float() - want).abs().max().item()
            # hi is the bf16 rounding of the product: one bf16 ulp from
            # split_hi_lo of the plain product at most, where the two fp32
            # sums straddle a rounding boundary
            ulp, _ = bf16_close(hi, split_hi_lo(want)[0])
            bad = ((hi.float() - split_hi_lo(want)[0].float()).abs()
                   > 2.0 ** -7 * want.abs() + tol).sum().item()
            print(f"matmul hi/lo {b}x{m}x{k}x{n}: |hi + lo - want| max "
                  f"{err:.3e} (tol {tol:.3e}); hi vs bf16(want) max "
                  f"{ulp:.3e}, {bad} beyond one ulp (tol 0)")
            require(math.isfinite(err) and err <= tol and bad == 0,
                    f"matmul hi/lo {b}x{m}x{k}x{n} disagrees with "
                    "split_hi_lo of the plain product")
            row.add(err)
            del hi, lo
        if main:
            ms = time_ms(torch, lambda: mm.matmul(a, w))
            old = time_ms(torch, lambda: mm.matmul(a, w, core="wmma"))
            plain = time_ms(torch, lambda: mm.matmul_plain(a, w))
            lib_fn, lib_name = library_matmul(torch, a, w)
            lib = time_ms(torch, lib_fn)
            n_bytes = b * ((m * k + k * n) * 2 + m * n * 4)
            n_ops = b * 2.0 * m * k * n
            bms, by = row.bound(n_bytes, n_ops)
            print(f"matmul {b}x{m}x{k}x{n}: wgmma core {ms:.4f} ms "
                  f"{rate(n_ops, ms)}; wmma core {old:.4f} ms "
                  f"{rate(n_ops, old)}; plain {plain:.4f} ms; {lib_name} "
                  f"{lib:.4f} ms {rate(n_ops, lib)}; bound {bms:.4f} ms "
                  f"({by})")
            require(ms < old, f"matmul {b}x{m}x{k}x{n}: the wgmma core "
                    f"({ms:.4f} ms) is not faster than the wmma core "
                    f"({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops, library_ms=lib)
            row.other_ms["wmma core"] += old
        del a, w, want


def check_fused_block_smw(torch, rows):
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_block_smw"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    # (bank, d, r, dtype, window fills, with_pivot, main-path shape): the
    # three bert-large bank sides at rank 4 with full windows, one of them
    # with the pivot, one with windows filled to 0, 1 and r; then a ragged
    # shape in both dtypes with mixed fills
    cases = [(96, 1024, 4, torch.bfloat16, "full", False, True),
             (24, 1024, 4, torch.bfloat16, "full", True, True),
             (24, 4096, 4, torch.bfloat16, "full", False, True),
             (24, 1024, 4, torch.bfloat16, "mixed", False, False),
             (3, 1001, 3, torch.float32, "mixed", True, False),
             (3, 1001, 3, torch.bfloat16, "mixed", False, False)]
    for b, d, r, dtype, fill, pivot, main in cases:
        j = near_identity(torch, b, d, gen, dtype)
        # v ~ N(0, 1): the rank-r term U M Uᵀ is ~r/d an element, beside
        # off-diagonal entries of J of ~0.7/d, so a kernel that drops or
        # misweights it fails the elementwise bound
        v = torch.randn((b, r, d), generator=gen, device="cuda")
        n = torch.full((b,), r, device="cuda") if fill == "full" else \
            torch.tensor([(0, 1, r)[i % 3] for i in range(b)], device="cuda")
        sq, gm = block_weights(n, r, 0.9)
        vt = (v * sq[..., None]).contiguous()
        # fp32 out: the same fp32 values, summed in another order and
        # solved by Gauss-Jordan in place of LU: 1e-5 relative, floor
        # 1e-6 of the largest entry
        rel, floor = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else \
            (1e-5, 1e-6)
        for variant in ("paper", "exact_smw"):
            res = rk.fused_block_smw(j, vt, gm, variant=variant,
                                     with_pivot=pivot)
            want = rk.fused_block_smw_plain(j, vt, gm, variant=variant,
                                            with_pivot=pivot)
            torch.cuda.synchronize()
            got = res[0] if pivot else res
            err, ratio = bf16_close(got, want[0] if pivot else want, rel,
                                    floor)
            tag = (f"fused_block_smw {b}x{d}x{d} r={r} {str(dtype)[6:]} "
                   f"fill={fill} {variant}")
            print(f"{tag}: max_abs_err {err:.3e}, worst |got-want| / "
                  f"({rel:.3g}|want| + {floor:g} max|want|) {ratio:.3f} "
                  "(tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} disagrees with its plain version")
            if fill == "mixed":
                empty = n == 0
                require(bool(torch.equal(got[empty], j[empty])),
                        f"{tag}: an empty window changed its slice")
            if pivot:
                # Gauss-Jordan pivots against the plain version's squared
                # Cholesky diagonal: the same fp32 numbers, 1e-3 relative
                p_err = ((res[1] - want[1]).abs()
                         / want[1].abs()).max().item()
                print(f"{tag}: pivot min {res[1].min().item():.6g} vs "
                      f"{want[1].min().item():.6g}, max rel err "
                      f"{p_err:.3e} (tol 1e-3)")
                require(p_err <= 1e-3, f"{tag}: pivot disagrees")
            row.add(err)
        if main:
            ms = time_ms(torch, lambda: rk.fused_block_smw(j, vt, gm))
            plain = time_ms(torch, lambda: rk.fused_block_smw_plain(j, vt,
                                                                    gm))
            n_bytes = b * (2 * d * d * j.element_size() + r * d * 4 + 4)
            n_ops = b * ((4.0 * r + 1) * d * d + 4.0 * r * r * d)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_block_smw {b}x{d}x{d} r={r}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del j, v, vt


def check_matvec_and_rank1_update(torch, rows):
    """The two unfused building blocks, at d = 1024, 4096 and 1001 (bf16
    J, fp32 vectors).  They are on no training path; ms, plain, library
    and bound sum the three shapes."""
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(5)
    for d in (1024, 4096, 1001):
        j = near_identity(torch, 1, d, gen, torch.bfloat16)[0]
        v = torch.randn((d, 1), generator=gen, device="cuda")
        got = rk.matvec(j, v)
        want = rk.matvec_plain(j, v)
        torch.cuda.synchronize()
        # fp32 out, the same products summed in another order
        err, ratio = bf16_close(got, want, 0.0, 1e-5)
        print(f"matvec {d}x{d}: max_abs_err {err:.3e}, worst |got-want| / "
              f"(1e-5 max|want|) {ratio:.3f} (tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"matvec {d} disagrees with its plain version")
        vb = v.to(torch.bfloat16)
        ms = time_ms(torch, lambda: rk.matvec(j, v), reps=50)
        plain = time_ms(torch, lambda: rk.matvec_plain(j, v), reps=50)
        lib = time_ms(torch, lambda: torch.mv(j, vb[:, 0]), reps=50)
        n_bytes = d * d * 2 + 2 * d * 4
        n_ops = 2.0 * d * d
        bms, by = rows["matvec"].bound(n_bytes, n_ops)
        print(f"matvec {d}x{d}: {ms:.4f} ms, plain {plain:.4f} ms, torch.mv "
              f"(bf16 vector and output) {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by})")
        rows["matvec"].add(err, ms, plain, n_bytes, n_ops, library_ms=lib)

        u = (want / math.sqrt(d)).contiguous()
        coef = torch.full((1, 1), 0.37, device="cuda")
        got = rk.rank1_update(j, u, coef, gamma=0.9)
        want = rk.rank1_update_plain(j, u, coef, gamma=0.9)
        torch.cuda.synchronize()
        err, ratio = bf16_close(got, want)
        print(f"rank1_update {d}x{d}: max_abs_err {err:.3e}, worst "
              f"|got-want| / (2^-7|want| + 1e-5 max|want|) {ratio:.3f} "
              "(tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"rank1_update {d} disagrees with its plain version")
        ub = u[:, 0].to(torch.bfloat16)
        c = coef.item()
        ms = time_ms(torch, lambda: rk.rank1_update(j, u, coef, gamma=0.9),
                     reps=50)
        plain = time_ms(torch, lambda: rk.rank1_update_plain(
            j, u, coef, gamma=0.9), reps=50)
        lib = time_ms(torch, lambda: torch.addr(j, ub, ub, beta=0.9,
                                                alpha=c), reps=50)
        n_bytes = 2 * d * d * 2 + d * 4 + 4
        n_ops = 3.0 * d * d
        bms, by = rows["rank1_update"].bound(n_bytes, n_ops)
        print(f"rank1_update {d}x{d}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch.addr (bf16 vectors) {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by})")
        rows["rank1_update"].add(err, ms, plain, n_bytes, n_ops,
                                 library_ms=lib)
        del j, v


def int8_bank(torch, b, d, gen):
    """int8 codes and (b,) fp32 scales (``quant_encode``) of a near-identity
    fp32 bank with symmetric off-diagonal noise of 0.05, so that the codes
    spread over about ±30 off the diagonal (a bank encoded from the
    phase's bf16 near-identity would hold almost only 127·I)."""
    from repro_torch.core.stats import quant_encode
    x = torch.randn((b, d, d), generator=gen, device="cuda") * 0.05
    x = (x + x.transpose(1, 2)) * (0.5 ** 0.5)
    x.diagonal(dim1=1, dim2=2).add_(1.0)
    q, sc = quant_encode(x)
    del x
    return q, sc


def check_fused_smw_int8(torch, rows):
    """fused_smw on int8 codes (fp32 out) against its plain version, which
    decodes the codes and computes in fp32: the same decoded values summed
    in another order, so the fp32 elementwise bound 1e-5|want| + 1e-6
    max|want|."""
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_smw[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, d, main in [(96, 1024, True), (24, 1024, True), (24, 4096, True),
                       (3, 1001, False)]:
        q, sc = int8_bank(torch, b, d, gen)
        v = torch.randn((b, d), generator=gen, device="cuda")
        for variant in ("paper", "exact_smw"):
            got = rk.fused_smw(q, v, gamma=0.9, variant=variant, scale=sc)
            want = rk.fused_smw_plain(q, v, gamma=0.9, variant=variant,
                                      scale=sc)
            torch.cuda.synchronize()
            err, ratio = bf16_close(got, want, 1e-5, 1e-6)
            print(f"fused_smw[int8] {b}x{d}x{d} {variant}: max_abs_err "
                  f"{err:.3e}, worst |got-want| / (1e-5|want| + 1e-6 "
                  f"max|want|) {ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"fused_smw[int8] {b}x{d} {variant} disagrees with its "
                    "plain version")
            row.add(err)
            del got, want
        if main:
            ms = time_ms(torch, lambda: rk.fused_smw(q, v, gamma=0.9,
                                                     scale=sc))
            plain = time_ms(torch, lambda: rk.fused_smw_plain(
                q, v, gamma=0.9, scale=sc))
            # the codes read once, the fp32 update written once; one
            # decode a code
            n_bytes = b * (d * d * 1 + d * d * 4 + d * 4 + 4)
            n_ops = b * 5.0 * d * d
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_smw[int8] {b}x{d}x{d}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del q, sc, v


def check_fused_block_smw_int8(torch, rows):
    """fused_block_smw on int8 codes at rank 4 (the bert-large bank sides,
    one with the pivot and one with windows filled to 0, 1 and r) and at a
    ragged shape; the fp32 bound of check_fused_smw_int8."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_block_smw[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(96, 1024, 4, "full", False, True),
             (24, 1024, 4, "full", True, True),
             (24, 4096, 4, "full", False, True),
             (24, 1024, 4, "mixed", False, False),
             (3, 1001, 3, "mixed", True, False)]
    for b, d, r, fill, pivot, main in cases:
        q, sc = int8_bank(torch, b, d, gen)
        v = torch.randn((b, r, d), generator=gen, device="cuda")
        n = torch.full((b,), r, device="cuda") if fill == "full" else \
            torch.tensor([(0, 1, r)[i % 3] for i in range(b)], device="cuda")
        sq, gm = block_weights(n, r, 0.9)
        vt = (v * sq[..., None]).contiguous()
        for variant in ("paper", "exact_smw"):
            res = rk.fused_block_smw(q, vt, gm, variant=variant,
                                     with_pivot=pivot, scale=sc)
            want = rk.fused_block_smw_plain(q, vt, gm, variant=variant,
                                            with_pivot=pivot, scale=sc)
            torch.cuda.synchronize()
            got = res[0] if pivot else res
            err, ratio = bf16_close(got, want[0] if pivot else want, 1e-5,
                                    1e-6)
            tag = (f"fused_block_smw[int8] {b}x{d}x{d} r={r} fill={fill} "
                   f"{variant}")
            print(f"{tag}: max_abs_err {err:.3e}, worst |got-want| / "
                  f"(1e-5|want| + 1e-6 max|want|) {ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} disagrees with its plain version")
            if fill == "mixed":
                empty = n == 0
                require(bool(torch.equal(
                    got[empty], q[empty].float() * sc[empty][:, None, None])),
                    f"{tag}: an empty window changed its decoded slice")
            if pivot:
                p_err = ((res[1] - want[1]).abs()
                         / want[1].abs()).max().item()
                print(f"{tag}: pivot min {res[1].min().item():.6g} vs "
                      f"{want[1].min().item():.6g}, max rel err "
                      f"{p_err:.3e} (tol 1e-3)")
                require(p_err <= 1e-3, f"{tag}: pivot disagrees")
            row.add(err)
            del res, want, got
        if main:
            ms = time_ms(torch, lambda: rk.fused_block_smw(q, vt, gm,
                                                           scale=sc))
            plain = time_ms(torch, lambda: rk.fused_block_smw_plain(
                q, vt, gm, scale=sc))
            n_bytes = b * (d * d * 1 + d * d * 4 + r * d * 4 + 8)
            n_ops = b * ((4.0 * r + 2) * d * d + 4.0 * r * r * d)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_block_smw[int8] {b}x{d}x{d} r={r}: {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del q, sc, v, vt


def check_fused_precond_int8(torch, rows):
    """fused_precond on int8 R and L with their scales (the first product
    through matmul with an int8 operand), rescale on and off; the bf16
    route's bound 2e-4·max|want| (the fp32 intermediate rides the tensor
    cores as a bf16 hi/lo pair)."""
    from repro_torch.kernels import precond as pc
    row = rows["fused_precond[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for b, di, do, main in [(96, 1024, 1024, True), (24, 1024, 4096, True),
                            (24, 4096, 1024, True), (3, 1001, 600, False)]:
        rq, rsc = int8_bank(torch, b, di, gen)
        lq, lsc = int8_bank(torch, b, do, gen)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        kw = dict(r_scale=rsc, l_scale=lsc)
        for rescale in (True, False):
            got = pc.fused_precond(rq, g, lq, rescale=rescale, **kw)
            want = pc.fused_precond_plain(rq, g, lq, rescale=rescale, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 2e-4 * want.abs().max().item()
            print(f"fused_precond[int8] {b}x{di}x{do} rescale={rescale}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e})")
            require(math.isfinite(err) and err <= tol,
                    f"fused_precond[int8] {b}x{di}x{do} disagrees with its "
                    "plain version")
            row.add(err)
            del got, want
        if main:
            ms = time_ms(torch, lambda: pc.fused_precond(rq, g, lq, **kw))
            plain = time_ms(torch, lambda: pc.fused_precond_plain(
                rq, g, lq, **kw))
            n_bytes = b * ((di * di + do * do) * 1 + di * do * 2
                           + di * do * 4 + 8)
            n_ops = b * 2.0 * di * do * (di + do)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_precond[int8] {b}x{di}x{do}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"{n_ops / ms / 1e9:.1f} TFLOP/s")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del rq, lq, g


# ----------------------------------------------------------------------- #
# Phase 4: full-width bert-large with mkor(lamb)
# ----------------------------------------------------------------------- #
def _max_rel(torch, xs, ys):
    num = sum(float(torch.sum(torch.square(x.float() - y.float())))
              for x, y in zip(xs, ys))
    den = sum(float(torch.sum(torch.square(y.float()))) for y in ys)
    return math.sqrt(num / max(den, 1e-30))


def bert_large_setup(dev, cfg=None):
    """Full-width bert-large with random weights from seed 0, its synthetic
    data (batch 8 x 128), and a maker of mkor(lamb) optimizers and their
    train steps."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib

    cfg = cfg or bert_large.CONFIG
    params = model_lib.init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {model_lib.param_count(params):,} params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"{cfg.dtype}")
    ds = pipeline.make_dataset(cfg, global_batch=8, seq_len=128, seed=0)

    def make(use_kernels, **kw):
        kw.setdefault("inv_freq", 3)
        mcfg = MKORConfig(use_kernels=use_kernels, **kw)
        opt = mkor(firstorder.lamb(1e-3), mcfg)
        return opt, train_lib.make_train_step(cfg, opt), mcfg
    return cfg, params, ds, make


def check_step0(torch, dev, cfg, params, ds, make):
    """Step 0 from the same state, through the kernels and the plain route.
    Without stagger every bucket inverts on step 0, so every bank side goes
    through fused_smw before it is compared."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves

    opt_0k, step_0k, _ = make(True, stagger=False)
    opt_0p, step_0p, _ = make(False, stagger=False)
    batch0 = train_lib.batch_to_device(pipeline.make_batch(ds, 0), dev)
    pk, sk, mk = step_0k(params, opt_0k.init(params), batch0)
    pp, sp, mp = step_0p(params, opt_0p.init(params), batch0)
    compare_banks("step 0", sk["factor_banks"], sp["factor_banks"])
    p0 = tree_leaves(params)
    dk = [a.float() - b.float() for a, b in zip(tree_leaves(pk), p0)]
    dp = [a.float() - b.float() for a, b in zip(tree_leaves(pp), p0)]
    rel_upd = _max_rel(torch, dk, dp)
    # bf16 parameters: an update that lands on the other side of a bf16
    # rounding boundary moves by a whole ulp
    print(f"step 0 param update vs plain: relative Frobenius error "
          f"{rel_upd:.3e} (tol 2e-2)")
    require(rel_upd <= 2e-2, "step 0 parameter update differs")
    del dk, dp, sk, sp

    # the loss on batch 0 after the step: both routes must move it alike
    loss_fn = train_lib.make_loss_fn(cfg, collect_stats=False)
    with torch.no_grad():
        l0 = float(mk["loss"])
        lk = float(loss_fn(pk, batch0)[0])
        lp = float(loss_fn(pp, batch0)[0])
    # 5 % of what the step did to the loss, plus 1e-5 relative for bf16
    # parameters that round the other way
    tol = 0.05 * abs(lp - l0) + 1e-5 * abs(lp)
    print(f"step 0 loss {l0:.6f}; after the step: kernels {lk:.6f}, plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3e}, tol {tol:.3e})")
    require(math.isfinite(lk) and abs(lk - lp) <= tol,
            "loss after step 0 differs")
    del pk, pp


def compare_banks(tag, got, want, bucket_ids=None):
    """Every bank side of ``bucket_ids`` (default all), kernel route
    against plain route, with the elementwise bf16 bound."""
    for bid in (bucket_ids if bucket_ids is not None else sorted(got)):
        for side in ("l_inv", "r_inv"):
            err, ratio = bf16_close(got[bid][side], want[bid][side])
            print(f"{tag} bank {bid}/{side}: max_abs_err {err:.3e}, worst "
                  f"|got-want| / (2^-7|want| + 1e-5 max|want|) {ratio:.3f} "
                  "(tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} bank {bid}/{side} differs")


class Int8BankCheck:
    """Holds int8 bank sides of the kernel route against the plain route's:
    the reconstructed fp32 bank decode(codes, scale) + error feedback with
    the fp32 elementwise bound 1e-5|want| + 1e-6 max|want| (it equals the
    stabilized fp32 update plus the old error feedback exactly, and the two
    routes' updates differ by fp32 rounding only), and the codes at most
    one step apart (a rounding difference can move a value across a code
    boundary; the error feedback carries the other side).  Records the
    worst ratio and the share of codes that differ."""

    def __init__(self, torch):
        self.torch = torch
        self.worst, self.flipped, self.codes = 0.0, 0, 0

    def __call__(self, tag, got, want, bucket_ids=None):
        torch = self.torch
        for bid in (bucket_ids if bucket_ids is not None else sorted(got)):
            for side in ("l", "r"):
                q_k, s_k, e_k = (f"{side}_inv", f"{side}_scale",
                                 f"{side}_ef")
                g, w = got[bid], want[bid]
                rec_g = g[q_k].float() * g[s_k][..., None, None] + g[e_k]
                rec_w = w[q_k].float() * w[s_k][..., None, None] + w[e_k]
                err, ratio = bf16_close(rec_g, rec_w, 1e-5, 1e-6)
                del rec_g, rec_w
                dq = (g[q_k].to(torch.int16) - w[q_k].to(torch.int16)).abs()
                max_dq, n_flip = int(dq.max()), int((dq > 0).sum())
                self.worst = max(self.worst, ratio)
                self.flipped += n_flip
                self.codes += dq.numel()
                print(f"{tag} bank {bid}/{side}: decode + ef max_abs_err "
                      f"{err:.3e}, worst |got-want| / (1e-5|want| + 1e-6 "
                      f"max|want|) {ratio:.3f} (tol 1); codes: max diff "
                      f"{max_dq} (tol 1), {n_flip} of {dq.numel()} differ")
                require(math.isfinite(ratio) and ratio <= 1.0,
                        f"{tag} bank {bid}/{side}: decode + ef differs")
                require(max_dq <= 1, f"{tag} bank {bid}/{side}: codes "
                        "differ by more than one step")

    def summary(self, name):
        share = self.flipped / max(self.codes, 1)
        print(f"[{name}] kernel vs plain route: worst decode+ef ratio "
              f"{self.worst:.3f} (tol 1), {self.flipped} of {self.codes} "
              f"codes differ by one step ({share:.3e})")


class PlainTee:
    """An optimizer that runs the kernel route and, at the listed counts,
    also the plain route on the same inputs, and holds the banks of the
    buckets that invert against each other (``compare``, default the
    elementwise bf16 bound of :func:`compare_banks`).  The plain route
    launches no kernel, so the launch counts stay those of the main path;
    ``in_plain`` is True while it runs.  ``events`` records the call order
    of precompute and update."""

    def __init__(self, torch, opt_k, opt_p, phases, inv_freq,
                 update_at=(), tick_at=(), compare=None):
        self.torch, self.opt_k, self.opt_p = torch, opt_k, opt_p
        self.phases, self.inv_freq = phases, inv_freq
        self.update_at, self.tick_at = set(update_at), set(tick_at)
        self.compare = compare or compare_banks
        self.events, self.compared = [], []
        self.in_plain = False

    def plain(self, fn, *args, **kw):
        self.in_plain = True
        try:
            return fn(*args, **kw)
        finally:
            self.in_plain = False

    def due(self, count):
        return [b for b, ph in sorted(self.phases.items())
                if count % self.inv_freq == ph]

    def transformation(self):
        from repro_torch.core.firstorder import GradientTransformation
        return GradientTransformation(
            self.opt_k.init, self.update,
            self.precompute if self.opt_k.precompute is not None else None)

    def precompute(self, state, params=None, **kw):
        self.events.append("precompute")
        new = self.opt_k.precompute(state, params=params, **kw)
        count = state["count"]
        if count in self.tick_at:
            plain = self.plain(self.opt_p.precompute, state, params=params,
                               **kw)
            self.torch.cuda.synchronize()
            self.compare(f"tick {count} pending", new["pending_banks"],
                         plain["pending_banks"], self.due(count))
            self.compared.append(count)
        return new

    def update(self, grads, state, params=None, stats=None, **kw):
        self.events.append("update")
        out = self.opt_k.update(grads, state, params=params, stats=stats,
                                **kw)
        count = state["count"]
        if count in self.update_at:
            plain = self.plain(self.opt_p.update, grads, state,
                               params=params, stats=stats, **kw)
            self.torch.cuda.synchronize()
            self.compare(f"step {count}", out[1]["factor_banks"],
                         plain[1]["factor_banks"], self.due(count))
            self.compared.append(count)
        return out


def run_path(torch, dev, name, step_fn, opt, params, ds, steps,
             skip_times=()):
    """One counted training path: launch counts and fallbacks set to 0
    just before it, read just after; fresh optimizer state.  Returns
    (params, state, counts)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    state = opt.init(params)
    losses, times = [], []
    for step in range(steps):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = ops.launch_counts()
    cores = ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[{name}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    clean = [t for i, t in enumerate(times) if i > 0 and i not in skip_times]
    print(f"[{name}] step ms {[round(t, 3) for t in times]} (median of "
          f"steps {[i for i in range(1, steps) if i not in skip_times]} "
          f"{statistics.median(clean):.3f} ms), peak memory {peak:.3f} GiB")
    print(f"[{name}] launch counts {counts}, GEMM cores {cores}, fallbacks "
          f"{fallbacks}")
    must, must_not = PATH_KERNELS[name]
    for k in must:
        require(counts.get(k, 0) > 0,
                f"{name}: {k} was not launched on the training path")
    for k in must_not:
        require(counts.get(k, 0) == 0,
                f"{name}: {k} was launched on the training path")
    require(not fallbacks, f"{name}: fallbacks on the path: {fallbacks}")
    if name in WGMMA_PATHS:
        # every GEMM of matmul and fused_precond (two a launch: its first
        # product runs through matmul) on the Hopper core
        gemms = counts.get("matmul", 0) + counts.get("fused_precond", 0)
        require(cores.get("wmma", 0) == 0 and
                cores.get("wgmma", 0) == gemms,
                f"{name}: GEMM cores {cores}, expected all {gemms} on wgmma")
    return params, state, counts


def profile_and_phases(torch, dev, cfg, ds, step_fn, opt, params, state,
                       step):
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
    profile_step(torch, lambda: step_fn(params, state, batch))
    phase_breakdown(torch, cfg, opt, params, state, batch,
                    torch.cuda.synchronize)


def train_rank1(torch, dev, setup):
    """Path a: PR 12's rank-1 main path, unchanged."""
    cfg, params, ds, make = setup
    check_step0(torch, dev, cfg, params, ds, make)
    opt_k, step_k, _ = make(True)
    params, state, counts = run_path(torch, dev, "rank1", step_k, opt_k,
                                     params, ds, TRAIN_STEPS)
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       TRAIN_STEPS)
    return counts


def _phases(params, mcfg):
    from repro_torch.core import stats as statlib
    from repro_torch.core.mkor import manifest_for
    return statlib.bucket_phases(manifest_for(params, mcfg), mcfg.inv_freq,
                                 mcfg.stagger)


def train_rank4(torch, dev, setup):
    """Path b: block rank 4, inv_freq 4, stagger.  Bucket i consumes at
    counts i and i + 4: first a partial window (i + 1 rows), then a full
    one, which is held against the plain route."""
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, rank=4, inv_freq=4)
    opt_p, _, _ = make(False, rank=4, inv_freq=4)
    phases = _phases(params, mcfg)
    first_full = [ph + mcfg.inv_freq for ph in sorted(set(phases.values()))]
    tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                   update_at=first_full)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    params, state, counts = run_path(torch, dev, "rank4", step_fn, opt,
                                     params, ds, RANK4_STEPS,
                                     skip_times=first_full)
    require(tee.compared == first_full,
            f"rank4: compared at {tee.compared}, expected {first_full}")
    # one more step (bucket 0 consumes its second full window), profiled
    profile_and_phases(torch, dev, cfg, ds, train_lib.make_train_step(
        cfg, opt_k), opt_k, params, state, RANK4_STEPS)
    return counts


def train_staleness1(torch, dev, setup):
    """Path c: staleness 1 at rank 1, inv_freq 3, stagger.  Bucket i ticks
    at counts i, i + 3, i + 6: its first launch consumes an empty window,
    its second one row; the promoted active bank leaves the identity at
    the third tick."""
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, staleness=1)
    opt_p, _, _ = make(False, staleness=1)
    phases = _phases(params, mcfg)
    # the first tick that launches, then each bucket's first tick with a
    # non-empty window
    ticks = [0] + [ph + mcfg.inv_freq for ph in sorted(set(phases.values()))]
    tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq, tick_at=ticks)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    forward = model_lib.forward

    def traced_forward(*args, **kwargs):
        tee.events.append("forward")
        return forward(*args, **kwargs)

    model_lib.forward = traced_forward
    try:
        params, state, counts = run_path(torch, dev, "staleness1", step_fn,
                                         opt, params, ds, STALE_STEPS,
                                         skip_times=ticks)
    finally:
        model_lib.forward = forward
    require(tee.events == ["precompute", "forward", "update"] * STALE_STEPS,
            f"staleness1: call order {tee.events[:6]}...")
    print(f"[staleness1] every step ran precompute, then the forward, then "
          f"update ({STALE_STEPS} steps); compared ticks {tee.compared}")
    require(tee.compared == ticks, f"staleness1: compared at {tee.compared}")
    for bid, bank in sorted(state["factor_banks"].items()):
        d = bank["l_inv"].shape[-1]
        eye = torch.eye(d, dtype=bank["l_inv"].dtype, device=dev)
        moved = (bank["l_inv"] - eye).abs().max().item()
        print(f"[staleness1] active bank {bid}/l_inv: max |F - I| "
              f"{moved:.3e} after {STALE_STEPS} steps")
        require(moved > 0, f"staleness1: active bank {bid} is still the "
                "identity")
    # one more step (a tick that launches for the 1024x1024 bucket),
    # profiled; the phase times run the tick inline inside the update
    profile_and_phases(torch, dev, cfg, ds, train_lib.make_train_step(
        cfg, opt_k), opt_k, params, state, STALE_STEPS)
    return counts


def _int8_path(torch, dev, setup, name, steps, **kw):
    """One int8 training path (factor_quant="int8"): the kernel route,
    teed to the plain route at each bucket's first inversion (staleness 1:
    the first tick that launches, and each bucket's first tick with a
    non-empty window); counts the bank decodes the kernel route makes
    (window rows are decoded; banks must not be)."""
    from repro_torch.core import stats as statlib
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, factor_quant="int8", **kw)
    opt_p, _, _ = make(False, factor_quant="int8", **kw)
    phases = _phases(params, mcfg)
    firsts = sorted(set(phases.values()))
    check = Int8BankCheck(torch)
    if mcfg.staleness:
        at = [0] + [ph + mcfg.inv_freq for ph in firsts]
        tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                       tick_at=at, compare=check)
    else:
        at = firsts
        tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                       update_at=at, compare=check)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    decode, forward = statlib.quant_decode, model_lib.forward
    kernel_decodes = []

    def counted_decode(q, scale, axes=2):
        if not tee.in_plain:
            kernel_decodes.append(tuple(q.shape))
        return decode(q, scale, axes)

    def traced_forward(*args, **kwargs):
        tee.events.append("forward")
        return forward(*args, **kwargs)

    statlib.quant_decode, model_lib.forward = counted_decode, traced_forward
    try:
        params, state, counts = run_path(torch, dev, name, step_fn, opt,
                                         params, ds, steps, skip_times=at)
    finally:
        statlib.quant_decode, model_lib.forward = decode, forward
    require(tee.compared == at, f"{name}: compared at {tee.compared}, "
            f"expected {at}")
    check.summary(name)
    print(f"[{name}] bank decodes on the kernel route: "
          f"{len(kernel_decodes)}")
    require(not kernel_decodes, f"{name}: the kernel route decoded banks "
            f"{kernel_decodes[:4]}")
    order = ["precompute", "forward", "update"] if mcfg.staleness else \
        ["forward", "update"]
    require(tee.events == order * steps,
            f"{name}: call order {tee.events[:6]}...")
    for bid, bank in sorted(state["factor_banks"].items()):
        # the factor is decode + ef: off-diagonal terms below half a code
        # step live in the error feedback alone
        d = bank["l_inv"].shape[-1]
        eye = 127 * torch.eye(d, dtype=torch.int8, device=dev)
        codes = int((bank["l_inv"].to(torch.int16) - eye).abs().max())
        rec = bank["l_inv"].float() * bank["l_scale"][..., None, None] \
            + bank["l_ef"]
        moved = (rec - torch.eye(d, device=dev)).abs().max().item()
        print(f"[{name}] active bank {bid}/l_inv: max |decode + ef - I| "
              f"{moved:.3e}, max |codes - 127 I| {codes}, scale "
              f"{bank['l_scale'].min().item():.4g}.."
              f"{bank['l_scale'].max().item():.4g}, max |ef| "
              f"{bank['l_ef'].abs().max().item():.3e} after {steps} steps")
        del rec
        require(moved > 0, f"{name}: active bank {bid} is still the "
                "identity")
    profile_and_phases(torch, dev, cfg, ds, train_lib.make_train_step(
        cfg, opt_k), opt_k, params, state, steps)
    return counts


def train_int8_rank1(torch, dev, setup):
    """Path d: int8 factor state at rank 1, inv_freq 3, stagger."""
    return _int8_path(torch, dev, setup, "int8_rank1", TRAIN_STEPS)


def train_int8_rank4(torch, dev, setup):
    """Path e: int8 factor state, block rank 4, inv_freq 4, stagger."""
    return _int8_path(torch, dev, setup, "int8_rank4", RANK4_STEPS, rank=4,
                      inv_freq=4)


def train_int8_staleness1(torch, dev, setup):
    """Path f: int8 factor state at staleness 1, rank 1, inv_freq 3."""
    return _int8_path(torch, dev, setup, "int8_staleness1", STALE_STEPS,
                      staleness=1)


def phase_breakdown(torch, cfg, opt, params, state, batch, sync, reps=3):
    """Host-clock ms of each phase of a step (each ends in a synchronize),
    median of ``reps``: forward+backward, the MKOR+LAMB update, LAMB
    alone on the same gradients, and applying the updates."""
    from repro_torch.core import firstorder
    from repro_torch.training import loop as train_lib

    loss_fn = train_lib.make_loss_fn(cfg)
    lamb = firstorder.lamb(1e-3)
    lamb_state = lamb.init(params)
    times = {"forward+backward": [], "optimizer (MKOR+LAMB)": [],
             "LAMB alone": [], "apply_updates": []}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        (loss, aux), grads = timed("forward+backward",
                                   lambda: train_lib.value_and_grad(
                                       loss_fn, params, batch))
        updates, _ = timed("optimizer (MKOR+LAMB)", lambda: opt.update(
            grads, state, params=params, stats=aux["stats"]))
        timed("LAMB alone", lambda: lamb.update(grads, lamb_state,
                                                params=params))
        timed("apply_updates",
              lambda: firstorder.apply_updates(params, updates))
    print("phase ms (median of 3 steps, host clock): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in times.items()))


def profile_step(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profiled step: wall {wall:.3f} ms; the profiler recorded no "
              "device time (not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + (cur_e - cur_s)) / 1e3
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    port = ("mkor::gemm_kernel", "wgmma_gemm_kernel", "smw_uv_kernel", "smw_write_kernel",
            "sumsq_kernel", "rescale_kernel", "block_uv_kernel",
            "block_mid_kernel", "block_write_kernel")

    def is_port(n):
        return any(p in n for p in port)

    def is_gemm(n):
        low = n.lower()
        return not is_port(n) and any(t in low for t in (
            "gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas"))

    t_port = sum(v[0] for n, v in by_name.items() if is_port(n))
    t_gemm = sum(v[0] for n, v in by_name.items() if is_gemm(n))
    t_all = sum(v[0] for v in by_name.values())
    print(f"profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), port kernels {t_port:.3f} ms, "
          f"library GEMMs {t_gemm:.3f} ms, other kernels "
          f"{t_all - t_port - t_gemm:.3f} ms")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t:10.3f} ms {c:5d}x  {n[:100]}")
    # host waits: runtime calls that hold the host until the device is done
    # (the step's own closing synchronize is one of them)
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    t_first = min(e.time_range.start for e in host)
    waits = {}
    for e in host:
        if any(k in e.name for k in ("Synchronize", "cudaMemcpy",
                                     "_local_scalar_dense")):
            w = waits.setdefault(e.name, [0.0, 0, math.inf])
            w[0] += (e.time_range.end - e.time_range.start) / 1e3
            w[1] += 1
            w[2] = min(w[2], (e.time_range.start - t_first) / 1e3)
    print("host waits in the step: " + (", ".join(
        f"{n} {c}x {t:.3f} ms (first at +{f:.1f} ms)"
        for n, (t, c, f) in sorted(waits.items())) or "none"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per = build.build()
    print(f"built {sorted(build.KERNEL_SOURCES)} from src/repro_torch/csrc "
          f"in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in per.items())})")

    rows = {name: KernelRow(name) for name in REPLACES}
    check_fused_smw(torch, rows)
    check_fused_precond(torch, rows)
    check_matmul(torch, rows)
    check_fused_block_smw(torch, rows)
    check_matvec_and_rank1_update(torch, rows)
    check_fused_smw_int8(torch, rows)
    check_fused_block_smw_int8(torch, rows)
    check_fused_precond_int8(torch, rows)
    for name in ("matmul", "fused_precond"):
        r = rows[name]
        b_ms, b_by = r.bound(r.bytes, r.ops)
        print(f"{name}, sum of the bert-large shapes: wgmma core {r.ms:.4f} ms "
              f"{rate(r.ops, r.ms)}, " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in r.other_ms.items())
              + (f", library {r.library_ms:.4f} ms" if r.library_ms else "")
              + f", plain {r.plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()

    dev = torch.device("cuda")
    setup = bert_large_setup(dev)
    paths = {"rank1": train_rank1, "rank4": train_rank4,
             "staleness1": train_staleness1, "int8_rank1": train_int8_rank1,
             "int8_rank4": train_int8_rank4,
             "int8_staleness1": train_int8_staleness1}
    launches = {name: 0 for name in REPLACES}
    for name, fn in paths.items():
        t0 = time.perf_counter()
        counts = fn(torch, dev, setup)
        torch.cuda.empty_cache()
        print(f"[{name}] path done in {time.perf_counter() - t0:.1f} s")
        for k, c in counts.items():
            launches[k] += c
    print(json.dumps({"kernels": [rows[n].as_json(launches[n])
                                  for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
