#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build of every CUDA kernel from ``src/repro_torch/csrc`` (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes full-width bert-large gives it and at one ragged shape: max
     abs error and tolerance, kernel / plain / library ms, and the least
     time the card could take (bytes over 3.35 TB/s or bf16 operations
     over 989 TFLOP/s, whichever is larger);
  4. full-width bert-large trained with mkor(lamb) through the kernels:
     step 0 against the plain route from the same state (banks, update,
     and the loss after the step), then the main
     path (counts reset, fresh optimizer state, several steps) with
     losses, step time, peak memory, per-kernel launch counts and
     fallbacks, and a profiler breakdown of one more step;
  5. one JSON line listing every kernel, the card's name and power limit,
     and, last, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a result when there is no CUDA device or when the port's
sources are not beside it.
"""
from __future__ import annotations

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
REPLACES = {
    "fused_smw": "src/repro/kernels/rank1_smw.py:355",
    "fused_precond": "src/repro/kernels/precond.py:108",
    "matmul": "src/repro/kernels/matmul.py:35",
}
SOURCES = {
    "fused_smw": "src/repro_torch/csrc/rank1_smw.cu",
    "fused_precond": "src/repro_torch/csrc/precond.cu",
    "matmul": "src/repro_torch/csrc/matmul.cu",
}
TRAIN_STEPS = 6                   # two full inv_freq=3 windows


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
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

    def as_json(self, launches: int):
        b_ms, b_by = bound_ms(self.bytes, self.ops)
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name], "replaces": REPLACES[self.name],
                "launches": launches, "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": self.library_ms}


def bf16_close(got, want):
    """(max abs error, worst ratio to the elementwise bf16 tolerance).

    Kernel and plain version round the same fp32 value to bf16, but their
    fp32 sums run in another order, so an element may land on the
    neighbouring bf16 value: one ulp, at most 2^-7 of the element itself.
    The floor 1e-5·max|want| covers elements near zero, whose fp32
    rounding differences are ~1e-7 of the largest entry.  Being
    elementwise, the bound sees the rank-1 term of an SMW update even
    where it is small beside the diagonal."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
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
            bms, by = bound_ms(n_bytes, n_ops)
            print(f"fused_smw {b}x{d}x{d}: {ms:.4f} ms, plain {plain:.4f} ms,"
                  f" bound {bms:.4f} ms ({by})")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del j, v


def check_fused_precond(torch, rows):
    from repro_torch.kernels import precond as pc
    row = rows["fused_precond"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, di, do, main in [(96, 1024, 1024, True), (24, 1024, 4096, True),
                            (24, 4096, 1024, True), (3, 1001, 600, False)]:
        r = near_identity(torch, b, di, gen, torch.bfloat16)
        l = near_identity(torch, b, do, gen, torch.bfloat16)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        for rescale in (True, False):
            got = pc.fused_precond(r, g, l, rescale=rescale)
            want = pc.fused_precond_plain(r, g, l, rescale=rescale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            # the float32 intermediate rides the tensor cores as a bf16
            # hi/lo pair (16 significant bits) and sums run in another
            # order: 2e-4 of the largest entry
            tol = 2e-4 * want.abs().max().item()
            print(f"fused_precond {b}x{di}x{do} rescale={rescale}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e})")
            require(math.isfinite(err) and err <= tol,
                    f"fused_precond {b}x{di}x{do} disagrees with its plain "
                    "version")
            row.add(err)
        if main:
            ms = time_ms(torch, lambda: pc.fused_precond(r, g, l))
            plain = time_ms(torch, lambda: pc.fused_precond_plain(r, g, l))
            n_bytes = b * ((di * di + do * do + di * do) * 2 + di * do * 4)
            n_ops = b * 2.0 * di * do * (di + do)
            bms, by = bound_ms(n_bytes, n_ops)
            print(f"fused_precond {b}x{di}x{do}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"{n_ops / ms / 1e9:.1f} TFLOP/s")
            row.add(0.0, ms, plain, n_bytes, n_ops)
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
    from repro_torch.kernels import matmul as mm
    row = rows["matmul"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    # the first products fused_precond hands to matmul at bert-large:
    # G L⁻¹ for the 1024x1024 and 1024x4096 buckets, R⁻¹ G for 4096x1024
    for b, m, k, n, main in [(96, 1024, 1024, 1024, True),
                             (24, 1024, 4096, 4096, True),
                             (24, 4096, 4096, 1024, True),
                             (3, 1001, 600, 701, False)]:
        a = (torch.randn((b, m, k), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        w = (torch.randn((b, k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        got = mm.matmul(a, w)
        want = mm.matmul_plain(a, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # bf16 products are exact in fp32: only the summation order differs
        tol = 1e-5 * want.abs().max().item() * math.sqrt(k)
        print(f"matmul {b}x{m}x{k}x{n}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})")
        require(math.isfinite(err) and err <= tol,
                f"matmul {b}x{m}x{k}x{n} disagrees with its plain version")
        row.add(err)
        if main:
            ms = time_ms(torch, lambda: mm.matmul(a, w))
            plain = time_ms(torch, lambda: mm.matmul_plain(a, w))
            lib_fn, lib_name = library_matmul(torch, a, w)
            lib = time_ms(torch, lib_fn)
            n_bytes = b * ((m * k + k * n) * 2 + m * n * 4)
            n_ops = b * 2.0 * m * k * n
            bms, by = bound_ms(n_bytes, n_ops)
            print(f"matmul {b}x{m}x{k}x{n}: {ms:.4f} ms, plain {plain:.4f} "
                  f"ms, {lib_name} {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}), {n_ops / ms / 1e9:.1f} TFLOP/s")
            row.add(0.0, ms, plain, n_bytes, n_ops, library_ms=lib)
        del a, w


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
    data (batch 8 x 128), and a maker of mkor(lamb) train steps."""
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

    def make(use_kernels, stagger=True):
        opt = mkor(firstorder.lamb(1e-3),
                   MKORConfig(inv_freq=3, stagger=stagger,
                              use_kernels=use_kernels))
        return opt, train_lib.make_train_step(cfg, opt)
    return cfg, params, ds, make


def check_step0(torch, dev, cfg, params, ds, make):
    """Step 0 from the same state, through the kernels and the plain route.
    Without stagger every bucket inverts on step 0, so every bank side goes
    through fused_smw before it is compared."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves

    opt_0k, step_0k = make(True, stagger=False)
    opt_0p, step_0p = make(False, stagger=False)
    batch0 = train_lib.batch_to_device(pipeline.make_batch(ds, 0), dev)
    pk, sk, mk = step_0k(params, opt_0k.init(params), batch0)
    pp, sp, mp = step_0p(params, opt_0p.init(params), batch0)
    for bid, bank in sk["factor_banks"].items():
        for side in ("l_inv", "r_inv"):
            err, ratio = bf16_close(bank[side], sp["factor_banks"][bid][side])
            print(f"step 0 bank {bid}/{side}: max_abs_err {err:.3e}, worst "
                  f"|got-want| / (2^-7|want| + 1e-5 max|want|) {ratio:.3f} "
                  "(tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"step 0 bank {bid}/{side} differs")
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


def train_bert_large(torch, dev, cfg=None):
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib

    cfg, params, ds, make = bert_large_setup(dev, cfg)
    check_step0(torch, dev, cfg, params, ds, make)

    # the main path (staggered inversions): fresh state, counts from zero
    opt_k, step_k = make(True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = opt_k.init(params)
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
        t0 = time.perf_counter()
        params, state, metrics = step_k(params, state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = ops.launch_counts()
    fallbacks = ops.fallback_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else float("nan")
    print(f"train losses {losses}")
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    print(f"step ms {[round(t, 3) for t in times]} (median of steps "
          f"1-{TRAIN_STEPS - 1} {statistics.median(times[1:]):.3f} ms), "
          f"peak memory {peak:.3f} GiB")
    print(f"launch counts {counts}, fallbacks {fallbacks}")
    for name in REPLACES:
        require(counts.get(name, 0) > 0,
                f"{name} was not launched on the training path")
    require(not fallbacks, f"fallbacks on the bert-large path: {fallbacks}")

    # one more step under the profiler, then the step split into phases
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, TRAIN_STEPS),
                                      dev)
    profile_step(torch, lambda: step_k(params, state, batch))
    phase_breakdown(torch, cfg, opt_k, params, state, batch, sync)
    return counts


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
    port = ("mkor::gemm_kernel", "smw_uv_kernel", "smw_write_kernel",
            "sumsq_kernel", "rescale_kernel")

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
    ops.reset_launch_counts()

    counts = train_bert_large(torch, torch.device("cuda"))
    print(json.dumps({"kernels": [rows[n].as_json(counts.get(n, 0))
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
