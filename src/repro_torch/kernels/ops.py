"""Banked entry points to the kernels and the launch / fallback counters
(port of ``repro/kernels/ops.py``).  These are what MKOR calls with
``MKORConfig.use_kernels=True``: :func:`smw_rank1_update_banked` (rank-1
stats, ``fused_smw``), :func:`smw_block_update_banked` (ring windows,
``fused_block_smw``) and :func:`fused_precondition_banked`.

Contract, as in the reference: a bank is ``(*lead, d, d)`` with
``lead = (n_bucket_layers, *stack)``; the lead dims are flattened and each
banked entry makes ONE launch per bucket, with the flattened lead dims as
the kernel's batch (grid) axis.  An empty owner chunk (a 0 in ``lead``) is
returned untouched.

A single factor or slice (no lead dims) runs as a bank of one.

MKOR's per-layer layout calls the reference's per-layer entries,
:func:`smw_rank1_update` (``v`` may be chained rows),
:func:`smw_block_update` and :func:`fused_precondition`: one layer's
``(*stack, d, d)`` factor goes through the banked entry with
``lead = stack``, one launch a layer side.  :func:`matmul_cu` (the
reference's ``pallas_matmul``) launches ``matmul``.  Launches count under
the kernels' own names.

The TPU plan (``_pick_block`` and the 12 MiB VMEM budget) has no
counterpart: the kernels mask ragged edges themselves, so nothing is
padded, and the fused precondition keeps its first product in device
memory rather than in on-chip scratch, so it has no size limit and takes
every 2-D slice.  :class:`KernelPlan` and :func:`bucket_kernel_plans` are
the reference's dispatch report with the card's fields: each SMW plan is
read from the C entries of ``csrc/smw_plan.cuh`` (tiles, runs, lag,
scratch, and whether J arrives by bulk copies or element by element), the
precondition's GEMM core from ``kernels/matmul.py:gemm_route`` and its
scratch from the precondition library.  The plan takes the libraries as
an argument (:func:`card_libraries` on the card; the CPU tests pass
``smw_plan.cuh`` built by the host compiler) and never re-derives them in
Python.  Only a gradient with extra broadcast dims (experts under shared
factors) falls back to :func:`two_sided_precondition` (two ``matmul``
launches plus a rescale); that fallback is counted in
:func:`fallback_counts` and warned about.

int8 factor banks (MKOR's int8 factor state) pass their codes with
``lead``-shaped fp32 scales: ``scale=`` for the SMW entries,
``l_scale=`` / ``r_scale=`` (both or neither) for the precondition.  The
scales are flattened with the bank, so it is still one launch per bank
side, counted as ``fused_smw[int8]``, ``fused_block_smw[int8]`` and
``fused_precond[int8]``, and the SMW updates come back fp32 for the caller
to requantize.
"""
from __future__ import annotations

import ctypes
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import precond as pc
from repro_torch.kernels import rank1_smw as rk
from repro_torch.kernels.ref import dequant_ref

launch_counts = build.launch_counts
gemm_core_counts = build.gemm_core_counts
reset_launch_counts = build.reset_launch_counts


class KernelFallbackWarning(UserWarning):
    """A fused entry point fell back to its unfused path."""


_FALLBACK_COUNTS: Counter = Counter()


def fallback_counts() -> Dict[Tuple[str, str], int]:
    return dict(_FALLBACK_COUNTS)


def reset_fallback_counts() -> None:
    _FALLBACK_COUNTS.clear()


def _note_fallback(kernel: str, reason: str, detail: str) -> None:
    _FALLBACK_COUNTS[(kernel, reason)] += 1
    warnings.warn(f"{kernel}: falling back to the unfused path ({reason}): "
                  f"{detail}", KernelFallbackWarning, stacklevel=3)


# ----------------------------------------------------------------------- #
# SMW
# ----------------------------------------------------------------------- #
def _flat_scale(scale, lead):
    """A bank's ``lead``-shaped int8 scales as the kernel's (B,) fp32."""
    if scale is None:
        return None
    if tuple(scale.shape) != lead:
        raise ValueError(f"scale {tuple(scale.shape)} must match the bank's "
                         f"lead dims {lead}")
    return scale.float().reshape(-1).contiguous()


def smw_rank1_update_banked(j: torch.Tensor, v: torch.Tensor, *,
                            gamma: float, variant: str = "paper",
                            out: torch.Tensor = None,
                            scale: torch.Tensor = None) -> torch.Tensor:
    """Banked fused SMW.  j: (*lead, d, d); v: (*lead, d).  ``out`` (may
    be ``j``) receives the update in place.  ``scale`` (``lead``-shaped
    fp32) marks j as int8 codes: the update comes back fp32."""
    d = j.shape[-1]
    lead = tuple(j.shape[:-2])
    if tuple(v.shape) != lead + (d,):
        raise ValueError(f"smw bank {tuple(j.shape)} vs stats "
                         f"{tuple(v.shape)}")
    if not lead:                                    # one factor
        return smw_rank1_update_banked(
            j[None], v[None], gamma=gamma, variant=variant,
            scale=None if scale is None else scale.reshape(1))[0]
    if 0 in lead:                                   # empty owner slice
        return j if scale is None else j.float()
    jf = j.reshape(-1, d, d)
    vf = v.float().reshape(-1, d).contiguous()
    of = None if out is None else out.view(-1, d, d)
    return rk.fused_smw(jf, vf, gamma=gamma, variant=variant, out=of,
                        scale=_flat_scale(scale, lead)).reshape(j.shape)


def smw_block_update_banked(j: torch.Tensor, v: torch.Tensor, n_valid, *,
                            gamma: float, variant: str = "paper",
                            with_pivot: bool = False,
                            out: torch.Tensor = None,
                            scale: torch.Tensor = None):
    """Banked block rank-r Woodbury update: ONE ``fused_block_smw`` launch
    per bank.  j: (*lead, d, d); v: (*lead, r, d) ring windows ordered
    oldest-first (``core.stats.window_ordered``); n_valid: int or int
    tensor broadcastable to ``lead``, each slice's window fill count (a
    slice with count 0 comes back unchanged).  The √wᵢ row weights and
    γ^m are formed here per slice in fp32 (``core.mkor.block_weights``).
    ``out`` (may be ``j``) receives the update in place.

    ``with_pivot=True`` returns ``(new, pivot)``: the smallest
    Gauss–Jordan pivot over every slice of the bank, a 0-d fp32 tensor
    (see :func:`repro_torch.kernels.rank1_smw.fused_block_smw` for which
    pivot that is); ``inf`` for an empty bank.  ``scale`` (``lead``-shaped
    fp32) marks j as int8 codes: the update comes back fp32."""
    from repro_torch.core.mkor import block_weights  # mkor imports ops
    d = j.shape[-1]
    lead = tuple(j.shape[:-2])
    if v.ndim != j.ndim or tuple(v.shape[:len(lead)]) != lead or \
            v.shape[-1] != d:
        raise ValueError(f"block smw bank {tuple(j.shape)} vs window "
                         f"{tuple(v.shape)}")
    if not lead:                                    # one factor
        res = smw_block_update_banked(
            j[None], v[None], torch.as_tensor(n_valid).reshape(1),
            gamma=gamma, variant=variant, with_pivot=with_pivot,
            out=None if out is None else out[None],
            scale=None if scale is None else scale.reshape(1))
        return (res[0][0], res[1]) if with_pivot else res[0]
    if 0 in lead:                                   # empty owner slice
        inf = torch.full((), float("inf"), device=j.device)
        jf = j if scale is None else j.float()
        return (jf, inf) if with_pivot else jf
    r = v.shape[-2]
    nv = torch.as_tensor(n_valid, device=j.device).broadcast_to(lead)
    sq, gm = block_weights(nv.reshape(-1), r, gamma)
    vt = (v.float().reshape(-1, r, d) * sq[..., None]).contiguous()
    of = None if out is None else out.view(-1, d, d)
    res = rk.fused_block_smw(j.reshape(-1, d, d), vt, gm.contiguous(),
                             variant=variant, with_pivot=with_pivot, out=of,
                             scale=_flat_scale(scale, lead))
    if with_pivot:
        return res[0].reshape(j.shape), torch.amin(res[1])
    return res.reshape(j.shape)


# ----------------------------------------------------------------------- #
# Per-layer entries (the reference's, for MKOR's per-layer layout): one
# layer's factor ``(*stack, d, d)`` goes through the banked entry with
# ``lead = stack``, so a stacked layer is one launch a side, not one a
# slice (the reference maps its per-slice kernel over the stack).
# ----------------------------------------------------------------------- #
def smw_rank1_update(j_inv: torch.Tensor, v: torch.Tensor, *, gamma: float,
                     variant: str = "paper",
                     out: torch.Tensor = None) -> torch.Tensor:
    """``fused_smw`` on one layer's factor j_inv (*stack, d, d) with stats
    v (*stack, d), or (*stack, r, d) chained oldest first (one launch a
    row).  ``out`` (may be ``j_inv``) receives the update in place."""
    if v.ndim != j_inv.ndim:
        return smw_rank1_update_banked(j_inv, v, gamma=gamma,
                                       variant=variant, out=out)
    for i in range(v.shape[-2]):
        j_inv = smw_rank1_update_banked(j_inv, v[..., i, :], gamma=gamma,
                                        variant=variant, out=out)
        out = j_inv                     # the next row updates it in place
    return j_inv


def smw_block_update(j_inv: torch.Tensor, v: torch.Tensor, *, gamma: float,
                     variant: str = "paper", n_valid=None,
                     with_pivot: bool = False, out: torch.Tensor = None):
    """``fused_block_smw`` on one layer's factor j_inv (*stack, d, d) from
    its window rows v (*stack, r, d), oldest first; ``n_valid`` (None: a
    full window) broadcastable to ``stack``.  ``with_pivot`` also returns
    the smallest pivot over the stack (0-d fp32)."""
    return smw_block_update_banked(
        j_inv, v, v.shape[-2] if n_valid is None else n_valid, gamma=gamma,
        variant=variant, with_pivot=with_pivot, out=out)


def matmul_cu(a: torch.Tensor, b: torch.Tensor, *,
              out_dtype=torch.float32) -> torch.Tensor:
    """A @ B through ``csrc/matmul.cu`` (the reference's
    ``pallas_matmul``): 2-D, or 3-D batched (a 2-D operand broadcast)."""
    return mm.matmul(a, b, out_dtype=out_dtype)


# ----------------------------------------------------------------------- #
# Precondition
# ----------------------------------------------------------------------- #
def two_sided_precondition(l_inv: torch.Tensor, r_inv: torch.Tensor,
                           g_w: torch.Tensor) -> torch.Tensor:
    """ΔW = R⁻¹ G L⁻¹ via two ``matmul`` launches (fp32).  Extra leading
    dims of ``g_w`` broadcast the 2-D factors."""
    lead = tuple(g_w.shape[:-2])
    g3 = g_w.reshape((-1,) + tuple(g_w.shape[-2:])).contiguous()
    t = matmul_cu(r_inv.contiguous(), g3)
    out = matmul_cu(t, l_inv.contiguous())
    return out.reshape(lead + tuple(out.shape[-2:]))


def fused_precondition(l_inv: torch.Tensor, r_inv: torch.Tensor,
                       g_w: torch.Tensor, *,
                       rescale: bool = True) -> torch.Tensor:
    """``fused_precond`` on one layer: factors (*stack, d, d), g_w (*stack,
    *extra, d_in, d_out) → fp32 ΔW, each stack slice rescaled alone, one
    launch over the stack.  Extra dims fall back to
    :func:`two_sided_precondition` (counted and warned), as in the
    reference."""
    return fused_precondition_banked(l_inv, r_inv, g_w, rescale=rescale)


def fused_precondition_banked(l_inv: torch.Tensor, r_inv: torch.Tensor,
                              g_w: torch.Tensor, *, rescale: bool = True,
                              l_scale: torch.Tensor = None,
                              r_scale: torch.Tensor = None) -> torch.Tensor:
    """l_inv (*lead, do, do), r_inv (*lead, di, di), g_w (*lead, *extra,
    di, do) → fp32 ΔW, one ``fused_precond`` launch per bank.
    ``l_scale`` / ``r_scale`` (``lead``-shaped fp32, both or neither) mark
    the factors as int8 codes."""
    lead = tuple(l_inv.shape[:-2])
    if tuple(r_inv.shape[:len(lead)]) != lead or \
            tuple(g_w.shape[:len(lead)]) != lead:
        raise ValueError(f"precondition bank shapes l {tuple(l_inv.shape)} "
                         f"r {tuple(r_inv.shape)} g {tuple(g_w.shape)}")
    if (l_scale is None) != (r_scale is None):
        raise ValueError("int8 factors need both l_scale and r_scale")
    if not lead:                                    # one slice
        one = (lambda s: None if s is None else s.reshape(1))
        return fused_precondition_banked(
            l_inv[None], r_inv[None], g_w[None], rescale=rescale,
            l_scale=one(l_scale), r_scale=one(r_scale))[0]
    if 0 in lead:                                   # empty owner slice
        return torch.zeros(g_w.shape, dtype=torch.float32,
                           device=g_w.device)
    lf = l_inv.reshape((-1,) + tuple(l_inv.shape[-2:]))
    rf = r_inv.reshape((-1,) + tuple(r_inv.shape[-2:]))
    gf = g_w.reshape((lf.shape[0],) + tuple(g_w.shape[len(lead):]))
    ls, rs = _flat_scale(l_scale, lead), _flat_scale(r_scale, lead)
    if gf.ndim > 3:
        # extra broadcast dims: the unfused path, a slice at a time, its
        # factors (int8 decoded first) broadcast as 2-D operands over the
        # slice's extra dims (no copy of a factor for each expert), and a
        # rescale spanning the whole slice
        _note_fallback("fused_precond", "extra_dims",
                       f"g_w shape {tuple(g_w.shape)}")
        g4 = gf.reshape((gf.shape[0], -1) + tuple(gf.shape[-2:]))
        delta = torch.empty(gf.shape, dtype=torch.float32, device=gf.device)

        def factor(f, sc, i):
            return f[i] if sc is None else dequant_ref(f[i], sc[i])
        for i in range(gf.shape[0]):
            delta[i] = two_sided_precondition(
                factor(lf, ls, i), factor(rf, rs, i), g4[i]).reshape(
                    delta.shape[1:])
        if rescale:
            delta = pc.rescale_update(delta, gf, n_lead=1)
        return delta.reshape(g_w.shape)
    out = pc.fused_precond(rf.contiguous(), gf.contiguous(), lf.contiguous(),
                           rescale=rescale, r_scale=rs, l_scale=ls)
    return out.reshape(g_w.shape)


# ----------------------------------------------------------------------- #
# Kernel plans (the reference's ``KernelPlan`` / ``bucket_kernel_plans``)
# ----------------------------------------------------------------------- #
_PLAN_FIELDS = ("rows", "tiles", "run", "runs", "lag")


@dataclass(frozen=True)
class KernelPlan:
    """One launch a bucket implies, as the card runs it.

    ``kernel`` is the launch count's name; ``dims`` the logical factor
    dims; ``rank`` the kernel instance (the window rank ``window_rank``
    padded up to one of ``rank1_smw.BLOCK_RANKS``; 1 for ``fused_smw``);
    ``batch`` the slices one launch covers.  SMW plans carry the C plan
    (``rows``, ``tiles``, ``run``, ``runs``, ``lag`` for ``resident``
    blocks) and ``bulk`` (False: J is loaded element by element); the
    precondition carries its GEMM ``core``.  ``scratch_bytes`` is the
    device scratch the C entry asks for (None for a precondition planned
    without its library).  ``per_step`` are the launches of every step,
    ``per_phase_step`` those the bucket's phase step adds; ``gemms`` the
    GEMMs a step runs on each core; ``fallback`` the counted fallback of
    the extra-dims route."""
    kernel: str
    dims: Tuple[int, ...]
    rank: int
    window_rank: int
    batch: int
    per_step: Mapping[str, int] = field(default_factory=dict)
    per_phase_step: Mapping[str, int] = field(default_factory=dict)
    gemms: Mapping[str, int] = field(default_factory=dict)
    plan: Optional[Mapping[str, int]] = None
    resident: Optional[int] = None
    bulk: Optional[bool] = None
    core: Optional[str] = None
    scratch_bytes: Optional[int] = None
    fallback: Optional[Tuple[str, str]] = None


def card_libraries() -> Dict[str, object]:
    """The kernel libraries the plans read on the card (built first if
    needed)."""
    return {"block_smw": build.library("block_smw"),
            "precond": build.library("precond")}


def _smw_plan(lib, d: int, batch: int, window: int, staleness: int,
              store: torch.dtype, resident: Optional[int]) -> KernelPlan:
    if lib is None:
        raise RuntimeError("an SMW plan reads the C plan of "
                           "csrc/smw_plan.cuh: pass its library")
    block = window > 1 or staleness > 0
    rank = next((k for k in rk.BLOCK_RANKS if k >= window), None) \
        if block else 1
    if rank is None:
        raise ValueError(f"no block SMW instance takes rank {window}")
    item = torch.empty((), dtype=store).element_size()
    if resident is None:
        if not hasattr(lib, "mkor_block_smw_resident"):
            raise RuntimeError("the blocks resident on the card come from "
                               "the kernel library; pass resident= to plan "
                               "with the plan header alone")
        out = ctypes.c_longlong()
        build.check(lib.mkor_block_smw_resident(
            d, batch, rank, build.DTYPE_CODES[store], 1,
            ctypes.byref(out)), "fused_block_smw")
        resident = int(out.value)
    res = (ctypes.c_int * 5)()
    lib.mkor_block_smw_plan(d, batch, rank, item, resident, res)
    name = ("fused_block_smw" if block else "fused_smw") + \
        ("[int8]" if store == torch.int8 else "")
    return KernelPlan(
        kernel=name, dims=(d,), rank=rank, window_rank=max(window, 1),
        batch=batch, per_phase_step={name: 1},
        plan=dict(zip(_PLAN_FIELDS, res)), resident=resident,
        bulk=bool(lib.mkor_block_smw_bulk(d, rank, item, 1)),
        scratch_bytes=4 * sum(rk.scratch_sizes(lib, d, batch, rank, item)))


def _precond_plan(lib, d_in: int, d_out: int, batch: int,
                  extra: Tuple[int, ...], store: torch.dtype,
                  grad_dtype: torch.dtype) -> KernelPlan:
    first = "matmul[int8 operand]" if store == torch.int8 else "matmul"
    if extra:
        # the extra-dims route: per slice, R⁻¹G over the slice's extra
        # dims (int8 factors decoded to fp32 first), then T L⁻¹ on the
        # fp32 intermediate; both 2-D factor operands broadcast
        e = 1
        for x in extra:
            e *= x
        f = torch.float32 if store == torch.int8 else store
        cores = Counter({mm.gemm_route(f, grad_dtype, d_in, d_out, 0, 0, 0,
                                       d_in * d_out): batch,
                         mm.gemm_route(torch.float32, f, d_out, d_out, 0, 0,
                                       d_in * d_out, 0): batch})
        return KernelPlan(
            kernel="fused_precond", dims=(d_in, d_out), rank=1,
            window_rank=1, batch=batch, per_step={"matmul": 2 * batch},
            gemms=dict(cores), fallback=("fused_precond", "extra_dims"))
    core = pc.precond_route(store, grad_dtype, store, d_in, d_out, 0, 0, 0)
    scratch = None if lib is None else 4 * pc.scratch_floats(
        lib, d_in, d_out, batch, tma=core == "wgmma",
        quant=store == torch.int8)
    name = "fused_precond" + ("[int8]" if store == torch.int8 else "")
    return KernelPlan(
        kernel=name, dims=(d_in, d_out), rank=1, window_rank=1, batch=batch,
        per_step={name: 1, first: 1}, gemms={core: 2}, core=core,
        scratch_bytes=scratch)


def bucket_kernel_plans(d_in: int, d_out: int, *, rank: int = 1,
                        factor_dtype="bfloat16", factor_quant: str = "none",
                        staleness: int = 0, batch: int = 1,
                        extra: Tuple[int, ...] = (),
                        grad_dtype: torch.dtype = torch.bfloat16,
                        libs: Optional[Mapping[str, object]] = None,
                        resident: Optional[int] = None
                        ) -> Tuple[KernelPlan, ...]:
    """Every kernel dispatch one factor bucket implies, in the reference's
    order: one SMW update a factor dim (d_in, then d_out), then the
    precondition over the (d_in, d_out) slice.  ``batch`` is the bucket's
    slices (one launch covers them all), ``extra`` its extra dims (then
    the precondition takes the counted extra-dims route), ``grad_dtype``
    the gradient's dtype.  ``libs``: ``"block_smw"`` (required: the C plan)
    and ``"precond"`` (the precondition's scratch); ``resident``: the
    blocks the card holds at once (default: asked of the kernel library)."""
    from repro_torch.core import stats as statlib
    libs = libs or {}
    store = statlib.factor_storage_dtype(factor_dtype, factor_quant)
    smw = tuple(_smw_plan(libs.get("block_smw"), d, batch, rank, staleness,
                          store, resident) for d in (d_in, d_out))
    return smw + (_precond_plan(libs.get("precond"), d_in, d_out, batch,
                                tuple(extra), store, grad_dtype),)


def grad_dtypes(params, manifest) -> Dict[str, torch.dtype]:
    """Each bucket's gradient dtype: its layers' weight dtype."""
    from repro_torch.core import stats as statlib
    return {b.bucket_id: statlib.tree_get(params, b.paths[0])["w"].dtype
            for b in manifest}


def manifest_kernel_plans(manifest, mcfg, grad_dtypes: Mapping[str, object],
                          libs=None, resident=None
                          ) -> Dict[str, Tuple[KernelPlan, ...]]:
    """:func:`bucket_kernel_plans` of every bucket of ``manifest`` under
    MKOR's config ``mcfg``; ``grad_dtypes``: each bucket's gradient
    dtype, by bucket id."""
    from repro_torch.core import stats as statlib
    return {b.bucket_id: bucket_kernel_plans(
        b.d_in, b.d_out, rank=mcfg.rank, factor_dtype=mcfg.factor_dtype,
        factor_quant=mcfg.factor_quant, staleness=mcfg.staleness,
        batch=statlib.bucket_slices(b), extra=b.extra,
        grad_dtype=grad_dtypes[b.bucket_id], libs=libs, resident=resident)
        for b in manifest}


def planned_counts(plans: Mapping[str, Tuple[KernelPlan, ...]],
                   phases: Mapping[str, int], inv_freq: int, steps: int,
                   start: int = 0):
    """The launches, GEMM cores and fallbacks that ``steps`` steps from
    count ``start`` make by the plans: every step's launches, and each
    bucket's phase-step launches at the counts ``c`` with ``c % inv_freq
    == phases[bucket]``.  Returns three dicts, as ``launch_counts``,
    ``gemm_core_counts`` and ``fallback_counts`` read them."""
    launches, cores, fallbacks = Counter(), Counter(), Counter()
    for bid, bucket_plans in plans.items():
        n_phase = sum((c % max(inv_freq, 1)) == phases[bid]
                      for c in range(start, start + steps))
        for p in bucket_plans:
            for k, v in p.per_step.items():
                launches[k] += v * steps
            for k, v in p.per_phase_step.items():
                launches[k] += v * n_phase
            for k, v in p.gemms.items():
                cores[k] += v * steps
            if p.fallback is not None:
                fallbacks[p.fallback] += steps
    return dict(launches), dict(cores), dict(fallbacks)
