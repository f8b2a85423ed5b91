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

There is no counterpart of the TPU plan (``KernelPlan``, ``_pick_block``
and the 12 MiB VMEM budget): the kernels mask ragged edges themselves, so
nothing is padded, and the fused precondition keeps its first product in
device memory rather than in on-chip scratch, so it has no size limit and
takes every 2-D slice.  Tile and shared-memory sizes live in the CUDA
sources alone (the wrapper asks the library for the one scratch size it
needs).  Only a gradient with extra broadcast dims (experts under shared
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

import warnings
from collections import Counter
from typing import Dict, Tuple

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
        # extra broadcast dims: the unfused path with the factors expanded
        # over them (int8 factors decoded first), and a rescale spanning
        # the whole slice
        _note_fallback("fused_precond", "extra_dims",
                       f"g_w shape {tuple(g_w.shape)}")
        n_e = gf[0, ..., 0, 0].numel()

        def expand(f, sc):
            f = f if sc is None else dequant_ref(f, sc)
            return f[:, None].expand((-1, n_e) + tuple(f.shape[-2:])) \
                .reshape((-1,) + tuple(f.shape[-2:]))
        delta = two_sided_precondition(expand(lf, ls), expand(rf, rs),
                                       gf.reshape((-1,) + tuple(
                                           gf.shape[-2:]))).reshape(gf.shape)
        if rescale:
            delta = pc.rescale_update(delta, gf, n_lead=1)
        return delta.reshape(g_w.shape)
    out = pc.fused_precond(rf.contiguous(), gf.contiguous(), lf.contiguous(),
                           rescale=rescale, r_scale=rs, l_scale=ls)
    return out.reshape(g_w.shape)
