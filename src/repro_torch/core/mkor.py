"""MKOR: Momentum-Enabled Kronecker-Factor-Based Optimizer Using Rank-1
Updates — the port of the single-process paths of ``repro/core/mkor.py``
(both factor layouts).

Per eligible 2-D layer with weight W (d_in, d_out), gradient G, rank-1
statistics ā = E[a] (d_in,) and ḡ = E[g] (d_out,):

  line 5/6  norm-based stabilizer:   if ‖F⁻¹‖∞ > ε:  F⁻¹ ← ζF⁻¹ + (1−ζ)I
  line 7/8  SM-based factor inversion (Eq. 5/6, O(d²)):
      L⁻¹ ← γL⁻¹ + (1−γ) / (γ²(1 + γ(1−γ) ḡᵀL⁻¹ḡ)) · (L⁻¹ḡ)(L⁻¹ḡ)ᵀ
      R⁻¹ ← (same with ā)
  line 9    precondition:            ΔW = R⁻¹ G L⁻¹
  line 10   rescale:                 ΔW ← ΔW · ‖G‖_F / ‖ΔW‖_F
  line 14   backend step (LAMB / momentum-SGD / ...)

Factors live in shape-bucketed *banks* (``layout="bank"``): every eligible
layer is grouped by ``(stack, extra, d_in, d_out)`` (core/stats.py) and
each bucket owns ``l_inv: (n_slots, *stack, d_out, d_out)`` and
``r_inv: (n_slots, *stack, d_in, d_in)``.  ``update`` runs stabilize →
SMW → precondition → rescale once per bucket over the whole bank.  With
``stagger`` the bucket at index i inverts on steps where
``count % inv_freq == i % inv_freq``; off-phase steps skip the inversion
(a Python branch on the host-side step count, where the reference uses
``lax.cond``).

Block rank-r (``rank > 1``, paper §4): every step pushes the layer's stat
vectors into an fp32 ring window of the last r steps
(``state["stat_windows"][bucket] = {"a", "g", "n"}``, core/stats.py), and
the bucket's phase step consumes the whole window with ONE block-Woodbury
update per bank side (:func:`smw_block_update`), then resets the per-slot
write count ``n``.

Overlap-hidden inversions (``staleness=1``): the inverse state is double
buffered.  ``precompute`` (the tick, run by the train step before the
forward pass) promotes each phase bucket's *pending* bank to *active* and
launches the next pending bank from the carried window (stats through
the previous step); ``update`` pushes this step's stats and
preconditions with the active bank only.  At rank 1 the window has one
row, so every staleness-1 run goes through the block update.  The launch
runs on the current stream; overlapping it on a side stream is later
work (ROADMAP).  ``update`` without ``precomputed=True`` runs the same tick
inline, so the two protocols are bit-equal.

int8 factor state (``factor_quant="int8"``, single process, bank layout):
every bank side, the pending ones included, is the triple (codes int8,
scale fp32 per slice ``(n_slots, *stack)``, error feedback fp32 of the
bank's shape), stored as ``{l_inv, l_scale, l_ef, r_inv, r_scale, r_ef}``;
the identity is codes 127·I at scale 1/127 with zero error feedback.  A
phase step runs, per side, the SMW or block update on the codes, then the
stabilizer on the fp32 result, then ``quant_requantize`` with the side's
error feedback -- the reverse of the bf16 order, so that the stabilizer
caps the scale before the codes are taken.  Windows are int8 rows with
per-row fp32 scales (``a_scale`` / ``g_scale``), decoded and then ordered
for the block update.  At staleness 1 the tick swaps the side triples and
launches on the promoted pending codes (the error feedback rides the
pending bank).  Preconditioning takes the codes and scales as they are.

``use_kernels=True`` (the reference's ``use_pallas``) routes the banked
SMW, the block update and the precondition through the hand-written CUDA
kernels (``kernels/ops.py``: one ``fused_smw`` or ``fused_block_smw``
launch per bucket side per phase step, one ``fused_precond`` launch per
bucket per step; their int8 variants read the codes and scales directly,
so no decoded bank is made); otherwise the same math runs as plain
batched PyTorch.  Either way ``update`` and ``precompute`` are
functional: the state passed in is not modified (the bf16 and fp32 SMW
kernels update the freshly stabilized copy of a bank in place, which saves
a second bank-sized buffer).

MKOR-H (``hybrid=True``, :func:`mkor_h`, paper §3.2): every step updates
a fast and a slow EMA of the loss; once ``count > hybrid_min_steps`` and
the relative improvement rate (slow − fast)/|slow| drops below
``hybrid_threshold``, the switch ``hybrid["on"]`` turns off for good and
the step falls back to the backend on the raw gradients.  The switch is a
0-d device bool, so the step cannot branch on it without a device read.
It takes the host's *view* of the carried switch instead
(``GradientTransformation.observe`` reads it; the caller passes it back as
``view=`` to ``plan``, ``precompute`` and ``update``):

* view on, or no view (the switch may be on): the whole second-order step
  runs and is made exact by masked selects on the device switch, as the
  reference's ``where(so_on, ...)``: each bank leaf (the int8 triple
  together) new against old on phase steps, the window count's reset,
  and the preconditioned gradient against the raw one.  The staleness-1
  tick is gated by the CARRIED switch (promote, launch and count reset
  selected), the fallback by the updated one.  The per-step host values
  the switch reads (``count == 0``, ``count > hybrid_min_steps``) reach
  it as 0/1 float32 scalars from ``plan`` (``hybrid_first``,
  ``hybrid_late``), never as Python bools, so a CUDA graph freezes none.
* view off (the host has seen the switch off; it is sticky): no
  stabilize, SMW, block update, precondition or tick, so no kernel
  launch.  The step is the backend on the probe-zeroed gradients, the
  EMAs and the window pushes, so the state stays the reference's.  With
  the health sentinel on, the precondition still runs (its ε check feeds
  the sentinel's state, as in the reference); only the inversions stop.

The numerical-health sentinel (``health=True``, the reference's DESIGN.md
§14) keeps ``state["health"][bucket] = {"cooldown", "trips"}`` (0-d int32
on the parameters' device).  Every step, per bucket: *detect* -- any
non-finite value in the banks (both buffers at staleness 1), the
bucket's gradients, its stat vectors and its windows, or a bank whose
max |x| exceeds ``health_norm_factor · stabilizer_threshold`` (one
NaN-propagating max |x| a tensor gives both, with no tensor-sized
temporary); the stat vectors are zeroed where not finite before any push
or inversion.  *Gate* -- the reference folds ``(cooldown == 0) &
~pre_bad`` into its ``lax.cond``; the port keeps the host phase branch
(it keys the CUDA graphs), runs the inversion on a phase step, and
selects new against old with that 0-d device bool (and MKOR-H's switch):
each bank leaf, the window count's reset, the tick's promote and launch,
and the block update's pivot, masked to +inf where the gate held the old
banks (the reference never computes it there).  *Trip* -- the detection
signals, a bank that is non-finite or hot after the inversion, or a
pivot below ``health_pivot_tol`` (rank > 1 at staleness 0; the rank-1
SMW exports none) reset the bucket's banks to the identity (int8: codes
127·I, scale 1/127 and zero error feedback together) before the
precondition of the cleaned gradient; a slice whose update vanished
while its gradient did not, or a non-finite update, trips too and resets
again; windows and counts are zeroed on a trip (both buffers reset at
staleness 1).  The cooldown is K = ``health_cooldown`` on a trip and
counts down on the bucket's phase steps (at staleness 1 the tick neither
promotes nor launches while it is not 0).  Nothing in the step reads a
health leaf on the host.

The per-layer layout (``layout="per_layer"``, the reference's numerical
oracle for the banks) keeps ``state["factors"][path_str] = {"l_inv",
"r_inv"}`` of shape ``(*stack, d, d)`` a layer, windows a layer with a
0-d count ``n``, and ``pending_factors`` at staleness 1.  It runs the
bank path's schedule (each layer takes its bucket's phase), stabilizer,
updates and MKOR-H selects one layer at a time; with ``use_kernels`` it
goes through the per-layer entries of ``kernels/ops.py``, one launch a
layer side over its stack.  It takes rank ≥ 1, staleness 0 or 1, stagger
on or off, both variants, MKOR-H and factor storage ``none`` / ``bf16``.

Data parallel (``dist``, the reference's owner-sharded inversions):
under the dist step of ``training/loop.py`` every worker holds the whole
state and sees the same mean gradients and stats, so everything runs
replicated except the bank inversions.  With ``dist`` of world > 1, each
bank side's stabilize and SMW (rank 1), or block update (rank > 1 and the
staleness-1 tick), runs on this worker's chunk of the bank's flattened
(slot x stack) slices only (``sharding.collectives.owner_sharded_map``),
through the kernels with ``use_kernels``; the updated
slices are gathered in worker order.  The chunk's zero padding is inert
(a zero factor with a zero vector; a window count of 0).  int8: the owner
stabilizes its fp32 chunk and ``quant_encode``s it at the wire (no error
feedback), so the gathered codes are the stored codes and every worker's
error feedback stays zero.  The sentinel derives its trips from
replicated data only, and the block update exports no pivot under dist.
``live`` (a liveness mask) re-splits the chunks over the live workers.
At world 1 the single-device branches run.  The per-layer layout runs
replicated, as the reference's does.

Ported: both layouts, rank ≥ 1, staleness 0 or 1, stagger on or off,
``variant`` ``paper`` and ``exact_smw``, factor storage ``none`` /
``bf16`` / ``int8`` (int8 in the bank layout), MKOR-H, the health
sentinel (bank layout), ``dist`` and ``live``.  int8 or health with the
per-layer layout raises ``ValueError``, as in the reference.
``MKORConfig`` keeps every field of the reference with the same default,
with ``use_pallas`` renamed ``use_kernels`` and the Pallas-only
``interpret`` dropped.

The state is the reference's tree, key for key, with the reference's
dtypes and shapes: ``count``, ``factor_banks`` (per-layer: ``factors``),
``stat_windows`` (rank > 1 or staleness 1), ``pending_banks`` (per-layer:
``pending_factors``; staleness 1), ``health`` (with
``health=True``), ``hybrid`` (MKOR-H's
switch, ``{"on": bool, "ema_fast": fp32, "ema_slow": fp32}`` scalars on
the parameters' device, carried unchanged with ``hybrid=False``) and
``backend``, so
``interop.opt_state_from_numpy`` carries a JAX state across whole.
``count`` is a 0-d int32 tensor kept on the CPU whatever device the banks
are on: the inversion schedule is a host branch on it, and a CUDA count
would add a device-to-host sync to every step of a host-bound loop.  With
stagger each bucket's phase is fixed, so which buckets invert on a step
depends on ``count % inv_freq`` alone: ``plan(state)`` gives that residue
as the update's branch key (with the backend's per-step scalars), and the
chunk runner (``training/loop.py``) captures one CUDA graph per residue
and advances the counts on the host itself.  With ``hybrid=True`` the
plan also takes the view: the key is ``(count % inv_freq, backend key)``
while the switch may be on and ``(None, backend key)`` once the view is
off (the step then has no phase branch).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import (GradientTransformation,
                                        device_scalars, step_count)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.precond import rescale_update  # Alg. 1 line 10
from repro_torch.kernels.rank1_smw import fused_block_smw_plain
from repro_torch.sharding import collectives
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class MKORConfig:
    gamma: float = 0.9                 # factor momentum (Eqs. 3-6)
    inv_freq: int = 10                 # update factors every f steps
    stabilizer_threshold: float = 50.0  # ε: ‖F⁻¹‖∞ trigger (lines 5-6)
    zeta: float = 0.95                 # blend-toward-identity strength
    factor_dtype: str = "bfloat16"     # paper: half precision
    factor_quant: str = "none"         # "none" | "bf16" | "int8"
    max_factor_dim: int = 32768        # skip layers with huge factor dims
    min_factor_dim: int = 4
    rescale: bool = True               # line 10 gradient rescaling
    exclude: Tuple[str, ...] = ("embed", "lm_head")
    variant: str = "paper"             # "paper" | "exact_smw"
    rank: int = 1
    use_kernels: bool = False          # hand-written CUDA kernels (kernels/)
    layout: str = "bank"               # "bank" (bucketed) | "per_layer"
    stagger: bool = True
    staleness: int = 0
    health: bool = False
    health_cooldown: int = 2
    health_norm_factor: float = 4.0
    health_pivot_tol: float = 1e-12
    dist: Optional[Tuple[Tuple[str, int], ...]] = None
    live: Optional[Tuple[bool, ...]] = None
    hybrid: bool = False
    hybrid_ema_fast: float = 0.9
    hybrid_ema_slow: float = 0.99
    hybrid_threshold: float = 0.02
    hybrid_min_steps: int = 50


def _hybrid_init(device) -> Dict[str, torch.Tensor]:
    """MKOR-H's switch state, as the reference's ``_hybrid_init``."""
    return {"on": torch.ones((), dtype=torch.bool, device=device),
            "ema_fast": torch.zeros((), dtype=torch.float32, device=device),
            "ema_slow": torch.zeros((), dtype=torch.float32, device=device)}


def _hybrid_scalars(count: int, cfg: "MKORConfig") -> Dict[str, np.float32]:
    """The switch's per-step host values as 0/1 float32 scalars."""
    return {"hybrid_first": np.float32(count == 0),
            "hybrid_late": np.float32(count > cfg.hybrid_min_steps)}


def _hybrid_update(h: Dict[str, torch.Tensor], loss: torch.Tensor,
                   first: torch.Tensor, late: torch.Tensor,
                   cfg: "MKORConfig") -> Dict[str, torch.Tensor]:
    """MKOR-H (§3.2): the sticky switch to first order once the relative
    loss-improvement rate stalls (the reference's ``_hybrid_update``;
    ``first`` and ``late`` are ``count == 0`` and ``count >
    hybrid_min_steps`` as 0-d float32 0/1)."""
    loss = loss.float()
    first = first > 0
    fast = torch.where(first, loss,
                       cfg.hybrid_ema_fast * h["ema_fast"]
                       + (1 - cfg.hybrid_ema_fast) * loss)
    slow = torch.where(first, loss,
                       cfg.hybrid_ema_slow * h["ema_slow"]
                       + (1 - cfg.hybrid_ema_slow) * loss)
    rate = (slow - fast) / torch.clamp(torch.abs(slow), min=1e-12)
    stalled = (late > 0) & (rate < cfg.hybrid_threshold)
    return {"on": h["on"] & ~stalled, "ema_fast": fast, "ema_slow": slow}


def _select(on: Optional[torch.Tensor], new, old):
    """``where(on, new, old)`` leaf by leaf over two equal tuples of
    tensors; ``new`` itself when there is no switch (``on`` None)."""
    if on is None:
        return new
    return tuple(torch.where(on, n, o) for n, o in zip(new, old))


# the quantized identity's scale: codes 127·I decode to exactly I·(127/127)
_QUANT_ID_SCALE = 1.0 / statlib.INT8_QMAX


# ----------------------------------------------------------------------- #
# Health sentinel primitives (the reference's ``_any_nonfinite`` ...
# ``_quant_side_maxabs``).  Each signal is a 0-d device bool from
# reductions that keep no tensor-sized temporary: max|x| is NaN when x
# holds a NaN and inf when it holds an inf, so it alone says whether every
# element is finite, and with the hot threshold whether the bank is hot.
# ----------------------------------------------------------------------- #
def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a 0-d fp32 tensor, NaN-propagating (0 for an empty x)."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.linalg.vector_norm(x, float("inf")).float()


def _any_nonfinite(tensors) -> torch.Tensor:
    """0-d bool: any non-finite element anywhere in ``tensors``."""
    return ~torch.isfinite(torch.stack([_absmax(t) for t in tensors])).all()


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    """Non-finite elements replaced by 0 (the identity on clean data)."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _slice_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-slice ‖x‖ over the trailing matrix dims, from fp32 squares: 0
    exactly where the reference's fp32 Σx² is 0 (every square rounds to
    0), positive where it is positive."""
    return torch.linalg.vector_norm(x, 2, dim=(-2, -1), dtype=torch.float32)


def _identity_like(bank: torch.Tensor) -> torch.Tensor:
    """Identity factors broadcast to a bank's shape (bf16 / fp32), or the
    int8 identity codes 127·I for an int8 bank: the quarantine reset."""
    eye = torch.eye(bank.shape[-1], dtype=bank.dtype, device=bank.device)
    if bank.dtype == torch.int8:
        eye.mul_(int(statlib.INT8_QMAX))
    return eye.expand(bank.shape)


def _quant_side_maxabs(side) -> torch.Tensor:
    """max |decode| of an int8 bank side, scale · max|codes| per slice,
    with no decoded bank made."""
    q, sc = side[0], side[1]
    lo, hi = torch.aminmax(q.reshape(tuple(q.shape[:-2]) + (-1,)), dim=-1)
    return torch.amax(sc * torch.maximum(hi.float(), lo.float().abs()))


def _check_supported(cfg: MKORConfig) -> None:
    if cfg.layout not in ("bank", "per_layer"):
        raise ValueError(f"unknown layout {cfg.layout!r}")
    if cfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {cfg.rank}")
    if cfg.staleness not in (0, 1):
        raise ValueError(f"staleness must be 0 (synchronous) or 1 "
                         f"(double-buffered), got {cfg.staleness}")
    if cfg.health and cfg.layout != "bank":
        raise ValueError(
            "health=True requires layout='bank': the sentinel state "
            "machine is per bucket")
    if cfg.health and cfg.health_cooldown < 1:
        raise ValueError(
            f"health_cooldown must be >= 1, got {cfg.health_cooldown}")
    if cfg.factor_quant not in statlib.FACTOR_QUANT_MODES:
        raise ValueError(
            f"factor_quant must be one of {statlib.FACTOR_QUANT_MODES}, "
            f"got {cfg.factor_quant!r}")
    if cfg.factor_quant == "int8" and cfg.layout != "bank":
        raise ValueError(
            "factor_quant='int8' requires layout='bank': the scale / "
            "error-feedback state is per bucket")
    if cfg.variant not in ("paper", "exact_smw"):
        raise ValueError(f"unknown variant {cfg.variant!r}")


# ----------------------------------------------------------------------- #
# Core math (single factor, single layer), as in the reference
# ----------------------------------------------------------------------- #
def smw_rank1_update(j_inv: torch.Tensor, v: torch.Tensor, gamma: float,
                     variant: str = "paper") -> torch.Tensor:
    """One rank-1 SM-based inverse update (paper Eq. 5/6), O(d²), for a
    factor (..., d, d) and its statistic (..., d); leading dims batch."""
    jf, vf = j_inv.float(), v.float()
    u = torch.matmul(jf, vf[..., None])[..., 0]
    s = torch.sum(vf * u, dim=-1)[..., None, None]         # ḡᵀ J⁻¹ ḡ (fp32)
    uu = u[..., :, None] * u[..., None, :]
    if variant == "paper":
        coef = (1.0 - gamma) / (gamma ** 2 * (1.0 + gamma * (1.0 - gamma)
                                              * s))
        new = gamma * jf + coef * uu
    elif variant == "exact_smw":
        # (γJ + (1-γ)vvᵀ)⁻¹ = (1/γ)(J⁻¹ − (1−γ) uuᵀ / (γ + (1−γ)s))
        new = (jf - (1.0 - gamma) * uu / (gamma + (1.0 - gamma) * s)) / gamma
    else:
        raise ValueError(variant)
    return new.to(j_inv.dtype)


def block_weights(n_valid, rank: int, gamma: float, device=None):
    """Per-row √weights and base scale of the block rank-r update.

    Chaining m = min(n_valid, rank) rank-1 EMA updates composes to

        J_m = γ^m J_0 + Σ_{i<m} (1-γ) γ^(m-1-i) v_i v_iᵀ   (i=0 oldest)

    so the block update folds row i of the window by √w_i with
    w_i = (1-γ)γ^(m-1-i) and scales the base factor by γ^m.  Rows at or
    beyond ``n_valid`` get weight zero, and n_valid = 0 makes the update an
    exact no-op (γ⁰ = 1, Ṽ = 0).  ``n_valid`` is an int or an int tensor
    of any shape: returns ``(sqrt_w, gm)`` of shapes ``n.shape + (rank,)``
    and ``n.shape``, in fp32."""
    n = torch.as_tensor(n_valid, device=device)
    i = torch.arange(rank, dtype=torch.float32, device=n.device)
    m = torch.clamp(n.to(torch.float32), max=float(rank))
    mm = m[..., None]
    w = torch.where(i < mm, (1.0 - gamma) * gamma ** torch.clamp(
        mm - 1.0 - i, min=0.0), torch.zeros((), device=n.device))
    return torch.sqrt(w), gamma ** m


def smw_block_update(j_inv: torch.Tensor, v: torch.Tensor, gamma: float,
                     variant: str = "paper", n_valid=None,
                     with_pivot: bool = False):
    """Block rank-r Woodbury inverse update (paper §4), O(r·d² + r³).

    j_inv (*lead, d, d); v (*lead, r, d) window rows, oldest first;
    n_valid broadcastable to ``lead`` (None: a full window).  Leading dims
    batch.

      exact_smw:  (γ^m J + ṼᵀṼ)⁻¹
                  = (1/γ^m)(J⁻¹ − J⁻¹Ṽᵀ (γ^m I_r + ṼJ⁻¹Ṽᵀ)⁻¹ ṼJ⁻¹),
                  exactly m chained rank-1 exact SMW updates;
      paper:      J⁻¹ ← γ^m J⁻¹ + J⁻¹Ṽᵀ (γ^{2m}(I_r + γ^m S))⁻¹ ṼJ⁻¹,
                  S = ṼJ⁻¹Ṽᵀ, the PD-preserving generalization of Eq. 5/6
                  (at r = 1 it is Eq. 5/6 exactly).

    n_valid = 0 returns the factor unchanged.  ``with_pivot=True`` also
    returns, per slice, the smallest squared Cholesky diagonal entry of
    the r×r mid matrix (its smallest Gauss–Jordan pivot; NaN when it is not
    positive definite)."""
    r = v.shape[-2]
    sq, gm = block_weights(r if n_valid is None else n_valid, r, gamma,
                           device=j_inv.device)
    vt = v.float() * sq[..., None]
    return fused_block_smw_plain(j_inv, vt, gm, variant=variant,
                                 with_pivot=with_pivot)


def stabilize(j_inv: torch.Tensor, threshold: float,
              zeta: float) -> torch.Tensor:
    """Norm-based stabilizer (lines 5-6 / Eqs. 7-8) plus the norm cap of the
    reference, per (d, d) slice of any leading dims."""
    jf = j_inv.float()
    norm = torch.amax(torch.abs(jf), dim=(-2, -1), keepdim=True)
    eye = torch.eye(j_inv.shape[-1], dtype=torch.float32,
                    device=j_inv.device)
    blended = zeta * jf + (1.0 - zeta) * eye
    out = torch.where(norm > threshold, blended, jf)
    n2 = torch.amax(torch.abs(out), dim=(-2, -1), keepdim=True)
    out = torch.where(n2 > threshold,
                      out * (threshold / torch.clamp(n2, min=1e-30)), out)
    return out.to(j_inv.dtype)


def precondition(l_inv: torch.Tensor, r_inv: torch.Tensor,
                 g_w: torch.Tensor) -> torch.Tensor:
    """ΔW = R⁻¹ G L⁻¹ in fp32.  Factors (*lead, d, d) and g_w (*lead,
    *extra, d_in, d_out): the factors broadcast over the extra dims
    (experts under shared factors), as in the reference."""
    n_extra = g_w.ndim - r_inv.ndim

    def bcast(f):
        return f.float().reshape(tuple(f.shape[:-2]) + (1,) * n_extra
                                 + tuple(f.shape[-2:]))
    return torch.matmul(torch.matmul(bcast(r_inv), g_w.float()),
                        bcast(l_inv))


# ----------------------------------------------------------------------- #
# The optimizer
# ----------------------------------------------------------------------- #
def _eligible(path, dense, cfg: MKORConfig) -> bool:
    _, _, d_in, d_out = statlib.layer_dims(dense)
    if any(str(p) in cfg.exclude for p in path):
        return False
    lo, hi = cfg.min_factor_dim, cfg.max_factor_dim
    return lo <= d_in <= hi and lo <= d_out <= hi


def _init_factors(dense, cfg: MKORConfig) -> Dict[str, torch.Tensor]:
    """One layer's identity factors ``(*stack, d, d)`` at the storage
    dtype, on the layer's device (the per-layer layout)."""
    stack, _, d_in, d_out = statlib.layer_dims(dense)
    fd = statlib.factor_storage_dtype(cfg.factor_dtype, cfg.factor_quant)
    dev = dense["w"].device

    def eye(d):
        return torch.eye(d, dtype=fd, device=dev).expand(
            stack + (d, d)).contiguous()
    return {"l_inv": eye(d_out), "r_inv": eye(d_in)}


def manifest_for(tree, cfg: MKORConfig) -> statlib.BucketManifest:
    return statlib.build_bucket_manifest(
        tree, lambda path, dense: _eligible(path, dense, cfg))


def mkor(backend: GradientTransformation,
         cfg: MKORConfig = MKORConfig()) -> GradientTransformation:
    """MKOR wrapping a first-order ``backend`` (Alg. 1)."""
    _check_supported(cfg)
    # owner-sharded inversions: the reference's dist_on
    dist_on = cfg.dist is not None and collectives.world_size(cfg.dist) > 1
    per_layer = cfg.layout == "per_layer"
    quant8 = cfg.factor_quant == "int8"
    store_dtype = statlib.factor_storage_dtype(cfg.factor_dtype,
                                               cfg.factor_quant)
    win_dtype = torch.float32 if cfg.factor_quant == "none" else store_dtype
    # rank-1 staleness-1 still rides the block update (a 1-row window);
    # rank 1 at staleness 0 keeps the rank-1 state tree
    needs_window = cfg.rank > 1 or cfg.staleness > 0
    # a bank side is a tuple of the bank's entries: (inverse,), or (codes,
    # scale, error feedback) with int8 storage
    side_keys = ((("l_inv", "l_scale", "l_ef"), ("r_inv", "r_scale", "r_ef"))
                 if quant8 else (("l_inv",), ("r_inv",)))

    def unpack(bank):
        return tuple(tuple(bank[k] for k in keys) for keys in side_keys)

    def pack(l_side, r_side):
        return {k: t for keys, side in zip(side_keys, (l_side, r_side))
                for k, t in zip(keys, side)}

    def stab(bank):
        return stabilize(bank, cfg.stabilizer_threshold, cfg.zeta)

    def decode(side):
        return statlib.quant_decode(side[0], side[1])

    def owner_map(fn, j, *rest, quant=False):
        """``fn`` on this worker's chunk of the bank ``j`` (*lead, d, d) and
        of the lead-aligned ``rest``, the lead dims flattened, and the
        chunks gathered back to ``j``'s shape; with ``quant``, ``fn``
        returns int8 codes and scales, gathered to ``j``'s and ``lead``."""
        lead = tuple(j.shape[:-2])
        n = 1
        for d in lead:
            n *= d
        flat = [x.reshape((n,) + tuple(x.shape[len(lead):]))
                for x in (j,) + rest]
        if quant:
            q, sc = collectives.owner_sharded_map_quant(
                fn, flat, cfg.dist, n, cfg.live)
            return q.reshape(j.shape), sc.reshape(lead)
        return collectives.owner_sharded_map(
            fn, flat, cfg.dist, n, cfg.live).reshape(j.shape)

    def rank1_bank(j, v, scale=None):
        """Stabilize, then the rank-1 SMW of bank ``j`` (*lead, d, d) with
        stats ``v`` (*lead, d); int8 codes ``j`` with their ``scale``: the
        SMW of the codes (fp32 out), then the stabilizer."""
        if scale is not None:
            if cfg.use_kernels:
                f = kops.smw_rank1_update_banked(
                    j, v, gamma=cfg.gamma, variant=cfg.variant, scale=scale)
            else:
                f = smw_rank1_update(statlib.quant_decode(j, scale), v,
                                     cfg.gamma, cfg.variant)
            return stab(f)
        jb = stab(j)
        if cfg.use_kernels:
            return kops.smw_rank1_update_banked(
                jb, v, gamma=cfg.gamma, variant=cfg.variant, out=jb)
        return smw_rank1_update(jb, v, cfg.gamma, cfg.variant)

    def side_rank1(side, v):
        """Rank-1 SMW on one bank side (*lead, d, d) with stats (*lead,
        d).  bf16 / fp32: stabilize, then update.  int8: update the codes
        (fp32 out), stabilize, requantize with the error feedback, or under
        dist encode the owned chunk at the wire (the error feedback stays
        zero)."""
        if not quant8:
            return ((owner_map(rank1_bank, side[0], v) if dist_on
                     else rank1_bank(side[0], v)),)
        q, sc, ef = side
        if not dist_on:
            return statlib.quant_requantize(rank1_bank(q, v, sc), ef)
        codes, scales = owner_map(
            lambda qc, vc, scc: statlib.quant_encode(rank1_bank(qc, vc, scc)),
            q, v, sc, quant=True)
        return codes, scales, ef

    def block_update(j, v_ord, cnt, with_pivot, **kw):
        """The block update of bank (or codes) ``j``, through the kernel
        or the plain route; with ``with_pivot`` also the smallest pivot
        over the bank (a 0-d fp32 tensor)."""
        if cfg.use_kernels:
            return kops.smw_block_update_banked(
                j, v_ord, cnt, gamma=cfg.gamma, variant=cfg.variant,
                with_pivot=with_pivot, **kw)
        if "scale" in kw:
            j = statlib.quant_decode(j, kw["scale"])
        res = smw_block_update(j, v_ord, cfg.gamma, cfg.variant,
                               n_valid=cnt, with_pivot=with_pivot)
        return (res[0], torch.amin(res[1])) if with_pivot else res

    def block_bank(j, v_ord, cnt, scale=None, with_pivot=False):
        """One block update of bank ``j`` (*lead, d, d) from the ordered
        window rows ``v_ord`` (*lead, r, d) with fill counts ``cnt``
        (``lead``), in the order of :func:`rank1_bank`.  Returns the bank
        and, with ``with_pivot``, its smallest pivot (else None)."""
        if scale is None:
            j = stab(j)
            kw = {"out": j} if cfg.use_kernels else {}
        else:
            kw = {"scale": scale}
        res = block_update(j, v_ord, cnt, with_pivot, **kw)
        f, piv = res if with_pivot else (res, None)
        return (f if scale is None else stab(f)), piv

    def side_block(side, v_ord, cnt, with_pivot=False):
        """One block update of a bank side, as :func:`side_rank1` orders
        it.  Returns the new side and, with ``with_pivot`` (never under
        dist), the bank's smallest pivot (else None)."""
        if not dist_on:
            if not quant8:
                f, piv = block_bank(side[0], v_ord, cnt, None, with_pivot)
                return (f,), piv
            f, piv = block_bank(side[0], v_ord, cnt, side[1], with_pivot)
            return statlib.quant_requantize(f, side[2]), piv
        if not quant8:
            return (owner_map(lambda jc, vc, cc: block_bank(jc, vc, cc)[0],
                              side[0], v_ord, cnt),), None
        q, sc, ef = side
        codes, scales = owner_map(
            lambda qc, vc, cc, scc: statlib.quant_encode(
                block_bank(qc, vc, cc, scc)[0]),
            q, v_ord, cnt, sc, quant=True)
        return (codes, scales, ef), None

    def window_rows(win, name, cnt):
        """The fp32 (or stored-dtype) rows of window ``name`` ("a" or
        "g"), decoded first when int8, then ordered oldest-first."""
        rows = statlib.window_decode(win[name], win[name + "_scale"]) \
            if quant8 else win[name]
        return statlib.window_ordered(rows, cnt)

    def banked_precond(l_side, r_side, gw, n_lead):
        if cfg.use_kernels:
            scales = dict(l_scale=l_side[1], r_scale=r_side[1]) \
                if quant8 else {}
            delta = kops.fused_precondition_banked(
                l_side[0], r_side[0], gw, rescale=cfg.rescale, **scales)
        else:
            l_bank, r_bank = (decode(l_side), decode(r_side)) if quant8 \
                else (l_side[0], r_side[0])
            delta = precondition(l_bank, r_bank, gw)
            if cfg.rescale:
                delta = rescale_update(delta, gw, n_lead)
        return delta.to(gw.dtype)

    def init_per_layer(params):
        """The per-layer layout's factor state: ``factors`` keyed by path
        string, each layer's windows with a 0-d count ``n`` (rank > 1 or
        staleness 1), and distinct ``pending_factors`` at staleness 1."""
        factors, windows = {}, {}
        for path in statlib.iter_dense_layers(params):
            dense = statlib.tree_get(params, path)
            if not _eligible(path, dense, cfg):
                continue
            key = statlib.path_str(path)
            factors[key] = _init_factors(dense, cfg)
            if needs_window:
                stack, _, d_in, d_out = statlib.layer_dims(dense)
                dev = dense["w"].device
                windows[key] = {
                    k: torch.zeros(stack + (cfg.rank, d), dtype=win_dtype,
                                   device=dev)
                    for k, d in (("a", d_in), ("g", d_out))}
                windows[key]["n"] = torch.zeros((), dtype=torch.int32,
                                                device=dev)
        state = {"count": step_count(), "factors": factors}
        if needs_window:
            state["stat_windows"] = windows
        if cfg.staleness:
            state["pending_factors"] = {
                key: {k: t.clone() for k, t in fac.items()}
                for key, fac in factors.items()}
        return state

    def init_banks(params):
        banks, windows = {}, {}
        for b in manifest_for(params, cfg):
            shape = (b.n_slots,) + b.stack
            dev = statlib.tree_get(params, b.paths[0])["w"].device

            def eye(d, dtype):
                return torch.eye(d, dtype=dtype, device=dev).expand(
                    shape + (d, d)).contiguous()

            def side(d):
                if not quant8:
                    return (eye(d, store_dtype),)
                return (eye(d, torch.int8).mul_(int(statlib.INT8_QMAX)),
                        torch.full(shape, _QUANT_ID_SCALE,
                                   dtype=torch.float32, device=dev),
                        torch.zeros(shape + (d, d), dtype=torch.float32,
                                    device=dev))

            def window(d):
                return torch.zeros(shape + (cfg.rank, d), dtype=win_dtype,
                                   device=dev)

            banks[b.bucket_id] = pack(side(b.d_out), side(b.d_in))
            if needs_window:
                win = {"a": window(b.d_in), "g": window(b.d_out),
                       "n": torch.zeros((b.n_slots,), dtype=torch.int32,
                                        device=dev)}
                if quant8:
                    # per-row scales: a push encodes only its own row
                    for k in ("a_scale", "g_scale"):
                        win[k] = torch.zeros(shape + (cfg.rank,),
                                             dtype=torch.float32, device=dev)
                windows[b.bucket_id] = win
        state = {"count": step_count(), "factor_banks": banks}
        if needs_window:
            state["stat_windows"] = windows
        if cfg.staleness:
            # distinct buffers, not views of the active banks
            state["pending_banks"] = {
                bid: {k: t.clone() for k, t in bank.items()}
                for bid, bank in banks.items()}
        dev = tree_leaves(params)[0].device
        if cfg.health:
            # per bucket: phase steps of quarantine left, and trips so far
            state["health"] = {
                b.bucket_id: {k: torch.zeros((), dtype=torch.int32,
                                             device=dev)
                              for k in ("cooldown", "trips")}
                for b in manifest_for(params, cfg)}
        return state

    def init(params):
        state = init_per_layer(params) if per_layer else init_banks(params)
        state["hybrid"] = _hybrid_init(tree_leaves(params)[0].device)
        state["backend"] = backend.init(params)
        return state

    def bucket_inputs(bucket, grads, stats):
        """Gradients of the bucket's slots, the slots that have stats this
        step, their stacked ḡ and ā (fp32), and the stat vectors of the
        other slots (which the sentinel scans too)."""
        g_ws, g_vecs, a_vecs = [], [], []
        for path in bucket.paths:
            g_ws.append(statlib.tree_get(grads, path)["w"])
            g_vecs.append(statlib.get_g_vec(grads, path))
            a_vecs.append(statlib.get_a_vec(stats, path)
                          if stats is not None else None)
        slots = [i for i, (av, gv) in enumerate(zip(a_vecs, g_vecs))
                 if av is not None and gv is not None]
        extra = [v for i, pair in enumerate(zip(g_vecs, a_vecs))
                 if i not in slots for v in pair if v is not None]
        if not slots:
            return g_ws, slots, None, None, extra
        gv = torch.stack([g_vecs[i] for i in slots]).float()
        av = torch.stack([a_vecs[i] for i in slots]).float()
        return g_ws, slots, gv, av, extra

    def slot_access(bucket, slots, device):
        """(take, put) over the bank dim for ``slots``: the identity when
        every slot has stats, else index_select / index_copy."""
        if len(slots) == bucket.n_slots:
            return (lambda x: x), (lambda full, sub: sub)
        idx = torch.tensor(slots, device=device)
        return ((lambda x: x.index_select(0, idx)),
                (lambda full, sub: full.index_copy(0, idx, sub)))

    def push_windows(bucket, win, slots, gv, av):
        """Push this step's stats of ``slots`` into the bucket's windows.
        Returns the window entries of those slots after the push (``n``
        counted up) and the ``(take, put)`` over the slot dim."""
        take, put = slot_access(bucket, slots, win["n"].device)
        cnt = take(win["n"])
        cnt_b = cnt.reshape(cnt.shape + (1,) * len(bucket.stack))
        sub = {"n": cnt + 1}
        for name, vec in (("a", av), ("g", gv)):
            if quant8:
                sub[name], sub[name + "_scale"] = statlib.window_push_quant(
                    take(win[name]), take(win[name + "_scale"]), cnt_b, vec)
            else:
                sub[name] = statlib.window_push(take(win[name]), cnt_b, vec)
        return sub, take, put

    def lead_counts(cnt, bank):
        """Per-slot counts broadcast over the stack dims of ``bank``."""
        ns = bank.ndim - 3
        return cnt.reshape(cnt.shape + (1,) * ns).expand(
            bank.shape[:ns + 1])

    def block_sides(l_side, r_side, win, cnt, with_pivot=False):
        """Both sides' block updates from window ``win`` (ḡ rows update L,
        ā rows R) with per-slot fill counts ``cnt``; with ``with_pivot``
        also the smallest pivot of the two (else None)."""
        c_full = lead_counts(cnt, l_side[0])
        l_new, pl = side_block(l_side, window_rows(win, "g", c_full),
                               c_full, with_pivot)
        r_new, pr = side_block(r_side, window_rows(win, "a", c_full),
                               c_full, with_pivot)
        return l_new, r_new, (torch.minimum(pl, pr) if with_pivot else None)

    def write_delta(out, bucket, delta, gw, so_on):
        """The bucket's update into ``out``: ``delta``, or with MKOR-H's
        switch ``so_on`` off, the gradient ``gw``."""
        if so_on is not None:
            delta = torch.where(so_on, delta, gw)     # MKOR-H fallback
        for i, path in enumerate(bucket.paths):
            out = statlib.tree_set(
                out, path, {**statlib.tree_get(out, path), "w": delta[i]})
        return out

    # ------------------------------------------------------------------ #
    # The health sentinel (health=True): detect, gate, trip, reset
    # ------------------------------------------------------------------ #
    hot_norm = cfg.health_norm_factor * cfg.stabilizer_threshold

    def side_bad(side):
        """0-d bool: a bank side holds a non-finite value or is hot (its
        max |decode| above health_norm_factor · stabilizer_threshold).
        int8: the codes are always finite, so the scale and the error
        feedback are scanned, and the norm is scale · max|codes|."""
        if quant8:
            return _any_nonfinite(side[1:]) | \
                (_quant_side_maxabs(side) > hot_norm)
        return ~(_absmax(side[0]) <= hot_norm)

    def sides_bad(*sides):
        bad = side_bad(sides[0])
        for side in sides[1:]:
            bad = bad | side_bad(side)
        return bad

    def window_srcs(win):
        # int8 window codes are always finite: their scales are scanned
        return [win["a_scale"], win["g_scale"]] if quant8 else \
            [win["a"], win["g"]]

    def input_srcs(gw, gv, av, extra):
        """The step's gradients and stat vectors, for the non-finite scan
        (the stacked ones, and the vectors of slots left out of them)."""
        return [gw] + ([gv, av] if gv is not None else []) + extra

    def reset_side(side, trip):
        """The quarantine reset: identity factors; int8: codes 127·I,
        scale 1/127 and the error feedback zeroed together, so a residual
        from before the trip never re-enters."""
        new = (torch.where(trip, _identity_like(side[0]), side[0]),)
        if quant8:
            new += (torch.where(trip, _QUANT_ID_SCALE, side[1]),
                    torch.where(trip, 0.0, side[2]))
        return new

    def reset_windows(win, trip):
        """Zero the window rows (and int8 row scales) and counts on a trip:
        0-weighted NaN rows would still poison the next block update."""
        return {k: torch.where(trip, torch.zeros((), dtype=t.dtype,
                                                 device=t.device), t)
                for k, t in win.items()}

    def next_health(hst, trip, phase_hit):
        """Cooldown: K on a trip, one less on each phase step, else kept;
        trips counted.  ``phase_hit`` is a host bool, or a 0-d device bool
        when MKOR-H's switch gates it."""
        cool = hst["cooldown"]
        dec = torch.clamp(cool - 1, min=0)
        if isinstance(phase_hit, bool):
            dec = dec if phase_hit else cool
        else:
            dec = torch.where(phase_hit, dec, cool)
        k = torch.full_like(cool, cfg.health_cooldown)
        return {"cooldown": torch.where(trip, k, dec),
                "trips": hst["trips"] + trip.to(torch.int32)}

    def precondition_bucket(out, bucket, l_side, r_side, gw, so_on):
        """Lines 9-10: one precondition + rescale per bucket; with MKOR-H's
        switch ``so_on`` off, the raw gradient instead."""
        delta = banked_precond(l_side, r_side, gw, 1 + len(bucket.stack))
        return write_delta(out, bucket, delta, gw, so_on)

    def precondition_guarded(out, bucket, l_side, r_side, gw, so_on, trip):
        """Lines 9-10 under the sentinel: a trip resets the banks before
        they precondition the cleaned gradient; a slice whose update
        vanished while its gradient did not (the rescale's ε guard fired)
        or a non-finite update trips too, and resets them again.  Returns
        (out, l_side, r_side, trip)."""
        l_side, r_side = reset_side(l_side, trip), reset_side(r_side, trip)
        gw = _finite_or_zero(gw)
        delta = banked_precond(l_side, r_side, gw, 1 + len(bucket.stack))
        eps_hit = torch.any((_slice_norm(delta) == 0.0)
                            & (_slice_norm(gw) > 0.0))
        trip = trip | eps_hit | _any_nonfinite([delta])
        out = write_delta(out, bucket, _finite_or_zero(delta), gw, so_on)
        return (out, reset_side(l_side, trip), reset_side(r_side, trip),
                trip)

    def update_sync(grads, state, params, stats, so_on, off):
        """The synchronous step.  ``so_on``: MKOR-H's updated switch (None
        without MKOR-H), which selects each phase step's results; ``off``:
        the host has seen the switch off, so no second-order work runs."""
        count = int(state["count"])
        manifest = manifest_for(params if params is not None else grads, cfg)
        phases = statlib.bucket_phases(manifest, cfg.inv_freq, cfg.stagger)
        new_banks: Dict[str, Dict[str, torch.Tensor]] = {}
        new_windows, new_health = {}, {}
        out = grads
        for bucket in manifest:
            bid = bucket.bucket_id
            l_side, r_side = unpack(state["factor_banks"][bid])
            g_ws, slots, gv, av, extra = bucket_inputs(bucket, grads, stats)
            # the stacked gradients, unless no precondition runs
            gw = torch.stack(g_ws) if cfg.health or not off else None
            do_inv = not off and count % cfg.inv_freq == phases[bid]
            win = state["stat_windows"][bid] if cfg.rank > 1 else None
            # the switch that selects the phase step's results: MKOR-H's,
            # and the sentinel's gate (the reference's do_inv on the
            # device), which also masks the pivot
            sel, piv = so_on, None
            if cfg.health:
                hst = state["health"][bid]
                pre_bad = sides_bad(l_side, r_side) | _any_nonfinite(
                    input_srcs(gw, gv, av, extra)
                    + (window_srcs(win) if win is not None else []))
                sel = (hst["cooldown"] == 0) & ~pre_bad
                if so_on is not None:
                    sel = sel & so_on
                if slots:
                    # poisoned stat vectors never enter windows or banks
                    gv, av = _finite_or_zero(gv), _finite_or_zero(av)
            # --- lines 5-8.  Slots without stats this step keep their
            # factors (and windows) untouched. ----------------------------- #
            if cfg.rank > 1:
                if slots:
                    # push, then on the phase step consume each slot's
                    # whole window and reset its count (the push precedes
                    # the consume, so the phase step's own stats count)
                    sub, take, put = push_windows(bucket, win, slots, gv, av)
                    if do_inv:
                        l_old = tuple(map(take, l_side))
                        r_old = tuple(map(take, r_side))
                        # no pivot export under dist: a singular solve
                        # shows in the gathered banks' post checks
                        l_new, r_new, piv = block_sides(
                            l_old, r_old, sub, sub["n"],
                            cfg.health and not dist_on)
                        l_side = tuple(map(put, l_side,
                                           _select(sel, l_new, l_old)))
                        r_side = tuple(map(put, r_side,
                                           _select(sel, r_new, r_old)))
                        zero = torch.zeros_like(sub["n"])
                        sub["n"] = zero if sel is None else \
                            torch.where(sel, zero, sub["n"])
                    win = {k: put(win[k], sub[k]) for k in win}
            elif slots and do_inv:
                take, put = slot_access(bucket, slots, l_side[0].device)
                l_old = tuple(map(take, l_side))
                r_old = tuple(map(take, r_side))
                l_side = tuple(map(put, l_side, _select(
                    sel, side_rank1(l_old, gv), l_old)))
                r_side = tuple(map(put, r_side, _select(
                    sel, side_rank1(r_old, av), r_old)))
            if not cfg.health:
                new_banks[bid] = pack(l_side, r_side)
                if win is not None:
                    new_windows[bid] = win
                if not off:
                    out = precondition_bucket(out, bucket, l_side, r_side,
                                              gw, so_on)
                continue
            # --- the sentinel's trip: the banks after the inversion (a
            # phase step's only: otherwise they are the banks pre_bad
            # scanned), and the pivot, masked to +inf where the gate held
            # the old banks (the reference never computes it there) ----- #
            trip = pre_bad
            if slots and do_inv:
                trip = trip | sides_bad(l_side, r_side)
                if piv is not None:
                    piv = torch.where(sel, piv, float("inf"))
                    trip = trip | ~(piv >= cfg.health_pivot_tol)
            out, l_side, r_side, trip = precondition_guarded(
                out, bucket, l_side, r_side, gw, so_on, trip)
            new_banks[bid] = pack(l_side, r_side)
            if win is not None:
                new_windows[bid] = reset_windows(win, trip)
            phase_hit = do_inv if so_on is None or not do_inv else so_on
            new_health[bid] = next_health(hst, trip, phase_hit)
        fstate = {"factor_banks": new_banks}
        if cfg.rank > 1:
            fstate["stat_windows"] = new_windows
        if cfg.health:
            fstate["health"] = new_health
        return out, fstate

    # ------------------------------------------------------------------ #
    # staleness=1: the tick (promote-then-launch) and the per-step work
    # ------------------------------------------------------------------ #
    def tick_banked(state, tree, view=None):
        """On each bucket's phase step: active ← pending, and pending ←
        block update of the just-promoted bank from the window the state
        carries (stats through the previous step); the window's count
        resets.  Its rows persist (the count masks stale rows).  A slot
        whose window was never written carries count 0: its update is an
        exact no-op.  With int8 storage the side triples move together,
        so the error feedback rides the pending bank.  MKOR-H gates all
        three on the CARRIED switch, and the sentinel on the carried
        cooldown (a quarantined bucket neither promotes nor launches),
        by selects on the device; once the host view is off the tick does
        nothing."""
        if cfg.hybrid and view is False:
            return state
        c_on = state["hybrid"]["on"] if cfg.hybrid else None
        manifest = manifest_for(tree, cfg)
        phases = statlib.bucket_phases(manifest, cfg.inv_freq, cfg.stagger)
        count = int(state["count"])
        active = dict(state["factor_banks"])
        pending = dict(state["pending_banks"])
        windows = dict(state["stat_windows"])
        for bucket in manifest:
            bid = bucket.bucket_id
            if count % cfg.inv_freq != phases[bid]:
                continue
            gate = c_on
            if cfg.health:
                cool_ok = state["health"][bid]["cooldown"] == 0
                gate = cool_ok if gate is None else gate & cool_ok
            pend, win = pending[bid], windows[bid]
            l_new, r_new, _ = block_sides(*unpack(pend), win, win["n"])
            launched = pack(l_new, r_new)
            n = torch.zeros_like(win["n"])
            if gate is None:
                active[bid], pending[bid] = pend, launched
            else:
                act = active[bid]
                active[bid] = {k: torch.where(gate, pend[k], act[k])
                               for k in pend}
                pending[bid] = {k: torch.where(gate, launched[k], pend[k])
                                for k in pend}
                n = torch.where(gate, n, win["n"])
            windows[bid] = {**win, "n": n}
        return {**state, "factor_banks": active, "pending_banks": pending,
                "stat_windows": windows}

    def update_async(grads, state, params, stats, so_on, off):
        """Push this step's stats into the windows and precondition with
        the ACTIVE banks; no inversion (that happened at the tick).
        ``so_on`` and ``off`` as in :func:`update_sync`.  The sentinel
        scans both buffers, and a trip resets both, with the window."""
        count = int(state["count"])
        manifest = manifest_for(params if params is not None else grads, cfg)
        phases = statlib.bucket_phases(manifest, cfg.inv_freq, cfg.stagger)
        new_windows, new_banks, new_pending, new_health = {}, {}, {}, {}
        out = grads
        for bucket in manifest:
            bid = bucket.bucket_id
            g_ws, slots, gv, av, extra = bucket_inputs(bucket, grads, stats)
            win = state["stat_windows"][bid]
            l_act, r_act = unpack(state["factor_banks"][bid])
            gw = torch.stack(g_ws) if cfg.health or not off else None
            if cfg.health:
                l_pen, r_pen = unpack(state["pending_banks"][bid])
                trip = sides_bad(l_act, r_act, l_pen, r_pen) | \
                    _any_nonfinite(window_srcs(win)
                                   + input_srcs(gw, gv, av, extra))
                if slots:
                    gv, av = _finite_or_zero(gv), _finite_or_zero(av)
            if slots:
                sub, _, put = push_windows(bucket, win, slots, gv, av)
                win = {k: put(win[k], sub[k]) for k in win}
            if not cfg.health:
                new_windows[bid] = win
                if not off:
                    out = precondition_bucket(out, bucket, l_act, r_act, gw,
                                              so_on)
                continue
            out, l_act, r_act, trip = precondition_guarded(
                out, bucket, l_act, r_act, gw, so_on, trip)
            new_banks[bid] = pack(l_act, r_act)
            new_pending[bid] = pack(reset_side(l_pen, trip),
                                    reset_side(r_pen, trip))
            new_windows[bid] = reset_windows(win, trip)
            phase = count % cfg.inv_freq == phases[bid]
            phase_hit = phase if so_on is None or not phase else so_on
            new_health[bid] = next_health(state["health"][bid], trip,
                                          phase_hit)
        if not cfg.health:
            return out, {"factor_banks": state["factor_banks"],
                         "pending_banks": state["pending_banks"],
                         "stat_windows": new_windows}
        return out, {"factor_banks": new_banks, "pending_banks": new_pending,
                     "stat_windows": new_windows, "health": new_health}

    # ------------------------------------------------------------------ #
    # layout="per_layer": the reference's per-layer path, the bank path's
    # numerical oracle.  One factor pair a layer, each stacked layer's
    # (*stack, d, d) updated whole (one launch a side with kernels); the
    # same schedule, stabilizer, updates and selects as the bank path.
    # ------------------------------------------------------------------ #
    def layer_smw(j, v):
        """Stabilize, then the rank-1 SMW of one layer's factor with its
        stats ``v`` (*stack, d)."""
        jb = stab(j)
        if cfg.use_kernels:
            return kops.smw_rank1_update(jb, v, gamma=cfg.gamma,
                                         variant=cfg.variant, out=jb)
        return smw_rank1_update(jb, v, cfg.gamma, cfg.variant)

    def layer_block(j, win, name):
        """Stabilize, then the block update of one layer's factor from its
        window's ``name`` rows ("a" or "g"), filled ``win["n"]`` times."""
        jb, cnt = stab(j), win["n"]
        rows = statlib.window_ordered(win[name], cnt)
        if cfg.use_kernels:
            return kops.smw_block_update(jb, rows, gamma=cfg.gamma,
                                         variant=cfg.variant, n_valid=cnt,
                                         out=jb)
        return smw_block_update(jb, rows, cfg.gamma, cfg.variant,
                                n_valid=cnt)

    def layer_inputs(grads, stats, path):
        """A layer's gradient and its ā, ḡ (None where the step has none)."""
        a_vec = statlib.get_a_vec(stats, path) if stats is not None else None
        return (statlib.tree_get(grads, path)["w"], a_vec,
                statlib.get_g_vec(grads, path))

    def push_layer(win, a_vec, g_vec):
        return {"a": statlib.window_push(win["a"], win["n"], a_vec),
                "g": statlib.window_push(win["g"], win["n"], g_vec),
                "n": win["n"] + 1}

    def precondition_layer(out, path, l_inv, r_inv, gw, so_on):
        """Lines 9-10 for one layer (each stack slice rescaled alone); with
        MKOR-H's switch ``so_on`` off, the raw gradient instead."""
        if cfg.use_kernels:
            delta = kops.fused_precondition(l_inv, r_inv, gw,
                                            rescale=cfg.rescale)
        else:
            delta = precondition(l_inv, r_inv, gw)
            if cfg.rescale:
                delta = rescale_update(delta, gw, l_inv.ndim - 2)
        delta = delta.to(gw.dtype)
        if so_on is not None:
            delta = torch.where(so_on, delta, gw)     # MKOR-H fallback
        return statlib.tree_set(out, path,
                                {**statlib.tree_get(out, path), "w": delta})

    def per_layer_setup(grads, params):
        tree = params if params is not None else grads
        return ({statlib.path_str(p): p
                 for p in statlib.iter_dense_layers(grads)},
                statlib.layer_phases(manifest_for(tree, cfg), cfg.inv_freq,
                                     cfg.stagger))

    def update_per_layer(grads, state, params, stats, so_on, off):
        """The synchronous per-layer step (the reference's
        ``update_per_layer``); ``so_on`` and ``off`` as in
        :func:`update_sync`."""
        count = int(state["count"])
        paths, phases = per_layer_setup(grads, params)
        new_factors, new_windows, out = {}, {}, grads
        for key, fac in state["factors"].items():
            g_w, a_vec, g_vec = layer_inputs(grads, stats, paths[key])
            old = (fac["l_inv"], fac["r_inv"])
            do_inv = not off and count % cfg.inv_freq == phases.get(key, 0)
            has_stats = a_vec is not None and g_vec is not None
            l_inv, r_inv = old
            if cfg.rank > 1:
                win = state["stat_windows"][key]
                if has_stats:
                    # push, then on the phase step consume the window and
                    # reset its count (the phase step's own stats count)
                    win = push_layer(win, a_vec, g_vec)
                    if do_inv:
                        l_inv, r_inv = _select(so_on, (
                            layer_block(l_inv, win, "g"),
                            layer_block(r_inv, win, "a")), old)
                        zero = torch.zeros_like(win["n"])
                        win = {**win, "n": zero if so_on is None else
                               torch.where(so_on, zero, win["n"])}
                new_windows[key] = win
            elif has_stats and do_inv:
                l_inv, r_inv = _select(so_on, (layer_smw(l_inv, g_vec),
                                               layer_smw(r_inv, a_vec)), old)
            new_factors[key] = {"l_inv": l_inv, "r_inv": r_inv}
            if not off:
                out = precondition_layer(out, paths[key], l_inv, r_inv, g_w,
                                         so_on)
        fstate = {"factors": new_factors}
        if cfg.rank > 1:
            fstate["stat_windows"] = new_windows
        return out, fstate

    def tick_per_layer(state, tree, view=None):
        """:func:`tick_banked` a layer at a time (the reference's
        ``tick_per_layer``)."""
        if cfg.hybrid and view is False:
            return state
        c_on = state["hybrid"]["on"] if cfg.hybrid else None
        phases = statlib.layer_phases(manifest_for(tree, cfg), cfg.inv_freq,
                                      cfg.stagger)
        count = int(state["count"])
        active = dict(state["factors"])
        pending = dict(state["pending_factors"])
        windows = dict(state["stat_windows"])
        for key in state["factors"]:
            if count % cfg.inv_freq != phases.get(key, 0):
                continue
            pend, win = pending[key], windows[key]
            launched = {"l_inv": layer_block(pend["l_inv"], win, "g"),
                        "r_inv": layer_block(pend["r_inv"], win, "a")}
            n = torch.zeros_like(win["n"])
            if c_on is None:
                active[key], pending[key] = pend, launched
            else:
                act = active[key]
                active[key] = {k: torch.where(c_on, pend[k], act[k])
                               for k in pend}
                pending[key] = {k: torch.where(c_on, launched[k], pend[k])
                                for k in pend}
                n = torch.where(c_on, n, win["n"])
            windows[key] = {**win, "n": n}
        return {**state, "factors": active, "pending_factors": pending,
                "stat_windows": windows}

    def update_per_layer_async(grads, state, params, stats, so_on, off):
        """Push this step's stats and precondition with the ACTIVE factors
        (the reference's ``update_per_layer_async``)."""
        paths, _ = per_layer_setup(grads, params)
        new_windows, out = {}, grads
        for key, fac in state["factors"].items():
            g_w, a_vec, g_vec = layer_inputs(grads, stats, paths[key])
            win = state["stat_windows"][key]
            if a_vec is not None and g_vec is not None:
                win = push_layer(win, a_vec, g_vec)
            new_windows[key] = win
            if not off:
                out = precondition_layer(out, paths[key], fac["l_inv"],
                                         fac["r_inv"], g_w, so_on)
        return out, {"factors": state["factors"],
                     "pending_factors": state["pending_factors"],
                     "stat_windows": new_windows}

    def tick(state, tree, view=None):
        return (tick_per_layer if per_layer else tick_banked)(state, tree,
                                                              view)

    def precompute(state, params=None, view=None, **_):
        """The phase tick of the two-phase protocol: run it at the top of
        the train step, before the gradients exist, then pass
        ``precomputed=True`` to ``update``."""
        if params is None:
            raise ValueError("mkor precompute needs params (the bucket "
                             "manifest is derived from them)")
        return tick(state, params, view)

    def plan(state, view=None):
        """The next update's host branch key, ``count % inv_freq`` (the
        phase residue that picks the buckets that invert, at the tick too;
        ``None`` once MKOR-H's view is off), with the backend's branch key
        and per-step scalars (and MKOR-H's)."""
        key, scalars = backend.plan(state["backend"])
        count = int(state["count"])
        if not cfg.hybrid:
            return (count % cfg.inv_freq, key), scalars
        residue = None if view is False else count % cfg.inv_freq
        return (residue, key), {**scalars, **_hybrid_scalars(count, cfg)}

    def observe(state) -> bool:
        """MKOR-H's host view: the carried switch (a device read)."""
        return bool(state["hybrid"]["on"])

    def update(grads, state, params=None, stats=None, loss=None,
               precomputed=False, scalars=None, view=None, **_):
        if cfg.hybrid and loss is None:
            raise ValueError("MKOR-H needs the loss for switching")
        off = cfg.hybrid and view is False
        if cfg.staleness and not precomputed:
            state = tick(state, params if params is not None else grads,
                         view)
        count = int(state["count"])
        hybrid, so_on = state["hybrid"], None
        if cfg.hybrid:
            hs = scalars if scalars is not None else device_scalars(
                _hybrid_scalars(count, cfg), loss.device)
            hybrid = _hybrid_update(hybrid, loss, hs["hybrid_first"],
                                    hs["hybrid_late"], cfg)
            so_on = hybrid["on"]
        if cfg.staleness:
            step = update_per_layer_async if per_layer else update_async
        else:
            step = update_per_layer if per_layer else update_sync
        out, fstate = step(grads, state, params, stats, so_on, off)
        # probes are stat taps: never step them, keep backend moments clean
        out = statlib.zero_probes(out)
        updates, backend_state = backend.update(
            out, state["backend"], params=params, scalars=scalars)
        updates = statlib.zero_probes(updates)
        return updates, {"count": step_count(count + 1), **fstate,
                         "hybrid": hybrid, "backend": backend_state}

    return GradientTransformation(init, update,
                                  precompute if cfg.staleness else None,
                                  plan if backend.plan is not None else None,
                                  observe if cfg.hybrid else None)


def mkor_h(backend: GradientTransformation,
           cfg: MKORConfig = MKORConfig()) -> GradientTransformation:
    """Hybrid MKOR (§3.2)."""
    return mkor(backend, dataclasses.replace(cfg, hybrid=True))


def factor_slices(state, tree, cfg: MKORConfig = MKORConfig()):
    """Per-layer ``{path_str: {"l_inv", "r_inv"}}`` views of the factor
    state, whatever its layout (int8 banks decoded to fp32), for tests and
    inspection."""
    if "factors" in state:                          # layout="per_layer"
        return dict(state["factors"])
    out = {}
    for bucket in manifest_for(tree, cfg):
        bank = state["factor_banks"][bucket.bucket_id]
        for i, key in enumerate(bucket.path_strs):
            if "l_scale" in bank:                   # int8: fp32 views
                out[key] = {
                    "l_inv": statlib.quant_decode(bank["l_inv"][i],
                                                  bank["l_scale"][i]),
                    "r_inv": statlib.quant_decode(bank["r_inv"][i],
                                                  bank["r_scale"][i])}
            else:
                out[key] = {"l_inv": bank["l_inv"][i],
                            "r_inv": bank["r_inv"][i]}
    return out
