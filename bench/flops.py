"""The yardstick's arithmetic: the model's operations a training step, the
two optimizer-kernel bounds, and the card's peaks.

Operations and bytes come from the configuration's shapes, as the work the
algorithm needs, whatever buckets or kernels carry it.  The kernel bounds
are those of the port's kernel checks, frozen here: the precondition
ΔW = R⁻¹ G L⁻¹ reads G, L⁻¹ and R⁻¹ once (bf16) and writes ΔW once
(float32), 2·(d_out²·d_in + d_out·d_in²) operations at the bf16 peak; the
rank-1 SMW update reads and writes J once at its storage dtype and reads
its vector (float32) and coefficient, 5d² + 4d operations.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from reference import head_dim, padded_vocab

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# bytes a factor element is stored in, by the traffic's ``factor_quant``
FACTOR_BYTES = {"none": 2, "bf16": 2, "int8": 1}


def dense_layers(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """Every dense layer as (name, copies, d_in, d_out): the attention
    projections and the MLP of each of ``n_layers`` blocks, and lm_head."""
    n, d, f = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    h, hk, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return [("q", n, d, h * dh), ("k", n, d, hk * dh), ("v", n, d, hk * dh),
            ("o", n, h * dh, d), ("in", n, d, f), ("out", n, f, d),
            ("lm_head", 1, d, padded_vocab(cfg))]


def mkor_layers(cfg: Dict, lo: int = 4, hi: int = 32768
                ) -> List[Tuple[str, int, int, int]]:
    """The layers MKOR preconditions: every dense layer but lm_head whose
    dims lie in [lo, hi]."""
    return [layer for layer in dense_layers(cfg)
            if layer[0] != "lm_head" and lo <= layer[2] <= hi
            and lo <= layer[3] <= hi]


def model_flops_per_step(cfg: Dict, batch: int, seq_len: int) -> float:
    """Forward and backward operations of one step (3 × forward): the
    dense products with lm_head, the attention scores' outer product
    (Σ_d q)(Σ_d k) over every (query, key) pair, and the value product."""
    tokens = batch * seq_len
    dense = sum(2.0 * tokens * copies * d_in * d_out
                for _, copies, d_in, d_out in dense_layers(cfg))
    pairs = float(batch) * cfg["n_heads"] * seq_len * seq_len
    attn = cfg["n_layers"] * (pairs + 2.0 * pairs * head_dim(cfg))
    return 3.0 * (dense + attn)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time: the larger of bytes at the HBM peak and operations
    at the bf16 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS)


def precond_cost(d_in: int, d_out: int) -> Tuple[float, float]:
    """(bytes, operations) of one ΔW = R⁻¹ G L⁻¹ with its rescale."""
    n_bytes = (d_in * d_in + d_out * d_out + d_in * d_out) * 2 \
        + d_in * d_out * 4
    return float(n_bytes), 2.0 * d_in * d_out * (d_in + d_out)


def smw_cost(d: int, factor_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one rank-1 SMW update of a d × d factor."""
    return float(2 * d * d * factor_bytes + d * 4 + 4), 5.0 * d * d + 4.0 * d


def precond_bound_s_per_step(cfg: Dict) -> float:
    """Σ over MKOR's layers of the precondition's bound: every layer is
    preconditioned every step."""
    return sum(copies * bound_s(*precond_cost(d_in, d_out))
               for _, copies, d_in, d_out in mkor_layers(cfg))


def smw_bound_s_per_step(cfg: Dict, inv_freq: int,
                         factor_bytes: int = 2) -> float:
    """Σ over MKOR's factors (L⁻¹: d_out, R⁻¹: d_in) of the SMW bound,
    over ``inv_freq``: each factor is updated once a period."""
    total = sum(copies * (bound_s(*smw_cost(d_out, factor_bytes))
                          + bound_s(*smw_cost(d_in, factor_bytes)))
                for _, copies, d_in, d_out in mkor_layers(cfg))
    return total / inv_freq

