"""Layer discovery, rank-1 statistic extraction and the factor-bank bucket
manifest (port of the main-path part of ``repro/core/stats.py``).

Conventions, as in the reference:

* A "dense layer" is any params sub-dict holding both ``"w"`` (ndim >= 2,
  trailing dims ``(d_in, d_out)``) and ``"probe"`` (trailing dim d_out).
* The leading dims of ``probe`` (size-1 dims stripped) are the *stack*
  dims: the scan-over-layers repeats.
* The stats tree from ``forward(collect_stats=True)`` mirrors the params
  tree with each dense dict replaced by ``{"a": E[a]}``.
* ``grads[...]["probe"]`` is exactly ``E[g]``.

The manifest is a pure function of the tree structure and the leaf shapes,
so it can be rebuilt at every ``update`` and always agrees with ``init``.
The rank-r stat windows (``window_push`` / ``window_ordered``) and the
int8 storage helpers (``quant_encode`` / ``quant_decode`` /
``quant_requantize``, ``window_push_quant`` / ``window_decode``) are here,
and the owner map of the data-parallel path (``live_mask``,
``bucket_owner_map``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Path = Tuple[Any, ...]


def is_dense_dict(node) -> bool:
    return isinstance(node, dict) and "w" in node and "probe" in node \
        and hasattr(node["w"], "ndim") and node["w"].ndim >= 2


def iter_dense_layers(params) -> List[Path]:
    """All paths (tuples of dict keys / sequence indices) to dense dicts."""
    out: List[Path] = []

    def walk(node, path):
        if is_dense_dict(node):
            out.append(path)
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    return out


def tree_get(tree, path: Path):
    node = tree
    for k in path:
        if node is None:
            return None
        try:
            node = node[k]
        except (KeyError, IndexError, TypeError):
            return None
    return node


def tree_set(tree, path: Path, value):
    """Functionally replace ``tree[path]`` (dicts/lists copied on the way)."""
    if not path:
        return value
    k = path[0]
    if isinstance(tree, dict):
        new = dict(tree)
        new[k] = tree_set(tree[k], path[1:], value)
        return new
    if isinstance(tree, list):
        new = list(tree)
        new[k] = tree_set(tree[k], path[1:], value)
        return new
    if isinstance(tree, tuple):
        lst = list(tree)
        lst[k] = tree_set(tree[k], path[1:], value)
        return tuple(lst)
    raise TypeError(f"cannot set path {path} in {type(tree)}")


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)


def stack_shape_of(probe) -> Tuple[int, ...]:
    """Stack dims = probe leading dims with broadcast 1s stripped."""
    return tuple(d for d in probe.shape[:-1] if d != 1)


def layer_dims(dense: Dict) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                     int, int]:
    """Returns (stack_shape, extra_shape, d_in, d_out) for a dense dict."""
    w, probe = dense["w"], dense["probe"]
    d_in, d_out = w.shape[-2], w.shape[-1]
    stack = stack_shape_of(probe)
    lead = tuple(w.shape[:-2])
    if lead[:len(stack)] != stack:
        raise ValueError(f"stack dims {stack} not a prefix of w lead dims "
                         f"{lead}")
    return stack, lead[len(stack):], d_in, d_out


def get_a_vec(stats, path: Path) -> Optional[torch.Tensor]:
    node = tree_get(stats, path)
    if node is None or not isinstance(node, dict) or "a" not in node:
        return None
    return node["a"]


def get_g_vec(grads, path: Path) -> Optional[torch.Tensor]:
    node = tree_get(grads, path)
    if node is None or "probe" not in node:
        return None
    probe = node["probe"]
    return probe.reshape(stack_shape_of(probe) + probe.shape[-1:])


# ----------------------------------------------------------------------- #
# Factor-bank bucket manifest
# ----------------------------------------------------------------------- #
@dataclass(frozen=True)
class FactorBucket:
    """One shape bucket: every layer with identical (stack, extra, d_in,
    d_out) signature.  ``paths`` fixes the bank slot order; ``index`` is
    the bucket's position in the sorted bucket order (the anchor of the
    staggered inversion schedule)."""
    bucket_id: str
    stack: Tuple[int, ...]
    extra: Tuple[int, ...]
    d_in: int
    d_out: int
    paths: Tuple[Path, ...]
    index: int = 0

    def phase(self, inv_freq: int) -> int:
        """This bucket inverts on steps where ``count % inv_freq == phase``."""
        return self.index % max(inv_freq, 1)

    @property
    def n_slots(self) -> int:
        return len(self.paths)

    @property
    def path_strs(self) -> Tuple[str, ...]:
        return tuple(path_str(p) for p in self.paths)


@dataclass(frozen=True)
class BucketManifest:
    buckets: Tuple[FactorBucket, ...]

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)


def bucket_id_for(stack: Tuple[int, ...], extra: Tuple[int, ...],
                  d_in: int, d_out: int) -> str:
    """Deterministic, human-readable bucket key (e.g. ``1024x1024_s24``)."""
    bid = f"{d_in}x{d_out}"
    if stack:
        bid += "_s" + "x".join(map(str, stack))
    if extra:
        bid += "_e" + "x".join(map(str, extra))
    return bid


def build_bucket_manifest(
        tree, eligible: Optional[Callable[[Path, Dict], bool]] = None,
) -> BucketManifest:
    """Group eligible dense layers of ``tree`` by shape signature: buckets
    sorted by id, slots by path string."""
    groups: Dict[Tuple, List[Path]] = {}
    for path in iter_dense_layers(tree):
        dense = tree_get(tree, path)
        if eligible is not None and not eligible(path, dense):
            continue
        stack, extra, d_in, d_out = layer_dims(dense)
        groups.setdefault((stack, extra, d_in, d_out), []).append(path)
    buckets = [FactorBucket(bucket_id=bucket_id_for(*sig), stack=sig[0],
                            extra=sig[1], d_in=sig[2], d_out=sig[3],
                            paths=tuple(sorted(paths, key=path_str)))
               for sig, paths in groups.items()]
    buckets.sort(key=lambda b: b.bucket_id)
    return BucketManifest(tuple(dataclasses.replace(b, index=i)
                                for i, b in enumerate(buckets)))


def bucket_phases(manifest: BucketManifest, inv_freq: int,
                  stagger: bool = True) -> Dict[str, int]:
    """Per-bucket inversion phases: round-robin ``i % inv_freq`` with
    ``stagger``, all 0 (the paper's spike schedule) without."""
    if not stagger:
        return {b.bucket_id: 0 for b in manifest}
    return {b.bucket_id: b.phase(inv_freq) for b in manifest}


def layer_phases(manifest: BucketManifest, inv_freq: int,
                 stagger: bool = True) -> Dict[str, int]:
    """Per-layer view of :func:`bucket_phases`: ``{path_str: phase}``."""
    phases = bucket_phases(manifest, inv_freq, stagger)
    return {ps: phases[b.bucket_id] for b in manifest for ps in b.path_strs}


def bucket_slices(bucket: FactorBucket) -> int:
    """Flattened (slot x stack) slice count of a bucket's banks."""
    n = bucket.n_slots
    for d in bucket.stack:
        n *= d
    return n


def live_mask(world_size: int,
              live: Optional[Tuple[bool, ...]] = None) -> Tuple[bool, ...]:
    """A validated liveness mask for ``world_size`` workers (``None``:
    every worker live)."""
    w = max(world_size, 1)
    if live is None:
        return (True,) * w
    mask = tuple(bool(x) for x in live)
    if len(mask) != w:
        raise ValueError(
            f"liveness mask has {len(mask)} entries for world {w}")
    if not any(mask):
        raise ValueError("liveness mask declares every worker dead")
    return mask


def owner_chunk(n_slots: int, n_live: int) -> int:
    """Slices each live worker owns of ``n_slots`` (the last chunks may be
    padding only)."""
    return -(-n_slots // max(n_live, 1))


def survivor_rank(mask: Tuple[bool, ...], worker: int) -> int:
    """``worker``'s rank among the live workers of ``mask`` (0 for a dead
    worker): the index of its chunk."""
    return sum(mask[:worker]) if mask[worker] else 0


def bucket_owner_map(manifest: BucketManifest, world_size: int,
                     live: Optional[Tuple[bool, ...]] = None,
                     ) -> Dict[str, Tuple[Tuple[int, int], ...]]:
    """``{bucket_id: ((start, stop), ...)}``: worker w owns the flattened
    (slot x stack) slices ``[start_w, stop_w)`` of every bucket's banks:
    its :func:`owner_chunk` at its :func:`survivor_rank`, clipped to the
    slice count (trailing workers may own empty ranges; dead workers own
    ``(0, 0)``), the chunks ``sharding.collectives.owner_shard`` slices."""
    mask = live_mask(world_size, live)
    out = {}
    for b in manifest:
        n = bucket_slices(b)
        chunk = owner_chunk(n, sum(mask))
        out[b.bucket_id] = tuple(
            (min(survivor_rank(mask, w) * chunk, n),
             min((survivor_rank(mask, w) + 1) * chunk, n))
            if alive else (0, 0) for w, alive in enumerate(mask))
    return out


# ----------------------------------------------------------------------- #
# Rank-r stat windows
#
# With ``MKORConfig.rank = r > 1`` (or ``staleness=1``) the optimizer keeps
# the last r per-step statistic vectors of every factor in a ring window
# and consumes the whole window with one block-Woodbury update on the
# factor's phase step.
# ----------------------------------------------------------------------- #
def window_push(win: torch.Tensor, count, vec: torch.Tensor) -> torch.Tensor:
    """Ring-write ``vec`` into row ``count % r`` of the window.

    win: (*lead, r, d); vec: (*lead, d); count: int tensor broadcastable
    to ``lead``, the number of writes since the last consume (BEFORE this
    push).  A select, so no host sync and O(r·d) per slice."""
    r = win.shape[-2]
    pos = torch.remainder(torch.as_tensor(count, device=win.device), r)
    onehot = torch.arange(r, device=win.device) == pos[..., None]
    return torch.where(onehot[..., None], vec[..., None, :].to(win.dtype),
                       win)


def window_ordered(win: torch.Tensor, count) -> torch.Tensor:
    """The window rows oldest-first for consumption.

    Until the ring wraps (count <= r) rows 0..count-1 already sit in write
    order; after wrapping the oldest row is at ``count % r``, so the rows
    are rotated (``torch.gather``) to restore chaining order.  Rows beyond
    ``count`` are stale or unwritten; the block update masks them through
    its n_valid weights."""
    r = win.shape[-2]
    count = torch.as_tensor(count, device=win.device)
    shift = torch.where(count > r, torch.remainder(count, r),
                        torch.zeros_like(count))
    rows = torch.remainder(
        shift[..., None] + torch.arange(r, device=win.device), r)
    rows = rows.broadcast_to(win.shape[:-1])
    return torch.gather(win, -2, rows[..., None].expand(win.shape))


# ----------------------------------------------------------------------- #
# Quantized factor storage (``MKORConfig.factor_quant``)
#
#   none — store at ``factor_dtype``;
#   bf16 — bfloat16 storage whatever ``factor_dtype`` says;
#   int8 — per-slice symmetric int8 codes + fp32 scales, with fp32
#          error-feedback accumulators on the bank requantization path.
# The helpers below are the encode/decode arithmetic of the reference,
# operation for operation, so codes, scales and error feedback come out
# bit-equal to it on the CPU.  The CUDA kernels take the codes and the
# per-slice scales and decode at the load site (kernels/rank1_smw.py,
# kernels/precond.py): no fp32 copy of a resident bank is made for them.
# ----------------------------------------------------------------------- #
FACTOR_QUANT_MODES = ("none", "bf16", "int8")

# symmetric range: ±127 keeps decode(q) = -decode(-q) exact
INT8_QMAX = 127.0

# floor on a slice's max-abs before the division: an all-zero slice (a
# zeroed window row) encodes to exact zeros, not NaN
QUANT_SCALE_EPS = 1e-30

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def factor_storage_dtype(factor_dtype: str,
                         factor_quant: str) -> torch.dtype:
    """Resident dtype of the factor banks under ``factor_quant``."""
    if factor_quant == "int8":
        return torch.int8
    if factor_quant == "bf16":
        return torch.bfloat16
    return _TORCH_DTYPES[factor_dtype]


def factor_itemsize(factor_dtype: str, factor_quant: str = "none") -> int:
    """Bytes a resident bank element: the one place the dry run, the
    kernel plans and the contract checks take factor widths from the
    config."""
    return factor_storage_dtype(factor_dtype, factor_quant).itemsize


def _expand(scale: torch.Tensor, axes: int) -> torch.Tensor:
    return scale.reshape(tuple(scale.shape) + (1,) * axes)


def quant_encode(x: torch.Tensor, axes: int = 2):
    """Per-slice symmetric int8 encode: ``(codes int8, scale fp32)``.

    The trailing ``axes`` dims are one slice (2 for a (d, d) factor, 1 for
    a window row); ``scale.shape == x.shape[:-axes]``.  scale =
    max(max|x|, 1e-30) / 127 and codes = round(x / scale) (a division, and
    ``torch.round`` rounds half to even as ``jnp.round`` does), clipped to
    ±127."""
    xf = x.float()
    red = tuple(range(xf.ndim - axes, xf.ndim))
    amax = torch.amax(torch.abs(xf), dim=red)
    scale = torch.clamp(amax, min=QUANT_SCALE_EPS) / INT8_QMAX
    q = torch.clamp(torch.round(xf / _expand(scale, axes)), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return q, scale


def quant_decode(q: torch.Tensor, scale: torch.Tensor,
                 axes: int = 2) -> torch.Tensor:
    """fp32 decode of :func:`quant_encode` output: the plain routes' view of
    an int8 bank (the kernels decode at their load sites instead)."""
    return q.float() * _expand(scale, axes)


def quant_requantize(x: torch.Tensor, err: torch.Tensor, axes: int = 2):
    """Error-feedback requantization of a freshly computed fp32 bank:
    ``(codes, scale, err')`` with ``err' = (x + err) - decode(codes,
    scale)``, so the quantization error accumulates in the fp32
    accumulator instead of in the codes.  ``err`` is fp32 of x's shape.
    (The residual repeats :func:`quant_decode`'s one product inline.)"""
    comp = x.float() + err
    q, scale = quant_encode(comp, axes)
    return q, scale, comp - q.float() * _expand(scale, axes)


def window_push_quant(win: torch.Tensor, win_scale: torch.Tensor, count,
                      vec: torch.Tensor):
    """Quantized ring-write: encode ``vec`` per row and write the int8 row
    and its scale into row ``count % r``.

    win: (*lead, r, d) int8; win_scale: (*lead, r) fp32; vec: (*lead, d).
    Scales are per row, so rows already in the ring keep their codes and
    scales: each stored row is an exact encode of the vector pushed, and
    the window needs no error feedback."""
    qv, sv = quant_encode(vec, axes=1)
    r = win.shape[-2]
    pos = torch.remainder(torch.as_tensor(count, device=win.device), r)
    onehot = torch.arange(r, device=win.device) == pos[..., None]
    new_win = torch.where(onehot[..., None], qv[..., None, :], win)
    new_scale = torch.where(onehot, sv[..., None], win_scale)
    return new_win, new_scale


def window_decode(win: torch.Tensor, win_scale: torch.Tensor) -> torch.Tensor:
    """fp32 view of a quantized stat window (per-row scales)."""
    return win.float() * win_scale[..., None]


def zero_probes(tree):
    """Zero every ``probe`` leaf (probes are statistics taps, never
    updated)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (torch.zeros_like(v) if k == "probe" else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node
    return walk(tree)


# ----------------------------------------------------------------------- #
# The analytic cost model (the reference's ``bucket_cost`` and
# ``bucket_comm_cost``, key for key).  It is the reference's function, with
# its properties: at ``staleness >= 1`` with int8 banks the pending bank's
# fp32 error feedback and scales are left out of ``pending_factor_bytes``
# (the state tree holds them; ``launch/dryrun.py`` prints the difference).
# ----------------------------------------------------------------------- #
def bucket_cost(bucket: FactorBucket, factor_bytes: int,
                rank: int = 1, staleness: int = 0,
                health: bool = False,
                factor_quant: str = "none") -> Dict[str, Any]:
    """Per-bucket factor FLOPs and bytes.  Slices are bank slots x stacked
    repeats, each with a (d_out, d_out) L⁻¹ and a (d_in, d_in) R⁻¹; the
    phase-step inversion is one block-Woodbury update a factor, the
    precondition two products a step over the extra dims.  ``factor_bytes``
    is :func:`factor_itemsize` of the config."""
    n = bucket_slices(bucket)
    b = 1
    for d in bucket.extra:
        b *= d
    di, do = bucket.d_in, bucket.d_out
    r = max(rank, 1)
    smw_flops = n * sum(
        (4 * r + 1) * d * d + 2 * r * r * d + 2 * r ** 3
        for d in (di, do))
    precond_flops = n * b * 2 * di * do * (di + do)
    factor_mem = n * (di * di + do * do) * factor_bytes
    win_elem = 4 if factor_quant == "none" else factor_bytes
    has_window = r > 1 or staleness
    window_mem = n * r * (di + do) * win_elem if has_window else 0
    pending_mem = factor_mem if staleness else 0
    scale_mem = ef_mem = 0
    if factor_quant == "int8":
        scale_mem = n * 2 * 4 * (2 if staleness else 1)
        if has_window:
            scale_mem += n * r * 2 * 4
        ef_mem = n * (di * di + do * do) * 4
    return {
        "bucket_id": bucket.bucket_id,
        "n_layers": bucket.n_slots,
        "stack": list(bucket.stack),
        "extra": list(bucket.extra),
        "d_in": di,
        "d_out": do,
        "slices": n,
        "rank": r,
        "factor_bytes": factor_mem,
        "window_bytes": window_mem,
        "pending_factor_bytes": pending_mem,
        "quant_scale_bytes": scale_mem,
        "quant_ef_bytes": ef_mem,
        "health_state_bytes": 8 if health else 0,
        "smw_flops_per_inv": smw_flops,
        "precond_flops_per_step": precond_flops,
        "hbm_bytes_per_inv": 3 * factor_mem + 2 * window_mem,
    }


def bucket_comm_cost(bucket: FactorBucket, world_size: int,
                     factor_bytes: int,
                     stats_bytes: int, rank: int = 1,
                     factor_quant: str = "none") -> Dict[str, Any]:
    """Per-bucket collective payload bytes a worker a step: the rank-1
    stats every step (O(d), rank-independent), the window they add up to,
    the KFAC-style full factor payload an inversion, and the owner gather
    of the updated inverse chunk on the bucket's phase step (int8: codes
    plus one fp32 scale a slice side).  ``stats_bytes`` is the stat
    payload's wire width: the reference's bf16 (2), or the port's fp32
    sum of bf16-rounded values (4, ``sharding/collectives.py``)."""
    n = bucket_slices(bucket)
    di, do = bucket.d_in, bucket.d_out
    factor_mem = n * (di * di + do * do) * factor_bytes
    chunk = -(-n // max(world_size, 1))
    step_bytes = n * (di + do) * stats_bytes
    scale_bytes = chunk * 2 * 4 if factor_quant == "int8" else 0
    return {
        "rank1_stats_bytes_per_step": step_bytes,
        "rank_window_bytes_per_inv": max(rank, 1) * step_bytes,
        "kfac_factor_bytes_per_inv": factor_mem,
        "owner_gather_bytes_per_phase_step":
            factor_mem * chunk // n + scale_bytes,
        "owner_gather_scale_bytes_per_phase_step": scale_bytes,
    }
