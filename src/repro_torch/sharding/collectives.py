"""Explicit collectives for the data-parallel MKOR step, on
``torch.distributed`` (port of ``repro/sharding/collectives.py``).

MKOR's systems claim is linear communication: per layer the workers
exchange the rank-1 statistics ā (d_in,) and ḡ (d_out,), O(d) on the
wire, instead of the O(d²) factors a KFAC-style distribution broadcasts.
This module is that schedule, with the reference's names:

* :func:`pmean_rank1_stats`: mean-reduce only the rank-1 ``"a"`` leaves of
  the stats tree (bf16 payload, fp32 accumulation; full-stat leaves are
  dropped);
* :func:`flat_reduce_scatter_mean` / :func:`flat_all_gather_tree`
  (:func:`all_reduce_mean_tree`): the gradient mean as one flat fp32
  buffer, reduce-scattered and all-gathered, one collective pair a step;
* :func:`owner_shard` / :func:`gather_shards` (:func:`owner_sharded_map`,
  :func:`owner_sharded_map_quant`): the owner-sharded inversions, each
  worker inverting its chunk of a bank's flattened (slot x stack) slices
  and the chunks recombined in worker order.

A dist spec is the reference's static ``((axis_name, axis_size), ...)``.
Where the reference runs inside ``shard_map`` over those axes, the port
runs one process per worker in the ``torch.distributed`` world group,
whose size is the spec's world.  The worker index is the rank, row-major over the spec's axes, which is
the order in which multi-axis ``all_gather`` concatenates in the
reference: with ``(("pod", 2), ("data", 2))`` rank ``pod * 2 + data``.
Indices, liveness and chunk offsets are host ints here (the reference's
are traced scalars), so a shard is a plain slice; the liveness and owner
rules are ``core/stats.py``'s (``live_mask``, ``owner_chunk``,
``survivor_rank``), which ``bucket_owner_map`` shares.

**Transport** (:func:`transport`), chosen from the backend and the
tensors' device: NCCL moves CUDA tensors, gloo moves CPU tensors, and gloo
with CUDA tensors stages each collective through host buffers (torch
2.13's gloo has no reduce-scatter or all-gather of CUDA tensors; 2.11's
ran them).  The staged transport
exists so that several ranks can share one card; the kernels still run on
the card, but a CUDA graph cannot hold the host copies.  Any other pair
raises.  All three use ``reduce_scatter_tensor`` / ``all_gather_into_tensor``
/ ``all_reduce``, which torch 2.11 and later have for both backends.

**Wire accounting** (:func:`wire_log`): while a caller holds a
:class:`WireLog` open, every call through :func:`transport` is recorded
(:class:`WireRecord`: op, dtype, shape, element count, bytes on the wire,
what the payload is and whether it belongs to a bucket's phase-step
inversion), and each data-parallel step marks where it starts
(:func:`note_step`).  Bytes on the wire are the operand's: the full
buffer of a reduce-scatter or an all-reduce, the local shard of an
all-gather.  The stat payload is rounded to bf16 and summed as fp32, so
4 bytes an element cross the wire, twice the reference's bf16 width
(``core/stats.py`` ``bucket_comm_cost`` takes either).  Whether each fp32
stat payload was bf16-exact when it left is counted on the payload's
device, in the log's counter, with no host sync; the caller reads it once
after the run (:meth:`WireLog.inexact_stats`).  The log changes no
collective.  A CUDA graph capture records what the step would send and
captures the exactness count with the step; the chunk runner moves the
records to each replay (:func:`wire_mark`, :func:`wire_rewind`,
:func:`wire_credit`), as it does the kernel launch counts, and each
replay's step mark says it was replayed.  A log open across a capture
needs its counter on the device before the capture
(``wire_log(device)``).  ``analysis/contracts.py`` reads the log.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.core import stats as statlib
from repro_torch.tree import tree_leaves, tree_map

DistSpec = Tuple[Tuple[str, int], ...]
LiveMask = Tuple[bool, ...]

# The wire contract (the reference's): rank-1 stat payloads are quantized
# to the factor dtype before the reduction, every mean reduction
# accumulates in fp32, and the int8 owner-gather ships codes.
RANK1_PAYLOAD_DTYPE = "bfloat16"
ACCUM_DTYPE = "float32"
QUANT_WIRE_DTYPE = "int8"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def dist_axes() -> DistSpec:
    """The dist spec of the process group: ``(("data", size),)``."""
    return (("data", tdist.get_world_size()),)


def world_size(dist: Optional[DistSpec]) -> int:
    if not dist:
        return 1
    w = 1
    for _, s in dist:
        w *= int(s)
    return w


def worker_index(dist: DistSpec) -> int:
    """This worker's row-major index over the dist axes: the rank.  Raises
    when the process group's size is not the spec's world."""
    size = tdist.get_world_size()
    if size != world_size(dist):
        raise ValueError(f"dist spec {dist} has world {world_size(dist)}, "
                         f"the process group {size}")
    return tdist.get_rank()


# --------------------------------------------------------------------- #
# Transport
# --------------------------------------------------------------------- #
class _Native:
    """The backend's own collectives on the tensors' device."""

    def all_reduce(self, x: torch.Tensor,
                   op=tdist.ReduceOp.SUM) -> torch.Tensor:
        tdist.all_reduce(x, op=op)
        return x

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor) -> None:
        tdist.reduce_scatter_tensor(out, x)

    def all_gather(self, out: torch.Tensor, x: torch.Tensor) -> None:
        tdist.all_gather_into_tensor(out, x.contiguous())


class _HostStaged(_Native):
    """gloo with CUDA tensors: each collective on host copies, the result
    copied back to the tensors' device."""

    def all_reduce(self, x: torch.Tensor,
                   op=tdist.ReduceOp.SUM) -> torch.Tensor:
        host = x.cpu()
        tdist.all_reduce(host, op=op)
        return x.copy_(host)

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor) -> None:
        host = torch.empty(out.shape, dtype=out.dtype)
        tdist.reduce_scatter_tensor(host, x.cpu())
        out.copy_(host)

    def all_gather(self, out: torch.Tensor, x: torch.Tensor) -> None:
        host = torch.empty(out.shape, dtype=out.dtype)
        tdist.all_gather_into_tensor(host, x.cpu())
        out.copy_(host)


@dataclass(frozen=True)
class WireRecord:
    """One collective as it crossed the wire.  ``op``: ``all_reduce``,
    ``reduce_scatter``, ``all_gather`` (or ``step``, the start of a step,
    with ``what`` ``replay`` where the step was captured and replayed);
    ``what``: ``stats`` (the rank-1 stat payload), ``grad`` (the flat
    gradient halves), ``mean`` (a scalar or metric mean),
    ``owner_gather`` (recombined inversion chunks), ``agree`` (the elastic
    span agreement); ``phase``: made by a bucket's phase-step
    inversion."""
    op: str
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    numel: int = 0
    nbytes: int = 0
    what: str = ""
    phase: bool = False


class WireLog:
    """The records of every collective since the log was opened, and, on
    each device, the count of fp32 stat payloads that were not
    bf16-exact."""

    def __init__(self, device=None):
        self.records: List[WireRecord] = []
        self._inexact: Dict[torch.device, torch.Tensor] = {}
        if device is not None:
            self._counter(torch.device(device))

    def _counter(self, device: torch.device) -> torch.Tensor:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._inexact:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a wire log open across a CUDA graph capture counts on "
                    f"{device}: open it with wire_log({device!s})")
            self._inexact[device] = torch.zeros((), dtype=torch.int32,
                                                device=device)
        return self._inexact[device]

    def inexact_stats(self) -> int:
        """fp32 stat payloads that left not bf16-exact, replays included
        (one host read a device)."""
        return sum(int(t) for t in self._inexact.values())

    def steps(self) -> List[List[WireRecord]]:
        """The records split at each step mark; what came before the first
        mark is dropped."""
        out: List[List[WireRecord]] = []
        for r in self.records:
            if r.op == "step":
                out.append([])
            elif out:
                out[-1].append(r)
        return out

    def replayed(self) -> List[bool]:
        """For each of :meth:`steps`, whether it was a graph replay."""
        return [r.what == "replay" for r in self.records if r.op == "step"]


_LOGS: List[WireLog] = []
_CONTEXT = [("", False)]            # (what, phase) of the calls being made


@contextlib.contextmanager
def wire_log(device=None):
    """Record every collective made through :func:`transport` while the
    block runs; yields the :class:`WireLog` (its exactness counter on
    ``device`` made now, as a graph capture within the block needs)."""
    log = WireLog(device)
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def _wire(what: str, phase: Optional[bool] = None):
    _CONTEXT.append((what, _CONTEXT[-1][1] if phase is None else phase))
    try:
        yield
    finally:
        _CONTEXT.pop()


def wire_context() -> Tuple[str, bool]:
    """(what, phase) of the collective being made (see
    :class:`WireRecord`)."""
    return _CONTEXT[-1]


def note_step() -> None:
    """Mark the start of a step in every open log (a step being captured
    is marked as a replay: its records reach the log only by replays)."""
    if not _LOGS:
        return
    captured = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    for log in _LOGS:
        log.records.append(WireRecord("step",
                                      what="replay" if captured else ""))


def wire_mark() -> List[int]:
    """The length of every open log, for :func:`wire_rewind`."""
    return [len(log.records) for log in _LOGS]


def wire_rewind(mark: List[int]):
    """Drop what each open log recorded since ``mark`` and return it (a
    graph capture's records)."""
    added = []
    for log, n in zip(_LOGS, mark):
        added.append(log.records[n:])
        del log.records[n:]
    return added


def wire_credit(added) -> None:
    """Record one replay of a captured graph: its capture's records."""
    for log, recs in zip(_LOGS, added):
        log.records.extend(recs)


def _record(op: str, x: torch.Tensor) -> None:
    what, phase = _CONTEXT[-1]
    if what == "stats" and x.dtype == torch.float32:
        inexact = (x != x.to(torch.bfloat16).float()).any()
        for log in _LOGS:
            log._counter(x.device).add_(inexact)
    rec = WireRecord(op, str(x.dtype).replace("torch.", ""),
                     tuple(x.shape), x.numel(),
                     x.numel() * x.element_size(), what, phase)
    for log in _LOGS:
        log.records.append(rec)


class _Logged:
    """A transport that records each call in the open logs, then makes
    it unchanged."""

    def __init__(self, inner):
        self.inner = inner

    def all_reduce(self, x, op=tdist.ReduceOp.SUM):
        _record("all_reduce", x)
        return self.inner.all_reduce(x, op=op)

    def reduce_scatter(self, out, x):
        _record("reduce_scatter", x)
        self.inner.reduce_scatter(out, x)

    def all_gather(self, out, x):
        _record("all_gather", x)
        self.inner.all_gather(out, x)


def transport(device: torch.device):
    """The collectives for tensors on ``device``: NCCL on
    CUDA tensors and gloo on CPU tensors natively, gloo on CUDA tensors
    staged through the host.  Any other backend and device raise.  While a
    :func:`wire_log` is open, each call is recorded first."""
    backend = str(tdist.get_backend())
    kind = torch.device(device).type
    if (backend, kind) in (("nccl", "cuda"), ("gloo", "cpu")):
        inner = _Native()
    elif (backend, kind) == ("gloo", "cuda"):
        inner = _HostStaged()
    else:
        raise ValueError(
            f"no transport for {kind} tensors over a {backend} process "
            "group (NCCL takes CUDA tensors, gloo CPU tensors, or CUDA "
            "tensors staged through the host)")
    return _Logged(inner) if _LOGS else inner


# --------------------------------------------------------------------- #
# Mean reductions
# --------------------------------------------------------------------- #
def pmean(x: torch.Tensor, dist: DistSpec) -> torch.Tensor:
    """Mean over the data workers, accumulated in fp32 (ACCUM_DTYPE)."""
    acc = x.to(_DTYPES[ACCUM_DTYPE]).clone()
    with _wire("mean"):
        acc = transport(x.device).all_reduce(acc)
    return (acc / world_size(dist)).to(x.dtype)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over every rank of the group, in place
    (the elastic supervisor's span-boundary agreement,
    ``training/resilience.py``)."""
    with _wire("agree"):
        return transport(x.device).all_reduce(x, op=tdist.ReduceOp.MAX)


def pmean_rank1_stats(stats, dist: DistSpec,
                      payload_dtype: Optional[str] = RANK1_PAYLOAD_DTYPE):
    """Synchronize ONLY the rank-1 statistics: each dense layer's ``"a"``
    (E[a]) is mean-reduced and the full-stat leaves (``"A"``, ``"G"``) are
    dropped from the tree.  ``payload_dtype`` quantizes the payload
    (default bf16, the factor dtype); the sum runs in fp32.  ``None`` skips
    the quantization (the bit-tight mode)."""
    pd = _DTYPES[payload_dtype] if payload_dtype is not None else None

    def reduce_a(a):
        payload = a.to(pd) if pd is not None else a
        acc = payload.to(_DTYPES[ACCUM_DTYPE]).clone()
        with _wire("stats"):
            acc = transport(a.device).all_reduce(acc)
        return (acc / world_size(dist)).to(a.dtype)

    def walk(node):
        if isinstance(node, dict):
            if isinstance(node.get("a"), torch.Tensor):
                return {"a": reduce_a(node["a"])}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(stats)


def flat_reduce_scatter_mean(tree, dist: DistSpec):
    """First half of the flat gradient mean: every leaf raveled into one
    fp32 buffer (zero-padded to a multiple of the world), reduce-scattered
    and divided by the world, leaving worker i its mean shard i.  Returns
    ``(shard, spec)``; ``spec`` is the unflatten recipe for
    :func:`flat_all_gather_tree`."""
    leaves = tree_leaves(tree)
    spec = (tree, [(t.shape, t.dtype) for t in leaves])
    if not leaves:
        return None, spec
    w = world_size(dist)
    flat = torch.cat([t.to(torch.float32).reshape(-1) for t in leaves])
    pad = (-flat.numel()) % w
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // w)
    with _wire("grad"):
        transport(flat.device).reduce_scatter(shard, flat)
    return shard.div_(w), spec


def flat_all_gather_tree(shard, spec, dist: DistSpec):
    """Second half: all-gather the mean shards in worker order, drop the
    pad, and split back into the tree's leaves (shapes and dtypes from
    ``spec``)."""
    tree, metas = spec
    if not metas:
        return tree
    full = shard.new_empty(shard.numel() * world_size(dist))
    with _wire("grad"):
        transport(shard.device).all_gather(full, shard)
    out, off = [], 0
    for shape, dtype in metas:
        k = 1
        for d in shape:
            k *= d
        out.append(full[off:off + k].reshape(shape).to(dtype))
        off += k
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def all_reduce_mean_tree(tree, dist: DistSpec):
    """The flat gradient mean: :func:`flat_reduce_scatter_mean` then
    :func:`flat_all_gather_tree` (the dist step calls the halves itself to
    put the stat pmean between them)."""
    shard, spec = flat_reduce_scatter_mean(tree, dist)
    return flat_all_gather_tree(shard, spec, dist)


# --------------------------------------------------------------------- #
# Owner-sharded factor inversions, liveness
# --------------------------------------------------------------------- #
def normalize_live(dist: Optional[DistSpec],
                   live: Optional[LiveMask]) -> LiveMask:
    """Validated per-worker liveness tuple (``None``: every worker live)."""
    return statlib.live_mask(world_size(dist), live)


def n_live(dist: Optional[DistSpec],
           live: Optional[LiveMask] = None) -> int:
    return sum(normalize_live(dist, live))


def survivor_index(dist: DistSpec, live: Optional[LiveMask] = None) -> int:
    """This worker's rank among the live workers (0 for a dead worker,
    whose result never reaches the recombined bank)."""
    return statlib.survivor_rank(normalize_live(dist, live),
                                 worker_index(dist))


def is_live(dist: DistSpec, live: Optional[LiveMask] = None) -> bool:
    return normalize_live(dist, live)[worker_index(dist)]


def effective_live(dist: Optional[DistSpec],
                   live: Optional[LiveMask]) -> Optional[LiveMask]:
    """A fully live mask as ``None``, so the all-live step is the static
    step."""
    if live is None:
        return None
    mask = normalize_live(dist, live)
    return None if all(mask) else mask


owner_chunk = statlib.owner_chunk


def owner_shard(x: torch.Tensor, dist: DistSpec,
                live: Optional[LiveMask] = None) -> torch.Tensor:
    """This worker's owned chunk of a dim-0-leading array: dim 0 padded
    with zeros to ``n_live * chunk`` (zero slots are inert through
    stabilize and the SMW kernels: a zero factor with a zero vector, or a
    window count of 0), then this worker's ``chunk`` rows at its
    (survivor-)rank offset.  Dead workers take offset 0."""
    nl = n_live(dist, live)
    chunk = owner_chunk(x.shape[0], nl)
    padded = nl * chunk
    if padded > x.shape[0]:
        x = torch.cat([x, x.new_zeros((padded - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    off = survivor_index(dist, live) * chunk
    return x[off:off + chunk]


def gather_shards(x: torch.Tensor, dist: DistSpec, n_slots: int,
                  live: Optional[LiveMask] = None) -> torch.Tensor:
    """Recombine the owned chunks into the full bank dim (the reference's
    static rule).  Every worker live and ``(n_live - 1) · chunk ≤ 2 ·
    n_slots``: one all-gather, in worker order, the padded tail dropped.
    Otherwise each live worker writes its chunk at its survivor-rank
    offset into a zero buffer (a dead worker writes nothing) and one sum
    all-reduce combines them: each slot has one non-zero contributor, so
    the sum is exact."""
    live = effective_live(dist, live)
    mask = normalize_live(dist, live)
    nl = sum(mask)
    chunk = x.shape[0]
    t = transport(x.device)
    if live is None and (nl - 1) * chunk <= 2 * n_slots:
        full = x.new_empty((nl * chunk,) + tuple(x.shape[1:]))
        with _wire("owner_gather", phase=True):
            t.all_gather(full, x)
        return full[:n_slots]
    buf = x.new_zeros((nl * chunk,) + tuple(x.shape[1:]))
    if mask[worker_index(dist)]:
        off = survivor_index(dist, mask) * chunk
        buf[off:off + chunk] = x
    with _wire("owner_gather", phase=True):
        return t.all_reduce(buf[:n_slots].contiguous())


def owner_sharded_map(fn: Callable, arrays, dist: DistSpec, n_slots: int,
                      live: Optional[LiveMask] = None) -> torch.Tensor:
    """Slice each array's owned chunk (:func:`owner_shard`), apply ``fn``
    to the chunks (one array out, dim 0 the chunk's), and recombine
    (:func:`gather_shards`).  Padded slots reach ``fn`` and must be
    inert."""
    chunks = [owner_shard(x, dist, live) for x in arrays]
    return gather_shards(fn(*chunks), dist, n_slots, live)


def owner_sharded_map_quant(fn: Callable, arrays, dist: DistSpec,
                            n_slots: int, live: Optional[LiveMask] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`owner_sharded_map` whose ``fn`` returns a quantized chunk,
    ``(codes int8, scales fp32)``; both are recombined, so the gathered
    codes are the stored codes on every worker.  Codes of any other dtype
    raise ``TypeError``."""
    chunks = [owner_shard(x, dist, live) for x in arrays]
    codes, scales = fn(*chunks)
    if codes.dtype != _DTYPES[QUANT_WIRE_DTYPE]:
        raise TypeError(f"quantized owner-gather payload must be "
                        f"{QUANT_WIRE_DTYPE}, got {codes.dtype}")
    return (gather_shards(codes, dist, n_slots, live),
            gather_shards(scales, dist, n_slots, live))
