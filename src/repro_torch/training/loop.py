"""The train step: loss, gradients, MKOR stat plumbing, optimizer glue,
the data-parallel step and the chunk runner (port of
``repro/training/loop.py``).

One step is Algorithm 1 end to end: forward (capturing E[a]) → backward
(probe gradients = E[g]) → MKOR factor update + preconditioning → backend
optimizer → parameter update.  PyTorch runs eagerly, so there is no jit.

The chunk runner (:func:`make_chunk_runner`, :func:`train_epoch`) takes
the place of the reference's jitted ``lax.scan`` over a chunk of steps.
On a CUDA device each step of a chunk is a replay of a CUDA graph of the
whole step (forward, backward, MKOR and LAMB), with one metrics fetch per
chunk; on the CPU it runs the same steps eagerly.  What a graph would
freeze lives on the host: the optimizer's ``plan(state)`` gives the key
of the step's host branches (MKOR's ``count % inv_freq``) and its
per-step scalars (LAMB's learning rate and bias corrections).  The runner
runs a key's first step eagerly, captures one graph per key the second
time the key comes up, writes the scalars into device buffers before
each replay, and advances the state's host counts itself.

An optimizer that branches on device state (MKOR-H's sticky switch) has
``observe(state)``, a device read of that state into a host *view*.  The
runner reads it once a chunk, at the chunk's start, right after the
previous chunk's metrics fetch (the device is idle then), and passes it
as ``view=`` to ``plan`` (it is part of the key) and to every step of
the chunk (``train_step(..., view=)``, which hands it to ``precompute``
and ``update``).  A switch that flips inside a chunk takes effect in the
next one; the optimizer keeps the steps in between exact on the device.
The per-step loop (``train_step`` called without a view) reads the view
once a step.

The data-parallel step (:func:`make_dist_step_fn`,
:func:`make_dist_train_step`) runs in each process of a
``torch.distributed`` group with the same signature as the single-device
step: it takes the global batch, keeps this rank's rows, and makes every
wire byte explicit (``sharding/collectives.py``): the loss mean, the
gradients as one flat reduce-scatter and all-gather pair with the rank-1
stat mean between the halves, and, when the optimizer carries
``MKORConfig.dist``, the owner-sharded inversions inside ``update``.  Params
and optimizer state are replicated: every rank holds the same bits.  On
NCCL the collectives run on the current stream, so the chunk runner
captures them in its graphs; gloo with CUDA tensors stages them through
the host, which a graph cannot hold.
"""
from __future__ import annotations

import gc
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import firstorder
from repro_torch.core.firstorder import GradientTransformation
from repro_torch.kernels import build
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives
from repro_torch.training import phases
from repro_torch.tree import tree_leaves, tree_map


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  The mean reduction is what
    makes the probe-gradient identity exact (models/layers.py)."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_id, torch.zeros_like(labels), labels)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    valid = labels != ignore_id
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / \
        torch.clamp(valid.sum(), min=1).float()


def _as_tensor(x) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if t.is_floating_point() else t.long()


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch → tensors on ``device`` (integers, the token ids,
    as int64)."""
    return {k: _as_tensor(v).to(device) for k, v in batch.items()}


def text_prefix_len(cfg: ModelConfig) -> int:
    """Positions occupied by the multimodal prefix in decoder-only VLMs."""
    if cfg.frontend != "none" and not cfg.is_encoder_decoder:
        return cfg.frontend_len
    return 0


def make_loss_fn(cfg: ModelConfig, *, collect_stats: bool = True) -> Callable:
    n_prefix = text_prefix_len(cfg)

    def loss_fn(params, batch):
        logits, aux = model_lib.forward(params, cfg, batch,
                                        collect_stats=collect_stats)
        # a VLM's labels cover its text positions only
        text_logits = logits[:, n_prefix:] if n_prefix else logits
        loss_lm = lm_loss(text_logits, batch["labels"])
        loss = loss_lm + aux["moe_aux"]
        return loss, {"stats": aux["stats"], "loss_lm": loss_lm,
                      "moe_aux": aux["moe_aux"].detach()}
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, aux), grads)`` like ``jax.value_and_grad(has_aux=True)``:
    gradients of every parameter leaf, as a tree shaped like ``params``."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p_req = tree_map(lambda _: next(it), params)
    loss, aux = loss_fn(p_req, batch)
    phases.mark("backward", loss.device)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(zip(grads, live))

    def fill(_):
        g, t = next(it)
        return torch.zeros_like(t) if g is None else g
    return (loss.detach(), aux), tree_map(fill, params)


def _mark_first_order(opt_state, device) -> None:
    """The ``first_order`` mark before a first-order optimizer's update.
    An optimizer that carries a backend's state (MKOR, Eva) runs the
    backend itself and marks ``second_order`` and ``first_order`` inside
    its update."""
    if not (isinstance(opt_state, dict) and "backend" in opt_state):
        phases.mark("first_order", device)


def make_train_step(cfg: ModelConfig, optimizer: GradientTransformation,
                    *, collect_stats: bool = True) -> Callable:
    loss_fn = make_loss_fn(cfg, collect_stats=collect_stats)

    def train_step(params, opt_state, batch, scalars=None, view=None):
        """One step; ``scalars`` are the optimizer's per-step scalars as
        0-d device tensors (None: the optimizer makes them from its plan)
        and ``view`` its host view of its device state (None: read here
        with ``observe``, when the optimizer has one).
        ``train_step.plan`` and ``train_step.observe`` are the
        optimizer's."""
        if view is None and optimizer.observe is not None:
            view = optimizer.observe(opt_state)
        device = tree_leaves(params)[0].device
        phases.mark("forward", device)
        # two-phase protocol: the precompute tick consumes only carried
        # state, so it runs before the gradients exist (synchronous
        # optimizers have no precompute)
        precompute = optimizer.precompute is not None
        if precompute:
            opt_state = optimizer.precompute(opt_state, params=params,
                                             view=view)
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        _mark_first_order(opt_state, device)
        updates, opt_state = optimizer.update(
            grads, opt_state, params=params, stats=aux["stats"], loss=loss,
            precomputed=precompute, scalars=scalars, view=view)
        phases.mark("apply", device)
        params = firstorder.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            "loss_lm": aux["loss_lm"].detach(),
            "moe_aux": aux["moe_aux"],
            "grad_norm": firstorder.global_norm(grads),
            "update_norm": firstorder.global_norm(updates),
        }
        phases.mark("end", device)
        return params, opt_state, metrics

    train_step.plan = optimizer.plan
    train_step.observe = optimizer.observe
    return train_step


# ----------------------------------------------------------------------- #
# The explicit-collective data-parallel step
# ----------------------------------------------------------------------- #
def make_dist_step_fn(grads_fn: Callable, optimizer: GradientTransformation,
                      dist: collectives.DistSpec, *,
                      stats_payload_dtype: Optional[str] = "bfloat16"
                      ) -> Callable:
    """Wrap a local ``grads_fn(params, local_batch) -> (loss, grads, stats
    [, extra_metrics])`` into a data-parallel step over the process group
    (of ``dist``'s world size).

    The step takes the global batch: rank w keeps rows ``[w·B/W,
    (w+1)·B/W)`` of every batch leaf, the reference's sharding order, and
    a leading dim that the world does not divide raises.  In the
    reference's order: the optimizer's precompute tick, the local loss and
    gradients, the loss pmean, the gradients' reduce-scatter, the rank-1
    stat pmean (``stats_payload_dtype``: bf16 by default, ``None`` for the
    bit-tight mode), the all-gather, the update (owner-sharded inversions
    when the optimizer carries ``MKORConfig.dist``), ``apply_updates`` and
    the metrics.  Returns ``(params, opt_state, batch, scalars=None,
    view=None) -> (params, opt_state, metrics)``, interchangeable with
    :func:`make_train_step` (``plan`` and ``observe`` attached), so the
    chunk runner takes it unchanged."""
    world = collectives.world_size(dist)
    warm = []

    def step(params, opt_state, batch, scalars=None, view=None):
        for key, leaf in batch.items():
            if leaf.ndim == 0 or leaf.shape[0] % world:
                raise ValueError(
                    f"batch leaf {key!r} leading dim "
                    f"{leaf.shape[0] if leaf.ndim else None} does not "
                    f"divide the data world size {world}")
        rank = collectives.worker_index(dist)
        collectives.note_step()
        if not warm:
            # a collective before any graph capture: it sets up the
            # communicator, which a capture cannot do
            collectives.pmean(torch.zeros((), device=tree_leaves(params)[0]
                                          .device), dist)
            warm.append(True)
        local = {k: v[rank * (v.shape[0] // world):
                      (rank + 1) * (v.shape[0] // world)]
                 for k, v in batch.items()}
        if view is None and optimizer.observe is not None:
            view = optimizer.observe(opt_state)
        device = tree_leaves(params)[0].device
        phases.mark("forward", device)
        precompute = optimizer.precompute is not None
        if precompute:
            opt_state = optimizer.precompute(opt_state, params=params,
                                             view=view)
        out = grads_fn(params, local)
        loss, grads, stats = out[:3]
        extra = out[3] if len(out) > 3 else {}
        loss = collectives.pmean(loss, dist)
        # the gradient mean as its two halves, the O(d) stat mean between
        shard, spec = collectives.flat_reduce_scatter_mean(grads, dist)
        stats = collectives.pmean_rank1_stats(
            stats, dist, payload_dtype=stats_payload_dtype)
        grads = collectives.flat_all_gather_tree(shard, spec, dist)
        _mark_first_order(opt_state, device)
        updates, opt_state = optimizer.update(
            grads, opt_state, params=params, stats=stats, loss=loss,
            precomputed=precompute, scalars=scalars, view=view)
        phases.mark("apply", device)
        params = firstorder.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            **{k: collectives.pmean(v, dist)
               for k, v in extra.items()},
            "grad_norm": firstorder.global_norm(grads),
            "update_norm": firstorder.global_norm(updates),
        }
        phases.mark("end", device)
        return params, opt_state, metrics

    step.plan = optimizer.plan
    step.observe = optimizer.observe
    return step


def make_dist_train_step(cfg: ModelConfig,
                         optimizer: GradientTransformation,
                         dist: collectives.DistSpec, *,
                         collect_stats: bool = True,
                         stats_payload_dtype: Optional[str] = "bfloat16"
                         ) -> Callable:
    """The data-parallel :func:`make_train_step` (the launcher's
    ``--dist``): the same signature and metrics, explicit collectives.
    Build MKOR with ``MKORConfig(dist=dist)`` to owner-shard its
    inversions over the same process group."""
    loss_fn = make_loss_fn(cfg, collect_stats=collect_stats)

    def local_grads(params, batch):
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        return loss, grads, aux["stats"], {
            "loss_lm": aux["loss_lm"].detach(), "moe_aux": aux["moe_aux"]}

    return make_dist_step_fn(local_grads, optimizer, dist,
                             stats_payload_dtype=stats_payload_dtype)


# ----------------------------------------------------------------------- #
# The chunk runner
# ----------------------------------------------------------------------- #
def chunk_schedule(n_steps: int, chunk: int) -> List[int]:
    """Chunk lengths for an ``n_steps`` run at chunk size ``chunk`` (clamped
    to 1): full chunks and at most one trailing partial one."""
    chunk = max(chunk, 1)
    full, rem = divmod(max(n_steps, 0), chunk)
    return [chunk] * full + ([rem] if rem else [])


def stack_batches(batches: Sequence[Dict]) -> Dict:
    """Stack same-shaped numpy batch dicts along a new leading axis, on the
    host."""
    return tree_map(lambda *xs: np.stack(xs), *batches)


class GraphCaptureError(RuntimeError):
    """The train step could not be captured as a CUDA graph."""


def _capture_failure(exc: BaseException) -> str:
    """Where a capture failed: the first exception of the chain (a failed
    capture also fails the capture's end), at its deepest frame outside
    torch and the standard library, with that line of source."""
    while (exc.__cause__ or exc.__context__) is not None:
        exc = exc.__cause__ or exc.__context__
    skip = (str(Path(torch.__file__).parent), str(Path(traceback.__file__)
                                                  .parent))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(skip)]
    where = f"{frames[-1].filename}:{frames[-1].lineno} `{frames[-1].line}`" \
        if frames else "an unknown line"
    first = str(exc).strip().splitlines()
    return (f"CUDA graph capture of the train step failed at {where}: "
            f"{type(exc).__name__}: {first[0] if first else ''}")


def _host_leaf(t: torch.Tensor) -> bool:
    """A leaf the chunk runner keeps on the host: a CPU tensor (the state's
    step counts)."""
    return t.device.type == "cpu"


# The chunk runners' set-up counts, over every runner of the process:
# graphs captured, eager warm-ups, host seconds in warm-ups and captures
# (each ending in a synchronize), and the graph pool's growth in bytes
# (the device's reserved bytes right after each capture less right after
# the cache was emptied before it).  Read with :func:`runner_counts`.
_RUNNER_COUNTS = dict(graphs=0, warm_ups=0, capture_s=0.0, pool_bytes=0)
_RUNNER_BY_KEY: Dict = {}
SPAN = "repro_torch.runner."      # the runner's profiler ranges


def runner_counts(by_key: bool = False) -> Dict:
    """The chunk runners' set-up counts (``graphs``, ``warm_ups``,
    ``capture_s``, ``pool_bytes``) since the last reset; with ``by_key``,
    the same counts for each graph key (the optimizer's plan key).  The
    CPU's eager steps count nothing."""
    if by_key:
        return {k: dict(v) for k, v in _RUNNER_BY_KEY.items()}
    return dict(_RUNNER_COUNTS)


def reset_runner_counts() -> None:
    for k in _RUNNER_COUNTS:
        _RUNNER_COUNTS[k] = 0
    _RUNNER_BY_KEY.clear()


def _count_setup(key, **add) -> None:
    row = _RUNNER_BY_KEY.setdefault(key, dict.fromkeys(_RUNNER_COUNTS, 0))
    for k, v in add.items():
        _RUNNER_COUNTS[k] += v
        row[k] += v


class _Graph:
    """One captured step: the graph, the host counts' change per step, the
    kernel launches (and GEMM cores) and the wire records its capture
    recorded."""

    def __init__(self, graph, delta, counts, wire=()):
        self.graph, self.delta, self.counts = graph, delta, counts
        self.wire = wire


class ChunkRunner:
    """``runner(params, opt_state, stacked) -> (params, opt_state,
    stacked_metrics)``: ``stacked`` is a dict of numpy arrays with the
    chunk's steps on the leading axis (:func:`stack_batches`), and
    ``stacked_metrics`` a dict of CPU float tensors of the chunk's length.

    On a CUDA device the runner keeps static buffers: the parameters and
    the optimizer state's device leaves (the caller's own tensors with
    ``donate=True``, written in place; copies with ``donate=False``, which
    leaves the caller's tensors untouched), one batch, the per-step
    scalars and a metrics row.  The state's CPU leaves (the step counts)
    stay on the host.  With ``step_fn.observe`` it reads the host view
    once, at the chunk's start (module docstring).  For each step it
    copies the step's batch into the static batch, writes the scalars of
    ``step_fn.plan`` and replays the graph of the plan's key.  The first
    time a key comes up, the step runs eagerly on a side stream (the
    warm-up a capture needs; its result is the step's); the second time,
    it is captured and then replayed, so that no eager step runs beside a
    pool that has grown to hold a graph.  Every key's graph is captured
    into one memory pool: replays run one at a time on one stream, and the
    graph writes every result into the static buffers, so no pool block
    outlives a replay.  The buffers that the runner writes or reads
    outside a graph are allocated outside the pool.  A capture that fails
    raises :class:`GraphCaptureError`; nothing carries on eagerly.  Each
    replay is credited with the kernel launches its capture recorded.  The
    metrics come to the host once per chunk.  The step's ``end`` phase
    mark follows the write-back (``training/phases.py``); while a profiler
    runs, the runner's parts show as ranges ``repro_torch.runner.<part>``
    (bind, observe, batch_to_device, plan, replay, fetch, warm_up,
    capture); :func:`runner_counts` counts the warm-ups and captures.

    On the CPU (a device the caller asked for), or with ``capture=False``
    (a step whose collectives a graph cannot hold: gloo staged through the
    host), the runner runs the same steps eagerly, one after another, with
    the view read the same way.

    :meth:`release` frees the graphs, the static buffers and the pool;
    ``training/resilience.py`` ``elastic_train`` releases a runner before
    it builds the next one for a new liveness mask."""

    def __init__(self, step_fn: Callable, *, donate: bool = True,
                 capture: bool = True):
        self.step_fn, self.donate, self.capture = step_fn, donate, capture
        self.graphs: Dict = {}
        self._warmed: Dict = {}        # keys warmed up, not yet captured
        self.pool = None
        self.host: List[int] = []      # the state's host counts, as it runs
        self._template = None
        self._view: Dict = {}          # ``view=`` of this chunk's steps

    def __call__(self, params, opt_state, stacked):
        n = len(next(iter(stacked.values())))
        device = tree_leaves(params)[0].device
        if device.type != "cuda" or not self.capture:
            return self._eager_chunk(params, opt_state, stacked, n, device)
        return self._graph_chunk(params, opt_state, stacked, n, device)

    def release(self) -> None:
        """Drop the graphs, the static buffers, the batch, scalar and
        metrics buffers and the graph pool, then return the freed blocks
        to the device (``torch.cuda.empty_cache``).  A later call binds and
        captures anew."""
        self.graphs.clear()
        self._warmed.clear()
        self.pool = None
        self.host, self._template, self._view = [], None, {}
        for name in ("_static", "_storages", "_batch", "_scalars", "_keys",
                     "_metrics", "_host_mask"):
            self.__dict__.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache()

    def _observe(self, opt_state) -> None:
        """Read the optimizer's host view of ``opt_state`` (the chunk's
        one device read besides its metrics fetch), if it has one."""
        observe = getattr(self.step_fn, "observe", None)
        self._view = {} if observe is None else {"view": observe(opt_state)}

    def _eager_chunk(self, params, opt_state, stacked, n, device):
        rows = []
        self._observe(opt_state)
        for k in range(n):
            batch = batch_to_device({key: v[k] for key, v in stacked.items()},
                                    device)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch, **self._view)
            rows.append(metrics)
        return params, opt_state, {
            key: torch.stack([m[key].detach().float().cpu() for m in rows])
            for key in rows[0]}

    # --- CUDA: static buffers, capture and replay ----------------------- #
    def _bind(self, params, opt_state, stacked, device):
        """Point the static buffers at this call's params and state (and
        read its host counts)."""
        tree = (params, opt_state)
        if self._template is not None:      # leaves in the first call's order
            tree = tree_map(lambda _, t: t, self._template, tree)
        leaves = tree_leaves(tree)
        host = [_host_leaf(t) for t in leaves]
        if self._template is None:
            # the tree's structure (its leaves' order), not its tensors
            self._template, self._host_mask = tree_map(lambda _: 0, tree), host
            seen, static = set(), []
            for t, on_host in zip(leaves, host):
                if on_host:
                    static.append(t)
                    continue
                key = t.untyped_storage().data_ptr()
                adopt = self.donate and key not in seen and t.is_contiguous()
                seen.add(key)
                static.append(t if adopt else t.clone())
            self._static = static
            self._storages = {t.untyped_storage().data_ptr()
                              for t, h in zip(static, host) if not h}
            self._batch = {k: torch.empty(v.shape[1:],
                                          dtype=_as_tensor(v[:0]).dtype,
                                          device=device)
                           for k, v in stacked.items()}
            self._scalars, self._keys, self._metrics = None, None, None
        else:
            if host != self._host_mask or len(leaves) != len(self._static):
                raise ValueError("the chunk runner's params and state must "
                                 "keep the tree of its first call")
            for t, s, on_host in zip(leaves, self._static, host):
                if on_host or t is s:
                    continue
                if t.shape != s.shape or t.dtype != s.dtype:
                    raise ValueError("the chunk runner's params and state "
                                     "must keep their shapes and dtypes")
                s.copy_(t)
            for k, v in stacked.items():
                if tuple(v.shape[1:]) != tuple(self._batch[k].shape):
                    raise ValueError(f"batch {k!r} changed shape")
        return [int(t) for t, h in zip(leaves, host) if h]

    def _tree_at(self, host_values):
        """(params, state) on the static buffers, with fresh host leaves
        holding ``host_values``."""
        vals = iter(host_values)
        leaves = [torch.tensor(next(vals), dtype=t.dtype) if h else t
                  for t, h in zip(self._static, self._host_mask)]
        it = iter(leaves)
        return tree_map(lambda _: next(it), self._template)

    def _write_back(self, new_params, new_state, metrics):
        """Write a step's results into the static buffers and return its
        host counts.  A result that is another static buffer (the
        staleness-1 tick promotes the pending bank to active) is copied
        aside before any buffer is written."""
        out = tree_leaves(tree_map(lambda _, o: o, self._template,
                                   (new_params, new_state)))
        pairs = []
        for s, o, h in zip(self._static, out, self._host_mask):
            if h or o is s or (o.data_ptr() == s.data_ptr()
                               and o.stride() == s.stride()):
                continue
            if o.untyped_storage().data_ptr() in self._storages:
                o = o.clone()
            pairs.append((s, o))
        for s, o in pairs:
            s.copy_(o)
        self._metrics.copy_(torch.stack(
            [metrics[k].detach().float().reshape(()) for k in self._keys]))
        return [int(o) for o, h in zip(out, self._host_mask) if h]

    def _write_scalars(self, values, device):
        if self._scalars is None:
            self._scalars = {k: torch.zeros((), dtype=torch.float32,
                                            device=device) for k in values}
        if set(values) != set(self._scalars):
            raise ValueError("the step's plan changed its scalars")
        for k, t in self._scalars.items():
            t.fill_(float(values[k]))

    def _warm_up(self, host_values, device, key) -> List[int]:
        """The first step of a key: run it eagerly on a side stream (the
        warm-up a capture needs; its result is the step's, written into the
        static buffers).  Returns its change of the host counts."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), phases.runner_step(device):
            out = self.step_fn(*self._tree_at(host_values), self._batch,
                               scalars=self._scalars, **self._view)
            if self._keys is None:
                self._keys = list(out[2])
                self._metrics = torch.empty(len(self._keys),
                                            dtype=torch.float32,
                                            device=device)
            delta = [o - h for o, h in zip(self._write_back(*out),
                                           host_values)]
        current.wait_stream(side)
        torch.cuda.synchronize(device)
        _count_setup(key, warm_ups=1, capture_s=time.perf_counter() - t0)
        return delta

    def _capture(self, host_values, delta, device, key) -> _Graph:
        """Capture the step of a key whose warm-up ran before (its host
        counts' change ``delta``), from the host state at hand; the capture
        runs nothing, so the static buffers stay as they were.  The cached
        blocks of the eager steps go back to the device first: a capture
        cannot free cached memory when it runs short."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        mark = build.count_mark()
        wire = collectives.wire_mark()
        try:
            with torch.cuda.graph(graph, pool=self.pool), \
                    phases.runner_step(device):
                out = self.step_fn(*self._tree_at(host_values), self._batch,
                                   scalars=self._scalars, **self._view)
                captured = [o - h for o, h in zip(self._write_back(*out),
                                                  host_values)]
        except Exception as exc:
            # a failed capture leaves the capture stream current
            torch.cuda.set_stream(current)
            build.rewind_counts(mark)
            collectives.wire_rewind(wire)
            raise GraphCaptureError(_capture_failure(exc)) from exc
        del out
        counts = build.rewind_counts(mark)
        if captured != delta:
            raise GraphCaptureError(
                f"the captured step moves the host counts by {captured}, "
                f"the eager step by {delta}")
        grown = torch.cuda.memory_reserved(device) - reserved
        torch.cuda.synchronize(device)
        _count_setup(key, graphs=1, capture_s=time.perf_counter() - t0,
                     pool_bytes=grown)
        return _Graph(graph, delta, counts, collectives.wire_rewind(wire))

    def _replay(self, g: _Graph) -> None:
        g.graph.replay()
        build.credit_counts(g.counts)
        collectives.wire_credit(g.wire)

    def _graph_chunk(self, params, opt_state, stacked, n, device):
        plan = getattr(self.step_fn, "plan", None)
        if plan is None:
            raise ValueError("a CUDA chunk runner needs step_fn.plan (the "
                             "optimizer's plan: make_train_step sets it)")
        with phases.span(SPAN + "bind"):
            host = self.host = self._bind(params, opt_state, stacked, device)
        with phases.span(SPAN + "observe"):
            self._observe(self._tree_at(host)[1])
        with phases.span(SPAN + "batch_to_device"):
            batches = batch_to_device(stacked, device)   # one copy a chunk
        rows = None
        for k in range(n):
            with phases.span(SPAN + "plan"):
                key, values = plan(self._tree_at(host)[1], **self._view)
                for name, buf in self._batch.items():
                    buf.copy_(batches[name][k])
                self._write_scalars(values, device)
            g = self.graphs.get(key)
            if g is None and key in self._warmed:
                with phases.span(SPAN + "capture"):
                    g = self.graphs[key] = self._capture(
                        host, self._warmed.pop(key), device, key)
            if g is None:
                with phases.span(SPAN + "warm_up"):
                    delta = self._warmed[key] = self._warm_up(host, device,
                                                              key)
            else:
                with phases.span(SPAN + "replay"):
                    self._replay(g)
                delta = g.delta
            host = self.host = [h + d for h, d in zip(host, delta)]
            if rows is None:
                rows = torch.empty((n, len(self._keys)), dtype=torch.float32,
                                   device=device)
            rows[k].copy_(self._metrics)
        with phases.span(SPAN + "fetch"):
            rows = rows.cpu()                            # one fetch a chunk
        params, opt_state = self._tree_at(host)
        if not self.donate:
            params, opt_state = tree_map(
                lambda t: t if t.device.type == "cpu" else t.clone(),
                (params, opt_state))
        return params, opt_state, {k: rows[:, i]
                                   for i, k in enumerate(self._keys)}


def make_chunk_runner(step_fn: Callable, *, donate: bool = True,
                      capture: bool = True) -> ChunkRunner:
    """A ``(params, opt_state, stacked) -> (params, opt_state,
    stacked_metrics)`` runner of ``step_fn`` over a chunk of steps: CUDA
    graph replays on a CUDA device (unless ``capture=False``), eager steps
    on the CPU (:class:`ChunkRunner`)."""
    return ChunkRunner(step_fn, donate=donate, capture=capture)


def train_epoch(step_fn: Callable, params, opt_state, batches, *,
                chunk: int = 8, donate: bool = True,
                runner: Optional[Callable] = None,
                hooks: Optional[Callable[[int, Dict], None]] = None):
    """Run the numpy ``batches`` through ``step_fn`` in chunks of ``chunk``
    steps.  Metrics come to the host once per chunk and are split into
    per-step float dicts, so ``hooks(step_idx, metrics)`` fires in bursts at
    chunk boundaries.  A trailing partial chunk replays the same graphs.
    Returns (params, opt_state, history) like :func:`train_loop`.  Build
    the runner once (:func:`make_chunk_runner`) and pass it as ``runner``
    when calling this once per epoch: its graphs are captured once."""
    if runner is None:
        runner = make_chunk_runner(step_fn, donate=donate)
    history: List[Dict] = []

    def flush(buf):
        nonlocal params, opt_state
        params, opt_state, metrics = runner(params, opt_state,
                                            stack_batches(buf))
        for k in range(len(buf)):
            m = {key: float(v[k]) for key, v in metrics.items()}
            if hooks is not None:
                hooks(len(history), m)
            history.append(m)

    buf = []
    for batch in batches:
        buf.append(batch)
        if len(buf) == chunk:
            flush(buf)
            buf = []
    if buf:
        flush(buf)
    return params, opt_state, history


def train_loop(cfg: ModelConfig, optimizer: GradientTransformation,
               params, batches, *, jit: bool = True,
               hooks: Optional[Callable[[int, Dict], None]] = None):
    """The per-step loop over numpy ``batches`` on the parameters' device,
    with ``hooks`` fired every step (the reference's signature; the port
    has no jit, so ``jit`` changes nothing)."""
    step_fn = make_train_step(cfg, optimizer)
    device = tree_leaves(params)[0].device
    opt_state = optimizer.init(params)
    history = []
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(
            params, opt_state, batch_to_device(batch, device))
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if hooks is not None:
            hooks(i, metrics)
    return params, opt_state, history

