"""One rank of the port's data-parallel CPU tests, and the helper that
spawns a group of them.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE OUT

A rank joins a gloo group through the ``file://`` store STORE, runs every
scenario of the pickled JOB (a list of dicts, each with a ``"kind"``),
and pickles ``{scenario name: result}`` (numpy trees) to OUT.  It imports
only torch, numpy and the port, never JAX: the tests compare what the
ranks return with the JAX package in their own process.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def ae_batch(step, d_in=96, n=64):
    """The reference dist tests' batch (tests/test_dist.py ``_batch``)."""
    rng = np.random.default_rng(step)
    basis = np.random.default_rng(0).standard_normal((8, d_in)) / 3
    x = (rng.standard_normal((n, 8)) @ basis).astype(np.float32)
    return {"x": x, "y": x}


def run_ranks(tmp_path, world, scenarios, timeout=180):
    """Run ``scenarios`` on ``world`` spawned ranks; returns each rank's
    results, in rank order.  Raises with the ranks' output if one fails or
    the group outlives ``timeout`` seconds."""
    tmp_path = Path(tmp_path)
    job = tmp_path / f"job{world}.pkl"
    job.write_bytes(pickle.dumps(scenarios))
    store = tmp_path / f"store{world}"
    outs = [tmp_path / f"out{world}_{r}.pkl" for r in range(world)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(job), str(r), str(world), str(store),
         str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs, failed = [], False
    for p in procs:
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            log = "timed out\n" + log
            failed = True
        failed |= p.returncode != 0
        logs.append(log)
    if failed:
        raise RuntimeError("\n".join(f"--- rank {r}\n{log[-4000:]}"
                                     for r, log in enumerate(logs)))
    return [pickle.loads(o.read_bytes()) for o in outs]


# --------------------------------------------------------------------- #
# Scenarios
# --------------------------------------------------------------------- #
def _collectives(sc, world):
    from repro_torch.sharding import collectives as C
    dist = (("data", world),)
    rank = tdist.get_rank()
    out = {"worker_index": C.worker_index(dist)}
    if world == 4:
        # rank = pod * 2 + data, row-major over (("pod", 2), ("data", 2))
        idx = C.worker_index((("pod", 2), ("data", 2)))
        out["pod_data"] = (idx, idx // 2, idx % 2)
    tree = {k: torch.from_numpy(v[rank]) for k, v in sc["tree"].items()}
    out["all_reduce_mean"] = {
        k: v.numpy() for k, v in C.all_reduce_mean_tree(tree, dist).items()}
    stats = {"layers": [{k: torch.from_numpy(v[rank])
                         for k, v in sc["stats"].items()}]}
    for name, pd in (("stats_bf16", "bfloat16"), ("stats_fp32", None)):
        got = C.pmean_rank1_stats(stats, dist, payload_dtype=pd)
        out[name] = {k: v.numpy() for k, v in got["layers"][0].items()}
    rounds = {}
    for live in (None, sc["dead_mask"]):
        for n_slots in sc["n_slots"]:
            x = torch.arange(n_slots * 4, dtype=torch.float32).reshape(
                n_slots, 4)
            mine = C.owner_shard(x, dist, live=live)
            rounds[(live, n_slots)] = C.gather_shards(
                2.0 * mine, dist, n_slots, live=live).numpy()
            codes, scales = C.owner_sharded_map_quant(
                lambda c: (c.to(torch.int8), c[:, 0] * 0.5), [x], dist,
                n_slots, live=live)
            rounds[("quant", live, n_slots)] = (codes.numpy(),
                                                scales.numpy())
    out["rounds"] = rounds
    try:
        C.owner_sharded_map_quant(lambda c: (c, c[:, 0]), [x], dist, 3)
        out["type_error"] = None
    except TypeError as exc:
        out["type_error"] = str(exc)
    try:
        C.transport(torch.device("meta"))
        out["bad_transport"] = None
    except ValueError as exc:
        out["bad_transport"] = str(exc)
    return out


def _fc(sc, world):
    """One step of ``mkor(lamb)`` on a single dense layer (the config
    check of tests/test_torch_mkor.py) with ``MKORConfig(**sc["mkor"])``."""
    from repro_torch import interop
    from repro_torch.core import firstorder as fo
    from repro_torch.core import mkor as mk
    opt = mk.mkor(fo.lamb(1e-3), mk.MKORConfig(**sc["mkor"]))
    params = {"fc": {"w": torch.ones((8, 6)), "probe": torch.zeros(6)}}
    state = opt.init(params)
    grads = {"fc": {"w": torch.full((8, 6), 0.5), "probe": torch.ones(6)}}
    upd, state = opt.update(grads, state, params=params,
                            stats={"fc": {"a": torch.ones(8)}})
    return {"update": interop.tree_to_numpy(upd),
            "state": interop.tree_to_numpy(state)}


def _health(state):
    return {b: (int(h["trips"]), int(h["cooldown"]))
            for b, h in state["health"].items()}


def _ae(sc, world):
    """The reference test's autoencoder through the port's dist step: the
    loss, the health after every step, and the final params and state."""
    from repro_torch import interop
    from repro_torch.core import baseline_net
    from repro_torch.core import firstorder as fo
    from repro_torch.core import mkor as mk
    from repro_torch.training import chaos
    from repro_torch.training import loop
    dist = (("data", world),)
    mcfg = mk.MKORConfig(dist=dist, **sc["mkor"])
    opt = mk.mkor(fo.sgd(1e-2, momentum=0.9), mcfg)
    if sc.get("chaos"):
        opt = chaos.chaotic(opt, chaos.parse_chaos_spec(sc["chaos"]), mcfg)
    step = loop.make_dist_step_fn(baseline_net.grads_and_full_stats, opt,
                                  dist,
                                  stats_payload_dtype=sc.get("payload"))
    params = interop.params_from_numpy(sc["params"], CPU)
    state = opt.init(params)
    batches = [ae_batch(i, *sc.get("batch", ())) for i in range(sc["steps"])]
    out = {"losses": [], "health": []}
    if sc.get("chunk"):
        p0, s0 = params, state
    for b in batches:
        params, state, m = step(params, state,
                                loop.batch_to_device(b, CPU))
        out["losses"].append(float(m["loss"]))
        if mcfg.health:
            out["health"].append(_health(state))
    if sc.get("chunk"):
        pe, se, hist = loop.train_epoch(step, p0, s0, batches,
                                        chunk=sc["chunk"])
        flat = zip(_leaves((pe, se)), _leaves((params, state)))
        out["chunk_equal"] = (
            [h["loss"] for h in hist] == out["losses"]
            and all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in flat))
    out["params"] = interop.tree_to_numpy(params)
    out["state"] = interop.tree_to_numpy(state)
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _model(sc, world):
    """``make_dist_train_step`` on a model config: the losses and final
    params of ``sc["steps"]`` steps of mkor(lamb)."""
    from repro_torch import interop
    from repro_torch.core import firstorder as fo
    from repro_torch.core import mkor as mk
    from repro_torch.data import pipeline
    from repro_torch.training import loop
    dist = (("data", world),)
    opt = mk.mkor(fo.lamb(1e-3), mk.MKORConfig(inv_freq=1, dist=dist))
    step = loop.make_dist_train_step(sc["cfg"], opt, dist,
                                     stats_payload_dtype=None)
    params = interop.params_from_numpy(sc["params"], CPU)
    state = opt.init(params)
    ds = pipeline.make_dataset(sc["cfg"], global_batch=8, seq_len=16)
    losses = []
    for i in range(sc["steps"]):
        params, state, m = step(params, state, loop.batch_to_device(
            pipeline.make_batch(ds, i), CPU))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": interop.tree_to_numpy(params),
            "state": interop.tree_to_numpy(state)}


class _SpanClock:
    """A clock under which span k of the elastic loop (which reads the
    clock at a span's start and end) takes ``times[k]`` seconds."""

    def __init__(self, times):
        self.times, self.t, self.calls = list(times), 0.0, 0

    def __call__(self):
        self.calls += 1
        if self.calls % 2 == 0:                 # a span's end
            self.t += self.times[self.calls // 2 - 1]
        return self.t


def _elastic(sc, world):
    """``resilience.elastic_train`` over the autoencoder's dist step (the
    eager chunk runner, no donation), the chaos plan ``sc["chaos"]``.
    With ``sc["span_times"]`` rank r's clock makes span k take
    ``span_times[r][k]`` seconds (the ranks disagree); with ``sc["preempt"] =
    (rank, step)`` that rank sends itself SIGTERM when it logs ``step``,
    rank 0 takes the emergency checkpoint into ``sc["ckpt"]``, and every
    rank then restores it and trains to the end.  Returns the history, the
    supervisor's events and statuses, the state each runner built after
    the first saw (the quarantined state), and the final params and
    state."""
    import signal

    from repro_torch import checkpointing, interop
    from repro_torch.core import baseline_net
    from repro_torch.core import firstorder as fo
    from repro_torch.core import mkor as mk
    from repro_torch.data import pipeline
    from repro_torch.training import chaos
    from repro_torch.training import loop
    from repro_torch.training import resilience as res
    dist = (("data", world),)
    rank = tdist.get_rank()
    seen = []

    def factory(live):
        opt = mk.mkor(fo.sgd(1e-2, momentum=0.9),
                      mk.MKORConfig(dist=dist, live=live, **sc["mkor"]))
        runner = loop.make_chunk_runner(loop.make_dist_step_fn(
            baseline_net.grads_and_full_stats, opt, dist,
            stats_payload_dtype=None), donate=False)

        first = [live is not None]

        def run(params, state, stacked):
            if first[0]:
                first[0] = False
                seen.append(interop.tree_to_numpy(state))
            return runner(params, state, stacked)
        builds.append(live)
        return run
    builds = []
    mcfg = mk.MKORConfig(dist=dist, **sc["mkor"])
    params = interop.params_from_numpy(sc["params"], CPU)
    state = mk.mkor(fo.sgd(1e-2, momentum=0.9), mcfg).init(params)
    sup = res.ElasticSupervisor(world, monitor=res.StragglerMonitor(
        world, **sc.get("monitor", {})))
    plan = chaos.parse_chaos_spec(sc["chaos"]) if sc.get("chaos") else None
    clock = _SpanClock(sc["span_times"][rank]) if sc.get("span_times") \
        else None
    preempt = sc.get("preempt")

    def on_metrics(step, hi, m):
        if preempt and (rank, step) == tuple(preempt):
            os.kill(os.getpid(), signal.SIGTERM)

    def save(at, p, s, extra):
        if rank == 0:
            checkpointing.save(sc["ckpt"], at - 1, (p, s), {
                "step": at - 1, "world": world,
                "cursor": pipeline.cursor_metadata(
                    pipeline.cursor_for_step(at)), **extra})

    def train(params, state, start, guard=None):
        return res.elastic_train(
            factory, params, state, make_batch=ae_batch,
            stack_batches=loop.stack_batches, start=start,
            steps=sc["steps"] - start, chunk=sc["chunk"], supervisor=sup,
            plan=plan, mcfg=mcfg, save=save if preempt else None,
            on_metrics=on_metrics, guard=guard, sleep=lambda s: None,
            **({"clock": clock} if clock else {}))

    with res.PreemptionGuard() as guard:
        params, state, hist, preempted = train(params, state, 0, guard)
    out = {"history": hist, "preempted": preempted}
    if preempted:
        tdist.barrier()                      # rank 0's checkpoint is on disk
        (params, state), meta, _ = checkpointing.restore_latest_valid(
            sc["ckpt"], (params, state))
        out["meta"] = meta
        params, state, rest, _ = train(params, state, meta["cursor"]["step"])
        out["resumed"] = rest
    out.update(events=sup.events, status=sup.status, builds=builds,
               quarantined=seen, params=interop.tree_to_numpy(params),
               state=interop.tree_to_numpy(state))
    return out


KINDS = {"collectives": _collectives, "ae": _ae, "model": _model,
         "fc": _fc, "elastic": _elastic}


def main(job, rank, world, store, out):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=int(rank), world_size=int(world))
    try:
        results = {sc["name"]: KINDS[sc["kind"]](sc, int(world))
                   for sc in pickle.loads(Path(job).read_bytes())}
    finally:
        tdist.destroy_process_group()
    Path(out).write_bytes(pickle.dumps(results))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main(*sys.argv[1:])
