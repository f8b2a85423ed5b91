"""The port's elastic loop across ranks (``training/resilience.py``
``elastic_train`` with ``MKORConfig.dist``, the launcher's ``--elastic
--dist``) against the JAX package.

One spawn a world through ``tests/torch_dist_worker.py`` (scenario kind
``"elastic"``: the autoencoder's dist step, ``mkor(sgd(1e-2,
momentum=0.9))``, inv_freq 2, staleness 1 and the sentinel, the bit-tight
stat payload, the eager chunk runner without donation).  World 2: a
``kill_shard@3:0`` run held against JAX's ``elastic_train`` over its
``make_dist_step_fn`` on a 2-device mesh with the same plan (losses,
params and state at ``tests/test_dist.py``'s tolerances plus one bf16 ulp
on bf16 factors, the convention of ``tests/test_torch_dist.py``), a
``drop_collective`` run and a run preempted by a SIGTERM to one rank, both
the clean run's bits.  World 4: ``delay_shard@2:3`` with each rank's clock
injected and disagreeing, the demotion and events equal on every rank and
to JAX's supervisor fed the slowest rank's times.  Then the launcher's
``--elastic --dist`` on the CPU."""
import importlib

import jax
import numpy as np
import pytest

from repro.core import baseline_net as j_net
from repro.core import firstorder as j_fo
from repro.launch import mesh as mesh_lib
from repro.training import chaos as j_chaos
from repro.training import loop as j_loop
from repro.training import resilience as j_res
from repro_torch import interop
from repro_torch.core import mkor as t_mkor
from repro_torch.launch import train as t_train
from repro_torch.training import resilience as t_res

from test_torch_dist import _close, _host
from torch_dist_worker import ae_batch, run_ranks

j_mkor = importlib.import_module("repro.core.mkor")
MKOR = dict(inv_freq=2, exclude=(), staleness=1, health=True)
STEPS, CHUNK = 6, 3
# world -> scenario name -> options (steps and chunk above unless given)
WORLDS = {
    2: {"kill": dict(chaos="kill_shard@3:0"),
        "clean": dict(),
        "drop": dict(chaos="drop_collective@4"),
        "preempt": dict(preempt=(1, 1), chunk=2)},
    # rank r's seconds for each span of 2 steps; on its own, rank 0 would
    # demote shard 3 at step 6, rank 1 at step 2, ranks 2 and 3 at step 4
    4: {"delay": dict(chaos="delay_shard@2:3", steps=8, chunk=2,
                      span_times=[[1, 0.1, 1, 1], [1, 5, 1, 1], [1, 1, 1, 1],
                                  [1, 1, 1, 1]],
                      monitor=dict(slow_factor=2.0, patience=2,
                                   min_obs=1))},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ae = _host(j_net.init_autoencoder(jax.random.key(0), 96, (48, 12, 48)))
    out = {}
    for world, scs in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"elastic{world}")
        out[world] = run_ranks(tmp, world, [
            {"name": name, "kind": "elastic", "params": ae, "mkor": MKOR,
             "steps": STEPS, "chunk": CHUNK, "ckpt": str(tmp / name), **sc}
            for name, sc in scs.items()])
    return out


def _jax_kill_run():
    """JAX's elastic_train over its dist step on a 2-device mesh, the same
    plan and spans."""
    mesh = mesh_lib.make_host_mesh(2)
    common = dict(MKOR, dist=(("data", 2),))

    def factory(live):
        opt = j_mkor.mkor(j_fo.sgd(1e-2, momentum=0.9),
                          j_mkor.MKORConfig(live=live, **common))
        step = j_loop.make_dist_step_fn(
            lambda p, b: j_net.grads_and_full_stats(p, b), opt, mesh,
            ("data",), stats_payload_dtype=None)
        return j_loop.make_chunk_runner(step, donate=False)

    mcfg = j_mkor.MKORConfig(**common)
    params = j_net.init_autoencoder(jax.random.key(0), 96, (48, 12, 48))
    sup = j_res.ElasticSupervisor(2)
    params, state, hist, _ = j_res.elastic_train(
        factory, params, j_mkor.mkor(j_fo.sgd(1e-2, momentum=0.9),
                                     mcfg).init(params),
        make_batch=ae_batch, stack_batches=j_loop.stack_batches, start=0,
        steps=STEPS, chunk=CHUNK, supervisor=sup,
        plan=j_chaos.parse_chaos_spec("kill_shard@3:0"), mcfg=mcfg,
        sleep=lambda s: None)
    return params, state, hist, sup


def _bit_equal(a, b):
    la = jax.tree.leaves(a, is_leaf=lambda x: x is None)
    lb = jax.tree.leaves(b, is_leaf=lambda x: x is None)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x.dtype == y.dtype
                                      and x.tobytes() == y.tobytes())
        for x, y in zip(la, lb))


def test_elastic_kill_world2_matches_jax(runs):
    """``kill_shard@3:0`` at world 2: rank 0 declared dead at step 3 (it
    owns every slice of the autoencoder's one-slice buckets), its orphaned
    buckets quarantined and the owners remapped onto rank 1; the
    losses, params and state of every rank against JAX's elastic_train;
    the supervisors' events equal JAX's on both ranks; the state the
    remapped runner first saw (the quarantined state) and the final state
    bit-equal across the ranks, the orphans reset."""
    pj, sj, hj, supj = _jax_kill_run()
    ranks = [r["kill"] for r in runs[2]]
    for got in ranks:
        assert [h["step"] for h in got["history"]] == list(range(STEPS))
        np.testing.assert_allclose([h["loss"] for h in got["history"]],
                                   [h["loss"] for h in hj], rtol=1e-5)
        _close(got["params"], pj)
        _close(got["state"], sj, ulp_bf16=True)
        assert got["events"] == supj.events and got["status"] == supj.status
        assert got["builds"] == [None, (False, True)]
    assert supj.events[0]["event"] == "declared dead"
    q0, q1 = ranks[0]["quarantined"], ranks[1]["quarantined"]
    assert len(q0) == 1 and _bit_equal(q0, q1)
    assert _bit_equal(ranks[0]["state"], ranks[1]["state"])
    assert _bit_equal(ranks[0]["params"], ranks[1]["params"])
    q = q0[0]
    cfg = t_mkor.MKORConfig(dist=(("data", 2),), **MKOR)
    orphans = t_res.orphaned_buckets(
        interop.params_from_numpy(ranks[0]["params"], "cpu"), cfg, [0])
    assert orphans
    for bid, h in q["health"].items():
        assert int(h["cooldown"]) == (cfg.health_cooldown if bid in orphans
                                      else 0), bid
    for bid in orphans:
        for key in ("factor_banks", "pending_banks"):
            for k, v in q[key][bid].items():
                eye = np.broadcast_to(np.eye(v.shape[-1], dtype=np.float32),
                                      v.shape)
                assert np.array_equal(v.astype(np.float32), eye), (key, k)
        assert not any(np.asarray(v).any()
                       for v in q["stat_windows"][bid].values())


def test_elastic_drop_collective_is_the_clean_runs_bits(runs):
    """``drop_collective@4``: the span fails once on every rank before its
    runner and is retried; params and state are the clean run's bits."""
    for r in runs[2]:
        assert [h["loss"] for h in r["drop"]["history"]] \
            == [h["loss"] for h in r["clean"]["history"]]
        assert _bit_equal(r["drop"]["params"], r["clean"]["params"])
        assert _bit_equal(r["drop"]["state"], r["clean"]["state"])
        assert r["drop"]["events"] == [] and r["drop"]["builds"] == [None]


def test_elastic_preemption_stops_every_rank_at_one_span(runs):
    """A SIGTERM to rank 1 (at its step 1) stops both ranks at the same
    span boundary (the flag is agreed after span [2, 4)); rank 0's
    emergency checkpoint carries cursor 4; both ranks resume from it and
    end on the clean run's bits."""
    for r in runs[2]:
        got = r["preempt"]
        assert got["preempted"]
        assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
        assert got["meta"]["cursor"]["step"] == 4
        assert got["meta"]["emergency"] is True
        assert [h["step"] for h in got["resumed"]] == [4, 5]
        losses = [h["loss"] for h in got["history"] + got["resumed"]]
        assert losses == [h["loss"] for h in r["clean"]["history"]]
        assert _bit_equal(got["params"], r["clean"]["params"])
        assert _bit_equal(got["state"], r["clean"]["state"])


def test_elastic_delay_world4_agrees_and_matches_jax_supervisor(runs):
    """``delay_shard@2:3`` at world 4 with each rank's clock injected, the
    ranks disagreeing on the span times (``WORLDS``): every rank takes the
    slowest rank's time of each span, so every rank demotes shard 3 at the
    same step (2; alone, the ranks would demote at 6, 2, 4 and 4),
    rebuilds the runner for the same mask and logs the same events, equal
    to the JAX supervisor fed those times; the ranks end on the same
    bits."""
    sc = WORLDS[4]["delay"]
    ref = j_res.ElasticSupervisor(4, monitor=j_res.StragglerMonitor(
        4, **sc["monitor"]))
    slowest = np.max(sc["span_times"], axis=0)
    for k, lo in enumerate((0, 2, 4, 6)):
        times = [slowest[k] / 2 * (3.0 if i == 3 and lo >= 2 else 1.0)
                 for i in range(4)]
        for _ in range(2):
            ref.observe_step_times(times, lo)
    assert ref.status[3] == j_res.DEMOTED and ref.events[0]["step"] == 2
    for r in runs[4]:
        got = r["delay"]
        assert got["events"] == ref.events and got["status"] == ref.status
        assert got["builds"] == [None, (True, True, True, False)]
        assert np.isfinite([h["loss"] for h in got["history"]]).all()
    for r in runs[4][1:]:
        assert _bit_equal(r["delay"]["state"], runs[4][0]["delay"]["state"])


def test_launcher_elastic_dist_cpu(capfd):
    """``--elastic --dist --dist-devices 2 --device cpu --chaos
    kill_shard@2:1``: two spawned gloo ranks, rank 1 declared dead at step
    2 (one set of lines: rank 0 speaks), a finite final loss."""
    final = t_train.main([
        "--arch", "bert-large", "--reduced", "--steps", "4",
        "--global-batch", "4", "--seq-len", "16", "--inv-freq", "2",
        "--log-every", "1", "--device", "cpu", "--chunk", "2", "--elastic",
        "--dist", "--dist-devices", "2", "--chaos", "kill_shard@2:1"])
    out = capfd.readouterr().out
    assert out.count("[elastic] step 2: shard 1 declared dead (live 1/2)") \
        == 1
    assert "remapping owners over 1 survivors" in out
    assert out.count("done: final loss") == 1
    assert np.isfinite(final)
