"""The port's data-parallel MKOR (``training/loop.py`` ``make_dist_step_fn``
and ``make_dist_train_step``, ``MKORConfig(dist=...)``'s owner-sharded
inversions, the launcher's ``--dist``) against the JAX package.

The port's ranks are spawned processes over gloo (``file://`` store under
``tmp_path``; ``tests/torch_dist_worker.py`` imports only torch and the
port), one spawn a world for every scenario of that world; the JAX dist
step runs here under ``shard_map`` on the conftest's fake CPU devices.
``tests/test_torch_dist_features.py`` holds int8 state, the sentinel, a
dead worker and the launcher's ``--dist`` the same way.
The workload is the reference test's (``tests/test_dist.py``): the
autoencoder 96 → 48/12/48, ``mkor(sgd(1e-2, momentum=0.9))``,
``inv_freq`` 2, the bit-tight stat payload, at worlds 2 and 4, and the
tolerances of ``tests/test_dist.py``.

The bf16 factor banks are held to one bf16 ulp besides that tolerance:
the port's single-device bank path already rounds an element one ulp
away from JAX's where their fp32 sums run in another order (the parity
convention of ``tests/test_torch_health.py``: on this workload 2 of 9216
elements of the 96 x 96 factor, 3.05e-5 at |x| ≈ 6e-3, stagger off, no
dist involved), and with stagger on the JAX dist step itself misses
JAX's single-device run by one bf16 ulp on 2 of 9216 elements of one
factor leaf (losses and params within tolerance; ROADMAP.md queue 3)."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baseline_net as j_net
from repro.core import firstorder as j_fo
from repro.launch import mesh as mesh_lib
from repro.models import model as j_model
from repro.data import pipeline as j_pipe
from repro.training import chaos as j_chaos
from repro.training import loop as j_loop
from repro_torch.core import baseline_net as t_net
from repro_torch.core import firstorder as t_fo
from repro_torch.core import mkor as t_mkor
from repro_torch.training import loop as t_loop

from test_torch_mkor_block import _port_cfg
from torch_dist_worker import ae_batch, run_ranks

j_mkor = importlib.import_module("repro.core.mkor")
STEPS = 6
COMMON = dict(inv_freq=2, exclude=())
# (name, world) -> MKORConfig fields, steps, and the run's options
SCENARIOS = {
    "off": dict(mkor=dict(stagger=False)),
    "on": dict(mkor=dict(stagger=True), chunk=4),
    "bf16_payload": dict(mkor=dict(), payload="bfloat16"),
    "int8_rank4_stale1": dict(mkor=dict(rank=4, staleness=1,
                                        factor_quant="int8")),
    "health_chaos": dict(mkor=dict(health=True), chaos="grad_nan@3"),
    "static": dict(mkor=dict(staleness=1)),
    "remap": dict(mkor=dict(staleness=1), live=(True, True, False, True)),
}
WORLD_SCENARIOS = {2: ("off", "on", "bf16_payload"), 4: ("off", "on")}


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def spawn_runs(tmp_path_factory, world_scenarios, model_cfg=None):
    """{world: [rank results]}: one spawn a world, every scenario of it
    (and, at world 2 with ``model_cfg``, make_dist_train_step on it)."""
    ae = _host(j_net.init_autoencoder(jax.random.key(0), 96, (48, 12, 48)))
    out = {}
    for world, names in world_scenarios.items():
        scs = []
        for name in names:
            sc = dict(SCENARIOS[name])
            live = sc.pop("live", None)
            scs.append({"name": name, "kind": "ae", "params": ae,
                        "steps": STEPS, **sc,
                        "mkor": {**COMMON, **sc["mkor"],
                                 **({"live": live} if live else {})}})
        if world == 2 and model_cfg is not None:
            scs.append({"name": "model", "kind": "model", "steps": 2,
                        "cfg": _port_cfg(model_cfg), "params": _host(
                            j_model.init_params(jax.random.key(0),
                                                model_cfg))})
        out[world] = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world,
                               scs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    return spawn_runs(tmp_path_factory, WORLD_SCENARIOS,
                      request.getfixturevalue("tiny_model_cfg"))


def check_ranks_identical(ranks):
    """Every scenario: each rank's losses, params and whole state (counts,
    banks, windows, moments, health) are the same bits as rank 0's."""
    for name in ranks[0]:
        for r in ranks[1:]:
            assert r[name]["losses"] == ranks[0][name]["losses"], name
            for key in ("params", "state"):
                a, b = _leaves(r[name][key]), _leaves(ranks[0][name][key])
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert (x is None and y is None) or (
                        x.dtype == y.dtype and np.array_equal(x, y)), \
                        (name, key)


def _jax_opt(kw, chaos=None):
    cfg = j_mkor.MKORConfig(**{**COMMON, **kw})
    opt = j_mkor.mkor(j_fo.sgd(1e-2, momentum=0.9), cfg)
    if chaos:
        opt = j_chaos.chaotic(opt, j_chaos.parse_chaos_spec(chaos), cfg)
    return opt


def _health(state):
    return {b: (int(h["trips"]), int(h["cooldown"]))
            for b, h in state["health"].items()}


def _jax_run(kw, world=None, chaos=None):
    """The JAX run of the scenario: single-device (``world`` None) or the
    JAX dist step (bit-tight payload); returns (params, state, losses,
    health per step), computed once a file for each argument set."""
    return _jax_run_cached(tuple(sorted(kw.items())), world, chaos)


@functools.lru_cache(maxsize=None)
def _jax_run_cached(kw_items, world, chaos):
    kw = dict(kw_items)
    params = j_net.init_autoencoder(jax.random.key(0), 96, (48, 12, 48))
    if world is None:
        opt = _jax_opt(kw, chaos)

        def step_fn(p, s, b):
            loss, g, st = j_net.grads_and_full_stats(p, b)
            u, s = opt.update(g, s, params=p, stats=st, loss=loss)
            return j_fo.apply_updates(p, u), s, {"loss": loss}
        step = jax.jit(step_fn)
    else:
        mesh = mesh_lib.make_host_mesh(world)
        dist = (("data", world),)
        opt = _jax_opt({**kw, "dist": dist}, chaos)
        step = j_loop.make_dist_step_fn(
            lambda p, b: j_net.grads_and_full_stats(p, b), opt, mesh,
            ("data",), stats_payload_dtype=None)
    s, losses, health = opt.init(params), [], []
    for i in range(STEPS):
        params, s, m = step(params, s, ae_batch(i))
        losses.append(float(m["loss"]))
        if "health" in s:
            health.append(_health(s))
    return params, s, losses, health


def _close(got, want, rtol=2e-4, atol=1e-5, ulp_bf16=False):
    """Leaf by leaf (``want`` a JAX tree, ``got`` the port's numpy tree)
    within ``tests/test_dist.py``'s tolerance; with ``ulp_bf16`` a bf16
    leaf of ``want`` may also be one bf16 ulp off."""
    def leaf(w, g):
        w32 = np.asarray(w, np.float32)
        tol = rtol * np.abs(w32) + atol
        if ulp_bf16 and np.asarray(w).dtype == jnp.bfloat16:
            exp = np.floor(np.log2(np.maximum(np.abs(w32), 2.0 ** -126)))
            tol = np.maximum(tol, 2.0 ** (exp - 7))
        err = np.abs(np.asarray(g, np.float32) - w32)
        assert np.all(err <= tol), float(np.max(err - tol))
    jax.tree.map(leaf, want, got)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_stagger_off_matches_jax_dist_and_single(runs, world):
    """Stagger off: losses, params and the whole state against JAX's
    single-device run and JAX's dist step at the reference's tolerances
    (bf16 factors: one bf16 ulp, module docstring)."""
    p1, s1, l1, _ = _jax_run(dict(stagger=False))
    pd, sd, _, _ = _jax_run(dict(stagger=False), world)
    for r in runs[world]:
        got = r["off"]
        np.testing.assert_allclose(got["losses"], l1, rtol=1e-5)
        for want_p, want_s in ((p1, s1), (pd, sd)):
            _close(got["params"], want_p)
            _close(got["state"], want_s, ulp_bf16=True)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_stagger_on_matches_single_and_jax_dist(runs, world):
    """Stagger on: against JAX's single-device run and JAX's dist step at
    the reference's tolerances, bf16 factors to one bf16 ulp (the JAX dist
    step's own miss is one, module docstring)."""
    p1, s1, l1, _ = _jax_run(dict(stagger=True))
    pd, sd, _, _ = _jax_run(dict(stagger=True), world)
    for r in runs[world]:
        got = r["on"]
        np.testing.assert_allclose(got["losses"], l1, rtol=1e-5)
        _close(got["params"], p1)
        _close(got["state"], s1, ulp_bf16=True)
        _close(got["params"], pd)
        _close(got["state"], sd, ulp_bf16=True)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_ranks_hold_bit_identical_state(runs, world):
    """Each rank's losses, params and whole state are rank 0's bits."""
    check_ranks_identical(runs[world])


def test_dist_bf16_payload_default_stays_close(runs):
    """The default bf16 stat payload tracks JAX's single-device fp32 run
    within the reference's bf16 tolerance (reference ``:249``)."""
    p1, _, _, _ = _jax_run(dict())
    for r in runs[2]:
        got = r["bf16_payload"]
        assert np.isfinite(got["losses"]).all()
        _close(got["params"], p1, rtol=3e-2, atol=3e-3)


def test_dist_step_composes_with_chunk_runner(runs):
    """``train_epoch`` over the dist step in chunks of 4 (a partial chunk
    after) gives the per-step dist loop's losses, params and state bit for
    bit on every rank (on the CPU the runner runs eager steps)."""
    for r in runs[2]:
        assert r["on"]["chunk_equal"]


def test_dist_train_step_model_matches_jax_single(runs, tiny_model_cfg):
    """``make_dist_train_step`` on the tiny model config, world 2, against
    JAX's single-device ``make_train_step`` after 2 steps (reference
    ``:610``)."""
    cfg = tiny_model_cfg
    params = j_model.init_params(jax.random.key(0), cfg)
    opt = j_mkor.mkor(j_fo.lamb(1e-3), j_mkor.MKORConfig(inv_freq=1))
    step = jax.jit(j_loop.make_train_step(cfg, opt))
    ds = j_pipe.make_dataset(cfg, global_batch=8, seq_len=16)
    s = opt.init(params)
    for i in range(2):
        params, s, m = step(params, s, j_pipe.make_batch(ds, i))
    for r in runs[2]:
        got = r["model"]
        assert got["losses"][-1] == pytest.approx(float(m["loss"]),
                                                  rel=1e-4)
        _close(got["params"], params, rtol=5e-4, atol=5e-5)


def test_dist_step_rejects_indivisible_batch():
    """A batch whose leading dim the world does not divide raises before
    any collective."""
    opt = t_mkor.mkor(t_fo.sgd(1e-2), t_mkor.MKORConfig(exclude=()))
    dist = (("data", 8),)
    step = t_loop.make_dist_step_fn(t_net.grads_and_full_stats, opt, dist)
    params = t_net.init_autoencoder(torch.Generator().manual_seed(0), 96,
                                    (48,))
    batch = t_loop.batch_to_device(ae_batch(0, 96, 12), torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        step(params, opt.init(params), batch)
